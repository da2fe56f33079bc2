"""Sketched GMRES (randomized lane).

Oracles: explicit true residuals against dense/stencil operators (real,
complex, preconditioned, warm-started), exact termination in a
24-dimensional space, quasi-optimality against full GMRES on the same
Krylov subspace, and direct embedding-quality checks of the
Kronecker-factored Gaussian sketch."""

import numpy
import pytest
import jax.numpy as jnp

from krypy_tpu import functional as F, ops


def _dense_nonsym(n, seed=0, spread=(1, 20), skew=0.3):
    rng = numpy.random.RandomState(seed)
    A = (numpy.diag(numpy.linspace(*spread, n))
         + skew * numpy.triu(rng.randn(n, n), 1) / numpy.sqrt(n))
    return A, rng


def test_kron_sketch_is_an_embedding():
    """Norms of arbitrary vectors are preserved to the ~1/sqrt(d)
    concentration expected of a Gaussian-class embedding."""
    N, d = 4096, 256
    S = F.kron_sketch(N, d, seed=7)
    assert S.d >= d
    rng = numpy.random.RandomState(0)
    ratios = []
    for i in range(20):
        x = jnp.asarray(rng.randn(N), jnp.float32)
        ratios.append(
            float(jnp.linalg.norm(F.sketch_apply(S, x))
                  / jnp.linalg.norm(x))
        )
    ratios = numpy.array(ratios)
    # each realization within 50%, the ensemble mean much tighter
    assert numpy.all(numpy.abs(ratios - 1) < 0.5)
    assert abs(ratios.mean() - 1) < 0.1


def test_kron_sketch_approximate_orthogonality():
    """Sketched inner products of orthogonal vectors stay small
    relative to the vector norms."""
    N, d = 2048, 400
    S = F.kron_sketch(N, d, seed=3)
    x = jnp.zeros(N).at[:N // 2].set(1.0)
    y = jnp.zeros(N).at[N // 2:].set(1.0)
    sx, sy = F.sketch_apply(S, x), F.sketch_apply(S, y)
    cos = float(jnp.abs(jnp.vdot(sx, sy))
                / (jnp.linalg.norm(sx) * jnp.linalg.norm(sy)))
    assert cos < 0.25


def test_kron_sketch_smooth_grid_modes():
    """Regression: grid-smooth vectors are near-rank-1 as reshaped
    matrices; without the Rademacher pre-mask the Kronecker map kept
    their rank and two ORTHOGONAL Laplacian eigenmodes sketched to
    cosine -0.35 (enough to diverge a preconditioned f32 solve at
    255^2).  With the mask they stay numerically orthogonal."""
    n = 255
    N = n * n
    x = numpy.linspace(0, 1, n)
    xx, yy = numpy.meshgrid(x, x)
    m1 = jnp.asarray((numpy.sin(numpy.pi * xx)
                      * numpy.sin(numpy.pi * yy)).ravel())
    m2 = jnp.asarray((numpy.sin(2 * numpy.pi * xx)
                      * numpy.sin(numpy.pi * yy)).ravel())
    S = F.kron_sketch(N, 164, seed=0, dtype=jnp.float64)
    s1, s2 = F.sketch_apply(S, m1), F.sketch_apply(S, m2)
    cos = float(jnp.abs(jnp.vdot(s1, s2))
                / (jnp.linalg.norm(s1) * jnp.linalg.norm(s2)))
    assert cos < 0.15
    for s, m in ((s1, m1), (s2, m2)):
        ratio = float(jnp.linalg.norm(s) / jnp.linalg.norm(m))
        assert abs(ratio - 1) < 0.35


def test_sketched_gmres_dense_nonsymmetric():
    A, rng = _dense_nonsym(200)
    b = jnp.asarray(rng.randn(200))
    r = F.sketched_gmres(jnp.asarray(A), b, tol=1e-8, maxiter=150)
    assert int(r.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ r.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-8
    # resnorms: sketched estimates, final entry is the TRUE residual
    assert numpy.isfinite(numpy.asarray(r.resnorms)[: int(r.niter) + 1]).all()


def test_sketched_gmres_quasi_optimal_vs_gmres():
    """Same Krylov subspace, sketched minimization: the true residual
    after m steps is within a small factor of full GMRES's."""
    A, rng = _dense_nonsym(160, seed=5)
    b = jnp.asarray(rng.randn(160))
    m = 30
    rs = F.sketched_gmres(jnp.asarray(A), b, tol=1e-14, maxiter=m,
                          k_ortho=4, sketch_dim=8 * (m + 1))
    rg = F.gmres(jnp.asarray(A), b, tol=1e-14, maxiter=m)
    rel_s = float(jnp.linalg.norm(b - jnp.asarray(A) @ rs.x)
                  / jnp.linalg.norm(b))
    rel_g = float(jnp.linalg.norm(b - jnp.asarray(A) @ rg.x.reshape(-1))
                  / jnp.linalg.norm(b))
    assert rel_s <= 3 * rel_g + 1e-14


def test_sketched_gmres_complex():
    rng = numpy.random.RandomState(1)
    n = 120
    A = (numpy.diag(numpy.linspace(1, 10, n)).astype(complex)
         + 0.2 * (rng.randn(n, n) + 1j * rng.randn(n, n)) / numpy.sqrt(n))
    b = jnp.asarray(rng.randn(n) + 1j * rng.randn(n))
    r = F.sketched_gmres(jnp.asarray(A), b, tol=1e-8, maxiter=100)
    assert int(r.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ r.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-8


def test_sketched_gmres_preconditioned_convdiff():
    cd = ops.convection_diffusion_2d(32, 32)
    Mj = ops.jacobi_preconditioner(cd)
    b = jnp.ones(32 * 32, jnp.float64)
    r = F.sketched_gmres(cd, b, M=Mj, tol=1e-9, maxiter=300, k_ortho=4)
    assert int(r.status) == 0
    rel = float(jnp.linalg.norm(b - cd(r.x)) / jnp.linalg.norm(b))
    assert rel <= 1e-9


def test_sketched_gmres_exact_termination():
    """In a 24-dimensional space the basis exhausts and the assembled
    iterate is the exact solution (trailing degenerate column dropped)."""
    A, rng = _dense_nonsym(24, seed=2, spread=(1, 5), skew=0.1)
    b = jnp.asarray(rng.randn(24))
    r = F.sketched_gmres(jnp.asarray(A), b, tol=1e-12, maxiter=40,
                         k_ortho=3)
    assert int(r.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ r.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-12


def test_sketched_gmres_x0_and_zero_rhs():
    A, rng = _dense_nonsym(80, seed=4, spread=(1, 8), skew=0.2)
    b = jnp.asarray(rng.randn(80))
    x0 = jnp.asarray(rng.randn(80))
    r = F.sketched_gmres(jnp.asarray(A), b, x0=x0, tol=1e-10, maxiter=60)
    assert int(r.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ r.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-10

    r0 = F.sketched_gmres(jnp.asarray(A), jnp.zeros(80), tol=1e-10,
                          maxiter=10)
    assert int(r0.status) == 0
    assert int(r0.niter) == 0
    assert float(jnp.linalg.norm(r0.x)) == 0.0


def test_sketched_gmres_shared_sketch():
    """A prebuilt sketch is reusable across a solve sequence."""
    A, rng = _dense_nonsym(100, seed=6, spread=(1, 10), skew=0.2)
    S = F.kron_sketch(100, 4 * 61, seed=0)
    for k in range(2):
        b = jnp.asarray(rng.randn(100))
        r = F.sketched_gmres(jnp.asarray(A), b, tol=1e-9, maxiter=60,
                             sketch=S)
        assert int(r.status) == 0
        rel = float(jnp.linalg.norm(b - jnp.asarray(A) @ r.x)
                    / jnp.linalg.norm(b))
        assert rel <= 1e-9


def test_restarted_sketched_gmres_convdiff():
    """The restarted driver solves a system whose length exceeds any
    stable single sketched cycle; a second solve on the same operator
    reuses the compiled cycle and the same embedding."""
    cd = ops.convection_diffusion_2d(64, 64)
    Mj = ops.jacobi_preconditioner(cd)
    b = jnp.ones(64 * 64, jnp.float64)
    r = F.restarted_sketched_gmres(
        cd, b, M=Mj, tol=1e-8, maxiter=40, max_restarts=20, k_ortho=4
    )
    assert int(r.status) == 0
    rel = float(jnp.linalg.norm(b - cd(r.x)) / jnp.linalg.norm(b))
    assert rel <= 1e-8
    assert int(r.niter) > 40  # genuinely needed restarts

    r2 = F.restarted_sketched_gmres(
        cd, 2.0 * b, M=Mj, tol=1e-8, maxiter=40, max_restarts=20,
        k_ortho=4,
    )
    assert int(r2.status) == 0


def test_sketched_gmres_rejects_narrow_sketch():
    A, rng = _dense_nonsym(50, seed=0)
    b = jnp.asarray(rng.randn(50))
    with pytest.raises(ValueError):
        F.sketched_gmres(jnp.asarray(A), b, maxiter=40, sketch_dim=10)


def test_sketched_gmres_maxiter_honest():
    """An unreachable tolerance reports MAXITER with the best iterate,
    never false convergence."""
    A, rng = _dense_nonsym(150, seed=9, spread=(1, 3000), skew=0.5)
    A32 = jnp.asarray(numpy.asarray(A, dtype=numpy.float32))
    b = jnp.asarray(rng.randn(150), jnp.float32)
    r = F.sketched_gmres(A32, b, tol=1e-14, maxiter=20)
    assert int(r.status) == 1
    rel = float(jnp.linalg.norm(b - A32 @ r.x) / jnp.linalg.norm(b))
    assert rel > 1e-14


def test_sketched_eigs_dominant_spectrum():
    """One-shot sketched Rayleigh-Ritz recovers the well-separated
    dominant eigenvalues; every pair is explicitly certified."""
    rng = numpy.random.RandomState(0)
    n = 400
    D = numpy.diag(numpy.r_[numpy.linspace(10, 5, 8),
                            numpy.linspace(1, 0.1, n - 8)])
    Q = numpy.linalg.qr(rng.randn(n, n))[0]
    A = Q @ D @ Q.T + 0.05 * rng.randn(n, n) / numpy.sqrt(n)
    r = F.sketched_eigs(jnp.asarray(A), k=6, maxiter=80, which="lm")
    assert r.status == 0
    assert float(r.pair_resnorms.max()) < 1e-8
    true = numpy.sort(numpy.linalg.eigvals(A).real)[::-1][:6]
    got = numpy.sort(numpy.asarray(r.theta.real))[::-1]
    numpy.testing.assert_allclose(got, true, rtol=1e-7)


def test_sketched_eigs_complex_operator():
    """Complex operator, well-separated dominant cluster: a one-shot
    survey resolves it (tightly spaced interior pairs are a job for
    eigs/Krylov-Schur, and the certified residuals say so honestly)."""
    rng = numpy.random.RandomState(3)
    n = 200
    diag = numpy.r_[numpy.linspace(10, 7, 4), numpy.linspace(1, 0.5, n - 4)]
    A = (numpy.diag(diag).astype(complex)
         + 0.1j * numpy.triu(rng.randn(n, n), 1) / numpy.sqrt(n))
    r = F.sketched_eigs(jnp.asarray(A), k=4, maxiter=60, which="lr")
    assert float(r.pair_resnorms.max()) < 1e-6
    true = numpy.linalg.eigvals(A)
    true = true[numpy.argsort(-true.real)][:4]
    got = numpy.asarray(r.theta)
    got = got[numpy.argsort(-got.real)]
    numpy.testing.assert_allclose(got.real, true.real, rtol=1e-5)


def test_sketched_eigs_matvec_only():
    """Callable operator with n=: the survey tool needs only a traced
    matvec (and never the adjoint)."""
    cd = ops.convection_diffusion_2d(24, 24)
    r = F.sketched_eigs(cd, k=4, n=24 * 24, maxiter=70, which="lm")
    # certified residuals are honest even if loose; the dominant
    # eigenvalue of the stencil is real and well separated
    assert float(r.pair_resnorms.min()) < 1e-4


def test_sketched_eigs_validation():
    with pytest.raises(ValueError):
        F.sketched_eigs(lambda x: x, k=3)  # no n, no shape
    with pytest.raises(ValueError):
        F.sketched_eigs(jnp.eye(10), k=0)


def test_sketched_gmres_sharded_matches_single_device():
    """The sketched solver is pure jnp: under a mesh GSPMD shards the
    basis and the Kronecker sketch's reshape+GEMMs without code
    changes.  Same solve, 8 devices vs 1, agrees to f32 reduction-
    order noise."""
    import jax

    from krypy_tpu import parallel

    mesh = parallel.make_mesh(8)
    nx = 64
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    r1 = F.sketched_gmres(lap, b, tol=1e-5, maxiter=30, seed=3)
    bs = parallel.shard_vector(b, mesh)
    with mesh:
        rs = jax.jit(
            lambda bb: F.sketched_gmres(lap, bb, tol=1e-5, maxiter=30,
                                        seed=3)
        )(bs)
    assert int(rs.niter) == int(r1.niter)
    # different f32 reduction orders perturb the assembled iterate (the
    # adaptive assembly may even pick a different candidate); what must
    # agree is the iteration count and the delivered residual quality
    err = float(jnp.linalg.norm(rs.x - r1.x) / jnp.linalg.norm(r1.x))
    assert err < 0.1
    rel_s = float(jnp.linalg.norm(b - lap(rs.x)) / jnp.linalg.norm(b))
    rel_1 = float(jnp.linalg.norm(b - lap(r1.x)) / jnp.linalg.norm(b))
    assert rel_s <= 1.1 * rel_1 + 1e-6


def test_sketch_certificate_healthy_embedding():
    """The posterior distortion certificate sits near 1 when d is
    ample, and the realized embedding dimension is reported."""
    nx = 63
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    r = F.sketched_gmres(lap, b, tol=1e-6, maxiter=30)
    assert int(r.sketch_d) >= 8 * 30
    assert 0.2 < float(r.distortion) < 2.0


def test_sketch_certificate_flags_starved_embedding():
    """A starved embedding (d barely above maxiter) on the grid-smooth
    Poisson subspace converges in sketch-space without true progress;
    the certificate must expose it (measured ~4.4 at d=35/m=30)."""
    nx = 63
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    r = F.sketched_gmres(lap, b, tol=1e-6, maxiter=30, sketch_dim=32)
    assert float(r.distortion) > 3.0
    assert not bool(r.converged)


def test_restarted_escalates_on_distortion():
    """restarted_sketched_gmres doubles the embedding when the
    certificate exceeds distortion_limit: from a starved d the solve
    must escalate and deliver real progress, while the frozen
    (round-3, distortion_limit=inf) run stalls without any."""
    nx = 63
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    frozen = F.restarted_sketched_gmres(
        lap, b, tol=1e-6, maxiter=30, max_restarts=6, sketch_dim=32,
        distortion_limit=float("inf"),
    )
    esc = F.restarted_sketched_gmres(
        lap, b, tol=1e-6, maxiter=30, max_restarts=6, sketch_dim=32,
    )
    assert int(esc.sketch_d) > int(frozen.sketch_d)
    assert float(esc.resnorms[-1]) < 0.1 * float(frozen.resnorms[-1])


def test_restarted_classic_fallback():
    """With escalation disabled, a failing certificate hands the
    remaining budget to classic restarted GMRES -- a bad embedding
    costs one cycle, never the solve."""
    nx = 63
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    r = F.restarted_sketched_gmres(
        lap, b, tol=1e-3, maxiter=30, max_restarts=8, sketch_dim=32,
        max_escalations=0,
    )
    assert bool(r.converged)
    assert float(r.resnorms[-1]) <= 1e-3


def test_sketch_escalation_single_compiled_program():
    """Escalating sketch_dim reuses ONE compiled cycle (VERDICT r4 #7):
    every level shares the d_max-padded buffer shapes and the sketch
    enters the jitted cycle as a traced operand, so a mid-solve
    escalation never retraces."""
    import numpy
    from krypy_tpu.functional import sketch as SK

    rng = numpy.random.RandomState(0)
    N = 300
    A = numpy.diag(numpy.linspace(1, 60, N))
    A = A + 0.3 * rng.randn(N, N) / numpy.sqrt(N)
    b = rng.randn(N)
    Aj = jnp.asarray(A, jnp.float32)
    bj = jnp.asarray(b, jnp.float32)

    SK._SKETCH_RESTART_CACHE.clear()
    # distortion_limit=0 forces an escalation at every restart seam
    res = SK.restarted_sketched_gmres(
        Aj, bj, tol=1e-12, maxiter=10, max_restarts=5,
        max_escalations=2, distortion_limit=0.0, classic_fallback=False,
    )
    assert len(SK._SKETCH_RESTART_CACHE) == 1
    fn = next(iter(SK._SKETCH_RESTART_CACHE.values()))
    assert fn._cache_size() == 1, "escalation recompiled the cycle"
    assert jnp.isfinite(res.resnorms[0])

    # the padded level-0 embedding still solves to tolerance
    SK._SKETCH_RESTART_CACHE.clear()
    res2 = SK.restarted_sketched_gmres(
        Aj, bj, tol=1e-5, maxiter=30, max_restarts=6, max_escalations=2,
    )
    assert int(res2.status) == F.CONVERGED
    rel = numpy.linalg.norm(
        b - A @ numpy.asarray(res2.x, numpy.float64)
    ) / numpy.linalg.norm(b)
    assert rel <= 2e-5


def test_padded_kron_sketch_levels_are_isometric():
    """Each escalation level of the padded sketch is an isometry in
    expectation at its ACTIVE dimension: E||S x||^2 = ||x||^2."""
    import numpy
    from krypy_tpu.functional.sketch import padded_kron_sketch, sketch_apply

    N, d0 = 400, 64
    x = jnp.asarray(numpy.random.RandomState(1).randn(N), jnp.float32)
    xn = float(jnp.linalg.norm(x))
    for level in (0, 1, 2):
        vals = []
        for s in range(24):
            S = padded_kron_sketch(N, d0 * 2 ** level, d0 * 4, seed=s)
            vals.append(float(jnp.linalg.norm(sketch_apply(S, x))) / xn)
        mean = numpy.mean(numpy.square(vals))
        assert abs(mean - 1.0) < 0.35, (level, mean)
        # padded rows are exactly zero beyond the active block
        rows = S.S1.shape[0]
        import math as _m
        d1, d2 = S.S1.shape[0], S.S2.shape[0]
        active = -(-d0 * 2 ** level // d2)
        if active < rows:
            assert float(jnp.abs(S.S1[active:]).max()) == 0.0
