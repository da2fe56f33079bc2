"""s-step (communication-avoiding) CG: correctness vs classic CG, the
true-residual guarantee, stagnation behavior, and sharded execution."""

import numpy
import pytest
import jax
import jax.numpy as jnp

from krypy_tpu import functional as F, ops, parallel


@pytest.mark.parametrize("s", [2, 4, 8])
def test_ca_cg_matches_cg_jacobi_poisson(s):
    nx = 64
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)
    b = jnp.ones(nx * nx)
    ref = F.cg(lap, b, M=Mj, tol=1e-10, maxiter=500)
    res = F.ca_cg(lap, b, s=s, M=Mj, tol=1e-10, maxiter=500)
    assert int(res.status) == 0
    true_rel = float(
        jnp.linalg.norm(b - lap(res.x)) / jnp.linalg.norm(b)
    )
    assert true_rel <= 1e-9
    # s <= 4 tracks CG's iteration count exactly; s=8 pays a bounded
    # conditioning penalty for the monomial basis
    if s <= 4:
        assert int(res.niter) <= int(ref.niter) + s
    else:
        assert int(res.niter) <= 2 * int(ref.niter)


def test_ca_cg_multigrid():
    nx = 63
    lap = ops.poisson_2d(nx)
    Mg = ops.multigrid_poisson_preconditioner(nx, coarsest=7)
    b = jnp.ones(nx * nx)
    res = F.ca_cg(lap, b, s=4, M=Mg, tol=1e-10, maxiter=64)
    assert int(res.status) == 0
    assert int(res.niter) <= 12  # mesh-independent


def test_ca_cg_dense_spd_unpreconditioned():
    r = numpy.random.RandomState(0)
    Q, _ = numpy.linalg.qr(r.randn(80, 80))
    A = Q @ numpy.diag(numpy.linspace(1, 50, 80)) @ Q.T
    b = jnp.asarray(A @ r.randn(80))
    res = F.ca_cg(jnp.asarray(A), b, s=4, tol=1e-10, maxiter=400)
    assert int(res.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ res.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-9


def test_ca_cg_f32_floor_reports_maxiter():
    """A tolerance below the float32 floor must stagnate-stop with
    MAXITER, never report false convergence (true residual is tracked
    per block)."""
    nx = 64
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)
    b = jnp.ones(nx * nx, jnp.float32)
    res = F.ca_cg(lap, b, s=4, M=Mj, tol=1e-13, maxiter=3000)
    assert int(res.status) == 1
    # but it got to the f32 floor
    n = int(res.niter) // 4
    floor = numpy.nanmin(numpy.asarray(res.resnorms))
    assert floor < 1e-4


def test_ca_cg_sharded():
    mesh = parallel.make_mesh(8)
    nx = 64
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)
    b = parallel.shard_vector(jnp.ones(nx * nx), mesh)
    with mesh:
        res = jax.jit(
            lambda v: F.ca_cg(lap, v, s=4, M=Mj, tol=1e-10, maxiter=500)
        )(b)
    assert int(res.status) == 0
    assert len({s.device for s in res.x.addressable_shards}) == 8


@pytest.mark.parametrize("s,basis", [
    (1, "monomial"), (2, "monomial"), (4, "monomial"),
    (2, "newton"), (4, "newton"),
    (2, "chebyshev"), (4, "chebyshev"), (8, "chebyshev"),
])
def test_ca_gmres_matches_gmres_at_block_boundaries(s, basis):
    """In exact arithmetic CA-GMRES equals GMRES at every block
    boundary; in float64 the residual histories agree to rounding.
    The Chebyshev basis' three-term recurrence accumulates slightly
    more rounding per block than the shift-per-step Newton basis
    (measured ~4e-5 peak boundary deviation on this probe), hence its
    looser comparison; the converged residual is equal."""
    r = numpy.random.RandomState(0)
    A = numpy.diag(numpy.linspace(1, 10, 80)) + 0.1 * r.randn(80, 80)
    b = jnp.asarray(r.randn(80))
    ref = F.gmres(jnp.asarray(A), b, tol=1e-12, maxiter=60)
    res = F.ca_gmres(jnp.asarray(A), b, s=s, basis=basis, tol=1e-12,
                     maxiter=60)
    assert int(res.status) == 0
    rg = numpy.asarray(ref.resnorms)
    rc = numpy.asarray(res.resnorms)
    bdry_rel = 2e-4 if basis == "chebyshev" else 1e-6
    for j in range(1, int(res.niter) // s):
        if j * s <= int(ref.niter):
            assert rc[j] == pytest.approx(rg[j * s], rel=bdry_rel)
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ res.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-11


@pytest.mark.parametrize("s", [2, 4])
def test_ca_gmres_arnoldi_relation(s):
    """The recovered Hessenberg satisfies A V_K = V_{K+1} H_K and the
    basis is orthonormal (the basis-change algebra is exact)."""
    r = numpy.random.RandomState(1)
    A = numpy.diag(numpy.linspace(1, 10, 60)) + 0.05 * r.randn(60, 60)
    b = jnp.asarray(r.randn(60))
    res, internal = F.ca_gmres(
        jnp.asarray(A), b, s=s, tol=1e-12, maxiter=40,
        return_internal=True,
    )
    K = int(res.niter)
    V = numpy.asarray(internal["V"])[: K + 1]
    H = numpy.asarray(internal["H"])[: K + 1, :K]
    arn = numpy.linalg.norm(A @ V[:K].T - V[: K + 1].T @ H)
    assert arn / numpy.linalg.norm(H) < 1e-12
    orth = numpy.linalg.norm(V @ V.T.conj() - numpy.eye(K + 1))
    assert orth < 1e-11


def test_ca_gmres_preconditioned():
    """Left/right preconditioning (Ml, Mr) as in gmres."""
    nx = 32
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)
    b = jnp.ones(nx * nx)
    res = F.ca_gmres(lap, b, s=4, Ml=Mj, Mr=Mj, tol=1e-10, maxiter=512)
    assert int(res.status) == 0
    rel = float(jnp.linalg.norm(b - lap(res.x)) / jnp.linalg.norm(b))
    assert rel <= 1e-8


def test_ca_gmres_multigrid_convdiff():
    """The intended regime: a spectrum-clustering preconditioner keeps
    the monomial basis well conditioned."""
    nx = 63
    lap = ops.poisson_2d(nx)
    Mg = ops.multigrid_poisson_preconditioner(nx, coarsest=7)
    b = jnp.ones(nx * nx)
    res = F.ca_gmres(lap, b, s=4, Ml=Mg, tol=1e-10, maxiter=64)
    assert int(res.status) == 0
    assert int(res.niter) <= 16


def test_ca_gmres_f32_floor_reports_maxiter():
    """Below-floor tolerances must stagnate-stop (true residual per
    block), never claim convergence."""
    nx = 64
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    res = F.ca_gmres(lap, b, s=4, tol=1e-13, maxiter=256)
    assert int(res.status) != 0
    assert numpy.nanmin(numpy.asarray(res.resnorms)) < 1e-3


def test_ca_gmres_newton_survives_where_monomial_breaks():
    """Unpreconditioned Poisson (kappa ~ 1.7e3) in float32 at s=8: the
    monomial basis breaks down within 2 blocks; the Leja-Newton basis
    tracks full GMRES over the whole run."""
    nx = 64
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    mono = F.ca_gmres(lap, b, s=8, basis="monomial", tol=0.0, maxiter=64,
                      stagnation_window=10**9)
    newt = F.ca_gmres(lap, b, s=8, basis="newton", tol=0.0, maxiter=64,
                      stagnation_window=10**9)
    assert int(mono.status) == 2  # BREAKDOWN
    assert int(newt.niter) == 64

    def true_rel(x):
        x64 = jnp.asarray(numpy.asarray(x), jnp.float64)
        b64 = jnp.ones(nx * nx, jnp.float64)
        return float(jnp.linalg.norm(b64 - lap(x64)) / jnp.linalg.norm(b64))

    ref = F.gmres(lap, b, tol=0.0, maxiter=64)
    assert true_rel(newt.x) <= 1.5 * true_rel(ref.x)


def test_ca_gmres_newton_explicit_shifts_callback_free():
    """Passing eigenvalue-estimate shifts skips the warmup+callback and
    must produce the same quality of basis."""
    r = numpy.random.RandomState(3)
    A = numpy.diag(numpy.linspace(1, 10, 60)) + 0.05 * r.randn(60, 60)
    ev = numpy.linalg.eigvals(A)
    b = jnp.asarray(r.randn(60))
    res = F.ca_gmres(jnp.asarray(A), b, s=4, basis="newton",
                     shifts=ev, tol=1e-12, maxiter=40)
    assert int(res.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ res.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-11


def test_ca_gmres_newton_complex():
    """Complex systems use the complex shifts directly (no conjugate-
    pair bookkeeping)."""
    r = numpy.random.RandomState(5)
    A = (numpy.diag(numpy.linspace(1, 8, 48))
         + 0.1 * (r.randn(48, 48) + 1j * r.randn(48, 48)))
    b = jnp.asarray(r.randn(48) + 1j * r.randn(48))
    res = F.ca_gmres(jnp.asarray(A), b, s=4, basis="newton",
                     tol=1e-12, maxiter=48)
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ res.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-10


def test_modified_leja_pairs_adjacent():
    ev = numpy.array([3.0, 1.0 + 2.0j, 1.0 - 2.0j, -4.0, 0.5])
    out = F.modified_leja(ev)
    assert out[0] == -4.0  # max modulus first
    i = int(numpy.argmax(out.imag > 0))
    assert out[i + 1] == numpy.conj(out[i])  # pair adjacent, Im>0 first
    assert sorted(out.tolist(), key=abs) == sorted(ev.tolist(), key=abs)


def test_ca_gmres_zero_rhs():
    res = F.ca_gmres(jnp.eye(16), jnp.zeros(16), s=2, maxiter=8)
    assert int(res.status) == 0
    assert float(jnp.linalg.norm(res.x)) == 0.0


def test_ca_gmres_sharded():
    mesh = parallel.make_mesh(8)
    nx = 64
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)
    b = parallel.shard_vector(jnp.ones(nx * nx), mesh)
    with mesh:
        res = jax.jit(
            lambda v: F.ca_gmres(
                lap, v, s=4, Ml=Mj, tol=1e-8, maxiter=512
            )
        )(b)
    assert int(res.status) == 0
    assert len({sh.device for sh in res.x.addressable_shards}) == 8


def test_restarted_ca_gmres_cached_cycles():
    """Restarted CA-GMRES converges where one cycle cannot, reuses the
    compiled cycle and the operator's Newton shifts across systems, and
    concatenates per-block residual histories."""
    import time

    nx = 48
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float64)
    res = F.restarted_ca_gmres(
        lap, b, s=4, maxiter=40, max_restarts=30, tol=1e-9
    )
    assert int(res.status) == 0
    rel = float(jnp.linalg.norm(b - lap(res.x)) / jnp.linalg.norm(b))
    assert rel <= 1e-8
    hist = numpy.asarray(res.resnorms)
    assert len(hist) > 11  # more than one cycle's blocks
    assert hist[-1] <= 1e-9

    # second rhs: no warmup re-jit, no cycle re-compile
    t0 = time.perf_counter()
    res2 = F.restarted_ca_gmres(
        lap, 1.5 * b, s=4, maxiter=40, max_restarts=30, tol=1e-9
    )
    wall = time.perf_counter() - t0
    assert int(res2.status) == 0
    assert wall < 2.0  # compile took far longer; cached path is fast


def test_restarted_ca_gmres_shift_refresh_traced():
    """Shift refresh between cycles must (a) keep ONE compiled cycle
    (shifts are traced arguments, not compile keys), (b) track plain
    restarted GMRES's residual trajectory on a hard spectrum at s=8."""
    from krypy_tpu.functional import sstep as S

    r = numpy.random.RandomState(5)
    # planted small outliers -> poor short-warmup shift estimates
    d = numpy.linspace(1.0, 50.0, 400)
    d[:4] = [1e-4, 5e-4, 2e-3, 1e-2]
    A = ops.diagonal(jnp.asarray(d))
    b = jnp.asarray(r.randn(400))

    S._CA_RESTART_CACHE.clear()
    res = F.restarted_ca_gmres(
        A, b, s=8, maxiter=40, max_restarts=10, tol=1e-10,
        refresh_shifts=True,
    )
    n_compiled = len(S._CA_RESTART_CACHE)
    assert n_compiled == 1  # refresh did not recompile

    def true_rel(x):
        return float(jnp.linalg.norm(b - A(x)) / jnp.linalg.norm(b))

    # same budget without refresh: the refreshed shifts must not make
    # the final residual worse (the planted outliers make the short
    # warmup's estimates poor, so refresh usually helps)
    S._CA_RESTART_CACHE.clear()
    res_static = F.restarted_ca_gmres(
        A, b, s=8, maxiter=40, max_restarts=10, tol=1e-10,
        refresh_shifts=False,
    )
    assert numpy.isfinite(true_rel(res.x))
    assert true_rel(res.x) <= 1.1 * true_rel(res_static.x)


def test_ca_gmres_traced_shift_tuple_matches_host_shifts():
    """The traced (theta_re, theta_im) form must reproduce the
    host-ordered path exactly (same shifts, same trajectory)."""
    from krypy_tpu.functional.sstep import (
        _leja_head, modified_leja, newton_shifts,
    )

    r = numpy.random.RandomState(11)
    A = numpy.diag(numpy.linspace(1, 10, 80)) + 0.05 * r.randn(80, 80)
    Aj = jnp.asarray(A)
    b = jnp.asarray(r.randn(80))
    ev = newton_shifts(Aj, b, 4)
    res_host = F.ca_gmres(Aj, b, s=4, basis="newton", shifts=ev,
                          tol=1e-12, maxiter=40)
    ordered = _leja_head(modified_leja(numpy.asarray(ev)), 4)
    res_tuple = F.ca_gmres(
        Aj, b, s=4, basis="newton",
        shifts=(jnp.asarray(ordered.real), jnp.asarray(ordered.imag)),
        tol=1e-12, maxiter=40,
    )
    assert int(res_host.status) == int(res_tuple.status)
    assert numpy.allclose(
        numpy.asarray(res_host.x), numpy.asarray(res_tuple.x),
        rtol=1e-12, atol=1e-12,
    )


def test_ca_gmres_chebyshev_survives_s12_f32():
    """Unpreconditioned f32 Poisson where the monomial basis breaks
    down at s=8: the Chebyshev (interval) basis tracks full GMRES's
    true residual even at s=12 -- the SPD sweet spot the basis exists
    for (near-optimal conditioning on the enclosing ellipse)."""
    nx = 64
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float32)
    b64 = jnp.ones(nx * nx, jnp.float64)

    def true_rel(x):
        x64 = jnp.asarray(numpy.asarray(x), jnp.float64)
        return float(
            jnp.linalg.norm(b64 - lap(x64)) / jnp.linalg.norm(b64)
        )

    ref = F.gmres(lap, b, tol=0.0, maxiter=72)
    for s in (8, 12):
        ch = F.ca_gmres(lap, b, s=s, basis="chebyshev", tol=0.0,
                        maxiter=72, stagnation_window=10**9)
        assert int(ch.niter) == 72  # no breakdown
        assert true_rel(ch.x) <= 1.1 * true_rel(ref.x)


def test_ca_gmres_chebyshev_complex():
    """Complex non-Hermitian system: the ellipse picks up a complex
    center and the recurrence runs in complex arithmetic."""
    r = numpy.random.RandomState(7)
    A = (
        numpy.diag(numpy.linspace(1, 10, 80))
        + 0.1 * r.randn(80, 80)
        + 0.05j * r.randn(80, 80)
    )
    b = jnp.asarray(r.randn(80) + 1j * r.randn(80))
    res = F.ca_gmres(jnp.asarray(A), b, s=4, basis="chebyshev",
                     tol=1e-10, maxiter=60)
    assert int(res.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ res.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-9


def test_ca_gmres_chebyshev_explicit_shifts_callback_free():
    """Passing eigenvalue estimates (the same shifts= plumbing as the
    Newton basis) skips the warmup; the ellipse is derived from them."""
    r = numpy.random.RandomState(3)
    A = numpy.diag(numpy.linspace(1, 10, 60)) + 0.05 * r.randn(60, 60)
    ev = numpy.linalg.eigvals(A)
    b = jnp.asarray(r.randn(60))
    res = F.ca_gmres(jnp.asarray(A), b, s=4, basis="chebyshev",
                     shifts=ev, tol=1e-12, maxiter=40)
    assert int(res.status) == 0
    rel = float(
        jnp.linalg.norm(b - jnp.asarray(A) @ res.x) / jnp.linalg.norm(b)
    )
    assert rel <= 1e-11


def test_restarted_ca_gmres_chebyshev():
    """Restarted driver with the Chebyshev basis: converges across
    cycles, the per-cycle ellipse refresh keeps ONE compiled cycle
    (the ellipse derives from traced shift arrays)."""
    from krypy_tpu.functional import sstep as S

    nx = 48
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx, jnp.float64)
    S._CA_RESTART_CACHE.clear()
    res = F.restarted_ca_gmres(
        lap, b, s=8, maxiter=40, max_restarts=30, tol=1e-9,
        basis="chebyshev",
    )
    assert int(res.status) == 0
    assert len(S._CA_RESTART_CACHE) == 1
    rel = float(jnp.linalg.norm(b - lap(res.x)) / jnp.linalg.norm(b))
    assert rel <= 1e-8


def test_ca_gmres_rank_deficient_panel_stays_finite():
    """Eigenvector rhs: the first Newton direction (A - theta0) b is
    ~0, so the candidate panel's Gram matrix is numerically singular.
    Whether plain Cholesky survives that is a rounding-order lottery
    (one reduction order NaN'd where the CPU's happened not to);
    the shifted CholQR2 guard must keep the solve finite and
    progressing on every backend."""
    n = 256
    lap = ops.poisson_1d(n)
    h = 1.0 / (n + 1)
    b = jnp.asarray(
        numpy.sin(numpy.arange(1, n + 1) * numpy.pi * h), jnp.float32
    )
    r = F.ca_gmres(lap, b, tol=1e-6, maxiter=16, s=4, basis="newton")
    rn = numpy.asarray(r.resnorms)
    assert numpy.all(numpy.isfinite(numpy.asarray(r.x)))
    finite = rn[numpy.isfinite(rn)]
    assert finite.size > 1 and float(numpy.nanmin(rn)) < 1e-2
