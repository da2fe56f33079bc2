"""Tests for the jitted deflated GMRES and the accelerator-native recycling loop."""

import numpy
import pytest
import jax
import jax.numpy as jnp

from krypy_tpu import functional as F
from krypy_tpu import ops, parallel
from krypy_tpu.functional.deflation import (
    RecyclingGmres,
    build_deflation,
    deflated_gmres,
    weighted_qr,
)


def test_weighted_qr():
    rng = numpy.random.RandomState(0)
    U = jnp.asarray(rng.randn(30, 4))
    B = jnp.diag(jnp.asarray(numpy.linspace(1, 3, 30)))
    Q, R = weighted_qr(U, ip=B)
    G = numpy.asarray(Q.conj().T @ (B @ Q))
    numpy.testing.assert_allclose(G, numpy.eye(4), atol=1e-12)
    numpy.testing.assert_allclose(
        numpy.asarray(Q @ R), numpy.asarray(U), atol=1e-12
    )
    assert numpy.linalg.norm(numpy.tril(numpy.asarray(R), -1)) == 0


def test_golden_deflated_functional():
    """Functional deflated GMRES reproduces the reference golden values
    (test/test_convenience_wrappers.py:34-55)."""
    n = 100
    A = numpy.diag([1.0e-3] + list(range(2, n + 1)))
    b = numpy.ones(n)
    U = numpy.zeros((n, 1))
    U[0, 0] = 1.0
    res = deflated_gmres(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(U), tol=1e-5
    )
    assert int(res.status) == F.CONVERGED
    x = numpy.asarray(res.x)
    golden = [1004.1873774950692, 1000.0003174918709, 1000.0]
    assert abs(numpy.abs(x).sum() - golden[0]) < 1e-11 * golden[0]
    assert abs(numpy.sqrt(x @ x) - golden[1]) < 1e-11 * golden[1]
    assert abs(numpy.max(numpy.abs(x)) - golden[2]) < 1e-11 * golden[2]


def test_deflation_projection_properties():
    """The assembled oblique projection annihilates the deflation image
    and the captured C matches explicit inner products."""
    rng = numpy.random.RandomState(1)
    n = 40
    A = numpy.diag(numpy.linspace(1, 2, n))
    A[0, 0] = 1e-3
    U = jnp.asarray(rng.randn(n, 2))
    defl = build_deflation(jnp.asarray(A), U)
    # E = <Uo, A Uo>
    E_exp = numpy.asarray(defl.Uo).conj().T @ (A @ numpy.asarray(defl.Uo))
    numpy.testing.assert_allclose(
        numpy.asarray(defl.E), E_exp, atol=1e-12
    )

    res, internals = deflated_gmres(
        jnp.asarray(A), jnp.ones(n), U, tol=1e-10, maxiter=20,
        return_internal=True,
    )
    k = int(res.niter)
    V = numpy.asarray(internals["V"])[:k]
    C = numpy.asarray(internals["C"])[:k]
    C_exp = V @ (A.T @ numpy.asarray(defl.Uo).conj())
    numpy.testing.assert_allclose(C, C_exp, atol=1e-8)

    # true residual small
    x = numpy.asarray(res.x)
    rel = numpy.linalg.norm(numpy.ones(n) - A @ x) / numpy.sqrt(n)
    assert rel <= 1e-10


def test_deflation_speeds_up_outlier_system():
    """Deflating the outlier eigenvector reduces iteration count."""
    n = 100
    A = numpy.diag([1.0e-4] + list(numpy.linspace(1, 2, n - 1)))
    b = numpy.ones(n)
    plain = F.gmres(jnp.asarray(A), jnp.asarray(b), tol=1e-8, maxiter=90)
    U = numpy.zeros((n, 1))
    U[0, 0] = 1.0
    defl = deflated_gmres(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(U), tol=1e-8,
        maxiter=90,
    )
    assert int(defl.status) == F.CONVERGED
    assert int(defl.niter) < int(plain.niter)


def test_recycling_gmres_functional():
    N = 100
    d = numpy.linspace(1, 2, N)
    d[:5] = [1e-8, 1e-4, 1e-2, 2e-2, 3e-2]
    A = jnp.asarray(numpy.diag(d))
    b = jnp.ones(N)
    rec = RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    iters = []
    for _ in range(3):
        r = rec.solve(A, b, tol=1e-5, maxiter=60)
        assert int(r.status) == F.CONVERGED
        iters.append(int(r.niter))
    assert iters[1] <= iters[0]
    assert iters[2] <= iters[0]


def test_recycling_sequence_of_systems():
    """Recycling across a slowly varying sequence with planted outlier
    modes (the regime where deflation pays off -- same setup class as the
    reference test, test/test_recycling.py:17-39; BASELINE config 5)."""
    n = 120
    base = numpy.linspace(1, 2, n)
    base[:4] = [1e-6, 1e-3, 5e-3, 2e-2]
    rec = RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    b = jnp.ones(n)
    iters = []
    for i in range(4):
        d = base * (1.0 + 0.01 * i)  # slowly varying sequence
        op = ops.diagonal(jnp.asarray(d))
        r = rec.solve(op, b, tol=1e-6, maxiter=110)
        assert int(r.status) == F.CONVERGED
        iters.append(int(r.niter))
    # recycling must help once the outlier space is captured
    assert min(iters[1:]) < iters[0]


def test_recycling_warmup_precompiles_both_cores():
    """warmup() compiles the plain AND deflated cores ahead of the
    sequence (serving path: no compile inside solve), and the warmed
    solver produces the same iteration counts as an unwarmed one."""
    n = 120
    base = numpy.linspace(1, 2, n)
    base[:4] = [1e-6, 1e-3, 5e-3, 2e-2]
    b = jnp.ones(n)

    rec_w = RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    op0 = ops.diagonal(jnp.asarray(base))
    assert rec_w.warmup(op0, b, tol=1e-6, maxiter=110) is rec_w
    # both structures (plain, deflated) compiled for the family
    assert len(rec_w._compiled) == 2

    rec_plain = RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    for i in range(3):
        d = base * (1.0 + 0.01 * i)
        op = ops.diagonal(jnp.asarray(d))
        rw = rec_w.solve(op, b, tol=1e-6, maxiter=110)
        rp = rec_plain.solve(op, b, tol=1e-6, maxiter=110)
        assert int(rw.status) == F.CONVERGED
        assert int(rw.niter) == int(rp.niter)
    # the warmed solver added no new compilation entries
    assert len(rec_w._compiled) == 2


def test_recycling_varying_tol_does_not_retrace():
    """The tolerance is a TRACED argument of the compiled cores: a
    driver that varies it per solve (Eisenstat-Walker forcing in
    newton_krylov) must not grow the compilation cache."""
    n = 80
    base = numpy.linspace(1, 2, n)
    base[:2] = [1e-4, 1e-2]
    rec = RecyclingGmres(n_vectors=2, which="sm", hermitian=True)
    b = jnp.ones(n)
    for i, tol in enumerate((1e-2, 3e-4, 7e-6)):
        op = ops.diagonal(jnp.asarray(base * (1.0 + 0.01 * i)))
        r = rec.solve(op, b, tol=tol, maxiter=70)
        assert int(r.status) == F.CONVERGED
    assert len(rec._compiled) == 2  # plain + deflated, nothing more


def test_sharded_deflated_gmres():
    """Deflated GMRES runs sharded over the 8-device mesh."""
    nx = 16
    lap = ops.shifted_laplacian_2d(nx, sigma=500.0)
    N = nx * nx
    b = jnp.ones(N)
    rng = numpy.random.RandomState(0)
    U = jnp.asarray(rng.randn(N, 2))
    mesh = parallel.make_mesh(8)
    b_sh = parallel.shard_vector(b, mesh)

    @jax.jit
    def run(bb):
        return deflated_gmres(
            lap, bb, U, tol=1e-6, maxiter=220
        )

    with mesh:
        res = run(b_sh)
    x = numpy.asarray(res.x)
    rel = numpy.linalg.norm(
        numpy.asarray(b) - numpy.asarray(lap(jnp.asarray(x)))
    ) / numpy.sqrt(N)
    assert rel <= 1e-6


@pytest.mark.parametrize(
    "solver, golden0",
    [
        (F.deflated_cg, 1004.1873775173271),
        (F.deflated_minres, 1004.1873774950692),
    ],
)
def test_golden_deflated_short_recurrence(solver, golden0):
    """Functional deflated CG/MINRES reproduce the reference golden
    values (test/test_convenience_wrappers.py:34-55)."""
    n = 100
    A = numpy.diag([1.0e-3] + list(range(2, n + 1)))
    b = numpy.ones(n)
    U = numpy.zeros((n, 1))
    U[0, 0] = 1.0
    res = solver(jnp.asarray(A), jnp.asarray(b), jnp.asarray(U), tol=1e-5)
    assert int(res.status) == F.CONVERGED
    x = numpy.asarray(res.x)
    assert abs(numpy.abs(x).sum() - golden0) < 1e-11 * golden0


@pytest.mark.parametrize(
    "solver, kw, golden0",
    [
        (deflated_gmres, {"ortho": "cgs2_1r"}, 1004.1873774950692),
        (F.deflated_cg, {"variant": "1r"}, 1004.1873775173271),
        (F.deflated_minres, {"variant": "1r"}, 1004.1873774950692),
    ],
)
def test_golden_deflated_one_reduce(solver, kw, golden0):
    """The fused one-reduce deflated solvers reproduce the reference
    golden values (test/test_convenience_wrappers.py:34-55) -- the
    numerics of folding capture+projection into the single contraction
    are at solver tolerance."""
    n = 100
    A = numpy.diag([1.0e-3] + list(range(2, n + 1)))
    b = numpy.ones(n)
    U = numpy.zeros((n, 1))
    U[0, 0] = 1.0
    res = solver(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(U), tol=1e-5, **kw
    )
    assert int(res.status) == F.CONVERGED
    x = numpy.asarray(res.x)
    assert abs(numpy.abs(x).sum() - golden0) < 1e-10 * golden0


def test_deflated_one_reduce_gram_identities():
    """The fused-1r deflated GMRES's captured small matrices satisfy the
    SAME Gram identities as the hook path's: C[k] = <Uo, A v_k>,
    E = <Uo, A Uo>, B = <V, A Uo> -- the augmented Galerkin block the
    recycling machinery consumes is exact (VERDICT r4 #1 parity
    battery)."""
    rng = numpy.random.RandomState(7)
    n = 80
    A = numpy.diag(numpy.linspace(1.0, 30.0, n))
    A += 0.05 * rng.randn(n, n)
    b = rng.randn(n)
    U = rng.randn(n, 3)
    res, ints = deflated_gmres(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(U),
        tol=1e-9, maxiter=40, ortho="cgs2_1r", return_internal=True,
    )
    niter = int(res.niter)
    assert niter > 5
    V = numpy.asarray(ints["V"])
    C = numpy.asarray(ints["C"])
    Uo = numpy.asarray(ints["Uo"])
    E = numpy.asarray(ints["E"])
    # basis orthonormality and complement membership (the leak the
    # seal-time cancellation removes)
    Vb = V[: niter + 1]
    numpy.testing.assert_allclose(
        Vb @ Vb.T, numpy.eye(niter + 1), atol=1e-12
    )
    assert numpy.abs(Uo.T @ Vb.T).max() < 1e-12
    # capture identity on every completed column
    for k in range(niter):
        numpy.testing.assert_allclose(
            C[k], Uo.T @ (A @ V[k]), atol=1e-11
        )
    numpy.testing.assert_allclose(E, Uo.T @ (A @ Uo), atol=1e-11)
    # the full augmented-Galerkin assembly (what Ritz recycling eats)
    # agrees between the fused and hook paths
    res_h, ints_h = deflated_gmres(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(U),
        tol=1e-9, maxiter=40, ortho="cgs2", return_internal=True,
    )
    from krypy_tpu.functional.deflation import _augmented_galerkin

    M1, n1, d1 = _augmented_galerkin(dict(ints, niter=niter))
    M2, n2, d2 = _augmented_galerkin(
        dict(ints_h, niter=int(res_h.niter))
    )
    assert (n1, d1) == (n2, d2)
    theta1 = numpy.sort_complex(numpy.linalg.eigvals(M1))
    theta2 = numpy.sort_complex(numpy.linalg.eigvals(M2))
    numpy.testing.assert_allclose(theta1, theta2, rtol=1e-8, atol=1e-10)


def test_deflated_one_reduce_long_solve_leak_regression():
    """Regression for the deflation-space leak: without the seal-time /
    alpha-term cancellation the basis drifts out of the projection
    complement at |alpha|/beta per iteration and a >100-iteration
    deflated one-reduce solve stalls well above tolerance (measured:
    2.5e-6 at 300 iterations on this operator pre-fix)."""
    rng = numpy.random.RandomState(0)
    n = 120
    A = numpy.diag(
        numpy.concatenate([numpy.linspace(-8, -1, 20),
                           numpy.linspace(1, 50, 100)])
    )
    S = 0.05 * rng.randn(n, n)
    A = A + S + S.T
    b = rng.randn(n)
    U = rng.randn(n, 3)
    r1 = F.deflated_minres(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(U),
        tol=1e-10, maxiter=300, variant="1r",
    )
    assert int(r1.status) == F.CONVERGED
    rel = numpy.linalg.norm(
        b - A @ numpy.asarray(r1.x)
    ) / numpy.linalg.norm(b)
    assert rel < 1e-9
    # GMRES leg: long cycle stays orthogonal and in-complement
    Aspd = numpy.diag(numpy.linspace(0.01, 60, n)) + 0.02 * (S + S.T)
    rg = deflated_gmres(
        jnp.asarray(Aspd), jnp.asarray(b), jnp.asarray(U),
        tol=1e-12, maxiter=110, ortho="cgs2_1r",
    )
    rel = numpy.linalg.norm(
        b - Aspd @ numpy.asarray(rg.x)
    ) / numpy.linalg.norm(b)
    assert rel < 1e-11
