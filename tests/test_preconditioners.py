"""Preconditioner gallery tests: Jacobi, Chebyshev, geometric multigrid,
DST fast-Poisson solver."""

import numpy
import pytest
import jax.numpy as jnp

from krypy_tpu import functional as F, ops


def test_chebyshev_preconditioner_spd_and_effective():
    n = 64
    lap = ops.poisson_1d(n)
    h = 1.0 / (n + 1)
    lmin = float(4 * numpy.sin(numpy.pi * h / 2) ** 2 / h**2)
    lmax = float(4 * numpy.cos(numpy.pi * h / 2) ** 2 / h**2)
    M = ops.chebyshev_preconditioner(lap, degree=6, lmin=lmin, lmax=lmax)
    # SPD check via dense assembly
    dense = numpy.column_stack(
        [numpy.asarray(M(jnp.eye(n)[:, j])) for j in range(n)]
    )
    numpy.testing.assert_allclose(dense, dense.T, atol=1e-10)
    assert numpy.linalg.eigvalsh(dense).min() > 0
    # CG with Chebyshev needs substantially fewer iterations on a random
    # (non-smooth) right hand side
    rng = numpy.random.RandomState(3)
    b = jnp.asarray(rng.randn(n))
    plain = F.cg(lap, b, tol=1e-10, maxiter=300)
    cheb = F.cg(lap, b, M=M, tol=1e-10, maxiter=300)
    assert int(cheb.status) == F.CONVERGED
    assert int(cheb.niter) <= int(plain.niter) // 2


@pytest.mark.parametrize("nx", [31, 63, 127])
def test_multigrid_mesh_independent(nx):
    lap = ops.poisson_2d(nx)
    M = ops.multigrid_poisson_preconditioner(nx)
    res = F.cg(lap, jnp.ones(nx * nx), M=M, tol=1e-10, maxiter=30)
    assert int(res.status) == F.CONVERGED
    # mesh-independent iteration count
    assert int(res.niter) <= 10
    x = numpy.asarray(res.x)
    b = numpy.ones(nx * nx)
    rel = numpy.linalg.norm(
        b - numpy.asarray(lap(jnp.asarray(x)))
    ) / numpy.linalg.norm(b)
    assert rel <= 1e-9


def test_multigrid_requires_nested_grid():
    with pytest.raises(ValueError):
        ops.multigrid_poisson_preconditioner(100)


@pytest.mark.parametrize("nx,ny", [(31, 31), (15, 31), (63, 31)])
def test_dst_solver_exact(nx, ny):
    dst = ops.poisson_dst_solver(nx, ny)
    lap = ops.poisson_2d(nx, ny)
    rng = numpy.random.RandomState(0)
    b = jnp.asarray(rng.randn(nx * ny))
    x = dst(b)
    rel = float(jnp.linalg.norm(lap(x) - b) / jnp.linalg.norm(b))
    assert rel <= 1e-12


def test_multigrid_with_dst_coarse():
    nx = 63
    lap = ops.poisson_2d(nx)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_solver="dst"
    )
    res = F.cg(lap, jnp.ones(nx * nx), M=M, tol=1e-10, maxiter=20)
    assert int(res.status) == F.CONVERGED
    assert int(res.niter) <= 8


def test_ssor_preconditioner_spd_and_accelerates_cg():
    """Red-black SSOR: symmetric (the forward+backward sweep order),
    positive definite, and roughly halves CG iterations vs Jacobi on
    the Poisson system."""
    import numpy

    nx = 48
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx)
    Ms = ops.ssor_poisson_preconditioner(nx)
    rng = numpy.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(nx * nx))
    v = jnp.asarray(rng.standard_normal(nx * nx))
    s1 = float(jnp.vdot(u, Ms(v)))
    s2 = float(jnp.vdot(Ms(u), v))
    assert abs(s1 - s2) <= 1e-12 * abs(s1)
    assert float(jnp.vdot(u, Ms(u))) > 0

    rj = F.cg(lap, b, M=ops.jacobi_preconditioner(lap), tol=1e-8,
              maxiter=3000)
    rs = F.cg(lap, b, M=Ms, tol=1e-8, maxiter=3000)
    assert int(rs.status) == 0
    assert int(rs.niter) < 0.7 * int(rj.niter)
    # CG stops on the M-weighted residual; the Euclidean true residual
    # may sit an epsilon over the tolerance
    rel = float(jnp.linalg.norm(b - lap(rs.x)) / jnp.linalg.norm(b))
    assert rel <= 5e-8


def test_ssor_preconditioner_rectangular_and_sweeps():
    nx, ny = 24, 40
    lap = ops.poisson_2d(nx, ny)
    b = jnp.ones(nx * ny)
    M1 = ops.ssor_poisson_preconditioner(nx, ny, sweeps=1)
    M2 = ops.ssor_poisson_preconditioner(nx, ny, sweeps=3)
    r1 = F.cg(lap, b, M=M1, tol=1e-8, maxiter=2000)
    r2 = F.cg(lap, b, M=M2, tol=1e-8, maxiter=2000)
    assert int(r1.status) == 0 and int(r2.status) == 0
    assert int(r2.niter) <= int(r1.niter)  # more sweeps, fewer iters


def test_multigrid_rbgs_smoother_symmetric_and_effective():
    """smoother='rbgs': red-black GS smoothing with reversed-color
    post-sweeps and palindromic coarse sweeps keeps the V-cycle exactly
    symmetric (valid CG preconditioner) and converges in no more outer
    iterations than damped Jacobi."""
    import numpy

    nx = 127
    lap = ops.poisson_2d(nx)
    b = jnp.ones(nx * nx)
    mg_j = ops.multigrid_poisson_preconditioner(nx)
    mg_g = ops.multigrid_poisson_preconditioner(nx, smoother="rbgs")
    rj = F.cg(lap, b, M=mg_j, tol=1e-10, maxiter=100)
    rg = F.cg(lap, b, M=mg_g, tol=1e-10, maxiter=100)
    assert int(rg.status) == 0
    assert int(rg.niter) <= int(rj.niter)

    rng = numpy.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(nx * nx))
    v = jnp.asarray(rng.standard_normal(nx * nx))
    s1 = float(jnp.vdot(u, mg_g(v)))
    s2 = float(jnp.vdot(mg_g(u), v))
    assert abs(s1 - s2) <= 1e-12 * abs(s1)

    with pytest.raises(ValueError, match="smoother"):
        ops.multigrid_poisson_preconditioner(nx, smoother="zz")


def test_multigrid_cg_on_mesh_matches_single_device():
    """The full production stack -- multigrid-preconditioned CG -- on
    the 8-device mesh: the V-cycle's grid transfers and smoothers must
    partition under GSPMD and reproduce the single-device solve
    (tol above the f32 floor, stagnation-guarded -- below the floor BOTH
    lanes diverge identically, which is the documented f32 behavior)."""
    from krypy_tpu import parallel
    import jax

    nx = 63
    N = nx * nx
    mesh = parallel.make_mesh(8)
    lap = ops.poisson_2d(nx)
    mg = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=30
    )
    b1 = jnp.ones(N, jnp.float32)
    ref = F.cg(lap, b1, M=mg, tol=1e-5, maxiter=50, stagnation_window=6)
    b = parallel.shard_vector(b1, mesh)
    with mesh:
        res = jax.jit(
            lambda bb: F.cg(lap, bb, M=mg, tol=1e-5, maxiter=50,
                            stagnation_window=6)
        )(b)
    assert int(res.status) == F.CONVERGED
    assert int(res.niter) == int(ref.niter)
    assert len({s.device for s in res.x.addressable_shards}) == 8
    rel = float(
        jnp.linalg.norm(lap(res.x.astype(jnp.float64)) - b1)
        / jnp.linalg.norm(b1)
    )
    assert rel < 1e-4
    numpy.testing.assert_allclose(
        numpy.asarray(res.x), numpy.asarray(ref.x), rtol=1e-4, atol=1e-6
    )


def _graph_laplacian(N=2000, band=40, deg=8, seed=11):
    """Irregular (non-grid) SPD graph Laplacian with local-ish coupling
    -- the unstructured-operator regime the grid gallery can't serve."""
    import scipy.sparse as sp

    rng = numpy.random.default_rng(seed)
    rows = numpy.repeat(numpy.arange(N), deg)
    cols = (rows + rng.integers(1, band, size=rows.size)) % N
    W = sp.coo_matrix(
        (rng.uniform(0.5, 2.0, rows.size), (rows, cols)), shape=(N, N)
    )
    W = W + W.T
    L = sp.diags(numpy.asarray(W.sum(axis=1)).ravel()) - W
    return (L + 1e-2 * sp.eye(N)).tocsr()


def test_block_jacobi_exact_block_solves():
    """M x equals the dense per-block solve, including a padded
    trailing block (N not divisible by block_size)."""
    A = _graph_laplacian(N=333)
    M = ops.block_jacobi_preconditioner(A, block_size=40)
    rng = numpy.random.default_rng(0)
    x = rng.standard_normal(333)
    Ad = A.toarray()
    ref = numpy.zeros(333)
    for i in range(0, 333, 40):
        j = min(i + 40, 333)
        ref[i:j] = numpy.linalg.solve(Ad[i:j, i:j], x[i:j])
    numpy.testing.assert_allclose(
        numpy.asarray(M(jnp.asarray(x))), ref, rtol=1e-12
    )


def test_block_jacobi_accepts_bcoo_matvec_and_beats_jacobi():
    """From the BCOO matvec (sparse_from_scipy) the same blocks are
    extracted, and CG takes strictly fewer iterations than with point
    Jacobi on the irregular-graph Laplacian."""
    A = _graph_laplacian()
    Amv = ops.sparse_from_scipy(A)
    b = jnp.ones(A.shape[0], jnp.float64)
    Mj = ops.jacobi_preconditioner(Amv)
    Mbj = ops.block_jacobi_preconditioner(Amv, block_size=40)
    rj = F.cg(Amv, b, M=Mj, tol=1e-8, maxiter=2000)
    rb = F.cg(Amv, b, M=Mbj, tol=1e-8, maxiter=2000)
    assert bool(rj.converged) and bool(rb.converged)
    assert int(rb.niter) < int(rj.niter), (int(rb.niter), int(rj.niter))
    # and through the config-3 solver stack (right-preconditioned GMRES)
    rg = F.gmres(Amv, b, Mr=Mbj, tol=1e-8, maxiter=400)
    rgj = F.gmres(Amv, b, Mr=Mj, tol=1e-8, maxiter=400)
    assert int(rg.niter) < int(rgj.niter)


def test_block_jacobi_singular_block_shift():
    """An indefinite operator whose diagonal block is exactly singular
    factors once `shift` regularizes it."""
    import scipy.sparse as sp

    d = numpy.r_[numpy.zeros(4), numpy.linspace(1, 2, 28)]
    A = sp.diags(d).tocsr()
    M = ops.block_jacobi_preconditioner(A, block_size=4, shift=1e-3)
    y = M(jnp.ones(32))
    assert bool(jnp.all(jnp.isfinite(y)))


def test_block_jacobi_adds_no_collectives():
    """The batched block apply is shard-local: preconditioned CG emits
    exactly as many all-reduces per iteration as point-Jacobi CG on a
    mesh."""
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from helpers import loop_body_allreduces

    import jax

    from krypy_tpu import parallel

    A = _graph_laplacian(N=2048)
    Amv = ops.sparse_from_scipy(A)
    mesh = parallel.make_mesh(8)
    b = parallel.shard_vector(jnp.ones(2048, jnp.float64), mesh)
    Mj = ops.jacobi_preconditioner(Amv)
    Mbj = ops.block_jacobi_preconditioner(Amv, block_size=32)
    with mesh:
        fj = jax.jit(lambda v: F.cg(Amv, v, M=Mj, tol=1e-8, maxiter=64))
        fb = jax.jit(lambda v: F.cg(Amv, v, M=Mbj, tol=1e-8, maxiter=64))
    assert loop_body_allreduces(fb, b, mesh=mesh) == loop_body_allreduces(
        fj, b, mesh=mesh
    )


def test_dia_from_scipy_exact_and_sharded():
    """DIA (roll-based, gather-free) matvec is exact to the last bit vs
    scipy, exposes .diag/.shape, shards with neighbor permutes only,
    and feeds block-Jacobi through .scipy_matrix."""
    import jax

    from krypy_tpu import parallel

    A = _graph_laplacian(N=4096)
    Amv = ops.dia_from_scipy(A)
    rng = numpy.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(4096))
    assert float(
        numpy.abs(numpy.asarray(Amv(x)) - A @ numpy.asarray(x)).max()
    ) == 0.0
    numpy.testing.assert_array_equal(
        numpy.asarray(Amv.diag), A.diagonal()
    )
    mesh = parallel.make_mesh(8)
    with mesh:
        xs = parallel.shard_vector(x, mesh)
        ys = jax.jit(Amv)(xs)
    assert float(
        numpy.abs(numpy.asarray(ys) - A @ numpy.asarray(x)).max()
    ) == 0.0
    Mbj = ops.block_jacobi_preconditioner(Amv, block_size=32)
    r = F.cg(Amv, jnp.ones(4096), M=Mbj, tol=1e-8, maxiter=500)
    assert bool(r.converged)


def test_dia_sharded_lowers_to_neighbor_permutes():
    """HLO pin for the DIA mesh claim: the rolls of the sharded matvec
    lower to collective-permutes (neighbor traffic on the interconnect), never to
    all-gathers or all-reduces."""
    import re

    import jax
    import scipy.sparse as sp

    from krypy_tpu import parallel

    N = 4096
    A = sp.diags(
        [numpy.full(N, 4.0), -numpy.ones(N - 1), -numpy.ones(N - 1)],
        [0, 1, -1],
    ).tocsr()
    Amv = ops.dia_from_scipy(A)
    mesh = parallel.make_mesh(8)
    x = parallel.shard_vector(jnp.ones(N, jnp.float32), mesh)
    with mesh:
        txt = jax.jit(Amv).lower(x).compile().as_text()
    assert len(re.findall(r"collective-permute", txt)) > 0
    assert len(re.findall(r"all-gather", txt)) == 0
    assert len(re.findall(r"all-reduce", txt)) == 0


def test_dia_from_scipy_wraparound_and_guard():
    """Periodic (ring) couplings land on their own far diagonals and
    stay exact; a dense-ish matrix trips the max_diags guard."""
    import scipy.sparse as sp

    n = 64
    A = sp.diags(
        [numpy.full(n, 2.0), -numpy.ones(n - 1), -numpy.ones(n - 1),
         [-1.0], [-1.0]],
        [0, 1, -1, n - 1, -(n - 1)],
    ).tocsr()
    Amv = ops.dia_from_scipy(A)
    x = jnp.asarray(numpy.random.default_rng(0).standard_normal(n))
    assert float(
        numpy.abs(numpy.asarray(Amv(x)) - A @ numpy.asarray(x)).max()
    ) < 1e-14
    with pytest.raises(ValueError, match="max_diags"):
        ops.dia_from_scipy(
            sp.random(256, 256, 0.4, random_state=0), max_diags=32
        )


def test_spai_exact_on_representable_inverses():
    """When the pattern can represent A^{-1} exactly, SPAI delivers it
    (diagonal A; complex shifted diagonal), and the certificate says so."""
    import scipy.sparse as sp

    d = numpy.linspace(1.0, 5.0, 50)
    M = ops.spai_preconditioner(sp.diags(d).tocsr())
    assert M.spai_residual < 1e-10
    x = jnp.asarray(numpy.random.default_rng(0).standard_normal(50))
    numpy.testing.assert_allclose(
        numpy.asarray(M(x)), numpy.asarray(x) / d, rtol=1e-10
    )
    C = sp.diags(d[:32]).tocsr().astype(numpy.complex128) + 2j * sp.eye(32)
    Mc = ops.spai_preconditioner(C)
    assert Mc.spai_residual < 1e-10


def _nonsym_graph_operator(N=2048, seed=3):
    import scipy.sparse as sp

    rng = numpy.random.default_rng(seed)
    rows = numpy.repeat(numpy.arange(N), 6)
    cols = (rows + rng.integers(1, 24, rows.size)) % N
    W = sp.coo_matrix(
        (rng.uniform(0.5, 2.0, rows.size), (rows, cols)), shape=(N, N)
    )
    deg = numpy.asarray(W.sum(axis=1)).ravel() + numpy.asarray(
        W.sum(axis=0)
    ).ravel()
    return (
        sp.diags(deg) - 1.7 * W - 0.3 * W.T + 0.5 * sp.eye(N)
    ).tocsr()


def test_spai_beats_jacobi_on_nonsymmetric_unstructured():
    """SPAI (right) preconditioning on a convection-dominated irregular
    graph operator: fewer GMRES iterations than Jacobi; pattern='A2'
    fewer still, with a monotone certificate."""
    A = _nonsym_graph_operator()
    Amv = ops.dia_from_scipy(A)
    Ms = ops.spai_preconditioner(Amv)          # accepts the matvec form
    M2 = ops.spai_preconditioner(A, pattern="A2")
    assert 0 < M2.spai_residual < Ms.spai_residual < 1
    b = jnp.ones(A.shape[0], jnp.float64)
    kw = dict(tol=1e-8, maxiter=400)
    gj = F.gmres(Amv, b, Mr=ops.jacobi_preconditioner(Amv), **kw)
    gs = F.gmres(Amv, b, Mr=Ms, **kw)
    g2 = F.gmres(Amv, b, Mr=M2, **kw)
    assert bool(gs.converged) and bool(g2.converged)
    assert int(gs.niter) < 0.7 * int(gj.niter)
    assert int(g2.niter) < int(gs.niter)
    # certificate: residual of the solve is genuine
    x = numpy.asarray(gs.x)
    rel = numpy.linalg.norm(b - A @ x) / numpy.linalg.norm(
        numpy.asarray(b)
    )
    assert rel <= 1e-7


def test_spai_sharded_adds_no_collectives():
    """The SPAI application is a plain sparse matvec: a preconditioned
    GMRES iteration emits exactly as many all-reduces as a plain one."""
    import jax

    from krypy_tpu import parallel
    from helpers import loop_body_allreduces

    A = _nonsym_graph_operator(N=4096)
    Amv = ops.dia_from_scipy(A)
    Ms = ops.spai_preconditioner(A)
    mesh = parallel.make_mesh(8)
    b = parallel.shard_vector(jnp.ones(4096, jnp.float32), mesh)
    with mesh:
        plain = jax.jit(
            lambda v: F.gmres(Amv, v, tol=1e-6, maxiter=16, ortho="cgs2")
        )
        prec = jax.jit(
            lambda v: F.gmres(Amv, v, Mr=Ms, tol=1e-6, maxiter=16,
                              ortho="cgs2")
        )
        r = prec(b)
    assert loop_body_allreduces(prec, b, mesh=mesh) == loop_body_allreduces(
        plain, b, mesh=mesh
    )
    assert numpy.isfinite(float(r.resnorms[int(r.niter)]))


def test_spai_format_and_validation():
    import scipy.sparse as sp

    A = _nonsym_graph_operator(N=512)
    Mb = ops.spai_preconditioner(A, format="bcoo")
    Md = ops.spai_preconditioner(A, format="dia")
    x = jnp.asarray(numpy.random.default_rng(1).standard_normal(512))
    numpy.testing.assert_allclose(
        numpy.asarray(Mb(x)), numpy.asarray(Md(x)), rtol=1e-6, atol=1e-9
    )
    with pytest.raises(ValueError, match="pattern"):
        ops.spai_preconditioner(A, pattern="bogus")
    with pytest.raises(ValueError, match="format"):
        ops.spai_preconditioner(A, format="bogus")
    # dense input path
    Mdense = ops.spai_preconditioner(numpy.diag(numpy.arange(1.0, 9.0)))
    assert Mdense.spai_residual < 1e-10
