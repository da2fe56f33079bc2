"""Collective-count contracts for the full functional surface.

tests/test_collectives.py pins the latency model of the round-2 cores
(gmres/cg/ca_*/lsqr/chebyshev/poly-precond).  This file extends the
same compiled-HLO contract to everything added since: the sketched,
IDR(s), QMR, block, eigensolver and matrix-function lanes.  On a mesh
every all-reduce in the steady-state loop body is an interconnect round
trip, so the pinned number IS each solver's per-iteration sync cost --
a structural fact of the emitted HLO, not a prose claim.  The counts
are recorded in docs/DESIGN.md section 8's sync-point table.

Counting is done by :func:`tests.helpers.loop_body_allreduces`: only
while-loop ``body=`` computations count (ENTRY setup and rare
``lax.cond`` verification branches are excluded), and XLA's variadic
tuple all-reduces -- several reductions fused into one sync point --
count as one.

Where a lane is host-driven (eigs: host ordered Schur between device
sweeps, DESIGN section 7), the contract pins the jitted device sweep,
which is where all N-sized communication lives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from krypy_tpu import functional as F, ops, parallel
from krypy_tpu.functional.common import as_matvec
from krypy_tpu.functional.eigh import lanczos_1r_sweep, lanczos_cgs2_sweep

from helpers import loop_body_allreduces


@pytest.fixture(scope="module")
def mesh_and_problem():
    mesh = parallel.make_mesh(8)
    nx = 32
    lap = ops.poisson_2d(nx)
    cd = ops.convection_diffusion_2d(nx, wind=(1.0, 0.5), eps=1.0)
    b = parallel.shard_vector(jnp.ones(nx * nx, jnp.float32), mesh)
    return mesh, lap, cd, b


def _shard_columns(X, mesh):
    """(N, k) column blocks shard over N (axis 0); parallel.shard_vector
    shards the LAST axis (right for vectors and row-major bases)."""
    return jax.device_put(
        X, NamedSharding(mesh, P(mesh.axis_names[0], None))
    )


def test_sketched_gmres_two_collectives_per_iteration(mesh_and_problem):
    """Sketched GMRES syncs exactly TWICE per iteration: the k-row
    orthogonalization window contraction, then one variadic all-reduce
    fusing the sketch row (d, N) x (N,) with the norms.  One fewer
    round trip than cgs2's 3 -- and the basis traffic is O(k N) per
    iteration, not O(m N)."""
    mesh, lap, _, b = mesh_and_problem
    with mesh:
        f = jax.jit(lambda v: F.sketched_gmres(lap, v, tol=1e-6, maxiter=16))
    assert loop_body_allreduces(f, b, mesh=mesh) == 2


def test_idrs_sync_points_per_cycle(mesh_and_problem):
    """The IDR(s) loop body is one full cycle: s+1 matvecs with their
    shadow projections ((s, N) contractions), the smoothing and the
    residual norms -- 10 all-reduces per cycle at s=4, exactly 2 per
    matvec, matching CG's sync rate while handling nonsymmetric A."""
    mesh, lap, _, b = mesh_and_problem
    s = 4
    with mesh:
        f = jax.jit(lambda v: F.idrs(lap, v, s=s, tol=1e-6, maxiter=64))
    n = loop_body_allreduces(f, b, mesh=mesh)
    assert n == 10, n
    assert n / (s + 1) <= 2.0


def test_idrs_one_reduce_sync_points_per_matvec(mesh_and_problem):
    """idrs(variant='1r') communicates exactly ONCE per matvec -- s+1
    all-reduces per cycle (round 5, closing the last short-recurrence
    sync pole of the DESIGN section-8 table): each inner step's shadow
    projections, M-column, f/norm anchors and g-Gram couplings ride one
    (s+2+k, N) x (N, 2) contraction, and the omega step's norms fold
    with the NEXT cycle's f = P^H r into one (s+2, N) x (N, 2)
    cross-Gram.  Parity with classic on the same mesh problem."""
    mesh, lap, cd, b = mesh_and_problem
    s = 4
    with mesh:
        f1 = jax.jit(lambda v: F.idrs(cd, v, s=s, tol=1e-6, maxiter=200,
                                      variant="1r"))
        fc = jax.jit(lambda v: F.idrs(cd, v, s=s, tol=1e-6, maxiter=200))
    assert loop_body_allreduces(f1, b, mesh=mesh) == s + 1
    with mesh:
        r1 = f1(b)
        rc = fc(b)
    assert abs(int(r1.niter) - int(rc.niter)) <= s + 1
    assert float(
        jnp.linalg.norm(r1.x - rc.x) / jnp.linalg.norm(rc.x)
    ) <= 1e-3


def test_idrs_auto_priced_regimes(mesh_and_problem, monkeypatch):
    """idrs variant='auto' prices through the shared model: an
    expensive sync resolves to '1r', a free sync to 'classic' -- each
    bitwise equal to the explicit spelling."""
    from krypy_tpu.functional import policy

    mesh, lap, _, b = mesh_and_problem
    with mesh:
        r_classic = jax.jit(
            lambda v: F.idrs(lap, v, s=4, tol=1e-4, maxiter=120)
        )(b)
        r_1r = jax.jit(
            lambda v: F.idrs(lap, v, s=4, tol=1e-4, maxiter=120,
                             variant="1r")
        )(b)
    monkeypatch.setattr(policy, "SYNC_S", 1.0)
    with mesh:
        r_lat = jax.jit(
            lambda v: F.idrs(lap, v, s=4, tol=1e-4, maxiter=120,
                             variant="auto")
        )(b)
    assert float(jnp.linalg.norm(r_lat.x - r_1r.x)) == 0.0
    monkeypatch.setattr(policy, "SYNC_S", 0.0)
    with mesh:
        r_bw = jax.jit(
            lambda v: F.idrs(lap, v, s=4, tol=1e-4, maxiter=120,
                             variant="auto")
        )(b)
    assert float(jnp.linalg.norm(r_bw.x - r_classic.x)) == 0.0
    monkeypatch.setattr(policy, "SYNC_S", None)


def test_qmr_sync_points_and_sharded_equivalence(mesh_and_problem):
    """QMR's coupled two-sided Lanczos step costs exactly 4 all-reduces
    (the biorthogonality coupling <w, v>, the A- and A^T-side
    normalizations, and the residual-tracking norm); and the sharded
    solve matches the single-device solve to fp on a nonsymmetric
    operator."""
    mesh, _, cd, b = mesh_and_problem
    with mesh:
        f = jax.jit(lambda v: F.qmr(cd, v, tol=1e-6, maxiter=64))
    assert loop_body_allreduces(f, b, mesh=mesh) == 4
    with mesh:
        sharded = f(b)
    plain = F.qmr(cd, jnp.ones(b.shape[0], jnp.float32), tol=1e-6,
                  maxiter=64)
    assert int(sharded.niter) == int(plain.niter)
    assert float(jnp.linalg.norm(sharded.x - plain.x)) <= 1e-5 * float(
        jnp.linalg.norm(plain.x)
    )


def test_qmr_one_reduce_single_collective_per_iteration(mesh_and_problem):
    """qmr(variant='1r') communicates exactly ONCE per iteration
    (VERDICT r4 #5, beating the 4 -> 2 target): all couplings of the
    two-sided step ride one (9, N) x (N, 6) cross-Gram -- the
    biorthogonality delta is carried one step, both Lanczos norms and
    the residual norm come from measured-anchor expansions (the MINRES
    nu lesson: the anchors <v,v>, <w,w>, w^T v, <r,r> are measured in
    the SAME Gram so expansion error never compounds)."""
    mesh, _, cd, b = mesh_and_problem
    with mesh:
        f1 = jax.jit(lambda v: F.qmr(cd, v, tol=1e-6, maxiter=64,
                                     variant="1r"))
        fc = jax.jit(lambda v: F.qmr(cd, v, tol=1e-6, maxiter=64))
    assert loop_body_allreduces(f1, b, mesh=mesh) == 1
    with mesh:
        r1 = f1(b)
        rc = fc(b)
    assert int(r1.niter) == int(rc.niter)
    assert float(
        jnp.linalg.norm(r1.x - rc.x) / jnp.linalg.norm(rc.x)
    ) <= 1e-3


def test_lobpcg_sync_points_per_block_iteration(mesh_and_problem):
    """One LOBPCG iteration moves the whole 3k-direction trial space
    through 10 all-reduces (trial-block Grams for the Rayleigh-Ritz,
    SVQB panel Gram, residual norms) -- amortized 10/k per eigenpair,
    the point of the block method.  The iteration work lives in the
    active-iteration lax.cond branch (locking), hence
    include_branches."""
    mesh, lap, _, b = mesh_and_problem
    N = b.shape[0]
    X0 = _shard_columns(
        jnp.arange(1.0, 4 * N + 1.0, dtype=jnp.float32).reshape(N, 4) / N,
        mesh,
    )
    with mesh:
        f = jax.jit(lambda X: F.lobpcg(lap, 4, X0=X, tol=1e-6, maxiter=32))
    assert loop_body_allreduces(f, X0, mesh=mesh, include_branches=True) == 10


def test_lobpcg_fused_sync_points_per_block_iteration(mesh_and_problem):
    """lobpcg(variant='fused') moves the whole 3k-direction advance
    through THREE stacked cross-Grams (projection+refs, projection2+
    SVQB1, SVQB2+Rayleigh-Ritz), so a block iteration costs 3 sync
    points instead of 10 (VERDICT r4 #5) -- amortized 3/k per pair.
    Same Ritz values as classic on an f64 oracle."""
    mesh, lap, _, b = mesh_and_problem
    N = b.shape[0]
    X0 = _shard_columns(
        jnp.arange(1.0, 4 * N + 1.0, dtype=jnp.float32).reshape(N, 4) / N,
        mesh,
    )
    with mesh:
        f = jax.jit(lambda X: F.lobpcg(lap, 4, X0=X, tol=1e-6,
                                       maxiter=32, variant="fused"))
    assert loop_body_allreduces(
        f, X0, mesh=mesh, include_branches=True
    ) <= 4
    # numerics parity on a small f64 oracle (f32 long unpreconditioned
    # runs are fragile in BOTH variants -- documented lane caveat)
    import numpy as np

    rng = np.random.RandomState(5)
    A = np.diag(np.linspace(0.1, 30, 120))
    S = 0.02 * rng.randn(120, 120)
    A = jnp.asarray(A + S + S.T)
    rc = F.lobpcg(A, 4, n=120, tol=1e-9, maxiter=300)
    rf = F.lobpcg(A, 4, n=120, tol=1e-9, maxiter=300, variant="fused")
    assert bool(rc.converged) and bool(rf.converged)
    assert float(jnp.abs(rc.theta - rf.theta).max()) < 1e-7


def test_eigsh_sync_points_per_lanczos_step(mesh_and_problem):
    """Thick-restart Lanczos pays the full-CGS2 sweep cost: 2 fused
    projection passes + the norm = 3 all-reduces per step."""
    mesh, lap, _, b = mesh_and_problem
    with mesh:
        f = jax.jit(lambda v: F.eigsh(lap, 4, v0=v, tol=1e-6,
                                      max_restarts=16))
    assert loop_body_allreduces(f, b, mesh=mesh) == 3


def test_eigsh_one_reduce_sync_points_and_parity(mesh_and_problem):
    """eigsh(ortho='cgs2_1r') communicates exactly ONCE per Lanczos
    step (round 5): the lagged DCGS-2 sweep
    (eigh.lanczos_1r_sweep) fuses the delayed reorthogonalization
    pass, the Pythagorean norm and the new direction's first pass into
    one (m+1, N) x (N, 2) contraction; the peel/seal contractions live
    in the restart branch outside the loop body.  Eigenvalue parity
    with classic on the mesh problem."""
    mesh, lap, _, b = mesh_and_problem
    with mesh:
        f1 = jax.jit(lambda v: F.eigsh(lap, 4, v0=v, tol=1e-6,
                                       max_restarts=16,
                                       ortho="cgs2_1r"))
        fc = jax.jit(lambda v: F.eigsh(lap, 4, v0=v, tol=1e-6,
                                       max_restarts=16))
    assert loop_body_allreduces(f1, b, mesh=mesh) == 1
    with mesh:
        r1 = f1(b)
        rc = fc(b)
    assert bool(r1.converged) == bool(rc.converged)
    # f32 at tol=1e-6 on the square Laplacian's DEGENERATE pairs: the
    # two sweeps land ~1e-4-relative apart within the converged cluster
    np.testing.assert_allclose(
        np.asarray(r1.theta), np.asarray(rc.theta), rtol=1e-3
    )


def test_eigs_device_sweep_sync_points(mesh_and_problem):
    """eigs is host-driven (ordered Schur on host, DESIGN section 7);
    all N-sized communication is the shared CGS2 Arnoldi sweep, pinned
    here in the complex dtype eigs actually runs in: 3 per step."""
    mesh, lap, _, b = mesh_and_problem
    N = b.shape[0]
    m = 16
    A_mv = as_matvec(lap)
    dt, rdt = jnp.complex64, jnp.float32

    def cmv(x):
        return A_mv(x.real).astype(dt) + 1j * A_mv(x.imag).astype(dt)

    V0 = jnp.zeros((m + 1, N), dt).at[0].set(
        (b / jnp.linalg.norm(b)).astype(dt)
    )
    H0 = jnp.zeros((m + 1, m), dt)
    with mesh:
        V0 = jax.device_put(V0)
        sweep = jax.jit(
            lambda V, H: lanczos_cgs2_sweep(cmv, V, H, 0, m, dt, rdt)
        )
    assert loop_body_allreduces(sweep, V0, H0, mesh=mesh) == 3


def test_eigs_one_reduce_device_sweep_and_parity(mesh_and_problem):
    """The lagged one-reduce sweep serves the NON-Hermitian Arnoldi
    users too (its lag algebra never assumes Hermitian H): pinned at 1
    all-reduce per step in eigs's complex dtype, and the full
    eigs(ortho='cgs2_1r') driver returns the classic spectrum."""
    mesh, lap, cd, b = mesh_and_problem
    N = b.shape[0]
    m = 16
    A_mv = as_matvec(lap)
    dt, rdt = jnp.complex64, jnp.float32

    def cmv(x):
        return A_mv(x.real).astype(dt) + 1j * A_mv(x.imag).astype(dt)

    V0 = jnp.zeros((m + 1, N), dt).at[0].set(
        (b / jnp.linalg.norm(b)).astype(dt)
    )
    H0 = jnp.zeros((m + 1, m), dt)
    with mesh:
        V0 = jax.device_put(V0)
        sweep = jax.jit(
            lambda V, H: lanczos_1r_sweep(cmv, V, H, 0, m, dt, rdt)
        )
    assert loop_body_allreduces(sweep, V0, H0, mesh=mesh) == 1

    v0 = jnp.ones(N, jnp.float32)
    plain = F.eigs(cd, 4, v0=v0, which="lr", tol=1e-8, max_restarts=40)
    with mesh:
        onered = F.eigs(cd, 4, v0=b, which="lr", tol=1e-8,
                        max_restarts=40, ortho="cgs2_1r")
    assert plain.converged and onered.converged
    np.testing.assert_allclose(
        np.sort_complex(np.asarray(onered.theta)),
        np.sort_complex(np.asarray(plain.theta)),
        rtol=1e-4,
    )


def test_eigs_sharded_equivalence(mesh_and_problem):
    """The full eigs driver under a mesh context (device sweeps GSPMD-
    sharded, host Schur unchanged) returns the same spectrum as the
    single-device run."""
    mesh, _, cd, b = mesh_and_problem
    v0 = jnp.ones(b.shape[0], jnp.float32)
    plain = F.eigs(cd, 4, v0=v0, which="lr", tol=1e-8, max_restarts=40)
    with mesh:
        sharded = F.eigs(cd, 4, v0=b, which="lr", tol=1e-8,
                         max_restarts=40)
    assert plain.converged and sharded.converged
    np.testing.assert_allclose(
        np.sort_complex(np.asarray(sharded.theta)),
        np.sort_complex(np.asarray(plain.theta)),
        rtol=1e-4,
    )


def test_funm_krylov_sync_points_per_step(mesh_and_problem):
    """funm_krylov shares eigsh's sweep: 3 all-reduces per Lanczos
    step; the f(T) evaluation is replicated small-dense work with no
    collectives."""
    mesh, lap, _, b = mesh_and_problem
    with mesh:
        f = jax.jit(lambda v: F.funm_krylov(lap, v, jnp.exp, maxdim=16))
    assert loop_body_allreduces(f, b, mesh=mesh) == 3


def test_funm_krylov_one_reduce_sync_points_and_parity(mesh_and_problem):
    """funm_krylov(ortho='cgs2_1r') rides the one-reduce lagged sweep:
    1 all-reduce per Lanczos step, f(A)b parity with classic."""
    mesh, lap, _, b = mesh_and_problem
    fun = lambda w: 1.0 / jnp.sqrt(w)  # noqa: E731
    with mesh:
        f1 = jax.jit(lambda v: F.funm_krylov(lap, v, fun, maxdim=16,
                                             ortho="cgs2_1r"))
        fc = jax.jit(lambda v: F.funm_krylov(lap, v, fun, maxdim=16))
    assert loop_body_allreduces(f1, b, mesh=mesh) == 1
    with mesh:
        r1 = f1(b)
        rc = fc(b)
    assert float(
        jnp.linalg.norm(r1.x - rc.x) / jnp.linalg.norm(rc.x)
    ) <= 1e-5


def test_block_cg_two_collectives_per_block_step(mesh_and_problem):
    """block_cg advances ALL k right-hand sides with exactly 2
    all-reduces per block step: XLA fuses the direction and residual
    (k, N) x (N, k) Grams pairwise into two variadic sync points --
    amortized 2/k per system vs 2 for single-vector CG."""
    mesh, lap, _, b = mesh_and_problem
    N = b.shape[0]
    Bk = _shard_columns(jnp.ones((N, 4), jnp.float32), mesh)
    with mesh:
        f = jax.jit(lambda Bm: F.block_cg(lap, Bm, tol=1e-6, maxiter=64))
    assert loop_body_allreduces(f, Bk, mesh=mesh) == 2


def test_block_gmres_two_collectives_per_block_step(mesh_and_problem):
    """Block Arnoldi: the two panel-blocked Gram-Schmidt passes emit 2
    all-reduces per block step (the panel Gram factorization is
    replicated small-dense), amortized 2/k per system vs 3 for cgs2
    GMRES."""
    mesh, lap, _, b = mesh_and_problem
    N = b.shape[0]
    Bk = _shard_columns(jnp.ones((N, 4), jnp.float32), mesh)
    with mesh:
        f = jax.jit(lambda Bm: F.block_gmres(lap, Bm, tol=1e-6,
                                             maxiter=16))
    assert loop_body_allreduces(f, Bk, mesh=mesh) == 2
