#!/usr/bin/env python
"""Headline benchmark: wall-time to 1e-8 relative residual on a 1M-dof
2-D Poisson system (BASELINE.md north star), krypy_tpu on the
accelerator vs SciPy-CPU.

Prints ONE JSON line:
    {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup,
     "device": {"platform", "kind", "count"}, ...}

Method (device): mixed-precision iterative refinement -- float32 inner CG
preconditioned with a geometric multigrid V-cycle (mesh-independent ~8
iterations, all fused stencil work), the whole refinement one compiled
while_loop; the residual is recomputed in float64 between refinements
until the float64 relative residual is <= 1e-8.  Bulk traffic in f32,
accuracy restored by f64 outer correction.  A run that finds no GPU
exits non-zero.

Baselines (CPU), BOTH reported in the JSON line:

* ``vs_scipy_best`` (also mirrored as ``vs_baseline``): scipy.sparse CG
  with a Jacobi preconditioner at tol=1e-8 on the same operator (CSR) --
  the strongest solver scipy SHIPS for this problem (scipy has no
  multigrid).  If the full scipy solve would take too long it is measured
  over a fixed iteration budget and extrapolated linearly in iteration
  count (CG cost per iteration is constant); the ``extrapolated`` flag in
  the JSON says whether that happened.  This number mixes algorithm and
  hardware advantage.
* ``vs_scipy_same_algorithm``: scipy CG preconditioned with the SAME
  geometric multigrid V-cycle (vectorized numpy, float64), measured to
  convergence -- hardware+framework advantage only.
"""

import json
import os
import sys
import time

os.environ.setdefault("KRYPY_TPU_X64", "1")

import numpy as np

import jax
import jax.numpy as jnp


def build_problem(nx):
    """Returns (lap, b64, N).  The stencil's matvec dtype follows its
    input, so one operator serves the f32 inner solve and the f64 outer
    residual."""
    from krypy_tpu import ops

    lap = ops.poisson_2d(nx)
    N = nx * nx
    b64 = jnp.ones(N, jnp.float64)
    return lap, b64, N


def device_solve(lap, b64, nx, tol=1e-8, inner_tol=1e-4,
                 inner_maxiter=12):
    """Mixed-precision multigrid-CG via functional.refine_to; returns
    (x64, rel_res, wall_seconds, inner_iterations).

    The V-cycle coarsens to a 31-grid (deeper levels are latency-bound on
    the accelerator: tiny grids cost fixed per-op overhead, so a heavier
    smoothed coarse solve wins); inner tolerance 1e-4 stays above the
    float32 attainable-accuracy floor, each refinement contributing ~4
    orders of magnitude."""
    from krypy_tpu import functional as F, ops

    Mmg = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60
    )

    @jax.jit
    def inner_solve(r32):
        return F.cg(
            lap, r32, M=Mmg, tol=inner_tol, maxiter=inner_maxiter,
            stagnation_window=4,
        )

    def timed_solve(bb):
        # compiled=True runs the WHOLE refinement as one while_loop
        # (one dispatch + one fetch); its first call warms the compile
        result, info = F.refine_to(lap, bb, inner_solve, tol=tol,
                                   compiled=True)
        rel = float(jnp.nanmin(result.resnorms))
        return result.x, rel, info["wall_s"], info["inner_iters"]

    # best of 3; ALL three walls are reported (wall_s_all in the JSON)
    # so the spread is visible
    runs = [timed_solve(b64) for _ in range(3)]
    best = min(runs, key=lambda t: t[2])
    return best + ([r[2] for r in runs],)


def scipy_baseline(nx, tol=1e-8, budget_iters=400):
    """SciPy CSR Jacobi-CG; extrapolated if the full solve exceeds the
    iteration budget."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    N = nx * nx
    h2 = (1.0 / (nx + 1)) ** 2
    main = 4.0 * np.ones(N) / h2
    off1 = -np.ones(N - 1) / h2
    # break x-neighbor coupling across row boundaries
    off1[np.arange(1, nx * nx) % nx == 0] = 0.0
    offn = -np.ones(N - nx) / h2
    A = sp.diags(
        [main, off1, off1, offn, offn], [0, 1, -1, nx, -nx], format="csr"
    )
    b = np.ones(N)
    Minv = sp.diags(1.0 / main)

    count = {"n": 0}

    def cb(xk):
        count["n"] += 1

    t0 = time.perf_counter()
    x, info = spla.cg(
        A, b, rtol=tol, maxiter=budget_iters, M=Minv, callback=cb
    )
    wall = time.perf_counter() - t0
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    if rel <= tol:
        return wall, count["n"], False, rel

    # extrapolate: measure converged iteration count via our own run is
    # unfair; instead run scipy further in exponentially growing budgets
    # until converged or 2000 iters, then extrapolate per-iteration cost.
    # Per-iteration cost is best-of-3 (a single reading inflates up to
    # ~3x under background CPU load, measured 39 vs 136 s extrapolated
    # on the same day), which can only make the baseline FASTER and the
    # reported speedup more conservative.
    t_per_iter = wall / max(count["n"], 1)
    for _ in range(2):
        cnt = {"n": 0}
        t0 = time.perf_counter()
        spla.cg(
            A, b, rtol=tol, maxiter=150, M=Minv,
            callback=lambda xk: cnt.__setitem__("n", cnt["n"] + 1),
        )
        w = time.perf_counter() - t0
        t_per_iter = min(t_per_iter, w / max(cnt["n"], 1))
    count2 = {"n": 0}

    def cb2(xk):
        count2["n"] += 1

    x, info = spla.cg(A, b, rtol=tol, maxiter=4000, M=Minv, callback=cb2)
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    if rel <= tol:
        # converged within 4000; reuse measured wall time of that run
        t0 = time.perf_counter()  # unused, kept for clarity
        return t_per_iter * count2["n"], count2["n"], True, rel
    # did not converge in 4000: extrapolate iteration count from the
    # asymptotic CG rate kappa ~ (2(nx+1)/pi)^2
    kappa = (2.0 * (nx + 1) / np.pi) ** 2
    rate = (np.sqrt(kappa) - 1) / (np.sqrt(kappa) + 1)
    n_est = int(np.log(tol / 2.0) / np.log(rate)) + 1
    return t_per_iter * n_est, n_est, True, rel


def scipy_same_algorithm(nx, tol=1e-8):
    """Same-algorithm baseline: scipy CG preconditioned with the SAME
    geometric multigrid V-cycle (vectorized numpy, float64), measured to
    convergence -- no extrapolation.  Isolates the hardware+framework
    speedup from the algorithmic (multigrid-vs-Jacobi) one."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    from northstar import _np_vcycle

    N = nx * nx
    h2 = (1.0 / (nx + 1)) ** 2
    main_d = 4.0 * np.ones(N) / h2
    off1 = -np.ones(N - 1) / h2
    off1[np.arange(1, nx * nx) % nx == 0] = 0.0
    offn = -np.ones(N - nx) / h2
    A = sp.diags(
        [main_d, off1, off1, offn, offn], [0, 1, -1, nx, -nx], format="csr"
    )
    b = np.ones(N)

    def ml(x):
        return _np_vcycle(
            np.asarray(x, np.float64).reshape(nx, nx), nx,
            coarsest=31, coarse_sweeps=60,
        ).reshape(-1)

    M = spla.LinearOperator((N, N), matvec=ml)
    count = {"n": 0}
    t0 = time.perf_counter()
    x, info = spla.cg(
        A, b, rtol=tol, maxiter=200, M=M,
        callback=lambda xk: count.__setitem__("n", count["n"] + 1),
    )
    wall = time.perf_counter() - t0
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    return wall, count["n"], rel


def main():
    from krypy_tpu.config import use_compile_cache

    use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r} devices")
    # 1023 = 2^10 - 1: exact multigrid nesting; N = 1,046,529 (~1M dof)
    nx = int(os.environ.get("BENCH_NX", "1023"))
    tol = 1e-8

    lap, b64, N = build_problem(nx)
    x, rel, wall, inner_iters, wall_all = device_solve(
        lap, b64, nx, tol=tol
    )
    if not rel <= tol:
        raise SystemExit(f"headline solve stopped at relres {rel:.3e}")

    scipy_wall, scipy_iters, extrapolated, scipy_rel = scipy_baseline(
        nx, tol=tol
    )
    sa_wall, sa_iters, sa_rel = scipy_same_algorithm(nx, tol=tol)

    # second headline block: GMRES orthogonalization cost per scheme at
    # this size (BENCH_ORTHO=0 skips it)
    ortho_block = None
    if os.environ.get("BENCH_ORTHO", "1") != "0":
        sys.path.insert(
            0, os.path.join(os.path.dirname(__file__), "benchmarks")
        )
        from ortho_bench import copy_rate, solve_leg

        schemes = ("cgs2", "cgs2_1r", "cgs2_fused")
        ortho_block = solve_leg(N, 40, schemes, copy_rate(),
                                verbose=False)
        ortho_block["best_scheme"] = min(
            schemes, key=lambda o: ortho_block[o]["wall_s"]
        )

    print(
        json.dumps(
            {
                "metric": f"poisson2d_{N}dof_time_to_relres_1e-8",
                "value": wall,
                "unit": "s",
                "vs_baseline": scipy_wall / wall,
                "vs_scipy_best": scipy_wall / wall,
                "extrapolated": bool(extrapolated),
                "vs_scipy_same_algorithm": sa_wall / wall,
                "wall_s_all": wall_all,
                "relres": rel,
                "inner_iters": inner_iters,
                "ortho": ortho_block,
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    print(
        f"# device: {wall:.4f}s rel={rel:.2e} inner_iters={inner_iters} "
        f"| scipy-cpu jacobi: {scipy_wall:.3f}s iters={scipy_iters} "
        f"extrapolated={extrapolated} | scipy-cpu same-alg mg-cg: "
        f"{sa_wall:.3f}s iters={sa_iters} rel={sa_rel:.2e}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
