#!/usr/bin/env python
"""Sketched GMRES vs classic GMRES at 1M dof on the device.

Two measurements:

1. PER-ITERATION cost at m=40, slope-timed over the iteration count
   (t(maxiter=40) - t(maxiter=20)) / 20 inside single dispatches with
   tol=0, so the constant per-call cost cancels.
   sGMRES moves O(k N) per iteration against classic GMRES's O(m N)
   basis sweep, so the gap should widen with m.
2. END-TO-END: Jacobi-preconditioned convection-diffusion solve to
   1e-6 with RESTARTED drivers at m=40 for both solvers (restarting is
   the randomized lane's stability lever: plain m=120 sGMRES loses the
   truncated basis' conditioning AND the embedding distortion grows
   with the subspace dimension -- measured true_rel 1.43 before the
   restarted driver existed).  Reports wall + total iterations.

Timing: best-of-N, each call ended by ``block_until_ready``.
"""

import json
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp

from krypy_tpu import functional as F, ops


def _time_best(fn, b, n=4):
    fn(b)  # compile
    best = float("inf")
    for i in range(n):
        bi = b * (1.0 + 1e-6 * (i + 1))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(bi))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    nx = 1023
    N = nx * nx
    lap = ops.poisson_2d(nx)
    b = jnp.ones(N, jnp.float32)

    sketch = F.kron_sketch(N, 8 * 41, seed=0)

    results = {}
    for name, make in (
        ("gmres_cgs2", lambda m: jax.jit(
            lambda bb: F.gmres(lap, bb, tol=0.0, maxiter=m,
                               ortho="cgs2").x)),
        ("sgmres_k2", lambda m: jax.jit(
            lambda bb: F.sketched_gmres(lap, bb, tol=0.0, maxiter=m,
                                        k_ortho=2, sketch=sketch).x)),
    ):
        t40 = _time_best(make(40), b)
        t20 = _time_best(make(20), b)
        per_iter = (t40 - t20) / 20
        results[name] = {
            "t40_s": round(t40, 4),
            "per_iter_us": round(per_iter * 1e6, 1),
        }

    # end-to-end leg: convdiff + Jacobi to 1e-6, restarted m=40 drivers
    nx2 = 511
    cd = ops.convection_diffusion_2d(nx2, nx2)
    Mj = ops.jacobi_preconditioner(cd)
    b2 = jnp.ones(nx2 * nx2, jnp.float32)
    e2e = {}
    for name, fn in (
        ("restarted_gmres", lambda bb: F.restarted_gmres(
            cd, bb, M=Mj, tol=1e-6, maxiter=40, max_restarts=80,
            ortho="cgs2")),
        ("restarted_sgmres", lambda bb: F.restarted_sketched_gmres(
            cd, bb, M=Mj, tol=1e-6, maxiter=40, max_restarts=80,
            k_ortho=4)),
    ):
        fn(b2)  # compile the cycle
        best, r = float("inf"), None
        for i in range(3):
            bi = b2 * (1.0 + 1e-6 * (i + 1))
            t0 = time.perf_counter()
            r = fn(bi)
            jax.block_until_ready(r.x)
            best = min(best, time.perf_counter() - t0)
        rel = float(jnp.linalg.norm(b2 - cd(r.x)) / jnp.linalg.norm(b2))
        e2e[name] = {
            "wall_s": round(best, 4),
            "iters": int(r.niter),
            "true_rel": rel,
        }

    speedup = (results["gmres_cgs2"]["per_iter_us"]
               / results["sgmres_k2"]["per_iter_us"])
    print(json.dumps({
        "metric": "sgmres_vs_gmres_per_iter_1M_m40",
        "value": round(speedup, 2),
        "unit": "x",
        "detail": results,
        "e2e_convdiff_1e-6": e2e,
    }))


if __name__ == "__main__":
    main()
