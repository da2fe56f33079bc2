#!/usr/bin/env python
"""LSQR/LSMR throughput at ~1M dof on the device.

The probe is a damped least-squares problem on the 2-D Poisson operator
(`min ||b - A x||^2 + damp^2 ||x||^2` -- A is square but the damping
makes the problem genuinely least-squares).  Both solvers run a fixed
iteration budget; per-iteration cost is 2 stencil matvecs + 2 norm
reductions + scalar recurrences, so the wall should track ~2x the CG
per-iteration cost on the same operator (one matvec + 2 reductions).
"""

import json
import sys
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    nx = int(sys.argv[2]) if len(sys.argv) > 2 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)
    lap_mv = lambda v: lap(v)  # symmetric: Ah = A

    def timed(solve, label):
        b = jnp.ones(N, jnp.float32)
        r = solve(b)
        niter = int(r.niter)
        jax.block_until_ready(r.x)
        walls = []
        for rep in range(4):
            bb = jnp.full(N, 1.0 + 1e-3 * (rep + 1), jnp.float32)
            t0 = time.perf_counter()
            rr = solve(bb)
            jax.block_until_ready(rr.x)
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        out = {
            "solver": label,
            "niter": niter,
            "wall_s": round(wall, 4),
            "per_iter_us": round(wall / max(niter, 1) * 1e6, 1),
        }
        print(json.dumps(out), flush=True)
        return out

    res = {}
    for name, fn in (("lsqr", F.lsqr), ("lsmr", F.lsmr)):
        res[name] = timed(
            jax.jit(
                lambda b, fn=fn: fn(
                    lap_mv, b, Ah=lap_mv, damp=1e-3, tol=0.0,
                    maxiter=iters, stagnation_window=10**9,
                )
            ),
            name,
        )
    # context row: CG on the same operator (1 matvec/iter)
    res["cg"] = timed(
        jax.jit(lambda b: F.cg(lap, b, tol=0.0, maxiter=iters,
                               stagnation_window=10**9)),
        "cg_context",
    )
    print(
        json.dumps(
            {
                "summary": f"lsq_{N}dof_{iters}iters",
                "lsqr_vs_cg_periter": round(
                    res["lsqr"]["per_iter_us"] / res["cg"]["per_iter_us"],
                    2,
                ),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
