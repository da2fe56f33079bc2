#!/usr/bin/env python
"""GMRES throughput at 1M dof (BASELINE.json metric: "matvecs/s + MGS
GFLOP/s (GMRES, 1M dof)").

Runs GMRES(m) cycles on the 1M-dof Poisson operator in float32 and
reports per-iteration wall time, matvecs/s, and the orthogonalization
GFLOP/s (CGS2: 4 fused contractions of (m+1, N) per iteration = 8 (m+1) N
flops + the update; counted as 4 * 2 * (m+1) * N flops/iter)."""

import json
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp

from krypy_tpu import functional as F, ops


def main():
    nx = 1023
    N = nx * nx
    m = 30
    lap = ops.poisson_2d(nx)
    b = jnp.ones(N, jnp.float32)

    solve = jax.jit(
        lambda bb: F.gmres(lap, bb, tol=1e-30, maxiter=m, ortho="cgs2")
    )
    r = solve(b)
    r.x.block_until_ready()

    jax.block_until_ready(r.x)
    best = float("inf")
    for i in range(5):
        bi = b * (1.0 + 1e-6 * (i + 1))
        t0 = time.perf_counter()
        r = solve(bi)
        jax.block_until_ready(r.x)
        best = min(best, time.perf_counter() - t0)

    iters = int(r.niter)
    t_iter = best / iters
    # CGS2 = 2 passes x (coefficient contraction + update) over the
    # (m+1, N) basis
    ortho_flops = 4 * 2 * (m + 1) * N
    print(
        json.dumps(
            {
                "metric": f"gmres{m}_poisson_{N}dof_per_iter",
                "value": round(t_iter * 1e6, 1),
                "unit": "us",
                "matvecs_per_s": round(iters / best, 1),
                "ortho_gflops": round(ortho_flops / t_iter / 1e9, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
