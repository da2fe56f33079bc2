#!/usr/bin/env python
"""Block solvers vs sequential single-rhs solves at 1M dof on the
device: k systems share every operator memory pass and the small dense
work runs as GEMMs.

Fixed Krylov budget per column (tol=0), so the wall ratio is the
per-column throughput gain of the block formulation.
"""

import json
import sys
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    nx = int(sys.argv[3]) if len(sys.argv) > 3 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)

    cols = [
        jnp.full(N, 1.0 + 0.1 * j, jnp.float32) * jnp.linspace(
            0.5 + 0.05 * j, 1.5, N, dtype=jnp.float32
        )
        for j in range(k)
    ]
    B = jnp.stack(cols, axis=1)

    single = jax.jit(
        lambda b: F.gmres(lap, b, tol=0.0, maxiter=m, ortho="cgs2").x
    )
    block = jax.jit(
        lambda BB: F.block_gmres(lap, BB, tol=0.0, maxiter=m).x
    )

    # warm both compiles
    jax.block_until_ready(single(cols[0]))
    jax.block_until_ready(block(B))

    walls_seq, walls_blk = [], []
    for rep in range(3):
        scale = 1.0 + 1e-3 * (rep + 1)
        t0 = time.perf_counter()
        for j in range(k):
            jax.block_until_ready(single(cols[j] * scale))
        walls_seq.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        jax.block_until_ready(block(B * scale))
        walls_blk.append(time.perf_counter() - t0)

    seq, blk = min(walls_seq), min(walls_blk)
    print(
        json.dumps(
            {
                "metric": f"block_gmres{m}_{k}rhs_{N}dof",
                "sequential_s": round(seq, 4),
                "block_s": round(blk, 4),
                "speedup": round(seq / blk, 2),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
