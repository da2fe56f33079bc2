#!/usr/bin/env python
"""Achievable device-memory streaming bandwidth (roofline anchor).

Times a scaled copy (``y = s * x``: one read, one write) and a triad
(``z = x + s * y``: two reads, one write) over arrays of at least 256 MB,
several times the H100's 50 MB L2, so the rate is device memory's and
not the cache's.  Each figure is the best of several batches of
back-to-back calls ended by ``block_until_ready``; the queue stays full,
so launch latency hides behind the kernels.

Run: ``python benchmarks/stream_bench.py [--mib 256 1024]``.
"""

import argparse
import json

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp
from ortho_bench import best_time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, nargs="*", default=[256, 1024])
    args = ap.parse_args()

    copy = jax.jit(lambda x, s: s * x)
    triad = jax.jit(lambda x, y, s: x + s * y)
    s = jnp.float32(1.0001)
    dev = jax.devices()[0]
    for mib in args.mib:
        n = (mib << 20) // 4
        x = jnp.ones(n, jnp.float32)
        y = jnp.full(n, 2.0, jnp.float32)
        t_copy = best_time(copy, (x, s), k=20)
        t_triad = best_time(triad, (x, y, s), k=20)
        print(json.dumps({
            "mib_per_array": mib,
            "copy_GBps": 2 * 4 * n / t_copy / 1e9,
            "triad_GBps": 3 * 4 * n / t_triad / 1e9,
            "device": dev.device_kind,
            "platform": dev.platform,
        }), flush=True)


if __name__ == "__main__":
    main()
