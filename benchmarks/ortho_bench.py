#!/usr/bin/env python
"""Orthogonalization microbenchmark: the fused CGS2 kernel against the
plain XLA schemes, with the copy rate measured in the same run.

Two legs:

* kernel leg: one CGS2 orthogonalization of a vector against a
  ``rows``-row prefix of an (m, N) float32 basis, as (a) four plain jnp
  GEMVs (what ``ortho='cgs2'`` does per iteration, here on the prefix),
  (b) ``kernels.orthogonalize.cgs2_fused`` (jnp GEMV, Triton
  update+project kernel, jnp GEMV) and (c) the kernel alone.  Also
  prints the compiled temporary bytes of the jnp prefix GEMV: a value
  near ``rows * N * 4`` means XLA copies the prefix instead of reading
  it in place.
* solve leg: GMRES(m) with a diagonal operator per ``ortho`` scheme, so
  the orthogonalization dominates; bytes per solve from the model in
  :func:`sweep_bytes`.

Every time is the best of several back-to-back dispatches ended by
``block_until_ready``.  Run: ``python benchmarks/ortho_bench.py
[--size N] [--m M]``.
"""

import argparse
import json
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp


def best_time(fn, args, k=10, reps=5):
    """Seconds per call over ``k`` back-to-back calls, best of reps."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / k)
    return best


def copy_rate(n_bytes=256 << 20):
    """Achieved bytes/s of a scaled copy (read + write) of n_bytes."""
    x = jnp.ones(n_bytes // 4, jnp.float32)
    f = jax.jit(lambda a, s: a * s)
    return 2 * n_bytes / best_time(f, (x, jnp.float32(1.0001)), k=20)


def _bucket_rows(k, m):
    """Rows of the prefix bucket GMRES sweeps at iteration k."""
    h = 8
    while h < m + 1 and h < k + 1:
        h *= 2
    return min(h, m + 1)


def sweep_bytes(ortho, m, N, itemsize=4):
    """Basis bytes an m-iteration GMRES solve streams per scheme."""
    total = 0
    for k in range(m):
        if ortho == "cgs2":
            h, sweeps = _bucket_rows(k, m), 4  # 2 x (proj + upd)
        elif ortho == "cgs2_fused":
            h, sweeps = _bucket_rows(k, m), 3
        elif ortho == "cgs2_1r":
            h, sweeps = m + 2, 3  # one fused contraction + two updates
        elif ortho == "bmgs2":
            h, sweeps = min((k // 16 + 1) * 16, m + 1), 4
        else:
            raise ValueError(ortho)
        total += sweeps * h * N * itemsize
    return total


def kernel_leg(N, m, rows_list, copy_Bps):
    from krypy_tpu.kernels.orthogonalize import (
        apply_project,
        cgs2_fused,
        project_prefix,
    )

    key = jax.random.PRNGKey(0)
    V = jax.random.normal(key, (m, N), jnp.float32) / N ** 0.5
    w = jax.random.normal(jax.random.PRNGKey(1), (N,), jnp.float32)
    mask = jnp.ones(m, jnp.float32)
    out = []
    for rows in rows_list:
        def plain(V_, w_, r=rows):
            Vr = V_[:r]
            for _ in range(2):
                w_ = w_ - jnp.dot(jnp.dot(Vr, w_), Vr)
            return w_

        fused = jax.jit(lambda V_, w_, r=rows: cgs2_fused(
            V_, w_, mask, rows=r)[0])
        kern = jax.jit(lambda V_, w_, r=rows: apply_project(
            V_, w_, mask, mask, rows=r)[0])
        gemv = jax.jit(lambda V_, w_, r=rows: project_prefix(
            V_, w_, mask, rows=r))
        t_plain = best_time(jax.jit(plain), (V, w))
        t_fused = best_time(fused, (V, w))
        t_kern = best_time(kern, (V, w))
        t_gemv = best_time(gemv, (V, w))
        temp = gemv.lower(V, w).compile().memory_analysis()
        temp = getattr(temp, "temp_size_in_bytes", None)
        sweep = rows * N * 4
        rec = {
            "N": N, "rows": rows,
            "plain_cgs2_us": t_plain * 1e6,
            "fused_cgs2_us": t_fused * 1e6,
            "kernel_us": t_kern * 1e6,
            "gemv_us": t_gemv * 1e6,
            "plain_GBps": 4 * sweep / t_plain / 1e9,
            "fused_GBps": 3 * sweep / t_fused / 1e9,
            "kernel_GBps": sweep / t_kern / 1e9,
            "gemv_GBps": sweep / t_gemv / 1e9,
            "copy_GBps": copy_Bps / 1e9,
            "gemv_temp_bytes": temp,
            "prefix_bytes": sweep,
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def solve_leg(N, m, orthos, copy_Bps, verbose=True):
    """GMRES(m) with a diagonal operator: time per iteration per scheme."""
    from krypy_tpu import functional as F

    d = jnp.linspace(1.0, 2.0, N).astype(jnp.float32)
    b = jax.random.normal(jax.random.PRNGKey(2), (N,), jnp.float32)
    results = {}
    for ortho in orthos:
        run = jax.jit(lambda bb, o=ortho: F.gmres(
            lambda v: d * v, bb, tol=0.0, maxiter=m, ortho=o).x)
        t = best_time(run, (b,), k=3, reps=3)
        bps = sweep_bytes(ortho, m, N) / t
        results[ortho] = {
            "wall_s": t,
            "us_per_iter": t / m * 1e6,
            "sweep_GBps": bps / 1e9,
            "of_copy": bps / copy_Bps,
        }
        if verbose:
            print(json.dumps({"ortho": ortho, "m": m, "N": N,
                              **results[ortho]}), flush=True)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1023 * 1023)
    ap.add_argument("--m", type=int, default=40)
    ap.add_argument("--rows", default="8,16,26,41")
    ap.add_argument("--skip-solve", action="store_true")
    args = ap.parse_args()

    dev = jax.devices()[0]
    print(json.dumps({"device": dev.device_kind, "platform": dev.platform,
                      "count": len(jax.devices())}), flush=True)
    c = copy_rate()
    print(json.dumps({"copy_GBps": c / 1e9}), flush=True)
    rows = [int(r) for r in args.rows.split(",")]
    kernel_leg(args.size, args.m + 1, rows, c)
    if not args.skip_solve:
        solve_leg(args.size, args.m, ("cgs2", "cgs2_1r", "cgs2_fused"), c)


if __name__ == "__main__":
    main()
