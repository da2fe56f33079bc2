#!/usr/bin/env python
"""One-reduce solver family benchmark.

Times the classic vs one-reduce (`variant="1r"` / `ortho="cgs2_1r"`)
solvers at 1M dof f32 on one device: two fixed-iteration solves at
maxiter K1 < K2, per-iteration = (t(K2) - t(K1)) / (K2 - K1), each
solve timed best-of-N with ``block_until_ready``.

The one-reduce schemes buy their win in mesh sync points (HLO-pinned at
1 all-reduce/iteration in tests/test_collectives.py), which a single
device does not pay.  What one device shows is their extra local
traffic: the per-iteration delta over the classic variant, divided by
the time of one vector sweep at the copy rate measured in the same run,
is the ``extra_sweeps`` figure that
``krypy_tpu.functional.policy.ONE_REDUCE_EXTRA_SWEEPS`` prices.
Run: python benchmarks/onereduce_bench.py [--size NX] [--only ...]
"""

import argparse
import json
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)
from ortho_bench import copy_rate

import jax
import jax.numpy as jnp

#: (classic case, one-reduce case) per policy entry
PAIRS = {
    "cg": ("cg_classic", "cg_1r"),
    "minres": ("minres_classic", "minres_1r"),
    "qmr": ("qmr_classic", "qmr_1r"),
    "deflated_cg": ("deflcg4_classic", "deflcg4_1r"),
    "idrs": ("idrs4_classic", "idrs4_1r"),
}


def time_solve(make, b, reps=3):
    """Best-of-reps wall for a jitted solve, ended by block_until_ready."""
    jax.block_until_ready(make(b))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(make(b))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1023)
    ap.add_argument("--k1", type=int, default=20)
    ap.add_argument("--k2", type=int, default=40)
    ap.add_argument("--only", default="",
                    help="comma-separated case-name substrings to run "
                         "(short-recurrence solvers tolerate a much "
                         "wider K spread than GMRES, whose per-iter "
                         "cost grows with the basis height)")
    args = ap.parse_args()

    from krypy_tpu import functional as F, ops
    nx = args.size
    N = nx * nx
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)
    b = jax.random.normal(jax.random.PRNGKey(0), (N,), jnp.float32)

    def jit_solve(fn):
        j = jax.jit(fn)
        return lambda b: j(b).x

    cases = {
        "cg_classic": lambda m: jit_solve(
            lambda b: F.cg(lap, b, M=Mj, tol=0.0, maxiter=m)
        ),
        "cg_1r": lambda m: jit_solve(
            lambda b: F.cg(lap, b, M=Mj, tol=0.0, maxiter=m, variant="1r")
        ),
        "minres_classic": lambda m: jit_solve(
            lambda b: F.minres(lap, b, M=Mj, tol=0.0, maxiter=m)
        ),
        "minres_1r": lambda m: jit_solve(
            lambda b: F.minres(lap, b, M=Mj, tol=0.0, maxiter=m,
                               variant="1r")
        ),
        "gmres_cgs2": lambda m: jit_solve(
            lambda b: F.gmres(lap, b, tol=0.0, maxiter=m, ortho="cgs2")
        ),
        "gmres_1r": lambda m: jit_solve(
            lambda b: F.gmres(lap, b, tol=0.0, maxiter=m,
                              ortho="cgs2_1r")
        ),
        # round-5 lanes: fused-deflated (1 sync/iter incl. capture +
        # projection), dual-basis M, bf16 x 1r, one-reduce QMR
        "gmres_defl4_cgs2": lambda m: _defl_case(m, "cgs2"),
        "gmres_defl4_1r": lambda m: _defl_case(m, "cgs2_1r"),
        "gmres_M_cgs2": lambda m: jit_solve(
            lambda b: F.gmres(lap, b, M=Mj, tol=0.0, maxiter=m,
                              ortho="cgs2")
        ),
        "gmres_M_1r": lambda m: jit_solve(
            lambda b: F.gmres(lap, b, M=Mj, tol=0.0, maxiter=m,
                              ortho="cgs2_1r")
        ),
        "gmres_bf16_1r": lambda m: jit_solve(
            lambda b: F.gmres(lap, b, tol=0.0, maxiter=m,
                              ortho="cgs2_1r",
                              basis_dtype=jnp.bfloat16)
        ),
        "gmres_bf16_cgs2": lambda m: jit_solve(
            lambda b: F.gmres(lap, b, tol=0.0, maxiter=m, ortho="cgs2",
                              basis_dtype=jnp.bfloat16)
        ),
        "qmr_classic": lambda m: jit_solve(
            lambda b: F.qmr(lap, b, tol=0.0, maxiter=m)
        ),
        "qmr_1r": lambda m: jit_solve(
            lambda b: F.qmr(lap, b, tol=0.0, maxiter=m, variant="1r")
        ),
        "deflcg4_classic": lambda m: _deflcg_case(m, "classic"),
        "deflcg4_1r": lambda m: _deflcg_case(m, "1r"),
        # round-5: one-reduce IDR(s) -- maxiter counts MATVECS, so the
        # slope is per matvec (= per sync point in the 1r scheme)
        "idrs4_classic": lambda m: jit_solve(
            lambda b: F.idrs(lap, b, s=4, tol=0.0, maxiter=m)
        ),
        "idrs4_1r": lambda m: jit_solve(
            lambda b: F.idrs(lap, b, s=4, tol=0.0, maxiter=m,
                             variant="1r")
        ),
    }

    Ud = jax.random.normal(jax.random.PRNGKey(7), (N, 4), jnp.float32)

    def _defl_case(m, ortho):
        j = jax.jit(
            lambda b, UU: F.deflated_gmres(
                lap, b, UU, tol=0.0, maxiter=m, ortho=ortho
            )
        )
        return lambda b: j(b, Ud).x

    def _deflcg_case(m, variant):
        j = jax.jit(
            lambda b, UU: F.deflated_cg(
                lap, b, UU, tol=0.0, maxiter=m, variant=variant
            )
        )
        return lambda b: j(b, Ud).x

    if args.only:
        keys = [s.strip() for s in args.only.split(",")]
        cases = {n: f for n, f in cases.items()
                 if any(k in n for k in keys)}

    dev = jax.devices()[0]
    rate = copy_rate()
    sweep_us = N * 4 / rate * 1e6
    out = {"N": N, "k1": args.k1, "k2": args.k2, "device": dev.device_kind,
           "copy_GBps": rate / 1e9, "sweep_us": sweep_us,
           "per_iter_us": {}, "extra_sweeps": {}}
    for name, mk in cases.items():
        t1 = time_solve(mk(args.k1), b)
        t2 = time_solve(mk(args.k2), b)
        per = (t2 - t1) / (args.k2 - args.k1) * 1e6
        out["per_iter_us"][name] = per
        print(f"  {name}: {per:.1f} us/iter  "
              f"(t{args.k1}={t1*1e3:.1f} ms, t{args.k2}={t2*1e3:.1f} ms)",
              flush=True)
    per_iter = out["per_iter_us"]
    for entry, (classic, one) in PAIRS.items():
        if classic in per_iter and one in per_iter:
            out["extra_sweeps"][entry] = (
                per_iter[one] - per_iter[classic]
            ) / sweep_us
    print(json.dumps(out))


if __name__ == "__main__":
    main()
