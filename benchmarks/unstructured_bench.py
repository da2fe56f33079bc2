#!/usr/bin/env python
"""Unstructured-operator preconditioning benchmark.

The grid gallery's strong preconditioners (multigrid/DST/SSOR) assume
the 5-point stencil family; this leg measures the OFF-GRID story: an
irregular-graph Laplacian (BCOO matvec) solved by CG and by the
BASELINE config-3 solver stack (right-preconditioned GMRES), with
point Jacobi vs dense block-Jacobi (`ops.block_jacobi_preconditioner`
-- one batched (nb, bs, bs) matrix-unit matmul per application, zero
collectives).

Run: python benchmarks/unstructured_bench.py [--size N] [--bs B]
"""

import argparse
import json
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import numpy as np
import jax
import jax.numpy as jnp


def _sync(x):
    return jax.block_until_ready(x)


def graph_laplacian(N, band=32, deg=10, seed=11):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), deg)
    cols = (rows + rng.integers(1, band, size=rows.size)) % N
    W = sp.coo_matrix(
        (rng.uniform(0.5, 2.0, rows.size).astype(np.float32),
         (rows, cols)),
        shape=(N, N),
    )
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return (L + 0.1 * sp.eye(N, dtype=np.float32)).tocsr()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=65536)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--format", choices=("dia", "bcoo"), default="dia",
                    help="sparse matvec format: DIA (roll-based, "
                    "gather-free; 51x faster than BCOO on this chip) "
                    "or BCOO")
    args = ap.parse_args()

    from krypy_tpu import functional as F, ops

    A = graph_laplacian(args.size)
    Amv = (
        ops.dia_from_scipy(A)
        if args.format == "dia"
        else ops.sparse_from_scipy(A)
    )
    b = jnp.ones(args.size, jnp.float32)

    t0 = time.perf_counter()
    Mspai = ops.spai_preconditioner(A)
    spai_setup = time.perf_counter() - t0
    print(json.dumps({"spai_setup_s": round(spai_setup, 2),
                      "spai_residual": round(Mspai.spai_residual, 4)}),
          flush=True)
    precs = {
        "jacobi": ops.jacobi_preconditioner(Amv),
        f"block_jacobi_bs{args.bs}": ops.block_jacobi_preconditioner(
            Amv, block_size=args.bs
        ),
        "spai": Mspai,
    }
    rows = {}
    for name, M in precs.items():
        import jax

        row = {}
        if name != "spai":  # SPAI is nonsymmetric: GMRES(Mr=) only
            cg = jax.jit(
                lambda v, M=M: F.cg(Amv, v, M=M, tol=args.tol,
                                    maxiter=2000)
            )
            r = cg(b)
            _sync(r.x)  # compile+run
            best = float("inf")
            for rep in range(3):
                bb = _sync(b * (1.0 + 1e-6 * rep))
                t0 = time.perf_counter()
                r = cg(bb)
                _sync(r.x)
                best = min(best, time.perf_counter() - t0)
            row.update(cg_iters=int(r.niter), cg_wall_s=round(best, 4),
                       converged=bool(r.converged))
        gm = F.gmres(Amv, b, Mr=M, tol=args.tol, maxiter=500)
        row["gmres_iters"] = int(gm.niter)
        rows[name] = row
        print(json.dumps({"prec": name, "N": args.size, **rows[name]}),
              flush=True)

    j, bj = rows["jacobi"], rows[f"block_jacobi_bs{args.bs}"]
    print(json.dumps({
        "metric": f"unstructured_graph_laplacian_N{args.size}",
        "iters_jacobi": j["cg_iters"],
        "iters_block_jacobi": bj["cg_iters"],
        "iter_ratio": round(j["cg_iters"] / max(bj["cg_iters"], 1), 2),
        "wall_ratio": round(j["cg_wall_s"] / max(bj["cg_wall_s"], 1e-9), 2),
    }), flush=True)


if __name__ == "__main__":
    main()
