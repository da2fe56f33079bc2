#!/usr/bin/env python
"""Per-iteration cost: classic vs s-step solvers at 1M dof on the
device (the communication-avoiding variant bench line).

Both run a fixed iteration budget (tol=0) on the Jacobi-preconditioned
1M-dof Poisson system, so the wall ratio is the per-iteration speedup of
the fused-reduction formulation.

``--gmres`` benchmarks GMRES(m) vs CA-GMRES instead: the s-step
formulation replaces the per-iteration CGS2 sweep (4 reductions, 2
full-basis HBM passes per vector) with 6/s reductions and block GEMMs
over the basis, so the orthogonalization traffic drops ~s-fold.
"""

import json
import sys
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp


def gmres_main(argv):
    iters = int(argv[1]) if len(argv) > 1 else 40
    nx = int(argv[2]) if len(argv) > 2 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)

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
            "final_rel": float(rr.resnorms[int(jnp.nanargmin(
                jnp.where(jnp.isnan(rr.resnorms), jnp.inf, rr.resnorms)
            ))]),
            "wall_s": round(wall, 4),
            "per_iter_us": round(wall / max(niter, 1) * 1e6, 1),
        }
        print(json.dumps(out), flush=True)
        return out

    g = timed(
        jax.jit(lambda b: F.gmres(lap, b, tol=0.0, maxiter=iters,
                                  ortho="cgs2")),
        "gmres_cgs2",
    )
    results = {}
    for s in (2, 4, 8):
        for basis in ("monomial", "newton", "chebyshev"):
            kw = {}
            if basis in ("newton", "chebyshev"):
                # precompute shifts eagerly: keeps the jitted solve
                # free of host callbacks
                kw["shifts"] = F.newton_shifts(lap, jnp.ones(N, jnp.float32), s)
            results[s, basis] = timed(
                jax.jit(
                    lambda b, s=s, basis=basis, kw=kw: F.ca_gmres(
                        lap, b, s=s, basis=basis, tol=0.0, maxiter=iters,
                        stagnation_window=10**9, **kw,
                    )
                ),
                f"ca_gmres_s{s}_{basis}",
            )
    # the Chebyshev (interval) basis keeps conditioning at block sizes
    # the Newton basis' per-shift quality cannot reach on this SPD probe
    for s in (12, 16):
        kw = {"shifts": F.newton_shifts(lap, jnp.ones(N, jnp.float32), s)}
        results[s, "chebyshev"] = timed(
            jax.jit(
                lambda b, s=s, kw=kw: F.ca_gmres(
                    lap, b, s=s, basis="chebyshev", tol=0.0,
                    maxiter=iters, stagnation_window=10**9, **kw,
                )
            ),
            f"ca_gmres_s{s}_chebyshev",
        )
    # bf16 Krylov-basis storage: THROUGHPUT probe (the kappa~4e6 Poisson
    # operator is far past the eps(bf16)*kappa accuracy floor; the row
    # measures the HBM-traffic win of half-width basis reads, which is
    # what transfers to well-conditioned / preconditioned uses)
    kw = {"shifts": F.newton_shifts(lap, jnp.ones(N, jnp.float32), 4)}
    results[4, "newton_bf16"] = timed(
        jax.jit(
            lambda b, kw=kw: F.ca_gmres(
                lap, b, s=4, basis="newton", tol=0.0, maxiter=iters,
                stagnation_window=10**9, basis_dtype=jnp.bfloat16, **kw,
            )
        ),
        "ca_gmres_s4_newton_bf16basis",
    )
    print(
        json.dumps(
            {
                "summary": f"gmres_vs_ca_gmres_{N}dof_{iters}iters",
                "speedup_s4_newton_vs_gmres": round(
                    g["per_iter_us"]
                    / results[4, "newton"]["per_iter_us"], 2
                ),
                "speedup_bf16_basis": round(
                    results[4, "newton"]["per_iter_us"]
                    / results[4, "newton_bf16"]["per_iter_us"], 2
                ),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


def restarted_main(argv):
    """End-to-end: restarted GMRES(m) vs restarted CA-GMRES(m), fixed
    restart budget on the Jacobi-preconditioned 1M-dof Poisson system --
    same Krylov work per cycle, so the wall ratio is the end-to-end
    speedup and the achieved residuals should agree."""
    m = int(argv[1]) if len(argv) > 1 else 40
    restarts = int(argv[2]) if len(argv) > 2 else 5
    nx = int(argv[3]) if len(argv) > 3 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)

    def timed(solve, label):
        b = jnp.ones(N, jnp.float32)
        r = solve(b)   # compile
        jax.block_until_ready(r.x)
        walls = []
        for rep in range(3):
            bb = jnp.full(N, 1.0 + 1e-3 * (rep + 1), jnp.float32)
            t0 = time.perf_counter()
            rr = solve(bb)
            jax.block_until_ready(rr.x)
            walls.append(time.perf_counter() - t0)
        import numpy as np
        rel = float(np.nanmin(np.asarray(rr.resnorms)))
        out = {
            "solver": label,
            "wall_s": round(min(walls), 4),
            "achieved_rel": rel,
        }
        print(json.dumps(out), flush=True)
        return out

    g = timed(
        lambda b: F.restarted_gmres(
            lap, b, Ml=Mj, tol=1e-12, maxiter=m, max_restarts=restarts,
            ortho="cgs2",
        ),
        f"restarted_gmres_m{m}x{restarts + 1}",
    )
    c = timed(
        lambda b: F.restarted_ca_gmres(
            lap, b, Ml=Mj, tol=1e-12, maxiter=m, max_restarts=restarts,
            s=4, stagnation_window=10**9,
        ),
        f"restarted_ca_gmres_s4_m{m}x{restarts + 1}",
    )
    print(
        json.dumps(
            {
                "summary": f"restarted_{N}dof_m{m}x{restarts + 1}",
                "speedup": round(g["wall_s"] / c["wall_s"], 2),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


def main():
    if "--gmres" in sys.argv:
        return gmres_main([a for a in sys.argv if a != "--gmres"])
    if "--restarted" in sys.argv:
        return restarted_main([a for a in sys.argv if a != "--restarted"])
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    nx = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)
    Mj = ops.jacobi_preconditioner(lap)

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

    cg = timed(
        jax.jit(lambda b: F.cg(lap, b, M=Mj, tol=0.0, maxiter=iters,
                               stagnation_window=10**9)),
        "cg",
    )
    results = {"cg": cg}
    for s in (2, 4, 8):
        results[s] = timed(
            jax.jit(
                lambda b, s=s: F.ca_cg(
                    lap, b, s=s, M=Mj, tol=0.0, maxiter=iters,
                    stagnation_window=10**9,
                )
            ),
            f"ca_cg_s{s}",
        )
    print(
        json.dumps(
            {
                "summary": f"cg_vs_ca_cg_{N}dof_{iters}iters",
                "speedup_s4_vs_cg": round(
                    cg["per_iter_us"] / results[4]["per_iter_us"], 2
                ),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
