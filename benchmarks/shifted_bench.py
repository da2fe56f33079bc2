#!/usr/bin/env python
"""Multi-shift GMRES throughput: one basis vs per-shift solves.

1M-dof Poisson, ``n_shifts`` shifted systems (A + sigma_i I) x = b.
``shifted_gmres`` builds ONE m-step Krylov basis (m matvecs + the CGS2
sweeps) and finishes every shift with vmapped small solves plus one
basis GEMM; the sequential baseline runs one GMRES per shift -- m
matvecs and a full orthogonalization sweep EACH.
"""

import json
import sys
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp


def cg_main(argv):
    """shifted_cg: n_shifts SPD systems vs ONE plain CG of the seed
    system -- the family overhead is elementwise axpys only."""
    n_shifts = int(argv[1]) if len(argv) > 1 else 64
    iters = int(argv[2]) if len(argv) > 2 else 200
    nx = int(argv[3]) if len(argv) > 3 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)
    shifts = jnp.linspace(0.0, 100.0, n_shifts)

    multi = jax.jit(
        lambda b: F.shifted_cg(lap, b, shifts, maxiter=iters, tol=0.0)
    )
    single = jax.jit(
        lambda b: F.cg(lap, b, maxiter=iters, tol=0.0,
                       stagnation_window=10**9)
    )

    def sync(x):
        jax.block_until_ready(x)

    b = jnp.ones(N, jnp.float32)
    sync(multi(b).X)
    sync(single(b).x)
    wm = ws = 1e9
    for rep in range(3):
        bb = jnp.full(N, 1.0 + 1e-3 * (rep + 1), jnp.float32)
        t0 = time.perf_counter()
        sync(multi(bb).X)
        wm = min(wm, time.perf_counter() - t0)
        t0 = time.perf_counter()
        sync(single(bb).x)
        ws = min(ws, time.perf_counter() - t0)
    print(
        json.dumps(
            {
                "summary": f"shifted_cg_{N}dof_{n_shifts}shifts_"
                           f"{iters}iters",
                "multi_shift_wall_s": round(wm, 4),
                "single_cg_wall_s": round(ws, 4),
                "family_overhead": round(wm / ws, 2),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


def restarted_main(argv):
    """restarted_shifted_gmres (collinear seed scheme) vs per-shift
    restarted GMRES to the SAME tolerance: n_shifts families share one
    basis per cycle instead of n_shifts bases."""
    n_shifts = int(argv[1]) if len(argv) > 1 else 16
    m = int(argv[2]) if len(argv) > 2 else 30
    nx = int(argv[3]) if len(argv) > 3 else 511

    from krypy_tpu import functional as F, ops
    from krypy_tpu.functional.gmres import restarted_gmres

    N = nx * nx
    lap = ops.poisson_2d(nx)
    # (no preconditioner: M(A + sigma I) is not a shifted family);
    # quadrature-style shifts scale with the spectrum: sigma in
    # [1e-2, 1] * lambda_max keeps kappa(A + sigma I) <= ~100, the
    # regime where restarted GMRES(m) converges unpreconditioned
    lam_max = 8.0 * (nx + 1.0) ** 2
    shifts = jnp.asarray(
        lam_max * jnp.logspace(-2, 0, n_shifts), jnp.float32
    )
    # above the f32 updated-vs-true residual floor (~kappa*eps)
    tol = 1e-5
    b = jnp.ones(N, jnp.float32)

    def sync(x):
        jax.block_until_ready(x)

    # fair sequential baseline: ONE compiled whole-restart driver with
    # the shift as a traced argument (a fresh lambda per shift would
    # recompile n_shifts times and measure compiles, not solves)
    single = jax.jit(
        lambda bb, s: restarted_gmres(
            lambda v: lap(v) + s * v, bb, maxiter=m, max_restarts=20,
            tol=tol, compiled=True,
        )
    )

    # warm both
    r = F.restarted_shifted_gmres(
        lap, b, shifts, maxiter=m, max_restarts=20, tol=tol
    )
    sync(r.X)
    sync(single(b, shifts[0]).x)
    walls_m, walls_s = [], []
    for rep in range(2):
        bb = jnp.full(N, 1.0 + 1e-3 * (rep + 1), jnp.float32)
        t0 = time.perf_counter()
        r = F.restarted_shifted_gmres(
            lap, bb, shifts, maxiter=m, max_restarts=20, tol=tol
        )
        sync(r.X)
        walls_m.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        for i in range(n_shifts):
            rs = single(bb, shifts[i])
        sync(rs.x)
        walls_s.append(time.perf_counter() - t0)
    print(
        json.dumps(
            {
                "summary": f"restarted_shifted_{N}dof_{n_shifts}shifts"
                           f"_m{m}",
                "converged": bool(r.converged.all()),
                "total_krylov_steps": int(r.niter),
                "multi_shift_wall_s": round(min(walls_m), 4),
                "sequential_wall_s": round(min(walls_s), 4),
                "speedup": round(min(walls_s) / min(walls_m), 2),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


def main():
    if "--cg" in sys.argv:
        return cg_main([a for a in sys.argv if a != "--cg"])
    if "--restarted" in sys.argv:
        return restarted_main([a for a in sys.argv if a != "--restarted"])
    n_shifts = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    nx = int(sys.argv[3]) if len(sys.argv) > 3 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)
    shifts = jnp.linspace(0.0, 100.0, n_shifts)

    multi = jax.jit(
        lambda b: F.shifted_gmres(lap, b, shifts, maxiter=m, tol=0.0)
    )
    single = jax.jit(
        lambda b, s: F.gmres(
            lambda v, s=s: lap(v) + s * v, b, tol=0.0, maxiter=m
        )
    )

    def sync(x):
        jax.block_until_ready(x)

    b = jnp.ones(N, jnp.float32)
    sync(multi(b).X)
    sync(single(b, shifts[0]).x)

    walls_m, walls_s = [], []
    for rep in range(3):
        bb = jnp.full(N, 1.0 + 1e-3 * (rep + 1), jnp.float32)
        t0 = time.perf_counter()
        r = multi(bb)
        sync(r.X)
        walls_m.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        for i in range(n_shifts):
            rs = single(bb, shifts[i])
        sync(rs.x)
        walls_s.append(time.perf_counter() - t0)

    wm, ws = min(walls_m), min(walls_s)
    print(
        json.dumps(
            {
                "summary": f"shifted_{N}dof_{n_shifts}shifts_m{m}",
                "multi_shift_wall_s": round(wm, 4),
                "sequential_wall_s": round(ws, 4),
                "speedup": round(ws / wm, 2),
                "devices": str(jax.devices()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
