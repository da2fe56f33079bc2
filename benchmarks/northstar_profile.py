#!/usr/bin/env python
"""Component profile of the north-star solve (benchmarks/northstar.py)
at NORTHSTAR_NX (default 8191, 67M dof): where does the wall time go?

Slope-times, per component, K chained applications inside ONE jit at
two K values (per-op = dt/dK, which cancels the per-call dispatch and
launch cost), best-of-3, each call ended by ``block_until_ready``:

  * cd32 matvec (the f32 equilibrated convection-diffusion stencil)
  * multigrid V-cycle (the left preconditioner)
  * cd64 matvec + f64 norm (one refinement residual)
  * one full inner GMRES(RESTART) cycle (end-to-end slope over cycles)

Run: python benchmarks/northstar_profile.py
"""

import json
import os
import time

os.environ.setdefault("KRYPY_TPU_X64", "1")

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import jax
import jax.numpy as jnp
from jax import lax

NX = int(os.environ.get("NORTHSTAR_NX", "8191"))
RESTART = int(os.environ.get("NORTHSTAR_RESTART", "12"))
WIND = (1.0, 0.5)
EPS = 1.0


def _sync(x):
    return jax.block_until_ready(x)


def slope(make_fn, pool, k1, k2, reps=3):
    """per-op seconds via the K-chained slope."""
    f1, f2 = make_fn(k1), make_fn(k2)
    f1(pool[0]); f2(pool[0])  # compile
    best1 = best2 = float("inf")
    for i in range(reps):
        z = pool[(i + 1) % len(pool)]
        t0 = time.perf_counter(); _sync(f1(z)); best1 = min(
            best1, time.perf_counter() - t0)
        t0 = time.perf_counter(); _sync(f2(z)); best2 = min(
            best2, time.perf_counter() - t0)
    return (best2 - best1) / (k2 - k1)


def main():
    from krypy_tpu import functional as F, ops

    nx = NX
    N = nx * nx
    h = 1.0 / (nx + 1)
    h2 = h * h
    cd32 = ops.convection_diffusion_2d(
        nx, wind=(WIND[0] * h2, WIND[1] * h2), eps=EPS * h2,
    )
    cd64 = ops.convection_diffusion_2d(nx, wind=WIND, eps=EPS)
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, scale=1.0 / h2,
    )

    N32 = N
    key = jax.random.PRNGKey(0)
    pool32 = [jax.random.normal(k, (N32,), jnp.float32)
              for k in jax.random.split(key, 3)]
    pool64 = [jax.random.normal(k, (N,), jnp.float64)
              for k in jax.random.split(key, 3)]

    out = {"N": N, "nx": nx, "restart": RESTART, "per_op_s": {},
           "device": jax.devices()[0].device_kind}

    def chain(op):
        def make(K):
            @jax.jit
            def f(z):
                def body(i, v):
                    # roll(1) fusion barrier between reps
                    return jnp.roll(op(v), 1)
                return lax.fori_loop(0, K, body, z)
            return f
        return make

    out["per_op_s"]["cd32_matvec"] = slope(chain(cd32), pool32, 4, 12)
    out["per_op_s"]["mg_vcycle"] = slope(chain(Ml), pool32, 2, 6)
    out["per_op_s"]["cd64_matvec"] = slope(chain(cd64), pool64, 2, 6)

    def res64_make(K):
        @jax.jit
        def f(z):
            b = jnp.ones(N, jnp.float64)
            def body(i, carry):
                v, acc = carry
                r = b - cd64(v)
                return jnp.roll(v, 1), acc + jnp.linalg.norm(r)
            _, acc = lax.fori_loop(0, K, body, (z, jnp.float64(0.0)))
            return acc
        return f
    out["per_op_s"]["refine_residual64"] = slope(res64_make, pool64, 2, 6)

    def gmres_cycle_make(K):
        @jax.jit
        def f(z):
            def body(i, v):
                res = F.gmres(cd32, v, Ml=Ml, tol=0.0, maxiter=RESTART)
                return jnp.roll(res.x, 1)
            return lax.fori_loop(0, K, body, z)
        return f
    cyc = slope(gmres_cycle_make, pool32, 1, 3)
    out["per_op_s"]["gmres_cycle"] = cyc
    out["per_op_s"]["gmres_per_iter"] = cyc / RESTART

    for k, v in out["per_op_s"].items():
        print(f"  {k}: {v*1e3:.2f} ms")
    mg = out["per_op_s"]["mg_vcycle"]
    mv = out["per_op_s"]["cd32_matvec"]
    ortho = out["per_op_s"]["gmres_per_iter"] - mg - mv
    print(f"  -> implied ortho+overhead per iter: {ortho*1e3:.2f} ms")
    out["per_op_s"]["implied_ortho_per_iter"] = ortho
    print(json.dumps(out))


if __name__ == "__main__":
    main()
