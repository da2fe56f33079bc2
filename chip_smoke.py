#!/usr/bin/env python
"""Smoke test of the solver's main path on one GPU.

    python chip_smoke.py                # one card: phases 1-6
    python chip_smoke.py --four-cards   # the sharded path on four cards

Phases on one card, in this order:

1. device: a GPU is required (no fallback to the CPU); prints the card's
   name and power limit, the JAX version and the numeric settings;
2. bandwidth anchor: copy and triad over 256 MB arrays, then the
   5-point stencil matvec and one damped-Jacobi smoother sweep against
   that copy rate;
3. headline: 1M-dof 2-D Poisson, float32 multigrid-CG refined in float64
   to a relative residual of 1e-8 (``bench.py``'s path);
4. north star: 16.8M-dof convection-diffusion, float32 GMRES(25)
   left-preconditioned by multigrid, refined in float64 to 1e-8, as one
   compiled program (``benchmarks/northstar.py``'s path);
5. orthogonalization at width: GMRES(40) with each ``ortho`` scheme,
   its Hessenberg against a float64 NumPy Arnoldi run, its time per
   iteration at 1M and 16.8M dof and in the north star's GMRES(25) cycle;
6. compatibility lane: ``krypy_tpu.cg``/``minres``/``gmres`` on the
   README system against the 13-digit golden values, in float64.

Each solve is checked on the host against a float64 SciPy CSR copy of
the operator built here, independent of the device code.  A failed
check ends the run with a non-zero exit.  The last line of standard
output is one JSON object, ``{"ok": true, "device": {...}}``.

``--four-cards`` runs only the sharded path on a 1-D mesh of four
cards, each solve against the same solve on one card:

* the north-star operator at 4095^2 (odd N), one GMRES(25) cycle with
  ``ortho='auto'`` and ``'cgs2_1r'``;
* the same operator at 4096^2 (N splits evenly by grid rows), 25
  unpreconditioned GMRES steps with ``ortho='auto'`` and
  ``'cgs2_fused'`` (the per-shard kernel under ``shard_map``);
* the 1M Poisson ``cg(variant='auto')`` with multigrid;
* the all-reduce round trip.

A solve passes only if its compiled program holds all-reduces and
collective-permutes and needs at most ``SHARDED_TEMP_RATIO`` of the
one-card program's device memory: a program GSPMD could not partition
runs replicated, with neither.  A jax.Array of odd length cannot be
split, so the odd-N solutions come back replicated; the 4096^2 solution
is checked shard by shard.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

os.environ.setdefault("KRYPY_TPU_X64", "1")

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "benchmarks"))

from krypy_tpu import parallel  # noqa: E402

class Sizes(NamedTuple):
    """Problem sizes of one run."""
    headline_nx: int
    northstar_nx: int
    ortho_nx: int
    stream_n: int        # float32 elements per bandwidth-anchor array
    stencil_nx: tuple    # grids of the stencil bandwidth probe
    aligned_nx: int      # four cards: a grid whose rows split evenly


FULL = Sizes(1023, 4095, 1023, (256 << 20) // 4, (4095, 8191), 4096)
TOL = 1e-8
#: a replicated program needs as much device memory per card as on one
#: card (ratio 1).  A partitioned solve holds its Krylov vectors a
#: quarter per card; the multigrid levels too small to split run whole
#: on every card, so how far below 1 it gets depends on the
#: preconditioner's share.
SHARDED_TEMP_RATIO = 0.9
ORTHO_M = 40
#: float32 GMRES(40) against a float64 Arnoldi: rounding of order
#: eps32 * ||A|| per step, amplified by the conditioning of the Krylov
#: basis over 40 steps; 1e-4 relative on H and 1e-5 on the basis'
#: orthogonality leave room for that at N ~ 1e6 without hiding a wrong
#: coefficient (which shows as O(1))
H_RTOL = 1e-4
ORTH_TOL = 1e-5
#: the README system's golden values and tolerance
#: (tests/test_convenience.py)
GOLDEN = {
    "cg": (1004.1873775173957, 1000.0003174916551, 999.9999999997555),
    "gmres": (1004.1873724888546, 1000.0003124630923, 999.999994971191),
    "minres": (1004.187372488912, 1000.0003124632159, 999.9999949713145),
}
GOLDEN_TOL = 1e-11

CACHE_EVENTS = {"hits": 0, "misses": 0}


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def timed(fn, *args, reps=3):
    """Best wall time of ``reps`` calls of a warmed jitted ``fn``, each
    ended by ``block_until_ready``; returns (seconds, last output)."""
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


# ----------------------------------------------------- host references
def csr_poisson_2d(nx, ny=None):
    """5-point Dirichlet Laplacian of ``ops.poisson_2d`` as a float64
    SciPy CSR matrix (row-major grid, index i*ny + j)."""
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    Tx = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                  [-1, 0, 1]) / hx2
    Ty = sp.diags([-np.ones(ny - 1), 2 * np.ones(ny), -np.ones(ny - 1)],
                  [-1, 0, 1]) / hy2
    return (sp.kron(Tx, sp.eye(ny)) + sp.kron(sp.eye(nx), Ty)).tocsr()


def csr_convection_diffusion_2d(nx, ny=None, wind=(1.0, 0.5), eps=1.0):
    """Upwind convection-diffusion of ``ops.convection_diffusion_2d`` as
    a float64 SciPy CSR matrix."""
    ny = nx if ny is None else ny
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    Bx = sp.diags([-np.ones(nx - 1), np.ones(nx)], [-1, 0]) / hx
    By = sp.diags([-np.ones(ny - 1), np.ones(ny)], [-1, 0]) / hy
    conv = wind[0] * sp.kron(Bx, sp.eye(ny)) + wind[1] * sp.kron(
        sp.eye(nx), By
    )
    return (eps * csr_poisson_2d(nx, ny) + conv).tocsr()


def csr_shifted_laplacian_2d(nx, ny=None, sigma=0.0):
    """``ops.shifted_laplacian_2d`` as a float64 SciPy CSR matrix."""
    ny = nx if ny is None else ny
    return (csr_poisson_2d(nx, ny) - sigma * sp.eye(nx * ny)).tocsr()


def host_relres(A_csr, x, b):
    """``||b - A x|| / ||b||`` in float64 on the host."""
    x = np.asarray(x, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.linalg.norm(b - A_csr @ x) / np.linalg.norm(b))


def host_arnoldi(A_csr, v0, m):
    """m steps of Arnoldi with two-pass classical Gram-Schmidt in
    float64; returns the (m+1, m) Hessenberg."""
    V = np.zeros((m + 1, v0.size))
    H = np.zeros((m + 1, m))
    V[0] = v0 / np.linalg.norm(v0)
    for k in range(m):
        w = A_csr @ V[k]
        for _ in range(2):
            c = V[: k + 1] @ w
            w -= c @ V[: k + 1]
            H[: k + 1, k] += c
        H[k + 1, k] = np.linalg.norm(w)
        V[k + 1] = w / H[k + 1, k]
    return H


# --------------------------------------------------------------- phases
def phase_device(expect):
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        fail(f"no GPU: JAX found {platform!r} devices")
    check(len(devs) >= expect,
          f"need {expect} devices, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind} "
        f"({platform}); jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}, "
        f"jax_enable_x64={jax.config.jax_enable_x64}")
    return {"platform": platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_bandwidth(run):
    from ortho_bench import best_time

    from krypy_tpu import ops

    n = run.stream_n
    x = jnp.arange(n, dtype=jnp.float32) * 1e-6
    y = x + 1.0
    s = jnp.float32(1.0001)
    copy = jax.jit(lambda a, c: a * c)
    triad = jax.jit(lambda a, b2, c: a + c * b2)
    t_copy = best_time(copy, (x, s), k=20)
    t_triad = best_time(triad, (x, y, s), k=20)
    copy_bps = 2 * 4 * n / t_copy
    triad_bps = 3 * 4 * n / t_triad
    log(f"bandwidth: copy {copy_bps / 1e9:.1f} GB/s, triad "
        f"{triad_bps / 1e9:.1f} GB/s ({4 * n / 2**20:.0f} MiB arrays)")
    check(np.isfinite(copy_bps) and copy_bps > 0, "copy rate")

    # stencil family against the copy rate: the matvec moves 2 vectors,
    # one smoother sweep u + w (r - A u) moves 3
    out = {"copy_Bps": copy_bps, "triad_Bps": triad_bps}
    for nx in run.stencil_nx:
        N = nx * nx
        A = ops.poisson_2d(nx)
        w = 0.8 / float(A.diag[0])
        u = jnp.linspace(0.0, 1.0, N, dtype=jnp.float32)
        r = jnp.ones(N, jnp.float32)
        mv = jax.jit(A)
        sweep = jax.jit(lambda uu, rr: uu + w * (rr - A(uu)))
        t_mv = best_time(mv, (u,), k=20)
        t_sw = best_time(sweep, (u, r), k=20)
        mv_bps = 2 * 4 * N / t_mv
        sw_bps = 3 * 4 * N / t_sw
        log(f"stencil {nx}^2 f32: matvec {t_mv * 1e6:.1f} us = "
            f"{mv_bps / 1e9:.1f} GB/s ({mv_bps / copy_bps:.2f} of copy); "
            f"jacobi sweep {t_sw * 1e6:.1f} us = {sw_bps / 1e9:.1f} GB/s "
            f"({sw_bps / copy_bps:.2f} of copy)")
        out[f"stencil_{nx}"] = {"matvec_Bps": mv_bps, "sweep_Bps": sw_bps}
    return out


def phase_headline(run):
    from krypy_tpu import functional as F, ops

    nx = run.headline_nx
    N = nx * nx
    lap = ops.poisson_2d(nx)
    Mmg = ops.multigrid_poisson_preconditioner(
        nx, coarsest=min(31, nx // 2), coarse_sweeps=60
    )

    @jax.jit
    def inner_solve(r32):
        return F.cg(lap, r32, M=Mmg, tol=1e-4, maxiter=12,
                    stagnation_window=4)

    b = jnp.ones(N, jnp.float64)
    result, info = F.refine_to(lap, b, inner_solve, tol=TOL, compiled=True)
    x = np.asarray(result.x)
    rel = host_relres(csr_poisson_2d(nx), x, np.ones(N))
    log(f"headline poisson {N} dof: wall {info['wall_s']:.4f} s "
        f"(compile+warm {info['warm_s']:.1f} s), refine cycles "
        f"{info['cycles']}, inner CG iterations {info['inner_iters']}, "
        f"host f64 relres {rel:.3e}")
    check(np.all(np.isfinite(x)) and x.shape == (N,), "headline x")
    check(rel <= TOL, f"headline relres {rel:.3e} > {TOL}")
    return {"wall_s": info["wall_s"], "relres": rel,
            "inner_iters": info["inner_iters"], "cycles": info["cycles"]}


def phase_northstar(run):
    import northstar

    nx = run.northstar_nx
    N = nx * nx
    x, rec = northstar.compiled_solve(nx, ortho="cgs2", restart=25)
    x = np.asarray(x)
    check(np.all(np.isfinite(x)) and x.shape == (N,), "north-star x")
    A = csr_convection_diffusion_2d(
        nx, wind=northstar.WIND, eps=northstar.EPS
    )
    rel = host_relres(A, x, np.ones(N))
    log(f"north star convdiff {N} dof GMRES(25)+MG: wall "
        f"{rec['wall_s']:.4f} s (compile+warm {rec['warm_s']:.1f} s), "
        f"refine cycles {rec['refine_cycles']}, inner GMRES iterations "
        f"{rec['inner_iters']}, host f64 relres {rel:.3e}")
    check(rel <= TOL, f"north-star relres {rel:.3e} > {TOL}")
    return {"wall_s": rec["wall_s"], "relres": rel,
            "inner_iters": rec["inner_iters"],
            "cycles": rec["refine_cycles"]}


def phase_ortho(run, schemes, copy_Bps):
    from ortho_bench import sweep_bytes

    from krypy_tpu import functional as F, ops

    out = {}

    # (a) Hessenberg and orthogonality against a float64 host Arnoldi
    nx = run.ortho_nx
    N = nx * nx
    m = ORTHO_M
    A = ops.convection_diffusion_2d(nx)
    A_csr = csr_convection_diffusion_2d(nx)
    b = jax.random.normal(jax.random.PRNGKey(0), (N,), jnp.float32)
    H_ref = host_arnoldi(A_csr, np.asarray(b, np.float64), m)
    checks = []
    for o in schemes:
        solve = jax.jit(lambda bb, o=o: F.gmres(
            A, bb, tol=0.0, maxiter=m, ortho=o, return_internal=True
        ))
        wall, (res, internals) = timed(solve, b)
        H = np.asarray(internals["H"], np.float64)[: m + 1, :m]
        h_err = np.linalg.norm(H - H_ref) / np.linalg.norm(H_ref)
        V = np.asarray(internals["V"], np.float64)[: m + 1]
        orth = np.linalg.norm(np.eye(m + 1) - V @ V.T)
        bps = sweep_bytes(o, m, N) / wall
        log(f"ortho {o} N={N} m={m}: {wall / m * 1e6:.1f} us/iter, basis "
            f"sweeps {bps / 1e9:.1f} GB/s ({bps / copy_Bps:.2f} of copy); "
            f"|H-H64|/|H64| {h_err:.2e} (tol {H_RTOL:g}), |I-V'V| "
            f"{orth:.2e} (tol {ORTH_TOL:g})")
        out[f"{o}_N{N}_us_per_iter"] = wall / m * 1e6
        # checked at the end of the phase, after every timing is out
        checks += [
            (int(res.niter) == m, f"{o}: niter {int(res.niter)} != {m}"),
            (np.isfinite(h_err) and h_err <= H_RTOL,
             f"{o}: Hessenberg error {h_err:.2e} > {H_RTOL}"),
            (orth <= ORTH_TOL, f"{o}: orthogonality {orth:.2e}"),
        ]

    # (b) time per iteration at the north-star width, m = 40
    import northstar

    nx = run.northstar_nx
    N = nx * nx
    A = ops.convection_diffusion_2d(nx)
    b = jax.random.normal(jax.random.PRNGKey(1), (N,), jnp.float32)
    for o in schemes:
        solve = jax.jit(lambda bb, o=o: F.gmres(
            A, bb, tol=0.0, maxiter=m, ortho=o
        ))
        wall, res = timed(solve, b)
        check(np.isfinite(float(res.resnorms[m])), f"{o}: N={N} resnorm")
        bps = sweep_bytes(o, m, N) / wall
        log(f"ortho {o} N={N} m={m}: {wall / m * 1e6:.1f} us/iter, basis "
            f"sweeps {bps / 1e9:.1f} GB/s ({bps / copy_Bps:.2f} of copy)")
        out[f"{o}_N{N}_us_per_iter"] = wall / m * 1e6

    # (c) the north star's GMRES(25) cycle: multigrid-preconditioned, on
    # the h^2-equilibrated float32 operator
    cd32, _, Ml, h2 = northstar.build_operators(nx)
    rs = jnp.ones(N, jnp.float32) * h2
    for o in schemes:
        solve = jax.jit(lambda bb, o=o: F.gmres(
            cd32, bb, Ml=Ml, tol=0.0, maxiter=25, ortho=o
        ))
        wall, res = timed(solve, rs)
        check(np.isfinite(float(res.resnorms[25])), f"{o}: cycle resnorm")
        log(f"north-star GMRES(25) cycle {o}: {wall * 1e3:.3f} ms "
            f"({wall / 25 * 1e6:.1f} us/iter), final rel "
            f"{float(res.resnorms[25]):.3e}")
        out[f"{o}_cycle25_ms"] = wall * 1e3
    for cond, msg in checks:
        check(cond, msg)
    return out


def phase_compat():
    import krypy_tpu

    A = np.diag([1.0e-3] + list(range(2, 101)))
    b = np.ones(100)
    for name, ref in GOLDEN.items():
        sol, _ = getattr(krypy_tpu, name)(
            A, b, inner_product=lambda a, c: jnp.dot(a, c)
        )
        sol = np.asarray(sol)
        got = (np.sum(np.abs(sol)), np.sqrt(np.dot(sol, sol)),
               np.max(np.abs(sol)))
        err = max(abs(g - r) / r for g, r in zip(got, ref))
        log(f"compat {name}: sum|x| {got[0]!r}, max rel dev from golden "
            f"{err:.2e} (tol {GOLDEN_TOL:g})")
        check(sol.dtype == np.float64, f"{name}: dtype {sol.dtype}")
        check(err < GOLDEN_TOL, f"{name}: golden deviation {err:.2e}")


# ------------------------------------------------------------ four cards
COLLECTIVES = ("all-reduce", "collective-permute", "all-gather")


def _program(fn, *args):
    """Collective ops (synchronous or async) and per-device temporary
    bytes of the compiled program."""
    import re

    compiled = fn.lower(*args).compile()
    txt = compiled.as_text()
    counts = {op: len(re.findall(rf"\b{op}(?:-start)?\(", txt))
              for op in COLLECTIVES}
    mem = compiled.memory_analysis()
    return counts, int(mem.temp_size_in_bytes)


def _check_partitioned(what, mesh, fn, arg, temp_one):
    """Fail unless the mesh program of ``fn`` is partitioned: it holds
    all-reduces (inner products) and collective-permutes (halo rows),
    and needs at most SHARDED_TEMP_RATIO of ``temp_one``, the one-card
    program's temporary device memory."""
    with mesh:
        counts, temp = _program(fn, arg)
    ratio = temp / max(temp_one, 1)
    log(f"{what}: compiled collectives {counts}; temp per card "
        f"{temp / 2**20:.1f} MiB vs {temp_one / 2**20:.1f} MiB on one card "
        f"(ratio {ratio:.3f}, limit {SHARDED_TEMP_RATIO})")
    check(counts["all-reduce"] > 0 and counts["collective-permute"] > 0,
          f"{what}: the compiled program is not partitioned ({counts})")
    check(ratio <= SHARDED_TEMP_RATIO,
          f"{what}: temp per card {ratio:.3f} of one card's")


def _check_solution(what, x_mesh, x_ref, rtol, split):
    """Compare a mesh solution with the one-card one; ``split``: the
    array must hold a quarter on each card."""
    x_ref = np.asarray(x_ref)
    scale = float(np.max(np.abs(x_ref)))
    shards = x_mesh.addressable_shards
    devs = {sh.device for sh in shards}
    sizes = sorted({int(np.prod(sh.data.shape)) for sh in shards})
    if split:
        check(len(devs) == 4 and sizes == [x_ref.size // 4],
              f"{what}: shards of {sizes} elements on {len(devs)} cards, "
              f"want {x_ref.size // 4} on 4")
    worst = 0.0
    for sh in shards:
        part = np.asarray(sh.data)
        check(np.all(np.isfinite(part)), f"{what}: non-finite values")
        worst = max(worst, float(np.max(np.abs(part - x_ref[sh.index]))))
    worst /= scale
    log(f"{what}: {len(shards)} shards of {sizes} elements on "
        f"{len(devs)} cards, max deviation from one card {worst:.2e} "
        f"(tol {rtol:g})")
    check(worst <= rtol, f"{what}: deviation {worst:.2e} > {rtol}")


def four_card_northstar(run, mesh):
    """North-star operator (odd N), one GMRES(25) cycle with the
    multigrid, ortho 'auto' and 'cgs2_1r'."""
    import northstar

    from krypy_tpu import functional as F
    from krypy_tpu.functional.gmres import resolve_auto_ortho

    nx = run.northstar_nx
    N = nx * nx
    cd32, _, Ml, h2 = northstar.build_operators(nx)
    rs = jnp.ones(N, jnp.float32) * h2
    cycle = {
        o: jax.jit(lambda bb, o=o: F.gmres(cd32, bb, Ml=Ml, tol=1e-5,
                                           maxiter=25, ortho=o))
        for o in ("auto", "cgs2_1r")
    }
    rs_one = jax.device_put(rs, jax.devices()[0])
    t_one, ref = timed(cycle["cgs2_1r"], rs_one)
    temp_one = _program(cycle["cgs2_1r"], rs_one)[1]
    log(f"one card north-star GMRES(25) ortho=cgs2_1r: {t_one * 1e3:.3f} ms,"
        f" niter {int(ref.niter)}")
    with mesh:
        auto = resolve_auto_ortho(N, 25, jnp.dtype(jnp.float32))
    log(f"ortho='auto' on the 4-card mesh resolves to {auto!r} (N={N})")
    rs_sh = parallel.shard_vector(rs, mesh)
    out = {}
    for o, fn in cycle.items():
        what = f"north star ortho={o}"
        _check_partitioned(what, mesh, fn, rs_sh, temp_one)
        with mesh:
            t, res = timed(fn, rs_sh)
        log(f"four cards north-star GMRES(25) ortho={o}: {t * 1e3:.3f} ms, "
            f"niter {int(res.niter)} (one card {int(ref.niter)}), rel "
            f"{float(res.resnorms[int(res.niter)]):.3e}")
        check(abs(int(res.niter) - int(ref.niter)) <= 1,
              f"{what}: iteration count differs from one card")
        _check_solution(what, res.x, ref.x, 1e-3, split=False)
        out[o] = t
    return out


def four_card_aligned(run, mesh, interpret=False):
    """North-star operator on a grid whose rows split evenly: 25
    unpreconditioned GMRES steps, ortho 'auto' and 'cgs2_fused' (the
    per-shard kernel)."""
    from krypy_tpu import functional as F, ops
    from krypy_tpu.functional.gmres import resolve_auto_ortho

    import northstar

    nx = run.aligned_nx
    N = nx * nx
    h2 = (1.0 / (nx + 1)) ** 2
    A = ops.convection_diffusion_2d(
        nx, wind=(northstar.WIND[0] * h2, northstar.WIND[1] * h2),
        eps=northstar.EPS * h2,
    )
    b = jnp.ones(N, jnp.float32) * jnp.float32(h2)
    steps = {
        o: jax.jit(lambda bb, o=o: F.gmres(A, bb, tol=0.0, maxiter=25,
                                           ortho=o, interpret=interpret))
        for o in ("auto", "cgs2_fused")
    }
    b_one = jax.device_put(b, jax.devices()[0])
    t_one, ref = timed(steps["cgs2_fused"], b_one)
    temp_one = _program(steps["cgs2_fused"], b_one)[1]
    log(f"one card {nx}^2 GMRES 25 steps ortho=cgs2_fused: "
        f"{t_one * 1e3:.3f} ms")
    with mesh:
        auto = resolve_auto_ortho(N, 25, jnp.dtype(jnp.float32),
                                  interpret=interpret)
    log(f"ortho='auto' on the 4-card mesh resolves to {auto!r} (N={N})")
    b_sh = parallel.shard_vector(b, mesh)
    out = {}
    for o, fn in steps.items():
        what = f"{nx}^2 ortho={o}"
        _check_partitioned(what, mesh, fn, b_sh, temp_one)
        with mesh:
            t, res = timed(fn, b_sh)
        r_mesh = float(res.resnorms[25])
        r_one = float(ref.resnorms[25])
        log(f"four cards {nx}^2 GMRES 25 steps ortho={o}: {t * 1e3:.3f} ms, "
            f"rel {r_mesh:.4e} (one card {r_one:.4e})")
        check(abs(r_mesh - r_one) <= 1e-3 * r_one,
              f"{what}: residual differs from one card")
        _check_solution(what, res.x, ref.x, 1e-3, split=True)
        out[o] = t
    return out


def four_card_cg(run, mesh):
    """1M Poisson, multigrid CG with the priced variant choice."""
    from krypy_tpu import functional as F, ops
    from krypy_tpu.functional import policy

    nx = run.headline_nx
    N = nx * nx
    lap = ops.poisson_2d(nx)
    Mmg = ops.multigrid_poisson_preconditioner(
        nx, coarsest=min(31, nx // 2), coarse_sweeps=60
    )

    # tol 1e-4: above the float32 floor of the unscaled 1/h^2 operator
    # (bench.py's inner tolerance)
    def make_cg(variant):
        return jax.jit(lambda bb: F.cg(lap, bb, M=Mmg, tol=1e-4,
                                       maxiter=40, variant=variant))

    cg = make_cg("auto")
    b = jnp.ones(N, jnp.float32)
    variant = "1r" if policy.prefer_one_reduce("cg", N // 4, 4) else \
        "classic"
    log(f"cg variant='auto' on the 4-card mesh resolves to {variant} "
        f"(sync {policy.sync_s() * 1e6:g} us, stream "
        f"{policy.hbm_bytes_per_s() / 1e9:g} GB/s)")
    # the one-card reference runs the variant the mesh resolved to
    one = make_cg(variant)
    b_one = jax.device_put(b, jax.devices()[0])
    t_one, ref = timed(one, b_one)
    b_sh = parallel.shard_vector(b, mesh)
    _check_partitioned("poisson cg auto", mesh, cg, b_sh,
                       _program(one, b_one)[1])
    with mesh:
        t, res = timed(cg, b_sh)
    log(f"four cards poisson MG-CG variant=auto: {t * 1e3:.3f} ms, niter "
        f"{int(res.niter)}; one card variant={variant}: "
        f"{t_one * 1e3:.3f} ms, niter {int(ref.niter)}")
    check(abs(int(res.niter) - int(ref.niter)) <= 1, "cg iteration count")
    _check_solution("poisson cg auto", res.x, ref.x, 1e-4, split=False)
    return {"auto": t}


def four_card_sync(mesh):
    """All-reduce round trip: a dependent chain of psums of a 64-float
    vector per card, timed at two chain lengths."""
    from jax.sharding import PartitionSpec as P

    def chain(k):
        def body(v):
            for _ in range(k):
                v = jax.lax.psum(v, "n") * 0.25
            return v

        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("n"),
                                     out_specs=P("n")))

    v = parallel.shard_vector(jnp.ones(4 * 64, jnp.float32), mesh)
    t8, _ = timed(chain(8), v, reps=10)
    t72, _ = timed(chain(72), v, reps=10)
    sync_s = (t72 - t8) / 64
    log(f"four cards all-reduce round trip: {sync_s * 1e6:.2f} us "
        f"(64-float psum chain, 72 vs 8 links)")
    check(sync_s > 0, "all-reduce timing")
    return sync_s


def phase_four_cards(run):
    mesh = parallel.make_mesh(4)
    four_card_northstar(run, mesh)
    four_card_aligned(run, mesh)
    four_card_cg(run, mesh)
    four_card_sync(mesh)


def main():
    from jax import monitoring

    from krypy_tpu.config import use_compile_cache

    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--four-cards", action="store_true",
                      help="run only the sharded path on four cards")
    opts = args.parse_args()
    run = FULL

    cache_dir = use_compile_cache()
    monitoring.register_event_listener(_count_cache_event)
    t_start = time.perf_counter()
    device = phase_device(4 if opts.four_cards else 1)
    if opts.four_cards:
        phase_four_cards(run)
    else:
        bw = phase_bandwidth(run)
        phase_headline(run)
        phase_northstar(run)
        from krypy_tpu.functional.gmres import resolve_auto_ortho

        auto = resolve_auto_ortho(run.northstar_nx ** 2, 25, jnp.float32)
        log(f"ortho='auto' on one device resolves to {auto!r}")
        phase_ortho(run, ["cgs2", "cgs2_1r", "cgs2_fused"], bw["copy_Bps"])
        phase_compat()
    log(f"compile cache {cache_dir}: {CACHE_EVENTS['hits']} hits, "
        f"{CACHE_EVENTS['misses']} misses; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


def _count_cache_event(event, **_):
    if event == "/jax/compilation_cache/cache_hits":
        CACHE_EVENTS["hits"] += 1
    elif event == "/jax/compilation_cache/cache_misses":
        CACHE_EVENTS["misses"] += 1


if __name__ == "__main__":
    main()
