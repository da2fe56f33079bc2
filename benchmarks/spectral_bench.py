#!/usr/bin/env python
"""Spectral-surface throughput at 1M dof on the device: eigsh,
expm_multiply, inv_sqrt_multiply.

Each line reports best-of-3 wall for one compiled solve (ended by
``block_until_ready``).  These are the solvers with no reference analog; the bench
pins that the surface is perf-real, not demo-ware.
"""

import json
import sys
import time

import _setup  # noqa: F401  (repo root on sys.path, compile cache)

import numpy
import jax
import jax.numpy as jnp


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 1023

    from krypy_tpu import functional as F, ops

    N = nx * nx
    lap = ops.poisson_2d(nx)
    h2 = (1.0 / (nx + 1)) ** 2

    def timed(fn, label, out_of):
        out = fn(1.0)
        jax.block_until_ready(out_of(out))
        walls = []
        for rep in range(3):
            t0 = time.perf_counter()
            out = fn(1.0 + 1e-3 * (rep + 1))
            jax.block_until_ready(out_of(out))
            walls.append(time.perf_counter() - t0)
        print(
            json.dumps({"task": label, "wall_s": round(min(walls), 4)}),
            flush=True,
        )
        return out

    # k=4 smallest eigenpairs of the 1M-dof Laplacian via SHIFT-INVERT
    # with a multigrid-CG inner solver -- the production pattern for
    # smallest/interior eigenvalues (plain Lanczos crawls on the
    # unpreconditioned Laplacian's clustered low end); the whole
    # inner-outer eigensolve is one compiled program
    mg = ops.multigrid_poisson_preconditioner(
        nx, coarsest=min(31, nx), coarse_sweeps=60
    )
    # inner tolerance respects the float32 attainable floor (pushing
    # past it diverges -- CLAUDE.md); the stagnation guard returns the
    # best iterate
    inv = lambda r: F.cg(lap, r, M=mg, tol=5e-6, maxiter=60,
                         stagnation_window=8).x
    eig_j = jax.jit(
        # tol 5e-4 = the measured float32 eigenVECTOR residual floor at
        # 1M dof; the eigenVALUE error is its square (~1e-7 relative,
        # verified against the analytic lambda_0 below).  block_size=2
        # captures the square Laplacian's exactly-degenerate (i,j)/(j,i)
        # pairs, which single-vector Lanczos cannot converge (the r2
        # bench's honest MAXITER)
        lambda v: F.eigsh(lap, k=4, sigma=0.0, inv=inv, v0=v,
                          tol=5e-4, maxdim=24, max_restarts=30,
                          block_size=2)
    )
    eig = timed(
        lambda s: eig_j(jnp.full(N, s, jnp.float32)),
        f"eigsh_k4_shiftinvert_mgcg_{N}dof",
        lambda r: r.theta,
    )
    exact0 = (4.0 / h2) * (
        jnp.sin(jnp.pi * (1.0 / (nx + 1)) / 2) ** 2
        + jnp.sin(jnp.pi * (1.0 / (nx + 1)) / 2) ** 2
    )
    print(
        json.dumps(
            {
                "eigsh_theta0": float(eig.theta[0]),
                "analytic_lambda0": float(exact0),
                "rel_err": abs(
                    float(eig.theta[0]) - float(exact0)
                ) / float(exact0),
                "converged": bool(eig.status == 0),
                # per-pair backward errors vs A: the degenerate (1,2)/
                # (2,1) cluster members are the pairs block Lanczos
                # exists for -- each must certify, not just the max
                "pair_backward_errors": [
                    float(r) for r in eig.pair_resnorms
                ],
                "theta": [float(t) for t in eig.theta],
            }
        ),
        flush=True,
    )

    # the same k=4 smallest pairs by preconditioned LOBPCG: NO inner
    # solves -- one A application and one V-cycle per pair per
    # iteration, everything (3k, N) block GEMMs.  The backward-error
    # criterion matches the eigsh leg's certification metric; tol 1e-6
    # (not the eigsh leg's 5e-4) because a backward error of b allows
    # eigenvalue perturbations ~ b*||A||: at ||A|| ~ 8e6, 5e-4 would
    # certify theta errors of O(100) -- measured 1e-6 resolves the
    # degenerate pair to ~1e-5 absolute in 18 iterations
    lob_j = jax.jit(
        lambda X: F.lobpcg(
            lap, X0=X, which="sa", M=mg, tol=1e-6,
            criterion="backward", maxiter=60,
        )
    )
    base = jnp.stack(
        [
            jnp.cos(jnp.arange(N) * (0.7391 + 0.1137 * i)) + 0.01
            for i in range(4)
        ],
        axis=1,
    ).astype(jnp.float32)
    lob = timed(
        lambda s: lob_j(base * s),
        f"lobpcg_k4_mg_{N}dof",
        lambda r: r.theta,
    )
    print(
        json.dumps(
            {
                "lobpcg_theta0": float(lob.theta[0]),
                "rel_err": abs(
                    float(lob.theta[0]) - float(exact0)
                ) / float(exact0),
                "converged": bool(lob.status == 0),
                "niter": int(lob.niter),
                "pair_backward_errors": [
                    float(r) for r in lob.pair_resnorms
                ],
                "theta": [float(t) for t in lob.theta],
            }
        ),
        flush=True,
    )

    # heat semigroup exp(-dt A) b
    expm_j = jax.jit(
        lambda v: F.expm_multiply(lap, v, -1e-5, maxdim=30)
    )
    timed(
        lambda s: expm_j(jnp.full(N, s, jnp.float32)),
        f"expm_multiply_dt1e-5_{N}dof",
        lambda r: r.x,
    )

    # A^{-1/2} b via 16-term elliptic quadrature over multi-shift CG
    lmin = 2.0 * (jnp.pi**2)
    lmax = 8.0 / h2
    isq_j = jax.jit(
        lambda v: F.inv_sqrt_multiply(
            lap, v, lmin=float(lmin) * 0.5, lmax=float(lmax),
            terms=16, tol=1e-5, maxiter=4000,
        )[0]
    )
    timed(
        lambda s: isq_j(jnp.full(N, s, jnp.float32)),
        f"inv_sqrt_16terms_{N}dof",
        lambda x: x,
    )

    # ---- filtered lane: 3D Anderson model at band center -----------
    # H = -sum_<nn> + W u_i on an L^3 lattice: an O(1)-span Hamiltonian
    # whose INTERIOR (band-center, localized) states are the honest use
    # case for polynomial filtering -- 3D shift-invert factorization
    # fill is infeasible at this size, and (H - sigma I) at sigma=0 is
    # maximally indefinite, so the whole count -> block -> solve
    # pipeline below runs on nothing but f32 matvec chains.
    import os

    L3 = int(os.environ.get("ANDERSON_L", "48"))
    N3 = L3**3
    W = 2.0
    u = W * (
        2.0
        * ((numpy.sin(numpy.arange(N3) * 12.9898) * 43758.5453) % 1.0)
        - 1.0
    )
    Vdis = jnp.asarray(u, jnp.float32)

    def anderson(v):
        x = v.reshape(L3, L3, L3)
        hop = (
            jnp.pad(x[1:], ((0, 1), (0, 0), (0, 0)))
            + jnp.pad(x[:-1], ((1, 0), (0, 0), (0, 0)))
            + jnp.pad(x[:, 1:], ((0, 0), (0, 1), (0, 0)))
            + jnp.pad(x[:, :-1], ((0, 0), (1, 0), (0, 0)))
            + jnp.pad(x[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
            + jnp.pad(x[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
        )
        return -hop.reshape(-1) + Vdis * v

    t0 = time.perf_counter()
    v0 = (jnp.cos(jnp.arange(N3) * 0.7391) + 0.01).astype(jnp.float32)
    bnd = F.estimate_spectrum_bounds(anderson, v0=v0)
    bounds_s = time.perf_counter() - t0

    # window sized from the COUNT (the advertised workflow): start from
    # a guess, rescale the half-width once so ~12 states fall inside
    # (count scales ~linearly with width at the smooth band center)
    span = bnd[1] - bnd[0]
    w_half = 4.0 * span / (0.25 * N3)  # ~16-state guess at rho(0)~0.13
    deg_cnt = int(min(4.0 * span / (2 * w_half), 60000))
    t0 = time.perf_counter()
    cnt, se = F.window_count(
        anderson, (-w_half, w_half), jax.random.PRNGKey(0), n=N3,
        bounds=bnd, degree=deg_cnt, n_probes=8, dtype=jnp.float32,
    )
    w_half *= max(12.0 / max(cnt, 1.0), 0.1)
    cnt2, se2 = F.window_count(
        anderson, (-w_half, w_half), jax.random.PRNGKey(1), n=N3,
        bounds=bnd, degree=deg_cnt, n_probes=8, dtype=jnp.float32,
    )
    count_s = time.perf_counter() - t0
    block = int(numpy.ceil(1.3 * max(cnt2, 1.0))) + 4

    degree = int(min(4.0 * span / (2 * w_half), 80000))
    X0 = jnp.stack(
        [
            jnp.cos(jnp.arange(N3) * (0.7391 + 0.1137 * i))
            + 0.01 * (i + 1)
            for i in range(block)
        ],
        axis=1,
    ).astype(jnp.float32)
    win_j = jax.jit(
        lambda X: F.eigsh_window(
            anderson, (-w_half, w_half), X0=X, bounds=bnd,
            degree=degree, tol=2e-5, maxiter=25,
        )
    )
    win = timed(
        lambda s: win_j(X0 * s),
        f"anderson3d_bandcenter_window_{N3}sites",
        lambda r: r.theta,
    )
    ni = int(win.n_inside)
    print(
        json.dumps(
            {
                "anderson_L": L3,
                "bounds": [float(bnd[0]), float(bnd[1])],
                "bounds_s": round(bounds_s, 3),
                "count_est": round(float(cnt2), 2),
                "count_stderr": round(float(se2), 2),
                "count_s": round(count_s, 3),
                "window_half": float(w_half),
                "block": block,
                "degree": degree,
                "converged": bool(win.status == 0),
                "niter": int(win.niter),
                "n_inside": ni,
                "saturated": bool(win.saturated),
                "worst_backward_error": (
                    float(jnp.max(win.pair_resnorms[:ni])) if ni else None
                ),
            }
        ),
        flush=True,
    )
    print(json.dumps({"devices": str(jax.devices())}), flush=True)


if __name__ == "__main__":
    main()
