r"""Chebyshev iteration: the zero-reduction Krylov-free solver.

Every Krylov solver in this package pays at least one all-reduce per
iteration (CG: 2, GMRES/CGS2: 4, CA variants: ~6/s).  Chebyshev
iteration (Saad, *Iterative Methods for Sparse Linear Systems*, alg.
12.1) needs NONE: given spectral bounds ``[lmin, lmax]`` of the SPD
(preconditioned) operator, the optimal residual polynomial is known a
priori and the update is a pure 3-term recurrence -- one matvec, one
preconditioner apply, and axpys per step.  On a device mesh this is the
latency limit case: the only collectives are the residual-norm checks,
amortized to one all-reduce per ``check_every`` steps (pinned by
tests/test_collectives.py).

The price is spectrum knowledge: convergence degrades (or is lost) when
the true spectrum leaks outside ``[lmin, lmax]``.  The per-block TRUE
residual check keeps the solver honest -- it reports MAXITER via the
stagnation guard instead of claiming false convergence.  Use
:func:`spectral_bounds` for Lanczos-based estimates.

Reference baseline: krypy has no Chebyshev solver (its a-priori
machinery stops at *bounds* on CG/MINRES convergence,
krypy/utils.py:1847-2003); this solver is accelerator-native surface.
"""

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    cast_matvec,
    safe_div,
    system_dtype,
)

__all__ = ["chebyshev", "spectral_bounds"]


class _ChebState(NamedTuple):
    j: jnp.ndarray            # completed check blocks
    x: jnp.ndarray
    r: jnp.ndarray
    d: jnp.ndarray            # current direction
    rho: jnp.ndarray
    cur_rel: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray     # one entry per check block


def spectral_bounds(A, b, *, M=None, steps=24, safety=(0.5, 1.05)):
    """Estimate spectral bounds of the SPD (preconditioned) operator by
    a ``steps``-step Lanczos run, eagerly (one compiled step + host eig
    of the small tridiagonal).

    :param safety: multipliers applied to the extremal Ritz values.
      Ritz values lie strictly INSIDE the spectrum, so the lower bound
      needs real slack (interior eigenvalues below the smallest Ritz
      value are common at small ``steps``); Chebyshev tolerates an
      underestimated ``lmin`` gracefully (slower rate) but an
      underestimated ``lmax`` poorly, hence the asymmetric defaults.
    :return: ``(lmin, lmax)`` floats for :func:`chebyshev`.
    """
    b = jnp.asarray(b).reshape(-1)
    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(b, None)
    b = b.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))

    @jax.jit
    def lanczos_T():
        # Lanczos on M A (self-adjoint in the M^-1 inner product; for
        # bound ESTIMATES the Euclidean recurrence on MA is adequate
        # and avoids a second operator apply)
        v = b / jnp.linalg.norm(b)
        v_prev = jnp.zeros_like(v)
        alphas, betas = [], []
        beta = jnp.asarray(0.0, v.real.dtype)
        for _ in range(steps):
            w = apply(M_mv, A_mv(v)) - beta * v_prev
            alpha = jnp.real(jnp.vdot(v, w))
            w = w - alpha * v
            beta_new = jnp.linalg.norm(w)
            alphas.append(alpha)
            betas.append(beta_new)
            v_prev = v
            v = w * safe_div(1.0, beta_new)
            beta = beta_new
        return jnp.stack(alphas), jnp.stack(betas)

    al, be = (np.asarray(t, np.float64) for t in lanczos_T())
    T = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    w = np.linalg.eigvalsh(T)
    return float(safety[0] * w[0]), float(safety[1] * w[-1])


def chebyshev(
    A,
    b,
    *,
    lmin,
    lmax,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    check_every=16,
    stagnation_window=4,
):
    """Solve SPD ``A x = b`` (optionally with SPD preconditioner ``M``)
    by Chebyshev iteration in one compiled while_loop.

    :param lmin, lmax: bounds on the spectrum of ``M A`` (from
      :func:`spectral_bounds`, Gershgorin, or problem knowledge).
    :param check_every: steps between TRUE residual-norm checks -- the
      ONLY reductions in the solve; between checks the iteration is
      reduction-free.
    :param stagnation_window: stop after this many checks without
      improvement (wrong bounds / attainable-accuracy guard).
    :return: :class:`~krypy_tpu.functional.common.SolveResult`;
      ``resnorms`` holds one relative residual per check block,
      ``niter`` counts iterations (blocks * check_every).
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = N if maxiter is None else int(maxiter)
    check_every = int(check_every)
    blocks = -(-maxiter // check_every)

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))
    real_dtype = jnp.zeros(0, dtype).real.dtype

    theta = jnp.asarray((lmax + lmin) / 2.0, real_dtype)
    delta = jnp.asarray((lmax - lmin) / 2.0, real_dtype)
    sigma1 = safe_div(theta, delta)

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    bnorm = jnp.linalg.norm(bv)
    r0 = bv - A_mv(x0v)
    rel0 = safe_div(jnp.linalg.norm(r0), bnorm)
    d0 = apply(M_mv, r0) * safe_div(1.0, theta)
    rho0 = safe_div(1.0, sigma1)

    def step(carry, _):
        x, r, d, rho = carry
        x = x + d
        r = r - A_mv(d)
        z = apply(M_mv, r)
        rho_new = safe_div(1.0, 2.0 * sigma1 - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new * safe_div(1.0, delta)) * z
        return (x, r, d, rho_new), None

    def body(state):
        (x, r, d, rho), _ = lax.scan(
            step, (state.x, state.r, state.d, state.rho),
            None, length=check_every,
        )
        # the one reduction per block: TRUE residual (the recurrence r
        # is refreshed against drift at the same time)
        r = bv - A_mv(x)
        rel = safe_div(jnp.linalg.norm(r), bnorm)
        broken = ~jnp.isfinite(rel)
        improved = rel < state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(rel, state.best_rel)
        resnorms = state.resnorms.at[state.j + 1].set(rel)
        return _ChebState(
            state.j + 1, x, r, d, rho, rel, best, stall, broken, resnorms
        )

    def cond(state):
        go = (state.cur_rel > tol) & (state.j < blocks) & ~state.broken
        # stagnation_window == 0 disables the guard, matching the
        # convention of the sibling solvers (cg/bicgstab/tfqmr)
        if stagnation_window > 0:
            go = go & (state.stall < stagnation_window)
        return go

    init = _ChebState(
        jnp.asarray(0),
        x0v,
        r0,
        d0,
        rho0,
        rel0,
        rel0,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.full(blocks + 1, jnp.nan, real_dtype).at[0].set(rel0),
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(
        final.cur_rel <= tol,
        CONVERGED,
        jnp.where(final.broken, BREAKDOWN, MAXITER),
    )
    x = final.x
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.j * check_every,
        status=status,
    )
