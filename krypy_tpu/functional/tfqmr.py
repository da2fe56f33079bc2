r"""TFQMR: transpose-free quasi-minimal residual (Freund 1993).

Nonsymmetric short recurrence like
:func:`~krypy_tpu.functional.bicgstab.bicgstab` (constant memory, two
matvecs per full iteration), but with a quasi-minimization of the
residual over the Krylov space that smooths the erratic CGS-style
convergence -- useful when BiCGStab's stabilization polynomial breaks
down (its `omega` can vanish on strongly nonnormal operators).

accelerator-native design: one ``lax.while_loop`` over HALF-steps; per full
iteration 2 matvecs + 2 quasi-residual reductions + 2 norm reductions.
The cheap quasi-residual BOUND :math:`\tau_m \sqrt{m+1}` drives the
iteration; candidate convergence triggers an EXPLICIT residual
verification (one extra matvec on those half-steps only), so the
reported status is honest below the float32 floor (the framework's
standard policy).

Reference baseline: krypy has no nonsymmetric short-recurrence solver
at all (its nonsymmetric option is full-memory GMRES,
krypy/linsys.py:919-1004); TFQMR is accelerator-native extra surface.
"""

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    as_matvec,
    cast_matvec,
    safe_div,
    system_dtype,
)

__all__ = ["tfqmr"]


class _TfqmrState(NamedTuple):
    m: jnp.ndarray            # half-step counter
    x: jnp.ndarray
    w: jnp.ndarray
    u: jnp.ndarray
    uhat: jnp.ndarray         # A u
    v: jnp.ndarray
    d: jnp.ndarray
    tau: jnp.ndarray
    theta: jnp.ndarray
    eta: jnp.ndarray
    rho: jnp.ndarray
    alpha: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    done: jnp.ndarray         # status or -1 while running
    resnorms: jnp.ndarray


def tfqmr(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=None,
):
    r"""Solve nonsymmetric ``A x = b`` by TFQMR in one compiled
    while_loop.

    :param M: optional RIGHT preconditioner matvec (the iteration runs
      on ``A M`` and the returned iterate is ``M y``, so the residual
      being quasi-minimized is the TRUE residual).
    :param tol: relative residual target; candidate convergence by the
      quasi-residual bound is verified against the explicit residual
      before CONVERGED is reported.
    :param stagnation_window: stop after this many half-steps without
      improvement of the quasi-residual bound (attainable-accuracy
      guard).  Defaults to ``max(100, 2 * maxiter // 10)`` -- the bound
      is strongly non-monotone early (it can climb for dozens of
      half-steps before the quasi-minimization bites), so the window
      scales with the budget; 0 disables.
    :return: :class:`~krypy_tpu.functional.common.SolveResult`;
      ``resnorms[m]`` is the quasi-residual BOUND
      :math:`\tau_m\sqrt{m+1}/\|b\|` per half-step (an upper estimate;
      the final entry on a CONVERGED exit is explicit-verified).
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = N if maxiter is None else int(maxiter)
    mmax = 2 * maxiter
    if stagnation_window is None:
        stagnation_window = max(100, mmax // 10)

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    M_mv = cast_matvec(M_mv, dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    eps = jnp.asarray(jnp.finfo(real_dtype).tiny * 1e4, real_dtype)

    def AM(y):
        return A_mv(y if M_mv is None else M_mv(y))

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )
    # iterate in the preconditioned variable y (x = x0 + M y)
    r0 = bv - A_mv(x0v)
    bnorm = jnp.linalg.norm(bv)
    rstar = r0

    u0 = r0
    uhat0 = AM(u0)
    v0 = uhat0
    tau0 = jnp.linalg.norm(r0)
    rho0 = jnp.vdot(rstar, r0)
    rel0 = safe_div(tau0, bnorm)

    resnorms0 = jnp.full(mmax + 1, jnp.nan, real_dtype).at[0].set(rel0)
    start_done = jnp.where(rel0 <= tol, CONVERGED, -1)

    def x_of(y):
        return x0v + (y if M_mv is None else M_mv(y))

    def true_rel(y):
        return safe_div(jnp.linalg.norm(bv - A_mv(x_of(y))), bnorm)

    def body(st):
        even = st.m % 2 == 0

        def alpha_even(_):
            return safe_div(st.rho, jnp.vdot(rstar, st.v))

        alpha = lax.cond(even, alpha_even, lambda _: st.alpha, 0)

        w = st.w - alpha * st.uhat
        d = st.u + safe_div(
            (st.theta**2).astype(dtype) * st.eta, alpha
        ) * st.d
        theta = safe_div(jnp.linalg.norm(w), st.tau)
        c2 = safe_div(1.0, 1.0 + theta**2)
        tau = st.tau * theta * jnp.sqrt(c2)
        eta = c2.astype(dtype) * alpha
        x = st.x + eta * d

        def next_even(_):
            # we just finished an odd half: BiCG coefficient update
            rho_new = jnp.vdot(rstar, w)
            beta = safe_div(rho_new, st.rho)
            u = w + beta * st.u
            uhat = AM(u)
            v = uhat + beta * (st.uhat + beta * st.v)
            return u, uhat, v, rho_new

        def next_odd(_):
            # we just finished an even half: second half-step direction
            u = st.u - alpha * st.v
            uhat = AM(u)
            return u, uhat, st.v, st.rho

        u, uhat, v, rho = lax.cond(even, next_odd, next_even, 0)

        # Freund's quasi-residual bound tau_m * sqrt(m+1) with
        # m+1 = st.m + 1 half-steps now done -> sqrt(st.m + 2)
        bound = tau * jnp.sqrt(2.0 + st.m.astype(real_dtype)) * safe_div(
            1.0, bnorm
        )
        cand = bound <= tol

        # explicit verification on candidate convergence only
        rel_true = lax.cond(
            cand, lambda _: true_rel(x), lambda _: bound, 0
        )
        converged = cand & (rel_true <= tol)

        # rho (biorthogonality) or pivot (alpha denominator) vanishing
        # is a genuine Lanczos breakdown: eps-scaled tests, plus an
        # alpha that safe_div zeroed at an even half (vanished pivot)
        breakdown = (
            (~jnp.isfinite(bound))
            | (jnp.abs(rho) <= eps * jnp.linalg.norm(w) + eps)
            | (even & (jnp.abs(alpha) == 0))
        )
        improved = bound < st.best_rel
        stall = jnp.where(improved, 0, st.stall + 1)
        stall = jnp.where(cand & ~converged, st.stall + 1, stall)
        best = jnp.minimum(bound, st.best_rel)
        if stagnation_window > 0:
            stalled = stall >= stagnation_window
        else:
            stalled = jnp.asarray(False)
        done = jnp.where(
            converged,
            CONVERGED,
            jnp.where(
                breakdown,
                BREAKDOWN,
                jnp.where(stalled, MAXITER, -1),
            ),
        )
        resnorms = st.resnorms.at[st.m + 1].set(
            jnp.where(cand, rel_true, bound)
        )
        return _TfqmrState(
            st.m + 1, x, w, u, uhat, v, d, tau, theta, eta, rho,
            alpha, best, stall, done, resnorms,
        )

    def cond(st):
        return (st.done < 0) & (st.m < mmax)

    init = _TfqmrState(
        jnp.asarray(0),
        jnp.zeros(N, dtype),
        r0,
        u0,
        uhat0,
        v0,
        jnp.zeros(N, dtype),
        tau0,
        jnp.asarray(0.0, real_dtype),
        jnp.zeros((), dtype),
        rho0,
        jnp.zeros((), dtype),
        rel0,
        jnp.asarray(0),
        start_done,
        resnorms0,
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(final.done < 0, MAXITER, final.done)
    x = x_of(final.x)
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        # a solve converging at an odd half-step still did real work:
        # round half-steps UP to full iterations
        niter=(final.m + 1) // 2,
        status=status,
    )
