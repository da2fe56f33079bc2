r"""BiCGStab: nonsymmetric short-recurrence solver.

GMRES on a nonsymmetric system stores an O(maxiter x N) basis and pays
an O(k N) orthogonalization sweep per iteration; BiCGStab (van der Vorst
1992) keeps SEVEN vectors total and converges without restarts -- the
memory-scaling lever for nonsymmetric systems that CG/MINRES provide for
the symmetric case (SURVEY.md section 5.7).  Per iteration: two matvecs,
two preconditioner applies, four fused inner products, and axpys, all in
one ``lax.while_loop``.

The residual polynomial is the product of the BiCG polynomial and local
1-step GMRES smoothing factors; convergence is non-monotone, so the
stagnation guard and the explicit-residual policy follow the same
honesty contract as the other cores (report MAXITER at the
attainable-accuracy floor, never false convergence).  Rho/omega
breakdowns are detected on-device and reported as BREAKDOWN with the
last iterate.

Reference baseline: krypy has no transpose-free nonsymmetric
short-recurrence solver (its nonsymmetric answer is GMRES,
krypy/linsys.py:877-1018); accelerator-native surface.
"""

from typing import NamedTuple

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

__all__ = ["bicgstab"]


class _BicgstabState(NamedTuple):
    k: jnp.ndarray
    x: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    v: jnp.ndarray
    rho: jnp.ndarray
    alpha: jnp.ndarray
    omega: jnp.ndarray
    cur_rel: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray


def bicgstab(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=0,
    explicit_residual=False,
):
    """Solve nonsymmetric ``A x = b`` with right-preconditioned
    BiCGStab in one compiled while_loop.

    :param M: optional preconditioner matvec (applied as a right
      preconditioner inside the recurrence, so the tracked residual is
      the TRUE residual of the original system).
    :param stagnation_window: if > 0, stop after this many iterations
      without improving the best residual (non-monotone convergence
      plus reduced-precision floors make this the honest stop for f32).
    :return: :class:`~krypy_tpu.functional.common.SolveResult`.
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = N if maxiter is None else int(maxiter)

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))
    real_dtype = jnp.zeros(0, dtype).real.dtype

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    bnorm = jnp.linalg.norm(bv)
    r0 = bv - A_mv(x0v)
    rel0 = safe_div(jnp.linalg.norm(r0), bnorm)
    rt = r0  # shadow residual (fixed)
    rho0 = jnp.vdot(rt, r0)

    eps = jnp.asarray(jnp.finfo(real_dtype).tiny * 1e4, real_dtype)

    def body(state):
        k = state.k
        # p-direction and first half step
        Mp = apply(M_mv, state.p)
        v = A_mv(Mp)
        rtv = jnp.vdot(rt, v)
        alpha = safe_div(state.rho, rtv)
        s = state.r - alpha * v

        # stabilization half step
        Ms = apply(M_mv, s)
        t = A_mv(Ms)
        tt = jnp.real(jnp.vdot(t, t))
        omega = safe_div(jnp.vdot(t, s), tt)

        x = state.x + alpha * Mp + omega * Ms
        r = s - omega * t

        rho_new = jnp.vdot(rt, r)
        beta = safe_div(rho_new, state.rho) * safe_div(alpha, omega)
        p = r + beta * (state.p - omega * v)

        rel_upd = safe_div(jnp.linalg.norm(r), bnorm)
        need_explicit = (
            explicit_residual | (rel_upd <= tol) | (k + 1 == maxiter)
        )

        def with_explicit(_):
            return safe_div(jnp.linalg.norm(bv - A_mv(x)), bnorm)

        rel = lax.cond(need_explicit, with_explicit,
                       lambda _: rel_upd, None)

        # rho/omega breakdown: the biorthogonality coefficients vanish
        broken = (
            (jnp.abs(rho_new) <= eps * jnp.abs(rtv) + eps)
            | (jnp.abs(omega) <= eps)
            | ~jnp.isfinite(rel)
        )
        improved = rel < 0.99 * state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(rel, state.best_rel)
        resnorms = state.resnorms.at[k + 1].set(rel)
        return _BicgstabState(
            k + 1, x, r, p, v, rho_new, alpha, omega, rel, best,
            stall, broken, resnorms,
        )

    def cond(state):
        go = (
            (state.cur_rel > tol)
            & (state.k < maxiter)
            & ~state.broken
        )
        if stagnation_window > 0:
            go = go & (state.stall < stagnation_window)
        return go

    init = _BicgstabState(
        jnp.asarray(0),
        x0v,
        r0,
        r0,
        jnp.zeros(N, dtype),
        rho0,
        jnp.asarray(1.0, dtype),
        jnp.asarray(1.0, dtype),
        rel0,
        rel0,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.full(maxiter + 1, jnp.nan, real_dtype).at[0].set(rel0),
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
        niter=final.k,
        status=status,
    )
