r"""Jacobian-free Newton-Krylov for nonlinear systems F(x) = 0.

The accelerator-native twist the reference cannot offer: the Jacobian operator
is ``jax.jvp`` -- exact directional derivatives from autodiff, traced
into the SAME compiled program as the inner Krylov solve, so one Newton
step (residual, J-matvec GMRES, candidate updates) is one device
dispatch.  The reference's nonlinear usage builds dense Jacobians by
hand (krypy's recycling demo regime, SURVEY.md section 3.4); here
``F`` is any jittable function.

Structure (the framework's standard host/device split):

* device: a compiled ``step(x, r, eta)`` running GMRES on
  ``v -> jvp(F, x, v)`` plus a compiled backtracking evaluation;
* host: the Newton loop itself -- few iterations of decision logic
  (Eisenstat-Walker forcing-term choice, line-search control,
  convergence bookkeeping);
* optionally, the inner solves run through
  :class:`~krypy_tpu.functional.deflation.RecyclingGmres` via the
  operator-family protocol with ``params = x``: ONE compilation for the
  whole Newton sequence, and the Ritz/deflation subspace carries over
  between Newton steps (the sequence-of-slowly-varying-systems regime
  recycling was built for).
"""

import logging
import time
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .common import CONVERGED, MAXITER
from .deflation import RecyclingGmres
from .gmres import gmres as _gmres

__all__ = ["newton_krylov", "NewtonResult"]

_logger = logging.getLogger(__name__)


class NewtonResult(NamedTuple):
    """Result of :func:`newton_krylov`."""

    #: approximate root, shape ``(N,)``
    x: jnp.ndarray
    #: ||F(x_k)|| per Newton step (numpy, host decision data)
    resnorms: np.ndarray
    #: Newton steps taken
    niter: int
    #: total inner Krylov iterations
    inner_iters: int
    #: CONVERGED / MAXITER
    status: int
    #: inner Krylov iterations per Newton step (numpy int array)
    inner_history: np.ndarray = np.zeros(0, int)
    #: wall seconds per inner (Jacobian) solve
    inner_walls: np.ndarray = np.zeros(0)
    #: wall seconds of the pre-loop compile warmup (0.0 without
    #: ``warmup=True``); compiles dominate a short sequence's total, so
    #: report it separately from serving time
    warmup_s: float = 0.0

    @property
    def converged(self):
        return self.status == CONVERGED


def newton_krylov(
    F,
    x0,
    *,
    tol=1e-8,
    maxiter=50,
    inner_maxiter=50,
    eta_max=0.1,
    M=None,
    recycle=0,
    recycling_solver=None,
    warmup=False,
    line_search=True,
    verbose=False,
):
    r"""Solve ``F(x) = 0`` by inexact Newton with Jacobian-free GMRES.

    :param F: jittable residual function ``(N,) -> (N,)``; the Jacobian
      action is ``jax.jvp(F, (x,), (v,))`` -- exact, no finite-difference
      step-size tuning (reference-world JFNK needs one).
    :param tol: stop when ``||F(x)|| <= tol * max(||F(x0)||, 1)``.
    :param eta_max: cap on the Eisenstat-Walker forcing term; each inner
      solve runs to
      :math:`\eta_k = \min(\eta_{max}, 0.9 (\|F_k\|/\|F_{k-1}\|)^2)`
      (choice 2), so early steps don't oversolve.
    :param M: optional preconditioner matvec for the inner GMRES.
    :param recycle: if > 0, route the inner solves through
      :class:`RecyclingGmres` with this many deflation vectors; the
      Jacobian enters via the operator-family protocol (``params = x``),
      so the entire Newton sequence shares one compilation and recycles
      the deflation subspace between steps.
    :param recycling_solver: explicit recycling driver to use instead of
      the default fixed-width :class:`RecyclingGmres` (e.g. an
      auto-selecting one); implies the recycled path regardless of
      ``recycle``.
    :param warmup: pre-compile the recycled cores (plain + deflated +
      Ritz extraction) on the initial Jacobian before the Newton loop,
      so serving sequences pay no compile inside the timed steps.
    :param line_search: Armijo backtracking (t halved until
      :math:`\|F(x + t\,dx)\| \le (1 - 10^{-4} t)\|F(x)\|`, 8 tries);
      pure Newton otherwise.
    :return: :class:`NewtonResult`.
    """
    x = jnp.asarray(x0).reshape(-1)
    dtype = x.dtype
    warmup_s = 0.0

    @jax.jit
    def residual(xx):
        r = F(xx)
        return r, jnp.linalg.norm(r)

    if recycle > 0 or recycling_solver is not None:
        rec = recycling_solver or RecyclingGmres(
            n_vectors=int(recycle), which="sm", hermitian=False
        )

        def jac_op(xx):
            mv = lambda v: jax.jvp(F, (xx,), (v,))[1]
            mv.family = "newton_jvp"
            mv.params = xx
            mv.rebuild = lambda p: (
                lambda v: jax.jvp(F, (p,), (v,))[1]
            )
            return mv

        if warmup:
            t_w = time.perf_counter()
            rec.warmup(jac_op(x), jnp.zeros_like(x), M=M,
                       maxiter=inner_maxiter)
            warmup_s = time.perf_counter() - t_w

        def inner(xx, rr, eta):
            res = rec.solve(
                jac_op(xx), -rr, tol=float(eta), M=M,
                maxiter=inner_maxiter,
            )
            return res.x, int(res.niter)
    else:
        @jax.jit
        def _inner_jit(xx, rr, eta):
            Av = lambda v: jax.jvp(F, (xx,), (v,))[1]
            res = _gmres(Av, -rr, tol=eta, M=M, maxiter=inner_maxiter)
            return res.x, res.niter

        def inner(xx, rr, eta):
            dx, nit = _inner_jit(xx, rr, jnp.asarray(eta, jnp.float32))
            return dx, int(nit)

    @jax.jit
    def trial_step(xx, dx, t):
        # candidate iterate, its residual AND the norm in one dispatch:
        # the per-step pattern "trial norm, then separate update +
        # residual" triples the dispatches of the common accept-at-t=1
        # path
        xn = xx + t.astype(dtype) * dx
        rn = F(xn)
        return xn, rn, jnp.linalg.norm(rn)

    r, fnorm = residual(x)
    fnorm = float(fnorm)
    f0 = max(fnorm, 1.0)
    history = [fnorm]
    inner_total = 0
    inner_history = []
    inner_walls = []
    prev_fnorm = None
    status = MAXITER
    k = 0

    for k in range(1, maxiter + 1):
        if fnorm <= tol * f0:
            status = CONVERGED
            k -= 1
            break

        # Eisenstat-Walker choice 2 forcing term, with the standard
        # oversolve safeguard: never ask the inner solve for more
        # accuracy than the outer convergence test needs (half the
        # remaining gap) -- without it the LAST Jacobian solve runs to a
        # sub-attainable tolerance and burns inner_maxiter iterations
        if prev_fnorm is None:
            eta = eta_max
        else:
            eta = min(eta_max, 0.9 * (fnorm / prev_fnorm) ** 2)
        eta = max(eta, 0.5 * tol * f0 / fnorm)
        eta = min(eta, eta_max)

        t_in = time.perf_counter()
        dx, nit = inner(x, r, eta)
        inner_walls.append(time.perf_counter() - t_in)
        inner_history.append(nit)
        inner_total += nit

        t = 1.0
        xn, rn, tn = trial_step(x, dx, jnp.asarray(t))
        tn = float(tn)
        if line_search:
            # on sufficient-decrease failure the smallest step is kept:
            # the Newton direction may still be descent-adjacent, and
            # maxiter bounds the damage
            for _ in range(7):
                if tn <= (1.0 - 1e-4 * t) * fnorm:
                    break
                t *= 0.5
                xn, rn, tn = trial_step(x, dx, jnp.asarray(t))
                tn = float(tn)

        x, r = xn, rn
        prev_fnorm = fnorm
        fnorm = tn
        history.append(fnorm)
        if verbose:
            _logger.info(
                "newton step %d: ||F|| = %.3e (t=%g)", k, fnorm, t
            )
        if not np.isfinite(fnorm):
            break

    if np.isfinite(fnorm) and fnorm <= tol * f0:
        status = CONVERGED

    return NewtonResult(
        x=x,
        resnorms=np.asarray(history),
        niter=k,
        inner_iters=inner_total,
        status=status,
        inner_history=np.asarray(inner_history, int),
        inner_walls=np.asarray(inner_walls),
        warmup_s=warmup_s,
    )
