r"""Least-squares Krylov solvers: LSQR and LSMR.

Both solve :math:`\min_x \|b - A x\|_2` (optionally Tikhonov-damped,
:math:`\min_x \|b - Ax\|^2 + \mathrm{damp}^2\|x - x_0\|^2` -- the
damping regularizes toward the initial guess, since the Golub-Kahan
recurrence is seeded with the shifted variable :math:`dx = x - x_0`;
for the classic :math:`\mathrm{damp}^2\|x\|^2` objective use
``x0=None``) for a general
rectangular operator :math:`A \in \mathbb{C}^{M \times N}` via
Golub-Kahan bidiagonalization: LSQR (Paige & Saunders 1982) is CG on the
normal equations in exact arithmetic, LSMR (Fong & Saunders 2011) is
MINRES on them, so LSMR's :math:`\|A^H r_k\|` decreases monotonically.

accelerator-native design: the whole iteration is scalar recurrences plus two
matvecs (:math:`A v` and :math:`A^H u`) and two vector norms per step,
all inside one ``lax.while_loop`` -- a solve is a single XLA dispatch.
There is no Krylov buffer at all (short recurrence), so memory is five
vectors regardless of iteration count, and the N/M axes shard over a
mesh like every other functional solver (the two norms become
all-reduces; nothing else communicates).

The reference framework has no least-squares surface (krypy's solvers
require square systems, krypy/linsys.py:38-123); this module is
accelerator-native extra capability with the same SolveResult contract.
"""

import warnings

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

__all__ = ["lsqr", "lsmr"]


def _setup(A, Ah):
    """Coerce the operator pair, deriving A^H for matrix operands and
    operators exposing ``.adj``."""
    if Ah is None:
        if hasattr(A, "ndim") or (
            hasattr(A, "shape") and not callable(A)
        ):
            mat = jnp.asarray(A)
            Ah = lambda y: jnp.dot(mat.conj().T, y)
        elif hasattr(A, "adj"):
            Ah = as_matvec(A.adj)
        else:
            raise ValueError(
                "Ah= (the conjugate-transpose matvec y -> A^H y) is "
                "required for callable operators"
            )
    A_mv = as_matvec(A)
    Ah_mv = as_matvec(Ah)
    return A_mv, Ah_mv


def _x_dimension(A, x0, M, dtype):
    """x0 vector and x dimension: from x0 when given, else the
    operator's shape (matrices AND callable LinearOperators).

    For a shapeless callable without x0 the square fallback N = M is
    used, with a warning: if the system is actually rectangular, the
    solve would otherwise start from a wrong-dimension zero vector and
    fail later with an opaque shape/broadcast error."""
    if x0 is not None:
        x0v = jnp.asarray(x0).reshape(-1).astype(dtype)
        return x0v, x0v.shape[0]
    shape = getattr(A, "shape", None)
    if shape is not None and len(shape) == 2 and shape[1] is not None:
        N = int(shape[1])
    else:
        warnings.warn(
            "operator has no .shape and no x0 was given: assuming a "
            "SQUARE system (N = M). For rectangular problems pass x0= "
            "or give the operator a .shape."
        )
        N = M
    return jnp.zeros(N, dtype), N


def _make_stop_tests(
    A_mv, Ah_mv, bv, damp, tol, btol, normb, real_dtype,
    explicit_residual, x0v,
):
    """Build the stopping-test closure shared by lsqr/lsmr.

    Returns ``stop_tests(normar, normr, normA2, x) -> (ls_ok, res_ok,
    checked)``.  With ``explicit_residual`` the ESTIMATED trigger only
    arms an explicit verification: the true (damped) residual and
    normal-equations residual are recomputed and must pass the same
    thresholds; ``checked`` reports that a verification ran (used by the
    callers' stagnation accounting)."""
    tiny = jnp.finfo(real_dtype).tiny

    def est_tests(normar, normr, normA2):
        ls_ok = normar <= tol * jnp.sqrt(normA2) * jnp.maximum(
            normr, tiny
        )
        res_ok = normr <= btol * normb
        return ls_ok, res_ok

    if not explicit_residual:
        def stop_tests(normar, normr, normA2, x):
            ls_ok, res_ok = est_tests(normar, normr, normA2)
            return ls_ok, res_ok, jnp.asarray(False)

        return stop_tests

    def stop_tests(normar, normr, normA2, x):
        ls_e, res_e = est_tests(normar, normr, normA2)
        fired = ls_e | res_e

        def verify(_):
            rt = bv - A_mv(x)
            # the recurrences minimize the x0-centered damped objective
            # ||b - Ax||^2 + damp^2 ||x - x0||^2 (module docstring), so
            # the explicit check must test THAT objective's residual
            # and gradient A^H r - damp^2 (x - x0)
            dx = x - x0v
            nr = jnp.sqrt(
                jnp.linalg.norm(rt) ** 2
                + damp**2 * jnp.linalg.norm(dx) ** 2
            )
            art = Ah_mv(rt) - (damp**2).astype(x.dtype) * dx
            return est_tests(jnp.linalg.norm(art), nr, normA2)

        def keep_running(_):
            false = jnp.asarray(False)
            return false, false

        ls_ok, res_ok = lax.cond(fired, verify, keep_running, 0)
        return ls_ok, res_ok, fired

    return stop_tests


class _LsqrState(NamedTuple):
    k: jnp.ndarray
    x: jnp.ndarray
    u: jnp.ndarray            # (M,) left Lanczos vector
    v: jnp.ndarray            # (N,) right Lanczos vector
    w: jnp.ndarray            # (N,) search direction
    alpha: jnp.ndarray
    phibar: jnp.ndarray
    rhobar: jnp.ndarray
    psi2: jnp.ndarray         # accumulated damp-rotation residual mass
    normA2: jnp.ndarray       # Frobenius-norm estimate accumulator
    normar: jnp.ndarray       # ||A^H r_k|| estimate
    best_ar: jnp.ndarray
    stall: jnp.ndarray
    done: jnp.ndarray         # status or -1 while running
    resnorms: jnp.ndarray


def lsqr(
    A,
    b,
    *,
    Ah=None,
    damp=0.0,
    x0=None,
    tol=1e-8,
    btol=None,
    maxiter=None,
    stagnation_window=30,
    explicit_residual=True,
):
    r"""Damped least squares by LSQR in one compiled while_loop.

    :param A: operator ``(N,) -> (M,)`` (matrix, LinearOperator, or
      callable); rectangular allowed.
    :param Ah: conjugate-transpose matvec ``(M,) -> (N,)``. Derived
      automatically for matrix operands and operators with ``.adj``;
      required for plain callables.
    :param damp: Tikhonov parameter; solves
      :math:`\min \|b-Ax\|^2 + \mathrm{damp}^2 \|x - x_0\|^2` (the
      classic :math:`\|x\|^2` regularizer when ``x0`` is None -- see
      the module docstring).
    :param tol: stop when the estimated normal-equations residual
      satisfies :math:`\|A^H r_k\| \le \mathrm{tol}\,\|A\|_F\,\|r_k\|`
      (the least-squares criterion -- scipy.sparse.linalg.lsqr's atol).
    :param btol: additionally stop when the estimated residual satisfies
      :math:`\|r_k\| \le \mathrm{btol}\,\|b\|` (consistent systems);
      defaults to ``tol``.
    :param stagnation_window: float32 attainable-accuracy guard -- stop
      after this many iterations without improvement of
      :math:`\|A^H r\|`.
    :param explicit_residual: when the ESTIMATED stopping quantities
      first claim convergence, verify against the explicitly recomputed
      true residual (two extra matvecs on those iterations only) --
      the scalar recurrences drift below the float32-attainable floor
      and would otherwise report false convergence for tolerances the
      arithmetic cannot reach (same policy as the other functional
      solvers).
    :return: :class:`~krypy_tpu.functional.common.SolveResult`;
      ``resnorms[k]`` is the estimated :math:`\|r_k\|/\|b\|` of the
      damped system (exact in exact arithmetic).  BREAKDOWN means the
      bidiagonalization terminated (invariant subspace): the iterate is
      the exact (least-squares) solution up to round-off.
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    M = bv.shape[0]
    btol = tol if btol is None else btol

    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype

    x0v, N = _x_dimension(A, x0, M, dtype)

    A_mv, Ah_mv = _setup(A, Ah)
    A_mv = cast_matvec(A_mv, dtype)
    Ah_mv = cast_matvec(Ah_mv, dtype)
    m = 2 * max(M, N) if maxiter is None else int(maxiter)
    damp = jnp.asarray(damp, real_dtype)

    normb = jnp.linalg.norm(bv)
    u0 = bv - A_mv(x0v)
    beta0 = jnp.linalg.norm(u0)
    u0 = u0 * safe_div(1.0, beta0)
    v0 = Ah_mv(u0)
    alpha0 = jnp.linalg.norm(v0)
    v0 = v0 * safe_div(1.0, alpha0)
    normar0 = alpha0 * beta0  # ||A^H r_0||

    rel0 = safe_div(beta0, normb)
    resnorms0 = jnp.full(m + 1, jnp.nan, real_dtype).at[0].set(rel0)
    _stop_tests = _make_stop_tests(
        A_mv, Ah_mv, bv, damp, tol, btol, normb, real_dtype,
        explicit_residual, x0v,
    )

    def body(st):
        # Golub-Kahan step
        u = A_mv(st.v) - st.alpha.astype(dtype) * st.u
        beta = jnp.linalg.norm(u)
        u = u * safe_div(1.0, beta)
        v = Ah_mv(u) - beta.astype(dtype) * st.v
        alpha = jnp.linalg.norm(v)
        v = v * safe_div(1.0, alpha)

        # eliminate the damping row
        rhobar1 = jnp.sqrt(st.rhobar**2 + damp**2)
        c1 = safe_div(st.rhobar, rhobar1)
        psi = safe_div(damp, rhobar1) * st.phibar
        phibar1 = c1 * st.phibar

        # QR rotation of the lower-bidiagonal column
        rho = jnp.sqrt(rhobar1**2 + beta**2)
        c = safe_div(rhobar1, rho)
        s = safe_div(beta, rho)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s * phibar1

        x = st.x + safe_div(phi, rho).astype(dtype) * st.w
        w = v - safe_div(theta, rho).astype(dtype) * st.w

        psi2 = st.psi2 + psi**2
        normA2 = st.normA2 + alpha**2 + beta**2 + damp**2
        # residual of the DAMPED system; equals ||b - A x|| when damp=0
        normr = jnp.sqrt(phibar**2 + psi2)
        # phibar carries the sign of the damp rotation's c1 = rhobar /
        # |rhobar|; the norm estimate needs magnitudes
        normar = jnp.abs(phibar) * alpha * jnp.abs(c)

        rel = safe_div(normr, normb)
        resnorms = st.resnorms.at[st.k + 1].set(rel)

        ls_ok, res_ok, checked = _stop_tests(
            normar, normr, normA2, x,
        )
        invariant = (alpha * beta) == 0
        improved = normar < st.best_ar
        stall = jnp.where(improved, 0, st.stall + 1)
        # a failed explicit check means the estimates have drifted below
        # the attainable floor: count it toward stagnation
        stall = jnp.where(checked & ~(ls_ok | res_ok), st.stall + 1,
                          stall)
        best_ar = jnp.minimum(normar, st.best_ar)
        done = jnp.where(
            ls_ok | res_ok,
            CONVERGED,
            jnp.where(
                invariant,
                BREAKDOWN,
                jnp.where(stall >= stagnation_window, MAXITER, -1),
            ),
        )
        return _LsqrState(
            st.k + 1, x, u, v, w, alpha, phibar, rhobar, psi2, normA2,
            normar, best_ar, stall, done, resnorms,
        )

    def cond(st):
        return (st.done < 0) & (st.k < m)

    # zero rhs / already-converged start
    start_done = jnp.where(
        (rel0 <= btol) | (normar0 == 0), CONVERGED, -1
    )
    init = _LsqrState(
        jnp.asarray(0),
        x0v,
        u0,
        v0,
        v0,
        alpha0,
        beta0,
        alpha0,
        jnp.asarray(0.0, real_dtype),
        alpha0**2,
        normar0,
        normar0,
        jnp.asarray(0),
        start_done,
        resnorms0,
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(final.done < 0, MAXITER, final.done)
    x = final.x
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.k,
        status=status,
    )


class _LsmrState(NamedTuple):
    k: jnp.ndarray
    x: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    h: jnp.ndarray
    hbar: jnp.ndarray
    alpha: jnp.ndarray
    alphabar: jnp.ndarray
    zetabar: jnp.ndarray
    rho: jnp.ndarray
    rhobar: jnp.ndarray
    cbar: jnp.ndarray
    sbar: jnp.ndarray
    # ||r|| estimation recurrences (Fong & Saunders section 5)
    betadd: jnp.ndarray
    betad: jnp.ndarray
    rhodold: jnp.ndarray
    tautildeold: jnp.ndarray
    thetatilde: jnp.ndarray
    zeta: jnp.ndarray
    dknorm2: jnp.ndarray
    normA2: jnp.ndarray
    best_ar: jnp.ndarray
    stall: jnp.ndarray
    done: jnp.ndarray
    resnorms: jnp.ndarray


def lsmr(
    A,
    b,
    *,
    Ah=None,
    damp=0.0,
    x0=None,
    tol=1e-8,
    btol=None,
    maxiter=None,
    stagnation_window=30,
    explicit_residual=True,
):
    r"""Damped least squares by LSMR in one compiled while_loop.

    Same interface and stopping rules as :func:`lsqr`.  LSMR applies
    MINRES to the normal equations, so the minimized quantity
    :math:`\|A^H r_k\|` is monotonically decreasing -- preferable when
    iterations may be truncated early (the LSQR iterate's
    :math:`\|A^H r\|` can oscillate).  ``resnorms`` tracks the estimated
    :math:`\|r_k\|/\|b\|` of the damped system via the Fong & Saunders
    recurrences (exact in exact arithmetic).
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    M = bv.shape[0]
    btol = tol if btol is None else btol

    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype

    x0v, N = _x_dimension(A, x0, M, dtype)

    A_mv, Ah_mv = _setup(A, Ah)
    A_mv = cast_matvec(A_mv, dtype)
    Ah_mv = cast_matvec(Ah_mv, dtype)
    m = 2 * max(M, N) if maxiter is None else int(maxiter)
    damp = jnp.asarray(damp, real_dtype)

    normb = jnp.linalg.norm(bv)
    u0 = bv - A_mv(x0v)
    beta0 = jnp.linalg.norm(u0)
    u0 = u0 * safe_div(1.0, beta0)
    v0 = Ah_mv(u0)
    alpha0 = jnp.linalg.norm(v0)
    v0 = v0 * safe_div(1.0, alpha0)
    normar0 = alpha0 * beta0

    rel0 = safe_div(beta0, normb)
    resnorms0 = jnp.full(m + 1, jnp.nan, real_dtype).at[0].set(rel0)
    one = jnp.asarray(1.0, real_dtype)
    zero = jnp.asarray(0.0, real_dtype)
    _stop_tests = _make_stop_tests(
        A_mv, Ah_mv, bv, damp, tol, btol, normb, real_dtype,
        explicit_residual, x0v,
    )

    def body(st):
        # Golub-Kahan step
        u = A_mv(st.v) - st.alpha.astype(dtype) * st.u
        beta = jnp.linalg.norm(u)
        u = u * safe_div(1.0, beta)
        v = Ah_mv(u) - beta.astype(dtype) * st.v
        alpha = jnp.linalg.norm(v)
        v = v * safe_div(1.0, alpha)

        # rotation eliminating the damping term
        alphahat = jnp.sqrt(st.alphabar**2 + damp**2)
        chat = safe_div(st.alphabar, alphahat)
        shat = safe_div(damp, alphahat)

        # rotation P_k flattening the bidiagonal
        rhoold = st.rho
        rho = jnp.sqrt(alphahat**2 + beta**2)
        c = safe_div(alphahat, rho)
        s = safe_div(beta, rho)
        thetanew = s * alpha
        alphabar = c * alpha

        # rotation Pbar_k for the MINRES-on-normal-equations QR
        rhobarold = st.rhobar
        zetaold = st.zeta
        thetabar = st.sbar * rho
        rhotemp = st.cbar * rho
        rhobar = jnp.sqrt(rhotemp**2 + thetanew**2)
        cbar = safe_div(rhotemp, rhobar)
        sbar = safe_div(thetanew, rhobar)
        zeta = cbar * st.zetabar
        zetabar = -sbar * st.zetabar

        # solution update
        hbar = st.h - safe_div(
            thetabar * rho, rhoold * rhobarold
        ).astype(dtype) * st.hbar
        x = st.x + safe_div(zeta, rho * rhobar).astype(dtype) * hbar
        h = v - safe_div(thetanew, rho).astype(dtype) * st.h

        # ||r|| estimation (Fong & Saunders section 5.1)
        betaacute = chat * st.betadd
        betacheck = -shat * st.betadd
        betahat = c * betaacute
        betadd = -s * betaacute

        thetatildeold = st.thetatilde
        rhotildeold = jnp.sqrt(st.rhodold**2 + thetabar**2)
        ctildeold = safe_div(st.rhodold, rhotildeold)
        stildeold = safe_div(thetabar, rhotildeold)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * st.betad + ctildeold * betahat

        tautildeold = safe_div(
            zetaold - thetatildeold * st.tautildeold, rhotildeold
        )
        taud = safe_div(zeta - thetatilde * tautildeold, rhodold)
        dknorm2 = st.dknorm2 + betacheck**2
        normr = jnp.sqrt(dknorm2 + (betad - taud) ** 2 + betadd**2)

        normA2 = st.normA2 + alpha**2 + beta**2 + damp**2
        normar = jnp.abs(zetabar)

        rel = safe_div(normr, normb)
        resnorms = st.resnorms.at[st.k + 1].set(rel)

        ls_ok, res_ok, checked = _stop_tests(
            normar, normr, normA2, x,
        )
        invariant = (alpha * beta) == 0
        improved = normar < st.best_ar
        stall = jnp.where(improved, 0, st.stall + 1)
        stall = jnp.where(checked & ~(ls_ok | res_ok), st.stall + 1,
                          stall)
        best_ar = jnp.minimum(normar, st.best_ar)
        done = jnp.where(
            ls_ok | res_ok,
            CONVERGED,
            jnp.where(
                invariant,
                BREAKDOWN,
                jnp.where(stall >= stagnation_window, MAXITER, -1),
            ),
        )
        return _LsmrState(
            st.k + 1, x, u, v, h, hbar, alpha, alphabar, zetabar, rho,
            rhobar, cbar, sbar, betadd, betad, rhodold, tautildeold,
            thetatilde, zeta, dknorm2, normA2, best_ar, stall,
            done, resnorms,
        )

    def cond(st):
        return (st.done < 0) & (st.k < m)

    start_done = jnp.where(
        (rel0 <= btol) | (normar0 == 0), CONVERGED, -1
    )
    init = _LsmrState(
        jnp.asarray(0),
        x0v,
        u0,
        v0,
        v0,
        jnp.zeros(N, dtype),
        alpha0,
        alpha0,
        normar0,
        one,
        one,
        one,
        zero,
        beta0,
        zero,
        one,
        zero,
        zero,
        zero,
        zero,
        alpha0**2,
        normar0,
        jnp.asarray(0),
        start_done,
        resnorms0,
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(final.done < 0, MAXITER, final.done)
    x = final.x
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.k,
        status=status,
    )
