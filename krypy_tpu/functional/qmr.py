r"""QMR: quasi-minimal residual solver on the nonsymmetric Lanczos
biorthogonalization.

Freund & Nachtigal's QMR (1991) runs the two-sided Lanczos process --
one matvec with ``A`` and one with ``A^T`` per iteration, short
recurrences, seven live vectors -- and QUASI-minimizes the residual over
the Krylov space through the implicit tridiagonal least-squares problem,
giving the smooth convergence BiCG lacks at the same cost, without
GMRES's O(k N) growing sweep (the nonsymmetric memory-scaling lever of
SURVEY.md section 5.7, complementing BiCGStab/IDR(s)/TFQMR which avoid
the transpose at the price of squared/filtered residual polynomials).

accelerator-first: the transpose operator is derived AUTOMATICALLY with
``jax.linear_transpose`` -- in a functional framework the traced matvec
IS the operator, so its (bilinear) transpose is compiler-derived, not
user-supplied; the classic reason QMR is avoided in matrix-free codes
("no A^T available") does not exist here.  We implement the
bilinear-form variant (unconjugated ``w^T v`` products, ``A^T`` not
``A^H``), which is exactly what ``linear_transpose`` provides and is the
original coupled-two-term formulation; it reduces to the classical
real-arithmetic QMR for real data and remains valid for complex
operators.  Everything runs in one ``lax.while_loop``: 2 matvecs, 2
preconditioner applies, 5 fused inner products per iteration.

Right preconditioning is handled by composition: the recurrence runs on
``A_hat = A o M`` (whose transpose ``M^T A^T`` falls out of the same
``linear_transpose``), the loop accumulates the preconditioned-space
iterate, and ONE final ``M`` apply maps it back -- so the tracked
residual is the TRUE residual of the original system.

Honesty contract as the sibling cores: explicit-residual confirmation on
the convergence/maxiter exits, Lanczos breakdowns (rho, xi, delta,
epsilon, gamma) detected on-device and reported as BREAKDOWN with the
last iterate, stagnation guard for reduced-precision floors.

Reference baseline: krypy has no two-sided-Lanczos surface (its
nonsymmetric answer is GMRES, krypy/linsys.py:877-1018); accelerator-native.
"""

from typing import NamedTuple

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

__all__ = ["qmr", "transpose_matvec"]


def transpose_matvec(mv, N, dtype):
    """Bilinear transpose ``x -> A^T x`` of a traced linear matvec.

    Uses ``jax.linear_transpose``: the matvec must be linear and
    jax-traceable (every operator in :mod:`krypy_tpu.ops` is).  For the
    conjugate transpose compose with ``jnp.conj`` on both sides.
    """
    t = jax.linear_transpose(mv, jnp.zeros(N, dtype))

    def At(x):
        return t(x)[0]

    return At


class _QmrState(NamedTuple):
    k: jnp.ndarray
    u: jnp.ndarray        # preconditioned-space iterate (x = x0 + M u)
    r: jnp.ndarray        # true residual of the original system
    vt: jnp.ndarray
    wt: jnp.ndarray
    p: jnp.ndarray
    q: jnp.ndarray
    d: jnp.ndarray
    s: jnp.ndarray
    rho: jnp.ndarray
    xi: jnp.ndarray
    eps: jnp.ndarray
    gamma: jnp.ndarray
    eta: jnp.ndarray
    theta: jnp.ndarray
    cur_rel: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray
    # --- one-reduce (variant="1r") extras; scalars, zero in classic ---
    delta_c: jnp.ndarray  # carried biorthogonality coupling <w, v>
    rr: jnp.ndarray       # carried squared residual norm ||r||^2


def qmr(
    A,
    b,
    *,
    M=None,
    AT=None,
    MT=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=0,
    explicit_residual=False,
    variant="classic",
):
    r"""Solve nonsymmetric ``A x = b`` with right-preconditioned QMR in
    one compiled while_loop.

    :param M: optional right-preconditioner matvec (the recurrence runs
      on ``A o M``; the tracked residual is the TRUE residual).
    :param AT: optional explicit transpose matvec ``x -> A^T x``
      (bilinear transpose, no conjugation).  Default: derived from
      ``A`` with :func:`transpose_matvec` -- pass it only when the
      matvec is not jax-traceable.
    :param MT: optional explicit transpose of ``M`` (same contract).
    :param stagnation_window: if > 0, stop after this many iterations
      without improving the best residual.
    :param variant: ``"classic"`` (4 reductions per iteration: the
      biorthogonality coupling, both Lanczos normalizations, the
      residual norm) or ``"1r"`` (round 5, VERDICT r4 #5): ALL scalar
      couplings of the two-sided step ride ONE stacked (7, N) x (N, 5)
      cross-Gram per iteration.  The coupling :math:`\delta_{k+1} =
      w_{k+1}^T v_{k+1} = \tilde w^T\tilde v/(\rho\xi)` is carried one
      step (its expansion :math:`\tilde w^T\tilde v = w_a^T p_t -
      \beta\,w_a^T v - \beta\,w^T p_t + \beta^2\delta_k` uses only Gram
      entries), both normalizations come from the conjugated-norm
      expansions of :math:`\tilde v = p_t - \beta v` / :math:`\tilde w
      = w_a - \beta w`, and the residual norm from the expansion of
      :math:`r' = r - \eta p_t - \mathrm{sh}\, s` (the residual VECTOR
      recurrence is unchanged -- only its norm is derived, CG-style;
      the explicit-residual honesty check still verifies candidates
      against the true residual).  ``"auto"`` picks ``"1r"`` under a
      multi-device mesh context via the shared price model.
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

    if variant == "auto":
        from ..parallel import active_mesh_size
        from . import policy

        _mesh_n = active_mesh_size()
        variant = (
            "1r"
            if _mesh_n > 1
            and policy.prefer_one_reduce(
                "qmr", N // _mesh_n, jnp.dtype(dtype).itemsize,
                syncs_saved=3,
            )
            else "classic"
        )
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown qmr variant {variant!r}")
    one_reduce = variant == "1r"

    def Ahat(x):
        return A_mv(apply(M_mv, x))

    if AT is None and MT is None:
        Ahat_t = transpose_matvec(Ahat, N, dtype)
    else:
        AT_mv = (
            cast_matvec(as_matvec(AT), dtype)
            if AT is not None
            else transpose_matvec(A_mv, N, dtype)
        )
        if M_mv is None:
            MT_mv = None
        elif MT is not None:
            MT_mv = cast_matvec(as_matvec(MT), dtype)
        else:
            MT_mv = transpose_matvec(M_mv, N, dtype)

        def Ahat_t(x):
            return apply(MT_mv, AT_mv(x))

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    bnorm = jnp.linalg.norm(bv)
    r0 = bv - A_mv(x0v)
    rel0 = safe_div(jnp.linalg.norm(r0), bnorm)

    eps_tiny = jnp.asarray(jnp.finfo(real_dtype).tiny * 1e4, real_dtype)
    zero = jnp.zeros(N, dtype)

    def body(state):
        k = state.k
        v = state.vt / state.rho
        w = state.wt / state.xi
        # bilinear, unconjugated coupling; carried one step in "1r"
        # (derived from last iteration's Gram -- see below)
        delta = state.delta_c if one_reduce else jnp.sum(w * v)

        first = k == 0
        p = v - jnp.where(
            first, 0.0, safe_div(state.xi * delta, state.eps)
        ) * state.p
        q = w - jnp.where(
            first, 0.0, safe_div(state.rho * delta, state.eps)
        ) * state.q

        pt = Ahat(p)
        if one_reduce:
            # THE one fused reduction of the iteration: a (9, N) x
            # (N, 6) cross-Gram carrying the bilinear Lanczos couplings
            # (pre-conjugated rows cancel the einsum's conjugation),
            # the conjugated norm-expansion products, AND the measured
            # self-corrections nu_v = <v,v>, nu_w = <w,w>, delta_m =
            # w^T v, rr_m = <r,r>.  Measuring these instead of assuming
            # 1/carried values is load-bearing (the MINRES nu lesson):
            # the norm expansions lose accuracy exactly at cancellation
            # and the error otherwise compounds through the next
            # normalization -- with the measured anchors every
            # expansion is one-step-fresh and the replayed recurrence
            # tracks the classic one to the attainable floor
            # (tests/test_qmr.py parity).
            wta = Ahat_t(q)
            L = jnp.stack([
                pt, wta, state.r, state.s,
                jnp.conj(w), jnp.conj(q), jnp.conj(wta), v, w,
            ])
            R = jnp.stack([v, pt, w, state.s, wta, state.r])
            G = jnp.einsum("iN,jN->ij", L.conj(), R)
            pt_v = G[0, 0]          # <pt, v>
            pt_pt = jnp.real(G[0, 1])
            pt_s = G[0, 3]
            wta_w = G[1, 2]
            wta_wta = jnp.real(G[1, 4])
            r_pt = G[2, 1]
            r_s = G[2, 3]
            rr_m = jnp.real(G[2, 5])
            s_s = jnp.real(G[3, 3])
            w_pt_b = G[4, 1]        # bilinear w^T pt
            delta_m = G[4, 0]       # measured bilinear coupling w^T v
            eps_k = G[5, 1]         # bilinear q^T pt
            wta_pt_b = G[6, 1]
            wta_v_b = G[6, 0]
            nu_v = jnp.real(G[7, 0])
            nu_w = jnp.real(G[8, 2])

            delta = delta_m
            beta = safe_div(eps_k, delta_m)
            b2 = jnp.abs(beta) ** 2
            rho_new = jnp.sqrt(jnp.maximum(
                pt_pt - 2.0 * jnp.real(beta * pt_v) + b2 * nu_v, 0.0
            )).astype(dtype)
            xi_new = jnp.sqrt(jnp.maximum(
                wta_wta - 2.0 * jnp.real(beta * wta_w) + b2 * nu_w, 0.0
            )).astype(dtype)
            vt = pt - beta * v
            wt = wta - beta * w
            # next coupling: wt^T vt expanded from Gram entries
            wtvt = (
                wta_pt_b - beta * wta_v_b - beta * w_pt_b
                + beta * beta * delta_m
            )
            delta_next = safe_div(wtvt, (rho_new * xi_new).astype(dtype))
        else:
            eps_k = jnp.sum(q * pt)
            beta = safe_div(eps_k, delta)
            vt = pt - beta * v
            rho_new = jnp.linalg.norm(vt).astype(dtype)
            wt = Ahat_t(q) - beta * w
            xi_new = jnp.linalg.norm(wt).astype(dtype)
            delta_next = state.delta_c

        theta = safe_div(
            rho_new, state.gamma * jnp.abs(beta)
        ).real.astype(real_dtype)
        gamma = 1.0 / jnp.sqrt(1.0 + theta * theta)
        eta = -safe_div(
            state.eta * state.rho * gamma * gamma,
            beta * state.gamma * state.gamma,
        )

        shrink = (state.theta * gamma) ** 2
        sh = jnp.where(first, 0.0, shrink)
        d = eta * p + sh * state.d
        s = eta * pt + sh * state.s
        u = state.u + d
        r = state.r - s

        if one_reduce:
            # residual norm by ONE-STEP expansion of r' = r - eta*pt -
            # sh*s_old, anchored on the MEASURED <r, r> of the current
            # residual (the vector recurrence above is unchanged; only
            # its norm is derived, and the anchor means the expansion's
            # cancellation error never accumulates across iterations)
            rr_new = jnp.maximum(
                rr_m
                - 2.0 * jnp.real(eta * r_pt + sh * r_s)
                + jnp.abs(eta) ** 2 * pt_pt
                + 2.0 * sh * jnp.real(jnp.conj(eta) * pt_s)
                + sh * sh * s_s,
                0.0,
            )
            rel_upd = safe_div(jnp.sqrt(rr_new), bnorm)
        else:
            rr_new = state.rr
            rel_upd = safe_div(jnp.linalg.norm(r), bnorm)
        need_explicit = (
            explicit_residual | (rel_upd <= tol) | (k + 1 == maxiter)
        )

        def with_explicit(_):
            x = x0v + apply(M_mv, u)
            return safe_div(jnp.linalg.norm(bv - A_mv(x)), bnorm)

        rel = lax.cond(need_explicit, with_explicit,
                       lambda _: rel_upd, None)

        broken = (
            (jnp.abs(delta) <= eps_tiny)
            | (jnp.abs(eps_k) <= eps_tiny)
            | (jnp.abs(rho_new) <= eps_tiny)
            | (jnp.abs(xi_new) <= eps_tiny)
            | (gamma <= eps_tiny)
            | ~jnp.isfinite(rel)
        )
        improved = rel < 0.99 * state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(rel, state.best_rel)
        resnorms = state.resnorms.at[k + 1].set(rel)
        return _QmrState(
            k + 1, u, r, vt, wt, p, q, d, s,
            rho_new, xi_new, eps_k, gamma, eta, theta,
            rel, best, stall, broken, resnorms,
            delta_next, rr_new,
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

    rho0 = jnp.linalg.norm(r0).astype(dtype)
    if one_reduce:
        # entry-only reductions: the first coupling delta_0 = w_0^T v_0
        # = r0^T r0 / rho0^2 (bilinear) and ||r0||^2
        delta0 = safe_div(jnp.sum(r0 * r0), rho0 * rho0)
        rr0 = jnp.real(jnp.vdot(r0, r0))
    else:
        delta0 = jnp.asarray(0.0, dtype)
        rr0 = jnp.asarray(0.0, real_dtype)
    init = _QmrState(
        jnp.asarray(0),
        zero,
        r0,
        r0,
        r0,
        zero,
        zero,
        zero,
        zero,
        rho0,
        rho0,
        jnp.asarray(1.0, dtype),
        jnp.asarray(1.0, real_dtype),
        jnp.asarray(-1.0, dtype),
        jnp.asarray(0.0, real_dtype),
        rel0,
        rel0,
        jnp.asarray(0),
        # zero rhs (rho == 0) must not divide; loop is skipped anyway
        jnp.asarray(False) | (rho0 == 0),
        jnp.full(maxiter + 1, jnp.nan, real_dtype).at[0].set(rel0),
        delta0.astype(dtype),
        rr0.astype(real_dtype),
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(
        final.cur_rel <= tol,
        CONVERGED,
        jnp.where(final.broken & (final.k > 0), BREAKDOWN, MAXITER),
    )
    x = x0v + apply(M_mv, final.u)
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.k,
        status=status,
    )
