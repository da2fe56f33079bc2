r"""Flexible GMRES: GMRES with a variable (even nonlinear) right
preconditioner.

FGMRES (Saad 1993) stores the preconditioned directions
:math:`z_j = M_j(v_j)` alongside the orthonormal basis and reconstructs
the solution from Z, so :math:`M` may change every iteration -- in
particular it may itself be an iterative solver (inner-outer Krylov).
The cost is a second (m, N) buffer of HBM.

Accelerator shape: identical to :mod:`krypy_tpu.functional.gmres` -- one
``lax.while_loop``, row-major fixed-shape bases, batched/paneled
orthogonalization, matrix-accumulated Givens, on-device convergence
test; the flexible preconditioner is any jittable callable (an inner
functional solver with a fixed iteration budget traces straight into the
outer loop).

Reference baseline: krypy has no flexible variant (its Mr must be a
fixed linear operator, krypy/linsys.py:83-85); accelerator-native surface.
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
    as_matvec,
    cast_matvec,
    breakdown_threshold,
    givens_traced,
    safe_div,
    system_dtype,
)

__all__ = ["fgmres"]


class _FgmresState(NamedTuple):
    k: jnp.ndarray
    V: jnp.ndarray           # (m+1, N) orthonormal basis rows
    Z: jnp.ndarray           # (m, N) flexible directions z_j = M_j(v_j)
    H: jnp.ndarray           # (m+1, m) Hessenberg
    R: jnp.ndarray           # (m+1, m) rotated Hessenberg
    Q: jnp.ndarray           # (m+1, m+1) accumulated Givens product
    y: jnp.ndarray           # (m+1,) rotated projected rhs
    hsq: jnp.ndarray
    cur_rel: jnp.ndarray
    invariant: jnp.ndarray
    resnorms: jnp.ndarray


def fgmres(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    ortho="cgs2",
    explicit_residual=False,
):
    """Solve ``A x = b`` with flexible right preconditioning.

    :param M: the flexible preconditioner -- ANY jittable callable
      ``v -> z`` approximating :math:`A^{-1} v`; it need not be linear
      or the same from one iteration to the next (e.g.
      ``lambda v: cg(A, v, maxiter=5, tol=0).x``).  ``None`` reduces to
      plain GMRES.
    :param ortho: ``'cgs'``/``'cgs2'`` (batched) or ``'bmgs'``/
      ``'bmgs2'`` (row panels); Euclidean inner product only.
    :return: :class:`~krypy_tpu.functional.common.SolveResult`.

    Reference semantics for the shared mechanics (Givens QR of H,
    invariance detection, explicit-residual policy):
    krypy/linsys.py:951-997, krypy/utils.py:1035-1039.
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = N if maxiter is None else int(maxiter)

    A_mv = as_matvec(A)
    if M is None:
        M_fn = lambda v: v  # noqa: E731
    elif callable(M) and not hasattr(M, "ndim"):
        M_fn = M
    else:
        M_fn = as_matvec(M)

    passes = {"cgs": 1, "cgs2": 2, "bmgs": 1, "bmgs2": 2}[ortho]
    paneled = ortho in ("bmgs", "bmgs2")

    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    M_fn = cast_matvec(M_fn, dtype)
    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )
    real_dtype = jnp.zeros(0, dtype).real.dtype
    brk = breakdown_threshold(dtype)

    bnorm = jnp.linalg.norm(bv)
    r0 = bv - A_mv(x0v)
    beta = jnp.linalg.norm(r0)
    rel0 = safe_div(beta, bnorm)

    v0 = jnp.where(beta > 0, 1.0, 0.0) * safe_div(1.0, beta)
    V0 = jnp.zeros((m + 1, N), dtype).at[0].set(r0 * v0)

    panel_rows = max(1, min(16, m + 1))

    def orthogonalize(V, w, k):
        mask = jnp.arange(m + 1) <= k
        h = jnp.zeros(m + 1, dtype)
        if paneled:
            def panel_body(p, carry):
                w, h = carry
                start = jnp.minimum(p * panel_rows, m + 1 - panel_rows)
                Vp = lax.dynamic_slice_in_dim(V, start, panel_rows, 0)
                ridx = start + jnp.arange(panel_rows)
                rmask = (ridx >= p * panel_rows) & (ridx <= k)
                coeffs = jnp.dot(Vp.conj(), w) * rmask
                w = w - jnp.dot(coeffs, Vp)
                seg = lax.dynamic_slice_in_dim(h, start, panel_rows, 0)
                h = lax.dynamic_update_slice_in_dim(
                    h, seg + coeffs, start, 0
                )
                return (w, h)

            active = k // panel_rows + 1
            for _ in range(passes):
                w, h = lax.fori_loop(0, active, panel_body, (w, h))
        else:
            for _ in range(passes):
                coeffs = jnp.dot(V.conj(), w) * mask
                w = w - jnp.dot(coeffs, V)
                h = h + coeffs
        return w, h

    def xk_from(Z, R, y, k):
        col_mask = jnp.arange(m) < k
        Rk = R[:m, :m] + jnp.diag(
            jnp.where(col_mask, 0.0, 1.0).astype(dtype)
        )
        rhs = jnp.where(col_mask, y[:m], 0.0).astype(dtype)
        yy = jax.scipy.linalg.solve_triangular(Rk, rhs)
        return x0v + jnp.dot(yy, Z)

    def cond(state):
        return (
            (state.cur_rel > tol)
            & (state.k < m)
            & jnp.logical_not(state.invariant)
        )

    def body(state):
        k = state.k
        z = M_fn(state.V[k])
        w = A_mv(z)
        Z = state.Z.at[k].set(z)
        w, h = orthogonalize(state.V, w, k)
        hnew = jnp.linalg.norm(w)

        hsq = state.hsq + jnp.sum(jnp.abs(h) ** 2) + hnew**2
        invariant = hnew <= brk * jnp.sqrt(hsq)

        h = h.at[k + 1].set(hnew.astype(dtype))
        inv_h = jnp.where(invariant, 0.0, safe_div(1.0, hnew))
        V = state.V.at[k + 1].set(w * inv_h)
        H = state.H.at[:, k].set(h)

        col = jnp.dot(state.Q, h)
        c_new, s_new, r_new = givens_traced(col[k], col[k + 1])
        col = col.at[k].set(r_new).at[k + 1].set(0.0)
        qk = state.Q[k]
        qk1 = state.Q[k + 1]
        Q = (
            state.Q.at[k].set(c_new * qk + s_new * qk1)
            .at[k + 1].set(-jnp.conj(s_new) * qk + c_new * qk1)
        )
        R = state.R.at[:, k].set(col)

        yk_new = state.y[k]
        y = state.y.at[k].set(c_new * yk_new)
        y = y.at[k + 1].set(-jnp.conj(s_new) * yk_new)

        rel_upd = safe_div(jnp.abs(y[k + 1]), bnorm)
        need_explicit = (
            explicit_residual | (rel_upd <= tol) | (k + 1 == m)
            | invariant
        )

        def with_explicit(_):
            xk = xk_from(Z, R, y, k + 1)
            return safe_div(jnp.linalg.norm(bv - A_mv(xk)), bnorm)

        rel = lax.cond(need_explicit, with_explicit,
                       lambda _: rel_upd, None)
        resnorms = state.resnorms.at[k + 1].set(rel)
        return _FgmresState(
            k + 1, V, Z, H, R, Q, y, hsq, rel, invariant, resnorms
        )

    init = _FgmresState(
        jnp.asarray(0),
        V0,
        jnp.zeros((m, N), dtype),
        jnp.zeros((m + 1, m), dtype),
        jnp.zeros((m + 1, m), dtype),
        jnp.eye(m + 1, dtype=dtype),
        jnp.zeros(m + 1, dtype).at[0].set(beta.astype(dtype)),
        jnp.asarray(0.0, real_dtype),
        rel0,
        beta == 0,
        jnp.full(m + 1, jnp.nan, real_dtype).at[0].set(rel0),
    )
    final = lax.while_loop(cond, body, init)

    x = xk_from(final.Z, final.R, final.y, final.k)
    status = jnp.where(
        final.cur_rel <= tol,
        CONVERGED,
        jnp.where(final.invariant, BREAKDOWN, MAXITER),
    )
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.k,
        status=status,
    )
