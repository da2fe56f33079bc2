r"""Block solvers: one solve for multiple right-hand sides.

Not a reference capability (krypy solves a single rhs per call, its
``(N, 1)`` vectors notwithstanding) -- this is accelerator-native surface: every
operation of the block methods is an ``(N, k)`` GEMM or a ``(k, k)``
factorization, exactly the shapes the matrix units want, and the k systems share
every matvec's HBM traffic.

* :func:`block_cg` -- classical block CG (O'Leary 1980) for SPD systems,
  with an eigenvalue-floor rank-collapse guard: converged/dependent
  columns stop moving while the rest keep the block-Krylov acceleration.
* :func:`block_gmres` -- block GMRES (Vital 1990): block Arnoldi with
  two-pass panel-blocked Gram-Schmidt, rank-guarded panel
  orthonormalization, and a fixed-shape masked least squares per step.
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
    system_dtype,
)

__all__ = ["block_cg", "block_gmres"]


class _BlockCgState(NamedTuple):
    it: jnp.ndarray
    X: jnp.ndarray            # (N, k) iterates
    R: jnp.ndarray            # (N, k) residuals
    Z: jnp.ndarray            # (N, k) preconditioned residuals
    P: jnp.ndarray            # (N, k) search directions
    rels: jnp.ndarray         # (k,) per-column relative residuals
    max_rel: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray     # (maxiter+1, k)


def _guarded_solve(G, rhs, floor_ratio):
    """Solve the Hermitian small system ``G a = rhs`` with an eigenvalue
    floor: eigenvalues below ``floor_ratio * lambda_max`` are treated as
    converged/dependent directions and their components zeroed."""
    Gh = 0.5 * (G + G.conj().T)
    w, V = jnp.linalg.eigh(Gh)
    wmax = jnp.maximum(jnp.max(jnp.abs(w)), 1e-300)
    keep = w > floor_ratio * wmax
    winv = jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0)
    return V @ (winv[:, None] * (V.conj().T @ rhs))


def block_cg(
    A,
    B,
    *,
    M=None,
    X0=None,
    tol=1e-5,
    maxiter=None,
    floor_ratio=1e-12,
):
    """Solve SPD ``A X = B`` for all columns of ``B`` simultaneously.

    :param B: right-hand sides, shape ``(N, k)``.
    :param M: optional SPD preconditioner matvec (applied columnwise).
    :param tol: per-column relative residual target (Euclidean); the
      solve runs until EVERY column converges.
    :param floor_ratio: relative eigenvalue floor of the direction Gram
      matrix below which directions are dropped (rank-collapse guard).
    :return: :class:`~krypy_tpu.functional.common.SolveResult` with
      ``x`` of shape ``(N, k)`` and ``resnorms`` of shape
      ``(maxiter+1, k)`` (NaN beyond ``niter``).
    """
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError("block_cg expects B with shape (N, k)")
    N, k = B.shape
    # NOTE: ceil(N/k) is NOT a safe default bound -- it assumes a
    # full-rank block (rank-deficient rhs, e.g. duplicated columns,
    # converge like single-rhs CG).  The default matches cg's N; pass
    # maxiter explicitly at large N, since the per-column history
    # buffer is (maxiter+1, k).
    maxiter = N if maxiter is None else int(maxiter)

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(B, X0)
    B = B.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))
    real_dtype = jnp.zeros(0, dtype).real.dtype

    def blk(mv):
        """Lift a matvec to blocks: operators that natively accept
        ``(N, j)`` blocks (matrices) are used directly; matvec-only
        operators (stencils) are applied columnwise.  The probe uses a
        SINGLE column, so elementwise operators whose broadcast happens
        to reproduce B's shape when k == N cannot fool it; it runs at
        trace time, so the decision is static and the probe op is dead
        code the compiler drops."""
        if mv is None:
            return None
        try:
            probe = mv(B[:, :1])
            if probe.shape == (N, 1):
                return mv
        except Exception:  # noqa -- shape/rank mismatch: columnwise
            pass
        return lambda X: jnp.stack(
            [mv(X[:, j]) for j in range(k)], axis=1
        )

    A_blk = blk(A_mv)
    M_blk = blk(M_mv)

    X0v = (
        jnp.zeros((N, k), dtype)
        if X0 is None
        else jnp.asarray(X0).astype(dtype)
    )
    bnorms = jnp.maximum(
        jnp.linalg.norm(B, axis=0).astype(real_dtype), 1e-300
    )

    R0 = B - A_blk(X0v)
    Z0 = apply(M_blk, R0)
    rels0 = (jnp.linalg.norm(R0, axis=0) / bnorms).astype(real_dtype)

    resnorms0 = jnp.full((maxiter + 1, k), jnp.nan, real_dtype)
    resnorms0 = resnorms0.at[0].set(rels0)

    def body(state):
        Q = A_blk(state.P)
        PQ = jnp.dot(state.P.conj().T, Q)            # (k, k)
        PR = jnp.dot(state.P.conj().T, state.R)
        alpha = _guarded_solve(PQ, PR, floor_ratio)
        X = state.X + jnp.dot(state.P, alpha)
        R = state.R - jnp.dot(Q, alpha)
        Z = apply(M_blk, R)
        QZ = jnp.dot(Q.conj().T, Z)
        beta = -_guarded_solve(PQ, QZ, floor_ratio)
        P = Z + jnp.dot(state.P, beta)

        rels = (jnp.linalg.norm(R, axis=0) / bnorms).astype(real_dtype)
        max_rel = jnp.max(rels)
        broken = ~jnp.isfinite(max_rel)
        resnorms = state.resnorms.at[state.it + 1].set(rels)
        return _BlockCgState(
            state.it + 1, X, R, Z, P, rels, max_rel, broken, resnorms
        )

    def cond(state):
        return (
            (state.max_rel > tol)
            & (state.it < maxiter)
            & ~state.broken
        )

    init = _BlockCgState(
        jnp.asarray(0),
        X0v,
        R0,
        Z0,
        Z0,
        rels0,
        jnp.max(rels0),
        jnp.asarray(False),
        resnorms0,
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(
        final.max_rel <= tol,
        CONVERGED,
        jnp.where(final.broken, BREAKDOWN, MAXITER),
    )
    return SolveResult(
        x=final.X,
        resnorms=final.resnorms,
        niter=final.it,
        status=status,
    )


class _BlockGmresState(NamedTuple):
    it: jnp.ndarray           # completed block steps
    V: jnp.ndarray            # ((m+1)*k, N) basis rows, block j at j*k
    H: jnp.ndarray            # ((m+1)*k, m*k) block Hessenberg
    R: jnp.ndarray            # ((m+1)*k, m*k) rotated upper-triangular H
    Qacc: jnp.ndarray         # ((m+1)*k, (m+1)*k) accumulated rotations
    g: jnp.ndarray            # ((m+1)*k, k) rotated projected rhs
    rels: jnp.ndarray         # (k,) per-column LS residuals
    max_rel: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray     # (m+1, k)


def _panel_orth(W, floor_ratio, real_dtype):
    """Orthonormalize the rows of ``W`` (k, N) with a rank guard.

    Returns ``(Q, L)`` with ``W = L Q``, Q's rows orthonormal and rows
    of collapsed directions exactly zero.  Uses the Hermitian
    eigendecomposition of the small Gram matrix (the block analog of
    CholQR, robust to the rank deficiency that converged columns
    cause); applied twice by the caller for CGS2-class orthogonality.
    """
    G = jnp.dot(W.conj(), W.T)
    w, U = jnp.linalg.eigh(0.5 * (G + G.conj().T))
    w = jnp.maximum(w.astype(real_dtype), 0.0)
    wmax = jnp.maximum(jnp.max(w), 1e-300)
    keep = w > floor_ratio * wmax
    sq = jnp.sqrt(jnp.where(keep, w, 1.0))
    inv = jnp.where(keep, 1.0 / sq, 0.0).astype(W.dtype)
    # plain (not conjugate) transpose of U in Q, conj(U) in L: with the
    # row Gram G = conj(W) W^T = U diag(w) U^H this gives
    # conj(Q) Q^T = mask (orthonormal rows) and L Q = W exactly
    Q = inv[:, None] * jnp.dot(U.T, W)
    L = U.conj() * jnp.where(keep, sq, 0.0).astype(W.dtype)[None, :]
    return Q, L


def block_gmres(
    A,
    B,
    *,
    Ml=None,
    Mr=None,
    X0=None,
    tol=1e-5,
    maxiter=None,
    floor_ratio=1e-12,
    return_internal=False,
):
    r"""Solve ``A X = B`` for all columns of ``B`` with block GMRES.

    Block Arnoldi: each step applies the operator to a (k, N) panel (one
    shared HBM pass over the operator for k systems), orthogonalizes it
    against the basis with two passes of panel-blocked Gram-Schmidt
    (reading only panels holding active rows), and orthonormalizes via a
    rank-guarded Gram eigendecomposition -- converged or linearly
    dependent columns collapse to zero rows and stop consuming work,
    while the fixed-shape masked least squares keeps every column's
    residual tracked.

    :param B: right-hand sides, shape ``(N, k)``.
    :param Ml, Mr: left/right preconditioner matvecs (Euclidean inner
      product only).
    :param tol: per-column relative residual target; the solve runs
      until EVERY column converges.
    :param maxiter: BLOCK steps (each grows every column's Krylov space
      by one); the basis buffer is ``((maxiter+1)*k, N)``, so pass this
      explicitly at large N.
    :return: :class:`~krypy_tpu.functional.common.SolveResult` with
      ``x`` of shape ``(N, k)``, ``resnorms`` of shape
      ``(maxiter+1, k)``, and ``niter`` counting block steps.

    Reference baseline: krypy has no block solver (its GMRES is
    krypy/linsys.py:877-1018); accelerator-native surface.
    """
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError("block_gmres expects B with shape (N, k)")
    N, k = B.shape
    maxiter = max(1, N // k) if maxiter is None else int(maxiter)
    m = maxiter

    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    dtype = system_dtype(B, X0)
    B = B.astype(dtype)
    A_mv, Ml_mv, Mr_mv = (
        cast_matvec(f, dtype) for f in (A_mv, Ml_mv, Mr_mv)
    )
    real_dtype = jnp.zeros(0, dtype).real.dtype

    def op_rows(P):
        """Apply Ml A Mr to each ROW of a (k, N) panel; vmap lets XLA
        batch dense operators into one GEMM and stencils into one
        shifted-window sweep."""
        return jax.vmap(
            lambda v: apply(Ml_mv, A_mv(apply(Mr_mv, v)))
        )(P)

    X0v = (
        jnp.zeros((N, k), dtype)
        if X0 is None
        else jnp.asarray(X0).astype(dtype)
    )

    MlB = jax.vmap(lambda v: apply(Ml_mv, v))(B.T).T
    bnorms = jnp.maximum(
        jnp.linalg.norm(MlB, axis=0).astype(real_dtype), 1e-300
    )
    if X0 is None:
        R0 = MlB
    else:
        R0 = MlB - jax.vmap(lambda v: apply(Ml_mv, A_mv(v)))(X0v.T).T

    # initial panel: rows of V are basis vectors; with the row-form
    # factorization R0^T = S0 Q0 the column-form coordinates of R0 over
    # the basis are S0^T (R0 = Q0^T S0^T)
    Q0, S0 = _panel_orth(R0.T, floor_ratio, real_dtype)
    V0 = jnp.zeros(((m + 1) * k, N), dtype)
    V0 = lax.dynamic_update_slice(V0, Q0, (0, 0))

    rels0 = (jnp.linalg.norm(R0, axis=0) / bnorms).astype(real_dtype)
    resnorms0 = jnp.full((m + 1, k), jnp.nan, real_dtype).at[0].set(rels0)

    rhs_ls = jnp.zeros(((m + 1) * k, k), dtype)
    rhs_ls = lax.dynamic_update_slice(rhs_ls, S0.T, (0, 0))
    _pr = max(1, min(32, (m + 1) * k))

    def solve_Y(R, g, K):
        """Minimum-norm least-squares coefficients from the rotated
        system: columns >= K are untouched (all-zero) and collapsed
        directions leave exactly-zero R diagonals -- bump both and zero
        the matching Y rows (a zero R column cannot propagate its y
        into any other back-substitution row)."""
        Rk = R[: m * k, : m * k]
        dead = (jnp.arange(m * k) >= K) | (
            jnp.abs(jnp.diagonal(Rk)) == 0
        )
        Rk = Rk + jnp.diag(dead.astype(dtype))
        rhs = jnp.where((jnp.arange(m * k) < K)[:, None], g[: m * k], 0.0)
        Y = jax.scipy.linalg.solve_triangular(Rk, rhs)
        return jnp.where(dead[:, None], 0.0, Y)

    def assemble_X(V, Y):
        Yk = jnp.dot(V[: m * k].T, Y)                  # (N, k)
        return X0v + jax.vmap(lambda v: apply(Mr_mv, v))(Yk.T).T

    def body(state):
        it = state.it
        row0 = it * k
        Vj = lax.dynamic_slice_in_dim(state.V, row0, k, 0)
        W = op_rows(Vj)                                   # (k, N)

        # two passes of panel-blocked Gram-Schmidt against active rows
        C = jnp.zeros(((m + 1) * k, k), dtype)

        def panel_body(p, carry):
            Wp, Cp = carry
            start = jnp.minimum(p * _pr, (m + 1) * k - _pr)
            Vp = lax.dynamic_slice_in_dim(state.V, start, _pr, 0)
            ridx = start + jnp.arange(_pr)
            rmask = (
                (ridx >= p * _pr) & (ridx < row0 + k)
            ).astype(real_dtype)
            coeffs = jnp.dot(Vp.conj(), Wp.T) * rmask[:, None]
            Wp = Wp - jnp.dot(coeffs.T, Vp)
            seg = lax.dynamic_slice_in_dim(Cp, start, _pr, 0)
            Cp = lax.dynamic_update_slice(Cp, seg + coeffs, (start, 0))
            return Wp, Cp

        active_panels = (row0 + k - 1) // _pr + 1
        for _ in range(2):
            W, C = lax.fori_loop(0, active_panels, panel_body, (W, C))

        # rank-guarded panel orthonormalization (x2: CGS2-class)
        Q1, L1 = _panel_orth(W, floor_ratio, real_dtype)
        Q2, L2 = _panel_orth(Q1, floor_ratio, real_dtype)
        Qp = Q2
        Lfac = jnp.dot(L1, L2)                            # W = Lfac Qp

        V = lax.dynamic_update_slice(state.V, Qp, (row0 + k, 0))

        # Hessenberg block column: C rows + Lfac^T at block row it+1
        # (same row-form/column-form transpose as S0 above)
        hcol = lax.dynamic_update_slice(C, Lfac.T, (row0 + k, 0))
        H = lax.dynamic_update_slice(state.H, hcol, (0, row0))

        # incremental block QR of the Hessenberg: rotate the new block
        # column by the accumulated transform (one small GEMM), then a
        # LOCAL (2k, 2k) QR zeroes the subdiagonal block -- the block
        # analog of the scalar core's matrix-accumulated Givens
        # (functional/gmres.py); no full-matrix QR per step
        col = jnp.dot(state.Qacc, hcol)
        T = lax.dynamic_slice(col, (row0, 0), (2 * k, k))
        qt, rt = jnp.linalg.qr(T, mode="complete")     # T = qt rt
        col = lax.dynamic_update_slice(col, rt, (row0, 0))
        R = lax.dynamic_update_slice(state.R, col, (0, row0))
        Qrows = lax.dynamic_slice(
            state.Qacc, (row0, 0), (2 * k, (m + 1) * k)
        )
        Qacc = lax.dynamic_update_slice(
            state.Qacc, jnp.dot(qt.conj().T, Qrows), (row0, 0)
        )
        grows = lax.dynamic_slice(state.g, (row0, 0), (2 * k, k))
        g = lax.dynamic_update_slice(
            state.g, jnp.dot(qt.conj().T, grows), (row0, 0)
        )

        # per-column LS residuals: column norms of the rotated rhs tail
        tail = jnp.arange((m + 1) * k) >= row0 + k
        rels = (
            jnp.linalg.norm(g * tail[:, None], axis=0).astype(real_dtype)
            / bnorms
        )
        max_rel = jnp.max(rels)
        broken = ~jnp.isfinite(max_rel)
        resnorms = state.resnorms.at[it + 1].set(rels)
        return _BlockGmresState(
            it + 1, V, H, R, Qacc, g, rels, max_rel, broken, resnorms
        )

    def cond(state):
        return (
            (state.max_rel > tol)
            & (state.it < m)
            & ~state.broken
        )

    init = _BlockGmresState(
        jnp.asarray(0),
        V0,
        jnp.zeros(((m + 1) * k, m * k), dtype),
        jnp.zeros(((m + 1) * k, m * k), dtype),
        jnp.eye((m + 1) * k, dtype=dtype),
        rhs_ls,
        rels0,
        jnp.max(rels0),
        jnp.asarray(False),
        resnorms0,
    )
    final = lax.while_loop(cond, body, init)

    Y = solve_Y(final.R, final.g, final.it * k)
    X = assemble_X(final.V, Y)

    status = jnp.where(
        final.max_rel <= tol,
        CONVERGED,
        jnp.where(final.broken, BREAKDOWN, MAXITER),
    )
    result = SolveResult(
        x=X,
        resnorms=final.resnorms,
        niter=final.it,
        status=status,
    )
    if return_internal:
        return result, {"V": final.V, "H": final.H, "Y": Y}
    return result
