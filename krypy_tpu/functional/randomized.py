r"""Randomized low-rank primitives: randomized SVD and the Nystrom
preconditioner.

Both are pure block-GEMM algorithms (Halko-Martinsson-Tropp range
finding): every flop is a ``(N, l)`` panel contraction on the matrix units, there
are no per-vector inner products and no growing sweeps, and the number
of operator applications is fixed up front -- the natural accelerator shape for
low-rank approximation, complementing the iterative extreme-triplet
solver :func:`~krypy_tpu.functional.svd.svds` (LOBPCG) which serves
high-accuracy ends of the spectrum.

* :func:`rsvd` -- fixed-rank approximate SVD with subspace (power)
  iteration; for matvec-only operators the adjoint is derived with
  ``jax.linear_transpose`` (conjugated on both sides), like
  :func:`~krypy_tpu.functional.qmr.qmr` does for the transpose.
* :func:`nystrom_preconditioner` -- the randomized Nystrom
  preconditioner for SPD systems (Frangella, Tropp & Udell, SIAM J.
  Sci. Comput. 2023): one block of ``rank+p`` matvecs at construction,
  then each application is two small panel contractions and ZERO
  operator applications; with spectral decay it clusters the
  preconditioned spectrum at 1 and caps the CG iteration count.

Small dense factorizations (the ``(l, l)`` Gram eigendecompositions)
run as single device ``eigh`` calls OUTSIDE any while_loop -- compiling
``eigh`` inside a loop is pathologically slow on this runtime
(CLAUDE.md) and ``l`` is tiny.  Squaring the conditioning via the Gram
trick is benign at the accuracy level randomized sketches deliver; the
guarded square roots clamp noise-level directions.

Reference baseline: krypy has no randomized or low-rank surface
(krypy/linsys.py serves square solves only); accelerator-native extra surface.
"""

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .common import as_matvec
from .qmr import transpose_matvec

__all__ = ["RsvdResult", "rsvd", "nystrom_preconditioner", "hutchpp"]


class RsvdResult(NamedTuple):
    """Result pytree of :func:`rsvd`."""

    #: left singular vectors as columns, shape ``(m, k)``
    U: jnp.ndarray
    #: singular values, shape ``(k,)``, descending
    s: jnp.ndarray
    #: right singular vectors as rows, shape ``(k, n)`` (scipy
    #: convention)
    Vh: jnp.ndarray
    #: certified residuals ``max(||A v_i - s_i u_i||,
    #: ||A^H u_i - s_i v_i||) / s_1`` per triplet
    resnorms: jnp.ndarray


def _gaussian(key, shape, dtype):
    real_dtype = jnp.zeros(0, dtype).real.dtype
    if jnp.issubdtype(dtype, jnp.complexfloating):
        kr, ki = jax.random.split(key)
        return (jax.random.normal(kr, shape, real_dtype)
                + 1j * jax.random.normal(ki, shape, real_dtype)
                ).astype(dtype) / math.sqrt(2.0)
    return jax.random.normal(key, shape, dtype)


def _block_ops(A, Ah, n, dtype):
    """(block_A, block_Ah) applying the operator to column panels."""
    if hasattr(A, "ndim") or (hasattr(A, "shape") and not callable(A)):
        mat = jnp.asarray(A).astype(dtype)
        return (lambda X: mat @ X), (lambda Y: mat.conj().T @ Y)
    raw_mv = as_matvec(A)
    # pin the traced function's dtype so the derived transpose's
    # cotangent type matches even when the matvec computes wider
    A_mv = lambda v: raw_mv(v.astype(dtype)).astype(dtype)
    if Ah is None:
        if hasattr(A, "adj"):
            Ah_mv = as_matvec(A.adj)
        else:
            if n is None:
                raise ValueError(
                    "n= (the operator's input dimension) is required "
                    "for callable operators"
                )
            t = transpose_matvec(A_mv, int(n), dtype)
            Ah_mv = lambda y: jnp.conj(t(jnp.conj(y.astype(dtype))))
    else:
        Ah_mv = as_matvec(Ah)
    blk = jax.vmap(lambda v: A_mv(v).astype(dtype), 1, 1)
    blk_h = jax.vmap(lambda v: Ah_mv(v).astype(dtype), 1, 1)
    return blk, blk_h


def _gram_svd(B):
    """Economy SVD of a tall panel via the small Gram eigendecomposition.

    Returns (U, s) with ``B ~ U diag(s) W^H`` where the ``W`` factor is
    folded into U's construction; columns beyond the numerical rank get
    zero singular values and zero columns.
    """
    G = B.conj().T @ B
    w, W = jnp.linalg.eigh(G)  # ascending
    w = w[::-1]
    W = W[:, ::-1]
    s = jnp.sqrt(jnp.maximum(w.real, 0.0))
    smax = jnp.maximum(s[0], jnp.finfo(s.dtype).tiny)
    keep = s > jnp.finfo(s.dtype).eps ** 0.5 * smax
    inv = jnp.where(keep, 1.0 / jnp.where(keep, s, 1.0), 0.0)
    U = (B @ W) * inv[None, :]
    return U, s, W


def rsvd(A, k, *, Ah=None, n=None, p=10, q=2, seed=0, dtype=None):
    r"""Randomized SVD: the ``k`` dominant singular triplets.

    :param A: matrix, or matvec callable ``(n,) -> (m,)``.
    :param Ah: conjugate-transpose matvec; derived automatically via
      ``jax.linear_transpose`` for traceable callables (pass ``n=``).
    :param n: input dimension (callables without ``x0``/shape).
    :param p: oversampling columns (the sketch has ``k + p`` columns).
    :param q: subspace-iteration count; each step is one ``A`` and one
      ``A^H`` panel application with a QR in between (accuracy ~
      :math:`\sigma_{k+1} (\sigma_{k+1}/\sigma_k)^{2q}`).
    :return: :class:`RsvdResult` with certified per-triplet residuals.
    """
    if dtype is None:
        dtype = (jnp.asarray(A).dtype
                 if hasattr(A, "ndim") or (hasattr(A, "shape")
                                           and not callable(A))
                 else jnp.float32)
    if hasattr(A, "shape") and not callable(A) and n is None:
        n = int(jnp.asarray(A).shape[1])
    blk, blk_h = _block_ops(A, Ah, n, dtype)
    if n is None:
        n = int(jnp.asarray(A).shape[1])
    l = int(k) + int(p)

    Om = _gaussian(jax.random.PRNGKey(seed), (int(n), l), dtype)
    Q, _ = jnp.linalg.qr(blk(Om))
    for _ in range(int(q)):
        Z, _ = jnp.linalg.qr(blk_h(Q))
        Q, _ = jnp.linalg.qr(blk(Z))

    B = blk_h(Q)  # (n, l) = A^H Q
    # B^H = Q^H A ~ (U_small) diag(s) V^H: SVD via the small Gram
    V, s, W = _gram_svd(B)
    U = Q @ W

    U, s, V = U[:, :k], s[:k], V[:, :k]
    smax = jnp.maximum(s[0], jnp.finfo(s.dtype).tiny)
    r1 = blk(V) - U * s[None, :]
    r2 = blk_h(U) - V * s[None, :]
    res = jnp.maximum(
        jnp.linalg.norm(r1, axis=0), jnp.linalg.norm(r2, axis=0)
    ) / smax
    return RsvdResult(U=U, s=s, Vh=V.conj().T, resnorms=res)


def nystrom_preconditioner(
    A, rank, n, *, p=10, mu=0.0, seed=0, dtype=jnp.float32,
    return_factors=False,
):
    r"""Randomized Nystrom preconditioner for SPD ``A + mu I``.

    Construction (Frangella-Tropp-Udell): ONE block of ``rank + p``
    matvecs ``Y = A Omega``, a stabilizing shift ``nu = eps ||Y||_F``,
    a small Cholesky and the Gram-trick SVD give the Nystrom
    approximation :math:`\hat A = U \hat\Lambda U^H`.  The returned
    matvec applies

    .. math:: P^{-1} = (\hat\lambda_r + \mu)\, U (\hat\Lambda + \mu I)^{-1} U^H
              + (I - U U^H)

    -- two ``(rank, N)`` panel contractions, ZERO operator
    applications.  With a rapidly decaying spectrum the preconditioned
    spectrum clusters at 1 and CG converges in O(1) iterations
    (tests/test_randomized.py measures the iteration cap).

    :param mu: the shift of the system being solved (``A + mu I``);
      0 for plain SPD ``A``.
    :param return_factors: also return ``(U, lambdas)`` for inspection.
    :return: a matvec callable (and optionally the factors).
    """
    A_mv = as_matvec(A)
    l = int(rank) + int(p)
    dtype = jnp.dtype(dtype)
    Om = _gaussian(jax.random.PRNGKey(seed), (int(n), l), dtype)
    Om, _ = jnp.linalg.qr(Om)
    blk = jax.vmap(lambda v: A_mv(v).astype(dtype), 1, 1)
    Y = blk(Om)
    nu = jnp.finfo(dtype).eps * jnp.linalg.norm(Y)
    Ynu = Y + nu * Om
    G = Om.conj().T @ Ynu
    # symmetrize against roundoff before the Cholesky
    C = jnp.linalg.cholesky(0.5 * (G + G.conj().T))
    B = jax.scipy.linalg.solve_triangular(
        C, Ynu.conj().T, lower=True
    ).conj().T  # (n, l) with B B^H = Ynu G^{-1} Ynu^H
    U, sB, _ = _gram_svd(B)
    lam = jnp.maximum(sB * sB - nu, 0.0)[: int(rank)]
    U = U[:, : int(rank)]

    lam_r = lam[-1]
    scale = lam_r + mu
    denom = lam + mu
    denom = jnp.where(denom > 0, denom, 1.0)

    def P_inv(x):
        c = U.conj().T @ x.astype(dtype)
        inside = U @ (c * (scale / denom))
        return inside + (x.astype(dtype) - U @ c)

    if return_factors:
        return P_inv, (U, lam)
    return P_inv


def hutchpp(A, key, *, n=None, k=32, n_probes=32, Ah=None, dtype=None):
    r"""Hutch++ trace estimate of an implicit square operator (Meyer,
    Musco, Musco & Woodruff 2021).

    Splits ``trace(A)`` into an EXACT low-rank head plus a Hutchinson
    estimate of the deflated tail: with ``Q = qr(A Omega)``,

    .. math:: \mathrm{tr}(A) = \mathrm{tr}(Q^H A Q)
              + \mathrm{E}[z^H (I - QQ^H) A (I - QQ^H) z].

    Deflating the dominant directions cuts the estimator variance from
    the spread of ALL eigenvalues to that of the tail: for PSD ``A``,
    ``O(1/eps)`` matvecs suffice for relative error ``eps`` where plain
    Hutchinson needs ``O(1/eps^2)``.  Complements
    :func:`~krypy_tpu.functional.funm.slq_trace`, which serves
    ``trace(f(A))`` through Lanczos quadrature -- compose them by
    passing ``A = lambda v: funm-apply`` here when ``f(A)`` has rapid
    spectral decay.

    Accelerator shape: everything is three ``(N, k/n_probes)`` block operator
    applications + panel GEMMs; no per-probe loop.

    :param key: PRNGKey for the sketch and the probes.
    :param k: head-sketch columns (the rank deflated exactly).
    :param n_probes: Hutchinson probes on the deflated tail.
    :param Ah: conjugate-transpose matvec for the projector when ``A``
      is non-Hermitian AND matvec-only (derived automatically for
      traceable callables; unnecessary for matrices).
    :return: ``(estimate, stderr)`` -- stderr is the standard error of
      the tail term over probes (the head is exact).
    """
    if dtype is None:
        dtype = (jnp.asarray(A).dtype
                 if hasattr(A, "ndim") or (hasattr(A, "shape")
                                           and not callable(A))
                 else jnp.float32)
    if hasattr(A, "shape") and not callable(A) and n is None:
        n = int(jnp.asarray(A).shape[0])
    if n is None:
        raise ValueError("n= is required for callable operators")
    blk, _ = _block_ops(A, Ah, n, dtype)
    N = int(n)
    k = int(k)
    n_probes = int(n_probes)

    k1, k2 = jax.random.split(jax.random.PRNGKey(key) if isinstance(
        key, int) else key)
    Om = _gaussian(k1, (N, k), dtype)
    Q, _ = jnp.linalg.qr(blk(Om))

    # exact head: trace(Q^H A Q)
    AQ = blk(Q)
    head = jnp.trace(Q.conj().T @ AQ)

    # Hutchinson on the deflated tail, all probes in one block
    real_dtype = jnp.zeros(0, dtype).real.dtype
    Z = jax.random.rademacher(k2, (N, n_probes), real_dtype).astype(dtype)
    Zd = Z - Q @ (Q.conj().T @ Z)        # (I - QQ^H) z
    AZd = blk(Zd)
    AZdd = AZd - Q @ (Q.conj().T @ AZd)  # (I - QQ^H) A (I - QQ^H) z
    quad = jnp.sum(Zd.conj() * AZdd, axis=0)  # (n_probes,)
    tail = jnp.mean(quad)
    stderr = jnp.std(quad.real) / math.sqrt(n_probes)
    return head + tail, stderr
