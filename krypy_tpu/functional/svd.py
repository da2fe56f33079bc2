r"""Partial SVD: k largest singular triplets of a (possibly
rectangular) operator.

``svds`` runs :func:`~krypy_tpu.functional.lobpcg.lobpcg` on the Gram
operator :math:`C = A^H A` (SPD on the column space) with
``which='la'``, then recovers :math:`\sigma_i = \sqrt{\theta_i}` and
the left vectors :math:`u_i = A v_i / \sigma_i`.  This is the natural
Accelerator shape -- the whole solve is ``(3k, N)`` block GEMMs inside one
compiled while_loop, with one A and one :math:`A^H` application per
wanted triplet per iteration -- and squaring the spectrum is benign for
the LARGEST singular values (their relative gaps only widen; the
classic objection to the normal equations concerns the smallest ones,
which this routine deliberately does not serve -- use
:func:`~krypy_tpu.functional.lsq.lsqr` machinery for least-squares work
near the small end).

Every returned triplet is certified EXPLICITLY: the reported residuals
are :math:`\|A^H u_i - \sigma_i v_i\| / \sigma_1` (the
:math:`\|A v_i - \sigma_i u_i\|` half is zero by construction of
``u``), computed on the final vectors, not inherited from the inner
eigensolve's estimates -- the same honesty convention as ``eigsh``'s
shift-invert verification.

The reference has no SVD surface at all (krypy exposes only square-system
solvers, krypy/linsys.py); this module is accelerator-native extra surface.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .common import CONVERGED, MAXITER, as_matvec, cast_matvec
from .lobpcg import lobpcg
from .lsq import _setup

__all__ = ["svds", "SvdsResult"]


class SvdsResult(NamedTuple):
    """Result pytree of :func:`svds`."""

    #: left singular vectors as columns, shape ``(m, k)``
    U: jnp.ndarray
    #: singular values, shape ``(k,)``, descending
    s: jnp.ndarray
    #: right singular vectors as rows, shape ``(k, n)`` (scipy's
    #: ``svds`` convention)
    Vh: jnp.ndarray
    #: max certified triplet residual per inner iteration is not
    #: available (the inner solve tracks Gram residuals); this is the
    #: inner eigensolve's history
    resnorms: jnp.ndarray
    #: inner Rayleigh-Ritz iterations
    niter: jnp.ndarray
    #: CONVERGED / MAXITER -- from the EXPLICIT triplet residuals
    status: jnp.ndarray
    #: certified per-triplet residuals ||A^H u - sigma v|| / sigma_1
    pair_resnorms: jnp.ndarray = None

    @property
    def converged(self):
        return self.status == CONVERGED


def svds(
    A,
    k=6,
    *,
    Ah=None,
    n=None,
    X0=None,
    M=None,
    tol=1e-8,
    maxiter=500,
):
    r"""k LARGEST singular triplets of ``A`` by preconditioned LOBPCG
    on the Gram operator, as one compiled while_loop.

    :param A: operator, shape ``(m, n)`` (matrix, or matvec callable
      with ``Ah``).  May be rectangular.
    :param k: number of triplets.
    :param Ah: conjugate-transpose matvec ``y -> A^H y``; derived
      automatically for matrices and operators exposing ``.adj``.
    :param n: column dimension when ``A`` has no ``.shape`` and no
      ``X0``.
    :param X0: starting right-vector block, shape ``(n, k)`` columns.
      REQUIRED (complex-typed) for complex *callable* operators -- the
      dtype cannot be probed without applying A, and a real start would
      silently project the Gram operator onto its real part (matrices
      are handled automatically).
    :param M: optional SPD preconditioner for :math:`A^H A` applied to
      Gram residuals (e.g. an approximate inverse of the normal
      operator).
    :param tol: certified-triplet test
      :math:`\|A^H u_i - \sigma_i v_i\| \le \mathrm{tol}\,\sigma_1`
      for all k triplets.  The inner eigensolve (backward-error
      criterion on the Gram operator, normalized by
      :math:`\|C\| = \sigma_1^2`) is driven 20x tighter, because a
      Gram backward error of :math:`b` maps to a triplet residual of
      :math:`b\,\sigma_1/\sigma_i`; triplets with
      :math:`\sigma_i < \sigma_1/20` may honestly report MAXITER at
      tight tolerances (their certified residuals are returned either
      way).
    :param maxiter: inner Rayleigh-Ritz iterations.
    :return: :class:`SvdsResult`.
    """
    A_mv, Ah_mv = _setup(A, Ah)

    if X0 is not None:
        X0 = jnp.asarray(X0)
        if X0.ndim != 2:
            raise ValueError(f"X0 must be (n, k), got shape {X0.shape}")
        # the block width IS the triplet count (the same convention the
        # inner eigensolver applies); a stale k would desynchronize the
        # U/Vh assembly below from the inner solve's k
        k = int(X0.shape[1])

    if X0 is None and n is None:
        shape = getattr(A, "shape", None)
        if shape is None or len(shape) != 2:
            raise ValueError(
                "n= or X0= required when A has no 2-D .shape"
            )
        n = int(shape[1])

    if X0 is None:
        # the DTYPE must be pinned here, not inside the eigensolver: a
        # real-typed default start would make cast_matvec project the
        # complex Gram operator onto its real part -- the inner solve
        # then converges (its own criterion) on the WRONG operator,
        # caught only by the explicit certification below.  Matrices
        # carry their dtype; complex CALLABLES need a complex X0= (or a
        # complex-typed probe is impossible without applying A).
        op_dt = None
        if hasattr(A, "ndim"):
            op_dt = jnp.asarray(A).dtype
        elif hasattr(A, "dtype"):
            op_dt = jnp.dtype(A.dtype)
        if op_dt is not None and jnp.issubdtype(
            op_dt, jnp.complexfloating
        ):
            idx = jnp.arange(int(n))
            X0 = jnp.stack(
                [
                    jnp.cos(idx * (0.7391 + 0.1137 * i)) + 0.01 * (i + 1)
                    for i in range(int(k))
                ],
                axis=1,
            ).astype(op_dt)

    def gram(v):
        return Ah_mv(A_mv(v))

    r = lobpcg(
        gram,
        k,
        X0=X0,
        n=n,
        M=M,
        which="la",
        tol=0.05 * tol,
        maxiter=maxiter,
        criterion="backward",
    )

    theta = jnp.maximum(jnp.real(r.theta), 0.0)
    s = jnp.sqrt(theta)
    V = r.U                                             # (n, k) columns
    dtype = V.dtype
    A_c = jax.vmap(cast_matvec(as_matvec(A_mv), dtype))
    Ah_c = jax.vmap(cast_matvec(as_matvec(Ah_mv), dtype))
    AV = A_c(V.T).T                        # one batched apply, not k
    # u_i = A v_i / sigma_i; an exactly-zero sigma (rank < k) yields a
    # zero left vector, reported honestly through its residual
    s_safe = jnp.where(s > 0, s, 1.0).astype(dtype)
    U = AV / s_safe[None, :] * (s > 0)[None, :].astype(V.real.dtype)
    # explicit certification: ||A^H u - sigma v|| / sigma_1 (the
    # ||A v - sigma u|| half vanishes by construction)
    AhU = Ah_c(U.T).T
    res = jnp.linalg.norm(
        AhU - V * s[None, :].astype(dtype), axis=0
    )
    eps_floor = jnp.asarray(
        jnp.finfo(s.dtype).tiny ** 0.5, s.dtype
    )
    pair_res = res / jnp.maximum(s[0], eps_floor)
    status = jnp.where(
        jnp.max(pair_res) <= tol, CONVERGED, MAXITER
    )
    return SvdsResult(
        U=U,
        s=s,
        Vh=V.conj().T,
        resnorms=r.resnorms,
        niter=r.niter,
        status=status,
        pair_resnorms=pair_res,
    )
