"""Orthogonal and oblique projections (reference: krypy/utils.py:439-677).

Implements the numerically stable XQRY representation from
G. W. Stewart, "On the numerical analysis of oblique projectors" (2011):
the projection :math:`P_{\\mathcal{X},\\mathcal{Y}^\\perp}` is stored as
orthonormal bases V (of X) and W (of Y) plus a small QR factorization of
:math:`\\langle W, V\\rangle`.  Iterated application ("twice is enough") is
the default.  All N-dim work is jnp matmuls, so a sharded basis turns each
application into two GEMMs + an all-reduce on a device mesh.
"""

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..errors import ArgumentError
from .operators import (
    IdentityLinearOperator,
    LinearOperator,
    ZeroLinearOperator,
)
from .products import inner
from .qr import qr
from .dtypes import find_common_dtype

__all__ = ["Projection"]


class Projection:
    r"""Projection :math:`P_{\mathcal{X},\mathcal{Y}^\perp}` with range
    ``colspan(X)`` and kernel ``colspan(Y)``:math:`^\perp`.

    :param X: array with shape ``(N, k)``, full rank.
    :param Y: (optional) array with shape ``(N, k)``; defaults to ``X``
      (orthogonal projection).
    :param ip_B: (optional) inner product, see
      :func:`~krypy_tpu.core.products.inner`.
    :param orthogonalize: orthonormalize the supplied bases (default True).
    :param iterations: number of applications per :meth:`apply` call
      (default 2, per Stewart's round-off analysis).
    """

    def __init__(self, X, Y=None, ip_B=None, orthogonalize=True, iterations=2):
        if iterations < 1:
            raise ArgumentError("iterations < 1 not allowed")
        self.ip_B = ip_B
        self.orthogonalize = orthogonalize
        self.iterations = iterations

        X = jnp.asarray(X)
        Y = X if Y is None else jnp.asarray(Y)
        if X.ndim != 2:
            raise ArgumentError("X does not have shape==(N,k)")
        if X.shape != Y.shape:
            raise ArgumentError("X and Y have different shapes")

        # empty basis -> zero projection
        if X.shape[1] == 0:
            self.V = self.W = jnp.zeros(X.shape)
            self.VR = self.WR = self.Q = self.R = None
            return

        if orthogonalize:
            self.V, self.VR = qr(X, ip_B=ip_B)
        else:
            self.V, self.VR = X, None

        if Y is X and orthogonalize:
            # orthogonal projection: W = V, cross Gram is the identity
            self.W, self.WR = self.V, self.VR
            self.Q = self.R = None
        else:
            if orthogonalize:
                self.W, self.WR = qr(Y, ip_B=ip_B)
            else:
                self.W, self.WR = Y, None
            M = inner(self.W, self.V, ip_B=ip_B)
            self.Q, self.R = jnp.linalg.qr(M, mode="complete")

    # -- single applications ---------------------------------------------
    def _solve_coeffs(self, c):
        """Map :math:`\\langle W, a\\rangle` to basis coefficients of Pa."""
        if self.Q is not None and self.R is not None:
            c = jsl.solve_triangular(self.R, jnp.dot(self.Q.conj().T, c))
        return c

    def _apply(self, a, return_Ya=False):
        if self.V.shape[1] == 0:
            Pa = jnp.zeros(a.shape)
            return (Pa, jnp.zeros((0, a.shape[1]))) if return_Ya else Pa
        c = inner(self.W, a, ip_B=self.ip_B)
        if return_Ya:
            Ya = c
            if self.WR is not None:
                Ya = jnp.dot(self.WR.conj().T, Ya)
        Pa = jnp.dot(self.V, self._solve_coeffs(c))
        return (Pa, Ya) if return_Ya else Pa

    def _apply_adj(self, a):
        if self.V.shape[1] == 0:
            return jnp.zeros(a.shape)
        c = inner(self.V, a, ip_B=self.ip_B)
        if self.Q is not None and self.R is not None:
            c = jnp.dot(
                self.Q, jsl.solve_triangular(self.R.conj().T, c, lower=True)
            )
        return jnp.dot(self.W, c)

    # -- iterated applications -------------------------------------------
    def apply(self, a, return_Ya=False):
        r"""Apply the projection: :math:`P a`.

        With ``return_Ya=True`` also returns :math:`\langle Y, a\rangle`.
        """
        a = jnp.asarray(a)
        if self.V.shape[1] == 0:
            Pa = jnp.zeros(a.shape)
            return (Pa, jnp.zeros((0, a.shape[1]))) if return_Ya else Pa
        if return_Ya:
            x, Ya = self._apply(a, return_Ya=True)
        else:
            x = self._apply(a)
        for _ in range(self.iterations - 1):
            x = x + self._apply(a - x)
        return (x, Ya) if return_Ya else x

    def apply_adj(self, a):
        a = jnp.asarray(a)
        if self.V.shape[1] == 0:
            return jnp.zeros(a.shape)
        x = self._apply_adj(a)
        for _ in range(self.iterations - 1):
            x = x + self._apply_adj(a - x)
        return x

    def apply_complement(self, a, return_Ya=False):
        r"""Apply the complementary projection
        :math:`(I - P)a = P_{\mathcal{Y}^\perp,\mathcal{X}} a`."""
        a = jnp.asarray(a)
        if self.V.shape[1] == 0:
            return (a, jnp.zeros((0, a.shape[1]))) if return_Ya else a
        if return_Ya:
            x, Ya = self._apply(a, return_Ya=True)
        else:
            x = self._apply(a)
        z = a - x
        for _ in range(self.iterations - 1):
            z = z - self._apply(z)
        return (z, Ya) if return_Ya else z

    def apply_complement_adj(self, a):
        a = jnp.asarray(a)
        if self.V.shape[1] == 0:
            return a
        z = a - self._apply_adj(a)
        for _ in range(self.iterations - 1):
            z = z - self._apply_adj(z)
        return z

    # -- operator views ---------------------------------------------------
    def _get_operator(self, fun, fun_adj):
        N = self.V.shape[0]
        dt = find_common_dtype(self.V, self.W)
        return LinearOperator((N, N), dt, fun, fun_adj)

    def operator(self):
        """LinearOperator view of :meth:`apply`."""
        if self.V.shape[1] == 0:
            return ZeroLinearOperator((self.V.shape[0],) * 2)
        return self._get_operator(self.apply, self.apply_adj)

    def operator_complement(self):
        """LinearOperator view of :meth:`apply_complement`."""
        if self.V.shape[1] == 0:
            return IdentityLinearOperator((self.V.shape[0],) * 2)
        return self._get_operator(
            self.apply_complement, self.apply_complement_adj
        )

    def matrix(self):
        """Dense matrix representation (testing only)."""
        return self.apply(jnp.eye(self.V.shape[0]))
