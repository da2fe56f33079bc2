"""Inner products and norms, Euclidean and B-weighted.

Reference semantics: krypy/utils.py:146-238.  On a sharded device mesh these
contractions are where the collectives live: ``X^* Y`` with X, Y sharded over
the row (N) axis compiles to a local partial matmul followed by an XLA
all-reduce over the mesh axis -- GSPMD inserts the ``psum`` automatically when
the inputs carry a NamedSharding, so the same code serves single-chip and
multi-chip execution.
"""

import jax.numpy as jnp
from jax import core as jax_core

from ..errors import InnerProductError
from .operators import IdentityLinearOperator, LinearOperator, get_linearoperator

__all__ = [
    "ip_euclid",
    "inner",
    "norm_squared",
    "norm",
    "norm_MMlr",
    "orthonormality",
]


def _is_concrete(x):
    """True if ``x`` holds actual values (not a tracer) so host-side value
    checks are possible."""
    return not isinstance(x, jax_core.Tracer)


def ip_euclid(X, Y):
    """Euclidean block inner product :math:`X^* Y` for ``(N, m)`` x ``(N, n)``
    blocks, result ``(m, n)``."""
    return jnp.dot(X.conj().T, Y)


def inner(X, Y, ip_B=None):
    """Block inner product :math:`\\langle X, Y\\rangle`.

    :param ip_B: ``None`` (Euclidean), a matrix/operator ``B`` giving
      :math:`X^* B Y`, or a callable ``ip_B(X, Y)``.

    The B-application side is chosen to minimize work when the block widths
    differ (reference: krypy/utils.py:190-193).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if ip_B is None or isinstance(ip_B, IdentityLinearOperator):
        return jnp.dot(X.conj().T, Y)
    (N, m) = X.shape
    n = Y.shape[1]
    if isinstance(ip_B, LinearOperator) or hasattr(ip_B, "shape"):
        B = get_linearoperator((N, N), ip_B)
        if m > n:
            return jnp.dot(B.dot(X).conj().T, Y)
        return jnp.dot(X.conj().T, B.dot(Y))
    # callable inner product
    return jnp.asarray(ip_B(X, Y))


def norm_squared(x, Mx=None, inner_product=ip_euclid):
    """Squared norm w.r.t. a given product (reference: krypy/utils.py:196-211)."""
    assert x.ndim == 2
    rho = inner_product(x, x if Mx is None else Mx)
    if rho.shape == (1, 1) and _is_concrete(rho):
        val = complex(rho[0, 0])
        if abs(val.imag) > abs(val) * 1e-10 or val.real < 0.0:
            raise InnerProductError(
                f"<x,Mx> = {val}. Is the inner product indefinite?"
            )
    return jnp.linalg.norm(rho, 2)


def norm(x, y=None, ip_B=None):
    r"""Compute :math:`\sqrt{\langle x, y\rangle}` (block-norm for blocks).

    Raises :class:`InnerProductError` when the diagonal of the inner product
    has a significant imaginary part -- an indefiniteness indicator
    (reference: krypy/utils.py:214-238).  The check only runs in eager
    (non-traced) execution; jitted cores deal in status flags instead.
    """
    x = jnp.asarray(x)
    if y is None and (ip_B is None or isinstance(ip_B, IdentityLinearOperator)):
        if x.ndim == 2 and x.shape[1] == 1:
            # single column: the spectral norm IS the vector 2-norm --
            # and jnp.linalg.norm(x, 2) on an (N, 1) matrix lowers to a
            # full SVD (O(N^2) workspace: 4 TB at N=1e6).  Reduce
            # directly.
            return jnp.linalg.norm(x.reshape(-1))
        return jnp.linalg.norm(x, 2)
    if y is None:
        y = x
    ip = inner(x, y, ip_B=ip_B)
    if _is_concrete(ip):
        nrm_diag = jnp.linalg.norm(jnp.diag(ip), 2)
        nrm_diag_imag = jnp.linalg.norm(jnp.imag(jnp.diag(ip)), 2)
        if nrm_diag_imag > nrm_diag * 1e-10:
            raise InnerProductError(
                "inner product defined by ip_B not positive definite? "
                f"||diag(ip).imag||/||diag(ip)||={nrm_diag_imag / nrm_diag}"
            )
    return jnp.sqrt(jnp.linalg.norm(ip, 2))


def norm_MMlr(M, Ml, A, Mr, b, x0, yk, inner_product=ip_euclid):
    """Residual norm helper: given yk, compute xk and
    :math:`\\|M M_l (b - A(x_0 + M_r y_k))\\|_{M^{-1}}`
    (reference: krypy/utils.py:276-294)."""
    xk = x0 + Mr * yk
    r = b - A * xk
    Mlr = Ml * r
    norm_Mlr = norm(Mlr)
    if _is_concrete(norm_Mlr) and float(norm_Mlr) == 0:
        MMlr = jnp.zeros(Mlr.shape)
        norm_MMlr = 0
    else:
        nMMlr = M * (Mlr / norm_Mlr)
        MMlr = nMMlr * norm_Mlr
        ip_B = None if inner_product is ip_euclid else inner_product
        norm_MMlr = norm(Mlr, MMlr, ip_B=ip_B)
    return xk, Mlr, MMlr, norm_MMlr


def orthonormality(V, ip_B=None):
    """Deviation from orthonormality :math:`\\|I - \\langle V,V\\rangle\\|_2`
    (reference: krypy/utils.py:297-305)."""
    return norm(jnp.eye(V.shape[1]) - inner(V, V, ip_B=ip_B))
