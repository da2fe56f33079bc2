"""QR factorization with a customizable inner product
(reference: krypy/utils.py:680-707).

The Euclidean case uses the fused device QR.  The B-inner-product case runs
iterated modified Gram-Schmidt; for the blocked fast variant used inside
jitted solver cores see :mod:`krypy_tpu.kernels.orthogonalize`.
"""

import jax.numpy as jnp

from .products import inner, norm

__all__ = ["qr"]


def qr(X, ip_B=None, reorthos=1):
    """Economic QR of an ``(N, k)`` block: ``X = Q R`` with
    :math:`\\langle Q, Q\\rangle_{B} = I_k` and R upper triangular.

    :param reorthos: number of reorthogonalization sweeps (default 1, i.e.
      two MGS passes -- "twice is enough").
    """
    X = jnp.asarray(X)
    (N, k) = X.shape
    if ip_B is None and k > 0:
        return jnp.linalg.qr(X, mode="reduced")
    Q = X
    R = jnp.zeros((k, k), dtype=X.dtype)
    for i in range(k):
        col = Q[:, [i]]
        for _ in range(reorthos + 1):
            for j in range(i):
                alpha = inner(Q[:, [j]], col, ip_B=ip_B)[0, 0]
                R = R.at[j, i].add(alpha)
                col = col - alpha * Q[:, [j]]
        rii = norm(col, ip_B=ip_B)
        R = R.at[i, i].set(rii)
        col = jnp.where(rii >= 1e-15, col / jnp.where(rii == 0, 1.0, rii), col)
        Q = Q.at[:, [i]].set(col)
    return Q, R
