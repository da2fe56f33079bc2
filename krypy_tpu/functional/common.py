"""Shared infrastructure of the jitted solver cores.

Conventions (differ deliberately from the eager lane, for accelerator efficiency):

* vectors are 1-D ``(N,)`` device arrays;
* Krylov bases are stored ROW-major, shape ``(m+1, N)``: a block inner
  product against the basis is then a single ``(m+1, N) x (N,)``
  contraction that XLA maps onto the matrix units and, for a sharded N axis,
  lowers to partial-dot + all-reduce over the mesh;
* all problem operators are pure matvec callables ``(N,) -> (N,)``;
* statuses replace exceptions (reference: ConvergenceError semantics,
  krypy/linsys.py:466-478, become the MAXITER status here).
"""

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

#: solve reached the requested tolerance
CONVERGED = 0
#: maxiter reached without convergence (reference raises ConvergenceError)
MAXITER = 1
#: the Krylov subspace became invariant (lucky breakdown); the returned
#: iterate is exact up to round-off
BREAKDOWN = 2


class SolveResult(NamedTuple):
    """Result pytree of a functional solve."""

    #: approximate solution, shape ``(N,)``
    x: jnp.ndarray
    #: relative residual norms, shape ``(maxiter+1,)``; entries beyond
    #: ``niter`` are NaN
    resnorms: jnp.ndarray
    #: number of iterations performed
    niter: jnp.ndarray
    #: CONVERGED / MAXITER / BREAKDOWN
    status: jnp.ndarray
    #: error norms if an exact solution was supplied, else None
    errnorms: Optional[jnp.ndarray] = None

    @property
    def converged(self):
        return self.status == CONVERGED


def as_matvec(op):
    """Coerce ``op`` into a pure matvec callable ``(N,) -> (N,)``.

    Accepts ``None`` (identity), a 2-D array, a
    :class:`~krypy_tpu.utils.LinearOperator`, or a callable.
    """
    if op is None:
        return None
    # LinearOperator from the compatibility lane
    if hasattr(op, "dot") and hasattr(op, "shape") and not hasattr(op, "ndim"):
        return lambda x: op.dot(x)
    if hasattr(op, "ndim"):
        mat = jnp.asarray(op)
        if mat.ndim != 2:
            raise ValueError("matrix operator must be 2-D")
        return lambda x: mat @ x
    if callable(op):
        return op
    raise TypeError(f"cannot interpret operator of type {type(op)}")


def apply(mv, x):
    """Apply an optional matvec (None = identity)."""
    return x if mv is None else mv(x)


def cast_matvec(mv, dtype):
    """Pin a matvec's output to the system dtype.

    The functional lane's contract is that the right-hand side's dtype
    governs all device state; an operator that internally computes in a
    wider dtype (e.g. a float64 diagonal against a float32 rhs) would
    otherwise leak promotion into the loop-carried state and break the
    while_loop/cond type matching."""
    if mv is None:
        return None
    return lambda x: mv(x).astype(dtype)


def make_inner(ip):
    """Build the two inner-product forms used by the cores.

    :param ip: ``None`` (Euclidean), a matrix/operator ``B`` (weighted
      product :math:`x^* B y`), or a scalar callable ``ip(x, y)`` on 1-D
      vectors.
    :return: ``(pair, rows)`` where ``pair(x, y) -> scalar`` and
      ``rows(V, w) -> (m,)`` computes :math:`\\langle v_j, w\\rangle` for
      every row of V in one fused contraction.
    """
    if ip is None:
        def pair(x, y):
            return jnp.vdot(x, y)

        def rows(V, w):
            return jnp.dot(V.conj(), w)

        return pair, rows

    if hasattr(ip, "ndim") or hasattr(ip, "dot") and hasattr(ip, "shape"):
        Bmv = as_matvec(ip)

        def pair(x, y):
            return jnp.vdot(x, Bmv(y))

        def rows(V, w):
            return jnp.dot(V.conj(), Bmv(w))

        return pair, rows

    if callable(ip):
        def pair(x, y):
            return jnp.asarray(ip(x, y))

        def rows(V, w):
            return jax.vmap(lambda v: jnp.asarray(ip(v, w)))(V)

        return pair, rows

    raise TypeError(f"cannot interpret inner product of type {type(ip)}")


def make_gram(ip):
    """Build a fused cross-Gram form for the one-reduce rearrangements.

    ``gram(L, R) -> (k, k)`` computes :math:`G_{ij} = \\langle L_i,
    R_j\\rangle` for row-stacked vector bundles in ONE ``(k, N) x (N, k)``
    contraction -- a single partial-dot + all-reduce on a mesh whose N
    axis is sharded, regardless of how many scalars are read off G.

    Scalar-callable inner products cannot be batched into one
    contraction; callers must reject them before reaching here (the
    one-reduce variants raise ``ValueError``).
    """
    if ip is None:
        def gram(L, R):
            return jnp.einsum("iN,jN->ij", L.conj(), R)

        return gram

    if hasattr(ip, "ndim") or hasattr(ip, "dot") and hasattr(ip, "shape"):
        Bmv = as_matvec(ip)

        def gram(L, R):
            # B applications are local matvecs; the einsum is the one
            # mesh sync point
            return jnp.einsum("iN,jN->ij", L.conj(), jax.vmap(Bmv)(R))

        return gram

    raise TypeError(
        "one-reduce fusion needs the Euclidean or operator-weighted "
        f"inner product, got {type(ip)}"
    )


def norm_from_pair(pair, x, y=None):
    """sqrt(Re <x, y>) with the given pair product."""
    val = pair(x, x if y is None else y)
    return jnp.sqrt(jnp.maximum(jnp.real(val), 0.0))


def safe_div(a, b):
    """a / b with b == 0 mapped to 0 (used for relative norms of the
    zero right hand side, reference: krypy/linsys.py:385-387)."""
    return jnp.where(b == 0, 0.0, a / jnp.where(b == 0, 1.0, b))


def breakdown_threshold(dtype):
    """Relative subdiagonal threshold for invariance detection
    (reference: 1e-14 in float64, krypy/utils.py:1035-1039)."""
    eps = np.finfo(np.dtype(dtype)).eps if np.dtype(dtype).kind in "fc" \
        else np.finfo(np.float64).eps
    return float(45 * eps)


def system_dtype(*arrays):
    dt = None
    for a in arrays:
        if a is None:
            continue
        dt = jnp.asarray(a).dtype if dt is None else jnp.promote_types(
            dt, jnp.asarray(a).dtype
        )
    return dt


def givens_traced(a, b):
    """Branch-free complex-safe Givens coefficients ``(c, s, r)`` with
    real c >= 0 for use inside traced code (same convention as the host
    version, krypy_tpu/core/rotations.py)."""
    abs_a = jnp.abs(a)
    abs_b = jnp.abs(b)
    denom = jnp.sqrt(abs_a**2 + abs_b**2)
    safe = jnp.where(denom == 0, 1.0, denom)
    sign_a = jnp.where(abs_a == 0, 1.0 + 0.0 * a,
                       a / jnp.where(abs_a == 0, 1.0, abs_a).astype(a.dtype))
    c = jnp.where(abs_b == 0, 1.0, jnp.where(abs_a == 0, 0.0, abs_a / safe))
    s = jnp.where(
        abs_b == 0,
        0.0 * a,
        jnp.where(
            abs_a == 0,
            jnp.conj(b) / jnp.where(abs_b == 0, 1.0, abs_b).astype(b.dtype),
            sign_a * jnp.conj(b) / safe.astype(a.dtype),
        ),
    )
    r = jnp.where(
        abs_b == 0,
        a,
        jnp.where(abs_a == 0, abs_b.astype(a.dtype), sign_a * denom.astype(a.dtype)),
    )
    return c, s, r
