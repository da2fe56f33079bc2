"""Matrix-free linear operators on JAX arrays.

The reference models operators as objects with ``dot``/``dot_adj`` and lazy
combinator algebra (krypy/utils.py:1365-1636).  We keep that public surface --
``*``, ``+``, ``-``, ``**``, ``.adj`` -- but the payload functions are pure
jnp functions, so any operator can be closed over by a jitted solver core and
traced by XLA.  Block application convention: operators act on ``(N, k)``
blocks; 1-D ``(N,)`` vectors are also accepted and returned as 1-D.
"""

import numpy as np
import jax.numpy as jnp

from ..errors import ArgumentError, LinearOperatorError
from .dtypes import find_common_dtype

__all__ = [
    "LinearOperator",
    "IdentityLinearOperator",
    "ZeroLinearOperator",
    "MatrixLinearOperator",
    "DiagonalLinearOperator",
    "FunctionLinearOperator",
    "TimedLinearOperator",
    "get_linearoperator",
]


class LinearOperator:
    """A linear operator ``A: C^n -> C^m`` defined by its (adjoint) action.

    :param shape: ``(m, n)``.
    :param dtype: numpy-compatible dtype of the operator.
    :param dot: callable mapping an ``(n, k)`` block to an ``(m, k)`` block.
    :param dot_adj: callable for the adjoint action (optional).
    """

    def __init__(self, shape, dtype, dot=None, dot_adj=None):
        if len(shape) != 2:
            raise LinearOperatorError("shape must be (m, n)")
        try:
            shape = (int(shape[0]), int(shape[1]))
        except (TypeError, ValueError):
            raise LinearOperatorError("shape must be (m, n) with integers")
        if dot is None and dot_adj is None:
            raise LinearOperatorError("dot or dot_adj has to be defined")
        self.shape = shape
        self.dtype = np.dtype(dtype)
        self._dot = dot
        self._dot_adj = dot_adj

    # -- application ------------------------------------------------------
    def _apply(self, fun, X, in_dim):
        if fun is None:
            raise LinearOperatorError("action undefined")
        X = jnp.asarray(X)
        flat = X.ndim == 1
        if flat:
            X = X[:, None]
        if X.shape[0] != in_dim:
            raise LinearOperatorError(
                f"dimension mismatch: operator {self.shape}, input {X.shape}"
            )
        if X.shape[1] == 0:
            Y = jnp.zeros((self.shape[0], 0), dtype=X.dtype)
        else:
            Y = fun(X)
        return Y[:, 0] if flat else Y

    def dot(self, X):
        return self._apply(self._dot, X, self.shape[1])

    def dot_adj(self, X):
        return self._apply(self._dot_adj, X, self.shape[0])

    def __call__(self, X):
        return self.dot(X)

    def as_function(self):
        """Return the pure block-action function (for jitted cores)."""
        return self.dot

    # -- algebra ----------------------------------------------------------
    @property
    def adj(self):
        return _AdjointOperator(self)

    def __mul__(self, other):
        try:
            if isinstance(other, IdentityLinearOperator):
                return self
            if isinstance(self, IdentityLinearOperator):
                return other
            if isinstance(other, LinearOperator):
                return _ProductOperator(self, other)
            if np.isscalar(other):
                return _ScaledOperator(self, other)
            return self.dot(other)
        except LinearOperatorError:
            return NotImplemented

    def __rmul__(self, alpha):
        try:
            return _ScaledOperator(self, alpha)
        except LinearOperatorError:
            return NotImplemented

    def __pow__(self, p):
        try:
            return _PowerOperator(self, p)
        except LinearOperatorError:
            return NotImplemented

    def __add__(self, other):
        try:
            return _SumOperator(self, other)
        except LinearOperatorError:
            return NotImplemented

    def __neg__(self):
        return _ScaledOperator(self, -1)

    def __sub__(self, other):
        return self + (-other)

    def __repr__(self):
        m, n = self.shape
        return f"<{m}x{n} {self.__class__.__name__} with dtype={self.dtype}>"


class _SumOperator(LinearOperator):
    def __init__(self, A, B):
        if not isinstance(A, LinearOperator) or not isinstance(B, LinearOperator):
            raise LinearOperatorError("both operands must be LinearOperator")
        if A.shape != B.shape:
            raise LinearOperatorError("shape mismatch")
        self.args = (A, B)
        super().__init__(
            A.shape,
            find_common_dtype(A, B),
            lambda X: A.dot(X) + B.dot(X),
            lambda X: A.dot_adj(X) + B.dot_adj(X),
        )


class _ProductOperator(LinearOperator):
    def __init__(self, A, B):
        if not isinstance(A, LinearOperator) or not isinstance(B, LinearOperator):
            raise LinearOperatorError("both operands must be LinearOperator")
        if A.shape[1] != B.shape[0]:
            raise LinearOperatorError("shape mismatch")
        self.args = (A, B)
        super().__init__(
            (A.shape[0], B.shape[1]),
            find_common_dtype(A, B),
            lambda X: A.dot(B.dot(X)),
            lambda X: B.dot_adj(A.dot_adj(X)),
        )


class _ScaledOperator(LinearOperator):
    def __init__(self, A, alpha):
        if not isinstance(A, LinearOperator):
            raise LinearOperatorError("LinearOperator expected")
        if not np.isscalar(alpha):
            raise LinearOperatorError("scalar expected")
        self.args = (A, alpha)
        super().__init__(
            A.shape,
            find_common_dtype(A, np.asarray(alpha)),
            lambda X: alpha * A.dot(X),
            lambda X: np.conj(alpha) * A.dot_adj(X),
        )


class _PowerOperator(LinearOperator):
    def __init__(self, A, p):
        if not isinstance(A, LinearOperator):
            raise LinearOperatorError("LinearOperator expected")
        if A.shape[0] != A.shape[1]:
            raise LinearOperatorError("square operator expected")
        if not isinstance(p, (int, np.integer)) or p < 0:
            raise LinearOperatorError("non-negative integer power expected")
        self.args = (A, p)

        def power(fun, X):
            for _ in range(p):
                X = fun(X)
            return X

        super().__init__(
            A.shape,
            A.dtype,
            lambda X: power(A.dot, X),
            lambda X: power(A.dot_adj, X),
        )


class _AdjointOperator(LinearOperator):
    def __init__(self, A):
        if not isinstance(A, LinearOperator):
            raise LinearOperatorError("LinearOperator expected")
        self.args = (A,)
        m, n = A.shape
        super().__init__((n, m), A.dtype, A._dot_adj, A._dot)


class IdentityLinearOperator(LinearOperator):
    def __init__(self, shape):
        super().__init__(shape, np.dtype("float64"), lambda X: X, lambda X: X)


class ZeroLinearOperator(LinearOperator):
    def __init__(self, shape):
        super().__init__(
            shape,
            np.dtype("float64"),
            lambda X: jnp.zeros((shape[0],) + X.shape[1:], dtype=X.dtype),
            lambda X: jnp.zeros((shape[1],) + X.shape[1:], dtype=X.dtype),
        )


class MatrixLinearOperator(LinearOperator):
    """Operator backed by an explicit (dense or JAX-sparse) matrix."""

    def __init__(self, A):
        A = A if hasattr(A, "todense") or hasattr(A, "sum_duplicates") else jnp.asarray(A)
        self._A = A
        super().__init__(
            A.shape,
            A.dtype,
            lambda X: self._matmul(X),
            lambda X: self._matmul_adj(X),
        )

    def _matmul(self, X):
        return self._A @ X

    def _matmul_adj(self, X):
        return self._A.conj().T @ X

    @property
    def array(self):
        return self._A

    def __repr__(self):
        return self._A.__repr__()


class DiagonalLinearOperator(LinearOperator):
    """Operator ``diag(d)`` -- O(N) storage, elementwise application."""

    def __init__(self, d):
        d = jnp.asarray(d)
        if d.ndim != 1:
            raise ArgumentError("expected a 1-d array of diagonal entries")
        self.d = d
        n = d.shape[0]
        super().__init__(
            (n, n),
            d.dtype,
            lambda X: self.d[:, None] * X,
            lambda X: jnp.conj(self.d)[:, None] * X,
        )


class FunctionLinearOperator(LinearOperator):
    """Operator defined by pure functions acting on 1-D vectors.

    Convenience for matrix-free device operators: ``matvec`` maps ``(n,)`` to
    ``(m,)`` and is vmapped over block columns automatically.
    """

    def __init__(self, shape, dtype, matvec, rmatvec=None):
        import jax

        dot = lambda X: jax.vmap(matvec, in_axes=1, out_axes=1)(X)
        dot_adj = None
        if rmatvec is not None:
            dot_adj = lambda X: jax.vmap(rmatvec, in_axes=1, out_axes=1)(X)
        self.matvec = matvec
        self.rmatvec = rmatvec
        super().__init__(shape, dtype, dot, dot_adj)


class TimedLinearOperator(LinearOperator):
    """Wraps an operator, recording per-column wall-clock application time
    into a :class:`~krypy_tpu.core.timers.Timer`
    (reference: krypy/utils.py:1605-1636).

    Timing jitted/async dispatches requires a synchronization point, so the
    result is blocked upon before the timer stops.  This is intended for the
    eager compatibility lane and cost-model calibration, not for inside-jit
    use.
    """

    def __init__(self, linear_operator, timer=None):
        from .timers import Timer

        self._linear_operator = linear_operator
        self._timer = Timer() if timer is None else timer
        super().__init__(
            linear_operator.shape,
            linear_operator.dtype,
            linear_operator._dot,
            linear_operator._dot_adj,
        )

    def _timed(self, fun, X):
        k = X.shape[1] if X.ndim == 2 else 1
        if k == 0:
            return fun(X)
        with self._timer:
            ret = fun(X)
            try:
                ret.block_until_ready()
            except AttributeError:
                pass
        self._timer[-1] /= k
        return ret

    def dot(self, X):
        return self._timed(self._linear_operator.dot, X)

    def dot_adj(self, X):
        return self._timed(self._linear_operator.dot_adj, X)


def get_linearoperator(shape, A, timer=None):
    """Coerce ``A`` into a :class:`LinearOperator`
    (reference: krypy/utils.py:241-273).

    Accepts: ``None`` (identity), LinearOperator, ndarray / jnp array,
    scipy sparse matrix (converted to a JAX BCOO matrix), scipy
    LinearOperator, or jax.experimental.sparse matrices.
    """
    ret = None
    if isinstance(A, LinearOperator):
        ret = A
    elif A is None:
        ret = IdentityLinearOperator(shape)
    elif isinstance(A, (np.ndarray, jnp.ndarray)):
        ret = MatrixLinearOperator(A)
    else:
        # scipy sparse?
        if hasattr(A, "tocoo") and hasattr(A, "shape"):
            from jax.experimental import sparse as jsparse

            coo = A.tocoo()
            mat = jsparse.BCOO(
                (jnp.asarray(coo.data), jnp.column_stack(
                    [jnp.asarray(coo.row), jnp.asarray(coo.col)])),
                shape=coo.shape,
            )
            ret = MatrixLinearOperator(mat)
        elif hasattr(A, "matvec") and hasattr(A, "shape"):
            # scipy-style LinearOperator
            if not hasattr(A, "dtype"):
                raise ArgumentError("operator has no dtype")
            rmat = getattr(A, "rmatvec", None)
            ret = LinearOperator(
                A.shape,
                A.dtype,
                dot=lambda X: jnp.asarray(A.matmat(np.asarray(X)))
                if hasattr(A, "matmat")
                else jnp.asarray(A.matvec(np.asarray(X))),
                dot_adj=(lambda X: jnp.asarray(A.rmatvec(np.asarray(X))))
                if rmat is not None
                else None,
            )
        elif hasattr(A, "sum_duplicates") or type(A).__module__.startswith(
            "jax.experimental.sparse"
        ):
            ret = MatrixLinearOperator(A)
        else:
            raise TypeError(f"type not understood: {type(A)}")

    if (
        A is not None
        and not isinstance(ret, IdentityLinearOperator)
        and timer is not None
    ):
        ret = TimedLinearOperator(ret, timer)

    if tuple(shape) != tuple(ret.shape):
        raise LinearOperatorError(
            f"shape mismatch: expected {shape}, got {ret.shape}"
        )
    return ret
