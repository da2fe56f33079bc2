"""Arnoldi / Lanczos relation builders.

This module provides the incremental :class:`Arnoldi` engine with the four
orthogonalization schemes of the reference (krypy/utils.py:854-1081):
modified Gram-Schmidt (``'mgs'``), doubly-reorthogonalized MGS (``'dmgs'``),
the Lanczos three-term recurrence (``'lanczos'``) and Householder
(``'house'``), plus classical Gram-Schmidt variants (``'cgs'``, ``'cgs2'``)
that batch the orthogonalization into two GEMMs -- the accelerator-friendly scheme
with dmgs-class stability used by the jitted solver cores in
:mod:`krypy_tpu.functional`.

Design note (eager lane): the accelerator is latency-bound for tiny
sequential updates, so this engine keeps the *small* state -- the Hessenberg
matrix and all scalar coefficients -- on the host in numpy, while every
N-dimensional object (basis vectors, operator applications) stays a device
array.  The jitted lane in :mod:`krypy_tpu.functional` instead keeps
everything on device inside one compiled ``while_loop``.
"""

import warnings

import numpy as np
import jax.numpy as jnp

from .errors import ArgumentError
from .config import invariance_threshold
from .core.dtypes import find_common_dtype
from .core.operators import IdentityLinearOperator, get_linearoperator
from .core.products import inner, norm
from .core.rotations import House

__all__ = ["Arnoldi", "arnoldi", "arnoldi_res", "arnoldi_projected"]

_ORTHO_MODES = ("mgs", "dmgs", "lanczos", "house", "cgs", "cgs2")


def _append_stack(cache, cols, N, dtype):
    """Incrementally maintained column-stack of ``cols`` (a list of
    ``(N, 1)`` device columns).

    Only the columns beyond the cached prefix are stacked and
    concatenated, so a view access after one append issues ONE device
    concatenate instead of restacking all k columns, and a repeat access
    with no new columns is free.  Columns are append-only, so prefix
    reuse is always valid.  (The previous per-access full restack made
    ``explicit_residual=True`` solves O(k^2 N) in basis *rebuild* cost
    alone.)
    """
    n = len(cols)
    if n == 0:
        return jnp.zeros((N, 0), dtype=dtype)
    have = 0 if cache is None else cache.shape[1]
    if have == n:
        return cache
    pending = cols[have:]
    new = (
        pending[0].reshape(N, 1)
        if len(pending) == 1
        else jnp.column_stack(pending)
    )
    return new if have == 0 else jnp.concatenate([cache, new], axis=1)


class Arnoldi:
    r"""Incrementally build V and H with :math:`A V_n = V_{n+1}\underline{H}_n`.

    If the Krylov subspace becomes A-invariant, V and H are truncated so that
    :math:`A V_n = V_n H_n` and :attr:`invariant` is set.

    :param A: linear operator (coercible via ``get_linearoperator``).
    :param v: initial vector ``(N, 1)``.
    :param maxiter: maximal number of iterations (default N).
    :param ortho: one of ``'mgs'`` (default), ``'dmgs'``, ``'cgs'``,
      ``'cgs2'``, ``'lanczos'``, ``'house'``.
    :param M: (optional) self-adjoint positive definite preconditioner; a
      second basis :math:`P_n` with :math:`V_n = M P_n` is then maintained.
      Must be ``None`` for ``ortho='house'``.
    :param ip_B: (optional) inner product; must be Euclidean for
      ``ortho='house'``.
    """

    def __init__(
        self, A, v, maxiter=None, ortho="mgs", M=None, Mv=None, Mv_norm=None,
        ip_B=None,
    ):
        v = jnp.asarray(v)
        N = v.shape[0]
        self.A = get_linearoperator((N, N), A)
        self.maxiter = N if maxiter is None else maxiter
        self.ortho = ortho
        self.M = get_linearoperator((N, N), M)
        if isinstance(self.M, IdentityLinearOperator):
            self.M = None
        self.ip_B = ip_B

        self.dtype = find_common_dtype(self.A, v, M)
        self.iter = 0
        self.invariant = False
        self._N = N
        # device-side basis columns (N, 1) each; host-side Hessenberg
        self._V = []
        self._P = [] if self.M is not None else None
        # cached column-stacks of the above (prefix reuse; append-only)
        self._Vstack = None
        self._Pstack = None
        self._H = np.zeros(
            (self.maxiter + 1, self.maxiter), dtype=self.dtype
        )
        self._breakdown_tol = invariance_threshold(self.dtype)

        if ortho == "house":
            if self.M is not None or (
                ip_B is not None
                and not isinstance(ip_B, IdentityLinearOperator)
            ):
                raise ArgumentError(
                    "Householder orthogonalization requires the Euclidean "
                    "inner product and no preconditioner M"
                )
            self.houses = [House(v)]
            self.vnorm = float(jnp.linalg.norm(v, 2))
        elif ortho in ("mgs", "dmgs", "lanczos", "cgs", "cgs2"):
            self.reorthos = 1 if ortho in ("dmgs", "cgs2") else 0
            if self.M is not None:
                p = v
                v = self.M * p if Mv is None else jnp.asarray(Mv)
                self.vnorm = float(
                    norm(p, v, ip_B=ip_B) if Mv_norm is None else Mv_norm
                )
                if self.vnorm > 0:
                    self._P.append(p / self.vnorm)
            else:
                self.vnorm = float(
                    norm(v, ip_B=ip_B) if Mv_norm is None else Mv_norm
                )
        else:
            raise ArgumentError(
                f"Invalid value '{ortho}' for argument 'ortho'. "
                f"Valid are {', '.join(_ORTHO_MODES)}."
            )

        if self.vnorm > 0:
            self._V.append(v / self.vnorm)
        else:
            self.invariant = True

    # -- views ----------------------------------------------------------
    @property
    def V(self):
        """Device matrix of the basis vectors computed so far, ``(N, k+1)``.

        O(1) for repeat access; one incremental concatenate after an
        append (never a full k-column restack)."""
        self._Vstack = _append_stack(
            self._Vstack, self._V, self._N, self.dtype
        )
        return self._Vstack

    @property
    def P(self):
        """Device matrix of the preconditioned dual basis (``V = M P``)."""
        if self._P is None:
            return None
        self._Pstack = _append_stack(
            self._Pstack, self._P, self._N, self.dtype
        )
        return self._Pstack

    @property
    def H(self):
        """Host Hessenberg buffer, shape ``(maxiter+1, maxiter)``."""
        return self._H

    def basis_vector(self, k):
        """The k-th basis vector as a device ``(N, 1)`` column."""
        return self._V[k]

    # ------------------------------------------------------------------
    def advance(self):
        """Carry out one Arnoldi iteration."""
        if self.iter >= self.maxiter:
            raise ArgumentError("Maximum number of iterations reached.")
        if self.invariant:
            raise ArgumentError(
                "Krylov subspace was found to be invariant in the previous "
                "iteration."
            )

        k = self.iter
        Av = self.A * self._V[k]

        if self.ortho == "house":
            self._advance_house(Av, k)
        else:
            self._advance_gs(Av, k)
        self.iter += 1

    def _check_invariance(self, k):
        """Relative-subdiagonal breakdown test
        (reference: krypy/utils.py:1035-1039)."""
        subdiag = abs(self._H[k + 1, k])
        hnorm = np.linalg.norm(self._H[: k + 2, : k + 1], 2)
        if subdiag / hnorm <= self._breakdown_tol:
            self.invariant = True
            return True
        return False

    def _alpha_scalar(self, alpha, conj=False):
        """Householder phase factor as a host scalar in the engine dtype."""
        val = complex(alpha)
        if conj:
            val = np.conj(val)
        if np.dtype(self.dtype).kind != "c":
            val = val.real
        return val

    def _advance_house(self, Av, k):
        """Householder step (reference: krypy/utils.py:970-994)."""
        N = self._N
        for j in range(k + 1):
            house = self.houses[j]
            Av = Av.at[j:].set(house.apply(Av[j:]))
            Av = Av.at[j].multiply(self._alpha_scalar(house.alpha, conj=True))
        if k + 1 < N:
            house = House(Av[k + 1:])
            self.houses.append(house)
            Av = Av.at[k + 1:].set(
                house.apply(Av[k + 1:])
                * self._alpha_scalar(house.alpha, conj=True)
            )
            col = np.asarray(Av[: k + 2, 0])
        else:
            col = np.asarray(Av[: k + 1, 0])
        self._H[: len(col), k] = col
        self._H[k + 1, k] = abs(self._H[k + 1, k])
        if not self._check_invariance(k):
            vnew = jnp.zeros((N, 1), dtype=self.dtype)
            vnew = vnew.at[k + 1].set(1)
            for j in range(k + 1, -1, -1):
                vnew = vnew.at[j:].set(self.houses[j].apply(vnew[j:]))
            self._V.append(vnew * self._alpha_scalar(self.houses[-1].alpha))

    def _advance_gs(self, Av, k):
        """Gram-Schmidt / Lanczos step (reference: krypy/utils.py:995-1045)."""
        start = 0
        if self.ortho == "lanczos":
            start = k
            if k > 0:
                self._H[k - 1, k] = self._H[k, k - 1]
                prev = (
                    self._P[k - 1] if self.M is not None else self._V[k - 1]
                )
                Av = Av - self._H[k, k - 1] * prev

        basis = self._P if self.M is not None else self._V
        for _ in range(self.reorthos + 1):
            if self.ortho in ("cgs", "cgs2"):
                # classical (batched) Gram-Schmidt: one fused block inner
                # product and one block update -- two GEMMs on the device.
                # start == 0 here (lanczos never takes this branch), so
                # the cached stacks serve both reortho passes directly.
                Vk = self.V
                Bk = self.P if self.M is not None else Vk
                coeffs = inner(Vk, Av, ip_B=self.ip_B)
                Av = Av - jnp.dot(Bk, coeffs)
                self._H[start: k + 1, k] += np.asarray(coeffs)[:, 0]
            else:
                for j in range(start, k + 1):
                    alpha = complex(
                        inner(self._V[j], Av, ip_B=self.ip_B)[0, 0]
                    )
                    if self.ortho == "lanczos":
                        if abs(alpha.imag) > 1e-10:
                            warnings.warn(
                                f"Iter {self.iter}: abs(alpha.imag) = "
                                f"{abs(alpha.imag)} > 1e-10. Is your "
                                "operator self-adjoint in the provided "
                                "inner product?"
                            )
                        alpha = alpha.real
                    if np.dtype(self.dtype).kind != "c":
                        alpha = np.real(alpha)
                    self._H[j, k] += alpha
                    Av = Av - alpha * basis[j]

        if self.M is not None:
            MAv = self.M * Av
            hnew = float(norm(Av, MAv, ip_B=self.ip_B))
        else:
            hnew = float(norm(Av, ip_B=self.ip_B))
        self._H[k + 1, k] = hnew

        if not self._check_invariance(k):
            if self.M is not None:
                self._P.append(Av / hnew)
                self._V.append(MAv / hnew)
            else:
                self._V.append(Av / hnew)

    # ------------------------------------------------------------------
    def get(self):
        """Return ``(V, H)`` (plus ``P`` if M was given), truncated to the
        invariant relation if a breakdown occurred."""
        k = self.iter
        if self.invariant:
            V = self.V[:, :k]
            H = self._H[:k, :k]
            P = self.P[:, :k] if self.M is not None else None
        else:
            V = self.V[:, : k + 1]
            H = self._H[: k + 1, :k]
            P = self.P[:, : k + 1] if self.M is not None else None
        return (V, H, P) if self.M is not None else (V, H)

    def get_last(self):
        """Return the newest basis vector and Hessenberg column."""
        k = self.iter
        if self.invariant:
            V, H = None, self._H[:k, [k - 1]]
            P = None
        else:
            V, H = self._V[k], self._H[: k + 1, [k - 1]]
            P = self._P[k] if self.M is not None else None
        return (V, H, P) if self.M is not None else (V, H)


def arnoldi(*args, **kwargs):
    """One-shot Arnoldi: run to maxiter or invariance, return ``get()``."""
    eng = Arnoldi(*args, **kwargs)
    while eng.iter < eng.maxiter and not eng.invariant:
        eng.advance()
    return eng.get()


def arnoldi_res(A, V, H, ip_B=None):
    """Arnoldi residual
    :math:`\\|A V_n - V_{n+1}\\underline{H}_n\\|` (or the invariant variant)
    -- reference: krypy/utils.py:308-329."""
    V = jnp.asarray(V)
    H = jnp.asarray(H)
    N = V.shape[0]
    A = get_linearoperator((N, N), A)
    invariant = H.shape[0] == H.shape[1]
    AV = A * (V if invariant else V[:, :-1])
    res = AV - jnp.dot(V, H)
    return norm(res, ip_B=ip_B)


def arnoldi_projected(H, P, k, ortho="mgs"):
    """Perturbed Arnoldi relation for a projected operator, computed purely
    from existing small-dimensional data (no new N-dim matvecs) --
    reference: krypy/utils.py:1084-1168.

    Given :math:`\\underline{H}_n` and a projection P on coefficient space
    with a k-dimensional null space, computes U, G, F with
    :math:`(\\tilde P A + E_i) W_i = W_{i+1}\\underline{G}_i` where
    :math:`W_i = V_n U_i` and the error term is
    :math:`E_i x = v_{n+1} F_i\\langle W_i, x\\rangle`.
    """
    H = jnp.asarray(H)
    n = H.shape[1]
    dtype = find_common_dtype(H, P)
    invariant = H.shape[0] == n
    hlast = 0 if invariant else complex(H[-1, -1])
    if np.dtype(dtype).kind != "c":
        hlast = np.real(hlast)
    H_sq = get_linearoperator((n, n), H if invariant else H[:-1, :])
    P = get_linearoperator((n, n), P)
    v = P * jnp.eye(n, 1, dtype=dtype)
    maxiter = n - k + 1
    F = np.zeros((1, maxiter), dtype=dtype)

    from .core.operators import LinearOperator

    PH = LinearOperator((n, n), dtype, lambda x: P * (H_sq * x))
    eng = Arnoldi(PH, v, maxiter=maxiter, ortho=ortho)
    while eng.iter < eng.maxiter and not eng.invariant:
        u, _ = eng.get_last()
        val = hlast * complex(u[-1, 0])
        F[0, eng.iter] = val if np.dtype(dtype).kind == "c" else val.real
        eng.advance()
    U, G = eng.get()
    return U, G, F[[0], : eng.iter]
