r"""Non-Hermitian eigensolver: Krylov-Schur with device Arnoldi sweeps.

Computes k eigenpairs of a general square operator ``A`` by the
Krylov-Schur method (Stewart 2002): build an m-dimensional Krylov
decomposition :math:`A V_m = V_m B_m + v_{m+1} b_m^T`, compress it to
the l wanted Schur vectors, and continue.

Split of labor (the lane's standing convention, docs/DESIGN.md
section 7: small dense NON-Hermitian spectral work runs on host
LAPACK by design -- the accelerator backends have no Schur/eig
lowering, and the
(m, m) problem is microscopic):

* the Arnoldi sweeps -- all N-sized work -- run ON DEVICE as one
  compiled dispatch per cycle (the same full-CGS2 sweep the Hermitian
  ``eigsh`` uses; two fused ``(m+1, N) x (N,)`` contractions per step,
  deflation to zero rows on invariance, sharding over a mesh for free);
* the per-cycle ordered Schur decomposition of the (m, m) projection
  runs on the host (``scipy.linalg.schur``), exactly like the compat
  lane's Ritz extraction;
* basis compression V <- Z_l^T V and the final eigenvector assembly
  are device GEMMs; final pairs are verified EXPLICITLY against A
  (never only against projection residuals).

The basis is kept in the COMPLEX system dtype even for real operators:
Krylov-Schur's compressed T is complex triangular (real quasi-Schur
would keep it real at the cost of 2x2 block bookkeeping -- a measured
follow-up, not a correctness need), and non-Hermitian spectra are
complex anyway.

The reference exposes only Ritz extraction from existing solves
(krypy/utils.py:1380-1465) and no standalone eigensolver; this module
is accelerator-native extra surface, oracle-tested against
``scipy.sparse.linalg.eigs``.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    cast_matvec,
    safe_div,
    system_dtype,
)
from .eigh import lanczos_1r_sweep, lanczos_cgs2_sweep

__all__ = ["eigs", "EigsResult"]


class EigsResult(NamedTuple):
    """Result pytree of :func:`eigs`."""

    #: eigenvalue estimates, shape ``(k,)``, complex, sorted by ``which``
    theta: jnp.ndarray
    #: eigenvectors as columns, shape ``(N, k)``, complex, unit norm
    #: (NOT orthogonal in general -- non-normal operators do not have
    #: orthogonal eigenbases; the Schur basis is the orthonormal one)
    U: jnp.ndarray
    #: max wanted-pair residual per restart cycle
    resnorms: np.ndarray
    #: total Arnoldi steps (matvecs)
    niter: int
    #: CONVERGED / MAXITER
    status: int
    #: final EXPLICIT per-pair residuals ``||A u - theta u|| /
    #: max(|theta|, eps)``, shape ``(k,)`` -- computed against A, not
    #: the projection
    pair_resnorms: jnp.ndarray

    @property
    def converged(self):
        return self.status == CONVERGED


def _selection_key(ev, which):
    if which == "lm":
        return -np.abs(ev)
    if which == "sm":
        return np.abs(ev)
    if which == "lr":
        return -ev.real
    if which == "sr":
        return ev.real
    if which == "li":
        return -ev.imag
    if which == "si":
        return ev.imag
    raise ValueError(
        f"unknown which={which!r}: expected one of "
        "'lm', 'sm', 'lr', 'sr', 'li', 'si'"
    )


def eigs(
    A,
    k=6,
    *,
    v0=None,
    n=None,
    which="lm",
    maxdim=None,
    thick=None,
    tol=1e-8,
    max_restarts=100,
    sigma=None,
    inv=None,
    ortho="cgs2",
):
    r"""k eigenpairs of a general (non-Hermitian) operator by
    Krylov-Schur restarted Arnoldi.

    :param A: square operator (matvec / matrix / LinearOperator).
    :param k: number of wanted pairs.
    :param v0: start vector (``(N,)``); defaults to the deterministic
      quasi-random start shared by the other eigensolvers.
    :param n: problem size when ``A`` has no ``.shape`` and no ``v0``.
    :param which: selection -- ``'lm'`` (largest magnitude, default),
      ``'sm'``, ``'lr'``, ``'sr'``, ``'li'``, ``'si'`` (the scipy set).
      ``'sm'`` converges slowly without ``sigma=``/``inv=``.
    :param maxdim: Krylov dimension m per cycle (default
      ``max(2k + 8, 24)``).
    :param thick: Schur vectors kept at each restart (default
      ``min(2k, m - 2)``).
    :param tol: convergence test on the Krylov-decomposition residual
      :math:`|b^T z_i| \le \mathrm{tol} \cdot \max(|\theta_i|,
      \epsilon)` for the k wanted Schur vectors -- the ARPACK-style
      criterion; the returned ``pair_resnorms`` re-verify explicitly
      against A.
    :param max_restarts: restart cycles.
    :param sigma: shift-invert target: eigenvalues NEAREST ``sigma``
      via Arnoldi on :math:`(A - \sigma I)^{-1}` (requires ``inv=``);
      ``which`` is ignored.  Final pairs are back-transformed and
      verified against A itself.
    :param inv: jittable matvec applying :math:`(A - \sigma I)^{-1}`.
    :param ortho: ``"cgs2"`` (default, 3 all-reduces per Arnoldi step)
      or ``"cgs2_1r"`` (lagged DCGS-2,
      :func:`~krypy_tpu.functional.eigh.lanczos_1r_sweep`: ONE
      all-reduce per step; the lag algebra never assumes Hermitian H).
    :return: :class:`EigsResult`.

    Reference: the reference package extracts Ritz/harmonic pairs from
    existing solves (krypy/utils.py:1380-1465) but has no standalone
    non-Hermitian eigensolver; oracle is ``scipy.sparse.linalg.eigs``.
    """
    import scipy.linalg

    _selection_key(np.zeros(1, complex), which)  # validate early

    shift_invert = sigma is not None
    if shift_invert and inv is None:
        raise ValueError(
            "sigma= (shift-invert) requires inv=, a matvec applying "
            "(A - sigma I)^{-1}"
        )
    if inv is not None and not shift_invert:
        raise ValueError("inv= is only meaningful together with sigma=")

    A_mv = as_matvec(A)
    op_mv = as_matvec(inv) if shift_invert else A_mv

    if v0 is not None:
        v0 = jnp.asarray(v0).reshape(-1)
        N = int(v0.shape[0])
        base = system_dtype(v0)
        if hasattr(A, "ndim"):
            base = jnp.promote_types(base, jnp.asarray(A).dtype)
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or v0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        v0 = jnp.cos(jnp.arange(N) * 0.7391) + 0.01
        # no user dtype signal: the OPERATOR's dtype governs when it
        # can be probed (an f32 matrix runs in complex64, not the x64
        # default complex128)
        if hasattr(A, "ndim"):
            base = jnp.asarray(A).dtype
        elif hasattr(A, "dtype"):
            base = jnp.dtype(A.dtype)
        else:
            base = system_dtype(v0)
    if not jnp.issubdtype(base, jnp.floating) and not jnp.issubdtype(
        base, jnp.complexfloating
    ):
        base = jnp.zeros(0).dtype
    dtype = jnp.promote_types(base, jnp.complex64)  # c64 for f32, c128 else
    real_dtype = jnp.zeros(0, dtype).real.dtype

    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    m = min(N, max(2 * k + 8, 24)) if maxdim is None else min(int(maxdim), N)
    if k >= m - 1:
        raise ValueError(f"k={k} needs maxdim > k + 1 (have {m})")
    l = min(2 * k, m - 2) if thick is None else min(int(thick), m - 2)
    l = max(l, k)

    op_c = cast_matvec(op_mv, dtype)
    A_c = cast_matvec(A_mv, dtype)

    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown eigs ortho {ortho!r}")
    _sweep_fn = (
        lanczos_1r_sweep if ortho == "cgs2_1r" else lanczos_cgs2_sweep
    )

    @jax.jit
    def sweep(V, H, j0):
        return _sweep_fn(op_c, V, H, j0, m, dtype, real_dtype)

    @jax.jit
    def compress(V, H, Zl, Tll, brow):
        """Device restart: V[:l] <- Zl^T V[:m], V[l] <- V[m]; H zeroed
        and reloaded with the compressed Krylov decomposition."""
        Vl = jnp.dot(Zl.T, V[:m])
        Vn = jnp.zeros_like(V)
        Vn = Vn.at[:l].set(Vl).at[l].set(V[m])
        Hn = jnp.zeros_like(H)
        Hn = Hn.at[:l, :l].set(Tll).at[l, :l].set(brow)
        return Vn, Hn

    @jax.jit
    def finalize(V, Y, th):
        """Eigenvectors U = (Y^T V[:dim])^T, normalized, with explicit
        residuals against A (shift-invert included: th is ALREADY
        back-transformed)."""
        U = jnp.dot(Y.T, V[: Y.shape[0]])  # (k, N) rows
        nrm = jnp.linalg.norm(U, axis=1)
        U = U * safe_div(1.0, nrm)[:, None]
        AU = jax.vmap(A_c)(U)
        R = AU - th[:, None] * U
        den = jnp.maximum(
            jnp.abs(th).astype(real_dtype),
            jnp.asarray(jnp.finfo(real_dtype).tiny ** 0.5, real_dtype),
        )
        return U, jnp.linalg.norm(R, axis=1) / den

    v0 = v0.astype(dtype)
    beta0 = jnp.linalg.norm(v0)
    V = jnp.zeros((m + 1, N), dtype).at[0].set(
        v0 * safe_div(1.0, beta0)
    )
    H = jnp.zeros((m + 1, m + 1), dtype)

    eps = float(jnp.finfo(real_dtype).eps)
    resnorms = np.full(max_restarts, np.nan)
    j0 = jnp.asarray(0)
    niter = 0
    status = MAXITER
    Tend = Zend = None

    for cycle in range(max_restarts):
        V, H = sweep(V, H, j0)
        niter += m - int(j0)
        Hh = np.asarray(H)
        B = Hh[:m, :m]
        b = Hh[m, :m]

        # dead (deflated) rows mark an invariant subspace: their B
        # columns/rows are zero and their eigenvalues are spurious 0s
        live = np.concatenate(
            [np.ones(int(j0) + 1, bool),
             np.abs(np.diag(Hh, -1)[int(j0):m]) > 0]
        )[:m]

        T, Z = scipy.linalg.schur(B, output="complex")
        ev = np.diag(T)
        dead_mass = (np.abs(Z) ** 2 * ~live[:, None]).sum(axis=0)
        key = _selection_key(ev, "lm" if shift_invert else which)
        key = np.where(dead_mass > 0.5, np.inf, key)

        # reorder the l best to the front (LAPACK trsen via the sort
        # callable: select everything with key <= the l-th smallest)
        cutoff = np.sort(key)[min(l, m) - 1]
        T, Z, sdim = scipy.linalg.schur(
            B,
            output="complex",
            sort=lambda w: bool(
                _selection_key(np.asarray([w]),
                               "lm" if shift_invert else which)[0]
                <= cutoff
            ),
        )
        lsel = int(min(max(sdim, k), m - 1))
        ev = np.diag(T)

        # ARPACK-style subspace residuals of the leading Schur vectors
        bz = np.abs(b @ Z[:, :lsel])
        floors = np.maximum(np.abs(ev[:lsel]), eps)
        res = bz / floors
        worst = float(res[:k].max())
        resnorms[cycle] = worst
        # an invariant subspace (dead rows) zeroes its b entries, so
        # the same test covers lucky breakdown
        if worst <= tol:
            status = CONVERGED
            Tend, Zend = T[:lsel, :lsel], Z[:, :lsel]
            break
        if cycle == max_restarts - 1:
            Tend, Zend = T[:lsel, :lsel], Z[:, :lsel]
            break

        Zl = jnp.asarray(Z[:, :lsel], dtype)
        Tll = jnp.asarray(T[:lsel, :lsel], dtype)
        brow = jnp.asarray(b @ Z[:, :lsel], dtype)
        if lsel != l:
            # pad/trim to the static compression width so the jitted
            # compress/sweep never retraces on sdim jitter
            Zl = jnp.zeros((m, l), dtype).at[:, :min(lsel, l)].set(
                Zl[:, :min(lsel, l)]
            )
            Tp = jnp.zeros((l, l), dtype)
            Tll = Tp.at[:min(lsel, l), :min(lsel, l)].set(
                Tll[:min(lsel, l), :min(lsel, l)]
            )
            brow = jnp.zeros((l,), dtype).at[:min(lsel, l)].set(
                brow[:min(lsel, l)]
            )
        V, H = compress(V, H, Zl, Tll, brow)
        j0 = jnp.asarray(l)

    # final pairs: eigen-decompose the kept triangular block on host,
    # pick the k wanted, assemble + verify on device
    theta_s, Ys = np.linalg.eig(Tend)
    if shift_invert:
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = sigma + 1.0 / theta_s
        order = np.argsort(np.abs(lam - sigma))
    else:
        lam = theta_s
        order = np.argsort(_selection_key(lam, which))
    pick = order[:k]
    lam_k = lam[pick]
    Yk = Zend @ Ys[:, pick]  # back to the V[:m] coordinates

    U, pair_res = finalize(
        V, jnp.asarray(Yk, dtype), jnp.asarray(lam_k, dtype)
    )
    return EigsResult(
        theta=jnp.asarray(lam_k, dtype),
        U=U.T,
        resnorms=resnorms[: cycle + 1],
        niter=niter,
        status=status,
        pair_resnorms=pair_res,
    )
