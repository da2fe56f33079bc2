r"""Interior eigenpairs by Chebyshev-Jackson filtered subspace iteration.

Computes the eigenpairs of a Hermitian :math:`A` whose eigenvalues lie
in a user-given window :math:`[\xi_0, \xi_1]`, WITHOUT any inner linear
solves: a Jackson-damped Chebyshev polynomial approximation of the
window's indicator function is applied to a trial block (pure matvec
chains), followed by panel orthonormalization and Rayleigh-Ritz on A
(block GEMMs).  This is the filtered subspace iteration of
EVSL / ChASE (Li, Saad et al.; Di Napoli, Polizzi, Saad 2016 for the
Jackson-Chebyshev filter) and the deliberate THIRD lane of the
eigensolver surface:

* :func:`~krypy_tpu.functional.eigh.eigsh` ``(sigma=...)`` -- interior
  pairs by shift-invert Lanczos: fastest per iteration *if* a good
  inner solver for :math:`A - \sigma I` exists (each Lanczos step is a
  full Krylov solve);
* :func:`~krypy_tpu.functional.lobpcg.lobpcg` -- EXTREMAL pairs, one A
  application per pair per iteration, rate from the preconditioner;
* :func:`eigsh_window` (this module) -- INTERIOR pairs with nothing but
  ``degree`` applications of A per pair per iteration: the only option
  when :math:`A - \sigma I` is indefinite and hard to precondition,
  and the natural accelerator shape -- the filter is a ``lax.fori_loop`` of
  fused block matvecs (three-term recurrence), everything else is
  ``(p, N)`` panel GEMMs, the whole solve one ``lax.while_loop``.

The polynomial degree is the communication-avoidance knob: one outer
iteration performs ``degree`` matvecs with ZERO reductions -- all inner
products (SVQB Gram, Rayleigh-Ritz Gram, residual norms) happen once
per OUTER iteration, so on a sharded mesh the all-reduce count per
matvec is ~``3/degree`` instead of the 2-4 of Lanczos-type methods.

The reference exposes no eigensolver at all (only Ritz extraction from
existing solves, krypy/utils.py:1380-1465); this module is accelerator-native
extra surface with the same status-code contract as the linear solvers.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    safe_div,
    system_dtype,
)
from .eigh import lanczos_cgs2_sweep, spurious_ritz_mask

__all__ = [
    "eigsh_window",
    "estimate_spectrum_bounds",
    "WindowResult",
    "jackson_cheby_coeffs",
    "window_count",
    "kpm_dos",
]


class WindowResult(NamedTuple):
    """Result pytree of :func:`eigsh_window`.

    The block holds ``p`` Ritz pairs; the pairs INSIDE the window come
    first (ascending), then the rest (leaked / spurious directions,
    also ascending).  Only the ``n_inside`` leading pairs are
    deliverables; the tail is reported for diagnostics.
    """

    #: Ritz values, shape ``(p,)``, inside-window pairs first
    theta: jnp.ndarray
    #: Ritz vectors as columns, shape ``(N, p)`` (deflation-basis
    #: convention, like :class:`EigshResult.U`)
    U: jnp.ndarray
    #: boolean mask, shape ``(p,)``: pair lies inside the window (and
    #: is not a deflated-junk direction)
    inside: jnp.ndarray
    #: number of window eigenpairs found (== ``inside.sum()``)
    n_inside: jnp.ndarray
    #: worst inside-window relative residual per outer iteration
    resnorms: jnp.ndarray
    #: outer (filter + Rayleigh-Ritz) iterations performed
    niter: jnp.ndarray
    #: CONVERGED / MAXITER.  An EMPTY window (no spectrum inside)
    #: reports MAXITER with ``n_inside == 0`` -- the solver cannot
    #: distinguish "nothing there" from "not converged yet".
    status: jnp.ndarray
    #: final per-pair relative residuals, shape ``(p,)``
    pair_resnorms: jnp.ndarray
    #: True when EVERY live pair of the block sits inside the window at
    #: exit: the window likely contains MORE eigenpairs than the block
    #: width -- enlarge ``block`` (the count, not the accuracy, is in
    #: doubt)
    saturated: jnp.ndarray
    #: spectrum bounds ``(lmin, lmax)`` the filter was built on
    bounds: tuple = None
    #: Chebyshev degree used (matvecs per pair per outer iteration)
    degree: int = None

    @property
    def converged(self):
        return self.status == CONVERGED


def jackson_cheby_coeffs(lo, hi, lmin, lmax, degree):
    r"""Host-side coefficients of the Jackson-damped degree-``degree``
    Chebyshev expansion of the indicator function of ``[lo, hi]`` on a
    spectrum contained in ``[lmin, lmax]``.

    Returns ``(coeffs, center, half_width)`` with ``coeffs[j]`` the
    weight of :math:`T_j(l(t))` under the affine map
    :math:`l(t) = (t - c)/e` taking ``[lmin, lmax]`` to ``[-1, 1]``.
    The Jackson damping factors (Di Napoli, Polizzi & Saad 2016, eq. 15)
    make the truncated series non-negative up to :math:`O(10^{-3})`
    ringing -- without them the Gibbs oscillations of the raw expansion
    change sign, and repeated application of the filter AMPLIFIES
    out-of-window directions with negative response.
    """
    lo, hi = float(lo), float(hi)
    lmin, lmax = float(lmin), float(lmax)
    if not lo < hi:
        raise ValueError(f"window=({lo}, {hi}): need lo < hi")
    if not lmin < lmax:
        raise ValueError(f"bounds=({lmin}, {lmax}): need lmin < lmax")
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    a = (lo - c) / e
    b = (hi - c) / e
    if b <= -1.0 or a >= 1.0:
        raise ValueError(
            f"window=({lo}, {hi}) lies entirely outside the spectrum "
            f"bounds ({lmin}, {lmax}); nothing to filter for"
        )
    a = max(a, -1.0)
    b = min(b, 1.0)
    d = int(degree)
    if d < 2:
        raise ValueError(f"degree must be >= 2, got {degree}")
    j = np.arange(d + 1)
    # raw Chebyshev moments of the indicator: arccos is DECREASING, so
    # t in [a, b] maps to phi in [arccos(b), arccos(a)]
    pa, pb = np.arccos(a), np.arccos(b)
    mu = np.empty(d + 1)
    mu[0] = (pa - pb) / np.pi
    jj = j[1:]
    mu[1:] = 2.0 / (np.pi * jj) * (np.sin(jj * pa) - np.sin(jj * pb))
    # Jackson damping factors g_j^d
    alpha = np.pi / (d + 2)
    g = (
        (d + 2 - j) * np.sin(alpha) * np.cos(j * alpha)
        + np.cos(alpha) * np.sin(j * alpha)
    ) / ((d + 2) * np.sin(alpha))
    return mu * g, c, e


def _default_block_start(N, p, dtype):
    """Deterministic quasi-random (N, p)->rows (p, N) start block (no
    RNG inside traced code; same family as lobpcg/eigsh defaults)."""
    idx = jnp.arange(N)
    X = jnp.stack(
        [
            jnp.cos(idx * (0.7391 + 0.1137 * i)) + 0.01 * (i + 1)
            for i in range(p)
        ]
    )
    return X.astype(dtype)


def _operator_dtype(A):
    """Probe a matrix/LinearOperator dtype (None for bare callables)."""
    if hasattr(A, "ndim"):
        return jnp.asarray(A).dtype
    if hasattr(A, "dtype"):
        return jnp.dtype(A.dtype)
    return None


def _resolve_n(A, n, what="A"):
    if n is not None:
        return int(n)
    shape = getattr(A, "shape", None)
    if shape is None:
        raise ValueError(f"n= or X0= required when {what} has no .shape")
    return int(shape[0])


def estimate_spectrum_bounds(A, *, n=None, v0=None, m=24, safety=0.01):
    r"""Estimated spectrum bounds ``(lmin, lmax)`` of a Hermitian
    operator, as Python floats, by an ``m``-step Lanczos sweep.

    Each extremal Ritz value is pushed outward by its residual norm
    (for a Ritz pair :math:`(\theta, y)` some eigenvalue lies within
    :math:`\|Ay - \theta y\|` of :math:`\theta` -- the standard
    EVSL/ChASE bound recipe), then the interval is widened by
    ``safety`` relatively on each side: :func:`eigsh_window`'s
    Chebyshev filter grows like :math:`e^{d\sqrt{2\delta}}` for
    eigenvalues a relative distance :math:`\delta` OUTSIDE the mapped
    interval, so an underestimated ``lmax`` is the one genuinely
    dangerous failure mode and margin is cheap (it only widens the
    mapped interval slightly).

    One compiled dispatch; ``m`` matvecs.
    """
    A_mv = as_matvec(A)
    if v0 is not None:
        v0 = jnp.asarray(v0).reshape(-1)
        N = int(v0.shape[0])
    else:
        N = _resolve_n(A, n)
        v0 = jnp.cos(jnp.arange(N) * 0.7391) + 0.01
        op_dt = _operator_dtype(A)
        if op_dt is not None and jnp.issubdtype(op_dt, jnp.complexfloating):
            v0 = v0.astype(op_dt)
    dtype = system_dtype(v0)
    if not jnp.issubdtype(dtype, jnp.floating) and not jnp.issubdtype(
        dtype, jnp.complexfloating
    ):
        dtype = jnp.zeros(0).dtype
    real_dtype = jnp.zeros(0, dtype).real.dtype
    m = min(int(m), N)
    A_c = cast_matvec(A_mv, dtype)

    def _sweep(v):
        V = jnp.zeros((m + 1, N), dtype).at[0].set(
            v.astype(dtype) * safe_div(1.0, jnp.linalg.norm(v))
        )
        H = jnp.zeros((m + 1, m + 1), dtype)
        V, H = lanczos_cgs2_sweep(A_c, V, H, 0, m, dtype, real_dtype)
        Hm = 0.5 * (H[:m, :m] + H[:m, :m].conj().T)
        theta, S = jnp.linalg.eigh(Hm)
        # residual of each Ritz pair: beta_m |e_m^T s_i| (border of the
        # Lanczos relation); a deflated sweep has beta_m = 0 -> exact
        res = jnp.abs(H[m, m - 1]) * jnp.abs(S[m - 1, :])
        spur = spurious_ritz_mask(V[:m], S)
        big = jnp.asarray(jnp.finfo(real_dtype).max, real_dtype)
        lmin = jnp.min(jnp.where(spur, big, theta - res))
        lmax = jnp.max(jnp.where(spur, -big, theta + res))
        return lmin.astype(real_dtype), lmax.astype(real_dtype)

    lmin, lmax = jax.jit(_sweep)(v0)
    lmin, lmax = float(lmin), float(lmax)
    pad = float(safety) * max(lmax - lmin, abs(lmax), abs(lmin), 1e-30)
    return lmin - pad, lmax + pad


def _cheby_moments(A, degree, bounds, Z):
    r"""Per-probe Chebyshev moments :math:`\mu_j = z^H T_j(l(A)) z`
    for the rows of ``Z``, shape ``(degree+1, n_probes)``: one batched
    three-term recurrence, ``degree`` block matvecs, one dispatch."""
    lmin, lmax = float(bounds[0]), float(bounds[1])
    c = 0.5 * (lmax + lmin)
    inv_e = 2.0 / (lmax - lmin)
    dtype = Z.dtype
    real_dtype = jnp.zeros(0, dtype).real.dtype
    A_blk = jax.vmap(cast_matvec(as_matvec(A), dtype))

    def lA(Y):
        return (A_blk(Y) - c * Y) * inv_e

    def qf(Y):
        return jnp.real(jnp.sum(Z.conj() * Y, axis=1)).astype(real_dtype)

    d = int(degree)
    T1 = lA(Z)
    mu = jnp.zeros((d + 1, Z.shape[0]), real_dtype)
    mu = mu.at[0].set(qf(Z)).at[1].set(qf(T1))

    def step(j, carry):
        T0, T1, mu = carry
        T2 = 2.0 * lA(T1) - T0
        return T1, T2, mu.at[j].set(qf(T2))

    _, _, mu = lax.fori_loop(2, d + 1, step, (Z, T1, mu))
    return mu


def _rademacher_rows(A, key, n_probes, N, dtype=None):
    """Real Rademacher probe rows in the operator's (real) dtype, or
    in ``dtype`` when given (callable operators cannot be probed and
    would otherwise default to float64 under x64 -- pass
    ``dtype=jnp.float32`` for float32 work)."""
    dt = _operator_dtype(A) if dtype is None else jnp.dtype(dtype)
    if dt is None:
        dt = jnp.zeros(0).dtype
    real_dt = jnp.zeros(0, dt).real.dtype
    Z = jax.random.rademacher(key, (int(n_probes), N))
    return Z.astype(real_dt)


def window_count(
    A, window, key, *, n=None, bounds=None, degree=None, n_probes=16,
    dtype=None,
):
    r"""Stochastic estimate of the NUMBER of eigenvalues of Hermitian
    ``A`` inside ``window = (lo, hi)`` (Hutchinson trace of the
    Jackson-Chebyshev window filter; Di Napoli, Polizzi & Saad 2016).

    :math:`E[z^H \rho(A) z] = \mathrm{tr}\,\rho(A) \approx
    \#\{\lambda_i \in [lo, hi]\}` for Rademacher probes z and the same
    filter :func:`eigsh_window` iterates with.  The intended use IS
    :func:`eigsh_window` sizing: estimate the count, then pick
    ``block >~ 1.3 * count + 4`` so the window cannot saturate.  Costs
    ``degree`` batched matvecs in ONE dispatch -- cheaper than one
    outer iteration of the solver it plans for.

    Accuracy: eigenvalues within one filter transition width
    (~``pi * span/degree``) of the window edges are counted
    fractionally (the indicator is smoothed); the Hutchinson standard
    error over probes is returned, so both error sources are visible.

    :param key: ``jax.random`` PRNGKey for the Rademacher probes
      (explicit, reproducible -- the :func:`slq_trace` convention).
    :param bounds: spectrum bounds; estimated when omitted.
    :param degree: filter degree; same default policy as
      :func:`eigsh_window`.
    :param dtype: probe dtype; defaults to the operator's when it can
      be probed, else the x64-default float -- pass ``jnp.float32``
      explicitly for callable operators.
    :return: ``(count, stderr)`` Python floats.
    """
    lo, hi = float(window[0]), float(window[1])
    A_mv = as_matvec(A)
    N = _resolve_n(A, n)
    if bounds is None:
        bounds = estimate_spectrum_bounds(A, n=N)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    span = lmax - lmin
    width = min(hi, lmax) - max(lo, lmin)
    if width <= 0:
        raise ValueError(
            f"window=({lo}, {hi}) lies entirely outside the spectrum "
            f"bounds ({lmin}, {lmax})"
        )
    if degree is None:
        degree = int(np.clip(np.ceil(4.0 * span / width), 16, 1000))
    coeffs, _, _ = jackson_cheby_coeffs(lo, hi, lmin, lmax, degree)
    Z = _rademacher_rows(A, key, n_probes, N, dtype)
    mu = jax.jit(
        lambda Z: jnp.dot(
            jnp.asarray(coeffs, Z.dtype),
            _cheby_moments(A_mv, degree, (lmin, lmax), Z),
        )
    )(Z)
    per_probe = np.asarray(mu, float)
    count = float(per_probe.mean())
    stderr = (
        float(per_probe.std(ddof=1) / np.sqrt(len(per_probe)))
        if len(per_probe) > 1
        else float("inf")
    )
    return count, stderr


def kpm_dos(
    A,
    key,
    *,
    n=None,
    bounds=None,
    degree=180,
    n_probes=16,
    npoints=200,
    dtype=None,
):
    r"""Kernel polynomial method estimate of the spectral density
    (density of states) of Hermitian ``A``:

    .. math:: \rho(\lambda) \approx \frac{1}{e\pi\sqrt{1-x^2}}
        \Big(g_0\mu_0 + 2\sum_{j\ge 1} g_j \mu_j T_j(x)\Big),
        \quad x = l(\lambda),

    with Jackson-damped Hutchinson moments
    :math:`\mu_j \approx \mathrm{tr}\,T_j(l(A))` (Weisse, Wellein,
    Alvermann & Fehske 2006).  Normalized so that
    :math:`\int \rho\,d\lambda = N`: the curve is an eigenvalue-count
    density, the survey instrument for slicing a spectrum into
    :func:`eigsh_window` windows.

    Device cost: ``degree`` batched ``(n_probes, N)`` matvecs in ONE
    dispatch; the curve evaluation is host-side numpy.

    :param degree: moment count = resolution: features narrower than
      ~``span/degree`` are smeared by the Jackson kernel.
    :param dtype: probe dtype (see :func:`window_count`).
    :return: ``(grid, density)`` numpy arrays of length ``npoints``.
    """
    A_mv = as_matvec(A)
    N = _resolve_n(A, n)
    if bounds is None:
        bounds = estimate_spectrum_bounds(A, n=N)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    d = int(degree)
    Z = _rademacher_rows(A, key, n_probes, N, dtype)
    mu = jax.jit(
        lambda Z: jnp.mean(
            _cheby_moments(A_mv, d, (lmin, lmax), Z), axis=1
        )
    )(Z)
    mu = np.asarray(mu, float)

    j = np.arange(d + 1)
    alpha = np.pi / (d + 2)
    g = (
        (d + 2 - j) * np.sin(alpha) * np.cos(j * alpha)
        + np.cos(alpha) * np.sin(j * alpha)
    ) / ((d + 2) * np.sin(alpha))
    gmu = g * mu
    # open Chebyshev grid (never touches x = +-1 where the weight
    # 1/sqrt(1-x^2) is singular)
    x = np.cos(np.pi * (np.arange(npoints) + 0.5) / npoints)[::-1]
    # series evaluation by recurrence on the grid
    T0, T1 = np.ones_like(x), x
    y = gmu[0] * T0 + 2.0 * gmu[1] * T1
    for jj in range(2, d + 1):
        T0, T1 = T1, 2 * x * T1 - T0
        y += 2.0 * gmu[jj] * T1
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    grid = c + e * x
    density = y / (np.pi * np.sqrt(1.0 - x**2)) / e
    return grid, density


def eigsh_window(
    A,
    window,
    *,
    block=None,
    k=None,
    X0=None,
    n=None,
    degree=None,
    bounds=None,
    maxiter=100,
    tol=1e-8,
    criterion="backward",
):
    r"""Eigenpairs of Hermitian ``A`` inside ``window = (lo, hi)`` by
    Chebyshev-Jackson filtered subspace iteration -- interior
    eigenpairs with NO inner solves and NO factorization.

    Each outer iteration applies the degree-``degree`` polynomial
    filter to the ``p``-wide block (``degree`` fused block matvecs in
    one ``fori_loop``), orthonormalizes by two-pass SVQB and performs
    Rayleigh-Ritz ON A; pairs whose Ritz value falls inside the window
    converge at rate ``rho(outside)/rho(window edge)`` per iteration.
    Directions outside the window decay under the filter; exhausted
    directions deflate to ZERO rows (never normalized into garbage) and
    their junk Ritz values are masked out of the window count.

    :param A: Hermitian operator (matvec / matrix / LinearOperator).
    :param window: ``(lo, hi)`` -- the OPEN spectral interval wanted,
      as Python floats (they parameterize the compiled filter).
    :param block: trial-block width ``p``; must exceed the number of
      eigenvalues in the window (check ``result.saturated``).  Default
      ``k + max(4, k//2)`` when ``k`` is given.
    :param k: expected number of window eigenpairs -- ONLY sets the
      default block width; the deliverable count is ``result.n_inside``.
    :param X0: starting block, shape ``(N, p)`` columns; overrides
      ``block``/``k``.
    :param n: problem size when ``A`` has no ``.shape`` and no ``X0``.
    :param degree: Chebyshev filter degree (matvecs per pair per outer
      iteration).  Default resolves the window against the estimated
      spectrum span: ``clip(4 * span/width, 16, 1000)`` -- the Jackson
      kernel's transition width is ~``pi * span/degree``, so this puts
      roughly one transition width inside each window edge.  The knob
      trades outer iterations (reductions) for matvecs.
    :param bounds: spectrum bounds ``(lmin, lmax)``; estimated by
      :func:`estimate_spectrum_bounds` when omitted.  Eigenvalues
      OUTSIDE the bounds are amplified exponentially by the filter --
      when supplying bounds manually, make them OUTER bounds.
    :param maxiter: outer iterations.  Pairs at the window EDGES
      converge at the ratio of adjacent filter responses, which
      approaches 1 when eigenvalues hug the window boundary -- the
      block's surplus directions mitigate this by locking onto (and
      effectively deflating) the nearest outside eigenvalues, and a
      higher ``degree`` sharpens the edge; budget iterations
      accordingly or widen the window into a spectral gap.
    :param tol: per-pair residual tolerance (see ``criterion``).
    :param criterion: ``'backward'`` (default) tests
      :math:`\|Au - \theta u\| \le \mathrm{tol}\cdot\|A\|` with
      :math:`\|A\| \approx \max(|l_{min}|, |l_{max}|)` -- the right
      metric for interior pairs whose :math:`|\theta|` may be tiny;
      ``'rel'`` tests :math:`\|Au - \theta u\| \le \mathrm{tol}\cdot
      |\theta|` (matching ``eigsh``/``lobpcg``), which is unattainable
      for windows near zero.
    :return: :class:`WindowResult`.

    Reference: the reference package has no eigensolver (only
    krypy/utils.py:1380-1465 Ritz extraction); the algorithm follows
    EVSL's ChebLanTr filtering / ChASE subspace iteration as published.
    """
    if criterion not in ("rel", "backward"):
        raise ValueError(
            f"criterion={criterion!r}: expected 'rel' or 'backward'"
        )
    lo, hi = (float(window[0]), float(window[1]))
    if not lo < hi:
        raise ValueError(f"window={window!r}: need lo < hi")

    A_mv = as_matvec(A)

    if X0 is not None:
        X0 = jnp.asarray(X0)
        if X0.ndim != 2:
            raise ValueError(f"X0 must be (N, p), got shape {X0.shape}")
        N = int(X0.shape[0])
        p = int(X0.shape[1])
    else:
        N = _resolve_n(A, n)
        if block is not None:
            p = int(block)
        elif k is not None:
            p = int(k) + max(4, int(k) // 2)
        else:
            raise ValueError("one of block=, k= or X0= is required")
    if p < 1:
        raise ValueError(f"block must be >= 1, got {p}")
    if p > N:
        raise ValueError(f"block={p} exceeds the problem size N={N}")

    if X0 is None:
        X = _default_block_start(N, p, None)
        op_dt = _operator_dtype(A)
        if op_dt is not None and jnp.issubdtype(op_dt, jnp.complexfloating):
            X = X.astype(op_dt)
    else:
        X = X0.T

    dtype = system_dtype(X)
    if not jnp.issubdtype(dtype, jnp.floating) and not jnp.issubdtype(
        dtype, jnp.complexfloating
    ):
        dtype = jnp.zeros(0).dtype
    real_dtype = jnp.zeros(0, dtype).real.dtype
    X = X.astype(dtype)

    if bounds is None:
        bounds = estimate_spectrum_bounds(A, n=N)
    lmin, lmax = float(bounds[0]), float(bounds[1])

    span = lmax - lmin
    width = min(hi, lmax) - max(lo, lmin)
    if width <= 0:
        raise ValueError(
            f"window=({lo}, {hi}) lies entirely outside the spectrum "
            f"bounds ({lmin}, {lmax}); nothing to filter for"
        )
    if degree is None:
        degree = int(np.clip(np.ceil(4.0 * span / width), 16, 1000))
    degree = int(degree)

    coeffs_np, c, e = jackson_cheby_coeffs(lo, hi, lmin, lmax, degree)
    coeffs = jnp.asarray(coeffs_np, real_dtype)
    inv_e = 1.0 / e

    A_c = cast_matvec(A_mv, dtype)
    A_blk = jax.vmap(A_c)

    def lA(Z):
        """Rows through the affine map l(A) = (A - c I)/e."""
        return (A_blk(Z) - c * Z) * inv_e

    def cheb_filter(Z):
        """rho(A) Z by the three-term recurrence, ``degree`` block
        matvecs in one fori_loop, zero reductions."""
        T0 = Z
        T1 = lA(Z)
        Y = coeffs[0] * T0 + coeffs[1] * T1

        def step(j, carry):
            T0, T1, Y = carry
            T2 = 2.0 * lA(T1) - T0
            return T1, T2, Y + coeffs[j] * T2

        _, _, Y = lax.fori_loop(2, degree + 1, step, (T0, T1, Y))
        return Y

    eps = float(jnp.finfo(real_dtype).eps)
    brk = breakdown_threshold(dtype)

    def svqb2(Z):
        """Two-pass SVQB of the rows of Z (Euclidean; the B=I special
        case of lobpcg's panel factorization -- same dead-row rule,
        same S^T row-transform convention, see lobpcg.py for why S^T
        and not S^H with the row-Gram convention)."""
        for _ in range(2):
            d = jnp.real(jnp.sum(Z.conj() * Z, axis=1))
            alive = (d > (64.0 * eps) * jnp.sum(d) / p).astype(real_dtype)
            Z = Z * alive[:, None]
            G = jnp.dot(Z.conj(), Z.T)
            G = 0.5 * (G + G.conj().T)
            dd = jnp.maximum(jnp.real(jnp.diag(G)), 0.0)
            scale = safe_div(1.0, jnp.sqrt(dd))
            Gh = G * (scale[:, None] * scale[None, :]).astype(dtype)
            lam, S = jnp.linalg.eigh(Gh)
            keep = lam > (p * eps) * jnp.maximum(lam[-1], 0.0)
            inv = jnp.where(
                keep, safe_div(1.0, jnp.sqrt(jnp.maximum(lam, 0.0))), 0.0
            )
            T = (
                inv[:, None].astype(dtype)
                * S.T
                * scale[None, :].astype(dtype)
            )
            Z = jnp.dot(T, Z)
        return Z

    if criterion == "backward":
        anorm = max(abs(lmin), abs(lmax))
    eps_floor = jnp.asarray(jnp.finfo(real_dtype).tiny ** 0.5, real_dtype)

    def rr_and_residuals(Q):
        """Rayleigh-Ritz on A over the orthonormal rows of Q, then
        per-pair residuals and the window membership mask."""
        AQ = A_blk(Q)
        G = jnp.dot(Q.conj(), AQ.T)
        G = 0.5 * (G + G.conj().T)
        theta, C = jnp.linalg.eigh(G)
        spur = spurious_ritz_mask(Q, C)
        Xn = jnp.dot(C.T, Q)
        AXn = jnp.dot(C.T, AQ)
        theta = theta.astype(real_dtype)
        R = AXn - theta[:, None].astype(dtype) * Xn
        num = jnp.linalg.norm(R, axis=1)
        if criterion == "backward":
            den = jnp.full((p,), anorm, real_dtype)
        else:
            den = jnp.abs(theta)
        res = num / jnp.maximum(den, eps_floor)
        inside = (~spur) & (theta >= lo) & (theta <= hi)
        return Xn, AXn, theta, res, inside

    hist0 = jnp.full(maxiter + 1, jnp.nan, real_dtype)

    def body(state):
        X, _, _, _, _, it, hist, _, ok_prev, n_prev = state
        Y = cheb_filter(X)
        # rows that overflowed deflate to zero instead of poisoning the
        # Gram with NaN -- the failure mode of user-supplied bounds that
        # do not contain the spectrum (T_d grows as e^{d sqrt(2 delta)}
        # outside the mapped interval); the result then honestly
        # reports missing pairs rather than an all-NaN block
        row_ok = jnp.all(jnp.isfinite(Y), axis=1, keepdims=True)
        Y = jnp.where(row_ok, Y, jnp.zeros((), dtype))
        Q = svqb2(Y)
        Xn, AXn, theta, res, inside = rr_and_residuals(Q)
        worst = jnp.max(
            jnp.where(inside, res, jnp.zeros((), real_dtype))
        )
        n_in = jnp.sum(inside)
        hist = hist.at[it].set(worst)
        ok = (n_in > 0) & (worst <= tol)
        # pairs ENTER the window as they converge: a single passing
        # snapshot can freeze an undercounted n_inside, so demand two
        # consecutive passing iterations with a STABLE inside count
        conv = ok & ok_prev & (n_in == n_prev)
        return (
            Xn, AXn, theta, res, inside, it + 1, hist, conv, ok, n_in,
        )

    def cond(state):
        _, _, _, _, _, it, _, conv, _, _ = state
        return (~conv) & (it < maxiter)

    theta0 = jnp.zeros(p, real_dtype)
    res0 = jnp.full(p, jnp.inf, real_dtype)
    inside0 = jnp.zeros(p, bool)
    init = (
        X, jnp.zeros_like(X), theta0, res0, inside0,
        jnp.asarray(0), hist0, jnp.asarray(False),
        jnp.asarray(False), jnp.asarray(-1),
    )
    X, AX, theta, res, inside, it, hist, conv, _, _ = lax.while_loop(
        cond, body, init
    )

    # order: inside pairs first (ascending), leaked/junk tail after
    big = float(jnp.finfo(real_dtype).max) / 4
    order = jnp.argsort(theta + big * (~inside).astype(real_dtype))
    theta = theta[order]
    X = X[order]
    res = res[order]
    inside = inside[order]
    n_inside = jnp.sum(inside)
    live = jnp.sum(jnp.abs(X) ** 2, axis=1) > 0
    status = jnp.where(conv, CONVERGED, MAXITER)
    return WindowResult(
        theta=theta,
        U=X.T,
        inside=inside,
        n_inside=n_inside,
        resnorms=hist,
        niter=it,
        status=status,
        pair_resnorms=res,
        saturated=jnp.sum(live) == n_inside,
        bounds=(lmin, lmax),
        degree=degree,
    )
