r"""Krylov approximation of matrix-function actions f(A) b.

For Hermitian :math:`A` and an analytic :math:`f`, the Lanczos
approximation is :math:`f(A) b \approx \beta\, V_m^T f(T_m) e_1` with
:math:`T_m = V_m A V_m^T` -- exact once the Krylov space captures the
spectrum seen by ``b``, and exponentially convergent in m for entire
functions like exp (matrix exponentials are the workhorse of
exponential time integrators; scipy's analog is
``scipy.sparse.linalg.expm_multiply``).

accelerator-native design: the basis build is the same full-CGS2 Lanczos sweep
as :func:`~krypy_tpu.functional.eigh.eigsh` (two fused contractions
per step), :math:`f(T_m)` is evaluated on device via ``jnp.linalg.eigh``
of the small replicated projection, and the whole computation -- sweep,
eigendecomposition, assembly, and the standard a-posteriori error
estimate -- jits into one dispatch.  The reference has no matrix-function
surface (krypy is linear-systems only).
"""

from typing import NamedTuple

import jax.numpy as jnp

from .common import (
    as_matvec,
    cast_matvec,
    safe_div,
    system_dtype,
)
from .eigh import lanczos_1r_sweep, lanczos_cgs2_sweep, spurious_ritz_mask

__all__ = ["funm_krylov", "funm_krylov_arnoldi", "expm_multiply",
           "inv_sqrt_multiply", "slq_trace", "slq_logdet"]


class FunmResult(NamedTuple):
    """Result of :func:`funm_krylov`."""

    #: the approximation to f(A) b, shape like b
    x: jnp.ndarray
    #: sequence of correction magnitudes ||x_m - x_{m-1}|| per step used
    #: as the a-posteriori error estimate (NaN below the start index)
    corrections: jnp.ndarray
    #: Krylov dimension used
    m: int


def funm_krylov(A, b, f, *, maxdim=30, ortho="cgs2"):
    r"""Approximate ``f(A) b`` for Hermitian ``A`` by the Lanczos method.

    :param A: Hermitian operator (matvec / matrix / LinearOperator).
    :param b: vector ``(N,)``.
    :param f: scalar function applied to eigenvalues, as a jittable
      callable on arrays (e.g. ``jnp.exp``, ``jnp.sqrt``,
      ``lambda w: 1/jnp.sqrt(w)``).  Must be well-defined on the
      spectrum sampled by the Krylov space.
    :param maxdim: Krylov dimension m.  The returned ``corrections``
      array holds the distances :math:`\|x_m - x_j\|` of the final
      approximation to the NESTED lower-dimensional approximations for
      the last few j (``max(2, m-4) <= j < m``; other entries NaN),
      computed from the same basis -- an a-posteriori error signal:
      when the tail has decayed to rounding, the Krylov approximation
      has converged; otherwise re-run with a larger m (static shapes: m
      is a compile-time constant, as everywhere in this framework).
    :param ortho: ``"cgs2"`` (3 all-reduces per Lanczos step) or
      ``"cgs2_1r"`` (one fused all-reduce per step, lagged DCGS-2).
    :return: :class:`FunmResult`.
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = min(int(maxdim), N)

    A_mv = as_matvec(A)
    dtype = system_dtype(bv)
    bv = bv.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype

    beta = jnp.linalg.norm(bv)
    V = jnp.zeros((m + 1, N), dtype).at[0].set(bv * safe_div(1.0, beta))
    H = jnp.zeros((m + 1, m + 1), dtype)

    # shared full-CGS2 Lanczos sweep (eigh.py): batched
    # contractions, with the invariance guard -- normalizing a
    # round-off-sized residual would inject a garbage direction whose
    # Rayleigh quotient is unbounded (catastrophic under f=exp); it
    # deflates to a zero row instead.  ortho="cgs2_1r" swaps in the
    # one-all-reduce-per-step lagged sweep (eigh.lanczos_1r_sweep).
    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown funm_krylov ortho {ortho!r}")
    _sweep = lanczos_1r_sweep if ortho == "cgs2_1r" else lanczos_cgs2_sweep
    V, H = _sweep(A_mv, V, H, 0, m, dtype, real_dtype)

    def fT_e1(Hj, Vj):
        """beta * f(T_j) e1 over the leading block (size from the
        operand shapes).  Dead-block
        eigenpairs (exact zeros from deflation) are masked OUT before f
        touches them: for f singular at 0 (1/sqrt, log) the IEEE product
        f(0) * 0-coefficient would be inf * 0 = NaN, not 0."""
        Tj = 0.5 * (Hj + Hj.conj().T)
        tj, Sj = jnp.linalg.eigh(Tj)
        spurious = spurious_ritz_mask(Vj, Sj)
        coeff = jnp.where(
            spurious,
            jnp.zeros((), dtype),
            f(tj).astype(dtype) * Sj[0].conj(),
        )
        return jnp.dot(Sj, coeff) * beta.astype(dtype)

    fe1 = fT_e1(H[:m, :m], V[:m])
    x = jnp.dot(fe1, V[:m])

    # nested-approximation distances ||x_m - x_j|| for a handful of
    # tail sizes (per-j eigh on the small replicated blocks; a Python
    # loop over ~5 sizes keeps the compiled graph small)
    corrections = jnp.full(m + 1, jnp.nan, real_dtype)
    for j in range(max(2, m - 4), m):
        fj = fT_e1(H[:j, :j], V[:j])
        # ||x_m - x_j|| via the coefficient difference (V orthonormal)
        diff = fe1 - jnp.concatenate(
            [fj, jnp.zeros(m - j, dtype)]
        )
        corrections = corrections.at[j].set(jnp.linalg.norm(diff))

    return FunmResult(
        x=x if flat else x[:, None],
        corrections=corrections,
        m=m,
    )


def funm_krylov_arnoldi(A, b, f=None, *, maxdim=30, matfunc=None,
                        ortho="cgs2"):
    r"""Approximate ``f(A) b`` for a GENERAL (non-Hermitian) operator by
    the Arnoldi method: :math:`f(A) b \approx \beta V_m f(H_m) e_1`.

    Split of labor (the lane's standing convention, docs/DESIGN.md
    section 7, shared with :func:`~krypy_tpu.functional.eigs.eigs`):
    the m-step Arnoldi sweep -- all N-sized work, the same batched
    full-CGS2 contraction kernel every eigensolver uses, sharded over a
    mesh for free -- runs ON DEVICE in one compiled dispatch; the
    evaluation of ``f`` on the tiny (m, m) Hessenberg runs on the HOST
    via Schur-Parlett (``scipy.linalg.funm``) -- DIAGONALIZATION of a
    non-normal H is unstable (the eigenvector basis can be arbitrarily
    ill-conditioned), and the device has no Schur lowering; the final assembly
    ``V_m^T (beta f(H) e_1)`` is a device GEMV.

    Early invariance is handled EXACTLY: the sweep deflates a
    round-off-sized residual to a zero row, and the evaluation
    truncates to the live leading block -- if the Krylov space closes
    at dimension j, the result is f on that invariant subspace, and
    ``f`` is never evaluated on the dead zero block (which would NaN
    for f singular at 0).

    :param A: square operator (matvec / matrix / LinearOperator).
    :param b: vector ``(N,)``.
    :param f: scalar function, vectorized over a numpy array of
      (possibly complex) eigenvalues -- evaluated on the host, so any
      numpy-compatible callable works (``jnp.exp`` included).
    :param matfunc: alternative MATRIX function ``T -> f(T)`` on the
      small host block (e.g. ``scipy.linalg.expm``), overriding ``f``;
      prefer it when a structured algorithm exists -- Pade expm is
      more robust than generic Schur-Parlett.
    :param maxdim: Krylov dimension m (static; the ``corrections``
      tail is the same a-posteriori signal as :func:`funm_krylov`).
    :return: :class:`FunmResult` (``m`` is the LIVE dimension used).
    """
    import numpy as np
    import scipy.linalg as sla

    if (f is None) == (matfunc is None):
        raise ValueError("pass exactly one of f= or matfunc=")
    if matfunc is None:
        def matfunc(T):
            return sla.funm(T, lambda w: np.asarray(f(w)))

    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = min(int(maxdim), N)

    A_mv = as_matvec(A)
    dtype = system_dtype(bv)
    bv = bv.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype

    beta = jnp.linalg.norm(bv)
    V0 = jnp.zeros((m + 1, N), dtype).at[0].set(
        bv * safe_div(1.0, beta)
    )
    H0 = jnp.zeros((m + 1, m + 1), dtype)

    import jax

    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown funm_krylov_arnoldi ortho {ortho!r}")
    _sweep = lanczos_1r_sweep if ortho == "cgs2_1r" else lanczos_cgs2_sweep
    sweep = jax.jit(
        lambda V, H: _sweep(A_mv, V, H, 0, m, dtype, real_dtype)
    )
    V, H = sweep(V0, H0)

    Hh = np.asarray(H)
    # live leading block: the sweep writes an EXACT zero subdiagonal on
    # deflation (invariant subspace found)
    sub = np.abs(np.diag(Hh, -1))[:m]
    dead = np.nonzero(sub == 0.0)[0]
    j_live = int(dead[0]) + 1 if dead.size else m

    betah = float(beta)

    def fe1(j):
        col = np.asarray(matfunc(Hh[:j, :j]))[:, 0] * betah
        if np.iscomplexobj(col) and not np.iscomplexobj(
            np.zeros(0, np.dtype(dtype))
        ):
            # real system dtype: a real-analytic f of a real H is real
            # and Schur-Parlett merely returns a +0j-typed result -- but
            # f NOT real-analytic on the spectrum (sqrt/log of a real
            # non-normal H with eigenvalues on/near the branch cut)
            # yields genuinely complex columns whose silent truncation
            # would corrupt the answer with no signal in `corrections`
            # (ADVICE r4): warn when the imaginary mass is non-roundoff.
            imag_mass = np.linalg.norm(col.imag)
            scale = max(np.linalg.norm(col), 1.0)
            if imag_mass > 1e3 * np.finfo(col.real.dtype).eps * scale:
                import warnings

                warnings.warn(
                    "funm_krylov_arnoldi: f(H) e1 has non-negligible "
                    f"imaginary mass ({imag_mass:.2e} vs norm "
                    f"{scale:.2e}) for a real system dtype -- f is not "
                    "real on the Arnoldi spectrum (branch cut?); the "
                    "imaginary part is being discarded.  Pass a complex "
                    "b/dtype to keep it.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            col = col.real
        return col

    em = fe1(j_live)
    x = jnp.dot(jnp.asarray(em, dtype), V[:j_live])

    corrections = np.full(m + 1, np.nan, np.dtype(real_dtype))
    for j in range(max(2, j_live - 4), j_live):
        diff = em - np.concatenate(
            [fe1(j), np.zeros(j_live - j, em.dtype)]
        )
        corrections[j] = np.linalg.norm(diff)

    return FunmResult(
        x=x if flat else x[:, None],
        corrections=jnp.asarray(corrections),
        m=j_live,
    )


def expm_multiply(A, b, t=1.0, *, maxdim=30, hermitian=True):
    r"""``exp(t A) b`` (Lanczos for Hermitian ``A``, see
    :func:`funm_krylov`; ``hermitian=False`` switches to the Arnoldi
    path with host Pade expm on the Hessenberg, see
    :func:`funm_krylov_arnoldi` -- the workhorse for exponential
    integrators on convection-diffusion-class operators).  ``t`` may be
    negative (diffusion semigroups: ``expm_multiply(lap, b, -dt)``)."""
    t = float(t)
    if not hermitian:
        import scipy.linalg as sla

        return funm_krylov_arnoldi(
            A, b, matfunc=lambda T: sla.expm(t * T), maxdim=maxdim
        )
    return funm_krylov(A, b, lambda w: jnp.exp(t * w), maxdim=maxdim)


def inv_sqrt_multiply(
    A, b, *, lmin=None, lmax=None, terms=16, tol=1e-8, maxiter=None
):
    r"""``A^{-1/2} b`` for SPD ``A`` by elliptic-contour quadrature over
    multi-shift CG.

    The Hale-Higham-Trefethen conformal-map quadrature of
    :math:`A^{-1/2} = \frac{2}{\pi}\int_0^\infty (A + t^2 I)^{-1}\,dt`
    converges GEOMETRICALLY in the number of terms (16 terms reach
    ~1e-11 at condition number 1e4), and every resolvent in the sum is a
    member of one SPD shifted family -- so
    :func:`~krypy_tpu.functional.shifted.shifted_cg` computes all of
    them in ONE CG run (one matvec and two all-reduces per iteration,
    regardless of ``terms``), and the final combination is a single
    small GEMM.  Unlike :func:`funm_krylov` there is no m-step Krylov
    basis to store, so this scales to operators whose isqrt needs far
    more Krylov information than a replicated basis can hold.

    :param lmin,lmax: spectrum bounds (lmin must LOWER-bound, lmax
      upper-bound); estimated via
      :func:`~krypy_tpu.functional.chebyshev.spectral_bounds` when
      omitted.
    :param terms: quadrature points (geometric accuracy in ``terms``,
      degrading logarithmically with condition number).
    :param tol: target relative accuracy; the inner shifted solves run
      to ``max(tol/10, floor)`` where ``floor`` is the attainable
      relative residual of the SEED system's dtype
      (``~50*eps``) -- a float32 operator with the float64-style
      default ``tol=1e-8`` then still terminates at its floor instead
      of running the full maxiter budget, and ``shifted_cg``'s seed
      stagnation guard plus ``info["shift_status"]`` report what was
      actually achieved.
    :return: ``(x, info)`` where ``info`` carries the shifted-solve
      statuses and the quadrature parameters.
    """
    import numpy as np
    from scipy.special import ellipj, ellipk

    from .chebyshev import spectral_bounds
    from .shifted import shifted_cg

    b = jnp.asarray(b)
    if lmin is None or lmax is None:
        # asymmetric estimation risk: the quadrature needs lmin to
        # LOWER-bound the spectrum, and Lanczos Ritz values can sit far
        # above the true lambda_min on dense spectra -- but an
        # UNDERestimated lmin is harmless (accuracy depends only
        # logarithmically on lmax/lmin), so take two orders of
        # magnitude of slack; pass explicit bounds when known
        lo, hi = spectral_bounds(A, b, safety=(0.01, 1.2))
        lmin = float(lo) if lmin is None else float(lmin)
        lmax = float(hi) if lmax is None else float(lmax)
    lmin, lmax = float(lmin), float(lmax)
    if not 0 < lmin <= lmax:
        raise ValueError(f"need 0 < lmin <= lmax, got [{lmin}, {lmax}]")

    # midpoint rule in the conformal variable u in [0, K']:
    # t = sqrt(lmin) sn/cn, dt = sqrt(lmin) dn/cn^2 du (modulus
    # m1 = 1 - lmin/lmax)
    m1 = 1.0 - lmin / lmax
    Kp = float(ellipk(m1))
    u = (np.arange(terms) + 0.5) * Kp / terms
    sn, cn, dn, _ = ellipj(u, m1)
    shifts = lmin * (sn / cn) ** 2
    weights = (
        2.0 * Kp * np.sqrt(lmin) / (np.pi * terms)
    ) * dn / cn**2

    # clamp the inner target to the rhs dtype's attainable floor; the
    # kappa factor is unknown here, but the seed stagnation guard
    # inside shifted_cg handles the conditioning-dependent part
    eps = float(np.finfo(np.dtype(jnp.asarray(b).dtype)).eps)
    inner_tol = max(tol / 10.0, 50.0 * eps)
    res = shifted_cg(
        A, b, jnp.asarray(shifts), tol=inner_tol, maxiter=maxiter
    )
    w = jnp.asarray(weights, res.X.real.dtype).astype(res.X.dtype)
    x = jnp.dot(w, res.X)
    info = {
        "shift_status": res.status,
        "inner_iters": res.niter,
        "shifts": shifts,
        "weights": weights,
        "lmin": lmin,
        "lmax": lmax,
    }
    return (x if b.ndim == 1 else x[:, None]), info


def slq_trace(
    A, f, key, *, n=None, n_probes=16, maxdim=30, ortho="cgs2"
):
    r"""Stochastic Lanczos quadrature estimate of ``trace(f(A))`` for
    Hermitian ``A`` (Hutchinson probes + Gauss quadrature from the
    Lanczos tridiagonalization; the workhorse of log-determinant and
    trace-of-inverse estimation in Gaussian-process likelihoods).

    For Rademacher probes :math:`z` (``E[z z^T] = I``),
    :math:`E[z^T f(A) z] = \mathrm{tr} f(A)`, and each quadratic form is
    evaluated EXACTLY on the Krylov subspace:
    :math:`z^T f(A) z \approx \|z\|^2 \sum_j |S_{1j}|^2 f(\theta_j)`
    from the ``maxdim``-step Lanczos eigendecomposition.

    accelerator-native mapping: ALL probes run simultaneously --
    ``jax.vmap`` over the shared CGS2 sweep turns the per-probe matvecs
    into batched ``(n_probes, N)`` operator applications and the small
    eigensolves into one batched eigh; one dispatch for the whole
    estimator.  Dead-block (invariant-subspace) Ritz values are masked
    exactly as in :func:`funm_krylov`.

    :param key: ``jax.random`` PRNGKey for the Rademacher probes
      (explicit, so results are reproducible and traceable).
    :param n: problem size when ``A`` has no ``.shape``.
    :return: ``(estimate, stderr)`` -- the Hutchinson mean and its
      standard error over probes (the QUADRATURE error in each
      quadratic form is separate: raise ``maxdim`` until the estimate
      stabilizes; for smooth f like log it converges geometrically).
    """
    import jax

    A_mv = as_matvec(A)
    if n is None:
        shape = getattr(A, "shape", None)
        if shape is None:
            raise ValueError("n= required when A has no .shape")
        n = shape[0]
    N = int(n)

    # dtype follows the OPERATOR (eval_shape: no device work) -- a
    # float32 operator stays f32, and a complex Hermitian operator is
    # NOT silently truncated to real (which would return a wrong
    # logdet with near-zero error bars)
    # probe with the WEAKEST real dtype: fixed-dtype operators promote
    # the result to their own width; dtype-adaptive operators stay
    # narrow instead of being silently upcast
    out_aval = jax.eval_shape(
        A_mv, jax.ShapeDtypeStruct((N,), jnp.float32)
    )
    dtype = out_aval.dtype
    probe = jax.random.rademacher(key, (int(n_probes), N))
    Z = probe.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    m = min(int(maxdim), N)

    def quad_form(z):
        beta = jnp.linalg.norm(z)
        V = jnp.zeros((m + 1, N), dtype).at[0].set(
            z * safe_div(1.0, beta)
        )
        H = jnp.zeros((m + 1, m + 1), dtype)
        _sweep = (
            lanczos_1r_sweep if ortho == "cgs2_1r" else lanczos_cgs2_sweep
        )
        V, H = _sweep(A_mv, V, H, 0, m, dtype, real_dtype)
        Tm = 0.5 * (H[:m, :m] + H[:m, :m].conj().T)
        theta, S = jnp.linalg.eigh(Tm)
        spurious = spurious_ritz_mask(V[:m], S)
        w = jnp.where(
            spurious, 0.0, jnp.abs(S[0]) ** 2 * f(theta)
        )
        return beta**2 * jnp.sum(w)

    vals = jax.vmap(quad_form)(Z)
    est = jnp.mean(vals)
    if int(n_probes) > 1:
        # sample standard error (ddof=1); population std would bias
        # the bar low
        stderr = jnp.std(vals, ddof=1) * safe_div(
            1.0, jnp.sqrt(jnp.asarray(float(n_probes), real_dtype))
        )
    else:
        # a single probe carries no variance information
        stderr = jnp.asarray(jnp.inf, real_dtype)
    return est, stderr


def slq_logdet(A, key, **kwargs):
    r"""``log det(A)`` for SPD ``A`` by stochastic Lanczos quadrature
    (see :func:`slq_trace`; ``f = log``)."""
    return slq_trace(A, jnp.log, key, **kwargs)
