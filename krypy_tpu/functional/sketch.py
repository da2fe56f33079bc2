r"""Randomized sketching lane: sketched GMRES (sGMRES).

sGMRES (Nakatsukasa & Tropp, "Fast and accurate randomized algorithms
for linear systems and eigenvalue problems", SIMAX 2024) decouples the
Krylov BASIS from the residual MINIMIZATION: build a cheap basis that is
only *locally* orthogonalized (k-truncated Arnoldi: O(k N) HBM traffic
per iteration instead of full GMRES's O(j N) sweep), push everything
through a random subspace embedding ``S`` with ``d = O(m)`` rows, and
minimize the *sketched* residual ``||S(r0) - S(A Z) y||`` -- a small
``d x m`` least-squares problem.  If ``S`` embeds the (m+1)-dimensional
residual subspace with distortion ``eps``, the returned iterate is
quasi-optimal: ``||b - A x|| <= sqrt((1+eps)/(1-eps))`` times the true
minimum over the same subspace.

accelerator-first design decisions:

* The sketch is a KRONECKER-FACTORED Gaussian embedding
  ``S = (S1 (x) S2) / sqrt(d)`` with ``S1: (d1, n1)``, ``S2: (d2, n2)``,
  ``n1 n2 >= N``, ``d = d1 d2``: applying it is one reshape plus two
  small GEMMs (exactly one memory sweep of the vector), and
  it stores ``O(sqrt(d N))`` floats instead of a dense Gaussian's
  ``O(d N)`` (a dense sketch at d=168, N=1M would re-read 672 MB per
  iteration -- more than the entire ortho sweep it replaces).  The
  classical SRHT is out (an FFT-like transform per iteration; ROADMAP
  item C3 re-decides this by measurement) and CountSketch-class sparse
  sketches are out (scatters serialize).
  Kronecker-Gaussian maps carry an oversampling penalty over dense
  Gaussian embeddings AND a structured failure mode: grid-smooth
  vectors are near-rank-1 as reshaped matrices and the raw Kronecker
  map preserves rank, collapsing the embedding on exactly the
  subspaces a PDE solve produces -- so the sketch applies an iid
  Rademacher pre-mask (see :class:`KronSketch`), and ``sketch_dim``
  defaults to ``8 (maxiter+1)``: measured subspace distortion on a
  41-dim Krylov space of the 511^2 Poisson operator left a barely-
  converging cycle with NO true progress at d=4m (sketched 0.73 vs
  true 1.0, classic GMRES 0.887) and honest progress at d=8m (0.95) --
  and d barely affects per-iteration cost, which the O(N) sweep
  dominates.  Embedding quality is verified empirically in
  tests/test_sketch.py, including the orthogonal smooth-mode pair that
  breaks the unmasked map.
* The small sketched LS problem is solved by an INCREMENTAL Householder
  QR carried inside the while_loop state (reflectors in a ``(m, d)``
  buffer): per iteration it costs ``O(j d)`` flops, needs no
  eigendecomposition inside the loop (eigh inside a while_loop is slow
  to compile), and delivers the sketched residual norm for
  the stopping test as one masked tail norm -- the same mechanism the
  Givens chain provides in classic GMRES.
* The basis buffer is row-major ``(maxiter+1, N)`` like every other core
  in this package; the k-row orthogonalization window is one
  ``lax.dynamic_slice`` (unwritten rows are zero, so the window never
  needs masking).

Honesty contract (identical to the sibling cores): the loop stops on the
*sketched* residual, but the returned status is decided by the explicit
TRUE residual of the assembled iterate; ``resnorms`` carries the
per-iteration sketched estimates with the final entry replaced by the
true relative residual.

Reference baseline: krypy has no randomized lane (its GMRES fully
orthogonalizes, krypy/linsys.py:877-1018); accelerator-native surface.
"""

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .common import (
    CONVERGED,
    MAXITER,
    apply,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    safe_div,
    system_dtype,
)

__all__ = [
    "KronSketch",
    "SketchedSolveResult",
    "kron_sketch",
    "sketch_apply",
    "sketched_gmres",
    "restarted_sketched_gmres",
    "sketched_eigs",
]


class SketchedSolveResult(NamedTuple):
    """Result pytree of a sketched solve: the shared
    :class:`~krypy_tpu.functional.common.SolveResult` surface plus the
    runtime EMBEDDING-QUALITY CERTIFICATE.

    ``distortion`` is the posterior sketched-vs-true residual ratio
    ``true_rel / sketched_rel`` at exit, computed from the explicit
    true residual the honesty contract already pays for -- no extra
    cost.  On a healthy embedding it sits near 1; values well above 1
    mean the sketch UNDER-estimated the residual by that factor on the
    subspace this operator actually produced (the quasi-optimality
    guarantee degraded from sqrt((1+eps)/(1-eps)) ~ 1 toward the
    observed ratio), and the iterate converged in sketch-space without
    true progress.  :func:`restarted_sketched_gmres` escalates
    ``sketch_dim`` (or falls back to classic GMRES) when it exceeds
    ``distortion_limit``.
    """

    #: approximate solution, shape ``(N,)``
    x: jnp.ndarray
    #: sketched per-iteration estimates; final entry = true residual
    resnorms: jnp.ndarray
    #: number of iterations performed
    niter: jnp.ndarray
    #: CONVERGED / MAXITER
    status: jnp.ndarray
    #: posterior embedding certificate (see class docstring)
    #: plain-float default: a jnp default here would initialize the JAX
    #: backend at import time, before the caller can select a platform;
    #: constructors pass a device array explicitly.
    distortion: jnp.ndarray = 1.0
    #: realized embedding dimension d of the sketch used
    sketch_d: int = 0

    @property
    def converged(self):
        return self.status == CONVERGED


class KronSketch(NamedTuple):
    """Kronecker-factored Gaussian sketch
    ``x -> (S1 (x) S2) (signs * x)_pad / sqrt(d)``.

    ``x`` is sign-masked, zero-padded to ``n1 * n2`` and reshaped to
    ``(n1, n2)``; the embedding is ``S1 @ X @ S2.T`` flattened to
    ``d = d1 * d2``.

    The Rademacher pre-mask is LOAD-BEARING: a vector that is smooth on
    an ``(n1, n2)`` grid is near-rank-1 as a matrix, and the raw
    Kronecker map sends rank-1 matrices to rank-1 matrices -- the
    embedding collapses to an effective ``d1 + d2`` dimensions on such
    subspaces (measured: two ORTHOGONAL Laplacian eigenmodes at 255^2
    sketched to cosine -0.35; with the mask -0.004).  iid signs destroy
    the rank structure at the cost of one fused elementwise multiply.
    """

    S1: jnp.ndarray     # (d1, n1)
    S2: jnp.ndarray     # (d2, n2)
    signs: jnp.ndarray  # (N,) Rademacher pre-mask
    N: int

    @property
    def d(self):
        return self.S1.shape[0] * self.S2.shape[0]


def _split_even(n):
    """n1 >= n2 with n1 * n2 >= n, both near sqrt(n)."""
    n2 = max(1, int(math.isqrt(n)))
    n1 = -(-n // n2)
    return n1, n2


def kron_sketch(N, d, *, seed=0, dtype=jnp.float32):
    """Draw a :class:`KronSketch` embedding R^N -> R^(>=d).

    The factor dimensions are the integer splits nearest sqrt: the
    realized ``d1 * d2`` may slightly exceed the requested ``d``.
    """
    d1, d2 = _split_even(int(d))
    n1, n2 = _split_even(int(N))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    scale = 1.0 / math.sqrt(d1 * d2)
    # fold the global 1/sqrt(d) into S1 once
    S1 = jax.random.normal(k1, (d1, n1), real_dtype) * scale
    S2 = jax.random.normal(k2, (d2, n2), real_dtype)
    signs = jax.random.rademacher(k3, (int(N),), real_dtype)
    return KronSketch(S1=S1, S2=S2, signs=signs, N=int(N))


def padded_kron_sketch(N, d_active, d_max, *, seed=0, dtype=jnp.float32):
    """Draw a :class:`KronSketch` whose BUFFERS are sized for ``d_max``
    but whose live embedding has ~``d_active`` rows; the rest of S1 is
    exactly zero.

    This is the single-program escalation device (VERDICT r4 #7): every
    escalation level shares the ``d_max``-padded shapes, so the jitted
    solve cycle compiles ONCE and levels differ only in operand VALUES
    (zeroed rows produce zero sketch coordinates, which the Householder
    least-squares treats as absent equations).  The 1/sqrt(d) scale
    folded into S1 uses the ACTIVE row count, keeping the embedding an
    isometry-in-expectation at every level.  The padding costs extra
    matrix-unit flops in the two small sketch GEMMs only -- the HBM sweep of
    the sketched vector (the real cost) is padding-independent.
    """
    d1, d2 = _split_even(int(d_max))
    n1, n2 = _split_even(int(N))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    # active rows of S1 (each carries d2 embedding coordinates)
    rows = max(1, min(d1, -(-int(d_active) // d2)))
    scale = 1.0 / math.sqrt(rows * d2)
    S1 = jax.random.normal(k1, (d1, n1), real_dtype) * scale
    S1 = S1.at[rows:].set(0.0)
    S2 = jax.random.normal(k2, (d2, n2), real_dtype)
    signs = jax.random.rademacher(k3, (int(N),), real_dtype)
    return KronSketch(S1=S1, S2=S2, signs=signs, N=int(N))


def sketch_apply(S, x):
    """Apply the sketch to a vector (one HBM sweep + two small GEMMs)."""
    n1, n2 = S.S1.shape[1], S.S2.shape[1]
    xv = x.reshape(-1) * S.signs.astype(x.dtype)
    xp = jnp.pad(xv, (0, n1 * n2 - S.N))
    X = xp.reshape(n1, n2)
    return (S.S1.astype(x.dtype) @ X @ S.S2.T.astype(x.dtype)).reshape(-1)


class _SgmresState(NamedTuple):
    j: jnp.ndarray          # columns of S(AZ) processed so far
    B: jnp.ndarray          # (maxiter+1, N) truncated-Arnoldi basis rows
    SW: jnp.ndarray         # (maxiter, d) sketched columns S(A M b_j)
    V: jnp.ndarray          # (maxiter, d) unit Householder reflectors
    R: jnp.ndarray          # (maxiter, maxiter) upper triangular
    t: jnp.ndarray          # (d,) reflector-transformed sketched rhs
    cur_rel: jnp.ndarray    # sketched relative residual estimate
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    exhausted: jnp.ndarray  # basis could not be extended (invariance)
    resnorms: jnp.ndarray


def _house_vector(c, j, d):
    """Unit Householder vector zeroing ``c`` strictly below position j.

    Masked fixed-shape construction: entries < j are zero; complex-safe
    (the pivot keeps its phase).  Returns (v, alpha) with
    ``(I - 2 v v^H) c = [c[:j], alpha, 0...]`` and ``|alpha| = ||c[j:]||``.
    """
    idx = jnp.arange(d)
    tail = jnp.where(idx >= j, c, 0)
    na = jnp.linalg.norm(tail)
    c_j = c[j]
    absj = jnp.abs(c_j)
    phase = jnp.where(absj > 0, c_j / jnp.where(absj > 0, absj, 1.0), 1.0)
    alpha = -phase * na
    v = tail - alpha * (idx == j)
    nv = jnp.linalg.norm(v)
    v = jnp.where(nv > 0, v / jnp.where(nv > 0, nv, 1.0), v)
    return v, alpha


def sketched_gmres(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=40,
    k_ortho=2,
    sketch_dim=None,
    seed=0,
    sketch=None,
    stagnation_window=0,
    sketch_safety=0.25,
):
    r"""Solve ``A x = b`` by sketched GMRES in one compiled while_loop.

    Per iteration: ONE matvec (+ one preconditioner apply), a k-row
    orthogonalization window (``O(k N)`` traffic, independent of the
    iteration count), one sketch application (one sweep of the new
    vector) and an ``O(j d)`` small-QR update.  Compare classic GMRES's
    ``O(j N)`` full-basis sweep: at ``maxiter=40`` the sketched basis
    construction moves ~10x less HBM traffic per iteration.

    :param M: optional RIGHT preconditioner matvec; the minimized
      residual is the true residual of the original system.
    :param k_ortho: truncated-Arnoldi window (2-4 typical).  The basis
      is NOT globally orthogonal -- quasi-optimality of the returned
      iterate is inherited from the sketch, not the basis.
    :param sketch_dim: embedding dimension ``d`` (default
      ``8 (maxiter+1)``, must be ``> maxiter``).
    :param sketch: pass a prebuilt :class:`KronSketch` to share one
      embedding across a solve sequence.
    :param sketch_safety: the loop stops when the *sketched* relative
      residual falls below ``sketch_safety * tol``.  The margin absorbs
      the MINIMIZATION BIAS of sketch-and-solve: the sketched minimizer
      picks directions where the embedding underestimates, so the true
      residual can exceed the sketched one by the subspace distortion
      factor ``sqrt((1+eps)/(1-eps))`` (~2x at ``d = 4 m``), not just
      the ~1/sqrt(d) fixed-vector concentration.  The returned status
      is CONVERGED only if the explicit true residual meets ``tol``.
    :return: :class:`~krypy_tpu.functional.common.SolveResult`;
      ``resnorms[i]`` is the sketched estimate after ``i`` iterations,
      with the final entry replaced by the true relative residual.
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = int(maxiter)
    k_ortho = max(1, int(k_ortho))

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))
    real_dtype = jnp.zeros(0, dtype).real.dtype

    if sketch is None:
        sketch_dim = 8 * (maxiter + 1) if sketch_dim is None else int(sketch_dim)
        sketch = kron_sketch(N, sketch_dim, seed=seed, dtype=real_dtype)
    d = sketch.d
    if d <= maxiter:
        raise ValueError(
            f"sketch_dim (realized {d}) must exceed maxiter={maxiter}: the "
            "sketched LS problem needs more rows than columns"
        )

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    bnorm = jnp.linalg.norm(bv)
    r0 = bv - A_mv(x0v)
    r0norm = jnp.linalg.norm(r0)
    rel0 = safe_div(r0norm, bnorm)
    sr0 = sketch_apply(sketch, r0)
    sbnorm = jnp.linalg.norm(sketch_apply(sketch, bv))

    tiny = breakdown_threshold(dtype)
    idx_d = jnp.arange(d)

    B0 = jnp.zeros((maxiter + 1, N), dtype)
    B0 = B0.at[0].set(jnp.where(r0norm > 0, r0 / jnp.where(r0norm > 0, r0norm, 1.0), r0))

    def body(state):
        j = state.j
        # --- extend: w = A M b_j, sketch it BEFORE local orthogonalization
        z = lax.dynamic_slice(state.B, (j, 0), (1, N))[0]
        w = A_mv(apply(M_mv, z))
        sw = sketch_apply(sketch, w).astype(dtype)

        # --- incremental Householder QR of the sketched column
        def reflect(i, c):
            vi = state.V[i]
            return c - vi * (2.0 * jnp.vdot(vi, c))

        c = lax.fori_loop(0, j, reflect, sw)
        v, alpha = _house_vector(c, j, d)
        # sketched column (numerically) dependent on the previous ones:
        # the basis stopped producing new directions -- stop extending
        # (the final assembly drops the trailing degenerate column)
        dependent = jnp.abs(alpha) <= tiny * jnp.linalg.norm(sw)
        # column j of R: entries above the diagonal come from c, the
        # diagonal is alpha, below-diagonal mass is annihilated
        rcol = jnp.where(idx_d < j, c, 0).at[j].set(alpha)[: maxiter]
        R = state.R.at[:, j].set(rcol)
        V = state.V.at[j].set(v)
        t = state.t - v * (2.0 * jnp.vdot(v, state.t))
        # LS residual with columns 0..j = tail of the transformed rhs
        srel = safe_div(
            jnp.linalg.norm(jnp.where(idx_d > j, t, 0)), sbnorm
        ).astype(real_dtype)

        # --- truncated-Arnoldi local orthogonalization (k-row window;
        # rows above j are still zero, so no masking is needed)
        start = jnp.maximum(j - (k_ortho - 1), 0)
        W = lax.dynamic_slice(state.B, (start, 0), (k_ortho, N))
        h = W.conj() @ w
        u = w - jnp.tensordot(h, W, 1)
        nu = jnp.linalg.norm(u)
        wnorm = jnp.linalg.norm(w)
        exhausted = nu <= tiny * wnorm
        row = jnp.where(exhausted, 0.0, u / jnp.where(nu > 0, nu, 1.0))
        B = lax.dynamic_update_slice(state.B, row[None, :], (j + 1, 0))

        improved = srel < 0.99 * state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(srel, state.best_rel)
        resnorms = state.resnorms.at[j + 1].set(srel)
        SW = state.SW.at[j].set(sw)
        return _SgmresState(
            j + 1, B, SW, V, R, t, srel, best, stall,
            exhausted | dependent | ~jnp.isfinite(srel), resnorms,
        )

    def cond(state):
        go = (
            (state.cur_rel > sketch_safety * tol)
            & (state.j < maxiter)
            & ~state.exhausted
        )
        if stagnation_window > 0:
            go = go & (state.stall < stagnation_window)
        return go

    init = _SgmresState(
        jnp.asarray(0),
        B0,
        jnp.zeros((maxiter, d), dtype),
        jnp.zeros((maxiter, d), dtype),
        jnp.zeros((maxiter, maxiter), dtype),
        sr0.astype(dtype),
        rel0.astype(real_dtype),
        rel0.astype(real_dtype),
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.full(maxiter + 1, jnp.nan, real_dtype).at[0].set(rel0),
    )
    final = lax.while_loop(cond, body, init)

    # --- assemble by the best of three sketched-LS solves.  A raw
    # triangular solve through a near-dependent truncated-Arnoldi basis
    # amplifies y catastrophically at reduced precision (measured: f32
    # Jacobi-convdiff restarts diverged to rel 1.3), while a uniformly
    # truncated solve discards the fine corrections a healthy basis
    # carries (f64 convdiff stalled at 6.6e-6 under sqrt(eps)
    # truncation).  So: candidate 1 is the EXACT LS solution from the
    # in-loop Householder QR; candidates 2-3 are spectrally truncated
    # solves from the (m, m) Gram eigendecomposition (eigh, not SVD --
    # jnp.linalg.svd inside this jitted program has crashed an
    # ahead-of-time compiler; eigh is the path lobpcg/eigh use).
    # The winner is chosen by the EXPLICIT true residual: three
    # end-of-solve matvecs, no per-iteration cost.
    jf = final.j
    col = jnp.arange(maxiter)
    active = col < jf
    SWm = jnp.where(active[:, None], final.SW, 0)  # (m, d)
    eps = jnp.finfo(real_dtype).eps

    def residual_of(x):
        return safe_div(jnp.linalg.norm(bv - A_mv(x)), bnorm)

    def to_x(y):
        y = jnp.where(active, y, 0)
        return x0v + apply(M_mv, jnp.tensordot(y, final.B[:maxiter], 1))

    # candidate 1: exact LS via the loop's QR (drop a trailing
    # degenerate column: the loop exits at the FIRST dependent one)
    diag = jnp.diagonal(final.R)
    ok_diag = jnp.abs(diag) > tiny * jnp.max(
        jnp.concatenate([jnp.abs(diag), jnp.ones(1, real_dtype)])
    )
    act_qr = active & ok_diag
    Rm = jnp.where(act_qr[None, :] & act_qr[:, None], final.R, 0)
    Rm = Rm + jnp.diag(jnp.where(act_qr, 0.0, 1.0).astype(dtype))
    tm = jnp.where(act_qr, final.t[:maxiter], 0)
    y_qr = jax.scipy.linalg.solve_triangular(Rm, tm, lower=False)
    y_qr = jnp.where(act_qr, y_qr, 0)

    # candidates 2-3: spectrally truncated normal-equations solves
    G = (SWm @ SWm.conj().T).conj()       # (m, m) = C^H C, C = SW^T
    g = SWm.conj() @ sr0.astype(dtype)    # (m,)  = C^H sr0
    w, Vg = jnp.linalg.eigh(G)            # ascending, w ~ sigma^2
    wmax = jnp.maximum(w[-1], jnp.finfo(real_dtype).tiny)
    c = Vg.conj().T @ g

    def truncated(rcond):
        keep = w > (rcond * rcond) * wmax
        inv_w = jnp.where(keep, 1.0 / jnp.where(keep, w, 1.0), 0.0)
        return Vg @ (inv_w * c)

    # the x0 fallback guards against reduced-precision overruns past
    # the attainable floor: never return an iterate worse than x0
    x, true_rel = x0v, rel0
    for y in (y_qr, truncated(float(eps) ** 0.5),
              truncated(float(eps) ** 0.25)):
        xc = to_x(y)
        relc = residual_of(xc)
        better = relc < true_rel
        x = jnp.where(better, xc, x)
        true_rel = jnp.where(better, relc, true_rel)

    resnorms = final.resnorms.at[jf].set(true_rel)
    status = jnp.where(true_rel <= tol, CONVERGED, MAXITER)
    # posterior embedding certificate: the explicit true residual is
    # already in hand, so the sketched-vs-true ratio is free.  Guard
    # the zero-iteration and exactly-converged corners to 1.
    sk_rel = jnp.maximum(final.cur_rel, jnp.asarray(tiny, real_dtype))
    distortion = jnp.where(
        jf > 0, true_rel / sk_rel, jnp.ones((), real_dtype)
    )
    # report the LIVE embedding dimension: under the padded single-
    # program escalation (padded_kron_sketch) trailing S1 rows are
    # exactly zero and carry no equations -- counting them (a cheap
    # traced (d1, n1) scan, no N-sized reduction) keeps sketch_d
    # meaningful across escalation levels
    live_rows = jnp.sum(jnp.any(sketch.S1 != 0, axis=1))
    return SketchedSolveResult(
        x=x if flat else x[:, None],
        resnorms=resnorms,
        niter=jf,
        status=status,
        distortion=distortion.astype(real_dtype),
        sketch_d=live_rows * sketch.S2.shape[0],
    )


_SKETCH_RESTART_CACHE = {}
_SKETCH_RESTART_CACHE_MAX = 32


def restarted_sketched_gmres(
    A,
    b,
    *,
    max_restarts=0,
    maxiter=40,
    tol=1e-5,
    seed=0,
    sketch=None,
    distortion_limit=4.0,
    max_escalations=2,
    classic_fallback=True,
    **kwargs,
):
    """Restarted sketched GMRES: cycles of :func:`sketched_gmres` with
    the last iterate as the next initial guess, sharing ONE embedding.

    Restarting is the stability lever for the randomized lane: within a
    cycle the truncated-Arnoldi basis conditioning and the embedding
    distortion both grow with the cycle length, so long solves run as
    moderate cycles (m ~ 40) whose per-iteration cost stays ~constant
    (benchmarks/sketch_bench.py measures 4.3x classic GMRES at m=40 /
    1M dof) while each restart resets the basis against the TRUE
    residual (each cycle ends with an explicit-residual assembly, so
    restarts never chase sketch noise).

    EMBEDDING QUALITY is policed at each restart seam, not just
    observed: when a cycle's posterior ``distortion`` certificate (see
    :class:`SketchedSolveResult`) exceeds ``distortion_limit`` and the
    cycle failed to converge, the sketch is rebuilt with DOUBLE the
    embedding dimension and a fresh seed (up to ``max_escalations``
    times); if the certificate still fails after the last escalation
    and ``classic_fallback`` is true, the remaining iteration budget
    runs as classic restarted GMRES -- a silently bad embedding costs
    at most one cycle, never the solve.  Pass
    ``distortion_limit=float('inf')`` for the round-3 behavior.

    The compiled cycle takes ``(b, x0)`` as traced arguments and is
    cached across calls -- a solve sequence on one operator compiles
    once (per escalation level).  ``resnorms`` carries the
    per-iteration sketched estimates of all cycles stitched at the
    explicit cycle boundaries.
    """
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    N = int(bv.shape[0])
    x = kwargs.pop("x0", None)
    real_dtype = jnp.zeros(0, system_dtype(bv, None)).real.dtype

    key_items = tuple(
        (k, v if isinstance(v, (bool, int, float, str, type(None))) else id(v))
        for k, v in sorted(kwargs.items())
    )

    if sketch is None:
        # SINGLE-PROGRAM escalation (VERDICT r4 #7): every level shares
        # the d_max-padded buffer shapes, the sketch enters the jitted
        # cycle as a traced operand, and escalating = handing the same
        # compiled program a value with more live rows.  A mid-solve
        # retrace could cost more than the solve; this removes it by
        # construction.
        sd = kwargs.pop("sketch_dim", None)
        sd = 8 * (int(maxiter) + 1) if sd is None else int(sd)
        if sd <= int(maxiter):
            raise ValueError(
                f"sketch_dim={sd} must exceed maxiter={maxiter}"
            )
        d_max = sd * (2 ** max(0, int(max_escalations)))

        def level_sketch(level, seed_l):
            return padded_kron_sketch(
                N, sd * (2 ** level), d_max, seed=seed_l,
                dtype=real_dtype,
            )

        sketch = level_sketch(0, seed)
        key = (id(A), "padded", float(tol), int(maxiter), N, d_max,
               key_items)
        cycle_fn = _SKETCH_RESTART_CACHE.get(key)
        if cycle_fn is None:

            @jax.jit
            def cycle_fn(bb, xx, S1, S2, signs):
                sk = KronSketch(S1=S1, S2=S2, signs=signs, N=N)
                return sketched_gmres(
                    A, bb, x0=xx, tol=tol, maxiter=maxiter, sketch=sk,
                    **kwargs,
                )

            cycle_fn._keepalive = (A, kwargs)
            if len(_SKETCH_RESTART_CACHE) >= _SKETCH_RESTART_CACHE_MAX:
                _SKETCH_RESTART_CACHE.pop(
                    next(iter(_SKETCH_RESTART_CACHE))
                )
            _SKETCH_RESTART_CACHE[key] = cycle_fn

        def cycle(bb, xx):
            return cycle_fn(bb, xx, sketch.S1, sketch.S2, sketch.signs)

        def make_cycle(sk):
            # same compiled program; only the operand values change
            return cycle
    else:
        # explicit user sketch: legacy per-shape cycles (escalation
        # rebuilds at the doubled shape and pays one retrace)
        kwargs.pop("sketch_dim", None)
        level_sketch = None

        def make_cycle(sk):
            key = (id(A), id(sk), float(tol), int(maxiter), key_items)
            cyc = _SKETCH_RESTART_CACHE.get(key)
            if cyc is None:

                @jax.jit
                def cyc(bb, xx):
                    return sketched_gmres(
                        A, bb, x0=xx, tol=tol, maxiter=maxiter,
                        sketch=sk, **kwargs,
                    )

                cyc._keepalive = (A, sk, kwargs)
                if len(_SKETCH_RESTART_CACHE) >= _SKETCH_RESTART_CACHE_MAX:
                    _SKETCH_RESTART_CACHE.pop(
                        next(iter(_SKETCH_RESTART_CACHE))
                    )
                _SKETCH_RESTART_CACHE[key] = cyc
            return cyc

        cycle = make_cycle(sketch)

    import numpy as _np

    x = (
        jnp.zeros(bv.shape[0], bv.dtype)
        if x is None
        else jnp.asarray(x).reshape(-1)
    )
    resnorms = []
    result = None
    total = 0
    prev_rel = float("inf")
    escalations = 0
    cycles_left = int(max_restarts) + 1
    while cycles_left > 0:
        cycles_left -= 1
        result = cycle(bv, x)
        niter = int(result.niter)
        total += niter
        chunk = list(_np.asarray(result.resnorms)[: niter + 1])
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        cycle_rel = float(chunk[-1])
        if int(result.status) == CONVERGED or niter == 0:
            break
        distorted = float(result.distortion) > float(distortion_limit)
        if distorted and escalations < int(max_escalations):
            # bad embedding: double the LIVE dimension, fresh seed, and
            # spend one of the remaining cycles re-trying (don't trip
            # the stall exit on a residual the certificate says was
            # never trustworthy).  On the padded path this hands the
            # SAME compiled program a new operand value -- no retrace.
            escalations += 1
            if level_sketch is not None:
                sketch = level_sketch(
                    escalations, seed + 7919 * escalations
                )
            else:
                sketch = kron_sketch(
                    bv.shape[0], 2 * sketch.d,
                    seed=seed + 7919 * escalations, dtype=real_dtype,
                )
            cycle = make_cycle(sketch)
            prev_rel = cycle_rel if cycle_rel < prev_rel else prev_rel
            continue
        if distorted and classic_fallback:
            # certificate still failing at the escalation cap: the
            # operator's subspaces defeat this embedding family -- give
            # the remaining budget to classic restarted GMRES
            from .gmres import gmres as _classic_gmres

            budget = max(1, cycles_left + 1) * int(maxiter)
            cres = _classic_gmres(
                A, bv, x0=x, tol=tol, maxiter=budget,
                # sketched_gmres applies M as RIGHT preconditioning
                # (x = x0 + M correction, line ~315/411): hand the same
                # operator to classic gmres as Mr, NOT as its inner-
                # product-defining M -- a nonsymmetric M (e.g. SPAI)
                # would make gmres's sqrt(<r, M r>) norms meaningless
                # (ADVICE r4).
                Mr=kwargs.get("M"),
            )
            cn = int(cres.niter)
            total += cn
            chunk = list(_np.asarray(cres.resnorms)[: cn + 1])
            resnorms = resnorms[:-1] + chunk
            x = cres.x
            result = result._replace(status=cres.status)
            break
        # stop at the attainable floor: the cycle's explicit residual
        # no longer improves (the cycle itself guards against returning
        # a worse iterate, so equality means "stuck", not "diverging")
        if cycle_rel >= 0.999 * prev_rel:
            break
        prev_rel = cycle_rel

    return result._replace(
        x=x if b.ndim == 1 else x[:, None],
        resnorms=jnp.asarray(_np.asarray(resnorms)),
        niter=jnp.asarray(total),
    )


def sketched_eigs(
    A,
    k=6,
    *,
    v0=None,
    n=None,
    which="lm",
    maxiter=80,
    k_ortho=2,
    sketch_dim=None,
    seed=0,
    sketch=None,
    tol=1e-6,
):
    r"""Sketched Rayleigh-Ritz: ``k`` eigenpair estimates of a general
    operator from ONE pass of truncated Arnoldi (Nakatsukasa & Tropp).

    Builds an m-step k_ortho-locally-orthogonalized basis (``O(k N)``
    traffic per step -- ~10x cheaper than full Arnoldi at m=80), embeds
    basis and images through the shared Kronecker sketch, whitens by a
    truncated SVD of the small ``(d, m)`` sketched basis, and solves
    the ``r x r`` projected eigenproblem on host LAPACK (the package's
    convention for small dense non-Hermitian spectral work,
    docs/DESIGN.md section 7).  Every returned pair is certified
    EXPLICITLY against A: ``pair_resnorms[i] = ||A u_i - theta_i u_i||
    / max(|theta_i|, tiny)`` -- the sketch can only mislead the
    selection, never the reported quality.

    This is the cheap one-shot SPECTRAL SURVEY tool: use
    :func:`~krypy_tpu.functional.eigs.eigs` (Krylov-Schur) when
    specific pairs must converge to tight tolerances, and this when a
    wide picture of the spectrum per matvec matters.

    :param maxiter: Arnoldi steps m (the trial-space dimension).
    :param tol: certification threshold for CONVERGED status.
    :return: :class:`~krypy_tpu.functional.eigs.EigsResult`.
    """
    import numpy as _np

    from .eigs import EigsResult, _selection_key

    A_mv = as_matvec(A)
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
    dtype = jnp.dtype(base)
    real_dtype = jnp.zeros(0, dtype).real.dtype

    m = min(int(maxiter), N)
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > m:
        raise ValueError(f"k={k} needs maxiter >= k (have {m})")
    k_ortho = max(1, int(k_ortho))

    if sketch is None:
        sketch_dim = 8 * (m + 1) if sketch_dim is None else int(sketch_dim)
        sketch = kron_sketch(N, sketch_dim, seed=seed, dtype=real_dtype)
    d = sketch.d
    if d <= m:
        raise ValueError(
            f"sketch_dim (realized {d}) must exceed maxiter={m}"
        )

    A_c = cast_matvec(A_mv, dtype)
    v0 = v0.astype(dtype)
    v0 = v0 / jnp.linalg.norm(v0)
    tiny = breakdown_threshold(dtype)

    B0 = jnp.zeros((m + 1, N), dtype).at[0].set(v0)
    SB0 = jnp.zeros((m + 1, d), dtype).at[0].set(
        sketch_apply(sketch, v0).astype(dtype)
    )
    SW0 = jnp.zeros((m, d), dtype)

    def step(j, carry):
        B, SB, SW = carry
        z = lax.dynamic_slice(B, (j, 0), (1, N))[0]
        w = A_c(z)
        SW = SW.at[j].set(sketch_apply(sketch, w).astype(dtype))
        start = jnp.maximum(j - (k_ortho - 1), 0)
        W = lax.dynamic_slice(B, (start, 0), (k_ortho, N))
        h = W.conj() @ w
        u = w - jnp.tensordot(h, W, 1)
        nu = jnp.linalg.norm(u)
        wnorm = jnp.linalg.norm(w)
        row = jnp.where(
            nu <= tiny * wnorm, 0.0, u / jnp.where(nu > 0, nu, 1.0)
        )
        B = lax.dynamic_update_slice(B, row[None, :], (j + 1, 0))
        SB = SB.at[j + 1].set(sketch_apply(sketch, row).astype(dtype))
        return B, SB, SW

    B, SB, SW = lax.fori_loop(0, m, step, (B0, SB0, SW0))

    # whitening: truncated SVD of the sketched basis; exhausted (zero)
    # rows fall out as zero singular values
    U_s, sig, Vh_s = jnp.linalg.svd(SB[:m].T, full_matrices=False)
    sig_np = _np.asarray(sig)
    smax = max(float(sig_np[0]), float(jnp.finfo(real_dtype).tiny))
    r = int((sig_np > float(jnp.finfo(real_dtype).eps) ** 0.5 * smax).sum())
    r = max(r, 1)
    Ur = _np.asarray(U_s)[:, :r]
    Vr = _np.asarray(Vh_s).conj().T[:, :r]
    coords = Vr / sig_np[None, :r]  # (m, r): y = coords @ c
    M_small = Ur.conj().T @ _np.asarray(SW).T @ coords  # (r, r)

    ev, Y = _np.linalg.eig(M_small)
    order = _np.argsort(_selection_key(ev, which), kind="stable")
    sel = order[:k]
    theta = ev[sel]
    y = coords @ Y[:, sel]  # (m, k)

    X = jnp.tensordot(jnp.asarray(y.T), B[:m], 1).T  # (N, k), complex
    nrm = jnp.linalg.norm(X, axis=0)
    X = X / jnp.where(nrm > 0, nrm, 1.0)[None, :]
    if jnp.issubdtype(dtype, jnp.complexfloating):
        apply_col = A_c
    else:
        # real operator, complex Ritz vectors: apply to both parts
        def apply_col(c):
            return A_c(c.real) + 1j * A_c(c.imag)

    AX = jax.vmap(apply_col, 1, 1)(X)
    th = jnp.asarray(theta)
    pair_res = jnp.linalg.norm(AX - X * th[None, :], axis=0) / jnp.maximum(
        jnp.abs(th), jnp.asarray(tiny, real_dtype)
    )
    status = CONVERGED if bool(jnp.all(pair_res <= tol)) else MAXITER
    return EigsResult(
        theta=th,
        U=X,
        resnorms=_np.asarray([float(pair_res.max())]),
        niter=m,
        status=status,
        pair_resnorms=pair_res,
    )
