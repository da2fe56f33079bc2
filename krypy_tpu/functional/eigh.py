r"""Thick-restart Lanczos eigensolver for Hermitian operators.

Computes k extremal eigenpairs of a Hermitian :math:`A` with the
thick-restart Lanczos method (after Wu & Simon 2000): build an
m-dimensional Krylov basis, compress it to the l best Ritz pairs plus
the residual direction, and continue -- the compressed projected matrix
is an arrowhead that the generic full-reorthogonalization step extends
back to (numerically) Hermitian form automatically.

accelerator-native design decisions:

* the WHOLE solve -- every Lanczos sweep, every restart compression,
  every small eigendecomposition -- is one ``lax.while_loop``; a solve
  is a single XLA dispatch;
* full CGS2 reorthogonalization per step: two fused ``(m+1, N) x (N,)``
  contractions on the matrix units instead of the classic selective/partial
  schemes, whose data-dependent branching cannot be traced (and whose
  savings target memory-bound CPUs, not batched GEMM machines);
* the per-cycle (m, m) Hermitian eigendecomposition runs ON DEVICE with
  ``jnp.linalg.eigh`` (unlike the non-Hermitian cases, which go to host
  LAPACK by design -- docs/DESIGN.md section 7): it is needed INSIDE the
  compiled loop, and eigh runs on the device fine at these
  (replicated, small) sizes;
* the N axis of the basis shards over a mesh like every other
  functional core (the contractions become partial-dot + all-reduce).

The reference exposes Ritz extraction from existing solves
(krypy/utils.py:1380-1465) but no standalone eigensolver; this module is
accelerator-native extra surface with the same status-code contract as the
linear solvers.
"""

from typing import NamedTuple

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

__all__ = ["eigsh", "EigshResult"]


class EigshResult(NamedTuple):
    """Result pytree of :func:`eigsh`."""

    #: converged eigenvalue estimates, shape ``(k,)``, sorted by the
    #: selection criterion (``which``)
    theta: jnp.ndarray
    #: Ritz vectors as columns, shape ``(N, k)`` (the deflation-basis
    #: convention: pass directly as ``deflated_*(A, b, U=result.U)``)
    U: jnp.ndarray
    #: max relative residual of the k wanted pairs per restart cycle
    resnorms: jnp.ndarray
    #: total Lanczos steps (matvecs)
    niter: jnp.ndarray
    #: CONVERGED / MAXITER
    status: jnp.ndarray
    #: final per-pair residuals, shape ``(k,)`` -- the quantity whose
    #: max is ``resnorms[-1]``/``status``: Lanczos border residuals in
    #: general, pencil residuals for generalized problems, backward
    #: errors vs A for shift-invert.  Per-pair visibility matters for
    #: clustered/degenerate spectra, where one ill-conditioned member
    #: can lag the rest of its cluster.
    pair_resnorms: jnp.ndarray = None

    @property
    def converged(self):
        return self.status == CONVERGED


def lanczos_cgs2_sweep(
    A_mv, V, H, j0, m, dtype, real_dtype, B_mv=None, W=None
):
    """Full-reorthogonalization Lanczos steps j0..m-1 (CGS2; both passes
    accumulated into H's column, so H stays V^H A V).  A round-off-sized
    residual (invariant subspace found) deflates to a ZERO row instead
    of being normalized into a garbage direction.  Shared by
    :func:`eigsh` and :func:`~krypy_tpu.functional.funm.funm_krylov`.

    With ``B_mv``/``W`` (generalized eigenproblems) the sweep runs in
    the B-inner product: ``V`` is B-orthonormal, ``W = B V`` is the dual
    basis used for the projections, ``A_mv`` must apply the COMPOSITE
    operator :math:`B^{-1} A`, and the return value is ``(V, W, H)``
    with ``H = V^H A V`` (still Hermitian for Hermitian A).
    """
    brk = breakdown_threshold(dtype)
    row_idx = jnp.arange(m + 1)
    generalized = B_mv is not None

    def step(j, carry):
        if generalized:
            V, W, H = carry
            dual = W
        else:
            V, H = carry
            dual = V
        w = A_mv(V[j])
        mask = (row_idx <= j).astype(real_dtype)
        for _ in range(2):
            c = jnp.dot(dual.conj(), w) * mask
            w = w - jnp.dot(c, V)
            H = H.at[:, j].add(c)
        if generalized:
            Bw = B_mv(w)
            beta = jnp.sqrt(
                jnp.maximum(jnp.real(jnp.vdot(w, Bw)), 0.0)
            )
        else:
            beta = jnp.linalg.norm(w)
        alive = beta > brk * jnp.linalg.norm(H[:, j] * mask)
        live = jnp.where(alive, 1.0, 0.0)
        H = H.at[j + 1, j].set(
            jnp.where(alive, beta, 0.0).astype(dtype)
        )
        V = V.at[j + 1].set(live * w * safe_div(1.0, beta))
        if generalized:
            W = W.at[j + 1].set(live * Bw * safe_div(1.0, beta))
            return V, W, H
        return V, H

    if generalized:
        return lax.fori_loop(j0, m, step, (V, W, H))
    return lax.fori_loop(j0, m, step, (V, H))


def lanczos_1r_sweep(A_mv, V, H, j0, m, dtype, real_dtype):
    """One-reduce lagged DCGS-2 sweep: steps ``j0..m-1`` at exactly ONE
    all-reduce per step (round 5; classic :func:`lanczos_cgs2_sweep`
    pays 3 -- two projection passes + the norm).

    Same lagged scheme as the GMRES/Arnoldi ``ortho='cgs2_1r'`` lane
    (Swirydowicz et al. NLAA 2021, see
    :func:`krypy_tpu.functional.arnoldi._arnoldi_1r`): the candidate
    row ``j`` is stored UNNORMALIZED; one fused ``(m+1, N) x (N, 2)``
    contraction per step yields its reorthogonalization coefficients
    ``r = V^H u`` (the delayed second pass), its Pythagorean norm
    ``sigma^2 = <u,u> - ||r||^2``, and the first projection pass of the
    new direction ``w = A u``.  Because ``A`` hits the uncorrected
    candidate, the recorded column picks up the replicated lag
    correction ``g = H (r/sigma)`` -- ``H`` stays ``V^H A V`` exactly
    (in exact arithmetic), so the Ritz/arrowhead restart machinery is
    untouched.  The algebra never assumes Hermitian ``H``: the same
    sweep serves the non-Hermitian Arnoldi users
    (:mod:`~krypy_tpu.functional.eigs`).

    A peeled first projection (one reduce) opens the sweep and a
    seal contraction (one reduce, no matvec) closes the final candidate
    after the loop -- both OUTSIDE the loop body, so the per-step HLO
    pin is exactly 1 (tests/test_collectives_surface.py).  Deflation
    keeps the classic zero-row convention.  Standard (Euclidean,
    ``bs = 1``) pencils only; generalized/block sweeps stay on the
    classic scheme.
    """
    brk = breakdown_threshold(dtype)
    rows = V.shape[0]
    row_idx = jnp.arange(rows)

    # peeled step j0: first projection pass of A V[j0]
    w0 = A_mv(V[j0])
    c0 = jnp.dot(V.conj(), w0) * (row_idx <= j0).astype(real_dtype)
    H = H.at[:, j0].add(c0)
    V = V.at[j0 + 1].set(w0 - jnp.dot(c0, V))

    def step(j, carry):
        V, H = carry
        u = V[j]  # unnormalized, once-projected candidate
        w = A_mv(u)
        # THE one fused reduction of the step
        Z = jnp.dot(V.conj(), jnp.stack([u, w], axis=1))
        lt = row_idx < j
        r = jnp.where(lt, Z[:, 0], 0.0)
        s = jnp.real(Z[j, 0])
        c = jnp.where(lt, Z[:, 1], 0.0)
        t = Z[j, 1]

        sig2 = jnp.maximum(s - jnp.sum(jnp.abs(r) ** 2), 0.0)
        sigma = jnp.sqrt(sig2).astype(real_dtype)

        # complete column j-1: delayed reorthogonalization + subdiag
        completed = H[:, j - 1] + r
        alive = sigma > brk * jnp.linalg.norm(completed)
        live = jnp.where(alive, 1.0, 0.0)
        H = H.at[:, j - 1].set(completed).at[j, j - 1].set(
            jnp.where(alive, sigma, 0.0).astype(dtype)
        )
        inv_s = live * safe_div(1.0, sigma)
        V = V.at[j].set((u - jnp.dot(r, V)) * inv_s)

        # first-pass column j with the lag correction g = H (r/sigma)
        # (rt truncated to H's column count: callers pass square
        # (m+1, m+1) or rectangular (m+1, m) buffers; rows >= j are
        # zero either way)
        rt = r * inv_s
        g = jnp.dot(H, rt[: H.shape[1]])
        tk = (t - jnp.vdot(r, c)) * inv_s * inv_s
        chat = jnp.where(row_idx == j, tk, c * inv_s)
        V = V.at[j + 1].set(w * inv_s - jnp.dot(chat, V))
        H = H.at[:, j].add(chat - g)
        return V, H

    V, H = lax.fori_loop(j0 + 1, m, step, (V, H))

    # seal the final candidate (one reduce, no matvec): delayed second
    # pass + Pythagorean norm of row m
    u = V[m]
    Zs = jnp.dot(V.conj(), u)
    r = jnp.where(row_idx < m, Zs, 0.0)
    s = jnp.real(Zs[m])
    sig2 = jnp.maximum(s - jnp.sum(jnp.abs(r) ** 2), 0.0)
    sigma = jnp.sqrt(sig2).astype(real_dtype)
    completed = H[:, m - 1] + r
    alive = sigma > brk * jnp.linalg.norm(completed)
    live = jnp.where(alive, 1.0, 0.0)
    H = H.at[:, m - 1].set(completed).at[m, m - 1].set(
        jnp.where(alive, sigma, 0.0).astype(dtype)
    )
    V = V.at[m].set(
        (u - jnp.dot(r, V)) * live * safe_div(1.0, sigma)
    )
    return V, H


def spurious_ritz_mask(V_rows, S):
    """Identify eigenpairs of the projected matrix living in the DEAD
    block left by sweep deflation (their eigenvalues are exactly 0 and
    would pollute smallest-eigenvalue selection / diverge under
    functions singular at 0): an eigenvector whose mass sits on rows
    whose basis vector vanished is spurious."""
    live_row = jnp.sum(jnp.abs(V_rows) ** 2, axis=1) > 0
    dead_mass = jnp.sum(
        jnp.abs(S) ** 2 * (~live_row)[:, None].astype(S.real.dtype),
        axis=0,
    )
    return dead_mass > 0.5


def _selection_key(theta, which):
    if which == "sa":
        return theta
    if which == "la":
        return -theta
    if which == "lm":
        return -jnp.abs(theta)
    if which == "sm":
        return jnp.abs(theta)
    raise ValueError(f"unknown which={which!r}")


def eigsh(
    A,
    k=6,
    *,
    v0=None,
    n=None,
    which="sa",
    maxdim=None,
    thick=None,
    tol=1e-8,
    max_restarts=200,
    sigma=None,
    inv=None,
    B=None,
    Binv=None,
    block_size=1,
    ortho="cgs2",
):
    r"""k extremal eigenpairs of Hermitian ``A`` by thick-restart
    Lanczos, as one compiled while_loop.

    :param A: Hermitian operator (matvec / matrix / LinearOperator).
    :param k: number of wanted pairs.
    :param v0: starting vector; defaults to a fixed quasi-random vector
      (deterministic -- no RNG inside traced code).
    :param n: problem size when ``A`` has no ``.shape`` and no ``v0``.
    :param which: ``'sa'`` (smallest algebraic, default), ``'la'``
      (largest algebraic), ``'lm'``/``'sm'`` (largest/smallest
      magnitude; note plain Lanczos converges slowly to interior
      eigenvalues -- no shift-invert here).
    :param maxdim: Krylov dimension m per cycle (default
      ``min(N, max(2k + 8, 24))``).
    :param thick: Ritz pairs kept at each restart (default
      ``min(2k, maxdim - 2)``) -- the "thick" in thick-restart.
    :param tol: per-pair convergence test
      :math:`|\beta_m s_{m,i}| \le \mathrm{tol}\cdot\max(|\theta_i|,
      \epsilon)` for all k wanted pairs.
    :param sigma: shift-invert target: find the k eigenvalues NEAREST
      ``sigma`` by running Lanczos on :math:`(A - \sigma I)^{-1}` --
      the practical route to interior eigenvalues, where plain Lanczos
      crawls.  Requires ``inv``.
    :param inv: jittable matvec applying :math:`(A - \sigma I)^{-1}`
      (e.g. a closure over :func:`~krypy_tpu.functional.cg.cg` /
      :func:`~krypy_tpu.functional.minres.minres` with a tight inner
      tolerance -- the WHOLE inner-outer eigensolve then still traces
      into one compiled program).  The inner solves must be accurate
      (rel. residual well below ``tol``), or the Lanczos recurrence on
      the inexact operator loses Hermitian structure; this is the
      standard inexact-shift-invert caveat, not a device artifact.  With
      ``sigma``, ``which`` is ignored (nearest-``sigma`` selection) and
      the k pairs are VERIFIED against ``A`` itself: the returned
      ``resnorms[-1]``/``status`` reflect true BACKWARD errors
      :math:`\|A u - \lambda u\| / (\|A\|\,\|u\|)` with :math:`\|A\|`
      power-iteration-estimated (normalizing by :math:`|\lambda|` would
      demand :math:`\kappa(A)\,\epsilon` accuracy for smallest pairs --
      unattainable at f32 by any algorithm; ARPACK/scipy certify in the
      inverted space and never re-check against ``A`` at all).
    :param B,Binv: GENERALIZED eigenproblem :math:`A x = \lambda B x`
      with SPD ``B``: Lanczos runs in the B-inner product on
      :math:`B^{-1} A` (both operators required; one B and one
      :math:`B^{-1}` application per step on top of A).  The returned
      ``U`` columns are B-orthonormal, and the k pairs are VERIFIED
      against the pencil itself:
      :math:`\|A u - \lambda B u\| / (|\lambda|\,\|B u\|)`.
      COMBINABLE with ``sigma``: pass ``inv=`` applying
      :math:`(A - \sigma B)^{-1}` and Lanczos runs on the spectral
      transform :math:`(A-\sigma B)^{-1} B` (self-adjoint in the same
      B-inner product), returning the k pencil eigenvalues nearest
      ``sigma``; ``Binv`` is then unused and optional, and the pairs
      are verified against the pencil with the backward error
      :math:`\|Au-\lambda Bu\|/((\|A\|+|\lambda|\|B\|)\|u\|)`.
    :param block_size: advance this many Lanczos vectors per step
      (block thick-restart Lanczos).  Single-vector Lanczos converges
      one member of a DEGENERATE/clustered eigenvalue at a time (in
      exact arithmetic never more than one); a block of size >= the
      cluster multiplicity captures the whole cluster per cycle -- e.g.
      the square Laplacian's degenerate pairs need ``block_size=2``.
      Each block step runs one global CGS2 projection (two ``(m+bs, N)
      x (N, bs)`` contractions -- the same HBM sweeps as ``bs``
      single steps but with ``bs``-fold wider, better-shaped GEMM
      operands) followed by a two-pass intra-block MGS whose round-off
      rows deflate to zero (cluster exhausted).  Combinable with
      ``sigma``/``inv``; not with ``B`` (generalized pencils are
      single-vector only for now).
    :param ortho: ``"cgs2"`` (default: full two-pass CGS2, 3
      all-reduces per Lanczos step) or ``"cgs2_1r"`` (round 5: the
      lagged DCGS-2 sweep at exactly ONE all-reduce per step, see
      :func:`lanczos_1r_sweep`; same dmgs stability class).
      ``"cgs2_1r"`` requires ``block_size=1`` and no ``B=``.
    :return: :class:`EigshResult`.
    """
    A_mv = as_matvec(A)
    shift_invert = sigma is not None
    generalized = B is not None or Binv is not None
    if generalized:
        if B is None or (Binv is None and not shift_invert):
            raise ValueError(
                "generalized mode needs BOTH B= and Binv= (Binv is "
                "unused -- optional -- under sigma= shift-invert)"
            )
        B_mv = as_matvec(B)
        pencil_A_mv = A_mv
        if not shift_invert:
            Binv_mv = as_matvec(Binv)
            A_mv = lambda v: Binv_mv(pencil_A_mv(v))
    if shift_invert:
        if inv is None:
            raise ValueError(
                "sigma= (shift-invert) requires inv=, a matvec applying "
                "(A - sigma I)^{-1} (or (A - sigma B)^{-1} with B=)"
            )
        orig_A_mv = A_mv
        inv_mv = as_matvec(inv)
        if generalized:
            # spectral transform of the pencil: Lanczos on
            # C = (A - sigma B)^{-1} B, self-adjoint in the B-inner
            # product that the generalized lane already maintains;
            # eigenvalues nu = 1/(lambda - sigma)
            A_mv = lambda v: inv_mv(B_mv(v))
        else:
            A_mv = inv_mv
        which = "lm"  # largest of the inverted spectrum = nearest sigma
    if v0 is not None:
        v0 = jnp.asarray(v0).reshape(-1)
        N = v0.shape[0]
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or v0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        # deterministic quasi-random start: dense in every eigenbasis
        # direction with overwhelming probability, no RNG in traced code
        v0 = jnp.cos(jnp.arange(N) * 0.7391) + 0.01
        # the operator's dtype must win over the (real) default start:
        # cast_matvec pins everything to the system dtype, so a real v0
        # against a complex A would silently project the operator onto
        # its REAL part and converge on the wrong problem (complex
        # CALLABLES, whose dtype cannot be probed, need a complex v0=)
        op_dt = None
        if hasattr(A, "ndim"):
            op_dt = jnp.asarray(A).dtype
        elif hasattr(A, "dtype"):
            op_dt = jnp.dtype(A.dtype)
        if op_dt is not None and jnp.issubdtype(
            op_dt, jnp.complexfloating
        ):
            v0 = v0.astype(op_dt)

    dtype = system_dtype(v0)
    if not jnp.issubdtype(dtype, jnp.floating) and not jnp.issubdtype(
        dtype, jnp.complexfloating
    ):
        dtype = jnp.zeros(0).dtype  # default float
    v0 = v0.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    if shift_invert:
        orig_A_mv = cast_matvec(orig_A_mv, dtype)
    if generalized:
        B_mv = cast_matvec(B_mv, dtype)
        pencil_A_mv = cast_matvec(pencil_A_mv, dtype)
    else:
        B_mv = None
    real_dtype = jnp.zeros(0, dtype).real.dtype

    k = int(k)
    bs = int(block_size)
    if bs < 1:
        raise ValueError(f"block_size must be >= 1, got {bs}")
    if bs > 1 and generalized:
        raise ValueError(
            "block_size > 1 is not supported with generalized pencils; "
            "for clustered/degenerate generalized problems use "
            "functional.lobpcg(A, k, B=...), whose block width covers "
            "clusters natively (and needs no Binv)"
        )

    m = (
        min(N, max(2 * k + 8, 24))
        if maxdim is None
        else min(int(maxdim), N)
    )
    if bs > 1:
        # block-aligned cycle dimension (the sweep advances bs rows at
        # a time from the block-aligned restart point)
        m = max((m // bs) * bs, 2 * bs)
    if k >= m - 1:
        raise ValueError(f"k={k} needs maxdim > k + 1 (have {m})")
    l = min(2 * k, m - 2) if thick is None else min(int(thick), m - 2)
    l = max(l, k)
    if bs > 1:
        l = min(-(-l // bs) * bs, m - bs)

    eps_floor = jnp.asarray(
        jnp.finfo(real_dtype).tiny ** 0.5, real_dtype
    )

    brk = breakdown_threshold(dtype)

    def block_cgs2_sweep(V, H, j0):
        """Block Lanczos steps j0, j0+bs, ..., m-bs: one global CGS2
        projection of the bs-wide block per step (two (m+bs, N) x
        (N, bs) contractions), then a two-pass intra-block MGS whose
        round-off rows deflate to ZERO rows (same convention as the
        single-vector sweep: an exhausted cluster direction must not be
        normalized into garbage)."""
        row_idx_b = jnp.arange(m + bs)

        def step(t, carry):
            V, H = carry
            j = j0 + t * bs
            Vblk = lax.dynamic_slice_in_dim(V, j, bs, 0)
            Wblk = jnp.stack([A_mv(Vblk[i]) for i in range(bs)])
            mask = (row_idx_b < j + bs).astype(real_dtype)
            Cacc = jnp.zeros((m + bs, bs), dtype)
            for _ in range(2):
                C = (jnp.dot(V.conj(), Wblk.T) * mask[:, None]).astype(
                    dtype
                )
                Wblk = Wblk - jnp.dot(C.T, V)
                Cacc = Cacc + C
            seg = lax.dynamic_slice(H, (0, j), (m + bs, bs))
            H = lax.dynamic_update_slice(H, seg + Cacc, (0, j))

            qs = []
            Rblk = jnp.zeros((bs, bs), dtype)
            for i in range(bs):
                w = Wblk[i]
                for _ in range(2):
                    for p in range(i):
                        c = jnp.vdot(qs[p], w)
                        w = w - c * qs[p]
                        Rblk = Rblk.at[p, i].add(c.astype(dtype))
                nrm = jnp.linalg.norm(w)
                scale = jnp.sqrt(
                    jnp.sum(jnp.abs(Cacc[:, i]) ** 2)
                    + jnp.sum(jnp.abs(Rblk[:i, i]) ** 2)
                )
                alive = nrm > brk * scale
                live = jnp.where(alive, 1.0, 0.0)
                Rblk = Rblk.at[i, i].set(
                    jnp.where(alive, nrm, 0.0).astype(dtype)
                )
                qs.append(live * w * safe_div(1.0, nrm))
            Q = jnp.stack(qs).astype(dtype)
            V = lax.dynamic_update_slice(V, Q, (j + bs, 0))
            seg2 = lax.dynamic_slice(H, (j + bs, j), (bs, bs))
            H = lax.dynamic_update_slice(H, seg2 + Rblk, (j + bs, j))
            return V, H

        return lax.fori_loop(0, (m - j0) // bs, step, (V, H))

    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown eigsh ortho {ortho!r}")
    if ortho == "cgs2_1r" and (bs > 1 or generalized):
        raise ValueError(
            "ortho='cgs2_1r' supports the standard single-vector sweep "
            "only (block_size=1, no B=); the block/generalized sweeps "
            "stay on classic cgs2"
        )

    def lanczos_sweep(V, W, H, j0):
        """Sweep wrapper carrying the dual basis W (dummy (0,0) array
        in the standard case so the loop state keeps one static
        structure)."""
        if generalized:
            return lanczos_cgs2_sweep(
                A_mv, V, H, j0, m, dtype, real_dtype, B_mv=B_mv, W=W
            )
        if bs > 1:
            V, H = block_cgs2_sweep(V, H, j0)
            return V, W, H
        if ortho == "cgs2_1r":
            V, H = lanczos_1r_sweep(
                A_mv, V, H, j0, m, dtype, real_dtype
            )
            return V, W, H
        V, H = lanczos_cgs2_sweep(
            A_mv, V, H, j0, m, dtype, real_dtype
        )
        return V, W, H

    def ritz(V, H):
        """Device eigh of the Hermitian projection + selection.
        Eigenpairs of the dead (deflated) block sort LAST -- their
        exact-zero eigenvalues would otherwise win smallest-eigenvalue
        selection and report zero eigenpairs as converged."""
        Hm = H[:m, :m]
        Hm = 0.5 * (Hm + Hm.conj().T)
        theta, S = jnp.linalg.eigh(Hm)
        spurious = spurious_ritz_mask(V[:m], S)
        key = jnp.where(
            spurious, jnp.inf, _selection_key(theta, which)
        )
        order = jnp.argsort(key)
        return theta[order], S[:, order], spurious[order]

    if generalized:
        Bv0 = B_mv(v0)
        beta0 = jnp.sqrt(
            jnp.maximum(jnp.real(jnp.vdot(v0, Bv0)), 0.0)
        )
        W0 = jnp.zeros((m + bs, N), dtype).at[0].set(
            Bv0 * safe_div(1.0, beta0)
        )
    else:
        beta0 = jnp.linalg.norm(v0)
        W0 = jnp.zeros((0, 0), dtype)
    V0 = jnp.zeros((m + bs, N), dtype).at[0].set(
        v0 * safe_div(1.0, beta0)
    )
    if bs > 1:
        # fill the starting block with orthonormalized deterministic
        # quasi-random directions (same no-RNG rationale as v0)
        for i in range(1, bs):
            u = (
                jnp.cos(jnp.arange(N) * (0.7391 + 0.1137 * i))
                + 0.01 * (i + 1)
            ).astype(dtype)
            for _ in range(2):
                c = jnp.dot(V0[:i].conj(), u)
                u = u - jnp.dot(c, V0[:i])
            V0 = V0.at[i].set(u * safe_div(1.0, jnp.linalg.norm(u)))
    H0 = jnp.zeros((m + bs, m + bs), dtype)
    V1, W1, H1 = lanczos_sweep(V0, W0, H0, 0)

    class_resnorms = jnp.full(max_restarts + 1, jnp.nan, real_dtype)

    def cycle_stats(H, theta, S, spurious):
        # border block of the blocked relation A V_m = V_m H_m + Q Bord:
        # per-pair residual norm ||Bord S[:, i]|| (for bs = 1 this is
        # the classic |beta_m s_{m,i}|)
        Bord = H[m : m + bs, :m]
        BS = jnp.dot(Bord, S)                        # (bs, m) borders
        res = jnp.sqrt(jnp.sum(jnp.abs(BS[:, :k]) ** 2, axis=0))
        res = res / jnp.maximum(jnp.abs(theta[:k]), eps_floor)
        # a spurious pair among the k wanted means the reachable
        # invariant subspace has dimension < k: it can never converge,
        # so its residual is pinned at +inf (honest MAXITER)
        res = jnp.where(spurious[:k], jnp.inf, res)
        return BS, res, jnp.max(res)

    def body(state):
        V, W, H, cycles, niter, resnorms, _ = state
        theta, S, spurious = ritz(V, H)
        b, _, wres = cycle_stats(H, theta, S, spurious)
        resnorms = resnorms.at[cycles].set(wres)
        conv = wres <= tol

        def compress(_):
            Sl = S[:, :l]                            # (m, l)
            Y = jnp.dot(Sl.T, V[:m])                 # (l, N)
            Vn = (
                jnp.zeros_like(V)
                .at[:l].set(Y)
                .at[l : l + bs].set(V[m : m + bs])   # residual block
            )
            if generalized:
                # the dual basis transforms linearly: B Y = Sl^T (B V)
                Wn = (
                    jnp.zeros_like(W)
                    .at[:l].set(jnp.dot(Sl.T, W[:m]))
                    .at[l : l + bs].set(W[m : m + bs])
                )
            else:
                Wn = W
            bl = b[:, :l].astype(dtype)              # (bs, l) border
            diag = jnp.zeros(m + bs, dtype).at[:l].set(
                theta[:l].astype(dtype)
            )
            # arrowhead: diag(theta_l) + border rows only -- the first
            # sweep step (j = l) recomputes the column border as its
            # CGS2 coefficients <y_i, A vhat> and accumulates it into
            # H[:, l] itself (pre-setting it here would double-count)
            Hn = jnp.zeros_like(H) + jnp.diag(diag)
            Hn = Hn.at[l : l + bs, :l].set(bl)
            return lanczos_sweep(Vn, Wn, Hn, l)

        def keep(_):
            return V, W, H

        Vn, Wn, Hn = lax.cond(conv, keep, compress, 0)
        steps = jnp.where(conv, 0, m - l)
        return (
            Vn, Wn, Hn, cycles + 1, niter + steps, resnorms, conv,
        )

    def cond(state):
        _, _, _, cycles, _, _, conv = state
        return (~conv) & (cycles < max_restarts)

    init = (
        V1, W1, H1, jnp.asarray(0), jnp.asarray(m), class_resnorms,
        jnp.asarray(False),
    )
    V, W, H, cycles, niter, resnorms, conv = lax.while_loop(
        cond, body, init
    )

    # final extraction (also records the last cycle's residual when the
    # loop exited on max_restarts without a final body call)
    theta, S, spurious = ritz(V, H)
    _, pair_res, wres = cycle_stats(H, theta, S, spurious)
    U = jnp.dot(S[:, :k].T, V[:m]).T                  # (N, k)
    theta_k = theta[:k]

    def _opnorm(mv):
        """8-step power-iteration ||.||_2 estimate (deterministic
        quasi-random start; shared by both shift-invert verifications).
        Underestimates slightly for clustered tops, which only makes
        the backward-error criterion stricter."""
        z = (jnp.cos(jnp.arange(N) * 0.3571) + 0.01).astype(dtype)
        z = z * safe_div(1.0, jnp.linalg.norm(z))

        def _pw(i, zz):
            w = mv(zz)
            return w * safe_div(1.0, jnp.linalg.norm(w))

        z = lax.fori_loop(0, 8, _pw, z)
        return jnp.linalg.norm(mv(z)).astype(real_dtype)

    if generalized and shift_invert:
        # back-transform lambda = sigma + 1/nu and verify against the
        # PENCIL with a backward-error normalization (same rationale as
        # the standard shift-invert branch below: |lambda|-relative
        # residuals are unattainable for small pairs at f32):
        # ||A u - lam B u|| / ((||A|| + |lam| ||B||) ||u||), with both
        # operator norms power-iteration-estimated.
        lam = jnp.asarray(sigma, real_dtype) + 1.0 / theta_k
        AU = jnp.stack(
            [pencil_A_mv(U[:, i]) for i in range(k)], axis=1
        )
        BU = jnp.stack([B_mv(U[:, i]) for i in range(k)], axis=1)

        anorm = _opnorm(pencil_A_mv)
        bnorm = _opnorm(B_mv)
        unorms = jnp.linalg.norm(U, axis=0)
        res = jnp.linalg.norm(
            AU - BU * lam[None, :].astype(dtype), axis=0
        ) / jnp.maximum(
            (anorm + jnp.abs(lam) * bnorm) * unorms, eps_floor
        )
        pair_res = res
        wres = jnp.max(res)
        theta_k = lam
    elif generalized:
        # verify against the PENCIL: ||A u - theta B u||/(|theta| ||B u||)
        AU = jnp.stack(
            [pencil_A_mv(U[:, i]) for i in range(k)], axis=1
        )
        BU = jnp.stack([B_mv(U[:, i]) for i in range(k)], axis=1)
        res = jnp.stack([
            jnp.linalg.norm(
                AU[:, i] - theta_k[i].astype(dtype) * BU[:, i]
            )
            / jnp.maximum(
                jnp.abs(theta_k[i]) * jnp.linalg.norm(BU[:, i]),
                eps_floor,
            )
            for i in range(k)
        ])
        pair_res = res
        wres = jnp.max(res)
    elif shift_invert:
        # back-transform and VERIFY against A itself (the loop's
        # residuals were for the inverted operator; inexact inner
        # solves make them optimistic).  The verification metric is the
        # BACKWARD ERROR ||A u - lam u|| / (||A|| ||u||): normalizing by
        # |lam| instead would demand kappa(A)*eps accuracy for the
        # smallest eigenpairs -- unattainable at f32 by ANY algorithm,
        # because roundoff components along the top of the spectrum are
        # amplified by ||A|| in the residual (ARPACK/scipy do not even
        # re-verify against A; they certify in the inverted space).
        # ||A|| is estimated by a short power iteration (underestimates
        # slightly for clustered tops, which only makes the criterion
        # stricter).
        lam = jnp.asarray(sigma, real_dtype) + 1.0 / theta_k
        AU = jnp.stack(
            [orig_A_mv(U[:, i]) for i in range(k)], axis=1
        )
        anorm = _opnorm(orig_A_mv)
        unorms = jnp.linalg.norm(U, axis=0)
        res = jnp.linalg.norm(
            AU - U * lam[None, :].astype(dtype), axis=0
        ) / jnp.maximum(anorm * unorms, eps_floor)
        pair_res = res
        wres = jnp.max(res)
        theta_k = lam
    resnorms = resnorms.at[jnp.minimum(cycles, max_restarts)].set(wres)
    status = jnp.where(wres <= tol, CONVERGED, MAXITER)
    return EigshResult(
        theta=theta_k,
        U=U,
        resnorms=resnorms,
        niter=niter,
        status=status,
        pair_resnorms=pair_res,
    )
