r"""LOBPCG: locally optimal block preconditioned conjugate gradient.

Computes the k algebraically smallest (or largest) eigenpairs of a
Hermitian :math:`A` -- or of the Hermitian-definite pencil
:math:`A x = \lambda B x` -- with the LOBPCG method (Knyazev 2001),
in the basis-orthonormalized ("ortho") variant of Hetmaniuk & Lehoucq /
Duersch et al. 2018, which trades extra block GEMMs for robustness of
the Rayleigh-Ritz step.

This is the natural accelerator eigensolver shape and the deliberate complement
to :func:`~krypy_tpu.functional.eigh.eigsh`:

* **every** operation is a block GEMM on ``(3k, N)`` panels -- matvecs,
  projections, panel factorizations, Rayleigh-Ritz assembly all map
  straight onto the matrix units with k-fold wider operands than Lanczos;
* unlike shift-invert Lanczos it needs **no inner solves** -- only one
  application of A (and of the preconditioner / B) per wanted pair per
  iteration, so interior accuracy comes from the preconditioner
  (e.g. multigrid) instead of nested Krylov loops;
* the whole solve is one ``lax.while_loop`` -- a single XLA dispatch --
  with fixed-shape ``(k, N)`` row-major blocks (the functional-lane
  convention) that shard over a mesh like every other core: the Gram
  contractions become partial dots + one all-reduce each.

Robustness choices (all measured conventions shared with the rest of
the lane):

* the trial basis ``S = [X; W; P]`` is kept (approximately)
  B-orthonormal by construction -- W and P are CGS2-projected against X
  and jointly factorized by two-pass **SVQB** (Stathopoulos & Wu 2002;
  eigh-based, NaN-free on rank-deficient panels), so the Rayleigh-Ritz
  problem is an ordinary Hermitian ``eigh`` on the device;
* directions that die (converged/rank-deficient rows) deflate to ZERO
  rows; Ritz pairs of the dead block are pushed to the end of the
  selection by the same spurious-pair mask as ``eigsh``;
* soft locking: residual rows of already-converged pairs are zeroed
  before preconditioning, which removes their (noise-level) search
  directions from the trial space without dynamic shapes.

The reference exposes no eigensolver at all (only Ritz extraction from
existing solves, krypy/utils.py:1380-1465); this module is accelerator-native
extra surface with the same status-code contract as the linear solvers.
"""

from typing import NamedTuple

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
from .eigh import spurious_ritz_mask

__all__ = ["lobpcg", "LobpcgResult"]


class LobpcgResult(NamedTuple):
    """Result pytree of :func:`lobpcg`."""

    #: eigenvalue estimates, shape ``(k,)``, sorted by ``which``
    theta: jnp.ndarray
    #: Ritz vectors as columns, shape ``(N, k)``, B-orthonormal (the
    #: deflation-basis convention, like :class:`EigshResult.U`)
    U: jnp.ndarray
    #: max relative residual of the k pairs per iteration
    resnorms: jnp.ndarray
    #: Rayleigh-Ritz iterations performed (each costs k applications of
    #: A, of B and of the preconditioner)
    niter: jnp.ndarray
    #: CONVERGED / MAXITER
    status: jnp.ndarray
    #: final per-pair relative residuals, shape ``(k,)``
    pair_resnorms: jnp.ndarray = None

    @property
    def converged(self):
        return self.status == CONVERGED


def _block_apply(mv):
    """Lift a matvec to ``(j, N)`` row blocks via vmap (a matrix matvec
    becomes one GEMM; traced callables batch their stencil ops)."""
    return jax.vmap(mv)


def _selection_key(theta, which):
    if which == "sa":
        return theta
    if which == "la":
        return -theta
    raise ValueError(
        f"which={which!r}: LOBPCG finds extremal pairs only "
        "('sa'/'la'); for interior eigenvalues use eigsh(sigma=...)"
    )


def lobpcg(
    A,
    k=6,
    *,
    X0=None,
    n=None,
    B=None,
    M=None,
    which="sa",
    tol=1e-8,
    maxiter=500,
    lock=True,
    criterion="rel",
    variant="classic",
):
    r"""k extremal eigenpairs of Hermitian ``A`` (or of the pencil
    ``(A, B)`` with SPD ``B``) by preconditioned LOBPCG, as one
    compiled while_loop.

    :param A: Hermitian operator (matvec / matrix / LinearOperator).
    :param k: number of wanted pairs.  The trial space has ``3k``
      directions; a block at least as wide as the largest eigenvalue
      cluster captures the whole cluster at once (degenerate pairs need
      no special handling, unlike single-vector Lanczos).
    :param X0: starting block, shape ``(N, k)`` columns (the
      deflation-basis convention); defaults to a deterministic
      quasi-random block (no RNG inside traced code).
    :param n: problem size when ``A`` has no ``.shape`` and no ``X0``.
    :param B: SPD operator of the generalized problem
      :math:`A x = \lambda B x`.  Unlike ``eigsh(B=...)`` no
      :math:`B^{-1}` is needed -- LOBPCG only ever applies B.
    :param M: preconditioner applied to residuals, an approximation of
      :math:`A^{-1}` (SPD).  This is where the convergence rate comes
      from: with a multigrid V-cycle the iteration count is
      grid-size-independent.
    :param which: ``'sa'`` (smallest algebraic, default) or ``'la'``.
    :param tol: per-pair convergence test
      :math:`\|A u - \theta B u\| \le \mathrm{tol} \cdot
      \max(|\theta| \|B u\|, \epsilon)` (with ``B = I`` and
      :math:`\|u\|_B = 1` this is the classic
      :math:`\|r\| / |\theta|` test, matching ``eigsh``).
    :param maxiter: Rayleigh-Ritz iterations.
    :param lock: soft-lock converged pairs (zero their residual rows
      before preconditioning); keeps the trial Gram well conditioned
      once part of the block has converged.
    :param criterion: convergence metric.  ``'rel'`` (default) is the
      :math:`|\theta|`-relative test above, matching ``eigsh``.
      ``'backward'`` uses the BACKWARD error
      :math:`\|A u - \theta B u\| / ((\|A\| + |\theta| \|B\|) \|u\|)`
      with the operator norms power-iteration-estimated once at setup
      -- the right metric for the SMALLEST pairs of ill-conditioned
      operators at float32, where a :math:`|\theta|`-relative residual
      would demand :math:`\kappa(A)\,\epsilon` accuracy no algorithm
      can attain (same rationale as ``eigsh``'s shift-invert
      certification).
    :param variant: ``"classic"`` (10 all-reduces per block iteration:
      per-stage Grams, projections, row norms) or ``"fused"`` (round 5,
      VERDICT r4 #5): the whole advance runs on THREE stacked
      cross-Grams -- (i) projection pass 1 + the pre-projection row
      norms, (ii) projection pass 2 + the SVQB pass-1 Gram via the
      expansion :math:`G_1 = G_{p1} - C_2^H C_2` (X is B-orthonormal),
      (iii) the SVQB pass-2 Gram + the Rayleigh-Ritz blocks, with the
      pass-2 row transform applied to the SMALL matrices -- so one
      block iteration costs 4 sync points (3 + the residual check)
      instead of 10, amortized 4/k per pair.  The kill-tiny-row and
      spurious-Ritz rules fold into the SVQB alive masks (no separate
      norm reductions).  Standard problems only (``B=None``);
      ``"auto"`` picks ``"fused"`` under a multi-device mesh context.
    :return: :class:`LobpcgResult`.
    """
    if criterion not in ("rel", "backward"):
        raise ValueError(
            f"criterion={criterion!r}: expected 'rel' or 'backward'"
        )
    if variant == "auto":
        from ..parallel import active_mesh_size

        variant = (
            "fused" if active_mesh_size() > 1 and B is None else "classic"
        )
    if variant not in ("classic", "fused"):
        raise ValueError(f"unknown lobpcg variant {variant!r}")
    if variant == "fused" and B is not None:
        raise ValueError(
            "variant='fused' supports standard problems only (B=None); "
            "use variant='classic' for the generalized pencil"
        )
    fused = variant == "fused"
    A_mv = as_matvec(A)
    generalized = B is not None
    B_mv = as_matvec(B) if generalized else None
    M_mv = as_matvec(M)

    if X0 is not None:
        X0 = jnp.asarray(X0)
        if X0.ndim != 2:
            raise ValueError(f"X0 must be (N, k), got shape {X0.shape}")
        N = int(X0.shape[0])
        k = int(X0.shape[1])
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or X0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if 3 * k > N:
        raise ValueError(
            f"trial space needs 3k <= N (k={k}, N={N}); "
            "use a dense eigensolver at this size"
        )

    if X0 is None:
        # deterministic quasi-random block: dense in every eigenbasis
        # direction with overwhelming probability, no RNG in traced code
        idx = jnp.arange(N)
        X0 = jnp.stack(
            [
                jnp.cos(idx * (0.7391 + 0.1137 * i)) + 0.01 * (i + 1)
                for i in range(k)
            ],
            axis=1,
        )
        # the operator's dtype must win over the (real) default start:
        # cast_matvec pins everything to the system dtype, so a real
        # X0 against a complex A would silently project the operator
        # onto its REAL part and converge on the wrong problem.
        # Matrices/arrays carry their dtype; complex CALLABLES (whose
        # dtype cannot be probed without an application) need a complex
        # X0= -- documented in the docstring.
        op_dt = None
        if hasattr(A, "ndim"):
            op_dt = jnp.asarray(A).dtype
        elif hasattr(A, "dtype"):
            op_dt = jnp.dtype(A.dtype)
        if op_dt is not None and jnp.issubdtype(
            op_dt, jnp.complexfloating
        ):
            X0 = X0.astype(op_dt)

    dtype = system_dtype(X0)
    if not jnp.issubdtype(dtype, jnp.floating) and not jnp.issubdtype(
        dtype, jnp.complexfloating
    ):
        dtype = jnp.zeros(0).dtype  # default float
    real_dtype = jnp.zeros(0, dtype).real.dtype
    X = X0.T.astype(dtype)  # (k, N) rows -- functional-lane convention

    A_mv = cast_matvec(A_mv, dtype)
    A_blk = _block_apply(A_mv)
    if generalized:
        B_mv = cast_matvec(B_mv, dtype)
        B_blk = _block_apply(B_mv)
    if M_mv is not None:
        M_mv = cast_matvec(M_mv, dtype)
        M_blk = _block_apply(M_mv)

    _selection_key(jnp.zeros(1, real_dtype), which)  # validate early

    brk = breakdown_threshold(dtype)
    eps_floor = jnp.asarray(jnp.finfo(real_dtype).tiny ** 0.5, real_dtype)
    dummy = jnp.zeros((0, 0), dtype)

    def bx_of(Xr, BXr):
        return BXr if generalized else Xr

    def _b_svqb2(Z, AZ, BZ):
        """Two-pass SVQB (Stathopoulos & Wu 2002) of the rows of Z in
        the B-inner product; the (small dense) row transform is applied
        to the carried A- and B-images as well, so no operator
        re-application is needed.

        Two deflation rules, both to exact ZERO rows:

        * rows whose Gram diagonal is negligible against the panel
          (``d_i <= 64 eps mean(d)``) leave the trial space first --
          this is the converged-pair failure mode of textbook LOBPCG
          (locked pairs' conjugate directions decay to rounding level;
          a tiny live row would yield a junk near-zero Ritz value that
          smallest-algebraic selection picks up);
        * eigenvalues of the diagonally-scaled Gram at/below
          ``j eps lambda_max`` are dropped inside the factorization
          (rank-deficient directions).

        SVQB (an eigh of the scaled Gram) rather than shifted CholQR:
        the f32 Gram of a (j, N=1e6) panel carries ~sqrt(N) eps ~ 1e-4
        relative dot-product noise -- far above any O(eps)-shifted
        Cholesky's guard -- and a multigrid-preconditioned residual
        block is nearly rank-1 (all rows map toward the smooth error),
        so the shifted factor can go indefinite -> NaN under one
        accumulation order while another rounds the same Gram PSD
        (first advance step at 1M dof).  An eigendecomposition
        cannot produce NaN, and clamped directions deflate cleanly."""
        j = Z.shape[0]
        eps = float(jnp.finfo(real_dtype).eps)
        for _ in range(2):
            d = jnp.real(jnp.sum(Z.conj() * bx_of(Z, BZ), axis=1))
            alive = (d > (64.0 * eps) * jnp.sum(d) / j).astype(
                real_dtype
            )
            Z = Z * alive[:, None]
            AZ = AZ * alive[:, None]
            if generalized:
                BZ = BZ * alive[:, None]
            G = jnp.dot(Z.conj(), bx_of(Z, BZ).T)
            G = 0.5 * (G + G.conj().T)
            dd = jnp.maximum(jnp.real(jnp.diag(G)), 0.0)
            scale = safe_div(1.0, jnp.sqrt(dd))
            Gh = G * (scale[:, None] * scale[None, :]).astype(dtype)
            lam, S = jnp.linalg.eigh(Gh)
            keep = lam > (j * eps) * jnp.maximum(lam[-1], 0.0)
            inv = jnp.where(
                keep, safe_div(1.0, jnp.sqrt(jnp.maximum(lam, 0.0))), 0.0
            )
            # rows transform Q = diag(inv) S^T diag(scale) Z, mirrored
            # on AZ / BZ (linear consistency).  S^T, not S^H: with the
            # row-Gram convention G[i,j] = z_i^H B z_j the orthonormal
            # transform must satisfy T conj(G) T^H = I (the conjugation
            # lands on the COEFFICIENTS of the left factor in
            # <sum_k T[i,k] z_k, .>), and conj(Ghat) = conj(S) Lam S^T
            # makes that T = Lam^{-1/2} S^T D -- identical to S^H in
            # real arithmetic, which is why only complex inputs expose
            # the difference.
            T = (
                inv[:, None].astype(dtype)
                * S.T
                * scale[None, :].astype(dtype)
            )
            Z = jnp.dot(T, Z)
            AZ = jnp.dot(T, AZ)
            if generalized:
                BZ = jnp.dot(T, BZ)
        return Z, AZ, BZ

    def _project_against(Z, AZ, BZ, Xr, AXr, BXr):
        """CGS2-project the rows of Z B-orthogonal to the rows of Xr
        (which are B-orthonormal); the linear transform is mirrored on
        the A- and B-images."""
        for _ in range(2):
            C = jnp.dot(bx_of(Xr, BXr).conj(), Z.T)  # C[i,j] = <x_i, z_j>_B
            Z = Z - jnp.dot(C.T, Xr)
            AZ = AZ - jnp.dot(C.T, AXr)
            if generalized:
                BZ = BZ - jnp.dot(C.T, BXr)
        return Z, AZ, BZ

    def _kill_tiny_rows(Z, AZ, BZ, ref):
        """Zero rows whose post-projection norm collapsed below the
        breakdown threshold relative to their pre-projection size
        (exhausted directions must not be normalized into garbage --
        the same convention as the Lanczos sweep)."""
        alive = (jnp.linalg.norm(Z, axis=1) > brk * ref).astype(real_dtype)
        Z = Z * alive[:, None]
        AZ = AZ * alive[:, None]
        if generalized:
            BZ = BZ * alive[:, None]
        return Z, AZ, BZ

    def _rayleigh_ritz(S, AS):
        """Hermitian RR on the basis rows of S; dead (zero) rows sort
        last via the spurious mask.  The B-Gram never appears: the
        ortho-variant construction keeps S B-orthonormal (modulo dead
        rows), so the mass matrix of the projected pencil is the
        identity by construction -- that is the point of paying the
        SVQB/projection GEMMs."""
        G = jnp.dot(S.conj(), AS.T)
        G = 0.5 * (G + G.conj().T)
        theta, C = jnp.linalg.eigh(G)
        spurious = spurious_ritz_mask(S, C)
        key = jnp.where(spurious, jnp.inf, _selection_key(theta, which))
        order = jnp.argsort(key)
        return theta[order].astype(real_dtype), C[:, order]

    # ---- initial block: B-orthonormalize, then RR on X alone --------
    AX0 = A_blk(X)
    BX0 = B_blk(X) if generalized else dummy
    X, AX0, BX0 = _b_svqb2(X, AX0, BX0)
    theta0, C0 = _rayleigh_ritz(X, AX0)
    Ck = C0[:, :k]
    X = jnp.dot(Ck.T, X)
    AX = jnp.dot(Ck.T, AX0)
    BX = jnp.dot(Ck.T, BX0) if generalized else dummy
    theta = theta0[:k]

    P0 = jnp.zeros((k, N), dtype)
    AP0 = jnp.zeros((k, N), dtype)
    BP0 = jnp.zeros((k, N), dtype) if generalized else dummy

    hist0 = jnp.full(maxiter + 1, jnp.nan, real_dtype)

    if criterion == "backward":
        # 8-step power-iteration ||.||_2 estimates (deterministic
        # quasi-random start, like eigsh's shift-invert verification;
        # a slight underestimate for clustered tops only makes the
        # criterion stricter)
        def _opnorm(mv):
            z = (jnp.cos(jnp.arange(N) * 0.3571) + 0.01).astype(dtype)
            z = z * safe_div(1.0, jnp.linalg.norm(z))

            def _pw(i, zz):
                w = mv(zz)
                return w * safe_div(1.0, jnp.linalg.norm(w))

            z = lax.fori_loop(0, 8, _pw, z)
            return jnp.linalg.norm(mv(z)).astype(real_dtype)

        anorm = _opnorm(A_mv)
        bnorm = (
            _opnorm(B_mv)
            if generalized
            else jnp.asarray(1.0, real_dtype)
        )

    def _pair_res(Xr, AXr, BXr, th):
        R = AXr - th[:, None].astype(dtype) * bx_of(Xr, BXr)
        num = jnp.linalg.norm(R, axis=1)
        if criterion == "backward":
            den = (anorm + jnp.abs(th) * bnorm) * jnp.linalg.norm(
                Xr, axis=1
            )
        elif generalized:
            den = jnp.abs(th) * jnp.linalg.norm(BXr, axis=1)
        else:
            den = jnp.abs(th)  # ||x||_2 = 1 in the standard case
        return R, num / jnp.maximum(den, eps_floor)

    eps_mach = float(jnp.finfo(real_dtype).eps)

    def _svqb_transform(G, ref=None):
        """SVQB row transform from a (j, j) B-Gram: returns (T, live)
        where T orthonormalizes the rows the Gram belongs to and `live`
        marks the output rows that carry a direction.  The kill-tiny
        rule (vs pre-projection reference norms) folds into the alive
        mask when `ref` is given -- replicated small-dense work, zero
        sync points."""
        j = G.shape[0]
        d = jnp.maximum(jnp.real(jnp.diag(G)), 0.0)
        alive = d > (64.0 * eps_mach) * jnp.sum(d) / j
        if ref is not None:
            alive = alive & (jnp.sqrt(d) > brk * ref)
        aliver = alive.astype(real_dtype)
        scale = safe_div(1.0, jnp.sqrt(d * aliver)) * aliver
        Gh = G * (scale[:, None] * scale[None, :]).astype(dtype)
        lam, S = jnp.linalg.eigh(Gh)
        keep = lam > (j * eps_mach) * jnp.maximum(lam[-1], 0.0)
        inv = jnp.where(
            keep, safe_div(1.0, jnp.sqrt(jnp.maximum(lam, 0.0))), 0.0
        )
        T = (
            inv[:, None].astype(dtype)
            * S.T
            * scale[None, :].astype(dtype)
        )
        return T, keep

    def body(state):
        X, AX, BX, P, AP, BP, theta, it, hist, _ = state
        R, res = _pair_res(X, AX, BX, theta)
        wres = jnp.max(res)
        hist = hist.at[it].set(wres)
        conv = wres <= tol

        def advance_fused(_):
            """Three stacked cross-Grams for the whole advance (see the
            ``variant`` docstring); every small-dense factor is
            replicated, every (*, N) operation a local GEMM/axpy."""
            Rm = R
            if lock:
                Rm = Rm * (res > tol)[:, None].astype(real_dtype)
            W = M_blk(Rm) if M_mv is not None else Rm
            AW = A_blk(W)

            # ---- sync 1: projection pass 1 + pre-projection norms
            L2 = jnp.concatenate([X, W, P])
            R2 = jnp.concatenate([W, P])
            G2 = jnp.einsum("iN,jN->ij", L2.conj(), R2)
            C1 = jnp.concatenate([G2[:k, :k], G2[:k, k:]], axis=1)
            ref = jnp.sqrt(jnp.maximum(jnp.concatenate([
                jnp.real(jnp.diagonal(G2[k:2 * k, :k])),
                jnp.real(jnp.diagonal(G2[2 * k:, k:])),
            ]), 0.0))
            Up1 = R2 - jnp.dot(C1.T, X)
            AUp1 = jnp.concatenate([AW, AP]) - jnp.dot(C1.T, AX)

            # ---- sync 2: projection pass 2 + SVQB pass-1 Gram (the
            # post-pass-2 Gram follows from G1 = Gp1 - C2^H C2 because
            # X is B-orthonormal)
            G3 = jnp.einsum(
                "iN,jN->ij", jnp.concatenate([X, Up1]).conj(), Up1
            )
            C2 = G3[:k]
            Gp1 = G3[k:]
            U1 = Up1 - jnp.dot(C2.T, X)
            AU1 = AUp1 - jnp.dot(C2.T, AX)
            G1 = Gp1 - jnp.dot(C2.conj().T, C2)
            G1 = 0.5 * (G1 + G1.conj().T)
            T1, _ = _svqb_transform(G1, ref=ref)
            U2 = jnp.dot(T1, U1)
            AU2 = jnp.dot(T1, AU1)

            # ---- sync 3: SVQB pass-2 Gram + every Rayleigh-Ritz block
            G4 = jnp.einsum(
                "iN,jN->ij",
                jnp.concatenate([X, U2]).conj(),
                jnp.concatenate([U2, AX, AU2]),
            )
            Gu = 0.5 * (G4[k:, :2 * k] + G4[k:, :2 * k].conj().T)
            T2, keep2 = _svqb_transform(Gu)
            Gxa = G4[:k, 2 * k:3 * k]
            Gxau = jnp.dot(G4[:k, 3 * k:], T2.T)
            Guau = jnp.dot(
                jnp.dot(T2.conj(), G4[k:, 3 * k:]), T2.T
            )
            Grr = jnp.concatenate([
                jnp.concatenate([Gxa, Gxau], axis=1),
                jnp.concatenate([Gxau.conj().T, Guau], axis=1),
            ])
            Grr = 0.5 * (Grr + Grr.conj().T)
            th_all, C = jnp.linalg.eigh(Grr)
            # spurious mask from the transform structure: U3 row i is
            # dead iff its pass-2 singular direction was dropped
            live = jnp.concatenate([
                jnp.ones(k, bool), keep2
            ])
            dead_mass = jnp.sum(
                jnp.abs(C) ** 2 * (~live)[:, None].astype(real_dtype),
                axis=0,
            )
            key = jnp.where(
                dead_mass > 0.5, jnp.inf,
                _selection_key(th_all.astype(real_dtype), which),
            )
            order = jnp.argsort(key)
            th = th_all[order].astype(real_dtype)
            C = C[:, order]

            U3 = jnp.dot(T2, U2)
            AU3 = jnp.dot(T2, AU2)
            S = jnp.concatenate([X, U3])
            AS = jnp.concatenate([AX, AU3])
            Cx = C[:, :k]
            Xn = jnp.dot(Cx.T, S)
            AXn = jnp.dot(Cx.T, AS)
            Cu = C[k:, :k]
            Pn = jnp.dot(Cu.T, U3)
            APn = jnp.dot(Cu.T, AU3)
            return Xn, AXn, dummy, Pn, APn, dummy, th[:k]

        def advance(_):
            Rm = R
            if lock:
                # soft locking: converged pairs contribute no (noise-
                # level) search direction, but stay in X / the RR basis
                Rm = Rm * (res > tol)[:, None].astype(real_dtype)
            W = M_blk(Rm) if M_mv is not None else Rm
            wref = jnp.linalg.norm(W, axis=1)
            AW = A_blk(W)
            BW = B_blk(W) if generalized else dummy
            W, AW, BW = _project_against(W, AW, BW, X, AX, BX)
            W, AW, BW = _kill_tiny_rows(W, AW, BW, wref)
            pref = jnp.linalg.norm(P, axis=1)
            Pp, APp, BPp = _project_against(P, AP, BP, X, AX, BX)
            Pp, APp, BPp = _kill_tiny_rows(Pp, APp, BPp, pref)
            U = jnp.concatenate([W, Pp])
            AU = jnp.concatenate([AW, APp])
            BU = (
                jnp.concatenate([BW, BPp]) if generalized else dummy
            )
            U, AU, BU = _b_svqb2(U, AU, BU)

            S = jnp.concatenate([X, U])
            AS = jnp.concatenate([AX, AU])
            BS = jnp.concatenate([BX, BU]) if generalized else dummy
            th, C = _rayleigh_ritz(S, AS)
            Cx = C[:, :k]  # (3k, k)
            Xn = jnp.dot(Cx.T, S)
            AXn = jnp.dot(Cx.T, AS)
            BXn = jnp.dot(Cx.T, BS) if generalized else dummy
            # the next conjugate direction is the W/P part of the update
            Cu = C[k:, :k]  # (2k, k)
            Pn = jnp.dot(Cu.T, U)
            APn = jnp.dot(Cu.T, AU)
            BPn = jnp.dot(Cu.T, BU) if generalized else dummy
            return Xn, AXn, BXn, Pn, APn, BPn, th[:k]

        def keep(_):
            return X, AX, BX, P, AP, BP, theta

        Xn, AXn, BXn, Pn, APn, BPn, thn = lax.cond(
            conv, keep, advance_fused if fused else advance, 0
        )
        return (
            Xn, AXn, BXn, Pn, APn, BPn, thn,
            it + jnp.where(conv, 0, 1), hist, conv,
        )

    def cond(state):
        *_, it, _, conv = state
        return (~conv) & (it < maxiter)

    init = (
        X, AX, BX, P0, AP0, BP0, theta,
        jnp.asarray(0), hist0, jnp.asarray(False),
    )
    X, AX, BX, P, AP, BP, theta, it, hist, conv = lax.while_loop(
        cond, body, init
    )

    # final report (also records the last iteration's residual when the
    # loop exited on maxiter without a final body call)
    _, res = _pair_res(X, AX, BX, theta)
    wres = jnp.max(res)
    hist = hist.at[jnp.minimum(it, maxiter)].set(wres)
    status = jnp.where(wres <= tol, CONVERGED, MAXITER)
    return LobpcgResult(
        theta=theta,
        U=X.T,
        resnorms=hist,
        niter=it,
        status=status,
        pair_resnorms=res,
    )
