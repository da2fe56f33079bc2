"""Jitted preconditioned GMRES core.

One ``lax.while_loop`` containing the full iteration: matvec, blocked
orthogonalization, Givens QR update of the Hessenberg matrix, and the
on-device convergence check.  The Krylov basis lives in a fixed
``(maxiter+1, N)`` row-major buffer so each orthogonalization sweep is one
``(m+1, N) x (N,)`` contraction (+ one for the update); on a sharded
mesh the contraction lowers to partial-dot + all-reduce.

Orthogonalization schemes (``ortho=``):

* ``'cgs2'`` (default): two passes of batched classical Gram-Schmidt --
  two contractions per pass over a bucketed row prefix of the
  (maxiter+1, N) buffer (see ``bucket_heights``), dmgs-class stability.
* ``'cgs'``: single-pass batched CGS.
* ``'bmgs2'``/``'bmgs'``: two/one passes of BLOCKED MGS: the basis is
  swept in row panels and only panels holding active rows are read, so
  HBM traffic scales with the current Krylov dimension k instead of
  maxiter.  The fastest scheme for large maxiter; two passes are in the
  dmgs stability class.
* ``'cgs2_fused'``: both CGS2 passes in 3 sweeps of the bucketed row
  prefix instead of ``'cgs2'``'s 4: the middle update+projection pair runs
  as one Pallas kernel on the GPU's Triton route
  (:func:`~krypy_tpu.kernels.orthogonalize.cgs2_fused`).  Under an
  ACTIVE MESH the same scheme runs per shard via ``shard_map``
  (:func:`~krypy_tpu.kernels.orthogonalize.cgs2_fused_sharded`): 3
  local sweeps + 2 coefficient psums + the norm = 3 sync points/iter,
  one basis sweep of traffic less than ``cgs2`` (pinned in
  tests/test_collectives.py).  Eligible: float32 system, Euclidean ip,
  no ``M`` (with distinct project/update bases the fusion saves no
  traffic), no ``basis_dtype``, N divisible by the mesh size, and a GPU
  backend unless ``interpret=True`` is passed by name.  An ineligible
  call raises.
* ``'cgs2_1r'``: one-reduce lagged CGS-2 (DCGS-2, Świrydowicz et al.
  NLAA 2021 / Bielich et al. 2022): the second Gram-Schmidt pass of the
  previous candidate, its norm (Pythagorean identity) and the first
  pass of the new direction ride ONE fused ``(m+2, N) x (N, 2)``
  contraction, so a sharded iteration costs exactly ONE all-reduce
  (vs 5 for ``cgs2``: 2x2 projection passes + the norm) -- pinned on
  compiled HLO in tests/test_collectives.py.  Same two-pass (dmgs-class)
  stability as ``cgs2``; the Hessenberg column and the Givens/residual
  recurrences lag one iteration behind the basis, so a solve performs
  one extra matvec.  Euclidean or operator-weighted ``ip``; no ``M``
  dual basis.  ``basis_dtype`` composes (round 5): sealed rows are
  stored quantized while the trailing candidate also lives in a
  full-precision side vector, so the two big levers -- halved basis
  HBM traffic and one sync point per iteration -- stack at the 67M-dof
  scale where both were built (VERDICT r4 #2).
* ``'auto'``: resolve to the fastest eligible scheme at trace time.
  Under a multi-device mesh context, a sweep-vs-sync price model
  (DESIGN section 8) compares the local basis sweep the sharded fused
  kernel saves against its two extra all-reduces: bandwidth-bound
  shards get ``'cgs2_fused'`` (sharded), latency-bound shards get
  ``'cgs2_1r'``.  Single device: ``'cgs2_fused'`` for plain f32
  Euclidean solves on a GPU backend, ``'cgs2'`` otherwise.
* ``'mgs'``/``'dmgs'``: sequential (doubly) modified Gram-Schmidt via an
  inner ``fori_loop`` -- the reference's schemes (krypy/utils.py:1012-1029)
  for fidelity; latency-bound on accelerators.

Reference semantics preserved: Hessenberg buffer + Givens chain
(krypy/linsys.py:951-997), invariance detection (krypy/utils.py:1035-1039,
with a Frobenius-norm denominator instead of the spectral norm -- cheap to
carry on device and equal up to a factor <= sqrt(rank)), explicit-residual
policy (krypy/linsys.py:430-493).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    cast_matvec,
    breakdown_threshold,
    givens_traced,
    make_inner,
    norm_from_pair,
    safe_div,
    system_dtype,
)


# --- mesh ortho-policy model (DESIGN section 8) ------------------------
# ortho='auto' under a mesh compares "one local basis sweep saved per
# iteration" (the sharded fused kernel's win) against "two extra
# all-reduces per iteration" (its cost vs the one-reduce scheme).  The
# sync/HBM prices live in the SHARED calibrated model
# (:mod:`krypy_tpu.functional.policy`: per-backend table + env
# override; tests monkeypatch policy.SYNC_S to force either regime).
_FUSED_SHARDED_EXTRA_SYNCS = 2  # 3 sync points vs cgs2_1r's 1


def _fused_ok(ip, M, basis_dtype, dtype, interpret):
    """Static eligibility of ``ortho='cgs2_fused'`` apart from the mesh
    split: Euclidean ip, no dual basis, no quantized basis, a float32
    system, and a GPU backend unless the caller asked for the Pallas
    interpreter by name."""
    return (
        ip is None
        and M is None
        and basis_dtype is None
        and jnp.dtype(dtype) == jnp.dtype(jnp.float32)
        and (interpret or jax.default_backend() == "gpu")
    )


def resolve_auto_ortho(N, m, dtype, *, ip=None, M=None, basis_dtype=None,
                       interpret=False):
    """The scheme ``ortho='auto'`` runs for a size-N solve of height m.

    On a multi-device mesh the price model picks between the one-reduce
    scheme and the sharded fused kernel; on one device the fused kernel
    where eligible, batched CGS2 otherwise.
    """
    from ..parallel import active_mesh, active_mesh_size

    scalar_ip = ip is not None and not (
        hasattr(ip, "ndim") or (hasattr(ip, "dot") and hasattr(ip, "shape"))
    )
    mesh_n = active_mesh_size()
    fused_ok = _fused_ok(ip, M, basis_dtype, dtype, interpret)
    if mesh_n > 1 and not scalar_ip and not (
        M is not None and (ip is not None or basis_dtype is not None)
    ):
        # two mesh regimes (DESIGN section 8): latency-bound shards want
        # the ONE-sync-point scheme; bandwidth-bound shards want the
        # 3-sweep sharded fused kernel (2 extra syncs, one basis sweep
        # saved per iteration).  The fused branch additionally requires
        # a PHYSICAL mesh (shard_map needs device placement): under an
        # abstract sharding context only the mesh-safe one-reduce scheme
        # qualifies.
        from . import policy

        if (
            fused_ok
            and active_mesh() is not None
            and N % mesh_n == 0
            and policy.fused_sharded_wins(
                m + 1, N // mesh_n, jnp.dtype(dtype).itemsize,
                extra_syncs=_FUSED_SHARDED_EXTRA_SYNCS,
            )
        ):
            return "cgs2_fused"
        return "cgs2_1r"
    if mesh_n <= 1 and fused_ok:
        return "cgs2_fused"
    return "cgs2"


class _GmresState(NamedTuple):
    k: jnp.ndarray
    V: jnp.ndarray           # (m+1, N) Krylov basis rows
    P: jnp.ndarray           # (m+1, N) dual basis rows (V = M P); (0,0) if no M
    H: jnp.ndarray           # (m+1, m) raw Hessenberg
    R: jnp.ndarray           # (m+1, m) Givens-rotated Hessenberg
    Q: jnp.ndarray           # (m+1, m+1) accumulated Givens product
    y: jnp.ndarray           # (m+1,) rotated projected rhs
    C: jnp.ndarray           # (m, d) captured Gram columns (deflation)
    hsq: jnp.ndarray         # running squared Frobenius norm of H
    cur_rel: jnp.ndarray
    invariant: jnp.ndarray
    resnorms: jnp.ndarray
    errnorms: jnp.ndarray
    warn_explicit: jnp.ndarray
    Rb: jnp.ndarray          # (2+d, N) persistent right-operand buffer of
                             # the fused-deflated contraction; (0, 0) else
    uf: jnp.ndarray          # (N,) full-precision trailing candidate of
                             # the one-reduce scheme under basis_dtype
                             # quantization; (0,) else


class FusedDeflation(NamedTuple):
    """Deflation data for the one-reduce fused scheme (``ortho='cgs2_1r'``
    + deflation in ONE all-reduce per iteration, VERDICT r4 #1).

    The rows of ``UoT`` ride permanently at the bottom of the Krylov
    basis buffer and ``B W2`` in a persistent right-operand buffer, so
    the single fused ``(m+2+d, N) x (N, 2+d)`` contraction of each
    iteration simultaneously yields the Gram-Schmidt coefficients, the
    deflation capture column :math:`\\langle U, M_lAM_r v\\rangle`, the
    oblique-projection coefficients AND a fresh coupling Gram
    :math:`\\langle U, W_2\\rangle`; the "twice is enough" second
    projection pass needs no further communication because its
    coefficient is :math:`G^{-1}(c - Gq_1)` with every factor already
    replicated.  Classic deflated CGS2 pays ~6 sync points for the same
    iteration (2x2 projection passes + capture + 2 projection
    applications + the norm)."""

    UoT: jnp.ndarray   # (d, N) rows of the orthonormalized deflation basis
    W2T: jnp.ndarray   # (d, N) rows of the image basis (cols of W2)
    #: (d, d) coupling Gram <Uo, W2>.  GMRES ignores it (the fused
    #: contraction yields a fresh one each iteration for free); the
    #: short-recurrence folds (CG/MINRES) need the stored copy because
    #: their contraction has no W2 columns.
    G: jnp.ndarray = None


def gmres(
    A,
    b,
    *,
    M=None,
    Ml=None,
    Mr=None,
    ip=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    ortho="cgs2",
    explicit_residual=False,
    exact_solution=None,
    progress=False,
    operator_with_capture=None,
    capture_width=0,
    projected_r0=None,
    correct_xk=None,
    return_internal=False,
    basis_dtype=None,
    fused_deflation=None,
    interpret=False,
):
    r"""Solve :math:`M M_l A M_r y = M M_l b`, :math:`x = M_r y` with
    preconditioned GMRES in one compiled while_loop.

    Parameters as in :func:`krypy_tpu.functional.cg.cg`, plus ``ortho``
    (see module docstring).  Returns a
    :class:`~krypy_tpu.functional.common.SolveResult`; use
    :func:`restarted_gmres` for the restarted variant.

    Deflation hooks (used by :mod:`krypy_tpu.functional.deflation`):

    :param operator_with_capture: replaces the iteration operator with a
      callable ``v -> (w, cap)`` where ``cap`` (shape ``(capture_width,)``)
      is recorded per iteration into the C buffer (the deflation Gram
      column :math:`\langle U, M_l A M_r v_k\rangle`).
    :param projected_r0: callable mapping the left-preconditioned initial
      residual to its projected form.
    :param correct_xk: callable applied to each candidate solution before
      residual evaluation (the deflation correction).
    :param return_internal: also return the final loop state (Krylov
      basis, Hessenberg, rotated R, y, C) for spectral post-processing.
    :param fused_deflation: a :class:`FusedDeflation` -- fold the
      deflated operator's projection and capture into the one-reduce
      contraction (``ortho='cgs2_1r'`` only, ONE all-reduce per deflated
      iteration; see the class docstring).  Mutually exclusive with
      ``operator_with_capture``; ``projected_r0``/``correct_xk`` still
      apply.  Used by
      :func:`krypy_tpu.functional.deflation.deflated_gmres`.
    :param interpret: run the ``ortho='cgs2_fused'`` kernel in the Pallas
      interpreter (CPU tests, virtual meshes).  Never chosen implicitly.
    :param basis_dtype: storage dtype for the Krylov basis buffers
      (e.g. ``jnp.bfloat16``), independent of the computation dtype.
      Orthogonalization contractions then read the basis at the narrow
      width and accumulate in the computation dtype
      (``preferred_element_type``), halving the dominant HBM traffic for
      bfloat16.  The attainable TRUE relative residual is floored at
      ``eps(basis_dtype) * kappa(A)`` -- kappa of the UNpreconditioned
      operator, because the solution is reassembled from quantized basis
      rows regardless of preconditioner quality (measured: 6e-3 at
      kappa=50 with bfloat16; useless for kappa >~ 1/eps ~ 250).  Use
      only for well-conditioned operators, optionally composed with
      :func:`~krypy_tpu.functional.refine.refine_to` (GMRES-IR) for
      tight tolerances.  Euclidean inner product and batched/paneled
      orthogonalization schemes only.  The reference has no analog
      (krypy stores the basis at the system dtype, krypy/utils.py:902).
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = N if maxiter is None else int(maxiter)

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    pair, rows = make_inner(ip)
    if ortho == "auto":
        ortho = resolve_auto_ortho(
            N, m, jnp.dtype(system_dtype(bv, x0)), ip=ip, M=M,
            basis_dtype=basis_dtype, interpret=interpret,
        )
    one_reduce = ortho == "cgs2_1r"
    if one_reduce:
        if M is not None:
            # dual-basis one-reduce form (round 5, VERDICT r4 #3): V and
            # P both carry an unnormalized candidate row; the single
            # contraction V^H [u_p, w] yields the M-inner coefficients
            # <v_j, u_p> = <p_j, M u_p>, the Pythagorean norm
            # <u_v, u_p> = ||u_p||_M^2 and the new first-pass column --
            # same 1 all-reduce/iter, plus ONE fresh M apply (u_v' =
            # M u_p', keeping the V = M P invariant exact per step; a
            # recurrence-derived u_v' compounds its rounding by 1/h per
            # iteration, the MINRES lesson).
            if ip is not None:
                raise ValueError(
                    "ortho='cgs2_1r' with M supports the Euclidean base "
                    "inner product only; use ortho='cgs2' for ip + M"
                )
            if basis_dtype is not None:
                raise ValueError(
                    "ortho='cgs2_1r' with M does not support "
                    "basis_dtype (both candidate rows would need side "
                    "buffers); use ortho='cgs2'"
                )
            if fused_deflation is not None:
                raise ValueError(
                    "fused_deflation does not compose with the M dual "
                    "basis; use ortho='cgs2' (hook path)"
                )
        if ip is not None and not (
            hasattr(ip, "ndim") or (hasattr(ip, "dot") and hasattr(ip, "shape"))
        ):
            raise ValueError(
                "ortho='cgs2_1r' supports the Euclidean or "
                "operator-weighted inner product only (the one-reduce "
                "fusion needs the raw B-application, not a scalar "
                "callable)"
            )
        # basis_dtype composes with the one-reduce scheme (round 5,
        # VERDICT r4 #2): sealed rows are stored quantized, while the
        # trailing unnormalized candidate ALSO lives in a full-precision
        # side vector (state.uf) used for the subtraction and the new
        # candidate assembly.  The contraction reads the basis at the
        # narrow width with wide accumulation (the row_proj pattern);
        # the Pythagorean norm's s = <u_q, u_q> then carries
        # quantization noise whose RELATIVE effect on sigma^2 is
        # ~eps(bdt)/sqrt(N) * (|u|/sigma)^2 (stochastic cancellation
        # over N) -- inside the eps(bdt)*kappa attainable-accuracy
        # floor the basis_dtype contract already states.
    if fused_deflation is not None:
        if not one_reduce:
            raise ValueError(
                "fused_deflation requires ortho='cgs2_1r' (the deflation "
                "fold rides the one-reduce contraction); other schemes "
                "take the operator_with_capture hook path"
            )
        if operator_with_capture is not None:
            raise ValueError(
                "fused_deflation and operator_with_capture are mutually "
                "exclusive"
            )
        capture_width = int(jnp.shape(fused_deflation.UoT)[0])
    passes = {
        "cgs": 1,
        "cgs2": 2,
        "mgs": 1,
        "dmgs": 2,
        "bmgs": 1,
        "bmgs2": 2,
        "cgs2_fused": 2,
        "cgs2_1r": 2,  # two GS passes per basis vector, fused+lagged
    }[ortho]
    sequential = ortho in ("mgs", "dmgs")
    paneled = ortho in ("bmgs", "bmgs2")
    fused = ortho == "cgs2_fused"
    # Under an active mesh the fused scheme runs per shard via
    # shard_map (3 local sweeps + 2 psums); a single-device kernel on a
    # GSPMD-sharded basis would force replication.
    fused_mesh = None
    if fused:
        from ..parallel import active_mesh

        _dt = jnp.dtype(system_dtype(bv, x0))
        if not _fused_ok(ip, M, basis_dtype, _dt, interpret):
            raise ValueError(
                "ortho='cgs2_fused' needs a float32 system, the "
                "Euclidean inner product, no M, no basis_dtype and a "
                "GPU backend (or interpret=True); use ortho='cgs2' or "
                "'cgs2_1r'"
            )
        fused_mesh = active_mesh()
        if fused_mesh is not None and N % int(fused_mesh.devices.size):
            raise ValueError(
                f"ortho='cgs2_fused' on a mesh needs N={N} divisible by "
                f"the mesh size {int(fused_mesh.devices.size)}; use "
                "ortho='cgs2_1r'"
            )
    with_M = M_mv is not None

    dtype = system_dtype(bv, x0)
    bdt = dtype if basis_dtype is None else jnp.dtype(basis_dtype)
    mixed_basis = bdt != jnp.dtype(dtype)
    if mixed_basis:
        if ip is not None:
            raise ValueError(
                "basis_dtype requires the Euclidean inner product"
            )
        if sequential or fused:
            raise ValueError(
                "basis_dtype requires a batched/paneled ortho scheme "
                "(cgs/cgs2/bmgs/bmgs2) or the one-reduce cgs2_1r"
            )
        if jnp.issubdtype(dtype, jnp.complexfloating):
            raise ValueError("basis_dtype supports real systems only")
        if fused_deflation is not None:
            raise ValueError(
                "basis_dtype does not compose with fused_deflation (the "
                "deflation basis rows would be quantized inside the "
                "shared buffer, corrupting the oblique projection); use "
                "the hook path (ortho='cgs2') for deflated quantized-"
                "basis solves"
            )
    bv = bv.astype(dtype)
    A_mv, M_mv, Ml_mv, Mr_mv = (
        cast_matvec(f, dtype) for f in (A_mv, M_mv, Ml_mv, Mr_mv)
    )
    # deflation hooks must obey the system-dtype contract too (they can
    # close over wider-precision operators/bases)
    projected_r0 = cast_matvec(projected_r0, dtype)
    correct_xk = cast_matvec(correct_xk, dtype)
    if operator_with_capture is not None:
        _owc = operator_with_capture
        operator_with_capture = lambda v: tuple(
            t.astype(dtype) for t in _owc(v)
        )
    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )
    exact = (
        None
        if exact_solution is None
        else jnp.asarray(exact_solution).reshape(-1).astype(dtype)
    )
    real_dtype = jnp.zeros(0, dtype).real.dtype
    brk = breakdown_threshold(dtype)

    def MlAMr(v):
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    def iteration_op(v):
        """Operator driving the Arnoldi iteration (projected when
        deflating), plus the optional captured Gram column."""
        if operator_with_capture is not None:
            return operator_with_capture(v)
        return MlAMr(v), jnp.zeros(0, dtype)

    def residual_norm(x):
        Mlr = apply(Ml_mv, bv - A_mv(x))
        MMlr = apply(M_mv, Mlr)
        return norm_from_pair(pair, Mlr, MMlr)

    Mlb = apply(Ml_mv, bv)
    MMlb = apply(M_mv, Mlb)
    MMlb_norm = norm_from_pair(pair, Mlb, MMlb)

    Mlr0 = apply(Ml_mv, bv - A_mv(x0v))
    if projected_r0 is not None:
        Mlr0 = projected_r0(Mlr0)
    MMlr0 = apply(M_mv, Mlr0)
    MMlr0_norm = norm_from_pair(pair, Mlr0, MMlr0)
    rel0 = safe_div(MMlr0_norm, MMlb_norm)

    resnorms0 = jnp.full(m + 1, jnp.nan, real_dtype).at[0].set(rel0)
    track_err = exact is not None
    if track_err:
        def errnorm(x):
            return norm_from_pair(pair, exact - x)

        errnorms0 = jnp.full(m + 1, jnp.nan, real_dtype).at[0].set(
            errnorm(x0v)
        )
    else:
        errnorms0 = jnp.zeros(0, real_dtype)

    # initial basis vectors (stored at the basis dtype)
    v0 = jnp.where(MMlr0_norm > 0, 1.0, 0.0) * safe_div(1.0, MMlr0_norm)
    if not one_reduce:
        V0 = jnp.zeros((m + 1, N), bdt).at[0].set((MMlr0 * v0).astype(bdt))
        if with_M:
            P0 = jnp.zeros((m + 1, N), bdt).at[0].set(
                (Mlr0 * v0).astype(bdt)
            )
        else:
            P0 = jnp.zeros((0, 0), bdt)

    if mixed_basis:
        # read the basis at the narrow storage width, accumulate wide
        def row_proj(Vr, w):
            return jnp.dot(
                Vr, w.astype(bdt), preferred_element_type=dtype
            )

        def row_upd(coeffs, Br):
            return jnp.dot(
                coeffs.astype(bdt), Br, preferred_element_type=dtype
            )
    else:
        row_proj = rows

        def row_upd(coeffs, Br):
            return jnp.dot(coeffs, Br)

    def xk_from(V, R, y, k):
        """x_k = x0 + Mr (V[:k]^T yy) with a masked triangular solve of the
        k x k leading system (rows/cols >= k are deactivated by a unit
        diagonal and zero rhs, so the fixed-shape solve yields the exact
        k-dimensional solution)."""
        col_mask = jnp.arange(m) < k
        Rk = R[:m, :m] + jnp.diag(jnp.where(col_mask, 0.0, 1.0).astype(dtype))
        rhs = jnp.where(col_mask, y[:m], 0.0).astype(dtype)
        yy = jax.scipy.linalg.solve_triangular(Rk, rhs)
        # solution assembly upcasts the basis (rare event: only explicit-
        # residual iterations and the final iterate); the attainable
        # accuracy is still floored at eps(basis_dtype) * kappa(A) by the
        # quantization of the basis rows themselves
        yk = jnp.dot(yy, V[:m].astype(dtype))
        xk = x0v + apply(Mr_mv, yk)
        if correct_xk is not None:
            xk = correct_xk(xk)
        return xk

    if one_reduce:
        # One-reduce lagged CGS-2 GMRES (see module docstring).  The
        # basis buffer carries ONE extra row -- row k holds the
        # once-projected UNNORMALIZED trailing candidate -- and the
        # Hessenberg buffer one extra column (its first-pass
        # coefficients); both are sliced off the results.  The Givens
        # QR, residual estimate and convergence check run on the column
        # COMPLETED this iteration (index k-1), i.e. one step behind
        # the basis; hence one extra matvec + reduce per solve.
        Bmv = None if ip is None else cast_matvec(as_matvec(ip), dtype)

        def prep(x):
            return x if Bmv is None else Bmv(x)

        # fused deflation (see FusedDeflation): d extra PERMANENT rows
        # at the bottom of the basis buffer hold Uo^T, and a persistent
        # right-operand buffer Rb carries B W2 below the two live
        # columns, so ONE contraction serves orthogonalization,
        # capture, projection and the fresh coupling Gram.
        d_defl = 0
        if fused_deflation is not None:
            UoT = jnp.asarray(fused_deflation.UoT).astype(dtype)
            W2T = jnp.asarray(fused_deflation.W2T).astype(dtype)
            d_defl = UoT.shape[0]
            BW2T = W2T if Bmv is None else jax.vmap(Bmv)(W2T)

        def _dpad(coeffs):
            """Zero-extend (m+2,) coefficients over the deflation rows
            so dots against the extended buffer skip them."""
            return jnp.pad(coeffs, (0, d_defl)) if d_defl else coeffs

        def _proj_coeffs(cap, Gf):
            """Oblique-projection coefficients, applied twice (Stewart's
            "twice is enough") -- replicated d x d work, no sync."""
            q1 = jnp.linalg.solve(Gf, cap)
            q2 = jnp.linalg.solve(Gf, cap - jnp.dot(Gf, q1))
            return q1 + q2

        # mixed-precision forms: contraction reads the basis at the
        # narrow storage width and accumulates wide (row_proj pattern);
        # coefficient updates downcast the small coefficients instead of
        # upcasting the big buffer
        if mixed_basis:
            def _VdotR(Vb, R2):
                return jnp.einsum(
                    "mn,kn->mk", Vb.conj(), R2.astype(bdt),
                    preferred_element_type=dtype,
                )

            def _cdotV(coeffs, Vb):
                return jnp.dot(
                    coeffs.astype(bdt), Vb, preferred_element_type=dtype
                )
        else:
            def _VdotR(Vb, R2):
                return jnp.einsum("mn,kn->mk", Vb.conj(), R2)

            def _cdotV(coeffs, Vb):
                return jnp.dot(coeffs, Vb)

        v0vec = MMlr0 * v0
        V0r = jnp.zeros((m + 2 + d_defl, N), bdt).at[0].set(
            v0vec.astype(bdt)
        )
        if with_M:
            P0r = jnp.zeros((m + 2, N), dtype).at[0].set(Mlr0 * v0)
        else:
            P0r = jnp.zeros((0, 0), dtype)
        if d_defl:
            V0r = V0r.at[m + 2:].set(UoT)
            Rb0 = jnp.zeros((2 + d_defl, N), dtype).at[2:].set(BW2T)
        else:
            Rb0 = jnp.zeros((0, 0), dtype)
        H0r = jnp.zeros((m + 2, m + 1), dtype)
        C0r = jnp.zeros((m + 1, capture_width), dtype)

        # peeled step: first projection pass of the first direction (one
        # fused reduce; rows > 0 of the buffer are zero, no mask needed)
        w0, cap0 = iteration_op(v0vec)
        if d_defl:
            Rb0c = Rb0.at[0].set(prep(v0vec)).at[1].set(prep(w0))
            Z0 = jnp.einsum("mn,kn->mk", V0r.conj(), Rb0c)
            cap0 = Z0[m + 2:, 1]
            q0 = _proj_coeffs(cap0, Z0[m + 2:, 2:])
            chat0 = Z0[: m + 2, 1] - jnp.dot(Z0[: m + 2, 2:], q0)
            w0 = w0 - jnp.dot(q0, W2T)
        else:
            chat0 = _VdotR(V0r, prep(w0)[None, :])[:, 0]
        H0r = H0r.at[:, 0].set(chat0)
        if with_M:
            # dual-basis candidates: u_p in P-space, u_v = M u_p fresh
            up0 = w0 - jnp.dot(chat0, P0r)
            P0r = P0r.at[1].set(up0)
            V0r = V0r.at[1].set(apply(M_mv, up0))
            uf0 = jnp.zeros(0, dtype)
        else:
            u0f = w0 - _cdotV(_dpad(chat0), V0r)
            V0r = V0r.at[1].set(u0f.astype(bdt))
            uf0 = u0f if mixed_basis else jnp.zeros(0, dtype)
        if capture_width > 0:
            C0r = C0r.at[0].set(cap0)

        def cond_1r(state):
            return (
                (state.cur_rel > tol)
                & (state.k < m + 1)
                & jnp.logical_not(state.invariant)
            )

        def body_1r(state):
            k = state.k
            # under basis_dtype quantization the trailing candidate is
            # read from its full-precision side vector, not the buffer
            u = state.uf if mixed_basis else state.V[k]
            w, cap = iteration_op(u)

            # THE one fused reduction of the iteration: second GS pass
            # of u, its norm (Pythagorean identity on the same row), and
            # the first GS pass of w = op(u).  The pair is stacked
            # ROW-major (2, N) and contracted over the trailing axis,
            # so both operands stream contiguously.  With fused
            # deflation the same contraction also reads the Uo rows and
            # the B W2 columns, yielding capture + projection data.
            if d_defl:
                Rb = state.Rb.at[0].set(prep(u)).at[1].set(prep(w))
                Zf = jnp.einsum("mn,kn->mk", state.V.conj(), Rb)
                cap = Zf[m + 2:, 1]
                Gf = Zf[m + 2:, 2:]
                q = _proj_coeffs(cap, Gf)
                # projection correction of the first-pass column; the
                # candidate u is already projected (built from a
                # projected w last iteration), so column 0 needs none
                col0 = Zf[: m + 2, 0]
                col1 = Zf[: m + 2, 1] - jnp.dot(Zf[: m + 2, 2:], q)
                w = w - jnp.dot(q, W2T)
                # seal-time leak cancellation: the contraction also
                # measured <Uo, u> (column 0's Uo rows) for free --
                # removing it when the row is sealed keeps every basis
                # vector exactly in the projection complement (an
                # uncancelled leak recurs through the GS subtractions
                # scaled by |h|/sigma and can compound over a long
                # cycle; same fix as the MINRES alpha*d term).
                q_seal = _proj_coeffs(Zf[m + 2:, 0], Gf)
            elif with_M:
                # dual-basis: coefficients <v_j, u_p> = <p_j, M u_p>
                # (M-inner products) from the V rows against the
                # P-space candidate; norm row <u_v, u_p> = ||u_p||_M^2
                Rb = state.Rb
                up = state.P[k]
                Z = _VdotR(state.V, jnp.stack([up, w]))
                col0 = Z[:, 0]
                col1 = Z[:, 1]
            else:
                Rb = state.Rb
                Z = _VdotR(state.V, jnp.stack([prep(u), prep(w)]))
                col0 = Z[:, 0]
                col1 = Z[:, 1]
            lt = jnp.arange(m + 2) < k
            r = jnp.where(lt, col0, 0.0)
            s = jnp.real(col0[k])
            c = jnp.where(lt, col1, 0.0)
            t = col1[k]

            sig2 = jnp.maximum(s - jnp.sum(jnp.abs(r) ** 2), 0.0)
            sigma = jnp.sqrt(sig2).astype(real_dtype)

            # complete Hessenberg column k-1: reortho corrections + the
            # subdiagonal entry
            completed = jnp.where(
                jnp.arange(m + 2) == k,
                sigma.astype(dtype),
                state.H[:, k - 1] + r,
            )
            hsq = state.hsq + jnp.sum(jnp.abs(completed) ** 2)
            invariant = sigma <= brk * jnp.sqrt(hsq)
            H = state.H.at[:, k - 1].set(completed)

            inv_s = jnp.where(invariant, 0.0, safe_div(1.0, sigma))
            vk = u - _cdotV(_dpad(r), state.V)
            if d_defl:
                vk = vk - jnp.dot(q_seal, W2T)
            vk = vk * inv_s
            V = state.V.at[k].set(vk.astype(bdt))
            if with_M:
                P = state.P.at[k].set(
                    (up - jnp.dot(r, state.P)) * inv_s
                )
            else:
                P = state.P

            # first-pass column k with the lag correction g = H (r/sigma)
            # (A is applied to the uncorrected u, so the exact column is
            # chat - g; replicated small-matrix work only)
            rt = r * inv_s
            g = jnp.dot(H, rt[: m + 1])
            tk = (t - jnp.vdot(r, c)) * inv_s * inv_s
            chat = jnp.where(jnp.arange(m + 2) == k, tk, c * inv_s)
            if with_M:
                up_next = w * inv_s - jnp.dot(chat, P)
                P = P.at[k + 1].set(up_next)
                V = V.at[k + 1].set(apply(M_mv, up_next))
                uf = state.uf
            else:
                u_next = w * inv_s - _cdotV(_dpad(chat), V)
                V = V.at[k + 1].set(u_next.astype(bdt))
                uf = u_next if mixed_basis else state.uf
            H = H.at[:, k].set(chat - g)

            if capture_width > 0:
                # the capture is linear in the iterate: op(u) =
                # sum_j r_j op(v_j) + sigma op(v_k), so
                # <U, op v_k> = (cap - r^T C)/sigma
                C = state.C.at[k].set(
                    (cap - jnp.dot(r[: m + 1], state.C)) * inv_s
                )
            else:
                C = state.C

            # Givens QR / residual recurrences on the COMPLETED column
            j = k - 1
            col = jnp.dot(state.Q, completed[: m + 1])
            c_new, s_new, r_new = givens_traced(col[j], col[j + 1])
            col = col.at[j].set(r_new).at[j + 1].set(0.0)
            qj = state.Q[j]
            qj1 = state.Q[j + 1]
            Q = (
                state.Q.at[j].set(c_new * qj + s_new * qj1)
                .at[j + 1].set(-jnp.conj(s_new) * qj + c_new * qj1)
            )
            R = state.R.at[:, j].set(col)

            yj = state.y[j]
            y = state.y.at[j].set(c_new * yj)
            y = y.at[j + 1].set(-jnp.conj(s_new) * yj)

            rel_upd = safe_div(jnp.abs(y[j + 1]), MMlb_norm)
            need_explicit = (
                explicit_residual | (rel_upd <= tol) | (k == m) | invariant
            )

            def with_explicit(_):
                rkn = residual_norm(xk_from(V, R, y, k))
                return safe_div(rkn, MMlb_norm)

            rel = lax.cond(need_explicit, with_explicit,
                           lambda _: rel_upd, None)
            warn = state.warn_explicit | (
                (not explicit_residual) & (rel_upd <= tol) & (rel > tol)
            )

            if progress:
                jax.debug.print(
                    "gmres iter {k}: rel={r:.3e}", k=k, r=rel
                )
            resnorms = state.resnorms.at[k].set(rel)
            if track_err:
                errnorms = state.errnorms.at[k].set(
                    errnorm(xk_from(V, R, y, k))
                )
            else:
                errnorms = state.errnorms

            return _GmresState(
                k + 1, V, P, H, R, Q, y, C, hsq, rel, invariant,
                resnorms, errnorms, warn, Rb, uf,
            )

        init_1r = _GmresState(
            jnp.asarray(1),
            V0r,
            P0r,
            H0r,
            jnp.zeros((m + 1, m), dtype),
            jnp.eye(m + 1, dtype=dtype),
            jnp.zeros(m + 1, dtype).at[0].set(MMlr0_norm.astype(dtype)),
            C0r,
            jnp.asarray(0.0, real_dtype),
            rel0,
            MMlr0_norm == 0,
            resnorms0,
            errnorms0,
            jnp.asarray(False),
            Rb0,
            uf0,
        )
        final = lax.while_loop(cond_1r, body_1r, init_1r)
        niter = final.k - 1
        x = xk_from(final.V, final.R, final.y, niter)
        status = jnp.where(
            final.cur_rel <= tol,
            CONVERGED,
            jnp.where(final.invariant, BREAKDOWN, MAXITER),
        )
        result = SolveResult(
            x=x if flat else x[:, None],
            resnorms=final.resnorms,
            niter=niter,
            status=status,
            errnorms=final.errnorms if track_err else None,
        )
        if return_internal:
            internals = {
                "V": final.V[: m + 1],
                "P": final.P[: m + 1] if with_M else None,
                "H": final.H[: m + 1, :m],
                "R": final.R,
                "y": final.y,
                "C": final.C[:m],
                "MMlr0_norm": MMlr0_norm,
                "MMlb_norm": MMlb_norm,
            }
            return result, internals
        return result

    # panel height for the blocked-MGS path: 16 rows, clipped to
    # the basis height so the dynamic row slice is always in range
    panel_rows = max(1, min(16, m + 1))

    # prefix buckets for the batched (cgs/cgs2/cgs2_fused) schemes: the
    # sweep runs over a static row-prefix V[:h] with the smallest bucket
    # h >= k+1, so HBM traffic follows the current Krylov dimension
    # instead of the full maxiter-sized buffer.  Arithmetic is unchanged: rows beyond k
    # are masked to zero coefficients and the buffer rows are
    # zero-initialized, so the extra rows of a bucket contribute exact
    # zeros.  Doubling buckets bound the compiled-branch count by
    # log2(m); at m=40 the average swept height drops from 41 to ~26.
    # Buckets start at 8 (not 16) so short restart lengths -- e.g. the
    # memory-capped m=12 of the 67M-dof north star -- still engage the
    # prefix: at m=12 the average swept height drops from 13 to ~9.7.
    bucket_heights = []
    _h = 8
    while _h < m + 1:
        bucket_heights.append(_h)
        _h *= 2
    bucket_heights.append(m + 1)

    def orthogonalize(V, P, w, k):
        """Return (w_orth, h) where h are the accumulated coefficients.
        Subtraction runs against the dual basis P when M is present
        (reference: krypy/utils.py:1026-1029).

        ``bmgs``/``bmgs2`` sweep the basis in row panels and only visit
        the panels that hold active rows, so the HBM traffic per
        iteration scales with the current Krylov dimension k instead of
        the full maxiter-sized buffer (SURVEY.md section 5.7: streaming
        orthogonalization over V tiles).  Panel-level classical
        Gram-Schmidt between-panel MGS ("BMGS") with two passes is in the
        dmgs stability class.
        """
        basis = P if with_M else V
        mask = jnp.arange(m + 1) <= k
        h = jnp.zeros(m + 1, dtype)
        if sequential:
            def j_body(j, carry):
                w, h = carry
                active = (j <= k)
                coeff = jnp.where(active, rows(V[j][None, :], w)[0], 0.0)
                w = w - coeff * basis[j]
                h = h.at[j].add(coeff)
                return (w, h)

            for _ in range(passes):
                w, h = lax.fori_loop(0, m + 1, j_body, (w, h))
        elif paneled:
            def panel_body(p, carry):
                w, h = carry
                # clamped start: the final panel may re-read a few rows
                # below p*panel_rows; the row mask zeroes their coeffs
                start = jnp.minimum(p * panel_rows, m + 1 - panel_rows)
                Vp = lax.dynamic_slice_in_dim(V, start, panel_rows, 0)
                Bp = (
                    lax.dynamic_slice_in_dim(basis, start, panel_rows, 0)
                    if with_M
                    else Vp
                )
                ridx = start + jnp.arange(panel_rows)
                rmask = (ridx >= p * panel_rows) & (ridx <= k)
                coeffs = row_proj(Vp, w) * rmask
                w = w - row_upd(coeffs, Bp)
                seg = lax.dynamic_slice_in_dim(h, start, panel_rows, 0)
                h = lax.dynamic_update_slice_in_dim(
                    h, seg + coeffs, start, 0
                )
                return (w, h)

            active_panels = k // panel_rows + 1
            for _ in range(passes):
                w, h = lax.fori_loop(0, active_panels, panel_body, (w, h))
        else:
            if fused:
                from ..kernels.orthogonalize import (
                    cgs2_fused,
                    cgs2_fused_sharded,
                )

                fmask = mask.astype(w.real.dtype)
                if fused_mesh is not None:
                    # per-shard fused kernels + psum'd coefficients: 3
                    # local sweeps, 2 all-reduces (pinned in
                    # tests/test_collectives.py)
                    def sweep(w_b, hgt):
                        return cgs2_fused_sharded(
                            V, w_b, fmask, mesh=fused_mesh, rows=hgt,
                            interpret=interpret,
                        )
                else:
                    def sweep(w_b, hgt):
                        return cgs2_fused(
                            V, w_b, fmask, rows=hgt, interpret=interpret
                        )
            else:
                # batched CGS over the prefix: `passes` projection +
                # update pairs, rows beyond k masked
                def sweep(w_b, hgt):
                    c_all = jnp.zeros(m + 1, dtype)
                    for _ in range(passes):
                        coeffs = row_proj(V[:hgt], w_b) * mask[:hgt]
                        w_b = w_b - row_upd(coeffs, basis[:hgt])
                        c_all = c_all.at[:hgt].add(coeffs)
                    return w_b, c_all

            def make_branch(hgt):
                def branch(operands):
                    w_b, h_b = operands
                    w_b, c = sweep(w_b, hgt)
                    return w_b, h_b + c
                return branch

            idx = jnp.searchsorted(
                jnp.asarray(bucket_heights), k + 1, side="left"
            )
            w, h = lax.switch(
                idx, [make_branch(hh) for hh in bucket_heights], (w, h)
            )
        return w, h

    def cond(state):
        return (
            (state.cur_rel > tol)
            & (state.k < m)
            & jnp.logical_not(state.invariant)
        )

    def body(state):
        k = state.k
        w, cap = iteration_op(state.V[k].astype(dtype))
        C = (
            state.C.at[k].set(cap)
            if capture_width > 0
            else state.C
        )
        w, h = orthogonalize(state.V, state.P, w, k)

        if with_M:
            Mw = apply(M_mv, w)
            hnew = norm_from_pair(pair, w, Mw)
        else:
            hnew = norm_from_pair(pair, w)

        # invariance detection on the relative subdiagonal; Frobenius
        # denominator carried incrementally
        hsq = state.hsq + jnp.sum(jnp.abs(h) ** 2) + hnew**2
        invariant = hnew <= brk * jnp.sqrt(hsq)

        h = h.at[k + 1].set(hnew.astype(dtype))
        inv_h = jnp.where(invariant, 0.0, safe_div(1.0, hnew))
        if with_M:
            P = state.P.at[k + 1].set((w * inv_h).astype(bdt))
            V = state.V.at[k + 1].set((Mw * inv_h).astype(bdt))
        else:
            P = state.P
            V = state.V.at[k + 1].set((w * inv_h).astype(bdt))
        H = state.H.at[:, k].set(h)

        # apply the k previous rotations to the new column in ONE small
        # matvec against the accumulated rotation product (rows >= k of Q
        # are still identity, so this equals the sequential chain without
        # a per-rotation scalar loop)
        col = jnp.dot(state.Q, h)

        # new rotation zeroing the subdiagonal
        c_new, s_new, r_new = givens_traced(col[k], col[k + 1])
        col = col.at[k].set(r_new).at[k + 1].set(0.0)
        qk = state.Q[k]
        qk1 = state.Q[k + 1]
        Q = (
            state.Q.at[k].set(c_new * qk + s_new * qk1)
            .at[k + 1].set(-jnp.conj(s_new) * qk + c_new * qk1)
        )
        R = state.R.at[:, k].set(col)

        yk_new = state.y[k]
        y = state.y.at[k].set(c_new * yk_new)
        y = y.at[k + 1].set(-jnp.conj(s_new) * yk_new)

        rel_upd = safe_div(jnp.abs(y[k + 1]), MMlb_norm)
        need_explicit = (
            explicit_residual | (rel_upd <= tol) | (k + 1 == m) | invariant
        )

        def with_explicit(_):
            rkn = residual_norm(xk_from(V, R, y, k + 1))
            return safe_div(rkn, MMlb_norm)

        rel = lax.cond(need_explicit, with_explicit,
                       lambda _: rel_upd, None)
        warn = state.warn_explicit | (
            (not explicit_residual) & (rel_upd <= tol) & (rel > tol)
        )

        if progress:
            jax.debug.print(
                "gmres iter {k}: rel={r:.3e}", k=k + 1, r=rel
            )
        resnorms = state.resnorms.at[k + 1].set(rel)
        if track_err:
            errnorms = state.errnorms.at[k + 1].set(
                errnorm(xk_from(V, R, y, k + 1))
            )
        else:
            errnorms = state.errnorms

        return _GmresState(
            k + 1, V, P, H, R, Q, y, C, hsq, rel, invariant,
            resnorms, errnorms, warn, state.Rb, state.uf,
        )

    init = _GmresState(
        jnp.asarray(0),
        V0,
        P0,
        jnp.zeros((m + 1, m), dtype),
        jnp.zeros((m + 1, m), dtype),
        jnp.eye(m + 1, dtype=dtype),
        jnp.zeros(m + 1, dtype).at[0].set(MMlr0_norm.astype(dtype)),
        jnp.zeros((m, capture_width), dtype),
        jnp.asarray(0.0, real_dtype),
        rel0,
        MMlr0_norm == 0,
        resnorms0,
        errnorms0,
        jnp.asarray(False),
        jnp.zeros((0, 0), dtype),
        jnp.zeros(0, dtype),
    )
    final = lax.while_loop(cond, body, init)

    x = xk_from(final.V, final.R, final.y, final.k)
    status = jnp.where(
        final.cur_rel <= tol,
        CONVERGED,
        jnp.where(final.invariant, BREAKDOWN, MAXITER),
    )
    result = SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.k,
        status=status,
        errnorms=final.errnorms if track_err else None,
    )
    if return_internal:
        internals = {
            "V": final.V,
            "P": final.P if with_M else None,
            "H": final.H,
            "R": final.R,
            "y": final.y,
            "C": final.C,
            "MMlr0_norm": MMlr0_norm,
            "MMlb_norm": MMlb_norm,
        }
        return result, internals
    return result


#: compiled restart-cycle cache: (operator/option identity) -> jitted
#: ``(b, x0) -> SolveResult``.  The closures hold strong references to
#: their operators, so the id()-based keys cannot be recycled while the
#: entry lives; a small FIFO bounds growth.
_RESTART_CACHE = {}
_RESTART_CACHE_MAX = 16


def _restart_cycle(A, tol, maxiter, kwargs):
    """One compiled GMRES cycle with b AND x0 as traced arguments, cached
    across calls so a sequence of right-hand sides on the same operator
    compiles exactly once (VERDICT r1: the previous closure-over-b design
    recompiled per system)."""
    key_items = tuple(
        (k, v if isinstance(v, (bool, int, float, str, type(None))) else id(v))
        for k, v in sorted(kwargs.items())
    )
    key = (id(A), float(tol), maxiter, key_items)
    cycle = _RESTART_CACHE.get(key)
    if cycle is None:

        @jax.jit
        def cycle(bb, x0):
            return gmres(A, bb, x0=x0, tol=tol, maxiter=maxiter, **kwargs)

        # the closure must keep the id()-keyed objects alive
        cycle._keepalive = (A, kwargs)
        if len(_RESTART_CACHE) >= _RESTART_CACHE_MAX:
            _RESTART_CACHE.pop(next(iter(_RESTART_CACHE)))
        _RESTART_CACHE[key] = cycle
    return cycle


def restarted_gmres(
    A,
    b,
    *,
    max_restarts=0,
    maxiter=None,
    tol=1e-5,
    compiled=False,
    **kwargs,
):
    """Restarted GMRES: host loop over ONE compiled inner solve (with both
    the right-hand side and the initial guess as traced arguments),
    reusing the last iterate as initial guess
    (reference: krypy/linsys.py:1021-1072).

    The compiled cycle is cached across calls, so solving a sequence of
    systems with the same operator and options compiles once.  The outer
    restart loop runs on host because its trip count is
    convergence-dependent; its cost is one dispatch per restart.

    :param compiled: run the restart loop itself as a traced
      ``lax.while_loop`` so the WHOLE restarted solve is one dispatch
      and the function is usable INSIDE jitted code (e.g. as the inner
      solver of ``refine_to(compiled=True)``).  Granularity trade:
      ``resnorms`` then holds one entry per CYCLE (the cycle-final
      relative residual), not per iteration, and ``niter`` counts total
      inner iterations.
    """
    b = jnp.asarray(b)
    x = kwargs.pop("x0", None)
    if x is None:
        x = jnp.zeros(b.reshape(-1).shape[0], b.dtype)
        if b.ndim > 1:
            x = x[:, None]
    x = jnp.asarray(x)

    if compiled:
        return _restarted_gmres_traced(
            A, b, x, max_restarts, maxiter, tol, kwargs
        )

    cycle = _restart_cycle(A, tol, maxiter, kwargs)

    import numpy as _np

    resnorms = []
    result = None
    for _ in range(max_restarts + 1):
        result = cycle(b, x)
        niter = int(result.niter)
        chunk = list(_np.asarray(result.resnorms)[: niter + 1])
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        if int(result.status) in (CONVERGED, BREAKDOWN):
            break

    return result._replace(
        resnorms=jnp.asarray(_np.asarray(resnorms)),
        x=x,
    )


def _restarted_gmres_traced(A, b, x0, max_restarts, maxiter, tol, kwargs):
    """Traced restart driver: the whole restarted solve in one
    ``lax.while_loop`` (see :func:`restarted_gmres` ``compiled=``)."""
    cycles = int(max_restarts) + 1
    int_dtype = jnp.asarray(1).dtype
    # match gmres's resnorm dtype: real part of the system dtype
    real_dtype = jnp.zeros(0, b.dtype).real.dtype
    rels0 = jnp.full(cycles + 1, jnp.nan, real_dtype)

    def cond(c):
        i, x, rel, status, nit, rels = c
        return (i < cycles) & (status == MAXITER)

    def body(c):
        i, x, rel, status, nit, rels = c
        res = gmres(A, b, x0=x, tol=tol, maxiter=maxiter, **kwargs)
        rel_new = jnp.take(res.resnorms, res.niter).astype(real_dtype)
        # first cycle also records the initial relative residual, so
        # resnorms[0] matches the host driver's contract
        rels = rels.at[0].set(
            jnp.where(
                i == 0, res.resnorms[0].astype(real_dtype), rels[0]
            )
        )
        return (
            i + 1,
            res.x,
            rel_new,
            res.status.astype(int_dtype),
            nit + res.niter.astype(int_dtype),
            rels.at[i + 1].set(rel_new),
        )

    i, x, rel, status, nit, rels = lax.while_loop(
        cond, body,
        (
            jnp.asarray(0, int_dtype),
            x0,
            jnp.asarray(jnp.inf, real_dtype),
            jnp.asarray(MAXITER, int_dtype),
            jnp.asarray(0, int_dtype),
            rels0,
        ),
    )
    return SolveResult(x=x, resnorms=rels, niter=nit, status=status)
