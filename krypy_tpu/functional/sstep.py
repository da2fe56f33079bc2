r"""Communication-avoiding s-step solvers (CA-CG, CA-GMRES).

Classic CG performs 2 dependent global reductions per iteration (the
alpha and beta inner products); on a mesh each is an all-reduce, and on
this class of accelerator runtime the *sequential chain* of small ops is
the bottleneck even on one chip.  The s-step reformulation (after
Chronopoulos & Gear's s-step CG and Van Rosendale) advances s CG
iterations per loop step with THREE fused reductions total:

1. build the block Krylov basis V = [Mr, (MA)Mr, ..., (MA)^{s-1} Mr]
   (s matvecs, no reductions; powers scaled by a one-time spectral-radius
   estimate to keep the monomial basis bounded);
2. A-conjugate the block against the previous direction block with ONE
   (s, N) x (N, s) contraction;
3. form the block Gram/projection [P^T A P, P^T r] with ONE
   (s, N) x (N, s+1) contraction, solve the s x s system, and update
   x and r with two GEMMs;
4. one residual-norm reduction for the convergence check.

In exact arithmetic the trajectory equals CG (conjugating against the
previous block only is the s-step analog of the three-term recurrence).
The monomial basis conditions like kappa(MA)^s, so s is kept small
(default 4) and intended for use with a good SPD preconditioner M; the
solver reports BREAKDOWN when the block Gram matrix stops being usable.

Reference baseline: krypy has no communication-avoiding variant (its CG
is krypy/linsys.py:520-708); this solver is accelerator-native surface.

When to use: on MESHES, where each reduction is an all-reduce over the
interconnect.  On one device the two CG reductions inside one compiled
while_loop carry no dispatch latency, and the block formulation adds
basis-stacking traffic, so keep :func:`~krypy_tpu.functional.cg.cg` for
single-device work.
"""

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp
from jax import lax

import jax

from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    cast_matvec,
    safe_div,
    system_dtype,
)

__all__ = ["ca_cg", "ca_gmres", "modified_leja", "newton_shifts",
           "restarted_ca_gmres"]


class _CaCgState(NamedTuple):
    j: jnp.ndarray            # block counter
    x: jnp.ndarray
    r: jnp.ndarray
    Mr: jnp.ndarray           # M r (reused as the next block's seed)
    P: jnp.ndarray            # (N, s) previous direction block
    AP: jnp.ndarray           # (N, s) = A P
    W: jnp.ndarray            # (s, s) = P^T A P of the previous block
    cur_rel: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray     # one entry per block boundary


def ca_cg(
    A,
    b,
    *,
    s=4,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    lam_est=None,
    power_iters=8,
    stagnation_window=20,
    explicit_residual=True,
):
    """Solve SPD ``A x = b`` (optionally with SPD preconditioner M) by
    s-step CG in one compiled while_loop.

    :param s: CG steps advanced per loop iteration (keep small, <= 8).
    :param lam_est: scaling for the monomial basis powers; estimated by
      ``power_iters`` power iterations on MA when not given.
    :param maxiter: total CG-iteration budget (rounded up to blocks).
    :param stagnation_window: stop after this many blocks without
      improvement of the residual (float32 attainable-accuracy guard;
      note CG residual norms are non-monotone, so this is generous).
    :param explicit_residual: recompute the TRUE residual ``b - A x``
      once per block (amortized 1/s matvec) instead of trusting the
      block recurrence -- this self-corrects the monomial-basis drift
      that otherwise makes the recurrence residual diverge from the
      true one at larger s.
    :return: :class:`~krypy_tpu.functional.common.SolveResult`;
      ``resnorms`` holds one relative residual per s-step block,
      ``niter`` counts CG iterations (blocks * s).

    ``s >= 2`` is the intended regime (s=1 pays the block overhead for
    no amortization and CG's non-monotone start can trip the stagnation
    guard).
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = N if maxiter is None else int(maxiter)
    blocks = -(-maxiter // s)
    s = int(s)

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))
    real_dtype = jnp.zeros(0, dtype).real.dtype

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    def m_norm(r, Mr):
        # the M-weighted residual norm tracked by classic preconditioned
        # CG (cf. krypy/linsys.py:664-665); CG's Euclidean residual norm
        # is strongly non-monotone and would trip the stagnation guard
        return jnp.sqrt(jnp.maximum(jnp.real(jnp.vdot(r, Mr)), 0.0))

    Mb = apply(M_mv, bv)
    bnorm = m_norm(bv, Mb)
    r0 = bv - A_mv(x0v)
    Mr0 = apply(M_mv, r0)
    rel0 = safe_div(m_norm(r0, Mr0), bnorm)

    if lam_est is None:
        # one-time spectral-radius estimate of MA (setup cost, outside
        # the solve loop)
        def power_body(_, u):
            w = apply(M_mv, A_mv(u))
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

        u = lax.fori_loop(
            0, power_iters, power_body,
            r0 / jnp.maximum(jnp.linalg.norm(r0), 1e-30),
        )
        lam = jnp.linalg.norm(apply(M_mv, A_mv(u)))
        lam = jnp.maximum(lam, 1e-30).astype(real_dtype)
    else:
        lam = jnp.asarray(lam_est, real_dtype)

    eye_s = jnp.eye(s, dtype=dtype)

    def body(state):
        # 1. monomial basis of the preconditioned Krylov block (the seed
        # M r was already computed by the previous block's residual check)
        v = state.Mr
        Vcols, AVcols = [v], [A_mv(v)]
        for _ in range(s - 1):
            v = apply(M_mv, AVcols[-1]) / lam
            Vcols.append(v)
            AVcols.append(A_mv(v))
        V = jnp.stack(Vcols, axis=1)     # (N, s)
        AV = jnp.stack(AVcols, axis=1)

        # 2. A-conjugate against the previous block: ONE contraction
        cross = jnp.dot(state.AP.conj().T, V)       # (s, s)
        Bc = -jnp.linalg.solve(state.W, cross)
        P = V + jnp.dot(state.P, Bc)
        AP = AV + jnp.dot(state.AP, Bc)

        # 3. fused block Gram + projection: ONE contraction
        G = jnp.dot(P.conj().T, jnp.concatenate(
            [AP, state.r[:, None]], axis=1
        ))                                            # (s, s+1)
        W = G[:, :s]
        g = G[:, s]
        a = jnp.linalg.solve(W, g)
        x = state.x + jnp.dot(P, a)
        if explicit_residual:
            r = bv - A_mv(x)
        else:
            r = state.r - jnp.dot(AP, a)

        # 4. convergence / stagnation bookkeeping (one reduction)
        Mr = apply(M_mv, r)
        rel = safe_div(m_norm(r, Mr), bnorm)
        broken = ~jnp.isfinite(rel)
        improved = rel < state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(rel, state.best_rel)
        resnorms = state.resnorms.at[state.j + 1].set(rel)
        return _CaCgState(
            state.j + 1, x, r, Mr, P, AP, W, rel, best, stall, broken,
            resnorms,
        )

    def cond(state):
        go = (state.cur_rel > tol) & (state.j < blocks) & ~state.broken
        # stagnation_window == 0 disables the guard (package convention)
        if stagnation_window > 0:
            go = go & (state.stall < stagnation_window)
        return go

    init = _CaCgState(
        jnp.asarray(0),
        x0v,
        r0,
        Mr0,
        jnp.zeros((N, s), dtype),
        jnp.zeros((N, s), dtype),
        eye_s,
        rel0,
        rel0,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.full(blocks + 1, jnp.nan, real_dtype).at[0].set(rel0),
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(
        final.cur_rel <= tol,
        CONVERGED,
        jnp.where(final.broken, BREAKDOWN, MAXITER),
    )
    x = final.x
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.j * s,
        status=status,
    )


def modified_leja(ev):
    """Order points by the modified Leja ordering, conjugate pairs kept
    adjacent with the Im>0 member first.

    The Newton-basis polynomial :math:`\\prod (z - \\theta_i)` stays
    bounded on the spectrum when the shifts are Leja-ordered (each next
    point maximizes the product of distances to the already-chosen ones);
    naive orderings make intermediate partial products explode, which is
    the classic instability of the Newton s-step basis.
    """
    ev = np.asarray(ev, complex).ravel()
    remaining = list(range(ev.size))
    order = []

    def pick(idx):
        # Im>0 member of a conjugate pair goes first
        if ev[idx].imag < 0:
            tgt = ev[idx].conjugate()
            close = [
                r for r in remaining
                if abs(ev[r] - tgt) <= 1e-10 * max(1.0, abs(tgt))
            ]
            if close:
                idx = close[0]
        order.append(idx)
        remaining.remove(idx)
        if ev[idx].imag > 0:
            tgt = ev[idx].conjugate()
            if remaining:
                j = min(remaining, key=lambda r: abs(ev[r] - tgt))
                order.append(j)
                remaining.remove(j)

    while remaining:
        if not order:
            idx = max(remaining, key=lambda r: abs(ev[r]))
        else:
            chosen = ev[order]
            idx = max(
                remaining,
                key=lambda r: float(
                    np.sum(np.log(np.abs(ev[r] - chosen) + 1e-300))
                ),
            )
        pick(idx)
    return ev[order]


def _leja_head(ev, s):
    """First ``s`` Leja-ordered shifts, never splitting a conjugate pair.

    ``modified_leja`` keeps conjugate pairs adjacent (Im>0 opener first);
    a plain ``[:s]`` cut can then strand an opener whose conjugate falls
    just outside the window.  The Newton basis applies an unpaired opener
    with only its real part and no pair-correction step -- algebraically
    consistent, but the basis conditioning silently degrades versus the
    advertised Leja quality.  Collapse such an opener to its real part so
    every retained shift is applied exactly as ordered."""
    head = np.asarray(ev, complex)[:s].copy()
    if s >= 1 and head[-1].imag > 0:
        head[-1] = head[-1].real
    return head


def _arnoldi_warmup(MlAMr, seed, s, dtype):
    """s-step CGS2 Arnoldi (unrolled; s is small) returning the (s+1, s)
    Hessenberg whose eigenvalues seed the Newton-basis shifts."""
    Hw = jnp.zeros((s + 1, s), dtype)
    vs = [seed]
    for j in range(s):
        w = MlAMr(vs[j])
        Vj = jnp.stack(vs, axis=0)
        for _ in range(2):
            c = jnp.dot(Vj.conj(), w)
            w = w - jnp.dot(c, Vj)
            Hw = Hw.at[: j + 1, j].add(c)
        hj = jnp.linalg.norm(w)
        Hw = Hw.at[j + 1, j].set(hj.astype(dtype))
        vs.append(w * safe_div(1.0, hj))
    return Hw


def newton_shifts(A, b, s, *, Ml=None, Mr=None, x0=None, warmup=None):
    """Eagerly compute Leja-ordered Ritz shift estimates for the Newton
    s-step basis of :func:`ca_gmres`.

    Runs a ``warmup``-step Arnoldi (default ``max(s, 8)``; more steps
    give better Ritz estimates and a better-conditioned basis) as one
    compiled step, pulls the small Hessenberg to host, and returns
    ``modified_leja(eig(H))`` as a complex ndarray -- ca_gmres uses the
    first s after re-ordering.  Pass the result as
    ``ca_gmres(..., shifts=...)`` to keep a jitted solve free of host
    callbacks (required on runtimes without host callback support).
    """
    w_steps = max(int(s), 8) if warmup is None else max(int(warmup), int(s))
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv, Ml_mv, Mr_mv = (
        cast_matvec(f, dtype) for f in (A_mv, Ml_mv, Mr_mv)
    )
    x0v = (
        jnp.zeros(bv.shape[0], dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    def MlAMr(v):
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    @jax.jit
    def warm():
        r0 = apply(Ml_mv, bv - A_mv(x0v))
        seed = r0 * safe_div(1.0, jnp.linalg.norm(r0))
        return _arnoldi_warmup(MlAMr, seed, w_steps, dtype)

    Hw = np.asarray(warm())
    return modified_leja(np.linalg.eigvals(Hw[:w_steps, :w_steps]))


class _CaGmresState(NamedTuple):
    j: jnp.ndarray            # completed s-step blocks
    V: jnp.ndarray            # (m+1, N) orthonormal basis rows
    H: jnp.ndarray            # (m+1, m) recovered Hessenberg
    x: jnp.ndarray            # iterate at the last block boundary
    cur_rel: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray     # one entry per block boundary


def ca_gmres(
    A,
    b,
    *,
    s=4,
    basis="monomial",
    shifts=None,
    shift_warmup=None,
    Ml=None,
    Mr=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    lam_est=None,
    power_iters=8,
    stagnation_window=20,
    return_internal=False,
    basis_dtype=None,
):
    r"""Communication-avoiding s-step GMRES in one compiled while_loop.

    Advances s Arnoldi steps per loop iteration (after Hoemmen's
    CA-GMRES):

    1. **matrix powers**: s applications of :math:`M_l A M_r` scaled by a
       one-time spectral-radius estimate -- NO reductions;
    2. **block orthogonalization**: two passes of block classical
       Gram-Schmidt against the whole basis -- four fused
       ``(m+1, N) x (N, s)`` GEMMs per s iterations, so the HBM traffic
       over the Krylov buffer drops ~s-fold versus one-vector-at-a-time
       CGS2, and the per-iteration reduction count drops from 4 to 6/s;
    3. **panel factorization**: CholQR2 of the ``(s, N)`` candidate
       panel (two s x s Grams + Cholesky), the standard
       communication-avoiding tall-skinny QR on row panels;
    4. **Hessenberg recovery** from the basis-change algebra: with
       :math:`u_i = (M_l A M_r) u_{i-1}/\lambda` and
       :math:`[u_1..u_s] = V C + Q_{new} R` the new Hessenberg columns
       are small dense combinations of C, R and the previous H (all
       (m+1, s)-sized, replicated);
    5. one **explicit residual** per block (amortized 1/s matvec) -- the
       monomial power basis conditions like :math:`\kappa^s`, so the
       true residual, not a recurrence, drives convergence control.

    In exact arithmetic the trajectory equals GMRES at block
    boundaries.  Residual control is at block granularity: ``resnorms``
    has one entry per block, ``niter`` counts Arnoldi steps
    (blocks * s).

    Three s-step bases (``basis=``):

    * ``'monomial'`` (default): scaled matrix powers, ZERO reductions in
      the basis build.  Conditions like :math:`\\kappa^s` -- keep s small
      and pair with a spectrum-clustering preconditioner.
    * ``'newton'``: shifted powers :math:`u_{i+1} \\propto (M_lAM_r -
      \\theta_i)u_i` with Leja-ordered Ritz shifts (Hoemmen's CA-GMRES
      basis) and per-step normalization (s cheap norm-reductions per
      block; the HBM-traffic win of the block orthogonalization is
      untouched).  The shifts come from an s-step Arnoldi warmup whose
      small Hessenberg is eigendecomposed on HOST via
      ``jax.pure_callback`` (non-Hermitian eig is host-LAPACK by design,
      docs/DESIGN.md section 7) -- or pass eigenvalue-estimate
      ``shifts=`` (>= s values, conjugate-closed for real systems) to
      keep the solve callback-free.  Survives much harder spectra than
      the monomial basis at s=4..8 (tested on kappa ~ 1e6 operators
      where the monomial basis breaks down in float32).
    * ``'chebyshev'``: scaled-and-translated Chebyshev three-term
      recurrence :math:`u_{i+1} = (M_lAM_r - c)u_i - (e/2)^2 u_{i-1}`
      on the Manteuffel-style ellipse enclosing the Ritz estimates
      (same warmup / ``shifts=`` plumbing as the Newton basis -- only
      the center ``c`` and squared quarter-focal distance survive, so
      real arithmetic handles complex-conjugate spectra via ``e^2``,
      which may be negative).  Near-optimal basis conditioning on the
      ellipse; for SPD spectra (an interval) this is THE s-step basis
      and stays well conditioned at s = 8..16 where the Newton basis'
      per-shift quality matters.  Per-step normalization, s cheap
      norm-reductions per block, same Hessenberg-recovery algebra.

    Euclidean inner product and left/right preconditioning only (the
    reference's M changes the inner product; CholQR2 would need a
    weighted Gram -- use :func:`~krypy_tpu.functional.gmres.gmres` for
    that).  Reference baseline: krypy has no s-step variant (its GMRES
    is krypy/linsys.py:919-1004); this solver is accelerator-native surface.

    :param basis_dtype: storage dtype for the Krylov basis buffer (e.g.
      ``jnp.bfloat16``), independent of the computation dtype -- same
      contract as :func:`~krypy_tpu.functional.gmres.gmres`: the block
      Gram-Schmidt GEMMs read the basis at the narrow width and
      accumulate in the computation dtype, halving the dominant HBM
      traffic for bfloat16, while the candidate panel, CholQR2 and the
      Hessenberg recovery stay at full width.  The attainable TRUE
      relative residual is floored at ``eps(basis_dtype) * kappa(A)``
      (kappa of the UNpreconditioned operator).  Real systems only.
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    s = int(s)
    maxiter = N if maxiter is None else int(maxiter)
    blocks = -(-maxiter // s)
    m = blocks * s

    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    dtype = system_dtype(bv, x0)
    bdt = dtype if basis_dtype is None else jnp.dtype(basis_dtype)
    mixed_basis = bdt != jnp.dtype(dtype)
    if mixed_basis and jnp.issubdtype(dtype, jnp.complexfloating):
        raise ValueError("basis_dtype supports real systems only")
    bv = bv.astype(dtype)
    A_mv, Ml_mv, Mr_mv = (
        cast_matvec(f, dtype) for f in (A_mv, Ml_mv, Mr_mv)
    )
    real_dtype = jnp.zeros(0, dtype).real.dtype

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    def MlAMr(v):
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    Mlb = apply(Ml_mv, bv)
    Mlb_norm = jnp.linalg.norm(Mlb)
    Mlr0 = apply(Ml_mv, bv - A_mv(x0v))
    beta = jnp.linalg.norm(Mlr0)
    rel0 = safe_div(beta, Mlb_norm)

    if basis not in ("monomial", "newton", "chebyshev"):
        raise ValueError(f"unknown s-step basis {basis!r}")
    use_newton = basis == "newton"
    use_cheb = basis == "chebyshev"
    is_complex = jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)

    if use_newton or use_cheb:
        lam = jnp.asarray(1.0, real_dtype)  # unused: per-step norms
        inv_lam = lam
    elif lam_est is None:
        def power_body(_, u):
            w = MlAMr(u)
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

        u = lax.fori_loop(
            0, power_iters, power_body,
            Mlr0 / jnp.maximum(beta, 1e-30),
        )
        lam = jnp.linalg.norm(MlAMr(u))
        lam = jnp.maximum(lam, 1e-30).astype(real_dtype)
    else:
        lam = jnp.asarray(lam_est, real_dtype)
    if not (use_newton or use_cheb):
        inv_lam = (1.0 / lam).astype(real_dtype)

    v0 = jnp.where(beta > 0, 1.0, 0.0) * safe_div(1.0, beta)
    V0 = jnp.zeros((m + 1, N), bdt).at[0].set((Mlr0 * v0).astype(bdt))
    eye_s = jnp.eye(s, dtype=dtype)

    if mixed_basis:
        # read the basis at the narrow storage width, accumulate wide
        # (same convention as functional.gmres's mixed-basis path)
        def _proj(Vp, Z):
            return jnp.dot(
                Vp.conj(), Z.T.astype(bdt), preferred_element_type=dtype
            )

        def _upd(coeffs, Vp):
            return jnp.dot(
                coeffs.astype(bdt), Vp, preferred_element_type=dtype
            )

        def _assemble(yrow, Vp):
            return jnp.dot(yrow, Vp.astype(dtype))
    else:
        def _proj(Vp, Z):
            return jnp.dot(Vp.conj(), Z.T)

        _upd = jnp.dot
        _assemble = jnp.dot
    sub_diag = jnp.eye(m + 1, m, k=-1, dtype=dtype)
    rhs_ls = jnp.zeros(m + 1, dtype).at[0].set(beta.astype(dtype))
    # 32-row panel heights for the basis sweeps, clipped so
    # dynamic slices stay in range
    _pr = max(1, min(32, m + 1))
    _pra = max(1, min(32, m))

    if use_newton or use_cheb:
        if isinstance(shifts, tuple):
            # pre-ordered TRACED shift arrays (theta_re, theta_im) of
            # length s: the caller has already Leja-ordered them
            # (conjugate pairs adjacent, Im>0 opener first, no split
            # pair).  Because they enter as traced values, a driver can
            # REFRESH the shifts between restart cycles without
            # recompiling the cycle (restarted_ca_gmres does).
            theta_re = jnp.asarray(shifts[0], real_dtype)
            theta_im = jnp.asarray(shifts[1], real_dtype)
            if theta_re.shape != (s,) or theta_im.shape != (s,):
                raise ValueError(
                    f"traced shifts need shape ({s},) each, got "
                    f"{theta_re.shape}/{theta_im.shape}"
                )
        elif shifts is not None:
            ev = _leja_head(modified_leja(np.asarray(shifts)), s)
            if ev.size < s:
                raise ValueError(f"need >= {s} shifts, got {ev.size}")
            theta_re = jnp.asarray(ev.real, real_dtype)
            theta_im = jnp.asarray(ev.imag, real_dtype)
        else:
            # Arnoldi warmup to harvest Ritz shift estimates; more
            # steps than s (default max(s, 8)) give better estimates
            wu = (
                max(int(s), 8)
                if shift_warmup is None
                else max(int(shift_warmup), int(s))
            )

            def warmup_H(seed):
                return _arnoldi_warmup(MlAMr, seed, wu, dtype)

            def host_shifts(Hs):
                # non-Hermitian eig is host-LAPACK by design
                # (docs/DESIGN.md section 7)
                ev = np.linalg.eigvals(np.asarray(Hs)[:wu, :wu])
                ev = _leja_head(modified_leja(ev), s)
                npr = np.dtype(jnp.zeros(0, real_dtype).dtype)
                return ev.real.astype(npr), ev.imag.astype(npr)

            if isinstance(bv, jax.core.Tracer) or isinstance(
                x0v, jax.core.Tracer
            ):
                # under a caller's jit the host eig must be a callback;
                # runtimes without host callbacks should instead call
                # ca_gmres eagerly or pass shifts=
                theta_re, theta_im = jax.pure_callback(
                    host_shifts,
                    (
                        jax.ShapeDtypeStruct((s,), real_dtype),
                        jax.ShapeDtypeStruct((s,), real_dtype),
                    ),
                    warmup_H(V0[0].astype(dtype)),
                )
            else:
                # eager call: run the warmup as one compiled step and do
                # eig + Leja on host directly -- works on every runtime
                tr, ti = host_shifts(
                    jax.jit(warmup_H)(V0[0].astype(dtype))
                )
                theta_re = jnp.asarray(tr, real_dtype)
                theta_im = jnp.asarray(ti, real_dtype)
        if use_cheb:
            # Manteuffel-style enclosing ellipse of the Ritz estimates
            # (axis-aligned, 5% margin): center c, squared quarter-focal
            # distance e2q = (e/2)^2 = (a^2 - b^2)/4.  The scaled
            # Chebyshev recurrence uses ONLY c and e2q -- real
            # arithmetic survives complex-conjugate spectra because e^2
            # enters, never e (e2q < 0 is a vertical-foci ellipse).
            # Both are traced scalars, so drivers can refresh the
            # ellipse between restart cycles without recompiling (the
            # same property as the Newton lane's traced shift arrays).
            a_semi = 0.5 * (jnp.max(theta_re) - jnp.min(theta_re)) * 1.05
            if is_complex:
                c_im = 0.5 * (jnp.max(theta_im) + jnp.min(theta_im))
                b_semi = (
                    0.5 * (jnp.max(theta_im) - jnp.min(theta_im)) * 1.05
                )
                ccen = (
                    0.5 * (jnp.max(theta_re) + jnp.min(theta_re))
                    + 1j * c_im
                ).astype(dtype)
            else:
                b_semi = jnp.max(jnp.abs(theta_im)) * 1.05
                ccen = (
                    0.5 * (jnp.max(theta_re) + jnp.min(theta_re))
                ).astype(dtype)
            e2q = ((a_semi**2 - b_semi**2) / 4.0).astype(dtype)
        elif is_complex:
            theta = (theta_re + 1j * theta_im).astype(dtype)
            b2 = jnp.zeros(s, real_dtype)
        else:
            theta = theta_re.astype(dtype)
            # conjugate-pair correction (pairs are Leja-adjacent,
            # Im>0 opener first): u_{i+2} gets +(Im^2/sigma_i) u_i
            b2 = jnp.where(theta_im > 0, theta_im**2, 0.0).astype(
                real_dtype
            )

    def body(state):
        k = state.j * s

        # 1. s-step basis build
        u = state.V[k].astype(dtype)
        cols = []
        if use_newton:
            # shifted powers with per-step normalization: s cheap norm
            # reductions, vastly better conditioning than monomial
            uprev = jnp.zeros_like(u)
            sigs = []
            for i in range(s):
                w = MlAMr(u) - theta[i] * u
                if i >= 1:
                    w = w + (
                        b2[i - 1] * safe_div(1.0, sigs[i - 1])
                    ).astype(dtype) * uprev
                sig = jnp.linalg.norm(w)
                uprev = u
                u = w * safe_div(1.0, sig)
                sigs.append(sig)
                cols.append(u)
            sig_arr = jnp.stack(sigs).astype(real_dtype)
        elif use_cheb:
            # scaled-and-translated Chebyshev three-term recurrence
            # u_{i+1} = (A - c) u_i - (e/2)^2 u_{i-1} with per-step
            # normalization (the 1/sigma factor re-expresses the
            # previous unnormalized vector): near-optimal conditioning
            # on the enclosing ellipse, s norm-reductions per block
            uprev = jnp.zeros_like(u)
            sigs = []
            for i in range(s):
                w = MlAMr(u) - ccen * u
                if i >= 1:
                    w = w - (
                        e2q * safe_div(1.0, sigs[i - 1]).astype(dtype)
                    ) * uprev
                sig = jnp.linalg.norm(w)
                uprev = u
                u = w * safe_div(1.0, sig)
                sigs.append(sig)
                cols.append(u)
            sig_arr = jnp.stack(sigs).astype(real_dtype)
        else:
            # matrix powers (no reductions; fixed spectral scaling)
            for _ in range(s):
                u = MlAMr(u) * inv_lam
                cols.append(u)
            sig_arr = jnp.full(s, lam, real_dtype)
        Z = jnp.stack(cols, axis=0)                       # (s, N)

        # basis-generation matrix T (s+1, s):
        # (MlAMr) [u_0..u_{s-1}] = [u_0..u_s] T with u_0 = V[k]
        sidx = jnp.arange(s)
        Td = jnp.zeros((s + 1, s), dtype).at[sidx + 1, sidx].set(
            sig_arr.astype(dtype)
        )
        if use_newton:
            Td = Td.at[sidx, sidx].set(theta)
            if s > 1:
                sup = -(
                    b2[: s - 1] * safe_div(1.0, sig_arr[: s - 1])
                ).astype(dtype)
                Td = Td.at[sidx[: s - 1], sidx[1:]].set(sup)
        elif use_cheb:
            # A v_i = c v_i + (e2q / sigma_i) v_{i-1} + sigma_{i+1} v_{i+1}
            Td = Td.at[sidx, sidx].set(ccen)
            if s > 1:
                sup = e2q * safe_div(
                    1.0, sig_arr[: s - 1]
                ).astype(dtype)
                Td = Td.at[sidx[: s - 1], sidx[1:]].set(sup)

        # 2. block Gram-Schmidt x2 against the basis, swept in row
        # panels so only panels holding active rows are read: the HBM
        # traffic over the Krylov buffer scales with the current
        # dimension k instead of maxiter (panel-sequential updates keep
        # the exact decomposition Z0 = V C + Z_final, which is all the
        # Hessenberg recovery needs)
        C = jnp.zeros((m + 1, s), dtype)

        def panel_body(p, carry):
            Zp, Cp = carry
            start = jnp.minimum(p * _pr, m + 1 - _pr)
            Vp = lax.dynamic_slice_in_dim(state.V, start, _pr, 0)
            ridx = start + jnp.arange(_pr)
            rmask = ((ridx >= p * _pr) & (ridx <= k)).astype(real_dtype)
            coeffs = _proj(Vp, Zp) * rmask[:, None]           # (_pr, s)
            Zp = Zp - _upd(coeffs.T, Vp)
            seg = lax.dynamic_slice_in_dim(Cp, start, _pr, 0)
            Cp = lax.dynamic_update_slice(Cp, seg + coeffs, (start, 0))
            return Zp, Cp

        active_panels = k // _pr + 1
        for _ in range(2):
            Z, C = lax.fori_loop(0, active_panels, panel_body, (Z, C))

        # 3. SHIFTED CholQR2 of the panel: Z = conj(L1 L2) Q_rows,
        #    R = L2^H L1^H upper triangular.  The candidate panel can
        #    lose rank at the f32 floor (measured: smallest Gram
        #    eigenvalue 3.5e-9 < eps*||G|| on the 1M-dof ones-rhs
        #    Poisson probe, where A*r0 is boundary-supported and the
        #    first Newton direction nearly parallels r0); an unshifted
        #    Cholesky then returns NaN whenever the reduction order
        #    rounds that eigenvalue negative.
        #    The standard fix (shifted CholeskyQR, Fukaya et al.) adds
        #    c*eps*tr(G) I before factorizing: the factor stays finite,
        #    and the second (clean) pass restores orthonormality to
        #    working precision; the deficient direction degrades to an
        #    arbitrary orthonormal one instead of poisoning the basis.
        def _shifted_chol(G):
            scale = jnp.real(jnp.trace(G)) / s
            shift = (64.0 * float(jnp.finfo(real_dtype).eps)) * scale
            return jnp.linalg.cholesky(
                G + shift.astype(dtype) * eye_s
            )

        G1 = jnp.dot(Z.conj(), Z.T)
        L1 = _shifted_chol(G1)
        Q1 = jax.scipy.linalg.solve_triangular(L1.conj(), Z, lower=True)
        G2 = jnp.dot(Q1.conj(), Q1.T)
        L2 = _shifted_chol(G2)
        Qp = jax.scipy.linalg.solve_triangular(L2.conj(), Q1, lower=True)
        Rt = jnp.dot(L2.conj().T, L1.conj().T)            # (s, s) upper

        V = lax.dynamic_update_slice(
            state.V, Qp.astype(bdt), (k + 1, 0)
        )

        # 4. Hessenberg recovery.  Coordinates of [u_1..u_s] over the
        # extended basis: Zc = C + (R scattered to rows k+1..k+s), and
        # u_0 = V[k] has coordinates e_k; so the coordinates of
        # (MlAMr)[u_0..u_{s-1}] are AU = [e_k | Zc] T.  Then
        #   H[:, k]          = AU[:, 0]
        #   H[:, k+1..k+s-1] = ((AU[:, 1:] | 0) - H C) R^{-1}[:, :s-1]
        # from A' Q_new[:, :s-1] = (A' [u_1..u_s] - A' V C) R^{-1}; the
        # unknown A' u_s multiplies only the zero row of the triangular
        # R^{-1} columns used.
        Rscat = lax.dynamic_update_slice(
            jnp.zeros((m + 1, s), dtype), Rt, (k + 1, 0)
        )
        Zc = C + Rscat
        ek = (jnp.arange(m + 1) == k).astype(dtype)
        AU = jnp.dot(Zc, Td[1:, :]) + jnp.outer(ek, Td[0, :])
        H = lax.dynamic_update_slice(state.H, AU[:, :1], (0, k))
        if s > 1:
            M2 = jnp.dot(H, C[:m, :])                     # (m+1, s)
            M1p = jnp.concatenate(
                [AU[:, 1:], jnp.zeros((m + 1, 1), dtype)], axis=1
            )
            Rinv = jax.scipy.linalg.solve_triangular(Rt, eye_s)
            Hnew = jnp.dot(M1p - M2, Rinv[:, : s - 1])
            H = lax.dynamic_update_slice(H, Hnew, (0, k + 1))

        # 5. least squares on the (K+1, K) leading block (inactive
        # columns replaced by orthogonal unit columns -> their y is 0)
        K = k + s
        col_mask = jnp.arange(m) < K
        Hm = jnp.where(col_mask[None, :], H, sub_diag)
        qm, rm = jnp.linalg.qr(Hm, mode="reduced")
        y = jax.scipy.linalg.solve_triangular(
            rm, jnp.dot(qm.conj().T, rhs_ls)
        )

        # solution assembly over active panels only (same traffic
        # argument as the orthogonalization sweep)
        def assemble_body(p, acc):
            start = jnp.minimum(p * _pra, m - _pra)
            Vp = lax.dynamic_slice_in_dim(V, start, _pra, 0)
            yp = lax.dynamic_slice_in_dim(y, start, _pra, 0)
            ridx = start + jnp.arange(_pra)
            ymask = ((ridx >= p * _pra) & (ridx < K)).astype(real_dtype)
            return acc + _assemble(yp * ymask, Vp)

        yk = lax.fori_loop(
            0, (K - 1) // _pra + 1, assemble_body,
            jnp.zeros(N, dtype),
        )
        xk = x0v + apply(Mr_mv, yk)

        # 6. explicit residual (monomial-basis drift control)
        rel_new = safe_div(
            jnp.linalg.norm(apply(Ml_mv, bv - A_mv(xk))), Mlb_norm
        )

        finite = jnp.all(jnp.isfinite(Rt)) & jnp.isfinite(rel_new)
        broken = ~finite
        rel = jnp.where(broken, state.cur_rel, rel_new)
        x = jnp.where(broken, state.x, xk)
        improved = rel < state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(rel, state.best_rel)
        resnorms = state.resnorms.at[state.j + 1].set(rel)
        return _CaGmresState(
            state.j + 1, V, H, x, rel, best, stall, broken, resnorms
        )

    def cond(state):
        go = (state.cur_rel > tol) & (state.j < blocks) & ~state.broken
        # stagnation_window == 0 disables the guard (package convention)
        if stagnation_window > 0:
            go = go & (state.stall < stagnation_window)
        return go

    init = _CaGmresState(
        jnp.asarray(0),
        V0,
        jnp.zeros((m + 1, m), dtype),
        x0v,
        rel0,
        rel0,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.full(blocks + 1, jnp.nan, real_dtype).at[0].set(rel0),
    )
    final = lax.while_loop(cond, body, init)

    status = jnp.where(
        final.cur_rel <= tol,
        CONVERGED,
        jnp.where(final.broken, BREAKDOWN, MAXITER),
    )
    x = final.x
    result = SolveResult(
        x=x if flat else x[:, None],
        resnorms=final.resnorms,
        niter=final.j * s,
        status=status,
    )
    if return_internal:
        internal = {"V": final.V, "H": final.H, "lam": lam}
        if use_newton:
            internal["shifts"] = theta
        elif use_cheb:
            internal["ellipse"] = (ccen, e2q)
        return result, internal
    return result


#: compiled CA-GMRES restart-cycle cache, same design as
#: functional.gmres._RESTART_CACHE (id()-keyed closures kept alive by
#: the cached jitted function; small FIFO bounds growth)
_CA_RESTART_CACHE = {}
_CA_RESTART_CACHE_MAX = 16
_CA_SHIFTS_CACHE = {}
_CA_SHIFTS_KEEPALIVE = {}


def _ordered_shift_arrays(ev, s, real_np):
    """Host Leja ordering of eigenvalue estimates into the fixed-shape
    ``(theta_re, theta_im)`` arrays the traced-shift path of
    :func:`ca_gmres` consumes.  Fewer than ``s`` estimates are padded
    by repeating the final (real-collapsed) shift."""
    ev = _leja_head(modified_leja(np.asarray(ev)), s)
    if ev.size < s:
        pad_val = ev[-1].real if ev.size else 1.0
        ev = np.concatenate([ev, np.full(s - ev.size, pad_val)])
    return ev.real.astype(real_np), ev.imag.astype(real_np)


def restarted_ca_gmres(
    A,
    b,
    *,
    max_restarts=0,
    maxiter=None,
    tol=1e-5,
    s=4,
    basis="newton",
    shifts=None,
    shift_warmup=None,
    refresh_shifts=True,
    **kwargs,
):
    """Restarted CA-GMRES: host loop over ONE compiled s-step cycle with
    the rhs, initial guess AND Newton shifts as traced arguments.

    The initial shifts come from :func:`newton_shifts` (eager,
    callback-free, cached per operator).  With ``refresh_shifts`` (the
    default) every restart re-seeds them from the Leja-ordered Ritz
    values of the cycle that just finished -- the converged end of the
    spectrum sharpens the Newton basis conditioning cycle over cycle,
    which is what keeps s=8 stable on ill-conditioned operators where
    the short warmup's estimates are poor.  Because the shifts enter
    the compiled cycle as TRACED arrays, refreshing costs zero
    recompiles; the cycle cache is keyed by operator/options only.
    """
    b = jnp.asarray(b)
    x = kwargs.pop("x0", None)
    if x is None:
        x = jnp.zeros(b.reshape(-1).shape[0], b.dtype)
        if b.ndim > 1:
            x = x[:, None]
    x = jnp.asarray(x)
    real_np = np.dtype(jnp.zeros(0, b.real.dtype).dtype)

    needs_shifts = basis in ("newton", "chebyshev")
    tre = tim = None
    if needs_shifts:
        if shifts is None:
            # shifts are an operator property: cache them so sequences
            # of right-hand sides skip the warmup (and its per-call
            # re-jit)
            sk = (
                id(A), int(s), id(kwargs.get("Ml")),
                id(kwargs.get("Mr")), b.reshape(-1).shape[0],
                shift_warmup,
            )
            shifts = _CA_SHIFTS_CACHE.get(sk)
            if shifts is None:
                shifts = newton_shifts(
                    A, b, s,
                    Ml=kwargs.get("Ml"), Mr=kwargs.get("Mr"), x0=x,
                    warmup=shift_warmup,
                )
                if len(_CA_SHIFTS_CACHE) >= _CA_RESTART_CACHE_MAX:
                    old = next(iter(_CA_SHIFTS_CACHE))
                    _CA_SHIFTS_CACHE.pop(old)
                    _CA_SHIFTS_KEEPALIVE.pop(old, None)
                # keep the id()-keyed objects alive with the values
                _CA_SHIFTS_CACHE[sk] = shifts
                _CA_SHIFTS_KEEPALIVE[sk] = (
                    A, kwargs.get("Ml"), kwargs.get("Mr"),
                )
        if isinstance(shifts, tuple):
            tre = np.asarray(shifts[0], real_np)
            tim = np.asarray(shifts[1], real_np)
        else:
            tre, tim = _ordered_shift_arrays(shifts, int(s), real_np)

    key_items = tuple(
        (kk, v if isinstance(v, (bool, int, float, str, type(None)))
         else id(v))
        for kk, v in sorted(kwargs.items())
    )
    key = (id(A), float(tol), maxiter, s, basis, needs_shifts, key_items)
    cycle = _CA_RESTART_CACHE.get(key)
    if cycle is None:
        if needs_shifts:

            @jax.jit
            def cycle(bb, x0, theta_re, theta_im):
                return ca_gmres(
                    A, bb, x0=x0, tol=tol, maxiter=maxiter, s=s,
                    basis=basis, shifts=(theta_re, theta_im),
                    return_internal=True, **kwargs,
                )
        else:

            @jax.jit
            def cycle(bb, x0):
                return ca_gmres(
                    A, bb, x0=x0, tol=tol, maxiter=maxiter, s=s,
                    basis=basis, return_internal=True, **kwargs,
                )

        cycle._keepalive = (A, kwargs)
        if len(_CA_RESTART_CACHE) >= _CA_RESTART_CACHE_MAX:
            _CA_RESTART_CACHE.pop(next(iter(_CA_RESTART_CACHE)))
        _CA_RESTART_CACHE[key] = cycle

    resnorms = []
    result = None
    for _ in range(max_restarts + 1):
        if needs_shifts:
            result, internal = cycle(
                b, x, jnp.asarray(tre), jnp.asarray(tim)
            )
        else:
            result, internal = cycle(b, x)
        nsteps = int(result.niter)
        nblocks = nsteps // max(int(s), 1)
        chunk = list(np.asarray(result.resnorms)[: nblocks + 1])
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        if int(result.status) in (CONVERGED, BREAKDOWN):
            break
        if needs_shifts and refresh_shifts and nsteps >= s:
            # re-seed from this cycle's Ritz values (host LAPACK on the
            # small recovered Hessenberg; shape-stable, no recompile)
            Hs = np.asarray(internal["H"])[:nsteps, :nsteps]
            ev = np.linalg.eigvals(Hs)
            ev = ev[np.isfinite(ev)]
            if ev.size:
                tre, tim = _ordered_shift_arrays(ev, int(s), real_np)

    return result._replace(
        resnorms=jnp.asarray(np.asarray(resnorms)),
        x=x,
    )
