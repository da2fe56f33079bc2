r"""Multi-shift GMRES: solve (A + sigma_i I) x_i = b for MANY shifts
from ONE Krylov basis.

Krylov spaces are shift-invariant -- :math:`K_m(A, b) = K_m(A + \sigma
I, b)` -- so a single Arnoldi basis serves every shifted system: the
per-shift work is a small projected least squares with
:math:`H + \sigma \bar I`, and the solution assembly for ALL shifts is
one ``(n_shifts, m) x (m, N)`` GEMM.  Standard tool for Tikhonov
parameter sweeps, rational matrix-function approximation, and
frequency-domain solves.

accelerator-native mapping: the expensive part (basis build) is the usual
batched-CGS2 Arnoldi; the per-shift small solves are ``jax.vmap`` over
the replicated ``(m+1, m)`` Hessenberg -- thousands of shifts cost one
batched QR on dense matrix-unit-shaped tiles; the assembly GEMM reads the basis
exactly once for all shifts.  The reference solves shifted systems one
at a time, rebuilding the Krylov space per shift (krypy has no
multi-shift surface).

Limitations (inherent to shift invariance, not this implementation):
no preconditioning (M(A + sigma I) is not a shifted family), Euclidean
inner product, zero initial guess (all systems must share the residual
direction b).
"""

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .arnoldi import arnoldi
from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    safe_div,
    system_dtype,
)

__all__ = [
    "shifted_cg",
    "shifted_gmres",
    "restarted_shifted_gmres",
    "ShiftedResult",
]


class ShiftedResult(NamedTuple):
    """Result of :func:`shifted_gmres`."""

    #: solutions, shape ``(n_shifts, N)`` (row i solves ``(A + shifts[i]
    #: I) x = b``)
    X: jnp.ndarray
    #: final relative residual per shift, shape ``(n_shifts,)``
    resnorms: jnp.ndarray
    #: Krylov steps actually built, shared by all shifts (the cycle
    #: dimension for single-cycle :func:`shifted_gmres`; the TOTAL over
    #: cycles for :func:`restarted_shifted_gmres`)
    niter: jnp.ndarray
    #: CONVERGED / MAXITER per shift, shape ``(n_shifts,)``
    status: jnp.ndarray

    @property
    def converged(self):
        return self.status == CONVERGED


def shifted_gmres(A, b, shifts, *, maxiter=50, tol=1e-8, ortho="cgs2"):
    r"""Solve the shifted family ``(A + shifts[i] I) x_i = b`` with one
    Krylov basis.

    :param A: operator (matvec / matrix / LinearOperator); the family
      member for shift 0.
    :param shifts: array of shifts ``(n_shifts,)``; complex shifts on a
      real operator promote the small solves (and the solutions) to
      complex while the basis build stays real.
    :param maxiter: Krylov dimension m (single cycle -- after a restart
      the shifted residuals lose collinearity, so this solver reports
      per-shift status honestly instead of restarting; raise m or
      deflate instead).
    :param tol: per-shift relative residual target.
    :return: :class:`ShiftedResult`.
    """
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = min(int(maxiter), N)
    shifts = jnp.asarray(shifts).reshape(-1)

    A_mv = as_matvec(A)
    dtype = system_dtype(bv)
    small_dtype = jnp.promote_types(dtype, shifts.dtype)
    shifts = shifts.astype(small_dtype)

    rel = arnoldi(A_mv, bv, maxiter=m, ortho=ortho)
    V, H, k = rel.V, rel.H, rel.niter
    beta = jnp.linalg.norm(bv)

    # masked fixed-shape least squares, one per shift (vmapped): columns
    # >= k are replaced by orthonormal unit columns so their y entries
    # vanish (same device idiom as ca_gmres's block LS)
    col_mask = jnp.arange(m) < k
    sub_diag = jnp.eye(m + 1, m, k=-1, dtype=small_dtype)
    shift_rows = jnp.eye(m + 1, m, dtype=small_dtype)
    rhs = jnp.zeros(m + 1, small_dtype).at[0].set(
        beta.astype(small_dtype)
    )
    Hs = H.astype(small_dtype)

    def solve_one(sigma):
        Hm = jnp.where(
            col_mask[None, :], Hs + sigma * shift_rows, sub_diag
        )
        q, r = jnp.linalg.qr(Hm, mode="reduced")
        y = jax.scipy.linalg.solve_triangular(
            r, jnp.dot(q.conj().T, rhs)
        )
        res = jnp.linalg.norm(rhs - jnp.dot(Hm, y))
        return y, res

    Y, res = jax.vmap(solve_one)(shifts)          # (s, m), (s,)

    # all solutions in ONE basis GEMM
    X = jnp.dot(Y, V[:m].astype(small_dtype))     # (s, N)

    rel_res = jax.vmap(lambda r: safe_div(r, beta))(res)
    status = jnp.where(rel_res <= tol, CONVERGED, MAXITER)
    return ShiftedResult(
        X=X, resnorms=rel_res, niter=k, status=status
    )


def restarted_shifted_gmres(
    A, b, shifts, *, maxiter=50, max_restarts=10, tol=1e-8,
    ortho="cgs2", seed=0, stagnation_window=3,
):
    r"""Restarted multi-shift GMRES with COLLINEAR residuals (the
    seed-system scheme of Frommer & Gl\"assner, SIAM J. Sci. Comput.
    19(1), 1998).

    Plain restarting breaks the multi-shift trick: after one cycle the
    shifted residuals point in different directions, so no single Krylov
    space serves the family (which is why :func:`shifted_gmres` is
    single-cycle by design).  The seed scheme restores it by
    construction: the seed shift runs ordinary restarted GMRES, and
    every other shift solves the SQUARE augmented system

    .. math:: [\,\bar H + \sigma_i \bar I \;|\; z\,]
              \begin{bmatrix} y_i \\ \zeta_i \end{bmatrix}
              = \beta_i e_1,

    where ``z`` is the seed's small-coordinate residual, which forces
    its new residual to be exactly :math:`\zeta_i` times the seed's.
    Starting from the shared residual ``b`` (zero initial guess), ALL
    residuals stay parallel to one direction by induction, every cycle
    rebuilds one basis from that direction, and each shift's
    collinearity factor is a scalar carried between cycles.

    Per cycle: one m-step Arnoldi + a vmapped batch of (m+1)-square
    solves + one ``(s, m) x (m, N)`` update GEMM -- same device shape
    as the single-cycle solver.  Final per-shift relative residuals are
    recomputed EXPLICITLY (s matvecs) so statuses are honest regardless
    of accumulated collinearity drift.

    :param seed: index into ``shifts`` of the INITIAL seed system
      (default 0).  After every cycle the seed moves to the shift with
      the largest implied residual -- a converged seed would misread
      its eps-level residual as subspace invariance and stall the rest
      of the family (the re-seeding remedy of the original paper);
      since residuals are collinear, any shift can take over seamlessly
      and the move costs no recompiles (the index is traced).
    :param stagnation_window: stop after this many cycles without
      improvement in the family's max implied residual and return the
      best snapshot (f32 solves stall at the attainable-accuracy floor
      and then diverge if pushed -- same guard as the other solvers);
      0 disables.
    :return: :class:`ShiftedResult` with ``niter`` = total Krylov steps.
    """
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = min(int(maxiter), N)
    shifts = jnp.asarray(shifts).reshape(-1)
    ns = shifts.shape[0]
    seed = int(seed)
    if not 0 <= seed < ns:
        raise ValueError(f"seed index {seed} outside [0, {ns})")

    A_mv = as_matvec(A)
    dtype = system_dtype(bv)
    small_dtype = jnp.promote_types(dtype, shifts.dtype)
    shifts = shifts.astype(small_dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    # after the first cycle the shared residual direction lives in the
    # promoted dtype (complex for complex shifts), so the basis build
    # runs there too
    A_mv = cast_matvec(A_mv, small_dtype)

    sub_diag = jnp.eye(m + 1, m, k=-1, dtype=small_dtype)
    shift_rows = jnp.eye(m + 1, m, dtype=small_dtype)
    e1 = jnp.zeros(m + 1, small_dtype).at[0].set(1.0)
    # z is in the e1-normalized small coordinates, so the happy-
    # breakdown test is relative to 1
    brk = float(breakdown_threshold(small_dtype))

    # compiled-cycle cache (same pattern and rationale as
    # gmres._RESTART_CACHE): a sequence of calls on the same operator,
    # shift count and options compiles exactly once.  The seed index is
    # a TRACED argument (re-seeding costs no recompiles).
    # tol/max_restarts are baked into the cached rescue driver, so they
    # are part of the key
    ckey = (
        id(A), m, ortho, ns, str(small_dtype), N, float(tol),
        int(max_restarts),
    )

    def cycle(r_dir, betas, X, sh, seed_idx):
        """One seed cycle.  ``r_dir`` is the shared unit residual
        direction, ``betas`` the per-shift collinearity factors
        (r_i = betas[i] * r_dir), ``X`` the iterates ``(ns, N)``,
        ``sh`` the traced shift values and ``seed_idx`` the traced seed
        index (the host re-seeds on the hardest shift each cycle)."""
        rel = arnoldi(A_mv, r_dir, maxiter=m, ortho=ortho)
        V, H, k = rel.V, rel.H, rel.niter
        col_mask = jnp.arange(m) < k
        Hs = H.astype(small_dtype)

        # seed: masked least squares at its shift
        Hseed = jnp.where(
            col_mask[None, :], Hs + sh[seed_idx] * shift_rows, sub_diag
        )
        q, r = jnp.linalg.qr(Hseed, mode="reduced")
        y_seed = jax.scipy.linalg.solve_triangular(
            r, jnp.dot(q.conj().T, e1)
        )
        z = e1 - jnp.dot(Hseed, y_seed)         # (m+1,) small residual
        znorm = jnp.linalg.norm(z)

        # z ~ 0 would make the augmented system [Hm | z] singular (its
        # QR emits NaN).  Because the host re-seeds on the HARDEST
        # shift each cycle, this fires only on genuine (numerical)
        # invariance of the Krylov space -- where the plain per-shift
        # least squares is exact for every shift.  lax.cond so the hot
        # path pays only one batched small solve.
        z_ok = znorm > brk

        def aug_branch(_):
            def one(sigma, beta_i):
                Hm = jnp.where(
                    col_mask[None, :], Hs + sigma * shift_rows, sub_diag
                )
                Msq = jnp.concatenate([Hm, z[:, None]], axis=1)
                qq, rr = jnp.linalg.qr(Msq, mode="reduced")
                w = jax.scipy.linalg.solve_triangular(
                    rr, jnp.dot(qq.conj().T, beta_i * e1)
                )
                return w[:m], w[m]               # y_i, zeta_i

            Ys, zetas = jax.vmap(one)(sh, betas)
            # the seed's own row: r_seed_new = beta_seed * z, i.e.
            # y = beta_seed * y_seed, zeta = beta_seed
            Ys = Ys.at[seed_idx].set(betas[seed_idx] * y_seed)
            zetas = zetas.at[seed_idx].set(betas[seed_idx])
            r_new = jnp.dot(z, V.astype(small_dtype))
            return (
                Ys,
                zetas * znorm,
                r_new * safe_div(1.0, znorm),
            )

        def plain_branch(_):
            def one(sigma, beta_i):
                Hm = jnp.where(
                    col_mask[None, :], Hs + sigma * shift_rows, sub_diag
                )
                qp, rp = jnp.linalg.qr(Hm, mode="reduced")
                y_p = jax.scipy.linalg.solve_triangular(
                    rp, jnp.dot(qp.conj().T, beta_i * e1)
                )
                res_p = jnp.linalg.norm(
                    beta_i * e1 - jnp.dot(Hm, y_p)
                )
                return y_p, res_p

            Ys, resn = jax.vmap(one)(sh, betas)
            return Ys, resn.astype(small_dtype), r_dir

        Ys, betas_new, r_dir_new = lax.cond(
            z_ok, aug_branch, plain_branch, None
        )
        X = X + jnp.dot(Ys, V[:m].astype(small_dtype))
        absb = jnp.abs(betas_new)
        # ONE host fetch per cycle:
        # [max residual, krylov steps, hardest-shift index]
        stats = jnp.stack([
            jnp.max(absb).astype(real_dtype),
            k.astype(real_dtype),
            jnp.argmax(absb).astype(real_dtype),
        ])
        return r_dir_new, betas_new, X, stats

    cached = _SEED_CYCLE_CACHE.get(ckey)
    if cached is None:
        from .gmres import restarted_gmres as _rg

        jcycle = jax.jit(cycle)
        # cached residual checker: a fresh jit per call would recompile
        # the ns-matvec check on every solve (review finding)
        jcheck = jax.jit(
            lambda XX, ss, bb: lax.map(
                lambda xs: jnp.linalg.norm(
                    bb - (A_mv(xs[0]) + xs[1] * xs[0])
                ),
                (XX, ss),
            )
        )
        # cached per-shift rescue driver (shift traced): the collinear
        # premise can break legitimately -- e.g. an easy seed reaching
        # eps within cycle 1 forces the plain fallback, after which the
        # family's residuals are NOT parallel -- and then the implied
        # factors under-report.  Unconverged shifts finish with honest
        # per-shift restarted GMRES from their current iterates.
        jrescue = jax.jit(
            lambda bb, x0, sg: _rg(
                lambda v: A_mv(v) + sg * v, bb, x0=x0, maxiter=m,
                max_restarts=int(max_restarts), tol=float(tol),
                compiled=True,
            )
        )
        cached = (jcycle, jcheck, jrescue)
        cached[0]._keepalive = (A,)
        if len(_SEED_CYCLE_CACHE) >= _SEED_CYCLE_CACHE_MAX:
            _SEED_CYCLE_CACHE.pop(next(iter(_SEED_CYCLE_CACHE)))
        _SEED_CYCLE_CACHE[ckey] = cached
    jcycle, jcheck, jrescue = cached

    bnorm = jnp.linalg.norm(bv)
    r_dir = (bv * safe_div(1.0, bnorm)).astype(small_dtype)
    betas = jnp.full(ns, bnorm, small_dtype)
    X = jnp.zeros((ns, N), small_dtype)
    total_k = 0
    # f32 floor guard (CLAUDE.md: solves stall at the attainable floor
    # and then DIVERGE if pushed further): keep the best-X snapshot and
    # stop after `stagnation_window` cycles without improvement
    best = float("inf")
    X_best = X
    stall = 0
    bnorm_f = float(bnorm)
    seed_idx = seed
    for _ in range(int(max_restarts) + 1):
        r_dir, betas, X, stats = jcycle(
            r_dir, betas, X, shifts, jnp.asarray(seed_idx, jnp.int32)
        )
        stats_h = np.asarray(stats)
        absmax, k = float(stats_h[0]), int(stats_h[1])
        total_k += k
        if absmax < best:
            best, X_best, stall = absmax, X, 0
        else:
            stall += 1
        if absmax <= tol * bnorm_f:
            break
        if stagnation_window and stall >= stagnation_window:
            break
        # re-seed on the hardest shift (Frommer-Glassner): a converged
        # seed would otherwise misread its eps-level residual as
        # invariance and stall the rest of the family
        seed_idx = int(stats_h[2])
    X = X_best

    # honest statuses: explicit true residuals (ns matvecs, one
    # compiled dispatch; lax.map so user matvecs only ever see 1-D
    # vectors -- vmap would impose a batching requirement no other
    # solver in the lane does)
    true_res = jcheck(X, shifts, bv.astype(small_dtype))
    rel_res = np.asarray(
        (true_res / jnp.maximum(bnorm, jnp.finfo(
            real_dtype).tiny)).real.astype(real_dtype)
    )
    # rescue pass: finish shifts the collinear scheme left unconverged
    # (per-shift restarted GMRES from the current iterates, up to the
    # same restart budget each -- never worse than the sequential
    # baseline, and a no-op when the fast path converged everything)
    for i in np.nonzero(rel_res > tol)[0]:
        ri = jrescue(
            bv.astype(small_dtype), X[i], shifts[i]
        )
        total_k += int(ri.niter)
        X = X.at[i].set(ri.x.astype(small_dtype))
    if bool(np.any(rel_res > tol)):
        true_res = jcheck(X, shifts, bv.astype(small_dtype))
        rel_res = np.asarray(
            (true_res / jnp.maximum(bnorm, jnp.finfo(
                real_dtype).tiny)).real.astype(real_dtype)
        )
    rel_res = jnp.asarray(rel_res)
    status = jnp.where(rel_res <= tol, CONVERGED, MAXITER)
    return ShiftedResult(
        X=X, resnorms=rel_res, niter=jnp.asarray(total_k),
        status=status,
    )


#: compiled seed-cycle cache (same pattern/rationale as
#: gmres._RESTART_CACHE)
_SEED_CYCLE_CACHE = {}
_SEED_CYCLE_CACHE_MAX = 16


class _ShiftedCgState(NamedTuple):
    k: jnp.ndarray
    x: jnp.ndarray            # (s, N) shifted iterates
    ps: jnp.ndarray           # (s, N) shifted directions
    r: jnp.ndarray            # (N,) BASE residual
    p: jnp.ndarray            # (N,) base direction
    rho: jnp.ndarray          # (r, r) of the base system
    zeta: jnp.ndarray         # (s,)
    zeta_old: jnp.ndarray     # (s,)
    alpha_old: jnp.ndarray
    beta_old: jnp.ndarray
    x_best: jnp.ndarray       # (s, N) snapshot at the best seed residual
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    done: jnp.ndarray
    # --- one-reduce (variant="1r") extras; zero-size in the classic ---
    s_dir: jnp.ndarray        # (N,) coupled direction recurrence A p
    delta: jnp.ndarray        # <r, A r>


def shifted_cg(A, b, shifts, *, maxiter=None, tol=1e-8,
               stagnation_window=None, variant="classic"):
    r"""Solve the SPD shifted family ``(A + shifts[i] I) x_i = b`` by
    multi-shift CG in one compiled while_loop.

    The seed system (shift 0) drives an ordinary CG recurrence; every
    shifted system rides it through the :math:`\zeta` scalar recurrence
    (the multi-mass solver of the lattice-QCD literature, after
    Jegerlehner 1996): its residual is the COLLINEAR vector
    :math:`r_k^\sigma = \zeta_k^\sigma r_k`, so per iteration the whole
    family costs ONE matvec, the base system's 2 reductions (independent
    of the number of shifts), and rank-1 elementwise updates of the
    ``(n_shifts, N)`` iterate/direction blocks.  Memory is two
    N-vectors per shift -- constant in iteration count, unlike
    :func:`shifted_gmres`'s basis.

    Requires SPD ``A`` and real ``shifts >= 0`` (each family member must
    stay SPD; the seed is the hardest system, so its convergence
    dominates).  Final statuses are verified against explicitly
    recomputed per-shift true residuals (one vmapped matvec sweep).

    :param stagnation_window: float32 attainable-accuracy guard on the
      SEED residual (shifts >= 0 only improve conditioning, so every
      family member floors no later than the seed): after this many
      iterations without a new seed-residual minimum the solve stops
      and the iterates snapshotted at the best seed residual are
      returned -- a reduced-precision CG pushed past its floor
      DIVERGES, so returning the final iterate would be garbage.
      Defaults to ``max(50, maxiter // 10)`` (the Euclidean CG residual
      oscillates with long plateaus on hard spectra, so the window must
      scale with the budget); 0 disables.  Costs one extra
      (n_shifts, N) buffer when enabled.

    :param variant: ``"classic"`` (2 reductions per iteration:
      :math:`\langle p, Ap\rangle` and the residual norm, independent
      of the number of shifts), ``"1r"`` (single-reduction
      Chronopoulos-Gear rearrangement of the SEED recurrence: the
      coupled ``s = A p`` recurrence derives :math:`\alpha` from
      :math:`\gamma = \langle r, r\rangle`,
      :math:`\delta = \langle r, A r\rangle`, both out of ONE stacked
      contraction -- so the ENTIRE multi-mass family costs one
      all-reduce per iteration), or ``"auto"`` (``"1r"`` under a
      multi-device mesh context).

    :return: :class:`ShiftedResult` (``resnorms`` holds the final TRUE
      relative residual per shift).
    """
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = N if maxiter is None else int(maxiter)
    if stagnation_window is None:
        stagnation_window = max(50, maxiter // 10)
    shifts = jnp.asarray(shifts).reshape(-1)
    s = shifts.shape[0]

    A_mv = as_matvec(A)
    dtype = system_dtype(bv)
    bv = bv.astype(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    sig = shifts.astype(real_dtype)

    bnorm = jnp.linalg.norm(bv)
    rho0 = jnp.real(jnp.vdot(bv, bv)).astype(real_dtype)

    if variant == "auto":
        # priced selection (shared model, krypy_tpu/functional/policy.py)
        from ..parallel import active_mesh_size
        from . import policy

        _mesh_n = active_mesh_size()
        variant = (
            "1r"
            if _mesh_n > 1
            and policy.prefer_one_reduce(
                "shifted_cg", N // _mesh_n, jnp.dtype(dtype).itemsize
            )
            else "classic"
        )
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown shifted_cg variant {variant!r}")
    one_reduce = variant == "1r"

    def body(st):
        if one_reduce:
            # Chronopoulos-Gear on the seed: alpha from the
            # gamma/delta recurrence, the coupled s = A p direction,
            # and ONE stacked contraction for gamma_new/delta_new --
            # the single all-reduce of the whole multi-mass iteration
            pAp = st.delta - st.beta_old / jnp.where(
                st.alpha_old == 0, 1.0, st.alpha_old
            ) * st.rho
            alpha = safe_div(st.rho, pAp)
            r_new = st.r - alpha.astype(dtype) * st.s_dir
            w_new = A_mv(r_new)
            both = jnp.real(
                jnp.einsum("kn,n->k", jnp.stack([r_new, w_new]).conj(),
                           r_new)
            ).astype(real_dtype)
            rho_new = jnp.maximum(both[0], 0.0)
            delta_new = both[1]
            beta = safe_div(rho_new, st.rho)
            s_new = w_new + beta.astype(dtype) * st.s_dir
        else:
            Ap = A_mv(st.p)
            pAp = jnp.real(jnp.vdot(st.p, Ap)).astype(real_dtype)
            alpha = safe_div(st.rho, pAp)

            # base residual/direction update (the seed system's iterate
            # is x[seed-shift rows]; the seed rides the same shifted
            # recurrence with sigma = 0 ... except we keep it implicit:
            # every row of x uses the zeta recurrence, which reduces to
            # the plain CG update for sigma = 0, zeta = 1)
            r_new = st.r - alpha.astype(dtype) * Ap
            rho_new = jnp.real(jnp.vdot(r_new, r_new)).astype(real_dtype)
            beta = safe_div(rho_new, st.rho)
            s_new, delta_new = st.s_dir, st.delta

        # zeta recurrence (denominator guarded; a vanishing denominator
        # marks the shift as stalled, not NaN)
        den = (
            alpha * st.beta_old * (st.zeta_old - st.zeta)
            + st.zeta_old * st.alpha_old * (1.0 + sig * alpha)
        )
        zeta_new = safe_div(
            st.zeta * st.zeta_old * st.alpha_old, den
        )
        ratio = safe_div(zeta_new, st.zeta)
        alpha_s = alpha * ratio
        beta_s = beta * ratio**2

        x = st.x + alpha_s[:, None].astype(dtype) * st.ps
        ps = (
            zeta_new[:, None].astype(dtype) * r_new[None, :]
            + beta_s[:, None].astype(dtype) * st.ps
        )
        # the base direction p only feeds <p, Ap> -- which the 1r
        # recurrence replaces -- so skip its axpy there
        p = st.p if one_reduce else r_new + beta.astype(dtype) * st.p

        # stop when every shifted residual |zeta| ||r|| meets tol
        rel = jnp.abs(zeta_new) * jnp.sqrt(
            jnp.maximum(rho_new, 0.0)
        ) * safe_div(1.0, bnorm)
        done = jnp.all(rel <= tol)

        # seed-residual stagnation guard with best-iterate snapshots
        seed_rel = jnp.sqrt(jnp.maximum(rho_new, 0.0)) * safe_div(
            1.0, bnorm
        )
        improved = seed_rel < st.best_rel
        best_rel = jnp.minimum(seed_rel, st.best_rel)
        stall = jnp.where(improved, 0, st.stall + 1)
        x_best = jnp.where(improved, x, st.x_best)
        return _ShiftedCgState(
            st.k + 1, x, ps, r_new, p, rho_new, zeta_new, st.zeta,
            alpha, beta, x_best, best_rel, stall, done,
            s_new, delta_new,
        )

    def cond(st):
        go = (~st.done) & (st.k < maxiter)
        if stagnation_window > 0:
            go = go & (st.stall < stagnation_window)
        return go

    ones = jnp.ones(s, real_dtype)
    if one_reduce:
        s0 = A_mv(bv)  # s_0 = A p_0 = A r_0
        extras = (
            s0,
            jnp.real(jnp.vdot(bv, s0)).astype(real_dtype),
        )
    else:
        extras = (
            jnp.zeros(0, dtype),
            jnp.asarray(0.0, real_dtype),
        )
    init = _ShiftedCgState(
        jnp.asarray(0),
        jnp.zeros((s, N), dtype),
        jnp.broadcast_to(bv, (s, N)).astype(dtype),
        bv,
        bv,
        rho0,
        ones,
        ones,
        jnp.asarray(1.0, real_dtype),
        jnp.asarray(0.0, real_dtype),
        jnp.zeros((s, N), dtype),
        jnp.asarray(jnp.inf, real_dtype),
        jnp.asarray(0),
        jnp.asarray(False),
        *extras,
    )
    final = lax.while_loop(cond, body, init)
    if stagnation_window > 0:
        # the seed residual is non-monotone (Euclidean CG), so a
        # CONVERGED exit keeps the final iterate; the best-seed
        # snapshot only replaces it on a stagnation exit (where the
        # final iterate may have diverged past the f32 floor)
        X = jnp.where(final.done, final.x, final.x_best)
    else:
        X = final.x

    # explicit per-shift true residuals (honesty: the zeta recurrence
    # can drift at the attainable-accuracy floor)
    AX = jax.vmap(A_mv)(X)
    R = bv[None, :] - AX - sig[:, None].astype(dtype) * X
    rel = jax.vmap(
        lambda rr: safe_div(jnp.linalg.norm(rr), bnorm)
    )(R)
    status = jnp.where(rel <= tol, CONVERGED, MAXITER)
    return ShiftedResult(
        X=X, resnorms=rel, niter=final.k, status=status
    )
