r"""IDR(s): induced-dimension-reduction solver for nonsymmetric systems.

IDR(s) (Sonneveld & van Gijzen, SIAM J. Sci. Comput. 31(2), 2008; the
biorthogonal variant implemented here is van Gijzen & Sonneveld, ACM
TOMS 38(1), 2011, "Algorithm 913") confines successive residuals to a
shrinking chain of Sonneveld spaces :math:`G_j` and terminates -- in
exact arithmetic -- within :math:`N + N/s` matvecs.  It fills the gap
between the two existing transpose-free short-recurrence cores:
BiCGStab is (mathematically) IDR(1), while larger ``s`` buys GMRES-like
robustness on strongly nonsymmetric/indefinite spectra at a fixed
memory footprint of :math:`2s+2` long vectors -- the nonsymmetric
memory-scaling lever of SURVEY.md section 5.7 with a dial on it.

accelerator-native design: the shadow block :math:`P` is a fixed orthonormal
``(s, N)`` panel, so every projection :math:`P^* v` in the recurrence
is ONE ``(s, N) x (N,)`` contraction (= one all-reduce on a sharded
mesh) instead of ``s`` sequential dots; the inner ``k = 0..s-1`` stage
loop is unrolled at trace time (``s`` is static), keeping all shapes
fixed; the whole solve is one ``lax.while_loop`` whose body performs a
full IDR cycle (``s + 1`` matvecs).  Small ``(s, s)`` systems are
solved replicated on device via triangular substitution.

Honesty contract as in the sibling cores: non-monotone convergence plus
reduced-precision floors are handled by the stagnation guard and the
explicit-residual policy; rho/omega/pivot breakdowns are detected
on-device and reported as BREAKDOWN with the last iterate.

``variant="1r"`` (round 5) compresses the cycle to EXACTLY one
all-reduce per matvec -- s+1 sync points per cycle instead of the
classic ~2/matvec: each inner step's two shadow projections (the
biorthogonalization right-hand side ``P^H g`` and the M-column) come
out of ONE stacked contraction whose extra rows also measure the
anchors ``<r, g>``, ``<r, r>``, ``<g_i, g>`` and a FRESH ``f = P^H r``
(so every norm/f expansion is one-step-fresh, the MINRES nu lesson);
the omega step folds ``<t,t>``, ``<t,r>``, ``<r,r>`` AND the next
cycle's ``f`` into one (s+2, N) x (N, 2) cross-Gram, eliminating the
cycle-start projection entirely.  The small corrections (``M``-column
and ``g``-Gram updates) are replicated O(s^2) work.

Reference baseline: krypy has no IDR surface (its nonsymmetric answer
is GMRES, krypy/linsys.py:877-1018); accelerator-native addition.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

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

__all__ = ["idrs"]


class _IdrState(NamedTuple):
    it: jnp.ndarray          # matvec count (s+1 per cycle)
    x: jnp.ndarray
    r: jnp.ndarray
    U: jnp.ndarray           # (s, N) direction block
    G: jnp.ndarray           # (s, N) A-image block
    Mmat: jnp.ndarray        # (s, s) shadow Gram, lower triangular
    om: jnp.ndarray
    cur_rel: jnp.ndarray
    best_rel: jnp.ndarray
    stall: jnp.ndarray
    broken: jnp.ndarray
    resnorms: jnp.ndarray
    # --- one-reduce (variant="1r") extras; zeros in classic ---
    f: jnp.ndarray           # (s,) carried shadow projections P^H r
    GG: jnp.ndarray          # (s, s) Gram <g_i, g_j> of current G rows


def _shadow_block(key, s, N, dtype, r0):
    """Fixed orthonormal (s, N) shadow panel; row 0 is the normalized
    initial residual (standard choice: guarantees progress on the first
    cycle), the rest Haar-ish via QR of a Gaussian block."""
    kr, ki = jax.random.split(key)
    real_dtype = jnp.zeros(0, dtype).real.dtype
    block = jax.random.normal(kr, (N, s), real_dtype).astype(dtype)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        block = block + 1j * jax.random.normal(ki, (N, s), real_dtype).astype(
            dtype
        )
    r0n = r0 * safe_div(1.0, jnp.linalg.norm(r0))
    block = block.at[:, 0].set(r0n)
    Q, _ = jnp.linalg.qr(block)          # tall-skinny, s columns
    return Q.T                           # (s, N); P P^* = I


def idrs(
    A,
    b,
    *,
    s=4,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=0,
    explicit_residual=False,
    seed=0,
    variant="classic",
):
    """Solve nonsymmetric ``A x = b`` by IDR(s) with biorthogonal
    shadow-space recurrences, in one compiled while_loop.

    :param s: Sonneveld-space codimension (static; memory is ``2s + 2``
      long vectors).  ``s = 1`` is BiCGStab-class; ``s = 4`` (default)
      is the standard robustness/memory trade; ``s = 8`` approaches
      GMRES convergence on hard spectra.
    :param M: optional preconditioner matvec, applied as a RIGHT
      preconditioner inside the recurrence (the tracked residual is the
      true residual of the original system).
    :param maxiter: bound on the number of matvecs (default ``N``).  A
      cycle of ``s + 1`` matvecs always completes, so up to ``s`` extra
      matvecs past ``maxiter`` may run.
    :param stagnation_window: if > 0, stop after this many cycle checks
      without improving the best residual (IDR convergence is
      non-monotone; this is the honest stop at the f32 floor).
    :param seed: PRNG seed for the fixed shadow panel.
    :param variant: ``"classic"`` (~2 all-reduces per matvec: the
      cycle-start shadow projection, two projections + a norm per inner
      step, four reductions in the omega step), ``"1r"`` (exactly ONE
      all-reduce per matvec -- s+1 stacked cross-Gram contractions per
      cycle, see module docstring), or ``"auto"`` (the shared
      :mod:`~krypy_tpu.functional.policy` price model picks ``"1r"``
      under a mesh whose sync cost exceeds the extra operand-stack
      traffic).
    :return: :class:`~krypy_tpu.functional.common.SolveResult` with
      ``resnorms`` indexed by matvec count (NaN beyond the last entry).
    """
    b = jnp.asarray(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = N if maxiter is None else int(maxiter)
    s = int(s)
    if s < 1:
        raise ValueError("idrs requires s >= 1")

    A_mv = as_matvec(A)
    M_mv = as_matvec(M)
    dtype = system_dtype(bv, x0)
    bv = bv.astype(dtype)
    A_mv, M_mv = (cast_matvec(f, dtype) for f in (A_mv, M_mv))
    real_dtype = jnp.zeros(0, dtype).real.dtype

    if variant == "auto":
        from ..parallel import active_mesh_size
        from . import policy

        _mesh_n = active_mesh_size()
        variant = (
            "1r"
            if _mesh_n > 1
            and policy.prefer_one_reduce(
                "idrs", N // _mesh_n, jnp.dtype(dtype).itemsize,
                syncs_saved=1,  # per matvec: ~2 -> 1
            )
            else "classic"
        )
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown idrs variant {variant!r}")
    one_reduce = variant == "1r"

    x0v = (
        jnp.zeros(N, dtype)
        if x0 is None
        else jnp.asarray(x0).reshape(-1).astype(dtype)
    )

    bnorm = jnp.linalg.norm(bv)
    r0 = bv - A_mv(x0v)
    rel0 = safe_div(jnp.linalg.norm(r0), bnorm)

    P = _shadow_block(jax.random.PRNGKey(seed), s, N, dtype, r0)
    Pc = P.conj()

    eps = jnp.asarray(jnp.finfo(real_dtype).tiny * 1e4, real_dtype)
    angle = jnp.asarray(0.7, real_dtype)  # omega maintenance threshold

    nbuf = maxiter + s + 2  # cycles overrun maxiter by at most s matvecs

    def body(state):
        x, r = state.x, state.r
        U, G, Mmat, GG = state.U, state.G, state.Mmat, state.GG
        resnorms = state.resnorms
        broken = state.broken
        it = state.it

        # "1r": carried from the previous cycle's omega cross-Gram and
        # re-anchored on a fresh measurement at every inner step below.
        # classic: one dedicated (s, N) contraction per cycle.
        f = state.f if one_reduce else Pc @ r

        # s intermediate steps; k is static (unrolled), so all slices
        # below are static-shape.
        for k in range(s):
            Msub = Mmat[k:, k:]
            c = solve_triangular(Msub, f[k:], lower=True)
            v = r - c @ G[k:, :]
            v = apply(M_mv, v)
            u_k = state.om * v + c @ U[k:, :]
            g_t = A_mv(u_k)
            if one_reduce:
                # THE one fused reduction of the step: a
                # (s+2+k, N) x (N, 2) contraction carrying the shadow
                # projections P^H g_t (biorthogonalization rhs AND
                # M-column source), the measured anchors f = P^H r,
                # <r, g_t>, ||r||^2, ||g_t||^2, and the <g_i, g_t> /
                # <g_i, r> couplings that close the one-step norm
                # expansions.  Everything downstream is replicated
                # O(s^2) work.
                L = jnp.concatenate(
                    [Pc, r.conj()[None], g_t.conj()[None], G[:k].conj()],
                    axis=0,
                )
                R = jnp.stack([g_t, r], axis=1)
                Gm = L @ R
                h = Gm[:s, 0]                  # P^H g_t
                f_meas = Gm[:s, 1]             # fresh P^H r (anchor)
                r_gt = Gm[s, 0]                # <r, g_t>
                rr_m = jnp.real(Gm[s, 1])      # ||r||^2 (anchor)
                gt_gt = jnp.real(Gm[s + 1, 0])
                gi_gt = Gm[s + 2:, 0]          # <g_i, g_t>, i < k
                gi_r = Gm[s + 2:, 1]           # <g_i, r>,  i < k
                if k > 0:
                    alphas = solve_triangular(
                        Mmat[:k, :k], h[:k], lower=True
                    )
                    g_k = g_t - alphas @ G[:k, :]
                    u_k = u_k - alphas @ U[:k, :]
                    # M-column by one-step expansion (the measured h is
                    # this step's anchor; nothing is carried)
                    Mcol = h[k:] - Mmat[k:, :k] @ alphas
                    r_gk = r_gt - jnp.sum(alphas * jnp.conj(gi_r))
                    gg_col = gi_gt - GG[:k, :k] @ alphas  # <g_i, g_k>
                    gk_gk = jnp.maximum(
                        gt_gt
                        - 2.0
                        * jnp.real(jnp.sum(jnp.conj(alphas) * gi_gt))
                        + jnp.real(
                            jnp.vdot(alphas, GG[:k, :k] @ alphas)
                        ),
                        0.0,
                    )
                    GG = GG.at[:k, k].set(gg_col)
                    GG = GG.at[k, :k].set(gg_col.conj())
                else:
                    g_k = g_t
                    Mcol = h
                    r_gk = r_gt
                    gk_gk = gt_gt
                GG = GG.at[k, k].set(gk_gk.astype(dtype))
            else:
                g_k = g_t
                # Biorthogonalize the new pair against shadow rows < k.
                # The stored g_i are only TRIANGULARLY biorthogonal
                # (p_i^* g_j = M[i,j] != 0 for i > j), so the
                # reference's sequential update (one dot per i) is
                # equivalent to solving the small lower-triangular
                # system M[:k,:k] alpha = P[:k]^* g_k -- which needs
                # just ONE fused (k, N) x (N,) contraction here.
                if k > 0:
                    alphas = solve_triangular(
                        Mmat[:k, :k], Pc[:k] @ g_k, lower=True
                    )
                    g_k = g_k - alphas @ G[:k, :]
                    u_k = u_k - alphas @ U[:k, :]
                Mcol = Pc[k:] @ g_k
            Mmat = Mmat.at[k:, k].set(Mcol)
            Mkk = Mmat[k, k]
            broken = broken | (jnp.abs(Mkk) <= eps)
            if one_reduce:
                beta = safe_div(f_meas[k], Mkk)
            else:
                beta = safe_div(f[k], Mkk)
            r = r - beta * g_k
            x = x + beta * u_k
            if one_reduce:
                # f for the next step: fresh measurement minus the one
                # exact recurrence step <p_j, r'> = <p_j, r> - beta M[j,k]
                ph = jnp.zeros(s, dtype).at[k:].set(Mcol)
                f = f_meas - beta * ph
                rr_new = jnp.maximum(
                    rr_m
                    - 2.0 * jnp.real(beta * r_gk)
                    + jnp.abs(beta) ** 2 * gk_gk,
                    0.0,
                )
                rel_k = safe_div(jnp.sqrt(rr_new), bnorm)
            elif k + 1 < s:
                f = f.at[k + 1:].set(f[k + 1:] - beta * Mmat[k + 1:, k])
            if not one_reduce:
                rel_k = safe_div(jnp.linalg.norm(r), bnorm)
            G = G.at[k].set(g_k)
            U = U.at[k].set(u_k)
            resnorms = resnorms.at[it + k + 1].set(rel_k)

        # omega step: r is now in G_j; one minimal-residual polynomial
        # factor moves it toward G_{j+1}, with van Gijzen's "maintaining
        # the convergence" safeguard on the angle between t and r.
        v = apply(M_mv, r)
        t = A_mv(v)
        if one_reduce:
            # one (s+2, N) x (N, 2) cross-Gram: <t,t>, <t,r>, <r,r>
            # AND the next cycle's f = P^H (r - om t) -- the
            # cycle-start shadow projection is gone entirely.
            L2 = jnp.concatenate(
                [Pc, t.conj()[None], r.conj()[None]], axis=0
            )
            R2 = jnp.stack([t, r], axis=1)
            G2 = L2 @ R2
            f_t = G2[:s, 0]
            f_r = G2[:s, 1]
            tt = jnp.real(G2[s, 0])
            ts = G2[s, 1]                      # <t, r>
            rr_m2 = jnp.real(G2[s + 1, 1])     # ||r||^2 (anchor)
            tn = jnp.sqrt(jnp.maximum(tt, 0.0))
            rn = jnp.sqrt(jnp.maximum(rr_m2, 0.0))
            om = safe_div(ts, tt)
        else:
            tn = jnp.linalg.norm(t)
            rn = jnp.linalg.norm(r)
            ts = jnp.vdot(t, r)
            om = safe_div(ts, jnp.real(jnp.vdot(t, t)))
        rho = safe_div(jnp.abs(ts), tn * rn)
        om = om * jnp.where(rho < angle, safe_div(angle, rho), 1.0)
        broken = broken | (jnp.abs(om) <= eps)
        x = x + om * v
        r = r - om * t

        it = it + s + 1
        if one_reduce:
            rr_om = jnp.maximum(
                rr_m2
                - 2.0 * jnp.real(jnp.conj(om) * ts)
                + jnp.abs(om) ** 2 * tt,
                0.0,
            )
            rel_upd = safe_div(jnp.sqrt(rr_om), bnorm)
            f = f_r - om * f_t
        else:
            rel_upd = safe_div(jnp.linalg.norm(r), bnorm)
        need_explicit = (
            explicit_residual | (rel_upd <= tol) | (it >= maxiter)
        )

        def with_explicit(_):
            return safe_div(jnp.linalg.norm(bv - A_mv(x)), bnorm)

        rel = lax.cond(need_explicit, with_explicit, lambda _: rel_upd, None)
        broken = broken | ~jnp.isfinite(rel)

        improved = rel < 0.99 * state.best_rel
        stall = jnp.where(improved, 0, state.stall + 1)
        best = jnp.minimum(rel, state.best_rel)
        resnorms = resnorms.at[it].set(rel)
        return _IdrState(
            it, x, r, U, G, Mmat, om, rel, best, stall, broken, resnorms,
            f, GG,
        )

    def cond(state):
        go = (
            (state.cur_rel > tol)
            & (state.it < maxiter)
            & ~state.broken
        )
        if stagnation_window > 0:
            go = go & (state.stall < stagnation_window)
        return go

    # "1r" seeds the carried shadow projections once at entry; the loop
    # body then refreshes them from its own cross-Grams.
    f0 = (Pc @ r0) if one_reduce else jnp.zeros(s, dtype)
    init = _IdrState(
        jnp.asarray(0),
        x0v,
        r0,
        jnp.zeros((s, N), dtype),
        jnp.zeros((s, N), dtype),
        jnp.eye(s, dtype=dtype),
        jnp.asarray(1.0, dtype),
        rel0,
        rel0,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.full(nbuf, jnp.nan, real_dtype).at[0].set(rel0),
        f0,
        jnp.zeros((s, s), dtype),
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
        niter=final.it,
        status=status,
    )
