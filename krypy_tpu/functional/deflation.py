r"""Jitted deflated GMRES and the accelerator-native recycling loop.

Deflation in the functional lane (reference semantics:
krypy/deflation.py:32-143, rebuilt for compile-once execution):

1. the deflation basis U (static width d) is orthonormalized on device in
   the relevant inner product;
2. the operator is wrapped as :math:`v \mapsto (I-P)\,M_l A M_r\,v` where
   P is the oblique projection with range
   :math:`\operatorname{colspan}(M_lAM_rU)` and kernel
   :math:`\operatorname{colspan}(U)^\perp`, applied twice per Stewart's
   round-off analysis;
3. every candidate solution is corrected by solving the d-dimensional
   deflation component of its residual;
4. the Gram column :math:`\langle U, M_lAM_r v_k\rangle` is captured each
   iteration into the C buffer carried through the while_loop, so the
   spectral machinery (Ritz values for recycling) has all small matrices
   available after ONE device dispatch.

All N-dim work (QR of U, projection applications, correction) consists of
``(d, N)``-by-``(N,)`` contractions that shard over the mesh like the
solver itself; the d x d factors are replicated.
"""

import time

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .common import apply, as_matvec, make_inner, safe_div
from .. import spectral
# note: the package re-exports the gmres *function* under the same name,
# so bind the submodule explicitly through sys.modules
import importlib

_gmres_mod = importlib.import_module("krypy_tpu.functional.gmres")

__all__ = [
    "deflated_gmres",
    "deflated_cg",
    "deflated_minres",
    "weighted_qr",
    "ritz_pairs",
    "assemble_ritz_vectors",
    "ritz_deflation_vectors",
    "RecyclingGmres",
    "AutoRecyclingGmres",
]


def weighted_qr(U, ip=None, passes=2):
    """Orthonormalize the columns of ``(N, d)`` in the ``ip`` inner
    product via blocked classical Gram-Schmidt (``passes`` sweeps).

    Returns ``(Q, R)`` with R upper triangular; jit-friendly (d static).
    """
    pair, rows = make_inner(ip)
    N, d = U.shape
    if d == 0:
        return U, jnp.zeros((0, 0), U.dtype)
    cols = []
    R = jnp.zeros((d, d), U.dtype)
    for i in range(d):
        v = U[:, i]
        for _ in range(passes):
            if cols:
                Q = jnp.stack(cols, axis=0)  # (i, N)
                coeffs = rows(Q, v)
                v = v - jnp.dot(coeffs, Q)
                R = R.at[:i, i].add(coeffs)
        nrm = jnp.sqrt(jnp.maximum(jnp.real(pair(v, v)), 0.0))
        R = R.at[i, i].set(nrm.astype(U.dtype))
        v = v * safe_div(1.0, nrm)
        cols.append(v)
    return jnp.stack(cols, axis=1), R


class DeflationOperator(NamedTuple):
    """Precomputed deflation data (a pytree; closes over no tracers)."""

    Uo: jnp.ndarray      # (N, d) orthonormalized deflation basis
    AU: jnp.ndarray      # (N, d) = MlAMr Uo
    W2: jnp.ndarray      # (N, d) orthonormal basis of AU (in ip)
    G: jnp.ndarray       # (d, d) = <Uo, W2>, the oblique coupling
    E: jnp.ndarray       # (d, d) = <Uo, AU>


def _ip_for_U(ip, M, Minv, ip_defl):
    """Inner product in which the deflation basis is orthonormalized.

    Reference semantics (krypy/linsys.py:163-176 get_ip_Minv_B +
    krypy/deflation.py:40): with an inner-product-changing preconditioner
    M the basis must be orthonormal in :math:`\\langle x, M^{-1}y
    \\rangle_B`, which needs the INVERSE of M -- hence the explicit
    ``Minv`` argument (mirroring the reference's LinearSystem(Minv=...)).
    """
    if ip_defl is not None:
        return ip_defl
    if M is None:
        return ip
    if Minv is None:
        raise ValueError(
            "deflation with the inner-product-changing preconditioner M "
            "requires Minv (or an explicit ip_defl) to orthonormalize U "
            "in the M^{-1} inner product"
        )
    base_pair, _ = make_inner(ip)
    Minv_mv = as_matvec(Minv)
    return lambda x, y: base_pair(x, Minv_mv(y))


def build_deflation(A, U, *, M=None, Minv=None, Ml=None, Mr=None, ip=None,
                    ip_defl=None):
    """Assemble the deflation data for basis U (shape ``(N, d)``).

    :param ip: solver inner product (defines the projection geometry).
    :param Minv: inverse of M, needed to orthonormalize U in the
      :math:`M^{-1}` inner product when M is present.
    :param ip_defl: explicit override of the orthonormalization product.
    """
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    pair, rows = make_inner(ip)
    ip_defl = _ip_for_U(ip, M, Minv, ip_defl)

    U = jnp.asarray(U)
    Uo, _ = weighted_qr(U, ip_defl)
    AUcols = jax.vmap(
        lambda u: apply(Ml_mv, A_mv(apply(Mr_mv, u))), in_axes=1,
        out_axes=1,
    )(Uo) if U.shape[1] else Uo
    W2, _ = weighted_qr(AUcols, ip)
    # <Uo, W2> and <Uo, AU> as d x d blocks
    d = U.shape[1]
    if d:
        G = jnp.stack(
            [rows(Uo.T, W2[:, j]) for j in range(d)], axis=1
        )
        E = jnp.stack(
            [rows(Uo.T, AUcols[:, j]) for j in range(d)], axis=1
        )
    else:
        G = jnp.zeros((0, 0), U.dtype)
        E = jnp.zeros((0, 0), U.dtype)
    return DeflationOperator(Uo, AUcols, W2, G, E)


def deflated_gmres(
    A,
    b,
    U,
    *,
    M=None,
    Minv=None,
    Ml=None,
    Mr=None,
    ip=None,
    ip_defl=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    ortho="cgs2",
    explicit_residual=False,
    return_internal=False,
):
    r"""Deflated preconditioned GMRES in one compiled while_loop.

    Solves :math:`M M_l A M_r y = M M_l b` on the complement of the
    deflation space spanned by U, correcting each iterate through the
    deflation component (reference: krypy/deflation.py DeflatedGmres).

    :param U: deflation basis, shape ``(N, d)`` with static d.
    :param ortho: as in :func:`~krypy_tpu.functional.gmres.gmres`, plus
      the deflation-specific resolution: ``'cgs2_1r'`` folds the
      deflation capture and oblique projection INTO the one-reduce
      contraction (:class:`~krypy_tpu.functional.gmres.FusedDeflation`),
      so a deflated iteration costs exactly ONE all-reduce on a mesh
      (pinned in tests/test_collectives.py) instead of the hook path's
      ~6; ``'auto'`` resolves to the fused one-reduce scheme under a
      multi-device mesh context (when eligible: no ``M``, non-scalar
      ``ip``) and to ``'cgs2'`` otherwise.
    :return: :class:`~krypy_tpu.functional.common.SolveResult` (plus the
      internal small matrices if ``return_internal``).
    """
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    pair, rows = make_inner(ip)

    defl = build_deflation(
        A, U, M=M, Minv=Minv, Ml=Ml, Mr=Mr, ip=ip, ip_defl=ip_defl
    )
    d = defl.Uo.shape[1]

    if d == 0:
        out = _gmres_mod.gmres(
            A, b, M=M, Ml=Ml, Mr=Mr, ip=ip, x0=x0, tol=tol,
            maxiter=maxiter, ortho=ortho,
            explicit_residual=explicit_residual,
            return_internal=return_internal,
        )
        return out

    UoT = defl.Uo.T          # (d, N)

    _scalar_ip = ip is not None and not (
        hasattr(ip, "ndim") or (hasattr(ip, "dot") and hasattr(ip, "shape"))
    )
    if ortho == "auto":
        # mesh context: the fused one-reduce deflated scheme (1 sync
        # point/iter) dominates every hook-path alternative; single
        # chip: classic cgs2 hooks (the plain-gmres auto kernels don't
        # compose with the capture hook).
        from ..parallel import active_mesh_size

        ortho = (
            "cgs2_1r"
            if active_mesh_size() > 1 and M is None and not _scalar_ip
            else "cgs2"
        )

    def proj_complement(z):
        """(I - P) z with P = W2 <Uo, W2>^{-1} <Uo, .>, applied twice
        ("twice is enough", Stewart 2011)."""
        def once(z):
            c = rows(UoT, z)              # <Uo, z>
            c = jnp.linalg.solve(defl.G, c)
            return z - jnp.dot(defl.W2, c)
        z = once(z)
        return z - (jnp.dot(defl.W2, jnp.linalg.solve(
            defl.G, rows(UoT, z)
        )))

    def op_with_capture(v):
        Av = apply(Ml_mv, A_mv(apply(as_matvec(Mr), v)))
        cap = rows(UoT, Av)               # <Uo, MlAMr v>
        return proj_complement(Av), cap

    def correct(xk):
        """Solve the deflation component of the residual
        (reference: krypy/deflation.py:58-68)."""
        r = apply(Ml_mv, bv - A_mv(xk))
        c = rows(UoT, r)
        c = jnp.linalg.solve(defl.E, c)
        return xk + jnp.dot(defl.Uo, c)

    if ortho == "cgs2_1r":
        # fold projection + capture into the one-reduce contraction:
        # exactly ONE all-reduce per deflated iteration (see
        # gmres.FusedDeflation)
        out = _gmres_mod.gmres(
            A, b, M=M, Ml=Ml, Mr=Mr, ip=ip, x0=x0, tol=tol,
            maxiter=maxiter, ortho=ortho,
            explicit_residual=explicit_residual,
            fused_deflation=_gmres_mod.FusedDeflation(
                UoT=UoT, W2T=defl.W2.T
            ),
            projected_r0=proj_complement,
            correct_xk=correct,
            return_internal=return_internal,
        )
    else:
        out = _gmres_mod.gmres(
            A, b, M=M, Ml=Ml, Mr=Mr, ip=ip, x0=x0, tol=tol,
            maxiter=maxiter, ortho=ortho,
            explicit_residual=explicit_residual,
            operator_with_capture=op_with_capture,
            capture_width=d,
            projected_r0=proj_complement,
            correct_xk=correct,
            return_internal=return_internal,
        )
    if return_internal:
        result, internals = out
        internals["E"] = defl.E
        internals["Uo"] = defl.Uo
        internals["AU"] = defl.AU
        return result, internals
    return out


def _make_deflation_hooks(A, U, *, M, Minv, Ml, Mr, ip, ip_defl):
    """Shared hook construction for the short-recurrence deflated
    solvers: returns (defl, operator_override, projected_r0, correct_xk)
    or Nones when d == 0."""
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    _, rows = make_inner(ip)

    defl = build_deflation(
        A, U, M=M, Minv=Minv, Ml=Ml, Mr=Mr, ip=ip, ip_defl=ip_defl
    )
    d = defl.Uo.shape[1]
    if d == 0:
        return defl, None, None, None
    UoT = defl.Uo.T

    def proj_complement(z):
        def once(z):
            c = rows(UoT, z)
            c = jnp.linalg.solve(defl.G, c)
            return z - jnp.dot(defl.W2, c)
        return once(once(z))

    def op(v):
        Av = apply(Ml_mv, A_mv(apply(Mr_mv, v)))
        return proj_complement(Av)

    return defl, op, proj_complement, None


def _deflated_short_recurrence(core, A, b, U, kwargs, fused_ok=False,
                               solver_name="cg"):
    """Common driver for deflated CG / MINRES (reference: DeflatedCg /
    DeflatedMinres, krypy/deflation.py:236-273): projected operator,
    projected initial residual, corrected iterates.

    With ``fused_ok`` and ``variant='1r'`` (or a mesh-resolved
    ``'auto'``) the oblique projection is FOLDED into the solver's
    one-reduce contraction instead of riding the operator hook: a
    deflated iteration then costs exactly ONE all-reduce (pinned in
    tests/test_collectives.py) vs the hook path's 4 (classic: 2
    recurrence reductions + 2 projection applications) or 3 (hook-1r).
    """
    b = jnp.asarray(b)
    bv = b.reshape(-1)
    ip = kwargs.get("ip")
    M = kwargs.get("M")
    _scalar_ip = ip is not None and not (
        hasattr(ip, "ndim") or (hasattr(ip, "dot") and hasattr(ip, "shape"))
    )

    variant = kwargs.get("variant", "classic")
    if variant == "auto" and fused_ok:
        # priced resolution (shared model, functional/policy.py): the
        # fused-deflated form saves THREE sync points over the classic
        # hook path, so its break-even shard is 3x larger than the
        # plain solver's
        from ..parallel import active_mesh_size
        from .policy import prefer_one_reduce

        _mesh_n = active_mesh_size()
        _dt = jnp.dtype(bv.dtype)
        variant = (
            "1r"
            if _mesh_n > 1
            and not _scalar_ip
            and prefer_one_reduce(
                f"deflated_{solver_name}",
                bv.shape[0] // _mesh_n, _dt.itemsize,
                syncs_saved=3,
            )
            else "classic"
        )
        kwargs["variant"] = variant

    use_fused = fused_ok and variant == "1r" and not _scalar_ip

    defl, op, proj, _ = _make_deflation_hooks(
        A, U,
        M=M, Minv=kwargs.pop("Minv", None),
        Ml=kwargs.get("Ml"), Mr=kwargs.get("Mr"),
        ip=ip, ip_defl=kwargs.pop("ip_defl", None),
    )
    if op is None:
        return core(A, b, **kwargs)

    A_mv = as_matvec(A)
    Ml_mv = as_matvec(kwargs.get("Ml"))
    _, rows = make_inner(ip)
    UoT = defl.Uo.T

    def correct(xk):
        r = apply(Ml_mv, bv - A_mv(xk))
        c = rows(UoT, r)
        c = jnp.linalg.solve(defl.E, c)
        return xk + jnp.dot(defl.Uo, c)

    if use_fused:
        return core(
            A, b,
            fused_deflation=_gmres_mod.FusedDeflation(
                UoT=UoT, W2T=defl.W2.T, G=defl.G
            ),
            projected_r0=proj,
            correct_xk=correct,
            **kwargs,
        )
    return core(
        A, b,
        operator_override=op,
        projected_r0=proj,
        correct_xk=correct,
        **kwargs,
    )


def deflated_cg(A, b, U, **kwargs):
    """Deflated preconditioned CG in one compiled while_loop
    (reference: krypy/deflation.py DeflatedCg).  Accepts the parameters
    of :func:`krypy_tpu.functional.cg.cg` plus the deflation basis U.
    ``variant='1r'`` folds the oblique projection into the one-reduce
    cross-Gram: ONE all-reduce per deflated iteration."""
    from .cg import cg as _cg

    return _deflated_short_recurrence(
        _cg, A, b, U, kwargs, fused_ok=True, solver_name="cg"
    )


def deflated_minres(A, b, U, **kwargs):
    """Deflated preconditioned MINRES in one compiled while_loop
    (reference: krypy/deflation.py DeflatedMinres).  ``variant='1r'``
    folds the oblique projection into the one-reduce cross-Gram: ONE
    all-reduce per deflated iteration."""
    from .minres import minres as _minres

    return _deflated_short_recurrence(
        _minres, A, b, U, kwargs, fused_ok=True, solver_name="minres"
    )


@jax.jit
def _pack_galerkin(H, C, E, V, AU):
    """Device-side pack of every small matrix the host eig needs into
    ONE flat buffer: fetching H, C, E and the Gram block separately
    costs 4 device-to-host round trips per recycling hand-off; one
    concatenated fetch costs one."""
    B = jnp.dot(jnp.conj(V), AU)  # (m+1, d) Gram block <V, AU>
    dt = jnp.result_type(H.dtype, C.dtype, E.dtype, B.dtype)
    return jnp.concatenate(
        [H.ravel().astype(dt), C.ravel().astype(dt),
         E.ravel().astype(dt), B.ravel().astype(dt)]
    )


def _augmented_galerkin(internals):
    """Host assembly of the augmented Galerkin matrix ``[[H + B E^{-1}C,
    B], [C, E]]`` of the space ``[V_n, U]`` from the matrices captured by
    a (deflated) functional GMRES solve (reference math:
    krypy/deflation.py:781-809).  Returns ``(Mblock, n, d)``."""
    n = int(internals.get(
        "niter", np.asarray(internals["H"]).shape[1]
    ))
    E_dev = internals["E"] if "E" in internals else jnp.zeros((0, 0))
    d = int(E_dev.shape[0])

    if d:
        H_dev, C_dev = internals["H"], internals["C"]
        V, AU = internals["V"], internals["AU"]
        flat = np.asarray(
            _pack_galerkin(
                jnp.asarray(H_dev), jnp.asarray(C_dev),
                jnp.asarray(E_dev), V, AU,
            )
        )
        sizes = [np.prod(np.shape(a)) for a in (H_dev, C_dev, E_dev)]
        o1, o2, o3 = np.cumsum(sizes).astype(int)
        H_full = flat[:o1].reshape(np.shape(H_dev))
        C_full = flat[o1:o2].reshape(np.shape(C_dev))
        E = flat[o2:o3].reshape(np.shape(E_dev))
        B = flat[o3:].reshape(np.shape(V)[0], d)[:n]
        H = H_full[:n, :n]
        C = C_full[:n, :d].T
        EinvC = np.linalg.solve(E, C)
        Mblock = np.block([[H + B @ EinvC, B], [C, E]])
    else:
        H_full = np.asarray(internals["H"])
        Mblock = H_full[:n, :n]
    return Mblock, n, d


def ritz_pairs(internals, hermitian=False):
    """Augmented Ritz values and coefficient vectors (host decision
    data) from the captured small matrices of a functional GMRES solve."""
    Mblock, n, d = _augmented_galerkin(internals)
    if hermitian:
        theta, coeffs = np.linalg.eigh((Mblock + Mblock.conj().T) / 2)
    else:
        theta, coeffs = np.linalg.eig(Mblock)
    return theta, coeffs, n, d


def _realify_columns(sel, theta=None):
    """Real coefficient block spanning (a real surrogate of) the columns
    of complex ``sel``.

    A complex-conjugate Ritz pair ``(v, conj(v))`` must map to the real
    pair ``(Re v, Im v)`` -- taking the phase-aligned real part of BOTH
    members yields two IDENTICAL columns and a rank-deficient deflation
    basis (singular E, NaN solve).  With ``theta`` given, a column whose
    eigenvalue is the conjugate of an earlier selected one contributes
    its imaginary part; without ``theta`` the same rule is applied by
    detecting near-parallelism against the previous realified column.
    """
    p, k = sel.shape
    idx = np.argmax(np.abs(sel), axis=0)
    piv = sel[idx, np.arange(k)]
    phase = piv / np.where(np.abs(piv) == 0, 1.0, np.abs(piv))
    aligned = sel / phase[None, :]

    out = np.empty((p, k))
    seen = []  # eigenvalues of already-realified columns
    for j in range(k):
        col = np.real(aligned[:, j])
        use_imag = False
        if theta is not None:
            tj = complex(np.asarray(theta).reshape(-1)[j])
            if abs(tj.imag) > 1e-12 * max(abs(tj), 1.0):
                for ti in seen:
                    if abs(ti - np.conj(tj)) <= 1e-8 * max(abs(tj), 1.0):
                        use_imag = True
                        break
            seen.append(tj)
        elif j > 0:
            prev = out[:, j - 1]
            denom = np.linalg.norm(col) * np.linalg.norm(prev)
            if denom > 0 and abs(col @ prev) > 0.999 * denom:
                use_imag = True
        if use_imag:
            im = np.imag(aligned[:, j])
            if np.linalg.norm(im) > 1e-12 * np.linalg.norm(aligned[:, j]):
                col = im
        out[:, j] = col
    norms = np.linalg.norm(out, axis=0)
    return out / np.where(norms == 0, 1.0, norms)


def assemble_ritz_vectors(internals, sel, n, d, theta=None):
    """Assemble ``[V_n, U] @ sel`` as ONE static-shape device GEMM.

    Every device operation uses the STATIC buffer shapes (the full
    ``(m+1, N)`` basis); the dynamic iteration count ``n`` only ever
    slices host arrays.  A per-``n`` device slice would recompile the
    assembly for every distinct iteration count of a recycling
    sequence -- the multi-second solve-2/solve-3 transients of round 2.

    :param theta: (optional) eigenvalues of the selected columns; enables
      exact conjugate-pair handling in the real-basis realification.
    """
    V = internals["V"]
    if np.iscomplexobj(sel) and not jnp.iscomplexobj(V):
        sel = _realify_columns(sel, theta)

    # scatter the (n+d)-row coefficients into the STATIC basis layout
    # [V (m+1 rows) | U (d rows)] with zeros on the unused rows, so the
    # assembly GEMM compiles once per buffer shape, not once per n
    m1 = V.shape[0]
    basis = V if not d else jnp.concatenate(
        [V, internals["Uo"].T], axis=0
    )
    sel_full = np.zeros((m1 + d, sel.shape[1]), dtype=sel.dtype)
    sel_full[:n] = sel[:n]
    if d:
        sel_full[m1:] = sel[n:]
    # keep the basis dtype: host eigensolves return f64/c128, which must
    # not leak into the (possibly f32) device solve
    sel_dev = jnp.asarray(sel_full).astype(basis.dtype)
    return jnp.dot(sel_dev.T, basis).T  # (N, n_vectors)


def ritz_deflation_vectors(internals, n_vectors=3, which="sm",
                           hermitian=False):
    """Extract Ritz deflation vectors for the NEXT solve from the internal
    state of a deflated (or plain) functional GMRES solve.

    The augmented Ritz problem is assembled from the small matrices only
    (reference math: krypy/deflation.py:737-830); the eigensolve of the
    (n+d) x (n+d) pencil runs on host (decision data), the vector assembly
    ``[V_n, U] @ coeffs`` is one static-shape device GEMM (see
    :func:`assemble_ritz_vectors`).
    """
    theta, coeffs, n, d = ritz_pairs(internals, hermitian=hermitian)
    order = {
        "sm": np.argsort(np.abs(theta)),
        "lm": np.argsort(np.abs(theta))[::-1],
        "sr": np.argsort(np.real(theta)),
        "lr": np.argsort(np.real(theta))[::-1],
    }[which][:n_vectors]
    sel = np.ascontiguousarray(coeffs[:, order])
    return assemble_ritz_vectors(internals, sel, n, d, theta=theta[order])


class RecyclingGmres:
    """accelerator-native recycling GMRES: construct once, call :meth:`solve` for
    each system of a sequence; deflation vectors are Ritz vectors
    recycled from the previous solve (reference driver:
    krypy/recycling/linsys.py).  Each solve is ONE device dispatch; the
    Ritz selection between solves is host-side decision logic on the
    small matrices."""

    def __init__(self, n_vectors=3, which="sm", hermitian=False):
        self.n_vectors = n_vectors
        self.which = which
        self.hermitian = hermitian
        self._last_internals = None
        self._U = None
        # compiled-solve cache: (id(A), U-shape-or-None, option items) ->
        # jitted fn; entries hold the keepalive refs so ids stay valid
        self._compiled = {}

    def _solver_for(self, A, U_shape, kwargs):
        """One compilation per (operator, deflation width, options): a
        sequence of systems with the same structure then costs one trace
        total instead of one per solve (the round-1 per-solve retrace was
        the dominant wall in the recycling benchmark).

        Operators exposing the family protocol (``family``/``params``/
        ``rebuild``, see :func:`krypy_tpu.ops.diagonal`) share ONE
        compilation across the whole sequence: the parameters enter as a
        traced argument and the operator is rebuilt inside the trace.
        The tolerance is likewise a TRACED argument (it only feeds
        comparisons inside the loop), so drivers that vary it per solve
        -- e.g. Eisenstat-Walker forcing in
        :func:`~krypy_tpu.functional.newton.newton_krylov` -- do not
        retrace.
        """
        kwargs = dict(kwargs)
        kwargs.pop("tol", None)  # traced argument, not a key item
        key_items = tuple(
            (k, v if isinstance(v, (bool, int, float, str, type(None)))
             else id(v))
            for k, v in sorted(kwargs.items())
        )
        family = getattr(A, "family", None)
        parametric = (
            family is not None
            and hasattr(A, "params")
            and hasattr(A, "rebuild")
        )
        if parametric:
            p = jnp.asarray(A.params)
            op_key = ("family", family, p.shape, str(p.dtype))
            keepalive = (A.rebuild, kwargs)
        else:
            op_key = id(A)
            keepalive = (A, kwargs)
        key = (op_key, U_shape, key_items)

        entry = self._compiled.get(key)
        if entry is None:
            if parametric:
                rebuild = A.rebuild
                if U_shape is None:
                    @jax.jit
                    def core(b, tol, params):
                        return _gmres_mod.gmres(
                            rebuild(params), b, tol=tol,
                            return_internal=True, **kwargs,
                        )
                else:
                    @jax.jit
                    def core(b, tol, U, params):
                        return deflated_gmres(
                            rebuild(params), b, U, tol=tol,
                            return_internal=True, **kwargs,
                        )
            else:
                if U_shape is None:
                    @jax.jit
                    def core(b, tol):
                        return _gmres_mod.gmres(
                            A, b, tol=tol, return_internal=True,
                            **kwargs
                        )
                else:
                    @jax.jit
                    def core(b, tol, U):
                        return deflated_gmres(
                            A, b, U, tol=tol, return_internal=True,
                            **kwargs
                        )
            entry = (core, parametric, keepalive)
            if len(self._compiled) > 16:
                self._compiled.pop(next(iter(self._compiled)))
            self._compiled[key] = entry
        return entry[0], entry[1]

    def _warmup_widths(self):
        """Deflation widths whose cores warmup pre-compiles."""
        return (0, self.n_vectors)

    def warmup(self, A, b, **kwargs):
        """Pre-compile the plain AND deflated solver cores for this
        operator (or operator family) and rhs structure, so a serving
        sequence pays no compile inside :meth:`solve`.

        Runs each core once on a ZERO right-hand side (which converges
        in 0 iterations -- the execution is pure compile cost) with an
        orthonormal placeholder deflation basis of each width in
        :meth:`_warmup_widths`.  ``kwargs`` must match the subsequent
        :meth:`solve` calls (they are part of the compilation key).
        Returns ``self``.
        """
        b = jnp.asarray(b)
        bz = jnp.zeros_like(b)
        N = b.reshape(-1).shape[0]
        dtype = b.dtype
        tol = kwargs.get("tol", 1e-5)
        for width in self._warmup_widths():
            U_shape = None if width == 0 else (N, width)
            core, parametric = self._solver_for(A, U_shape, kwargs)
            args = [bz, tol]
            if U_shape is not None:
                args.append(jnp.eye(N, width, dtype=dtype))
            if parametric:
                args.append(jnp.asarray(A.params))
            res, internals = core(*args)
            # warmup's whole job is to guarantee compile+execute
            # finished before the serving sequence starts
            jax.block_until_ready(res.x)
            # warm the Ritz-extraction GEMMs too (static shapes: one
            # compile per deflation width, reused by every solve).
            # niter must be >= n_vectors so the warmed assembly GEMM has
            # the same column count as the serving sequence's
            ints = dict(internals)
            m = int(np.asarray(internals["H"]).shape[1])
            ints["niter"] = min(self.n_vectors, m)
            ints.setdefault("E", jnp.zeros((0, 0)))
            try:
                self._warm_extraction(ints)
            except np.linalg.LinAlgError:
                pass
        return self

    def _warm_extraction(self, ints):
        """Compile the extraction path warmup's core run will feed."""
        vecs = ritz_deflation_vectors(
            ints, n_vectors=self.n_vectors, which=self.which,
            hermitian=self.hermitian,
        )
        jax.block_until_ready(vecs)

    def _next_deflation_basis(self, kwargs):
        """Deflation basis for the upcoming solve (None = plain solve).

        The base driver extracts a FIXED number of Ritz vectors;
        :class:`AutoRecyclingGmres` overrides this with the priced
        greedy selection.  Without captured internals an externally
        seeded basis (checkpoint resume, see
        :class:`krypy_tpu.checkpoint.CheckpointedRecycling`) is kept."""
        if self._last_internals is None:
            return self._U
        try:
            return ritz_deflation_vectors(
                self._last_internals,
                n_vectors=self.n_vectors,
                which=self.which,
                hermitian=self.hermitian,
            )
        except np.linalg.LinAlgError:
            return None

    def _observe(self, width, niter, wall_s):
        """Timing feedback after each solve (consumed by the auto
        driver's cost model)."""

    def solve(self, A, b, **kwargs):
        self._U = self._next_deflation_basis(kwargs)

        b = jnp.asarray(b)
        tol = kwargs.get("tol", 1e-5)
        t0 = time.perf_counter()
        if self._U is None:
            core, parametric = self._solver_for(A, None, kwargs)
            args = [b, tol]
            if parametric:
                args.append(jnp.asarray(A.params))
            result, internals = core(*args)
            internals = dict(internals)
            internals["E"] = jnp.zeros((0, 0))
        else:
            core, parametric = self._solver_for(
                A, tuple(self._U.shape), kwargs
            )
            args = [b, tol, self._U]
            if parametric:
                args.append(jnp.asarray(A.params))
            result, internals = core(*args)
            internals = dict(internals)
        internals["niter"] = int(result.niter)  # also a device sync
        self._observe(
            0 if self._U is None else int(self._U.shape[1]),
            internals["niter"],
            time.perf_counter() - t0,
        )
        self._last_internals = internals
        return result


class AutoRecyclingGmres(RecyclingGmres):
    r"""Recycling GMRES with automatic deflation-subspace selection.

    Functional-lane port of the reference's greedy ``RitzFactory`` with
    ``RitzApriori`` pricing (krypy/recycling/factories.py:52-107,
    evaluators.py:13-134), adapted to compile-once execution:

    * candidate subsets are the prefixes (width 0..``max_vectors``) of
      the small-magnitude ordering of the augmented Ritz values -- the
      greedy search direction of the reference's ``RitzSmall``/
      ``RitzExtremal`` generators;
    * each candidate width ``d`` is priced as
      ``d * tau(0) + predicted_steps(remaining spectrum) * tau(d)``
      where ``predicted_steps`` comes from the a-priori
      :class:`~krypy_tpu.spectral.BoundMinres` (degrading to the CG
      kappa-bound on definite spectra) applied to the NON-deflated Ritz
      values, and ``tau(d)`` is the MEASURED per-iteration wall of the
      compiled width-``d`` core, updated online after every solve
      (SURVEY section 5.1's timing->decision loop with the wall-clock
      operator timers replaced by compiled-step measurements);
    * an unevaluable candidate (complex Ritz values, empty remainder) is
      skipped, mirroring the reference's AssumptionError-as-control-flow
      (krypy/recycling/factories.py:58-63); if ALL candidates are
      unevaluable the driver falls back to the fixed-width selection of
      the base class.

    Widths not yet measured are extrapolated from the cheapest measured
    width by a ``1 + growth * d`` per-iteration overhead factor.  The
    candidate widths are static compilation shapes: :meth:`warmup`
    pre-compiles all ``max_vectors + 1`` cores, so a serving sequence
    pays no compile inside solves.
    """

    def __init__(self, max_vectors=4, which="sm", hermitian=True,
                 growth=0.05, widths=None):
        """:param widths: candidate deflation widths (default: every
        width ``0..max_vectors``).  Each width is a distinct compiled
        core, and compiles dominate :meth:`warmup`, so serving
        deployments can restrict the set, e.g.
        ``widths=(0, max_vectors)``; the priced selection then runs over
        the allowed set only.  0 and ``max_vectors`` are always
        included (0 is the no-deflation fallback; ``max_vectors`` caps
        the extraction shape)."""
        super().__init__(
            n_vectors=max_vectors, which=which, hermitian=hermitian
        )
        self.max_vectors = int(max_vectors)
        if widths is None:
            self._widths = tuple(range(self.max_vectors + 1))
        else:
            ws = {0, self.max_vectors} | {int(w) for w in widths}
            if not all(0 <= w <= self.max_vectors for w in ws):
                raise ValueError(
                    f"widths must lie in [0, {self.max_vectors}]"
                )
            self._widths = tuple(sorted(ws))
        self._growth = float(growth)
        self._tau = {}
        #: chosen deflation width per solve (observability)
        self.selected_widths = []
        #: predicted iteration counts of the chosen candidates
        self.predicted_steps = []

    def _warmup_widths(self):
        return self._widths

    def _warm_extraction(self, ints):
        # the auto driver always assembles max_vectors columns and
        # slices; warm that path plus each slice width
        theta, coeffs, n, d = ritz_pairs(ints, hermitian=self.hermitian)
        sel, theta_sel = self._padded_selection(theta, coeffs)
        U_full = assemble_ritz_vectors(ints, sel, n, d, theta=theta_sel)
        for w in self._widths:
            if w > 0:
                jax.block_until_ready(U_full[:, :w])

    def _tau_of(self, d):
        if d in self._tau:
            return self._tau[d]
        if not self._tau:
            return None
        base_d = min(self._tau, key=self._tau.get)
        return self._tau[base_d] * (
            1.0 + self._growth * max(0, d - base_d)
        )

    def _observe(self, width, niter, wall_s):
        if niter <= 0:
            return
        tau = wall_s / niter
        prev = self._tau.get(width)
        self._tau[width] = tau if prev is None else 0.5 * (prev + tau)

    def _padded_selection(self, theta, coeffs):
        """Coefficient block (and eigenvalues) of the max_vectors
        smallest-|theta| Ritz vectors, zero-padded so the assembly GEMM
        shape is independent of how many vectors the selection ends up
        using."""
        order = np.argsort(np.abs(theta))[: self.max_vectors]
        sel = np.ascontiguousarray(coeffs[:, order])
        theta_sel = np.asarray(theta)[order]
        if sel.shape[1] < self.max_vectors:
            pad = self.max_vectors - sel.shape[1]
            sel = np.pad(sel, ((0, 0), (0, pad)))
            theta_sel = np.pad(theta_sel, (0, pad), constant_values=1.0)
        return sel, theta_sel

    def _next_deflation_basis(self, kwargs):
        if self._last_internals is None:
            # keep an externally seeded basis (checkpoint resume)
            w = 0 if self._U is None else int(self._U.shape[1])
            self.selected_widths.append(w)
            self.predicted_steps.append(None)
            return self._U
        tol = float(kwargs.get("tol", 1e-5))
        maxiter = kwargs.get("maxiter")

        try:
            theta, coeffs, n, d_prev = ritz_pairs(
                self._last_internals, hermitian=self.hermitian
            )
        except np.linalg.LinAlgError:
            self.selected_widths.append(0)
            self.predicted_steps.append(None)
            return None

        order = np.argsort(np.abs(theta))
        dmax = max(0, min(self.max_vectors, len(theta) - 1))
        budget = float(maxiter) if maxiter else 10.0 * max(len(theta), 1)

        best = None  # (cost, width, steps)
        for dwidth in (w for w in self._widths if w <= dmax):
            remaining = theta[order[dwidth:]]
            if np.iscomplexobj(remaining) and not np.isreal(
                remaining
            ).all():
                continue  # unevaluable candidate: skip (reference flow)
            try:
                bound = spectral.BoundMinres(np.real(remaining))
                steps = float(bound.get_step(tol))
            except Exception:
                continue
            if not np.isfinite(steps) or steps < 0:
                steps = budget
            steps = min(steps, budget)
            tau = self._tau_of(dwidth)
            tau0 = self._tau_of(0)
            if tau is None or tau0 is None:
                cost = steps  # no timing data yet: price in iterations
            else:
                cost = dwidth * tau0 + steps * tau
            if best is None or cost < best[0]:
                best = (cost, dwidth, steps)

        if best is None:
            # every candidate unevaluable: fixed-width fallback
            self.selected_widths.append(self.n_vectors)
            self.predicted_steps.append(None)
            return super()._next_deflation_basis(kwargs)

        _, dwidth, steps = best
        self.selected_widths.append(dwidth)
        self.predicted_steps.append(steps)
        if dwidth == 0:
            return None
        sel, theta_sel = self._padded_selection(theta, coeffs)
        U_full = assemble_ritz_vectors(
            self._last_internals, sel, n, d_prev, theta=theta_sel
        )
        return U_full[:, :dwidth]
