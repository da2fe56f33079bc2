"""Operator gallery.

Matrix-free matvecs for the benchmark/test problems of BASELINE.md (the
reference has no operator gallery; its extensibility hook is the
LinearOperator protocol, krypy/utils.py:1365 -- these are the
compiled-array equivalents).  All operators are pure functions on 1-D
``(N,)`` vectors:

* stencils are expressed as pad/slice/add pipelines that XLA fuses into a
  single elementwise pass; on an active mesh they split their grid by
  rows, and GSPMD turns the shifts into halo exchanges;
* diagonal operators are elementwise multiplies;
* explicit sparse matrices use ``jax.experimental.sparse`` (BCOO).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = [
    "diagonal",
    "poisson_1d",
    "poisson_2d",
    "convection_diffusion_2d",
    "shifted_laplacian_2d",
    "jacobi_preconditioner",
    "chebyshev_preconditioner",
    "gmres_polynomial_preconditioner",
    "multigrid_poisson_preconditioner",
    "ssor_poisson_preconditioner",
    "poisson_dst_solver",
    "nls_jacobian_sequence",
    "nls_residual_2d",
    "readme_diag",
    "sparse_from_scipy",
    "block_jacobi_preconditioner",
    "dia_from_scipy",
    "spai_preconditioner",
]


def diagonal(d):
    """diag(d) as a matvec; ``d`` has shape ``(N,)``.

    Exposes the *operator-family* protocol (``family``/``params``/
    ``rebuild``): sequence drivers like
    :class:`krypy_tpu.functional.deflation.RecyclingGmres` compile one
    solver per family and pass ``params`` as a traced argument, so a
    sequence of different diagonals reuses a single compilation."""
    d = jnp.asarray(d)

    def matvec(x):
        return d * x

    matvec.diag = d
    matvec.shape = (d.shape[0], d.shape[0])
    matvec.family = "diagonal"
    matvec.params = d
    matvec.rebuild = lambda p: (lambda x: p * x)
    return matvec


def readme_diag(n=100):
    """The README example operator A = diag(1e-3, 2, 3, ..., n)
    (reference: README.md:43-48, example.py:12-16)."""
    d = jnp.concatenate(
        [jnp.array([1.0e-3]), jnp.arange(2.0, n + 1)]
    )
    return diagonal(d)


def _split(a, spec):
    """Constrain ``a`` to ``spec`` over the active mesh's axis (no-op
    without a mesh)."""
    from .parallel import active_mesh

    mesh = active_mesh()
    if mesh is None:
        return a
    return jax.lax.with_sharding_constraint(
        a, NamedSharding(mesh, P(*(mesh.axis_names[0] if s else None
                                   for s in spec)))
    )


def _level_on_mesh(u):
    """Multigrid level ``u`` split by rows where that pays, replicated
    otherwise.  Split d ways, a smoothing sweep (3 grid vectors of
    traffic) saves ``3 (1 - 1/d) u.size`` elements per card, and each of
    its halo exchanges costs about one sync; a level whose saving is
    below one sync (:mod:`~krypy_tpu.functional.policy`'s measured
    prices) runs whole on every card, so the coarse levels' many small
    sweeps need no communication at all.  A level's input and its
    coarse correction are both pinned: GSPMD does not carry an input
    pin through the level by itself."""
    from .functional import policy
    from .parallel import active_mesh

    mesh = active_mesh()
    if mesh is None:
        return u
    d = mesh.devices.size
    saved = 3 * policy.sweep_s(u.size * (d - 1) / d, u.dtype.itemsize)
    return _split(u, (1, 0) if saved > policy.sync_s() else (0, 0))


def _to_grid(x, nx, ny):
    """``(N,) -> (nx, ny)``, split by grid rows on a mesh.  A flat
    vector whose even split does not fall on row boundaries (any odd N)
    cannot carry its sharding through the reshape, and GSPMD would
    replicate the whole solve; pinning the rows makes it move the data
    instead."""
    return _split(x.reshape(nx, ny), (1, 0))


def _to_flat(u):
    """``(nx, ny) -> (N,)``, split along N on a mesh."""
    return _split(u.reshape(-1), (1,))


def _lap1d_apply(u, h2):
    """1-D central second difference with Dirichlet boundaries."""
    left = jnp.pad(u[:-1], (1, 0))
    right = jnp.pad(u[1:], (0, 1))
    return (2.0 * u - left - right) / h2


def poisson_1d(n):
    """1-D Dirichlet Laplacian on n interior points of (0,1); SPD."""
    h2 = (1.0 / (n + 1)) ** 2

    def matvec(x):
        return _lap1d_apply(x, h2)

    matvec.shape = (n, n)
    matvec.diag = jnp.full(n, 2.0 / h2)
    return matvec


def poisson_2d(nx, ny=None):
    """5-point Laplacian on an nx x ny interior grid of the unit square,
    Dirichlet boundaries; SPD, N = nx*ny.

    The stencil is applied as shifted adds, which XLA fuses into one
    pass over the grid; on a mesh GSPMD exchanges the halo rows.
    """
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2

    def matvec(x):
        u = _to_grid(x, nx, ny)
        ux = (2.0 * u
              - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
              - jnp.pad(u[1:, :], ((0, 1), (0, 0)))) / hx2
        uy = (2.0 * u
              - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
              - jnp.pad(u[:, 1:], ((0, 0), (0, 1)))) / hy2
        return _to_flat(ux + uy)

    matvec.shape = (nx * ny, nx * ny)
    matvec.diag = jnp.full(nx * ny, 2.0 / hx2 + 2.0 / hy2)
    return matvec


def convection_diffusion_2d(nx, ny=None, wind=(1.0, 0.5), eps=1.0):
    """Nonsymmetric convection-diffusion operator
    ``-eps * Lap(u) + w . grad(u)`` with first-order upwind convection;
    the BASELINE config-3 operator.
    """
    ny = nx if ny is None else ny
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    hx2, hy2 = hx * hx, hy * hy
    wx, wy = wind
    lap = poisson_2d(nx, ny)

    def matvec(x):
        u = _to_grid(x, nx, ny)
        # upwind differences (wind components assumed non-negative)
        dux = (u - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))) / hx
        duy = (u - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))) / hy
        conv = wx * dux + wy * duy
        return eps * lap(x) + _to_flat(conv)

    matvec.shape = (nx * ny, nx * ny)
    matvec.diag = (
        eps * (2.0 / hx2 + 2.0 / hy2) + wx / hx + wy / hy
    ) * jnp.ones(nx * ny)
    return matvec


def shifted_laplacian_2d(nx, ny=None, sigma=0.0):
    """Shifted Laplacian ``Lap - sigma I`` (indefinite for sigma inside
    the spectrum); the BASELINE config-4 operator."""
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    lap = poisson_2d(nx, ny)

    def matvec(x):
        return lap(x) - sigma * x

    matvec.shape = (nx * ny, nx * ny)
    matvec.diag = (2.0 / hx2 + 2.0 / hy2 - sigma) * jnp.ones(nx * ny)
    return matvec


def jacobi_preconditioner(op_or_diag):
    """Jacobi (diagonal) preconditioner M = diag(A)^{-1} from an operator
    exposing ``.diag`` or from an explicit diagonal."""
    d = getattr(op_or_diag, "diag", None)
    if d is None:
        d = jnp.asarray(op_or_diag)
    inv = 1.0 / d

    def matvec(x):
        return inv * x

    matvec.diag = inv
    matvec.shape = (d.shape[0], d.shape[0])
    return matvec


def chebyshev_preconditioner(op, degree=8, lmin=None, lmax=None):
    r"""Chebyshev polynomial preconditioner :math:`M \approx A^{-1}` for an
    SPD operator with spectrum in ``[lmin, lmax]``.

    Each application runs ``degree`` operator applications with no
    sequential inner products -- the accelerator-native preconditioner: it trades
    (cheap, fused) matvec flops for (expensive, latency-bound) Krylov
    iterations, roughly dividing the outer CG iteration count by
    ``degree``.  The standard Chebyshev semi-iteration recurrence is used
    (Saad, Iterative Methods, alg. 12.1), which is an SPD polynomial in A
    and therefore a valid CG preconditioner.

    ``lmin``/``lmax`` default to a Gershgorin-style estimate from
    ``op.diag`` if available.
    """
    if lmax is None:
        d = getattr(op, "diag", None)
        if d is None:
            raise ValueError("lmax required when op has no .diag")
        lmax = float(2.0 * jnp.max(d))
    if lmin is None:
        lmin = lmax * 1e-4

    # plain Python floats: weak-typed, so the recurrence stays in the
    # iterate's dtype (numpy scalars would promote f32 states to f64)
    theta = float(lmax + lmin) / 2.0
    delta = float(lmax - lmin) / 2.0
    sigma = theta / delta

    def matvec(r):
        rho = 1.0 / sigma
        z = r / theta
        d_vec = z
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d_vec = rho_new * rho * d_vec + (2.0 * rho_new / delta) * (
                r - op(z)
            )
            z = z + d_vec
            rho = rho_new
        return z

    matvec.shape = getattr(op, "shape", None)
    matvec.degree = degree
    return matvec


def gmres_polynomial_preconditioner(
    op, degree=8, *, seed=None, n=None, stability_check=True
):
    r"""GMRES-polynomial preconditioner :math:`p(A) \approx A^{-1}` for a
    general (nonsymmetric, complex-spectrum) operator.

    The degree-``degree`` GMRES residual polynomial
    :math:`\pi(z) = \prod_i (1 - z/\theta_i)` has the harmonic Ritz
    values :math:`\theta_i` of a ``degree``-step Arnoldi run as its
    roots; the preconditioner applies :math:`p(A) = (I - \pi(A)) A^{-1}`
    in product form with modified-Leja-ordered roots and conjugate pairs
    combined in real arithmetic (after Loe & Morgan, "Toward efficient
    polynomial preconditioning for GMRES", 2021).

    accelerator-native rationale (same as :func:`chebyshev_preconditioner`, but
    for NONSYMMETRIC operators where a Chebyshev interval does not
    apply): one application is ``degree`` operator applications and ZERO
    inner products -- no reductions, no sequential latency-bound scalar
    chain -- so it trades fused matvec flops for outer Krylov iterations
    and pairs with the communication-avoiding solvers (the roots are an
    operator property computed ONCE, eagerly, like
    :func:`~krypy_tpu.functional.sstep.newton_shifts`).

    :param seed: Arnoldi starting vector (defaults to ones); the rhs of
      the target system is the standard choice.
    :param n: problem size when ``op`` has no ``.shape`` and no seed is
      given.
    :param stability_check: evaluate the partial-product growth factor
      of the Leja-ordered roots on the harmonic Ritz estimates and raise
      if it exceeds 1e8 (the classic product-form instability at high
      degree; lower ``degree`` or precondition first).
    :return: jittable matvec with ``.roots`` (Leja-ordered harmonic Ritz
      values) and ``.degree`` attributes.

    The reference has no polynomial preconditioning (krypy takes
    user-supplied ``M`` only, krypy/linsys.py:61-78).
    """
    import numpy as np

    from .functional import arnoldi, as_matvec
    from .functional.sstep import modified_leja

    shape = getattr(op, "shape", None)
    op = as_matvec(op)

    if seed is None:
        if n is None:
            if shape is None:
                raise ValueError(
                    "n= or seed= required when op has no .shape"
                )
            n = shape[1]
        # the default seed must carry the OPERATOR's dtype: arnoldi
        # derives all basis/Hessenberg dtypes from the seed, and a
        # float32 seed would silently truncate a complex or float64
        # operator's Arnoldi relation (and hence the roots).
        # eval_shape learns the dtype without any device work
        import jax

        probe = jax.eval_shape(
            op, jax.ShapeDtypeStruct((int(n),), jnp.float32)
        )
        seed = jnp.ones(int(n), probe.dtype)
    seed = jnp.asarray(seed).reshape(-1)

    rel = arnoldi(op, seed, maxiter=int(degree), ortho="cgs2")
    k = int(rel.niter)
    if k < 1:
        raise ValueError("Arnoldi produced no usable steps")
    H = np.asarray(rel.H)[: k + 1, :k].astype(np.complex128)
    Hk = H[:k, :k]
    hk = H[k, k - 1]
    # harmonic Ritz values: eig(Hk + hk^2 * f e_k^H), f = Hk^{-H} e_k
    ek = np.zeros(k)
    ek[-1] = 1.0
    f = np.linalg.solve(Hk.conj().T, ek)
    roots = np.linalg.eigvals(Hk + (abs(hk) ** 2) * np.outer(f, ek))
    roots = modified_leja(roots)

    if stability_check:
        # growth of |pi_j(theta_i)| over the Ritz estimates: the product
        # form is unstable when intermediate partial products explode
        pi = np.ones(roots.size, complex)
        growth = 1.0
        for th in roots:
            pi *= 1.0 - roots / th
            growth = max(growth, float(np.max(np.abs(pi))))
        if growth > 1e8:
            raise ValueError(
                f"product-form growth {growth:.1e} at degree {k}: "
                "reduce degree (the polynomial would amplify round-off "
                "past single precision)"
            )

    complex_op = np.iscomplexobj(np.asarray(seed)) or bool(
        jnp.issubdtype(jnp.asarray(rel.V).dtype, jnp.complexfloating)
    )
    if complex_op:
        # complex operator: roots are not conjugate-closed; apply them
        # one by one with complex scalars
        plan = [("real", complex(th), None) for th in roots]
    else:
        # real operator: conjugate pairs are adjacent after
        # modified_leja (Im>0 opener first); combine each pair in real
        # arithmetic so the iterates stay real
        plan = []
        i = 0
        while i < roots.size:
            th = roots[i]
            if abs(th.imag) > 1e-14 * max(1.0, abs(th)):
                a2b2 = float(abs(th) ** 2)
                plan.append(("pair", 2.0 * float(th.real), a2b2))
                i += 2
            else:
                plan.append(("real", float(th.real), None))
                i += 1

    def matvec(v):
        # out accumulates p(A)v, prod carries pi_j(A)v
        out = jnp.zeros_like(v)
        prod = v
        for idx, (kind, c1, c2) in enumerate(plan):
            last = idx == len(plan) - 1
            if kind == "real":
                out = out + prod / c1
                if not last:
                    prod = prod - op(prod) / c1
            else:
                Ap = op(prod)
                out = out + (c1 * prod - Ap) / c2
                if not last:
                    prod = prod - (c1 * Ap - op(Ap)) / c2
        return out

    matvec.shape = shape
    matvec.degree = k
    matvec.roots = roots
    return matvec


def _lap2d_grid(u, h2):
    """5-point Laplacian on a 2-D grid array (Dirichlet)."""
    ux = (2.0 * u
          - jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
          - jnp.pad(u[1:, :], ((0, 1), (0, 0))))
    uy = (2.0 * u
          - jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
          - jnp.pad(u[:, 1:], ((0, 0), (0, 1))))
    return (ux + uy) / h2


def _restrict_fw_1d(u, axis):
    """Vertex-centered full weighting along one axis (``n = 2 nc + 1``):
    ``c_j = (u_{2j} + 2 u_{2j+1} + u_{2j+2}) / 4`` as three strided
    slices (separable, so no convolution and no reduced-precision
    conv passes)."""
    u = jnp.moveaxis(u, axis, 0)
    out = (
        0.25 * u[0:-2:2] + 0.5 * u[1:-1:2] + 0.25 * u[2::2]
    )
    return jnp.moveaxis(out, 0, axis)


def _restrict_fw(r):
    """Full-weighting restriction (vertex-centered, ``nx = 2 nc + 1``)."""
    return _restrict_fw_1d(_restrict_fw_1d(r, 0), 1)


def _prolong_bilinear_1d(c, axis):
    """Bilinear prolongation along one axis: odd fine nodes copy the
    coarse value, even fine nodes average their coarse neighbors
    (Dirichlet zero outside); interleaving via stack+reshape keeps the
    layout contiguous instead of strided scatters."""
    c = jnp.moveaxis(c, axis, 0)
    nc = c.shape[0]
    ext = jnp.pad(c, [(1, 1)] + [(0, 0)] * (c.ndim - 1))
    evens = 0.5 * (ext[:-1] + ext[1:])  # nc + 1 values
    inter = jnp.stack([evens[:-1], c], axis=1).reshape(
        (2 * nc,) + c.shape[1:]
    )
    out = jnp.concatenate([inter, evens[-1:]], axis=0)
    return jnp.moveaxis(out, 0, axis)


def _prolong_bilinear(c, nx):
    """Bilinear prolongation (``nx = 2 nc + 1``)."""
    return _prolong_bilinear_1d(_prolong_bilinear_1d(c, 0), 1)


def _dst1(u, axis):
    """DST-I along ``axis`` via the odd-extension FFT (length 2(n+1));
    the accelerator-native path to spectral Poisson solves."""
    u = jnp.moveaxis(u, axis, -1)
    n = u.shape[-1]
    z = jnp.concatenate(
        [
            jnp.zeros(u.shape[:-1] + (1,), u.dtype),
            u,
            jnp.zeros(u.shape[:-1] + (1,), u.dtype),
            -u[..., ::-1],
        ],
        axis=-1,
    )
    f = jnp.fft.rfft(z, axis=-1)
    out = -f.imag[..., 1: n + 1] / 2.0
    return jnp.moveaxis(out.astype(u.dtype), -1, axis)


def poisson_dst_solver(nx, ny=None):
    r"""Fast direct solver for the 2-D Dirichlet Poisson operator by sine
    diagonalization: :math:`x = S \Lambda^{-1} S b` with S the DST-I in
    both grid directions (four FFTs per solve, all fused device work).

    Usable standalone or as the exact coarse/fine solve inside
    :func:`multigrid_poisson_preconditioner`; as a preconditioner it is
    exactly :math:`A^{-1}` for the constant-coefficient operator.
    """
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    ii = np.arange(1, nx + 1)
    jj = np.arange(1, ny + 1)
    lam_x = 4.0 * np.sin(ii * np.pi / (2 * (nx + 1))) ** 2 / hx2
    lam_y = 4.0 * np.sin(jj * np.pi / (2 * (ny + 1))) ** 2 / hy2
    lam = lam_x[:, None] + lam_y[None, :]
    # DST-I is involutory up to the factor 2/(n+1) per direction
    scale = (2.0 / (nx + 1)) * (2.0 / (ny + 1))

    def matvec(b):
        u = b.reshape(nx, ny)
        u = _dst1(_dst1(u, 0), 1)
        u = u / jnp.asarray(lam, u.dtype)
        u = _dst1(_dst1(u, 0), 1) * scale
        return u.reshape(-1)

    matvec.shape = (nx * ny, nx * ny)
    return matvec


def _rb_gs_half(u, r, mask, diag, omega, apply_A):
    """One red-black Gauss-Seidel HALF-update on a grid: the masked
    color's exact GS value via the residual form
    ``u + (omega/diag)(r - A u)`` (equals ``(1-omega)u +
    (omega/diag)(r - offdiag(u))`` since ``A u = diag*u + offdiag(u)``).
    Shared by :func:`ssor_poisson_preconditioner` and the multigrid
    ``smoother='rbgs'`` path."""
    return jnp.where(
        mask, u + (omega / diag) * (r - apply_A(u)), u
    )


def ssor_poisson_preconditioner(nx, ny=None, omega=1.0, sweeps=1):
    r"""Red-black SSOR preconditioner for the 2-D 5-point Laplacian.

    One application performs ``sweeps`` symmetric Gauss-Seidel sweeps
    (forward red->black, backward black->red) of the checkerboard
    coloring: each color's update is a fully vectorized masked stencil
    operation, so the classic sequential triangular solve becomes four
    dense grid updates per sweep -- the vectorized form of Gauss-Seidel
    (lexicographic GS is a serial dependency chain and is NOT
    implemented, by design).  The symmetric sweep order makes M SPD for
    the symmetric operator, so it is a valid CG preconditioner; it is
    also the standard multigrid smoother upgrade over damped Jacobi.

    The reference has no preconditioner gallery at all (user-supplied
    ``M`` only, krypy/linsys.py:61-78).

    :param omega: relaxation factor (1.0 = symmetric Gauss-Seidel).
    :param sweeps: symmetric sweeps per application.
    """
    ny = nx if ny is None else ny
    h2 = (1.0 / (nx + 1)) ** 2
    diag = 4.0 / h2
    ii = jnp.arange(nx)[:, None] + jnp.arange(ny)[None, :]
    red = (ii % 2 == 0)

    def apply_A(u):
        return _lap2d_grid(u, h2)

    def color_update(u, r, mask):
        return _rb_gs_half(u, r, mask, diag, omega, apply_A)

    def matvec(rv):
        r = _to_grid(rv, nx, ny)
        u = jnp.zeros_like(r)
        red_m = red.astype(bool)
        for _ in range(int(sweeps)):
            u = color_update(u, r, red_m)         # forward: red
            u = color_update(u, r, ~red_m)        # forward: black
            u = color_update(u, r, ~red_m)        # backward: black
            u = color_update(u, r, red_m)         # backward: red
        return _to_flat(u)

    matvec.shape = (nx * ny, nx * ny)
    return matvec


def multigrid_poisson_preconditioner(
    nx, nu_pre=2, nu_post=2, omega=0.8, coarsest=7, coarse_sweeps=20,
    coarse_solver=None, smoother="jacobi", scale=1.0,
):
    r"""Geometric multigrid V-cycle preconditioner for the 2-D Dirichlet
    Poisson operator -- the mesh-independent production preconditioner.

    Requires ``nx = 2^k - 1`` for exact vertex-centered grid nesting.
    One application runs a V-cycle with damped-Jacobi smoothing,
    full-weighting restriction and bilinear prolongation, entirely as
    fused stencil/stride operations; the recursion over levels is static,
    so the whole cycle compiles into one XLA program that a solver core
    treats as the preconditioner matvec M ~= A^{-1}.

    (The reference has no preconditioner library -- preconditioners are
    user-supplied operators; this is part of the operator gallery.)

    :param scale: scalar multiplied into the V-cycle output (M becomes
      ``scale * V(r)``) -- for h^2-equilibrated systems where the caller
      would otherwise wrap the preconditioner in ``lambda r: M(r)/h2``.
      XLA fuses the multiply into the last sweep.
    :param smoother: ``"jacobi"`` (damped by ``omega``) or ``"rbgs"``
      (red-black Gauss-Seidel at ``omega = 1`` -- the ``omega``
      parameter applies to the Jacobi smoother only: two checkerboard
      half-updates per sweep, smoothing factor ~0.25 vs Jacobi's ~0.5;
      the POST-smoother runs the colors in reversed order so the
      V-cycle stays symmetric and remains a valid CG preconditioner,
      and the coarse level rounds ``coarse_sweeps`` UP to symmetric
      (forward, reverse) pairs).
    """
    if (nx + 1) & nx != 0:
        raise ValueError("multigrid requires nx = 2^k - 1")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coarse_solver == "dst":
        coarse_solver = poisson_dst_solver(coarsest)

    def lap_grid(u, nx_l, h2):
        """Level Laplacian (one fused stencil pass)."""
        return _lap2d_grid(u, h2)

    def vcycle(r, nx_l):
        r = _level_on_mesh(r)
        h2 = (1.0 / (nx_l + 1)) ** 2
        diag = 4.0 / h2

        if smoother == "rbgs":
            ii = jnp.arange(nx_l)[:, None] + jnp.arange(nx_l)[None, :]
            red = (ii % 2 == 0)

        def smooth(u, n_sweeps, reverse=False):
            if smoother == "rbgs":
                # shared red-black half-update (residual form, omega=1:
                # plain Gauss-Seidel; the `omega` parameter applies to
                # the Jacobi smoother only)
                order = (~red, red) if reverse else (red, ~red)

                def step(u):
                    u = _rb_gs_half(
                        u, r, order[0], diag, 1.0,
                        lambda uu: lap_grid(uu, nx_l, h2),
                    )
                    return _rb_gs_half(
                        u, r, order[1], diag, 1.0,
                        lambda uu: lap_grid(uu, nx_l, h2),
                    )
            else:
                def step(u):
                    return u + (omega / diag) * (
                        r - lap_grid(u, nx_l, h2)
                    )

            if n_sweeps <= 4:
                for _ in range(n_sweeps):
                    u = step(u)
                return u
            # long smoothing chains compile as a rolled loop (XLA compile
            # time grows superlinearly with unrolled stencil chains)
            import jax.lax as lax

            return lax.fori_loop(0, n_sweeps, lambda i, u: step(u), u)

        if nx_l <= coarsest:
            if coarse_solver is not None:
                return coarse_solver(r.reshape(-1)).reshape(r.shape)
            if smoother == "rbgs":
                # palindromic sweeps (forward, reverse) keep the coarse
                # smoothing operator exactly symmetric
                import jax.lax as lax

                def sym_step(i, u):
                    u = smooth(u, 1)
                    return smooth(u, 1, reverse=True)

                # round UP to symmetric pairs: coarse_sweeps=k runs
                # ceil(k/2) (forward, reverse) pairs = k or k+1 sweeps
                return lax.fori_loop(
                    0, (coarse_sweeps + 1) // 2, sym_step,
                    jnp.zeros_like(r),
                )
            return smooth(jnp.zeros_like(r), coarse_sweeps)

        if smoother == "rbgs" or nu_pre < 2:
            u = smooth(jnp.zeros_like(r), nu_pre)
        else:
            # Jacobi sweeps 1+2 from u=0 collapse to one stencil pass:
            # u2 = 2w r - w^2 A r (drops a full lap_grid)
            w = omega / diag
            u = smooth((2.0 * w) * r - (w * w) * lap_grid(r, nx_l, h2),
                       nu_pre - 2)
        res = r - lap_grid(u, nx_l, h2)
        ec = _level_on_mesh(vcycle(_restrict_fw(res), (nx_l - 1) // 2))
        u = u + _prolong_bilinear(ec, nx_l)
        # reversed color order in post-smoothing keeps the cycle
        # symmetric (S_post = S_pre^T)
        return smooth(u, nu_post, reverse=True)

    def matvec(x):
        r = _to_grid(x, nx, nx)
        u = _to_flat(vcycle(r, nx))
        return scale * u if scale != 1.0 else u

    matvec.shape = (nx * nx, nx * nx)
    return matvec


def nls_residual_2d(nx, kappa=1.0, lam=25.0, amplitude=1.0,
                    dtype=jnp.float32):
    r"""Stationary nonlinear-Schrödinger (Gross-Pitaevskii) residual on
    the 2-D unit square:

    .. math:: F(u) = -\Delta u + \kappa u^3 - \lambda u - g,

    with the source g manufactured so that ``u* = amplitude *`` (Gaussian
    bump) satisfies ``F(u*) = 0``.  Returns ``(F, u_star)``.

    The Jacobian action ``J(u) v = -Lap v + 3 kappa u^2 v - lam v`` is
    symmetric; with ``lam`` inside the spectrum of the discrete
    :math:`-\Delta` (first eigenvalue :math:`\approx 2\pi^2` on the unit
    square) it is indefinite with a few low-lying modes -- exactly the
    spectrum recycling deflation targets.  This is the BASELINE config-5
    problem: a Newton sequence of slowly varying symmetric-indefinite
    Jacobian solves.
    """
    lap = poisson_2d(nx)
    xs = np.linspace(1.0 / (nx + 1), nx / (nx + 1.0), nx)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    bump = np.exp(-30.0 * ((X - 0.5) ** 2 + (Y - 0.5) ** 2))
    ustar = jnp.asarray(amplitude * bump.reshape(-1), dtype)
    g = lap(ustar) + kappa * ustar**3 - lam * ustar

    def F(u):
        return lap(u) + kappa * u**3 - lam * u - g

    return F, ustar


def nls_jacobian_sequence(n, n_sys=5, kappa=1.0, seed=0):
    """A sequence of Jacobian-like SPD operators
    ``J_i = Lap_1d + diag(1 + 3 kappa psi_i^2)`` mimicking Newton steps on
    a nonlinear Schrödinger-type equation; the BASELINE config-5 sequence
    of slowly varying systems for recycling benchmarks."""
    lap = poisson_1d(n)
    rng = np.random.RandomState(seed)
    xs = np.linspace(0, 1, n)
    psi = np.exp(-40 * (xs - 0.5) ** 2)
    ops = []
    for i in range(n_sys):
        psi_i = psi * (1.0 + 0.05 * i) + 0.01 * rng.randn(n) * i
        d = jnp.asarray(1.0 + 3.0 * kappa * psi_i**2)

        def matvec(x, _d=d):
            return lap(x) + _d * x

        matvec.shape = (n, n)
        matvec.diag = lap.diag + d
        # operator family: the whole Jacobian sequence shares one
        # compiled solver, with the diagonal part as a traced argument
        matvec.family = ("nls_jacobian", id(lap))
        matvec.params = d
        matvec.rebuild = lambda p, _lap=lap: (lambda x: _lap(x) + p * x)
        ops.append(matvec)
    return ops


def sparse_from_scipy(A):
    """Convert a scipy sparse matrix into a BCOO-backed matvec.

    The returned matvec exposes ``.bcoo`` (the device matrix), ``.diag``
    (so :func:`jacobi_preconditioner` and the Chebyshev/Gershgorin
    estimators work unchanged) and ``.shape``."""
    from jax.experimental import sparse as jsparse

    coo = A.tocoo()
    mat = jsparse.BCOO(
        (
            jnp.asarray(coo.data),
            jnp.column_stack(
                [jnp.asarray(coo.row), jnp.asarray(coo.col)]
            ),
        ),
        shape=coo.shape,
    )

    def matvec(x):
        return mat @ x

    matvec.shape = coo.shape
    matvec.bcoo = mat
    matvec.diag = jnp.asarray(
        A.diagonal(), jnp.asarray(coo.data).dtype
    )
    return matvec


def dia_from_scipy(A, max_diags=512):
    r"""Convert a scipy sparse matrix into a DIAGONAL-format matvec --
    the accelerator-native sparse format for matrices with bounded bandwidth.

    Gather-based sparse formats pay an index read and an irregular
    access per nonzero.  DIA stores one dense vector per occupied
    diagonal and applies

    .. math:: y = \sum_k \mathrm{roll}(d_k \odot x,\; -o_k)

    -- one elementwise multiply + one shift per diagonal, ZERO gathers,
    exact to the last bit.  On a mesh the rolls lower to neighbor
    ``collective-permute``s, not global collectives.  (ROADMAP item A6
    measures BCOO, DIA and BCSR on the GPU.)

    Out-of-band storage positions are zero-filled, so the circular roll
    wraps only zeros -- true wraparound entries (periodic stencils) get
    their own diagonals and remain exact.

    :param max_diags: refuse matrices occupying more distinct diagonals
      (memory is ``n_diags * N`` floats and the matvec does ``n_diags``
      sweeps; apply a bandwidth-reducing ordering -- e.g.
      ``scipy.sparse.csgraph.reverse_cuthill_mckee`` -- first, or fall
      back to :func:`sparse_from_scipy`).
    :return: matvec with ``.dia_data`` ``(n_diags, N)``, ``.offsets``,
      ``.diag``, ``.shape`` and ``.scipy_matrix`` (consumed by
      :func:`block_jacobi_preconditioner`).
    """
    coo = A.tocoo()
    N = coo.shape[0]
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq = np.unique(off)
    if uniq.size > int(max_diags):
        raise ValueError(
            f"matrix occupies {uniq.size} diagonals > max_diags="
            f"{max_diags}: reorder for bandwidth (RCM) or use "
            "sparse_from_scipy"
        )
    data = np.zeros((uniq.size, N), dtype=coo.data.dtype)
    k = np.searchsorted(uniq, off)
    np.add.at(data, (k, coo.col), coo.data)
    dia = jnp.asarray(data)
    offsets = [int(o) for o in uniq]

    def matvec(x):
        prod = dia * x[None, :]
        acc = jnp.zeros_like(x)
        for i, o in enumerate(offsets):
            acc = acc + (jnp.roll(prod[i], -o) if o else prod[i])
        return acc

    matvec.shape = coo.shape
    matvec.dia_data = dia
    matvec.offsets = uniq
    zi = np.searchsorted(uniq, 0)
    matvec.diag = (
        dia[zi]
        if zi < uniq.size and uniq[zi] == 0
        else jnp.zeros(N, dia.dtype)
    )
    matvec.scipy_matrix = A
    return matvec


def _as_scipy_sparse(A):
    """Coerce the unstructured-lane operator forms (scipy sparse, a
    matvec carrying ``.scipy_matrix`` or ``.bcoo``, or a dense array)
    into a scipy sparse matrix."""
    import numpy as np
    import scipy.sparse as sp

    if hasattr(A, "scipy_matrix"):
        return A.scipy_matrix
    if hasattr(A, "bcoo"):
        mat = A.bcoo
        idx = np.asarray(mat.indices)
        return sp.coo_matrix(
            (np.asarray(mat.data), (idx[:, 0], idx[:, 1])),
            shape=mat.shape,
        )
    if hasattr(A, "tocoo"):
        return A
    return sp.csr_matrix(np.asarray(A))


def spai_preconditioner(A, *, pattern="A", ridge=0.0, format="auto",
                        max_diags=512):
    r"""Sparse approximate inverse (SPAI) with a FIXED sparsity pattern:
    :math:`M = \arg\min \|A M - I\|_F` over matrices supported on the
    pattern -- the unstructured-lane preconditioner for NONSYMMETRIC
    operators, where block-Jacobi's symmetric block story is weak and
    ILU's sequential triangular solves map poorly to a data-parallel
    device.

    The minimization decouples into one small least-squares problem per
    column: with support :math:`J_j`, the normal equations are
    :math:`(A^H\!A)[J_j,J_j]\, m_j = (A^H)[J_j, j]`.  Setup runs ONCE on
    the host (columns grouped by support size, each group one batched
    ``numpy.linalg.solve``); the application is a plain sparse matvec on
    device -- gather-free DIA (:func:`dia_from_scipy`) when the pattern
    is banded (``format="auto"``), BCOO otherwise -- so preconditioned
    iterations add ZERO extra collectives on a mesh.

    Honesty certificate: the returned matvec carries
    ``.spai_residual`` = :math:`\|A M - I\|_F / \sqrt{N}` (the exact
    minimized objective, computed host-side; 0 means M is the exact
    inverse on this pattern, ~1 means the pattern cannot represent an
    inverse at all -- widen it with ``pattern="A2"``).

    NOTE: M is NOT Hermitian in general, even for Hermitian A -- use it
    as ``Mr=``/``Ml=`` in :func:`~krypy_tpu.functional.gmres` /
    ``bicgstab`` / ``idrs``; for SPD systems and CG prefer
    :func:`block_jacobi_preconditioner`.

    Reference baseline: krypy ships no preconditioners at all (they
    enter as ``Ml``/``Mr`` callables, krypy/linsys.py:61-74); SPAI is
    accelerator-native surface.

    :param pattern: ``"A"`` (support of A -- the classic SPAI(0) level)
      or ``"A2"`` (support of :math:`A + A^2`: denser, better quality,
      setup cost grows with the squared stencil size).
    :param ridge: added to the normal-equation diagonals (stabilizes
      rank-deficient supports; a tiny trace-scaled jitter is always
      applied).
    :param format: ``"auto"`` / ``"dia"`` / ``"bcoo"`` device layout.
    :return: matvec with ``.spai_residual``, ``.scipy_matrix``,
      ``.shape`` (and the chosen format's attributes).
    """
    import numpy as np
    import scipy.sparse as sp

    A = sp.csc_matrix(_as_scipy_sparse(A))
    N = A.shape[0]
    if pattern == "A":
        P = A
    elif pattern == "A2":
        absA = abs(A)
        P = (absA + absA @ absA).tocsc()
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    # the diagonal must be representable (a zero column in P would pin
    # M's column to zero even when A is e.g. a permutation)
    P = (P + sp.eye(N, format="csc", dtype=A.dtype)).tocsc()

    S = (A.conj().T @ A).tocsr()   # Gram, pattern-sized windows below
    Ah = A.conj().T.tocsr()        # rhs columns: (A^H e_j)[J]

    def _csr_lookup(mat, rr, cc):
        """Vectorized mat[rr, cc] for flat index arrays: within-row
        column indices of a canonical CSR are sorted, so the combined
        key row * (N+1) + col is GLOBALLY sorted over the nnz -- one
        searchsorted resolves every query (absent entries -> 0)."""
        if mat.nnz == 0:
            return np.zeros(rr.shape, dtype=mat.data.dtype)
        mat.sort_indices()
        nnz_rows = np.repeat(
            np.arange(mat.shape[0], dtype=np.int64), np.diff(mat.indptr)
        )
        keys = nnz_rows * (N + 1) + mat.indices.astype(np.int64)
        q = rr.astype(np.int64) * (N + 1) + cc.astype(np.int64)
        pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
        return np.where(keys[pos] == q, mat.data[pos], 0.0)

    indptr, indices = P.indptr, P.indices
    sizes = np.diff(indptr)
    data = np.zeros(indptr[-1], dtype=np.promote_types(A.dtype,
                                                       np.float64))
    for k in np.unique(sizes):
        cols = np.nonzero(sizes == k)[0]
        J = indices[
            (indptr[cols][:, None] + np.arange(k)[None, :]).ravel()
        ].reshape(cols.size, k)
        G = _csr_lookup(
            S,
            np.repeat(J, k, axis=1).ravel(),
            np.tile(J, (1, k)).ravel(),
        ).reshape(cols.size, k, k).astype(data.dtype)
        rhs = _csr_lookup(
            Ah, J.ravel(), np.repeat(cols, k)
        ).reshape(cols.size, k).astype(data.dtype)
        tr = np.einsum("bii->b", G).real / k
        jitter = float(ridge) + 1e-13 * np.maximum(tr, 1.0)
        G[:, np.arange(k), np.arange(k)] += jitter[:, None]
        m = np.linalg.solve(G, rhs[..., None])[..., 0]
        data[
            (indptr[cols][:, None] + np.arange(k)[None, :]).ravel()
        ] = m.ravel()

    M = sp.csc_matrix((data.astype(A.dtype), indices, indptr),
                      shape=(N, N))
    resid = sp.linalg.norm(A @ M - sp.eye(N, format="csc",
                                          dtype=A.dtype)) / np.sqrt(N)

    if format == "auto":
        n_diags = np.unique(
            M.tocoo().col.astype(np.int64) - M.tocoo().row.astype(np.int64)
        ).size
        format = "dia" if n_diags <= max_diags else "bcoo"
    if format == "dia":
        mv = dia_from_scipy(M.tocsr(), max_diags=max_diags)
    elif format == "bcoo":
        mv = sparse_from_scipy(M.tocsr())
        mv.scipy_matrix = M.tocsr()
    else:
        raise ValueError(f"unknown format {format!r}")
    mv.spai_residual = float(resid)
    return mv


def block_jacobi_preconditioner(A, block_size=32, *, shift=0.0):
    r"""Block-Jacobi preconditioner for UNSTRUCTURED operators:
    :math:`M = \mathrm{blockdiag}(A)^{-1}` with dense ``block_size``
    diagonal blocks.

    The strong members of the gallery (multigrid, DST, SSOR) assume the
    2-D stencil family; off the grid, point Jacobi is often all that is
    left.  Block-Jacobi captures the LOCAL coupling a graph-ordered
    operator concentrates near its diagonal, at an accelerator-native cost: the
    application is ONE batched ``(nb, bs, bs) x (nb, bs)`` matmul
    (``einsum('bij,bj->bi')``) -- dense GEMM work, zero collectives on a
    mesh (blocks are local to the N-axis shards whenever the local
    shard size divides ``block_size``), and memory ``N * bs`` floats
    for the factored blocks.

    Blocks are extracted from the EXPLICIT sparsity (a scipy sparse
    matrix, a matvec carrying ``.bcoo`` from :func:`sparse_from_scipy`,
    or a dense array) -- matvec-only probing cannot separate a block
    diagonal without graph coloring, so it is deliberately not offered.
    Inverses are computed host-side once (LU of SPD/diagonally-dominant
    blocks; ``shift`` adds ``shift * I`` per block for indefinite
    operators whose blocks may be singular).

    :param block_size: dense block edge (last block may be smaller;
      internally zero-padded with unit diagonal).
    :return: matvec with ``.blocks`` (the factored ``(nb, bs, bs)``
      inverse tensor), ``.block_size`` and ``.shape``.
    """
    import numpy as np

    bs = int(block_size)
    if hasattr(A, "scipy_matrix"):
        A = A.scipy_matrix
    if hasattr(A, "bcoo"):
        mat = A.bcoo
        N = mat.shape[0]
        idx = np.asarray(mat.indices)
        rows, cols = idx[:, 0], idx[:, 1]
        data = np.asarray(mat.data)
    elif hasattr(A, "tocoo"):
        coo = A.tocoo()
        N = coo.shape[0]
        rows, cols, data = coo.row, coo.col, coo.data
    else:
        Ad = np.asarray(A)
        N = Ad.shape[0]
        rows, cols = np.nonzero(Ad)
        data = Ad[rows, cols]

    nb = -(-N // bs)
    blocks = np.zeros((nb, bs, bs), dtype=data.dtype)
    same = rows // bs == cols // bs
    r, c, v = rows[same], cols[same], data[same]
    np.add.at(blocks, (r // bs, r % bs, c % bs), v)
    if shift:
        blocks += float(shift) * np.eye(bs, dtype=data.dtype)
    # unit diagonal on the zero padding of the trailing block (and any
    # empty rows), so the inverse exists and acts as identity there
    tail = np.arange(nb * bs) >= N
    empty = np.abs(blocks).sum(axis=2).reshape(-1) == 0
    fix = (tail | empty).reshape(nb, bs)
    bidx, lidx = np.nonzero(fix)
    blocks[bidx, lidx, lidx] = 1.0
    inv = jnp.asarray(np.linalg.inv(blocks))

    pad = nb * bs - N

    def matvec(x):
        xr = (
            jnp.pad(x, (0, pad)) if pad else x
        ).reshape(nb, bs)
        y = jnp.einsum("bij,bj->bi", inv, xr).reshape(-1)
        return y[:N] if pad else y

    matvec.blocks = inv
    matvec.block_size = bs
    matvec.shape = (N, N)
    return matvec
