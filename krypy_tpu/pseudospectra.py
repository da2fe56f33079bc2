"""Native epsilon-pseudospectrum computation.

The reference delegates pseudospectra to the external ``pseudopy`` package
(lazily imported at krypy/deflation.py:617).  This module provides the
functionality natively:

* :class:`NormalEvals` -- for normal matrices the
  :math:`\\varepsilon`-pseudospectrum is exactly the union of disks of
  radius :math:`\\varepsilon` around the eigenvalues; the boundary (arcs of
  circles outside all other disks) is computed in closed form.
* :class:`NonnormalMeshgrid` / :class:`NonnormalAuto` -- for non-normal
  matrices, :math:`\\sigma_{\\min}(A - zI)` is evaluated on a complex grid
  as one *batched* device SVD (vmap over grid points -- dense linalg that
  maps well onto the matrix units), and level sets are extracted with contourpy.

The objects expose ``contour_paths(epsilon)`` returning a :class:`Paths`
with ``vertices()`` (complex boundary points) and ``length()`` (total
boundary length), the interface consumed by
:func:`krypy_tpu.deflation.bound_pseudo` and
:func:`krypy_tpu.spectral.bound_perturbed_gmres`.
"""

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["Path", "Paths", "NormalEvals", "NonnormalMeshgrid", "NonnormalAuto"]


class Path:
    """A polyline in the complex plane."""

    def __init__(self, vertices):
        self._vertices = np.asarray(vertices, dtype=complex).ravel()

    def vertices(self):
        return self._vertices

    def length(self):
        if self._vertices.size < 2:
            return 0.0
        return float(np.sum(np.abs(np.diff(self._vertices))))


class _Arc(Path):
    """A circular arc, with exact length."""

    def __init__(self, center, radius, phi0, phi1, n_points=64):
        self.center = center
        self.radius = radius
        self.phi0 = phi0
        self.phi1 = phi1
        phis = np.linspace(phi0, phi1, max(2, n_points))
        super().__init__(center + radius * np.exp(1j * phis))

    def length(self):
        return float(abs(self.phi1 - self.phi0) * self.radius)


class Paths:
    """A collection of boundary paths."""

    def __init__(self, paths=None):
        self.paths = list(paths) if paths is not None else []

    def append(self, path):
        self.paths.append(path)

    def vertices(self):
        if not self.paths:
            return np.zeros((0,), dtype=complex)
        return np.concatenate([p.vertices() for p in self.paths])

    def length(self):
        return float(sum(p.length() for p in self.paths))


def _merge_intervals(intervals):
    """Merge overlapping [lo, hi] intervals."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


class NormalEvals:
    """Pseudospectrum of a normal matrix: union of eigenvalue disks.

    ``contour_paths(epsilon)`` returns the exact boundary of the union of
    disks :math:`|z - \\lambda_i| \\le \\varepsilon`: for each disk the
    angular intervals hidden inside other disks are subtracted and the
    remaining arcs returned.
    """

    def __init__(self, evals):
        self.evals = np.asarray(evals, dtype=complex).ravel()

    def contour_paths(self, epsilon, n_points=128):
        paths = Paths()
        lam = self.evals
        r = float(epsilon)
        for i, ci in enumerate(lam):
            covered = []
            fully_covered = False
            for j, cj in enumerate(lam):
                if i == j:
                    continue
                dist = abs(cj - ci)
                if dist == 0:
                    continue
                if dist >= 2 * r:
                    continue  # equal radii: disks intersect iff dist < 2r
                # angular window of circle i hidden inside disk j
                # (equal radii r): half-angle = arccos(dist / (2 r))
                half = np.arccos(dist / (2 * r))
                mid = np.angle(cj - ci)
                covered.append((mid - half, mid + half))
            # normalize angular intervals into [0, 2pi), splitting wrap-around
            norm_cov = []
            for lo, hi in covered:
                span = hi - lo
                lo = lo % (2 * np.pi)
                hi = lo + span
                if hi <= 2 * np.pi:
                    norm_cov.append((lo, hi))
                else:
                    norm_cov.append((lo, 2 * np.pi))
                    norm_cov.append((0.0, hi - 2 * np.pi))
            merged = _merge_intervals(norm_cov)
            if merged and merged[0][0] <= 0 and merged[-1][1] >= 2 * np.pi:
                fully_covered = len(merged) == 1
            if fully_covered:
                continue
            # visible arcs = complement of merged within [0, 2pi)
            if not merged:
                paths.append(_Arc(ci, r, 0.0, 2 * np.pi, n_points))
                continue
            cursor = 0.0
            for lo, hi in merged:
                if lo > cursor:
                    paths.append(_Arc(ci, r, cursor, lo, n_points))
                cursor = max(cursor, hi)
            if cursor < 2 * np.pi:
                paths.append(_Arc(ci, r, cursor, 2 * np.pi, n_points))
        return paths


def _smallest_singular_values(A, zs):
    """sigma_min(A - z I) for a batch of shifts, as one vmapped device SVD."""
    A = jnp.asarray(A, dtype=jnp.complex128 if jnp.asarray(A).dtype.kind == "c"
                    or np.iscomplexobj(zs) else jnp.asarray(A).dtype)
    n = A.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)
    zs_j = jnp.asarray(zs, dtype=A.dtype if A.dtype.kind == "c"
                       else jnp.complex128)
    A_c = A.astype(zs_j.dtype)
    eye_c = eye.astype(zs_j.dtype)

    def smin(z):
        s = jnp.linalg.svd(A_c - z * eye_c, compute_uv=False)
        return s[-1]

    return np.asarray(jax.vmap(smin)(zs_j))


class NonnormalMeshgrid:
    """Grid evaluation of :math:`\\sigma_{\\min}(A - zI)` with contour
    extraction of pseudospectrum boundaries."""

    def __init__(
        self,
        A,
        real_min=-1.0,
        real_max=1.0,
        real_n=50,
        imag_min=-1.0,
        imag_max=1.0,
        imag_n=50,
    ):
        self.A = np.asarray(A)
        real = np.linspace(real_min, real_max, real_n)
        imag = np.linspace(imag_min, imag_max, imag_n)
        self.Real, self.Imag = np.meshgrid(real, imag)
        zs = (self.Real + 1j * self.Imag).ravel()
        self.Vals = _smallest_singular_values(self.A, zs).reshape(
            self.Real.shape
        )

    def contour_paths(self, epsilon, n_points=None):
        """Extract the epsilon level set as polyline paths."""
        from contourpy import contour_generator

        gen = contour_generator(
            x=self.Real, y=self.Imag, z=self.Vals
        )
        lines = gen.lines(float(epsilon))
        paths = Paths()
        for line in lines:
            line = np.asarray(line)
            if line.shape[0] >= 2:
                paths.append(Path(line[:, 0] + 1j * line[:, 1]))
        return paths


class NonnormalAuto(NonnormalMeshgrid):
    """Meshgrid pseudospectrum with automatic bounding box covering all
    epsilon-pseudospectra for ``epsilon <= delta_max`` (the
    pseudospectrum lies within distance delta_max of the spectrum)."""

    def __init__(self, A, delta_min, delta_max, n_points=60, **kwargs):
        A = np.asarray(A)
        evals = np.linalg.eigvals(A)
        pad = 1.1 * delta_max
        super().__init__(
            A,
            real_min=float(np.min(evals.real) - pad),
            real_max=float(np.max(evals.real) + pad),
            real_n=n_points,
            imag_min=float(np.min(evals.imag) - pad),
            imag_max=float(np.max(evals.imag) + pad),
            imag_n=n_points,
            **kwargs,
        )
