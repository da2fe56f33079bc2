"""krypy_tpu -- an accelerator-native Krylov subspace solver framework.

A from-scratch JAX/XLA/Pallas rebuild of the capability set of KryPy
(https://github.com/andrenarchy/krypy, reference mounted at
/root/reference): CG, MINRES and GMRES with user-defined inner products and
two-sided preconditioning, deflation with oblique projections and
Ritz/harmonic-Ritz extraction, and recycling for sequences of linear
systems -- redesigned for compiled accelerator execution:

* solver hot loops compile once into ``jax.lax.while_loop`` kernels with
  on-device convergence checks (:mod:`krypy_tpu.functional`);
* the N-dimensional data path (vectors, Krylov bases, matvecs, inner
  products) shards over a ``jax.sharding.Mesh`` so inner products become
  local partial contractions + all-reduces (:mod:`krypy_tpu.parallel`);
* the fused two-pass Gram-Schmidt step runs as a Pallas kernel on the
  GPU (:mod:`krypy_tpu.kernels`); everything else is XLA-compiled jnp;
* the reference's eager, object-style API (``linsys``, ``deflation``,
  ``recycling``, ``utils``) is preserved for drop-in compatibility.
"""

from . import config  # noqa: F401  (must be first: enables x64)
from . import utils  # noqa: F401

__version__ = "0.1.0"

from . import linsys  # noqa: E402,F401
from . import deflation  # noqa: E402,F401
from . import recycling  # noqa: E402,F401
from ._convenience import cg, gmres, minres  # noqa: E402,F401

__all__ = [
    "linsys",
    "deflation",
    "recycling",
    "utils",
    "cg",
    "minres",
    "gmres",
    "__version__",
]
