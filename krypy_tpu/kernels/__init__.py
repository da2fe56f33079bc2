"""Hand-written GPU kernels for the solver hot paths.

The reference's "native layer" is BLAS under numpy (SURVEY.md L0).  Here
XLA compiles almost everything; a kernel exists only where XLA leaves
bandwidth on the table:

* :mod:`~krypy_tpu.kernels.orthogonalize` -- fused two-pass classical
  Gram-Schmidt (``ortho='cgs2_fused'``): the middle update+projection
  pair of CGS2 in one sweep of the basis, as a Pallas kernel on the
  Triton route.

Kernels compile for the GPU only.  ``interpret=True``, passed by name,
runs them in the Pallas interpreter, which is how the CPU tests check
them.
"""

from .orthogonalize import cgs2_fused

__all__ = ["cgs2_fused"]
