"""Global numerical configuration for krypy_tpu.

The reference library (krypy, /root/reference) inherits float64 semantics from
NumPy.  JAX defaults to float32, so we opt into 64-bit mode at import time
unless the user disables it via the ``KRYPY_TPU_X64`` environment variable
(set it to ``0`` for a float32-only process, e.g. in benchmarks).

Note that enabling x64 does *not* force computations into float64: arrays
created with an explicit ``dtype=jnp.float32`` stay in float32 all the way
through the solvers.  It only makes float64 *available*, which the
reference-parity test-suite requires (identities at ~1e-14).
"""

import os

import jax

_X64 = os.environ.get("KRYPY_TPU_X64", "1") != "0"

if _X64:
    jax.config.update("jax_enable_x64", True)

# f32 matmuls may run at reduced precision by default (TF32 on the GPU),
# which silently injects ~1e-3..1e-4 relative noise into the library's
# core contractions -- inner products, Gram-Schmidt sweeps, Gram
# matrices.  A numerics library must not trade digits silently, so full
# f32 accumulation is the import-time default.  The solver hot paths are
# matrix-vector contractions, bound by memory bandwidth far below the
# tensor-core balance point, so the cost is small.  Opt out (e.g. for
# bf16-dominated workloads) with ``KRYPY_TPU_PRECISION=default``.
_PRECISION = os.environ.get("KRYPY_TPU_PRECISION", "highest")
if _PRECISION != "default":
    jax.config.update("jax_default_matmul_precision", _PRECISION)


#: directory of the persistent compile cache when the environment names
#: none: fixed, because the path is part of the cache key
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)


def use_compile_cache():
    """Turn on JAX's persistent compilation cache for a script.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here.  Otherwise the cache goes to the fixed
    directory :data:`REPO_CACHE_DIR` (``<repo>/.jax_cache``).  Scripts
    call this at start-up; importing the library never does.

    :return: the cache directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def x64_enabled() -> bool:
    """Return True if 64-bit mode was enabled at import time."""
    return _X64


def default_float():
    """The widest available real floating dtype."""
    import jax.numpy as jnp

    return jnp.float64 if _X64 else jnp.float32


def default_complex():
    """The widest available complex floating dtype."""
    import jax.numpy as jnp

    return jnp.complex128 if _X64 else jnp.complex64


#: Relative breakdown threshold used for invariance detection in the
#: Arnoldi/Lanczos iterations (reference: krypy/utils.py:1035-1039 uses 1e-14
#: in float64).  Parameterized by dtype so the float32 path uses a
#: consistent threshold.
def invariance_threshold(dtype) -> float:
    import numpy as np

    eps = np.finfo(np.dtype(dtype)).eps
    # 1e-14 ~ 45*eps in float64; scale the same multiple for other dtypes.
    return float(45 * eps)
