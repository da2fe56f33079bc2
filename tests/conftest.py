"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding tests use the virtual devices (the driver separately
dry-runs the multi-chip path); numerics tests need float64 to check the
reference-grade identities (~1e-14).

The platform is pinned to the CPU in the config (after importing jax
and before first use), so the suite runs on the CPU on any machine,
including one with a GPU.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# A long pytest session accumulates thousands of compiled executables
# in one process, after which XLA:CPU's JIT segfaults compiling the
# next while_loop (reproduced three times at ~99%, in different
# test_sstep tests each time, always inside backend_compile_and_load;
# first on the 11.7K-test full grid, then on the default run once the
# suite grew past ~4.4K tests).  Dropping the compilation caches
# between modules bounds the live-executable count; measured cost is
# ~nil (the full grid ran 27:30 with clearing, in line with the
# default run, because cross-module cache reuse is rare).
# The STRUCTURAL fix is process sharding: `-n auto --dist loadscope`
# (pytest-xdist, CI default) keeps whole modules per worker so each
# process compiles ~1/N of the executables; this fixture stays as
# belt-and-braces for serial runs.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
