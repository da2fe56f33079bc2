"""chip_smoke.py's four-card legs at small sizes on four virtual CPU
devices (the kernel in the Pallas interpreter): the partitioning checks
pass, and each mesh solve matches the one-device solve.  On the cards
the same functions run at full size (``chip_smoke.py --four-cards``)."""

import os
import sys

import jax.numpy as jnp
import pytest

from krypy_tpu import ops, parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def small(smoke):
    return smoke.Sizes(headline_nx=63, northstar_nx=127, ortho_nx=31,
                       stream_n=1 << 16, stencil_nx=(63,), aligned_nx=128)


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(4)


def test_four_card_northstar_odd_n(smoke, small, mesh):
    times = smoke.four_card_northstar(small, mesh)
    assert set(times) == {"auto", "cgs2_1r"}


def test_four_card_aligned_sharded_kernel(smoke, small, mesh):
    times = smoke.four_card_aligned(small, mesh, interpret=True)
    assert set(times) == {"auto", "cgs2_fused"}


def test_four_card_cg(smoke, small, mesh):
    assert smoke.four_card_cg(small, mesh)["auto"] > 0


def test_replicated_program_fails_partition_check(smoke, small, mesh):
    """A program GSPMD leaves replicated (a diagonal operator on an odd
    N: nothing pins a split) is refused."""
    import jax
    from krypy_tpu import functional as F

    N = 127 * 127
    A = ops.diagonal(jnp.linspace(1.0, 2.0, N, dtype=jnp.float32))
    fn = jax.jit(lambda bb: F.cg(A, bb, tol=1e-5, maxiter=20))
    b = jnp.ones(N, jnp.float32)
    temp_one = smoke._program(fn, jax.device_put(b, jax.devices()[0]))[1]
    with pytest.raises(SystemExit):
        smoke._check_partitioned("diag cg", mesh, fn,
                                 parallel.shard_vector(b, mesh), temp_one)
