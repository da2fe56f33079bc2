"""Batched solves: ``jax.vmap`` over the functional cores.

The functional lane's design contract -- pure matvec callables, static
shapes, status codes instead of exceptions, one ``lax.while_loop`` per
solve -- makes every core a valid vmap target: thousands of independent
small systems become ONE device program (the while_loop runs until the
slowest batch member finishes; finished members are masked).  This is a
capability the reference cannot express at all (krypy solvers are
stateful Python objects, krypy/linsys.py:330-520); on the device it is how
small-system workloads (per-cell chemistry, per-sample calibration,
parameter sweeps) reach the matrix-unit.

Sharding the BATCH axis over a mesh makes the program embarrassingly
parallel: the compiled loop body contains ZERO collectives (pinned
below) -- the complement of the sharded-N regime tested in
test_collectives.py.
"""

import numpy
import pytest
import jax
import jax.numpy as jnp

import krypy_tpu  # noqa: F401 -- x64 policy
from krypy_tpu import functional as F, parallel

from helpers import loop_body_allreduces


def _spd_batch(B=48, n=24, seed=0, dtype=numpy.float64):
    rng = numpy.random.default_rng(seed)
    Q = numpy.linalg.qr(rng.standard_normal((B, n, n)))[0]
    evs = rng.uniform(1.0, 10.0, (B, n))
    As = numpy.einsum("bij,bj,bkj->bik", Q, evs, Q).astype(dtype)
    bs = rng.standard_normal((B, n)).astype(dtype)
    return As, bs


@pytest.mark.parametrize(
    "solver, kw",
    [
        (F.cg, {}),
        (F.cg, {"variant": "1r"}),
        (F.minres, {}),
        (F.gmres, {}),
        (F.bicgstab, {}),
    ],
)
def test_vmap_batch_solves_every_system(solver, kw):
    As, bs = _spd_batch()
    res = jax.jit(
        jax.vmap(lambda A, b: solver(A, b, tol=1e-10, maxiter=120, **kw))
    )(jnp.asarray(As), jnp.asarray(bs))
    assert bool((numpy.asarray(res.status) == F.CONVERGED).all())
    xs = numpy.asarray(res.x)
    for i in range(As.shape[0]):
        rel = numpy.linalg.norm(
            As[i] @ xs[i] - bs[i]
        ) / numpy.linalg.norm(bs[i])
        assert rel <= 1e-9, (i, rel)
    # per-system iteration counts are individual, not the batch max
    niters = numpy.asarray(res.niter)
    assert niters.min() < niters.max()


def test_vmap_batch_matches_loop():
    """Batched result == one-at-a-time solves (same core, masked loop)."""
    As, bs = _spd_batch(B=8)
    batched = jax.jit(
        jax.vmap(lambda A, b: F.cg(A, b, tol=1e-12, maxiter=100))
    )(jnp.asarray(As), jnp.asarray(bs))
    for i in range(8):
        single = F.cg(jnp.asarray(As[i]), jnp.asarray(bs[i]), tol=1e-12,
                      maxiter=100)
        assert int(single.niter) == int(batched.niter[i])
        numpy.testing.assert_allclose(
            numpy.asarray(batched.x[i]), numpy.asarray(single.x),
            rtol=1e-10, atol=1e-12,
        )


def test_sharded_batch_axis_is_collective_free():
    """BATCH-axis sharding: each device solves its slice of systems;
    the compiled loop body must contain ZERO all-reduces (the
    complement of the sharded-N regime)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = parallel.make_mesh(8)
    As, bs = _spd_batch(B=32, n=16, dtype=numpy.float32)
    axis = mesh.axis_names[0]
    Ad = jax.device_put(jnp.asarray(As),
                        NamedSharding(mesh, P(axis, None, None)))
    bd = jax.device_put(jnp.asarray(bs), NamedSharding(mesh, P(axis, None)))
    solve = jax.jit(
        jax.vmap(lambda A, b: F.cg(A, b, tol=1e-5, maxiter=64))
    )
    with mesh:
        res = solve(Ad, bd)
        assert loop_body_allreduces(solve, Ad, bd, mesh=mesh) == 0
    assert bool((numpy.asarray(res.status) == F.CONVERGED).all())
    n_shards = len({s.device for s in res.x.addressable_shards})
    assert n_shards == 8
