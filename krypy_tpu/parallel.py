"""Mesh and sharding utilities -- the distributed layer of krypy_tpu.

The reference is a single-address-space library (SURVEY.md section 2:
parallelism ABSENT); its scalability hook is the matrix-free operator
protocol.  Here, distribution is first-class and follows the GSPMD model:

* the long axis is the vector dimension N; vectors and the Krylov basis
  ``(m+1, N)`` are sharded over a 1-D device mesh along N;
* the small dense state (Hessenberg, Givens, projected rhs) is replicated;
* no explicit collectives are written: inner products are partial
  contractions + an XLA-inserted ``psum``; the 2-D stencil operators
  pin a grid-row split (``ops._to_grid``), so GSPMD exchanges halo rows
  for any N, odd N included;
* multi-host runs reuse the same program (jax.distributed + GSPMD).

Typical usage::

    mesh = make_mesh()                      # all local devices, axis "n"
    A = ops.poisson_2d(nx)                  # stencil matvec
    b = shard_vector(b, mesh)               # device_put with NamedSharding
    solve = jax.jit(lambda b: functional.cg(A, b, tol=1e-8, maxiter=500))
    result = solve(b)                       # partitioned automatically
"""

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "init_distributed",
    "make_mesh",
    "make_global_vector",
    "shard_vector",
    "replicate",
    "sharded_solve",
    "active_mesh_size",
    "active_mesh",
]


def active_mesh():
    """The CONCRETE :class:`~jax.sharding.Mesh` of the context the
    caller traces under, or ``None``.

    Unlike :func:`active_mesh_size` this must return a physical mesh
    (``jax.shard_map`` needs device placement, not just a size), so only
    the ``with Mesh(...):`` resource environment qualifies; an abstract
    sharding context without devices returns ``None``.
    """
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            from jax.interpreters import pxla

            m = pxla.thread_resources.env.physical_mesh
        if not m.empty and m.devices.size > 1:
            return m
    except (ImportError, AttributeError):
        pass
    return None


def active_mesh_size():
    """Number of devices of the mesh context the caller traces under, or
    0 when no mesh is active.

    Used by trace-time heuristics (``ortho='auto'``) to pick
    latency-optimal schemes on multi-chip meshes.  Probes both the
    modern sharding context and the legacy ``with Mesh(...):`` resource
    environment; returns 0 if neither reports a mesh (conservative:
    heuristics then assume single-chip).
    """
    try:
        from jax.sharding import get_abstract_mesh

        m = get_abstract_mesh()
        if m is not None and not m.empty:
            return int(m.size)
    except (ImportError, AttributeError):
        pass
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            from jax.interpreters import pxla

            m = pxla.thread_resources.env.physical_mesh
        if not m.empty:
            return int(m.devices.size)
    except (ImportError, AttributeError):
        pass
    return 0


def init_distributed(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_count=None,
):
    """Initialize multi-host (DCN) execution.

    Wraps :func:`jax.distributed.initialize`: after it returns,
    ``jax.devices()`` spans every host and the same jitted solver program
    runs unchanged on a global mesh -- GSPMD inserts the collectives
    within and across hosts.  Must be
    called before any jax computation (it has to run before the backend
    initializes).

    Pass them explicitly on CPU/GPU clusters (and in the 2-process CPU
    test, tests/test_distributed.py).

    :param coordinator_address: ``"host:port"`` of process 0.
    :param num_processes: world size.
    :param process_id: this process's rank.
    :param local_device_count: if given, force this many virtual CPU
      devices per process (testing without hardware; sets XLA_FLAGS, so
      it must precede backend initialization).
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        marker = "--xla_force_host_platform_device_count="
        if marker in flags:
            existing = flags.split(marker, 1)[1].split()[0]
            if existing != str(local_device_count):
                raise ValueError(
                    f"XLA_FLAGS already forces {existing} host devices "
                    f"but local_device_count={local_device_count} was "
                    "requested; clear the flag or pass a matching count"
                )
        else:
            os.environ["XLA_FLAGS"] = (
                flags + f" {marker}{local_device_count}"
            ).strip()
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_global_vector(mesh, data_for_index, global_shape, dtype=None,
                       axis_name=None, sharded_axis=0):
    """Assemble a process-spanning sharded vector on a (possibly
    multi-host) mesh.

    :param data_for_index: callable mapping an index tuple (the shard's
      slice into the global array) to the shard's numpy data -- each
      process only materializes the shards it hosts.
    :param global_shape: full logical shape.
    :param sharded_axis: which logical axis is distributed (default 0:
      the N axis -- both for 1-D vectors and ``(N, d)`` deflation
      bases, whose small d axis stays replicated).
    """
    axis_name = mesh.axis_names[0] if axis_name is None else axis_name
    spec_list = [None] * len(global_shape)
    spec_list[sharded_axis] = axis_name
    spec = P(*spec_list)
    sharding = NamedSharding(mesh, spec)

    def _cb(index):
        arr = np.asarray(data_for_index(index))
        return arr if dtype is None else arr.astype(dtype)

    return jax.make_array_from_callback(
        tuple(global_shape), sharding, _cb
    )


def make_mesh(n_devices=None, axis_name="n", devices=None):
    """Build a 1-D device mesh over the vector axis.

    :param n_devices: number of devices (default: all available).
    :param axis_name: mesh axis name (default ``"n"``).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_vector(x, mesh, axis_name=None):
    """Place a vector (or row-major basis block) with its last axis sharded
    over the mesh.

    N need not divide the mesh size, but a ``jax.Array`` cannot hold an
    uneven split: an indivisible vector comes back REPLICATED.  A solve
    jitted under the mesh still splits it inside the program wherever
    an operator pins a split (the 2-D stencils do), and returns its
    solution replicated."""
    axis_name = mesh.axis_names[0] if axis_name is None else axis_name
    x = jnp.asarray(x)
    spec = P(*([None] * (x.ndim - 1) + [axis_name]))
    sharding = NamedSharding(mesh, spec)
    if x.shape[-1] % mesh.devices.size != 0:
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.device_put(x, sharding)


def replicate(x, mesh):
    """Replicate small state across the mesh."""
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))


def sharded_solve(solver, A, b, mesh=None, **kwargs):
    """Run a functional solver with b (and all N-dim state) sharded over
    the mesh.  ``solver`` is one of :mod:`krypy_tpu.functional`'s cg /
    minres / gmres; static solver options go in ``kwargs``.

    Returns the :class:`~krypy_tpu.functional.common.SolveResult` with the
    solution sharded like b.
    """
    if mesh is None:
        mesh = make_mesh()
    b_sharded = shard_vector(b, mesh)

    @partial(jax.jit, static_argnames=())
    def _run(bb):
        return solver(A, bb, **kwargs)

    with mesh:
        return _run(b_sharded)
