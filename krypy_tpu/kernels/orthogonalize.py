"""Fused two-pass classical Gram-Schmidt (CGS2) for the GPU.

For a row-major basis ``V`` of shape ``(m, N)``, a vector ``w`` of shape
``(N,)``, a row mask and a static row prefix ``rows``, CGS2 computes

.. math::
    c_1 = (V_r w) \\odot \\text{mask}, \\quad w_1 = w - c_1^T V_r, \\quad
    c_2 = (V_r w_1) \\odot \\text{mask}, \\quad w_2 = w_1 - c_2^T V_r

with :math:`V_r` the leading ``rows`` rows.  Done as four GEMVs that is
four sweeps of :math:`V_r`: XLA does not fuse two GEMVs of which the
second reads the first one's output.  Here the middle two share one
sweep: :func:`apply_project` is a Pallas kernel (Triton route) in which
each program owns one column tile of :math:`V_r`, holds it in registers,
applies the first-pass update and projects the updated tile for the
second-pass coefficients.  The programs write their partial coefficients
to an ``(n_tiles, rows)`` buffer and a jnp sum finishes them.  The first
projection and the final update are plain GEMVs.  Three sweeps instead
of four.

The reference MGS loop is krypy/utils.py:1012-1029; the batched-CGS
reformulation has dmgs-class stability, see krypy_tpu/arnoldi.py.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "cgs2_fused",
    "cgs2_fused_sharded",
    "check_fused_eligible",
    "project_prefix",
    "apply_project",
    "update_prefix",
]

#: basis storage dtypes the kernel takes (the vector and the
#: coefficients are float32)
BASIS_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))

#: elements of V one program holds in registers: the tile is
#: ``rows_p2 x (TILE_ELEMS // rows_p2)``
TILE_ELEMS = 8192


def check_fused_eligible(V_dtype, w_dtype, interpret):
    """Raise unless the fused kernel can run: a float32 or bfloat16
    basis, a float32 vector, and a GPU backend (or ``interpret=True``,
    which runs the kernel in the Pallas interpreter anywhere)."""
    if jnp.dtype(V_dtype) not in BASIS_DTYPES:
        raise ValueError(
            f"cgs2_fused takes a float32 or bfloat16 basis, not {V_dtype}"
        )
    if jnp.dtype(w_dtype) != jnp.float32:
        raise ValueError(
            f"cgs2_fused takes a float32 vector, not {w_dtype}"
        )
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "cgs2_fused is compiled for the GPU (Pallas, Triton route); "
            f"the backend is {jax.default_backend()!r}.  Pass "
            "interpret=True to run it in the Pallas interpreter."
        )


def _rows_p2(rows):
    return pl.next_power_of_2(max(int(rows), 1))


def _tile_cols(rows_p2, block_n):
    if block_n is not None:
        return pl.next_power_of_2(int(block_n))
    return max(128, min(2048, TILE_ELEMS // rows_p2))


def _apply_project_kernel(V_ref, w_ref, c_ref, mask_ref, w1_ref, part_ref,
                          *, rows, n, tile):
    j = pl.program_id(0)
    rp = c_ref.shape[0]
    cols = j * tile + jnp.arange(tile)
    cmask = cols < n
    rmask = jnp.arange(rp) < rows
    # one read of the (rows_p2, tile) slab of V; rows past `rows` and
    # columns past n are masked to zero
    slab = plgpu.load(
        V_ref.at[pl.ds(0, rp), pl.ds(j * tile, tile)],
        mask=rmask[:, None] & cmask[None, :],
        other=0.0,
    ).astype(jnp.float32)
    w = plgpu.load(w_ref.at[pl.ds(j * tile, tile)], mask=cmask, other=0.0)
    # elementwise products and reductions, not a dot: no TF32
    w1 = w - jnp.sum(c_ref[...][:, None] * slab, axis=0)
    plgpu.store(w1_ref.at[pl.ds(j * tile, tile)], w1, mask=cmask)
    part_ref[j, :] = jnp.sum(slab * w1[None, :], axis=1) * mask_ref[...]


@functools.partial(
    jax.jit, static_argnames=("rows", "block_n", "interpret")
)
def apply_project(V, w, c, mask, *, rows=None, block_n=None,
                  interpret=False):
    """Update and project in ONE sweep of the ``rows`` prefix:
    ``w1 = w - c[:rows]^T V[:rows]`` and
    ``c2 = (V[:rows] w1) * mask[:rows]``.

    :param V: basis rows ``(m, N)``, float32 or bfloat16.
    :param w: float32 vector ``(N,)``.
    :param c: first-pass coefficients, length >= ``rows``.
    :param mask: per-row multiplier, length >= ``rows``.
    :param rows: static number of leading rows to sweep (default m).
    :param block_n: column-tile width (rounded up to a power of two;
      default: ``TILE_ELEMS`` elements of V per program).
    :param interpret: run in the Pallas interpreter.
    :return: ``(w1, c2)`` with ``c2`` zero-padded to length m.
    """
    check_fused_eligible(V.dtype, w.dtype, interpret)
    m, n = V.shape
    rows = m if rows is None else int(rows)
    rp = _rows_p2(rows)
    tile = _tile_cols(rp, block_n)
    n_tiles = pl.cdiv(n, tile)

    def pad(v):
        v = v[:rows].astype(jnp.float32)
        return jnp.pad(v, (0, rp - rows))

    w1, parts = pl.pallas_call(
        functools.partial(
            _apply_project_kernel, rows=rows, n=n, tile=tile
        ),
        grid=(n_tiles,),
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n_tiles, rp), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=4 if rp * tile <= 4096 else 8, num_stages=1
        ),
        interpret=interpret,
        name="cgs2_apply_project",
    )(V, w, pad(c), pad(mask))
    c2 = jnp.sum(parts, axis=0)[:rows]
    return w1, jnp.pad(c2, (0, m - rows))


def project_prefix(V, w, mask, *, rows=None):
    """First-pass coefficients ``(V[:rows] w) * mask[:rows]`` (one GEMV
    sweep of the prefix), zero-padded to length m."""
    m = V.shape[0]
    rows = m if rows is None else int(rows)
    c = jnp.dot(V[:rows], w, preferred_element_type=jnp.float32)
    c = c * mask[:rows].astype(jnp.float32)
    return jnp.pad(c, (0, m - rows))


def update_prefix(V, w, c, *, rows=None):
    """Final update ``w - c[:rows]^T V[:rows]`` (one GEMV sweep)."""
    m = V.shape[0]
    rows = m if rows is None else int(rows)
    return w - jnp.dot(
        c[:rows].astype(jnp.float32), V[:rows],
        preferred_element_type=jnp.float32,
    )


def cgs2_fused(V, w, mask, *, rows=None, block_n=None, interpret=False):
    """Two-pass CGS2 in three sweeps of the ``rows`` prefix of V:
    :func:`project_prefix` -> :func:`apply_project` (kernel) ->
    :func:`update_prefix`.

    :param V: basis rows ``(m, N)``, float32 or bfloat16.
    :param w: float32 vector ``(N,)``.
    :param mask: per-row multiplier ``(m,)``.
    :param rows: static number of leading rows to sweep (default m).
    :return: ``(w_orth, coeffs)`` with ``coeffs = c1 + c2`` of length m.
    """
    check_fused_eligible(V.dtype, w.dtype, interpret)
    m = V.shape[0]
    rows = m if rows is None else int(rows)
    c1 = project_prefix(V, w, mask, rows=rows)
    w1, c2 = apply_project(V, w, c1, mask, rows=rows, block_n=block_n,
                           interpret=interpret)
    return update_prefix(V, w1, c2, rows=rows), c1 + c2


def cgs2_fused_sharded(V, w, mask, *, mesh, rows=None, axis_name=None,
                       block_n=None, interpret=False):
    """Multi-device fused CGS2: three LOCAL sweeps per shard and two
    all-reduces of the (rows,)-sized coefficients.

    The basis ``V`` is column-sharded over the mesh axis, so each device
    runs the three local steps of :func:`cgs2_fused` on its shard with a
    ``psum`` after each projection.  Against batched CGS2 under GSPMD (4
    sweeps, 2 sync points) this saves one basis sweep per iteration at
    the same sync count; against ``cgs2_1r`` (1 sync point, 3 full
    sweeps) it trades two extra round trips for prefix-sized sweeps.
    ``ortho='auto'`` in :mod:`krypy_tpu.functional.gmres` prices the two
    through :mod:`krypy_tpu.functional.policy`.

    Same contract as :func:`cgs2_fused`; N must divide over the mesh.
    """
    check_fused_eligible(V.dtype, w.dtype, interpret)
    axis_name = mesh.axis_names[0] if axis_name is None else axis_name
    m, N = V.shape
    rows = m if rows is None else int(rows)
    n_dev = mesh.shape[axis_name]
    if N % n_dev != 0:
        raise ValueError(
            f"N={N} must divide over the mesh size {n_dev} for the "
            "sharded fused path (use ortho='cgs2_1r' otherwise)"
        )
    P = jax.sharding.PartitionSpec

    def local(V_loc, w_loc, maskv):
        c1 = jax.lax.psum(
            project_prefix(V_loc, w_loc, maskv, rows=rows), axis_name
        )
        w1_loc, c2p = apply_project(
            V_loc, w_loc, c1, maskv, rows=rows, block_n=block_n,
            interpret=interpret,
        )
        c2 = jax.lax.psum(c2p, axis_name)
        return update_prefix(V_loc, w1_loc, c2, rows=rows), c1 + c2

    # check_vma=False: pallas_call's out_shape carries no varying-mesh-
    # axes annotation, which the default check rejects
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis_name), P(axis_name), P()),
        out_specs=(P(axis_name), P()),
        check_vma=False,
    )(V, w, mask)
