"""Fused CGS2 kernel tests (Pallas interpreter on CPU; the kernel
compiles for the GPU through the Triton route, where chip_smoke.py
phase 5 checks it)."""

import numpy
import pytest
import jax
import jax.numpy as jnp

from krypy_tpu.kernels import orthogonalize as ko
from krypy_tpu.kernels.orthogonalize import (
    apply_project,
    cgs2_fused,
    cgs2_fused_sharded,
)


def _mask(kind, m, rows):
    if kind == "all":
        return numpy.ones(m)
    if kind == "prefix":
        # the GMRES pattern: active rows 0..k, k < rows
        return (numpy.arange(m) <= max(rows // 2, 0)).astype(float)
    return (numpy.arange(m) % 2 == 0).astype(float)


def _cgs2_f64(V, w, mask, rows):
    Vr, mk = V[:rows], mask[:rows]
    c1 = (Vr @ w) * mk
    w1 = w - c1 @ Vr
    c2 = (Vr @ w1) * mk
    return w1 - c2 @ Vr, c1 + c2


@pytest.mark.parametrize("mask_kind", ["all", "prefix", "alternate"])
@pytest.mark.parametrize("basis_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1000, 1023 * 1023, 4095 * 7])
@pytest.mark.parametrize("rows", [1, 7, 26, 41])
def test_cgs2_fused_matches_numpy(rows, N, basis_dtype, mask_kind):
    """The kernel composition against a float64 NumPy CGS2 on the same
    (rounded) basis: masked tails, non-power-of-two N and rows, and a
    bfloat16 basis.  Tolerance: float32 accumulation over N terms."""
    rng = numpy.random.default_rng(rows * 7 + N % 97)
    m = rows + 3
    V = jnp.asarray(rng.standard_normal((m, N)) / numpy.sqrt(N),
                    basis_dtype)
    w = jnp.asarray(rng.standard_normal(N), jnp.float32)
    mask = _mask(mask_kind, m, rows)
    # few programs at the 1M size keep the interpreter quick; the other
    # sizes take the default tile
    block_n = 65536 if N > 100000 else None
    w2, c = cgs2_fused(V, w, jnp.asarray(mask, jnp.float32), rows=rows,
                       block_n=block_n, interpret=True)
    Vd = numpy.asarray(V.astype(jnp.float32), numpy.float64)
    w_ref, c_ref = _cgs2_f64(Vd, numpy.asarray(w, numpy.float64), mask,
                             rows)
    assert w2.dtype == jnp.float32 and w2.shape == (N,)
    assert c.shape == (m,)
    numpy.testing.assert_allclose(numpy.asarray(w2), w_ref,
                                  atol=2e-5 * numpy.abs(w_ref).max())
    numpy.testing.assert_allclose(numpy.asarray(c)[:rows], c_ref,
                                  atol=2e-5 * numpy.linalg.norm(w_ref))
    assert numpy.all(numpy.asarray(c)[rows:] == 0.0)


@pytest.mark.parametrize("rows, expect", [(1, 2048), (8, 1024), (26, 256),
                                          (41, 128), (300, 128)])
def test_tile_width(rows, expect):
    """Tiles hold TILE_ELEMS elements of V, power-of-two wide, within
    [128, 2048] columns; an explicit block_n rounds up to a power of 2."""
    rp = ko._rows_p2(rows)
    assert rp >= rows and rp & (rp - 1) == 0
    assert ko._tile_cols(rp, None) == expect
    assert ko._tile_cols(rp, 1000) == 1024


def test_apply_project_partials_sum_across_tiles():
    """Many programs, each with its own partial coefficients: the sum
    over the (n_tiles, rows) buffer equals the one-tile result."""
    rng = numpy.random.default_rng(5)
    m, N, rows = 9, 5000, 9
    V = jnp.asarray(rng.standard_normal((m, N)), jnp.float32)
    w = jnp.asarray(rng.standard_normal(N), jnp.float32)
    c = jnp.asarray(rng.standard_normal(m), jnp.float32)
    mask = jnp.ones(m, jnp.float32)
    w1a, c2a = apply_project(V, w, c, mask, rows=rows, block_n=128,
                             interpret=True)
    w1b, c2b = apply_project(V, w, c, mask, rows=rows, block_n=8192,
                             interpret=True)
    numpy.testing.assert_allclose(numpy.asarray(w1a), numpy.asarray(w1b),
                                  rtol=1e-6, atol=1e-5)
    numpy.testing.assert_allclose(numpy.asarray(c2a), numpy.asarray(c2b),
                                  rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("what", ["f64_basis", "f64_vector", "no_interpret"])
def test_cgs2_fused_rejects_ineligible(what):
    """No silent fallback: a float64 basis or vector, or the compiled
    kernel on a backend other than the GPU, raises."""
    V = jnp.zeros((4, 256), jnp.float32)
    w = jnp.zeros(256, jnp.float32)
    kw = {"interpret": True}
    if what == "f64_basis":
        V = V.astype(jnp.float64)
    elif what == "f64_vector":
        w = w.astype(jnp.float64)
    else:
        kw = {}
    with pytest.raises(ValueError):
        cgs2_fused(V, w, jnp.ones(4, jnp.float32), **kw)


def test_cgs2_fused_sharded_matches_single_device():
    """The shard_map composition (3 local sweeps + 2 psums) reproduces
    the single-device fused kernel on an 8-device mesh."""
    from krypy_tpu import parallel

    rng = numpy.random.RandomState(3)
    m, N, rows = 9, 1024, 8
    V = jnp.asarray(rng.randn(m, N) / numpy.sqrt(N), jnp.float32)
    w = jnp.asarray(rng.randn(N), jnp.float32)
    mask = (jnp.arange(m) < 6).astype(jnp.float32)

    w_ref, c_ref = cgs2_fused(V, w, mask, rows=rows, interpret=True)

    mesh = parallel.make_mesh(8)
    Vs = jax.device_put(
        V,
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "n")
        ),
    )
    ws = parallel.shard_vector(w, mesh)
    with mesh:
        w_sh, c_sh = jax.jit(
            lambda V_, w_, m_: cgs2_fused_sharded(
                V_, w_, m_, mesh=mesh, rows=rows, interpret=True
            )
        )(Vs, ws, mask)
    # float32: the shards sum their partials in another order
    scale = float(jnp.max(jnp.abs(w_ref)))
    numpy.testing.assert_allclose(
        numpy.asarray(w_sh), numpy.asarray(w_ref), atol=1e-6 * scale
    )
    numpy.testing.assert_allclose(
        numpy.asarray(c_sh), numpy.asarray(c_ref), atol=1e-6 * scale
    )


def test_cgs2_fused_sharded_rejects_indivisible_n():
    from krypy_tpu import parallel

    mesh = parallel.make_mesh(8)
    V = jnp.zeros((4, 1023), jnp.float32)
    with pytest.raises(ValueError, match="divide over the mesh"):
        cgs2_fused_sharded(V, jnp.zeros(1023, jnp.float32),
                           jnp.ones(4, jnp.float32), mesh=mesh,
                           interpret=True)
