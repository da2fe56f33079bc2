"""The device-facing surface off the device: the price-model tables and
their unknown-backend error, ``ortho='auto'``'s choice per backend, the
explicit ``cgs2_fused`` eligibility errors, the compile-cache placement,
and chip_smoke.py's host float64 reference operators."""

import os
import sys

import numpy
import pytest
import jax
import jax.numpy as jnp

from krypy_tpu import config, functional as F, ops, parallel
from krypy_tpu.functional import policy
from krypy_tpu.functional.gmres import resolve_auto_ortho

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def backend(monkeypatch):
    """Pretend JAX's default backend is the given platform name."""
    def set_backend(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_backend


# ----------------------------------------------------------- price model
@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_policy_table_resolves(name, backend, monkeypatch):
    monkeypatch.setattr(policy, "SYNC_S", None)
    monkeypatch.setattr(policy, "HBM_BYTES_PER_S", None)
    monkeypatch.delenv("KRYPY_TPU_SYNC_S", raising=False)
    monkeypatch.delenv("KRYPY_TPU_HBM_BYTES_PER_S", raising=False)
    backend(name)
    assert policy.sync_s() == policy.SYNC_S_TABLE[name] > 0
    assert policy.hbm_bytes_per_s() == policy.HBM_BYTES_PER_S_TABLE[name]
    assert policy.sweep_s(10**6, 4) == pytest.approx(
        4e6 / policy.HBM_BYTES_PER_S_TABLE[name]
    )


@pytest.mark.parametrize("name", ["neuron", "rocm", "METAL"])
def test_policy_unknown_backend_raises(name, backend, monkeypatch):
    """A backend without measured constants is an error naming the
    environment variables that calibrate it, not a silent default."""
    monkeypatch.setattr(policy, "SYNC_S", None)
    monkeypatch.setattr(policy, "HBM_BYTES_PER_S", None)
    monkeypatch.delenv("KRYPY_TPU_SYNC_S", raising=False)
    monkeypatch.delenv("KRYPY_TPU_HBM_BYTES_PER_S", raising=False)
    backend(name)
    with pytest.raises(RuntimeError, match="KRYPY_TPU_SYNC_S"):
        policy.sync_s()
    with pytest.raises(RuntimeError, match="KRYPY_TPU_HBM_BYTES_PER_S"):
        policy.hbm_bytes_per_s()
    with pytest.raises(RuntimeError):
        policy.prefer_one_reduce("cg", 10**6, 4)


def test_policy_env_calibrates_unknown_backend(backend, monkeypatch):
    monkeypatch.setattr(policy, "SYNC_S", None)
    monkeypatch.setattr(policy, "HBM_BYTES_PER_S", None)
    monkeypatch.setenv("KRYPY_TPU_SYNC_S", "3e-5")
    monkeypatch.setenv("KRYPY_TPU_HBM_BYTES_PER_S", "2e12")
    backend("rocm")
    assert policy.sync_s() == 3e-5
    assert policy.hbm_bytes_per_s() == 2e12


def test_policy_tables_hold_only_measured_backends():
    assert set(policy.SYNC_S_TABLE) == {"gpu", "cpu"}
    assert set(policy.HBM_BYTES_PER_S_TABLE) == {"gpu", "cpu"}
    assert all(v > 0 for v in policy.ONE_REDUCE_EXTRA_SWEEPS.values())


def test_prefer_one_reduce_monotone_in_shard_size(monkeypatch):
    """Fixed sync cost: small shards take the one-reduce variant, large
    shards (extra traffic outweighs the saved sync) the classic one."""
    monkeypatch.setattr(policy, "SYNC_S", 1e-5)
    monkeypatch.setattr(policy, "HBM_BYTES_PER_S", 1e12)
    assert policy.prefer_one_reduce("cg", 10**3, 4)
    assert not policy.prefer_one_reduce("cg", 10**9, 4)


@pytest.mark.parametrize("n_local", [10**3, 10**5, 10**7])
def test_deflated_minres_priced_as_deflated_cg(n_local, monkeypatch):
    """Deflated MINRES's one-reduce fold is the deflated CG fold: it
    takes that measured figure, not CG's."""
    monkeypatch.setattr(policy, "SYNC_S", 16.7e-6)
    monkeypatch.setattr(policy, "HBM_BYTES_PER_S", 2.758e12)
    sweeps = policy.ONE_REDUCE_EXTRA_SWEEPS
    assert sweeps["deflated_minres"] == sweeps["deflated_cg"]
    assert policy.prefer_one_reduce("deflated_minres", n_local, 4) == \
        policy.prefer_one_reduce("deflated_cg", n_local, 4)


@pytest.mark.parametrize("N, split", [(4096, True), (4095, False)])
def test_shard_vector_split_or_replicated(N, split):
    """An evenly dividing vector is split over the mesh; an odd one
    cannot be held split and comes back replicated, whole on each
    device."""
    mesh = parallel.make_mesh(4)
    x = parallel.shard_vector(jnp.arange(N, dtype=jnp.float32), mesh)
    sizes = {int(sh.data.size) for sh in x.addressable_shards}
    assert sizes == ({N // 4} if split else {N})
    numpy.testing.assert_array_equal(numpy.asarray(x), numpy.arange(N))


# ---------------------------------------------------- ortho='auto' choice
@pytest.mark.parametrize(
    "name, dtype, kw, expect",
    [
        ("gpu", jnp.float32, {}, "cgs2_fused"),
        ("gpu", jnp.float64, {}, "cgs2"),
        ("gpu", jnp.complex64, {}, "cgs2"),
        ("gpu", jnp.float32, {"M": lambda x: x}, "cgs2"),
        ("gpu", jnp.float32, {"ip": lambda x, y: jnp.vdot(x, y)}, "cgs2"),
        ("gpu", jnp.float32, {"basis_dtype": jnp.bfloat16}, "cgs2"),
        ("cpu", jnp.float32, {}, "cgs2"),
        ("cpu", jnp.float32, {"interpret": True}, "cgs2_fused"),
        ("rocm", jnp.float32, {}, "cgs2"),
    ],
)
def test_auto_ortho_single_device(name, dtype, kw, expect, backend):
    """One device: the fused kernel for a plain float32 Euclidean solve
    on the GPU (or in the interpreter by request), batched CGS2 for
    everything else."""
    backend(name)
    assert resolve_auto_ortho(4096, 40, jnp.dtype(dtype), **kw) == expect


@pytest.mark.parametrize("N, sync, expect", [
    (4096, 0.0, "cgs2_fused"),     # free syncs: save the sweep
    (4096, 1.0, "cgs2_1r"),        # expensive syncs: one reduce
    (4095, 0.0, "cgs2_1r"),        # uneven split: no shard_map kernel
])
def test_auto_ortho_mesh(N, sync, expect, backend, monkeypatch):
    backend("gpu")
    monkeypatch.setattr(policy, "SYNC_S", sync)
    mesh = parallel.make_mesh(8)
    with mesh:
        got = resolve_auto_ortho(N, 40, jnp.dtype(jnp.float32))
    assert got == expect


# --------------------------------------------- explicit cgs2_fused errors
@pytest.mark.parametrize(
    "case", ["f64", "complex", "ip", "M", "basis_dtype", "no_interpret",
             "mesh_indivisible"]
)
def test_gmres_fused_ineligible_raises(case):
    """An explicit ortho='cgs2_fused' that cannot run the kernel raises
    instead of quietly running another scheme."""
    N = 64
    A = ops.poisson_2d(8)
    b = jnp.ones(N, jnp.float32)
    kw = {"interpret": True}
    if case == "f64":
        b = b.astype(jnp.float64)
    elif case == "complex":
        b = b.astype(jnp.complex64)
    elif case == "ip":
        kw["ip"] = lambda x, y: jnp.vdot(x, y)
    elif case == "M":
        kw["M"] = lambda x: x
    elif case == "basis_dtype":
        kw["basis_dtype"] = jnp.bfloat16
    elif case == "no_interpret":
        kw = {}
    if case == "mesh_indivisible":
        A = ops.poisson_2d(9, 7)
        b = jnp.ones(63, jnp.float32)
        with parallel.make_mesh(8), pytest.raises(ValueError,
                                                  match="divisible"):
            F.gmres(A, b, tol=1e-6, maxiter=8, ortho="cgs2_fused", **kw)
        return
    with pytest.raises(ValueError, match="cgs2_fused"):
        F.gmres(A, b, tol=1e-6, maxiter=8, ortho="cgs2_fused", **kw)


def test_gmres_fused_interpret_matches_cgs2():
    """The whole GMRES core with the kernel in the interpreter: same
    iteration count and solution as batched CGS2 to float32 rounding."""
    A = ops.convection_diffusion_2d(31)
    b = jnp.ones(31 * 31, jnp.float32)
    ref = F.gmres(A, b, tol=1e-5, maxiter=40, ortho="cgs2")
    got = F.gmres(A, b, tol=1e-5, maxiter=40, ortho="cgs2_fused",
                  interpret=True)
    assert int(got.niter) == int(ref.niter)
    rel = float(jnp.linalg.norm(got.x - ref.x) / jnp.linalg.norm(ref.x))
    assert rel < 1e-4


# ------------------------------------------------------- compile cache
def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    got = config.use_compile_cache()
    assert got == config.REPO_CACHE_DIR
    assert got == os.path.join(REPO, ".jax_cache")
    assert seen == [("jax_compilation_cache_dir", got)]
    # fixed: the same path every call (it is part of the cache key)
    assert config.use_compile_cache() == got


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    assert config.use_compile_cache() == str(tmp_path)
    assert seen == []


def test_compile_cache_not_set_on_import():
    """Importing the library leaves the cache setting alone; scripts opt
    in through use_compile_cache()."""
    src = open(os.path.join(REPO, "krypy_tpu", "config.py")).read()
    body = src.split("def use_compile_cache", 1)[0]
    assert "jax_compilation_cache_dir" not in body


# ------------------------------------- chip_smoke.py host references
@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("kind", ["poisson", "convdiff", "shifted"])
@pytest.mark.parametrize("nx, ny", [(5, 5), (6, 6), (7, 4), (8, 3),
                                    (16, 9), (31, 31)])
def test_host_csr_reference_matches_ops(smoke, kind, nx, ny):
    """The host float64 SciPy operators that chip_smoke.py checks the
    device solves against equal the gallery's matvecs, at odd and even
    sizes (independent constructions: Kronecker sums vs shifted adds)."""
    if kind == "poisson":
        A, A_csr = ops.poisson_2d(nx, ny), smoke.csr_poisson_2d(nx, ny)
    elif kind == "convdiff":
        kw = dict(wind=(1.0, 0.5), eps=0.7)
        A = ops.convection_diffusion_2d(nx, ny, **kw)
        A_csr = smoke.csr_convection_diffusion_2d(nx, ny, **kw)
    else:
        A = ops.shifted_laplacian_2d(nx, ny, sigma=7.5)
        A_csr = smoke.csr_shifted_laplacian_2d(nx, ny, sigma=7.5)
    x = numpy.random.default_rng(nx * 31 + ny).standard_normal(nx * ny)
    got = numpy.asarray(A(jnp.asarray(x, jnp.float64)))
    want = A_csr @ x
    assert A_csr.shape == (nx * ny, nx * ny)
    numpy.testing.assert_allclose(got, want, rtol=1e-12,
                                  atol=1e-12 * numpy.abs(want).max())


def test_host_arnoldi_and_relres(smoke):
    """The host Arnoldi reproduces the Arnoldi relation in float64, and
    host_relres is the plain relative residual."""
    nx = 12
    A_csr = smoke.csr_convection_diffusion_2d(nx)
    v0 = numpy.random.default_rng(0).standard_normal(nx * nx)
    m = 10
    H = smoke.host_arnoldi(A_csr, v0, m)
    ref = F.arnoldi(ops.convection_diffusion_2d(nx), jnp.asarray(v0),
                    maxiter=m, ortho="cgs2")
    numpy.testing.assert_allclose(
        H, numpy.asarray(ref.H)[: m + 1, :m], rtol=1e-9,
        atol=1e-9 * numpy.abs(H).max(),
    )
    x = numpy.ones(nx * nx)
    b = A_csr @ x
    assert smoke.host_relres(A_csr, x, b) < 1e-15
    assert smoke.host_relres(A_csr, 0 * x, b) == pytest.approx(1.0)
