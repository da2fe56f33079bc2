"""Shared mesh price model for the ``auto`` scheme/variant policies.

Every latency-vs-bandwidth decision in the package (GMRES
``ortho='auto'``, CG/MINRES/shifted-CG ``variant='auto'``, which
multigrid levels split over a mesh) prices the same two quantities:

* the cost of ONE sync point -- an all-reduce round trip over the mesh
  interconnect (``sync_s``), and
* the cost of streaming one element of local device-memory traffic
  (``1 / hbm_bytes_per_s``).

A one-reduce rearrangement trades sync points for extra local traffic,
so the decision is ``syncs_saved * sync_s  >  extra_sweeps *
n_local * itemsize / hbm_bytes_per_s`` -- with ``extra_sweeps``
calibrated per solver from measured single-device costs
(benchmarks/onereduce_bench.py).

The constants resolve, in priority order, from

1. an explicit module override (``policy.SYNC_S`` /
   ``policy.HBM_BYTES_PER_S`` -- tests monkeypatch these; embedders can
   set them after a microbenchmark of their own fabric),
2. the ``KRYPY_TPU_SYNC_S`` / ``KRYPY_TPU_HBM_BYTES_PER_S`` environment
   variables (deployment-time calibration without code changes, e.g. a
   mesh that spans hosts),
3. a per-backend table of measured numbers.  A backend missing from the
   table is an error, not a default.

The reference has no analog: krypy is single-address-space
(SURVEY.md section 2) and never prices communication.
"""

import os

import jax

__all__ = [
    "sync_s",
    "hbm_bytes_per_s",
    "sweep_s",
    "prefer_one_reduce",
    "fused_sharded_wins",
    "ONE_REDUCE_EXTRA_SWEEPS",
]

#: explicit overrides; ``None`` means "resolve from env / table".
#: Tests monkeypatch these to force either regime.
SYNC_S = None
HBM_BYTES_PER_S = None

#: per-backend one-sync (all-reduce round trip) cost in seconds.
#: "gpu": a dependent chain of 64-float psums over four NVIDIA H100 80GB
#: HBM3 cards joined by NVLink, 700 W power limit (chip_smoke.py
#: --four-cards: 15.2-24.2 us over five runs; 16.7 us kept).  "cpu":
#: the virtual test mesh shares one address space, so a sync is about a
#: barrier (order of magnitude, not measured).
SYNC_S_TABLE = {
    "gpu": 16.7e-6,
    "cpu": 2e-6,
}

#: per-backend achievable device-memory stream rate (bytes/s).
#: "gpu": the 256 MB copy rate of chip_smoke.py phase 2 on one NVIDIA
#: H100 80GB HBM3 with a 400 W power limit (2758 GB/s).  "cpu": order of
#: magnitude, not measured.
HBM_BYTES_PER_S_TABLE = {
    "gpu": 2.758e12,
    "cpu": 40e9,
}

#: calibrated extra local traffic of the one-reduce rearrangement, in
#: equivalent basis-vector sweeps per iteration: the measured
#: single-device cost delta (one-reduce minus classic, per iteration)
#: divided by the time of one vector sweep at the same run's copy rate.
#: Measured with benchmarks/onereduce_bench.py (K 20 -> 40 at 1.05M dof
#: f32) on one NVIDIA H100 80GB HBM3 with a 400 W power limit.
#: Deflated MINRES is not measured: its fold of the oblique projection
#: into the cross-Gram contraction is the deflated CG fold, so it takes
#: that figure.  Solvers without an entry (shifted CG) price at the CG
#: figure.
ONE_REDUCE_EXTRA_SWEEPS = {
    "cg": 4.3,
    "minres": 179.4,
    "qmr": 190.9,
    "deflated_cg": 116.9,
    "deflated_minres": 116.9,
    # idrs (s=4), per MATVEC
    "idrs": 158.4,
}


def _table_entry(table, what, env):
    backend = jax.default_backend()
    try:
        return table[backend]
    except KeyError:
        raise RuntimeError(
            f"no measured {what} for the {backend!r} backend; set "
            f"{env} (or the policy module override) to calibrate it"
        ) from None


def sync_s():
    """Cost of one mesh sync point (all-reduce round trip), seconds."""
    if SYNC_S is not None:
        return float(SYNC_S)
    env = os.environ.get("KRYPY_TPU_SYNC_S")
    if env:
        return float(env)
    return _table_entry(SYNC_S_TABLE, "sync cost", "KRYPY_TPU_SYNC_S")


def hbm_bytes_per_s():
    """Achievable local memory stream rate, bytes/second."""
    if HBM_BYTES_PER_S is not None:
        return float(HBM_BYTES_PER_S)
    env = os.environ.get("KRYPY_TPU_HBM_BYTES_PER_S")
    if env:
        return float(env)
    return _table_entry(
        HBM_BYTES_PER_S_TABLE, "stream rate", "KRYPY_TPU_HBM_BYTES_PER_S"
    )


def sweep_s(n_local, itemsize):
    """Time to stream one ``n_local``-element local vector, seconds."""
    return n_local * itemsize / hbm_bytes_per_s()


def prefer_one_reduce(solver, n_local, itemsize, syncs_saved=1):
    """Should the ``auto`` policy pick the one-reduce variant?

    True when the sync time saved per iteration exceeds the extra local
    traffic the rearrangement streams per shard.  ``solver`` indexes
    :data:`ONE_REDUCE_EXTRA_SWEEPS`; unknown solvers price at the CG
    figure.

    On a latency-cheap mesh (small ``sync_s``, e.g. the shared-memory
    CPU test mesh) with large shards this returns False -- classic CG at
    less local traffic is the bandwidth-bound choice there.
    """
    extra = ONE_REDUCE_EXTRA_SWEEPS.get(solver, ONE_REDUCE_EXTRA_SWEEPS["cg"])
    return syncs_saved * sync_s() > extra * sweep_s(n_local, itemsize)


def fused_sharded_wins(basis_rows, n_local, itemsize, extra_syncs=2):
    """GMRES mesh regime: does the sharded fused CGS2 kernel (3 local
    sweeps + 3 sync points) beat the one-reduce scheme (1 sync point)?

    The fused kernel saves ONE local sweep of the full basis per
    iteration and pays ``extra_syncs`` additional all-reduces; it wins
    when the saved sweep time exceeds the extra round trips
    (bandwidth-bound shards: tall basis, large shard, slow HBM relative
    to the interconnect).
    """
    saved_s = sweep_s(basis_rows * n_local, itemsize)
    return saved_s > extra_syncs * sync_s()
