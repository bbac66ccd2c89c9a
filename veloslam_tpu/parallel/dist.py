"""Multi-host runtime: jax.distributed init, tile-hash patch partitioning,
global-array assembly from host-local map shards.

The reference is strictly single-process (SURVEY.md §2b: its only
"backend" is UDP sockets + host threads).  This module supplies the
multi-host story demanded by BASELINE.json configs[4]:

  * `init_distributed` — one call per host; after it, `jax.devices()`
    spans every process's devices and meshes built from it place
    collectives on the devices' interconnect within a host and the
    network across hosts (the runtime picks the transport; no NCCL/MPI
    plumbing to port).
  * `tile_owner` — deterministic hash partitioning of map patches across
    processes (the distributed analog of MapManager's single-host patch
    grid, reference MapManager.cxx:25-46).
  * `scatter_local_rows` — assemble a globally-sharded array from each
    process's locally-owned rows (`jax.make_array_from_process_local_data`);
    the resulting PlaneGrid feeds `parallel.sharded.register_sharded`
    unchanged — the same shard_map kernels run single-chip, multi-chip,
    and multi-host.
  * `allgather` — fetch a replicated/global result to every host.

Tested without a cluster via multi-process CPU workers (Gloo collectives),
tests/test_multihost.py — the reference's loopback-fake-backend idea
(SURVEY.md §4.2) applied to distributed execution.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None
                     ) -> None:
    """Initialize the multi-process runtime (idempotent; no-op for
    single-process runs).

    Arguments default from the environment (VELOSLAM_COORDINATOR /
    VELOSLAM_NUM_PROCESSES / VELOSLAM_PROCESS_ID), falling back to JAX's
    own auto-detection where a cluster launcher provides the topology.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "VELOSLAM_COORDINATOR")
    if num_processes is None and "VELOSLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VELOSLAM_NUM_PROCESSES"])
    if process_id is None and "VELOSLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VELOSLAM_PROCESS_ID"])
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_mesh(data_axis: int = 1, map_axis: Optional[int] = None) -> Mesh:
    """Mesh over ALL global devices (call after init_distributed)."""
    devs = jax.devices()
    if map_axis is None:
        map_axis = len(devs) // data_axis
    if data_axis * map_axis != len(devs):
        raise ValueError(f"mesh {data_axis}x{map_axis} != {len(devs)} "
                         "global devices")
    arr = np.asarray(devs).reshape(data_axis, map_axis)
    return Mesh(arr, ("data", "map"))


def tile_owner(ix, iy, n_shards: int):
    """Deterministic shard id for map tile (ix, iy) — splitmix-style
    integer hash so neighboring tiles spread across hosts (load balance)
    rather than forming contiguous host-sized blocks (hotspots under a
    moving sensor)."""
    ix = np.asarray(ix, np.int64).astype(np.uint64)
    iy = np.asarray(iy, np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (ix * np.uint64(0x9E3779B97F4A7C15)
             + iy * np.uint64(0xC2B2AE3D27D4EB4F))
        h ^= (h >> np.uint64(33))
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= (h >> np.uint64(33))
    return (h % np.uint64(n_shards)).astype(np.int64)


def scatter_local_rows(mesh: Mesh, tree, axis: str = "map"):
    """Assemble globally row-sharded arrays from each process's local rows.

    Every leaf of `tree` holds THIS process's rows along axis 0 (equal
    count on every process — fixed shard capacity); the result is a pytree
    of global jax.Arrays sharded over `axis`.  Leaves whose first axis is
    not the row axis (scalars, origin vectors) should be passed via
    `replicate` instead.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda leaf: jax.make_array_from_process_local_data(
            sharding, np.asarray(leaf)), tree)


def replicate(mesh: Mesh, tree):
    """Fully-replicated global arrays from identical host-local values."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            sharding, np.asarray(a)), tree)


def allgather(tree):
    """Gather global/replicated results to every host as numpy."""
    from jax.experimental import multihost_utils as mh
    return jax.tree.map(
        lambda a: np.asarray(mh.process_allgather(a, tiled=True)), tree)


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


# --- map partitioning across hosts --------------------------------------------

def partition_plane_grid_rows(full, pid: int, n_shards: int,
                              tile_m: float = 16.0):
    """Host-local slice of a full PlaneGrid: the voxel rows whose TILE
    hashes to `pid` (tile_owner), key-sorted and padded back to the full
    capacity so every shard has equal row count.

    Returns ([keys, count, mean, cov, normal, usable], origin, voxel_size)
    as host numpy — feed the list to `scatter_local_rows` and the scalars
    to `replicate` to build the global registration target.
    """
    from veloslam_tpu.registration import voxel as vx

    keys = np.asarray(full.grid.keys)
    cap = keys.shape[0]
    centers = np.asarray(vx.unpack_keys(full.grid.keys, full.grid.origin,
                                        full.grid.voxel_size))
    tile = np.floor(centers[:, :2] / tile_m).astype(np.int64)
    mine = ((tile_owner(tile[:, 0], tile[:, 1], n_shards) == pid)
            & (keys != vx.INVALID_KEY))

    def take(a, fill=0):
        a = np.asarray(a)
        out = np.full((cap,) + a.shape[1:], fill, a.dtype)
        sel = a[mine]
        out[:len(sel)] = sel
        return out

    my_keys = take(keys, fill=vx.INVALID_KEY)
    order = np.argsort(my_keys)        # binary-search invariant per shard
    rows = [my_keys[order], take(full.grid.count)[order],
            take(full.grid.mean)[order], take(full.grid.cov)[order],
            take(full.normal)[order], take(full.usable)[order]]
    return rows, np.asarray(full.grid.origin), np.asarray(
        full.grid.voxel_size)


def assemble_global_plane_grid(mesh: Mesh, local_rows, origin, voxel_size,
                               axis: str = "map"):
    """Globally `axis`-sharded PlaneGrid from per-process local rows."""
    from veloslam_tpu.registration import voxel as vx
    from veloslam_tpu.registration.gicp import PlaneGrid

    sh = scatter_local_rows(mesh, local_rows, axis=axis)
    rep = replicate(mesh, [origin, voxel_size])
    return PlaneGrid(
        grid=vx.VoxelGrid(keys=sh[0], count=sh[1], mean=sh[2], cov=sh[3],
                          origin=rep[0], voxel_size=rep[1]),
        normal=sh[4], usable=sh[5])
