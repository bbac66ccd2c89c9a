"""Device mesh construction for the SLAM engine.

Axes (SURVEY.md §2b — the distributed story the reference lacks):
  * "data": data parallelism over packet batches / scans,
  * "map":  spatial parallelism over map voxels, keyframes and pose-graph
            edges (the SP analog: the map is the long axis of SLAM).

Multi-host: build the mesh over all global devices after
`jax.distributed.initialize()`; patches/keyframes partition by their shard
index; the runtime routes collectives over the devices' interconnect
(NVLink within a host) and the network across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from veloslam_tpu.config import MeshConfig


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else jax.devices())
    n = cfg.n_devices
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(cfg.data_axis, cfg.map_axis)
    return Mesh(arr, ("data", "map"))


def data_spec() -> P:
    return P("data")


def map_spec() -> P:
    return P("map")


def replicated() -> P:
    return P()


def shard_to(mesh: Mesh, spec: P, tree):
    """Device-put a pytree with the given PartitionSpec on the mesh."""
    sharding = NamedSharding(mesh, spec)
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)
