"""veloslam_tpu — a LiDAR SLAM engine written in JAX.

A JAX / XLA / shard_map framework with the capabilities of the
VeloSLAM reference (victl/VeloSLAM): Velodyne HDL-32E / HDL-64 / VLP-16 packet
decode into motion-compensated point frames, INS/GPS time sync and pose
interpolation, scan registration (voxelized point-to-plane GICP and NDT),
a patch-tiled voxel-Gaussian map, and a pose-graph back end with loop closure
solved by (distributed) Gauss-Newton.

Design stance (see SURVEY.md §7): the reference's thread-and-queue CPU
architecture is replaced by a functional pipeline over fixed-shape arrays —
packet batches in, pose timelines as sorted arrays, frames as dense padded
tensors with validity masks, the map as sharded voxel-Gaussian blocks.

Precision/time model:
  * host time   = int64 microseconds since the Unix epoch (numpy),
  * device time = float32 seconds relative to a batch/frame anchor,
  * geodesy     = float64 on host (numpy), relative ENU float32 on device.
"""

__version__ = "0.1.0"

from veloslam_tpu.config import (  # noqa: F401
    SensorConfig,
    PipelineConfig,
    RegistrationConfig,
    MapConfig,
    GraphConfig,
    MeshConfig,
    SlamConfig,
)
