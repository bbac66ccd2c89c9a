"""Single typed configuration tree for the whole engine.

The reference scatters configuration across compile-time platform defines,
constructor arguments and ad-hoc setters (reference CMakeLists.txt:6-16,
HDLParser.h:101-124, INSSource.h:52).  Here everything lives in one frozen
dataclass tree so a pipeline run is fully described by a `SlamConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from veloslam_tpu import constants as C


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Which LiDAR and how to decode it.

    `model` selects the timing/beam layout: "hdl32", "vlp16" or "hdl64"
    (reference HDLParser.cxx:935-960 switches on the calibration's laser
    count the same way).
    """

    model: str = "hdl32"
    # Path to a Velodyne XML calibration file; None uses built-in tables.
    calibration_path: Optional[str] = None
    rpm: float = 600.0
    # Crop region (x0, x1, y0, y1, z0, z1) in sensor frame; None disables.
    # Matches the semantics of reference HDLParser.cxx:629-639.
    crop_region: Optional[Tuple[float, float, float, float, float, float]] = None
    crop_inside: bool = False    # True: drop inside region; False: keep inside
    # Dual-return selection: None keeps both returns; "near"/"far"/
    # "high"/"low" keeps one member per pair (reference setDualReturnFilter,
    # HDLParser.h:101-124; flag semantics HDLParser.h:75-81).
    dual_return_filter: Optional[str] = None
    # Static bound on firings per revolution (type_defs.h:20).  Dual-return
    # streams double the firing positions per revolution — raise this to
    # ~4400 when keeping both returns.
    max_firings_per_frame: int = C.MAX_FIRINGS_PER_FRAME
    # Laser selection: wire laser ids to decode; None enables all
    # (setLaserSelection parity, reference HDLParser.h:101-124).
    laser_mask: Optional[Tuple[int, ...]] = None

    @property
    def n_lasers(self) -> int:
        return {"hdl32": 32, "vlp16": 16, "hdl64": 64}[self.model]

    def enabled_lasers(self):
        """(n_lasers,) bool mask from `laser_mask` (None → all True)."""
        import numpy as np
        if self.laser_mask is None:
            return None
        en = np.zeros(self.n_lasers, bool)
        en[list(self.laser_mask)] = True
        return en


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Decode / motion-compensation pipeline knobs."""

    # Packets per decode batch (static shape fed to the jitted decoder).
    packets_per_batch: int = 512
    # "se3": full SE(3) per-point de-skew. "translation": reference-parity
    # translation-only reprojection (reference HDLParser.cxx:249-254).
    compensation: str = "se3"
    # Drop every (skip+1)-th firing block (reference HDLParser.cxx:1042).
    points_skip: int = 0
    # In-memory frame cache capacity before spilling to the host/disk tier
    # (reference keeps 200 frames in RAM, HDLManager.h:108).
    frame_cache_capacity: int = 200


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Scan-to-scan and scan-to-map registration."""

    # "gicp" (point-to-plane, planarity-gated), "d2d" (Gaussian-to-
    # Gaussian, registration.d2d — better on corner-heavy scenes, iterates
    # over voxels not points), or "ndt" (point-to-distribution,
    # registration.ndt).
    method: str = "gicp"
    # Odometry voxel size: 0.5 m halves the Gaussian-mixing radius of
    # each plane patch — measured on the bench loop the 1.0 m default
    # was the odometry noise floor (ATE 0.137 / RPE10 0.174 at 1.0 m vs
    # 0.041 / 0.062 at 0.5 m, same drive, same iterations).  The rolling
    # map needs 2x the rows (rolling_map_capacity) and the dense-index
    # window shrinks to ±0.5 m, so priors must stay within the basin
    # (bootstrap ramp + constant-velocity correction extrapolation).
    voxel_size: float = 0.5
    # Fixed voxel-table capacity per scan (static shape for jit).
    scan_voxel_capacity: int = 8192
    # Rolling odometry map rows (runtime/odometry OdometryState).
    rolling_map_capacity: int = 65536
    max_iterations: int = 16
    # Levenberg damping added to the 6x6 normal equations.
    damping: float = 1e-6
    huber_delta: float = 0.5
    # Reject correspondences whose point-to-plane distance exceeds this.
    max_correspondence_dist: float = 2.0
    # Minimum points per voxel for a valid Gaussian.
    min_points_per_voxel: int = 4
    # Planarity gate (λ2−λ3)/λ1 for point-to-plane voxels (rejects
    # line-like scan-ring voxels whose normals bias registration).
    min_planarity: float = 0.35
    # Points per scan fed to registration (subsampled, static shape).
    # 16384 of an HDL-32 revolution's ~70k returns: halves the gather-
    # bound association cost for no measured ATE change on the simulator
    # drives (tests assert the bounds).
    max_points: int = 16384
    # Health gates: a registration result is trusted only with at least
    # this many correspondences (points for gicp/ndt, voxels for d2d).
    min_matched_points: int = 500
    min_matched_voxels: int = 50
    # Dense O(1) correspondence index instead of the binary-search lookup
    # (A/B'd by bench.py --ab); equals it bit-for-bit inside the index
    # window.
    use_dense_index: bool = True
    # Re-run correspondence search every k GN iterations (1 = classical
    # ICP).  Association is the only gather-bound stage (far costlier than
    # a fixed-correspondence iteration); with INS priors the
    # correspondence set is stable across consecutive iterations, so k=8
    # keeps two association passes per 16-iteration solve.
    reassociate_every: int = 8
    # Rolling-map forgetting factor per frame: voxel counts decay by this
    # before each scan merge, so stale geometry fades and the fixed-
    # capacity grid follows the vehicle.  Closer to 1 = a stabler anchor
    # (less odometry noise), further = faster adaptation to scene change.
    map_decay: float = 0.98


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Patch-tiled voxel-Gaussian map (MapManager/MapPatch equivalent)."""

    voxel_size: float = 1.0
    patch_size_m: float = 100.0          # tile edge (MapPatch 'range' analog)
    voxels_per_patch: int = 16384        # fixed capacity per patch block
    max_resident_patches: int = 16       # HBM-resident patch budget
    roi_range_m: float = C.ROI_RANGE_M   # reference MapManager.h:13


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph back end."""

    keyframe_translation_m: float = 2.0   # new keyframe after this motion
    keyframe_rotation_deg: float = 10.0
    loop_closure_radius_m: float = 15.0
    loop_closure_min_gap: int = 50        # keyframe-index separation
    max_keyframes: int = 1024             # static bound for jitted solver
    gn_iterations: int = 8
    damping: float = 1e-6
    # Appearance-based (scan-context) loop-closure proposal: drift-
    # independent, complements the position-radius channel above (which
    # misses revisits once accumulated drift exceeds the radius).
    use_scan_context: bool = True
    sc_min_score: float = 0.6             # cosine similarity gate
    # Verification budget per sweep (geometric GICP verify is the cost);
    # candidates beyond the cap stay pending and retry next sweep.
    max_closure_candidates_per_sweep: int = 8
    # Closure-VERIFICATION voxel size, decoupled from the odometry voxel
    # (registration.voxel_size): verification needs a wide convergence
    # basin — its coarse pass runs at 4x this, and the appearance
    # channel's priors carry zero translation, so genuine revisits sit
    # meters off.  Halving this with the odometry voxel (r5's 0.5 m)
    # measurably broke figure-8 double-revisit closure quality.
    verify_voxel_m: float = 1.0
    keyframes_per_closure_sweep: int = 10  # sweep cadence (keyframes)
    # Edge information diagonals (rot×3, trans×3).  ANISOTROPY MATTERS:
    # INS attitude is far more trustworthy than drifting position, and
    # with rot_info ≈ trans_info the solver prefers to bend the chain
    # with cheap rotations instead of removing translation drift —
    # measured: a 18.8 m drifted loop leaves an 11 m mid-loop bow at
    # isotropic info, 0.1 m at rot=1e6 (tests/test_fullslam.py).
    odom_edge_info: Tuple[float, ...] = (1e6,) * 3 + (100.0,) * 3
    closure_edge_info: Tuple[float, ...] = (1e4,) * 3 + (500.0,) * 3
    # Landmark layer: post detections per keyframe become pose-landmark
    # observations, Schur-eliminated in the solver (the landmark-map
    # story the reference's MapObjects layer anticipates but never runs).
    use_landmarks: bool = True
    landmark_cluster_radius_m: float = 1.2
    landmark_min_observations: int = 2
    # Observation information 1/sigma²: post-center detections from
    # subsampled scans measure ~0.35 m rms (bench loop drive), so info 8
    # — the old 25 (sigma 0.2 m) over-trusted them enough to fight
    # accurate loop closures.
    landmark_obs_info: float = 8.0
    # Residual trim: after the first landmark solve, observations whose
    # residual exceeds this are disabled and the graph re-solved once —
    # cross-association outliers (two posts within the cluster radius,
    # or a wall corner detected as a post) sit far outside the ~0.35 m
    # detection noise, and the Huber weight only bounds their influence.
    # 0 disables.
    landmark_trim_residual_m: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh / sharding layout.

    Axes: "data" batches scans/packets, "map" shards map patches and
    pose-graph edges.  The reference has no distributed story (SURVEY.md
    §2b); this is the array-program replacement for its thread-per-stage
    concurrency.
    """

    data_axis: int = 1
    map_axis: int = 1

    @property
    def n_devices(self) -> int:
        return self.data_axis * self.map_axis


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    registration: RegistrationConfig = dataclasses.field(
        default_factory=RegistrationConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)
