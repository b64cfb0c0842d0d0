"""Configuration dataclasses with JSON round-trip (port of ``visual_slam_tpu.config``).

Field for field the JAX package's configuration, so one JSON file drives
either package. The JAX module's comments record why each knob exists and
what it measured on the TPU; those measurements describe the reference, not
this port. Knobs whose stage is not ported yet are carried and ignored.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict


@dataclass
class CameraConfig:
    sensor_type: str = "monocular"  # monocular | stereo | rgbd
    width: int = 0
    height: int = 0
    fps: float = 30.0


@dataclass
class FeatureConfig:
    """Detector/matcher selection. ``num_features`` is the static per-frame
    capacity: the detector always returns exactly this many slots."""

    detector_name: str = "fast_orb"  # fast_orb | fast_orb_anms | shi_tomasi_orb
    matcher_name: str = "bf_hamming"
    num_features: int = 1000
    fast_threshold: float = 20.0
    num_pyramid_levels: int = 4
    scale_factor: float = 1.2
    grid_cells: int = 8
    ragged_descriptors: bool = False
    detector_params: Dict[str, Any] = field(default_factory=dict)
    matcher_params: Dict[str, Any] = field(default_factory=dict)
    filter_params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class InitializationConfig:
    min_depth: float = 0.1
    max_depth: float = 50.0
    min_inliers: int = 100
    min_parallax_deg: float = 1.0
    min_dt: float = 0.0
    essential_hypotheses: int = 256
    essential_threshold: float = 3e-3
    buffer_frames: int = 5


@dataclass
class TrackingConfig:
    min_inliers: int = 10
    min_parallax_deg: float = 1.0
    keyframe_interval: int = 5
    min_inlier_ratio: float = 0.25
    max_reprojection_error: float = 1.0
    use_ransac: bool = True
    check_reprojection_error: bool = False
    kf_min_translation: float = 2.0
    kf_min_rotation_deg: float = 10.0
    kf_min_matches: int = 30
    pnp_hypotheses: int = 128
    pnp_threshold_px: float = 3.0
    match_ratio: float = 0.75
    fused_pipeline: bool = False
    local_map_size: int = 4096  # landmark arena of the guided match; 0 disables it
    guided_radius_px: float = 25.0  # base window, widened by the motion model's rotation
    guided_ratio: float = 0.8
    chunk_size: int = 1  # frames per tracking chunk
    device_promotion: bool = False
    async_boundary: bool = False
    async_boundary_min_kfs: int = 12
    async_boundary_cooloff: int = 2
    heavy_boundary_every: int = 1
    upload_f16: bool = False
    compact_fetch_promos: int = 4
    use_depth_residual: bool = True
    rgbd_virtual_baseline: float = 0.08
    stereo_row_tolerance: float = 2.0
    depth_scale: float = 1.0


@dataclass
class LocalMappingConfig:
    run_timeout: float = 0.1
    max_neighbors: int = 2
    min_depth: float = 0.1
    max_depth: float = 50.0
    min_parallax_deg: float = 0.5


@dataclass
class OptimizationConfig:
    solver: str = "lm_schur"  # lm_schur | adam
    n_iter: int = 20
    lr: float = 1e-3
    batch_size: int = 1000
    huber_delta: float = 5.0
    window_size: int = 8  # keyframes per local BA window (padded bucket)
    max_points: int = 4096  # landmark capacity per window (padded bucket)
    lm_lambda0: float = 1e-3
    pose_bucket_floor: int = 16
    point_bucket_floor: int = 1024
    sparse_obs: bool | str = False  # False | True | "auto"
    sparse_auto_min_window: int = 32
    obs_cap: int = 16
    lm_minor: bool | str = False
    ba_every_n_keyframes: int = 1
    async_ba: bool = False
    log_reprojection_error: bool = True
    global_ba_max_keyframes: int = 64


@dataclass
class LoopClosingConfig:
    enabled: bool = False
    # Shortlist candidates by global signature (loop_closing/signature.py)
    # before the batched geometric match; False scores every old keyframe.
    use_signature: bool = True
    shortlist_size: int = 8


@dataclass
class MapConfig:
    max_frames: int = 5
    cull_redundant_keyframes: bool = True
    kf_redundancy_threshold: float = 0.9  # fraction seen by >= 3 other KFs
    min_keyframes_before_cull: int = 8
    max_landmarks: int = 0  # 0 = unlimited; else evict least-recently-seen
    budget_protect_recent: int = 8


@dataclass
class AdditionalParamsConfig:
    ransac_threshold: float = 3e-3
    ransac_prob: float = 0.999


@dataclass
class Config:
    """Aggregate configuration."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    initialization: InitializationConfig = field(default_factory=InitializationConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    local_mapping: LocalMappingConfig = field(default_factory=LocalMappingConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    loop_closing: LoopClosingConfig = field(default_factory=LoopClosingConfig)
    map: MapConfig = field(default_factory=MapConfig)
    additional_params: AdditionalParamsConfig = field(default_factory=AdditionalParamsConfig)
    debug: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            val = data[f.name]
            if f.name in _SUBCONFIGS:
                sub = _SUBCONFIGS[f.name]
                known = {x.name for x in dataclasses.fields(sub)}
                kwargs[f.name] = sub(**{k: v for k, v in val.items() if k in known})
            else:
                kwargs[f.name] = val
        return cls(**kwargs)


_SUBCONFIGS = {
    "camera": CameraConfig,
    "feature": FeatureConfig,
    "initialization": InitializationConfig,
    "tracking": TrackingConfig,
    "local_mapping": LocalMappingConfig,
    "optimization": OptimizationConfig,
    "loop_closing": LoopClosingConfig,
    "map": MapConfig,
    "additional_params": AdditionalParamsConfig,
}
