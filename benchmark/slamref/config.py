"""Typed, serializable configuration tree.

The reference has *no* config system — every parameter is a hardcoded literal
scattered across the two nodes (see SURVEY.md §5 "Config / flag system" for the
full file:line list).  Here they are promoted into one dataclass tree whose
defaults reproduce the reference values, with the documented quirks fixed:

- BA window defaults to 8 (BASELINE.json north-star; reference hardcodes
  ``min(5, N)`` at ``backend.cpp:895``) and uses the *intended* intrinsics
  (the reference's ``SlidingWindowBA(10, fx, fy, cx, cy)`` call at
  ``backend.cpp:661`` shifts every argument — a bug we do not replicate).
- Unassociated landmark ids use -1, not 0 (``backend.cpp:308`` ambiguity).
- Detections are optional: no detector stream ⇒ every observation is
  "unlabeled" instead of stalling the backend (``backend.cpp:183-190``).

Capacity fields are new: the TPU build needs static shapes, so every
variable-size set gets an explicit capacity + validity mask.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics (reference: from ROS camera_info, frontend.cpp:972-1036)."""

    width: int = 1280
    height: int = 720
    fx: float = 900.0
    fy: float = 900.0
    cx: float = 640.0
    cy: float = 360.0
    # RealSense 16UC1 depth is millimetres (frontend.cpp:463 divides by 1000).
    depth_scale: float = 0.001

    def scaled(self, width: int, height: int) -> "CameraConfig":
        sx, sy = width / self.width, height / self.height
        return dataclasses.replace(
            self, width=width, height=height,
            fx=self.fx * sx, fy=self.fy * sy, cx=self.cx * sx, cy=self.cy * sy,
        )


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor (reference ctor args frontend.cpp:205-211)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20    # primary FAST threshold (ORBextractor.cpp:826)
    min_th_fast: int = 7     # per-cell fallback threshold (ORBextractor.cpp:845)
    patch_size: int = 31     # IC-angle / rBRIEF patch (ORBextractor.hpp)
    edge_threshold: int = 19  # pyramid border (ORBextractor.cpp:1173)
    cell_size: int = 35      # FAST grid cell (ORBextractor.cpp:785)
    # --- TPU capacities (new) ---
    max_keypoints: int = 1024          # final capacity across levels
    max_per_level: int = 1024          # candidate capacity per pyramid level


@dataclass(frozen=True)
class DepthConfig:
    """Depth validity gate (frontend.cpp:241-242,457-473)."""

    min_depth: float = 0.3
    max_depth: float = 3.0


@dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching (frontend.cpp:1123-1127)."""

    max_hamming: int = 50
    cross_check: bool = False  # reference BFMatcher(NORM_HAMMING) default


@dataclass(frozen=True)
class RANSACConfig:
    """Geometric verification + PnP (frontend.cpp:911-923,1146-1147)."""

    # fundamental-matrix RANSAC
    fm_threshold_px: float = 2.0
    fm_confidence: float = 0.99
    # Batched hypothesis counts (OpenCV runs adaptive <=1000 sequential
    # draws; a fixed vmapped batch is the TPU formulation). 384/192 over
    # the earlier 256/128: on hard sequences (fast motion + depth noise)
    # the extra hypotheses cut worst-seed ATE ~2.8x (0.267 -> 0.096,
    # seed 1 of the parity sweep) for a sub-millisecond tracking cost —
    # the MXU eats hypothesis batches for breakfast.
    fm_iterations: int = 384
    # PnP RANSAC
    pnp_iterations: int = 192   # reference: 100 (frontend.cpp:917)
    pnp_threshold_px: float = 4.0
    pnp_confidence: float = 0.99
    min_pnp_matches: int = 6    # frontend.cpp:899
    refine_iterations: int = 10  # Gauss-Newton polish per round (two rounds
    # with inlier re-gating in between); 10+10 buys measurably better poses
    # than 5+5 on hard frames and the serial tail is still tiny vs extract
    # Loop/relocalization verification PnP threshold. Deliberately wider
    # than the frame-to-frame pnp_threshold_px: the candidate keyframe's
    # stored cloud and the entry frame's pixels are separated by the very
    # drift the loop exists to measure (depth-scale drift alone puts true
    # inliers in the 4-12 px residual band on the drift fixture), so a
    # tracking-grade threshold vetoes exactly the correcting loops. Safety
    # comes from consensus, not tightness: Hamming cross-check + F-RANSAC
    # pre-filter + the >=loop_min_inliers PnP gate + the apply-side
    # correction-magnitude gate.
    loop_pnp_threshold_px: float = 12.0


@dataclass(frozen=True)
class MotionConfig:
    """Per-frame motion outlier gate (frontend.cpp:549-570)."""

    max_translation_m: float = 0.5
    max_rotation_rad: float = 0.2


@dataclass(frozen=True)
class TrackingConfig:
    """Pose-estimation policy beyond the reference's frame-to-frame chain.

    anchor_to_keyframe=True adds a second PnP each frame against the LAST
    KEYFRAME's stored world points (matched descriptors are already
    computed for the keyframe policy): its solution is an ABSOLUTE pose,
    so odometry error compounds per keyframe instead of per frame over
    the interval. The anchored pose replaces the frame-to-frame
    composition only when it has enough inliers and agrees with it within
    the jump gates (a wrong anchor match must not teleport the tracker).
    ON by default: it beats the frame-to-frame-only estimator (the
    reference's formulation, frontend.cpp:947-948) 3-6x on mean ATE at
    every measured configuration for ~zero per-frame cost, and every
    robustness fixture (dynamic culling, loop efficacy, relocalization)
    passes unchanged with it on (PARITY_RESULTS.md). Set False for the
    reference-faithful frame-to-frame behavior."""

    anchor_to_keyframe: bool = True
    anchor_min_inliers: int = 60
    anchor_max_jump_m: float = 0.3
    anchor_max_jump_rad: float = 0.15


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe policy + backend-feature culling (frontend.cpp:601-662,1171-1219)."""

    min_matches_to_last_kf: int = 150
    max_frames_between_kf: int = 30
    cull_top_unmatched: int = 200
    cull_min_response: float = 50.0


@dataclass(frozen=True)
class AssociationConfig:
    """Backend data association (backend.cpp:225-227,1064-1120)."""

    max_hamming: int = 50
    max_reprojection_px: float = 5.0
    # declared-but-unused in the reference too (min_parallax_ratio_,
    # backend.cpp:227,635 — the code actually gates on the 5° angle,
    # backend.cpp:517); kept for config parity
    min_parallax_ratio: float = 0.02


@dataclass(frozen=True)
class TriangulationConfig:
    """Multi-view triangulation gates (backend.cpp:517,599,610)."""

    min_parallax_deg: float = 5.0
    max_reprojection_px: float = 2.0
    min_depth: float = 0.1
    max_depth: float = 10.0


@dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle adjustment (bundle_adjustment.hpp:675-851, backend.cpp:874-990)."""

    window_size: int = 8          # reference hardcodes min(5,N); north-star uses 8
    period_s: float = 2.0         # wall-timer period (backend.cpp:208)
    max_iterations: int = 20      # backend.cpp:959
    huber_delta: float = 1.345    # bundle_adjustment.hpp:818
    sigma_px: float = 1.0         # residual weight 1/sigma (bundle_adjustment.hpp:675)
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    init_lambda: float = 1e-4     # Ceres default trust-region init 1e4 radius ⇒ λ=1e-4
    # Soft priors anchoring poses to their tracker estimates and points to
    # their metric-depth measurements.  Reprojection-only RGB-D BA is gauge-
    # deficient (global scale; weakly-shared keyframes can escape their
    # basin while fitting their own observations perfectly — observed 1 m
    # pose jumps on small windows).  The reference sidesteps this only
    # because its Ceres success gate usually DISCARDS results; priors fix it
    # properly.  Set sigma <= 0 to disable.
    pose_prior_sigma_rot: float = 0.10   # rad
    pose_prior_sigma_t: float = 0.30     # m
    point_prior_sigma: float = 0.5       # m — deliberately weak: strong
    # point anchors fight the data along low-parallax depth directions
    # (measured +3.3 % reprojection cost vs the f64 oracle at 0.15 m;
    # +0.05 % at 0.5 m, tests/test_ba_oracle.py); basin safety comes from
    # the POSE priors, points with ≥2 obs are reprojection-constrained
    # Prior weights decay with in-window observation count:
    # w_eff = w * n0/(n0 + n_obs).  A keyframe/point seen by many
    # observations is fully constrained by reprojection and its prior
    # vanishes (asymptotically unbiased, matching the prior-free Ceres
    # optimum); a weakly-shared keyframe (the 1 m-jump failure mode the
    # priors exist for) keeps nearly the full anchor.  0 disables decay.
    prior_obs_decay: float = 4.0
    # --- TPU capacities ---
    max_observations: int = 4096


@dataclass(frozen=True)
class PruneConfig:
    """Landmark pruning (backend.cpp:1251-1252)."""

    min_observations: int = 2
    max_age_s: float = 20.0


@dataclass(frozen=True)
class SemanticConfig:
    """YOLO semantic filtering (backend.cpp:233,749-751)."""

    filtered_classes: Tuple[str, ...] = ("person",)
    # Cull filtered-class keypoints in the FRONTEND too (before matching /
    # RANSAC / keyframe payload). Divergence from the reference, which culls
    # only in the backend (backend.cpp:746-751): in-process frame-synced
    # detections make frontend culling possible, protecting the odometry
    # itself from dynamic objects (docs/PARITY.md).
    cull_in_frontend: bool = True
    detector: str = "yolov8n"
    max_detections: int = 32
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    input_size: int = 640
    # Culling-robustness post-processing on LEARNED detector outputs (GT
    # boxes are exact and bypass it): each box is dilated by box_margin ×
    # its width/height, and keeps being served for persist_frames frames.
    # A walker the detector misses for a frame or two is still covered by
    # the previous frame's dilated box (dynamic objects that matter move
    # ~1-2 px/frame, far less than the dilation slack), which is what
    # closes the gap between a recall<1 learned detector and ground truth
    # in the end-to-end culling proof (semantic/train.in_loop_eval).
    # persist=5: the r4 override sweep (PARITY_RESULTS.md) measured
    # confirmed walker landmarks 41 → 0 going 3 → 5 at margin 0.15 (the
    # r3 optimum of 3 no longer held after the extraction-selection
    # changes shifted which walker keypoints survive); 6-8 frames only
    # add over-culling keyframe pressure (71 → 95 keyframes).
    box_margin: float = 0.15
    persist_frames: int = 5
    # Velocity-extrapolated box TRACKS (r5, supersedes the persist_frames
    # union when > 0): detections are IoU-matched to live tracks; a track
    # the detector misses keeps being served, extrapolated by its
    # estimated velocity and inflated by track_inflate per stale frame,
    # for up to track_ttl_frames. This is the in-process equivalent of
    # the reference's /yolo/tracking stream (tracked detections with
    # IDs, backend.cpp:183-190) and is what bridges the measured 13-20
    # frame OOD miss-runs (scripts/ood_eval.py): a stop-and-go walker
    # stays covered while frozen, an approaching walker's track grows
    # with the inflation. 0 disables tracking (persist_frames union).
    track_ttl_frames: int = 12
    track_inflate: float = 0.03
    # id used when no bbox contains the pixel (backend.cpp:1028)
    unlabeled_category: str = "unlabeled"


@dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity landmark arena (new; replaces unbounded std::maps backend.cpp:619-621)."""

    max_landmarks: int = 4096
    max_keyframes: int = 64
    max_obs_per_landmark: int = 16
    max_obs_per_keyframe: int = 512
    max_categories: int = 32


@dataclass(frozen=True)
class PlaceConfig:
    """BoW place recognition (DBoW2-equivalent; test_dbow2_integration.cpp)."""

    branching: int = 10
    depth: int = 3           # 1e3 words for online-trained vocabularies;
    #                          ORBvoc.txt (k=10, L=6) loads with its own dims
    max_db_entries: int = 1024


@dataclass(frozen=True)
class PipelineConfig:
    """Two-stage pipeline semantics replacing ROS topics/sync (SURVEY.md §5)."""

    queue_depth: int = 30         # QoS depth (frontend.cpp:178)
    sync_queue: int = 10          # ApproximateTime queue (frontend.cpp:185)
    sync_slop_s: float = 0.05     # pairing tolerance
    detections_optional: bool = True


@dataclass(frozen=True)
class SLAMConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    ransac: RANSACConfig = field(default_factory=RANSACConfig)
    motion: MotionConfig = field(default_factory=MotionConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    association: AssociationConfig = field(default_factory=AssociationConfig)
    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    prune: PruneConfig = field(default_factory=PruneConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    map: MapConfig = field(default_factory=MapConfig)
    place: PlaceConfig = field(default_factory=PlaceConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLAMConfig":
        kwargs = {}
        for f in dataclasses.fields(cls):
            sub = d.get(f.name)
            if sub is None:
                continue
            sub_cls = f.default_factory  # type: ignore[misc]
            if isinstance(sub, dict):
                vals = dict(sub)
                for sf in dataclasses.fields(sub_cls):
                    if sf.name in vals and isinstance(vals[sf.name], list):
                        vals[sf.name] = tuple(vals[sf.name])
                kwargs[f.name] = sub_cls(**vals)
            else:
                kwargs[f.name] = sub
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "SLAMConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)

    # Presets mirroring the three reference launch files -----------------
    @classmethod
    def preset(cls, name: str) -> "SLAMConfig":
        """'camera' | 'yolo_slam' | 'bag_playback' — the reference launch XMLs."""
        base = cls()
        if name in ("camera", "camera_rviz", "bag_playback"):
            # no detector stream: observations all 'unlabeled'
            return base.replace(
                pipeline=dataclasses.replace(base.pipeline, detections_optional=True))
        if name in ("yolo", "yolo_slam"):
            return base
        if name == "tum_fr3":
            return base.replace(camera=CameraConfig(
                width=640, height=480, fx=535.4, fy=539.2, cx=320.1, cy=247.6,
                depth_scale=1.0 / 5000.0))
        raise ValueError(f"unknown preset: {name!r}")
