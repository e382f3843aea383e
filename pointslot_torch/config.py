"""Configuration dataclasses of the port.

A copy of the fields of ``pointslot_tpu/config.py`` that the ported slices
read, with the same defaults: KITTI tracking's 1242x375 stereo camera, the
1000-feature, 8-level, scale-1.2 ORB budget, the tracking policy, the
object-SLOT knobs, the online detector and DeepSORT of mode 3, the
bundle-adjustment caps and chi2 gates, the loop-closing policy, and the
runtime knobs. A field joins with the slice that reads it.
``runtime.pipeline_stages`` keeps the reference's default and exists so
that the System can raise for what the port does not run yet.

``load_yaml`` reads a reference-schema (OpenCV ``%YAML:1.0``) file into a
``SystemConfig``, as ``pointslot_tpu.config.load_yaml`` does, key for key.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple


class SLOTMode:
    """The five behavioral modes (reference include/Parameters.h:68-75)."""

    SLAM = 0                 # pure stereo ORB-SLAM
    DYNAMIC_SLAM = 1         # semantic dynamic SLAM: mask out dynamic regions
    MANUAL_TRACKING = 2      # user-selected ROIs, object pipeline on those
    AUTONOMOUS_DRIVING = 3   # online detector + MOT association in-loop
    OFFLINE = 4              # offline GT detections/IDs (reproducibility mode)


@dataclass(frozen=True)
class CameraConfig:
    """Stereo pinhole camera (reference YAML ``Camera.*`` keys)."""

    fx: float = 721.5377
    fy: float = 721.5377
    cx: float = 609.5593
    cy: float = 172.8540
    # radial-tangential distortion (KITTI is rectified: all zero)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 1242
    height: int = 375
    fps: float = 10.0
    bf: float = 384.38148       # baseline * fx
    # close/far point threshold in units of baseline (reference ThDepth)
    th_depth: float = 50.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def depth_threshold(self) -> float:
        return self.th_depth * self.bf / self.fx

    @property
    def distorted(self) -> bool:
        """Keypoints are undistorted: k1, k2, p1 or p2 nonzero. k3 is read
        by nothing, as in the reference's System."""
        return any(v != 0 for v in (self.k1, self.k2, self.p1, self.p2))


@dataclass(frozen=True)
class ORBConfig:
    """Feature extraction budget (reference YAML ``ORBextractor.*``)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    min_th_fast: int = 5
    # rBRIEF sample-pair table: "learned" (the standard decorrelated ORB
    # table) or "gaussian" (seeded random pairs, the object frontend's)
    brief_pattern: str = "learned"
    # full-resolution stereo disparity re-fit for keypoints at this octave
    # or above (ops/stereo.fine_refine_from_patches)
    stereo_fine_min_level: int = 6
    # descriptor pre-filter for the stereo row match
    stereo_match_th: int = 100


@dataclass(frozen=True)
class TrackingConfig:
    """Camera-tracking policy knobs (reference src/Tracking.cc)."""

    min_init_stereo_features: int = 500
    min_matches_motion_model: int = 20
    min_matches_ref_kf: int = 15
    min_inliers_local_map: int = 30
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10
    kf_ref_ratio_many_close: float = 0.75
    kf_ref_ratio: float = 0.9
    min_tracked_close: int = 100
    max_nontracked_close: int = 70
    max_local_keyframes: int = 80
    reset_max_kfs_when_lost: int = 5


@dataclass(frozen=True)
class ObjectConfig:
    """Object-SLOT knobs (reference Parameters.cc object block): the fields
    the object path of modes 2-4 reads."""

    # BRIEF table of the object frontend, a second extractor beside the
    # camera's (the reference runs its own ORB on object masks,
    # src/Frame.cc:2623-2665); equal to ORBConfig.brief_pattern shares one
    brief_pattern: str = "gaussian"
    max_object_points: int = 512        # per-object landmark capacity
    select_tracked_obj_id: int = -1     # -1 = every track
    narrow_bbox_px: int = 10            # shrink 2D bbox before masking (modes 2, 3)
    max_missing_dt: float = 0.5         # occlusion bridge time (s)
    manual_point_max_distance: bool = False
    in_obj_frame_point_max_distance: float = 3.0
    init_min_features: int = 40         # EnInitDetObjORBFeaturesNum
    init_min_map_points: int = 17       # EnInitMapObjectPointsNum
    min_tracked_points: int = 15        # EnMinTrackedMOPsNUM
    track_min_features: int = 30        # EnTrackObjectMinFeatureNum
    # the (w, h, l) size prior of detections without one (modes 2, 3)
    uniform_scale: Tuple[float, float, float] = (1.6, 1.5, 3.0)
    set_init_position_by_points: bool = True
    # dynamic/static discrimination (src/DetectionObject.cc:189,
    # src/MapObject.cc:414-448)
    dyn_mono_err_threshold: float = 1.0
    dyn_stereo_err_threshold: float = 2.0
    dyn_hysteresis_votes: int = 4
    # object keyframe / BA policy (src/Optimizer.cc:47,
    # src/ObjectLocalMapping.cpp:375); the solve's pose capacity is the next
    # power of two of the live window, up to ba_window_pose_cap
    ba_window_kf_ids: int = 120
    ba_min_covisible_kfs: int = 8
    ba_window_pose_cap: int = 128
    # redundant object-keyframe culling (src/ObjectLocalMapping.cpp:269-323)
    kf_culling: bool = True
    kf_cull_redundancy: float = 0.9
    # SE(3) constant-velocity priors between consecutive object keyframes
    # in the BA window; 0 = off, the reference's live surface
    ba_motion_prior_weight: float = 0.0
    # GMS grid-statistics filtering of object brute matches (the reference's
    # SearchByBruceMatchingWithGMS path)
    use_gms: bool = False
    # offline-optical-flow point tracking (Virtual KITTI flow maps; the
    # reference's SearchByOfflineOpticalFlowTracking, src/ORBmatcher.cc:2236:
    # search radius RADIUS_FORDYNAMIC=5 px, Hamming gate
    # TH_HIGH_FORDYNAMIC=130)
    use_offline_flow: bool = False
    flow_match_radius: float = 5.0
    flow_match_th_desc: int = 130


@dataclass(frozen=True)
class DetectorConfig:
    """Online detection head (mode 3; reference YOLOdetector + deepsort)."""

    conf_threshold: float = 0.4
    iou_threshold: float = 0.5
    input_size: int = 640
    network_width: int = 16      # base channel count of the YOLO network
    keep_classes: Tuple[int, ...] = (2, 7)   # car, truck (reference Frame.cc:2557)
    weights_path: Optional[str] = None
    reid_weights_path: Optional[str] = None
    reid_feature_dim: int = 128
    # DeepSORT association (reference deepsort/src/tracker.cpp)
    max_cosine_distance: float = 0.2
    nn_budget: int = 100
    max_iou_distance: float = 0.7
    max_age: int = 30
    n_init: int = 3


@dataclass(frozen=True)
class BAConfig:
    """Bundle-adjustment solver settings (reference src/Optimizer.cc)."""

    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    # capacities of one windowed solve: poses, points, observations/point
    max_ba_keyframes: int = 32
    max_ba_points: int = 8192
    max_obs_per_point: int = 16


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing (reference src/LoopClosing.cc)."""

    enabled: bool = True
    covisibility_consistency_th: int = 3
    sim3_ransac_iters: int = 64
    min_sim3_inliers: int = 20
    fix_scale: bool = True   # stereo
    pose_graph_cg_iters: int = 100
    # detection policy (reference src/LoopClosing.cc:106 DetectLoop)
    min_kfs_before_detect: int = 10   # map must have this many KFs
    cooldown_kfs: int = 10            # KFs between accepted loops
    min_frame_distance: int = 20      # candidate must be this many frames old
    max_candidates: int = 5           # BoW candidates examined per query
    # relocalization BoW floor (reference KeyFrameDatabase::
    # DetectRelocalizationCandidates minScore analog)
    reloc_min_score: float = 0.015
    reloc_max_candidates: int = 5
    # inlier-weighted IRLS refinement of the RANSAC loop transform
    # (reference Optimizer::OptimizeSim3, src/Optimizer.cc:1684)
    refine_transform_iters: int = 4
    # optional DBoW2 vocabulary file (.bin, .bin.gz or the text export);
    # None trains or loads the small in-repo vocabulary
    vocab_path: Optional[str] = None
    # force the tree vocabulary + sparse inverted-index database for
    # vocab_path; None = auto by vocabulary size
    vocab_as_tree: Optional[bool] = None
    # full-map BA after loop correction (the reference's detached-thread
    # GBA, src/LoopClosing.cc:648-752), after duplicate structure across
    # the loop is merged (SearchAndFuse analog)
    run_global_ba: bool = True
    # run the GBA solve on a detached thread outside the map lock (the
    # reference's RunGlobalBundleAdjustment thread + mbStopGBA abort);
    # False = inline deterministic solve (unit tests)
    background_gba: bool = True
    # global-BA structure caps (all keyframes participate; points beyond the
    # cap are corrected by their reference keyframe's pose delta)
    gba_max_points: int = 8192
    gba_obs_per_point: int = 8


@dataclass(frozen=True)
class RuntimeConfig:
    """Host-pipeline execution knobs."""

    # run mapping in a worker thread (the reference's LocalMapping thread)
    async_mapping: bool = False
    # device-resident camera tracking through FusedTrackStep, with
    # keyframe-rate device map tables (slam/fast_path.py)
    device_resident_tracking: bool = False
    fast_refresh_every: int = 10
    profile: bool = False
    map_max_kfs: int = 256
    map_max_points: int = 32768
    pipeline_stages: bool = False


@dataclass(frozen=True)
class SystemConfig:
    slot_mode: int = SLOTMode.SLAM
    # mode 1: 0 = a mask every frame, 1 = masks carried by the ROI tracker
    dynaslam_mode: int = 0
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    objects: ObjectConfig = field(default_factory=ObjectConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kwargs) -> "SystemConfig":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# YAML loading (reference schema)
# ---------------------------------------------------------------------------

def _parse_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV ``%YAML:1.0`` flat key:value file.

    cv::FileStorage YAML is almost-but-not-quite standard YAML (the ``%YAML:1.0``
    directive and ``!!opencv-matrix`` tags break pyyaml), and the reference's
    configs are flat scalars — so a tolerant line parser is both simpler and
    more compatible.
    """
    out: dict = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%"):
                continue
            m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
            if not m:
                continue
            key, val = m.group(1), m.group(2).strip().strip('"')
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def load_yaml(path: str, base: Optional[SystemConfig] = None) -> SystemConfig:
    """Build a :class:`SystemConfig` from a reference-schema YAML file
    (``pointslot_tpu/config.py::load_yaml``): the keys it does not set keep
    `base`'s values. ``Camera.RGB``, ``ORBextractor.iniThFAST`` and
    ``Viewer.ObjectCenter`` set fields that nothing reads, in either
    package, so the port has no field for them and leaves them unread."""
    y = _parse_opencv_yaml(path)
    cfg = base or SystemConfig()

    def get(key, default):
        return y.get(key, default)

    cam = dataclasses.replace(
        cfg.camera,
        fx=float(get("Camera.fx", cfg.camera.fx)),
        fy=float(get("Camera.fy", cfg.camera.fy)),
        cx=float(get("Camera.cx", cfg.camera.cx)),
        cy=float(get("Camera.cy", cfg.camera.cy)),
        k1=float(get("Camera.k1", cfg.camera.k1)),
        k2=float(get("Camera.k2", cfg.camera.k2)),
        p1=float(get("Camera.p1", cfg.camera.p1)),
        p2=float(get("Camera.p2", cfg.camera.p2)),
        width=int(get("Camera.width", cfg.camera.width)),
        height=int(get("Camera.height", cfg.camera.height)),
        fps=float(get("Camera.fps", cfg.camera.fps)),
        bf=float(get("Camera.bf", cfg.camera.bf)),
        th_depth=float(get("ThDepth", cfg.camera.th_depth)),
    )
    orb = dataclasses.replace(
        cfg.orb,
        n_features=int(get("ORBextractor.nFeatures", cfg.orb.n_features)),
        scale_factor=float(get("ORBextractor.scaleFactor", cfg.orb.scale_factor)),
        n_levels=int(get("ORBextractor.nLevels", cfg.orb.n_levels)),
        min_th_fast=int(get("ORBextractor.minThFAST", cfg.orb.min_th_fast)),
    )
    uniform_scale = (
        float(get("Object.Width.xc", cfg.objects.uniform_scale[0])),
        float(get("Object.Height.yc", cfg.objects.uniform_scale[1])),
        float(get("Object.Length.zc", cfg.objects.uniform_scale[2])),
    )
    objects = dataclasses.replace(
        cfg.objects,
        select_tracked_obj_id=int(
            get("Object.EnSelectTrackedObjId", cfg.objects.select_tracked_obj_id)
        ),
        manual_point_max_distance=bool(
            int(get("Object.EbManualSetPointMaxDistance", 0)) > 0
        ),
        in_obj_frame_point_max_distance=float(
            get(
                "Object.EfInObjFramePointMaxDistance",
                cfg.objects.in_obj_frame_point_max_distance,
            )
        ),
        set_init_position_by_points=(
            float(get("Object.EbSetInitPositionByPoints", 1)) > 0
        ),
        # extension key: the reference hard-codes this switch as a local
        # `int temp = 0/1` (src/Tracking.cc:2384-2412)
        use_offline_flow=bool(
            int(get("Object.UseOfflineFlow",
                    int(cfg.objects.use_offline_flow)))
        ),
        init_min_features=int(
            get("Object.EnInitDetObjORBFeaturesNum", cfg.objects.init_min_features)
        ),
        uniform_scale=uniform_scale,
    )
    detector = dataclasses.replace(
        cfg.detector,
        conf_threshold=float(get("Yolo.confThres", cfg.detector.conf_threshold)),
        iou_threshold=float(get("Yolo.iouThres", cfg.detector.iou_threshold)),
        weights_path=get("Yolo.weightsPath", cfg.detector.weights_path),
        reid_weights_path=get("DeepSort.weightsPath", cfg.detector.reid_weights_path),
    )
    # extension key (no reference analog — the reference hard-codes 500,
    # src/Tracking.cc:2842, which is disproportionate at small geometries)
    tracking = dataclasses.replace(
        cfg.tracking,
        min_init_stereo_features=int(
            get("Tracking.MinInitStereoFeatures",
                cfg.tracking.min_init_stereo_features)
        ),
    )
    return dataclasses.replace(
        cfg,
        slot_mode=int(get("SLOT.MODE", cfg.slot_mode)),
        dynaslam_mode=int(get("DynaSLAM.MODE", cfg.dynaslam_mode)),
        camera=cam,
        orb=orb,
        objects=objects,
        detector=detector,
        tracking=tracking,
    )
