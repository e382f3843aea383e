"""KITTI tracking and Virtual KITTI readers of the port.

A copy of ``pointslot_tpu/datasets/kitti.py`` that builds the port's
``slam.objects.Detection`` and decodes PNGs without PIL
(``datasets/png16.py``: zlib and the C unfilter helper). Virtual KITTI 2's
``.jpg`` frames and the PNGs that decoder does not read (Adam7-interlaced,
samples below 8 bits) go through PIL, as every file does in the reference;
without PIL they raise an ImportError that says so.

The JAX module's description follows.

Replaces the reference's offline readers: image list loading
(Examples/Stereo/stereo_kitti.cc:175-245 LoadImages), the 1x24-row object
table ReadKittiObjectInfo (reference src/Tracking.cc:485-640, row layout
documented at :481-484), camera pose GT ReadKittiPoseInfo (:449-479), and
the instance-segmentation PNG reader (src/Frame.cc:1004-1216).

Also provides the Virtual KITTI readers (reference
ReadVirtualKittiObjectInfo :650, ReadVirtualKittiCameraGT :845).

Layout expected (the reference's, README.md:13):
  <root>/image_02/<seq>/ 000000.png ...   left
  <root>/image_03/<seq>/ 000000.png ...   right
  <root>/ObjectTracking.txt (or label_02/<seq>.txt)  detections
  <root>/instances/<seq>/ 000000.png      instance masks (optional)
  <root>/pose_gt.txt                       camera GT (optional)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from pointslot_torch.datasets import png16
from pointslot_torch.slam.objects import Detection

_VEHICLE_TYPES = {"Car", "Van", "Truck", "Bus"}
_NONVEHICLE_TYPES = {
    "Pedestrian", "Person_sitting", "Cyclist", "Tram", "Misc", "DontCare",
}


def _pil_open(path: str):
    """PIL's Image.open for JPEG (Virtual KITTI 2's frames) and the PNGs
    png16 does not decode; raises ImportError without PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading JPEG, Adam7-interlaced PNGs and PNGs with samples below "
            f"8 bits needs PIL, which is not installed (other PNGs need no PIL)") from e
    return Image.open(path)


def _is_png(path: str) -> bool:
    return path.lower().endswith(".png")


def _imread_gray(path: str) -> np.ndarray:
    """PNG/JPG -> (H, W) uint8 grayscale without OpenCV (PNG without PIL,
    but for the kinds png16 leaves to PIL)."""
    if _is_png(path):
        try:
            return png16.read_png_gray(path)
        except png16.NeedsPil:
            pass
    img = _pil_open(path)
    if img.mode not in ("L", "I;16", "I"):
        img = img.convert("L")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (arr / max(arr.max(), 1) * 255).astype(np.uint8)
    return arr


def _imread_raw(path: str) -> np.ndarray:
    """Instance masks: load preserving integer ids."""
    if _is_png(path):
        try:
            return png16.read_png(path)
        except png16.NeedsPil:
            pass
    return np.asarray(_pil_open(path))


def read_kitti_object_rows(path: str, n_frames: Optional[int] = None) -> np.ndarray:
    """Parse the KITTI tracking label file into 1x24 rows (same layout as
    the reference's EvOfflineAllObjectDetections; see SURVEY.md):

    [0] frame [1] track [2] trunc [3] occ [4] alpha [5:9] bbox xywh
    [9:12] dims (l, h, w) [12:15] location cam-frame [15] rot_y [16] score
    [17] type_id (1 = vehicle) [18] is_moving [19:24] zeros.

    KITTI labels give the 3D-box BOTTOM-face center; rows store the
    GEOMETRIC center (y - h/2), the framework-wide object-frame convention
    (io/writers.py converts back on export; the VKITTI reader shifts the
    same way). KITTI tracking labels carry no moving/static flag, so
    is_moving is always 1 here (the VKITTI reader fills it for real).
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 17:
                continue
            frame_id = int(float(parts[0]))
            track_id = int(float(parts[1]))
            typ = parts[2]
            type_id = 0.0 if typ in _NONVEHICLE_TYPES else 1.0
            trunc, occ, alpha = (float(parts[i]) for i in (3, 4, 5))
            x0, y0, x1, y1 = (float(parts[i]) for i in (6, 7, 8, 9))
            h, w, l = (float(parts[i]) for i in (10, 11, 12))
            loc = [float(parts[13]), float(parts[14]) - h / 2.0,
                   float(parts[15])]
            rot_y = float(parts[16])
            row = np.zeros(24)
            row[0], row[1] = frame_id, track_id
            row[2], row[3], row[4] = trunc, occ, alpha
            row[5:9] = [x0, y0, x1 - x0, y1 - y0]
            row[9:12] = [l, h, w]
            row[12:15] = loc
            row[15] = rot_y
            row[16] = 1.0
            row[17] = type_id
            row[18] = 1.0
            rows.append(row)
    out = np.asarray(rows) if rows else np.zeros((0, 24))
    if n_frames is not None and len(out):
        out = out[out[:, 0] < n_frames]
    return out


def read_kitti_poses(path: str) -> np.ndarray:
    """12-float rows -> (N, 4, 4) poses (reference ReadKittiPoseInfo)."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(data), 1, 1))
    out[:, :3, :4] = data
    return out


def read_virtual_kitti_objects(pose_file: str, bbox_file: str) -> np.ndarray:
    """Virtual KITTI 2 per-frame object pose + bbox files -> 1x24 rows
    (reference ReadVirtualKittiObjectInfo src/Tracking.cc:650-843).

    pose: frame cameraID trackID alpha width height length wx wy wz
          r_wy r_wx r_wz cx cy cz r_cy r_cx r_cz
    bbox: frame cameraID trackID left right top bottom pixels trunc occ
          isMoving
    """
    def load(path):
        with open(path) as f:
            header = f.readline()
            return [ln.split() for ln in f if ln.strip()], header

    poses, _ = load(pose_file)
    bboxes, _ = load(bbox_file)
    bbox_map: Dict[tuple, List[str]] = {}
    for b in bboxes:
        bbox_map[(int(b[0]), int(b[1]), int(b[2]))] = b
    rows = []
    for p in poses:
        frame, cam_id, track = int(p[0]), int(p[1]), int(p[2])
        if cam_id != 0:
            continue
        key = (frame, cam_id, track)
        if key not in bbox_map:
            continue
        b = bbox_map[key]
        left, right, top, bottom = (float(b[i]) for i in (3, 4, 5, 6))
        is_moving = b[10].lower() in ("true", "1") if len(b) > 10 else True
        width, height, length = float(p[4]), float(p[5]), float(p[6])
        cx, cy, cz = float(p[13]), float(p[14]), float(p[15])
        r_cy = float(p[16])
        row = np.zeros(24)
        row[0], row[1] = frame, track
        row[4] = float(p[3])
        row[5:9] = [left, top, right - left, bottom - top]
        row[9:12] = [length, height, width]
        # Virtual KITTI object origin is at the bottom face center; shift to
        # the geometric center like the reference (EnObjectCenter == 1)
        row[12:15] = [cx, cy - height / 2.0, cz]
        row[15] = r_cy
        row[16] = 1.0
        row[17] = 1.0
        row[18] = float(is_moving)
        rows.append(row)
    return np.asarray(rows) if rows else np.zeros((0, 24))


def read_virtual_kitti_flow(path: str) -> np.ndarray:
    """Decode a Virtual KITTI forward-optical-flow PNG -> (H, W, 2) float32
    per-pixel (du, dv) in pixels (reference
    Frame::ReadVirtualKittiForwardOpticalFlow, src/Frame.cc:1458-1494).

    Encoding (VKITTI 2): 16-bit RGB where R holds u, G holds v, each mapped
    as ``2/(2^16-1) * value - 1`` scaled by (W-1)/(H-1); B == 0 marks an
    invalid pixel (flow forced to zero)."""
    img = png16.read_png16(path)
    if img.ndim != 3:
        raise ValueError(f"{path}: expected RGB flow PNG")
    h, w = img.shape[:2]
    scale = 2.0 / (2.0 ** 16 - 1.0)
    du = (scale * img[:, :, 0].astype(np.float64) - 1.0) * (w - 1)
    dv = (scale * img[:, :, 1].astype(np.float64) - 1.0) * (h - 1)
    invalid = img[:, :, 2] == 0
    flow = np.stack([du, dv], axis=-1).astype(np.float32)
    flow[invalid] = 0.0
    return flow


def virtual_kitti_flow_path(dataset_dir: str, frame_id: int,
                            camera: int = 0) -> str:
    """forwardFlow/Camera_<k>/flow_%05d.png under the sequence folder
    (reference src/Frame.cc:599-600, :1462)."""
    return os.path.join(dataset_dir, "forwardFlow", f"Camera_{camera}",
                        f"flow_{frame_id:05d}.png")


def read_mynteye_object_rows(
    path: str,
    dims=(1.6, 1.5, 3.0),
    location=(0.0, 0.0, 5.0),
    rotation_y: float = 0.0,
) -> np.ndarray:
    """MYNTEYE single-object bbox file -> 1x24 rows (reference
    ReadMynteyeObjectInfo src/Tracking.cc:889-960: per line
    `frame x y w h`; dims/location/rotation come from the config priors)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            row = np.zeros(24)
            row[0] = float(parts[0])
            row[1] = 1  # single fixed track id
            row[3] = 1.0  # occluded flag as the reference sets it
            row[5:9] = [float(p) for p in parts[1:5]]
            row[9:12] = dims
            row[12:15] = location
            row[15] = rotation_y
            row[16] = 1.0
            row[17] = 1.0
            row[18] = 1.0
            rows.append(row)
    return np.asarray(rows) if rows else np.zeros((0, 24))


@dataclass
class KittiTrackingSequence:
    root: str
    sequence: str = "0000"

    def __post_init__(self):
        self.left_dir = os.path.join(self.root, "image_02", self.sequence)
        self.right_dir = os.path.join(self.root, "image_03", self.sequence)
        if not os.path.isdir(self.left_dir):
            # KITTI raw layout: <root>/image_02/data/0000000000.png
            # (reference stereo_kitti.cc:237-243, EnDataSetNameNum == 2)
            raw_left = os.path.join(self.root, "image_02", "data")
            if os.path.isdir(raw_left):
                self.left_dir = raw_left
                self.right_dir = os.path.join(self.root, "image_03", "data")
            else:
                # flat layout: <root>/image_02/*.png
                self.left_dir = os.path.join(self.root, "image_02")
                self.right_dir = os.path.join(self.root, "image_03")
        self.frames = sorted(
            f for f in os.listdir(self.left_dir) if f.endswith((".png", ".jpg"))
        )
        label = None
        for cand in (
            os.path.join(self.root, "ObjectTracking.txt"),
            os.path.join(self.root, "label_02", f"{self.sequence}.txt"),
            os.path.join(self.root, f"{self.sequence}.txt"),
        ):
            if os.path.isfile(cand):
                label = cand
                break
        self.rows = (
            read_kitti_object_rows(label, n_frames=len(self.frames))
            if label
            else np.zeros((0, 24))
        )
        self.instances_dir = None
        for cand in (
            os.path.join(self.root, "instances", self.sequence),
            os.path.join(self.root, "instances"),
        ):
            if os.path.isdir(cand):
                self.instances_dir = cand
                break
        pose_file = os.path.join(self.root, "pose_gt.txt")
        self.gt_poses = read_kitti_poses(pose_file) if os.path.isfile(pose_file) else None
        # Virtual KITTI forward optical flow (offline flow tracking mode)
        self.flow_dir = None
        for cand in (
            os.path.join(self.root, "forwardFlow", "Camera_0"),
            os.path.join(self.root, self.sequence, "forwardFlow", "Camera_0"),
        ):
            if os.path.isdir(cand):
                self.flow_dir = cand
                break

    def load_flow(self, i: int):
        """Forward flow map of frame i, or None (reference src/Frame.cc:700)."""
        if self.flow_dir is None:
            return None
        path = os.path.join(self.flow_dir, f"flow_{i:05d}.png")
        return read_virtual_kitti_flow(path) if os.path.isfile(path) else None

    def __len__(self):
        return len(self.frames)

    def timestamps(self, fps: float = 10.0):
        return np.arange(len(self.frames)) / fps

    def load(self, i: int):
        """Returns (left, right, detections, instance_mask) for frame i.

        Detection mask_value follows the reference semantics: the k-th
        detection row of the frame owns mask pixels with value k+1
        (reference src/Frame.cc:810-844)."""
        name = self.frames[i]
        left = _imread_gray(os.path.join(self.left_dir, name))
        right = _imread_gray(os.path.join(self.right_dir, name))
        frame_rows = self.rows[self.rows[:, 0] == i] if len(self.rows) else []
        dets = [
            Detection.from_row24(r, mask_value=k + 1)
            for k, r in enumerate(frame_rows)
            if r[1] >= 0 and r[17] > 0
        ]
        inst = None
        if self.instances_dir is not None:
            p = os.path.join(self.instances_dir, name)
            if os.path.isfile(p):
                raw = _imread_raw(p)
                # KITTI MOTS instance PNGs encode id = class*1000 + instance;
                # normalize to small per-frame ids matched to rows by bbox IoU
                inst = self._normalize_instances(raw, dets)
        return left, right, dets, inst

    @staticmethod
    def _normalize_instances(raw: np.ndarray, dets: List[Detection]) -> np.ndarray:
        """Map arbitrary instance-id images onto 1..K mask values matching
        the detection rows (by bbox overlap), 0 = background."""
        out = np.zeros(raw.shape[:2], np.int32)
        ids = np.unique(raw)
        ids = ids[ids > 0]
        for rid in ids:
            m = raw == rid
            ys, xs = np.nonzero(m)
            if len(xs) == 0:
                continue
            bx0, bx1, by0, by1 = xs.min(), xs.max(), ys.min(), ys.max()
            best, best_iou = 0, 0.0
            for det in dets:
                dx0, dy0, dw, dh = det.bbox
                ix0 = max(bx0, dx0); iy0 = max(by0, dy0)
                ix1 = min(bx1, dx0 + dw); iy1 = min(by1, dy0 + dh)
                inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
                union = (bx1 - bx0) * (by1 - by0) + dw * dh - inter
                iou = inter / max(union, 1)
                if iou > best_iou:
                    best, best_iou = det.mask_value, iou
            if best_iou > 0.3:
                out[m] = best
        return out


def read_virtual_kitti_camera_gt(path: str) -> np.ndarray:
    """Virtual KITTI 2 extrinsic.txt -> (N, 4, 4) world-to-camera matrices
    for Camera 0 (reference ReadVirtualKittiCameraGT, src/Tracking.cc:845).
    Row layout: frame cameraID r1,1 ... r3,4 0 0 0 1 (16 floats row-major)."""
    mats = {}
    with open(path) as f:
        f.readline()  # header
        for ln in f:
            parts = ln.split()
            if len(parts) < 18:
                continue
            frame, cam = int(parts[0]), int(parts[1])
            if cam != 0:
                continue
            mats[frame] = np.asarray(
                [float(x) for x in parts[2:18]], np.float64
            ).reshape(4, 4)
    if not mats:
        return np.zeros((0, 4, 4))
    n = max(mats) + 1
    out = np.tile(np.eye(4), (n, 1, 1))
    for i, T in mats.items():
        out[i] = T
    return out


@dataclass
class VirtualKittiSequence:
    """Virtual KITTI 2 scene loader with the KittiTrackingSequence frame
    interface (reference layout: <root>/<camera dir>/rgb_%05d.jpg,
    Examples/Stereo/stereo_kitti.cc:228-235, plus pose.txt/bbox.txt/
    extrinsic.txt at the root, src/Tracking.cc:112-113,:199)."""

    root: str

    def __post_init__(self):
        pairs = [
            ("frames/rgb/Camera_0", "frames/rgb/Camera_1"),
            ("rgb/Camera_0", "rgb/Camera_1"),
            ("Camera_0", "Camera_1"),
        ]
        self.left_dir = self.right_dir = None
        for l, r in pairs:
            ld = os.path.join(self.root, l)
            if os.path.isdir(ld):
                self.left_dir = ld
                self.right_dir = os.path.join(self.root, r)
                break
        if self.left_dir is None:
            raise FileNotFoundError(
                f"no Virtual KITTI camera dirs under {self.root}"
            )
        self.frames = sorted(
            f for f in os.listdir(self.left_dir)
            if f.endswith((".jpg", ".png"))
        )
        self.stereo = os.path.isdir(self.right_dir)
        pose = os.path.join(self.root, "pose.txt")
        bbox = os.path.join(self.root, "bbox.txt")
        self.rows = (
            read_virtual_kitti_objects(pose, bbox)
            if os.path.isfile(pose) and os.path.isfile(bbox)
            else np.zeros((0, 24))
        )
        ext = os.path.join(self.root, "extrinsic.txt")
        self.gt_poses = (
            read_virtual_kitti_camera_gt(ext) if os.path.isfile(ext) else None
        )
        self.instances_dir = None
        for cand in ("frames/instanceSegmentation/Camera_0",
                     "instanceSegmentation/Camera_0"):
            d = os.path.join(self.root, cand)
            if os.path.isdir(d):
                self.instances_dir = d
                break
        self.flow_dir = None
        for cand in ("frames/forwardFlow/Camera_0", "forwardFlow/Camera_0"):
            d = os.path.join(self.root, cand)
            if os.path.isdir(d):
                self.flow_dir = d
                break

    def __len__(self):
        return len(self.frames)

    def timestamps(self, fps: float = 10.0):
        return np.arange(len(self.frames)) / fps

    def load_flow(self, i: int):
        if self.flow_dir is None:
            return None
        path = os.path.join(self.flow_dir, f"flow_{i:05d}.png")
        return read_virtual_kitti_flow(path) if os.path.isfile(path) else None

    def load(self, i: int):
        name = self.frames[i]
        left = _imread_gray(os.path.join(self.left_dir, name))
        right = (
            _imread_gray(os.path.join(self.right_dir, name))
            if self.stereo else left
        )
        frame_rows = self.rows[self.rows[:, 0] == i] if len(self.rows) else []
        dets = [
            Detection.from_row24(r, mask_value=k + 1)
            for k, r in enumerate(frame_rows)
            if r[1] >= 0 and r[17] > 0
        ]
        inst = None
        if self.instances_dir is not None:
            for pat in (f"instancegt_{i:05d}.png", name):
                p = os.path.join(self.instances_dir, pat)
                if os.path.isfile(p):
                    raw = _imread_raw(p)
                    inst = KittiTrackingSequence._normalize_instances(raw, dets)
                    break
        return left, right, dets, inst
