"""Configuration dataclasses read by the per-frame hot path.

A copy of the fields of ``pointslot_tpu/config.py`` (CameraConfig,
ORBConfig and the SystemConfig fields the fused step reads), with the same
defaults: KITTI tracking's 1242x375 stereo camera and the 1000-feature,
8-level, scale-1.2 ORB budget.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CameraConfig:
    """Stereo pinhole camera (reference YAML ``Camera.*`` keys)."""

    fx: float = 721.5377
    fy: float = 721.5377
    cx: float = 609.5593
    cy: float = 172.8540
    width: int = 1242
    height: int = 375
    bf: float = 384.38148       # baseline * fx

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclass(frozen=True)
class ORBConfig:
    """Feature extraction budget (reference YAML ``ORBextractor.*``)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    min_th_fast: int = 5
    # full-resolution stereo disparity re-fit for keypoints at this octave
    # or above (ops/stereo.fine_refine_from_patches)
    stereo_fine_min_level: int = 6
    # descriptor pre-filter for the stereo row match
    stereo_match_th: int = 100


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)

    def replace(self, **kwargs) -> "SystemConfig":
        return dataclasses.replace(self, **kwargs)
