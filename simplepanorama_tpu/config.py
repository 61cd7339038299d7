"""Configuration for the stitching pipeline.

Mirrors the reference's ``pan::config`` field-for-field (same names, same
defaults — /root/reference/src/classes/_panorama.h:80-125) so that a config
file written by the reference application parses here unchanged, and the
key=value file format of ``conf::ConfigParser``
(/root/reference/src/system/_config_parser.h:16-138) round-trips.
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Union


class Blending(enum.IntEnum):
    NO_BLEND = 0
    SIMPLE_BLEND = 1
    MULTI_BLEND = 2


class Projection(enum.IntEnum):
    SPHERICAL = 0
    CYLINDRICAL = 1
    STEREOGRAPHIC = 2


class Stretch(enum.IntEnum):
    LINEAR_SCALING = 0
    QUADRATIC_SCALING = 1


@dataclasses.dataclass
class Config:
    """All pipeline tunables. Defaults match the reference exactly."""

    # system
    threads: int = 8                       # host-side IO/decode parallelism
    init_size: int = 700                   # working resolution (max side)
    # blending
    blend: Blending = Blending.MULTI_BLEND
    gain_compensation: bool = False
    blend_intensity: bool = True           # exposure-disparity fix
    cut: bool = False                      # graph-cut seams
    cut_seams: bool = True                 # distance-transform seams
    # MULTI_BLEND
    bands: int = 2
    sigma_blend: float = 7.0
    # projection
    straighten: bool = True
    proj: Projection = Projection.SPHERICAL
    fix_center: bool = True                # stereographic missing-center fix
    stretching: Stretch = Stretch.QUADRATIC_SCALING
    # adjustment
    focal: float = 700.0                   # fallback focal if estimation fails
    lambda_: float = 0.05                  # initial LM lambda
    fast: bool = False                     # Lowe objective (camera-only LM)
    # matching
    max_images_per_match: int = 5
    max_keypoints: int = 250               # per-pair cap after RANSAC cleanup
    RANSAC_iterations: int = 1500
    x_margin: int = 4                      # inlier reprojection margin (px)
    min_overlap: float = 0.15
    overlap_inl_match: float = 0.1
    overlap_inl_keyp: float = 0.005
    conf: float = 0.025
    # SIFT
    nfeatures: int = 0                     # 0 = unlimited (we clamp, see below)
    nOctaveLayers: int = 4
    contrastThreshold: float = 3e-2
    edgeThreshold: float = 6.0
    sigma_sift: float = 1.4142

    # --- rebuild-specific knobs (fixed-shape discipline) -----------------
    # Detector keypoint capacity per image. The device SIFT emits a fixed
    # number of slots; invalid slots carry a validity mask. The reference's
    # nfeatures=0 means "unlimited"; this is the static bound we pad to.
    # Capacity sensitivity (measured, tests/test_adjacency_parity.py):
    # raising to 2048 changes NOTHING about the accepted pair set or
    # weights on brocken/front — the default stays 1024 (half the
    # SIFT/matching cost for identical adjacency).
    max_kp_detect: int = 1024
    # Static capacity of per-pair candidate matches fed to RANSAC.
    max_matches_per_pair: int = 512

    def sift_max_features(self) -> int:
        """Static keypoint slot count (nfeatures=0 → max_kp_detect)."""
        if self.nfeatures and self.nfeatures > 0:
            return min(self.nfeatures, self.max_kp_detect)
        return self.max_kp_detect


# ---------------------------------------------------------------------------
# key=value config-file round-trip, matching conf::ConfigParser's registry
# (key names and registration order: _config_parser.h:20-111).
# ---------------------------------------------------------------------------

def _fmt_float(v: float) -> str:
    s = f"{v:.6f}".rstrip("0")
    if s.endswith("."):
        s += "0"
    return s


_ENTRIES = [
    # (file key, attr, to_str, from_str)
    ("Threads", "threads", str, int),
    ("Focal", "focal", _fmt_float, float),
    ("Init_size", "init_size", str, int),
    ("Method", "blend", lambda v: Blending(v).name, lambda s: Blending[s]),
    ("Gain_Compensation", "gain_compensation",
     lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Blend_Intensity", "blend_intensity",
     lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Cut", "cut", lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Use_Cut", "cut_seams",
     lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Bands", "bands", str, int),
    ("Blend_Sigma", "sigma_blend", _fmt_float, float),
    ("Straighten", "straighten",
     lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Projection", "proj", lambda v: Projection(v).name,
     lambda s: Projection[s]),
    ("Fix_center", "fix_center",
     lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Stretch", "stretching", lambda v: Stretch(v).name,
     lambda s: Stretch[s]),
    ("Lambda", "lambda_", _fmt_float, float),
    ("Adjustment", "fast",
     lambda v: "true" if v else "false", lambda s: s == "true"),
    ("Max_Images_Per_Match", "max_images_per_match", str, int),
    ("Max_Keypoints", "max_keypoints", str, int),
    ("RANSAC_iterations", "RANSAC_iterations", str, int),
    ("x_Margin", "x_margin", str, int),
    ("min_overlap", "min_overlap", _fmt_float, float),
    ("overlap_inl_match", "overlap_inl_match", _fmt_float, float),
    ("overlap_inl_keyp", "overlap_inl_keyp", _fmt_float, float),
    ("confidence", "conf", _fmt_float, float),
    ("nfeatures", "nfeatures", str, int),
    ("nOctaveLayers", "nOctaveLayers", str, int),
    ("contrastThreshold", "contrastThreshold", _fmt_float, float),
    ("edgeThreshold", "edgeThreshold", _fmt_float, float),
    ("sigma_sift", "sigma_sift", _fmt_float, float),
]

_KEY_TO_ENTRY = {k: (attr, to_s, from_s) for k, attr, to_s, from_s in _ENTRIES}


def read_config_file(path: Union[str, Path], cfg: Config = None) -> Config:
    """Parse a key=value config file (tolerates comments/blank lines/unknown
    keys, like ConfigParser::read_cfg, _config_parser.cpp:52-86)."""
    cfg = cfg or Config()
    text = Path(path).read_text()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        entry = _KEY_TO_ENTRY.get(key)
        if entry is None:
            continue
        attr, _, from_s = entry
        try:
            setattr(cfg, attr, from_s(val))
        except (ValueError, KeyError):
            pass  # tolerate malformed values, keep default
    return cfg


def write_config_file(path: Union[str, Path], cfg: Config) -> None:
    """Write the full config in registration order (ConfigParser::write_cfg)."""
    lines = []
    for key, attr, to_s, _ in _ENTRIES:
        lines.append(f"{key} = {to_s(getattr(cfg, attr))}")
    Path(path).write_text("\n".join(lines) + "\n")
