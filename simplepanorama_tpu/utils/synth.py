"""Seeded image sequences with known cameras.

A procedural scene on the sphere (an equirectangular BGR image that wraps
horizontally) is photographed by pinhole cameras with a known focal
length and known rotations, and the views are written as PNG. Because
the truth is known, a stitch of the views can be checked directly: its
focal against ``focal`` and its relative rotations against
``rotations``.

Conventions: a rotation ``R`` maps world directions into camera
coordinates (x right, y down, z forward), so a world direction ``d``
lands on pixel ``K R d`` with ``K = [[f, 0, cx], [0, f, cy], [0, 0, 1]]``
and ``(cx, cy) = ((w - 1) / 2, (h - 1) / 2)``. World y points down, so a
positive pitch looks up.

Layouts follow the reference's bundled sets at their working size
(700 x 467 px views at f = 700 px, a 53 degree horizontal field of view):

  * ``map``: one row of views 30 degrees apart in yaw (about 40 % overlap);
  * ``front``: two rows of views 30 degrees apart in yaw, at pitch +-12
    degrees.

Every view gets a small pitch and roll jitter (up to 3 and 2 degrees).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Tuple

import numpy as np

SCENE_WH = (4096, 2048)
VIEW_WH = (700, 467)
FOCAL = 700.0
YAW_STEP_DEG = 30.0
FRONT_PITCH_DEG = 12.0
PITCH_JITTER_DEG = 3.0
ROLL_JITTER_DEG = 2.0

# Ground-truth tolerances for a stitch of generated views, shared by the
# CPU calibration test (tests/test_synth.py: 4 views of 400 x 300 px at
# f = 400, init_size 400, RANSAC 300) and chip_smoke.py (6 and 14 views
# of 700 x 467 px at f = 700). The CPU run measured a worst focal error
# of 0.9 %, a worst relative-rotation error of 1.03 degrees and a preview
# coverage of 0.78; the 700 px runs on an H100 measured at most 0.47 %,
# 0.488 degrees and 0.758 coverage. The rotation error is a fixed share
# of a pixel over the focal (the bundle adjustment's free principal
# points trade against rotation), so its tolerance is set per view
# width, with about a 1.5-2x margin; the focal one keeps more.
FOCAL_TOL = 0.03
ROT_TOL_DEG = {400: 2.0, 700: 0.75}       # view width -> degrees
MIN_COVERAGE = 0.6


@dataclasses.dataclass
class SynthSet:
    """A written sequence and its ground truth."""
    paths: List[str]
    focal: float
    rotations: np.ndarray        # (n, 3, 3) world -> camera
    size: Tuple[int, int]        # (h, w) of every view


def rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """World -> camera rotation of a camera turned by ``yaw`` (about the
    vertical axis), then ``pitch`` (up positive), then ``roll`` (about its
    optical axis); angles in radians."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    # camera -> world is Ry Rx Rz; world -> camera is its transpose
    return (Ry @ Rx @ Rz).T


def _value_noise(rng, w: int, h: int, cells_x: int) -> np.ndarray:
    """One octave of smooth value noise, (h, w) in [0, 1), periodic in x:
    a random lattice of ``cells_x`` columns interpolated with a smoothstep
    fade."""
    cells_y = max(2, cells_x // 2)
    lat = rng.random((cells_y + 1, cells_x), dtype=np.float32)

    def axis(n, cells):
        pos = (np.arange(n, dtype=np.float32) + 0.5) * cells / n
        i0 = np.floor(pos).astype(np.int64)
        t = pos - i0
        return i0, t * t * (3.0 - 2.0 * t)

    x0, tx = axis(w, cells_x)
    y0, ty = axis(h, cells_y)
    x1 = (x0 + 1) % cells_x
    x0 = x0 % cells_x
    rows = (lat[:, x0] * (1.0 - tx) + lat[:, x1] * tx)          # (cy+1, w)
    y1 = np.minimum(y0 + 1, cells_y)
    return rows[y0] * (1.0 - ty)[:, None] + rows[y1] * ty[:, None]


def _fill_shape(canvas: np.ndarray, rng, cx: float, cy: float,
                r: float, color: np.ndarray) -> None:
    """Paint one hard-edged filled ellipse or convex polygon centred at
    (cx, cy) with radius ~r; columns wrap around the seam."""
    h, w = canvas.shape[:2]
    R = int(np.ceil(r * 1.6)) + 1
    ys = np.arange(int(cy) - R, int(cy) + R + 1)
    ys = ys[(ys >= 0) & (ys < h)]
    xs = np.arange(int(cx) - R, int(cx) + R + 1)
    dy = (ys[:, None] + 0.5 - cy)
    dx = (xs[None, :] + 0.5 - cx)
    if rng.random() < 0.5:
        ax, ay = r * rng.uniform(0.5, 1.5), r * rng.uniform(0.5, 1.5)
        th = rng.uniform(0, np.pi)
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        inside = (u / ax) ** 2 + (v / ay) ** 2 <= 1.0
    else:
        k = int(rng.integers(3, 8))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = r * rng.uniform(0.6, 1.4, k)
        px, py = rad * np.cos(ang), rad * np.sin(ang)
        inside = np.ones((len(ys), len(xs)), bool)
        for a in range(k):      # convex hull of a star-ordered polygon
            b = (a + 1) % k
            cross = ((px[b] - px[a]) * (dy - py[a])
                     - (py[b] - py[a]) * (dx - px[a]))
            inside &= cross >= 0
    sub = canvas[np.ix_(ys, xs % w)]
    sub[inside] = color
    canvas[np.ix_(ys, xs % w)] = sub


def make_scene(seed: int, width: int = SCENE_WH[0],
               height: int = SCENE_WH[1], n_shapes: int = 800
               ) -> np.ndarray:
    """Equirectangular (height, width, 3) BGR uint8 scene, periodic in x:
    several octaves of value noise under a slowly varying tint, plus
    ``n_shapes`` hard-edged ellipses and polygons (the blobs and corners
    SIFT keys on) placed within 50 degrees of the horizon."""
    rng = np.random.default_rng(seed)
    lum = np.zeros((height, width), np.float32)
    amp, total = 1.0, 0.0
    for octave in range(2, 9):
        lum += amp * _value_noise(rng, width, height, 2 ** octave)
        total += amp
        amp *= 0.8
    lum = np.clip((lum / total - 0.5) * 3.0 + 0.5, 0.0, 1.0)
    tint = np.stack([_value_noise(rng, width, height, 4)
                     for _ in range(3)], axis=-1)
    img = 255.0 * lum[..., None] * (0.55 + 0.9 * tint)
    canvas = np.clip(img, 0, 255).astype(np.uint8)
    band = height * 50.0 / 180.0
    for _ in range(n_shapes):
        cy = rng.uniform(height / 2 - band, height / 2 + band)
        cx = rng.uniform(0, width)
        r = width * 0.002 * np.exp(rng.uniform(0.0, np.log(6.0)))
        color = rng.integers(0, 256, 3).astype(np.uint8)
        _fill_shape(canvas, rng, cx, cy, r, color)
    return canvas


def render_view(scene: np.ndarray, R: np.ndarray, focal: float,
                size_wh: Tuple[int, int] = VIEW_WH) -> np.ndarray:
    """Photograph ``scene`` with a pinhole camera (rotation ``R``, focal
    ``focal`` px): bilinear sampling of the equirectangular image along
    each pixel's ray. Returns (h, w, 3) BGR uint8."""
    w, h = size_wh
    H, W = scene.shape[:2]
    xs = (np.arange(w, dtype=np.float64) - (w - 1) / 2.0) / focal
    ys = (np.arange(h, dtype=np.float64) - (h - 1) / 2.0) / focal
    rays = np.stack(np.broadcast_arrays(xs[None, :], ys[:, None],
                                        np.ones((1, 1))), axis=-1)
    d = rays @ np.asarray(R, np.float64)        # R^T applied to each ray
    lon = np.arctan2(d[..., 0], d[..., 2])
    lat = np.arctan2(-d[..., 1], np.hypot(d[..., 0], d[..., 2]))
    u = (lon + np.pi) / (2 * np.pi) * W - 0.5
    v = (np.pi / 2 - lat) / np.pi * H - 0.5
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    c0, c1 = u0 % W, (u0 + 1) % W
    r0, r1 = np.clip(v0, 0, H - 1), np.clip(v0 + 1, 0, H - 1)

    def px(r, c):
        return scene[r, c].astype(np.float32)

    top = px(r0, c0) * (1 - fu) + px(r0, c1) * fu
    bot = px(r1, c0) * (1 - fu) + px(r1, c1) * fu
    return np.clip(np.rint(top * (1 - fv) + bot * fv), 0, 255).astype(
        np.uint8)


def layout(kind: str, seed: int, n: int = 0) -> np.ndarray:
    """Camera rotations (n, 3, 3) of a ``map`` (one row, 6 views by
    default) or ``front`` (two rows of 7 by default) layout with seeded
    pitch/roll jitter; for ``front``, ``n`` counts views per row."""
    rng = np.random.default_rng(seed + 1)
    step = np.deg2rad(YAW_STEP_DEG)
    if kind == "map":
        cols, pitches = n or 6, [0.0]
    elif kind == "front":
        cols, pitches = n or 7, [FRONT_PITCH_DEG, -FRONT_PITCH_DEG]
    else:
        raise ValueError(f"unknown layout {kind!r}")
    rots = []
    for p in pitches:
        for c in range(cols):
            jp = rng.uniform(-PITCH_JITTER_DEG, PITCH_JITTER_DEG)
            jr = rng.uniform(-ROLL_JITTER_DEG, ROLL_JITTER_DEG)
            rots.append(rotation((c - (cols - 1) / 2) * step,
                                 np.deg2rad(p + jp), np.deg2rad(jr)))
    return np.stack(rots)


def write_sequence(out_dir, kind: str, seed: int, n: int = 0,
                   size_wh: Tuple[int, int] = VIEW_WH,
                   focal: float = FOCAL, scene=None) -> SynthSet:
    """Render a ``kind`` layout of the seeded scene into ``out_dir`` as
    lossless PNG files and return the paths with the ground truth.
    ``scene`` may pass a scene made once by make_scene(seed)."""
    from simplepanorama_tpu.io import save_image
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if scene is None:
        scene = make_scene(seed)
    rots = layout(kind, seed, n)
    paths = []
    for i, R in enumerate(rots):
        p = out / f"{kind}_{i:02d}.png"
        save_image(str(p), render_view(scene, R, focal, size_wh))
        paths.append(str(p))
    return SynthSet(paths=paths, focal=float(focal), rotations=rots,
                    size=(size_wh[1], size_wh[0]))


def _angle_deg(A: np.ndarray, B: np.ndarray) -> float:
    """Angle of the rotation A^T B, in degrees."""
    c = (np.trace(A.T @ B) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def stitch_errors(result, truth: SynthSet) -> dict:
    """Ground-truth errors of a stitch.StitchResult of ``truth``'s views:
    ``focal_err``, the worst |f / f_true - 1| over cameras, and
    ``rot_err_deg``, the worst angle between the estimated and the true
    rotation of each camera relative to the first. The stitcher's ``rot``
    maps camera to world coordinates, the transpose of this module's
    convention, so its relative rotation is ``rot_i^T rot_0``."""
    rot = np.asarray(result.rot, np.float64)
    true = truth.rotations[list(result.nodes)]
    focal = np.asarray(result.K, np.float64)[:, 0, 0]
    rel_err = [_angle_deg(rot[i].T @ rot[0], true[i] @ true[0].T)
               for i in range(len(rot))]
    return {"focal_err": float(np.max(np.abs(focal / truth.focal - 1.0))),
            "rot_err_deg": float(max(rel_err))}


def coverage(preview: np.ndarray) -> float:
    """Share of preview pixels that any view covers (not black)."""
    return float((np.asarray(preview).max(axis=-1) > 0).mean())
