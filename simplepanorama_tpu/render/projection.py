"""Rotation warpers: spherical / cylindrical / stereographic projections.

Capability mirror of proj::{spherical,cylindrical,sten}_proj
(/root/reference/src/math/_projection.cpp) which wrap OpenCV's
detail::RotationWarper family. The design splits the work:

  * host (numpy, tiny): forward-map each image's border to find its
    destination ROI (OpenCV detectResultRoi semantics) — ROIs are shape
    metadata and must be static for XLA;
  * device (one vmapped jitted program): backward-map every destination
    pixel of a common padded ROI through ray geometry and bilinearly
    gather from the source image. The footprint mask falls out of the
    same map (in-bounds + in-front), then gets eroded like the
    reference's createSurroundingMask + 3x erode pipeline
    (_projection.cpp:446-449).

Projection formulas are the standard ones the reference's OpenCV warpers
use (scale = projector focal): forward maps unit ray -> (u, v) plane,
backward the inverse. K is adjusted to principal point
(w - cx, h - cy) exactly like the reference (_projection.cpp:38-42).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.geometry.rotation import mm


# ---------------------------------------------------------------------------
# projection math (host + device shared, works on numpy or jnp arrays)
# ---------------------------------------------------------------------------

def _forward_spherical(x, y, z, xp):
    u = xp.arctan2(x, z)
    n = xp.sqrt(x * x + y * y + z * z)
    v = xp.pi - xp.arccos(xp.clip(y / n, -1.0, 1.0))
    return u, v


def _backward_spherical(u, v, xp):
    sinv = xp.sin(v)
    return sinv * xp.sin(u), -xp.cos(v), sinv * xp.cos(u)


def _forward_cylindrical(x, y, z, xp):
    u = xp.arctan2(x, z)
    v = y / xp.sqrt(x * x + z * z)
    return u, v


def _backward_cylindrical(u, v, xp):
    return xp.sin(u), v, xp.cos(u)


def _forward_stereographic(x, y, z, xp):
    u_ = xp.arctan2(x, z)
    n = xp.sqrt(x * x + y * y + z * z)
    v_ = xp.pi - xp.arccos(xp.clip(y / n, -1.0, 1.0))
    r = xp.sin(v_) / (1.0 - xp.cos(v_) + 1e-12)
    return r * xp.cos(u_), r * xp.sin(u_)


def _backward_stereographic(u, v, xp):
    u_ = xp.arctan2(v, u)
    r = xp.sqrt(u * u + v * v)
    v_ = 2.0 * xp.arctan(1.0 / (r + 1e-12))
    sinv = xp.sin(v_)
    return sinv * xp.sin(u_), -xp.cos(v_), sinv * xp.cos(u_)


_PROJ = {
    "spherical": (_forward_spherical, _backward_spherical),
    "cylindrical": (_forward_cylindrical, _backward_cylindrical),
    "stereographic": (_forward_stereographic, _backward_stereographic),
}


def adjusted_K(K: np.ndarray, h: int, w: int) -> np.ndarray:
    """K with principal point (w - cx, h - cy) (_projection.cpp:38-42)."""
    Ka = np.array(K, np.float64)
    Ka[0, 2] = w - K[0, 2]
    Ka[1, 2] = h - K[1, 2]
    return Ka


def roi_for_image(kind: str, scale: float, R: np.ndarray, K: np.ndarray,
                  h: int, w: int, step: int = 4) -> Tuple[int, int, int, int]:
    """Destination ROI (tl_x, tl_y, width, height) by forward-mapping the
    source border (detectResultRoiByBorder semantics), host-side numpy."""
    fwd, _ = _PROJ[kind]
    Ka = adjusted_K(K, h, w)
    xs = np.arange(0, w, step, dtype=np.float64)
    ys = np.arange(0, h, step, dtype=np.float64)
    border = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], 1),
        np.stack([xs, np.full_like(xs, h - 1)], 1),
        np.stack([np.zeros_like(ys), ys], 1),
        np.stack([np.full_like(ys, w - 1), ys], 1)])
    pts = np.concatenate([border, np.ones((len(border), 1))], 1)
    rays = pts @ (np.asarray(R) @ np.linalg.inv(Ka)).T
    u, v = fwd(rays[:, 0], rays[:, 1], rays[:, 2], np)
    u = u * scale
    v = v * scale
    # 360-degree seam: an image straddling u = +-pi*scale produces a
    # full-circle bbox; unwrap to [0, 2pi) instead (the backward map is
    # periodic in u, so any contiguous branch is valid)
    if kind in ("spherical", "cylindrical") \
            and u.max() - u.min() > np.pi * scale:
        u = np.mod(u, 2 * np.pi * scale)
    tl_x = int(np.floor(u.min()))
    tl_y = int(np.floor(v.min()))
    br_x = int(np.ceil(u.max()))
    br_y = int(np.ceil(v.max()))
    return tl_x, tl_y, br_x - tl_x + 1, br_y - tl_y + 1


def _source_coords(K_adj: jnp.ndarray, R: jnp.ndarray, corner: jnp.ndarray,
                   scale, kind: str, yy: jnp.ndarray, xx: jnp.ndarray,
                   valid_hw: jnp.ndarray):
    """Backward-map (yy, xx) canvas-ROI coordinates to source pixel
    coordinates. Returns (sx, sy, inb)."""
    _, bwd = _PROJ[kind]
    u = (xx + corner[0]) / scale
    v = (yy + corner[1]) / scale
    dx, dy, dz = bwd(u, v, jnp)
    M = mm(K_adj, R.T)                    # k_rinv
    px = M[0, 0] * dx + M[0, 1] * dy + M[0, 2] * dz
    py = M[1, 0] * dx + M[1, 1] * dy + M[1, 2] * dz
    pz = M[2, 0] * dx + M[2, 1] * dy + M[2, 2] * dz
    in_front = pz > 1e-9
    zs = jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
    sx = px / zs
    sy = py / zs
    h = valid_hw[0].astype(jnp.float32)
    w = valid_hw[1].astype(jnp.float32)
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1) & in_front
    return sx, sy, inb


def _bilinear_taps(sx, sy, H: int, W: int):
    x0 = jnp.clip(jnp.floor(sx), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(sy), 0, H - 2).astype(jnp.int32)
    fx = jnp.clip(sx - x0, 0.0, 1.0)
    fy = jnp.clip(sy - y0, 0.0, 1.0)
    return x0, y0, fx, fy


def warp_from_grid(img: jnp.ndarray, K_adj: jnp.ndarray, R: jnp.ndarray,
                   corner: jnp.ndarray, scale, kind: str,
                   yy: jnp.ndarray, xx: jnp.ndarray,
                   valid_hw: jnp.ndarray):
    """Backward-map warp over an arbitrary destination coordinate grid
    (yy, xx are canvas-ROI pixel coordinates). The tiled/spatially-sharded
    render path (parallel.tiled_compose) calls this with each device's
    slab of the canvas grid; warp_backward calls it with the full ROI.

    Sampling is four row-gathers from the flattened image (bit-identical
    to the 2-D advanced-index form)."""
    sx, sy, inb = _source_coords(K_adj, R, corner, scale, kind, yy, xx,
                                 valid_hw)
    H, W = img.shape[:2]
    x0, y0, fx, fy = _bilinear_taps(sx, sy, H, W)
    fx = fx[..., None]
    fy = fy[..., None]
    flat = img.reshape(H * W, img.shape[2])
    lin = (y0 * W + x0).ravel()
    sh = x0.shape + (img.shape[2],)
    v00 = jnp.take(flat, lin, axis=0).reshape(sh)
    v01 = jnp.take(flat, lin + 1, axis=0).reshape(sh)
    v10 = jnp.take(flat, lin + W, axis=0).reshape(sh)
    v11 = jnp.take(flat, lin + W + 1, axis=0).reshape(sh)
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    out = jnp.where(inb[..., None], out, 0.0)
    return out, inb


def _pack_neighbors_u8(img_u8: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) uint8 -> ((H-1)*(W-1), 4) uint32: each row packs the 2x2
    bilinear neighborhood of (y, x) with BGR in the low 24 bits of each
    lane. Bilinear taps are then indexable with ONE gather row per output
    pixel instead of four f32 gathers (bit-exact since uint8 values are
    exact in f32)."""
    v = img_u8.astype(jnp.uint32)
    P = v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16)
    N = jnp.stack([P[:-1, :-1], P[:-1, 1:], P[1:, :-1], P[1:, 1:]], -1)
    return N.reshape(-1, 4)


def _unpack_u8(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([(v & 0xFF), ((v >> 8) & 0xFF),
                      ((v >> 16) & 0xFF)], -1).astype(jnp.float32)


def warp_from_grid_u8(img_u8: jnp.ndarray, K_adj: jnp.ndarray,
                      R: jnp.ndarray, corner: jnp.ndarray, scale,
                      kind: str, yy: jnp.ndarray, xx: jnp.ndarray,
                      valid_hw: jnp.ndarray):
    """warp_from_grid for a uint8 source: the 2x2 neighborhood is packed
    into 4 uint32 lanes so each bilinear sample is one gather row. Up to
    floor-ties at integer source coordinates this matches warp_from_grid
    on img_u8.astype(float32) exactly."""
    sx, sy, inb = _source_coords(K_adj, R, corner, scale, kind, yy, xx,
                                 valid_hw)
    H, W = img_u8.shape[:2]
    x0, y0, fx, fy = _bilinear_taps(sx, sy, H, W)
    N = _pack_neighbors_u8(img_u8)
    g = jnp.take(N, (y0 * (W - 1) + x0).ravel(), axis=0)
    g = g.reshape(x0.shape + (4,))
    v00 = _unpack_u8(g[..., 0])
    v01 = _unpack_u8(g[..., 1])
    v10 = _unpack_u8(g[..., 2])
    v11 = _unpack_u8(g[..., 3])
    fx = fx[..., None]
    fy = fy[..., None]
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    out = jnp.where(inb[..., None], out, 0.0)
    return out, inb


@functools.partial(jax.jit, static_argnames=("kind", "out_h", "out_w"))
def warp_backward(img: jnp.ndarray, K_adj: jnp.ndarray, R: jnp.ndarray,
                  corner: jnp.ndarray, scale,
                  kind: str, out_h: int, out_w: int,
                  valid_hw: jnp.ndarray):
    """Backward-map warp of one image into its padded destination ROI.

    img: (H, W, C) float32 (replicate/zero padded to common shape);
    valid_hw: true (h, w) of the source. Returns (warped (out_h,out_w,C),
    mask (out_h,out_w) bool) — mask not yet eroded.
    """
    yy = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 1)
    return warp_from_grid(img, K_adj, R, corner, scale, kind, yy, xx,
                          valid_hw)


@functools.partial(jax.jit, static_argnames=("kind", "out_h", "out_w",
                                             "erode_iters"))
def warp_backward_batch(imgs, K_adjs, Rs, corners, scale,
                        kind: str, out_h: int, out_w: int,
                        valid_hws, erode_iters: int = 4):
    """All images warped in ONE dispatch (lax.map over the batch), with
    footprint masks eroded on-device."""
    def one(args):
        img, Ka, R, corner, vhw = args
        warped, mask = warp_backward(img, Ka, R, corner, scale, kind,
                                     out_h, out_w, vhw)
        return warped, erode_mask(mask, iters=erode_iters)

    return jax.lax.map(one, (imgs, K_adjs, Rs, corners, valid_hws))


@functools.partial(jax.jit, static_argnames=("iters",))
def erode_mask(mask: jnp.ndarray, iters: int = 4) -> jnp.ndarray:
    """3x3 min-pool erosion, outside-is-black border handling
    (blnd::erode + the 3x cv::erode in get_proj_parameters)."""
    m = mask.astype(jnp.float32)
    H, W = mask.shape[-2], mask.shape[-1]
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = ((yy > 0) & (yy < H - 1) & (xx > 0)
                & (xx < W - 1)).astype(jnp.float32)
    win = (3,) * 2 if mask.ndim == 2 else (1,) * (mask.ndim - 2) + (3, 3)
    for _ in range(iters):
        m = -jax.lax.reduce_window(-m, -1.0, jax.lax.max, win,
                                   (1,) * mask.ndim, "SAME")
        # reduce_window SAME pads with -init (=1 after negation is wrong);
        # force borders to zero like the reference's outside-is-black rule
        m = m * interior
    return m > 0.5


@dataclasses.dataclass
class ProjData:
    """Warped images/masks/corners (proj::proj_data)."""
    imgs: List[np.ndarray]      # (h_i, w_i, 3) float32 per image
    masks: List[np.ndarray]     # (h_i, w_i) bool
    corners: List[Tuple[int, int]]  # (tl_x, tl_y)


def get_proj_parameters(kind: str, scale: float,
                        images: Sequence[np.ndarray],
                        Rs: Sequence[np.ndarray],
                        Ks: Sequence[np.ndarray],
                        connectivity: Sequence[float],
                        get_masks: bool = True) -> ProjData:
    """Warp every connected image (proj::get_proj_parameters,
    _projection.cpp:422-454). Images are BGR uint8 or float; output floats
    keep the input scale."""
    sel = [i for i in range(len(images)) if connectivity[i] > 0]
    rois = {}
    for i in sel:
        h, w = images[i].shape[:2]
        rois[i] = roi_for_image(kind, scale, Rs[i], Ks[i], h, w)
    out_h = max(rois[i][3] for i in sel)
    out_w = max(rois[i][2] for i in sel)
    out_h = (out_h + 7) // 8 * 8
    out_w = (out_w + 127) // 128 * 128
    Hs = max(im.shape[0] for im in images)
    Ws = max(im.shape[1] for im in images)

    n = len(sel)
    imgs_b = np.zeros((n, Hs, Ws, 3), np.float32)
    Ka_b = np.zeros((n, 3, 3), np.float32)
    R_b = np.zeros((n, 3, 3), np.float32)
    c_b = np.zeros((n, 2), np.float32)
    hw_b = np.zeros((n, 2), np.int32)
    for b, i in enumerate(sel):
        im = images[i].astype(np.float32)
        h, w = im.shape[:2]
        imgs_b[b, :h, :w] = im
        Ka_b[b] = adjusted_K(Ks[i], h, w)
        R_b[b] = np.asarray(Rs[i], np.float32)
        c_b[b] = (rois[i][0], rois[i][1])
        hw_b[b] = (h, w)

    warped_b, mask_b = warp_backward_batch(
        jnp.asarray(imgs_b), jnp.asarray(Ka_b), jnp.asarray(R_b),
        jnp.asarray(c_b), float(scale), kind, out_h, out_w,
        jnp.asarray(hw_b), erode_iters=4 if get_masks else 1)
    warped_b = np.asarray(warped_b)
    mask_b = np.asarray(mask_b)

    imgs_out, masks_out, corners = [], [], []
    for b, i in enumerate(sel):
        tlx, tly, rw, rh = rois[i]
        imgs_out.append(warped_b[b, :rh, :rw])
        masks_out.append(mask_b[b, :rh, :rw])
        corners.append((tlx, tly))
    return ProjData(imgs=imgs_out, masks=masks_out, corners=corners)
