"""Flat-plane (projective) rendering: generic homography warps, the legacy
pairwise stitch, and the BA-free chained-homography panorama.

Capability mirror of imgm::applyGeometricTransform (generic inverse-map
remap template, /root/reference/src/math/_img_manipulation.h:58-83),
imgm::stitch (legacy pairwise stitch, _img_manipulation.cpp:178-212), and
the flat-panorama use of imgm::calc_stitch_from_adj / pan_img_transform
(_img_manipulation.cpp:281-390) — the projective composite the reference
builds before bundle adjustment replaces it with rotations.

Design: the warp is one jitted backward-map gather per destination ROI
(bilinear, fixed output shape); compositing pastes in chain order.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.geometry.canvas import (
    PanImgTransform, apply_h_np, get_translation)


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def warp_perspective(img: jnp.ndarray, H_inv: jnp.ndarray,
                     out_h: int, out_w: int):
    """Inverse-map homography warp (applyGeometricTransform): for every
    destination pixel, sample the source at H_inv @ (x, y, 1) with bilinear
    interpolation. Returns (warped (out_h,out_w,C) f32, mask bool)."""
    yy = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 1)
    px = H_inv[0, 0] * xx + H_inv[0, 1] * yy + H_inv[0, 2]
    py = H_inv[1, 0] * xx + H_inv[1, 1] * yy + H_inv[1, 2]
    pz = H_inv[2, 0] * xx + H_inv[2, 1] * yy + H_inv[2, 2]
    zs = jnp.where(jnp.abs(pz) < 1e-12, 1e-12, pz)
    sx = px / zs
    sy = py / zs
    Hs, Ws = img.shape[:2]
    inb = (sx >= 0) & (sx <= Ws - 1) & (sy >= 0) & (sy <= Hs - 1) & (pz > 0)
    x0 = jnp.clip(jnp.floor(sx), 0, Ws - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(sy), 0, Hs - 2).astype(jnp.int32)
    fx = jnp.clip(sx - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(sy - y0, 0.0, 1.0)[..., None]
    out = ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
           + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)
    return jnp.where(inb[..., None], out, 0.0), inb


def pairwise_stitch(base: np.ndarray, attach: np.ndarray,
                    H: np.ndarray) -> np.ndarray:
    """Legacy two-image stitch (imgm::stitch): warp ``attach`` by H into
    the base plane, allocate the union canvas, paste base on top where it
    has content. ``H`` maps attach coordinates into base coordinates."""
    T, xs, xe, ys, ye = get_translation(base.shape[:2], attach.shape[:2],
                                        np.asarray(H, np.float64))
    out_w = int(xe - xs + 1)
    out_h = int(ye - ys + 1)
    TH = T @ np.asarray(H, np.float64)
    warped, _ = warp_perspective(
        jnp.asarray(attach.astype(np.float32)),
        jnp.asarray(np.linalg.inv(TH).astype(np.float32)), out_h, out_w)
    pano = np.array(warped)
    bx, by = int(-xs), int(-ys)
    bh, bw = base.shape[:2]
    roi = pano[by:by + bh, bx:bx + bw]
    basef = base.astype(np.float32)
    nz = basef.sum(axis=-1, keepdims=True) > 0
    pano[by:by + bh, bx:bx + bw] = np.where(nz, basef, roi)
    return np.clip(pano, 0, 255).astype(np.uint8)


def render_flat(transform: PanImgTransform,
                images: Sequence[np.ndarray]) -> np.ndarray:
    """Composite the chained-homography flat panorama (the reference's
    pre-BA projective layout): each image is warped by its img_to_pan
    chain onto the shared canvas; pixels paste in BFS-chain order with the
    first (reference) image winning where footprints overlap."""
    ph, pw = transform.pan_hw
    if ph <= 0 or pw <= 0:
        raise RuntimeError("Flat panorama dimensions out of range")
    acc = np.zeros((ph, pw, 3), np.float32)
    filled = np.zeros((ph, pw), bool)
    order = np.argsort(-np.asarray(transform.connectivity))
    for i in order:
        if transform.connectivity[i] <= 0 and i != transform.center:
            continue
        Hinv = np.linalg.inv(transform.img_to_pan[i])
        warped, mask = warp_perspective(
            jnp.asarray(images[i].astype(np.float32)),
            jnp.asarray(Hinv.astype(np.float32)), ph, pw)
        warped = np.asarray(warped)
        mask = np.asarray(mask) & ~filled
        acc[mask] = warped[mask]
        filled |= mask
    return np.clip(acc, 0, 255).astype(np.uint8)
