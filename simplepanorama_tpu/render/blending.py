"""Blending: none / feathered (distance-transform alpha) / multiband.

Reproduces blnd::{no,simple,multi}_blend (/root/reference/src/math/
_blending.cpp:83-252) on a device canvas. Per-image ROI blocks are padded
to one common shape so every per-image op is a single compiled program;
canvas accumulation uses dynamic_update_slice on a margin-padded canvas
(corners are dynamic, block shapes static).

Deviation: the reference blurs each band with BORDER_REFLECT at the ROI
edge (_blending.cpp:210); here blocks are zero-padded. Color and weight
decay identically at the edge, so the ratio color/alpha that forms the
output is unchanged except at completely unsupported pixels.

All color math runs on the input scale (0..255 float); multiband returns
the same scale (the reference returns [0,1] floats and rescales on
display — one scale conversion fewer here).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.ops.edt import distance_transform
from simplepanorama_tpu.geometry.canvas import get_pan_dimension


def pack_blocks(images: Sequence[np.ndarray],
                masks: Sequence[np.ndarray],
                corners: Sequence[Tuple[int, int]]):
    """Pad per-image ROI blocks to a common shape and compute canvas
    geometry. Returns (imgs (N,Hb,Wb,3), msks (N,Hb,Wb), offs (N,2) [y,x],
    canvas_hw (H,W))."""
    sizes = [im.shape[:2] for im in images]
    d = get_pan_dimension(corners, sizes)
    Hb = max(s[0] for s in sizes)
    Wb = max(s[1] for s in sizes)
    Hb = (Hb + 7) // 8 * 8
    Wb = (Wb + 127) // 128 * 128
    N = len(images)
    imgs = np.zeros((N, Hb, Wb, 3), np.float32)
    msks = np.zeros((N, Hb, Wb), np.float32)
    offs = np.zeros((N, 2), np.int32)
    for i, (im, mk, (tx, ty)) in enumerate(zip(images, masks, corners)):
        h, w = im.shape[:2]
        imgs[i, :h, :w] = im
        msks[i, :h, :w] = np.asarray(mk, np.float32)
        offs[i] = (ty - d.min_y, tx - d.min_x)
    return (jnp.asarray(imgs), jnp.asarray(msks), jnp.asarray(offs),
            (d.height, d.width))


def _acc_add(canvas, block, off):
    """canvas[off[0]:+Hb, off[1]:+Wb] += block (canvas is margin-padded)."""
    sl = jax.lax.dynamic_slice(
        canvas, (off[0], off[1]) + (0,) * (canvas.ndim - 2),
        block.shape)
    return jax.lax.dynamic_update_slice(
        canvas, sl + block, (off[0], off[1]) + (0,) * (canvas.ndim - 2))


@functools.partial(jax.jit, static_argnames=("canvas_hw",))
def no_blend(imgs, msks, offs, canvas_hw):
    """Masked paste in order (blnd::no_blend, _blending.cpp:157-182)."""
    H, W = canvas_hw
    _, Hb, Wb, _ = imgs.shape
    canvas = jnp.zeros((H + Hb, W + Wb, 3), jnp.float32)
    for i in range(imgs.shape[0]):
        m = msks[i][..., None] > 0
        sl = jax.lax.dynamic_slice(canvas, (offs[i, 0], offs[i, 1], 0),
                                   (Hb, Wb, 3))
        sl = jnp.where(m, imgs[i], sl)
        canvas = jax.lax.dynamic_update_slice(
            canvas, sl, (offs[i, 0], offs[i, 1], 0))
    return canvas[:H, :W]


@functools.partial(jax.jit, static_argnames=("canvas_hw",))
def simple_blend(imgs, msks, offs, canvas_hw):
    """Feathering with normalized distance-transform alpha and
    (1 - accumulated alpha) compositing (blnd::simple_blend,
    _blending.cpp:83-153)."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    color = jnp.zeros((H + Hb, W + Wb, 3), jnp.float32)
    alpha = jnp.zeros((H + Hb, W + Wb), jnp.float32)
    for i in range(N):
        dt = distance_transform(msks[i] > 0)
        a = dt / jnp.maximum(jnp.max(dt), 1e-12)
        acc_a = jax.lax.dynamic_slice(alpha, (offs[i, 0], offs[i, 1]),
                                      (Hb, Wb))
        contrib_a = a * (1.0 - acc_a)
        color = _acc_add(color, imgs[i] * contrib_a[..., None], offs[i])
        alpha = jax.lax.dynamic_update_slice(
            alpha, acc_a + contrib_a, (offs[i, 0], offs[i, 1]))
    out = color[:H, :W] / jnp.maximum(alpha[:H, :W, None], 1e-12)
    return jnp.where(alpha[:H, :W, None] > 0, out, 0.0)


def _blur_fixed(x: jnp.ndarray, sigma: float, radius: int) -> jnp.ndarray:
    """Separable Gaussian with a FIXED truncation radius (the reference
    passes a kernel sized from the base sigma while blurring with the
    band sigma, _blending.cpp:189-212 — reproduced)."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    kh = jnp.asarray(k)[None, None, None, :]
    kv = jnp.asarray(k)[None, None, :, None]
    # x: (H, W, C) -> NCHW
    xx = x.transpose(2, 0, 1)[None]
    xx = jax.lax.conv_general_dilated(
        xx, jnp.tile(kh, (x.shape[2], 1, 1, 1)), (1, 1),
        [(0, 0), (radius, radius)], feature_group_count=x.shape[2])
    xx = jax.lax.conv_general_dilated(
        xx, jnp.tile(kv, (x.shape[2], 1, 1, 1)), (1, 1),
        [(radius, radius), (0, 0)], feature_group_count=x.shape[2])
    return xx[0].transpose(1, 2, 0)


def _blur_batch(x: jnp.ndarray, sigma: float, radius: int) -> jnp.ndarray:
    """Separable fixed-radius Gaussian of a whole (N, H, W, C) batch as
    ONE grouped-conv pair (N*C feature groups) — the hardware-shaped form
    of _blur_fixed; 10x faster than per-image dispatches on the chip."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    kh = jnp.asarray(k)[None, None, None, :]
    kv = jnp.asarray(k)[None, None, :, None]
    N, H, W, C = x.shape
    xx = x.transpose(0, 3, 1, 2).reshape(1, N * C, H, W)
    xx = jax.lax.conv_general_dilated(
        xx, jnp.tile(kh, (N * C, 1, 1, 1)), (1, 1),
        [(0, 0), (radius, radius)], feature_group_count=N * C)
    xx = jax.lax.conv_general_dilated(
        xx, jnp.tile(kv, (N * C, 1, 1, 1)), (1, 1),
        [(radius, radius), (0, 0)], feature_group_count=N * C)
    return xx.reshape(N, C, H, W).transpose(0, 2, 3, 1)


def mb_batch_contribution(imgs, seam_msks, orig_msks, bands: int,
                          sigma: float):
    """Per-image multiband (color, alpha) contributions for a whole
    (N, H, W, ·) batch: every band level is ONE grouped conv over the
    4-channel (image, seam) stack — the batched form of the per-image
    band loop in multi_blend (accumulation over images commutes, so
    contributions can be folded into a canvas in any order)."""
    radius = int(np.ceil(3 * sigma))
    src = jnp.concatenate(
        [imgs, (seam_msks[..., None] > 0).astype(jnp.float32)], -1)
    sigmas = [float(np.sqrt(2 * (bands - i) + 1) * sigma)
              for i in range(bands)]
    blurred = {s: _blur_batch(src, s, radius) for s in set(sigmas)}
    color = jnp.zeros_like(imgs)
    alpha = jnp.zeros(imgs.shape[:3], jnp.float32)
    for i in range(bands):
        sb = sigmas[i]
        if i == bands - 1:
            band = imgs - blurred[sb][..., :3]
        elif i > 0:
            band = blurred[sb][..., :3] - blurred[sigmas[i + 1]][..., :3]
        else:
            band = blurred[sb][..., :3]
        w = jnp.where(orig_msks > 0, blurred[sb][..., 3], 0.0)
        color = color + band * w[..., None]
        alpha = alpha + w
    return color, alpha


@functools.partial(jax.jit, static_argnames=("canvas_hw", "bands", "sigma"))
def multi_blend(imgs, seam_msks, orig_msks, offs, canvas_hw,
                bands: int = 2, sigma: float = 7.0):
    """Multiband blending (blnd::multi_blend, _blending.cpp:186-252):
    ``bands`` Gaussian levels with sigma_band = sqrt(2(bands-i)+1)*sigma,
    per-band weights = blurred seam masks zeroed outside the original
    footprint, accumulated color/alpha on the canvas.

    Images and seam masks are stacked into one 4-channel batch so every
    band level is a single grouped conv over all images (bit-identical to
    the per-image formulation, validated against the cv2 oracle in
    tests/test_render_oracles.py)."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    radius = int(np.ceil(3 * sigma))
    color = jnp.zeros((H + Hb, W + Wb, 3), jnp.float32)
    alpha = jnp.zeros((H + Hb, W + Wb), jnp.float32)

    src = jnp.concatenate(
        [imgs, (seam_msks[..., None] > 0).astype(jnp.float32)], -1)
    sigmas = [float(np.sqrt(2 * (bands - i) + 1) * sigma)
              for i in range(bands)]
    blurred = {s: _blur_batch(src, s, radius) for s in set(sigmas)}

    for i in range(bands):
        sb = sigmas[i]
        if i == bands - 1:
            band = imgs - blurred[sb][..., :3]
        elif i > 0:
            band = blurred[sb][..., :3] - blurred[sigmas[i + 1]][..., :3]
        else:
            band = blurred[sb][..., :3]
        w = jnp.where(orig_msks > 0, blurred[sb][..., 3], 0.0)
        for j in range(N):
            color = _acc_add(color, band[j] * w[j][..., None], offs[j])
            alpha = _acc_add(alpha, w[j], offs[j])

    out = color[:H, :W] / jnp.maximum(alpha[:H, :W, None], 1e-12)
    # reference divides by 255/bands to land in [0,1]; we keep 0..255:
    out = out * bands
    return jnp.where(alpha[:H, :W, None] > 0, out, 0.0)


def blend(method: str,
          images: Sequence[np.ndarray],
          seam_masks: Sequence[np.ndarray],
          orig_masks: Sequence[np.ndarray],
          corners: Sequence[Tuple[int, int]],
          bands: int = 2, sigma: float = 7.0) -> np.ndarray:
    """Dispatch like stitch_parameters::get_preview. Returns float32
    (H, W, 3) on the 0..255 scale."""
    imgs, seams, offs, hw = pack_blocks(images, seam_masks, corners)
    if method == "NO_BLEND":
        return np.asarray(no_blend(imgs, seams, offs, hw))
    if method == "SIMPLE_BLEND":
        return np.asarray(simple_blend(imgs, seams, offs, hw))
    if method == "MULTI_BLEND":
        _, origs, _, _ = pack_blocks(
            [np.zeros_like(im) for im in images], orig_masks, corners)
        return np.asarray(multi_blend(imgs, seams, origs, offs, hw,
                                      bands=bands, sigma=float(sigma)))
    raise ValueError(f"unknown blend method {method}")
