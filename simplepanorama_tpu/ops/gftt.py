"""GFTT (Shi-Tomasi) corner detection on the device.

Capability mirror of the reference's alternative detector path
util::extract_keypoints_detGFTT_descSIFT (/root/reference/src/math/
_homography.cpp:754-792, kept but unused there): goodFeaturesToTrack
corners + SIFT descriptors. The detector is the classic structure-tensor
minimum eigenvalue with quality-level thresholding and non-maximum
suppression — here as reduce_window + top_k (fixed shapes), with
min-distance enforced by a max-pool NMS window.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.ops.sift import (
    _blur, _descriptor, _orientation, grad_stack, SiftFeatures)


def _sobel(img: jnp.ndarray):
    kx = jnp.asarray(np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                              np.float32))
    x = img[None, None]
    pad = [(1, 1), (1, 1)]
    gx = jax.lax.conv_general_dilated(x, kx[None, None], (1, 1), pad)[0, 0]
    gy = jax.lax.conv_general_dilated(x, kx.T[None, None], (1, 1), pad)[0, 0]
    return gx, gy


@functools.partial(jax.jit, static_argnames=("max_corners", "block_size",
                                             "min_distance", "use_harris"))
def gftt_detect(img_gray: jnp.ndarray, valid_hw: jnp.ndarray,
                max_corners: int = 1024, quality_level: float = 0.01,
                min_distance: int = 8, block_size: int = 3,
                use_harris: bool = False, harris_k: float = 0.04
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Corner positions by Shi-Tomasi min-eigenvalue (or Harris) response.

    Returns (xy (K, 2), response (K,), valid (K,)).
    """
    gx, gy = _sobel(img_gray)
    # structure tensor, box-summed over block_size
    w = jnp.ones((1, 1, block_size, block_size), jnp.float32)

    def box(a):
        return jax.lax.conv_general_dilated(
            a[None, None], w, (1, 1), "SAME")[0, 0]

    axx = box(gx * gx)
    ayy = box(gy * gy)
    axy = box(gx * gy)
    if use_harris:
        resp = (axx * ayy - axy * axy) - harris_k * (axx + ayy) ** 2
    else:
        # min eigenvalue of [[axx, axy], [axy, ayy]]
        tr = 0.5 * (axx + ayy)
        det = axx * ayy - axy * axy
        resp = tr - jnp.sqrt(jnp.maximum(tr * tr - det, 0.0))

    H, W = img_gray.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    vh = valid_hw[0]
    vw = valid_hw[1]
    inb = (xx >= 4) & (xx < vw - 4) & (yy >= 4) & (yy < vh - 4)
    resp = jnp.where(inb, resp, 0.0)

    # NMS over the min-distance window + quality-level threshold
    k = 2 * min_distance + 1
    mx = jax.lax.reduce_window(resp, -jnp.inf, jax.lax.max, (k, k), (1, 1),
                               "SAME")
    peak = (resp >= mx) & (resp >= quality_level * jnp.max(resp))
    score = jnp.where(peak, resp, 0.0).reshape(-1)
    vals, idx = jax.lax.top_k(score, max_corners)
    xs = (idx % W).astype(jnp.float32)
    ys = (idx // W).astype(jnp.float32)
    return jnp.stack([xs, ys], -1), vals, vals > 0


@functools.partial(jax.jit, static_argnames=("max_corners",))
def gftt_sift(img_gray: jnp.ndarray, valid_hw: jnp.ndarray,
              max_corners: int = 1024, patch_scale: float = 3.0
              ) -> SiftFeatures:
    """GFTT corners with SIFT descriptors at a fixed patch scale
    (the alt path computes SIFT descriptors on size-less keypoints)."""
    xy, resp, valid = gftt_detect(img_gray, valid_hw,
                                  max_corners=max_corners)
    H, W = img_gray.shape
    # single-level "pyramid": dense bf16 gradient buffer (see grad_stack)
    flat = grad_stack(_blur(img_gray, 1.0)).reshape(-1, 4)
    zeros = jnp.zeros_like(xy[:, 0], jnp.int32)

    def per_kp(x, y, l):
        pyr = (flat, 0, H, W)
        so = jnp.asarray(patch_scale, jnp.float32)
        a = _orientation(pyr, l, y, x, so)
        d = _descriptor(pyr, l, y, x, so, a)
        return d

    desc = jax.vmap(per_kp)(xy[:, 0], xy[:, 1], zeros)
    l1 = jnp.sum(jnp.abs(desc), axis=1, keepdims=True)
    desc = jnp.sqrt(desc / jnp.maximum(l1, 1e-12))
    desc = jnp.where(valid[:, None], desc, 0.0)
    return SiftFeatures(xy=jnp.where(valid[:, None], xy, 0.0),
                        size=jnp.full_like(resp, patch_scale * 2),
                        response=jnp.where(valid, resp, 0.0),
                        desc=desc, valid=valid)
