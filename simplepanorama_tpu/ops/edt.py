"""Euclidean distance transform on the device via jump flooding.

The reference uses cv::distanceTransform(DIST_L2, DIST_MASK_5) — a 5x5
chamfer *approximation* (e.g. /root/reference/src/math/_distance_cut.cpp:62,
_blending.cpp:107). The data-parallel replacement is the jump-flooding
algorithm (JFA): O(log n) data-parallel passes, each a 9-way gather; its
rare sub-pixel errors are smaller than the chamfer approximation the
reference accepts. Every pass is pure elementwise/roll work.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

_BIG = 1e10


@functools.partial(jax.jit, static_argnames=())
def distance_transform(mask: jnp.ndarray) -> jnp.ndarray:
    """L2 distance of each nonzero pixel to the nearest zero pixel.

    mask: (H, W) bool or numeric (nonzero = foreground). Returns (H, W)
    float32 distances (0 on background), like cv::distanceTransform.
    """
    H, W = mask.shape
    fg = mask.astype(jnp.bool_)
    yy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    # nearest-seed coordinates; seeds are background pixels
    seed_y = jnp.where(fg, _BIG, yy)
    seed_x = jnp.where(fg, _BIG, xx)

    def dist2(sy, sx):
        return (sy - yy) ** 2 + (sx - xx) ** 2

    n_steps = max(1, int(math.ceil(math.log2(max(H, W)))))
    step = 1 << (n_steps - 1)

    sy, sx = seed_y, seed_x
    for _ in range(n_steps + 1):
        best = dist2(sy, sx)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cy = jnp.roll(sy, (dy, dx), axis=(0, 1))
                cx = jnp.roll(sx, (dy, dx), axis=(0, 1))
                d = dist2(cy, cx)
                take = d < best
                sy = jnp.where(take, cy, sy)
                sx = jnp.where(take, cx, sx)
                best = jnp.where(take, d, best)
        step = max(1, step // 2)

    return jnp.where(fg, jnp.sqrt(best), 0.0).astype(jnp.float32)
