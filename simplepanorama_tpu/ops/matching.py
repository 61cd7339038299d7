"""Descriptor matching on the device: all-pairs 2-NN + Lowe ratio test.

The reference matches each image pair with FLANN 2-NN + ratio 0.8
(util::match_keypoints, /root/reference/src/math/_homography.cpp:416-444),
threaded over (i, j) pairs. Here the descriptor distance computation is a
batched matmul: rootSIFT descriptors are unit-L2 so
``dist^2 = 2 - 2 * dot``, and the 2-NN reduces to a top-2 over dot products.
Pairs are processed in fixed-size batches; everything is padded + masked.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

RATIO_THRESH = 0.8  # Lowe ratio (match_keypoints, _homography.cpp:430)


@functools.partial(jax.jit, static_argnames=("match_cap",))
def match_pair_batch(desc_q: jnp.ndarray,
                     desc_t: jnp.ndarray,
                     valid_q: jnp.ndarray,
                     valid_t: jnp.ndarray,
                     match_cap: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """2-NN ratio matching for a batch of image pairs.

    desc_q/desc_t: (B, K, 128) float32 rootSIFT (unit L2 norm).
    valid_q/valid_t: (B, K) bool.

    Returns:
      match_idx: (B, match_cap, 2) int32 — (queryIdx, trainIdx), compacted
                 to the front, padded with -1.
      match_valid: (B, match_cap) bool.
      n_matches: (B,) int32 raw ratio-test match counts (the pass-1
                 adjacency numbers, get_match_number_matrix,
                 _homography.cpp:663-697).
    """
    B, K, _ = desc_q.shape

    # dot products; invalid train cols -> -inf so top-2 skips them
    dots = jnp.einsum("bqd,btd->bqt", desc_q, desc_t,
                      preferred_element_type=jnp.float32)
    dots = jnp.where(valid_t[:, None, :], dots, -jnp.inf)

    # top-2 as two max/argmax passes, which fuse into reductions where
    # lax.top_k may lower to a per-row sort
    best = jnp.max(dots, axis=2)
    best_idx = jnp.argmax(dots, axis=2)
    t_iota = jax.lax.broadcasted_iota(jnp.int32, dots.shape, 2)
    second = jnp.max(jnp.where(t_iota == best_idx[..., None], -jnp.inf,
                               dots), axis=2)
    # unit-norm descriptors: d = sqrt(2 - 2 dot)
    d0 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * best, 0.0))
    d1 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * second, 0.0))
    ok = (d0 < RATIO_THRESH * d1) & valid_q
    # need at least 2 valid train descriptors for a meaningful ratio
    ok = ok & (jnp.sum(valid_t, axis=1) >= 2)[:, None]

    n_matches = jnp.sum(ok, axis=1).astype(jnp.int32)

    # compact passing queries to the front (stable order by query index)
    order = jnp.argsort(~ok, axis=1, stable=True)    # passing first
    order = order[:, :match_cap]                      # (B, match_cap)
    sel_ok = jnp.take_along_axis(ok, order, axis=1)
    q_idx = jnp.where(sel_ok, order, -1).astype(jnp.int32)
    t_idx = jnp.take_along_axis(best_idx, order, axis=1)
    t_idx = jnp.where(sel_ok, t_idx, -1).astype(jnp.int32)
    match_idx = jnp.stack([q_idx, t_idx], axis=-1)
    return match_idx, sel_ok, n_matches


def gather_match_coords(kp_xy_q: jnp.ndarray, kp_xy_t: jnp.ndarray,
                        match_idx: jnp.ndarray,
                        match_valid: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather (B, M, 2) query/train coordinates for compacted matches."""
    q = jnp.take_along_axis(
        kp_xy_q, jnp.maximum(match_idx[..., 0:1], 0), axis=1)
    t = jnp.take_along_axis(
        kp_xy_t, jnp.maximum(match_idx[..., 1:2], 0), axis=1)
    q = jnp.where(match_valid[..., None], q, 0.0)
    t = jnp.where(match_valid[..., None], t, 0.0)
    return q, t
