"""Fixed-shape convex-polygon math for overlap-aware match verification.

The reference verifies each pair by intersecting the (centered) image-1 rect
with the H-projected image-2 rect and counting keypoints/matches inside
(keypoints_in_overlap_centered, /root/reference/src/math/_homography.cpp:
448-500, using cv::intersectConvexConvex + cv::pointPolygonTest).

Device version: the clip region is an axis-aligned rect, so the intersection is
a Sutherland–Hodgman clip of the projected quad by 4 half-planes with a
static vertex buffer (quad ∩ rect has at most 8 vertices), and the point
counts need no polygon at all — a point is inside the intersection iff it is
inside the rect AND inside the quad. Everything vmaps over pairs.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_CAP = 8  # max vertices of quad ∩ rect


def _clip_halfplane(pts: jnp.ndarray, n: jnp.ndarray,
                    sign: float, axis: int, bound: jnp.ndarray):
    """One Sutherland–Hodgman pass: keep sign*(coord - bound) <= 0.

    pts: (_CAP, 2) vertex buffer, n: scalar count. Returns new (pts, n).
    """
    def dist(p):
        return sign * (p[axis] - bound)

    def body(i, state):
        out, m = state
        cur = pts[i % _CAP]
        nxt = pts[(i + 1) % jnp.maximum(n, 1)]
        dc = dist(cur)
        dn = dist(nxt)
        inside_c = dc <= 0
        inside_n = dn <= 0
        t = dc / jnp.where(jnp.abs(dc - dn) < 1e-12, 1e-12, dc - dn)
        inter = cur + t * (nxt - cur)

        # emit cur if inside; emit intersection if the edge crosses
        def emit(out, m, p, cond):
            out = jnp.where(cond, out.at[m % _CAP].set(p), out)
            m = jnp.where(cond, m + 1, m)
            return out, m

        valid_i = i < n
        out, m = emit(out, m, cur, valid_i & inside_c)
        out, m = emit(out, m, inter, valid_i & (inside_c != inside_n))
        return out, m

    out0 = jnp.zeros_like(pts)
    out, m = jax.lax.fori_loop(0, _CAP, body, (out0, jnp.array(0)))
    return out, jnp.minimum(m, _CAP)


def quad_rect_intersection_area(quad: jnp.ndarray, half_w: jnp.ndarray,
                                half_h: jnp.ndarray) -> jnp.ndarray:
    """Area of quad ∩ [-half_w, half_w] x [-half_h, half_h]."""
    pts = jnp.zeros((_CAP, 2)).at[:4].set(quad)
    n = jnp.array(4)
    pts, n = _clip_halfplane(pts, n, -1.0, 0, -half_w)  # x >= -half_w
    pts, n = _clip_halfplane(pts, n, 1.0, 0, half_w)    # x <= half_w
    pts, n = _clip_halfplane(pts, n, -1.0, 1, -half_h)
    pts, n = _clip_halfplane(pts, n, 1.0, 1, half_h)

    idx = jnp.arange(_CAP)
    mask = idx < n
    x = jnp.where(mask, pts[:, 0], 0.0)
    y = jnp.where(mask, pts[:, 1], 0.0)
    nxt = (idx + 1) % jnp.maximum(n, 1)
    xs = x[nxt]
    ys = y[nxt]
    terms = jnp.where(mask, x * ys - xs * y, 0.0)
    return 0.5 * jnp.abs(jnp.sum(terms))


def points_in_quad(pts: jnp.ndarray, quad: jnp.ndarray) -> jnp.ndarray:
    """Inside-or-on-edge test for (M, 2) points vs. a convex quad (4, 2)."""
    nxt = jnp.roll(jnp.arange(4), -1)
    e = quad[nxt] - quad                     # (4, 2) edges
    # orientation of the quad via shoelace sign
    orient = jnp.sign(jnp.sum(quad[:, 0] * quad[nxt, 1]
                              - quad[nxt, 0] * quad[:, 1]))
    orient = jnp.where(orient == 0, 1.0, orient)
    d = pts[:, None, :] - quad[None, :, :]   # (M, 4, 2)
    cross = e[None, :, 0] * d[:, :, 1] - e[None, :, 1] * d[:, :, 0]
    return jnp.all(orient * cross >= 0, axis=1)


def overlap_stats(H: jnp.ndarray,
                  img1_hw: jnp.ndarray, img2_hw: jnp.ndarray,
                  kp1: jnp.ndarray, kp1_valid: jnp.ndarray,
                  match_q: jnp.ndarray, match_valid: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Overlap stats in image-1's centered frame.

    H maps image-2 (train) coords into image-1. Returns
    (overlap_fraction_of_img1, n_keypoints_in_overlap, n_matches_in_overlap)
    matching keypoints_in_overlap_centered.
    """
    h1, w1 = img1_hw[0].astype(jnp.float32), img1_hw[1].astype(jnp.float32)
    h2, w2 = img2_hw[0].astype(jnp.float32), img2_hw[1].astype(jnp.float32)
    rect2 = jnp.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    rect2 = rect2 * jnp.stack([w2 / 2, h2 / 2])
    # project image-2 rect into image-1
    x = rect2[:, 0] * H[0, 0] + rect2[:, 1] * H[0, 1] + H[0, 2]
    y = rect2[:, 0] * H[1, 0] + rect2[:, 1] * H[1, 1] + H[1, 2]
    w = rect2[:, 0] * H[2, 0] + rect2[:, 1] * H[2, 1] + H[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    quad = jnp.stack([x / w, y / w], axis=1)

    area = quad_rect_intersection_area(quad, w1 / 2, h1 / 2)
    overlap_frac = area / (w1 * h1)

    in_rect = lambda p: ((jnp.abs(p[:, 0]) <= w1 / 2)
                         & (jnp.abs(p[:, 1]) <= h1 / 2))
    kp_in = points_in_quad(kp1, quad) & in_rect(kp1) & kp1_valid
    m_in = points_in_quad(match_q, quad) & in_rect(match_q) & match_valid
    return overlap_frac, jnp.sum(kp_in), jnp.sum(m_in)
