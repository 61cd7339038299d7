"""Homography estimation on the device: normalized DLT + batched-hypothesis RANSAC.

The reference runs 1500 sequential RANSAC rounds per image pair
(util::find_homography, /root/reference/src/math/_homography.cpp:8-68).
Here all hypotheses are evaluated at once: sampling, the 4-point DLT solve,
inlier scoring and the sanity predicates are vmapped over a (n_iter,) batch,
and the reference's sequential accept rule ("keep H only when the loss
strictly improves the running best AND sanity passes",
_homography.cpp:51-62) is reproduced exactly with an exclusive prefix-min
scan over hypothesis losses.

All shapes are static: matches are padded to a capacity with a validity mask.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from simplepanorama_tpu.geometry.rotation import mm


def apply_h(H: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Perspective-transform (..., 2) points by 3x3 H (dehomogenized)."""
    x = pts[..., 0] * H[0, 0] + pts[..., 1] * H[0, 1] + H[0, 2]
    y = pts[..., 0] * H[1, 0] + pts[..., 1] * H[1, 1] + H[1, 2]
    w = pts[..., 0] * H[2, 0] + pts[..., 1] * H[2, 1] + H[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return jnp.stack([x / w, y / w], axis=-1)


def normalize_2d(pts: jnp.ndarray) -> jnp.ndarray:
    """Conditioning matrix: translate by the mean, scale per-axis by the mean
    absolute deviation (util::Normalize2D, _homography.cpp:144-168)."""
    tr = jnp.mean(pts, axis=0)
    sc = jnp.mean(jnp.abs(pts - tr), axis=0)
    sc = jnp.maximum(sc, 1e-8)
    return jnp.array([
        [1.0 / sc[0], 0.0, -tr[0] / sc[0]],
        [0.0, 1.0 / sc[1], -tr[1] / sc[1]],
        [0.0, 0.0, 1.0],
    ])


def _cholesky_solve_unrolled(A: jnp.ndarray, b: jnp.ndarray,
                             n: int = 8) -> jnp.ndarray:
    """Solve SPD A x = b by a fully unrolled scalar Cholesky.

    Written in scalar form on purpose: under vmap every operation
    becomes a fused elementwise op over the hypothesis batch.
    The batched-LU `jnp.linalg.solve` this replaces lowers to a
    serialized panel loop with dynamic slicing — measured as the
    dominant cost of the whole RANSAC verify kernel (48k tiny solves
    per pair chunk)."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(jnp.maximum(d, 1e-20))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _similarity_inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of the conditioning matrix
    [[a,0,c],[0,d,e],[0,0,1]] (normalize_2d's shape)."""
    a, c, d, e = T[0, 0], T[0, 2], T[1, 1], T[1, 2]
    ia = 1.0 / a
    id_ = 1.0 / d
    z = jnp.zeros(())
    o = jnp.ones(())
    return jnp.stack([
        jnp.stack([ia, z, -c * ia]),
        jnp.stack([z, id_, -e * id_]),
        jnp.stack([z, z, o])])


def dlt_homography(query: jnp.ndarray, train: jnp.ndarray) -> jnp.ndarray:
    """Normalized DLT from >=4 correspondences: H maps train -> query.

    Conditioning makes H' close to a similarity, so its (2,2) entry is
    generically nonzero; we pin h'_22 = 1 and solve the inhomogeneous
    2n x 8 system by normal equations (8x8 unrolled Cholesky — every op
    elementwise over the vmapped hypothesis batch, and much better f32
    conditioning than an eigendecomposition of A^T A). Exact for the
    4-point minimal sample; least-squares for n > 4. Then decondition
    H = T_q^-1 H' T_t (decondition_homography2D, _homography.cpp:71-77).
    """
    Tq = normalize_2d(query)
    Tt = normalize_2d(train)
    q = apply_h(Tq, query)
    t = apply_h(Tt, train)

    n = query.shape[0]
    ones = jnp.ones((n,))
    zeros = jnp.zeros((n,))
    # unknowns h = (h00..h21); rows for x: A_x h = q0, with
    # A_x = [t0, t1, 1, 0, 0, 0, -q0 t0, -q0 t1]
    rx = jnp.stack([t[:, 0], t[:, 1], ones, zeros, zeros, zeros,
                    -q[:, 0] * t[:, 0], -q[:, 0] * t[:, 1]], axis=1)
    ry = jnp.stack([zeros, zeros, zeros, t[:, 0], t[:, 1], ones,
                    -q[:, 1] * t[:, 0], -q[:, 1] * t[:, 1]], axis=1)
    A = jnp.concatenate([rx, ry], axis=0)          # (2n, 8)
    b = jnp.concatenate([q[:, 0], q[:, 1]], axis=0)  # (2n,)
    AtA = mm(A.T, A) + 1e-12 * jnp.eye(8)
    h8 = _cholesky_solve_unrolled(AtA, mm(A.T, b), 8)
    Hc = jnp.concatenate([h8, jnp.ones((1,))]).reshape(3, 3)
    H = mm(_similarity_inv(Tq), Hc, Tt)
    return H


def hom_sanity(H: jnp.ndarray, img1_hw: jnp.ndarray,
               img2_hw: jnp.ndarray) -> jnp.ndarray:
    """Vectorizable sanity predicate (util::hom_sanity,
    _homography.cpp:268-329): finite entries, non-reflecting (2x2 det > 0),
    bounded perspective terms (H20/H21 <= .003, one-sided as in the
    reference), convex projected image-1 quad, area >= |img1|/200, projected
    corners within 8000x image-2 scale."""
    h1, w1 = img1_hw[0], img1_hw[1]
    h2, w2 = img2_hw[0], img2_hw[1]
    finite = jnp.all(jnp.isfinite(H))
    det2 = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]
    non_reflect = det2 > 0
    skew_ok = (H[2, 0] <= 0.003) & (H[2, 1] <= 0.003)

    corners = jnp.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    corners = corners * jnp.stack([w1, h1]).astype(jnp.float32)
    x = corners[:, 0] * H[0, 0] + corners[:, 1] * H[0, 1] + H[0, 2]
    y = corners[:, 0] * H[1, 0] + corners[:, 1] * H[1, 1] + H[1, 2]
    w = corners[:, 0] * H[2, 0] + corners[:, 1] * H[2, 1] + H[2, 2]
    w_ok = jnp.all(jnp.abs(w) >= 1e-6)
    w_safe = jnp.where(jnp.abs(w) < 1e-6, 1e-6, w)
    px = x / w_safe
    py = y / w_safe

    # convexity: consecutive-edge cross products share a sign
    nxt = jnp.roll(jnp.arange(4), -1)
    ex = px[nxt] - px
    ey = py[nxt] - py
    cross = ex * ey[nxt] - ey * ex[nxt]
    convex = jnp.all(cross >= 0) | jnp.all(cross <= 0)

    # shoelace area
    area = 0.5 * jnp.abs(jnp.sum(px * py[nxt] - px[nxt] * py))
    area_ok = area >= (w1 * h1).astype(jnp.float32) / 200.0

    inf_ok = jnp.all((jnp.abs(px) <= 8000.0 * w2.astype(jnp.float32))
                     & (jnp.abs(py) <= 8000.0 * h2.astype(jnp.float32)))

    return finite & non_reflect & skew_ok & w_ok & convex & area_ok & inf_ok


@functools.partial(jax.jit, static_argnames=("n_iter",))
def ransac_homography(query: jnp.ndarray,
                      train: jnp.ndarray,
                      valid: jnp.ndarray,
                      img1_hw: jnp.ndarray,
                      img2_hw: jnp.ndarray,
                      key: jax.Array,
                      n_iter: int = 1500,
                      margin: float = 4.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched-hypothesis RANSAC. H maps train -> query.

    query/train: (M, 2) padded match coords (center-origin), valid: (M,) bool.
    Returns (H (3,3), inlier_mask (M,)). Identity if nothing accepted,
    matching find_homography's fallback (_homography.cpp:10-13).
    """
    M = query.shape[0]
    # sample 4 distinct valid indices per hypothesis: top-4 of masked
    # uniforms, taken as 4 successive argmax passes — bit-identical to
    # lax.top_k (same descending order, same first-occurrence ties) with
    # no per-row sort
    gumbel = jax.random.uniform(key, (n_iter, M))
    gumbel = jnp.where(valid[None, :], gumbel, -jnp.inf)
    iota = jax.lax.broadcasted_iota(jnp.int32, (n_iter, M), 1)
    picks = []
    for _ in range(4):
        a = jnp.argmax(gumbel, axis=1)
        picks.append(a)
        gumbel = jnp.where(iota == a[:, None], -jnp.inf, gumbel)
    sample_idx = jnp.stack(picks, axis=1)     # (n_iter, 4)

    q4 = query[sample_idx]   # (n_iter, 4, 2)
    t4 = train[sample_idx]

    Hs = jax.vmap(dlt_homography)(q4, t4)     # (n_iter, 3, 3)

    # inlier-fraction loss at the margin (homography_loss,
    # _homography.cpp:244-265): loss = 1 - inliers/valid_count
    def loss_of(H):
        pred = apply_h(H, train)
        d = jnp.linalg.norm(pred - query, axis=-1)
        inl = (d < margin) & valid
        return 1.0 - jnp.sum(inl) / jnp.maximum(jnp.sum(valid), 1)

    losses = jax.vmap(loss_of)(Hs)            # (n_iter,)
    sane = jax.vmap(lambda H: hom_sanity(H, img1_hw, img2_hw))(Hs)

    # sequential accept rule: improve strictly on the running-min loss AND be
    # sane; the running min updates on improvement regardless of sanity.
    eye_loss = loss_of(jnp.eye(3))
    prefix = jax.lax.associative_scan(jnp.minimum, losses)
    prev_best = jnp.concatenate([jnp.array([eye_loss]), prefix[:-1]])
    prev_best = jnp.minimum(prev_best, eye_loss)
    accepted = (losses < prev_best) & sane
    idx = jnp.arange(n_iter)
    last_accept = jnp.max(jnp.where(accepted, idx, -1))
    H_best = jnp.where(last_accept >= 0, Hs[jnp.maximum(last_accept, 0)],
                       jnp.eye(3))

    pred = apply_h(H_best, train)
    d = jnp.linalg.norm(pred - query, axis=-1)
    inliers = (d <= margin) & valid
    return H_best, inliers


def inlier_distances(H: jnp.ndarray, query: jnp.ndarray, train: jnp.ndarray,
                     valid: jnp.ndarray) -> jnp.ndarray:
    """Reprojection distances |q - H t| with +inf on padding."""
    pred = apply_h(H, train)
    d = jnp.linalg.norm(pred - query, axis=-1)
    return jnp.where(valid, d, jnp.inf)
