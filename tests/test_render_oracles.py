"""Direct oracle tests for the compositing layer: each device kernel is
compared against an independent NumPy/OpenCV port of the reference's own
math (the compositing layer was previously tested only
transitively through one e2e NCC gate).

Oracles are ports of:
  * blnd::multi_blend            /root/reference/src/math/_blending.cpp:186-252
  * gain::gain_compensation      /root/reference/src/math/_gain_compensation.cpp
  * test::equalizeIntensities    /root/reference/src/test/_test.cpp:9-106
  * cv::detail::SphericalWarper  (via cv2.PyRotationWarper, the exact
    component proj::spherical_proj wraps, _projection.cpp:27-84)
"""

import numpy as np
import pytest

import jax.numpy as jnp


def _rng_blocks(rng, n=2, Hb=64, Wb=128):
    """Smooth random images on one shared canvas-sized block per image."""
    imgs = np.zeros((n, Hb, Wb, 3), np.float32)
    masks = np.zeros((n, Hb, Wb), np.float32)
    import cv2
    for i in range(n):
        base = rng.uniform(40, 220, (Hb // 8, Wb // 8, 3)).astype(np.float32)
        imgs[i] = cv2.resize(base, (Wb, Hb), interpolation=cv2.INTER_CUBIC)
    # overlapping rectangular footprints inside the shared ROI
    masks[0, 4:Hb - 4, 4:Wb // 2 + 16] = 1.0
    masks[1, 8:Hb - 8, Wb // 2 - 16:Wb - 4] = 1.0
    imgs *= masks[..., None] > 0
    return imgs, masks


# ---------------------------------------------------------------------------
# multiband blend
# ---------------------------------------------------------------------------

def _multi_blend_oracle(imgs, seam_masks, orig_masks, corners, canvas_hw,
                        bands, sigma):
    """NumPy/cv2 port of blnd::multi_blend (_blending.cpp:186-252),
    returning the 0..255 scale (the reference divides by 255/bands for a
    [0,1] display scale; multiplied back for comparison)."""
    import cv2
    H, W = canvas_hw
    color = np.zeros((H, W, 3), np.float64)
    alpha = np.zeros((H, W), np.float64)
    ksz = 2 * int(np.ceil(3 * sigma)) + 1
    for i in range(bands):
        sigma_band = np.sqrt(2 * (bands - i) + 1) * sigma
        for j in range(len(imgs)):
            img = imgs[j].astype(np.float32)
            blurred = cv2.GaussianBlur(img, (ksz, ksz), sigma_band,
                                       borderType=cv2.BORDER_REFLECT)
            w = cv2.GaussianBlur(
                (seam_masks[j] > 0).astype(np.float32) * 255.0, (ksz, ksz),
                sigma_band, borderType=cv2.BORDER_REFLECT) / 255.0
            if i == bands - 1:
                band = img - blurred
            elif i > 0:
                sigma_prev = np.sqrt(2 * (bands - i - 1) + 1) * sigma
                band = blurred - cv2.GaussianBlur(
                    img, (ksz, ksz), sigma_prev,
                    borderType=cv2.BORDER_REFLECT)
            else:
                band = blurred
            w = np.where(orig_masks[j] > 0, w, 0.0)
            ty, tx = corners[j]
            h, wd = img.shape[:2]
            color[ty:ty + h, tx:tx + wd] += band * w[..., None]
            alpha[ty:ty + h, tx:tx + wd] += w
    out = color / np.maximum(alpha[..., None], 1e-12)
    return np.where(alpha[..., None] > 0, out * bands, 0.0)


def test_multi_blend_vs_reference_port(rng):
    from simplepanorama_tpu.render.blending import multi_blend
    Hb, Wb = 64, 128
    imgs, masks = _rng_blocks(rng, n=2, Hb=Hb, Wb=Wb)
    # seam masks: left image owns the left half of the overlap
    seams = masks.copy()
    seams[0, :, Wb // 2:] = 0.0
    seams[1, :, :Wb // 2] = 0.0
    offs = jnp.zeros((2, 2), jnp.int32)
    out = np.asarray(multi_blend(
        jnp.asarray(imgs), jnp.asarray(seams), jnp.asarray(masks), offs,
        (Hb, Wb), bands=2, sigma=2.0))
    oracle = _multi_blend_oracle(imgs, seams, masks, [(0, 0), (0, 0)],
                                 (Hb, Wb), bands=2, sigma=2.0)
    # compare away from the ROI border (documented deviation: the
    # reference reflects image content at the ROI edge, we zero-pad;
    # sigma=2 -> radius 6, x2 bands)
    r = 13
    sup = (np.asarray(out).sum(-1) > 0) & (oracle.sum(-1) > 0)
    sup[:r] = sup[-r:] = False
    sup[:, :r] = sup[:, -r:] = False
    diff = np.abs(out - oracle)[sup]
    assert diff.mean() < 0.5, f"mean abs diff {diff.mean():.3f}"
    assert np.percentile(diff, 99) < 3.0, \
        f"p99 abs diff {np.percentile(diff, 99):.3f}"


# ---------------------------------------------------------------------------
# gain compensation
# ---------------------------------------------------------------------------

def _gain_oracle(imgs, masks, corners, adj):
    """NumPy port of gain::gain_compensation (_gain_compensation.cpp):
    rect-intersection overlap areas/intensities, M g = G with
    sigma_N = 100, sigma_g = .01."""
    n = len(imgs)
    adj_sym = adj + np.eye(n)
    grays = [0.114 * im[..., 0] + 0.587 * im[..., 1] + 0.299 * im[..., 2]
             for im in imgs]
    N_ij = np.zeros((n, n))
    I_ij = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            if adj_sym[i, j] <= 0:
                continue
            (yi, xi), (yj, xj) = corners[i], corners[j]
            hi, wi = grays[i].shape
            hj, wj = grays[j].shape
            y0, y1 = max(yi, yj), min(yi + hi, yj + hj)
            x0, x1 = max(xi, xj), min(xi + wi, xj + wj)
            if y1 <= y0 or x1 <= x0:
                continue
            mi = masks[i][y0 - yi:y1 - yi, x0 - xi:x1 - xi] > 0
            mj = masks[j][y0 - yj:y1 - yj, x0 - xj:x1 - xj] > 0
            both = mi & mj
            area = both.sum()
            if area == 0:
                continue
            gi = grays[i][y0 - yi:y1 - yi, x0 - xi:x1 - xi]
            gj = grays[j][y0 - yj:y1 - yj, x0 - xj:x1 - xj]
            N_ij[i, j] = N_ij[j, i] = area
            I_ij[i, j] = gj[both].sum() / area
            I_ij[j, i] = gi[both].sum() / area
    S_N, S_g = 100.0, 0.01
    B = np.diag(N_ij.sum(axis=1))
    A = np.diag((N_ij * I_ij * I_ij).sum(axis=1))
    C = N_ij * I_ij * I_ij.T
    G = (1.0 / S_g) * np.diag(B)
    M = (2.0 / S_N) * (A - C) + (1.0 / S_g) * B
    return np.linalg.solve(M, G)


def test_gain_dev_vs_reference_port(rng):
    from simplepanorama_tpu.render.compose import gain_dev
    Hb, Wb = 64, 128
    imgs, masks = _rng_blocks(rng, n=2, Hb=Hb, Wb=Wb)
    imgs[1] *= 1.3  # exposure disparity to compensate
    np.clip(imgs, 0, 255, out=imgs)
    adj = np.zeros((2, 2))
    adj[0, 1] = 0.4
    offs = jnp.zeros((2, 2), jnp.int32)
    gains = gain_dev(jnp.asarray(imgs), jnp.asarray(masks) > 0, offs,
                     (Hb, Wb), adj)
    oracle = _gain_oracle(list(imgs), list(masks), [(0, 0), (0, 0)], adj)
    assert np.allclose(gains, oracle, rtol=2e-3), (gains, oracle)
    # the brighter image must receive the larger gain divisor
    assert oracle[1] > oracle[0]


# ---------------------------------------------------------------------------
# exposure-disparity fields
# ---------------------------------------------------------------------------

def _equalize_oracle(imgs, masks, corners):
    """cv2 port of test::equalizeIntensities at ratio=.5
    (_test.cpp:9-106): half-res DT-weighted intensities, neighbor
    accumulation over ROI overlaps, 13x13 sigma-7 blur."""
    import cv2
    n = len(imgs)
    eps = 1e-5
    dts = [cv2.distanceTransform((m > 0).astype(np.uint8),
                                 cv2.DIST_L2, cv2.DIST_MASK_5) / 255.0
           for m in masks]
    gray, dt_s, mk_s, roi = [], [], [], []
    for i in range(n):
        g = (0.114 * imgs[i][..., 0] + 0.587 * imgs[i][..., 1]
             + 0.299 * imgs[i][..., 2]) / 255.0
        gs = cv2.resize(g.astype(np.float32), None, fx=0.5, fy=0.5,
                        interpolation=cv2.INTER_LINEAR)
        ms = cv2.resize((masks[i] > 0).astype(np.float32), None, fx=0.5,
                        fy=0.5, interpolation=cv2.INTER_LINEAR) > 0.5
        ds = cv2.resize(dts[i].astype(np.float32), None, fx=0.5, fy=0.5,
                        interpolation=cv2.INTER_LINEAR)
        gray.append(np.where(ms, gs, 0.0))
        mk_s.append(ms)
        dt_s.append(ds)
        ty, tx = corners[i]
        h, w = gs.shape
        roi.append((ty // 2, tx // 2, h, w))
    fields = []
    for i in range(n):
        int_t = gray[i] * dt_s[i]
        alpha_t = dt_s[i].copy()
        yi, xi, hi, wi = roi[i]
        for j in range(n):
            if i == j:
                continue
            yj, xj, hj, wj = roi[j]
            y0, y1 = max(yi, yj), min(yi + hi, yj + hj)
            x0, x1 = max(xi, xj), min(xi + wi, xj + wj)
            if y1 <= y0 or x1 <= x0:
                continue
            sl_i = (slice(y0 - yi, y1 - yi), slice(x0 - xi, x1 - xi))
            sl_j = (slice(y0 - yj, y1 - yj), slice(x0 - xj, x1 - xj))
            m = mk_s[i][sl_i]
            int_t[sl_i] += np.where(m, gray[j][sl_j] * dt_s[j][sl_j], 0.0)
            alpha_t[sl_i] += np.where(m, dt_s[j][sl_j], 0.0)
        f = int_t / (alpha_t + eps) + eps
        f = gray[i] / f
        f = f + (~mk_s[i]).astype(np.float32)
        f = cv2.GaussianBlur(f, (13, 13), 7, borderType=cv2.BORDER_REFLECT)
        fields.append(f)
    return fields


def test_equalize_dev_vs_reference_port(rng):
    from simplepanorama_tpu.render.compose import equalize_dev
    Hb, Wb = 64, 128
    imgs, masks = _rng_blocks(rng, n=2, Hb=Hb, Wb=Wb)
    imgs[1] *= 1.25
    np.clip(imgs, 1, 255, out=imgs)
    offs = jnp.zeros((2, 2), jnp.int32)
    fields = np.asarray(equalize_dev(jnp.asarray(imgs),
                                     jnp.asarray(masks) > 0, offs, (Hb, Wb)))
    oracle = _equalize_oracle(list(imgs), list(masks), [(0, 0), (0, 0)])
    for i in range(2):
        m = cv2_erode(masks[i])  # compare inside the eroded footprint
        ms = m[::2, ::2] > 0.5
        d = np.abs(fields[i][:Hb // 2, :Wb // 2] - oracle[i])[ms]
        assert np.percentile(d, 99) < 0.05, \
            f"image {i}: p99 field diff {np.percentile(d, 99):.4f}"
        # the over-exposed image's correction field must exceed 1 in the
        # overlap (it gets divided down)
    ov = (masks[0] > 0) & (masks[1] > 0)
    ovs = ov[::2, ::2]
    assert oracle[1][ovs].mean() > 1.0
    assert fields[1][:Hb // 2, :Wb // 2][ovs].mean() > 1.0


def cv2_erode(mask, iters=6):
    import cv2
    k = np.ones((3, 3), np.uint8)
    return cv2.erode((mask > 0).astype(np.uint8), k, iterations=iters)


# ---------------------------------------------------------------------------
# rotation warp vs OpenCV's own warper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["spherical", "cylindrical"])
def test_warp_backward_vs_cv2_rotation_warper(rng, kind):
    """warp_backward must reproduce cv::detail::{Spherical,Cylindrical}
    Warper (the component the reference wraps) pixel-for-pixel up to
    bilinear rounding."""
    import cv2
    from simplepanorama_tpu.render import projection as prj
    h, w = 120, 160
    base = rng.uniform(30, 225, (h // 8, w // 8, 3)).astype(np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)

    focal = 150.0
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    rv = np.array([0.05, -0.3, 0.02])
    R, _ = cv2.Rodrigues(rv)
    Ka = prj.adjusted_K(K, h, w)
    scale = focal

    warper = cv2.PyRotationWarper(kind, scale)
    corner_cv, warped_cv = warper.warp(
        img, Ka.astype(np.float32), R.astype(np.float32),
        cv2.INTER_LINEAR, cv2.BORDER_CONSTANT)

    tlx, tly, rw, rh = prj.roi_for_image(kind, scale, R, K, h, w)
    # OpenCV's detectResultRoi walks the full source grid; ours walks the
    # border with the same math — corners must agree to a pixel or two
    assert abs(corner_cv[0] - tlx) <= 2 and abs(corner_cv[1] - tly) <= 2

    warped, mask = prj.warp_backward(
        jnp.asarray(img), jnp.asarray(Ka, jnp.float32),
        jnp.asarray(R, jnp.float32),
        jnp.asarray(np.array([tlx, tly], np.float32)), scale, kind,
        (rh + 7) // 8 * 8, (rw + 127) // 128 * 128,
        jnp.asarray(np.array([h, w], np.int32)))
    warped = np.asarray(warped)
    mask = np.asarray(prj.erode_mask(mask, iters=4))

    # align the two outputs on common canvas coords
    H0 = min(warped_cv.shape[0] - max(0, tly - corner_cv[1]),
             rh - max(0, corner_cv[1] - tly))
    W0 = min(warped_cv.shape[1] - max(0, tlx - corner_cv[0]),
             rw - max(0, corner_cv[0] - tlx))
    oy_cv, ox_cv = max(0, tly - corner_cv[1]), max(0, tlx - corner_cv[0])
    oy, ox = max(0, corner_cv[1] - tly), max(0, corner_cv[0] - tlx)
    a = warped[oy:oy + H0, ox:ox + W0]
    b = warped_cv[oy_cv:oy_cv + H0, ox_cv:ox_cv + W0]
    m = mask[oy:oy + H0, ox:ox + W0]
    # compare interior pixels (our mask is eroded 4x, cv2's is not)
    diff = np.abs(a - b)[m]
    assert diff.mean() < 1.0, f"mean abs diff {diff.mean():.3f}"
    assert np.percentile(diff, 99) < 5.0, \
        f"p99 {np.percentile(diff, 99):.3f}"
