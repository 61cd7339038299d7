"""SIFT detector/descriptor tests: synthetic oracle + cv2 cross-validation.

Mirrors the reference's validation philosophy (numeric oracles in
production code, golden fixtures — SURVEY §4): blob positions are an exact
oracle; OpenCV SIFT on the bundled `map` images is the cross-check.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from simplepanorama_tpu.ops.sift import extract_sift
from simplepanorama_tpu.config import Config
from simplepanorama_tpu.features import extract_features


def _blob_image(blobs, hw=(128, 128)):
    img = np.zeros(hw, np.float32)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    for (y, x, s, a) in blobs:
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255)


def test_sift_finds_blobs():
    blobs = [(40, 40, 3, 200), (80, 90, 5, 180), (60, 20, 2, 150),
             (100, 50, 4, 120)]
    img = _blob_image(blobs)
    f = extract_sift(jnp.asarray(img), jnp.array([128, 128]), max_kp=64)
    v = np.asarray(f.valid)
    assert v.sum() >= len(blobs)
    xy = np.asarray(f.xy)[v]
    for (y, x, _, _) in blobs:
        d = np.linalg.norm(xy - np.array([x, y]), axis=1).min()
        assert d < 1.0, f"blob at ({x},{y}) missed by {d:.2f}px"


def test_sift_descriptor_rotation_invariance():
    """A descriptor should match its 90-deg-rotated counterpart."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (96, 96)).astype(np.float32)
    # smooth it so gradients are meaningful
    import scipy.ndimage as ndi
    img = ndi.gaussian_filter(img, 2.0) * 4
    rot = np.rot90(img).copy()
    fa = extract_sift(jnp.asarray(img), jnp.array([96, 96]), max_kp=64)
    fb = extract_sift(jnp.asarray(rot), jnp.array([96, 96]), max_kp=64)
    va, vb = np.asarray(fa.valid), np.asarray(fb.valid)
    if va.sum() < 5 or vb.sum() < 5:
        pytest.skip("too few keypoints in random texture")
    da, db = np.asarray(fa.desc)[va], np.asarray(fb.desc)[vb]
    sims = da @ db.T
    # most descriptors should find a near-duplicate (dot close to 1)
    frac = (sims.max(axis=1) > 0.9).mean()
    assert frac > 0.6, f"only {frac:.0%} rotation-matched"


@pytest.mark.slow
def test_sift_matches_cv2_on_real_pair(map_images):
    """End-to-end cross-check on budapest1<->budapest2: our SIFT must give
    at least as strong a geometric match as the reference's OpenCV SIFT
    path did (76 inliers with top-1024 keypoints at init_size=700; we run
    at 350 px to keep CI fast and require a proportional floor)."""
    import cv2
    from simplepanorama_tpu.ops.matching import (
        match_pair_batch, gather_match_coords)
    from simplepanorama_tpu.ops.homography import ransac_homography

    paths, imgs = map_images
    small = [cv2.resize(im, (im.shape[1] // 2, im.shape[0] // 2))
             for im in imgs[:2]]
    cfg = Config()
    feats = extract_features(small, cfg)
    assert feats[0].count > 200 and feats[1].count > 200

    K = cfg.sift_max_features()
    mi, mv, nm = match_pair_batch(
        jnp.asarray(feats[0].desc[None]), jnp.asarray(feats[1].desc[None]),
        jnp.asarray(feats[0].valid[None]), jnp.asarray(feats[1].valid[None]),
        cfg.max_matches_per_pair)
    q, t = gather_match_coords(
        jnp.asarray(feats[0].xy[None]), jnp.asarray(feats[1].xy[None]),
        mi, mv)
    hw = jnp.array(small[0].shape[:2])
    H, inl = ransac_homography(
        q[0], t[0], mv[0], hw, hw, jax.random.PRNGKey(0),
        n_iter=500, margin=4.0)
    n_inl = int(np.asarray(inl).sum())
    assert n_inl >= 25, f"only {n_inl} inliers on an overlapping pair"
    # translation direction must match the known layout (x shift ~195px)
    H = np.array(H)
    assert 150 < H[0, 2] / H[2, 2] < 250


def test_gftt_detects_corners():
    from simplepanorama_tpu.ops.gftt import gftt_detect
    img = np.zeros((96, 96), np.float32)
    img[20:60, 30:70] = 200.0   # rectangle -> 4 strong corners
    import scipy.ndimage as ndi
    img = ndi.gaussian_filter(img, 1.0)
    xy, resp, valid = gftt_detect(jnp.asarray(img), jnp.array([96, 96]),
                                  max_corners=16)
    pts = np.asarray(xy)[np.asarray(valid)]
    for cx, cy in [(30, 20), (69, 20), (30, 59), (69, 59)]:
        d = np.linalg.norm(pts - np.array([cx, cy]), axis=1).min()
        assert d < 3.0, f"corner ({cx},{cy}) missed by {d:.1f}px"


def test_gftt_sift_descriptors_match_across_shift():
    from simplepanorama_tpu.ops.gftt import gftt_sift
    rng = np.random.default_rng(9)
    import scipy.ndimage as ndi
    base = ndi.gaussian_filter(
        rng.uniform(0, 255, (128, 160)).astype(np.float32), 2.0) * 4
    a = base[:, :128]
    b = base[:, 24:152]   # 24px shift
    fa = gftt_sift(jnp.asarray(a.copy()), jnp.array([128, 128]), max_corners=128)
    fb = gftt_sift(jnp.asarray(b.copy()), jnp.array([128, 128]), max_corners=128)
    da = np.asarray(fa.desc)[np.asarray(fa.valid)]
    db = np.asarray(fb.desc)[np.asarray(fb.valid)]
    sims = da @ db.T
    assert (sims.max(1) > 0.9).mean() > 0.4


@pytest.mark.parametrize("env,want", [("123456789", 123456789), (None, None)])
def test_sift_mem_budget(monkeypatch, env, want):
    """The SIFT chunk budget: the override when set, else half the host's
    physical memory on the CPU (whose device reports no byte limit); a
    chunk at a large working size then stays bounded."""
    import os
    from simplepanorama_tpu import features
    if env is None:
        monkeypatch.delenv("SPT_SIFT_MEM_BUDGET", raising=False)
        want = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2
    else:
        monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", env)
    assert features._sift_mem_budget() == want
    # one 4000 x 4000 image needs per_img = 4000^2 * 6 * 550 bytes (53 GB)
    monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", str(100_000_000_000))
    assert features._sift_chunk_size(8, 4000, 4000, Config()) == 1
