"""Direct unit oracles for the two kernels that were previously only
exercised end-to-end: ops/edt.py vs
cv2.distanceTransform and exposure.straighten vs a literal port of
strg::straightenPanorama (/root/reference/src/math/_straightening.cpp:5-51),
including the up-vector sign case."""

import numpy as np
import pytest


def _blob_mask(h, w, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(6):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(5, max(6, min(h, w) // 3))
        yy, xx = np.mgrid[:h, :w]
        m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 255
    # keep some background so distances are finite
    m[0, :] = 0
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edt_matches_cv2_precise(seed):
    """JFA distance transform vs cv2 DIST_MASK_PRECISE (exact L2).
    JFA's rare propagation misses are sub-pixel; gate max error at 1px
    and mean at 0.05px."""
    import cv2
    import jax.numpy as jnp
    from simplepanorama_tpu.ops.edt import distance_transform
    m = _blob_mask(160, 220, seed)
    ours = np.asarray(distance_transform(jnp.asarray(m > 0)))
    ref = cv2.distanceTransform(m, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
    err = np.abs(ours - ref)
    assert err.max() < 1.0, f"max err {err.max():.3f}"
    assert err.mean() < 0.05, f"mean err {err.mean():.4f}"


def test_edt_closer_than_reference_chamfer():
    """The reference uses the 5x5 chamfer APPROXIMATION
    (cv::distanceTransform(DIST_L2, DIST_MASK_5), _distance_cut.cpp:62).
    Our JFA must be at least as close to the exact transform as the
    approximation the reference accepts."""
    import cv2
    import jax.numpy as jnp
    from simplepanorama_tpu.ops.edt import distance_transform
    m = _blob_mask(200, 200, 7)
    exact = cv2.distanceTransform(m, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
    chamfer = cv2.distanceTransform(m, cv2.DIST_L2, cv2.DIST_MASK_5)
    ours = np.asarray(distance_transform(jnp.asarray(m > 0)))
    assert np.abs(ours - exact).max() <= np.abs(chamfer - exact).max() + 1e-3
    assert np.abs(ours - exact).mean() <= np.abs(chamfer - exact).mean()


def test_edt_trivial_cases():
    import jax.numpy as jnp
    from simplepanorama_tpu.ops.edt import distance_transform
    # all-background -> all zeros
    z = np.asarray(distance_transform(jnp.zeros((32, 64), bool)))
    assert (z == 0).all()
    # single background pixel: distance = euclidean distance to it
    m = np.ones((33, 49), bool)
    m[10, 20] = False
    d = np.asarray(distance_transform(jnp.asarray(m)))
    yy, xx = np.mgrid[:33, :49]
    expect = np.sqrt((yy - 10.0) ** 2 + (xx - 20.0) ** 2)
    assert np.abs(d - expect).max() < 1e-3


# ---------------------------------------------------------------------------
# straightening
# ---------------------------------------------------------------------------

def _straighten_ref_port(rotations):
    """Literal NumPy port of strg::straightenPanorama
    (_straightening.cpp:5-51), kept independent of the package
    implementation: per-camera X column, covariance sum, smallest
    eigenvector (Eigen SelfAdjointEigenSolver sorts ascending),
    sign-align to world up, Rodrigues-style g = I + V + V^2 (1-c)/s^2."""
    C = np.zeros((3, 3))
    for R in rotations:
        X = R[:, 0]
        C += np.outer(X, X)
    wvals, wvecs = np.linalg.eigh(C)
    up = wvecs[:, 0]
    world_up = np.array([0.0, 1.0, 0.0])
    if up @ world_up < 0:
        up = -up
    w = np.cross(up, world_up)
    s = np.linalg.norm(w)
    c = up @ world_up
    V = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    g = np.eye(3) + V + V @ V * ((1 - c) / (s * s))
    return np.stack([g @ R for R in rotations])


def _rot(axis, deg):
    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    th = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _tilted_pan_rots(n, tilt_deg, flip=False):
    """A horizontal pan whose camera plane is tilted by tilt_deg: the
    covariance's smallest eigenvector is the (tilted) pan axis."""
    tilt = _rot([1, 0, 0], tilt_deg)
    rots = [tilt @ _rot([0, 1, 0], a) for a in np.linspace(0, 80, n)]
    if flip:
        rots = [r @ np.diag([1.0, -1.0, -1.0]) for r in rots]
    return np.stack(rots)


@pytest.mark.parametrize("tilt", [3.0, 15.0, -10.0])
def test_straighten_matches_reference_port(tilt):
    from simplepanorama_tpu.render.exposure import straighten
    rots = _tilted_pan_rots(8, tilt)
    ours = straighten(rots)
    ref = _straighten_ref_port(rots)
    np.testing.assert_allclose(ours, ref, atol=1e-10)


def test_straighten_up_vector_sign_case():
    """Rotations whose covariance eigenvector comes out with negative
    Y-dot: the sign-alignment branch must flip it (a sign bug here would
    rotate the panorama ~180 degrees and hide behind a loose NCC gate)."""
    from simplepanorama_tpu.render.exposure import straighten
    rots = _tilted_pan_rots(8, 170.0)   # upside-down-ish pan
    ours = straighten(rots)
    ref = _straighten_ref_port(rots)
    np.testing.assert_allclose(ours, ref, atol=1e-10)
    # result property: the straightened X-axis covariance's smallest
    # eigenvector aligns with +Y
    X = ours[:, :, 0]
    w, v = np.linalg.eigh(X.T @ X)
    up = v[:, 0] * np.sign(v[1, 0])
    assert abs(up @ np.array([0, 1, 0])) > 0.999


def test_straighten_aligns_tilt_property():
    """After straightening a tilted pan, the mean camera Y axis must be
    closer to world-up than before."""
    from simplepanorama_tpu.render.exposure import straighten
    rots = _tilted_pan_rots(10, 12.0)
    out = straighten(rots)
    def mean_updot(rs):
        return np.mean([r[1, 1] for r in rs])
    assert mean_updot(out) > mean_updot(rots)


def test_cylinder_prewarp_properties():
    """Legacy cylindrical pre-warp (images::images_to_cylinder,
    _image.cpp:168-191): the center pixel is a fixed point, the center
    row maps through x = f*tan((u-cx)/f) exactly, and columns compress
    toward the edges (cylindrical squeeze)."""
    import cv2
    from simplepanorama_tpu.io import cylinder_prewarp
    h, w, f = 120, 240, 200.0
    # vertical stripe pattern so horizontal compression is observable
    img = np.zeros((h, w, 3), np.uint8)
    img[:, ::10] = 255
    out = cylinder_prewarp(img, f)
    assert out.shape == img.shape
    # center pixel fixed: theta=0 -> x=0, y=v-cy
    assert (out[h // 2, w // 2] == img[h // 2, w // 2]).all()
    # an off-center column u samples source x = f*tan((u-cx)/f) + cx,
    # which is FARTHER from center than u (tan(t) >= t): content near the
    # borders gets pulled inward, so the outermost source stripes vanish
    # from the output unless tan stays small. Verify the mapping on a
    # delta image: a single white source column at u0 appears at the
    # INVERSE-mapped location atan((u0-cx)/f)*f + cx.
    delta = np.zeros((h, w), np.float32)
    u0 = 200
    delta[:, u0] = 255.0
    warped = cylinder_prewarp(delta[..., None].repeat(3, -1)
                              .astype(np.uint8), f)
    row = warped[h // 2, :, 0].astype(np.float32)
    u_expect = np.arctan((u0 - w / 2) / f) * f + w / 2
    peak = row.argmax()
    assert abs(peak - u_expect) <= 1.5, (peak, u_expect)
