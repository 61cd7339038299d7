"""Seeded views with known cameras (utils.synth), the PNG codec, the
compile-cache location, and the CPU calibration of chip_smoke.py's
ground-truth checks."""

import numpy as np
import pytest

from simplepanorama_tpu.utils import synth


@pytest.mark.parametrize("yaw,pitch,roll", [(0.0, 0.0, 0.0),
                                            (35.0, 8.0, -2.0),
                                            (-150.0, -12.0, 3.0)])
def test_projected_points_land_on_view(yaw, pitch, roll):
    """A white dot at a known world direction d must appear in the
    rendered view at the pinhole projection K R d."""
    W, H = 1024, 512
    scene = np.zeros((H, W, 3), np.uint8)
    R = synth.rotation(*np.deg2rad([yaw, pitch, roll]))
    w, h, f = 320, 240, 300.0
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    # 3x3-pixel dots near the directions of three view pixels
    expect = []
    for x, y in [(60.0, 50.0), (200.0, 120.0), (250.0, 190.0)]:
        d = R.T @ np.linalg.solve(K, [x, y, 1.0])
        lon = np.arctan2(d[0], d[2])
        lat = np.arctan2(-d[1], np.hypot(d[0], d[2]))
        u = int((lon + np.pi) / (2 * np.pi) * W)
        v = int((np.pi / 2 - lat) / np.pi * H)
        scene[v - 1:v + 2, [(u - 1) % W, u % W, (u + 1) % W]] = 255
        # the dot centre's own direction, projected with K R d
        lon = (u + 0.5) / W * 2 * np.pi - np.pi
        lat = np.pi / 2 - (v + 0.5) / H * np.pi
        d = [np.cos(lat) * np.sin(lon), -np.sin(lat),
             np.cos(lat) * np.cos(lon)]
        p = K @ R @ d
        expect.append(p[:2] / p[2])
    view = synth.render_view(scene, R, f, (w, h)).max(axis=-1)
    for x, y in expect:
        x0, y0 = int(round(x)), int(round(y))
        win = view[y0 - 8:y0 + 9, x0 - 8:x0 + 9].astype(np.float64)
        assert win.max() > 100
        ys, xs = np.mgrid[-8:9, -8:9]
        assert abs((win * ys).sum() / win.sum() + y0 - y) < 0.3
        assert abs((win * xs).sum() / win.sum() + x0 - x) < 0.3


@pytest.mark.parametrize("kind,n_views", [("map", 6), ("front", 14)])
def test_layout_views_and_steps(kind, n_views):
    rots = synth.layout(kind, seed=3)
    assert rots.shape == (n_views, 3, 3)
    assert np.allclose(rots @ rots.transpose(0, 2, 1), np.eye(3),
                       atol=1e-12)
    # neighbours in a row are 30 degrees apart in yaw, up to the jitter
    ang = synth._angle_deg(rots[0], rots[1])
    assert 29.0 < ang < 33.5


def test_write_sequence_is_lossless(tmp_path):
    from simplepanorama_tpu.io import file_to_array, probe_size
    scene = synth.make_scene(1, 1024, 512, n_shapes=50)
    s = synth.write_sequence(tmp_path, "map", 1, n=2, size_wh=(320, 240),
                             focal=300.0, scene=scene)
    assert s.size == (240, 320) and len(s.paths) == 2
    for p, R in zip(s.paths, s.rotations):
        assert probe_size(p) == (240, 320)
        np.testing.assert_array_equal(
            file_to_array(p), synth.render_view(scene, R, 300.0, (320, 240)))


def _png_with_filters(img, filters):
    """Reference PNG encoder applying filter type filters[y % 5] to row
    y, written from the spec (section 9.2) independently of io.py."""
    import struct
    import zlib
    h, w, c = img.shape
    rgb = img[..., ::-1].reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rgb[y]
        up = rgb[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decodes_every_filter_type():
    from simplepanorama_tpu.io import decode_png
    img = np.random.default_rng(2).integers(0, 256, (23, 17, 3), np.uint8)
    data = _png_with_filters(img, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("shape", [(31, 45, 3), (8, 300, 3), (20, 19)])
def test_png_round_trip_bit_exact(tmp_path, shape):
    from simplepanorama_tpu import io
    img = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                     np.uint8)
    path = str(tmp_path / "x.png")
    assert io.save_image(path, img)
    back = io.file_to_array(path)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("shape", [(31, 45, 3), (8, 300, 3), (20, 19)])
def test_png_round_trip_without_cv2(tmp_path, monkeypatch, shape):
    """Where cv2 cannot be imported, PNG reads and writes through the
    zlib + numpy codec, bit for bit, and cv2 reads what it wrote."""
    import sys
    import cv2
    from simplepanorama_tpu import io
    img = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                     np.uint8)
    path = str(tmp_path / "x.png")
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert io._cv2() is None
    assert io.save_image(path, img)
    back = io.file_to_array(path)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(back, want)
    monkeypatch.undo()
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), want)


def test_non_png_without_cv2_names_it(tmp_path, monkeypatch):
    import sys
    from simplepanorama_tpu import io
    img = np.zeros((32, 32, 3), np.uint8)
    jpg = str(tmp_path / "x.jpg")
    assert io.save_image(jpg, img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        io.file_to_array(jpg)
    with pytest.raises(ImportError, match="cv2"):
        io.save_image(str(tmp_path / "y.jpg"), img)


@pytest.mark.parametrize("env", [None, "/some/cache/dir"])
def test_compile_cache_dir(monkeypatch, env):
    import pathlib
    import simplepanorama_tpu
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = pathlib.Path(simplepanorama_tpu.__file__).resolve().parent
        assert simplepanorama_tpu.compile_cache_dir() == str(
            root.parent / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert simplepanorama_tpu.compile_cache_dir() == env


def test_stitch_recovers_ground_truth(tmp_path, monkeypatch):
    """CPU calibration of chip_smoke.py's checks: 4 generated views
    (400 x 300 px, f = 400, the 53 degree field of view of the 700 px
    sets) stitched single-device at init_size 400 and 300 RANSAC
    iterations must meet the same focal, rotation and coverage
    tolerances (synth.FOCAL_TOL, ROT_TOL_DEG, MIN_COVERAGE)."""
    from simplepanorama_tpu import Config, Panorama
    from simplepanorama_tpu.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "PIPELINE_SHARDING", False)
    truth = synth.write_sequence(tmp_path, "map", 0, n=4,
                                 size_wh=(400, 300), focal=400.0)
    cfg = Config()
    cfg.init_size = 400
    cfg.RANSAC_iterations = 300
    p = Panorama(truth.paths).stitch(cfg)
    assert tuple(p.connected) == (4, 4)
    # exit waits for the full-res prefetch rather than killing it
    assert not p._full_prefetch[1].daemon
    err = synth.stitch_errors(p.result, truth)
    assert err["focal_err"] <= synth.FOCAL_TOL, err
    assert err["rot_err_deg"] <= synth.ROT_TOL_DEG[400], err
    assert synth.coverage(p.get_preview()) >= synth.MIN_COVERAGE
