"""Decode fast path + streaming load/extract overlap.

load_clamped must be behavior-identical to the reference's
full-decode-then-clamp rule (_image.cpp:29-73) — bit-identical where no
reduced decode triggers, shape-identical and visually identical where it
does; the streaming extract path must produce the same feature tables as
the materialized-list path. Sources are generated views (utils.synth) at
the reference sets' 700 x 467 working size, as PNG and as JPEG.
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """Four overlapping 700 x 467 views: (png paths, jpg paths)."""
    import cv2
    from simplepanorama_tpu.utils import synth
    out = tmp_path_factory.mktemp("views")
    scene = synth.make_scene(0, 2048, 1024, n_shapes=300)
    s = synth.write_sequence(out, "map", 0, n=4, scene=scene)
    jpgs = []
    for p in s.paths:
        j = p[:-4] + ".jpg"
        cv2.imwrite(j, cv2.imread(p), [cv2.IMWRITE_JPEG_QUALITY, 95])
        jpgs.append(j)
    return s.paths, jpgs


def test_probe_size_matches_decode(views):
    from simplepanorama_tpu import io
    pngs, jpgs = views
    for path in pngs[:2] + jpgs[:2]:
        img = io.file_to_array(path)
        assert img is not None and img.shape == (467, 700, 3), path
        assert io.probe_size(path) == img.shape[:2], path


def test_probe_size_png(tmp_path):
    import cv2
    from simplepanorama_tpu import io
    img = np.random.default_rng(0).integers(0, 255, (123, 456, 3),
                                            np.uint8)
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, img)
    assert io.probe_size(p) == (123, 456)


@pytest.mark.parametrize("fmt", [0, 1])
def test_load_clamped_identical_small_source(views, fmt):
    """Sources under the 2x-reduce threshold take the full-decode path:
    output must be bit-identical to clamp_to_init_size."""
    from simplepanorama_tpu import io
    path = views[fmt][0]
    a = io.load_clamped(path, 700)
    b = io.clamp_to_init_size(io.file_to_array(path), 700)
    assert a.shape == b.shape == (467, 700, 3)
    assert np.array_equal(a, b)


def test_load_clamped_reduced_decode(tmp_path):
    """A large source triggers reduced decode: exact same output SHAPE as
    the reference rule, near-identical pixels (the k-scaled DCT decode +
    INTER_AREA differs from full decode + INTER_AREA only in rounding)."""
    import cv2
    from simplepanorama_tpu import io
    rng = np.random.default_rng(1)
    # smooth content (noise would make the two decode paths diverge at
    # high frequency for reasons unrelated to correctness)
    base = rng.integers(0, 255, (40, 60, 3), np.uint8)
    big = cv2.resize(base, (4800, 3200), interpolation=cv2.INTER_CUBIC)
    p = str(tmp_path / "big.jpg")
    cv2.imwrite(p, big, [cv2.IMWRITE_JPEG_QUALITY, 95])

    a = io.load_clamped(p, 700)
    b = io.clamp_to_init_size(io.file_to_array(p), 700)
    assert a.shape == b.shape == (467, 700, 3)
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert diff.mean() < 2.0 and diff.max() < 40, (
        f"mean {diff.mean():.2f} max {diff.max()}")


def test_load_clamped_too_small(tmp_path):
    import cv2
    from simplepanorama_tpu import io
    img = np.zeros((200, 400, 3), np.uint8)
    p = str(tmp_path / "small.jpg")
    cv2.imwrite(p, img)
    with pytest.raises(io.ImageTooSmallError):
        io.load_clamped(p, 700)


def test_pending_load_dims_and_finalize(views):
    from simplepanorama_tpu import io
    paths = views[1]
    s = io.ImageSet(paths)
    pending = s.load_resized_stream(400, threads=2)
    assert len(pending) == len(paths)
    for i in range(len(paths)):
        im = pending.get(i)
        assert pending.dims[i] == im.shape[:2]
    pending.finalize()
    pending.finalize()        # idempotent
    assert len(s.img_data) == len(paths)
    assert s.loaded == paths


def test_streaming_extract_matches_list_path(views, monkeypatch):
    """extract_features(PendingLoad) must equal extract_features(list)
    (streaming runs single-device; force that by disabling the pipeline
    mesh so the virtual 8-device CPU mesh doesn't take the other
    branch)."""
    from simplepanorama_tpu import io
    from simplepanorama_tpu.config import Config
    from simplepanorama_tpu.features import extract_features
    from simplepanorama_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "PIPELINE_SHARDING", False)
    paths = views[1]
    cfg = Config()
    cfg.init_size = 400

    s1 = io.ImageSet(paths)
    pending = s1.load_resized_stream(cfg.init_size, threads=2)
    feats_stream = extract_features(pending, cfg)
    assert len(s1.img_data) == len(paths)   # finalized by extraction

    s2 = io.ImageSet(paths)
    s2.load_resized(cfg.init_size, threads=2)
    feats_list = extract_features(s2.img_data, cfg)

    assert len(feats_stream) == len(feats_list)
    for a, b in zip(feats_stream, feats_list):
        assert a.count == b.count
        v = np.asarray(a.valid)
        assert np.allclose(np.asarray(a.xy)[v], np.asarray(b.xy)[v],
                           atol=1e-4)
        assert np.allclose(np.asarray(a.desc)[v], np.asarray(b.desc)[v],
                           atol=1e-4)
    # device source stack retained for the warp stage
    assert feats_stream.device_images is not None
    assert feats_stream.device_images.shape[0] == len(paths)
