"""End-to-end golden tests on the reference's bundled sequences
(results/* are de-facto regression fixtures, SURVEY §4)."""

import glob

import numpy as np
import pytest


@pytest.mark.slow
def test_map_sequence_stitches(map_stitched):
    """The 6-image map sequence must fully connect and produce a panorama
    with the reference output's aspect ratio (map.jpg is 1152x2272 ->
    0.507). Stitched once per session (conftest.map_stitched: init 400,
    RANSAC 500 — geometry is scale-free; keeps CPU CI fast)."""
    p = map_stitched
    assert p.connected == (6, 6)
    prev = p.get_preview()
    h, w = prev.shape[:2]
    aspect = h / w
    assert abs(aspect - 1152 / 2272) < 0.03, f"aspect {aspect:.3f}"
    nz = (prev.sum(-1) > 0).mean()
    assert nz > 0.85, f"coverage {nz:.2f}"

    # golden-image structural check vs the reference's own output
    # (results/map/map.jpg). Crops/projections differ slightly, so this
    # is a loose gate against gross blend/geometry regressions.
    import cv2
    ref = cv2.imread("/root/reference/results/map/map.jpg")
    ref = cv2.resize(ref, (w, h), interpolation=cv2.INTER_AREA)
    a = cv2.cvtColor(prev, cv2.COLOR_BGR2GRAY).astype(np.float32)
    b = cv2.cvtColor(ref, cv2.COLOR_BGR2GRAY).astype(np.float32)
    # central region only (borders differ by crop)
    a = a[h // 5:-h // 5, w // 5:-w // 5]
    b = b[h // 5:-h // 5, w // 5:-w // 5]
    a = (a - a.mean()) / (a.std() + 1e-6)
    b = (b - b.mean()) / (b.std() + 1e-6)
    ncc = float((a * b).mean())
    assert ncc > 0.5, f"NCC vs golden output too low: {ncc:.3f}"


@pytest.mark.slow
def test_cli_runs(tmp_path):
    from simplepanorama_tpu.cli import main
    paths = sorted(glob.glob("/root/reference/results/map/budapest*.jpg"))[:3]
    out = tmp_path / "pano.jpg"
    rc = main(paths + ["-o", str(out), "--init-size", "400",
                       "--RANSAC-iterations", "300", "--quiet", "--timing",
                       "--blend", "SIMPLE_BLEND"])
    assert rc == 0
    assert out.exists()
    import cv2
    img = cv2.imread(str(out))
    assert img is not None and img.shape[0] > 100


@pytest.mark.slow
def test_checkpoint_resume_recomposites_without_ba(tmp_path, monkeypatch):
    """--save-state / from_state: compositing resumes under CHANGED
    blend/seam settings with features/matching/BA never re-running
    (SURVEY §5 checkpoint/resume)."""
    from simplepanorama_tpu import Panorama, Config
    paths = sorted(glob.glob("/root/reference/results/map/budapest*.jpg"))[:4]
    cfg = Config()
    cfg.init_size = 400
    cfg.RANSAC_iterations = 300
    p = Panorama(paths)
    p.stitch(cfg)
    state = tmp_path / "state.npz"
    p.save_state(state)

    # resuming must not touch the expensive pipeline stages
    import simplepanorama_tpu.features as features
    import simplepanorama_tpu.stitch as stitch

    def _boom(*a, **k):
        raise AssertionError("resume re-ran a pre-compositing stage")

    monkeypatch.setattr(features, "extract_features", _boom)
    monkeypatch.setattr(stitch, "bundle_adjust_stitching", _boom)

    cfg2 = Config()
    cfg2.init_size = 400
    cfg2.blend = cfg2.blend.__class__["SIMPLE_BLEND"]
    cfg2.cut_seams = False
    p2 = Panorama.from_state(state, config=cfg2)   # paths from checkpoint
    assert p2.connected[0] == p.connected[0]
    prev = p2.get_preview()
    assert prev.shape[0] > 100 and (prev.sum(-1) > 0).mean() > 0.5

    # a third config change on the SAME object also skips BA
    cfg3 = Config()
    cfg3.init_size = 400
    cfg3.cut_seams = True
    p2.set_config(cfg3)
    prev3 = p2.get_preview()
    assert prev3.shape == prev.shape


@pytest.mark.slow
def test_cli_from_state(tmp_path):
    from simplepanorama_tpu.cli import main
    paths = sorted(glob.glob("/root/reference/results/map/budapest*.jpg"))[:3]
    state = tmp_path / "s.npz"
    out1 = tmp_path / "a.jpg"
    rc = main(paths + ["-o", str(out1), "--init-size", "400",
                       "--RANSAC-iterations", "300", "--quiet",
                       "--save-state", str(state)])
    assert rc == 0 and state.exists()
    out2 = tmp_path / "b.jpg"
    rc = main(["-o", str(out2), "--quiet", "--init-size", "400",
               "--from-state", str(state), "--blend", "SIMPLE_BLEND"])
    assert rc == 0
    assert out2.exists()
