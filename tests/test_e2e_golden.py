"""Golden e2e tests for the full regression corpus:
brocken (12), front (14), FKH360 (36, 360-degree u-seam), map with
graph-cut seams, and the stereographic center fix on a real 360 sequence.

Two golden tiers:

  * SHIPPED goldens (/root/reference/results/*.jpg): loose gates only.
    Root cause of the old 0.40 ceiling on front/FKH360: the reference's
    OWN freshly-compiled output also scores ~0.40 against its shipped
    JPGs (measured via tools/ref_headless at identical settings) — the
    shipped files come from unknown settings/crop/version, so ~0.4 is
    the ceiling for ANY faithful rebuild, not our divergence.
  * FRESH references (tests/data/ref_fresh/*, generated by
    tools/ref_headless at THESE tests' exact settings): tight gates.
    Measured ours-vs-fresh: brocken 0.97, front 0.90, map 0.66-0.83
    (the reference's map BA has large run-to-run spread — its own
    fresh-vs-fresh NCC is only 0.81-0.95).

Note: results/sten/{fixed,missing}.jpg are a park scene whose INPUT
photos are not bundled (the README's "Front Door" alt text is a
mislabel), so the stereographic fix is exercised end-to-end on FKH360
instead — fix ON must close the central hole that fix OFF leaves.
"""

import glob
import pathlib

import numpy as np
import pytest

from conftest import ncc_aligned, reuse_stitch

RES = "/root/reference/results"
FRESH = str(pathlib.Path(__file__).parent / "data" / "ref_fresh")


@pytest.fixture
def _no_persistent_compile_cache():
    """Serializing some compositing executables for the persistent
    compile cache segfaults deterministically inside
    compilation_cache.put_executable_and_time (zstd on specific
    payloads — same failure mode test_fullres guards against; seen here
    at test_stereographic_center_fix_e2e's no-fix set_config). The sten
    test requests this fixture to turn the persistent cache off for its
    own compiles only (the shared pipeline compiles stay cached)."""
    import jax
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def _stitch(paths, cfg):
    from simplepanorama_tpu import Panorama
    p = Panorama(paths)
    p.stitch(cfg)
    return p


def _cfg(init_size=400, ransac=500):
    from simplepanorama_tpu import Config
    cfg = Config()
    cfg.init_size = init_size
    cfg.RANSAC_iterations = ransac
    return cfg


@pytest.mark.slow
def test_brocken_sequence():
    paths = sorted(glob.glob(f"{RES}/brocken/resized*.jpg"))
    p = _stitch(paths, _cfg())
    assert p.connected == (12, 12)
    prev = p.get_preview()
    h, w = prev.shape[:2]
    assert 0.48 < h / w < 0.64, f"aspect {h/w:.3f}"
    assert (prev.sum(-1) > 0).mean() > 0.8
    score = ncc_aligned(prev, f"{RES}/brocken/brocken.jpg")
    assert score > 0.6, f"aligned NCC {score:.3f}"
    # measured 0.97; gate at measured-minus-margin
    fresh = ncc_aligned(prev, f"{FRESH}/brocken_400.jpg")
    assert fresh > 0.9, f"NCC vs fresh reference {fresh:.3f}"


@pytest.mark.slow
def test_front_sequence():
    paths = sorted(glob.glob(f"{RES}/front/resized*.jpg"))
    p = _stitch(paths, _cfg())
    assert p.connected == (14, 14)
    prev = p.get_preview()
    h, w = prev.shape[:2]
    assert 0.32 < h / w < 0.45, f"aspect {h/w:.3f}"
    assert (prev.sum(-1) > 0).mean() > 0.8
    score = ncc_aligned(prev, f"{RES}/front/front.jpg")
    assert score > 0.25, f"aligned NCC {score:.3f}"   # shipped-JPG ceiling ~0.4
    # measured 0.90; gate at measured-minus-margin
    fresh = ncc_aligned(prev, f"{FRESH}/front_400.jpg")
    assert fresh > 0.8, f"NCC vs fresh reference {fresh:.3f}"


@pytest.mark.slow
def test_map_graphcut_seams(map_stitched):
    """Graph-cut seam path end to end (cut=True was never e2e-exercised
    in round 1): same geometry gates as the distance-transform run, plus
    seam sanity — full coverage and no double-exposure bands."""
    cfg = _cfg()
    cfg.cut = True
    p = reuse_stitch(map_stitched, cfg)
    assert p.connected == (6, 6)
    prev = p.get_preview()
    h, w = prev.shape[:2]
    assert abs(h / w - 1152 / 2272) < 0.04
    assert (prev.sum(-1) > 0).mean() > 0.85
    # full-width aligned NCC includes the black corner borders (which the
    # reference output crops away), so it runs lower than central-crop
    # NCC (0.83 measured); 0.5 still rejects any broken seam/geometry
    score = ncc_aligned(prev, f"{RES}/map/map.jpg", max_vshift=0.1)
    assert score > 0.5, f"aligned NCC {score:.3f}"
    # fresh-reference gate: the reference's own
    # output at THESE settings incl. cut=true (tools/ref_headless)
    fresh_ref = pathlib.Path(FRESH) / "map_cut_400.jpg"
    if fresh_ref.exists():
        # measured 0.876; gate at measured-minus-margin
        fresh = ncc_aligned(prev, str(fresh_ref), max_vshift=0.1)
        assert fresh > 0.75, f"NCC vs fresh cut reference {fresh:.3f}"
    # seam masks must partition the canvas: every covered pixel owned by
    # exactly one seam mask (mutual exclusion, _graph_cut.cpp:84-115)
    st = p.stitch_params.state
    seams = np.asarray(st.seam_masks)
    offs = np.asarray(st.offs)
    H, W = st.canvas_hw
    n, Hb, Wb = seams.shape
    count = np.zeros((H + Hb, W + Wb), np.int32)
    for i in range(n):
        count[offs[i, 0]:offs[i, 0] + Hb,
              offs[i, 1]:offs[i, 1] + Wb] += seams[i]
    assert count.max() == 1, "overlapping seam ownership"


@pytest.mark.slow
def test_fkh360_sequence(fkh_stitched):
    """36-image 360-degree panorama: full connectivity, the u-unwrap
    produces the golden aspect, content matches up to the free circular
    u-origin."""
    p = fkh_stitched
    assert p.connected == (36, 36)
    prev = p.get_preview()
    h, w = prev.shape[:2]
    ref_aspect = 1067 / 6567
    assert abs(h / w - ref_aspect) < 0.035, f"aspect {h/w:.3f}"
    score = ncc_aligned(prev, f"{RES}/FKH360/FKH.jpg", circular=True)
    assert score > 0.3, f"circular-aligned NCC {score:.3f}"
    # measured ours-vs-fresh: 0.53 (the reference's 360-degree u-unwrap
    # drifts structurally run to run, so the ceiling here is far below
    # the planar sequences'); gate at measured-minus-margin
    fresh = ncc_aligned(prev, f"{FRESH}/FKH360_300.jpg",
                        circular=True)
    assert fresh > 0.45, f"NCC vs fresh reference {fresh:.3f}"


@pytest.mark.slow
def test_map_full_resolution_render(map_stitched):
    """--full-res smoke: the streaming device path
    (render.fullres) re-renders map at native resolution; geometry scales
    by the resolution ratio and content still matches the golden JPG."""
    p = map_stitched
    prev = p.get_preview()
    full = p.get_panorama()
    h, w = prev.shape[:2]
    fh, fw = full.shape[:2]
    # inputs are 1142 px wide vs the 400-px working resolution
    ratio = fw / w
    assert 2.3 < ratio < 3.4, f"full/preview ratio {ratio:.2f}"
    assert abs(fh / fw - h / w) < 0.03
    assert (full.sum(-1) > 0).mean() > 0.85
    score = ncc_aligned(full, f"{RES}/map/map.jpg", max_vshift=0.1)
    assert score > 0.5, f"aligned NCC {score:.3f}"


@pytest.mark.slow
def test_stereographic_center_fix_e2e(fkh_stitched,
                                      _no_persistent_compile_cache):
    """Stereographic little planet on the real 360 sequence: without the
    fix the nadir is a large hole; with fix_center the circle is detected,
    disk_reproj closes it in the preview AND the full-res render re-runs
    the estimate/reproj + inpaint at full resolution (return_full,
    _panorama.cpp:292-311,342-350). Measured: center-dark 0.79 -> 0.03."""
    from simplepanorama_tpu import stitcher
    from simplepanorama_tpu.config import Projection

    def center_dark(img, frac=6):
        h, w = img.shape[:2]
        c = img[h // 2 - h // frac:h // 2 + h // frac,
                w // 2 - w // frac:w // 2 + w // frac]
        return float((c.sum(-1) <= 3).mean())

    cfg = _cfg(init_size=300)
    cfg.proj = Projection.STEREOGRAPHIC
    cfg.fix_center = True
    p = reuse_stitch(fkh_stitched, cfg)
    assert p.connected == (36, 36)
    assert p.stitch_params.sten_circle is not None, "fix did not trigger"

    prev = p.get_preview()
    h, w = prev.shape[:2]
    assert 0.9 < h / w < 1.1, f"planet aspect {h/w:.3f}"
    assert center_dark(prev) < 0.10, f"preview hole {center_dark(prev):.3f}"

    full = p.get_panorama()
    fh, fw = full.shape[:2]
    assert fh > 1.5 * h, "full-res render not larger than preview"
    assert center_dark(full) < 0.10, f"full-res hole {center_dark(full):.3f}"

    # fresh-reference gate (the sten corpus's INPUT photos are not
    # bundled, so the reference's stereographic path is exercised on
    # FKH360 instead): the little planet's disk rotation is a free
    # u-origin gauge, so compare ROTATION-INVARIANT radial intensity
    # profiles against the reference's own output at these settings
    # (tools/ref_headless, tests/data/ref_fresh/FKH360_sten_300.jpg)
    import pathlib as _pl
    ref_path = _pl.Path(FRESH) / "FKH360_sten_300.jpg"
    if ref_path.exists():
        import cv2

        def radial_profile(img, nbins=64):
            g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float32)
            hh, ww = g.shape
            yy, xx = np.mgrid[:hh, :ww]
            r = np.sqrt(((yy - hh / 2) / (hh / 2)) ** 2
                        + ((xx - ww / 2) / (ww / 2)) ** 2)
            prof = np.zeros(nbins)
            for b in range(nbins):
                m = (r >= b / nbins) & (r < (b + 1) / nbins)
                prof[b] = g[m].mean() if m.any() else 0.0
            return prof

        a = radial_profile(prev)
        bprof = radial_profile(cv2.imread(str(ref_path)))
        an = (a - a.mean()) / (a.std() + 1e-6)
        bn = (bprof - bprof.mean()) / (bprof.std() + 1e-6)
        score = float((an * bn).mean())
        assert score > 0.8, f"radial-profile NCC vs fresh ref {score:.3f}"

    # same stitch WITHOUT the fix: the hole must be there (sanity that the
    # gate actually measures the feature)
    cfg2 = _cfg(init_size=300)
    cfg2.proj = Projection.STEREOGRAPHIC
    cfg2.fix_center = False
    imgs = [p.images.img_data[g] for g in p.result.nodes]
    params2 = stitcher.set_config(p.result, imgs, cfg2)
    prev2 = stitcher.render_preview(params2, cfg2)
    assert center_dark(prev2) > 0.4, "expected nadir hole without the fix"
