import textwrap

from simplepanorama_tpu.config import (
    Blending, Projection, Stretch, Config,
    read_config_file, write_config_file,
)


def test_defaults_match_reference():
    c = Config()
    assert c.threads == 8
    assert c.init_size == 700
    assert c.blend == Blending.MULTI_BLEND
    assert not c.gain_compensation
    assert c.blend_intensity
    assert not c.cut
    assert c.cut_seams
    assert c.bands == 2
    assert c.sigma_blend == 7.0
    assert c.straighten
    assert c.proj == Projection.SPHERICAL
    assert c.fix_center
    assert c.stretching == Stretch.QUADRATIC_SCALING
    assert c.focal == 700.0
    assert c.lambda_ == 0.05
    assert not c.fast
    assert c.max_images_per_match == 5
    assert c.max_keypoints == 250
    assert c.RANSAC_iterations == 1500
    assert c.x_margin == 4
    assert abs(c.min_overlap - 0.15) < 1e-9
    assert abs(c.overlap_inl_match - 0.1) < 1e-9
    assert abs(c.overlap_inl_keyp - 0.005) < 1e-9
    assert abs(c.conf - 0.025) < 1e-9
    assert c.nOctaveLayers == 4
    assert abs(c.contrastThreshold - 0.03) < 1e-12
    assert c.edgeThreshold == 6.0
    assert abs(c.sigma_sift - 1.4142) < 1e-9


def test_round_trip(tmp_path):
    c = Config(init_size=900, blend=Blending.SIMPLE_BLEND, cut=True,
               proj=Projection.CYLINDRICAL, fast=True, lambda_=0.1)
    p = tmp_path / "config"
    write_config_file(p, c)
    c2 = read_config_file(p)
    assert c2.init_size == 900
    assert c2.blend == Blending.SIMPLE_BLEND
    assert c2.cut
    assert c2.proj == Projection.CYLINDRICAL
    assert c2.fast
    assert abs(c2.lambda_ - 0.1) < 1e-6


def test_reads_reference_style_file(tmp_path):
    # key names as written by the reference's ConfigParser
    txt = textwrap.dedent("""\
        # comment line
        Threads = 4
        Method = NO_BLEND
        Projection = STEREOGRAPHIC
        Stretch = LINEAR_SCALING
        Adjustment = true
        Use_Cut = false
        confidence = 0.05
        unknown_key = whatever
    """)
    p = tmp_path / "config"
    p.write_text(txt)
    c = read_config_file(p)
    assert c.threads == 4
    assert c.blend == Blending.NO_BLEND
    assert c.proj == Projection.STEREOGRAPHIC
    assert c.stretching == Stretch.LINEAR_SCALING
    assert c.fast
    assert not c.cut_seams
    assert abs(c.conf - 0.05) < 1e-6


def test_bench_comm_accounting_shape():
    """bench.bench_comm_accounting is a pure function of stage timings;
    its forecast must be well-formed and monotone in mesh size."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).parent.parent / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    seqs = {"map": {"images": 6, "preview_shape": [709, 1396],
                    "stages_s": {
        "keypoints": 0.5, "matching": 0.25, "bundle_adjust": 0.28,
        "render_preview": 0.2, "compositing": 0.18, "warp": 0.1,
        "equalize": 0.03, "dist_cut": 0.03, "load": 0.05}}}
    acc = bench.bench_comm_accounting(seqs)
    per = acc["per_sequence"]["map"]["per_mesh"]
    assert set(per) == {"2_chips", "4_chips", "8_chips"}
    effs = [per[k]["forecast_efficiency"] for k in
            ("2_chips", "4_chips", "8_chips")]
    assert all(0 < e <= 1.0 for e in effs)
    assert effs[0] >= effs[1] >= effs[2]      # Amdahl monotonicity
    for k in per:
        assert per[k]["collective_bytes"]["bundle_adjust"] > 0
        # blend collectives charged to the stage that runs them
        # (the old standalone `blend` key matched no
        # measured stage and its bytes were silently dropped)
        assert per[k]["collective_bytes"]["compositing"] > 0
    assert acc["per_sequence"]["map"]["amdahl_ceiling_efficiency"]
