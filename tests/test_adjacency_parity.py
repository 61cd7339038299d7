"""Adjacency parity vs the REFERENCE'S OWN CODE.

The recorded values below were produced by compiling the reference's
unmodified matching stack (_homography.cpp + _util.cpp) into a headless
harness (tools/ref_oracle/) and running it on the bundled map sequence at
init_size=700 with pan::config defaults — the reference's panorama::test
inspection output (/root/reference/src/classes/_panorama.cpp:572-609)
reproduced exactly. Regenerate with:  bash tools/ref_oracle/build_and_run.sh

Our raw ratio-test counts are not absolutely comparable (the device SIFT
keeps a fixed top-1024-by-response keypoint capacity; the reference
keeps all ~8000), so raw counts are gated on rank correlation; the
accepted pair SET and the geometric overlap weights must match directly.
"""

import glob

import numpy as np
import pytest

# tools/ref_oracle output, map @ init_size=700 (reference defaults)
REF_RAW = np.array([
    [0, 1626, 110, 2117, 1007, 112],
    [0, 0, 2601, 996, 2309, 1304],
    [0, 0, 0, 123, 1300, 2815],
    [0, 0, 0, 0, 1732, 100],
    [0, 0, 0, 0, 0, 2274],
    [0, 0, 0, 0, 0, 0]], float)
REF_WEIGHTS = np.array([
    [0, .4419, 0, .5690, .2666, 0],
    [0, 0, .5625, .2571, .5744, .3340],
    [0, 0, 0, 0, .3219, .6098],
    [0, 0, 0, 0, .4712, 0],
    [0, 0, 0, 0, 0, .5333],
    [0, 0, 0, 0, 0, 0]])


@pytest.mark.slow
def test_map_adjacency_matches_reference_oracle():
    from simplepanorama_tpu.pipeline import diagnose
    from simplepanorama_tpu.config import Config
    paths = sorted(glob.glob("/root/reference/results/map/budapest*.jpg"))
    d = diagnose(paths, Config())

    ours_w = d["adjacency"]
    ours_raw = d["raw_match_counts"]

    # 1. identical accepted pair set
    ref_pairs = {tuple(p) for p in zip(*np.nonzero(REF_WEIGHTS))}
    our_pairs = {tuple(int(v) for v in p)
                 for p in zip(*np.nonzero(ours_w))}
    assert our_pairs == ref_pairs, (our_pairs, ref_pairs)

    # 2. overlap weights (pure homography geometry) within 3 points
    diff = np.abs(ours_w - REF_WEIGHTS)[REF_WEIGHTS > 0]
    assert diff.max() < 0.03, f"max weight diff {diff.max():.4f}"

    # 3. raw ratio-test counts rank-correlate despite the keypoint cap
    iu = np.triu_indices(6, 1)
    a, b = ours_raw[iu], REF_RAW[iu]
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    rho = np.corrcoef(ra, rb)[0, 1]
    assert rho > 0.9, f"raw-count rank correlation {rho:.3f}"

    # 4. focal estimate vs the reference's own focal_from_hom on the same
    # input (oracle prints 2889.78 — large because the map scene is
    # near-planar, which ill-conditions Szeliski-Shum; BA refines it).
    # The keypoint cap shifts the RANSAC homographies slightly, so gate
    # at +-25% of the recorded reference value.
    assert abs(d["focal_estimate"] - 2889.78) / 2889.78 < 0.25, \
        d["focal_estimate"]


# ---------------------------------------------------------------------------
# Breadth: brocken + front vs the reference oracle.
# Recorded fixture: tests/data/adjacency_oracle_bf.json; regenerate with
#   bash tools/ref_oracle/build_and_run.sh brocken|front
#
# Keypoint-capacity sensitivity (measured 2026-08-21 on the chip,
# diagnose at max_kp_detect 1024 vs 2048): the accepted pair set, the
# missing pairs, and the weight agreement are IDENTICAL at both
# capacities (brocken: 39 pairs, Jaccard .809 vs the oracle's 46, both
# caps missing the same {(1,8),(2,4),(3,5),(4,6)}; front: 48 pairs,
# Jaccard .980, both caps missing only (0,5); weights agree to <=.015;
# raw-count rank correlation .94/.91 -> .95 at 2048). The dropped pairs
# therefore come from heuristic_match_filter's top-5-by-raw-count
# candidate ranking (slightly different raw counts change which WEAK
# candidates get verified), not from the 1024 cap — which justifies the
# 1024 default (2048 doubles SIFT/matching cost for zero adjacency
# gain). All sequences remain fully connected either way.
# ---------------------------------------------------------------------------

import json as _json
import pathlib as _pathlib

_BF = _json.loads((_pathlib.Path(__file__).parent / "data" /
                   "adjacency_oracle_bf.json").read_text())

_SEQ_GLOB = {
    "brocken": "/root/reference/results/brocken/resized*.jpg",
    "front": "/root/reference/results/front/resized*.jpg",
}


@pytest.mark.slow
@pytest.mark.parametrize("seq", ["brocken", "front"])
def test_adjacency_breadth_vs_oracle(seq):
    from simplepanorama_tpu.pipeline import diagnose
    from simplepanorama_tpu.config import Config
    ref = _BF[seq]
    W_ref = np.array(ref["adj_weights"])
    n = W_ref.shape[0]
    d = diagnose(sorted(glob.glob(_SEQ_GLOB[seq])), Config())
    W = d["adjacency"]

    ref_pairs = {(i, j) for i in range(n) for j in range(n)
                 if W_ref[i, j] > 0}
    our_pairs = {(int(i), int(j)) for i, j in zip(*np.nonzero(W))}

    # high overlap of the accepted sets (weak candidates may differ via
    # the top-5 raw-count filter — see module comment; measured .81/.98)
    jac = len(our_pairs & ref_pairs) / len(our_pairs | ref_pairs)
    assert jac >= 0.75, f"pair-set Jaccard {jac:.3f}"

    # the scene graph must stay one fully-connected component
    from simplepanorama_tpu.geometry.graph import connected_components
    comps = connected_components(np.asarray(W))
    assert len(comps[0].nodes) == n, "graph no longer fully connected"

    # overlap weights (homography geometry) close on shared pairs
    # (measured <= .015)
    shared = our_pairs & ref_pairs
    wd = max(abs(W[p] - W_ref[p]) for p in shared)
    assert wd < 0.05, f"max weight diff {wd:.4f}"

    # focal estimate close to the reference's own focal_from_hom
    # (measured within 3.5%)
    assert abs(d["focal_estimate"] - ref["focal"]) / ref["focal"] < 0.1

    # raw ratio-test counts rank-correlate despite the keypoint cap
    iu = np.triu_indices(n, 1)
    a = np.asarray(d["raw_match_counts"])[iu]
    b = np.array(ref["raw_counts"])[iu]
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    rho = np.corrcoef(ra, rb)[0, 1]
    assert rho > 0.85, f"raw-count rank correlation {rho:.3f}"
