"""End-to-end smoke run of the stitcher on one NVIDIA GPU.

    python chip_smoke.py [--seed N]
    python chip_smoke.py --four-cards [--seed N]

Phases, each printing one JSON line (``"phase"``) with its elapsed time:

  0. device: the JAX backend must be the GPU (the script never falls back
     to the CPU); prints the device kind and count, the card's name and
     power limit from nvidia-smi, whether cv2 imports, and the compile
     cache directory;
  1. generate: seeded views of a procedural scene with known cameras
     (simplepanorama_tpu.utils.synth), written as PNG to a temporary
     directory;
  2. map: 6 views of 700 x 467 px through Panorama(paths).stitch(Config())
     at the reference defaults, then get_preview() and get_panorama();
     run twice (cold with compilation, then warm), per-stage times from
     utils.timing.global_timer(), checked against the ground truth;
  3. front: 14 views in two rows, Config(cut=True) (graph-cut seams on the
     device), same checks and timings;
  4. mincut: a 500 x 700 seam graph from two overlapping generated views,
     solved on the device by ops.maxflow.grid_mincut and on the host by
     the exact Dinic oracle (native/mincut.cpp); cut values must agree
     within 1e-3 relative; prints the median device time of 5 runs.

With ``--four-cards`` the script needs 4 GPUs and runs only phases 2-3,
each twice in one process: sharded over the 4 cards
(parallel.mesh.pipeline_mesh) and on one card
(parallel.mesh.PIPELINE_SHARDING = False), and compares the two.

A failed check ends the script with a non-zero exit code. On success the
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

# sharded vs one-card results differ only by f32 summation order (psum
# partials in BA and blending), which bundle adjustment can amplify
# slightly; well below the ground-truth tolerances
FOUR_CARD_FOCAL_TOL = 0.005
FOUR_CARD_ROT_TOL_DEG = 0.25
FOUR_CARD_MIN_NCC = 0.99
# both min-cut solvers are exact; only f32 summation order differs
MINCUT_REL_TOL = 1e-3


class CheckFailed(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def phase_device(n_cards: int) -> dict:
    import jax
    t0 = time.perf_counter()
    devs = jax.devices()
    backend = jax.default_backend()
    check(backend == "gpu" and all(d.platform == "gpu" for d in devs),
          f"JAX backend is {backend!r} ({[d.platform for d in devs]}), "
          f"not the GPU")
    check(len(devs) >= n_cards, f"{len(devs)} GPUs, {n_cards} needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    from simplepanorama_tpu import compile_cache_dir
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    emit("device", **dev, nvidia_smi=smi.stdout.strip().splitlines(),
         cv2=has_cv2, compile_cache_dir=compile_cache_dir(),
         seconds=time.perf_counter() - t0)
    return dev


def phase_generate(out_dir: pathlib.Path, seed: int):
    from simplepanorama_tpu.utils import synth
    t0 = time.perf_counter()
    scene = synth.make_scene(seed)
    sets = {"map": synth.write_sequence(out_dir / "map", "map", seed,
                                        scene=scene),
            "front": synth.write_sequence(out_dir / "front", "front", seed,
                                          scene=scene)}
    emit("generate", views={k: len(v.paths) for k, v in sets.items()},
         size_hw=list(sets["map"].size), focal=sets["map"].focal,
         seconds=time.perf_counter() - t0)
    return scene, sets


def stitch_once(truth, cfg) -> dict:
    """One Panorama run through the public API, with per-stage times and
    the ground-truth checks."""
    from simplepanorama_tpu import Panorama
    from simplepanorama_tpu.utils import synth
    from simplepanorama_tpu.utils.timing import global_timer
    timer = global_timer()
    timer.durations.clear()
    timer.counts.clear()
    t0 = time.perf_counter()
    p = Panorama(truth.paths).stitch(cfg)
    t1 = time.perf_counter()
    preview = p.get_preview()
    t2 = time.perf_counter()
    full = p.get_panorama()
    t3 = time.perf_counter()
    n = len(truth.paths)
    check(tuple(p.connected) == (n, n),
          f"connected {p.connected}, expected ({n}, {n})")
    check(full.ndim == 3 and full.shape[2] == 3 and full.dtype.name ==
          "uint8", f"full panorama {full.shape} {full.dtype}")
    err = synth.stitch_errors(p.result, truth)
    cov = synth.coverage(preview)
    check(err["focal_err"] <= synth.FOCAL_TOL,
          f"focal error {err['focal_err']:.4f} > {synth.FOCAL_TOL}")
    rot_tol = synth.ROT_TOL_DEG[truth.size[1]]
    check(err["rot_err_deg"] <= rot_tol,
          f"rotation error {err['rot_err_deg']:.3f} deg > {rot_tol}")
    check(cov >= synth.MIN_COVERAGE,
          f"preview coverage {cov:.3f} < {synth.MIN_COVERAGE}")
    return {"stitch_s": t1 - t0, "preview_s": t2 - t1,
            "panorama_s": t3 - t2, "total_s": t3 - t0,
            "stages_s": dict(sorted(timer.durations.items(),
                                    key=lambda kv: -kv[1])),
            **err, "coverage": cov, "preview_shape": list(preview.shape),
            "panorama_shape": list(full.shape),
            "rot": p.result.rot, "focal": p.result.K[:, 0, 0],
            "preview": preview}


def _public(run: dict) -> dict:
    return {k: v for k, v in run.items()
            if k not in ("rot", "focal", "preview")}


def phase_stitch(name: str, truth, cfg) -> None:
    t0 = time.perf_counter()
    cold = stitch_once(truth, cfg)
    warm = stitch_once(truth, cfg)
    emit(name, views=len(truth.paths), cold=_public(cold),
         warm=_public(warm), compile_s_estimate=cold["total_s"]
         - warm["total_s"], seconds=time.perf_counter() - t0)


def phase_mincut(scene) -> None:
    """The 500 x 700 seam graph: two overlapping crops (offset 40, 180 px)
    of one generated 1400 x 1000 view, scene mask over the left 60 %,
    element mask over the right 65 %."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from simplepanorama_tpu.native import grid_mincut_native
    from simplepanorama_tpu.ops.maxflow import cut_value, grid_mincut
    from simplepanorama_tpu.render.graphcut import _build_cut_graph
    from simplepanorama_tpu.utils import synth
    t0 = time.perf_counter()
    img = synth.render_view(scene, synth.rotation(0.0, 0.0, 0.0), 1400.0,
                            (1400, 1000))
    g = (0.114 * img[..., 0] + 0.587 * img[..., 1]
         + 0.299 * img[..., 2]).astype(np.float32)
    H, W, dy, dx = 500, 700, 40, 180
    m1 = np.zeros((H, W), np.float32)
    m1[2:H - 2, 2:int(W * 0.60)] = 255.0
    m2 = np.zeros((H, W), np.float32)
    m2[2:H - 2, int(W * 0.35):W - 2] = 255.0
    graph = _build_cut_graph(jnp.asarray(g[:H, :W]),
                             jnp.asarray(g[dy:dy + H, dx:dx + W]),
                             jnp.asarray(m1), jnp.asarray(m2))
    tc = time.perf_counter()
    side = jax.block_until_ready(grid_mincut(*graph))
    compile_s = time.perf_counter() - tc
    times = []
    for _ in range(5):
        tr = time.perf_counter()
        side = jax.block_until_ready(grid_mincut(*graph))
        times.append(time.perf_counter() - tr)
    wh, wv, exc, obj = (np.asarray(a) for a in graph)
    th = time.perf_counter()
    side_n, flow = grid_mincut_native(wh, wv, exc, obj)
    host_s = time.perf_counter() - th
    v_dev = cut_value(wh, wv, exc, obj, np.asarray(side))
    v_host = cut_value(wh, wv, exc, obj, side_n)
    rel = abs(v_dev - v_host) / max(1.0, v_host)
    check(rel <= MINCUT_REL_TOL,
          f"min-cut value {v_dev} vs Dinic {v_host} (rel {rel:.2e})")
    emit("mincut", grid=[H, W], cut_value_device=v_dev,
         cut_value_dinic=v_host, dinic_flow=flow, rel_diff=rel,
         device_median_s=statistics.median(times), device_runs_s=times,
         first_call_s=compile_s, dinic_host_s=host_s,
         seconds=time.perf_counter() - t0)


def _ncc(a, b) -> float:
    import numpy as np
    h = min(a.shape[0], b.shape[0])
    w = min(a.shape[1], b.shape[1])
    x = a[:h, :w].astype(np.float64).ravel()
    y = b[:h, :w].astype(np.float64).ravel()
    x -= x.mean()
    y -= y.mean()
    return float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))


def phase_four_cards(name: str, truth, cfg) -> None:
    """The same stitch sharded over 4 cards and on one card."""
    import numpy as np
    from simplepanorama_tpu.parallel import mesh as pmesh
    t0 = time.perf_counter()
    pmesh.PIPELINE_SHARDING = True
    mesh = pmesh.pipeline_mesh()
    check(mesh is not None and mesh.size == 4,
          f"pipeline mesh {mesh} is not 4 cards")
    sharded = stitch_once(truth, cfg)
    pmesh.PIPELINE_SHARDING = False
    try:
        single = stitch_once(truth, cfg)
    finally:
        pmesh.PIPELINE_SHARDING = True
    d_focal = float(np.max(np.abs(sharded["focal"] / single["focal"]
                                  - 1.0)))
    d_rot = max(
        float(np.degrees(np.arccos(np.clip(
            (np.trace(a.T @ b) - 1.0) / 2.0, -1.0, 1.0))))
        for a, b in zip(sharded["rot"], single["rot"]))
    ncc = _ncc(sharded["preview"], single["preview"])
    check(d_focal <= FOUR_CARD_FOCAL_TOL,
          f"{name}: focal differs by {d_focal:.5f} between 4 cards and 1")
    check(d_rot <= FOUR_CARD_ROT_TOL_DEG,
          f"{name}: rotations differ by {d_rot:.4f} deg")
    check(ncc >= FOUR_CARD_MIN_NCC, f"{name}: preview NCC {ncc:.4f}")
    emit(f"{name}_four_cards", views=len(truth.paths),
         sharded=_public(sharded), single=_public(single),
         focal_rel_diff=d_focal, rot_diff_deg=d_rot, preview_ncc=ncc,
         seconds=time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run phases 2-3 sharded over 4 GPUs and on one, "
                         "and compare them")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    try:
        dev = phase_device(n_cards)
    except (CheckFailed, ImportError, OSError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: device check failed: {e}", file=sys.stderr)
        return 1
    if args.four_cards:
        check(dev["count"] == 4, f"{dev['count']} GPUs, need exactly 4")
    import os
    # drain the device at stage boundaries so each stage's time includes
    # the device work it dispatched
    os.environ["SPT_SYNC_STAGES"] = "1"
    from simplepanorama_tpu import Config
    with tempfile.TemporaryDirectory(prefix="spt_smoke_") as tmp:
        scene, sets = phase_generate(pathlib.Path(tmp), args.seed)
        cut_cfg = Config()
        cut_cfg.cut = True
        jobs = [("map", sets["map"], Config()),
                ("front", sets["front"], cut_cfg)]
        if args.four_cards:
            for name, truth, cfg in jobs:
                phase_four_cards(name, truth, cfg)
        else:
            for name, truth, cfg in jobs:
                phase_stitch(name, truth, cfg)
            phase_mincut(scene)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
