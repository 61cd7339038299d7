"""Two-process multi-host smoke over loopback DCN (SURVEY §7 step 8):
jax.distributed with 2 CPU processes, per-host image shards for feature
extraction, process_allgather of the feature tables, and a global-mesh
psum — the communication pattern run_pipeline's stages use across hosts."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid = sys.argv[1], int(sys.argv[2])
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=2, process_id=pid)
    assert jax.process_count() == 2
    assert jax.device_count() == 4          # 2 local x 2 processes

    import numpy as np
    import cv2
    sys.path.insert(0, "/root/repo")
    from simplepanorama_tpu.config import Config
    from simplepanorama_tpu.features import extract_features
    from simplepanorama_tpu.parallel.multihost import host_shard, global_mesh

    # every process holds the same 3-image list; extraction shards by host
    paths = sorted(__import__("glob").glob(
        "/root/reference/results/map/budapest*.jpg"))[:3]
    from simplepanorama_tpu.io import clamp_to_init_size
    imgs = [clamp_to_init_size(cv2.imread(p), 300) for p in paths]
    cfg = Config()
    assert host_shard(list(range(3))) == ([0, 1] if pid == 0 else [2])
    feats = extract_features(imgs, cfg)
    assert len(feats) == 3
    counts = [f.count for f in feats]
    assert all(c > 50 for c in counts), counts

    # a psum over the global 4-device mesh rides loopback DCN
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils
    mesh = global_mesh()
    x = multihost_utils.host_local_array_to_global_array(
        np.ones((4, 8), np.float32) * (pid + 1), mesh, P("data"))
    from jax import shard_map
    s = shard_map(lambda v: jax.lax.psum(jnp.sum(v), "data"), mesh=mesh,
                  in_specs=P("data"), out_specs=P())
    total = jax.jit(s)(x)
    # global array: proc0 rows (value 1) + proc1 rows (value 2)
    assert abs(float(total) - (4*8*1.0 + 4*8*2.0)) < 1e-3, float(total)

    print(f"proc {pid}: ok counts={counts} psum={float(total)}", flush=True)
""")


_WORKER_MATCH_BA = textwrap.dedent("""
    import os, sys, json
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid, outp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=2, process_id=pid)
    import numpy as np
    import cv2, glob
    sys.path.insert(0, "/root/repo")
    from simplepanorama_tpu.config import Config
    from simplepanorama_tpu.io import clamp_to_init_size
    from simplepanorama_tpu.features import extract_features
    from simplepanorama_tpu.adjacency import build_adjacency
    from simplepanorama_tpu.geometry.graph import connected_components
    from simplepanorama_tpu.geometry.focal import focal_from_hom
    from simplepanorama_tpu.stitch import bundle_adjust_stitching

    paths = sorted(glob.glob(
        "/root/reference/results/map/budapest*.jpg"))[:4]
    imgs = [clamp_to_init_size(cv2.imread(p), 300) for p in paths]
    cfg = Config(); cfg.init_size = 300; cfg.RANSAC_iterations = 500
    feats = extract_features(imgs, cfg)
    # the multihost path must keep the device feature tables alive
    assert feats.device_batch is not None
    sizes = [im.shape[:2] for im in imgs]
    adjres = build_adjacency(feats, sizes, cfg)       # pairs host-sharded
    comp = connected_components(adjres.adj)[0]
    focal = focal_from_hom(adjres.hom_mat, adjres.adj)
    if focal <= 0: focal = float(cfg.focal)
    res = bundle_adjust_stitching(comp, adjres, sizes, focal, cfg)
    out = {"adj": adjres.adj.tolist(),
           "nodes": list(map(int, res.nodes)),
           "focal": [float(f) for f in res.K[:, 0, 0]],
           "rot": [r.tolist() for r in res.rot]}
    open(outp, "w").write(json.dumps(out))
    print(f"proc {pid}: ok", flush=True)
""")


_WORKER_TILED = textwrap.dedent("""
    import os, sys, json
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    coord, pid, outp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=2, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils
    sys.path.insert(0, "/root/repo")
    from simplepanorama_tpu.parallel.multihost import global_mesh
    from simplepanorama_tpu.parallel import tiled_compose as tc

    mesh = global_mesh()                     # 2 procs x 2 local devices
    assert mesh.devices.size == 4

    # deterministic blocks, identical in both processes (seeded)
    rng = np.random.default_rng(0)
    n, Hb, Wb, H, W = 4, 40, 128, 96, 320
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    origs = np.zeros((n, Hb, Wb), np.float32)
    seams = np.zeros((n, Hb, Wb), np.float32)
    offs = np.zeros((n, 2), np.int32)
    for i in range(n):
        h, w = int(rng.integers(20, Hb + 1)), int(rng.integers(60, Wb + 1))
        origs[i, :h, :w] = 1.0
        seams[i, int(rng.integers(0, 5)):h, int(rng.integers(0, 20)):w] = 1.0
        offs[i] = (int(rng.integers(0, H - Hb + 1)),
                   int(rng.integers(0, W - Wb + 1)))

    # image batch sharded over the GLOBAL mesh: this process feeds its
    # contiguous half; psum_scatter and the lazy all_gather ride
    # loopback DCN between the two processes
    def shard(x):
        nl = x.shape[0] // 2
        return multihost_utils.host_local_array_to_global_array(
            x[pid * nl:(pid + 1) * nl], mesh, P("data"))

    out = tc.multi_blend_sharded(
        shard(jnp.asarray(imgs)), shard(jnp.asarray(seams)),
        shard(jnp.asarray(origs)), shard(jnp.asarray(offs)),
        (H, W), mesh, bands=2, sigma=5.0)
    rep = jax.jit(lambda x: x,
                  out_shardings=NamedSharding(mesh, P()))(out)
    canvas = np.asarray(rep.addressable_data(0))

    # halo_exchange across the process boundary: a column-sharded iota
    # slab, each device's halos must hold its mesh neighbors' edge
    # columns (the ppermute hop 1<->2 crosses DCN)
    from jax import shard_map
    Wt = 16
    base = jnp.arange(4 * Wt, dtype=jnp.float32).reshape(1, 4 * Wt)
    xg = multihost_utils.host_local_array_to_global_array(
        np.asarray(base).reshape(1, 4, Wt)[:, 2 * pid:2 * pid + 2]
        .reshape(1, 2 * Wt), mesh, P(None, "data"))
    halo = jax.jit(shard_map(
        lambda v: tc.halo_exchange(v, 2, "data", fill=-1.0),
        mesh=mesh, in_specs=P(None, "data"),
        out_specs=P(None, "data")))(xg)
    halo_rep = jax.jit(lambda x: x,
                       out_shardings=NamedSharding(mesh, P()))(halo)
    hv = np.asarray(halo_rep.addressable_data(0)).reshape(4, Wt + 4)
    expect_ok = True
    for d in range(4):
        left = hv[d, :2]
        want = ([-1.0, -1.0] if d == 0
                else [d * Wt - 2.0, d * Wt - 1.0])
        expect_ok &= np.allclose(left, want)
        right = hv[d, -2:]
        want = ([-1.0, -1.0] if d == 3
                else [(d + 1) * Wt + 0.0, (d + 1) * Wt + 1.0])
        expect_ok &= np.allclose(right, want)
    assert expect_ok, hv

    np.save(outp, canvas)
    print(f"proc {pid}: ok", flush=True)
""")


@pytest.mark.slow
def test_two_process_tiled_compose(tmp_path):
    """Multi-host compositing smoke: the
    psum_scatter multiband blend and the ppermute halo exchange run over
    2-process loopback DCN and reproduce the single-device blend."""
    if os.environ.get("SPT_TEST_PLATFORM", "cpu") != "cpu":
        pytest.skip("multi-process smoke runs on the CPU backend")
    import jax.numpy as jnp
    from simplepanorama_tpu.render.blending import multi_blend

    # the same deterministic blocks the workers generate
    rng = np.random.default_rng(0)
    n, Hb, Wb, H, W = 4, 40, 128, 96, 320
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    origs = np.zeros((n, Hb, Wb), np.float32)
    seams = np.zeros((n, Hb, Wb), np.float32)
    offs = np.zeros((n, 2), np.int32)
    for i in range(n):
        h, w = int(rng.integers(20, Hb + 1)), int(rng.integers(60, Wb + 1))
        origs[i, :h, :w] = 1.0
        seams[i, int(rng.integers(0, 5)):h, int(rng.integers(0, 20)):w] = 1.0
        offs[i] = (int(rng.integers(0, H - Hb + 1)),
                   int(rng.integers(0, W - Wb + 1)))
    ref = np.asarray(multi_blend(jnp.asarray(imgs), jnp.asarray(seams),
                                 jnp.asarray(origs), jnp.asarray(offs),
                                 (H, W), bands=2, sigma=5.0))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker_tc.py"
    script.write_text(_WORKER_TILED)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    outs = [tmp_path / f"tc{i}.npy" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(i), str(outs[i])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process tiled compose timed out")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {i} failed:\n{log[-3000:]}"
    c0 = np.load(outs[0])
    c1 = np.load(outs[1])
    np.testing.assert_allclose(c0, c1, atol=1e-5)   # identical global view
    np.testing.assert_allclose(c0, ref, atol=2e-2)  # float reassociation


@pytest.mark.slow
def test_two_process_match_and_ba(tmp_path):
    """Pair verification host-sharded + BA over the global mesh: the
    2-process result must match the single-process pipeline (per-pair
    RANSAC keys make the adjacency identical; LM differs only by float
    reassociation across the different mesh)."""
    if os.environ.get("SPT_TEST_PLATFORM", "cpu") != "cpu":
        pytest.skip("multi-process smoke runs on the CPU backend")
    import cv2
    import glob
    from simplepanorama_tpu.config import Config
    from simplepanorama_tpu.io import clamp_to_init_size
    from simplepanorama_tpu.features import extract_features
    from simplepanorama_tpu.adjacency import build_adjacency
    from simplepanorama_tpu.geometry.graph import connected_components
    from simplepanorama_tpu.geometry.focal import focal_from_hom
    from simplepanorama_tpu.stitch import bundle_adjust_stitching

    paths = sorted(glob.glob(
        "/root/reference/results/map/budapest*.jpg"))[:4]
    imgs = [clamp_to_init_size(cv2.imread(p), 300) for p in paths]
    cfg = Config()
    cfg.init_size = 300
    cfg.RANSAC_iterations = 500
    feats = extract_features(imgs, cfg)
    sizes = [im.shape[:2] for im in imgs]
    adjres = build_adjacency(feats, sizes, cfg)
    comp = connected_components(adjres.adj)[0]
    focal = focal_from_hom(adjres.hom_mat, adjres.adj)
    res = bundle_adjust_stitching(comp, adjres, sizes, focal, cfg)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker_mb.py"
    script.write_text(_WORKER_MATCH_BA)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(i), str(outs[i])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process match+BA timed out")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {i} failed:\n{log[-3000:]}"

    import json
    r0 = json.loads(outs[0].read_text())
    r1 = json.loads(outs[1].read_text())
    # both processes hold the identical global result
    assert r0 == r1
    # adjacency bit-matches single-process (per-pair keys)
    np.testing.assert_allclose(np.array(r0["adj"]), adjres.adj,
                               rtol=0, atol=1e-5)
    assert r0["nodes"] == list(map(int, res.nodes))
    # BA close to the single-process run. The meshes differ (2x2-device
    # global vs 8-device local), so ~50 LM iterations of reassociated
    # float sums walk the weakly-constrained focal direction a little
    # (measured 1.3%); rotations are the tightly-constrained quantity.
    np.testing.assert_allclose(np.array(r0["focal"]), res.K[:, 0, 0],
                               rtol=0.05)
    for a, b in zip(r0["rot"], res.rot):
        A = np.array(a)
        c = (np.trace(A @ b.T) - 1.0) / 2.0
        ang = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
        assert ang < 0.5, f"rotation deviates {ang:.3f} deg"


@pytest.mark.slow
def test_two_process_feature_shard_and_psum(tmp_path):
    if os.environ.get("SPT_TEST_PLATFORM", "cpu") != "cpu":
        pytest.skip("multi-process smoke runs on the CPU backend")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process smoke timed out")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: ok" in out
