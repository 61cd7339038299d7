"""Grid min-cut tests: scipy maximum_flow oracle + seam-shape sanity.

The reference validates nothing here (it trusts the vendored BK library);
we check that the data-parallel push-relabel reaches the same min-cut
VALUE as an exact solver on the same graph (ties in the cut set are
allowed — any minimum cut is a valid seam).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from simplepanorama_tpu.ops.maxflow import cut_value, grid_mincut


_cut_value = cut_value


def _scipy_mincut_value(wh, wv, excess, node, scale=10000):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow
    H, W = wh.shape
    n = H * W
    src, snk = n, n + 1
    rows, cols, caps = [], [], []

    def add(u, v, c):
        c = int(round(c * scale))
        if c > 0:
            rows.append(u); cols.append(v); caps.append(c)

    for y in range(H):
        for x in range(W):
            u = y * W + x
            if not node[y, x]:
                continue
            if x + 1 < W and node[y, x + 1]:
                add(u, u + 1, wh[y, x]); add(u + 1, u, wh[y, x])
            if y + 1 < H and node[y + 1, x]:
                add(u, u + W, wv[y, x]); add(u + W, u, wv[y, x])
            if excess[y, x] > 0:
                add(src, u, excess[y, x])
            elif excess[y, x] < 0:
                add(u, snk, -excess[y, x])
    g = csr_matrix((caps, (rows, cols)), shape=(n + 2, n + 2))
    return maximum_flow(g, src, snk).flow_value / scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mincut_matches_scipy(seed):
    rng = np.random.default_rng(seed)
    H, W = 24, 32
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    # cheap vertical corridor the cut should follow
    cx = W // 2 + rng.integers(-4, 4)
    wh[:, cx] *= 0.01
    node = np.ones((H, W), bool)
    excess = np.zeros((H, W), np.float32)
    excess[:, 0] = 5000.0    # source column
    excess[:, -1] = -5000.0  # sink column

    side = np.asarray(grid_mincut(jnp.asarray(wh), jnp.asarray(wv),
                                  jnp.asarray(excess), jnp.asarray(node)))
    ours = _cut_value(wh, wv, excess, node, side)
    exact = _scipy_mincut_value(wh, wv, excess, node)
    assert side[:, 0].all() and not side[:, -1].any()
    assert ours <= exact * 1.02 + 1e-3, f"cut {ours} vs exact {exact}"


def test_mincut_irregular_region():
    rng = np.random.default_rng(3)
    H, W = 24, 24
    node = np.zeros((H, W), bool)
    node[2:-2, 2:-2] = True
    node[10:14, 10:14] = False  # hole
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    excess = np.zeros((H, W), np.float32)
    excess[2, 2:-2] = 5000.0
    excess[-3, 2:-2] = -5000.0
    side = np.asarray(grid_mincut(jnp.asarray(wh), jnp.asarray(wv),
                                  jnp.asarray(excess), jnp.asarray(node)))
    ours = _cut_value(wh, wv, excess, node, side)
    exact = _scipy_mincut_value(wh, wv, excess, node)
    assert side[2, 2:-2].all() and not side[-3, 2:-2].any()
    assert ours <= exact * 1.02 + 1e-3, f"cut {ours} vs exact {exact}"


def test_mincut_sharded_matches_single():
    """The column-sharded solver (halo ppermute + psum predicates) runs
    the same phase schedule as the single-device kernel, so the cut must
    match bit-for-bit on the 8-device CPU mesh."""
    from simplepanorama_tpu.parallel.mesh import make_mesh
    from simplepanorama_tpu.parallel.dist_mincut import grid_mincut_sharded
    rng = np.random.default_rng(11)
    H, W = 24, 36    # W not a multiple of 8: exercises the pad path
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wh[:, 17] *= 0.01
    node = np.ones((H, W), bool)
    node[5:9, 20:24] = False
    excess = np.zeros((H, W), np.float32)
    excess[:, 0] = 5000.0
    excess[:, -1] = -5000.0
    single = np.asarray(grid_mincut(
        jnp.asarray(wh), jnp.asarray(wv), jnp.asarray(excess),
        jnp.asarray(node), sweep_iters=H + 40 + 4))
    mesh = make_mesh(8)
    sharded = np.asarray(grid_mincut_sharded(
        jnp.asarray(wh), jnp.asarray(wv), jnp.asarray(excess),
        jnp.asarray(node), mesh))
    np.testing.assert_array_equal(sharded, single)
    ours = _cut_value(wh, wv, excess, node, sharded)
    exact = _scipy_mincut_value(wh, wv, excess, node)
    assert ours <= exact * 1.02 + 1e-3


def test_native_matches_jax_mincut():
    """The C++ Dinic backend and the device push-relabel solver must find
    min cuts of equal value on the same graph."""
    from simplepanorama_tpu.native import grid_mincut_native
    rng = np.random.default_rng(7)
    H, W = 24, 32
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    node = np.ones((H, W), bool)
    excess = np.zeros((H, W), np.float32)
    excess[:, 0] = 5000.0
    excess[:, -1] = -5000.0
    side_n, flow = grid_mincut_native(wh, wv, excess, node)
    side_j = np.asarray(grid_mincut(jnp.asarray(wh), jnp.asarray(wv),
                                    jnp.asarray(excess), jnp.asarray(node)))
    v_n = _cut_value(wh, wv, excess, node, side_n)
    v_j = _cut_value(wh, wv, excess, node, side_j)
    assert abs(v_n - flow) < 1e-2 * max(1.0, flow)
    assert abs(v_j - v_n) <= 0.02 * v_n + 1e-3


@pytest.mark.slow
def test_mincut_production_scale_real_content():
    """Cut-value parity at a REAL seam-graph size with real image content
    (all prior parity tests were <=24x36 toy grids; production
    overlap ROIs at init_size=700 are hundreds of px on a side). The JAX
    push-relabel and the native Dinic oracle must both reach the same
    min-cut value. (The CI-sized 256x512 keeps the CPU run tractable;
    chip_smoke.py checks the 500x700 graph on the GPU.)"""
    import cv2
    from simplepanorama_tpu.render.graphcut import _build_cut_graph
    from simplepanorama_tpu.native import grid_mincut_native

    img = cv2.imread("/root/reference/results/map/budapest1.jpg")
    img = cv2.resize(img, (1400, 1000))
    g = (0.114 * img[..., 0] + 0.587 * img[..., 1]
         + 0.299 * img[..., 2]).astype(np.float32)
    H, W, dy, dx = 256, 512, 30, 120
    m1 = np.zeros((H, W), np.float32)
    m1[2:H - 2, 2:int(W * 0.60)] = 255.0
    m2 = np.zeros((H, W), np.float32)
    m2[2:H - 2, int(W * 0.35):W - 2] = 255.0
    graph = _build_cut_graph(jnp.asarray(g[:H, :W]),
                             jnp.asarray(g[dy:dy + H, dx:dx + W]),
                             jnp.asarray(m1), jnp.asarray(m2))
    wh, wv, exc, obj = (np.asarray(a) for a in graph)

    side_j = np.asarray(grid_mincut(*graph))
    side_n, flow = grid_mincut_native(wh, wv, exc, obj)
    v_j = _cut_value(wh, wv, exc, obj, side_j)
    v_n = _cut_value(wh, wv, exc, obj, side_n)
    assert abs(v_n - flow) < 1e-2 * max(1.0, flow)
    assert abs(v_j - v_n) <= 1e-3 * max(1.0, v_n), (v_j, v_n)
    # the seam must be a single connected front: every row of the overlap
    # band has both source- and sink-side pixels
    band = obj & (np.arange(W)[None, :] >= int(W * 0.35)) \
        & (np.arange(W)[None, :] < int(W * 0.60))
    rows = band.any(1)
    src_rows = (side_j & band).any(1)
    snk_rows = (~side_j & band).any(1)
    assert (src_rows[rows] | snk_rows[rows]).all()


def test_device_chain_matches_host_loop():
    """The device-chain incremental cut (graph_cut_state — canvas resident,
    no per-image host sync) must reproduce the host-loop graph_cut when
    both use the same solver (ties broken identically)."""
    import jax
    from simplepanorama_tpu.render import graphcut as gc
    from simplepanorama_tpu.render.compose import ComposeState

    rng = np.random.default_rng(3)
    n, Hb, Wb = 3, 48, 128
    H, W = 80, 256
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    masks = np.zeros((n, Hb, Wb), bool)
    offs = np.array([[0, 0], [10, 60], [20, 120]], np.int32)
    rois = []
    for i in range(n):
        h, w = 40 + i, 100 + 5 * i
        masks[i, 1:h - 1, 1:w - 1] = True
        rois.append((int(offs[i, 1]), int(offs[i, 0]), w, h))
    state = ComposeState(imgs=jnp.asarray(imgs), masks=jnp.asarray(masks),
                         offs=jnp.asarray(offs), rois=rois,
                         canvas_hw=(H, W), min_xy=(0, 0))
    seq = [0, 1, 2]

    # host loop on the equivalent per-image lists, forced onto the SAME
    # push-relabel solver (the native-Dinic fast path may break min-cut
    # ties differently)
    imgs_l = [imgs[i, :r[3], :r[2]] for i, r in enumerate(rois)]
    masks_l = [masks[i, :r[3], :r[2]] for i, r in enumerate(rois)]
    corners_l = [(r[0], r[1]) for r in rois]
    orig_solve = gc._solve_cut

    def forced(wh, wv, excess, obj, mask2):
        from simplepanorama_tpu.ops.maxflow import grid_mincut as gm
        return jnp.where(obj, gm(wh, wv, excess, obj), mask2 > 0)

    gc._solve_cut = forced
    try:
        seams_host = gc.graph_cut(imgs_l, masks_l, corners_l, seq)
    finally:
        gc._solve_cut = orig_solve

    seams_dev = np.asarray(gc.graph_cut_state(state, seq))
    for i, r in enumerate(rois):
        dev_i = seams_dev[i, :r[3], :r[2]]
        host_i = np.asarray(seams_host[i])
        agree = (dev_i == host_i).mean()
        assert agree > 0.995, f"image {i}: {agree:.4f}"


def test_graph_cut_state_matches_dinic():
    """graph_cut_state (the device chain the GPU path runs, solving with
    grid_mincut) must cut an irregular overlap at the min-cut value the
    exact Dinic oracle finds on the same seam graph."""
    from simplepanorama_tpu.native import grid_mincut_native
    from simplepanorama_tpu.render import graphcut as gc
    from simplepanorama_tpu.render.compose import ComposeState

    rng = np.random.default_rng(5)
    Hb, Wb = 40, 128
    base = rng.uniform(0, 255, (Hb + 8, Wb + 48, 3)).astype(np.float32)
    imgs = np.stack([base[:Hb, :Wb], base[6:6 + Hb, 40:40 + Wb]])
    imgs[1] += rng.normal(0, 8, imgs[1].shape).astype(np.float32)
    masks = np.zeros((2, Hb, Wb), bool)
    masks[0, 1:-1, 1:110] = True
    masks[0, 12:20, 70:90] = False          # a hole in the first view
    masks[1, 2:-2, 2:-2] = True
    masks[1, 25:, :20] = False              # a notch in the second
    offs = np.array([[0, 0], [6, 40]], np.int32)
    rois = [(0, 0, Wb, Hb), (40, 6, Wb, Hb)]
    state = ComposeState(imgs=jnp.asarray(imgs), masks=jnp.asarray(masks),
                         offs=jnp.asarray(offs), rois=rois,
                         canvas_hw=(Hb + 6, Wb + 40), min_xy=(0, 0))
    seams = np.asarray(gc.graph_cut_state(state, [0, 1]))

    gray = np.asarray(gc._gray_batch(jnp.asarray(imgs)))
    scene_g = np.zeros((Hb, Wb), np.float32)
    scene_m = np.zeros((Hb, Wb), np.float32)
    sub = (slice(0, Hb - 6), slice(0, Wb - 40))
    scene_g[sub] = np.where(masks[0], gray[0], 0)[6:, 40:]
    scene_m[sub] = masks[0][6:, 40:] * 255.0
    graph = gc._build_cut_graph(jnp.asarray(scene_g), jnp.asarray(gray[1]),
                                jnp.asarray(scene_m),
                                jnp.asarray(masks[1] * 255.0))
    wh, wv, exc, obj = (np.asarray(a) for a in graph)
    assert obj.sum() > 500
    side_n, flow = grid_mincut_native(wh, wv, exc, obj)
    v_dev = cut_value(wh, wv, exc, obj, seams[1] & obj)
    v_n = cut_value(wh, wv, exc, obj, side_n)
    assert abs(v_n - flow) < 1e-2 * max(1.0, flow)
    assert abs(v_dev - v_n) <= 1e-3 * max(1.0, v_n), (v_dev, v_n)
