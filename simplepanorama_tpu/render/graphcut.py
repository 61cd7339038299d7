"""Graph-cut seam finding (Kwatra et al., Graphcut Textures).

Reproduces gcut::graph_cut (/root/reference/src/math/_graph_cut.cpp):
incremental compositing in BA insertion order — paste the first image;
for each next image, cut the overlap between the existing panorama
(grayscale) and the new image; finally a mutual-exclusion pass makes
later masks carve earlier ones (:84-115, equivalent to ownership by the
latest covering image).

Per-pair cut (computeCut, :285-341 + graph helper):
  nodes    = overlap pixels (scene mask ∧ element mask);
  edges    = 4-neighborhood, capacity between neighbors p, q:
             (|I1-I2|(p) + |I1-I2|(q)) / (sum of |Scharr| grads + eps) —
             horizontal edges use y-gradients, vertical use x-gradients
             (scharr_gradient::read, :248-282);
  t-links  = weight 5000 on the scene-mask contour (source) and the
             element-mask contour (sink), contours restricted to the
             overlap (graph_object ctor, _graph_cut_helper.h:28-80;
             define_graph_full, :344-405);
  result   = element mask with overlap pixels set to 255 * (source side).

The BK max-flow is replaced by the data-parallel push-relabel kernel
(ops/maxflow.grid_mincut), which converges to a min cut of the same
graph.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.ops.maxflow import grid_mincut
from simplepanorama_tpu.geometry.canvas import get_pan_dimension

_SEED_W = 5000.0
_EPS = 1e-6


def _scharr(img: jnp.ndarray):
    """OpenCV Scharr 3x3 gradients (x, y) of a (H, W) float image."""
    kx = jnp.asarray(np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                              np.float32))
    ky = kx.T
    x = img[None, None]
    pad = [(1, 1), (1, 1)]
    gx = jax.lax.conv_general_dilated(x, kx[None, None], (1, 1), pad)[0, 0]
    gy = jax.lax.conv_general_dilated(x, ky[None, None], (1, 1), pad)[0, 0]
    return gx, gy


def _boundary(mask: jnp.ndarray) -> jnp.ndarray:
    """Mask boundary (findContours/drawContours thickness-1 equivalent):
    foreground pixels with a background 4-neighbor or at the border."""
    m = mask.astype(jnp.float32)
    mn = -jax.lax.reduce_window(-m, -1.0, jax.lax.max, (3, 3), (1, 1),
                                "SAME")
    mn = mn.at[0, :].set(0.0).at[-1, :].set(0.0)
    mn = mn.at[:, 0].set(0.0).at[:, -1].set(0.0)
    return (m > 0) & (mn <= 0)


@functools.partial(jax.jit, static_argnames=())
def _build_cut_graph(img1: jnp.ndarray, img2: jnp.ndarray,
                     mask1: jnp.ndarray, mask2: jnp.ndarray):
    """Edge weights + seeds of one seam cut; inputs (H, W), 0..255
    scale. Returns (cap_h, cap_v, excess, node)."""
    obj = (mask1 > 0) & (mask2 > 0)
    A = jnp.abs(img1 - img2)
    g1x, g1y = _scharr(img1)
    g2x, g2y = _scharr(img2)

    def nb(x, dy, dx):
        return jnp.roll(x, (-dy, -dx), axis=(0, 1))

    # horizontal edge (y,x)-(y,x+1): uses y-gradients
    wh = (A + nb(A, 0, 1)) / (jnp.abs(g1y) + nb(jnp.abs(g1y), 0, 1)
                              + jnp.abs(g2y) + nb(jnp.abs(g2y), 0, 1) + _EPS)
    # vertical edge (y,x)-(y+1,x): uses x-gradients
    wv = (A + nb(A, 1, 0)) / (jnp.abs(g1x) + nb(jnp.abs(g1x), 1, 0)
                              + jnp.abs(g2x) + nb(jnp.abs(g2x), 1, 0) + _EPS)

    cont_scene = _boundary(mask1) & obj
    cont_elem = _boundary(mask2) & obj
    excess = _SEED_W * cont_scene.astype(jnp.float32) \
        - _SEED_W * (cont_elem & ~cont_scene).astype(jnp.float32)
    return wh, wv, excess, obj


def _solve_cut(wh, wv, excess, obj, mask2):
    """Min-cut dispatch: data-parallel push-relabel on an accelerator
    (column-sharded over the mesh when >1 device is attached), the native
    Dinic backend on host CPU (the reference's BK slot)."""
    import jax as _jax
    from simplepanorama_tpu.parallel.mesh import pipeline_mesh
    mesh = pipeline_mesh()
    if _jax.default_backend() == "cpu":
        from simplepanorama_tpu.native import grid_mincut_native
        try:
            side, _ = grid_mincut_native(
                np.asarray(wh), np.asarray(wv), np.asarray(excess),
                np.asarray(obj))
            side = jnp.asarray(side)
        except Exception:
            side = grid_mincut(wh, wv, excess, obj)
    elif mesh is not None:
        from simplepanorama_tpu.parallel.dist_mincut import \
            grid_mincut_sharded
        side = grid_mincut_sharded(wh, wv, excess, obj, mesh)
    else:
        side = grid_mincut(wh, wv, excess, obj)
    return jnp.where(obj, side, mask2 > 0)


def graph_cut(images: Sequence[np.ndarray],
              masks: Sequence[np.ndarray],
              corners: Sequence[Tuple[int, int]],
              seq: Sequence[int],
              progress: Optional[Callable[[float], None]] = None,
              cancelled: Optional[Callable[[], bool]] = None,
              ) -> List[np.ndarray]:
    """Incremental graph-cut seams over the component's images.

    ``seq`` is the BA insertion order (local indices). Returns one seam
    mask per image (same order/shapes as ``masks``).
    """
    sizes = [im.shape[:2] for im in images]
    d = get_pan_dimension(corners, sizes)
    H, W = d.height, d.width
    pano = np.zeros((H, W), np.float32)         # grayscale canvas
    scene = np.zeros((H, W), bool)
    rois = []
    grays = []
    for im, (tx, ty) in zip(images, corners):
        g = 0.114 * im[..., 0] + 0.587 * im[..., 1] + 0.299 * im[..., 2]
        grays.append(np.asarray(g, np.float32))
        rois.append((ty - d.min_y, tx - d.min_x))

    out = [np.asarray(m) > 0 for m in masks]
    first = seq[0]
    y0, x0 = rois[first]
    h, w = sizes[first]
    m0 = out[first]
    pano[y0:y0 + h, x0:x0 + w][m0] = grays[first][m0]
    scene[y0:y0 + h, x0:x0 + w] |= m0

    n = max(1, len(seq) - 1)
    for s in seq[1:]:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        y0, x0 = rois[s]
        h, w = sizes[s]
        pano_roi = pano[y0:y0 + h, x0:x0 + w]
        scene_roi = scene[y0:y0 + h, x0:x0 + w]
        m2 = jnp.asarray(out[s].astype(np.float32) * 255)
        graph = _build_cut_graph(
            jnp.asarray(pano_roi), jnp.asarray(grays[s]),
            jnp.asarray(scene_roi.astype(np.float32) * 255), m2)
        cut = np.asarray(_solve_cut(*graph, m2))
        out[s] = cut
        pano_roi[cut] = grays[s][cut]
        scene_roi |= cut
        if progress is not None:
            progress(1.0 / n)

    # mutual exclusion: ownership by the latest covering image in seq
    owner = -np.ones((H, W), np.int32)
    for rank, s in enumerate(seq):
        y0, x0 = rois[s]
        h, w = sizes[s]
        region = owner[y0:y0 + h, x0:x0 + w]
        region[out[s]] = s
    for s in seq:
        y0, x0 = rois[s]
        h, w = sizes[s]
        out[s] = out[s] & (owner[y0:y0 + h, x0:x0 + w] == s)
    return [o for o in out]


# ---------------------------------------------------------------------------
# device-chain incremental graph cut: no host sync inside the loop
# ---------------------------------------------------------------------------
# The host loop above performs one device dispatch + a FULL host sync
# (np.asarray(cut)) + a host canvas update per image — on a 36-image
# sequence that is 35 serialized solves. Here the grayscale
# canvas and scene mask stay ON DEVICE: each image is one enqueued
# _cut_step dispatch whose output feeds the next step's input as a device
# future, so the host loop runs ahead and the chain pipelines (the same
# discipline as the double-buffered BA chunks, stitch.py:243-261). The
# only sync is the final seam-mask download.

@jax.jit
def _cut_step(canvas_g, scene, gray_b, mask_b, off):
    """One incremental cut over padded blocks: slice the canvas under the
    new image, build the seam graph, solve, paste. Shapes are the packed
    block shape, so ONE compiled program serves every image."""
    Hb, Wb = gray_b.shape
    pano_roi = jax.lax.dynamic_slice(canvas_g, (off[0], off[1]), (Hb, Wb))
    scene_roi = jax.lax.dynamic_slice(
        scene, (off[0], off[1]), (Hb, Wb))
    wh, wv, excess, obj = _build_cut_graph(
        pano_roi, gray_b, scene_roi.astype(jnp.float32) * 255.0,
        mask_b.astype(jnp.float32) * 255.0)
    side = grid_mincut(wh, wv, excess, obj)
    cut = jnp.where(obj, side, mask_b)
    canvas_g = jax.lax.dynamic_update_slice(
        canvas_g, jnp.where(cut, gray_b, pano_roi), (off[0], off[1]))
    scene = jax.lax.dynamic_update_slice(
        scene, scene_roi | cut, (off[0], off[1]))
    return canvas_g, scene, cut


@jax.jit
def _paste_first(canvas_g, scene, gray_b, mask_b, off):
    Hb, Wb = gray_b.shape
    pano_roi = jax.lax.dynamic_slice(canvas_g, (off[0], off[1]), (Hb, Wb))
    scene_roi = jax.lax.dynamic_slice(scene, (off[0], off[1]), (Hb, Wb))
    canvas_g = jax.lax.dynamic_update_slice(
        canvas_g, jnp.where(mask_b, gray_b, pano_roi), (off[0], off[1]))
    scene = jax.lax.dynamic_update_slice(
        scene, scene_roi | mask_b, (off[0], off[1]))
    return canvas_g, scene


@functools.partial(jax.jit, static_argnames=("seq", "canvas_hw"))
def _mutual_exclusion_dev(cuts, offs, seq, canvas_hw):
    """Ownership by the latest covering image in ``seq`` (the reference's
    mask-exclusion pass, _graph_cut.cpp:84-115), batched on device."""
    N, Hb, Wb = cuts.shape
    H, W = canvas_hw
    owner = jnp.full((H + Hb, W + Wb), -1, jnp.int32)
    for s in seq:
        region = jax.lax.dynamic_slice(owner, (offs[s, 0], offs[s, 1]),
                                       (Hb, Wb))
        region = jnp.where(cuts[s], jnp.int32(s), region)
        owner = jax.lax.dynamic_update_slice(
            owner, region, (offs[s, 0], offs[s, 1]))
    outs = []
    for s in range(N):
        region = jax.lax.dynamic_slice(owner, (offs[s, 0], offs[s, 1]),
                                       (Hb, Wb))
        outs.append(cuts[s] & (region == s))
    return jnp.stack(outs)


def graph_cut_state(state, seq: Sequence[int],
                    progress: Optional[Callable[[float], None]] = None,
                    cancelled: Optional[Callable[[], bool]] = None):
    """Incremental graph-cut seams directly on a ComposeState's packed
    device blocks. Returns the (N, Hb, Wb) bool seam-mask batch ON DEVICE
    (ready to assign to state.seam_masks — no host round trip)."""
    imgs, masks, offs = state.imgs, state.masks, state.offs
    H, W = state.canvas_hw
    N, Hb, Wb = masks.shape
    gray = _gray_batch(imgs)
    canvas_g = jnp.zeros((H + Hb, W + Wb), jnp.float32)
    scene = jnp.zeros((H + Hb, W + Wb), bool)

    outs: List = [None] * N
    first = seq[0]
    canvas_g, scene = _paste_first(canvas_g, scene, gray[first],
                                   masks[first], offs[first])
    outs[first] = masks[first]
    n = max(1, len(seq) - 1)
    for s in seq[1:]:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        canvas_g, scene, cut = _cut_step(canvas_g, scene, gray[s],
                                         masks[s], offs[s])
        outs[s] = cut
        if progress is not None:
            progress(1.0 / n)
    return _mutual_exclusion_dev(jnp.stack(outs), offs, tuple(seq), (H, W))


@jax.jit
def _gray_batch(imgs):
    return (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1]
            + 0.299 * imgs[..., 2])
