"""Device-resident compositing: warp -> seams -> gain -> exposure -> blend
without host round trips.

A list-of-numpy-arrays flow would ship every warped block host<->device
between stages. This module keeps the packed block tensors on-device end
to end: the host only sees tiny metadata (ROIs, corners, gains) and the
final uint8 panorama.

Data model: every connected image is a block in
  imgs  (N, Hb, Wb, 3) float32   (0..255)
  masks (N, Hb, Wb)    bool
  offs  (N, 2) int32             block top-left on the canvas (y, x)
with one common padded block shape — the same layout blending.py's
jitted kernels already use.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.ops.edt import distance_transform
from simplepanorama_tpu.render import projection as prj
from simplepanorama_tpu.render.blending import (
    no_blend, simple_blend, multi_blend, _acc_add)
from simplepanorama_tpu.geometry.canvas import get_pan_dimension


def _mesh():
    from simplepanorama_tpu.parallel.mesh import pipeline_mesh
    return pipeline_mesh()


@jax.jit
def _gather_f32(batch_u8: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    """Select warp-source images out of the resident uint8 batch."""
    return batch_u8[rows].astype(jnp.float32)


@dataclasses.dataclass
class ComposeState:
    """Packed device blocks + host metadata."""
    imgs: jnp.ndarray            # (N, Hb, Wb, 3) f32
    masks: jnp.ndarray           # (N, Hb, Wb) bool
    offs: jnp.ndarray            # (N, 2) i32 canvas (y, x)
    rois: List[Tuple[int, int, int, int]]  # (tlx, tly, w, h) per image
    canvas_hw: Tuple[int, int]
    min_xy: Tuple[int, int]      # canvas origin in projection coords
    seam_masks: Optional[jnp.ndarray] = None   # (N, Hb, Wb) bool
    gains: Optional[np.ndarray] = None
    intensity: Optional[jnp.ndarray] = None    # (N, hb, wb) half-res fields


def warp_all(kind: str, scale: float, images: Sequence[np.ndarray],
             Rs, Ks, connectivity, dev_images=None) -> ComposeState:
    """Batched warp, blocks stay on device.

    ``dev_images``: optional ``(batch_u8, rows)`` — a device-resident
    uint8 image batch (the one the SIFT stage already uploaded) plus the
    batch row for each entry of ``images``. When given, the source pixels
    are gathered from that batch ON DEVICE instead of re-uploading a
    float32 copy — the pixels cross to the device once per stitch."""
    sel = [i for i in range(len(images)) if connectivity[i] > 0]
    rois = {}
    for i in sel:
        h, w = images[i].shape[:2]
        rois[i] = prj.roi_for_image(kind, scale, Rs[i], Ks[i], h, w)
    out_h = max(rois[i][3] for i in sel)
    out_w = max(rois[i][2] for i in sel)
    out_h = (out_h + 7) // 8 * 8
    out_w = (out_w + 127) // 128 * 128

    n = len(sel)
    Ka_b = np.zeros((n, 3, 3), np.float32)
    R_b = np.zeros((n, 3, 3), np.float32)
    c_b = np.zeros((n, 2), np.float32)
    hw_b = np.zeros((n, 2), np.int32)
    for b, i in enumerate(sel):
        h, w = images[i].shape[:2]
        Ka_b[b] = prj.adjusted_K(Ks[i], h, w)
        R_b[b] = np.asarray(Rs[i], np.float32)
        c_b[b] = (rois[i][0], rois[i][1])
        hw_b[b] = (h, w)

    if dev_images is not None:
        batch_u8, rows = dev_images
        sel_rows = jnp.asarray(np.array([rows[i] for i in sel], np.int32))
        src = _gather_f32(batch_u8, sel_rows)
    else:
        Hs = max(im.shape[0] for im in images)
        Ws = max(im.shape[1] for im in images)
        imgs_b = np.zeros((n, Hs, Ws, 3), np.float32)
        for b, i in enumerate(sel):
            h, w = images[i].shape[:2]
            imgs_b[b, :h, :w] = images[i].astype(np.float32)
        src = jnp.asarray(imgs_b)

    warped, masks = prj.warp_backward_batch(
        src, jnp.asarray(Ka_b), jnp.asarray(R_b),
        jnp.asarray(c_b), float(scale), kind, out_h, out_w,
        jnp.asarray(hw_b), erode_iters=4)

    roi_list = [(rois[i][0], rois[i][1], rois[i][2], rois[i][3])
                for i in sel]
    corners = [(r[0], r[1]) for r in roi_list]
    sizes = [(r[3], r[2]) for r in roi_list]
    d = get_pan_dimension(corners, sizes)
    offs = np.array([[ty - d.min_y, tx - d.min_x]
                     for (tx, ty) in corners], np.int32)
    # zero out block padding beyond each image's true ROI
    Hb, Wb = out_h, out_w
    yy = np.arange(Hb)[None, :, None]
    xx = np.arange(Wb)[None, None, :]
    rh = np.array([r[3] for r in roi_list])[:, None, None]
    rw = np.array([r[2] for r in roi_list])[:, None, None]
    valid_blk = jnp.asarray((yy < rh) & (xx < rw))
    masks = masks & valid_blk

    return ComposeState(
        imgs=warped, masks=masks, offs=jnp.asarray(offs),
        rois=roi_list, canvas_hw=(d.height, d.width),
        min_xy=(d.min_x, d.min_y))


@functools.partial(jax.jit, static_argnames=("canvas_hw",))
def dist_cut_dev(msks, offs, canvas_hw):
    """Distance-transform seams on packed device blocks (seams.py logic)."""
    H, W = canvas_hw
    N, Hb, Wb = msks.shape
    dts = jax.vmap(lambda m: distance_transform(m))(msks)
    dmax = jnp.zeros((H + Hb, W + Wb), jnp.float32)
    for i in range(N):
        sl = jax.lax.dynamic_slice(dmax, (offs[i, 0], offs[i, 1]), (Hb, Wb))
        dmax = jax.lax.dynamic_update_slice(
            dmax, jnp.maximum(sl, dts[i]), (offs[i, 0], offs[i, 1]))
    outs = []
    for i in range(N):
        sl = jax.lax.dynamic_slice(dmax, (offs[i, 0], offs[i, 1]), (Hb, Wb))
        outs.append(msks[i] & (dts[i] >= sl))
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("canvas_hw", "ratio_shift"))
def equalize_dev(imgs, msks, offs, canvas_hw, ratio_shift: int = 1):
    """Exposure-disparity fields on device (test::equalizeIntensities at
    ratio=.5): gray at half resolution via 2x2 mean pooling."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    eps = 1e-5
    r = 1 << ratio_shift
    hb, wb = Hb // r, Wb // r

    gray = (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1]
            + 0.299 * imgs[..., 2]) / 255.0
    dts = jax.vmap(lambda m: distance_transform(m))(msks) / 255.0

    def down(x):
        return x.reshape(N, hb, r, wb, r).mean(axis=(2, 4))

    gs = down(jnp.where(msks, gray, 0.0))
    ds = down(dts)
    ms = down(msks.astype(jnp.float32)) > 0.5
    offs_s = offs // r
    Hc, Wc = H // r + hb, W // r + wb

    int_dist = gs * ds
    cint = jnp.zeros((Hc, Wc), jnp.float32)
    cw = jnp.zeros((Hc, Wc), jnp.float32)
    for i in range(N):
        cint = _acc_add(cint, int_dist[i], offs_s[i])
        cw = _acc_add(cw, ds[i], offs_s[i])

    radius = 6
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2.0 * 49.0))
    k = jnp.asarray((k / k.sum()).astype(np.float32))

    outs = []
    for i in range(N):
        acc_i = jax.lax.dynamic_slice(cint, (offs_s[i, 0], offs_s[i, 1]),
                                      (hb, wb))
        acc_w = jax.lax.dynamic_slice(cw, (offs_s[i, 0], offs_s[i, 1]),
                                      (hb, wb))
        blended = acc_i / (acc_w + eps) + eps
        corr = jnp.where(ms[i], gs[i] / blended, 0.0) + (~ms[i])
        c = corr[None, None]
        c = jax.lax.conv_general_dilated(
            jnp.pad(c, ((0, 0), (0, 0), (0, 0), (radius, radius)),
                    mode="edge"),
            k[None, None, None, :], (1, 1), "VALID")
        c = jax.lax.conv_general_dilated(
            jnp.pad(c, ((0, 0), (0, 0), (radius, radius), (0, 0)),
                    mode="edge"),
            k[None, None, :, None], (1, 1), "VALID")
        outs.append(c[0, 0])
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("ratio_shift",))
def apply_intensity_dev(imgs, fields, ratio_shift: int = 1):
    """Upsample fields to block size and divide (adjust_intensity)."""
    N, Hb, Wb, _ = imgs.shape
    up = jax.image.resize(fields, (N, Hb, Wb), "linear")
    up = jnp.where(jnp.abs(up) < 1e-6, 1.0, up)
    return imgs / up[..., None]


def gain_dev(imgs, msks, offs, canvas_hw, adj) -> np.ndarray:
    """Gain compensation on packed blocks (Brown & Lowe §6 eq. 29,
    gain::gain_compensation, _gain_compensation.cpp:78-172): pairwise
    overlap areas/intensities as canvas dot products, tiny host solve."""
    H, W = canvas_hw
    n, Hb, Wb, _ = imgs.shape
    gray = (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1]
            + 0.299 * imgs[..., 2])
    N_mat, S_mat = _overlap_sums_dev(gray, msks, offs, (H, W))
    N_np = np.asarray(N_mat, np.float64)
    S_np = np.asarray(S_mat, np.float64)
    adj_sym = np.asarray(adj) + np.asarray(adj).T + np.eye(n)
    use = adj_sym > 0
    N_np = np.where(use & (N_np > 0), N_np, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        I = np.where(N_np > 0, S_np / N_np, 0.0)
    Iref = I.T
    S_N, S_g = 100.0, 0.01
    B = np.diag(N_np.sum(axis=1))
    A = np.diag((N_np * Iref * Iref).sum(axis=1))
    C = N_np * Iref * Iref.T
    G = (1.0 / S_g) * np.diag(B)
    M = (2.0 / S_N) * (A - C) + (1.0 / S_g) * B
    try:
        return np.linalg.solve(M, G)
    except np.linalg.LinAlgError:
        return np.ones(n)


@functools.partial(jax.jit, static_argnames=("canvas_hw",))
def _overlap_sums_dev(grays, msks, offs, canvas_hw):
    H, W = canvas_hw
    n, Hb, Wb = grays.shape
    cm = jnp.zeros((n, H + Hb, W + Wb), jnp.float32)
    cg = jnp.zeros((n, H + Hb, W + Wb), jnp.float32)
    for i in range(n):
        cm = cm.at[i].set(jax.lax.dynamic_update_slice(
            cm[i], msks[i].astype(jnp.float32), (offs[i, 0], offs[i, 1])))
        cg = cg.at[i].set(jax.lax.dynamic_update_slice(
            cg[i], grays[i] * msks[i], (offs[i, 0], offs[i, 1])))
    fm = cm.reshape(n, -1)
    fg = cg.reshape(n, -1)
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(fm, fm.T, precision=hi),
            jnp.matmul(fg, fm.T, precision=hi))


def blend_dev(method: str, state: ComposeState, imgs, bands: int,
              sigma: float) -> np.ndarray:
    """Blend packed device blocks -> uint8 numpy panorama (one transfer).

    MULTI_BLEND is a pure sum over images, so with >1 device attached it
    runs the mesh-parallel schedule (parallel.tiled_compose): band pyramids
    data-parallel over images, canvas reduced by psum_scatter. NO/SIMPLE
    are order-dependent composites and stay single-device."""
    seams = state.seam_masks
    msks_f = state.masks.astype(jnp.float32)
    if method == "NO_BLEND":
        use = seams if seams is not None else state.masks
        out = no_blend(imgs, use.astype(jnp.float32), state.offs,
                       state.canvas_hw)
    elif method == "SIMPLE_BLEND":
        out = simple_blend(imgs, msks_f, state.offs, state.canvas_hw)
    elif _mesh() is not None:
        from simplepanorama_tpu.parallel.tiled_compose import \
            multi_blend_sharded
        out = multi_blend_sharded(imgs, seams.astype(jnp.float32), msks_f,
                                  state.offs, state.canvas_hw, _mesh(),
                                  bands=bands, sigma=float(sigma))
    else:
        out = multi_blend(imgs, seams.astype(jnp.float32), msks_f,
                          state.offs, state.canvas_hw,
                          bands=bands, sigma=float(sigma))
    # clip+cast on device: the canvas leaves the device as uint8, a
    # quarter of the bytes of the f32 canvas
    return np.asarray(_to_u8(out))


@jax.jit
def _to_u8(x):
    return jnp.clip(x, 0.0, 255.0).astype(jnp.uint8)
