"""Device-resident full-resolution rendering.

The reference's return_full (/root/reference/src/classes/_panorama.cpp:
259-354) reloads the full-res images, rescales K by the resolution ratio,
re-projects everything, resizes the preview seam masks with INTER_CUBIC
and re-blends — BA never reruns. Its memory model is "all warped blocks
in RAM at once"; at the 30000-px canvas guard
(_img_manipulation.cpp:349-354) that is the peak of the whole program.

This design streams instead of materializing:

  * per-image work (backward warp, mask erode, seam/intensity upsample,
    gain divide, multiband band-pass) happens in BLOCK space — one padded
    ROI block at a time, uploaded as uint8 and never downloaded;
  * the only persistent device state is the canvas accumulator pair
    (color, alpha) — blending is an accumulate-then-normalize, so blocks
    can be folded in and freed immediately;
  * images are processed in chunks sized to a device-memory budget; the
    host loop enqueues chunk programs without synchronizing, so upload,
    warp and accumulate overlap across chunks.

Seam masks are upsampled ON DEVICE from the preview ComposeState blocks
with a cv2-aligned cubic interpolation matrix (Keys a=-0.75, pixel-center
mapping src = (dst+0.5)*ratio-0.5 — the INTER_CUBIC the reference uses at
_panorama.cpp:329-335); intensity fields with the linear kernel
(test::adjust_intensity resizes INTER_LINEAR, _test.cpp:110-122).

Mesh schedules (parallel.tiled_compose): with >1 device and MULTI_BLEND
(a pure sum over images) the chunk is either image-data-parallel (each
device folds its images into a private canvas, one psum_scatter at
finalize) or canvas-column-sharded for small N (each device warps only
its slab of canvas columns — warp_tiled's schedule — with ppermute halo
exchange for the band blurs). NO/SIMPLE blend composite in image order
and stay single-device.
"""

from __future__ import annotations

import functools

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.config import Config, Blending
from simplepanorama_tpu.render import projection as prj
from simplepanorama_tpu.render.blending import _acc_add
from simplepanorama_tpu.ops.edt import distance_transform

# device-memory budget for in-flight chunk blocks (bytes); the canvas
# accumulators are excluded (they are the irreducible state)
_CHUNK_BUDGET = int(1.5e9)


# ---------------------------------------------------------------------------
# cv2-aligned resize as interpolation matrices (built inside jit: output
# size is static, the scale ratio is traced so one compile serves every
# image of a sequence)
# ---------------------------------------------------------------------------

def _cubic_kernel(t):
    """Keys bicubic, a = -0.75 (OpenCV's INTER_CUBIC)."""
    a = -0.75
    at = jnp.abs(t)
    w1 = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    w2 = a * (((at - 5.0) * at + 8.0) * at - 4.0)
    return jnp.where(at <= 1.0, w1, jnp.where(at < 2.0, w2, 0.0))


def _linear_kernel(t):
    return jnp.maximum(0.0, 1.0 - jnp.abs(t))


def _resize_matrix(n_out: int, n_in: int, ratio, offset=0.0, cubic=True):
    """(n_out, n_in) interpolation matrix with cv2 pixel-center mapping
    src = (dst + 0.5 + offset) * ratio - 0.5; rows normalized (the
    out-of-range tail of the kernel is redistributed, approximating
    BORDER_REPLICATE). Rows whose support misses [0, n_in) are zero."""
    o = jnp.arange(n_out, dtype=jnp.float32)
    src = (o + 0.5 + offset) * ratio - 0.5
    i = jnp.arange(n_in, dtype=jnp.float32)
    W = (_cubic_kernel if cubic else _linear_kernel)(
        src[:, None] - i[None, :])
    s = W.sum(axis=1, keepdims=True)
    return jnp.where(jnp.abs(s) > 1e-6, W / jnp.where(s == 0, 1.0, s), 0.0)


def _upsample_block(block, n_out_hw, ratio_hw, cubic):
    """Resize a (h_in, w_in) block to static n_out_hw with traced per-axis
    ratios, as two matmuls."""
    Wy = _resize_matrix(n_out_hw[0], block.shape[0], ratio_hw[0],
                        cubic=cubic)
    Wx = _resize_matrix(n_out_hw[1], block.shape[1], ratio_hw[1],
                        cubic=cubic)
    return Wy @ block @ Wx.T


# ---------------------------------------------------------------------------
# per-image block preparation (shared by all schedules)
# ---------------------------------------------------------------------------

def _prep_block(src_f32, Ka, R, corner, vhw, roi_wh, scale, kind,
                out_h, out_w, seam_blk, seam_ratio, field_blk, field_ratio,
                gain, use_seam, use_field):
    """Warp one full-res source into its padded ROI block and apply the
    per-image corrections. Returns (img (out_h,out_w,3), mask f32, seam
    f32) — seam equals mask when use_seam is False."""
    warped, mask = prj.warp_backward(src_f32, Ka, R, corner, scale, kind,
                                     out_h, out_w, vhw)
    mask = prj.erode_mask(mask, iters=4)
    yy = jax.lax.broadcasted_iota(jnp.int32, (out_h, out_w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (out_h, out_w), 1)
    mask = mask & (yy < roi_wh[1]) & (xx < roi_wh[0])
    mask_f = mask.astype(jnp.float32)

    if use_seam:
        seam_up = _upsample_block(seam_blk, (out_h, out_w), seam_ratio,
                                  cubic=True)
        seam = jnp.where((seam_up > 0.5) & mask, 1.0, 0.0)
    else:
        seam = mask_f

    img = warped / gain
    if use_field:
        f_up = _upsample_block(field_blk, (out_h, out_w), field_ratio,
                               cubic=False)
        f_up = jnp.where(jnp.abs(f_up) < 1e-6, 1.0, f_up)
        img = img / f_up[..., None]
    # NOTE: img is intentionally NOT zeroed outside the eroded mask — the
    # reference blurs the full warped block (values in the erosion rim
    # bleed into the band colors); the weights alone are mask-gated.
    return img, mask_f, seam


def _mb_contribution(img, seam, orig, bands: int, sigma: float):
    """Multiband color/alpha contribution of one block (same band math as
    blending.multi_blend — accumulation over images commutes)."""
    from simplepanorama_tpu.parallel.tiled_compose import \
        _mb_block_contribution
    return _mb_block_contribution(img, seam, orig, bands, sigma)


# ---------------------------------------------------------------------------
# single-device chunked accumulation
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("scale", "kind", "out_h", "out_w", "bands", "sigma",
                     "method", "use_seam", "use_field", "paste_seam"))
def _chunk_accum(color, alpha, src_u8, Ka, R, corner, vhw, roi_wh, offs,
                 seam_blks, seam_ratios, field_blks, field_ratios, gains,
                 scale: float, kind: str, out_h: int, out_w: int,
                 bands: int, sigma: float, method: str,
                 use_seam: bool, use_field: bool, paste_seam: bool):
    """Fold one chunk of images into the canvas accumulators.

    method MULTI: (color, alpha) are the multiband sums.
    method SIMPLE: feathered (1-acc) compositing — color/alpha as in
      blending.simple_blend.
    method NO: color is the canvas, alpha unused (paste in order).
    Padding entries are passed with vhw = 0 -> empty mask -> no-op.

    The per-image work is BATCHED across the chunk (packed-neighborhood
    uint8 warp, one grouped conv per band level, one windowed erode) —
    the hardware-shaped form of the image loop; only the order-free
    canvas folds run as a lax.scan, so compile time stays independent of
    the chunk size."""
    G = src_u8.shape[0]

    def prep(src, Ka_g, R_g, c_g, vhw_g, wh_g, sb, sr, fb, fr, g_g):
        warped, mask = prj.warp_from_grid_u8(
            src, Ka_g, R_g, c_g, scale, kind,
            jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 0),
            jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 1),
            vhw_g)
        if use_seam:
            seam_up = _upsample_block(sb, (out_h, out_w), sr, cubic=True)
        else:
            seam_up = jnp.zeros((out_h, out_w), jnp.float32)
        img = warped / g_g
        if use_field:
            f_up = _upsample_block(fb, (out_h, out_w), fr, cubic=False)
            f_up = jnp.where(jnp.abs(f_up) < 1e-6, 1.0, f_up)
            img = img / f_up[..., None]
        # NOTE: img is intentionally NOT zeroed outside the eroded mask —
        # the reference blurs the full warped block (values in the
        # erosion rim bleed into the band colors); the weights alone are
        # mask-gated.
        return img, mask, seam_up

    imgs, masks, seam_ups = jax.vmap(prep)(
        src_u8, Ka, R, corner, vhw, roi_wh, seam_blks, seam_ratios,
        field_blks, field_ratios, gains)
    masks = prj.erode_mask(masks, iters=4)
    yy = jax.lax.broadcasted_iota(jnp.int32, (G, out_h, out_w), 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, (G, out_h, out_w), 2)
    masks = masks & (yy < roi_wh[:, 1, None, None]) \
        & (xx < roi_wh[:, 0, None, None])
    masks_f = masks.astype(jnp.float32)
    if use_seam:
        seams = jnp.where((seam_ups > 0.5) & masks, 1.0, 0.0)
    else:
        seams = masks_f

    if method == "MULTI":
        from simplepanorama_tpu.render.blending import mb_batch_contribution
        colors, alphas = mb_batch_contribution(imgs, seams, masks_f,
                                               bands, sigma)

        def step(carry, xs):
            color, alpha = carry
            c, a, off = xs
            return (_acc_add(color, c, off), _acc_add(alpha, a, off)), None

        (color, alpha), _ = jax.lax.scan(step, (color, alpha),
                                         (colors, alphas, offs))
        return color, alpha

    if method == "SIMPLE":
        dts = jax.vmap(lambda m: distance_transform(m > 0))(masks_f)
        feas = dts / jnp.maximum(
            jnp.max(dts, axis=(1, 2), keepdims=True), 1e-12)

        def step(carry, xs):
            color, alpha = carry
            img, fea, off = xs
            acc_a = jax.lax.dynamic_slice(
                alpha, (off[0], off[1]), (out_h, out_w))
            contrib = fea * (1.0 - acc_a)
            color = _acc_add(color, img * contrib[..., None], off)
            alpha = jax.lax.dynamic_update_slice(
                alpha, acc_a + contrib, (off[0], off[1]))
            return (color, alpha), None

        (color, alpha), _ = jax.lax.scan(step, (color, alpha),
                                         (imgs, feas, offs))
        return color, alpha

    # NO_BLEND: masked paste in order
    def step(carry, xs):
        color, alpha = carry
        img, sel, off = xs
        sl = jax.lax.dynamic_slice(
            color, (off[0], off[1], 0), (out_h, out_w, 3))
        sl = jnp.where(sel[..., None] > 0, img, sl)
        color = jax.lax.dynamic_update_slice(
            color, sl, (off[0], off[1], 0))
        return (color, alpha), None

    (color, alpha), _ = jax.lax.scan(
        step, (color, alpha),
        (imgs, seams if paste_seam else masks_f, offs))
    return color, alpha


@functools.partial(jax.jit, static_argnames=("method", "bands", "hw"))
def _finalize(color, alpha, method: str, bands: int, hw):
    H, W = hw
    color = color[:H, :W]
    alpha = alpha[:H, :W]
    if method == "MULTI":
        out = color / jnp.maximum(alpha[..., None], 1e-12) * bands
        out = jnp.where(alpha[..., None] > 0, out, 0.0)
    elif method == "SIMPLE":
        out = color / jnp.maximum(alpha[..., None], 1e-12)
        out = jnp.where(alpha[..., None] > 0, out, 0.0)
    else:
        out = color
    return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _pad_align(h, w):
    return (h + 7) // 8 * 8, (w + 127) // 128 * 128


def prefetch_sources(params, full_images: Sequence[Optional[np.ndarray]]):
    """Upload the packed full-res source stack ahead of render_full_dev
    (e.g. from a background thread while the preview is still rendering);
    pass the result as ``src_stack``. Sources depend only on the stitch
    result, never on the compositing config, so a prefetched stack stays
    valid across blend/seam/projection changes."""
    res = params.res
    n = len(res.nodes)
    sel = [i for i in range(n)
           if res.connectivity[i] > 0 and full_images[i] is not None]
    if not sel:
        return None
    Hs = max(full_images[i].shape[0] for i in sel)
    Ws = max(full_images[i].shape[1] for i in sel)
    return _pack_sources(full_images, sel, Hs, Ws)


def render_full_dev(params, cfg: Config,
                    full_images: Sequence[Optional[np.ndarray]],
                    force_single: bool = False, mesh=None,
                    src_stack=None) -> np.ndarray:
    """Streaming device re-render at full resolution.

    ``params`` is the preview StitchParams (seam masks / intensity fields
    / gains are reused at full res, per return_full); ``full_images`` the
    full-res BGR uint8 images in component order."""
    res = params.res
    st = params.state
    n = len(res.nodes)

    # ---- K rescale by the per-image resolution ratio (return_full,
    # _panorama.cpp:272-288) ----
    K_scaled = res.K.copy().astype(np.float64)
    sizes_full = []
    for l in range(n):
        img = full_images[l]
        if img is None:
            sizes_full.append(res.sizes[l])
            continue
        h0, w0 = res.sizes[l]
        h1, w1 = img.shape[:2]
        r = w1 / w0
        K_scaled[l, 0, 0] *= r
        K_scaled[l, 0, 2] *= r
        K_scaled[l, 1, 1] *= r
        K_scaled[l, 1, 2] *= r
        sizes_full.append((h1, w1))
    scale = float(K_scaled[res.center][0, 0])

    sel = [i for i in range(n)
           if res.connectivity[i] > 0 and full_images[i] is not None]
    kind = params.proj_kind

    # ---- full-res ROIs, canvas geometry (host, tiny) ----
    rois_f = {i: prj.roi_for_image(kind, scale, params.rot[i], K_scaled[i],
                                   sizes_full[i][0], sizes_full[i][1])
              for i in sel}
    out_h = max(rois_f[i][3] for i in sel)
    out_w = max(rois_f[i][2] for i in sel)
    out_h, out_w = _pad_align(out_h, out_w)
    from simplepanorama_tpu.geometry.canvas import get_pan_dimension
    corners = [(rois_f[i][0], rois_f[i][1]) for i in sel]
    d = get_pan_dimension(corners, [(rois_f[i][3], rois_f[i][2])
                                    for i in sel])

    method = ("NO" if cfg.blend == Blending.NO_BLEND else
              "SIMPLE" if cfg.blend == Blending.SIMPLE_BLEND else "MULTI")
    have_seams = st.seam_masks is not None
    use_seam = method == "MULTI" and have_seams
    paste_seam = (method == "NO" and have_seams
                  and (cfg.cut or cfg.cut_seams))
    if paste_seam:
        use_seam = True
    use_field = cfg.blend_intensity and st.intensity is not None

    # ---- per-image device parameters ----
    # state row of each selected image (warp_all packs connectivity>0 rows
    # in index order, matching the preview blocks)
    state_sel = [i for i in range(n) if res.connectivity[i] > 0]
    row_of = {i: b for b, i in enumerate(state_sel)}

    m = len(sel)
    Hs = max(sizes_full[i][0] for i in sel)
    Ws = max(sizes_full[i][1] for i in sel)
    Ka_b = np.zeros((m, 3, 3), np.float32)
    R_b = np.zeros((m, 3, 3), np.float32)
    c_b = np.zeros((m, 2), np.float32)
    vhw_b = np.zeros((m, 2), np.int32)
    wh_b = np.zeros((m, 2), np.int32)
    off_b = np.zeros((m, 2), np.int32)
    sr_b = np.ones((m, 2), np.float32)     # seam (preview->full) ratios
    fr_b = np.ones((m, 2), np.float32)     # intensity-field ratios
    g_b = np.ones((m,), np.float32)
    rows = np.zeros((m,), np.int32)
    for b, i in enumerate(sel):
        h1, w1 = sizes_full[i]
        Ka_b[b] = prj.adjusted_K(K_scaled[i], h1, w1)
        R_b[b] = np.asarray(params.rot[i], np.float32)
        tlx, tly, rw_f, rh_f = rois_f[i]
        c_b[b] = (tlx, tly)
        vhw_b[b] = (h1, w1)
        wh_b[b] = (rw_f, rh_f)
        off_b[b] = (tly - d.min_y, tlx - d.min_x)
        rows[b] = row_of[i]
        _, _, rw_p, rh_p = st.rois[row_of[i]]
        sr_b[b] = (rh_p / rh_f, rw_p / rw_f)
        fr_b[b] = ((rh_p // 2) / rh_f, (rw_p // 2) / rw_f)
        if params.gains is not None and cfg.gain_compensation:
            g_b[b] = float(params.gains[row_of[i]])

    rows_j = jnp.asarray(rows)
    if use_seam:
        seam_blks = st.seam_masks[rows_j].astype(jnp.float32)
    else:
        seam_blks = jnp.zeros((m, 1, 1), jnp.float32)
    if use_field:
        field_blks = st.intensity[rows_j]
    else:
        field_blks = jnp.zeros((m, 1, 1), jnp.float32)

    if force_single:
        mesh = None
    elif mesh is None and method == "MULTI":
        from simplepanorama_tpu.parallel.mesh import pipeline_mesh
        mesh = pipeline_mesh()
    if method != "MULTI":
        mesh = None
    if mesh is not None:
        from simplepanorama_tpu.parallel import tiled_compose as tc
        args = dict(
            Ka=jnp.asarray(Ka_b), R=jnp.asarray(R_b),
            corner=jnp.asarray(c_b), vhw=jnp.asarray(vhw_b),
            roi_wh=jnp.asarray(wh_b), offs=jnp.asarray(off_b),
            seam_blks=seam_blks, seam_ratios=jnp.asarray(sr_b),
            field_blks=field_blks, field_ratios=jnp.asarray(fr_b),
            gains=jnp.asarray(g_b), scale=scale, kind=kind,
            canvas_hw=(d.height, d.width), min_xy=(d.min_x, d.min_y),
            bands=cfg.bands, sigma=float(cfg.sigma_blend),
            use_seam=use_seam, use_field=use_field, mesh=mesh)
        if src_stack is None or tuple(src_stack.shape) != (m, Hs, Ws, 3):
            src_stack = _pack_sources(full_images, sel, Hs, Ws)
        ndev = mesh.devices.size
        if m >= ndev:
            out = tc.fullres_multi_dp(src_stack, block_hw=(out_h, out_w),
                                      **args)
        else:
            out = tc.fullres_multi_canvas(src_stack, **args)
        return np.asarray(out)

    # ---- single-device streaming ----
    if src_stack is not None and tuple(src_stack.shape) != (m, Hs, Ws, 3):
        src_stack = None                        # stale prefetch; re-upload
    # MULTI materializes every band level of the 4-channel blurred batch
    # simultaneously (~16*(bands+1) B/px) on top of the 16 B/px source
    # concat; NO/SIMPLE stay near the flat 12 B/px estimate
    temps = 4 * (4 * (cfg.bands + 1) + 4) if method == "MULTI" else 4 * 12
    per_img = (Hs * Ws * (3 + 16)               # uint8 source + packed nbr
               + out_h * out_w * 4 * (3 + 1 + 1)    # block + mask + seam
               + out_h * out_w * temps)         # blur/contribution temps
    # a prefetched device-resident source stack counts against the budget
    budget = _CHUNK_BUDGET - (src_stack.nbytes if src_stack is not None
                              else 0)
    G = int(max(1, min(m, max(1, budget) // max(1, per_img))))
    if src_stack is None and m >= 4:
        # >=2 chunks so later host->device uploads overlap earlier chunks'
        # compute (a prefetched stack is already device-resident)
        G = min(G, (m + 1) // 2)

    Hc2, Wc2 = d.height + out_h, d.width + out_w
    color = jnp.zeros((Hc2, Wc2, 3), jnp.float32)
    alpha = jnp.zeros((Hc2, Wc2), jnp.float32)

    for s in range(0, m, G):
        ids = list(range(s, min(s + G, m)))
        pad = G - len(ids)
        if src_stack is not None:
            if pad:
                src = src_stack[jnp.asarray(np.array(ids + [0] * pad,
                                                     np.int32))]
            else:
                src = jax.lax.slice_in_dim(src_stack, s, s + G)
        else:
            src_h = np.zeros((G, Hs, Ws, 3), np.uint8)
            for k, b in enumerate(ids):
                h1, w1 = sizes_full[sel[b]]
                src_h[k, :h1, :w1] = full_images[sel[b]]
            src = jnp.asarray(src_h)

        def take(a, fill=0):
            out_a = np.concatenate(
                [a[ids], np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                if pad else a[ids]
            return jnp.asarray(out_a)

        idx = jnp.asarray(np.array(ids + [0] * pad, np.int32))
        color, alpha = _chunk_accum(
            color, alpha, src,
            take(Ka_b), take(R_b), take(c_b), take(vhw_b), take(wh_b),
            take(off_b), seam_blks[idx], take(sr_b, 1.0),
            field_blks[idx], take(fr_b, 1.0), take(g_b, 1.0),
            scale=scale, kind=kind, out_h=out_h, out_w=out_w,
            bands=cfg.bands, sigma=float(cfg.sigma_blend), method=method,
            use_seam=use_seam, use_field=use_field, paste_seam=paste_seam)

    return np.asarray(_finalize(color, alpha, method, cfg.bands,
                                (d.height, d.width)))


def _pack_sources(full_images, sel, Hs, Ws):
    m = len(sel)
    src = np.zeros((m, Hs, Ws, 3), np.uint8)
    for b, i in enumerate(sel):
        im = full_images[i]
        src[b, :im.shape[0], :im.shape[1]] = im
    return jnp.asarray(src)
