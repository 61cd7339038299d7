"""Spatially-sharded compositing: the panorama canvas partitioned across
devices.

This is the workload's analog of sequence parallelism (SURVEY §2.7/§5):
the reference composites sequentially on one CPU (blnd::multi_blend,
/root/reference/src/math/_blending.cpp:186-252; proj::get_proj_parameters,
/root/reference/src/math/_projection.cpp:422-454); here the two heavy
compositing stages get mesh-parallel schedules:

* ``multi_blend_sharded`` — the band-pass pyramid work (per-image, per-band
  Gaussian blurs: the FLOP-heavy part) is data-parallel over the image
  batch; each device accumulates its images' color/alpha contributions on a
  full canvas, then ONE ``psum_scatter`` per accumulator reduces across
  devices and leaves each device holding the summed slab of canvas columns.
  Normalization (color/alpha) is local to the slab; an ``all_gather``
  reassembles the panorama. Multiband blending is a pure sum over images,
  so the schedule is exact — NO_BLEND/SIMPLE_BLEND are order-dependent
  compositing and stay single-device.

* ``warp_tiled`` — the full-resolution render path. The reference's canvas
  can reach 30000 px (_img_manipulation.cpp:349-354); at full resolution
  the canvas, not the per-image blocks, is the memory high-water mark.
  Each device backward-maps ONLY its slab of canvas columns (inverse
  warping is embarrassingly parallel over destination pixels), so canvas
  memory scales 1/n_devices with zero communication.

* ``halo_exchange`` — ppermute neighbor-column exchange for canvas-resident
  stencils (boundary columns for blurs/erosions on column-sharded slabs).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from simplepanorama_tpu.render.blending import _blur_fixed, _acc_add
from simplepanorama_tpu.render import projection as prj


def halo_exchange(x: jnp.ndarray, halo: int, axis: str,
                  fill: float = 0.0) -> jnp.ndarray:
    """Pad a column-sharded slab with ``halo`` columns from each mesh
    neighbor (``fill`` at the mesh ends). Must run inside shard_map over
    ``axis``; x is the local (H, Ws, ...) slab, returns (H, Ws+2*halo, ...).

    The ppermute pair is the collective idiom for stencil boundaries: each
    device sends its edge columns one hop left and one hop right.
    """
    n = jax.lax.axis_size(axis)
    left_edge = jax.lax.slice_in_dim(x, 0, halo, axis=1)
    right_edge = jax.lax.slice_in_dim(x, x.shape[1] - halo, x.shape[1],
                                      axis=1)
    # device d receives (d-1)'s right edge as its left halo and (d+1)'s
    # left edge as its right halo (non-participants receive zeros)
    from_left = jax.lax.ppermute(
        right_edge, axis, [(d, d + 1) for d in range(n - 1)])
    from_right = jax.lax.ppermute(
        left_edge, axis, [(d + 1, d) for d in range(n - 1)])
    if fill != 0.0:
        d = jax.lax.axis_index(axis)
        from_left = jnp.where(d == 0, jnp.full_like(from_left, fill),
                              from_left)
        from_right = jnp.where(d == n - 1, jnp.full_like(from_right, fill),
                               from_right)
    return jnp.concatenate([from_left, x, from_right], axis=1)


# ---------------------------------------------------------------------------
# multiband blend: images-DP + canvas reduce_scatter
# ---------------------------------------------------------------------------

def _mb_block_contribution(img, seam, orig, bands: int, sigma: float):
    """Per-image multiband contribution summed over bands (same math as
    blending.multi_blend, which accumulates band-by-band — addition
    commutes): returns (color (Hb,Wb,3), alpha (Hb,Wb))."""
    radius = int(np.ceil(3 * sigma))
    color = jnp.zeros_like(img)
    alpha = jnp.zeros(img.shape[:2], jnp.float32)
    for i in range(bands):
        sigma_band = float(np.sqrt(2 * (bands - i) + 1) * sigma)
        blurred = _blur_fixed(img, sigma_band, radius)
        w = _blur_fixed((seam[..., None] > 0).astype(jnp.float32),
                        sigma_band, radius)[..., 0]
        if i == bands - 1:
            band = img - blurred
        elif i > 0:
            sigma_prev = float(np.sqrt(2 * (bands - i - 1) + 1) * sigma)
            band = blurred - _blur_fixed(img, sigma_prev, radius)
        else:
            band = blurred
        w = jnp.where(orig > 0, w, 0.0)
        color = color + band * w[..., None]
        alpha = alpha + w
    return color, alpha


def multi_blend_sharded(imgs, seam_msks, orig_msks, offs,
                        canvas_hw: Tuple[int, int], mesh: Mesh,
                        bands: int = 2, sigma: float = 7.0,
                        axis: str = "data") -> jnp.ndarray:
    """blending.multi_blend with the image batch sharded over ``mesh``.

    Collective schedule: local band-pyramid + local canvas accumulation,
    one psum_scatter per accumulator (color, alpha) that both reduces
    across devices and shards the result by canvas columns, local
    normalization. Returns the (H, W, 3) panorama (column-sharded global
    array; gathers lazily on host read).
    """
    from jax import shard_map

    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    ndev = mesh.devices.size
    # pad the image batch to a multiple of the mesh size (zero masks
    # contribute nothing) and the canvas width so slabs divide evenly
    Np = (N + ndev - 1) // ndev * ndev
    if Np != N:
        pad = ((0, Np - N),)
        imgs = jnp.pad(imgs, pad + ((0, 0),) * 3)
        seam_msks = jnp.pad(seam_msks, pad + ((0, 0),) * 2)
        orig_msks = jnp.pad(orig_msks, pad + ((0, 0),) * 2)
        offs = jnp.pad(offs, pad + ((0, 0),))
    Hc = H + Hb
    Wc = ((W + Wb + ndev - 1) // ndev) * ndev

    def body(imgs_l, seams_l, origs_l, offs_l):
        color = jnp.zeros((Hc, Wc, 3), jnp.float32)
        alpha = jnp.zeros((Hc, Wc), jnp.float32)
        for j in range(imgs_l.shape[0]):
            c, a = _mb_block_contribution(imgs_l[j], seams_l[j],
                                          origs_l[j], bands, float(sigma))
            color = _acc_add(color, c, offs_l[j])
            alpha = _acc_add(alpha, a, offs_l[j])
        color = jax.lax.psum_scatter(color, axis, scatter_dimension=1,
                                     tiled=True)
        alpha = jax.lax.psum_scatter(alpha, axis, scatter_dimension=1,
                                     tiled=True)
        out = color / jnp.maximum(alpha[..., None], 1e-12)
        return jnp.where(alpha[..., None] > 0, out * bands, 0.0)

    # the normalized slab stays column-sharded; jit assembles the global
    # canvas (the all_gather happens lazily only if a consumer needs it)
    f = shard_map(body, mesh=mesh,
                  in_specs=(P(axis), P(axis), P(axis), P(axis)),
                  out_specs=P(None, axis))
    out = jax.jit(f)(imgs.astype(jnp.float32),
                     seam_msks.astype(jnp.float32),
                     orig_msks.astype(jnp.float32), offs)
    return out[:H, :W]


# ---------------------------------------------------------------------------
# tiled backward warp: canvas columns sharded
# ---------------------------------------------------------------------------

def warp_tiled(img, K_adj, R, corner, scale, kind: str,
               out_h: int, out_w: int, valid_hw, mesh: Mesh,
               axis: str = "data"):
    """projection.warp_backward with the destination ROI column-sharded:
    device d computes canvas columns [d*Ws, (d+1)*Ws). The source image is
    replicated; there is no communication. Returns (warped, mask) sharded
    (H, W/n) per device, assembled as global arrays by jit."""
    from jax import shard_map

    ndev = mesh.devices.size
    Wp = (out_w + ndev - 1) // ndev * ndev
    Ws = Wp // ndev

    def body(img_r, Ka_r, R_r, corner_r, vhw_r):
        d = jax.lax.axis_index(axis)
        yy = jax.lax.broadcasted_iota(jnp.float32, (out_h, Ws), 0)
        xx = (jax.lax.broadcasted_iota(jnp.float32, (out_h, Ws), 1)
              + (d * Ws).astype(jnp.float32))
        return prj.warp_from_grid(img_r, Ka_r, R_r, corner_r, scale, kind,
                                  yy, xx, vhw_r)

    f = shard_map(body, mesh=mesh,
                  in_specs=(P(), P(), P(), P(), P()),
                  out_specs=(P(None, axis), P(None, axis)))
    warped, mask = jax.jit(f)(img, K_adj, R, corner, valid_hw)
    return warped[:, :out_w], mask[:, :out_w]


# ---------------------------------------------------------------------------
# full-resolution multiband render: two mesh schedules
# ---------------------------------------------------------------------------

def _blur_slab(x, sigma: float, radius: int, axis: str):
    """Separable fixed-radius Gaussian of a column-sharded canvas slab:
    ppermute halo exchange supplies the ``radius`` neighbor columns, rows
    are local (zero beyond the canvas — identical to the block zero-pad
    the single-device blend uses)."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    kh = jnp.asarray(k)[None, None, None, :]
    kv = jnp.asarray(k)[None, None, :, None]
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    xp = halo_exchange(x, radius, axis, fill=0.0)
    C = x.shape[2]
    xx = xp.transpose(2, 0, 1)[None]
    xx = jax.lax.conv_general_dilated(
        xx, jnp.tile(kh, (C, 1, 1, 1)), (1, 1),
        [(0, 0), (0, 0)], feature_group_count=C)
    xx = jax.lax.conv_general_dilated(
        xx, jnp.tile(kv, (C, 1, 1, 1)), (1, 1),
        [(radius, radius), (0, 0)], feature_group_count=C)
    out = xx[0].transpose(1, 2, 0)
    return out[..., 0] if squeeze else out


def _erode_slab(m, iters: int, axis: str):
    """3x3 min-pool erosion of a column-sharded boolean slab with halo
    exchange; outside-is-black falls out of the VALID windows (equivalent
    to projection.erode_mask's border rule — a footprint pixel on its ROI
    bbox edge always has a zero neighbor)."""
    mp = halo_exchange(m.astype(jnp.float32), iters, axis, fill=0.0)
    mp = jnp.pad(mp, ((iters, iters), (0, 0)))
    for _ in range(iters):
        mp = jax.lax.reduce_window(mp, 1.0, jax.lax.min, (3, 3), (1, 1),
                                   "VALID")
    return mp > 0.5


def fullres_multi_dp(src_u8, block_hw, Ka, R, corner, vhw, roi_wh, offs,
                     seam_blks, seam_ratios, field_blks, field_ratios,
                     gains, scale: float, kind: str, canvas_hw, min_xy,
                     bands: int, sigma: float, use_seam: bool,
                     use_field: bool, mesh: Mesh, axis: str = "data"):
    """Full-res multiband render, image-data-parallel: each device folds
    its shard of images into a PRIVATE canvas accumulator (block-space
    per-image work, same code as the single-device stream), then one
    psum_scatter per accumulator reduces across devices and leaves each
    device normalizing its slab of canvas columns."""
    from jax import shard_map
    from simplepanorama_tpu.render.fullres import (_prep_block,
                                                   _mb_contribution)

    H, W = canvas_hw
    out_h, out_w = block_hw
    ndev = mesh.devices.size
    m = src_u8.shape[0]
    mp_ = (m + ndev - 1) // ndev * ndev
    if mp_ != m:
        pad = mp_ - m

        def z(a):
            return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        src_u8, Ka, R, corner, offs = map(z, (src_u8, Ka, R, corner, offs))
        vhw, roi_wh = map(z, (vhw, roi_wh))       # vhw=0 -> empty mask
        seam_blks, field_blks = map(z, (seam_blks, field_blks))
        seam_ratios = jnp.pad(seam_ratios, ((0, pad), (0, 0)),
                              constant_values=1.0)
        field_ratios = jnp.pad(field_ratios, ((0, pad), (0, 0)),
                               constant_values=1.0)
        gains = jnp.pad(gains, (0, pad), constant_values=1.0)

    Hc2 = H + out_h
    Wc2 = ((W + out_w + ndev - 1) // ndev) * ndev

    def body(src_l, Ka_l, R_l, c_l, vhw_l, wh_l, off_l, sb_l, sr_l,
             fb_l, fr_l, g_l):
        # the carry accumulates per-device (varying) contributions; mark
        # the zero init varying so the scan carry types line up
        color = jax.lax.pcast(jnp.zeros((Hc2, Wc2, 3), jnp.float32),
                              (axis,), to='varying')
        alpha = jax.lax.pcast(jnp.zeros((Hc2, Wc2), jnp.float32),
                              (axis,), to='varying')

        def step(carry, xs):
            color, alpha = carry
            (src, Ka_g, R_g, c_g, vhw_g, wh_g, off, sb, sr, fb, fr,
             g_g) = xs
            img, mask, seam = _prep_block(
                src.astype(jnp.float32), Ka_g, R_g, c_g, vhw_g, wh_g,
                scale, kind, out_h, out_w, sb, sr, fb, fr, g_g,
                use_seam, use_field)
            c, a = _mb_contribution(img, seam, mask, bands, sigma)
            return (_acc_add(color, c, off), _acc_add(alpha, a, off)), None

        (color, alpha), _ = jax.lax.scan(
            step, (color, alpha),
            (src_l, Ka_l, R_l, c_l, vhw_l, wh_l, off_l, sb_l, sr_l,
             fb_l, fr_l, g_l))
        color = jax.lax.psum_scatter(color, axis, scatter_dimension=1,
                                     tiled=True)
        alpha = jax.lax.psum_scatter(alpha, axis, scatter_dimension=1,
                                     tiled=True)
        out = color / jnp.maximum(alpha[..., None], 1e-12) * bands
        out = jnp.where(alpha[..., None] > 0, out, 0.0)
        return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)

    f = shard_map(body, mesh=mesh,
                  in_specs=(P(axis),) * 12, out_specs=P(None, axis))
    sh = NamedSharding(mesh, P(axis))
    args = [jax.device_put(a, sh) for a in
            (src_u8, Ka, R, corner, vhw, roi_wh, offs, seam_blks,
             seam_ratios, field_blks, field_ratios, gains)]
    out = jax.jit(f)(*args)
    return out[:H, :W]


def fullres_multi_canvas(src_u8, Ka, R, corner, vhw, roi_wh, offs,
                         seam_blks, seam_ratios, field_blks, field_ratios,
                         gains, scale: float, kind: str, canvas_hw, min_xy,
                         bands: int, sigma: float, use_seam: bool,
                         use_field: bool, mesh: Mesh, axis: str = "data"):
    """Full-res multiband render with the CANVAS column-sharded (the
    warp_tiled schedule, for small image counts where image-DP would idle
    devices): every image is warped directly onto each device's slab of
    canvas columns via the same grid pattern as warp_tiled; seam/field
    blocks are upsampled straight into canvas coordinates; band blurs and
    mask erosion run on the slabs with ppermute halo exchange. Per-image
    canvas-space math is identical to block space because a warped block
    is exactly the canvas restricted to its ROI (zeros elsewhere)."""
    from jax import shard_map
    from simplepanorama_tpu.render.fullres import _resize_matrix

    H, W = canvas_hw
    ndev = mesh.devices.size
    Hcp = (H + 7) // 8 * 8
    Wcp = ((W + 128 * ndev - 1) // (128 * ndev)) * 128 * ndev
    Wsl = Wcp // ndev
    m = src_u8.shape[0]
    radius = int(np.ceil(3 * sigma))
    sigmas = [float(np.sqrt(2 * (bands - i) + 1) * sigma)
              for i in range(bands)]

    def body(src_r, Ka_r, R_r, c_r, vhw_r, wh_r, off_r, sb_r, sr_r,
             fb_r, fr_r, g_r):
        dref = jax.lax.axis_index(axis)
        x0 = (dref * Wsl).astype(jnp.float32)
        yy = jax.lax.broadcasted_iota(jnp.float32, (Hcp, Wsl), 0)
        xx = jax.lax.broadcasted_iota(jnp.float32, (Hcp, Wsl), 1) + x0
        origin = jnp.asarray([float(min_xy[0]), float(min_xy[1])],
                             jnp.float32)
        color = jax.lax.pcast(jnp.zeros((Hcp, Wsl, 3), jnp.float32),
                              (axis,), to='varying')
        alpha = jax.lax.pcast(jnp.zeros((Hcp, Wsl), jnp.float32),
                              (axis,), to='varying')

        def step(carry, xs):
            color, alpha = carry
            (src_g, Ka_g, R_g, vhw_g, wh_g, off_g, sb_g, sr_g, fb_g,
             fr_g, g_g) = xs
            warped, inb = prj.warp_from_grid(
                src_g.astype(jnp.float32), Ka_g, R_g, origin,
                scale, kind, yy, xx, vhw_g)
            mask = _erode_slab(inb, 4, axis)
            offy = off_g[0].astype(jnp.float32)
            offx = off_g[1].astype(jnp.float32)
            mask = mask & (yy >= offy) & (yy < offy + wh_g[1]) \
                & (xx >= offx) & (xx < offx + wh_g[0])
            mask_f = mask.astype(jnp.float32)
            if use_seam:
                Wy = _resize_matrix(Hcp, sb_g.shape[0], sr_g[0],
                                    offset=-offy, cubic=True)
                Wx = _resize_matrix(Wsl, sb_g.shape[1], sr_g[1],
                                    offset=x0 - offx, cubic=True)
                seam_up = Wy @ sb_g @ Wx.T
                seam = jnp.where((seam_up > 0.5) & mask, 1.0, 0.0)
            else:
                seam = mask_f
            img = warped / g_g
            if use_field:
                Wy = _resize_matrix(Hcp, fb_g.shape[0], fr_g[0],
                                    offset=-offy, cubic=False)
                Wx = _resize_matrix(Wsl, fb_g.shape[1], fr_g[1],
                                    offset=x0 - offx, cubic=False)
                f_up = Wy @ fb_g @ Wx.T
                f_up = jnp.where(jnp.abs(f_up) < 1e-6, 1.0, f_up)
                img = img / f_up[..., None]
            # multiband contribution on the slab (halo-exchanged blurs)
            src4 = jnp.concatenate([img, seam[..., None]], -1)
            blurred = {s: _blur_slab(src4, s, radius, axis)
                       for s in set(sigmas)}
            for i in range(bands):
                sb = sigmas[i]
                if i == bands - 1:
                    band = img - blurred[sb][..., :3]
                elif i > 0:
                    band = blurred[sb][..., :3] \
                        - blurred[sigmas[i + 1]][..., :3]
                else:
                    band = blurred[sb][..., :3]
                w = jnp.where(mask_f > 0, blurred[sb][..., 3], 0.0)
                color = color + band * w[..., None]
                alpha = alpha + w
            return (color, alpha), None

        (color, alpha), _ = jax.lax.scan(
            step, (color, alpha),
            (src_r, Ka_r, R_r, vhw_r, wh_r, off_r, sb_r, sr_r, fb_r,
             fr_r, g_r))
        out = color / jnp.maximum(alpha[..., None], 1e-12) * bands
        out = jnp.where(alpha[..., None] > 0, out, 0.0)
        return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)

    f = shard_map(body, mesh=mesh, in_specs=(P(),) * 12,
                  out_specs=P(None, axis))
    sh = NamedSharding(mesh, P())
    args = [jax.device_put(a, sh) for a in
            (src_u8, Ka, R, corner, vhw, roi_wh, offs, seam_blks,
             seam_ratios, field_blks, field_ratios, gains)]
    out = jax.jit(f)(*args)
    return out[:H, :W]
