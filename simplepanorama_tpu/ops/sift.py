"""SIFT on the device: DoG scale-space detector + descriptor as a fixed-shape JAX
program.

The reference delegates to OpenCV's SIFT and post-processes to rootSIFT with
center-origin keypoints (util::extract_keypoints,
/root/reference/src/math/_homography.cpp:727-751). Here the whole detector
runs on-device, redesigned for batched fixed-shape execution rather than
translated:

  * the Gaussian pyramid is built with separable depthwise convolutions
    (static kernel sizes — sigmas are trace-time constants);
  * scale-space extrema are found with 3x3x3 ``reduce_window`` max/min over
    the DoG stack — no per-pixel scalar loop;
  * a fixed per-octave budget of candidates is selected with ``top_k`` on
    the pre-threshold response map (fixed shapes; invalid slots masked);
  * sub-pixel refinement solves the 3x3 quadratic fit in closed form,
    vmapped over candidates (mirrors OpenCV's adjustLocalExtrema math);
  * orientation and descriptor use a *canonical resampling grid*: instead of
    OpenCV's variable-radius pixel loops, a fixed SxS grid in the keypoint
    frame is bilinearly sampled from the octave image, and the 4x4x8
    histogram is accumulated with one einsum (static trilinear spatial
    weights x data-dependent orientation weights) — a matmul;
  * descriptors are rootSIFT-normalized (L1 + sqrt, convert_to_rootsift,
    _homography.cpp:700-724), so matching distances reduce to dot products.

Everything is jit/vmap-compatible: one compiled program serves a whole batch
of images padded to a common shape, with per-image valid extents as data.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

# OpenCV-compatible constants
_IMG_BORDER = 5          # SIFT_IMG_BORDER
_MAX_INTERP_STEPS = 5    # SIFT_MAX_INTERP_STEPS
_ORI_SIG_FCTR = 1.5      # SIFT_ORI_SIG_FCTR
_ORI_RADIUS = 3 * _ORI_SIG_FCTR  # 4.5
_ORI_HIST_BINS = 36
_DESCR_WIDTH = 4         # SIFT_DESCR_WIDTH (d)
_DESCR_HIST_BINS = 8     # SIFT_DESCR_HIST_BINS (n)
_DESCR_SCL_FCTR = 3.0    # SIFT_DESCR_SCL_FCTR
_DESCR_MAG_THR = 0.2     # SIFT_DESCR_MAG_THR
_ORI_GRID = 17           # canonical orientation sampling grid (odd)
_DESCR_GRID = 16         # canonical descriptor sampling grid


class SiftFeatures(NamedTuple):
    """Fixed-capacity keypoints+descriptors for one image (or a batch)."""
    xy: jnp.ndarray        # (..., K, 2) float32, original-image pixel coords
    size: jnp.ndarray      # (..., K) float32 keypoint diameter
    response: jnp.ndarray  # (..., K) float32
    desc: jnp.ndarray      # (..., K, 128) float32 rootSIFT (unit L2)
    valid: jnp.ndarray     # (..., K) bool


# ---------------------------------------------------------------------------
# Gaussian pyramid
# ---------------------------------------------------------------------------

def _gauss_kernel(sigma: float) -> np.ndarray:
    """1-D Gaussian taps, OpenCV float-image rule: 4 sigma each side."""
    radius = max(1, int(round(sigma * 4)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur of a (H, W) image, replicate borders."""
    if sigma <= 0:
        return img
    k = _gauss_kernel(sigma)
    r = (len(k) - 1) // 2
    x = img[None, None]                                   # (1,1,H,W)
    kh = jnp.asarray(k)[None, None, None, :]              # (1,1,1,T)
    kv = jnp.asarray(k)[None, None, :, None]              # (1,1,T,1)
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (r, r)), mode="edge")
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID")
    x = jnp.pad(x, ((0, 0), (0, 0), (r, r), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), "VALID")
    return x[0, 0]


def _pyramid_sigmas(sigma: float, n_layers: int) -> List[float]:
    """Incremental blur amounts between adjacent gaussian levels
    (OpenCV buildGaussianPyramid)."""
    k = 2.0 ** (1.0 / n_layers)
    sigs = [sigma]
    for i in range(1, n_layers + 3):
        sig_prev = (k ** (i - 1)) * sigma
        sig_total = sig_prev * k
        sigs.append(math.sqrt(sig_total ** 2 - sig_prev ** 2))
    return sigs


def _from_base_sigmas(sigma: float, n_layers: int) -> List[float]:
    """Blur amounts of every level DIRECTLY from the octave base (which
    already carries blur ``sigma``). Gaussian semigroup: blurring the base
    by sqrt(sig_total^2 - sigma^2) equals OpenCV's incremental chain."""
    k = 2.0 ** (1.0 / n_layers)
    out = [0.0]
    for i in range(1, n_layers + 3):
        sig_total = (k ** i) * sigma
        out.append(math.sqrt(max(sig_total ** 2 - sigma ** 2, 1e-8)))
    return out


def _multi_kernels(sigmas: List[float]) -> np.ndarray:
    """(L, T) tap matrix, all kernels zero-padded to the widest radius.
    A zero sigma becomes the identity (delta) kernel."""
    rads = [max(1, int(round(s * 4))) if s > 0 else 0 for s in sigmas]
    R = max(rads)
    T = 2 * R + 1
    ks = np.zeros((len(sigmas), T), np.float32)
    for i, s in enumerate(sigmas):
        if s <= 0:
            ks[i, R] = 1.0
            continue
        r = rads[i]
        x = np.arange(-r, r + 1, dtype=np.float64)
        k = np.exp(-(x * x) / (2.0 * s * s))
        ks[i, R - r:R + r + 1] = (k / k.sum()).astype(np.float32)
    return ks


def _blur_multi(base: jnp.ndarray, sigmas: List[float]) -> jnp.ndarray:
    """All pyramid levels of one octave in TWO conv dispatches.

    base: (N, H, W) batch of octave bases. Returns (N, L, H, W) where
    level l is base blurred by sigmas[l]. The horizontal pass is a dense
    1->L-channel conv; the vertical pass is a depthwise
    conv over the L level-channels. This replaces the reference-shaped
    chain of ~2(L-1) single-channel convs per octave per image with two
    batched ops — the difference between ~120 tiny dispatches and ~10
    large ones on the device."""
    ks = _multi_kernels(sigmas)
    L, T = ks.shape
    R = (T - 1) // 2
    x = base[:, None]                                     # (N,1,H,W)
    kh = jnp.asarray(ks)[:, None, None, :]                # (L,1,1,T)
    kv = jnp.asarray(ks)[:, :, None]                      # (L,T,1) -> below
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (R, R)), mode="edge")
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID")   # (N,L,H,W)
    x = jnp.pad(x, ((0, 0), (0, 0), (R, R), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x, kv[:, None, :, :], (1, 1), "VALID", feature_group_count=L)
    return x


def build_pyramid_batch(base: jnp.ndarray, sigma: float, n_layers: int,
                        n_octaves: int) -> List[jnp.ndarray]:
    """Batched Gaussian pyramid: list over octaves of (N, L, H_o, W_o).
    Levels are blurred directly from each octave base (see _blur_multi);
    the next octave base is level ``n_layers`` stride-2 subsampled, exactly
    as OpenCV's buildGaussianPyramid."""
    sigs = _from_base_sigmas(sigma, n_layers)
    octaves = []
    cur = base
    for o in range(n_octaves):
        oct_ = _blur_multi(cur, sigs)
        octaves.append(oct_)
        cur = oct_[:, n_layers, ::2, ::2]
    return octaves


def build_pyramid(base: jnp.ndarray, sigma: float, n_layers: int,
                  n_octaves: int) -> List[jnp.ndarray]:
    """Gaussian pyramid of ONE image: list over octaves of (L, H_o, W_o)."""
    return [o[0] for o in build_pyramid_batch(base[None], sigma, n_layers,
                                              n_octaves)]


# ---------------------------------------------------------------------------
# Extrema detection + refinement (per octave)
# ---------------------------------------------------------------------------

def _dense_refine(dog: jnp.ndarray, n_layers: int, contrast_thresh: float,
                  edge_thresh: float):
    """DENSE sub-pixel refinement of the whole DoG stack (OpenCV
    adjustLocalExtrema math on a 0..255 scale).

    Fixed-shape restructuring: instead of per-candidate neighborhood
    gathers (which this backend lowers to per-candidate broadcasts of the
    whole pyramid — 34 GB for 1024 candidates), every derivative, the
    3x3 closed-form solve, the contrast and the edge test are computed as
    elementwise stencil maps over (L, H, W). Candidates
    whose quadratic-fit offset exceeds 0.5 would move to a neighboring
    pixel in OpenCV's loop; here they are rejected, and the neighboring
    pixel's own fit (computed anyway, densely) takes over — the accepted
    keypoint set is the fixed point of OpenCV's movement iteration.

    Returns (ok, x_off, y_off, l_off, response) maps, all (L, H, W).
    """
    L, H, W = dog.shape
    img_scale = 1.0 / 255.0
    deriv_s = img_scale * 0.5
    second_s = img_scale
    cross_s = img_scale * 0.25

    # All 26 stencil taps slice ONE zero-padded copy of the stack instead
    # of taking jnp.roll views: roll lowers to concatenate copies whose
    # vmapped layouts XLA sometimes tiles batch-minor (observed 12x pad
    # expansion -> 32 GB compile-time HBM for a 14-image batch); slices
    # of a single padded buffer fuse. Border semantics differ (zero vs
    # wrap) only at positions the `interior` mask below rejects anyway
    # (layers 1..n_layers, >= _IMG_BORDER px from every image edge).
    d = dog
    dp = jnp.pad(d, 1)

    def sh(_, dl=0, dy=0, dx=0):
        return jax.lax.slice(dp, (1 + dl, 1 + dy, 1 + dx),
                             (1 + dl + L, 1 + dy + H, 1 + dx + W))
    dDx = (sh(d, 0, 0, 1) - sh(d, 0, 0, -1)) * deriv_s
    dDy = (sh(d, 0, 1, 0) - sh(d, 0, -1, 0)) * deriv_s
    dDs = (sh(d, 1, 0, 0) - sh(d, -1, 0, 0)) * deriv_s
    dxx = (sh(d, 0, 0, 1) + sh(d, 0, 0, -1) - 2 * d) * second_s
    dyy = (sh(d, 0, 1, 0) + sh(d, 0, -1, 0) - 2 * d) * second_s
    dss = (sh(d, 1, 0, 0) + sh(d, -1, 0, 0) - 2 * d) * second_s
    dxy = (sh(d, 0, 1, 1) - sh(d, 0, 1, -1)
           - sh(d, 0, -1, 1) + sh(d, 0, -1, -1)) * cross_s
    dxs = (sh(d, 1, 0, 1) - sh(d, 1, 0, -1)
           - sh(d, -1, 0, 1) + sh(d, -1, 0, -1)) * cross_s
    dys = (sh(d, 1, 1, 0) - sh(d, 1, -1, 0)
           - sh(d, -1, 1, 0) + sh(d, -1, -1, 0)) * cross_s

    # closed-form 3x3 solve X = -H^-1 dD via cofactors (elementwise)
    c00 = dyy * dss - dys * dys
    c01 = dxs * dys - dxy * dss
    c02 = dxy * dys - dxs * dyy
    c11 = dxx * dss - dxs * dxs
    c12 = dxy * dxs - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    det = dxx * c00 + dxy * c01 + dxs * c02
    safe = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    x_off = -(c00 * dDx + c01 * dDy + c02 * dDs) / safe
    y_off = -(c01 * dDx + c11 * dDy + c12 * dDs) / safe
    l_off = -(c02 * dDx + c12 * dDy + c22 * dDs) / safe
    bad_det = jnp.abs(det) < 1e-20
    x_off = jnp.where(bad_det, 0.0, x_off)
    y_off = jnp.where(bad_det, 0.0, y_off)
    l_off = jnp.where(bad_det, 0.0, l_off)

    converged = ((jnp.abs(x_off) < 0.5) & (jnp.abs(y_off) < 0.5)
                 & (jnp.abs(l_off) < 0.5)) & (~bad_det)

    contr = d * img_scale + 0.5 * (dDx * x_off + dDy * y_off + dDs * l_off)
    contrast_ok = jnp.abs(contr) * n_layers >= contrast_thresh

    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) * (r + 1) * det2)

    # interior-only (stencil wraps at borders; border is masked anyway)
    ll = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 0)
    yy = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 2)
    interior = ((ll >= 1) & (ll <= n_layers)
                & (yy >= _IMG_BORDER) & (yy < H - _IMG_BORDER)
                & (xx >= _IMG_BORDER) & (xx < W - _IMG_BORDER))

    ok = converged & contrast_ok & edge_ok & interior
    return ok, x_off, y_off, l_off, jnp.abs(contr), interior


# ---------------------------------------------------------------------------
# Canonical-grid sampling helpers
# ---------------------------------------------------------------------------

def grad_stack(level_imgs: jnp.ndarray) -> jnp.ndarray:
    """Dense central-difference gradients of a (..., H, W) level stack:
    returns (..., H, W, 4) = (dx, dy, dx@y+1, dy@y+1) in bf16 — each
    pixel's gradient packed together with the gradient of the pixel one
    row BELOW it (the vertical-pair trick).

    dy follows OpenCV's upward-positive convention I(y-1) - I(y+1).
    Precomputing gradients densely (cheap shifted subtractions) lets the
    per-keypoint pass bilinearly sample dx/dy directly; packing the
    vertical pair halves the gather count again — one row gather yields
    BOTH bilinear corners of a column (the per-keypoint sampling issues
    ~13 M tiny row gathers per 6-image chunk, so fewer rows means fewer
    gathers). bf16 halves gather bytes; the descriptor normalizes away
    the precision loss."""
    z = jnp.zeros_like(level_imgs[..., :, :1])
    dx = jnp.concatenate([z, level_imgs[..., :, 2:] - level_imgs[..., :, :-2],
                          z], axis=-1)
    zr = jnp.zeros_like(level_imgs[..., :1, :])
    dy = jnp.concatenate([zr, level_imgs[..., :-2, :]
                          - level_imgs[..., 2:, :], zr], axis=-2)
    g = jnp.stack([dx, dy], axis=-1)
    # row y+1's gradient, replicated on the last row (never sampled:
    # _grad_at clips y0 to H-2, so y0+1 <= H-1)
    g_dn = jnp.concatenate([g[..., 1:, :, :], g[..., -1:, :, :]], axis=-3)
    return jnp.concatenate([g, g_dn], axis=-1).astype(jnp.bfloat16)


def _grad_at(pyr, l: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray):
    """Bilinear sample of the dense gradient field: (gx, gy).

    ``pyr`` = (flat4 (T, 4) bf16 vertical-pair gradient buffer (see
    grad_stack), off, H, W) — off/H/W are (possibly traced) per-keypoint
    scalars selecting the octave. Flat row gathers are the only pyramid
    access pattern this backend lowers efficiently (multidim indexing or
    per-octave stacks broadcast the operand under vmap), and a single
    flat buffer lets ONE vmapped pass serve keypoints of every octave —
    no per-octave recompute. Each gathered row carries both vertical
    bilinear corners of one column, so a sample costs TWO row gathers
    (left column, right column) instead of four.
    """
    flat4, off, H, W = pyr
    x0 = jnp.clip(jnp.floor(xs), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(ys), 0, H - 2).astype(jnp.int32)
    fx = jnp.clip(xs - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(ys - y0, 0.0, 1.0)[..., None]
    base = off + l * (H * W) + y0 * W + x0
    vl = flat4[base]          # (dx,dy)@(y0,x0)   + (dx,dy)@(y0+1,x0)
    vr = flat4[base + 1]      # (dx,dy)@(y0,x0+1) + (dx,dy)@(y0+1,x0+1)
    v00, v10 = vl[..., :2], vl[..., 2:]
    v01, v11 = vr[..., :2], vr[..., 2:]
    g = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
         + (v10 * (1 - fx) + v11 * fx) * fy).astype(jnp.float32)
    return g[..., 0], g[..., 1]


def _orientation(pyr, l: jnp.ndarray, y: jnp.ndarray,
                 x: jnp.ndarray, scl_octv: jnp.ndarray) -> jnp.ndarray:
    """Dominant gradient orientation (degrees, [0, 360)).

    Fixed _ORI_GRID^2 canonical samples over radius 4.5*sigma replace
    OpenCV's variable-radius pixel loop (calcOrientationHist).
    """
    G = _ORI_GRID
    lin = np.linspace(-1.0, 1.0, G, dtype=np.float32)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    offs = jnp.asarray(np.stack([gy.ravel(), gx.ravel()], 1))  # (G*G, 2)
    radius = _ORI_RADIUS * scl_octv
    ys = y + offs[:, 0] * radius
    xs = x + offs[:, 1] * radius
    dx, dy = _grad_at(pyr, l, ys, xs)
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.degrees(jnp.arctan2(dy, dx)) % 360.0
    # Gaussian weight with sigma = 1.5 * scl_octv over true distance
    d2 = (offs[:, 0] * radius) ** 2 + (offs[:, 1] * radius) ** 2
    w = jnp.exp(-d2 / (2.0 * (_ORI_SIG_FCTR * scl_octv) ** 2))
    wmag = mag * w

    bins = ang * (_ORI_HIST_BINS / 360.0)
    b0 = jnp.floor(bins)
    fb = bins - b0
    b0 = b0.astype(jnp.int32) % _ORI_HIST_BINS
    b1 = (b0 + 1) % _ORI_HIST_BINS
    oh0 = jax.nn.one_hot(b0, _ORI_HIST_BINS) * ((1 - fb) * wmag)[:, None]
    oh1 = jax.nn.one_hot(b1, _ORI_HIST_BINS) * (fb * wmag)[:, None]
    hist = jnp.sum(oh0 + oh1, axis=0)
    # circular smooth [1,4,6,4,1]/16, applied like OpenCV
    h = hist
    hm1, hp1 = jnp.roll(h, 1), jnp.roll(h, -1)
    hm2, hp2 = jnp.roll(h, 2), jnp.roll(h, -2)
    hist = (6 * h + 4 * (hm1 + hp1) + (hm2 + hp2)) / 16.0

    k = jnp.argmax(hist)
    hk = hist[k]
    hl = hist[(k - 1) % _ORI_HIST_BINS]
    hr = hist[(k + 1) % _ORI_HIST_BINS]
    denom = hl - 2 * hk + hr
    interp = jnp.where(jnp.abs(denom) > 1e-12,
                       0.5 * (hl - hr) / denom, 0.0)
    bin_f = (k + interp) % _ORI_HIST_BINS
    return 360.0 - bin_f * (360.0 / _ORI_HIST_BINS)  # OpenCV convention


def _descr_spatial_weights() -> np.ndarray:
    """Static (_DESCR_GRID^2, d*d) trilinear spatial weights of the
    canonical descriptor grid, plus the Gaussian window baked in."""
    d = _DESCR_WIDTH
    S = _DESCR_GRID
    # sample centers in cell units, covering [-d/2, d/2]
    lin = (np.arange(S, dtype=np.float64) + 0.5) / S * d - d / 2.0
    rr, cc = np.meshgrid(lin, lin, indexing="ij")
    # histogram coords: rbin/cbin in [-0.5, d-0.5] like OpenCV
    rbin = rr.ravel() + d / 2.0 - 0.5
    cbin = cc.ravel() + d / 2.0 - 0.5
    gw = np.exp(-(rr.ravel() ** 2 + cc.ravel() ** 2) / (0.5 * d * d))
    Wmat = np.zeros((S * S, d * d), np.float32)
    r0 = np.floor(rbin).astype(int)
    c0 = np.floor(cbin).astype(int)
    fr = rbin - r0
    fc = cbin - c0
    for dr in (0, 1):
        for dc in (0, 1):
            r = r0 + dr
            c = c0 + dc
            wgt = (fr if dr else 1 - fr) * (fc if dc else 1 - fc) * gw
            okm = (r >= 0) & (r < d) & (c >= 0) & (c < d)
            idx = np.clip(r, 0, d - 1) * d + np.clip(c, 0, d - 1)
            for s in range(S * S):
                if okm[s]:
                    Wmat[s, idx[s]] += wgt[s]
    return Wmat


_DESCR_W = _descr_spatial_weights()  # module-level static


def _descriptor(pyr, l: jnp.ndarray, y: jnp.ndarray,
                x: jnp.ndarray, scl_octv: jnp.ndarray,
                angle_deg: jnp.ndarray) -> jnp.ndarray:
    """128-D SIFT descriptor via canonical-grid resampling + einsum binning."""
    d, n, S = _DESCR_WIDTH, _DESCR_HIST_BINS, _DESCR_GRID
    hist_width = _DESCR_SCL_FCTR * scl_octv
    ori = 360.0 - angle_deg                  # OpenCV: ori = 360 - kpt.angle
    theta = jnp.deg2rad(ori)
    ct, st = jnp.cos(theta), jnp.sin(theta)

    lin = (np.arange(S, dtype=np.float32) + 0.5) / S * d - d / 2.0
    rr, cc = np.meshgrid(lin, lin, indexing="ij")
    rr = jnp.asarray(rr.ravel())
    cc = jnp.asarray(cc.ravel())
    # inverse of OpenCV's (c_rot = j cos - i sin, r_rot = j sin + i cos):
    # image offsets from descriptor-frame coords
    xs = x + (cc * ct + rr * st) * hist_width
    ys = y + (-cc * st + rr * ct) * hist_width

    dx, dy = _grad_at(pyr, l, ys, xs)
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.degrees(jnp.arctan2(dy, dx)) % 360.0
    rel = (ang - ori) * (n / 360.0)

    ob = rel % n
    o0 = jnp.floor(ob)
    fo = ob - o0
    o0 = o0.astype(jnp.int32) % n
    o1 = (o0 + 1) % n
    O = (jax.nn.one_hot(o0, n) * (1 - fo)[:, None]
         + jax.nn.one_hot(o1, n) * fo[:, None])          # (S*S, n)

    Wmat = jnp.asarray(_DESCR_W)                          # (S*S, d*d)
    hist = jnp.einsum("sc,s,sn->cn", Wmat, mag, O,
                      preferred_element_type=jnp.float32)  # (d*d, n)
    vec = hist.reshape(-1)
    # normalize, clip at 0.2, renormalize (calcSIFTDescriptor)
    nrm = jnp.linalg.norm(vec)
    vec = jnp.minimum(vec, _DESCR_MAG_THR * jnp.maximum(nrm, 1e-12))
    nrm2 = jnp.linalg.norm(vec)
    return vec / jnp.maximum(nrm2, 1e-12)


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------

def _num_octaves(h: int, w: int) -> int:
    """Octave count for the doubled base image; smallest level >= 16 px."""
    return max(1, int(math.floor(math.log2(min(h, w) / 16.0))) + 1)


@functools.partial(
    jax.jit,
    static_argnames=("max_kp", "n_layers", "contrast_thresh",
                     "edge_thresh", "sigma", "upscale"))
def extract_sift(img_gray: jnp.ndarray,
                 valid_hw: jnp.ndarray,
                 max_kp: int = 1024,
                 n_layers: int = 4,
                 contrast_thresh: float = 0.03,
                 edge_thresh: float = 6.0,
                 sigma: float = 1.4142,
                 upscale: bool = True) -> SiftFeatures:
    """Detect + describe SIFT features of one grayscale image.

    img_gray: (H, W) float32, 0..255 scale; content may occupy only the
      top-left ``valid_hw = (h, w)`` region (replicate-padded outside).
    Returns fixed-capacity ``SiftFeatures`` with original-image pixel
    coordinates (not yet center-shifted).
    """
    H, W = img_gray.shape
    if upscale:
        base = jax.image.resize(img_gray, (H * 2, W * 2), "linear")
        sig_diff = math.sqrt(max(sigma * sigma - 4 * 0.25, 0.01))
        first_octave = -1
    else:
        base = img_gray
        sig_diff = math.sqrt(max(sigma * sigma - 0.25, 0.01))
        first_octave = 0
    base = _blur(base, sig_diff)
    n_oct = _num_octaves(*base.shape)

    gauss = build_pyramid(base, sigma, n_layers, n_oct)
    return _sift_from_pyramid(tuple(gauss), valid_hw, max_kp, n_layers,
                              contrast_thresh, edge_thresh, sigma,
                              first_octave)


def _sift_from_pyramid(gauss, valid_hw, max_kp: int, n_layers: int,
                       contrast_thresh: float, edge_thresh: float,
                       sigma: float, first_octave: int) -> SiftFeatures:
    """Detector+descriptor over a prebuilt single-image Gaussian pyramid
    (tuple over octaves of (L, H_o, W_o)). Shared by the single-image
    entry point and the batched one (which builds the pyramid with
    batched convs and vmaps this core)."""
    n_oct = len(gauss)
    dogs = [g[1:] - g[:-1] for g in gauss]

    prethresh = 0.5 * contrast_thresh / n_layers * 255.0
    budget = max_kp  # per-octave candidate budget

    all_resp, all_xy, all_size, all_valid = [], [], [], []
    all_oct, all_layer, all_ypix, all_xpix = [], [], [], []
    vh = valid_hw[0].astype(jnp.float32)
    vw = valid_hw[1].astype(jnp.float32)

    for o in range(n_oct):
        dog = dogs[o]
        L, Ho, Wo = dog.shape
        ext = jax.lax.reduce_window(
            dog, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1), "SAME")
        mn = jax.lax.reduce_window(
            dog, jnp.inf, jax.lax.min, (3, 3, 3), (1, 1, 1), "SAME")
        is_ext = ((dog >= ext) & (dog > prethresh)) \
            | ((dog <= mn) & (dog < -prethresh))

        (ok_map, xo_map, yo_map, lo_map, resp_map,
         interior_map) = _dense_refine(dog, n_layers, contrast_thresh,
                                       edge_thresh)
        # candidate pool: top-k extremum pixels by raw |DoG| response;
        # refinement values come from the dense maps via flat gathers
        # (never a vmapped pyramid access — see _dense_refine docstring).
        # top_k over the full octave lowers to a ~9M-element sort (0.16 s
        # of a 0.48 s extraction); instead the score is INT-ENCODED with
        # its 2x2-block offset in the low bits, block-maxed with a
        # strided reduce_window, and the top-k sorts 4x fewer elements.
        # At most one candidate survives per (layer, 2x2 block), which is
        # lossless up to ties: two pixels of the SAME layer inside a 2x2
        # block are 4/8-adjacent, and adjacent pixels cannot both be
        # strict 3x3x3 extrema. (4x4 blocks measurably perturbed the
        # keypoint set — the map focal-from-H seed moved 30%.)
        score_map = jnp.where(is_ext & interior_map, jnp.abs(dog), 0.0)
        q = jnp.minimum(score_map * 131072.0, 2.0 ** 28 - 1)
        yy_o = jax.lax.broadcasted_iota(jnp.int32, score_map.shape, 1)
        xx_o = jax.lax.broadcasted_iota(jnp.int32, score_map.shape, 2)
        off2 = ((yy_o % 2) << 1) | (xx_o % 2)
        enc = jnp.where(q > 0, (q.astype(jnp.int32) << 2) | off2, 0)
        pooled = jax.lax.reduce_window(
            enc, 0, jax.lax.max, (1, 2, 2), (1, 2, 2), "SAME")
        Hb2, Wb2 = pooled.shape[1], pooled.shape[2]
        pf = pooled.reshape(-1)
        k = min(budget, pf.shape[0])
        enc_k, pidx = jax.lax.top_k(pf, k)
        pad = budget - k
        if pad > 0:
            pidx = jnp.pad(pidx, (0, pad))
            enc_k = jnp.pad(enc_k, (0, pad))
        cand = enc_k > 0
        l_i = pidx // (Hb2 * Wb2)
        rem = pidx % (Hb2 * Wb2)
        y_i = (rem // Wb2) * 2 + ((enc_k >> 1) & 1)
        x_i = (rem % Wb2) * 2 + (enc_k & 1)

        xo_f = xo_map.reshape(-1)
        yo_f = yo_map.reshape(-1)
        lo_f = lo_map.reshape(-1)
        ok_f = ok_map.reshape(-1)
        resp_f = resp_map.reshape(-1)
        int_f = interior_map.reshape(-1)

        # OpenCV's movement iteration (adjustLocalExtrema): step to the
        # neighboring pixel/layer when the quadratic fit lands outside
        # +-0.5, re-reading the dense fit at the new location
        done = jnp.zeros_like(cand)
        for _ in range(_MAX_INTERP_STEPS):
            lin = l_i * (Ho * Wo) + y_i * Wo + x_i
            xo = xo_f[lin]
            yo = yo_f[lin]
            lo = lo_f[lin]
            conv = (jnp.abs(xo) < 0.5) & (jnp.abs(yo) < 0.5) \
                & (jnp.abs(lo) < 0.5)
            step_ok = int_f[lin] & (~done)
            move = step_ok & (~conv)
            l_i = jnp.where(move, jnp.clip(
                l_i + jnp.round(lo).astype(jnp.int32), 0, L - 1), l_i)
            y_i = jnp.where(move, jnp.clip(
                y_i + jnp.round(yo).astype(jnp.int32), 0, Ho - 1), y_i)
            x_i = jnp.where(move, jnp.clip(
                x_i + jnp.round(xo).astype(jnp.int32), 0, Wo - 1), x_i)
            done = done | conv | (~int_f[lin])

        lin = l_i * (Ho * Wo) + y_i * Wo + x_i
        ok = cand & ok_f[lin]
        l_f = l_i.astype(jnp.float32) + lo_f[lin]
        y_f = y_i.astype(jnp.float32) + yo_f[lin]
        x_f = x_i.astype(jnp.float32) + xo_f[lin]
        resp = resp_f[lin]
        scale_mult = 2.0 ** (o + first_octave)
        x_img = x_f * scale_mult
        y_img = y_f * scale_mult
        size = sigma * (2.0 ** (l_f / n_layers)) * scale_mult * 2.0
        # inside the valid region (pad area breeds replicate-border extrema)
        m = 2.0  # px margin in original coords
        ok = ok & (x_img >= m) & (x_img <= vw - 1 - m) \
               & (y_img >= m) & (y_img <= vh - 1 - m)

        all_resp.append(jnp.where(ok, resp, -1.0))
        all_xy.append(jnp.stack([x_img, y_img], -1))
        all_size.append(size)
        all_valid.append(ok)
        all_oct.append(jnp.full((budget,), o, jnp.int32))
        all_layer.append(jnp.clip(jnp.round(l_f), 1, n_layers).astype(jnp.int32))
        all_ypix.append(y_f)
        all_xpix.append(x_f)

    resp = jnp.concatenate(all_resp)
    top_resp, top_i = jax.lax.top_k(resp, max_kp)
    sel_xy = jnp.concatenate(all_xy)[top_i]
    sel_size = jnp.concatenate(all_size)[top_i]
    sel_valid = jnp.concatenate(all_valid)[top_i] & (top_resp > 0)
    sel_oct = jnp.concatenate(all_oct)[top_i]
    sel_layer = jnp.concatenate(all_layer)[top_i]
    sel_y = jnp.concatenate(all_ypix)[top_i]
    sel_x = jnp.concatenate(all_xpix)[top_i]

    # orientation + descriptor: ONE vmapped pass over all keypoints,
    # sampling dense bf16 gradients from the flat concatenated pyramid
    # (no per-octave loop; see grad_stack for the gather-count math)
    flat_pyr = jnp.concatenate(
        [grad_stack(g).reshape(-1, 4) for g in gauss])
    sizes_o = np.array([int(np.prod(g.shape)) for g in gauss])
    offs_o = np.concatenate([[0], np.cumsum(sizes_o)[:-1]]).astype(np.int32)
    Hs_o = np.array([g.shape[1] for g in gauss], np.int32)
    Ws_o = np.array([g.shape[2] for g in gauss], np.int32)
    kp_off = jnp.asarray(offs_o)[sel_oct]
    kp_H = jnp.asarray(Hs_o)[sel_oct]
    kp_W = jnp.asarray(Ws_o)[sel_oct]
    scl_octv = sel_size * 0.5 / (2.0 ** (sel_oct.astype(jnp.float32)
                                         + first_octave))

    def per_kp(layer, y, x, so, off, Ho, Wo):
        pyr = (flat_pyr, off, Ho, Wo)
        a = _orientation(pyr, layer, y, x, so)
        dvec = _descriptor(pyr, layer, y, x, so, a)
        return a, dvec

    angle, desc = jax.vmap(per_kp)(sel_layer, sel_y, sel_x, scl_octv,
                                   kp_off, kp_H, kp_W)

    # rootSIFT: L1-normalize + sqrt (convert_to_rootsift)
    l1 = jnp.sum(jnp.abs(desc), axis=1, keepdims=True)
    desc = jnp.sqrt(desc / jnp.maximum(l1, 1e-12))
    desc = jnp.where(sel_valid[:, None], desc, 0.0)

    return SiftFeatures(
        xy=jnp.where(sel_valid[:, None], sel_xy, 0.0),
        size=jnp.where(sel_valid, sel_size, 0.0),
        response=jnp.where(sel_valid, top_resp, 0.0),
        desc=desc,
        valid=sel_valid,
    )


@functools.partial(
    jax.jit,
    static_argnames=("max_kp", "n_layers", "contrast_thresh",
                     "edge_thresh", "sigma", "upscale"))
def extract_sift_batch(imgs_u8: jnp.ndarray,
                       valid_hw: jnp.ndarray,
                       max_kp: int = 1024,
                       n_layers: int = 4,
                       contrast_thresh: float = 0.03,
                       edge_thresh: float = 6.0,
                       sigma: float = 1.4142,
                       upscale: bool = True) -> SiftFeatures:
    """Whole-image-set SIFT in ONE dispatch.

    imgs_u8: (N, H, W, 3) uint8 BGR (edge-padded to the common shape);
    valid_hw: (N, 2) int32. Grayscale conversion happens on-device (4x
    less host->device traffic than f32 gray). The Gaussian pyramid — the
    dominant cost — is built for the WHOLE batch with two large convs per
    octave (_blur_multi); the per-image detector/descriptor core is then
    vmapped over the batch. This is the device replacement for the
    reference's one-async-task-per-image fan-out (_image.cpp:125-149).
    """
    N, H, W, _ = imgs_u8.shape
    b = imgs_u8[..., 0].astype(jnp.float32)
    g = imgs_u8[..., 1].astype(jnp.float32)
    r = imgs_u8[..., 2].astype(jnp.float32)
    gray = 0.114 * b + 0.587 * g + 0.299 * r      # (N, H, W)

    if upscale:
        base = jax.image.resize(gray, (N, H * 2, W * 2), "linear")
        sig_diff = math.sqrt(max(sigma * sigma - 4 * 0.25, 0.01))
        first_octave = -1
    else:
        base = gray
        sig_diff = math.sqrt(max(sigma * sigma - 0.25, 0.01))
        first_octave = 0
    base = _blur_multi(base, [sig_diff])[:, 0]
    n_oct = _num_octaves(base.shape[1], base.shape[2])

    gauss = build_pyramid_batch(base, sigma, n_layers, n_oct)

    core = functools.partial(
        _sift_from_pyramid, max_kp=max_kp, n_layers=n_layers,
        contrast_thresh=contrast_thresh, edge_thresh=edge_thresh,
        sigma=sigma, first_octave=first_octave)
    return jax.vmap(lambda pyr, hw: core(pyr, hw))(tuple(gauss), valid_hw)
