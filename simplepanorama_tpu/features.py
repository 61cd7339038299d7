"""Feature-extraction front end: batch images onto the device, run the
fixed-shape SIFT program, return center-origin keypoints + rootSIFT
descriptors.

Capability mirror of img::images::calculate_keypoints
(/root/reference/src/classes/_image.cpp:105-166) and util::extract_keypoints
(/root/reference/src/math/_homography.cpp:727-751): grayscale conversion,
SIFT with the config's parameters, rootSIFT transform, and keypoint
coordinates shifted to an image-center origin (integer half-size, matching
the reference's ``pt.x - img.cols / 2``).

The reference fans out one std::async task per image; here every image runs
through ONE compiled XLA program (all images are replicate-padded to a
common shape so a single jit cache entry serves the whole set), and the
batch dimension is the unit of data parallelism for multi-device sharding.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.config import Config
from simplepanorama_tpu.ops.sift import extract_sift, extract_sift_batch


# per-shape SIFT chunk size that survived compile (see _extract_arrays)
_SIFT_CHUNK_CACHE: dict = {}


@dataclasses.dataclass
class Features:
    """Per-image fixed-capacity features (host-side numpy views)."""
    xy: np.ndarray        # (K, 2) float32, center-origin (x, y)
    size: np.ndarray      # (K,)
    response: np.ndarray  # (K,)
    desc: np.ndarray      # (K, 128) rootSIFT
    valid: np.ndarray     # (K,) bool

    @property
    def count(self) -> int:
        return int(np.asarray(self.valid).sum())


class FeatureSet(list):
    """List of per-image Features, plus the stacked DEVICE tables the
    extraction program produced — the matching stage consumes those
    directly, so descriptors never round-trip through the host between
    the two stages."""
    device_batch = None   # (xy, desc, valid) jnp arrays, center-origin
    device_images = None  # (N', Hp, Wp, 3) uint8 device batch (padded);
    #                       row i = image i.  The warp stage gathers its
    #                       source pixels from this so they are uploaded
    #                       exactly once per stitch.


def _to_gray(img_bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 -> float32 grayscale on the 0..255 scale (OpenCV weights)."""
    b = img_bgr[..., 0].astype(np.float32)
    g = img_bgr[..., 1].astype(np.float32)
    r = img_bgr[..., 2].astype(np.float32)
    return 0.114 * b + 0.587 * g + 0.299 * r


def _pad_to(img: np.ndarray, H: int, W: int) -> np.ndarray:
    return np.pad(img, ((0, H - img.shape[0]), (0, W - img.shape[1])),
                  mode="edge")


def extract_features(images: Sequence[np.ndarray],
                     cfg: Config,
                     progress: Optional[Callable[[float], None]] = None,
                     cancelled: Optional[Callable[[], bool]] = None,
                     ) -> List[Features]:
    """Extract SIFT features for a list of BGR uint8 images.

    Every image is padded (edge-replicate) to the common max shape rounded
    to a multiple of 8, so one compiled program serves all of them.
    ``progress`` receives a per-image fraction delta; ``cancelled`` is
    polled between images (the reference polls its atomic between async
    tasks, _image.cpp:130).

    Multi-host: each process extracts only its contiguous shard of the
    image list and the per-image feature tables (tiny vs pixels) are
    all-gathered over DCN (SURVEY §5 workload split; the reference's
    per-image std::async fan-out scaled across hosts).
    """
    pending = images if hasattr(images, "futures") else None
    if pending is not None and (
            _needs_full_list(pending)
            or any(d is None for d in pending.dims)):
        images = pending.finalize()
        pending = None
    if pending is None and not images:
        return []
    if cancelled is not None and cancelled():
        raise RuntimeError("Process canceled")
    import jax as _jax
    if pending is not None:
        # streaming: SIFT chunks dispatch as soon as their images decode,
        # so host decode overlaps device compute
        arrays, device_images = _extract_arrays_stream(pending, cfg,
                                                       cancelled)
        images = pending.finalize()
        device_batch = (arrays[0], arrays[3], arrays[4])
    elif _jax.process_count() > 1:
        arrays = _extract_multihost(images, cfg)
        # re-upload the gathered tables once so matching keeps the
        # no-descriptor-round-trip device path (the DCN allgather already
        # moved them host-side; this single upload is unavoidable).
        # Pixels stay host-sharded: device_images would need an all-gather
        # of the full image batch over DCN, which the warp stage's
        # once-per-stitch upload undercuts.
        device_batch = (jnp.asarray(arrays[0]), jnp.asarray(arrays[3]),
                        jnp.asarray(arrays[4]))
        device_images = None
    else:
        arrays, device_images = _extract_arrays(images, cfg)
        device_batch = (arrays[0], arrays[3], arrays[4])  # xy, desc, valid
    out = FeatureSet(_to_features(images, arrays, progress))
    out.device_batch = device_batch
    out.device_images = device_images
    return out


def _needs_full_list(pending) -> bool:
    """Streaming extraction covers the single-process path (sharded or
    not is decided per-chunk below); multi-process extraction needs the
    materialized list for the host-shard split."""
    import jax as _jax
    from simplepanorama_tpu.parallel.mesh import pipeline_mesh
    return _jax.process_count() > 1 or pipeline_mesh() is not None


def _sift_mem_budget() -> int:
    """Bytes a SIFT chunk may use: ``SPT_SIFT_MEM_BUDGET`` when set, else
    half of what the device lets JAX allocate, or half of the host's
    physical memory on a device that reports no limit, such as the CPU."""
    env = os.environ.get("SPT_SIFT_MEM_BUDGET")
    if env:
        return int(env)
    import jax as _jax
    stats = _jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit") or (os.sysconf("SC_PAGE_SIZE")
                                         * os.sysconf("SC_PHYS_PAGES"))
    return int(limit) // 2


def _sift_chunk_size(nb: int, Hp: int, Wp: int, cfg: Config,
                     mesh=None) -> int:
    """Memory-budgeted SIFT chunk size (see _extract_arrays for the
    measured per-image footprint model and the compile-OOM self-tuning
    that can shrink it further)."""
    K = cfg.sift_max_features()
    per_img = Hp * Wp * (cfg.nOctaveLayers + 3) * 550
    budget = _sift_mem_budget()
    G = max(1, min(nb, 8, budget // max(1, per_img)))
    if mesh is not None:
        G = max(mesh.size, G // mesh.size * mesh.size)
    shape_key = (Hp, Wp, K, cfg.nOctaveLayers)
    return min(G, _SIFT_CHUNK_CACHE.get(shape_key, G))


def _extract_arrays_stream(pending, cfg: Config, cancelled=None):
    """Single-process streaming extraction: per-chunk host pad + upload +
    SIFT dispatch, consuming decoded images as their futures complete.
    The decode pool keeps working while earlier chunks run on device, so
    the pipeline pays max(decode, SIFT) instead of their sum."""
    K = cfg.sift_max_features()
    n = len(pending)
    Hm = max(d[0] for d in pending.dims)
    Wm = max(d[1] for d in pending.dims)
    Hp = (Hm + 7) // 8 * 8
    Wp = (Wm + 7) // 8 * 8
    G = _sift_chunk_size(n, Hp, Wp, cfg)
    if n >= 6:
        # >=3 chunks so the first dispatch starts after only G decodes
        G = min(G, (n + 2) // 3)
    shape_key = (Hp, Wp, K, cfg.nOctaveLayers)

    hw = np.ones((n, 2), np.int32) * 8
    for i, d in enumerate(pending.dims):
        hw[i] = d
    hw_d = jnp.asarray(hw)

    srcs: dict = {}          # chunk start -> device (G, Hp, Wp, 3) uint8

    def upload_chunk(s, G):
        if s in srcs and srcs[s].shape[0] == G:
            return srcs[s]
        ids = list(range(s, min(s + G, n)))
        blk = np.zeros((G, Hp, Wp, 3), np.uint8)
        for k, i in enumerate(ids):
            im = pending.get(i)
            blk[k] = np.pad(im, ((0, Hp - im.shape[0]),
                                 (0, Wp - im.shape[1]), (0, 0)),
                            mode="edge")
        srcs[s] = jnp.asarray(blk)
        return srcs[s]

    def dispatch_all(G):
        outs = []
        for s in range(0, n, G):
            if cancelled is not None and cancelled():
                raise RuntimeError("Process canceled")
            bb = upload_chunk(s, G)
            pad = G - min(G, n - s)
            hb = hw_d[s:s + G]
            if pad:
                hb = jnp.pad(hb, ((0, pad), (0, 0)), constant_values=8)
            outs.append(extract_sift_batch(
                bb, hb, max_kp=K, n_layers=cfg.nOctaveLayers,
                contrast_thresh=float(cfg.contrastThreshold),
                edge_thresh=float(cfg.edgeThreshold),
                sigma=float(cfg.sigma_sift)))
        return outs

    while True:
        try:
            outs = dispatch_all(G)
            break
        except Exception as e:  # jax runtime compile OOM
            if "Ran out of memory" not in str(e) or G <= 1:
                raise
            srcs.clear()
            G = max(1, G // 2)
    _SIFT_CHUNK_CACHE[shape_key] = G
    if len(outs) == 1:
        fb = outs[0]
    else:
        fb = jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)
    device_images = (srcs[0] if len(srcs) == 1 else
                     jnp.concatenate([srcs[s] for s in
                                      sorted(srcs)]))[:n]
    hw_full = jnp.pad(hw_d, ((0, fb.xy.shape[0] - n), (0, 0)),
                      constant_values=8) if fb.xy.shape[0] > n else hw_d
    return (_shift_and_trim(fb.xy, fb.size, fb.response, fb.desc,
                            fb.valid, hw_full, n), device_images)


def _extract_arrays(images: Sequence[np.ndarray], cfg: Config,
                    pad_shape=None):
    """One sharded SIFT dispatch over the (padded) image batch; returns
    host-side (xy, size, response, desc, valid) arrays for len(images)."""
    K = cfg.sift_max_features()
    if pad_shape is None:
        Hm = max(im.shape[0] for im in images)
        Wm = max(im.shape[1] for im in images)
    else:
        Hm, Wm = pad_shape
    Hp = (Hm + 7) // 8 * 8
    Wp = (Wm + 7) // 8 * 8

    n = len(images)
    # mesh-aware batch: pad the image axis to the mesh size so the ONE
    # compiled program shards data-parallel over devices (the device
    # equivalent of the reference's one-async-task-per-image fan-out,
    # _image.cpp:125-149 — SURVEY §2.7)
    from simplepanorama_tpu.parallel.mesh import (pipeline_mesh,
                                                  pad_leading,
                                                  shard_leading)
    mesh = pipeline_mesh()
    nb = pad_leading(n, mesh.size) if mesh is not None else n
    batch = np.zeros((nb, Hp, Wp, 3), np.uint8)
    hw = np.ones((nb, 2), np.int32) * 8   # padded slots: tiny valid area
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        batch[i] = np.pad(im, ((0, Hp - h), (0, Wp - w), (0, 0)),
                          mode="edge")
        hw[i] = (h, w)

    batch_d, hw_d = jnp.asarray(batch), jnp.asarray(hw)
    if mesh is not None:
        batch_d, hw_d = shard_leading((batch_d, hw_d), mesh)

    # SIFT holds a 2x-upsampled multi-level pyramid + gradient buffers per
    # image; a whole 12-image batch at init 700 exceeds a 16 GB chip
    # (measured: 16.22G HBM temps for 12x(704,528) — XLA materializes the
    # grouped-conv pyramid through 12x-padded transposed copies, so the
    # practical footprint is ~1.35 GB/image, far above the unpadded
    # estimate). Chunk the batch to a budget using the MEASURED per-image
    # factor — per-chunk shapes are identical, so it is still ONE
    # compiled program, dispatched ceil(n/G) times with no host sync.
    # cap 8 and self-tune downward: at some (batch, H, W) shapes XLA
    # assigns the batched pyramid temporaries a batch-minor layout whose
    # (8,128) tile padding explodes compile-time HBM ~10-20x past the
    # estimate (observed 32 GB for a 14-image batch of 400-px images, 22
    # GB for 8). Such a failure is a compile-time OOM, so it is caught
    # and the chunk halved; the working size is remembered per shape.
    G = _sift_chunk_size(nb, Hp, Wp, cfg, mesh)
    shape_key = (Hp, Wp, K, cfg.nOctaveLayers)

    def dispatch_all(G):
        outs = []
        for s in range(0, nb, G):
            blk = slice(s, s + G)
            pad = G - min(G, nb - s)
            bb, hb = batch_d[blk], hw_d[blk]
            if pad:  # trailing chunk: pad to the chunk shape (slots invalid)
                bb = jnp.pad(bb, ((0, pad),) + ((0, 0),) * 3)
                hb = jnp.pad(hb, ((0, pad), (0, 0)), constant_values=8)
            outs.append(extract_sift_batch(
                bb, hb,
                max_kp=K,
                n_layers=cfg.nOctaveLayers,
                contrast_thresh=float(cfg.contrastThreshold),
                edge_thresh=float(cfg.edgeThreshold),
                sigma=float(cfg.sigma_sift)))
        return outs

    while True:
        try:
            outs = dispatch_all(G)
            break
        except Exception as e:  # jax runtime compile OOM
            lo = mesh.size if mesh is not None else 1
            if "Ran out of memory" not in str(e) or G <= lo:
                raise
            G = max(lo, G // 2 // lo * lo if mesh is not None else G // 2)
    _SIFT_CHUNK_CACHE[shape_key] = G
    if len(outs) == 1:
        fb = outs[0]
    else:
        import jax as _jax
        fb = _jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)
    # center-origin shift ON DEVICE (integer halves — the reference's
    # ``pt.x - img.cols / 2`` convention), invalid slots zeroed, so the
    # returned tables are directly consumable by the matching stage.
    # Shift + the 5 trims run as ONE dispatch instead of six eager ops.
    hw_full = jnp.pad(hw_d, ((0, fb.xy.shape[0] - nb), (0, 0)),
                      constant_values=8) if fb.xy.shape[0] > nb else hw_d
    return _shift_and_trim(fb.xy, fb.size, fb.response, fb.desc,
                           fb.valid, hw_full, n), batch_d


@jax.jit
def _center_shift(xy, valid, hw):
    half = jnp.stack([hw[:, 1] // 2, hw[:, 0] // 2], -1).astype(jnp.float32)
    return jnp.where(valid[..., None], xy - half[:, None, :], 0.0)


@functools.partial(jax.jit, static_argnames=("n",))
def _shift_and_trim(xy, size, response, desc, valid, hw, n):
    xy = _center_shift(xy, valid, hw)
    return xy[:n], size[:n], response[:n], desc[:n], valid[:n]


def _extract_multihost(images: Sequence[np.ndarray], cfg: Config):
    """Per-host contiguous image shards + all-gather of the feature
    tables (parallel.multihost.host_shard over DCN)."""
    import jax as _jax
    from jax.experimental import multihost_utils
    from simplepanorama_tpu.parallel.multihost import host_shard
    n = len(images)
    nproc = _jax.process_count()
    per = (n + nproc - 1) // nproc
    idx = host_shard(list(range(n)))
    local = [images[i] for i in idx]
    # all hosts must dispatch identical shapes: common pad + shard padding
    Hm = max(im.shape[0] for im in images)
    Wm = max(im.shape[1] for im in images)
    while len(local) < per:
        local.append(np.zeros((8, 8, 3), np.uint8))
    arrays, _ = _extract_arrays(local, cfg, pad_shape=(Hm, Wm))
    gathered = multihost_utils.process_allgather(arrays)
    # (nproc, per, ...) -> contiguous order -> first n
    return tuple(np.asarray(g).reshape((-1,) + g.shape[2:])[:n]
                 for g in gathered)


class _LazyDescTable:
    """Defers the (N, K, 128) descriptor download until someone on the
    host actually reads it. The pipeline itself matches from the device
    tables (FeatureSet.device_batch), so in the common path the
    descriptors never cross the device link at all."""

    def __init__(self, dev):
        self._dev = dev
        self._host = None

    def get(self) -> np.ndarray:
        if self._host is None:
            self._host = np.asarray(self._dev)
            self._dev = None
        return self._host


class _LazyDesc:
    """numpy-compatible per-image view into a _LazyDescTable row."""

    def __init__(self, table: _LazyDescTable, i: int, shape):
        self._table = table
        self._i = i
        self.shape = shape
        self.dtype = np.dtype(np.float32)

    def __array__(self, dtype=None, copy=None):
        a = self._table.get()[self._i]
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, k):
        return self._table.get()[self._i][k]

    def __len__(self):
        return self.shape[0]


def _to_features(images, arrays,
                 progress: Optional[Callable[[float], None]] = None
                 ) -> List[Features]:
    """Host-side per-image views (coordinates already center-origin).
    One bulk transfer for the small tables the host actually reads;
    descriptors are wrapped lazily (the pipeline matches from the device
    tables in FeatureSet.device_batch and never reads them host-side)."""
    desc_all = arrays[3]
    xy_all, size_all, resp_all, valid_all = [
        np.asarray(a) for a in (arrays[0], arrays[1], arrays[2],
                                arrays[4])]
    n = len(images)
    if isinstance(desc_all, np.ndarray):
        desc_view = lambda i: desc_all[i]
    else:
        table = _LazyDescTable(desc_all)
        shp = tuple(desc_all.shape[1:])
        desc_view = lambda i: _LazyDesc(table, i, shp)
    out: List[Features] = []
    for i in range(n):
        out.append(Features(xy=xy_all[i], size=size_all[i],
                            response=resp_all[i], desc=desc_view(i),
                            valid=valid_all[i]))
        if progress is not None:
            progress(1.0 / n)
    return out
