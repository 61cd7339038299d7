"""Pairwise match verification -> scene adjacency.

Reproduces the behavior of ``util::adj_calculator``
(the reference's src/math/_homography.cpp:503-697,814-917) with a batched
execution model: instead of a thread pool over (i, j) pairs, pairs are
packed into fixed-size device batches and every stage (2-NN matching,
RANSAC, overlap verification) is one vmapped XLA program.

Pipeline (reference call order, _panorama.cpp:385-436):
  pass 1  raw ratio-test match counts for all upper-tri pairs
          (get_match_number_matrix, :663-697)
  filter  keep top ``max_images_per_match`` candidates per row
          (heuristic_match_filter, :837-878)
  pass 2  per surviving pair: RANSAC homography, inlier count, both-direction
          overlap acceptance tests, cleaned top-``max_keypoints`` matches
          (cal_adj -> match_quality, :503-660; clean_matches, :881-917)

Adjacency weight of an accepted pair = overlap percentage (:658).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.config import Config
from simplepanorama_tpu.features import Features
from simplepanorama_tpu.ops.matching import match_pair_batch, gather_match_coords
from simplepanorama_tpu.ops.homography import (
    ransac_homography, apply_h, inlier_distances)
from simplepanorama_tpu.ops.polygon import overlap_stats

_MIN_RAW_MATCHES = 30  # match_quality requires >= 30 raw matches (:523)


@dataclasses.dataclass
class Adjacency:
    """Scene graph produced by pairwise verification."""
    adj: np.ndarray        # (N, N) upper-tri weights (overlap %), 0 = rejected
    raw_counts: np.ndarray  # (N, N) pass-1 ratio-test match counts
    hom_mat: np.ndarray    # (N, N, 3, 3); [i, j] maps image-j pts -> image-i
    # cleaned matches per accepted ordered pair: (i, j) -> (xy_i, xy_j)
    # arrays of shape (M, 2) in center-origin coords, M <= max_keypoints
    matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)


def _verify_core(q, t, match_valid, xy_q, xy_t, valid_q, valid_t,
                 hw_q, hw_t, keys, n_raw,
                 n_iter: int, keep_cap: int,
                 margin, min_overlap, overlap_inl_match,
                 overlap_inl_keyp, conf):
    """RANSAC + overlap acceptance for a batch of pairs whose 2-NN match
    coordinates are already gathered. Returns per-pair acceptance,
    weight, H, and cleaned match coordinates (fixed capacity keep_cap)."""

    def one(q1, t1, mv, hw1, hw2, xy1, v1, xy2, v2, key, nr):
        H, inl = ransac_homography(q1, t1, mv, hw1, hw2, key,
                                   n_iter=n_iter, margin=margin)
        H = H / H[2, 2]
        n_in = jnp.sum(inl)
        Hinv = jnp.linalg.inv(H)

        ov1, akp1, am1 = overlap_stats(H, hw1, hw2, xy1, v1, q1, mv)
        ov2, akp2, am2 = overlap_stats(Hinv, hw2, hw1, xy2, v2, t1, mv)

        f = lambda a, b: a.astype(jnp.float32) / b.astype(jnp.float32)
        oim1, oik1 = f(n_in, am1), f(n_in, akp1)
        oim2, oik2 = f(n_in, am2), f(n_in, akp2)

        accept = (
            (nr >= _MIN_RAW_MATCHES)
            & (oim1 <= 1.0) & (ov1 >= min_overlap)
            & (oim1 >= overlap_inl_match) & (oik1 >= overlap_inl_keyp)
            & (oim2 <= 1.0) & (ov2 >= min_overlap)
            & (oim2 >= overlap_inl_match) & (oik2 >= overlap_inl_keyp)
            # the reference averages the *second* direction with itself
            # (match_quality, _homography.cpp:619-621) — kept verbatim
            & ((oik2 + oik2) * 0.5 >= conf)
        )

        # clean_matches: inliers within margin ranked by reprojection dist,
        # top keep_cap (:881-917)
        d = inlier_distances(H, q1, t1, mv)
        dk, order = jax.lax.top_k(-d, keep_cap)
        keep_valid = jnp.isfinite(-dk) & ((-dk) <= margin) & accept
        kq = q1[order]
        kt = t1[order]
        weight = jnp.where(accept, ov1, 0.0)
        return accept, weight, H, kq, kt, keep_valid

    return jax.vmap(one)(q, t, match_valid, hw_q, hw_t,
                         xy_q, valid_q, xy_t, valid_t, keys, n_raw)


@functools.partial(jax.jit, static_argnames=(
    "n_iter", "match_cap", "keep_cap"))
def _verify_pairs(desc_q, desc_t, xy_q, xy_t, valid_q, valid_t,
                  hw_q, hw_t, keys,
                  n_iter: int, match_cap: int, keep_cap: int,
                  margin, min_overlap, overlap_inl_match,
                  overlap_inl_keyp, conf):
    """Verify a batch of B image pairs from raw descriptors (recomputes
    the 2-NN; the multi-process path, where pass-1 tables live on other
    hosts' shards)."""
    match_idx, match_valid, n_raw = match_pair_batch(
        desc_q, desc_t, valid_q, valid_t, match_cap)
    q, t = gather_match_coords(xy_q, xy_t, match_idx, match_valid)
    return _verify_core(q, t, match_valid, xy_q, xy_t, valid_q, valid_t,
                        hw_q, hw_t, keys, n_raw,
                        n_iter=n_iter, keep_cap=keep_cap, margin=margin,
                        min_overlap=min_overlap,
                        overlap_inl_match=overlap_inl_match,
                        overlap_inl_keyp=overlap_inl_keyp, conf=conf)


@functools.partial(jax.jit, static_argnames=("n_iter", "keep_cap"))
def _verify_pairs_cached(mi_tab, mv_tab, nm_tab, rows, xy, valid, hw,
                         qi, ti, keys,
                         n_iter: int, keep_cap: int,
                         margin, min_overlap, overlap_inl_match,
                         overlap_inl_keyp, conf):
    """Verify a batch of pairs REUSING the pass-1 2-NN tables
    (single-process path): the matmul family runs once per pair total —
    pass 2 is pure gathers + RANSAC + overlap tests, one dispatch."""
    match_idx = mi_tab[rows]
    match_valid = mv_tab[rows]
    n_raw = nm_tab[rows]
    q, t = gather_match_coords(xy[qi], xy[ti], match_idx, match_valid)
    return _verify_core(q, t, match_valid, xy[qi], xy[ti],
                        valid[qi], valid[ti], hw[qi], hw[ti], keys, n_raw,
                        n_iter=n_iter, keep_cap=keep_cap, margin=margin,
                        min_overlap=min_overlap,
                        overlap_inl_match=overlap_inl_match,
                        overlap_inl_keyp=overlap_inl_keyp, conf=conf)


@jax.jit
def _pair_keys(master, ids):
    """Per-PAIR RANSAC keys derived from the pair's linear index i*N+j —
    the key stream is a function of the pair identity alone, so chunking
    and host-sharding the work list cannot change any pair's RANSAC draw
    (multi-process runs bit-match single-process)."""
    return jax.vmap(lambda s: jax.random.fold_in(master, s))(ids)


@jax.jit
def _gather_count_args(desc, valid, qi, ti):
    """One dispatch for the pass-1 pair gathers instead of 4 eager
    ones."""
    return desc[qi], desc[ti], valid[qi], valid[ti]


@jax.jit
def _gather_verify_args(desc, xy, valid, hw, qi, ti):
    """One dispatch for the pass-2 pair gathers (8 eager gathers)."""
    return (desc[qi], desc[ti], xy[qi], xy[ti], valid[qi], valid[ti],
            hw[qi], hw[ti])


def _stack_features(feats: Sequence[Features]):
    """Stacked device tables; reuses the extraction program's outputs
    when available (features.FeatureSet) so descriptors don't round-trip
    the device link between the two stages."""
    batch = getattr(feats, "device_batch", None)
    if batch is not None:
        return batch
    xy = jnp.asarray(np.stack([np.asarray(f.xy) for f in feats]))
    desc = jnp.asarray(np.stack([np.asarray(f.desc) for f in feats]))
    valid = jnp.asarray(np.stack([np.asarray(f.valid) for f in feats]))
    return xy, desc, valid


def _host_pair_shard(pairs):
    """This process's contiguous shard of the pair work list, padded so
    every process dispatches the same shapes. Returns (my_pairs, per,
    n_proc) — per is the padded shard length."""
    import jax as _jax
    nproc = _jax.process_count()
    if nproc <= 1:
        return pairs, len(pairs), 1
    from simplepanorama_tpu.parallel.multihost import host_shard
    per = (len(pairs) + nproc - 1) // nproc
    mine = host_shard(pairs)
    while len(mine) < per:           # pad with a repeat (results ignored)
        mine.append(pairs[-1])
    return mine, per, nproc


def raw_match_counts(feats: Sequence[Features], cfg: Config,
                     chunk: int = 64,
                     progress: Optional[Callable[[float], None]] = None,
                     cancelled: Optional[Callable[[], bool]] = None,
                     keep_tables: bool = False):
    """Pass 1: ratio-test match counts for all upper-triangular pairs.

    With ``keep_tables`` (single-process only) the per-pair compacted
    match tables stay ON DEVICE and are returned as
    (match_idx, match_valid, n_raw) concatenated over chunks — pair k of
    the upper-tri order sits at row k — so pass 2 never recomputes the
    2-NN matmuls. Returns (counts, tables) in that
    case, plain counts otherwise.

    Multi-process: the pair list is host-sharded (the reference's
    std::thread pool over (i,j) pairs scaled across hosts, SURVEY §5) and
    the per-pair counts are all-gathered over DCN."""
    from simplepanorama_tpu.parallel.mesh import (pipeline_mesh,
                                                  pad_leading, shard_leading)
    n = len(feats)
    counts = np.zeros((n, n))
    all_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pairs, per, nproc = _host_pair_shard(all_pairs)
    want_tables = keep_tables
    if nproc > 1:        # pass-1 tables live on other hosts' shards
        keep_tables = False
    xy, desc, valid = _stack_features(feats)
    mesh = pipeline_mesh()
    if mesh is not None:
        chunk = pad_leading(chunk, mesh.size)
    total = max(1, len(pairs))
    tab_mi, tab_mv, tab_nm = [], [], []
    nm_chunks = []
    for s in range(0, len(pairs), chunk):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        blk = pairs[s:s + chunk]
        # pad the final block to the chunk size: one compiled shape, and
        # the pair axis stays divisible by the mesh
        blk_p = blk + [blk[-1]] * (chunk - len(blk))
        qi = jnp.asarray([p[0] for p in blk_p])
        ti = jnp.asarray([p[1] for p in blk_p])
        args = _gather_count_args(desc, valid, qi, ti)
        if mesh is not None:
            args = shard_leading(args, mesh)
        midx, mval, nm = match_pair_batch(*args,
                                          cfg.max_matches_per_pair)
        if keep_tables:
            tab_mi.append(midx)
            tab_mv.append(mval)
            tab_nm.append(nm)
        # defer the host fetch: dispatches pipeline across chunks and
        # the counts arrive in one drain at the end
        nm_chunks.append((blk, nm))
        if progress is not None:
            progress(len(blk) / total)
    for blk, nm in nm_chunks:
        nm = np.asarray(nm)
        for (i, j), c in zip(blk, nm):
            counts[i, j] = float(c)
    if keep_tables:
        cat = (lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs))
        tables = (cat(tab_mi), cat(tab_mv), cat(tab_nm))
    else:
        tables = None
    if nproc > 1:
        from jax.experimental import multihost_utils
        flat = np.array([counts[i, j] for (i, j) in pairs], np.float64)
        gathered = np.asarray(
            multihost_utils.process_allgather(flat)).reshape(-1)
        # contiguous shards of length ``per``: global pair k sits at
        # flattened position k (padding tails land beyond len(all_pairs))
        counts[:] = 0.0
        for k, (i, j) in enumerate(all_pairs):
            counts[i, j] = gathered[k]
    if want_tables:
        return counts, tables
    return counts


def heuristic_match_filter(counts: np.ndarray, n: int) -> np.ndarray:
    """Keep the top-n candidates per row of the upper triangle
    (heuristic_match_filter, _homography.cpp:837-878)."""
    size = counts.shape[0]
    if n <= 0 or size == 0:
        raise ValueError("Wrong parameter or empty matches")
    n = min(n, size)
    out = np.zeros_like(counts)
    for i in range(size):
        cand = [(counts[i, j], j) for j in range(i + 1, size)]
        cand.sort(key=lambda p: p[0], reverse=True)
        for v, j in cand[:n]:
            out[i, j] = v
    return out


def build_adjacency(feats: Sequence[Features],
                    sizes: Sequence[Tuple[int, int]],
                    cfg: Config,
                    seed: int = 0,
                    chunk: int = 32,
                    progress: Optional[Callable[[float], None]] = None,
                    cancelled: Optional[Callable[[], bool]] = None,
                    ) -> Adjacency:
    """Full two-pass adjacency computation (panorama::get_adj_par)."""
    n = len(feats)
    counts, tables = raw_match_counts(
        feats, cfg, chunk=64,
        progress=(lambda d: progress(d * 0.5)) if progress else None,
        cancelled=cancelled, keep_tables=True)
    filtered = heuristic_match_filter(counts, cfg.max_images_per_match)

    adj = np.zeros((n, n))
    hom = np.zeros((n, n, 3, 3))
    hom[:] = np.eye(3)
    result = Adjacency(adj=adj, raw_counts=counts, hom_mat=hom)

    # position of pair (i, j) in the pass-1 upper-tri order (= its row
    # in the retained device match tables)
    pair_pos = {(i, j): k for k, (i, j) in enumerate(
        (i, j) for i in range(n) for j in range(i + 1, n))}
    all_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if filtered[i, j] >= _MIN_RAW_MATCHES]
    if not all_pairs:
        return result

    from simplepanorama_tpu.parallel.mesh import (pipeline_mesh,
                                                  pad_leading, shard_leading)
    mesh = pipeline_mesh()
    if mesh is not None:
        chunk = pad_leading(chunk, mesh.size)

    # multi-process: contiguous pair shards per host, verified locally on
    # each host's mesh, results all-gathered over DCN; per-pair RANSAC
    # keys make the sharded result identical to single-process
    pairs, per, nproc = _host_pair_shard(all_pairs)

    xy, desc, valid = _stack_features(feats)
    hw = jnp.asarray(np.array(sizes, np.int32))  # (N, 2) as (h, w)
    master = jax.random.PRNGKey(seed)
    total = max(1, len(pairs))
    acc_l, w_l, H_l, kq_l, kt_l, kv_l = [], [], [], [], [], []
    out_chunks = []
    for s in range(0, len(pairs), chunk):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        blk = pairs[s:s + chunk]
        # pad the final block to the chunk size to keep one compiled shape
        pad = chunk - len(blk)
        blk_p = blk + [blk[-1]] * pad
        qi = jnp.asarray([p[0] for p in blk_p])
        ti = jnp.asarray([p[1] for p in blk_p])
        keys = _pair_keys(master,
                          jnp.asarray([p[0] * n + p[1] for p in blk_p]))
        common = dict(
            n_iter=cfg.RANSAC_iterations,
            keep_cap=cfg.max_keypoints,
            margin=float(cfg.x_margin),
            min_overlap=cfg.min_overlap,
            overlap_inl_match=cfg.overlap_inl_match,
            overlap_inl_keyp=cfg.overlap_inl_keyp,
            conf=cfg.conf)
        if tables is not None:
            # single-process: reuse the pass-1 match tables — pass 2 is
            # gathers + RANSAC + overlap, no second 2-NN matmul
            rows = jnp.asarray([pair_pos[p] for p in blk_p], jnp.int32)
            if mesh is not None:
                rows, qi, ti, keys = shard_leading((rows, qi, ti, keys),
                                                   mesh)
            accept, weight, H, kq, kt, kv = _verify_pairs_cached(
                *tables, rows, xy, valid, hw, qi, ti, keys, **common)
        else:
            # pair-batch data parallelism over the mesh (the reference's
            # std::thread pool over (i,j) pairs, _panorama.cpp:385-436)
            args = _gather_verify_args(desc, xy, valid, hw, qi, ti) \
                + (keys,)
            if mesh is not None:
                args = shard_leading(args, mesh)
            accept, weight, H, kq, kt, kv = _verify_pairs(
                *args, match_cap=cfg.max_matches_per_pair, **common)
        # defer the host fetch: a blocking device_get here would
        # serialize chunk k's transfer against chunk k+1's dispatch; instead
        # every chunk's compute is enqueued first and the results drain
        # in one pass below
        out_chunks.append((len(blk), (accept, weight, H, kq, kt, kv)))
        if progress is not None:
            progress(len(blk) / total * 0.5)

    for nb, devs in out_chunks:
        # ONE batched transfer for the six outputs instead of six eager
        # np.asarray fetches
        accept, weight, H, kq, kt, kv = jax.device_get(devs)
        acc_l.append(accept[:nb])
        w_l.append(weight[:nb])
        H_l.append(np.array(H)[:nb])
        kq_l.append(kq[:nb])
        kt_l.append(kt[:nb])
        kv_l.append(kv[:nb])

    accept = np.concatenate(acc_l)
    weight = np.concatenate(w_l)
    H = np.concatenate(H_l)
    kq = np.concatenate(kq_l)
    kt = np.concatenate(kt_l)
    kv = np.concatenate(kv_l)
    if nproc > 1:
        from jax.experimental import multihost_utils
        accept, weight, H, kq, kt, kv = (
            np.asarray(g).reshape((-1,) + g.shape[2:])[:len(all_pairs)]
            for g in multihost_utils.process_allgather(
                (accept, weight, H, kq, kt, kv)))

    for b, (i, j) in enumerate(all_pairs):
        if not accept[b]:
            continue
        adj[i, j] = weight[b]
        hom[i, j] = H[b]
        hom[j, i] = np.linalg.inv(H[b])
        m = kv[b]
        result.matches[(i, j)] = (kq[b][m], kt[b][m])
        result.matches[(j, i)] = (kt[b][m], kq[b][m])
    return result
