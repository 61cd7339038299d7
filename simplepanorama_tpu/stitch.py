"""Incremental bundle-adjustment stitching driver.

Reproduces stch::bundleadjust_stitching (/root/reference/src/math/
_stitch.cpp:157-337): nodes are added in greedy strongest-edge order
(orderNodesByConnection, :8-82); each new camera inherits K from its
connection with the principal point zeroed (:248-251) and a rotation
initialized from the pairwise RANSAC homography via SVD orthogonalization
(approximate_rot = nearest rotation to K_new^-1 H K_conn, :134-154,
R_new = R_init . R_conn); after every addition a FULL LM bundle adjustment
runs over all cameras added so far (:268-295); finally the K principal
points are shifted by the integer image half-sizes (:303-307).

Shape discipline: cameras are renumbered into ADDITION ORDER and
matches sorted by activation step, so the live subproblem at any point of
the schedule is a PREFIX of the padded tables. The schedule is split into
~6 equal-work chunks, each compiled at a cropped capacity bucket (matches
rounded to 2048, cameras to 8) — early additions pay for the subproblem
they actually solve, the reference's growing prep_opt subproblem
(:85-131) re-expressed as a handful of static XLA shapes instead of a
fresh Eigen problem per node.

Deviation (reference bug not reproduced): the reference overwrites its
global homography table with the sub-problem-indexed ret_hmat result
(_stitch.cpp:283 'Hom_mat_new = teees.hom' — local indices into a global
table). We initialize each new camera from the pairwise RANSAC homography,
which is what the surviving entries of that table hold.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

import functools

import jax

from simplepanorama_tpu.config import Config
from simplepanorama_tpu.adjacency import Adjacency
from simplepanorama_tpu.geometry.graph import Component, order_nodes_by_connection
from simplepanorama_tpu.geometry import rotation as rotn
from simplepanorama_tpu import ba


@dataclasses.dataclass
class StitchResult:
    """Post-BA state (stch::stitch_result, _stitch.h:19-41), in
    component-local indexing plus the global-node map."""
    rot: np.ndarray            # (n, 3, 3)
    K: np.ndarray              # (n, 3, 3), centers shifted by half-size
    adj: np.ndarray            # (n, n) upper-tri weights
    connectivity: np.ndarray   # (n,)
    order: List[Tuple[int, int]]  # [(node, connected_to)] local indices
    nodes: List[int]           # local -> global image index
    center: int                # best-connected local node (maxLoc)
    sizes: List[Tuple[int, int]]  # (h, w) per local node


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_ba_data(comp: Component, adjres: Adjacency,
                  cap_round: int = 512, order: Optional[List[Tuple[int, int]]] = None,
                  relabel: Optional[np.ndarray] = None,
                  ) -> Tuple[ba.BAData, Optional[np.ndarray]]:
    """Flatten the component's directed cleaned matches into padded device
    tables.

    With ``order`` (the greedy addition schedule), matches are sorted by
    ACTIVATION STEP — the addition index at which both endpoint cameras
    are active — so the matches live at any point of the incremental
    schedule always form a contiguous prefix. Returns (data, prefix)
    where prefix[l] = number of matches active after addition l; prefix
    is None when no order is given.
    """
    nodes = comp.nodes
    g2l = {g: l for l, g in enumerate(nodes)}
    mi, mj, q, t, step = [], [], [], [], []
    add_idx = None
    if order is not None:
        add_idx = {node: l for l, (node, _) in enumerate(order)}
    for (gi, gj), (xy_i, xy_j) in adjres.matches.items():
        if gi in g2l and gj in g2l:
            li, lj = g2l[gi], g2l[gj]
            mi.extend([li] * len(xy_i))
            mj.extend([lj] * len(xy_i))
            q.append(xy_i)
            t.append(xy_j)
            if add_idx is not None:
                s = max(add_idx.get(li, len(order)),
                        add_idx.get(lj, len(order)))
                step.extend([s] * len(xy_i))
    M = len(mi)
    mi_np = np.asarray(mi, np.int32)
    mj_np = np.asarray(mj, np.int32)
    q_np = np.concatenate(q).astype(np.float32) if M else np.zeros((0, 2), np.float32)
    t_np = np.concatenate(t).astype(np.float32) if M else np.zeros((0, 2), np.float32)
    prefix = None
    if add_idx is not None and M:
        step_np = np.asarray(step, np.int64)
        srt = np.argsort(step_np, kind="stable")
        mi_np, mj_np = mi_np[srt], mj_np[srt]
        q_np, t_np = q_np[srt], t_np[srt]
        step_np = step_np[srt]
        prefix = np.searchsorted(step_np, np.arange(len(order)), side="right")
    if relabel is not None and M:
        # camera renumbering (addition order) applied to the endpoint ids
        mi_np = relabel[mi_np].astype(np.int32)
        mj_np = relabel[mj_np].astype(np.int32)
    cap = max(cap_round, _round_up(M, cap_round))
    mi_a = np.zeros(cap, np.int32)
    mj_a = np.zeros(cap, np.int32)
    q_a = np.zeros((cap, 2), np.float32)
    t_a = np.zeros((cap, 2), np.float32)
    valid = np.zeros(cap, bool)
    # realized-pair tables (ba.BAData.pi/pj/mp): H and dH/dcam chains run
    # once per realized pair (~3N) instead of per ordered pair (N^2)
    mp_a = np.zeros(cap, np.int32)
    if M:
        mi_a[:M] = mi_np
        mj_a[:M] = mj_np
        q_a[:M] = q_np
        t_a[:M] = t_np
        valid[:M] = True
        uniq, inv_rows = np.unique(np.stack([mi_np, mj_np], 1), axis=0,
                                   return_inverse=True)
        mp_a[:M] = inv_rows
    else:
        uniq = np.zeros((0, 2), np.int32)
    P = max(64, _round_up(len(uniq), 64))
    pi_a = np.zeros(P, np.int32)
    pj_a = np.zeros(P, np.int32)
    pi_a[:len(uniq)] = uniq[:, 0]
    pj_a[:len(uniq)] = uniq[:, 1]
    data = ba.BAData(mi=jnp.asarray(mi_a), mj=jnp.asarray(mj_a),
                     q=jnp.asarray(q_a), t=jnp.asarray(t_a),
                     m_valid=jnp.asarray(valid),
                     pi=jnp.asarray(pi_a), pj=jnp.asarray(pj_a),
                     mp=jnp.asarray(mp_a))
    return data, prefix


def _orthogonalize_np(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Vt[2] *= -1
    return U @ Vt


@functools.partial(jax.jit, static_argnames=("fast",))
def _incremental_lm(cams0: ba.CamState, active0, data: ba.BAData,
                    order_nodes, order_conns, H_pair, lambda0, lo, hi,
                    fast: bool, vaug=None):
    """Node-additions [lo, hi) of the incremental schedule as one XLA
    program (dynamic fori_loop bounds, so ONE compiled program serves
    every chunk of the schedule).

    The host driver (below) used to round-trip camera state to the host
    after every LM run only to re-feed it for the next addition, each
    trip a host sync. Here the
    greedy order is host-computed metadata (static arrays), and each
    fori_loop step activates one camera, initializes it from its connection
    on-device (inherit focal, zero principal point, SVD rotation init from
    the pairwise RANSAC homography — stch::bundleadjust_stitching,
    /root/reference/src/math/_stitch.cpp:238-296) and runs the full LM
    while_loop (ba.lm_run_impl) over the active set. The (cams, active)
    carry stays on device between chunk dispatches, so chunking costs one
    host sync per chunk and no data motion — which buys back the
    reference's per-node cancellation poll (_stitch.cpp:240) and honest
    per-chunk progress that the round-1 single-dispatch design lost.
    """

    def step(l, st):
        cams, active = st
        node = order_nodes[l]
        conn = order_conns[l]
        f = cams.focal[conn]
        Kc = ba._K_of(f, cams.ppal[conn])
        Kn_inv = jnp.diag(jnp.stack([1.0 / f, 1.0 / f,
                                     jnp.ones_like(f)]))
        M = rotn.mm(Kn_inv, H_pair[l], Kc)
        R_init = rotn.orthogonalize(M)
        R_conn = rotn.rodrigues(cams.rotvec[conn])
        rv_node = rotn.rotvec_from_matrix(rotn.mm(R_init, R_conn))
        cams = cams._replace(
            focal=cams.focal.at[node].set(f),
            ppal=cams.ppal.at[node].set(0.0),
            rotvec=cams.rotvec.at[node].set(rv_node))
        active = active.at[node].set(True)
        res = ba.lm_run_impl(cams, data, active, lambda0, fast=fast,
                             vaug_idx=None if vaug is None else vaug[l])
        return (res.cams, active)

    return jax.lax.fori_loop(lo, hi, step, (cams0, active0))


@functools.partial(jax.jit, static_argnames=("fast", "n_cap", "m_cap"))
def _incremental_lm_bucketed(cams0: ba.CamState, active0, data: ba.BAData,
                             order_conns, H_pair, vaug, lambda0, lo, hi,
                             fast: bool, n_cap: int, m_cap: int):
    """Node-additions [lo, hi) with compute cropped to the chunk's
    capacity bucket.

    The driver renumbers cameras into ADDITION ORDER (so the active set
    after addition l is exactly the prefix [0, l]) and sorts matches by
    activation step (so live matches form a prefix too, build_ba_data).
    Cropping the camera and match tables to (n_cap, m_cap) makes early
    additions pay for the subproblem they actually solve — the
    reference's growing prep_opt subproblem (/root/reference/src/math/
    _stitch.cpp:85-131) re-expressed as a handful of static bucket
    shapes — instead of every addition paying the final (N, M) capacity.
    The carry in and out stays full-size so chunks of different buckets
    chain on device without host round trips.
    """
    sl = lambda x: x[:m_cap]
    data_c = ba.BAData(mi=sl(data.mi), mj=sl(data.mj), q=sl(data.q),
                       t=sl(data.t), m_valid=sl(data.m_valid),
                       # realized-pair tables stay full-size (pair rows
                       # of not-yet-active cameras are gather-clamped
                       # and masked via active_m)
                       pi=data.pi, pj=data.pj,
                       mp=sl(data.mp) if data.mp is not None else None)
    cams_c = ba.CamState(focal=cams0.focal[:n_cap], ppal=cams0.ppal[:n_cap],
                         rotvec=cams0.rotvec[:n_cap], b=sl(cams0.b))
    active_c = active0[:n_cap]

    def step(l, st):
        cams, active = st
        node = l                      # addition-order numbering: node == l
        conn = order_conns[l]
        f = cams.focal[conn]
        Kc = ba._K_of(f, cams.ppal[conn])
        Kn_inv = jnp.diag(jnp.stack([1.0 / f, 1.0 / f, jnp.ones_like(f)]))
        M = rotn.mm(Kn_inv, H_pair[l], Kc)
        R_init = rotn.orthogonalize(M)
        R_conn = rotn.rodrigues(cams.rotvec[conn])
        rv_node = rotn.rotvec_from_matrix(rotn.mm(R_init, R_conn))
        cams = cams._replace(
            focal=cams.focal.at[node].set(f),
            ppal=cams.ppal.at[node].set(0.0),
            rotvec=cams.rotvec.at[node].set(rv_node))
        active = active.at[node].set(True)
        res = ba.lm_run_impl(cams, data_c, active, lambda0, fast=fast,
                             vaug_idx=vaug[l])
        return (res.cams, active)

    cams_c, active_c = jax.lax.fori_loop(lo, hi, step, (cams_c, active_c))
    cams = ba.CamState(
        focal=cams0.focal.at[:n_cap].set(cams_c.focal),
        ppal=cams0.ppal.at[:n_cap].set(cams_c.ppal),
        rotvec=cams0.rotvec.at[:n_cap].set(cams_c.rotvec),
        b=cams0.b.at[:m_cap].set(cams_c.b))
    active = active0.at[:n_cap].set(active_c)
    return cams, active


def bundle_adjust_stitching(comp: Component,
                            adjres: Adjacency,
                            sizes: Sequence[Tuple[int, int]],
                            focal: float,
                            cfg: Config,
                            progress: Optional[Callable[[float], None]] = None,
                            cancelled: Optional[Callable[[], bool]] = None,
                            fused: bool = True,
                            ) -> StitchResult:
    """Run the incremental BA over one connected component.

    ``sizes`` are (h, w) of the *global* image list; ``focal`` the scene
    focal estimate (or config fallback). ``fused=True`` runs the whole
    node-addition schedule as one compiled program (_incremental_lm);
    ``fused=False`` keeps the per-addition host loop (finer progress /
    cancellation granularity, reference-shaped control flow).
    """
    nodes = comp.nodes
    n = len(nodes)
    adj_sym = comp.adj + comp.adj.T
    order = order_nodes_by_connection(adj_sym)
    center = int(np.argmax(comp.connectivity))

    rot = np.tile(np.eye(3), (n, 1, 1))
    K = np.tile(np.diag([focal, focal, 1.0]), (n, 1, 1))

    def local_H(li: int, lj: int) -> np.ndarray:
        """RANSAC H mapping image-lj points into image-li (global table)."""
        return adjres.hom_mat[nodes[li], nodes[lj]].astype(np.float64)

    if n == 1 or len(order) < 2:
        Ks = K.copy()
        for l in range(n):
            h, w = sizes[nodes[l]]
            Ks[l, 0, 2] += w // 2
            Ks[l, 1, 2] += h // 2
        return StitchResult(rot=rot, K=Ks, adj=comp.adj,
                            connectivity=comp.connectivity, order=order,
                            nodes=nodes, center=center,
                            sizes=[sizes[g] for g in nodes])

    if fused:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        L = len(order)
        # renumber cameras into ADDITION ORDER (perm[new] = old local
        # index): the active set after addition l is then the prefix
        # [0, l] and, with matches sorted by activation step
        # (build_ba_data), the live match table is a prefix too — which
        # is what lets each chunk of the schedule run at a cropped
        # (n_cap, m_cap) capacity bucket instead of the final capacity.
        in_order = [o[0] for o in order]
        seen = set(in_order)
        perm = np.array(in_order + [i for i in range(n) if i not in seen],
                        np.int64)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)

        data, prefix = build_ba_data(comp, adjres, order=order, relabel=inv)
        Mcap = int(data.mi.shape[0])
        if prefix is None:   # component with no recorded matches
            prefix = np.zeros(L, np.int64)

        order_nodes = np.arange(L, dtype=np.int32)  # new numbering: node==l
        order_conns = np.array([inv[max(o[1], 0)] for o in order], np.int32)
        H_pair = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
        for l in range(1, L):
            H_pair[l] = local_H(order[l][1], order[l][0]).astype(np.float32)
        # reference V-augment quirk: the scaling focal belongs to the
        # active camera with the highest ORIGINAL local index (prep_opt
        # sorts its subproblem indices ascending, _stitch.cpp:88); under
        # renumbering that camera's NEW index is precomputed per addition
        vaug = inv[np.maximum.accumulate(np.array(in_order))].astype(np.int32)
        # camera capacity padded to a multiple of 8: measured a 9x
        # per-iteration cliff at exactly (N=36, M=27136) in the relaxed
        # Schur path (38.6 ms/iter vs ~5 at N=33/34/40 same M — an XLA
        # layout/padding pathology); 8-aligned camera counts sidestep it
        # and the extra slots are inactive-masked
        n_pad = _round_up(n, 8)
        cams0 = ba.CamState(
            focal=jnp.full((n_pad,), focal, jnp.float32),
            ppal=jnp.zeros((n_pad, 2), jnp.float32),
            rotvec=jnp.zeros((n_pad, 3), jnp.float32),
            b=data.t)
        # mesh-aware BA: match tables (and the per-match b params) sharded
        # over the mesh, cameras replicated; XLA's partitioner turns the
        # normal-equation segment-sums into psums (the reference's OpenMP
        # match chunks, _bundle_adjust_main.cpp:192-244 — SURVEY §2.7).
        # Match capacity is a multiple of 512 (build_ba_data), so it
        # divides any power-of-two mesh.
        from simplepanorama_tpu.parallel.mesh import pipeline_mesh
        nproc = jax.process_count()
        sharded = False
        if nproc > 1:
            # multi-host BA: match tables sharded over the GLOBAL mesh
            # (each host feeds its contiguous match shard to its local
            # devices; the normal-equation segment-sums psum over
            # ICI+DCN). Every process runs this same deterministic host
            # loop, so the SPMD dispatches line up.
            from simplepanorama_tpu.parallel.multihost import global_mesh
            from jax.experimental import multihost_utils
            from jax.sharding import PartitionSpec as P
            gmesh = global_mesh()
            M = data.mi.shape[0]
            if M % gmesh.devices.size == 0:
                nl = M // nproc
                pid = jax.process_index()

                def shard_g(x):
                    loc = np.asarray(x)[pid * nl:(pid + 1) * nl]
                    return multihost_utils.host_local_array_to_global_array(
                        loc, gmesh, P("data"))

                def rep_g(x):
                    return multihost_utils.host_local_array_to_global_array(
                        np.asarray(x), gmesh, P())

                data = ba.BAData(
                    mi=shard_g(data.mi), mj=shard_g(data.mj),
                    q=shard_g(data.q), t=shard_g(data.t),
                    m_valid=shard_g(data.m_valid),
                    # pair tables are tiny and replicated; mp rides the
                    # match axis like the other per-match tables
                    pi=rep_g(data.pi), pj=rep_g(data.pj),
                    mp=shard_g(data.mp))
                cams0 = ba.CamState(
                    focal=rep_g(cams0.focal), ppal=rep_g(cams0.ppal),
                    rotvec=rep_g(cams0.rotvec), b=shard_g(cams0.b))
                sharded = True
        else:
            mesh = pipeline_mesh()
            if mesh is not None and mesh.size > 1 \
                    and data.mi.shape[0] % mesh.size == 0:
                from jax.sharding import NamedSharding, PartitionSpec as P
                msh = NamedSharding(mesh, P("data"))
                rep = NamedSharding(mesh, P())
                put_m = lambda x: jax.device_put(x, msh)
                data = ba.BAData(
                    mi=put_m(data.mi), mj=put_m(data.mj),
                    q=put_m(data.q), t=put_m(data.t),
                    m_valid=put_m(data.m_valid),
                    pi=jax.device_put(data.pi, rep),
                    pj=jax.device_put(data.pj, rep),
                    mp=put_m(data.mp))
                cams0 = ba.CamState(
                    focal=jax.device_put(cams0.focal, rep),
                    ppal=jax.device_put(cams0.ppal, rep),
                    rotvec=jax.device_put(cams0.rotvec, rep),
                    b=jax.device_put(cams0.b, msh))
                sharded = True
        active = jnp.zeros(n_pad, bool).at[0].set(True)  # order[0] = cam 0
        oc = jnp.asarray(order_conns)
        Hp = jnp.asarray(H_pair)
        va = jnp.asarray(vaug)
        lam0 = jnp.asarray(float(cfg.lambda_), jnp.float32)

        # chunk plan: split the addition schedule into pieces of equal
        # WORK, each compiled at its own capacity bucket — matches
        # rounded to 2048 (keeps mesh divisibility), cameras to 8.
        # Cost model: per-LM-iteration time at these sizes is measured
        # latency/bandwidth-bound — roughly constant + linear in the
        # live match count, NOT ~ M(6N)^2 (the compute model put 60% of
        # the schedule in one big-capacity chunk). Equal-work chunks
        # also give even progress ticks and cancellation granularity
        # (the reference polls its cancel atomic per node,
        # _stitch.cpp:240).
        n_chunks = min(10, L - 1)
        w = prefix[1:L].astype(np.float64) + 3000.0
        cw = np.cumsum(w)
        bounds = [1]
        for c in range(1, n_chunks):
            t = np.searchsorted(cw, cw[-1] * c / n_chunks) + 1
            if t > bounds[-1] and t < L:
                bounds.append(int(t))
        bounds.append(L)
        chunks = []
        for lo_, hi_ in zip(bounds[:-1], bounds[1:]):
            n_cap = min(n_pad, _round_up(hi_, 8))
            m_cap = min(Mcap, _round_up(max(int(prefix[hi_ - 1]), 1), 2048))
            chunks.append((lo_, hi_, n_cap, m_cap))

        # double-buffered dispatch: keep up to two chunks in flight so the
        # per-chunk host sync overlaps the device computing the NEXT chunk — cancellation can
        # still stop the schedule within ~one chunk, and progress ticks on
        # real chunk completions (the dispatch is async; the carry is a
        # device future the next chunk consumes without host round trips)
        cams = cams0
        inflight = []   # [(cams_future, span)] enqueued, not yet synced
        ci = 0
        while ci < len(chunks) or inflight:
            while ci < len(chunks) and len(inflight) < 2:
                lo_, hi_, n_cap, m_cap = chunks[ci]
                if sharded:
                    # sharded tables: no cropping (slicing a P("data")
                    # array would reshard); full-capacity fused program
                    cams, active = _incremental_lm(
                        cams, active, data, jnp.asarray(order_nodes), oc,
                        Hp, lam0, jnp.asarray(lo_, jnp.int32),
                        jnp.asarray(hi_, jnp.int32), fast=bool(cfg.fast),
                        vaug=va)
                else:
                    cams, active = _incremental_lm_bucketed(
                        cams, active, data, oc, Hp, va, lam0,
                        jnp.asarray(lo_, jnp.int32),
                        jnp.asarray(hi_, jnp.int32),
                        fast=bool(cfg.fast), n_cap=n_cap, m_cap=m_cap)
                inflight.append((cams, hi_ - lo_))
                ci += 1
            done_cams, span = inflight.pop(0)
            jax.block_until_ready(done_cams.focal)
            if progress is not None:
                progress(span / (L - 1))
            if cancelled is not None and cancelled():
                # abandon un-synced chunks (the device drains them idly)
                raise RuntimeError("Process canceled")
        focal_new = np.asarray(cams.focal, np.float64)
        ppal_new = np.asarray(cams.ppal, np.float64)
        rv_new = np.asarray(cams.rotvec, np.float64)
        for l in range(L):   # map addition-order results back to local ids
            i = int(perm[l])
            K[i] = np.array([[focal_new[l], 0, ppal_new[l, 0]],
                             [0, focal_new[l], ppal_new[l, 1]],
                             [0, 0, 1.0]])
            rot[i] = _rodrigues_np(rv_new[l])
        Ks = K.copy()
        for l in range(n):
            h, w = sizes[nodes[l]]
            Ks[l, 0, 2] += w // 2
            Ks[l, 1, 2] += h // 2
        return StitchResult(rot=rot, K=Ks, adj=comp.adj,
                            connectivity=comp.connectivity, order=order,
                            nodes=nodes, center=center,
                            sizes=[sizes[g] for g in nodes])

    data, _ = build_ba_data(comp, adjres)

    first, second = order[0][0], order[1][0]
    # R for the second node: nearest rotation to K^-1 H K (both K equal)
    H01 = local_H(first, second)
    rot[second] = _orthogonalize_np(
        np.linalg.inv(K[first]) @ H01 @ K[first])
    K[second] = K[first]

    cam_active = np.zeros(n, bool)
    cam_active[[first, second]] = True
    lam = float(cfg.lambda_)

    def run_lm() -> None:
        cams = ba.CamState(
            focal=jnp.asarray(K[:, 0, 0].astype(np.float32)),
            ppal=jnp.asarray(K[:, :2, 2].astype(np.float32)),
            rotvec=jnp.asarray(np.stack([
                _rotvec_np(rot[i]) for i in range(n)]).astype(np.float32)),
            b=data.t)
        res = ba.lm_run(cams, data, jnp.asarray(cam_active), lam,
                        fast=bool(cfg.fast))
        focal_new = np.asarray(res.cams.focal)
        ppal_new = np.asarray(res.cams.ppal)
        rv_new = np.asarray(res.cams.rotvec)
        for i in range(n):
            if cam_active[i]:
                K[i] = np.array([[focal_new[i], 0, ppal_new[i, 0]],
                                 [0, focal_new[i], ppal_new[i, 1]],
                                 [0, 0, 1.0]])
                rot[i] = _rodrigues_np(rv_new[i])

    run_lm()
    if progress is not None:
        progress(1.0 / max(1, len(order) - 1))

    for l in range(2, len(order)):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        node, conn = order[l]
        Kn = K[conn].copy()
        Kn[0, 2] = 0.0
        Kn[1, 2] = 0.0
        K[node] = Kn
        H = local_H(conn, node)
        R_init = _orthogonalize_np(np.linalg.inv(Kn) @ H @ K[conn])
        rot[node] = R_init @ rot[conn]
        cam_active[node] = True
        run_lm()
        if progress is not None:
            progress(1.0 / max(1, len(order) - 1))

    Ks = K.copy()
    for l in range(n):
        h, w = sizes[nodes[l]]
        Ks[l, 0, 2] += w // 2
        Ks[l, 1, 2] += h // 2
    return StitchResult(rot=rot, K=Ks, adj=comp.adj,
                        connectivity=comp.connectivity, order=order,
                        nodes=nodes, center=center,
                        sizes=[sizes[g] for g in nodes])


def _rodrigues_np(v: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(v)
    if th < 1e-10:
        return np.eye(3) + _skew(v)
    u = v / th
    Kx = _skew(u)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _rotvec_np(R: np.ndarray) -> np.ndarray:
    Rs = _orthogonalize_np(R)
    v = np.array([Rs[2, 1] - Rs[1, 2], Rs[0, 2] - Rs[2, 0],
                  Rs[1, 0] - Rs[0, 1]])
    s = np.linalg.norm(v)
    c = np.clip((np.trace(Rs) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if s < 1e-10:
        return np.zeros(3)
    return v * (th / s)


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
