"""Bundle adjustment: Levenberg-Marquardt with a Schur complement, as one
jitted fixed-shape JAX program.

Objective and schedule reproduce the reference's ``bund``/``bundm``/``bundf``
(/root/reference/src/math/_bundle_adjust_tools.cpp, _bundle_adjust_main.cpp,
_bundle_adjust_fast.cpp):

  * model:  H(i, j) = K_j . R_i^T . R_j . K_i^{-1}   (ret_hom,
    _bundle_adjust_tools.cpp:134-139 — the reference's own convention,
    kept verbatim so rendering pairs with it);
  * state:  per-camera {focal, principal(2), rotvec(3)} plus, in the
    relaxed ("main") objective, a per-match estimated source point b
    (initialized to the train keypoint);
  * residual per directed match (i, j):  r = [t - b, q - dehom(H(i,j) b)]
    where q = query keypoint in image i, t = train keypoint in image j
    (E_func::error, :55-72);
  * LM loop (iterate, _bundle_adjust_main.cpp:416-510): <=50 trials,
    accept -> lambda/=10, reject -> lambda*=10, stop after 6 consecutive
    rejections; error metric = sum over matches of ||r||;
  * augmentation (:270-324): U diagonal scaled by (1 + lambda*s) with
    s = focal*.001 for the intrinsic block and pi/16 for rotations; V
    diagonal scaled by (1 + lambda*focal_last*.001) — the reference uses
    the *last* camera's focal here, kept for parity;
  * Schur: (U* - sum Y W^T) da = e_A - sum Y e_B;  db = V*^{-1}(e_B - W^T da)
    (get_error, :346-413). The fast/Lowe variant (bundf) drops the b
    parameters entirely and solves U* da = e_A.
  * anchor gauge: cameras whose rotation is identity never receive rotation
    updates (add_delta, _bundle_adjust_tools.cpp:762-771).

Deviations from the reference (behavior-preserving or fixing
reference bugs):
  * Jacobians come from vmapped forward-mode autodiff of the closed-form
    residual (the reference hand-derives A/B and validates them against
    finite differences — autodiff is exactly that closed form);
  * all normal-equation terms are segment-sums over the match axis, so
    sharding matches across devices turns them into psum-reducible
    partials (the distributed-BA path);
  * the trial state is always based on the *accepted* state (the reference
    accumulates principal-point deltas across rejected trials,
    _bundle_adjust_tools.cpp:776 — a bug, not reproduced);
  * the Schur system is Jacobi-preconditioned before the f32 solve.

Everything is padded: N cameras and M matches are static capacities;
``cam_active`` / match activity masks select the incremental subproblem, so
ONE compiled LM program serves every node-addition step of the driver.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from simplepanorama_tpu.geometry.rotation import mm, rodrigues

_AUG_FOCAL = 1e-3
_AUG_ANG = float(np.pi / 16.0)

# Experimental: per-match Jacobian streams (Jd/W/Z) in bf16 with f32
# accumulation (SPT_BA_PRECISION=bf16). At these problem sizes the LM
# iteration is bound by its chain of small ops rather than by bandwidth,
# so full f32 stays the default — the residual/error path is f32 either
# way.
_BF16 = os.environ.get("SPT_BA_PRECISION", "f32") == "bf16"


class BAData(NamedTuple):
    """Static match tables (device arrays, fixed capacity M).

    The optional realized-pair tables (pi, pj, mp) let the H / dH-dcam
    chains run once per REALIZED camera pair (P ~ 3N for panorama
    graphs, padded to 64) instead of once per ordered pair (N^2): the
    per-iteration Rodrigues+jacfwd table build was ~25% of the LM
    iteration at production capacity. When absent (None), the dense N^2
    table is built as before — numerics are identical either way (same
    per-pair math, gathered per match)."""
    mi: jnp.ndarray       # (M,) i32 query-image index (image of q)
    mj: jnp.ndarray       # (M,) i32 train-image index (image of t)
    q: jnp.ndarray        # (M, 2) query keypoint, center-origin
    t: jnp.ndarray        # (M, 2) train keypoint, center-origin
    m_valid: jnp.ndarray  # (M,) bool — slot holds a real match
    pi: jnp.ndarray = None  # (P,) i32 realized-pair query-camera ids
    pj: jnp.ndarray = None  # (P,) i32 realized-pair train-camera ids
    mp: jnp.ndarray = None  # (M,) i32 pair-table row of each match


class CamState(NamedTuple):
    focal: jnp.ndarray    # (N,)
    ppal: jnp.ndarray     # (N, 2)
    rotvec: jnp.ndarray   # (N, 3)
    b: jnp.ndarray        # (M, 2) estimated source points (relaxed objective)


def _K_of(focal, ppal):
    z = jnp.zeros_like(focal)
    o = jnp.ones_like(focal)
    return jnp.stack([
        jnp.stack([focal, z, ppal[..., 0]], -1),
        jnp.stack([z, focal, ppal[..., 1]], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


def _K_inv_of(focal, ppal):
    # closed-form inverse of [[f,0,px],[0,f,py],[0,0,1]]
    inv_f = 1.0 / focal
    z = jnp.zeros_like(focal)
    o = jnp.ones_like(focal)
    return jnp.stack([
        jnp.stack([inv_f, z, -ppal[..., 0] * inv_f], -1),
        jnp.stack([z, inv_f, -ppal[..., 1] * inv_f], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


def _match_residual(cam_i, cam_j, b, q, t):
    """Residual of one match. cam_* = (6,) [f, px, py, rx, ry, rz]."""
    K_j = _K_of(cam_j[0], cam_j[1:3])
    K_i_inv = _K_inv_of(cam_i[0], cam_i[1:3])
    R_i = rodrigues(cam_i[3:6])
    R_j = rodrigues(cam_j[3:6])
    H = mm(K_j, R_i.T, R_j, K_i_inv)
    p = mm(H, jnp.array([b[0], b[1], 1.0]))
    p2 = p[:2] / jnp.where(jnp.abs(p[2]) < 1e-12, 1e-12, p[2])
    return jnp.concatenate([t - b, q - p2])


_res_jac = jax.jacfwd(_match_residual, argnums=(0, 1, 2))


def _pair_H(cam_i, cam_j):
    """H of one (i, j) camera pair. cam_* = (6,) [f, px, py, rx, ry, rz]."""
    K_j = _K_of(cam_j[0], cam_j[1:3])
    K_i_inv = _K_inv_of(cam_i[0], cam_i[1:3])
    R_i = rodrigues(cam_i[3:6])
    R_j = rodrigues(cam_j[3:6])
    return mm(K_j, R_i.T, R_j, K_i_inv)


_pair_H_jac = jax.jacfwd(_pair_H, argnums=(0, 1))


def _cam6(cams: CamState):
    return jnp.concatenate([cams.focal[:, None], cams.ppal, cams.rotvec], -1)


def with_pair_tables(data: BAData) -> BAData:
    """Attach realized-pair tables computed host-side from mi/mj (for
    synthetic benchmark/test problems; stitch.build_ba_data builds them
    in production)."""
    mi = np.asarray(data.mi)
    mj = np.asarray(data.mj)
    uniq, inv = np.unique(np.stack([mi, mj], 1), axis=0,
                          return_inverse=True)
    P = max(64, (len(uniq) + 63) // 64 * 64)
    pi = np.zeros(P, np.int32)
    pj = np.zeros(P, np.int32)
    pi[:len(uniq)] = uniq[:, 0]
    pj[:len(uniq)] = uniq[:, 1]
    return data._replace(pi=jnp.asarray(pi), pj=jnp.asarray(pj),
                         mp=jnp.asarray(inv.astype(np.int32)))


def _match_geometry(Hm, b):
    """Per-match projective chain given the gathered pair homographies.
    Returns (bh (M,3), p2 (M,2), Jp (M,2,3)) with the same dehomogenization
    guard (and its zero-tangent behavior) as _match_residual.

    All per-match contractions here and in _assemble are written as
    broadcast-multiply-reduce, NOT einsum/dot: a dot_general with a tiny
    contraction dim per batch element would be padded up to a
    matrix-unit tile per match, where the elementwise form fuses."""
    bh = jnp.concatenate([b, jnp.ones_like(b[:, :1])], -1)
    p = (Hm * bh[:, None, :]).sum(-1)
    guard = jnp.abs(p[:, 2]) < 1e-12
    w = jnp.where(guard, 1e-12, p[:, 2])
    inv_w = 1.0 / w
    p2 = p[:, :2] * inv_w[:, None]
    # d dehom / dp; the guarded branch treats w as a constant (zero
    # tangent), matching jacfwd-through-where on _match_residual
    zero = jnp.zeros_like(inv_w)
    dw = jnp.where(guard, zero, -inv_w * inv_w)
    Jp = jnp.stack([
        jnp.stack([inv_w, zero, p[:, 0] * dw], -1),
        jnp.stack([zero, inv_w, p[:, 1] * dw], -1)], -2)
    return bh, p2, Jp


def _pair_tables(data: BAData, c6, N, with_jac: bool):
    """(H table, optional (dH/dcam_i, dH/dcam_j) tables, per-match row
    index): over the realized pairs when data carries them, else over
    all N^2 ordered pairs."""
    if data.pi is not None:
        ci, cj = c6[data.pi], c6[data.pj]
        pid = data.mp
    else:
        ii = jnp.repeat(jnp.arange(N), N)
        jj = jnp.tile(jnp.arange(N), N)
        ci, cj = c6[ii], c6[jj]
        pid = data.mi * N + data.mj
    Ht = jax.vmap(_pair_H)(ci, cj)
    jac = jax.vmap(_pair_H_jac)(ci, cj) if with_jac else None
    return Ht, jac, pid


def _expand_rows(table: jnp.ndarray, pid: jnp.ndarray, P: int):
    """table[pid] for a (P, ...) table, as a one-hot matmul when the
    table is small (realized-pair tables, P <= 256) instead of a
    row-gather over M~20k indices. HIGHEST keeps it bit-clean: the
    one-hot operand's 0/1 entries are exact in every reduced-precision
    pass, so each output row is the exact f32 table row."""
    if P > 256:
        return table[pid]
    oh = jax.nn.one_hot(pid, P, dtype=table.dtype)
    flat = table.reshape(P, -1)
    out = jnp.matmul(oh, flat, precision=jax.lax.Precision.HIGHEST)
    return out.reshape((pid.shape[0],) + table.shape[1:])


def residuals(cams: CamState, data: BAData, active_m: jnp.ndarray,
              fast: bool) -> jnp.ndarray:
    """(M, 4) residuals, zeroed on inactive slots."""
    N = cams.focal.shape[0]
    c6 = _cam6(cams)
    b = data.t if fast else cams.b
    Ht, _, pid = _pair_tables(data, c6, N, with_jac=False)
    Hm = _expand_rows(Ht, pid, Ht.shape[0])
    _, p2, _ = _match_geometry(Hm, b)
    r = jnp.concatenate([data.t - b, data.q - p2], -1)
    return jnp.where(active_m[:, None], r, 0.0)


def total_error(cams: CamState, data: BAData, active_m, fast: bool,
                psum_axis=None):
    """Sum over active matches of ||r_m|| (the reference's metric).
    With ``psum_axis`` the local sum is all-reduced over that mesh axis
    (shard_map path — matches sharded, cameras replicated)."""
    r = residuals(cams, data, active_m, fast)
    e = jnp.sum(jnp.linalg.norm(r, axis=-1))
    if psum_axis is not None:
        e = jax.lax.psum(e, psum_axis)
    return e


class _JacCache(NamedTuple):
    """Lambda-independent normal-equation terms of one accepted state.

    The LM trial loop re-solves with a new lambda after a rejection, but
    the Jacobian (and hence U, eA, W, V, eB) belongs to the ACCEPTED
    state and is unchanged across consecutive rejected trials — only the
    diagonal augmentation and the Schur reduction depend on lambda.
    Caching these (carried in the while_loop state, recomputed under a
    lax.cond only on accept) removes the full assemble from every
    rejected trial. U/eA are already psum-reduced in the shard_map path;
    W/V/eB stay match-shard-local."""
    U: jnp.ndarray          # (6N, 6N)
    eA: jnp.ndarray         # (6N,)
    aug: jnp.ndarray        # (6N,) diagonal augmentation scales
    focal_last: jnp.ndarray  # scalar, V-augment reference quirk
    W: jnp.ndarray          # (M, 6N, 2) or U[:0] placeholder in fast mode
    V: jnp.ndarray          # (M, 2, 2)  or placeholder
    eB: jnp.ndarray         # (M, 2)     or placeholder


def _assemble(cams: CamState, data: BAData, active_m, lam, cam_active,
              fast: bool, n_cams: int, psum_axis=None, vaug_idx=None):
    """Build and augment the (Schur-reduced) camera system.

    Returns (S (6N,6N), rhs (6N,), Vinv (M,2,2), W (M,6N,2), eB) — the
    last three are None in fast mode.

    Formulation, two levels:

    1. The residual depends on cameras only through H(i, j), so the
       rotation/intrinsics chain and its jacfwd run once per ordered
       camera PAIR (N^2 <= ~1.3k evaluations) building H / dH/dcam
       tables; per-match work is a 9-float gather plus the projective
       chain rule (~150 flops) instead of vmapping jacfwd of the full
       residual over every match.
    2. The per-match Jacobian is block-sparse over cameras (two 2x6
       blocks on the projected-residual rows; the (t - b) rows are
       camera-independent). Instead of segment-summing 6x6 blocks into
       camera slots with a scatter-add, the dense block-sparse Jacobian
       J (M, 2, 6N) is materialized via one-hot camera masks and every
       normal-equation term becomes ONE large matmul:
       U = J^T J, e_A = -J^T r, W = J^T B, sum Y W^T, sum Y e_B. At the
       corpus's largest problem (N=36, M~20k) J is ~35 MB.

    With ``psum_axis`` (shard_map over match shards) the camera-system
    reductions U, e_A, sum YW^T, sum Y e_B are psummed over the axis;
    everything per-match (V, W, e_B blocks, and hence the delta_b
    back-substitution) stays local to the shard holding the match — the
    Schur trick is exactly what makes that split cheap (SURVEY §5; the
    reference's async dataflow, _bundle_adjust_main.cpp:192-244, reborn
    as two collectives).
    """
    cache = _assemble_cache(cams, data, active_m, cam_active, fast,
                            n_cams, psum_axis=psum_axis, vaug_idx=vaug_idx)
    S, rhs, Vinv = _schur_solve_system(cache, active_m, lam, cam_active,
                                       fast, psum_axis=psum_axis)
    if fast:
        return S, rhs, None, None, None
    return S, rhs, Vinv, cache.W, cache.eB


def _ein(spec, a, b):
    """Contraction with f32 accumulation regardless of operand dtype
    (bf16 operands take the native bf16 path; f32 keeps HIGHEST)."""
    if _BF16:
        return jnp.einsum(spec, a, b if b.dtype == a.dtype
                          else b.astype(a.dtype),
                          preferred_element_type=jnp.float32)
    return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST)


def _assemble_cache(cams: CamState, data: BAData, active_m, cam_active,
                    fast: bool, n_cams: int, psum_axis=None,
                    vaug_idx=None) -> _JacCache:
    """Jacobian-dependent (lambda-independent) half of the assemble."""
    N = n_cams
    c6 = _cam6(cams)
    b = data.t if fast else cams.b
    Ht, (Dit, Djt), pid = _pair_tables(data, c6, N, with_jac=True)
    P = Ht.shape[0]
    Hm = _expand_rows(Ht, pid, P)
    bh, p2, Jp = _match_geometry(Hm, b)
    r = jnp.concatenate([data.t - b, data.q - p2], -1)
    r = jnp.where(active_m[:, None], r, 0.0)

    # chain rule: d resid[2:4] / d cam = -Jp . (dH/dcam b)
    # (broadcast-multiply-reduce on purpose — see _match_geometry)
    dHb_i = (_expand_rows(Dit, pid, P) * bh[:, None, :, None]).sum(2)
    dHb_j = (_expand_rows(Djt, pid, P) * bh[:, None, :, None]).sum(2)
    Ai23 = -(Jp[:, :, :, None] * dHb_i[:, None, :, :]).sum(2)  # (M,2,6)
    Aj23 = -(Jp[:, :, :, None] * dHb_j[:, None, :, :]).sum(2)
    B23 = -(Jp[:, :, :, None] * Hm[:, None, :, :2]).sum(2)     # (M,2,2)
    msk = active_m[:, None, None]
    Ai23 = jnp.where(msk, Ai23, 0.0)
    Aj23 = jnp.where(msk, Aj23, 0.0)
    m_eye = jnp.broadcast_to(-jnp.eye(2, dtype=B23.dtype), B23.shape)
    B = jnp.concatenate([m_eye, B23], 1)                # (M,4,2)
    B = jnp.where(msk, B, 0.0)

    # dense block-sparse Jacobian: J[m, r, 6*x+a] = Pi[m,x] Ai23[m,r,a]
    #                                             + Pj[m,x] Aj23[m,r,a]
    Pi = jax.nn.one_hot(data.mi, N, dtype=Ai23.dtype)   # (M, N)
    Pj = jax.nn.one_hot(data.mj, N, dtype=Aj23.dtype)
    Jd = (Pi[:, None, :, None] * Ai23[:, :, None, :]
          + Pj[:, None, :, None] * Aj23[:, :, None, :])  # (M, 2, N, 6)
    Jd = Jd.reshape(-1, 2, 6 * N)
    if _BF16:
        Jd = Jd.astype(jnp.bfloat16)

    U = _ein("mra,mrb->ab", Jd, Jd)

    # gradient with the Gauss-Newton sign: we differentiate the RESIDUAL
    # r = meas - model, so the step solves (J^T J + lam D) d = -J^T r
    # (the reference differentiates the model, absorbing the minus)
    eA = -_ein("mra,mr->a", Jd, r[:, 2:])

    if psum_axis is not None:
        # THE collective: partial normal equations -> global camera system
        # (augmentation must scale the GLOBAL diagonal, so psum comes first)
        U = jax.lax.psum(U, psum_axis)
        eA = jax.lax.psum(eA, psum_axis)

    # augmentation scales (augment, _bundle_adjust_main.cpp:270-324)
    aug = jnp.concatenate([
        jnp.repeat(cams.focal[:, None] * _AUG_FOCAL, 3, axis=1),
        jnp.full((N, 3), _AUG_ANG)], axis=1).reshape(-1)

    # V augment focal: reference quirk — the LAST active camera's focal
    # (the augment loop variable's final value; prep_opt sorts its
    # subproblem indices, so "last" = highest original local index among
    # active cameras). ``vaug_idx`` overrides when the caller has
    # renumbered cameras (stitch.py addition-order bucketing) and
    # precomputed that camera's new index.
    if vaug_idx is None:
        last = jnp.max(jnp.where(cam_active, jnp.arange(N), 0))
    else:
        last = vaug_idx
    focal_last = cams.focal[last]

    if fast:
        return _JacCache(U=U, eA=eA, aug=aug, focal_last=focal_last,
                         W=jnp.zeros((1, 1, 2), U.dtype),
                         V=jnp.zeros((1, 2, 2), U.dtype),
                         eB=jnp.zeros((1, 2), U.dtype))

    V = (B[:, :, :, None] * B[:, :, None, :]).sum(1)   # (M,2,2)
    eB = -(B * r[:, :, None]).sum(1)                   # (M,2)
    # W = Jd^T B (projected rows only) written as 4 elementwise
    # (M, 6N) products — the broadcast form materializes a
    # (M, 2, 6N, 2) intermediate (~160 MB at production capacity)
    Bc = B.astype(Jd.dtype)
    W = jnp.stack(
        [Jd[:, 0, :] * Bc[:, 2, 0, None] + Jd[:, 1, :] * Bc[:, 3, 0, None],
         Jd[:, 0, :] * Bc[:, 2, 1, None] + Jd[:, 1, :] * Bc[:, 3, 1, None]],
        axis=-1)                                       # (M,6N,2)
    return _JacCache(U=U, eA=eA, aug=aug, focal_last=focal_last,
                     W=W, V=V, eB=eB)


def _schur_solve_system(cache: _JacCache, active_m, lam, cam_active,
                        fast: bool, psum_axis=None):
    """Lambda-dependent half: diagonal augmentation, V inverse, Schur
    reduction. Runs every LM trial; _assemble_cache only on accepts."""
    U_aug = cache.U + jnp.diag(jnp.diag(cache.U) * lam * cache.aug)

    if fast:
        S, rhs = U_aug, cache.eA
        Vinv = None
    else:
        W, V, eB = cache.W, cache.V, cache.eB
        aug_l = 1.0 + lam * cache.focal_last * _AUG_FOCAL
        Va = V.at[:, 0, 0].multiply(aug_l).at[:, 1, 1].multiply(aug_l)
        det = Va[:, 0, 0] * Va[:, 1, 1] - Va[:, 0, 1] * Va[:, 1, 0]
        det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
        Vinv = jnp.stack([
            jnp.stack([Va[:, 1, 1], -Va[:, 0, 1]], -1),
            jnp.stack([-Va[:, 1, 0], Va[:, 0, 0]], -1)], -2) / det[:, None, None]
        Vinv = jnp.where(active_m[:, None, None], Vinv, 0.0)

        # YW = sum_m W V^-1 W^T via the closed-form 2x2 Cholesky of the
        # (symmetric PSD) V^-1: YW = Z^T Z with Z = W L built from pure
        # elementwise products — the Y = W V^-1 broadcast form
        # materialized a (M, 6N, 2, 2) intermediate (~314 MB at
        # production capacity) and dominated the whole assemble
        l00 = jnp.sqrt(jnp.maximum(Vinv[:, 0, 0], 0.0))
        safe = jnp.where(l00 > 0.0, l00, 1.0)
        l10 = Vinv[:, 1, 0] / safe
        l11 = jnp.sqrt(jnp.maximum(Vinv[:, 1, 1] - l10 * l10, 0.0))
        cast = (lambda x: x.astype(W.dtype))
        Z0 = W[:, :, 0] * cast(l00)[:, None] \
            + W[:, :, 1] * cast(l10)[:, None]
        Z1 = W[:, :, 1] * cast(l11)[:, None]                # (M,6N)
        YW = _ein("ma,mb->ab", Z0, Z0) + _ein("ma,mb->ab", Z1, Z1)
        # yeb = sum_m W (V^-1 eB): g = V^-1 eB is elementwise per match
        g0 = Vinv[:, 0, 0] * eB[:, 0] + Vinv[:, 0, 1] * eB[:, 1]
        g1 = Vinv[:, 1, 0] * eB[:, 0] + Vinv[:, 1, 1] * eB[:, 1]
        yeb = (_ein("ma,m->a", W[:, :, 0], g0)
               + _ein("ma,m->a", W[:, :, 1], g1))
        if psum_axis is not None:
            YW = jax.lax.psum(YW, psum_axis)
            yeb = jax.lax.psum(yeb, psum_axis)
        S = U_aug - YW
        rhs = cache.eA - yeb

    # inactive cameras: identity diagonal block, zero rhs -> zero delta
    act6 = jnp.repeat(cam_active, 6)
    S = jnp.where(act6[:, None] & act6[None, :], S, 0.0)
    S = S + jnp.diag(jnp.where(act6, 0.0, 1.0))
    rhs = jnp.where(act6, rhs, 0.0)
    return S, rhs, Vinv


def _solve_preconditioned(S, rhs):
    """Jacobi-preconditioned solve (f32-friendly conditioning)."""
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diag(S)), 1e-12))
    Dinv = 1.0 / d
    Ss = S * Dinv[:, None] * Dinv[None, :]
    y = jnp.linalg.solve(Ss, rhs * Dinv)
    return y * Dinv


def _apply_delta(cams: CamState, da, db, data: BAData, cam_active,
                 active_m, fast: bool):
    """Trial state from deltas. Rotation frozen for identity-rotation
    cameras (gauge anchor, add_delta)."""
    N = cams.focal.shape[0]
    da = da.reshape(N, 6)
    da = jnp.where(cam_active[:, None], da, 0.0)
    frozen = jnp.linalg.norm(cams.rotvec, axis=-1) < 1e-6
    focal = cams.focal + da[:, 0]
    ppal = cams.ppal + da[:, 1:3]
    rotvec = jnp.where(frozen[:, None], cams.rotvec,
                       cams.rotvec + da[:, 3:6])
    if fast or db is None:
        b = cams.b
    else:
        b = cams.b + jnp.where(active_m[:, None], db, 0.0)
    return CamState(focal, ppal, rotvec, b)


class LMResult(NamedTuple):
    cams: CamState
    error: jnp.ndarray        # final accepted sum-of-norms error
    lam: jnp.ndarray
    n_accepted: jnp.ndarray
    n_iter: jnp.ndarray       # LM trial steps executed (accepted+rejected)


def lm_run_impl(cams: CamState, data: BAData, cam_active: jnp.ndarray,
                lambda0, fast: bool = False, max_iter: int = 50,
                psum_axis=None, vaug_idx=None) -> LMResult:
    """lm_run body without the jit wrapper — composable inside larger
    compiled programs (the fused incremental driver, stitch._incremental_lm,
    inlines it in a fori_loop so the whole node-addition schedule is one
    XLA program with zero host round trips).

    With ``psum_axis`` the same loop runs under shard_map with match
    tables (and cams.b) sharded over that mesh axis: the camera system is
    psum-reduced, the tiny Schur solve is replicated, and the per-match
    delta_b back-substitution stays shard-local (parallel.dist_ba)."""
    N = cams.focal.shape[0]
    active_m = data.m_valid & cam_active[data.mi] & cam_active[data.mj]

    def cond(st):
        it, strikes, *_ = st
        return (it < max_iter) & (strikes <= 5)

    def recompute(cur):
        return _assemble_cache(cur, data, active_m, cam_active, fast, N,
                               psum_axis=psum_axis, vaug_idx=vaug_idx)

    def body(st):
        it, strikes, cur, err_cur, lam, n_acc = st
        # NOTE: recomputing the cache unconditionally here measured
        # FASTER than carrying it through a lax.cond that skips the
        # recompute on rejected trials (2.4 vs 1.2 ms/iter at N=40
        # production capacity): the conditional defeats XLA's in-place
        # aliasing/fusion of the ~40 MB W buffer and every iteration
        # pays the copy instead of the (well-fused) recompute.
        cache = recompute(cur)
        S, rhs, Vinv = _schur_solve_system(cache, active_m, lam,
                                           cam_active, fast,
                                           psum_axis=psum_axis)
        da = _solve_preconditioned(S, rhs)
        if fast:
            db = None
        else:
            wtd = (cache.W * da[None, :, None]).sum(1)
            db = (Vinv * (cache.eB - wtd)[:, None, :]).sum(2)
        trial = _apply_delta(cur, da, db, data, cam_active, active_m, fast)
        err_new = total_error(trial, data, active_m, fast,
                              psum_axis=psum_axis)
        ok = (err_new < err_cur) & jnp.isfinite(err_new)
        nxt = jax.tree.map(lambda a, b: jnp.where(ok, a, b), trial, cur)
        err_nxt = jnp.where(ok, err_new, err_cur)
        lam = jnp.where(ok, lam * 0.1, lam * 10.0)
        strikes = jnp.where(ok, 0, strikes + 1)
        return (it + 1, strikes, nxt, err_nxt, lam,
                n_acc + ok.astype(jnp.int32))

    err0 = total_error(cams, data, active_m, fast, psum_axis=psum_axis)
    init = (jnp.array(0), jnp.array(0), cams, err0,
            jnp.asarray(lambda0, jnp.float32), jnp.array(0))
    it, strikes, cur, err, lam, n_acc = jax.lax.while_loop(cond, body, init)
    return LMResult(cams=cur, error=err, lam=lam, n_accepted=n_acc,
                    n_iter=it)


@functools.partial(jax.jit, static_argnames=("fast", "max_iter"))
def lm_run(cams: CamState, data: BAData, cam_active: jnp.ndarray,
           lambda0, fast: bool = False, max_iter: int = 50) -> LMResult:
    """Full LM optimization over the active subproblem (one XLA program)."""
    return lm_run_impl(cams, data, cam_active, lambda0, fast=fast,
                       max_iter=max_iter)


def model_homography(cams: CamState, i: int, j: int) -> jnp.ndarray:
    """H(i, j) of the BA model (ret_hmat) — maps b-points to image i."""
    K_j = _K_of(cams.focal[j], cams.ppal[j])
    K_i_inv = _K_inv_of(cams.focal[i], cams.ppal[i])
    R_i = rodrigues(cams.rotvec[i])
    R_j = rodrigues(cams.rotvec[j])
    return mm(K_j, R_i.T, R_j, K_i_inv)
