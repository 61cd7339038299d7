"""Data-parallel min-cut on a 4-connected grid: push-relabel in JAX.

The reference vendors the Boykov-Kolmogorov max-flow library
(/root/reference/src/max_flow/, ~1748 LoC of pointer-chasing C++ —
maxflow.cpp:472's grow/augment/adopt loop) — inherently sequential.
The data-parallel replacement is lock-step push-relabel with periodic
global relabeling (the standard GPU formulation): every phase is an
elementwise (H, W) update with 4-neighbor shifts, so the whole solver is
a single jitted lax.while_loop. It converges to a minimum cut of the
same graph, so seam quality matches BK exactly up to min-cut ties.

Graph encoding: t-links are folded into a signed excess
(e = cap_source - cap_sink); nodes with negative excess are sink demands.
Termination: max preflow is reached when no positive-excess node can
reach a sink demand in the residual graph; the cut's source side is then
exactly the set of nodes that CANNOT reach a sink (computed by the same
reachability sweep used for global relabeling).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

_INF = 1e18


def _shift(x, dy, dx, fill):
    """x shifted so result[y, x] = x[y+dy, x+dx], out-of-bounds = fill."""
    out = jnp.roll(x, (-dy, -dx), axis=(0, 1))
    if dy == 1:
        out = out.at[-1, :].set(fill)
    elif dy == -1:
        out = out.at[0, :].set(fill)
    if dx == 1:
        out = out.at[:, -1].set(fill)
    elif dx == -1:
        out = out.at[:, 0].set(fill)
    return out


# direction order: 0=right(+x), 1=left(-x), 2=down(+y), 3=up(-y)
_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def _shift_n(x, dy: int, dx: int, fill):
    """x shifted by (dy, dx) steps: result[y, x] = x[y+dy, x+dx],
    out-of-bounds filled — the n-step generalization of _shift, built by
    concatenation (roll+fixup only handles +-1)."""
    H, W = x.shape
    if dy > 0:
        x = jnp.concatenate([x[dy:], jnp.full((dy, W), fill, x.dtype)], 0)
    elif dy < 0:
        x = jnp.concatenate([jnp.full((-dy, W), fill, x.dtype), x[:dy]], 0)
    if dx > 0:
        x = jnp.concatenate([x[:, dx:], jnp.full((H, dx), fill, x.dtype)],
                            1)
    elif dx < 0:
        x = jnp.concatenate([jnp.full((H, -dx), fill, x.dtype), x[:, :dx]],
                            1)
    return x


def _minplus_scan(d0, w, dy: int, dx: int, size: int):
    """Inclusive min-plus prefix scan along one propagation direction
    (Hillis-Steele doubling, log2(size) steps): returns
    new_d[p] = min_j d0[p - j*step] + sum of w over the path — i.e. the
    fully-relaxed BFS distance along this direction in one O(log) pass
    instead of O(size) sweeps. ``w[p]`` is the edge weight INTO p from
    its predecessor (1 where the residual capacity admits, INF where
    not); (dy, dx) is the direction values FLOW (predecessor at
    (p_y - dy, p_x - dx)). Combine((bL,aL),(bR,aR)) = (min(bR, bL+aR),
    aL+aR); left identity (INF, 0)."""
    B = jnp.minimum(d0, _shift_n(d0, -dy, -dx, _INF) + w)
    A = jnp.minimum(w + _shift_n(w, -dy, -dx, 0.0), _INF)
    s = 2
    while s < size:
        B = jnp.minimum(B, _shift_n(B, -dy * s, -dx * s, _INF) + A)
        A = jnp.minimum(A + _shift_n(A, -dy * s, -dx * s, 0.0), _INF)
        s *= 2
    return B


def _dist_to_sink_scan(caps, demand, node, n_pass: int):
    """BFS distance-to-sink via directional min-plus scans: each pass
    fully relaxes down/up/right/left in O(log H + log W) doubling steps;
    passes repeat until fixpoint (a pass count ~ the number of direction
    changes along the shortest path's spiral, not the grid diameter).
    Same fixpoint as _dist_to_sink — only the relaxation order differs."""
    H, W = demand.shape
    d0 = jnp.where(demand & node, 0.0, _INF)
    # w into p from direction (dy,dx): admissible iff p can push TOWARD
    # its predecessor, i.e. caps[k][p] > 0 for k = the reverse direction
    w_down = jnp.where(caps[3] > 0, 1.0, _INF)    # from (y-1,x): k=3 up
    w_up = jnp.where(caps[2] > 0, 1.0, _INF)      # from (y+1,x): k=2 down
    w_right = jnp.where(caps[1] > 0, 1.0, _INF)   # from (y,x-1): k=1 left
    w_left = jnp.where(caps[0] > 0, 1.0, _INF)    # from (y,x+1): k=0 right

    def cond(state):
        it, d, changed = state
        return (it < n_pass) & changed

    def body(state):
        it, d, _ = state
        prev = d
        d = _minplus_scan(d, w_down, 1, 0, H)
        d = _minplus_scan(d, w_up, -1, 0, H)
        d = _minplus_scan(d, w_right, 0, 1, W)
        d = _minplus_scan(d, w_left, 0, -1, W)
        d = jnp.where(node, d, _INF)
        return it + 1, d, jnp.any(d < prev)

    _, d, _ = jax.lax.while_loop(
        cond, body, (jnp.array(0), jnp.where(node, d0, _INF),
                     jnp.array(True)))
    return d


def _dist_to_sink(caps, demand, node, n_sweep, shift=_shift,
                  gany=lambda b: b):
    """Height field = BFS distance to the nearest sink-demand node through
    positive-residual edges (global relabel). caps: (4, H, W).
    Runs to fixpoint (bounded by n_sweep) — truncated distances would
    make reachable nodes look like source-side.

    ``shift``/``gany`` parameterize the neighbor access and the global
    any-reduction so the same solver runs single-device (identity) or
    column-sharded under shard_map (halo ppermute + psum) — see
    parallel.dist_mincut."""
    d0 = jnp.where(demand & node, 0.0, _INF)

    def cond(state):
        it, d, changed = state
        return (it < n_sweep) & changed

    def body(state):
        it, d, _ = state
        best = d
        for k, (dy, dx) in enumerate(_DIRS):
            # can send flow from here toward the neighbor if cap[k] > 0
            nb = shift(d, dy, dx, _INF)
            cand = jnp.where(caps[k] > 0, nb + 1.0, _INF)
            best = jnp.minimum(best, cand)
        best = jnp.where(node, best, _INF)
        return it + 1, best, gany(jnp.any(best < d))

    _, d, _ = jax.lax.while_loop(cond, body, (jnp.array(0), d0,
                                              jnp.array(True)))
    return d


def _mincut_core(cap_h, cap_v, excess0, node,
                 max_outer: int, inner_iters: int, sweep_iters: int,
                 shift=_shift, gany=lambda b: b):
    """Solver core shared by the single-device and the column-sharded
    variants; ``shift`` supplies neighbor values (with halo exchange when
    the grid is sharded) and ``gany`` reduces loop predicates globally."""
    H, W = cap_h.shape
    nodef = node.astype(jnp.float32)
    cap_h = cap_h * nodef * shift(nodef, 0, 1, 0.0)
    cap_v = cap_v * nodef * shift(nodef, 1, 0, 0.0)
    # residual caps per direction: caps[k][p] = capacity from p toward its
    # k-neighbor. Left/up edges live at the neighbor's index in
    # cap_h/cap_v, hence the -1 shifts.
    caps = jnp.stack([cap_h, shift(cap_h, 0, -1, 0.0),
                      cap_v, shift(cap_v, -1, 0, 0.0)])
    # direction k's reverse direction index
    rev = (1, 0, 3, 2)

    e = jnp.where(node, excess0, 0.0)
    # clamp t-link magnitudes to (sum of incident edge caps + 1): a t-link
    # at least as large as everything the node can move is never the
    # bottleneck, so the min cut is unchanged — and it keeps every value
    # O(edge weight), which f32 needs (5000-scale seeds next to 0.1-scale
    # flows lose the flows to cancellation)
    cap_sum = caps.sum(axis=0) + 1.0
    e = jnp.clip(e, -cap_sum, cap_sum)

    def push_phase(state):
        caps, e, h = state
        # sequential over 4 directions inside one phase (deterministic)
        for k, (dy, dx) in enumerate(_DIRS):
            h_nb = shift(h, dy, dx, _INF)
            admissible = (e > 0) & (h == h_nb + 1.0) & (caps[k] > 0)
            flow = jnp.where(admissible, jnp.minimum(e, caps[k]), 0.0)
            caps = caps.at[k].add(-flow)
            # reverse capacity grows AT THE RECEIVING node: value shifted
            # opposite to the push direction
            caps = caps.at[rev[k]].add(shift(flow, -dy, -dx, 0.0))
            e = e - flow + shift(flow, -dy, -dx, 0.0)
        # relabel: active nodes with no admissible edge lift to
        # 1 + min residual neighbor height
        min_h = _INF * jnp.ones_like(h)
        adm = jnp.zeros_like(h, dtype=bool)
        for k, (dy, dx) in enumerate(_DIRS):
            h_nb = shift(h, dy, dx, _INF)
            has_cap = caps[k] > 0
            min_h = jnp.minimum(min_h, jnp.where(has_cap, h_nb, _INF))
            adm = adm | (has_cap & (h == h_nb + 1.0))
        lift = (e > 0) & (~adm) & (min_h < _INF)
        h = jnp.where(lift, min_h + 1.0, h)
        return caps, e, h

    if shift is _shift:
        # single-device: BFS via directional min-plus scans (O(log) per
        # pass) — the sweep fixpoint needs O(grid diameter) iterations
        def bfs(caps_, demand_):
            return _dist_to_sink_scan(caps_, demand_, node, sweep_iters)
    else:
        # sharded variant: halo shifts only reach +-1, keep the sweeps
        def bfs(caps_, demand_):
            return _dist_to_sink(caps_, demand_, node, sweep_iters,
                                 shift, gany)

    # ONE BFS per outer iteration: its result is both the relabel height
    # field for the next push block AND the progress/termination check for
    # the previous one (the state is unchanged between the two uses, so
    # the old end-of-iteration BFS recomputed the same distances the next
    # iteration's global relabel would — merged, halving BFS work)
    def outer_body(state):
        it, caps, e, d, _ = state
        caps, e, h = jax.lax.fori_loop(
            0, inner_iters, lambda _, s: push_phase(s), (caps, e, d))
        d = bfs(caps, e < 0)
        work_left = gany(jnp.any((e > 0) & (d < _INF)))
        return it + 1, caps, e, d, work_left

    def outer_cond(state):
        it, _, _, _, work_left = state
        return (it < max_outer) & work_left

    d0 = bfs(caps, e < 0)
    work0 = gany(jnp.any((e > 0) & (d0 < _INF)))
    state = (jnp.array(0), caps, e, d0, work0)
    it, caps, e, d, _ = jax.lax.while_loop(outer_cond, outer_body, state)

    # final residual reachability-to-sink: unreachable = source side
    return (d >= _INF) & node


@functools.partial(jax.jit, static_argnames=("max_outer", "inner_iters",
                                             "sweep_iters"))
def grid_mincut(cap_h: jnp.ndarray, cap_v: jnp.ndarray,
                excess0: jnp.ndarray, node: jnp.ndarray,
                max_outer: int = 400, inner_iters: int = 30,
                sweep_iters: int = 0):
    """Min cut of the seam grid.

    cap_h: (H, W) capacity between (y, x) and (y, x+1) (last col unused);
    cap_v: (H, W) capacity between (y, x) and (y+1, x) (last row unused);
    excess0: signed t-link excess (+source, -sink); node: validity mask.

    Returns source_side (H, W) bool: nodes that cannot reach any sink in
    the final residual graph (BK what_segment == SOURCE equivalent).
    """
    H, W = cap_h.shape
    if sweep_iters <= 0:
        sweep_iters = H + W + 4   # grid diameter bounds every BFS
    return _mincut_core(cap_h, cap_v, excess0, node, max_outer,
                        inner_iters, sweep_iters)


def cut_value(cap_h, cap_v, excess, node, source_side) -> float:
    """Host (numpy) cost of the cut that ``source_side`` induces on the
    grid_mincut graph: grid edges between the two sides plus the t-links
    lost (source excess on the sink side, sink demand on the source
    side). Lets any two solvers' cuts be compared by value, since ties
    in the cut set are allowed."""
    cap_h, cap_v, excess = (np.asarray(a, np.float64)
                            for a in (cap_h, cap_v, excess))
    node = np.asarray(node, bool)
    S = np.asarray(source_side, bool) & node
    T = ~np.asarray(source_side, bool) & node
    cross_h = ((S[:, :-1] & T[:, 1:]) | (T[:, :-1] & S[:, 1:]))
    cross_v = ((S[:-1, :] & T[1:, :]) | (T[:-1, :] & S[1:, :]))
    cost = cap_h[:, :-1][cross_h].sum() + cap_v[:-1, :][cross_v].sum()
    cost += np.where(T, np.maximum(excess, 0), 0).sum()
    cost += np.where(S, np.maximum(-excess, 0), 0).sum()
    return float(cost)
