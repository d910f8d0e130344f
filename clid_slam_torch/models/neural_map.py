"""Fixed-capacity voxel-hashed neural point map (port of
clid_slam_tpu/models/neural_map.py).

All per-point arrays have ``capacity + 1`` rows; row ``capacity`` is a zero
sentinel for invalid gathers. ``hash_mirror`` [H,4] holds each bucket
occupant's (x, y, z, travel_dist_at_create) so a K-cell probe is one row
gather per cell.

Functions return new state objects; tensors that a function does not
change are shared with the input state, and tensors it changes are new
(``insert_points`` clones the slabs it writes), so a caller's old state
stays valid.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple, Optional

import torch

from ..ops.gather import gather_lanes, gather_rows_nd
from ..ops.scatter import compact_indices, scatter_set, segment_add
from ..utils import lie
from ..ops.voxel import (
    grid_coords,
    neighbor_hash_soa,
    neighbor_offsets,
    voxel_down_sample_mask,
    voxel_hash,
)

_EMPTY_POS = 1e9  # mirror sentinel: empty buckets sit "infinitely far away"
INSERT_COMPACT_ROWS = 65536  # pre-probe compaction budget (see insert_points)


@dataclass
class NeuralMapState:
    positions: torch.Tensor  # [C+1, 3] f32
    quats: torch.Tensor  # [C+1, 4] f32 (wxyz)
    geo_feats: torch.Tensor  # [C+1, F] f32 (trainable)
    color_feats: torch.Tensor  # [C+1, Fc] f32
    certainty: torch.Tensor  # [C+1] f32
    ts_create: torch.Tensor  # [C+1] i32
    ts_update: torch.Tensor  # [C+1] i32
    count: torch.Tensor  # scalar i32
    hash_table: torch.Tensor  # [H] i32, -1 = empty
    hash_mirror: torch.Tensor  # [H, 4] f32

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)]

    def _replace(self, **kw) -> "NeuralMapState":
        return replace(self, **kw)


def init_map(
    capacity: int,
    hash_size: int,
    feature_dim: int,
    color_feature_dim: int = 1,
    device=None,
) -> NeuralMapState:
    c1 = capacity + 1
    f32 = dict(dtype=torch.float32, device=device)
    quats = torch.zeros((c1, 4), **f32)
    quats[:, 0] = 1.0
    return NeuralMapState(
        positions=torch.zeros((c1, 3), **f32),
        quats=quats,
        geo_feats=torch.zeros((c1, feature_dim), **f32),
        color_feats=torch.zeros((c1, color_feature_dim), **f32),
        certainty=torch.zeros((c1,), **f32),
        ts_create=torch.zeros((c1,), dtype=torch.int32, device=device),
        ts_update=torch.zeros((c1,), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        hash_table=torch.full((hash_size,), -1, dtype=torch.int32, device=device),
        hash_mirror=torch.full((hash_size, 4), _EMPTY_POS, **f32),
    )


def map_capacity(state: NeuralMapState) -> int:
    return state.positions.shape[0] - 1


def _compact_rows(mask: torch.Tensor, rows: torch.Tensor, size: int):
    """Stable cumsum compaction of the masked rows into ``size`` slots.
    Returns (compacted [size, ...], live [size]); rows past ``size`` drop."""
    offs = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.zeros((size,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    scatter_set(out, offs, rows, mask & (offs < size))
    n = torch.sum(mask.to(torch.int64))
    live = torch.arange(size, device=rows.device) < torch.clamp(n, max=size)
    return out, live


class InsertStats(NamedTuple):
    new_ratio: torch.Tensor  # n_new / max(m_total, 1)
    dropped: torch.Tensor  # candidates lost to the pre-probe compaction


def insert_points(
    state: NeuralMapState,
    points: torch.Tensor,  # [M,3] world frame
    mask: torch.Tensor,  # [M] bool
    resolution,
    travel_dist: torch.Tensor,  # [T]
    cur_ts,
    diff_travel_dist_local,
    downsample: bool = True,
):
    """Insert new neural points (model/neural_points.py:324-437 semantics).

    A candidate claims a slot when its bucket is empty, the occupant is a
    hash collision (dist² > 3·res²), or the occupant is stale by travel
    distance. Winners are compacted into a [w] staging buffer so only w rows
    touch the slabs. Returns (new_state, InsertStats).

    Mirrors the JAX behaviour on purpose: with more than 65,536 candidate
    rows, the (downsampled) candidates are compacted to the first 65,536
    before the probe and the rest are dropped silently there; the port
    counts them in ``InsertStats.dropped``."""
    cap = map_capacity(state)
    hsize = state.hash_table.shape[0]
    dev = points.device
    m = points.shape[0]
    w = min(32768, m)  # per-frame insertion budget

    if downsample:
        mask = voxel_down_sample_mask(points, mask, resolution, hsize)

    m_total = torch.sum(mask.to(torch.int32))
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if m > INSERT_COMPACT_ROWS:
        w1 = INSERT_COMPACT_ROWS
        points, mask = _compact_rows(mask, points, w1)
        dropped = torch.clamp(m_total - w1, min=0)
        m = w1

    g = grid_coords(points, resolution)
    h = voxel_hash(g, hsize)
    mir = gather_rows_nd(state.hash_mirror, h)
    occupied = mir[..., 0] < _EMPTY_POS * 0.5
    dist2 = torch.sum((mir[..., :3] - points) ** 2, dim=-1)
    collision = occupied & (dist2 > 3.0 * resolution * resolution)
    cur_idx = state.hash_table[h].to(torch.int64)
    safe_idx = torch.where(cur_idx >= 0, cur_idx, torch.full_like(cur_idx, cap))
    delta_td = travel_dist[cur_ts] - travel_dist[state.ts_update[safe_idx].long()]
    stale = delta_td > diff_travel_dist_local

    is_first = state.count == 0
    update = mask & (~occupied | collision | stale | is_first)

    offs = torch.cumsum(update.to(torch.int64), 0) - 1
    update = update & (offs < w) & (state.count + offs < cap)
    stage_pts = torch.zeros((w, 3), dtype=torch.float32, device=dev)
    scatter_set(stage_pts, offs, points, update)
    stage_h = torch.full((w,), hsize, dtype=torch.int64, device=dev)
    scatter_set(stage_h, offs, h, update)
    n_new = torch.sum(update.to(torch.int32))

    wr = torch.arange(w, device=dev)
    wlive = wr < n_new
    new_idx_w = state.count.long() + wr
    ts = torch.as_tensor(cur_ts, device=dev).to(torch.int32)
    positions = scatter_set(state.positions.clone(), new_idx_w, stage_pts, wlive)
    ts_create = scatter_set(state.ts_create.clone(), new_idx_w, ts, wlive)
    ts_update = scatter_set(state.ts_update.clone(), new_idx_w, ts, wlive)
    # two staged voxels can share a bucket: duplicates resolve last-wins
    hash_table = scatter_set(
        state.hash_table.clone(), stage_h, new_idx_w.to(torch.int32), wlive
    )
    mirror_rows = torch.cat(
        [stage_pts, travel_dist[cur_ts].expand(w)[:, None]], dim=1
    )
    hash_mirror = scatter_set(state.hash_mirror.clone(), stage_h, mirror_rows, wlive)

    new_ratio = n_new / torch.clamp(m_total, min=1)
    new_state = replace(
        state,
        positions=positions,
        ts_create=ts_create,
        ts_update=ts_update,
        count=torch.clamp(state.count + n_new, max=cap).to(torch.int32),
        hash_table=hash_table,
        hash_mirror=hash_mirror,
    )
    return new_state, InsertStats(new_ratio, dropped)


# ------------------------------------------------------------------- query


class QueryResult(NamedTuple):
    feature: torch.Tensor  # [N, F+P] weighted feature ‖ relative vector ([N, k, F+P] per neighbour)
    weights: torch.Tensor  # [N, k]
    knn_idx: torch.Tensor  # [N, k] point indices (-1 invalid)
    nn_count: torch.Tensor  # [N]
    certainty: torch.Tensor  # [N]


def neighborhood_probe(
    state: NeuralMapState,
    points: torch.Tensor,  # [N,3]
    nb_offs: torch.Tensor,  # [K,3]
    resolution,
    max_valid_dist2,
    travel_dist: Optional[torch.Tensor] = None,
    cur_ts=0,
    diff_travel_dist_local=1e9,
    time_filtering: bool = False,
):
    """[N] points -> ([N,K] dist², [N,K] bucket, [N,K] valid, [N,K,4]
    mirror rows) over the K-cell neighborhood with one mirror row gather."""
    hsize = state.hash_table.shape[0]
    h = neighbor_hash_soa(points, nb_offs, resolution, hsize)
    mir = gather_rows_nd(state.hash_mirror, h)
    d2 = torch.sum((mir[..., :3] - points[:, None, :]) ** 2, dim=-1)
    valid = d2 <= max_valid_dist2
    if time_filtering:
        dtd = torch.abs(travel_dist[cur_ts] - mir[..., 3])
        valid = valid & (dtd < diff_travel_dist_local)
    return d2, h, valid, mir


def smallest_k(d2s: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries per row, ties to the lower index
    (``jax.lax.top_k(-d2s, k)``'s selection and order)."""
    return torch.sort(d2s, dim=-1, stable=True).indices[..., :k]


def dedupe_mask(h_sel: torch.Tensor) -> torch.Tensor:
    """True where an earlier column of the row holds the same bucket."""
    k = h_sel.shape[-1]
    tri = torch.ones((k, k), dtype=torch.bool, device=h_sel.device).tril(-1)
    dup = (h_sel[..., :, None] == h_sel[..., None, :]) & tri
    return torch.any(dup, dim=-1)


def idw_weights(knn_d2, valid, nn_count) -> torch.Tensor:
    """Normalized inverse-distance² weights with the reference's
    zero-neighbor epsilon handling (model/neural_points.py:688-706)."""
    eps = 1e-15
    zero = torch.zeros_like(knn_d2)
    w = torch.where(valid, 1.0 / (knn_d2 + eps), zero)
    w = torch.where((nn_count == 0)[..., None], torch.full_like(w, eps), w)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.where(valid, w, zero)


def layer_norm_feats(f: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(f, dim=-1, keepdim=True)
    var = torch.var(f, dim=-1, keepdim=True, unbiased=False)
    return (f - mu) * torch.rsqrt(var + 1e-5)


def conj_rotate(quats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate ``vecs`` [..., 3] by the conjugates of ``quats`` [..., 4]
    (wxyz), in the JAX package's operation order."""
    w, u = quats[..., :1], -quats[..., 1:]  # no host constant: a CUDA graph can hold it
    uv = torch.linalg.cross(u.expand_as(vecs), vecs, dim=-1)
    return vecs + 2.0 * (w * uv + torch.linalg.cross(u.expand_as(uv), uv, dim=-1))


def query_feature(
    state: NeuralMapState,
    points: torch.Tensor,
    nb_offs: torch.Tensor,
    resolution,
    max_valid_dist2,
    knn_k: int,
    travel_dist=None,
    cur_ts=0,
    diff_travel_dist_local=1e9,
    time_filtering: bool = False,
    rotate_vecs: bool = False,
    encode_vecs=None,
    layer_norm: bool = False,
    weighted_first: bool = True,
) -> QueryResult:
    """kNN feature interpolation (model/neural_points.py:553-769).
    Differentiable wrt ``points`` and ``state.geo_feats``; both backward
    passes sum in a fixed order (the lane gathers' targets are distinct,
    the feature rows' are summed by ``ops/gather.py:gather_rows_nd``), so a
    card run repeats bit for bit.

    ``weighted_first=False`` (decode-then-weight) returns the per-neighbour
    features [N, k, F+P] in place of their IDW-weighted sum; the caller
    decodes each neighbour and weights the decoded values with
    ``weights``.

    ``rotate_vecs=True`` is the post-PGO mode: after ``adjust_map`` each
    point's quaternion holds its accumulated pose correction, and the
    relative vector is expressed in the point's original frame by the
    conjugate rotation (model/neural_points.py:666-671)."""
    cap = map_capacity(state)
    d2, h, pvalid, mir = neighborhood_probe(
        state, points, nb_offs, resolution, max_valid_dist2,
        travel_dist, cur_ts, diff_travel_dist_local, time_filtering,
    )
    nn_count = torch.sum(pvalid.to(torch.int32), dim=-1)
    d2s = torch.where(pvalid, d2, torch.full_like(d2, 9e3))
    sel = smallest_k(d2s.detach(), knn_k)
    knn_d2 = gather_lanes(d2s, sel)
    h_sel = gather_lanes(h, sel)
    valid = gather_lanes(pvalid, sel) & ~dedupe_mask(h_sel)
    idx_sel = state.hash_table[h_sel].to(torch.int64)
    valid = valid & (idx_sel >= 0)
    knn_idx = torch.where(valid, idx_sel, torch.full_like(idx_sel, -1))
    safe = torch.where(valid, idx_sel, torch.full_like(idx_sel, cap))

    feats = gather_rows_nd(state.geo_feats, safe)
    if layer_norm:
        feats = layer_norm_feats(feats)
    feats = torch.where(valid[..., None], feats, torch.zeros_like(feats))
    nb_pos = gather_lanes(mir, sel)[..., :3]
    vecs = points[:, None, :] - nb_pos
    if rotate_vecs:
        vecs = conj_rotate(gather_rows_nd(state.quats, safe), vecs)
    if encode_vecs is not None:
        vecs = encode_vecs(vecs)
    vecs = torch.where(valid[..., None], vecs, torch.zeros_like(vecs))
    w = idw_weights(knn_d2, valid, nn_count)
    cert = torch.where(valid, state.certainty[safe], torch.zeros_like(w))
    certainty_q = torch.sum(cert * w, dim=1)
    feat_vec = torch.cat([feats, vecs], dim=-1)
    feature = torch.sum(feat_vec * w[..., None], dim=1) if weighted_first else feat_vec
    return QueryResult(feature, w, knn_idx, nn_count, certainty_q)


def query_color_feature(
    state: NeuralMapState, qres: QueryResult, feature_dim: int
) -> torch.Tensor:
    """Color-feature interpolation on the geometric query's neighbours and
    weights (``qres``), from the second feature slab ``color_feats``, with
    the same relative-vector suffix: [N, Fc+P], or [N, k, Fc+P] when the
    query ran decode-then-weight. The slab's rows go through
    ``gather_rows_nd`` (a fixed-order backward wrt ``color_feats``)."""
    cap = map_capacity(state)
    valid = qres.knn_idx >= 0
    safe = torch.where(valid, qres.knn_idx, torch.full_like(qres.knn_idx, cap))
    cf = gather_rows_nd(state.color_feats, safe)
    cf = torch.where(valid[..., None], cf, torch.zeros_like(cf))
    if qres.feature.dim() == 3:  # decode-then-weight
        return torch.cat([cf, qres.feature[..., feature_dim:]], dim=-1)
    cw = torch.sum(cf * qres.weights[..., None], dim=1)
    return torch.cat([cw, qres.feature[:, feature_dim:]], dim=-1)


def accumulate_certainty(
    state: NeuralMapState,
    knn_idx: torch.Tensor,
    weights: torch.Tensor,
    query_ts: Optional[torch.Tensor] = None,
) -> NeuralMapState:
    """Training-mode certainty accumulation + last-update-ts maxing (both
    in a fixed order, so deterministic on the card too)."""
    cap = map_capacity(state)
    valid = knn_idx >= 0
    tgt = torch.where(valid, knn_idx, torch.full_like(knn_idx, cap)).reshape(-1)
    w = torch.where(valid, weights, torch.zeros_like(weights)).reshape(-1)
    certainty = segment_add(state.certainty, tgt, w)
    certainty[cap] = 0.0
    ts_update = state.ts_update
    if query_ts is not None:
        ts_rep = query_ts.to(torch.int32)[:, None].expand(knn_idx.shape)
        ts_rep = torch.where(valid, ts_rep, torch.zeros_like(ts_rep)).reshape(-1)
        ts_update = ts_update.scatter_reduce(0, tgt, ts_rep, "amax")
        ts_update[cap] = 0
    return replace(state, certainty=certainty, ts_update=ts_update)


def query_certainty_max(
    state: NeuralMapState,
    points: torch.Tensor,
    resolution,
    max_valid_dist2,
) -> torch.Tensor:
    """Max neighbor certainty over the 1-cell neighborhood."""
    nb = torch.from_numpy(neighbor_offsets(1, 0.0)).to(points.device)
    _, h, valid, _ = neighborhood_probe(state, points, nb, resolution, max_valid_dist2)
    cap = map_capacity(state)
    idx = state.hash_table[h].to(torch.int64)
    valid = valid & (idx >= 0)
    cert = state.certainty[torch.where(valid, idx, torch.full_like(idx, cap))]
    cert = torch.where(valid, cert, torch.zeros_like(cert))
    return torch.amax(cert, dim=-1)


def query_certainty_own_cell(
    state: NeuralMapState,
    points: torch.Tensor,
    resolution,
) -> torch.Tensor:
    """Own-cell certainty for the novelty gate, skipping the mirror
    distance check (exact up to hash collisions)."""
    hsize = state.hash_table.shape[0]
    cap = map_capacity(state)
    h = voxel_hash(grid_coords(points, resolution), hsize)
    idx = state.hash_table[h].to(torch.int64)
    valid = idx >= 0
    cert = state.certainty[torch.where(valid, idx, torch.full_like(idx, cap))]
    return torch.where(valid, cert, torch.zeros_like(cert))


# ------------------------------------------------------------------- prune


def _rebuild_hash(positions, ts_create, count, travel_dist, resolution, hsize):
    """Hash table and mirror over the first ``count`` points. Two live
    points in one bucket resolve last-wins, as in ``insert_points``."""
    c1 = positions.shape[0]
    dev = positions.device
    h = voxel_hash(grid_coords(positions, resolution), hsize)
    live = torch.arange(c1, device=dev) < count
    hash_table = torch.full((hsize,), -1, dtype=torch.int32, device=dev)
    scatter_set(hash_table, h, torch.arange(c1, dtype=torch.int32, device=dev), live)
    travel_at_create = travel_dist[ts_create.clamp(min=0).long()]
    hash_mirror = torch.full((hsize, 4), _EMPTY_POS, dtype=torch.float32, device=dev)
    scatter_set(
        hash_mirror, h, torch.cat([positions, travel_at_create[:, None]], dim=1), live
    )
    return hash_table, hash_mirror


def prune_and_rehash(
    state: NeuralMapState,
    prune_certainty_thre,
    travel_dist: torch.Tensor,
    cur_ts,
    diff_travel_dist_local,
    resolution,
    global_prune: bool = False,
) -> NeuralMapState:
    """Drop inactive low-certainty points (all low-certainty points with
    ``global_prune``), compact the survivors to the front in order and
    rebuild the hash. No host read.

    The compaction is a gather: output slot j reads the j-th kept row, so
    no scatter order can matter. Freed rows keep the ``insert_points`` slab
    invariant: identity quaternion, zero features, certainty and stamps."""
    c1 = state.positions.shape[0]
    dev = state.positions.device
    rows = torch.arange(c1, device=dev)
    live = rows < state.count
    certain = state.certainty >= prune_certainty_thre
    if global_prune:
        keep = live & certain
    else:
        dtd = torch.abs(travel_dist[cur_ts] - travel_dist[state.ts_update.long()])
        keep = live & ~((dtd > diff_travel_dist_local) & ~certain)
    new_count = torch.sum(keep.to(torch.int32))
    src = compact_indices(keep, c1)
    kept = rows < new_count

    def compact(arr):
        moved = arr[src]
        mask = kept.reshape((c1,) + (1,) * (arr.dim() - 1))
        return torch.where(mask, moved, torch.zeros_like(moved))

    positions = compact(state.positions)
    quats = compact(state.quats)
    quats[:, 0] = torch.where(kept, quats[:, 0], torch.ones_like(quats[:, 0]))
    ts_create = compact(state.ts_create)
    hash_table, hash_mirror = _rebuild_hash(
        positions, ts_create, new_count, travel_dist, resolution,
        state.hash_table.shape[0],
    )
    return NeuralMapState(
        positions=positions,
        quats=quats,
        geo_feats=compact(state.geo_feats),
        color_feats=compact(state.color_feats),
        certainty=compact(state.certainty),
        ts_create=ts_create,
        ts_update=compact(state.ts_update),
        count=new_count,
        hash_table=hash_table,
        hash_mirror=hash_mirror,
    )


def adjust_map(
    state: NeuralMapState,
    pose_diff: torch.Tensor,  # [T,4,4] per-frame pose corrections
    travel_dist: torch.Tensor,
    resolution,
    use_mid_ts: bool = True,
) -> NeuralMapState:
    """Apply per-frame pose corrections (from PGO / global BA) to the map:
    each point moves by the correction of its (mid) timestamp, its stored
    orientation accumulates the rotation, and the hash is rebuilt for the
    moved positions. The rotation is applied as multiply-and-reduce, not a
    matmul, so no matmul precision setting can move the map."""
    c1 = state.positions.shape[0]
    ts = (
        torch.div(state.ts_create + state.ts_update, 2, rounding_mode="floor")
        if use_mid_ts
        else state.ts_create
    )
    T = pose_diff[ts.clamp(min=0).long()]  # [C+1,4,4]
    R, t = T[:, :3, :3], T[:, :3, 3]
    live = (torch.arange(c1, device=state.positions.device) < state.count)[:, None]
    moved = torch.sum(R * state.positions[:, None, :], dim=-1) + t
    positions = torch.where(live, moved, state.positions)
    dq = lie.rotmat_to_quat(R)
    quats = torch.where(live, lie.quat_multiply(dq, state.quats), state.quats)
    hash_table, hash_mirror = _rebuild_hash(
        positions, state.ts_create, state.count, travel_dist, resolution,
        state.hash_table.shape[0],
    )
    return replace(
        state, positions=positions, quats=quats, hash_table=hash_table,
        hash_mirror=hash_mirror,
    )


def memory_mb(state: NeuralMapState, feature_dim: int) -> float:
    """Map memory accounting (model/neural_points.py:157-174)."""
    n = int(state.count)
    point_dim = feature_dim + 3 + 4
    return n * point_dim * 4 / 1024 / 1024
