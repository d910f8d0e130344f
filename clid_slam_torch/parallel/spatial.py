"""Spatially sharded neural point map, one shard per rank of a
``torch.distributed`` process group (port of
clid_slam_tpu/parallel/spatial.py).

The global map is split into S shards, each a ``NeuralMapState`` of fixed
capacity with its own hash table; JAX's leading ``[S]`` shard axis is the
rank here, so every function below takes and returns this rank's shard.

- **Ownership by voxel hash.** A voxel belongs to shard
  ``mix(voxel_hash) % S`` (``shard_owner``), so a rank's table holds only
  the points it owns and its probe yields only its own candidates.
- **Replicated queries, local partial kNN, distance-only exchange.** Query
  points are the same on every rank. Each rank takes its own k best
  candidates; the [N,k] distances are all-gathered, every rank takes the
  same global top-k over the S·k candidates (a tie between ranks goes to
  the lower rank), and the winners' payload (position, features,
  certainty) is combined by one masked ``psum`` of [N,k,3+F+1] whose slots
  are disjoint.
- **Feature gathers and scatters stay on the rank.** The loss consumes the
  combined features, so the gradient reaches each rank's slab through its
  own masked gather; certainty scatters go to each rank's own winners.

A shard's hash-mirror probe and feature rows go through ``gather_rows``
(``ops/gather.py:gather_rows_nd``, whose backward sums in a fixed order)
and its k-best selection through ``gather_lanes``, as ``query_feature``'s
do. The mapping loop is torch autograd (the JAX package's is XLA, with no
Pallas kernel). The collectives are ``parallel/collectives.py``'s: sums in
rank order, backward as JAX's transposes under ``check_vma=False``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..mapping import mapper as mp
from ..mapping.pool import ReplayPool, sample_batch_indices, split_rows
from ..models import decoder as dec
from ..models import neural_map as nm
from ..ops import gather as gt
from ..ops.voxel import _M32, _murmur_mix, _prime_sum, grid_coords
from .collectives import Mesh, all_gather, make_group_mesh, pmax, psum, psum_all, psum_scatter


def make_spatial_mesh(n_devices: Optional[int] = None, group=None) -> Mesh:
    """This rank's ``(group, rank, size)`` over the shard axis."""
    return make_group_mesh(n_devices, group)


def shard_owner(points: torch.Tensor, resolution, n_shards: int) -> torch.Tensor:
    """[N,3] world points -> [N] int32 owner shard of each point's voxel:
    the prime sum of the voxel coordinates plus 0x9E3779B9, murmur-mixed,
    mod S, all in uint32 arithmetic (carried in int64 masked to 32 bits, so
    negative coordinates wrap as JAX's ``astype(uint32)``)."""
    base = _prime_sum(grid_coords(points, resolution))
    h = _murmur_mix((base + 0x9E3779B9) & _M32)
    return (h % n_shards).to(torch.int32)


def init_sharded_map(
    mesh: Mesh,
    capacity_per_shard: int,
    hash_size_per_shard: int,
    feature_dim: int,
    color_feature_dim: int = 1,
    device=None,
) -> nm.NeuralMapState:
    """This rank's empty shard (on the card unless ``device="cpu"``)."""
    del mesh  # every shard starts the same
    return nm.init_map(
        capacity_per_shard, hash_size_per_shard, feature_dim, color_feature_dim,
        device=resolve_device(device),
    )


class SpatialQueryResult(NamedTuple):
    feature: torch.Tensor  # [N, F+P] replicated
    weights: torch.Tensor  # [N, k] replicated
    knn_idx: torch.Tensor  # [N, k] this rank's local rows (-1 where not its winner)
    nn_count: torch.Tensor  # [N] replicated
    certainty: torch.Tensor  # [N] replicated


_FAR = 9e3


def collective_bytes_per_query(n_cells: int, knn_k: int, feature_dim: int):
    """Per-query collective payload bytes: (the full-candidate combine, the
    partial-kNN combine this module runs)."""
    old = (n_cells * 4 + 2 * n_cells + knn_k * (feature_dim + 1)) * 4
    new = (knn_k + knn_k * (3 + feature_dim + 1)) * 4
    return old, new


def _partial_knn(
    st: nm.NeuralMapState,
    points: torch.Tensor,
    k: int,
    *,
    nb_offs,
    resolution,
    max_valid_dist2,
    travel_dist,
    cur_ts,
    window,
    time_filtering,
):
    """This shard's k best candidates over the cells it owns. Returns (kd2
    [N,k] with ``_FAR`` where invalid, h_sel [N,k] local buckets, n_valid
    [N] local candidate count)."""
    d2, h, valid, _ = nm.neighborhood_probe(
        st, points, nb_offs, resolution, max_valid_dist2, travel_dist, cur_ts, window,
        time_filtering,
    )
    d2m = torch.where(valid, d2, torch.full_like(d2, _FAR))
    sel = nm.smallest_k(d2m, k)
    h_sel = gt.gather_lanes(h, sel)
    # the same bucket can surface through two probed cells
    kvalid = gt.gather_lanes(valid, sel) & ~nm.dedupe_mask(h_sel)
    kd2 = torch.where(kvalid, gt.gather_lanes(d2m, sel), torch.full_like(d2m[:, :k], _FAR))
    return kd2, h_sel, torch.sum(valid.to(torch.int32), dim=-1)


class _Winners(NamedTuple):
    knn_d2: torch.Tensor  # [N,k] replicated
    valid: torch.Tensor  # [N,k] replicated
    mine: torch.Tensor  # [N,k] this rank's winners
    knn_idx: torch.Tensor  # [N,k] local rows of those, -1 elsewhere
    safe: torch.Tensor  # [N,k] local rows, the sentinel row elsewhere


def _global_top_k(st, kd2, h_sel, k: int, mesh: Mesh) -> _Winners:
    """The replicated global top-k over the S·k all-gathered candidates, in
    JAX's layout ([N, S·k], shard-major within a row, so a tie between
    shards goes to the lower rank), and this rank's claims on it."""
    n = kd2.shape[0]
    flat = all_gather(kd2, mesh).transpose(0, 1).reshape(n, mesh.size * k)
    selg = nm.smallest_k(flat, k)
    knn_d2 = gt.gather_lanes(flat, selg)
    valid = knn_d2 < _FAR
    mine = valid & (torch.div(selg, k, rounding_mode="floor") == mesh.rank)
    slot = torch.where(mine, selg % k, torch.zeros_like(selg))
    idx_local = st.hash_table[gt.gather_lanes(h_sel, slot)].to(torch.int64)
    mine = mine & (idx_local >= 0)
    cap = nm.map_capacity(st)
    return _Winners(
        knn_d2, valid, mine, torch.where(mine, idx_local, torch.full_like(idx_local, -1)),
        torch.where(mine, idx_local, torch.full_like(idx_local, cap)),
    )


def _masked_rows(slab: torch.Tensor, win: _Winners) -> torch.Tensor:
    """This rank's winners' rows of ``slab`` ([N,k,...]), zero elsewhere."""
    rows = gt.gather_rows_nd(slab, win.safe)
    mask = win.mine.reshape(win.mine.shape + (1,) * (rows.dim() - 2))
    return torch.where(mask, rows, torch.zeros_like(rows))


def _payload(st: nm.NeuralMapState, win: _Winners) -> torch.Tensor:
    """[N,k,3+F+1]: position, features and certainty of this rank's winners."""
    cert = torch.where(win.mine, st.certainty[win.safe], torch.zeros_like(win.knn_d2))
    return torch.cat(
        [_masked_rows(st.positions, win), _masked_rows(st.geo_feats, win), cert[..., None]], -1
    )


def _relative(points, nb_pos, valid, encode_vecs):
    vecs = points[:, None, :] - nb_pos
    if encode_vecs is not None:
        vecs = encode_vecs(vecs)
    return torch.where(valid[..., None], vecs, torch.zeros_like(vecs))


def _combined_query(
    st: nm.NeuralMapState,
    points: torch.Tensor,
    *,
    mesh: Mesh,
    nb_offs,
    resolution,
    max_valid_dist2,
    knn_k: int,
    travel_dist=None,
    cur_ts=0,
    window=1e9,
    time_filtering: bool = False,
    encode_vecs=None,
) -> SpatialQueryResult:
    """``neural_map.query_feature``'s semantics over the union of every
    rank's points; differentiable wrt ``st.geo_feats`` (this rank's)."""
    kd2, h_sel, n_local = _partial_knn(
        st, points, knn_k, nb_offs=nb_offs, resolution=resolution,
        max_valid_dist2=max_valid_dist2, travel_dist=travel_dist, cur_ts=cur_ts,
        window=window, time_filtering=time_filtering,
    )
    win = _global_top_k(st, kd2, h_sel, knn_k, mesh)
    nn_count = psum(n_local, mesh)
    payload = psum(_payload(st, win), mesh)  # [N,k,3+F+1], the one combine
    vecs = _relative(points, payload[..., :3], win.valid, encode_vecs)
    w = nm.idw_weights(win.knn_d2, win.valid, nn_count)
    certainty_q = torch.sum(payload[..., -1] * w, dim=1)
    feat_vec = torch.cat([payload[..., 3:-1], vecs], dim=-1)
    feature = torch.sum(feat_vec * w[..., None], dim=1)
    return SpatialQueryResult(feature, w, win.knn_idx, nn_count, certainty_q)


def _combined_query_chunked(
    st: nm.NeuralMapState,
    points: torch.Tensor,  # [N,3], the same on every rank
    *,
    mesh: Mesh,
    nb_offs,
    resolution,
    max_valid_dist2,
    knn_k: int,
    travel_dist=None,
    cur_ts=0,
    window=1e9,
    time_filtering: bool = False,
    encode_vecs=None,
):
    """``_combined_query`` with batch-sharded outputs: the winners' payload
    is reduce-scattered over the batch, so each rank holds the features of
    its N/S chunk only. ``psum_scatter``'s transpose is ``all_gather``, so
    every chunk's feature cotangent reaches every owning rank's slab.

    Returns (feature_chunk [N/S, F+P], w_chunk [N/S,k], nn_count_chunk,
    certainty_chunk, knn_idx [N,k] this rank's winners over the whole
    batch, w_full [N,k]) -- the whole batch's winners and weights feed the
    local certainty scatter."""
    n = points.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} query points do not split over {mesh.size} ranks")
    chunk = n // mesh.size
    kd2, h_sel, n_local = _partial_knn(
        st, points, knn_k, nb_offs=nb_offs, resolution=resolution,
        max_valid_dist2=max_valid_dist2, travel_dist=travel_dist, cur_ts=cur_ts,
        window=window, time_filtering=time_filtering,
    )
    win = _global_top_k(st, kd2, h_sel, knn_k, mesh)
    nn_count = psum(n_local, mesh)
    payload_c = psum_scatter(_payload(st, win), mesh)  # [N/S,k,3+F+1]
    sl = slice(mesh.rank * chunk, (mesh.rank + 1) * chunk)
    valid_c, nnc_c = win.valid[sl], nn_count[sl]
    vecs = _relative(points[sl], payload_c[..., :3], valid_c, encode_vecs)
    w = nm.idw_weights(win.knn_d2[sl], valid_c, nnc_c)
    wf = nm.idw_weights(win.knn_d2, win.valid, nn_count)
    certainty_q = torch.sum(payload_c[..., -1] * w, dim=1)
    feat_vec = torch.cat([payload_c[..., 3:-1], vecs], dim=-1)
    feature = torch.sum(feat_vec * w[..., None], dim=1)
    return feature, w, nnc_c, certainty_q, win.knn_idx, wf


def _mlp_of(like: dec.MLPParams, leaves) -> dec.MLPParams:
    nh = len(like.weights)
    return dec.MLPParams(list(leaves[:nh]), list(leaves[nh : 2 * nh]), leaves[2 * nh],
                         leaves[2 * nh + 1])


def summed(mesh: Mesh, features: bool):
    """``adam_loop``'s ``reduce_grads``: the MLP gradients (and, with
    ``features``, the feature slab's) summed over ranks in one collective."""

    def reduce(g_feats, g_mlp):
        if features:
            g_feats, *g_mlp = psum_all([g_feats] + g_mlp, mesh)
            return g_feats, g_mlp
        return g_feats, psum_all(g_mlp, mesh)

    return reduce


def adam_loop(loss_step, feats, mlp, n_iters, lr, mlp_lr, adam_eps, reduce_grads=None):
    """``n_iters`` autograd Adam steps (moments from zero) on the whole
    feature slab ``feats`` and the MLP's leaves. ``loss_step(i, feats,
    mlp)`` returns (loss, sdf_loss, eik_loss); ``reduce_grads(g_feats,
    g_mlp)``, a collective, runs before the update when given. Returns
    (feats, mlp, losses [2] of the last step, zeros after no step)."""
    leaves = [p.detach() for p in mlp.tensors()]
    fm, fv = torch.zeros_like(feats), torch.zeros_like(feats)
    mm, mv = [torch.zeros_like(p) for p in leaves], [torch.zeros_like(p) for p in leaves]
    losses = torch.zeros(2, device=feats.device)
    feats = feats.detach()
    for i in range(n_iters):
        with torch.enable_grad():
            f = feats.requires_grad_(True)
            ps = [p.requires_grad_(True) for p in leaves]
            loss, sdf_l, eik_l = loss_step(i, f, _mlp_of(mlp, ps))
            grads = torch.autograd.grad(loss, [f] + ps)
        g_feats, g_mlp = grads[0], list(grads[1:])
        if reduce_grads is not None:
            g_feats, g_mlp = reduce_grads(g_feats, g_mlp)
        t = float(i + 1)
        upd, fm, fv = mp._adam_update(g_feats, fm, fv, t, lr, adam_eps)
        feats = feats.detach() + upd
        new = []
        for j, (p, g) in enumerate(zip(leaves, g_mlp)):
            u, mm[j], mv[j] = mp._adam_update(g, mm[j], mv[j], t, mlp_lr, adam_eps)
            new.append(p.detach() + u)
        leaves = new
        losses = torch.stack([sdf_l.detach(), eik_l.detach()])
    return feats.detach(), _mlp_of(mlp, leaves), losses


def _eikonal_g(t0, t1, t2, t3, t4, t5, num_grad_eps):
    g = torch.stack([t0 - t1, t2 - t3, t4 - t5], dim=-1) / (2 * num_grad_eps)
    return torch.sqrt(torch.sum(g * g, dim=-1) + 1e-20)


def make_spatial_fns(
    mesh: Mesh,
    *,
    feature_dim: int,
    knn_k: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    sigma: float,
    bs: int,
    bs_new: int,
    gradient_decimation: int,
    num_grad_eps: float,
    weight_e: float,
    loss_weight_on: bool,
    lr: float,
    adam_eps: float = 1e-15,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    encode_vecs=None,
    loss_type: str = "bce",
    batch_shard="cached",
):
    """Build (insert_fn, query_fn, mapping_fn) over the mesh's ranks.

    insert_fn(state, points, mask, travel, cur_ts, window) -> (state,
        new_ratio): this rank claims the points whose voxels it owns; the
        ratio's count is a ``psum``.
    query_fn(state, points, travel, cur_ts, window) -> SpatialQueryResult
        with this rank's [N,k] local ``knn_idx`` (JAX stacks them [S,N,k]).
    mapping_fn(state, mlp, pool, travel, cur_ts, window, iter_count,
        mlp_lr_scale, generator=None, batch_draws=None) -> (state, mlp,
        losses): the Adam loop with every map access through the combined
        query; feature updates and certainty scatters stay on the rank.
        The replay batch is drawn from ``generator`` (seeded the same on
        every rank) or given: ``batch_draws`` holds one (idx_hist, pick)
        pair per batch (``pool.sample_batch_indices``), one for the cached
        body and one an iteration for the others.

    ``batch_shard`` picks the mapping body, as in JAX: ``"cached"`` (one
    collective probe a call, then a ``psum_scatter`` of the [bs,k,F]
    payload an Adam step, the MLP and losses on this rank's bs/S chunk),
    ``True``/``"uncached"`` (the chunked math with a probe every step) or
    ``False`` (the replicated batch), which also serves when bs % S != 0.
    """
    S = mesh.size
    q_kw = dict(mesh=mesh, nb_offs=nb_offs, resolution=resolution,
                max_valid_dist2=max_valid_dist2, knn_k=knn_k, encode_vecs=encode_vecs)
    dkw = dict(leaky=mlp_leaky, bf16=mlp_bf16)
    loss_kw = dict(loss_type=loss_type, sigma=sigma, loss_weight_on=loss_weight_on)
    dstep = gradient_decimation
    bd = max(1, bs // dstep)
    if batch_shard and bs % S != 0:
        batch_shard = False  # chunking needs bs divisible by S
    bd_pad = ((bd + S - 1) // S) * S  # whole samples (6 taps each) per chunk
    chunk = max(1, bs // S)
    start = mesh.rank * chunk
    sum_mlp = summed(mesh, features=False)

    def offsets(dev):
        return torch.as_tensor(nb_offs, device=dev)

    def insert_fn(state, points, mask, travel, cur_ts, window):
        own = shard_owner(points, resolution, S) == mesh.rank
        st2, _ = nm.insert_points(state, points, mask & own, resolution, travel, cur_ts, window)
        n_new = psum((st2.count - state.count).reshape(1), mesh)[0]
        n_in = torch.sum(mask.to(torch.int32))
        return st2, n_new / torch.clamp(n_in, min=1)

    def query_fn(state, points, travel, cur_ts, window):
        kw = dict(q_kw, nb_offs=offsets(points.device))
        return _combined_query(state, points, travel_dist=travel, cur_ts=cur_ts, window=window,
                               **kw)

    def batch_of(pool: ReplayPool, generator, draws):
        idx = sample_batch_indices(pool, bs, bs_new, generator, draws)
        bvalid = (pool.valid[idx] & (idx < pool.size)).to(torch.float32)
        coord, label, weight, ts, _, _ = split_rows(pool.data[idx])
        return coord, label, weight, ts, bvalid

    def draws_at(batch_draws, i):
        return None if batch_draws is None else batch_draws[i]

    def body_cached_chunked(st0, mlp, pool, travel, cur_ts, window, n_iters, mlp_lr,
                            generator, batch_draws):
        """One collective probe and top-k merge a call freeze the batch's
        query geometry; every Adam step then exchanges only the [bs,k,F]
        feature payload (one ``psum_scatter``) and runs the MLP and losses
        on this rank's chunk."""
        dev = st0.positions.device
        bd_local = max(1, chunk // dstep)
        coord_b, sdf_b, w_b, ts_b, bvalid = batch_of(pool, generator, draws_at(batch_draws, 0))
        kd2, h_sel, n_local = _partial_knn(
            st0, coord_b, knn_k, nb_offs=offsets(dev), resolution=resolution,
            max_valid_dist2=max_valid_dist2, travel_dist=travel, cur_ts=cur_ts, window=window,
            time_filtering=False,
        )
        win = _global_top_k(st0, kd2, h_sel, knn_k, mesh)
        nn_count = psum(n_local, mesh)
        pos_c = psum_scatter(_masked_rows(st0.positions, win), mesh)  # [chunk,k,3]
        sl = slice(start, start + chunk)
        valid_c = win.valid[sl]
        lbl_c, wgt_c, bv_c = sdf_b[sl], w_b[sl], bvalid[sl]
        vec0 = coord_b[sl][:, None, :] - pos_c
        enc0 = _relative(coord_b[sl], pos_c, valid_c, encode_vecs)
        w_c = nm.idw_weights(win.knn_d2[sl], valid_c, nn_count[sl])
        encw0 = torch.sum(enc0 * w_c[..., None], dim=1)
        wf = nm.idw_weights(win.knn_d2, win.valid, nn_count)

        # tap geometry on the chunk's decimated samples, reusing the
        # centre sample's kNN (the single-device cached mapper's rule)
        vd = bv_c[::dstep][:bd_local]
        vec_d = vec0[::dstep][:bd_local]
        valid_d = valid_c[::dstep][:bd_local]
        eps3 = torch.eye(3, device=dev) * num_grad_eps
        tap_vec = vec_d[None] + torch.cat([eps3, -eps3], 0)[:, None, None, :]  # [6,bd,k,3]
        tap_d2 = torch.sum(tap_vec * tap_vec, dim=-1)
        tap_valid = valid_d[None] & (tap_d2 <= max_valid_dist2)
        w_tap = nm.idw_weights(tap_d2, tap_valid, torch.sum(tap_valid.to(torch.int32), dim=-1))
        enc_tap = encode_vecs(tap_vec) if encode_vecs is not None else tap_vec
        enc_tap = torch.where(tap_valid[..., None], enc_tap, torch.zeros_like(enc_tap))
        enc_tapw = torch.sum(enc_tap * w_tap[..., None], dim=2)

        sdf_loss_of = mp.make_sdf_loss(lbl_c, wgt_c, bv_c, **loss_kw)
        den_c = torch.sum(bv_c)
        den_tot, vd_tot = torch.clamp(psum(torch.stack([den_c, torch.sum(vd)]), mesh), min=1.0)

        def loss_step(i, feats, mlp_p):
            pay = psum_scatter(_masked_rows(feats, win), mesh)  # [chunk,k,F]
            fw = torch.sum(pay * w_c[..., None], dim=1)
            pred = dec.sdf(mlp_p, torch.cat([fw, encw0], -1), sdf_scale, **dkw)
            sdf_loss = psum(sdf_loss_of(pred) * den_c, mesh) / den_tot
            fw_tap = torch.sum(pay[::dstep][:bd_local][None] * w_tap[..., None], dim=2)
            tp = dec.sdf(mlp_p, torch.cat([fw_tap, enc_tapw], -1), sdf_scale, **dkw)  # [6,bd]
            gn = _eikonal_g(tp[0], tp[3], tp[1], tp[4], tp[2], tp[5], num_grad_eps)
            eik = psum(torch.sum(((gn - 1.0) ** 2) * vd), mesh) / vd_tot
            return sdf_loss + weight_e * eik, sdf_loss, eik

        feats, mlp_out, losses = adam_loop(loss_step, st0.geo_feats, mlp, n_iters, lr, mlp_lr,
                                           adam_eps, sum_mlp)
        # certainty once, scaled by the step count (the cached single-device
        # mapper's rule); the taps' weights are all-gathered so that every
        # rank addresses the whole batch's decimated rows, chunk by chunk
        itf = float(max(n_iters, 0))
        st = nm.accumulate_certainty(st0._replace(geo_feats=feats), win.knn_idx, wf * itf, ts_b)
        tap_rows = torch.as_tensor(np.concatenate(
            [c * chunk + np.arange(bd_local) * dstep for c in range(S)]), device=dev)
        w_tap_full = all_gather(torch.sum(w_tap, dim=0), mesh).reshape(S * bd_local, knn_k)
        st = nm.accumulate_certainty(st, win.knn_idx[tap_rows], w_tap_full * itf, None)
        return st, mlp_out, losses

    def per_batch_body(query_loss, sum_mlp_grads):
        """The bodies that draw a batch and query the map every step;
        ``query_loss(st, mlp, batch, where)`` returns (loss, sdf, eik,
        (knn_idx, w, tap_idx, tap_w)), from which certainty accumulates
        each step. ``sum_mlp_grads``: the MLP gradients are per-chunk
        partials, summed over ranks before the update."""

        def body(st0, mlp, pool, travel, cur_ts, window, n_iters, mlp_lr, generator,
                 batch_draws):
            carry = {"st": st0}

            def loss_step(i, feats, mlp_p):
                coord, label, weight, ts, bvalid = batch_of(pool, generator,
                                                            draws_at(batch_draws, i))
                st = carry["st"]
                loss, sdf_l, eik_l, aux = query_loss(
                    st._replace(geo_feats=feats), mlp_p, (coord, label, weight, bvalid),
                    (travel, cur_ts, window))
                knn_idx, w_knn, tap_idx, tap_w = (a.detach() for a in aux)
                st = nm.accumulate_certainty(st, knn_idx, w_knn, ts)
                carry["st"] = nm.accumulate_certainty(st, tap_idx, tap_w, None)
                return loss, sdf_l, eik_l

            feats, mlp_out, losses = adam_loop(
                loss_step, st0.geo_feats, mlp, n_iters, lr, mlp_lr, adam_eps,
                sum_mlp if sum_mlp_grads else None)
            return carry["st"]._replace(geo_feats=feats), mlp_out, losses

        return body

    def sharded_batch_loss(st, mlp_p, batch, where):
        """The batch is the same on every rank, the probe and merge are
        collective, and each rank runs the MLP and losses on its chunk."""
        coord, label, weight, bvalid = batch
        travel, cur_ts, window = where
        kw = dict(q_kw, nb_offs=offsets(coord.device), travel_dist=travel, cur_ts=cur_ts,
                  window=window)
        feat, _, _, _, knn_idx, wf = _combined_query_chunked(st, coord, **kw)
        pred_c = dec.sdf(mlp_p, feat, sdf_scale, **dkw)
        sl = slice(start, start + chunk)
        bv_c = bvalid[sl]
        den_c = torch.clamp(torch.sum(bv_c), min=0.0)
        loss_c = mp.make_sdf_loss(label[sl], weight[sl], bv_c, **loss_kw)(pred_c)
        sdf_loss = psum(loss_c * den_c, mesh) / torch.clamp(psum(den_c, mesh), min=1.0)
        # the eikonal taps sample-major [bd_pad, 6], so chunks hold whole samples
        pad = bd_pad - bd
        xd = torch.cat([coord[::dstep][:bd], coord.new_zeros((pad, 3))])
        vd = torch.cat([bvalid[::dstep][:bd], bvalid.new_zeros(pad)])
        eps3 = torch.eye(3, device=coord.device) * num_grad_eps
        taps = (xd[:, None, :] + torch.cat([eps3, -eps3], 0)[None]).reshape(bd_pad * 6, 3)
        tap_feat, _, _, _, tap_idx, tap_wf = _combined_query_chunked(st, taps, **kw)
        t6 = dec.sdf(mlp_p, tap_feat, sdf_scale, **dkw).reshape(bd_pad // S, 6)
        n_c = bd_pad // S
        vd_c = vd[mesh.rank * n_c : (mesh.rank + 1) * n_c]
        gn = _eikonal_g(t6[:, 0], t6[:, 3], t6[:, 1], t6[:, 4], t6[:, 2], t6[:, 5], num_grad_eps)
        eik = psum(torch.sum(((gn - 1.0) ** 2) * vd_c), mesh) / torch.clamp(
            psum(torch.sum(vd_c), mesh), min=1.0)
        return sdf_loss + weight_e * eik, sdf_loss, eik, (knn_idx, wf, tap_idx, tap_wf)

    def replicated_loss(st, mlp_p, batch, where):
        """The whole batch on every rank through the combined query."""
        coord, label, weight, bvalid = batch
        travel, cur_ts, window = where
        kw = dict(q_kw, nb_offs=offsets(coord.device), travel_dist=travel, cur_ts=cur_ts,
                  window=window)
        q = _combined_query(st, coord, **kw)
        sdf_loss = mp.make_sdf_loss(label, weight, bvalid, **loss_kw)(
            dec.sdf(mlp_p, q.feature, sdf_scale, **dkw))
        xd, vd = coord[::dstep][:bd], bvalid[::dstep][:bd]
        eps3 = torch.eye(3, device=coord.device) * num_grad_eps
        taps = torch.cat([xd + eps3[0], xd - eps3[0], xd + eps3[1], xd - eps3[1],
                          xd + eps3[2], xd - eps3[2]], 0)
        q_tap = _combined_query(st, taps, **kw)
        t = dec.sdf(mlp_p, q_tap.feature, sdf_scale, **dkw).reshape(6, bd)
        gn = _eikonal_g(t[0], t[1], t[2], t[3], t[4], t[5], num_grad_eps)
        eik = torch.sum(((gn - 1.0) ** 2) * vd) / torch.clamp(torch.sum(vd), min=1.0)
        return (sdf_loss + weight_e * eik, sdf_loss, eik,
                (q.knn_idx, q.weights, q_tap.knn_idx, q_tap.weights))

    if batch_shard == "cached":
        body = body_cached_chunked
    elif batch_shard:
        body = per_batch_body(sharded_batch_loss, True)
    else:
        body = per_batch_body(replicated_loss, False)

    def mapping_fn(state, mlp, pool, travel, cur_ts, window, iter_count, mlp_lr_scale,
                   generator: Optional[torch.Generator] = None, batch_draws=None):
        dev = state.positions.device
        mlp_lr = lr * torch.as_tensor(mlp_lr_scale, device=dev, dtype=torch.float32)
        return body(state, mlp, pool, travel, cur_ts, window, int(iter_count), mlp_lr,
                    generator, batch_draws)

    return insert_fn, query_fn, mapping_fn


def make_sharded_tracker_fn(
    mesh: Mesh,
    cached_body,  # iekf.make_cached_update_fn(...) result
    *,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    layer_norm: bool = False,
):
    """Candidate-cached IESEKF update over the sharded map: one collective
    candidate build a frame (the partial-kNN exchange at ``n_cand`` width),
    then ``cached_body.dense_update``'s iterations on every rank with no
    further collective, so every rank's result is the same bit for bit.

    update(state, mlp, points_imu[S,3], mask, rot0, pos0, rest0, P, travel,
           cur_ts, window) -> (rot, pos, rest, P, ok, n_iter)
    """
    C = cached_body.n_cand
    dense_update = cached_body.dense_update

    def update(state, mlp, points_imu, mask, rot0, pos0, rest0, Pm, travel, cur_ts, window):
        pc0 = points_imu @ rot0.T + pos0
        kd2, h_sel, _ = _partial_knn(
            state, pc0, C, nb_offs=torch.as_tensor(nb_offs, device=pc0.device),
            resolution=resolution, max_valid_dist2=max_valid_dist2, travel_dist=travel,
            cur_ts=cur_ts, window=window, time_filtering=True,
        )
        win = _global_top_k(state, kd2, h_sel, C, mesh)
        feats = gt.gather_rows_nd(state.geo_feats, win.safe)
        if layer_norm:
            feats = nm.layer_norm_feats(feats)
        feats = torch.where(win.mine[..., None], feats, torch.zeros_like(feats))
        ok_ch = win.mine[..., None].to(torch.float32)
        payload = psum(torch.cat([_masked_rows(state.positions, win), feats, ok_ch], -1), mesh)
        return dense_update(
            (payload[..., :3], payload[..., 3:-1], payload[..., -1] > 0.5, None), mlp,
            points_imu, mask, rot0, pos0, rest0, Pm,
        )

    return update


def make_sharded_certainty_fn(mesh: Mesh, *, resolution: float, max_valid_dist2: float):
    """``query_certainty_max`` over the union of the shards (novelty
    gating): each rank's maximum, then the maximum over ranks."""

    def certainty(state, points):
        return pmax(nm.query_certainty_max(state, points, resolution, max_valid_dist2), mesh)

    return certainty


def total_count(state: nm.NeuralMapState, mesh: Mesh) -> int:
    """Live points over every shard."""
    return int(psum(state.count.reshape(1), mesh)[0])
