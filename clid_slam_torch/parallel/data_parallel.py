"""Data-parallel mapping over the ranks of a ``torch.distributed`` process
group (port of clid_slam_tpu/parallel/data_parallel.py).

The map and the MLP are replicated on every rank; the replay batch is
split over the ranks. Each rank queries and decodes its bs/S rows of the
batch and the decimated eikonal taps that fall in them. The loss's
numerators and denominators are summed over ranks, the feature and MLP
gradients are summed in rank order before the replicated Adam step, and
certainty accumulates from every rank's winners. This is the single-device
math, as in JAX (where the partitioner inserts the all-reduce): the
result at S ranks equals the one at 1 rank up to the order of float sums.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..mapping.pool import ReplayPool, sample_batch_indices, split_rows
from ..models import decoder as dec
from ..models import neural_map as nm
from .collectives import Mesh, make_group_mesh, pmax, psum
from .spatial import adam_loop, summed


def make_mesh(n_devices: Optional[int] = None, group=None) -> Mesh:
    """This rank's ``(group, rank, size)`` over the data-parallel axis."""
    return make_group_mesh(n_devices, group)


def make_dp_mapping_fn(
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
    adam_eps: float,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    encode_vecs=None,
):
    """Returns ``mapping(map_state, mlp, pool, travel_dist, cur_ts, window,
    iter_count, mlp_lr_scale, generator=None, batch_draws=None) ->
    (map_state, mlp, losses[2])``: ``mapper.make_mapping_fn``'s re-querying
    loop with the batch split over the ranks. Every rank must pass the same
    batch: ``batch_draws`` holds one (idx_hist, pick) pair an iteration
    (``pool.sample_batch_indices``), else ``generator`` (seeded the same on
    every rank) draws them."""
    S = mesh.size
    if bs % S:
        raise ValueError(f"the batch ({bs}) must divide over the {S} ranks")
    del feature_dim  # the slab's width
    dstep = gradient_decimation
    bd = max(1, bs // dstep)
    chunk = bs // S
    start = mesh.rank * chunk
    # the decimated tap rows (every dstep-th of the first bd) in this chunk
    taps_here = np.arange(bd) * dstep
    taps_here = taps_here[(taps_here >= start) & (taps_here < start + chunk)] - start
    dkw = dict(leaky=mlp_leaky, bf16=mlp_bf16)

    def query_sdf(st, feats, mlp, pts, travel, cur_ts, window):
        q = nm.query_feature(
            st._replace(geo_feats=feats), pts, torch.as_tensor(nb_offs, device=pts.device),
            resolution, max_valid_dist2, knn_k, travel, cur_ts, window, True,
            encode_vecs=encode_vecs,
        )
        return dec.sdf(mlp, q.feature, sdf_scale, **dkw), q

    def mapping(map_state: nm.NeuralMapState, mlp: dec.MLPParams, pool: ReplayPool,
                travel_dist, cur_ts, window, iter_count, mlp_lr_scale,
                generator: Optional[torch.Generator] = None, batch_draws=None):
        dev = map_state.positions.device
        mlp_lr = lr * torch.as_tensor(mlp_lr_scale, device=dev, dtype=torch.float32)
        tap_rows = torch.as_tensor(taps_here, device=dev)
        eps3 = torch.eye(3, device=dev) * num_grad_eps
        carry = {"st": map_state}

        def loss_step(i, feats, mlp_p):
            draws = None if batch_draws is None else batch_draws[i]
            idx = sample_batch_indices(pool, bs, bs_new, generator, draws)[start : start + chunk]
            bvalid = (pool.valid[idx] & (idx < pool.size)).to(torch.float32)
            coord, label, weight, ts, _, _ = split_rows(pool.data[idx])
            xd, vd = coord[tap_rows], bvalid[tap_rows]
            den, vd_den = torch.clamp(psum(torch.stack([torch.sum(bvalid), torch.sum(vd)]), mesh),
                                      min=1.0)
            st = carry["st"]
            pred, q = query_sdf(st, feats, mlp_p, coord, travel_dist, cur_ts, window)
            target = torch.sigmoid(label / sigma)
            z = pred / sigma  # optax's sigmoid_binary_cross_entropy
            bce = -target * F.logsigmoid(z) - (1.0 - target) * F.logsigmoid(-z)
            w_sdf = torch.abs(weight) * bvalid if loss_weight_on else bvalid
            sdf_num = torch.sum(w_sdf * bce)
            taps = torch.cat([xd + eps3[0], xd - eps3[0], xd + eps3[1], xd - eps3[1],
                              xd + eps3[2], xd - eps3[2]], 0)
            t, q_tap = query_sdf(st, feats, mlp_p, taps, travel_dist, cur_ts, window)
            t = t.reshape(6, -1)
            g = torch.stack([t[0] - t[1], t[2] - t[3], t[4] - t[5]], -1) / (2 * num_grad_eps)
            gn = torch.sqrt(torch.sum(g * g, dim=-1) + 1e-20)
            eik_num = torch.sum(((gn - 1.0) ** 2) * vd)
            # certainty from every rank's winners: this rank's increments,
            # summed over ranks in order; the update stamps by their maximum
            inc = st._replace(certainty=torch.zeros_like(st.certainty))
            inc = nm.accumulate_certainty(inc, q.knn_idx, q.weights.detach(), ts)
            inc = nm.accumulate_certainty(inc, q_tap.knn_idx, q_tap.weights.detach(), None)
            carry["st"] = st._replace(certainty=st.certainty + psum(inc.certainty, mesh),
                                      ts_update=pmax(inc.ts_update, mesh))
            nums = psum(torch.stack([sdf_num, eik_num]).detach(), mesh)
            # this rank's share of the whole batch's loss
            return sdf_num / den + weight_e * eik_num / vd_den, nums[0] / den, nums[1] / vd_den

        feats, mlp_out, losses = adam_loop(loss_step, map_state.geo_feats, mlp, int(iter_count),
                                           lr, mlp_lr, adam_eps, summed(mesh, features=True))
        return carry["st"]._replace(geo_feats=feats), mlp_out, losses

    return mapping


def shard_batch_pipeline(mesh: Mesh, arrays):
    """This rank's rows of each per-sample array (the leading axis split
    over the ranks in order)."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
        c = n // mesh.size
        out.append(a[mesh.rank * c : (mesh.rank + 1) * c])
    return out
