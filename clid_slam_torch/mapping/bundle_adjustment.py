"""Sliding-window bundle adjustment: joint pose and map-feature refinement
(port of clid_slam_tpu/mapping/bundle_adjustment.py).

Surface samples (``sdf_label == 0``) drawn from the replay pool are
re-expressed in the sensor frame of the pose they were built with, moved by
the window's corrected poses T(ts) = T0(ts) · exp(delta(ts)), and the mean
squared decoded SDF at them is minimized by Adam over the window's se(3)
deltas and the map's features, one autograd step an iteration.

Both backward passes that sum many samples into few rows (the features'
rows and the window's poses) go through ``ops/gather.py:gather_rows_nd``,
whose backward sums each row in a fixed order, so a run on the card
repeats bit for bit.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from ..models import decoder as dec
from ..models import neural_map as nm
from ..ops.gather import gather_rows_nd
from ..utils import lie
from .mapper import _adam_update
from .pool import ReplayPool, split_rows


def make_ba_fn(
    *,
    knn_k: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    window_size: int,
    ba_bs: int,
    lr_pose: float,
    lr_map: float,
    adam_eps: float = 1e-15,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    rotate_vecs: bool = False,
    encode_vecs=None,
):
    """Returns ``bundle_adjust(map_state, mlp, pool, poses0[W,4,4],
    window_ts0, travel_dist, cur_ts, window, iter_count, generator=None,
    draws=None) -> (map_state, new_poses[W,4,4], last_loss)``. ``draws``
    ([iter_count, ba_bs] pool rows) replaces the generator's draws."""
    offs_t = torch.as_tensor(nb_offs)
    W = window_size

    def bundle_adjust(
        map_state: nm.NeuralMapState,
        mlp: dec.MLPParams,
        pool: ReplayPool,
        poses0: torch.Tensor,
        window_ts0: int,
        travel_dist: torch.Tensor,
        cur_ts,
        window,
        iter_count: int,
        generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ):
        dev = poses0.device
        offs = offs_t.to(dev)
        hi = torch.clamp(pool.size.long(), min=1)
        deltas = torch.zeros((W, 6), device=dev)
        feats = map_state.geo_feats
        m_d, v_d = torch.zeros_like(deltas), torch.zeros_like(deltas)
        m_f, v_f = torch.zeros_like(feats), torch.zeros_like(feats)
        loss = torch.zeros((), device=dev)
        for i in range(iter_count):
            if draws is None:
                u = torch.rand(ba_bs, generator=generator, device=dev, dtype=torch.float64)
                idx = torch.minimum((u * hi).long(), hi - 1)
            else:
                idx = torch.as_tensor(draws[i], device=dev).long()
            world, lbl, _, ts, _, _ = split_rows(pool.data[idx])
            # surface endpoints within the window only
            w_idx = torch.clamp(ts - window_ts0, 0, W - 1).long()
            in_window = (ts >= window_ts0) & (idx < pool.size) & pool.valid[idx]
            sel = (in_window & (lbl == 0.0)).to(torch.float32)
            # sensor-frame coords recomputed as T0⁻¹·world (T0 = the pose
            # the sample was built with)
            T0 = poses0[w_idx]
            local = torch.sum(T0[:, :3, :3] * (world - T0[:, :3, 3])[:, :, None], dim=1)
            with torch.enable_grad():
                d = deltas.detach().requires_grad_(True)
                f = feats.detach().requires_grad_(True)
                poses = poses0 @ lie.se3_exp(d)
                T = gather_rows_nd(poses, w_idx)
                pts = torch.sum(T[:, :3, :3] * local[:, None, :], dim=-1) + T[:, :3, 3]
                q = nm.query_feature(
                    replace(map_state, geo_feats=f), pts, offs, resolution,
                    max_valid_dist2, knn_k, travel_dist, cur_ts, window, True,
                    rotate_vecs=rotate_vecs, encode_vecs=encode_vecs,
                )
                pred = dec.sdf(mlp, q.feature, sdf_scale, leaky=mlp_leaky, bf16=mlp_bf16)
                # squared SDF at measured surface points (utils/mapper.py:927)
                loss = torch.sum(pred**2 * sel) / torch.clamp(torch.sum(sel), min=1.0)
                g_d, g_f = torch.autograd.grad(loss, (d, f))
            t = float(i + 1)
            upd, m_d, v_d = _adam_update(g_d, m_d, v_d, t, lr_pose, adam_eps)
            deltas = deltas + upd
            upd, m_f, v_f = _adam_update(g_f, m_f, v_f, t, lr_map, adam_eps)
            feats = feats + upd
            loss = loss.detach()
        new_poses = poses0 @ lie.se3_exp(deltas)
        return replace(map_state, geo_feats=feats), new_poses, loss

    return bundle_adjust
