"""Streaming SLAM over a sharded neural map (port of
clid_slam_tpu/pipeline/streaming_sharded.py).

``StreamingSlam``'s device-resident state and host surface (``seed_pose``,
``precompile``, ``process_frame``, ``block``, ``sync``, checkpoints) with
the map split over the ranks of a ``torch.distributed`` process group, one
shard a rank (``parallel/spatial.py``). Only the map carries a shard; the filter, the
odometry bookkeeping, the local label map, the sampler, the replay pool and
the decoder are replicated, so every rank draws the same numbers in the
same order from its generator and holds the same values.

One frame: IMU propagation, the voxel masks and ``track_max_range``, the
sharded tracker (one collective candidate build, then the replicated
iterated update), the lose-track and stop bookkeeping, the replicated
local map and sampler, the sharded insert and certainty, the pool's window
filter and append, the adaptive iteration offset and the sharded mapping
body (cached on tracked frames, uncached on frame 0). As in the JAX step,
per-point timestamps are not used (no deskew) and the color and semantic
decoders pass through untouched. The frame step makes these host reads:
the tracker's exit flag an iteration and the mapping body's step count.

The JAX package's BA and prune cadences fail on a sharded map, so the
constructor refuses ``ba_freq_frame > 0`` and ``prune_map_on``; its
sharded step has no dynamic filter, so ``dynamic_filter_on`` is not run
here either (a warning says so). ``precompile()``, ``sync()`` and
``neural_point_count()`` are collectives, and ``save_checkpoint`` is one
too: every rank calls them together. A checkpoint is one npz in the JAX
package's sharded layout (map leaves stacked ``[S, ...]``), written by
rank 0; on load each rank takes its own shard.
"""

from __future__ import annotations

import warnings
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..device import resolve_device
from ..mapping import pool as pl
from ..models import local_map as lm
from ..ops.voxel import voxel_down_sample_mask
from ..parallel import spatial as sp
from ..parallel.slam_sharded import (init_shard, is_new_samples, make_driver_mesh,
                                     make_sharded_stages)
from ..utils.transforms import crop_mask, transform_points
from . import streaming as stream
from .streaming import (StreamState, _orthonormalize, _pose, adaptive_iters, predict_imu,
                        source_indices, track_bookkeeping)


def make_sharded_frame_step(cfg: Config, mesh, nb_offs, encode_vecs, map_log=None):
    """The four sharded frame-step variants keyed by (track,
    filter_pool_now), with ``make_frame_step``'s call and return:
    step(state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
    crop_max_range, iters_base, mlp_lr_scale, allow_restart, draws=None) ->
    (state, insert_dropped, None); the sharded insert does not count
    dropped candidates, so ``insert_dropped`` is 0. ``map_log``, a list,
    gets (frame_id, mapping steps) of each frame: the count the mapping
    body reads on the host anyway."""
    window = cfg.diff_travel_dist_local
    st = make_sharded_stages(cfg, mesh, nb_offs, encode_vecs)

    def make_step(track: bool, filter_pool_now: bool):
        def step(state: StreamState, frame_id: int, points, pmask, point_ts, imu_rows,
                 imu_count: int, crop_max_range: float, iters_base: int, mlp_lr_scale: float,
                 allow_restart: bool, draws: Optional[dict] = None):
            del point_ts  # deskew is not wired in the sharded step
            draws = draws or {}
            dev = points.device
            crop = torch.tensor(crop_max_range, dtype=torch.float32, device=dev)
            pmask = pmask & crop_mask(points, cfg.min_z, cfg.max_z, cfg.min_range, crop)
            scale = crop / cfg.max_range
            train_mask = voxel_down_sample_mask(points, pmask, scale * cfg.vox_down_m,
                                                cfg.map_hash_size)
            rot, pos, rest, P = state.rot, state.pos, state.rest, state.P
            odom_poses = state.odom_poses.clone()
            travel_dist = state.travel_dist.clone()
            lose_track, consec_lose = state.lose_track, state.consec_lose
            stop_count, stop_status = state.stop_count, state.stop_status
            failed = state.failed
            track_iters = state.track_iters

            if track:
                rot, pos, rest, P = predict_imu(cfg, rot, pos, rest, P, imu_rows, imu_count)
                src_idx, smask = source_indices(cfg, points, train_mask, scale)
                rot, pos, rest, P, ok, n_iter = st.tracker_update(
                    state.map_state, state.mlp, points[src_idx], smask, rot, pos, rest, P,
                    travel_dist, frame_id, window,
                )
                rot = _orthonormalize(rot)
                track_iters = track_iters.clone()
                track_iters[frame_id] = n_iter
                pose = _pose(rot, pos)
                (stop_count, stop_status, lose_track, consec_lose, failed, _,
                 tran_norm) = track_bookkeeping(cfg, state, pose, ok)
                travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)] + tran_norm
            else:
                pose = _pose(rot, pos)
                travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)]
            odom_poses[frame_id] = pose

            # map prep (prep.make_prep_fn's structure, the insert sharded)
            use_mask = train_mask & ~lose_track & ~stop_status
            origin = pose[:3, 3]
            local_map = state.local_map
            if not cfg.use_pin_mapper:
                local_map = lm.update_local_map(
                    local_map, origin, transform_points(points, pose), use_mask,
                    cfg.local_voxel_size_m, cfg.local_map_size, crop_now=filter_pool_now,
                )
            batch = st.sampler(points, use_mask, pose, local_map, cfg.local_voxel_size_m,
                               generator=state.key, draws=draws.get("sample"))
            coords_global = transform_points(batch.coords, pose)
            upd_sel = batch.mask & (
                torch.abs(batch.sdf_label) < cfg.surface_sample_range_m * cfg.map_surface_ratio)
            surf_rows = (1 + cfg.surface_sample_n) * points.shape[0]
            map_state, _ = st.insert_fn(state.map_state, coords_global[:surf_rows],
                                        upd_sel[:surf_rows], travel_dist, frame_id, window)
            pool = state.pool
            if filter_pool_now:
                pool = pl.filter_pool(pool, origin, cfg.window_radius)
            is_new = is_new_samples(cfg, st.certainty_fn, map_state, coords_global, batch)
            pool = pl.append_samples(pool, coords_global, batch.sdf_label, batch.weight,
                                     batch.mask, frame_id, is_new,
                                     uniform=draws.get("append"), generator=state.key)

            iters = adaptive_iters(cfg, iters_base, torch.sum(is_new.to(torch.int32)),
                                   torch.sum(batch.mask.to(torch.int32)), allow_restart,
                                   stop_status)
            n_iters = int(iters)
            if map_log is not None:
                map_log.append((frame_id, n_iters))
            map_fn = st.mapping_fn if track else st.mapping_fn_init
            map_state, mlp, loss2 = map_fn(
                map_state, state.mlp, pool, travel_dist, frame_id, window, n_iters, mlp_lr_scale,
                generator=state.key, batch_draws=draws.get("batches"),
            )
            losses = state.losses.clone()
            losses[frame_id] = loss2
            new_state = replace(
                state,
                rot=rot, pos=pos, rest=rest, P=P, last_pose=pose, odom_poses=odom_poses,
                travel_dist=travel_dist, lose_track=lose_track, consec_lose=consec_lose,
                stop_count=stop_count, stop_status=stop_status, failed=failed,
                map_state=map_state, local_map=local_map, pool=pool, mlp=mlp, losses=losses,
                track_iters=track_iters,
            )
            return new_state, torch.zeros((), dtype=torch.int64, device=dev), None

        return step

    return {(tr, fp): make_step(tr, fp) for tr in (False, True) for fp in (False, True)}


class StreamingShardedSlam(stream.StreamingSlam):
    """``StreamingSlam`` whose neural map is sharded over the ranks of
    ``group`` (the default process group when None; ``n_devices`` must be
    None or its size). ``device=None`` means the CUDA card (on an NCCL
    group); ``device="cpu"`` runs on the CPU (on a gloo group)."""

    def __init__(self, cfg: Config, n_devices: Optional[int] = None, total_frames: int = 1024,
                 device=None, group=None):
        if cfg.ba_freq_frame > 0:
            raise ValueError("StreamingShardedSlam: ba_freq_frame > 0 (sliding-window BA) "
                             "does not run on a sharded map")
        if cfg.prune_map_on:
            raise ValueError("StreamingShardedSlam: prune_map_on (prune and rehash) does not "
                             "run on a sharded map")
        if cfg.dynamic_filter_on:
            warnings.warn("StreamingShardedSlam: dynamic_filter_on is not run on a sharded "
                          "map (the JAX package's sharded step has no filter)", RuntimeWarning)
        self.mesh = make_driver_mesh(n_devices, group, resolve_device(device))
        self.n_shards = self.mesh.size
        # (frame_id, mapping steps) of each frame since construction or load
        self.map_log = []
        super().__init__(cfg, total_frames=total_frames, device=device)

    # -- overridden factory hooks ----------------------------------------
    def _make_steps(self):
        return make_sharded_frame_step(self.cfg, self.mesh, self.nb_offs, self.encode_vecs,
                                       self.map_log)

    def _init_map_state(self):
        return init_shard(self.cfg, self.mesh, self.device)

    def precompile(self):
        """``StreamingSlam.precompile`` over the sharded step (a collective:
        every rank calls it and runs the variants in the same order); the
        variants' mapping steps are kept out of ``map_log``."""
        n = len(self.map_log)
        super().precompile()
        del self.map_log[n:]

    def neural_point_count(self) -> int:
        """Live points over every shard (a collective)."""
        return sp.total_count(self.state.map_state, self.mesh)

    def sync(self) -> dict:
        """``StreamingSlam.sync()`` (a collective here) with ``map_iters``,
        the mapping steps of each frame since construction or load."""
        out = super().sync()
        out["map_iters"] = list(self.map_log)
        return out

    # -- checkpoints: JAX's stacked layout, one file --------------------
    def _state_to_numpy(self) -> list:
        from ..convert import sharded_stream_state_to_numpy

        return sharded_stream_state_to_numpy(self.state, self.mesh)

    def _state_from_numpy(self, leaves) -> StreamState:
        from ..convert import sharded_stream_state_from_numpy

        return sharded_stream_state_from_numpy(leaves, self.mesh.rank, self.device)

    def _write_checkpoint(self, path: str, arrays: dict):
        if self.mesh.rank == 0:
            np.savez_compressed(path, **arrays)
        dist.barrier(self.mesh.group)  # the file exists on return, on every rank
