"""The streaming frame step in plain PyTorch: a frozen copy of
``clid_slam_torch/pipeline/streaming.py`` lines 72-537 but ``clone_state``
(``StreamState``, the one-buffer packing, the IMU propagation, the tracker's sources, the
bookkeeping, the adaptive iteration count and ``make_frame_step``) as of
commit 806f431, run on the plain gathers and the plain mapping loop of
this package. Two changes: the step takes ``pose_override``, the pose that
the stages after tracking use in place of the tracked one, and returns the
tracked pose besides, so that tracking and the stages after it are judged
apart (a rounding-sized difference of the pose would otherwise move a
point across a voxel face and the whole map after it).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .config import Config
from .mapping import mapper as mp
from .mapping import pool as pl
from .mapping import prep as prp
from .mapping.dynamic_filter import make_dynamic_filter_fn
from .models import decoder as dec
from .models import local_map as lm
from .models import neural_map as nm
from .odometry import iekf
from .ops.scatter import compact_indices
from .ops.voxel import voxel_down_sample_mask
from .utils.transforms import crop_mask, deskew

G_M_S2 = iekf.G_M_S2
IMU_MAX_ROWS = 64  # static IMU-row bucket (100-640 Hz IMU at 10 Hz LiDAR)


@dataclass
class StreamState:
    rot: torch.Tensor  # [3,3]
    pos: torch.Tensor  # [3]
    rest: torch.Tensor  # [12] vel, bg, ba, grav
    P: torch.Tensor  # [18,18]
    last_pose: torch.Tensor  # [4,4]
    odom_poses: torch.Tensor  # [T,4,4]
    travel_dist: torch.Tensor  # [T]
    lose_track: torch.Tensor  # bool
    consec_lose: torch.Tensor  # i32
    stop_count: torch.Tensor  # i32
    stop_status: torch.Tensor  # bool
    failed: torch.Tensor  # bool
    map_state: nm.NeuralMapState
    local_map: lm.LocalMapState
    pool: pl.ReplayPool
    mlp: dec.MLPParams
    color_mlp: dec.MLPParams
    sem_mlp: dec.MLPParams
    key: torch.Generator  # the JAX state's PRNG key slot
    losses: torch.Tensor  # [T,2]
    track_iters: torch.Tensor  # [T] i32

    def leaves(self) -> list:
        """The state in the JAX package's leaf order (``tree_leaves`` of
        its ``StreamState``); the key slot holds the generator."""
        return [
            self.rot, self.pos, self.rest, self.P, self.last_pose, self.odom_poses,
            self.travel_dist, self.lose_track, self.consec_lose, self.stop_count,
            self.stop_status, self.failed, *self.map_state.tensors(),
            *self.local_map.tensors(), *self.pool.tensors(), *self.mlp.tensors(),
            *self.color_mlp.tensors(), *self.sem_mlp.tensors(), self.key, self.losses,
            self.track_iters,
        ]


def pack_adapter(step, p_cap: int, imu_max_rows: int):
    """Wrap a frame step (``make_frame_step``'s call) into the one-buffer
    convention ``packed(state, frame_pack, draws=None)``, ``frame_pack``
    the host buffer of ``pack_frame_buffers``: the scan block [p_cap,5]
    (x, y, z, mask, point_ts), then the aux block [imu_max_rows+1,7] whose
    first rows are the IMU rows (dt, acc, gyro) and whose last row carries
    the frame scalars (frame_id, imu_count, crop_max_range, iters_base,
    mlp_lr_scale, allow_restart, 0). The buffer goes to the state's device
    in one copy and the step gets views of it; the scalars are read from
    the host buffer, so they cost no read from the device."""
    scan_n = p_cap * 5

    def packed(state: StreamState, frame_pack: np.ndarray, draws: Optional[dict] = None,
               pose_override=None):
        host = np.asarray(frame_pack, np.float32)
        dev = state.rot.device
        buf = torch.from_numpy(host).to(dev)
        scan = buf[:scan_n].reshape(p_cap, 5)
        aux = buf[scan_n:].reshape(imu_max_rows + 1, 7)
        s = host[scan_n:].reshape(imu_max_rows + 1, 7)[-1]
        return step(
            state, int(s[0]), scan[:, :3], scan[:, 3] > 0.5, scan[:, 4], aux[:-1], int(s[1]),
            float(s[2]), int(s[3]), float(s[4]), bool(s[5] > 0.5), draws, pose_override,
        )

    return packed


def pack_frame_buffers(
    p_cap: int,
    imu_max_rows: int,
    points,  # [n,3] np
    point_ts,  # [n] np or None
    imu_window,  # [k,7] np or None
    frame_id: int,
    crop_max_range: float,
    iters_base: int,
    mlp_lr_scale: float,
    allow_restart: bool,
) -> np.ndarray:
    """The host buffer of ``pack_adapter``'s convention (the JAX package's
    layout): the first ``p_cap`` points and ``imu_max_rows`` IMU rows."""
    n = min(points.shape[0], p_cap)
    pack = np.zeros(p_cap * 5 + (imu_max_rows + 1) * 7, np.float32)
    scan = pack[: p_cap * 5].reshape(p_cap, 5)
    aux = pack[p_cap * 5 :].reshape(imu_max_rows + 1, 7)
    scan[:n, :3] = points[:n, :3]
    scan[:n, 3] = 1.0
    if point_ts is not None:
        scan[:n, 4] = np.asarray(point_ts, np.float32).reshape(-1)[:n]
    k = 0
    if imu_window is not None and len(imu_window):
        k = min(len(imu_window), imu_max_rows)
        aux[:k] = imu_window[:k]
    aux[-1, :6] = (
        float(frame_id),
        float(k),
        float(crop_max_range),
        float(iters_base),
        float(mlp_lr_scale),
        1.0 if allow_restart else 0.0,
    )
    return pack


def _orthonormalize(R):
    """Project an almost-rotation back to SO(3) (Gram-Schmidt)."""
    a = R[:, 0] / torch.linalg.norm(R[:, 0])
    b = R[:, 1] - torch.dot(a, R[:, 1]) * a
    b = b / torch.linalg.norm(b)
    c = torch.linalg.cross(a, b, dim=0)
    return torch.stack([a, b, c], dim=1)


def _pose(rot, pos):
    T = torch.eye(4, device=rot.device)
    T[:3, :3] = rot
    T[:3, 3] = pos
    return T


def _max_valid_dist2(cfg: Config) -> float:
    return 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2


def mapping_kwargs(cfg: Config, nb_offs, encode_vecs) -> dict:
    """``mapper.make_mapping_fn``'s arguments for ``cfg``, as the frame step
    builds frame 0's general body (tracked frames add ``max_outer=1``)."""
    return dict(
        feature_dim=cfg.feature_dim,
        knn_k=cfg.query_nn_k,
        nb_offs=nb_offs,
        resolution=cfg.voxel_size_m,
        max_valid_dist2=_max_valid_dist2(cfg),
        sdf_scale=cfg.sdf_scale,
        sigma=cfg.sdf_scale,
        loss_type=cfg.main_loss_type,
        bs=cfg.bs,
        bs_new=cfg.bs_new_sample,
        gradient_decimation=cfg.gradient_decimation,
        num_grad_eps=cfg.num_grad_eps,
        weight_e=cfg.weight_e,
        loss_weight_on=cfg.loss_weight_on,
        lr=cfg.lr,
        adam_eps=cfg.adam_eps,
        mlp_leaky=cfg.mlp_leaky_relu,
        mlp_bf16=cfg.mlp_bf16,
        color_on=cfg.color_on,
        sem_on=cfg.semantic_on,
        weight_i=cfg.weight_i,
        weight_s=cfg.weight_s,
        surface_sample_range_m=cfg.surface_sample_range_m,
        encode_vecs=encode_vecs,
        weighted_first=cfg.weighted_first,
        layer_norm=cfg.layer_norm_on,
        resample_every=cfg.map_resample_every,
    )


def prep_kwargs(cfg: Config) -> dict:
    """``prep.make_prep_fn``'s arguments for ``cfg`` but ``filter_pool_now``."""
    return dict(
        resolution=cfg.voxel_size_m,
        local_resolution=cfg.local_voxel_size_m,
        local_map_size=cfg.local_map_size,
        window_radius=cfg.window_radius,
        surface_sample_range_m=cfg.surface_sample_range_m,
        surface_sample_n=cfg.surface_sample_n,
        free_front_n=cfg.free_front_n,
        free_behind_n=cfg.free_behind_n,
        free_sample_begin_ratio=cfg.free_sample_begin_ratio,
        free_sample_end_dist_m=cfg.free_sample_end_dist_m,
        max_range=cfg.max_range,
        dist_weight_on=cfg.dist_weight_on,
        dist_weight_scale=cfg.dist_weight_scale,
        map_surface_ratio=cfg.map_surface_ratio,
        from_sample_points=cfg.from_sample_points,
        new_certainty_thre=cfg.new_certainty_thre,
        novelty_on=cfg.bs_new_sample > 0,
        novelty_mode=cfg.novelty_mode,
        pin_mode=cfg.use_pin_mapper,
        behind_dropoff_on=cfg.behind_dropoff_on,
        incidence_label_on=cfg.incidence_label_on,
        incidence_min_factor=cfg.incidence_min_factor,
        incidence_degenerate_factor=cfg.incidence_degenerate_factor,
        free_behind_weight=cfg.resolved_free_behind_weight(),
    )


def predict_imu(cfg: Config, rot, pos, rest, P, imu_rows, imu_count: int):
    """The IESEKF's IMU propagation over a frame's rows on the device:
    (rot, pos, rest, P) after it."""
    f32 = dict(dtype=torch.float32, device=rot.device)
    Q = torch.zeros((12, 12), **f32)
    I3 = torch.eye(3, **f32)
    Q[0:3, 0:3] = cfg.measurement_noise_covariance * I3
    Q[3:6, 3:6] = cfg.measurement_noise_covariance * I3
    Q[6:9, 6:9] = cfg.bias_noise_covariance * I3
    Q[9:12, 9:12] = cfg.bias_noise_covariance * I3
    rot, pos, vel, bg, ba, grav, P = iekf.device_predict_imu(
        rot, pos, rest[0:3], rest[3:6], rest[6:9], rest[9:12], P, Q, imu_rows, imu_count,
    )
    return rot, pos, torch.cat([vel, bg, ba, grav]), P


def source_indices(cfg: Config, points, train_mask, scale):
    """The tracker's source points: (indices [S] into ``points``, their
    mask [S]) of the voxel keep-mask at ``source_vox_down_m`` within
    ``track_max_range``."""
    S = cfg.max_source_points
    src_mask = voxel_down_sample_mask(
        points, train_mask, scale * cfg.source_vox_down_m, cfg.map_hash_size
    )
    if cfg.track_max_range > 0:
        src_mask = src_mask & (torch.linalg.norm(points, dim=-1) <= cfg.track_max_range)
    n_src = torch.sum(src_mask.to(torch.int32))
    return compact_indices(src_mask, S), torch.arange(S, device=points.device) < n_src


def track_bookkeeping(cfg: Config, state: StreamState, pose, ok):
    """The stop, lose-track and failure flags after a tracked frame at
    ``pose``: (stop_count, stop_status, lose_track, consec_lose, failed,
    the relative transform from the last pose, its translation norm)."""
    last_tran = torch.linalg.inv(state.last_pose) @ pose
    tran_norm = torch.linalg.norm(last_tran[:3, 3])
    I3 = torch.eye(3, device=pose.device)
    near_I = torch.all(torch.abs(last_tran[:3, :3] - I3) < 1e-3) & torch.all(
        torch.abs(last_tran[:3, 3]) < cfg.voxel_size_m * 0.1
    )
    stop_count = torch.where(near_I, state.stop_count + 1, torch.zeros_like(state.stop_count))
    stop_status = stop_count > cfg.stop_frame_thre
    too_big = tran_norm > cfg.surface_sample_range_m * 40.0
    lose_track = ~ok | too_big
    consec_lose = torch.where(
        lose_track, state.consec_lose + 1, torch.zeros_like(state.consec_lose)
    )
    failed = state.failed | too_big | (consec_lose > 10)
    return stop_count, stop_status, lose_track, consec_lose, failed, last_tran, tran_norm


def adaptive_iters(cfg: Config, iters_base: int, new_count, cur_count, allow_restart: bool,
                   stop_status):
    """The frame's mapping steps on the device (utils/mapper.py:446-459):
    ``iters_base`` moved by the share of new samples, 10 fewer on a stop,
    at least 1."""
    iters = torch.tensor(iters_base, dtype=torch.int32, device=stop_status.device)
    if cfg.adaptive_iters and cfg.bs_new_sample > 0:
        ratio = new_count / torch.clamp(cur_count, min=1)
        offset = torch.where(
            ratio < cfg.new_sample_ratio_less,
            torch.full_like(iters, -5),
            torch.where(
                ratio > cfg.new_sample_ratio_more,
                torch.where(
                    allow_restart & (ratio > cfg.new_sample_ratio_restart),
                    torch.full_like(iters, 10),
                    torch.full_like(iters, 5),
                ),
                torch.zeros_like(iters),
            ),
        )
        iters = iters + offset
    iters = torch.where(stop_status, iters - 10, iters)
    return torch.clamp(iters, min=1)


def make_frame_step(cfg: Config, nb_offs, encode_vecs):
    """The four frame-step variants keyed by (track, filter_pool_now):
    step(state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
    crop_max_range, iters_base, mlp_lr_scale, allow_restart) -> (state,
    insert_dropped, filtered); ``filtered`` is None or the [2] counts of
    points the map trains on before and after the dynamic filter."""
    max_valid_dist2 = _max_valid_dist2(cfg)
    max_sdf_std = cfg.surface_sample_range_m * cfg.max_sdf_std_ratio
    window = cfg.diff_travel_dist_local
    n_cand = cfg.track_n_cand or max(16, cfg.query_nn_k * 2)
    make_update = (
        functools.partial(iekf.make_cached_update_fn, n_cand=n_cand)
        if cfg.track_cached
        else iekf.make_update_iterated_fn
    )
    update = make_update(
        knn_k=cfg.query_nn_k,
        nb_offs=nb_offs,
        resolution=cfg.voxel_size_m,
        max_valid_dist2=max_valid_dist2,
        sdf_scale=cfg.sdf_scale,
        min_grad_norm=cfg.reg_min_grad_norm,
        max_grad_norm=cfg.reg_max_grad_norm,
        min_nn_count=cfg.track_mask_query_nn_k,
        max_iteration=cfg.reg_iter_n,
        term_thre_deg=cfg.reg_term_thre_deg,
        term_thre_m=cfg.reg_term_thre_m,
        mlp_leaky=cfg.mlp_leaky_relu,
        mlp_bf16=cfg.mlp_bf16,
        encode_vecs=encode_vecs,
        weighted_first=cfg.weighted_first,
        layer_norm=cfg.layer_norm_on,
        max_sdf_std=max_sdf_std,
        stagnation_iter=cfg.stagnation_iter,
        info_scale=cfg.tracker_info_scale,
    )
    map_kw = mapping_kwargs(cfg, nb_offs, encode_vecs)
    mapping_body = mp.make_mapping_fn(**map_kw)
    mapping_body_fast = mp.make_mapping_fn(
        **dict(
            map_kw,
            resample_every=max(cfg.map_resample_every, cfg.iters + 10),
            max_outer=1,
            dup_independent=cfg.map_dup_independent,
            use_pallas=cfg.map_pallas,
        )
    )
    prep_bodies = {
        fp: prp.make_prep_fn(filter_pool_now=fp, **prep_kwargs(cfg)) for fp in (False, True)
    }
    dyn_filter = None
    if cfg.dynamic_filter_on:
        # without layer_norm, as the JAX frame step builds it (ROADMAP C4)
        dyn_filter = make_dynamic_filter_fn(
            knn_k=cfg.query_nn_k,
            nb_offs=nb_offs,
            resolution=cfg.voxel_size_m,
            max_valid_dist2=max_valid_dist2,
            sdf_scale=cfg.sdf_scale,
            certainty_thre=cfg.dynamic_certainty_thre,
            sdf_ratio_thre=cfg.dynamic_sdf_ratio_thre,
            mlp_leaky=cfg.mlp_leaky_relu,
            mlp_bf16=cfg.mlp_bf16,
            encode_vecs=encode_vecs,
        )

    def make_step(track: bool, filter_pool_now: bool):
        prep_body = prep_bodies[filter_pool_now]

        def step(
            state: StreamState,
            frame_id: int,
            points,  # [P,3] sensor frame, padded
            pmask,  # [P] bool
            point_ts,  # [P] in [0,1] (zeros when deskew is off)
            imu_rows,  # [K,7]
            imu_count: int,
            crop_max_range: float,
            iters_base: int,
            mlp_lr_scale: float,
            allow_restart: bool,
            draws: Optional[dict] = None,
            pose_override=None,
        ):
            """``draws`` injects the frame's random numbers (keys "sample",
            "append", "batches": see prep and mapper) in place of the
            state's generator. ``pose_override`` ([4,4], tracked frames):
            the pose the stages after tracking use. Returns (state,
            insert_dropped, filtered, the tracked pose or None)."""
            draws = draws or {}
            crop = torch.tensor(crop_max_range, dtype=torch.float32, device=points.device)
            pmask = pmask & crop_mask(points, cfg.min_z, cfg.max_z, cfg.min_range, crop)
            scale = crop / cfg.max_range
            train_mask = voxel_down_sample_mask(
                points, pmask, scale * cfg.vox_down_m, cfg.map_hash_size
            )
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
                src_pts = points[src_idx]
                if cfg.deskew:
                    rel = torch.linalg.inv(state.last_pose) @ _pose(rot, pos)
                    src_pts = deskew(src_pts, point_ts[src_idx], rel)

                with record_function("frame.track"):
                    rot, pos, rest, P, ok, n_iter = update(
                        state.map_state, state.mlp, src_pts, smask,
                        rot, pos, rest, P, travel_dist, frame_id, window,
                    )
                rot = _orthonormalize(rot)
                tracked = _pose(rot, pos)
                if pose_override is not None:
                    rot = pose_override[:3, :3].clone()
                    pos = pose_override[:3, 3].clone()
                track_iters = track_iters.clone()
                track_iters[frame_id] = n_iter
                pose = _pose(rot, pos)
                (stop_count, stop_status, lose_track, consec_lose, failed, last_tran,
                 tran_norm) = track_bookkeeping(cfg, state, pose, ok)
                travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)] + tran_norm
                odom_poses[frame_id] = pose
                if cfg.deskew:
                    full = deskew(points, point_ts, last_tran)
                    points = torch.where(train_mask[:, None], full, points)
            else:
                tracked = None
                pose = _pose(rot, pos)
                odom_poses[frame_id] = pose
                travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)]

            # dynamic-object filter (slam.py:170-176: tracked frames only):
            # drop measurements landing in confidently observed free space
            filtered = None
            if dyn_filter is not None and track:
                with record_function("frame.filter"):
                    world = points @ pose[:3, :3].T + pose[:3, 3]
                    before = torch.sum(train_mask.to(torch.int32))
                    train_mask = dyn_filter(
                        state.map_state, state.mlp, world, train_mask,
                        travel_dist, frame_id, window,
                    )
                    filtered = torch.stack([before, torch.sum(train_mask.to(torch.int32))])

            # map prep, gated by tracking validity (a lost or stopped frame
            # must not corrupt the map)
            valid_mapping = ~lose_track & ~stop_status
            with record_function("frame.prep"):
                res = prep_body(
                    state.map_state, state.local_map, state.pool, points,
                    train_mask & valid_mapping, pose, travel_dist, frame_id, window,
                    generator=state.key, sample_draws=draws.get("sample"),
                    append_uniform=draws.get("append"),
                )

            iters = adaptive_iters(cfg, iters_base, res.new_sample_count, res.cur_sample_count,
                                   allow_restart, stop_status)

            map_fn = mapping_body_fast if track else mapping_body
            with record_function("frame.map"):
                map_state, mlp, color_mlp, sem_mlp, loss2 = map_fn(
                    res.map_state, state.mlp, state.color_mlp, state.sem_mlp, res.pool,
                    travel_dist, frame_id, window, iters, mlp_lr_scale,
                    generator=state.key, batch_draws=draws.get("batches"),
                )
            losses = state.losses.clone()
            losses[frame_id] = loss2
            new_state = replace(
                state,
                rot=rot, pos=pos, rest=rest, P=P, last_pose=pose,
                odom_poses=odom_poses, travel_dist=travel_dist,
                lose_track=lose_track, consec_lose=consec_lose,
                stop_count=stop_count, stop_status=stop_status, failed=failed,
                map_state=map_state, local_map=res.local_map, pool=res.pool,
                mlp=mlp, color_mlp=color_mlp, sem_mlp=sem_mlp, losses=losses,
                track_iters=track_iters,
            )
            return new_state, res.insert_dropped, filtered, tracked

        return step

    return {(tr, fp): make_step(tr, fp) for tr in (False, True) for fp in (False, True)}


