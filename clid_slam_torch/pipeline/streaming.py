"""Streaming SLAM loop: the single-device frame step (port of
clid_slam_tpu/pipeline/streaming.py).

The whole recurrent state (IESEKF, odometry bookkeeping, neural map, local
label map, replay pool, decoder) lives on the device in ``StreamState``.
One frame = IMU propagation + candidate-cached iterated update + map prep +
adaptive iteration count + mapping, with the host uploading the scan and
the IMU window once. Tracked frames map with the fused kernel
(``ops/map_loop.py``) or, where the config is ineligible for it, with the
mapper's autograd loop; frame 0 runs the general multi-batch body. With
``prune_map_on`` the map is pruned and rehashed every ``prune_freq_frame``
frames, after the frame step.

Host reads inside a frame: the iterated update reads its exit flag once
per iteration, frame 0 reads its iteration count to size the outer
mapping loop, and a tracked frame on the autograd loop reads its step
count once. Everything else stays on the device until ``sync()``.

The tracking, prep and mapping stages run under ``torch.profiler``
ranges (``frame.track``, ``frame.prep``, ``frame.map``) so that a profile
of the loop splits the frame by stage (``chip_smoke.py --profile``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Config
from ..device import resolve_device
from ..mapping import mapper as mp
from ..mapping import pool as pl
from ..mapping import prep as prp
from ..models import decoder as dec
from ..models import local_map as lm
from ..models import neural_map as nm
from ..odometry import iekf
from ..ops.encoding import make_encoder
from ..ops.scatter import compact_indices
from ..ops.voxel import neighbor_offsets, voxel_down_sample_mask
from ..utils.transforms import adaptive_crop_range, crop_mask, deskew

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


def check_supported(cfg: Config) -> None:
    """The options the port runs so far; the others raise."""
    missing = [
        name for name, on in (
            ("color_on", cfg.color_on),
            ("semantic_on", cfg.semantic_on),
            ("dynamic_filter_on", cfg.dynamic_filter_on),
            ("ba_freq_frame>0", cfg.ba_freq_frame > 0),
            ("mlp_bf16", cfg.mlp_bf16),
            ("weighted_first=False", not cfg.weighted_first),
            ("track_cached=False", not cfg.track_cached),
            (f"feature_dim={cfg.feature_dim} (not a multiple of 4)", cfg.feature_dim % 4 != 0),
        ) if on
    ]
    if missing:
        raise NotImplementedError(
            f"clid_slam_torch does not port these options yet: {', '.join(missing)}"
        )


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


def make_frame_step(cfg: Config, nb_offs, encode_vecs):
    """The four frame-step variants keyed by (track, filter_pool_now):
    step(state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
    crop_max_range, iters_base, mlp_lr_scale, allow_restart) -> state."""
    max_valid_dist2 = 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2
    S = cfg.max_source_points
    window = cfg.diff_travel_dist_local
    n_cand = cfg.track_n_cand or max(16, cfg.query_nn_k * 2)
    cached_update = iekf.make_cached_update_fn(
        knn_k=cfg.query_nn_k,
        n_cand=n_cand,
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
        encode_vecs=encode_vecs,
        layer_norm=cfg.layer_norm_on,
        stagnation_iter=cfg.stagnation_iter,
        info_scale=cfg.tracker_info_scale,
    )
    map_kw = dict(
        feature_dim=cfg.feature_dim,
        knn_k=cfg.query_nn_k,
        nb_offs=nb_offs,
        resolution=cfg.voxel_size_m,
        max_valid_dist2=max_valid_dist2,
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
        encode_vecs=encode_vecs,
        layer_norm=cfg.layer_norm_on,
        resample_every=cfg.map_resample_every,
    )
    mapping_body = mp.make_mapping_fn(**map_kw)
    mapping_body_fast = mp.make_mapping_fn(
        **dict(
            map_kw,
            resample_every=max(cfg.map_resample_every, cfg.iters + 10),
            max_outer=1,
            dup_independent=cfg.map_dup_independent,
        )
    )
    prep_bodies = {
        fp: prp.make_prep_fn(
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
            filter_pool_now=fp,
            pin_mode=cfg.use_pin_mapper,
            behind_dropoff_on=cfg.behind_dropoff_on,
            incidence_label_on=cfg.incidence_label_on,
            incidence_min_factor=cfg.incidence_min_factor,
            incidence_degenerate_factor=cfg.incidence_degenerate_factor,
            free_behind_weight=cfg.resolved_free_behind_weight(),
        )
        for fp in (False, True)
    }

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
        ):
            """``draws`` injects the frame's random numbers (keys "sample",
            "append", "batches": see prep and mapper) in place of the
            state's generator."""
            draws = draws or {}
            dev = points.device
            f32 = dict(dtype=torch.float32, device=dev)
            crop = torch.tensor(crop_max_range, **f32)
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
                Q = torch.zeros((12, 12), **f32)
                I3 = torch.eye(3, **f32)
                Q[0:3, 0:3] = cfg.measurement_noise_covariance * I3
                Q[3:6, 3:6] = cfg.measurement_noise_covariance * I3
                Q[6:9, 6:9] = cfg.bias_noise_covariance * I3
                Q[9:12, 9:12] = cfg.bias_noise_covariance * I3
                rot, pos, vel, bg, ba, grav, P = iekf.device_predict_imu(
                    rot, pos, rest[0:3], rest[3:6], rest[6:9], rest[9:12], P, Q,
                    imu_rows, imu_count,
                )
                rest = torch.cat([vel, bg, ba, grav])

                src_mask = voxel_down_sample_mask(
                    points, train_mask, scale * cfg.source_vox_down_m, cfg.map_hash_size
                )
                if cfg.track_max_range > 0:
                    src_mask = src_mask & (
                        torch.linalg.norm(points, dim=-1) <= cfg.track_max_range
                    )
                n_src = torch.sum(src_mask.to(torch.int32))
                src_idx = compact_indices(src_mask, S)
                smask = torch.arange(S, device=dev) < n_src
                src_pts = points[src_idx]
                if cfg.deskew:
                    rel = torch.linalg.inv(state.last_pose) @ _pose(rot, pos)
                    src_pts = deskew(src_pts, point_ts[src_idx], rel)

                with record_function("frame.track"):
                    rot, pos, rest, P, ok, n_iter = cached_update(
                        state.map_state, state.mlp, src_pts, smask,
                        rot, pos, rest, P, travel_dist, frame_id, window,
                    )
                rot = _orthonormalize(rot)
                track_iters = track_iters.clone()
                track_iters[frame_id] = n_iter
                pose = _pose(rot, pos)
                last_tran = torch.linalg.inv(state.last_pose) @ pose
                tran_norm = torch.linalg.norm(last_tran[:3, 3])
                near_I = torch.all(torch.abs(last_tran[:3, :3] - I3) < 1e-3) & torch.all(
                    torch.abs(last_tran[:3, 3]) < cfg.voxel_size_m * 0.1
                )
                stop_count = torch.where(near_I, stop_count + 1, torch.zeros_like(stop_count))
                stop_status = stop_count > cfg.stop_frame_thre
                too_big = tran_norm > cfg.surface_sample_range_m * 40.0
                lose_track = ~ok | too_big
                consec_lose = torch.where(
                    lose_track, consec_lose + 1, torch.zeros_like(consec_lose)
                )
                failed = failed | too_big | (consec_lose > 10)
                travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)] + tran_norm
                odom_poses[frame_id] = pose
                if cfg.deskew:
                    full = deskew(points, point_ts, last_tran)
                    points = torch.where(train_mask[:, None], full, points)
            else:
                pose = _pose(rot, pos)
                odom_poses[frame_id] = pose
                travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)]

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

            # adaptive iteration offset (utils/mapper.py:446-459)
            iters = torch.tensor(iters_base, dtype=torch.int32, device=dev)
            if cfg.adaptive_iters and cfg.bs_new_sample > 0:
                ratio = res.new_sample_count / torch.clamp(res.cur_sample_count, min=1)
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
            iters = torch.clamp(iters, min=1)

            map_fn = mapping_body_fast if track else mapping_body
            with record_function("frame.map"):
                map_state, mlp, loss2 = map_fn(
                    res.map_state, state.mlp, res.pool, travel_dist, frame_id,
                    window, iters, mlp_lr_scale, generator=state.key,
                    batch_draws=draws.get("batches"),
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
                mlp=mlp, losses=losses, track_iters=track_iters,
            )
            return new_state, res.insert_dropped

        return step

    return {(tr, fp): make_step(tr, fp) for tr in (False, True) for fp in (False, True)}


class StreamingSlam:
    """Host driver of the device-resident loop. ``device=None`` means the
    CUDA card; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: Config, total_frames: int = 1024, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.total_frames = total_frames
        self.nb_offs = neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
        self.encode_vecs, _ = make_encoder(
            num_bands=cfg.pos_encoding_band,
            freq=cfg.pos_encoding_freq,
            base=cfg.pos_encoding_base,
            use_gaussian=cfg.use_gaussian_pe,
            input_dim=cfg.pos_input_dim,
            seed=cfg.seed,
        )
        self.steps = make_frame_step(cfg, self.nb_offs, self.encode_vecs)
        self.T_imu_lidar = np.asarray(cfg.T_imu_lidar, np.float64)
        self.imu_max_rows = IMU_MAX_ROWS
        self._init_state()
        self.processed = 0
        # insert candidates dropped by the pre-probe compaction (all frames)
        self.insert_dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        # (frame_id, point count before, after) of every prune; the counts
        # stay device scalars until sync()
        self.prune_log = []

    def _init_state(self):
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        d_in = cfg.feature_dim + cfg.position_dim
        mlp = dec.init_mlp(
            gen, d_in, cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1, cfg.mlp_bias_on
        )
        color_mlp = dec.init_mlp(
            gen, d_in, cfg.color_mlp_hidden_dim, cfg.color_mlp_level,
            max(cfg.color_channel, 1), cfg.mlp_bias_on,
        )
        sem_mlp = dec.init_mlp(
            gen, d_in, cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level, 1, cfg.mlp_bias_on
        )
        P = np.eye(18, dtype=np.float32)
        P[9:12, 9:12] *= 1e-4
        P[12:15, 12:15] *= 1e-3
        P[15:18, 15:18] *= 1e-4
        rest = np.zeros(12, np.float32)
        rest[9:12] = cfg.init_gravity or [0.0, 0.0, -G_M_S2]
        if cfg.init_bg is not None:
            rest[3:6] = cfg.init_bg
        if cfg.init_ba is not None:
            rest[6:9] = cfg.init_ba
        T = self.total_frames
        t = lambda a: torch.as_tensor(a, device=dev)
        self.state = StreamState(
            rot=torch.eye(3, device=dev),
            pos=torch.zeros(3, device=dev),
            rest=t(rest),
            P=t(P),
            last_pose=torch.eye(4, device=dev),
            odom_poses=torch.eye(4, device=dev).repeat(T, 1, 1),
            travel_dist=torch.zeros(T, device=dev),
            lose_track=torch.zeros((), dtype=torch.bool, device=dev),
            consec_lose=torch.zeros((), dtype=torch.int32, device=dev),
            stop_count=torch.zeros((), dtype=torch.int32, device=dev),
            stop_status=torch.zeros((), dtype=torch.bool, device=dev),
            failed=torch.zeros((), dtype=torch.bool, device=dev),
            map_state=nm.init_map(
                cfg.map_capacity, cfg.map_hash_size, cfg.feature_dim, 1, device=dev
            ),
            local_map=lm.init_local_map(
                cfg.local_map_capacity, cfg.local_map_hash_size, device=dev
            ),
            pool=pl.init_pool(
                cfg.pool_capacity, cfg.max_scan_points * cfg.all_sample_n,
                max(cfg.color_channel, 1), device=dev,
            ),
            mlp=mlp,
            color_mlp=color_mlp,
            sem_mlp=sem_mlp,
            key=gen,
            losses=torch.zeros((T, 2), device=dev),
            track_iters=torch.zeros(T, dtype=torch.int32, device=dev),
        )

    def neural_point_count(self) -> int:
        return int(self.state.map_state.count)

    def seed_pose(self, rot: np.ndarray, pos: np.ndarray, vel=None):
        """Anchor the initial pose (and optionally velocity) before frame 0."""
        dev = self.device
        st = self.state
        rest = st.rest.clone()
        if vel is not None:
            rest[0:3] = torch.as_tensor(np.asarray(vel, np.float32), device=dev)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rot
        T[:3, 3] = np.asarray(pos).reshape(3)
        self.state = replace(
            st,
            rot=torch.as_tensor(np.asarray(rot, np.float32), device=dev),
            pos=torch.as_tensor(np.asarray(pos, np.float32), device=dev),
            rest=rest,
            last_pose=torch.as_tensor(T, device=dev),
        )

    def process_frame(
        self,
        frame_id: int,
        points: np.ndarray,
        imu_window: Optional[np.ndarray] = None,
        point_ts=None,
        draws: Optional[dict] = None,
    ):
        """One frame from in-memory arrays (sensor frame [N,3+], IMU rows
        [k,7] of (dt, acc, gyro), optional per-point timestamps).
        ``draws`` injects the frame's random numbers (see make_frame_step)."""
        cfg, dev = self.cfg, self.device
        points = np.asarray(points)[:, :3].astype(np.float32)
        if not np.allclose(self.T_imu_lidar, np.eye(4)):
            points = (
                points @ self.T_imu_lidar[:3, :3].T.astype(np.float32)
                + self.T_imu_lidar[:3, 3].astype(np.float32)
            )
        crop_max_range = cfg.max_range
        if cfg.adaptive_range_on:
            crop_max_range = adaptive_crop_range(points, cfg.max_range)
        p_cap = cfg.max_scan_points
        n = points.shape[0]
        if n > p_cap:
            sel = np.random.default_rng(frame_id).permutation(n)[:p_cap]
            sel.sort()
            points = points[sel]
            point_ts = point_ts[sel] if point_ts is not None else None
            n = p_cap
        k = 0
        imu = np.zeros((self.imu_max_rows, 7), np.float32)
        if imu_window is not None and len(imu_window):
            if len(imu_window) > self.imu_max_rows:
                warnings.warn(
                    f"frame {frame_id}: IMU window has {len(imu_window)} rows, "
                    f"truncating to imu_max_rows={self.imu_max_rows}",
                    RuntimeWarning,
                )
            k = min(len(imu_window), self.imu_max_rows)
            imu[:k] = imu_window[:k]
        scan = np.zeros((p_cap, 5), np.float32)
        scan[:n, :3] = points
        scan[:n, 3] = 1.0
        if cfg.deskew and point_ts is not None:
            scan[:n, 4] = np.asarray(point_ts, np.float32).reshape(-1)[:n]
        scan_d = torch.from_numpy(scan).to(dev)
        imu_d = torch.from_numpy(imu).to(dev)

        track = cfg.track_on and frame_id > 0
        filter_now = (frame_id + 1) % cfg.pool_filter_freq == 0
        step = self.steps[(track, filter_now)]
        iters_base = cfg.iters * cfg.init_iter_ratio if frame_id == 0 else cfg.iters
        mlp_scale = 0.0 if frame_id >= cfg.freeze_after_frame else 1.0
        self.state, dropped = step(
            self.state, frame_id, scan_d[:, :3], scan_d[:, 3] > 0.5, scan_d[:, 4],
            imu_d, k, crop_max_range, iters_base, mlp_scale,
            frame_id > cfg.freeze_after_frame, draws,
        )
        self.insert_dropped = self.insert_dropped + dropped

        # prune cadence (no host read)
        if cfg.prune_map_on and (frame_id + 1) % cfg.prune_freq_frame == 0:
            before = self.state.map_state.count
            pruned = nm.prune_and_rehash(
                self.state.map_state, cfg.max_prune_certainty,
                self.state.travel_dist, frame_id, cfg.diff_travel_dist_local,
                cfg.voxel_size_m,
            )
            self.prune_log.append((frame_id, before, pruned.count))
            self.state = replace(self.state, map_state=pruned)
        self.processed = frame_id + 1

    def block(self):
        """Wait for all enqueued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sync(self) -> dict:
        """Materialize results on the host."""
        st = self.state
        n = self.processed
        return {
            "odom_poses": st.odom_poses[:n].double().cpu().numpy(),
            "travel_dist": st.travel_dist[:n].double().cpu().numpy(),
            "losses": st.losses[:n].cpu().numpy(),
            "track_iters": st.track_iters[:n].cpu().numpy(),
            "failed": bool(st.failed),
            "lose_track": bool(st.lose_track),
            "neural_points": self.neural_point_count(),
            "insert_dropped": int(self.insert_dropped),
            "prunes": [(f, int(b), int(a)) for f, b, a in self.prune_log],
        }
