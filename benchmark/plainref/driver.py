"""The plain reference's driver: one frame of the streaming SLAM step from
a given state, on the plain paths of this package.

A frozen copy of the host side of ``clid_slam_torch/pipeline/streaming.py``
as of commit 806f431: ``StreamingSlam._init_state`` (lines 632-687),
``seed_pose`` (722-738) and the host half of ``process_frame`` (753-786),
with ``SLAMDataset.read_frame_arrays``'s move of the scan into the IMU's
frame (``pipeline/dataset.py`` lines 179-190). It imports nothing of the
system under test: the state it starts a frame from is handed over as
plain tensors in the leaf order of ``StreamState.leaves()``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import step as st
from .config import Config
from .models import decoder as dec
from .models import local_map as lm
from .models import neural_map as nm
from .mapping import pool as pl
from .ops.encoding import make_encoder
from .ops.voxel import neighbor_offsets
from .utils.transforms import adaptive_crop_range

IMU_MAX_ROWS = st.IMU_MAX_ROWS


def full_precision() -> None:
    """Every f32 product at full precision (TF32 off), as the
    configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Reference:
    """The frame step of ``cfg`` on ``device``, on the plain paths."""

    def __init__(self, cfg: Config, total_frames: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.total_frames = total_frames
        self.nb_offs = neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
        self.encode_vecs, _ = make_encoder(
            num_bands=cfg.pos_encoding_band, freq=cfg.pos_encoding_freq,
            base=cfg.pos_encoding_base, use_gaussian=cfg.use_gaussian_pe,
            input_dim=cfg.pos_input_dim, seed=cfg.seed,
        )
        self.steps = st.make_frame_step(cfg, self.nb_offs, self.encode_vecs)
        self.T_imu_lidar = np.asarray(cfg.T_imu_lidar, np.float64)

    def init_state(self, rot, pos, vel) -> st.StreamState:
        """The state before frame 0: the decoders drawn from ``cfg.seed``,
        empty map, local map and pool, the pose and velocity anchored."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        d_in = cfg.feature_dim + cfg.position_dim
        mlp = dec.init_mlp(gen, d_in, cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1,
                           cfg.mlp_bias_on)
        color_mlp = dec.init_mlp(gen, d_in, cfg.color_mlp_hidden_dim, cfg.color_mlp_level,
                                 max(cfg.color_channel, 1), cfg.mlp_bias_on)
        sem_mlp = dec.init_mlp(gen, d_in, cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level,
                               cfg.sem_class_count if cfg.semantic_on else 1, cfg.mlp_bias_on)
        P = np.eye(18, dtype=np.float32)
        P[9:12, 9:12] *= 1e-4
        P[12:15, 12:15] *= 1e-3
        P[15:18, 15:18] *= 1e-4
        rest = np.zeros(12, np.float32)
        rest[9:12] = cfg.init_gravity or [0.0, 0.0, -st.G_M_S2]
        if cfg.init_bg is not None:
            rest[3:6] = cfg.init_bg
        if cfg.init_ba is not None:
            rest[6:9] = cfg.init_ba
        rest[0:3] = np.asarray(vel, np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rot
        T[:3, 3] = np.asarray(pos).reshape(3)
        n = self.total_frames
        t = lambda a: torch.as_tensor(a, device=dev)
        return st.StreamState(
            rot=t(np.asarray(rot, np.float32)), pos=t(np.asarray(pos, np.float32)),
            rest=t(rest), P=t(P), last_pose=t(T),
            odom_poses=torch.eye(4, device=dev).repeat(n, 1, 1),
            travel_dist=torch.zeros(n, device=dev),
            lose_track=torch.zeros((), dtype=torch.bool, device=dev),
            consec_lose=torch.zeros((), dtype=torch.int32, device=dev),
            stop_count=torch.zeros((), dtype=torch.int32, device=dev),
            stop_status=torch.zeros((), dtype=torch.bool, device=dev),
            failed=torch.zeros((), dtype=torch.bool, device=dev),
            map_state=nm.init_map(cfg.map_capacity, cfg.map_hash_size, cfg.feature_dim,
                                  cfg.feature_dim if cfg.color_on else 1, device=dev),
            local_map=lm.init_local_map(cfg.local_map_capacity, cfg.local_map_hash_size,
                                        device=dev),
            pool=pl.init_pool(cfg.pool_capacity, cfg.max_scan_points * cfg.all_sample_n,
                              max(cfg.color_channel, 1), device=dev),
            mlp=mlp, color_mlp=color_mlp, sem_mlp=sem_mlp, key=gen,
            losses=torch.zeros((n, 2), device=dev),
            track_iters=torch.zeros(n, dtype=torch.int32, device=dev),
        )

    def state_from_leaves(self, leaves: list, gen_state: torch.Tensor) -> st.StreamState:
        """A state from tensors in ``StreamState.leaves()`` order (the key
        slot is ignored; the generator takes ``gen_state``)."""
        dev = self.device
        it = iter([x.to(dev) if isinstance(x, torch.Tensor) else x for x in leaves])
        take = lambda k: [next(it) for _ in range(k)]
        head = take(12)
        map_state = nm.NeuralMapState(*take(10))
        local_map = lm.LocalMapState(*take(4))
        pool = pl.ReplayPool(*take(5))
        cfg = self.cfg

        def mlp(levels):
            w, b = take(levels), take(levels)
            wo, bo = take(2)
            return dec.MLPParams(w, b, wo, bo)

        geo = mlp(cfg.geo_mlp_level)
        color = mlp(cfg.color_mlp_level)
        sem = mlp(cfg.sem_mlp_level)
        next(it)  # the program's generator
        losses, track_iters = take(2)
        gen = torch.Generator(device=dev)
        gen.set_state(gen_state.cpu())
        return st.StreamState(*head, map_state=map_state, local_map=local_map, pool=pool,
                              mlp=geo, color_mlp=color, sem_mlp=sem, key=gen, losses=losses,
                              track_iters=track_iters)

    def frame(self, state: st.StreamState, frame_id: int, points, imu_window, point_ts,
              pose_override=None):
        """One frame from host arrays, as ``StreamingSlam.process_frame``
        takes them: (state, insert_dropped, filtered counts or None, tracked
        pose or None)."""
        cfg = self.cfg
        pts = np.asarray(points)[:, :3].astype(np.float32)
        if not np.allclose(self.T_imu_lidar, np.eye(4)):
            pts = (pts @ self.T_imu_lidar[:3, :3].T.astype(np.float32)
                   + self.T_imu_lidar[:3, 3].astype(np.float32))
        crop_max_range = cfg.max_range
        if cfg.adaptive_range_on:
            crop_max_range = adaptive_crop_range(pts, cfg.max_range)
        p_cap = cfg.max_scan_points
        n = pts.shape[0]
        if n > p_cap:
            sel = np.random.default_rng(frame_id).permutation(n)[:p_cap]
            sel.sort()
            pts = pts[sel]
            point_ts = point_ts[sel] if point_ts is not None else None
        track = cfg.track_on and frame_id > 0
        filter_now = (frame_id + 1) % cfg.pool_filter_freq == 0
        iters_base = cfg.iters * cfg.init_iter_ratio if frame_id == 0 else cfg.iters
        mlp_scale = 0.0 if frame_id >= cfg.freeze_after_frame else 1.0
        pack = st.pack_frame_buffers(
            p_cap, IMU_MAX_ROWS, pts, point_ts if cfg.deskew else None, imu_window,
            frame_id, crop_max_range, iters_base, mlp_scale, frame_id > cfg.freeze_after_frame,
        )
        step = st.pack_adapter(self.steps[(track, filter_now)], p_cap, IMU_MAX_ROWS)
        po = None if pose_override is None else torch.as_tensor(
            np.asarray(pose_override, np.float32), device=self.device)
        return step(state, pack, None, po)

    def sdf(self, map_state: nm.NeuralMapState, mlp: dec.MLPParams, points: torch.Tensor):
        """The map's decoded SDF at ``points`` [N,3] (world frame) and the
        neighbour count of each: (sdf [N], nn_count [N])."""
        cfg = self.cfg
        q = nm.query_feature(
            map_state, points, torch.as_tensor(self.nb_offs, device=points.device),
            cfg.voxel_size_m, st._max_valid_dist2(cfg), cfg.query_nn_k,
            encode_vecs=self.encode_vecs, layer_norm=cfg.layer_norm_on,
            weighted_first=cfg.weighted_first,
        )
        kw = dict(leaky=cfg.mlp_leaky_relu)
        if cfg.weighted_first:
            out = dec.sdf(mlp, q.feature, cfg.sdf_scale, **kw)
        else:
            out = torch.sum(dec.sdf(mlp, q.feature, cfg.sdf_scale, **kw) * q.weights, dim=-1)
        return out, q.nn_count
