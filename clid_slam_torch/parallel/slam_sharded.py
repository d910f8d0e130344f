"""Sharded-map SLAM loop: the classic driver's pipeline against a neural
point map split over the ranks of a ``torch.distributed`` process group
(port of clid_slam_tpu/parallel/slam_sharded.py).

- The **neural point map** is spatially sharded, one shard a rank
  (``parallel/spatial.py``): a rank inserts the points whose voxels it
  owns, and every query is a collective partial-kNN exchange.
- **Odometry**: one collective candidate build a frame, then the iterated
  IESEKF update on every rank with no further collective
  (``spatial.make_sharded_tracker_fn``); the 18x18 covariance and the IMU
  propagation stay on the host in float64, as in the classic driver.
- **Mapping**: the cached batch-sharded body on tracked frames, the
  uncached one (a fresh batch every step) for frame 0's warm-up.
- The **local label map, sampler and replay pool are replicated**: every
  rank holds the same ones and draws the same numbers in the same order
  from one generator seeded from ``cfg.seed``.

Host-driven like ``pipeline/slam.py:SlamSystem``; the host reads the
source count, the tracker's ``ok`` and the adaptive ratio every frame, as
the JAX driver does. They are replicated values, so every rank takes the
same branch and enters the same collectives. Every rank calls
``process_frame`` with the same frame, and ``neural_point_count`` (a
collective) together.

The JAX driver has no dynamic filter, BA, prune or color and semantic
heads, and neither has this one: those options are not read.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..device import resolve_device
from ..mapping import pool as pl
from ..mapping.sampler import sample_rays
from ..models import decoder as dec
from ..models import local_map as lm
from ..odometry import iekf
from ..ops.encoding import make_encoder
from ..ops.scatter import compact_indices
from ..ops.voxel import neighbor_offsets, voxel_down_sample_mask
from ..utils.transforms import crop_mask, transform_points
from . import spatial as sp
from .collectives import Mesh


def make_driver_mesh(n_devices: Optional[int], group, device: torch.device) -> Mesh:
    """The shard mesh over ``group`` (the default group when None), whose
    backend must suit ``device``: NCCL for the card, gloo for the CPU."""
    mesh = sp.make_spatial_mesh(n_devices, group)
    backend = dist.get_backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a sharded driver on {device} needs a {want} process group, "
                         f"not {backend}")
    return mesh


def init_shard(cfg: Config, mesh: Mesh, device):
    """This rank's empty shard: the global budget divided over the shards
    with a 2x slack for imbalance (JAX's ``slam_sharded.py:79-80``)."""
    S = mesh.size
    return sp.init_sharded_map(mesh, max(1024, (2 * cfg.map_capacity) // S),
                               max(2048, (2 * cfg.map_hash_size) // S), cfg.feature_dim,
                               cfg.feature_dim if cfg.color_on else 1, device=device)


def make_sharded_stages(cfg: Config, mesh: Mesh, nb_offs, encode_vecs) -> SimpleNamespace:
    """The stage functions both sharded drivers compose: ``insert_fn``,
    ``mapping_fn`` (the cached body, tracked frames) and
    ``mapping_fn_init`` (the uncached one, frame 0), ``tracker_update``,
    ``certainty_fn`` and ``sampler``."""
    max_valid_dist2 = 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2
    spatial_kw = dict(
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
        mlp_bf16=cfg.mlp_bf16,
        encode_vecs=encode_vecs,
    )
    insert_fn, _, mapping_fn = sp.make_spatial_fns(mesh, **spatial_kw)
    # frame 0's warm-up (iters x init_iter_ratio steps) needs a fresh batch
    # every step: the cached body freezes one batch a call
    _, _, mapping_fn_init = sp.make_spatial_fns(mesh, batch_shard="uncached", **spatial_kw)
    cached_body = iekf.make_cached_update_fn(
        knn_k=cfg.query_nn_k,
        n_cand=cfg.track_n_cand or max(16, cfg.query_nn_k * 2),
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
        max_sdf_std=cfg.surface_sample_range_m * cfg.max_sdf_std_ratio,
        stagnation_iter=cfg.stagnation_iter,
        info_scale=cfg.tracker_info_scale,
    )
    tracker_update = sp.make_sharded_tracker_fn(
        mesh, cached_body, nb_offs=nb_offs, resolution=cfg.voxel_size_m,
        max_valid_dist2=max_valid_dist2, layer_norm=cfg.layer_norm_on,
    )
    certainty_fn = sp.make_sharded_certainty_fn(
        mesh, resolution=cfg.voxel_size_m, max_valid_dist2=3.0 * (2.0 * cfg.voxel_size_m) ** 2,
    )
    sampler = partial(
        sample_rays,
        surface_sample_range_m=cfg.surface_sample_range_m,
        surface_sample_n=cfg.surface_sample_n,
        free_front_n=cfg.free_front_n,
        free_behind_n=cfg.free_behind_n,
        free_sample_begin_ratio=cfg.free_sample_begin_ratio,
        free_sample_end_dist_m=cfg.free_sample_end_dist_m,
        max_range=cfg.max_range,
        dist_weight_on=cfg.dist_weight_on,
        dist_weight_scale=cfg.dist_weight_scale,
        pin_mode=cfg.use_pin_mapper,
        behind_dropoff_on=cfg.behind_dropoff_on,
        incidence_label_on=cfg.incidence_label_on,
        incidence_min_factor=cfg.incidence_min_factor,
        incidence_degenerate_factor=cfg.incidence_degenerate_factor,
        free_behind_weight=cfg.resolved_free_behind_weight(),
    )
    return SimpleNamespace(insert_fn=insert_fn, mapping_fn=mapping_fn,
                           mapping_fn_init=mapping_fn_init, tracker_update=tracker_update,
                           certainty_fn=certainty_fn, sampler=sampler)


def is_new_samples(cfg: Config, certainty_fn, map_state, coords_global, batch):
    """The novelty flags of a frame's samples: a low certainty over every
    shard, near the surface, valid."""
    if cfg.bs_new_sample <= 0:
        return torch.zeros_like(batch.mask)
    cert = certainty_fn(map_state, coords_global)
    return ((cert < cfg.new_certainty_thre)
            & (torch.abs(batch.sdf_label) < cfg.surface_sample_range_m * 3.0) & batch.mask)


class ShardedSlamSystem:
    """``SlamSystem``'s loop over a map sharded on the ranks of ``group``
    (the default process group when None; ``n_devices`` must be None or
    its size). ``device=None`` means the CUDA card (on an NCCL group);
    ``device="cpu"`` runs on the CPU (on a gloo group)."""

    def __init__(self, cfg: Config, n_devices: Optional[int] = None, total_frames: int = 1024,
                 device=None, group=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.mesh = make_driver_mesh(n_devices, group, dev)
        self.n_shards = self.mesh.size
        self.total_frames = total_frames
        self.key = torch.Generator(device=dev)
        self.key.manual_seed(cfg.seed)

        self.nb_offs = neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
        self.encode_vecs, _ = make_encoder(
            num_bands=cfg.pos_encoding_band,
            freq=cfg.pos_encoding_freq,
            base=cfg.pos_encoding_base,
            use_gaussian=cfg.use_gaussian_pe,
            input_dim=cfg.pos_input_dim,
            seed=cfg.seed,
        )
        self.map_state = init_shard(cfg, self.mesh, dev)
        self.local_map = lm.init_local_map(cfg.local_map_capacity, cfg.local_map_hash_size,
                                           device=dev)
        self.pool = pl.init_pool(cfg.pool_capacity, cfg.max_scan_points * cfg.all_sample_n,
                                 max(cfg.color_channel, 1), device=dev)
        self.mlp = dec.init_mlp(self.key, cfg.feature_dim + cfg.position_dim,
                                cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1, cfg.mlp_bias_on)
        self.stages = make_sharded_stages(cfg, self.mesh, self.nb_offs, self.encode_vecs)
        self.tracker = iekf.IEKF(
            iekf.IEKFConfig(
                measurement_noise_covariance=cfg.measurement_noise_covariance,
                bias_noise_covariance=cfg.bias_noise_covariance,
                max_iteration=cfg.reg_iter_n,
                term_thre_deg=cfg.reg_term_thre_deg,
                term_thre_m=cfg.reg_term_thre_m,
            ),
            init_bg=cfg.init_bg,
            init_ba=cfg.init_ba,
            init_grav=cfg.init_gravity,
        )
        self.odom_poses = np.tile(np.eye(4), (total_frames, 1, 1))
        self.travel_dist = np.zeros(total_frames)
        self.travel_dist_dev = torch.zeros(total_frames, device=dev)
        self.last_pose = np.eye(4)
        self.lose_track = False
        self.failed = False
        self.adaptive_iter_offset = 0
        self._last_losses = torch.zeros(2, device=dev)
        self.map_log = []  # (frame_id, mapping steps) of each mapped frame
        self.processed = 0

    # ------------------------------------------------------------------ frame
    def process_frame(self, frame_id: int, points: np.ndarray, imu_window=None,
                      draws: Optional[dict] = None):
        """One frame of sensor-frame points [N,3+] and IMU rows [k,7] of
        (dt, acc, gyro). ``draws`` injects the frame's random numbers (keys
        "sample", "append", "batches", as ``StreamingSlam.process_frame``
        takes them) in place of the generator's."""
        cfg, dev = self.cfg, self.device
        draws = draws or {}
        p_cap = cfg.max_scan_points
        n = min(len(points), p_cap)
        buf = np.zeros((p_cap, 3), np.float32)
        buf[:n] = np.asarray(points)[:n, :3]
        mask = np.zeros(p_cap, bool)
        mask[:n] = True
        pts = torch.from_numpy(buf).to(dev)
        pmask = torch.from_numpy(mask).to(dev) & crop_mask(
            pts, cfg.min_z, cfg.max_z, cfg.min_range, cfg.max_range)
        train_mask = voxel_down_sample_mask(pts, pmask, cfg.vox_down_m, cfg.map_hash_size)

        # IMU propagation on the host in float64 (the classic loop's)
        if frame_id > 0 and imu_window is not None:
            for row in imu_window:
                self.tracker.predict(row[1:4], row[4:7], float(row[0]))

        if frame_id > 0 and cfg.track_on:
            src_mask = voxel_down_sample_mask(pts, train_mask, cfg.source_vox_down_m,
                                              cfg.map_hash_size)
            s_cap = cfg.max_source_points
            n_src = int(torch.sum(src_mask.to(torch.int32)))
            src_pts = pts[compact_indices(src_mask, s_cap)]
            smask = torch.arange(s_cap, device=dev) < n_src
            x = self.tracker.x
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
            rot, pos, rest, P, ok, _ = self.stages.tracker_update(
                self.map_state, self.mlp, src_pts, smask, f32(x.rot), f32(x.pos),
                f32(np.concatenate([x.vel, x.bg, x.ba, x.grav])), f32(self.tracker.P),
                self.travel_dist_dev, frame_id, cfg.diff_travel_dist_local,
            )
            rot = rot.cpu().double().numpy()
            u, _, vt = np.linalg.svd(rot)
            rot = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
            rest = rest.cpu().double().numpy()
            self.tracker.x = iekf.IEKFState(
                rot=rot, pos=pos.cpu().double().numpy(), vel=rest[0:3], bg=rest[3:6],
                ba=rest[6:9], grav=rest[9:12],
            )
            self.tracker.P = P.cpu().double().numpy()
            self.lose_track = not bool(ok)
        pose = self.tracker.x.pose_matrix()

        tran = np.linalg.norm((np.linalg.inv(self.last_pose) @ pose)[:3, 3])
        self.failed |= bool(tran > cfg.surface_sample_range_m * 40.0)
        self.odom_poses[frame_id] = pose
        self.travel_dist[frame_id] = self.travel_dist[max(frame_id - 1, 0)] + tran
        self.travel_dist_dev[frame_id] = float(self.travel_dist[frame_id])
        self.last_pose = pose

        if not self.lose_track:
            self._map_prep(frame_id, pts, train_mask, pose, draws)
            self._map_opt(frame_id, draws)
        self.processed = frame_id + 1

    def _map_prep(self, frame_id, pts, train_mask, pose, draws):
        cfg, st = self.cfg, self.stages
        pose_d = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        world = transform_points(pts, pose_d)
        filter_now = (frame_id + 1) % cfg.pool_filter_freq == 0
        self.local_map = lm.update_local_map(
            self.local_map, pose_d[:3, 3], world, train_mask, cfg.local_voxel_size_m,
            cfg.local_map_size, crop_now=filter_now,
        )
        batch = st.sampler(pts, train_mask, pose_d, self.local_map, cfg.local_voxel_size_m,
                           generator=self.key, draws=draws.get("sample"))
        coords_global = transform_points(batch.coords, pose_d)
        surf_rows = (1 + cfg.surface_sample_n) * pts.shape[0]
        upd_sel = batch.mask & (
            torch.abs(batch.sdf_label) < cfg.surface_sample_range_m * cfg.map_surface_ratio)
        self.map_state, _ = st.insert_fn(
            self.map_state, coords_global[:surf_rows], upd_sel[:surf_rows],
            self.travel_dist_dev, frame_id, cfg.diff_travel_dist_local,
        )
        if filter_now:
            self.pool = pl.filter_pool(self.pool, pose_d[:3, 3], cfg.window_radius)
        is_new = is_new_samples(cfg, st.certainty_fn, self.map_state, coords_global, batch)
        self.adaptive_iter_offset = 0
        if cfg.bs_new_sample > 0 and cfg.adaptive_iters:
            cur = max(int(torch.sum(batch.mask.to(torch.int32))), 1)
            ratio = float(torch.sum(is_new.to(torch.int32))) / cur
            if ratio < cfg.new_sample_ratio_less:
                self.adaptive_iter_offset = -5
            elif ratio > cfg.new_sample_ratio_more:
                self.adaptive_iter_offset = 5
                if frame_id > cfg.freeze_after_frame and ratio > cfg.new_sample_ratio_restart:
                    self.adaptive_iter_offset = 10
        self.pool = pl.append_samples(
            self.pool, coords_global, batch.sdf_label, batch.weight, batch.mask, frame_id,
            is_new, uniform=draws.get("append"), generator=self.key,
        )

    def _map_opt(self, frame_id, draws):
        cfg = self.cfg
        iters = cfg.iters * cfg.init_iter_ratio if frame_id == 0 else cfg.iters
        iters = max(1, iters + self.adaptive_iter_offset)
        self.map_log.append((frame_id, iters))
        mlp_scale = 0.0 if frame_id >= cfg.freeze_after_frame else 1.0
        map_fn = self.stages.mapping_fn if frame_id > 0 else self.stages.mapping_fn_init
        self.map_state, self.mlp, self._last_losses = map_fn(
            self.map_state, self.mlp, self.pool, self.travel_dist_dev, frame_id,
            cfg.diff_travel_dist_local, iters, mlp_scale, generator=self.key,
            batch_draws=draws.get("batches"),
        )

    def neural_point_count(self) -> int:
        """Live points over every shard (a collective: every rank calls it)."""
        return sp.total_count(self.map_state, self.mesh)
