"""The classic SLAM driver (port of clid_slam_tpu/pipeline/slam.py): the
per-frame loop over a directory of scans and IMU files, with the host f64
filter, checkpoint/resume and the post-PGO map adjustment.

Equivalent of the reference's slam.py:43-473 main loop:
read -> preprocess (+ host IMU propagation) -> iterated IESEKF update ->
dynamic filter -> map prep (local map, sampling, neural point insertion,
replay pool) -> map optimization -> BA -> results and artifacts.

The host orchestrates and keeps the filter in numpy f64; the measurement
model, map prep and mapping run on the device. Tracked frames map through
the single-batch body with ``use_pallas=cfg.map_pallas`` (the fused kernel
``ops/map_loop.py`` on the card), and the tracker re-queries the map at
every iteration (``iekf.make_update_iterated_fn``). After ``adjust_map``
every map query runs in the post-PGO mode (``rotate_vecs=True``).

Meshing (``mesher.py``): ``mesh_default_on`` writes a local mesh around the
pose every ``mesh_freq_frame`` frames and ``sdf_default_on`` an SDF slice
every ``sdfslice_freq_frame`` (``vis_sdf_slice_v`` adds the vertical one),
the control channel's ``mesh_now`` and ``slice_now`` once, and
``finalize`` writes ``mesh.ply`` of the whole map with ``save_mesh`` (its
vertices colored, or labelled with the free-space vertices dropped, when
the color or semantic head is on). Their time is ``FrameStats``'
``"mesh"`` entry.

CLI: ``python -m clid_slam_torch.pipeline.slam config.yaml [dataset] [seq]
[seed] [--device cpu]`` (the card unless ``--device`` says otherwise).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..mapping import mapper as mp
from ..mapping import pool as pl
from ..mapping import prep as prp
from ..mapping.bundle_adjustment import make_ba_fn
from ..mapping.dynamic_filter import make_dynamic_filter_fn
from ..mesher import SEM_KITTI_COLORS, Mesher, filter_mesh_vertices
from ..models import decoder as dec
from ..models import local_map as lm
from ..models import neural_map as nm
from ..odometry import iekf
from ..ops.encoding import make_encoder
from ..ops.voxel import neighbor_offsets
from ..utils import io
from ..utils import observability as obs
from ..utils.transforms import transform_points
from .dataset import SLAMDataset
from .streaming import _max_valid_dist2, mapping_kwargs, prep_kwargs

def _mlp_arrays(prefix: str, mlp: dec.MLPParams) -> dict:
    """Flatten an MLPParams (any depth) into npz-friendly named arrays."""
    out = {}
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        out[f"{prefix}_w{i}"] = w.detach().cpu().numpy()
        out[f"{prefix}_b{i}"] = b.detach().cpu().numpy()
    out[f"{prefix}_w_out"] = mlp.w_out.detach().cpu().numpy()
    out[f"{prefix}_b_out"] = mlp.b_out.detach().cpu().numpy()
    return out


def _mlp_from_arrays(prefix: str, z, device) -> dec.MLPParams:
    t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
    ws, bs = [], []
    i = 0
    while f"{prefix}_w{i}" in z:
        ws.append(t(f"{prefix}_w{i}"))
        bs.append(t(f"{prefix}_b{i}"))
        i += 1
    return dec.MLPParams(ws, bs, t(f"{prefix}_w_out"), t(f"{prefix}_b_out"))


@dataclass
class FrameStats:
    frame_id: int = 0
    pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    tracking_ok: bool = True
    track_iters: int = 0
    new_point_ratio: float = 0.0
    sdf_loss: float = 0.0
    eik_loss: float = 0.0
    iters: int = 0
    timings: dict = field(default_factory=dict)


class SlamSystem:
    """``device=None`` means the CUDA card; pass ``device="cpu"`` to run on
    the CPU."""

    def __init__(self, cfg: Config, total_frames: int = 0, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        # one generator for every draw, seeded as StreamingSlam's, so the
        # two drivers run the same random experiment
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
        self.max_valid_dist2 = _max_valid_dist2(cfg)

        self.map_state = nm.init_map(
            cfg.map_capacity, cfg.map_hash_size, cfg.feature_dim,
            cfg.feature_dim if cfg.color_on else 1, device=dev,
        )
        self.local_map = lm.init_local_map(
            cfg.local_map_capacity, cfg.local_map_hash_size, device=dev
        )
        self.pool = pl.init_pool(
            cfg.pool_capacity, cfg.max_scan_points * cfg.all_sample_n,
            max(cfg.color_channel, 1), device=dev,
        )
        d_in = cfg.feature_dim + cfg.position_dim
        self.mlp = dec.init_mlp(
            self.key, d_in, cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1, cfg.mlp_bias_on
        )
        self.color_mlp = dec.init_mlp(
            self.key, d_in, cfg.color_mlp_hidden_dim, cfg.color_mlp_level,
            max(cfg.color_channel, 1), cfg.mlp_bias_on,
        )
        self.sem_mlp = dec.init_mlp(
            self.key, d_in, cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level,
            cfg.sem_class_count if cfg.semantic_on else 1, cfg.mlp_bias_on,
        )
        if cfg.load_model and cfg.model_path and os.path.isfile(cfg.model_path):
            self.load_decoder(cfg.model_path)

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
        if total_frames == 0:
            total_frames = 1024
        self.dataset = SLAMDataset(cfg, tracker=self.tracker, min_frames=total_frames, device=dev)
        total_frames = max(self.dataset.total_pc_count, total_frames)
        self.total_frames = total_frames
        self.travel_dist_dev = torch.zeros(total_frames, device=dev)
        self.adaptive_iter_offset = 0
        self.run_path = os.path.join(cfg.output_root, cfg.run_name or "run")
        self._build_query_fns(rotate_vecs=False)
        self.stats: list = []
        # runtime steering (pause / mesh-now / cadence overrides) — the headless
        # ControlPacket equivalent (gui/gui_utils.py:180-220)
        from .control import ControlChannel

        self.control = ControlChannel(self.run_path)
        self.live_view = None
        if cfg.live_view_on:
            from .liveview import LiveViewPublisher

            self.live_view = LiveViewPublisher(port=cfg.live_view_port)
        from ..utils.observability import MetricsLogger

        self.metrics_logger = MetricsLogger(
            enabled=cfg.wandb_vis_on,
            run_name=cfg.run_name or cfg.name,
            run_dir=self.run_path,
            config={k: v for k, v in vars(cfg).items() if isinstance(v, (int, float, str, bool))},
            silence=cfg.silence,
        )
        self.stop_requested = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_query_fns(self, rotate_vecs: bool):
        """(Re)build every function that queries the neural map.
        ``rotate_vecs=True`` is the post-PGO mode: relative vectors are
        expressed in each point's original frame via its stored quaternion
        (model/neural_points.py:666-671)."""
        cfg = self.cfg
        self.after_pgo = rotate_vecs
        self._prep_fns = {}
        max_sdf_std = cfg.surface_sample_range_m * cfg.max_sdf_std_ratio
        map_kw = dict(mapping_kwargs(cfg, self.nb_offs, self.encode_vecs), rotate_vecs=rotate_vecs)
        self.mapping_fn = mp.make_mapping_fn(**map_kw)
        # steady-frame fast body: the streaming loop's (static single batch,
        # expanded-duplicate training with cfg.map_dup_independent, the fused
        # kernel with cfg.map_pallas); frame 0 keeps the general body
        self.mapping_fn_fast = mp.make_mapping_fn(
            **dict(
                map_kw,
                resample_every=max(cfg.map_resample_every, cfg.iters + 10),
                max_outer=1,
                dup_independent=cfg.map_dup_independent,
                use_pallas=cfg.map_pallas,
            )
        )
        track_kw = dict(
            knn_k=cfg.query_nn_k,
            nb_offs=self.nb_offs,
            resolution=cfg.voxel_size_m,
            max_valid_dist2=self.max_valid_dist2,
            sdf_scale=cfg.sdf_scale,
            min_grad_norm=cfg.reg_min_grad_norm,
            max_grad_norm=cfg.reg_max_grad_norm,
            min_nn_count=cfg.track_mask_query_nn_k,
            mlp_leaky=cfg.mlp_leaky_relu,
            mlp_bf16=cfg.mlp_bf16,
            rotate_vecs=rotate_vecs,
            encode_vecs=self.encode_vecs,
            weighted_first=cfg.weighted_first,
            layer_norm=cfg.layer_norm_on,
            max_sdf_std=max_sdf_std,
            info_scale=cfg.tracker_info_scale,
        )
        self.h_reduce_core = iekf.make_h_reduce_fn(**track_kw)
        self.update_iterated_dev = iekf.make_update_iterated_fn(
            max_iteration=cfg.reg_iter_n,
            term_thre_deg=cfg.reg_term_thre_deg,
            term_thre_m=cfg.reg_term_thre_m,
            stagnation_iter=cfg.stagnation_iter,
            **track_kw,
        )
        self.mesher = Mesher(
            knn_k=cfg.query_nn_k,
            nb_offs=self.nb_offs,
            resolution=cfg.voxel_size_m,
            max_valid_dist2=self.max_valid_dist2,
            sdf_scale=cfg.sdf_scale,
            mesh_min_nn=cfg.mesh_min_nn,
            mlp_leaky=cfg.mlp_leaky_relu,
            mlp_bf16=cfg.mlp_bf16,
            feature_dim=cfg.feature_dim,
            rotate_vecs=rotate_vecs,
            encode_vecs=self.encode_vecs,
            weighted_first=cfg.weighted_first,
            layer_norm=cfg.layer_norm_on,
        )
        self._ba_fn = None
        if cfg.ba_freq_frame > 0:
            self._ba_fn = make_ba_fn(
                knn_k=cfg.query_nn_k,
                nb_offs=self.nb_offs,
                resolution=cfg.voxel_size_m,
                max_valid_dist2=self.max_valid_dist2,
                sdf_scale=cfg.sdf_scale,
                window_size=cfg.ba_frame,
                ba_bs=cfg.ba_bs,
                lr_pose=cfg.lr_pose,
                lr_map=cfg.lr,
                adam_eps=cfg.adam_eps,
                mlp_leaky=cfg.mlp_leaky_relu,
                mlp_bf16=cfg.mlp_bf16,
                rotate_vecs=rotate_vecs,
                encode_vecs=self.encode_vecs,
            )
        self._dyn_filter = None
        if cfg.dynamic_filter_on:
            self._dyn_filter = make_dynamic_filter_fn(
                knn_k=cfg.query_nn_k,
                nb_offs=self.nb_offs,
                resolution=cfg.voxel_size_m,
                max_valid_dist2=self.max_valid_dist2,
                sdf_scale=cfg.sdf_scale,
                certainty_thre=cfg.dynamic_certainty_thre,
                sdf_ratio_thre=cfg.dynamic_sdf_ratio_thre,
                mlp_leaky=cfg.mlp_leaky_relu,
                mlp_bf16=cfg.mlp_bf16,
                rotate_vecs=rotate_vecs,
                encode_vecs=self.encode_vecs,
            )

    def _poses_dev(self) -> torch.Tensor:
        """The dataset's trajectory over ``total_frames`` as f32 on the device."""
        return torch.as_tensor(
            self.dataset.odom_poses[: self.total_frames], dtype=torch.float32, device=self.device
        )

    def adjust_map(self, corrected_poses: np.ndarray):
        """Apply an externally optimized trajectory (PGO / offline global
        BA) to the running system: transform the neural map by the per-frame
        pose corrections (model/neural_points.py:814-838), write back the
        corrected poses, rebuild pool world coordinates, and switch every
        map query into post-PGO mode (quaternion-rotated relative vectors)."""
        d = self.dataset
        n = min(d.processed_frame, len(corrected_poses))
        old = np.asarray(d.odom_poses[:n], np.float64)
        corr = np.asarray(corrected_poses, np.float64)[:n]
        diff = np.einsum("tij,tjk->tik", corr, np.linalg.inv(old))
        diff_full = np.tile(np.eye(4, dtype=np.float32), (self.total_frames, 1, 1))
        diff_full[:n] = diff.astype(np.float32)
        self.map_state = nm.adjust_map(
            self.map_state,
            torch.as_tensor(diff_full, device=self.device),
            self.travel_dist_dev,
            self.cfg.voxel_size_m,
        )
        # rebuild pool world coords from the corrected trajectory (as the
        # BA write-back does): coords' = T_new·T_old⁻¹·coords
        old_all = self._poses_dev()
        d.odom_poses[:n] = corr
        d.cur_pose_ref = corr[-1]
        d.last_pose_ref = corr[-1]
        self.pool = pl.retransform_coords(self.pool, old_all, self._poses_dev())
        # the local raw-point map is stale after a global correction: reset
        # it (it refills from the next frames)
        self.local_map = lm.init_local_map(
            self.cfg.local_map_capacity, self.cfg.local_map_hash_size, device=self.device
        )
        if not self.after_pgo:
            self._build_query_fns(rotate_vecs=True)

    # --------------------------------------------------------------- track
    def _track(self, frame_id: int) -> bool:
        """The whole iterated IESEKF update on the device, started from the
        host filter's propagated state, then written back to it in f64."""
        d = self.dataset
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        x = self.tracker.x
        rest0 = np.concatenate([x.vel, x.bg, x.ba, x.grav])
        with obs.span("frame.track", str(frame_id)):
            rot, pos, rest, P, ok, n_iter = self.update_iterated_dev(
                self.map_state, self.mlp, d.cur_source_points, d.cur_source_mask,
                f32(x.rot), f32(x.pos), f32(rest0), f32(self.tracker.P),
                self.travel_dist_dev, frame_id, self.cfg.diff_travel_dist_local,
            )
        rot = rot.cpu().double().numpy()
        # re-orthonormalize: f32 accumulation over iterations drifts the
        # rotation slightly; project back to SO(3)
        u, _, vt = np.linalg.svd(rot)
        rot = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
        rest = rest.cpu().double().numpy()
        self.tracker.x = iekf.IEKFState(
            rot=rot,
            pos=pos.cpu().double().numpy(),
            vel=rest[0:3],
            bg=rest[3:6],
            ba=rest[6:9],
            grav=rest[9:12],
        )
        self.tracker.P = P.cpu().double().numpy()
        self._last_track_iters = int(n_iter)
        ok = bool(ok)
        d.lose_track = not ok
        d.update_odom_pose(self.tracker.x.pose_matrix())
        return ok

    # ------------------------------------------------------------ map prep
    def _map_prep(self, frame_id: int, pose: np.ndarray, draws: dict) -> float:
        """The device prep step (mapping/prep.py), the prune cadence and the
        host's adaptive-iteration bookkeeping (utils/mapper.py:446-459)."""
        cfg = self.cfg
        d = self.dataset
        filter_now = (frame_id + 1) % cfg.pool_filter_freq == 0
        prep = self._prep_fns.get(filter_now)
        if prep is None:
            prep = prp.make_prep_fn(filter_pool_now=filter_now, **prep_kwargs(cfg))
            self._prep_fns[filter_now] = prep
        with obs.span("frame.prep", str(frame_id)):
            res = prep(
                self.map_state, self.local_map, self.pool, d.cur_points, d.cur_mask,
                torch.as_tensor(pose, dtype=torch.float32, device=self.device),
                self.travel_dist_dev, frame_id, cfg.diff_travel_dist_local,
                generator=self.key, sample_draws=draws.get("sample"),
                append_uniform=draws.get("append"),
                colors=d.cur_colors if cfg.color_on else None,
                sem_labels=d.cur_sem if cfg.semantic_on else None,
            )
        self.map_state = res.map_state
        self.local_map = res.local_map
        self.pool = res.pool

        # prune + rehash cadence (utils/mapper.py:274-278)
        if cfg.prune_map_on and (frame_id + 1) % cfg.prune_freq_frame == 0:
            self.map_state = nm.prune_and_rehash(
                self.map_state, cfg.max_prune_certainty, self.travel_dist_dev, frame_id,
                cfg.diff_travel_dist_local, cfg.voxel_size_m,
            )

        # adaptive iteration offset (utils/mapper.py:446-459)
        self.adaptive_iter_offset = 0
        if cfg.adaptive_iters and cfg.bs_new_sample > 0:
            cur_count = max(int(res.cur_sample_count), 1)
            new_obs_ratio = float(res.new_sample_count) / cur_count
            if new_obs_ratio < cfg.new_sample_ratio_less:
                self.adaptive_iter_offset = -5
            elif new_obs_ratio > cfg.new_sample_ratio_more:
                self.adaptive_iter_offset = 5
                if frame_id > cfg.freeze_after_frame and new_obs_ratio > cfg.new_sample_ratio_restart:
                    self.adaptive_iter_offset = 10
        return float(res.new_point_ratio)

    # ------------------------------------------------------------- mapping
    def _map_opt(self, frame_id: int, draws: dict) -> tuple:
        cfg = self.cfg
        cur_iters = cfg.iters * cfg.init_iter_ratio if frame_id == 0 else cfg.iters
        if self.dataset.stop_status:
            cur_iters = max(1, cur_iters - 10)
        cur_iters = max(1, cur_iters + self.adaptive_iter_offset)
        mlp_scale = 0.0 if frame_id >= cfg.freeze_after_frame else 1.0
        fn = self.mapping_fn if frame_id == 0 else self.mapping_fn_fast
        with obs.span("frame.map", str(frame_id)):
            self.map_state, self.mlp, self.color_mlp, self.sem_mlp, losses = fn(
                self.map_state, self.mlp, self.color_mlp, self.sem_mlp, self.pool,
                self.travel_dist_dev, frame_id, cfg.diff_travel_dist_local, cur_iters,
                mlp_scale, generator=self.key, batch_draws=draws.get("batches"),
            )
        losses = losses.cpu().numpy()
        return float(losses[0]), float(losses[1]), cur_iters

    def _ensure_capacity(self, frame_id: int):
        """Grow the per-frame state when streaming past the initial
        ``total_frames`` estimate (amortized doubling)."""
        if frame_id < self.total_frames:
            return
        new_total = max(self.total_frames * 2, frame_id + 1)
        td = torch.zeros(new_total, device=self.device)
        td[: self.total_frames] = self.travel_dist_dev
        self.travel_dist_dev = td
        d = self.dataset
        grow = new_total - len(d.odom_poses)
        if grow > 0:
            d.odom_poses = np.concatenate([d.odom_poses, np.tile(np.eye(4), (grow, 1, 1))])
            d.travel_dist = np.concatenate([d.travel_dist, np.zeros(grow)])
        self.total_frames = new_total

    # --------------------------------------------------------------- frame
    def process_frame(
        self,
        frame_id: int,
        points: Optional[np.ndarray] = None,
        imu_window: Optional[np.ndarray] = None,
        point_ts=None,
        draws: Optional[dict] = None,
    ) -> FrameStats:
        """One frame, read from disk (``points=None``: the scan and its IMU
        window) or from in-memory arrays. ``draws`` injects the frame's
        random numbers (keys "sample", "append", "batches", as
        ``StreamingSlam.process_frame`` takes them) in place of the
        generator's."""
        cfg = self.cfg
        d = self.dataset
        draws = draws or {}
        self._ensure_capacity(frame_id)
        ctl = self.control.poll()
        if ctl.stop:
            self.stop_requested = True
        if "mesh_res_m" in ctl.overrides:
            cfg.mc_res_m = float(ctl.overrides["mesh_res_m"])
        if "mesh_freq_frame" in ctl.overrides:
            cfg.mesh_freq_frame = int(ctl.overrides["mesh_freq_frame"])
        if "sdfslice_freq_frame" in ctl.overrides:
            cfg.sdfslice_freq_frame = int(ctl.overrides["sdfslice_freq_frame"])
        st = FrameStats(frame_id=frame_id)
        t0 = time.perf_counter()

        if points is not None:
            d.read_frame_arrays(points, point_ts)
        else:
            d.read_frame(frame_id)
            imu_window = d.read_imu_window(frame_id)

        if not d.preprocess_frame(imu_window):
            d.processed_frame += 1
            return st
        self._sync()
        t1 = time.perf_counter()

        if frame_id > 0 and cfg.track_on:
            st.tracking_ok = self._track(frame_id)
            st.track_iters = getattr(self, "_last_track_iters", 0)
        else:
            # first frame: the map frame is anchored to the tracker's state
            # (gt[0] if provided and not first_frame_ref, else wherever the
            # filter was initialized — usually identity)
            if cfg.track_on:
                if d.gt_pose_provided and not cfg.first_frame_ref:
                    self.tracker.x.rot = d.gt_poses[0][:3, :3].copy()
                    self.tracker.x.pos = d.gt_poses[0][:3, 3].copy()
                d.cur_pose_ref = self.tracker.x.pose_matrix()
                d.last_pose_ref = d.cur_pose_ref
            elif d.gt_pose_provided:
                d.cur_pose_ref = d.gt_poses[0].copy()
                d.last_pose_ref = d.cur_pose_ref
            d.odom_poses[frame_id] = d.cur_pose_ref
        st.pose = d.cur_pose_ref.copy()
        self.travel_dist_dev = self.travel_dist_dev.clone()  # callers may hold the old one
        self.travel_dist_dev[frame_id] = float(d.travel_dist[frame_id])
        t2 = time.perf_counter()

        valid_mapping = (not d.lose_track) and (not d.stop_status)
        if valid_mapping:
            if self._dyn_filter is not None and frame_id > 0:
                # drop measurements landing in confidently observed free
                # space (slam.py:170-176 passes filter_dynamic for frame>0)
                with obs.span("frame.filter", str(frame_id)):
                    pose_d = torch.as_tensor(d.cur_pose_ref, dtype=torch.float32, device=self.device)
                    world = transform_points(d.cur_points, pose_d)
                    d.cur_mask = self._dyn_filter(
                        self.map_state, self.mlp, world, d.cur_mask, self.travel_dist_dev,
                        frame_id, cfg.diff_travel_dist_local,
                    )
            st.new_point_ratio = self._map_prep(frame_id, d.cur_pose_ref, draws)
        self._sync()
        t3 = time.perf_counter()

        if frame_id % cfg.mapping_freq_frame == 0:
            st.sdf_loss, st.eik_loss, st.iters = self._map_opt(frame_id, draws)
        if (
            self._ba_fn is not None
            and frame_id >= cfg.ba_frame
            and (frame_id + 1) % cfg.ba_freq_frame == 0
        ):
            with obs.span("ba", str(frame_id)):
                self._bundle_adjust(frame_id)
        self._sync()
        t4 = time.perf_counter()

        # periodic in-loop reconstruction artifacts (the reference's
        # slam.py:247-321 ships these to its GUI; headless, PLY files)
        mesh_now = ctl.mesh_now or (
            cfg.mesh_default_on and (frame_id == 0 or (frame_id + 1) % cfg.mesh_freq_frame == 0)
        )
        slice_now = ctl.slice_now or (
            cfg.sdf_default_on and (frame_id == 0 or (frame_id + 1) % cfg.sdfslice_freq_frame == 0)
        )
        if mesh_now:
            self._write_local_mesh(frame_id)
        if slice_now:
            self._write_sdf_slice(frame_id)
        t_mesh = time.perf_counter() - t4 if mesh_now or slice_now else 0.0
        if cfg.log_freq_frame > 0 and (frame_id + 1) % cfg.log_freq_frame == 0:
            # periodic odometry log (utils/slam_dataset.py:664-682)
            os.makedirs(os.path.join(self.run_path, "pose_log"), exist_ok=True)
            io.write_ply(
                os.path.join(self.run_path, "pose_log", f"{frame_id}.ply"),
                d.odom_poses[: frame_id + 1, :3, 3].astype(np.float32),
            )

        st.timings = {
            "preprocess": t1 - t0,
            "tracking": t2 - t1,
            "map_prep": t3 - t2,
            "map_opt": t4 - t3,
            "mesh": t_mesh,
        }
        d.time_table.append([t1 - t0, t2 - t1, t3 - t2, t4 - t3, t_mesh])
        d.processed_frame += 1
        self.stats.append(st)
        self.metrics_logger.log_frame(
            frame_id, st.timings, {"sdf": st.sdf_loss, "eikonal": st.eik_loss}
        )
        if self.live_view is not None:
            # the per-frame basics; map points every 10 frames
            scan = None
            if d.cur_source_points is not None:
                sp = d.cur_source_points.cpu().numpy()
                sm = d.cur_source_mask.cpu().numpy()
                R, t = st.pose[:3, :3], st.pose[:3, 3]
                scan = sp[sm] @ R.T + t
            self.live_view.publish_frame(
                frame_id, st.pose, scan, traj=d.odom_poses[: frame_id + 1, :3, 3]
            )
            if frame_id % 10 == 0:
                cnt = int(self.map_state.count)
                self.live_view.publish_neural_points(
                    frame_id, self.map_state.positions[:cnt].cpu().numpy()
                )
        return st

    # ------------------------------------------------- in-loop vis artifacts
    def _write_local_mesh(self, frame_id: int):
        """Local-window mesh around the current pose (the reference's
        vis_mesh path, slam.py:247-276, chunked from map points)."""
        cfg = self.cfg
        n = int(self.map_state.count)
        if n == 0:
            return
        pts = self.map_state.positions[:n].cpu().numpy()
        center = self.dataset.cur_pose_ref[:3, 3]
        local = pts[np.linalg.norm(pts - center, axis=-1) < cfg.max_range]
        if len(local) == 0:
            return
        v, t = self.mesher.recon_aabb_mesh(
            self.map_state, self.mlp, local.min(0), local.max(0), cfg.mc_res_m, cfg.pad_voxel,
            cfg.min_cluster_vertices, guide_points=local, skip_top_voxel=cfg.skip_top_voxel,
        )
        if len(v):
            os.makedirs(os.path.join(self.run_path, "mesh"), exist_ok=True)
            io.write_ply_mesh(os.path.join(self.run_path, "mesh", f"mesh_{frame_id}.ply"), v, t)

    def _write_sdf_slice(self, frame_id: int):
        """Horizontal SDF slice (reference slam.py:293-308 semantics: half
        max_range extent at pose height + slice offset), plus the vertical
        y-z slice through the pose when vis_sdf_slice_v is set
        (utils/mesher.py:246-279)."""
        cfg = self.cfg
        center = self.dataset.cur_pose_ref[:3, 3]
        extent = cfg.max_range / 2.0
        slices = [("slice", self.mesher.sdf_slice(
            self.map_state, self.mlp, center, extent, float(center[2]) + cfg.sdf_slice_height,
            cfg.vis_sdf_res_m,
        ))]
        if cfg.vis_sdf_slice_v:
            slices.append(("slice_v", self.mesher.sdf_slice_vertical(
                self.map_state, self.mlp, center, extent, float(center[0]), cfg.vis_sdf_res_m,
            )))
        for name, (pts, sdf, ok) in slices:
            if not ok.any():
                continue
            os.makedirs(os.path.join(self.run_path, "sdf_slice"), exist_ok=True)
            bound = cfg.surface_sample_range_m * 4.0
            c = np.clip((sdf[ok] + bound) / (2 * bound), 0, 1)
            colors = np.stack([c, np.zeros_like(c), 1.0 - c], -1)
            io.write_ply(os.path.join(self.run_path, "sdf_slice", f"{name}_{frame_id}.ply"),
                         pts[ok], colors=colors)

    # ---------------------------------------------------------------- BA
    def _bundle_adjust(self, frame_id: int):
        """Sliding-window pose+feature refinement (utils/mapper.py:866-965);
        afterwards the pool's world coords are rebuilt from the corrected
        poses (utils/mapper.py:323-327)."""
        cfg = self.cfg
        d = self.dataset
        lo = frame_id - cfg.ba_frame + 1
        poses0 = torch.as_tensor(d.odom_poses[lo : frame_id + 1], dtype=torch.float32,
                                 device=self.device)
        self.map_state, new_poses, _ = self._ba_fn(
            self.map_state, self.mlp, self.pool, poses0, lo, self.travel_dist_dev, frame_id,
            cfg.diff_travel_dist_local, cfg.ba_iters, generator=self.key,
        )
        new_poses = new_poses.cpu().double().numpy()
        old_all = self._poses_dev()
        d.odom_poses[lo : frame_id + 1] = new_poses
        d.cur_pose_ref = new_poses[-1]
        d.last_pose_ref = new_poses[-1]
        self.pool = pl.retransform_coords(self.pool, old_all, self._poses_dev())

    # ------------------------------------------------------------ finalize
    def finalize(self, run_path: str) -> dict:
        cfg = self.cfg
        os.makedirs(run_path, exist_ok=True)
        result = self.dataset.write_results(run_path)
        n = int(self.map_state.count)
        result["neural_points"] = n
        result["map_memory_mb"] = nm.memory_mb(self.map_state, cfg.feature_dim)
        if cfg.save_map:
            self.save_checkpoint(os.path.join(run_path, "map_checkpoint.npz"))
            pts = self.map_state.positions[:n].cpu().numpy()
            # PCA-colored features (the GUI's neural-point view,
            # utils/tools.py:858-923)
            colors = None
            if n > 8:
                from ..utils.plots import feature_pca_colors

                colors, _ = feature_pca_colors(self.map_state.geo_feats[:n].cpu().numpy())
            io.write_ply(os.path.join(run_path, "neural_points.ply"), pts, colors=colors)
        if cfg.save_mesh and n > 0:
            pts = self.map_state.positions[:n].cpu().numpy()
            v, t = self.mesher.recon_aabb_mesh(
                self.map_state, self.mlp, pts.min(0), pts.max(0), cfg.mc_res_m, cfg.pad_voxel,
                cfg.min_cluster_vertices, guide_points=pts, skip_top_voxel=cfg.skip_top_voxel,
            )
            colors = None
            if cfg.semantic_on:
                # semantic vertex labels; free-space vertices dropped
                # (utils/mesher.py:401-423 semantics)
                labels, keep = self.mesher.estimate_vertex_sem(self.map_state, self.sem_mlp, v)
                v, t, kept = filter_mesh_vertices(v, t, keep)
                colors = SEM_KITTI_COLORS[np.clip(labels[kept], 0, len(SEM_KITTI_COLORS) - 1)]
            elif cfg.color_on:
                colors = self.mesher.estimate_vertex_colors(
                    self.map_state, self.color_mlp, v, cfg.color_channel
                )
            io.write_ply_mesh(os.path.join(run_path, "mesh.ply"), v, t, colors=colors)
            result["mesh_vertices"] = len(v)
        if cfg.save_merged_pc and self.dataset.total_pc_count > 0:
            out = self.dataset.write_merged_point_cloud(run_path)
            if out:
                result["merged_point_cloud"] = out
        with open(os.path.join(run_path, "metrics.json"), "w") as f:
            json.dump(result, f, indent=2)
        self.metrics_logger.log_final(result)
        self.metrics_logger.finish()
        return result

    # ------------------------------------------------- checkpoint / resume
    def save_checkpoint(self, path: str):
        """Full mid-sequence state in the JAX package's layout (map,
        decoders, pool, filter, poses; a JAX ``SlamSystem`` loads it), plus
        the generator's state (``gen_state``)."""
        a = lambda x: x.detach().cpu().numpy()
        ms = self.map_state
        np.savez_compressed(
            path,
            voxel_size_m=self.cfg.voxel_size_m,
            sdf_scale=self.cfg.sdf_scale,
            num_nei_cells=self.cfg.num_nei_cells,
            search_alpha=self.cfg.search_alpha,
            query_nn_k=self.cfg.query_nn_k,
            positions=a(ms.positions),
            quats=a(ms.quats),
            geo_feats=a(ms.geo_feats),
            color_feats=a(ms.color_feats),
            certainty=a(ms.certainty),
            ts_create=a(ms.ts_create),
            ts_update=a(ms.ts_update),
            count=a(ms.count),
            hash_table=a(ms.hash_table),
            hash_mirror=a(ms.hash_mirror),
            mlp_weights=a(self.mlp.weights[0]),
            mlp_biases=a(self.mlp.biases[0]),
            mlp_w_out=a(self.mlp.w_out),
            mlp_b_out=a(self.mlp.b_out),
            **_mlp_arrays("color_mlp", self.color_mlp),
            **_mlp_arrays("sem_mlp", self.sem_mlp),
            pool_data=a(self.pool.data),
            pool_valid=a(self.pool.valid),
            pool_size=a(self.pool.size),
            iekf_rot=self.tracker.x.rot,
            iekf_pos=self.tracker.x.pos,
            iekf_vel=self.tracker.x.vel,
            iekf_bg=self.tracker.x.bg,
            iekf_ba=self.tracker.x.ba,
            iekf_grav=self.tracker.x.grav,
            iekf_P=self.tracker.P,
            odom_poses=self.dataset.odom_poses,
            travel_dist=self.dataset.travel_dist,
            processed_frame=self.dataset.processed_frame,
            gen_state=self.key.get_state().numpy(),
        )

    def load_checkpoint(self, path: str):
        """Restore a ``save_checkpoint`` file of either package (the legacy
        pool layout included). A file without ``gen_state`` leaves the
        generator as it is."""
        dev = self.device
        t = lambda a, dtype=None: torch.as_tensor(np.asarray(a, dtype), device=dev)
        z = np.load(path)
        self.map_state = nm.NeuralMapState(
            positions=t(z["positions"], np.float32),
            quats=t(z["quats"], np.float32),
            geo_feats=t(z["geo_feats"], np.float32),
            color_feats=t(z["color_feats"], np.float32)
            if "color_feats" in z
            else torch.zeros((z["geo_feats"].shape[0], 1), device=dev),
            certainty=t(z["certainty"], np.float32),
            ts_create=t(z["ts_create"], np.int32),
            ts_update=t(z["ts_update"], np.int32),
            count=t(z["count"], np.int32),
            hash_table=t(z["hash_table"], np.int32),
            hash_mirror=t(z["hash_mirror"], np.float32),
        )
        self.mlp = dec.MLPParams(
            [t(z["mlp_weights"], np.float32)], [t(z["mlp_biases"], np.float32)],
            t(z["mlp_w_out"], np.float32), t(z["mlp_b_out"], np.float32),
        )
        if "color_mlp_w0" in z:
            self.color_mlp = _mlp_from_arrays("color_mlp", z, dev)
        if "sem_mlp_w0" in z:
            self.sem_mlp = _mlp_from_arrays("sem_mlp", z, dev)
        if "pool_data" in z:
            pool_data = t(z["pool_data"], np.float32)
        else:
            # legacy (pre-AoS) checkpoint layout
            n_rows = len(z["pool_coords"])
            c = self.pool.data.shape[1] - pl.BASE_COLS
            pd = np.zeros((n_rows, pl.BASE_COLS + c), np.float32)
            pd[:, 0:3] = z["pool_coords"]
            pd[:, 3] = z["pool_sdf"]
            pd[:, 4] = z["pool_weight"]
            pd[:, 5] = z["pool_ts"]
            pd[:, 6] = -1.0
            pool_data = t(pd)
        size = t(z["pool_size"], np.int32)
        valid = (
            t(z["pool_valid"], bool)
            if "pool_valid" in z
            else torch.arange(pool_data.shape[0], device=dev) < int(z["pool_size"])
        )
        self.pool = pl.ReplayPool(pool_data, valid, size, self.pool.new_buf, self.pool.new_count)
        self.tracker.x = iekf.IEKFState(
            rot=z["iekf_rot"],
            pos=z["iekf_pos"],
            vel=z["iekf_vel"],
            bg=z["iekf_bg"],
            ba=z["iekf_ba"],
            grav=z["iekf_grav"],
        )
        self.tracker.P = z["iekf_P"]
        n = int(z["processed_frame"])
        self.dataset.odom_poses[: len(z["odom_poses"])] = z["odom_poses"]
        self.dataset.travel_dist[: len(z["travel_dist"])] = z["travel_dist"]
        self.dataset.processed_frame = n
        if n > 0:
            self.dataset.cur_pose_ref = z["odom_poses"][n - 1]
            self.dataset.last_pose_ref = z["odom_poses"][n - 1]
        td = np.zeros(self.total_frames, np.float32)
        m = min(len(z["travel_dist"]), self.total_frames)
        td[:m] = z["travel_dist"][:m]
        self.travel_dist_dev = t(td)
        if "gen_state" in z:
            self.key.set_state(torch.from_numpy(z["gen_state"]))

    def load_decoder(self, path: str):
        z = np.load(path)
        t = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=self.device)
        self.mlp = dec.MLPParams(
            [t("mlp_weights")], [t("mlp_biases")], t("mlp_w_out"), t("mlp_b_out")
        )


def run_slam(config_path: str, dataset_name=None, sequence_name=None, seed=None, device=None):
    """CLI entry mirroring slam.py:43-70: ``config.yaml [dataset] [seq]
    [seed]`` with per-dataset path rewiring (utils/dataset_indexing.py:9-117).
    Returns ``finalize``'s metrics; ``device=None`` means the card."""
    from .dataset_indexing import set_dataset_path

    cfg = Config.load(config_path)
    if dataset_name:
        set_dataset_path(cfg, dataset_name, sequence_name or "")
        cfg.run_name = cfg.name
    if seed is not None:
        cfg.seed = int(seed)
    system = SlamSystem(cfg, device=device)
    n = system.dataset.total_pc_count
    for frame_id in range(n):
        st = system.process_frame(frame_id)
        if system.stop_requested:
            print(f"control channel: stop requested at frame {frame_id}")
            break
        if not cfg.silence:
            t = sum(st.timings.values())
            print(
                f"frame {frame_id}: {t*1e3:.1f} ms, loss {st.sdf_loss:.4f}, "
                f"points {int(system.map_state.count)}"
            )
    return system.finalize(system.run_path)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m clid_slam_torch.pipeline.slam")
    ap.add_argument("config")
    ap.add_argument("dataset", nargs="?")
    ap.add_argument("sequence", nargs="?")
    ap.add_argument("seed", nargs="?")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run_slam(a.config, a.dataset, a.sequence, a.seed, device=a.device)


if __name__ == "__main__":
    main()
