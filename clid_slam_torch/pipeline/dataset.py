"""Dataset frontend of the classic driver (port of
clid_slam_tpu/pipeline/dataset.py): per-frame IO, preprocessing, pose
bookkeeping.

Capabilities of the reference SLAMDataset (utils/slam_dataset.py:90-990):
frame loading (bin/ply/pcd), LiDAR->IMU extrinsic transform, per-point
timestamp estimation for deskewing, per-frame IMU CSV ingestion + host
filter propagation, adaptive-range cropping, voxel downsampling for mapping
and registration, odometry pose bookkeeping with stop/failure detection,
travel distance accumulation, and result writing (poses + metrics).

Every cloud leaving this class is a fixed-size (points, mask) pair of
tensors on the system's device: downsampling and cropping update masks on
the device, and the host only pads once per frame. Scans are read through
the port's native prefetcher (``clid_slam_torch/native``) when g++ built
it, else through the numpy readers of ``utils/io.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..ops.voxel import voxel_down_sample_mask
from ..utils import io, metrics, plots
from ..utils.transforms import adaptive_crop_range, crop_mask, deskew


def _rot_close_to_identity(T: np.ndarray, rot_thre: float, tran_thre: float) -> bool:
    """utils/tools.py:839-855."""
    return bool(
        np.all(np.abs(T[:3, :3] - np.eye(3)) < rot_thre)
        and np.all(np.abs(T[:3, 3]) < tran_thre)
    )


def intrinsic_correct(points: np.ndarray, correct_deg: float) -> np.ndarray:
    """KITTI vertical-angle intrinsic correction
    (utils/slam_dataset.py:1263-1291; 0.195 deg for KITTI odometry)."""
    if correct_deg == 0.0:
        return points
    out = points.copy()
    dist = np.linalg.norm(points[:, :3], axis=1)
    var = np.deg2rad(correct_deg)
    v_ang = np.arcsin(np.clip(points[:, 2] / np.clip(dist, 1e-12, None), -1, 1))
    v_ang_c = v_ang + var
    hor_scale = np.cos(v_ang_c) / np.clip(np.cos(v_ang), 1e-9, None)
    out[:, 0] *= hor_scale
    out[:, 1] *= hor_scale
    out[:, 2] = dist * np.sin(v_ang_c)
    return out


def _calib_matrix(tr) -> Optional[np.ndarray]:
    """A calibration ``Tr`` of 12 (3x4) or 16 (4x4) values as a 4x4
    matrix, or None."""
    if tr is None:
        return None
    tr = np.asarray(tr, np.float64).reshape(-1)
    T = np.eye(4)
    T[: len(tr) // 4] = tr.reshape(-1, 4)
    return T


class SLAMDataset:
    """``device=None`` means the CUDA card, as for the drivers."""

    def __init__(self, cfg: Config, tracker=None, min_frames: int = 1024, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracker = tracker  # host IEKF, wired by the classic driver
        self._min_frames = min_frames

        self.pc_filenames = []
        self.kiss_loader = None
        if cfg.use_kiss_dataloader:
            # kiss-icp dataloader mode (utils/slam_dataset.py:58-81): frames
            # (and gt poses / calibration when the loader carries them) come
            # from kiss_icp.datasets.dataset_factory. The optional package
            # is imported lazily.
            try:
                from kiss_icp.datasets import dataset_factory
            except ImportError as e:
                raise ImportError(
                    "use_kiss_icp_dataloader requires the optional "
                    "kiss-icp package (pip install kiss-icp)"
                ) from e
            from pathlib import Path

            self.kiss_loader = dataset_factory(
                dataloader=cfg.data_loader_name,
                data_dir=Path(cfg.pc_path),
                sequence=cfg.data_loader_seq,
                topic=cfg.data_loader_seq,
            )
            cfg.end_frame = min(len(self.kiss_loader), cfg.end_frame)
        elif cfg.pc_path and os.path.isdir(cfg.pc_path):
            self.pc_filenames = sorted(
                f
                for f in os.listdir(cfg.pc_path)
                if os.path.splitext(f)[1].lower() in (".bin", ".ply", ".pcd", ".las")
            )[cfg.begin_frame : cfg.end_frame : cfg.step_frame]
        self.total_pc_count = len(self.pc_filenames)
        if self.kiss_loader is not None:
            self.total_pc_count = max(
                (cfg.end_frame - cfg.begin_frame) // max(cfg.step_frame, 1), 0
            )
        # color normalization: KITTI intensity is already [0,1]
        # (utils/slam_dataset.py:172-184)
        self.color_scale = 1.0 if cfg.kitti_correction_on else 255.0

        # ground truth (optional)
        self.gt_poses: Optional[np.ndarray] = None
        calib = None
        if cfg.calib_path and os.path.isfile(cfg.calib_path):
            calib = io.read_calib_file(cfg.calib_path).get("Tr")
        elif self.kiss_loader is not None and hasattr(self.kiss_loader, "calibration"):
            # the loader's LiDAR-to-camera transform, as the reference sets
            # calib["Tr"] from it (utils/slam_dataset.py:58-81)
            calib = _calib_matrix(self.kiss_loader.calibration.get("Tr"))
        if cfg.pose_path and os.path.isfile(cfg.pose_path):
            if cfg.pose_path.endswith(".csv") or "tum" in cfg.pose_path:
                self.gt_poses, _ = io.read_tum_poses(cfg.pose_path)
            else:
                try:
                    self.gt_poses = io.read_kitti_poses(cfg.pose_path, calib)
                except Exception:
                    self.gt_poses, _ = io.read_tum_poses(cfg.pose_path)
            if self.gt_poses is not None:
                self.gt_poses = self.gt_poses[cfg.begin_frame : cfg.end_frame : cfg.step_frame]
        if (
            self.gt_poses is None
            and self.kiss_loader is not None
            and hasattr(self.kiss_loader, "gt_poses")
        ):
            gt = np.asarray(self.kiss_loader.gt_poses, np.float64)
            if calib is not None:
                # the calibrated frame of a pose file (io.read_kitti_poses)
                gt = np.einsum("ij,njk,kl->nil", np.linalg.inv(calib), gt, calib)
            self.gt_poses = gt[cfg.begin_frame : cfg.end_frame : cfg.step_frame]
        self.gt_pose_provided = self.gt_poses is not None

        n = max(self.total_pc_count, self._min_frames)
        self.odom_poses = np.tile(np.eye(4), (n, 1, 1))
        self.travel_dist = np.zeros(n)
        self.time_table = []

        self.processed_frame = 0
        self.cur_pose_ref = np.eye(4)
        self.last_pose_ref = np.eye(4)
        self.last_odom_tran = np.eye(4)
        self.stop_count = 0
        self.stop_status = False
        self.lose_track = False
        self.consecutive_lose_track_frame = 0

        self.cur_points = None  # [P,3] padded, IMU frame, on the device
        self.cur_mask = None
        self.cur_point_ts = None  # [P] normalized in [0,1] or None
        self.cur_source_points = None  # [P,3]
        self.cur_source_mask = None
        self.cur_colors = None  # [P,C] f32 in [0,1] (color_on only)
        self.cur_sem = None  # [P] i32 learning labels (semantic_on only)

        self.T_imu_lidar = np.asarray(cfg.T_imu_lidar, np.float64)

    # ------------------------------------------------------------- loading
    def read_frame_arrays(self, points: np.ndarray, point_ts=None, sem_labels=None):
        """Ingest an already-loaded frame. ``points`` may carry color /
        intensity columns past xyz (kept, normalized by color_scale —
        utils/slam_dataset.py:263-266); ``sem_labels`` are reduced learning
        labels [N] i32."""
        self._raw_points = points[:, :3].astype(np.float32)
        self._raw_colors = None
        if self.cfg.color_on and points.shape[1] > 3:
            c = self.cfg.color_channel
            self._raw_colors = points[:, 3 : 3 + c].astype(np.float32) / self.color_scale
        self._raw_sem = np.asarray(sem_labels, np.int32) if sem_labels is not None else None
        self._raw_ts = point_ts
        if not np.allclose(self.T_imu_lidar, np.eye(4)):
            self._raw_points = (
                self._raw_points @ self.T_imu_lidar[:3, :3].T.astype(np.float32)
                + self.T_imu_lidar[:3, 3].astype(np.float32)
            )

    def _frame_loader(self):
        """Lazily start the native prefetching loader (background read and
        parse of the next frames while the card works on the current one).
        None if native IO is unavailable."""
        if not hasattr(self, "_prefetcher"):
            self._prefetcher = None
            from .. import native

            if native.available() and self.total_pc_count > 0:
                paths = [os.path.join(self.cfg.pc_path, f) for f in self.pc_filenames]
                self._prefetcher = native.FramePrefetcher(
                    paths, lookahead=4, threads=2, color_channel=self.cfg.color_channel
                )
        return self._prefetcher

    def read_frame(self, frame_id: int):
        cfg = self.cfg
        sem_reduced = None
        if self.kiss_loader is not None:
            # utils/slam_dataset.py:232-248 (read_frame_with_loader)
            idx = cfg.begin_frame + frame_id * cfg.step_frame
            data = self.kiss_loader[idx]
            if isinstance(data, tuple):
                points, point_ts = data
            else:
                points, point_ts = data, None
            points = np.asarray(points, np.float32)
            if cfg.deskew and point_ts is None:
                point_ts = self._estimate_point_ts(points[:, :3])
            self.read_frame_arrays(points, point_ts, None)
            return
        if cfg.semantic_on and cfg.label_path:
            # SemanticKITTI frame + labels (utils/slam_dataset.py:267-281)
            pc_path = os.path.join(cfg.pc_path, self.pc_filenames[frame_id])
            label_path = os.path.join(
                cfg.label_path, os.path.splitext(self.pc_filenames[frame_id])[0] + ".label"
            )
            points, sem_raw, sem_reduced = io.read_semantic_point_label(pc_path, label_path)
            keep = io.filter_sem_kitti_mask(sem_raw, True, cfg.filter_moving_object)
            points, sem_reduced = points[keep], sem_reduced[keep]
            point_ts = None
        else:
            loader = self._frame_loader()
            if loader is not None and not cfg.use_nclt_bin:
                points, point_ts = loader.get(frame_id)
            else:
                path = os.path.join(cfg.pc_path, self.pc_filenames[frame_id])
                if cfg.use_nclt_bin and path.endswith(".bin"):
                    points, point_ts = io.load_nclt_bin(path), None
                else:
                    points, point_ts = io.read_point_cloud(path, cfg.color_channel)
        if cfg.kitti_correction_on:
            points = intrinsic_correct(points, cfg.correction_deg)
        if cfg.deskew and point_ts is None:
            point_ts = self._estimate_point_ts(points[:, :3])
        self.read_frame_arrays(points, point_ts, sem_reduced)

    def _estimate_point_ts(self, pts: np.ndarray):
        """Beam-geometry timestamp fallback (utils/slam_dataset.py:297-352)."""
        n = pts.shape[0]
        if n == 64 * 1024:
            return (np.floor(np.arange(n) / 64) / 1024).astype(np.float32)
        if n == 128 * 1024:
            return (np.floor(np.arange(n) / 128) / 1024).astype(np.float32)
        yaw = -np.arctan2(pts[:, 1], pts[:, 0])
        if self.cfg.lidar_type_guess == "velodyne":
            return (0.5 * (yaw / np.pi + 1.0)).astype(np.float32)
        ts = 0.5 * (yaw / np.pi + 0.5)
        ts[ts < 0] += 1.0
        return ts.astype(np.float32)

    def read_imu_window(self, frame_id: int) -> Optional[np.ndarray]:
        if not self.cfg.imu_path:
            return None
        p = os.path.join(self.cfg.imu_path, f"{frame_id}.csv")
        if not os.path.isfile(p):
            # the converter's zero-padded names (lidar/000012.ply, imu/000012.csv)
            p = os.path.join(self.cfg.imu_path, f"{frame_id:06d}.csv")
            if not os.path.isfile(p):
                return None
        return io.read_imu_csv(p)

    # --------------------------------------------------------- preprocess
    def preprocess_frame(self, imu_window: Optional[np.ndarray] = None) -> bool:
        cfg = self.cfg
        dev = self.device
        frame_id = self.processed_frame
        if frame_id == 0:
            self.odom_poses[0] = self.cur_pose_ref
            self.travel_dist[0] = 0.0
            self.last_pose_ref = self.cur_pose_ref
        else:
            if self.tracker is not None and imu_window is not None:
                for row in imu_window:
                    self.tracker.predict(row[1:4], row[4:7], float(row[0]))
                guess = np.eye(4)
                guess[:3, :3] = self.tracker.x.rot
                guess[:3, 3] = self.tracker.x.pos
                self.last_odom_tran = np.linalg.inv(self.last_pose_ref) @ guess

        pts = self._raw_points
        if pts.shape[0] < 10:
            return False

        crop_max_range = cfg.max_range
        if cfg.adaptive_range_on:
            crop_max_range = adaptive_crop_range(pts, cfg.max_range)
        train_voxel_m = (crop_max_range / cfg.max_range) * cfg.vox_down_m
        source_voxel_m = (crop_max_range / cfg.max_range) * cfg.source_vox_down_m

        # pad/truncate to the static bucket
        p_cap = cfg.max_scan_points
        n = pts.shape[0]
        colors_arr = self._raw_colors
        sem_arr = self._raw_sem
        if n > p_cap:
            sel = np.random.default_rng(frame_id).permutation(n)[:p_cap]
            sel.sort()
            pts = pts[sel]
            ts_arr = self._raw_ts[sel] if self._raw_ts is not None else None
            colors_arr = colors_arr[sel] if colors_arr is not None else None
            sem_arr = sem_arr[sel] if sem_arr is not None else None
            n = p_cap
        else:
            ts_arr = self._raw_ts
        buf = np.zeros((p_cap, 3), np.float32)
        buf[:n] = pts
        mask_np = np.zeros(p_cap, bool)
        mask_np[:n] = True
        ts_buf = None
        if ts_arr is not None and cfg.deskew:
            tb = np.zeros(p_cap, np.float32)
            tb[:n] = np.asarray(ts_arr, np.float32).reshape(-1)[:n]
            ts_buf = torch.from_numpy(tb).to(dev)
        self.cur_colors = None
        if colors_arr is not None:
            cb = np.zeros((p_cap, colors_arr.shape[1]), np.float32)
            cb[:n] = colors_arr
            self.cur_colors = torch.from_numpy(cb).to(dev)
        self.cur_sem = None
        if sem_arr is not None:
            sb = np.full(p_cap, -1, np.int32)
            sb[:n] = sem_arr
            self.cur_sem = torch.from_numpy(sb).to(dev)

        points_d = torch.from_numpy(buf).to(dev)
        mask_d = torch.from_numpy(mask_np).to(dev)
        mask_d = mask_d & crop_mask(points_d, cfg.min_z, cfg.max_z, cfg.min_range, crop_max_range)
        if cfg.rand_downsample:
            # random-ratio downsample replaces the voxel grid
            # (utils/slam_dataset.py:425-429)
            keep = np.random.default_rng(frame_id ^ 0x5EED).random(p_cap) < cfg.rand_down_r
            mask_d = mask_d & torch.from_numpy(keep).to(dev)
        else:
            mask_d = voxel_down_sample_mask(points_d, mask_d, train_voxel_m, cfg.map_hash_size)
        self.cur_points = points_d
        self.cur_mask = mask_d
        self.cur_point_ts = ts_buf

        # source cloud for registration
        if frame_id > 0 and cfg.track_on:
            src_mask = voxel_down_sample_mask(points_d, mask_d, source_voxel_m, cfg.map_hash_size)
            if cfg.track_max_range > 0:
                # registration-only range gate (config.track_max_range)
                src_mask = src_mask & (torch.linalg.norm(points_d, dim=-1) <= cfg.track_max_range)
            if cfg.deskew and ts_buf is not None and not self.lose_track:
                rel = torch.as_tensor(self.last_odom_tran, dtype=torch.float32, device=dev)
                src_pts = deskew(points_d, ts_buf, rel)
                src_pts = torch.where(src_mask[:, None], src_pts, points_d)
            else:
                src_pts = points_d
            self.cur_source_points = src_pts
            self.cur_source_mask = src_mask
        return True

    # ------------------------------------------------------ odometry pose
    def update_odom_pose(self, cur_pose: np.ndarray):
        cfg = self.cfg
        frame_id = self.processed_frame
        self.cur_pose_ref = cur_pose
        self.last_odom_tran = np.linalg.inv(self.last_pose_ref) @ cur_pose

        if _rot_close_to_identity(self.last_odom_tran, 1e-3, cfg.voxel_size_m * 0.1):
            self.stop_count += 1
        else:
            self.stop_count = 0
        self.stop_status = self.stop_count > cfg.stop_frame_thre

        self.odom_poses[frame_id] = cur_pose
        tran = float(np.linalg.norm(self.last_odom_tran[:3, 3]))
        if tran > cfg.surface_sample_range_m * 40.0:
            self.lose_track = True
            raise RuntimeError("Too large translation in one frame, system failed")
        self.travel_dist[frame_id] = self.travel_dist[frame_id - 1] + tran
        self.last_pose_ref = cur_pose

        # deskew the mapping cloud with the final relative pose
        if cfg.deskew and self.cur_point_ts is not None and not self.lose_track:
            rel = torch.as_tensor(self.last_odom_tran, dtype=torch.float32, device=self.device)
            full = deskew(self.cur_points, self.cur_point_ts, rel)
            self.cur_points = torch.where(self.cur_mask[:, None], full, self.cur_points)

        if self.lose_track:
            self.consecutive_lose_track_frame += 1
        else:
            self.consecutive_lose_track_frame = 0
        if self.consecutive_lose_track_frame > 10:
            raise RuntimeError("Lose track for a long time, system failed")

    # -------------------------------------------------------------- output
    def write_results(self, run_path: str) -> dict:
        os.makedirs(run_path, exist_ok=True)
        n = self.processed_frame
        odom = self.odom_poses[:n]
        io.write_kitti_poses(os.path.join(run_path, "odom_poses_kitti.txt"), odom)
        io.write_tum_poses(os.path.join(run_path, "odom_poses_tum.txt"), odom)
        result = {"frames": n}
        if self.gt_pose_provided and n > 2:
            gt = self.gt_poses[:n]
            result.update(metrics.absolute_error(odom, gt))
            # Horn alignment is degenerate on short / low-spread
            # trajectories; odometry runs share the gt frame anyway, so also
            # report the unaligned numbers
            na = metrics.absolute_error(odom, gt, align=False)
            result["ate_rmse_m_noalign"] = na["ate_rmse_m"]
            result["are_rmse_deg_noalign"] = na["are_rmse_deg"]
            result.update(metrics.relative_error(gt, odom))
        if self.time_table:
            tt = np.asarray(self.time_table)
            hdr = "preprocess,tracking,map_prep,map_opt,mesh"
            np.savetxt(os.path.join(run_path, "time_table.csv"), tt, delimiter=",", header=hdr)
            result["mean_frame_time_s"] = float(tt.sum(-1).mean())
            with open(os.path.join(run_path, "mean_time.txt"), "w") as f:
                for name, col in zip(hdr.split(","), tt.T):
                    f.write(f"{name}: {col.mean()*1e3:.2f} ms\n")
                f.write(f"total: {tt.sum(-1).mean()*1e3:.2f} ms\n")
            plots.plot_timing_detail(tt, os.path.join(run_path, "time_details.png"))
        if n > 2:
            plots.plot_trajectory(
                odom,
                self.gt_poses[:n] if self.gt_pose_provided else None,
                os.path.join(run_path, "trajectory_xy.png"),
            )
        with open(os.path.join(run_path, "metrics.json"), "w") as f:
            json.dump(result, f, indent=2)
        return result

    def write_merged_point_cloud(
        self, run_path: str, down_voxel_m: float = 0.0, max_frames: int = 0
    ):
        """Replay the sequence with the estimated poses and write one merged
        world-frame cloud (utils/slam_dataset.py:882-990, minus the Open3D
        dependency). Deskewing per frame uses the estimated inter-frame
        motion when timestamps are available (on the host's CPU)."""
        n = self.processed_frame
        if max_frames:
            n = min(n, max_frames)
        clouds = []
        for i in range(min(n, self.total_pc_count)):
            path = os.path.join(self.cfg.pc_path, self.pc_filenames[i])
            pts, ts = io.read_point_cloud(path, 0)
            pts = pts[:, :3]
            if self.cfg.kitti_correction_on:
                pts = intrinsic_correct(pts, self.cfg.correction_deg)
            if not np.allclose(self.T_imu_lidar, np.eye(4)):
                pts = pts @ self.T_imu_lidar[:3, :3].T + self.T_imu_lidar[:3, 3]
            if (
                self.cfg.deskew
                and ts is not None
                and i < self.total_pc_count - 1
                and i + 1 < len(self.odom_poses)
            ):
                rel = np.linalg.inv(self.odom_poses[i + 1]) @ self.odom_poses[i]
                pts = deskew(
                    torch.as_tensor(np.asarray(pts, np.float32)),
                    torch.as_tensor(np.asarray(ts, np.float32)),
                    torch.as_tensor(rel, dtype=torch.float32),
                ).numpy()
            T = self.odom_poses[i]
            clouds.append((pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
        if not clouds:
            return None
        merged = np.concatenate(clouds, 0)
        if down_voxel_m > 0:
            g = np.floor(merged / down_voxel_m).astype(np.int64)
            _, keep = np.unique(g, axis=0, return_index=True)
            merged = merged[np.sort(keep)]
        out = os.path.join(run_path, "merged_point_cloud.ply")
        io.write_ply(out, merged)
        return out
