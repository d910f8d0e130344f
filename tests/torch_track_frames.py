"""Frames for a tracked frame's predict and bookkeep
(``pipeline/streaming.py``: ``predict_stage``, ``bookkeep_stage``,
``GraphedTrackStages``), shared by the CPU tests of the stages' device
forms and the card tests of their CUDA graphs: a small ``StreamingSlam`` on
the switches of the benchmark's ``quad`` deployment (the adaptive crop
range, the dynamic filter, deskew, ``T_imu_lidar`` rotated 180 degrees) and
a seeded synthetic sequence with two moving pillars, whose frames differ in
crop range, in IMU rows (none, part of the window, the whole 64-row bucket)
and in id. Imports neither JAX nor the JAX package.

``python tests/torch_track_frames.py OUT.npz`` writes the CPU run's
results (``RECORDED``, from the code on ``sys.path``) that
``tests/test_torch_track_stages.py`` holds the port to."""

import os
import sys

import numpy as np
import torch

from clid_slam_torch.config import Config
from clid_slam_torch.pipeline.streaming import IMU_MAX_ROWS, StreamingSlam
from clid_slam_torch.pipeline.synthetic import SyntheticWorld, generate_sequence

N_FRAMES = 8
# each frame's IMU rows (frame 0 has none): the whole bucket, none, or the
# window merged into fewer rows
IMU_ROWS = (0, 64, 0, 16, 64, 4, 0, 32)
T_IMU_LIDAR = np.array([[-1.0, 0.0, 0.0, -0.006253], [0.0, -1.0, 0.0, 0.011775],
                        [0.0, 0.0, 1.0, -0.028535], [0.0, 0.0, 0.0, 1.0]])  # quad's
# two walls near the path and the room's far side beyond twice their
# distance, so that the adaptive crop range bites and moves from frame to
# frame; pillars crossing the room (cx, cy, vx, vy, r), which the dynamic
# filter drops
WALLS = [(6.25, 0.0, 0.5, 20.0, -1.5, 2.5), (0.0, 6.25, 20.0, 0.5, -1.5, 2.5)]
MOVING = [(1.0, -4.0, 0.0, 5.0, 0.4), (-4.0, 1.5, 5.0, 0.0, 0.4)]
RECORDED = os.path.join(os.path.dirname(__file__), "torch_track_frames_parent.npz")


def quad_like_config(**overrides) -> Config:
    c = Config()
    for k, v in {**dict(
        voxel_size_m=0.3, search_alpha=0.5, local_voxel_size_m=0.15, vox_down_m=0.08,
        source_vox_down_m=0.4, min_range=0.5, max_range=30.0, max_z=30.0, bs=4096,
        bs_new_sample=512, iters=10, reg_iter_n=20, freeze_after_frame=6,
        loss_weight_on=True, map_capacity=1 << 15, map_hash_size=1 << 17,
        local_map_capacity=1 << 16, local_map_hash_size=1 << 17,
        max_scan_points=1 << 13, max_source_points=1 << 11, pool_capacity=1 << 18,
        adaptive_range_on=True, dynamic_filter_on=True, deskew=True,
    ), **overrides}.items():
        setattr(c, k, v)
    c.T_imu_lidar = T_IMU_LIDAR.copy()
    c._derive()
    c.diff_travel_dist_local = 1e9
    return c


def _merged(window, k: int):
    """``window``'s interval in ``k`` rows: runs of rows merged (dt summed,
    acc and gyro averaged); ``k`` 0 gives no rows."""
    if window is None or k == 0:
        return np.zeros((0, 7))
    w = window.reshape(k, len(window) // k, 7)
    return np.concatenate([w[:, :, :1].sum(1), w[:, :, 1:].mean(1)], 1)


def frames():
    """The sequence and each frame's (points in the LiDAR frame, IMU rows,
    per-point timestamps by azimuth)."""
    seq = generate_sequence(n_frames=N_FRAMES, n_azimuth=256, n_elev=24, noise_std=0.01,
                            seed=3, imu_rate=IMU_MAX_ROWS, moving_pillars=MOVING,
                            world=SyntheticWorld(room_radius=14.0, boxes=WALLS))
    R, t = T_IMU_LIDAR[:3, :3], T_IMU_LIDAR[:3, 3]
    out = []
    for i, body in enumerate(seq.scans):
        lidar = (body - t) @ R  # StreamingSlam maps them back with T_imu_lidar
        ts = (np.arctan2(body[:, 1], body[:, 0]) + np.pi) / (2 * np.pi)
        out.append((lidar.astype(np.float32), _merged(seq.imu_windows[i], IMU_ROWS[i]),
                    ts.astype(np.float32)))
    return seq, out


def system(device, **overrides):
    """A fresh system on ``device``, anchored at the sequence's start, and
    its frames."""
    seq, fr = frames()
    s = StreamingSlam(quad_like_config(**overrides), total_frames=N_FRAMES + 2, device=device)
    w = 2 * np.pi / 20.0
    s.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3],
                vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]))
    return s, fr


def run(s, fr, ids):
    for i in ids:
        points, imu, ts = fr[i]
        s.process_frame(i, points, imu, point_ts=ts)


def results(s) -> dict:
    """What a run is held to: the trajectory, the travel distances, the
    iteration counts, the losses, the filter's counts and the map's size."""
    out = s.sync()
    return dict(odom_poses=out["odom_poses"], travel_dist=out["travel_dist"],
                track_iters=out["track_iters"], losses=out["losses"],
                filtered=np.array(out["filtered"], np.int64).reshape(-1, 3),
                neural_points=np.int64(out["neural_points"]))


if __name__ == "__main__":
    torch.set_num_threads(2)  # as the tests run it (tests/torch_parity.py)
    s, fr = system("cpu")
    run(s, fr, range(N_FRAMES))
    np.savez(sys.argv[1], **results(s))
