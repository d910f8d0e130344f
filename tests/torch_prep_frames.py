"""Tracked frames for map prep alone (``mapping/prep.py``), shared by the
CPU test of the in-place prep and the card tests of its CUDA graphs: a small
``StreamingSlam`` after frame 0 on a seeded synthetic sequence, and each
later frame's prep inputs. Imports neither JAX nor the JAX package."""

from dataclasses import replace

import numpy as np
import torch

from clid_slam_torch.config import Config
from clid_slam_torch.mapping import prep as prp
from clid_slam_torch.pipeline.streaming import StreamingSlam, prep_kwargs
from clid_slam_torch.pipeline.synthetic import generate_sequence

N_FRAMES = 6


def small_system(device, frame0=True, **overrides):
    """A small system on ``device``, after frame 0 with ``frame0``, and its
    sequence. The pool is small enough to be full from frame 1, so the
    eviction draw runs in every later frame."""
    c = Config()
    for k, v in {**dict(
        voxel_size_m=0.3, search_alpha=0.5, local_voxel_size_m=0.15, vox_down_m=0.08,
        source_vox_down_m=0.4, min_range=0.5, max_range=30.0, max_z=30.0, bs=4096,
        bs_new_sample=512, iters=10, reg_iter_n=20, freeze_after_frame=6,
        loss_weight_on=True, map_capacity=1 << 15, map_hash_size=1 << 17,
        local_map_capacity=1 << 16, local_map_hash_size=1 << 17,
        max_scan_points=1 << 13, max_source_points=1 << 11, pool_capacity=1 << 15,
        local_map_size=6.0,
    ), **overrides}.items():
        setattr(c, k, v)
    c._derive()
    c.diff_travel_dist_local = 1e9
    c.window_radius = 4.0  # the pool's window filter drops rows
    seq = generate_sequence(n_frames=N_FRAMES, n_azimuth=256, n_elev=24, noise_std=0.01,
                            seed=3)
    system = StreamingSlam(c, total_frames=N_FRAMES + 2, device=device)
    w = 2 * np.pi / 20.0
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3],
                     vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]))
    if frame0:
        system.process_frame(0, seq.scans[0], seq.imu_windows[0])
    return system, seq


def preps(cfg) -> dict:
    """``make_prep_fn``'s two variants, by ``filter_pool_now``."""
    return {fp: prp.make_prep_fn(filter_pool_now=fp, **prep_kwargs(cfg)) for fp in (False, True)}


def frame_inputs(system, seq, i):
    """Frame ``i``'s prep inputs: (points [P,3] padded, mask [P], pose [4,4],
    travel distances with frame i's set)."""
    p_cap = system.cfg.max_scan_points
    dev = system.device
    scan = np.asarray(seq.scans[i], np.float32)[:p_cap, :3]
    points = torch.zeros((p_cap, 3), device=dev)
    points[: len(scan)] = torch.from_numpy(scan).to(dev)
    mask = torch.arange(p_cap, device=dev) < len(scan)
    mask &= points[:, 2] > -1.0  # a few rows out, so that the masks bite
    pose = torch.from_numpy(np.asarray(seq.poses[i], np.float32)).to(dev)
    travel = system.state.travel_dist.clone()
    travel[i] = 0.35 * i
    return points, mask, pose, travel


def after_mapping(map_state, i):
    """The map as the mapping step leaves it for the next frame: new
    certainty and stamp tensors (the frame's prep reads both)."""
    cert = map_state.certainty + 0.02 * i
    ts = torch.where(map_state.ts_update > 0, map_state.ts_update,
                     torch.full_like(map_state.ts_update, i))
    return replace(map_state, certainty=cert, ts_update=ts)


def prep_leaves(res) -> list:
    """Every tensor of a ``PrepResult``."""
    return (res.map_state.tensors() + res.local_map.tensors() + res.pool.tensors()
            + [res.new_point_ratio, res.new_sample_count, res.cur_sample_count,
               res.insert_dropped])
