"""Two OS processes drive the sharded SLAM loops over one map, one shard
each (the port's counterpart of scripts/run_multiprocess.py).

The processes join one gloo process group on the CPU through a ``file://``
init method (no TCP port), then both drive ``ShardedSlamSystem`` and then
``StreamingShardedSlam`` over the same frames of the synthetic sequence
(``tiny_config`` widths, seed 3). Every kNN exchange and payload sum
crosses the process boundary. The parent asserts that the two processes'
trajectories are identical and that every shard owns points, and prints
one JSON line with ``traj_max_divergence_m``.

    python -m clid_slam_torch.tools.run_multiprocess [--frames 8] [--init-iter-ratio 40]

``--init-iter-ratio`` cuts frame 0's warm-up (``iters`` times it, 400
steps by default) for a quicker check.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

N_PROCS = 2


def tiny_config(init_iter_ratio: int = 40):
    """The small synthetic-room configuration of the JAX package's test
    suite (tests/test_slam_integration.py:tiny_config)."""
    from ..config import Config

    c = Config()
    for k, v in dict(
        voxel_size_m=0.3, search_alpha=0.5, local_voxel_size_m=0.15,
        surface_sample_range_m=0.25, surface_sample_n=3, free_front_n=2, free_behind_n=1,
        vox_down_m=0.08, source_vox_down_m=0.4, min_range=0.5, max_range=30.0, min_z=-5.0,
        max_z=30.0, bs=4096, bs_new_sample=512, iters=10, init_iter_ratio=init_iter_ratio,
        reg_iter_n=20, freeze_after_frame=6, loss_weight_on=True, map_capacity=1 << 15,
        map_hash_size=1 << 17, local_map_capacity=1 << 16, local_map_hash_size=1 << 17,
        max_scan_points=1 << 13, max_source_points=1 << 11, pool_capacity=1 << 18,
        track_on=True, silence=True,
    ).items():
        setattr(c, k, v)
    c._derive()
    c.diff_travel_dist_local = 1e9  # the travel window is irrelevant in the room
    return c


def worker(proc: int, store: str, out_dir: str, n_frames: int, init_iter_ratio: int):
    import torch

    from ..parallel import distributed as dd
    from ..parallel.collectives import all_gather
    from ..parallel.slam_sharded import ShardedSlamSystem
    from ..pipeline.streaming_sharded import StreamingShardedSlam
    from ..pipeline.synthetic import generate_sequence
    from ..utils import metrics

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // N_PROCS))
    ctx = dd.initialize(f"file://{store}", N_PROCS, proc, device="cpu")
    assert ctx.process_count == N_PROCS and ctx.global_devices == N_PROCS
    seq = generate_sequence(n_frames=n_frames, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    cfg = tiny_config(init_iter_ratio)
    w = 2 * np.pi / 20.0
    rot, pos = seq.poses[0][:3, :3], seq.poses[0][:3, 3]
    vel = rot @ np.array([3.0 * w, 0, 0])

    system = ShardedSlamSystem(cfg, total_frames=n_frames + 4, device="cpu")
    system.tracker.x.pos, system.tracker.x.rot, system.tracker.x.vel = pos.copy(), rot.copy(), vel
    for i in range(n_frames):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    est = system.odom_poses[:n_frames]
    m = metrics.absolute_error(est, seq.poses[:n_frames], align=False)

    ssys = StreamingShardedSlam(cfg, total_frames=n_frames + 4, device="cpu")
    ssys.seed_pose(rot, pos, vel)
    for i in range(n_frames):
        ssys.process_frame(i, seq.scans[i], seq.imu_windows[i])
    sest = ssys.sync()["odom_poses"][:n_frames]
    sm = metrics.absolute_error(sest, seq.poses[:n_frames], align=False)

    def counts(state):  # each shard's count, from every process
        return all_gather(state.count.reshape(1), system.mesh).reshape(-1).tolist()

    c, sc = counts(system.map_state), counts(ssys.state.map_state)
    out = {
        "proc": proc, "process_count": ctx.process_count, "global_devices": ctx.global_devices,
        "ate_rmse_m": float(m["ate_rmse_m"]), "traj": est[:, :3, 3].tolist(),
        "shard_counts": c, "points": int(sum(c)),
        "streaming_ate_rmse_m": float(sm["ate_rmse_m"]), "streaming_traj": sest[:, :3, 3].tolist(),
        "streaming_shard_counts": sc,
    }
    with open(os.path.join(out_dir, f"proc{proc}.json"), "w") as f:
        json.dump(out, f)
    print(f"# proc {proc}: ATE {out['ate_rmse_m']}, shards {c}", file=sys.stderr)
    dd.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--init-iter-ratio", type=int, default=40)
    ap.add_argument("--proc", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.proc is not None:
        worker(args.proc, args.store, args.out_dir, args.frames, args.init_iter_ratio)
        return

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--frames", str(args.frames), "--init-iter-ratio", str(args.init_iter_ratio),
                  "--store", os.path.join(tmp, "store"), "--out-dir", tmp]
        procs = [subprocess.Popen([sys.executable, "-m", "clid_slam_torch.tools.run_multiprocess",
                                   "--proc", str(i)] + common)
                 for i in range(N_PROCS)]
        try:
            rcs = [p.wait(timeout=1800) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert all(r == 0 for r in rcs), rcs
        outs = []
        for i in range(N_PROCS):
            with open(os.path.join(tmp, f"proc{i}.json")) as f:
                outs.append(json.load(f))
    assert outs[0]["process_count"] == N_PROCS and outs[0]["global_devices"] == N_PROCS
    # identical trajectories in both processes: the tracker's iterations are
    # replicated and every sum over ranks runs in rank order
    t0, t1 = np.asarray(outs[0]["traj"]), np.asarray(outs[1]["traj"])
    dmax = float(np.abs(t0 - t1).max())
    s0, s1 = np.asarray(outs[0]["streaming_traj"]), np.asarray(outs[1]["streaming_traj"])
    sdmax = float(np.abs(s0 - s1).max())
    assert dmax == 0.0 and sdmax == 0.0, (dmax, sdmax)
    c, sc = outs[0]["shard_counts"], outs[0]["streaming_shard_counts"]
    assert all(x > 0 for x in c) and all(x > 0 for x in sc), (c, sc)
    assert c == outs[1]["shard_counts"] and sc == outs[1]["streaming_shard_counts"]
    print(json.dumps({"multiprocess": {
        "processes": N_PROCS, "shards": N_PROCS, "frames": args.frames,
        "init_iter_ratio": args.init_iter_ratio, "ate_rmse_m": outs[0]["ate_rmse_m"],
        "traj_max_divergence_m": dmax, "shard_counts": c,
        "streaming_ate_rmse_m": outs[0]["streaming_ate_rmse_m"],
        "streaming_traj_max_divergence_m": sdmax, "streaming_shard_counts": sc,
    }}))


if __name__ == "__main__":
    main()
