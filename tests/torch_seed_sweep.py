"""ATE of the JAX and the PyTorch StreamingSlam over decoder/RNG seeds.

Two scenarios:
- ``tiny`` (default): the 12-frame tiny sequence of tests/test_streaming.py;
- ``large``: the bench's large configuration and trajectory (50 m world,
  32 m circle, hold and ramp, prune/rehash every 50 frames), 200 frames. On
  the CPU it is cut to 256x24 beams, bs 4096 and small tables; ``--full``
  runs it uncut (1024x32 beams, bench tables), which is for the card.

Both loops are chaotic (any rounding-level change moves the tiny ATE within
roughly 0.05-0.2 m, and the large one's slow vertical drift by more), so the
port is held to the JAX engine as a distribution, not run against run. Not a
test; run it by hand:

    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --seeds 0-15
    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --scenario large --seeds 1-4,42
    python tests/torch_seed_sweep.py --scenario large --full --side torch \
        --device cuda --seeds 42,1-3        # on the card; needs no JAX
    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --scenario large \
        --side torch_jax_draws --seeds 1-42

``--side torch_jax_draws`` runs the port on the random numbers the JAX
package would draw for that seed (its decoder init and its PRNG chain, frame
by frame), which separates the port's code from its random stream: seed by
seed its ATE then follows the JAX run's.

Prints one line per seed and side, then one JSON summary line.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _seeds(spec):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def cut_large(cfg, map_capacity=1 << 17, map_hash_size=1 << 20):
    """The large bench configuration at CPU size (both packages' Config)."""
    cfg.bs = 4096
    cfg.max_scan_points, cfg.max_source_points = 1 << 13, 1 << 11
    cfg.pool_capacity = 1 << 19
    cfg.map_capacity, cfg.map_hash_size = map_capacity, map_hash_size
    cfg.local_map_capacity, cfg.local_map_hash_size = 1 << 17, 1 << 19
    return cfg


def _scenario(name, side, full):
    """(make_config(seed), sequence, initial velocity, total_frames) from the
    package of ``side``, so that the port's side imports no JAX."""
    if side in ("jax", "torch_jax_draws"):
        from clid_slam_tpu.pipeline.synthetic import generate_sequence, large_world
    else:
        from clid_slam_torch.pipeline.synthetic import generate_sequence, large_world
    if name == "tiny":
        from torch_parity import port_config, tiny_config  # imports JAX's Config

        seq = generate_sequence(n_frames=12, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
        vel = seq.poses[0][:3, :3] @ np.array([3.0 * 2 * np.pi / 20.0, 0, 0])
        make = tiny_config if side != "torch" else (lambda **kw: port_config(tiny_config(**kw)))
        return make, seq, vel, 16
    if side in ("jax", "torch_jax_draws"):
        import bench as cases
    else:
        from clid_slam_torch.pipeline import bench_cases as cases
    az, el = (1024, 32) if full else (256, 24)
    seq = generate_sequence(
        n_frames=200, n_azimuth=az, n_elev=el, noise_std=0.01, radius=32.0,
        period_frames=400.0, seed=3, world=large_world(np.random.default_rng(11), room_radius=50.0),
        ramp_frames=25.0, hold_frames=15.0, spin_phase=True,
    )

    def make(seed):
        cfg = cases.build_config(large=True)
        cfg.seed = seed
        return cfg if full else cut_large(cfg)

    return make, seq, (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / 0.1, 232


def _run(system, seq, vel):
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], vel=vel)
    for i in range(len(seq.scans)):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    return system.sync()


def _run_on_jax_draws(jcfg, seq, vel, total, device):
    """The port from the JAX package's initial state for ``jcfg`` (decoder
    init included), every frame fed the numbers that package's PRNG chain
    yields (clid_slam_tpu/pipeline/streaming.py: two splits of the state's
    key a frame; the general body of frame 0 splits once per replay batch)."""
    import jax
    import torch

    from clid_slam_torch.convert import stream_state_from_numpy
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
    from test_torch_streaming import _jax_frame_draws
    from torch_parity import port_config

    s = JaxSlam(jcfg, total_frames=total)
    s.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], vel=vel)
    port = StreamingSlam(port_config(jcfg), total_frames=total, device=device)
    gen = port.state.key
    port.state = stream_state_from_numpy(
        [np.array(x) for x in jax.tree_util.tree_leaves(s.state)], device
    )
    port.state.key = gen
    key = s.state.key

    def replay_batch(kb):
        def batch(pool):
            k1, k2 = jax.random.split(kb)
            return (
                np.asarray(jax.random.randint(k1, (jcfg.bs,), 0, max(int(pool.size), 1))),
                np.asarray(jax.random.randint(
                    k2, (jcfg.bs_new_sample,), 0, max(int(pool.new_count), 1))),
            )
        return batch

    for i in range(len(seq.scans)):
        draws = _jax_frame_draws(jcfg, key)
        key, k_map = jax.random.split(jax.random.split(key)[0])
        if i == 0:
            n_batches = -(-(jcfg.iters * jcfg.init_iter_ratio + 10) // max(1, jcfg.map_resample_every))
            draws["batches"] = []
            for _ in range(n_batches):
                k_map, kb = jax.random.split(k_map)
                draws["batches"].append(replay_batch(kb))
        draws["append"] = torch.as_tensor(draws["append"], device=device)
        port.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws)
    return port.sync()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-7", help="e.g. 0-7 or 42,1-3")
    ap.add_argument("--side", choices=("both", "jax", "torch", "torch_jax_draws"),
                    default="both")
    ap.add_argument("--scenario", choices=("tiny", "large"), default="tiny")
    ap.add_argument("--full", action="store_true", help="large scenario uncut (for the card)")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()

    import torch

    from clid_slam_torch.utils import metrics

    torch.set_num_threads(2)
    sides = ("jax", "torch") if args.side == "both" else (args.side,)
    ate = {s: [] for s in sides}
    for side in sides:
        make, seq, vel, total = _scenario(args.scenario, side, args.full)
        if side == "jax":
            from clid_slam_tpu.pipeline.streaming import StreamingSlam
            kw = {}
        else:
            from clid_slam_torch import set_full_precision
            from clid_slam_torch.pipeline.streaming import StreamingSlam

            set_full_precision()
            kw = {"device": args.device}
        n = len(seq.scans)
        for seed in _seeds(args.seeds):
            if side == "torch_jax_draws":
                out = _run_on_jax_draws(make(seed=seed), seq, vel, total, args.device)
            else:
                out = _run(StreamingSlam(make(seed=seed), total_frames=total, **kw), seq, vel)
            est = np.asarray(out["odom_poses"])[:n]
            m = metrics.absolute_error(est, seq.poses[:n], align=False)
            ate[side].append(m["ate_rmse_m"])
            last = est[-1, :3, 3] - seq.poses[n - 1, :3, 3]
            print(f"{side} seed {seed}: ATE {m['ate_rmse_m']:.4f} m, "
                  f"ARE {m['are_rmse_deg']:.3f} deg, failed {out['failed']}, "
                  f"last error xyz {np.round(last, 3).tolist()}", flush=True)
    print(json.dumps({
        s: {"n": len(v), "ate_mean_m": float(np.mean(v)), "ate_std_m": float(np.std(v)),
            "ate_min_m": float(np.min(v)), "ate_max_m": float(np.max(v)),
            "over_0.2m": int(np.sum(np.asarray(v) >= 0.2))}
        for s, v in ate.items()
    } | {"scenario": args.scenario, "full": args.full, "device": args.device,
         "torch_threads": torch.get_num_threads()}))


if __name__ == "__main__":
    main()
