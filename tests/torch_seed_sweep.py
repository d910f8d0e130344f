"""ATE of the JAX and the PyTorch StreamingSlam over decoder/RNG seeds.

Four scenarios:
- ``tiny`` (default): the 12-frame tiny sequence of tests/test_streaming.py;
- ``large``: the bench's large configuration and trajectory (50 m world,
  32 m circle, hold and ramp, prune/rehash every 50 frames), 200 frames. On
  the CPU it is cut to 256x24 beams, bs 4096 and small tables; ``--full``
  runs it uncut (1024x32 beams, bench tables), which is for the card;
- ``small``: the bench's small configuration and 25-frame sequence, uncut
  (chip_smoke.py's ``stream`` phase at other seeds): the port on the card,
  the JAX package on a CPU (about a minute a seed);
- ``dynba``: the small configuration with the dynamic filter and a 20-frame
  sliding-window BA every 10 frames from frame 20, 40 frames, uncut
  (chip_smoke.py's ``stream_dynba`` phase), on the same devices.

Both loops are chaotic (any rounding-level change moves the tiny ATE within
roughly 0.05-0.2 m, and the large one's slow vertical drift by more), so the
port is held to the JAX engine as a distribution, not run against run. Not a
test; run it by hand:

    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --seeds 0-15
    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --scenario large --seeds 1-4,42
    python tests/torch_seed_sweep.py --scenario large --full --side torch \
        --device cuda --seeds 42,1-3        # on the card; needs no JAX
    python tests/torch_seed_sweep.py --scenario small --side torch \
        --device cuda --seeds 42,0-9 --k1 plain
    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --scenario dynba \
        --side jax --seeds 42
    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --scenario large \
        --side torch_jax_draws --seeds 1-42

``--side torch_jax_draws`` runs the port on the random numbers the JAX
package would draw for that seed (its decoder init and its PRNG chain, frame
by frame), which separates the port's code from its random stream: seed by
seed its ATE then follows the JAX run's.

``--set name=value`` (repeatable) sets a config field on both sides, for
example ``--set track_cached=False`` for the tracker that re-queries the
map at every iteration, or ``--set weighted_first=False``,
``--set mlp_bf16=True`` (chip_smoke.py's option phases; ``--frames 12``
cuts the small sequence to their 12 frames).

``--k1 plain`` maps the tracked frames with the fused loop's plain PyTorch
version (``ops/map_loop.py:map_loop_reference``) on the port's device in
place of its kernel: on the card this sets the kernel's rounding against
the reference's on the same seeds.

``--jax-fused`` puts the JAX package's tracked frames on its fused mapping
kernel (Pallas, interpreted off the TPU) instead of its XLA loop
(``torch_jax_draws.jax_fused``), so that both packages map on one rule;
each JAX run then must call the kernel once a tracked frame. The uncut
pairs of the large scenario, the JAX package on the CPU of the card's
machine:

    JAX_PLATFORMS=cpu python tests/torch_seed_sweep.py --scenario large \
        --full --side jax --jax-fused --seeds 42,0-9

Prints one line per seed and side, then one JSON summary line.
"""

import argparse
import ast
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


def _scenario(name, side, full, frames=None):
    """(make_config(seed), sequence, initial velocity, total_frames) from the
    package of ``side``, so that the port's side imports no JAX. ``frames``
    cuts the small and dynba sequences."""
    if side in ("jax", "torch_jax_draws"):
        from clid_slam_tpu.pipeline.synthetic import generate_sequence, large_world
    else:
        from clid_slam_torch.pipeline.synthetic import generate_sequence, large_world
    if name in ("small", "dynba"):
        if side == "torch_jax_draws":
            raise SystemExit(f"--scenario {name} runs --side jax or torch")
        if side == "jax":
            import bench as cases
        else:
            from clid_slam_torch.pipeline import bench_cases as cases
        seq = cases.make_sequence(False, frames or (25 if name == "small" else 40))

        def make_small(seed):
            cfg = cases.build_config(large=False)
            cfg.seed = seed
            if name == "dynba":
                cfg.dynamic_filter_on, cfg.ba_frame, cfg.ba_freq_frame = True, 20, 10
            return cfg

        vel = cases._vel0(seq, "small") if side == "jax" else cases.initial_velocity(seq, False)
        return make_small, seq, vel, cases.TOTAL_FRAMES
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
    ap.add_argument("--scenario", choices=("tiny", "large", "small", "dynba"), default="tiny")
    ap.add_argument("--full", action="store_true", help="large scenario uncut (for the card)")
    ap.add_argument("--frames", type=int, default=None,
                    help="the small or dynba sequence's first N frames (chip_smoke.py's "
                    "option phases run 12)")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--k1", choices=("kernel", "plain"), default="kernel",
                    help="the port's fused mapping loop: its kernel or its plain version")
    ap.add_argument("--jax-fused", action="store_true",
                    help="the JAX package's tracked frames on its Pallas kernel (interpreted)")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="a config field for every run (a Python literal), repeatable")
    args = ap.parse_args()
    overrides = {k: ast.literal_eval(v) for k, v in (a.split("=", 1) for a in args.set)}

    import torch

    from clid_slam_torch.utils import metrics

    torch.set_num_threads(2)
    if args.k1 == "plain":
        from clid_slam_torch.mapping import mapper as port_mapper
        from clid_slam_torch.ops.map_loop import map_loop_reference

        port_mapper.map_loop = map_loop_reference
    sides = ("jax", "torch") if args.side == "both" else (args.side,)
    ate = {s: [] for s in sides}
    last_z = {s: [] for s in sides}
    for side in sides:
        make_cfg, seq, vel, total = _scenario(args.scenario, side, args.full, args.frames)

        def make(seed, make_cfg=make_cfg):
            cfg = make_cfg(seed=seed)
            for k, v in overrides.items():
                setattr(cfg, k, v)
            return cfg

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
            note = ""
            if side == "torch_jax_draws":
                out = _run_on_jax_draws(make(seed=seed), seq, vel, total, args.device)
            elif side == "jax":
                from torch_jax_draws import jax_fused

                with jax_fused(args.jax_fused) as count:
                    out = _run(StreamingSlam(make(seed=seed), total_frames=total, **kw), seq, vel)
                    builds, calls = count.read()
                if args.jax_fused and calls != n - 1:
                    raise SystemExit(f"seed {seed}: the JAX kernel ran {calls} times for "
                                     f"{n - 1} tracked frames")
                note = f", kernel builds {builds} calls {calls}" if args.jax_fused else ""
            else:
                from clid_slam_torch.ops import map_loop as k1

                k1.launches = 0
                out = _run(StreamingSlam(make(seed=seed), total_frames=total, **kw), seq, vel)
                note = f", K1 launches {k1.launches}"
            est = np.asarray(out["odom_poses"])[:n]
            m = metrics.absolute_error(est, seq.poses[:n], align=False)
            ate[side].append(m["ate_rmse_m"])
            last = est[-1, :3, 3] - seq.poses[n - 1, :3, 3]
            last_z[side].append(float(last[2]))
            print(f"{side} seed {seed}: ATE {m['ate_rmse_m']:.4f} m, "
                  f"ARE {m['are_rmse_deg']:.3f} deg, failed {out['failed']}, "
                  f"last error xyz {np.round(last, 3).tolist()}{note}", flush=True)
    print(json.dumps({
        s: {"n": len(v), "ate_m": [float(a) for a in v],
            "ate_mean_m": float(np.mean(v)), "ate_std_m": float(np.std(v)),
            "ate_min_m": float(np.min(v)), "ate_max_m": float(np.max(v)),
            "over_0.2m": int(np.sum(np.asarray(v) >= 0.2)), "last_z_error_m": last_z[s]}
        for s, v in ate.items()
    } | {"scenario": args.scenario, "seeds": _seeds(args.seeds), "jax_fused": args.jax_fused, "frames": args.frames, "set": overrides, "full": args.full,
         "device": args.device,
         "k1": args.k1,
         "torch_threads": torch.get_num_threads()}))


if __name__ == "__main__":
    main()
