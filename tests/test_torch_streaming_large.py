"""The streaming frame step under the large bench configuration's options
(registration range gate, tracker information scale, bias noise, a finite
travel-distance window, prune cadence) on the large scenario's trajectory,
which starts at rest (hold, then ramp: the stop logic is live): each frame
one step ahead of the JAX package from the same state with the same draws.

Cut to CPU size: 256x24 beams, bs 4096, small tables, a prune every 4
frames. Poses within 1e-4 (the tracked-frame test's tolerance); iteration
counts, stop counters, point counts and pool sizes equal. The trained
features are not compared here: a sample on the novelty threshold may flip
between the two sides and shift the replay batch.

Run as a script for a longer stretch (prints one line per frame), or
uncut (1024x32 beams, the bench's tables and prune cadence) with the port
on a card:

    JAX_PLATFORMS=cpu python tests/test_torch_streaming_large.py 45
    XLA_PYTHON_CLIENT_PREALLOCATE=false \
        python tests/test_torch_streaming_large.py 200 --full --device cuda
"""

import os
import sys

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench as jax_bench
from clid_slam_torch.convert import stream_state_from_numpy
from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence, large_world
from test_torch_streaming import _jax_frame_draws
from torch_parity import n, port_config
from torch_seed_sweep import cut_large


def one_step_ahead(n_frames, prune_freq_frame=4, full=False, device="cpu"):
    """Yield, for frames 1..n_frames-1, the port's and the JAX package's
    results of that frame from the JAX state before it."""
    cfg = jax_bench.build_config(large=True)
    if not full:
        # a 9-frame map is small: tables a quarter of the sweep's keep the test short
        cut_large(cfg, 1 << 16, 1 << 19).prune_freq_frame = prune_freq_frame
    az, el = (1024, 32) if full else (256, 24)
    seq = generate_sequence(
        n_frames=n_frames, n_azimuth=az, n_elev=el, noise_std=0.01, radius=32.0,
        period_frames=400.0, seed=3, world=large_world(np.random.default_rng(11), room_radius=50.0),
        ramp_frames=25.0, hold_frames=15.0, spin_phase=True,
    )
    vel = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / 0.1
    s = JaxSlam(cfg, total_frames=n_frames + 8)
    s.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], vel)
    s.process_frame(0, seq.scans[0], seq.imu_windows[0])
    port = TorchSlam(port_config(cfg), total_frames=n_frames + 8, device=device)
    gen = port.state.key
    for frame in range(1, n_frames):
        port.state = stream_state_from_numpy(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], device
        )
        port.state.key = gen
        draws = _jax_frame_draws(cfg, s.state.key)
        port.process_frame(frame, seq.scans[frame], seq.imu_windows[frame], draws=draws)
        s.process_frame(frame, seq.scans[frame], seq.imu_windows[frame])
        yield frame, port, s


def _ints(state, frame):
    return (int(state.track_iters[frame]), int(state.stop_count), bool(state.stop_status),
            bool(state.lose_track), int(state.map_state.count), int(state.pool.size))


def test_large_options_one_step_ahead_matches_jax():
    stopped = 0
    for frame, port, s in one_step_ahead(9):
        np.testing.assert_allclose(
            n(port.state.odom_poses[frame]), np.asarray(s.state.odom_poses[frame]), atol=1e-4
        )
        np.testing.assert_allclose(n(port.state.rest), np.asarray(s.state.rest), atol=1e-4)
        assert _ints(port.state, frame) == _ints(s.state, frame), frame
        stopped += int(s.state.stop_count) > 0
    assert [f for f, _, _ in port.prune_log] == [3, 7]  # the cadence
    assert stopped >= 3  # the hold phase exercised the stop counter


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", type=int, nargs="?", default=45)
    ap.add_argument("--full", action="store_true", help="uncut, for a card")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()
    dz = []
    for frame, port, s in one_step_ahead(args.frames, full=args.full, device=args.device):
        pp, pj = n(port.state.odom_poses[frame]), np.asarray(s.state.odom_poses[frame])
        r = np.abs(n(port.state.rest) - np.asarray(s.state.rest)).max()
        live = int(s.state.map_state.count)
        fp = n(port.state.map_state.geo_feats[:live])
        fj = np.asarray(s.state.map_state.geo_feats[:live])
        dz.append(pp[2, 3] - pj[2, 3])
        print(f"frame {frame}: pose diff {np.abs(pp - pj).max():.2e} (z {dz[-1]:+.2e}), "
              f"tracker state diff {r:.2e}, features diff mean {np.abs(fp - fj).mean():.2e} "
              f"max {np.abs(fp - fj).max():.2e}, losses port {n(port.state.losses[frame]).round(4).tolist()} "
              f"jax {np.asarray(s.state.losses[frame]).round(4).tolist()}, "
              f"ints port {_ints(port.state, frame)} jax {_ints(s.state, frame)}", flush=True)
    print(f"z of the port minus z of JAX, one step ahead: mean {np.mean(dz):+.3e}, "
          f"std {np.std(dz):.3e} over {len(dz)} frames")
