"""Localize a classic-driver difference between the port and the JAX
package on the CPU, on the tiny sequence of tests/test_slam_integration.py
(12 frames, seed 3).

    JAX_PLATFORMS=cpu python tests/torch_classic_probe.py scan [--frames 8]
    JAX_PLATFORMS=cpu python tests/torch_classic_probe.py loop [--draws jax|port] [--map-pallas 0|1]

``scan``: for each frame i >= 1, the JAX state after frame i - 1 carried
into the port (``convert.classic_state_from_numpy``) and frame i run on both
with the JAX draws; one JSON line a frame: the pose difference, both
tracker iteration counts, both new-sample counts (the novelty gate), the
pool rows whose labels differ, and the losses' relative differences.
``loop``: 12 frames in closed loop, the JAX system and the port's (on the
JAX random experiment, ``--draws jax``, or on its own generator), one JSON
line each with ATE/ARE against ground truth. Torch runs with 2 threads, as
the tests do.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch_parity  # noqa: E402  (2 torch threads)
from torch_parity import port_config, tiny_config  # noqa: E402


def _seq():
    from clid_slam_tpu.pipeline.synthetic import generate_sequence

    return generate_sequence(n_frames=12, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


def scan(frames: int):
    import torch_jax_draws as jd
    from test_torch_slam import _jax_arrays, _seed_filter
    from clid_slam_torch.convert import classic_state_from_numpy
    from clid_slam_torch.pipeline.slam import SlamSystem
    from clid_slam_tpu.pipeline.slam import SlamSystem as JaxSystem

    seq, cfg = _seq(), tiny_config()
    s = JaxSystem(cfg, total_frames=16)
    _seed_filter(s, seq)
    for i in range(frames):
        before = _jax_arrays(s) if i else None
        _, draws = jd.frame_draws(cfg, s.key)
        st = s.process_frame(i, seq.scans[i], seq.imu_windows[i])
        if not i:
            continue
        p = SlamSystem(port_config(cfg), total_frames=16, device="cpu")
        classic_state_from_numpy(p, before)
        pst = p.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws)
        d = np.abs(p.pool.data.numpy() - np.asarray(s.pool.data))
        print(json.dumps({
            "frame": i,
            "pose_diff": float(np.abs(p.dataset.odom_poses[i] - s.dataset.odom_poses[i]).max()),
            "track_iters": [pst.track_iters, st.track_iters],
            "new_count": [int(p.pool.new_count), int(s.pool.new_count)],
            "label_rows_differ": int((d.max(1) > 1e-4).sum()),
            "loss_rel_diff": [pst.sdf_loss / st.sdf_loss - 1, pst.eik_loss / st.eik_loss - 1],
        }), flush=True)


def loop(draws: str, map_pallas: bool):
    from test_torch_slam import _jax_arrays, _seed_filter
    from test_torch_slam_loop import JaxDraws
    from clid_slam_torch.convert import classic_state_from_numpy
    from clid_slam_torch.pipeline.slam import SlamSystem
    from clid_slam_tpu.pipeline.slam import SlamSystem as JaxSystem
    from clid_slam_tpu.utils import metrics

    seq, cfg = _seq(), tiny_config()
    j = JaxSystem(cfg, total_frames=16)
    pcfg = port_config(cfg)
    pcfg.map_pallas = map_pallas
    p = SlamSystem(pcfg, total_frames=16, device="cpu")
    chain = None
    if draws == "jax":
        classic_state_from_numpy(p, _jax_arrays(j))
        chain = JaxDraws(cfg, j.key)
    for system in (j, p):
        _seed_filter(system, seq)
    for i in range(len(seq.scans)):
        j.process_frame(i, seq.scans[i], seq.imu_windows[i])
        p.process_frame(i, seq.scans[i], seq.imu_windows[i],
                        draws=chain.next(i) if chain else None)
    for name, system in (("jax", j), (f"port draws={draws} map_pallas={map_pallas}", p)):
        m = metrics.absolute_error(system.dataset.odom_poses[:12], seq.poses, align=False)
        print(json.dumps({"run": name, "ate_rmse_m": m["ate_rmse_m"],
                          "are_rmse_deg": m["are_rmse_deg"]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("scan", "loop"))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--draws", choices=("jax", "port"), default="jax")
    ap.add_argument("--map-pallas", type=int, default=1)
    a = ap.parse_args()
    if a.mode == "scan":
        scan(a.frames)
    else:
        loop(a.draws, bool(a.map_pallas))


if __name__ == "__main__":
    main()
