"""How far bf16 decoding moves one frame's mapping losses under a change
far below any tolerance, in the JAX package itself and in the port: the
tiny sequence's frame 2 from the JAX state after frames 0-1, run by the
JAX package on the scan as is and moved by ``--eps`` m, and by the port on
the JAX draws (the one-step test of tests/test_torch_streaming_options.py).
Not a test; run it by hand:

    JAX_PLATFORMS=cpu python tests/torch_bf16_sensitivity.py [--eps 1e-6]

Prints one JSON line per decoder precision (f32 and bf16).
"""

import argparse
import json
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eps", type=float, default=1e-6, help="the scan's shift in m")
    args = ap.parse_args()
    warnings.simplefilter("ignore")

    import jax
    import jax.numpy as jnp

    from clid_slam_torch.convert import stream_state_from_numpy
    from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
    from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
    from clid_slam_tpu.pipeline.synthetic import generate_sequence
    from test_torch_streaming import _jax_frame_draws, _seed
    from torch_parity import n, port_config, tiny_config

    seq = generate_sequence(n_frames=3, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    for bf16 in (False, True):
        cfg = tiny_config(mlp_bf16=bf16)
        s = JaxSlam(cfg, total_frames=16)
        _seed(s, seq)
        for i in range(2):
            s.process_frame(i, seq.scans[i], seq.imu_windows[i])
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)]
        tree = jax.tree_util.tree_structure(s.state)
        out = {"bf16": bf16, "eps_m": args.eps}
        for name, shift in (("jax", 0.0), ("jax_shifted", args.eps)):
            s.state = jax.tree_util.tree_unflatten(tree, [jnp.asarray(x) for x in leaves])
            s.process_frame(2, seq.scans[2] + shift, seq.imu_windows[2])
            out[name] = {"losses": np.asarray(s.state.losses[2]).tolist(),
                         "pose": np.asarray(s.state.odom_poses[2]).tolist()}
        port = TorchSlam(port_config(cfg), total_frames=16, device="cpu")
        gen = port.state.key
        port.state = stream_state_from_numpy(leaves, "cpu")
        port.state.key = gen
        draws = _jax_frame_draws(cfg, jax.tree_util.tree_unflatten(tree, leaves).key)
        port.process_frame(2, seq.scans[2], seq.imu_windows[2], draws=draws)
        out["port"] = {"losses": n(port.state.losses[2]).tolist(),
                       "pose": n(port.state.odom_poses[2]).tolist()}
        ref = np.asarray(out["jax"]["losses"])
        for k in ("jax_shifted", "port"):
            out[k]["losses_rel_diff"] = (np.abs(np.asarray(out[k]["losses"]) - ref) / ref).tolist()
            out[k]["pose_max_diff"] = float(np.abs(np.asarray(out[k]["pose"])
                                                   - np.asarray(out["jax"]["pose"])).max())
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
