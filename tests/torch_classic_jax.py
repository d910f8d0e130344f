"""The JAX package's classic driver on the classic phase of chip_smoke.py:
the same written dataset (the small configuration's widths, the small
sequence from rest) run by ``clid_slam_tpu.pipeline.slam.SlamSystem`` on
the CPU, frames and IMU rows handed over in memory (the JAX reader looks
for ``imu/<i>.csv``, the writer writes ``imu/<i:06d>.csv``: ROADMAP C5).
Prints one JSON line: ATE/ARE without alignment and the seconds a frame.

    JAX_PLATFORMS=cpu python tests/torch_classic_jax.py [n_frames]
"""

import json
import os
import sys
import tempfile
import time


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(n_frames: int = 25) -> dict:
    from chip_smoke import imu_rows, write_small_dataset
    from clid_slam_tpu.config import Config
    from clid_slam_tpu.pipeline.slam import SlamSystem
    from clid_slam_tpu.utils import metrics

    with tempfile.TemporaryDirectory() as tmp:
        seq, path, _ = write_small_dataset(tmp, n_frames, rest_start=True)
        system = SlamSystem(Config.load(path))
        t0 = time.perf_counter()
        for i in range(n_frames):
            system.process_frame(i, seq.scans[i], imu_rows(seq, i))
        secs = (time.perf_counter() - t0) / n_frames
    m = metrics.absolute_error(system.dataset.odom_poses[:n_frames], seq.poses[:n_frames],
                               align=False)
    out = {"phase": "classic_jax_cpu", "frames": n_frames, "ate_rmse_m": m["ate_rmse_m"],
           "are_rmse_deg": m["are_rmse_deg"], "s_per_frame": secs,
           "track_iters": [st.track_iters for st in system.stats]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 25)
