"""The port's multi-process runtime (clid_slam_torch/parallel/distributed.py)
and its two-process check (clid_slam_torch/tools/run_multiprocess.py):

- ``initialize()`` with nothing in the environment is a single-process
  no-op context (1 process, not initialized), as the JAX package's is;
  ``shutdown()`` without a group is a no-op;
- two spawned processes join one gloo group through ``initialize`` with
  explicit arguments (a ``file://`` URL), sum over it and leave it;
- ``run_sharded_slam`` on 2 gloo ranks gives the poses of a direct
  ``ShardedSlamSystem`` loop over the same frames bit for bit, and with no
  group and nothing in the environment it runs on one rank;
- ``python -m clid_slam_torch.tools.run_multiprocess`` exits 0 and prints
  ``traj_max_divergence_m`` 0.0 (the JAX package's MULTIPROC_r04.json
  records 0.0 for its own).

The runs here are cut in depth (3 frames, frame 0's warm-up 40 steps in
place of 400), not in width: the drivers' full-depth runs are in
tests/test_torch_{slam,streaming}_sharded.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from clid_slam_torch.parallel import distributed as dd
from clid_slam_tpu.parallel import distributed as jdd
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from torch_dist import Ranks, run_ranks
from torch_parity import port_config, tiny_config

N = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _inputs():
    seq = generate_sequence(n_frames=N, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    w = 2 * np.pi / 20.0
    rot = seq.poses[0][:3, :3]
    return dict(cfg=port_config(tiny_config(init_iter_ratio=4)), n=N,
                scans=[np.asarray(s) for s in seq.scans], imus=list(seq.imu_windows),
                seed_pose=(rot.copy(), seq.poses[0][:3, 3].copy(), rot @ np.array([3 * w, 0, 0])))


def test_initialize_with_a_clean_environment_is_a_no_op(clean_env):
    got = dd.initialize(device="cpu")
    want = jdd.initialize()
    assert not got.initialized and not want.initialized
    assert (got.process_index, got.process_count) == (want.process_index, want.process_count)
    assert (got.process_index, got.process_count, got.global_devices) == (0, 1, 1)
    assert got.is_coordinator and not dd.dist.is_initialized()


def test_shutdown_without_a_group_is_a_no_op():
    assert not dd.dist.is_initialized()
    dd.shutdown()
    assert not dd.dist.is_initialized()


def test_initialize_needs_a_size_and_a_rank_with_an_address(clean_env):
    with pytest.raises(ValueError, match="process_id"):
        dd.initialize("localhost:1", device="cpu")


def test_two_processes_join_through_explicit_arguments(tmp_path):
    out = run_ranks("torch_driver_ranks:join_case", 2,
                    dict(url=f"file://{tmp_path / 'join_store'}"), tmp_path / "ranks", group=False)
    for r, o in enumerate(out):
        assert o["ctx"] == dict(initialized=True, process_index=r, process_count=2,
                                local_devices=1, global_devices=2)
        assert o["coordinator"] == (r == 0)
        assert o["total"] == 3.0 and not o["after"]


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """``run_sharded_slam`` beside a direct loop on 2 ranks, and
    ``run_sharded_slam`` alone in a process with no group; side by side."""
    inp = _inputs()
    started = [Ranks("torch_driver_ranks:run_sharded_case", 2, inp,
                     tmp_path_factory.mktemp("run2")),
               Ranks("torch_driver_ranks:lone_case", 1, inp, tmp_path_factory.mktemp("lone"),
                     group=False)]
    try:
        return [r.join() for r in started]
    except BaseException:
        for r in started:
            r.kill()
        raise


def test_run_sharded_slam_equals_a_direct_loop_on_2_ranks(sharded_runs):
    out = sharded_runs[0]
    for o in out:
        assert o["shards"] == 2
        np.testing.assert_array_equal(o["poses"], o["direct"])
        np.testing.assert_array_equal(o["poses"], out[0]["poses"])
        assert o["points"] == o["direct_points"] > 0


def test_run_sharded_slam_without_a_group_runs_one_rank(sharded_runs):
    (lone,) = sharded_runs[1]
    assert not lone["ctx"]["initialized"] and lone["ctx"]["process_count"] == 1
    assert lone["shards"] == 1 and lone["world"] == 1 and lone["points"] > 0
    assert np.isfinite(lone["poses"]).all()


def test_run_multiprocess_tool_prints_zero_divergence():
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-m", "clid_slam_torch.tools.run_multiprocess",
                        "--frames", str(N), "--init-iter-ratio", "4"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])["multiprocess"]
    assert out["processes"] == 2 and out["frames"] == N
    assert out["traj_max_divergence_m"] == 0.0
    assert out["streaming_traj_max_divergence_m"] == 0.0
    assert all(c > 0 for c in out["shard_counts"] + out["streaming_shard_counts"])
