"""The port's ``ShardedSlamSystem`` (clid_slam_torch/parallel/slam_sharded.py)
on spawned gloo ranks, one shard a rank, against the JAX package's on the
conftest's virtual CPU devices:

- tests/test_slam_sharded.py:27 on 4 ranks (JAX's test uses 8 devices): its
  sequence (12 frames, seed 3) and gates: ATE < 0.25 m, ARE < 4 deg, not
  failed, more than 500 points;
- tests/test_slam_sharded.py:48 in the same run: after 3 frames every shard
  owns points and none holds half of them;
- every rank holds the same trajectory, pool, local map, MLP and generator
  bit for bit;
- one tracked frame from JAX's state (S = 2, after 3 frames) with JAX's
  draws: pose atol 1e-4, the shards' counts, the pool size and the
  lose-track flag equal, losses rtol 5e-2 (tests/test_torch_slam.py:93's
  tolerances; the sharded classic loop records no iteration count).
"""

import numpy as np
import jax
import pytest

import torch_jax_draws as jd
from clid_slam_torch.utils import metrics
from clid_slam_tpu.parallel.slam_sharded import ShardedSlamSystem as JaxSystem
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from torch_dist import Ranks
from torch_parity import port_config, tiny_config

N = 12
K_JAX = 3
DEADLINE_S = 600  # frame 0 is 400 steps of the uncached body


def _seed_pose(seq):
    w = 2 * np.pi / 20.0
    rot = seq.poses[0][:3, :3]
    return rot.copy(), seq.poses[0][:3, 3].copy(), rot @ np.array([3.0 * w, 0, 0])


def _inputs(seq, **kw):
    return dict(cfg=port_config(tiny_config()), n=N, scans=[np.asarray(s) for s in seq.scans],
                imus=list(seq.imu_windows), seed_pose=_seed_pose(seq), **kw)


def _jax_side(seq):
    """JAX's system on 2 devices after K_JAX frames (its state and the next
    frame's draws), then after one more frame."""
    cfg = tiny_config()
    s = JaxSystem(cfg, n_devices=2, total_frames=16)
    rot, pos, vel = _seed_pose(seq)
    s.tracker.x.pos, s.tracker.x.rot, s.tracker.x.vel = pos, rot, vel
    for i in range(K_JAX):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    leaves = lambda tree: [np.asarray(a) for a in jax.tree.leaves(tree)]  # noqa: E731
    x = s.tracker.x
    state = dict(
        map=leaves(s.map_state), local_map=leaves(s.local_map), pool=leaves(s.pool),
        mlp=leaves(s.mlp), x={k: getattr(x, k) for k in ("rot", "pos", "vel", "bg", "ba", "grav")},
        P=s.tracker.P, odom_poses=s.odom_poses.copy(), travel_dist=s.travel_dist.copy(),
        travel_dist_dev=np.asarray(s.travel_dist_dev), last_pose=s.last_pose.copy(),
        lose_track=s.lose_track, failed=bool(s.failed), total_frames=16,
    )
    _, draws = jd.frame_draws(cfg, s.key, sharded=True)
    s.process_frame(K_JAX, seq.scans[K_JAX], seq.imu_windows[K_JAX])
    after = dict(pose=s.odom_poses[K_JAX].copy(), counts=np.asarray(s.map_state.count),
                 pool_size=int(s.pool.size), losses=np.asarray(s._last_losses),
                 lose_track=s.lose_track)
    return state, jd.fixed(draws, s.pool), after


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=N, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


@pytest.fixture(scope="module")
def runs(seq, tmp_path_factory):
    """The 4-rank run (started first, it runs while the JAX side computes)
    and the 2-rank frame from JAX's state."""
    started = [Ranks("torch_driver_ranks:classic_run_case", 4, _inputs(seq, counts_after=3),
                     tmp_path_factory.mktemp("classic4"), deadline_s=DEADLINE_S)]
    try:
        state, draws, after = _jax_side(seq)
        started.append(Ranks(
            "torch_driver_ranks:classic_from_jax_case", 2,
            _inputs(seq, state=state, draws=draws, frame=K_JAX,
                    scan=np.asarray(seq.scans[K_JAX]), imu=seq.imu_windows[K_JAX]),
            tmp_path_factory.mktemp("classic_from_jax"), deadline_s=DEADLINE_S))
        run4, from_jax = (r.join() for r in started)
    except BaseException:
        for r in started:
            r.kill()
        raise
    return dict(run4=run4, from_jax=from_jax, after=after)


def test_sharded_slam_tracks_on_4_ranks(seq, runs):
    r0 = runs["run4"][0]
    assert not r0["failed"]
    m = metrics.absolute_error(r0["odom_poses"], seq.poses, align=False)
    assert m["ate_rmse_m"] < 0.25, m
    assert m["are_rmse_deg"] < 4.0, m
    assert r0["neural_points"] > 500


def test_sharded_map_is_partitioned_on_4_ranks(runs):
    counts = np.array([r["counts_after"] for r in runs["run4"]])
    assert counts.shape == (4,)
    assert int((counts > 0).sum()) == 4  # every shard owns points
    assert counts.max() < 0.5 * counts.sum()  # hash ownership: no shard dominates
    assert all(r["neural_points"] == sum(q["count"] for q in runs["run4"]) for r in runs["run4"])


def test_ranks_hold_the_same_replicated_state(runs):
    out = runs["run4"]
    for r in out[1:]:
        np.testing.assert_array_equal(r["odom_poses"], out[0]["odom_poses"])
        assert r["replicated"] == out[0]["replicated"]
    a, b = runs["from_jax"]
    assert (a["pool"], a["mlp"]) == (b["pool"], b["mlp"])
    np.testing.assert_array_equal(a["pose"], b["pose"])


def test_tracked_frame_one_step_ahead_matches_jax(runs):
    want = runs["after"]
    for r, got in enumerate(runs["from_jax"]):
        np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-4)
        assert got["lose_track"] == want["lose_track"] is False
        assert got["count"] == want["counts"][r]
        assert got["pool_size"] == want["pool_size"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-2)
