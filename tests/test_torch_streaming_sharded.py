"""The port's ``StreamingShardedSlam`` (clid_slam_torch/pipeline/
streaming_sharded.py) on spawned gloo ranks, one shard a rank, against the
JAX package's on the conftest's virtual CPU devices:

- tests/test_streaming_sharded.py:42 on 4 ranks: its sequence (10 frames,
  seed 3) and gates: ATE < 0.35 m, not failed, every shard owning points,
  ``neural_points`` the shards' sum;
- tests/test_streaming_sharded.py:61 on 2 ranks: saved after frame 4 of 8,
  loaded into a fresh system and run on, the trajectory equals the
  uninterrupted one bit for bit;
- every rank holds the same replicated state (pose, pool, local map, MLP,
  generator) bit for bit;
- one tracked frame from JAX's state (S = 2, after 3 frames) with JAX's
  draws against JAX's ``make_sharded_frame_step``: pose atol 1e-4,
  ``track_iters`` and the shards' counts and pool size equal, losses rtol
  5e-2 (tests/test_torch_streaming.py:156's tolerances);
- a JAX sharded checkpoint loads into the port and converts back array for
  array (``convert.sharded_stream_state_{from,to}_numpy``);
- the options the sharded step does not run: BA and prune refused at
  construction, the dynamic filter warned of.
"""

import warnings

import numpy as np
import jax
import pytest
import torch.distributed as dist

import torch_jax_draws as jd
from clid_slam_torch.pipeline.streaming_sharded import StreamingShardedSlam as PortSlam
from clid_slam_torch.utils import metrics
from clid_slam_tpu.pipeline.streaming_sharded import StreamingShardedSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from torch_dist import Ranks
from torch_parity import port_config, tiny_config

K_JAX = 3  # JAX frames before the compared one
DEADLINE_S = 600  # a run's frame 0 is 400 steps of the uncached body


def _seq(n):
    return generate_sequence(n_frames=n, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


def _seed_pose(seq):
    w = 2 * np.pi / 20.0
    rot = seq.poses[0][:3, :3]
    return rot.copy(), seq.poses[0][:3, 3].copy(), rot @ np.array([3.0 * w, 0, 0])


def _inputs(seq, n, **kw):
    return dict(cfg=port_config(tiny_config()), n=n, scans=[np.asarray(s) for s in seq.scans[:n]],
                imus=list(seq.imu_windows[:n]), seed_pose=_seed_pose(seq), **kw)


def _jax_side(seq, n, ckpt):
    """JAX's system on 2 devices after K_JAX frames (its checkpoint, its
    leaves and the next frame's draws), then after one more frame."""
    cfg = tiny_config()
    s = JaxSlam(cfg, n_devices=2, total_frames=n + 2)
    s.seed_pose(*_seed_pose(seq))
    for i in range(K_JAX):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    s.save_checkpoint(ckpt)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)]
    _, draws = jd.frame_draws(cfg, s.state.key, sharded=True)
    s.process_frame(K_JAX, seq.scans[K_JAX], seq.imu_windows[K_JAX])
    st = s.state
    after = dict(pose=np.asarray(st.odom_poses[K_JAX]), track_iters=int(st.track_iters[K_JAX]),
                 counts=np.asarray(st.map_state.count), pool_size=int(st.pool.size),
                 losses=np.asarray(st.losses[K_JAX]))
    return leaves, jd.fixed(draws, st.pool), after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank run, the 2-rank save-and-resume run and the 2-rank frame
    from JAX's state; the first two run while the JAX side computes."""
    seq10, seq8 = _seq(10), _seq(8)
    tmp = [tmp_path_factory.mktemp(name) for name in ("track", "resume", "from_jax")]
    started = [
        Ranks("torch_driver_ranks:stream_run_case", 4, _inputs(seq10, 10), tmp[0],
              deadline_s=DEADLINE_S),
        Ranks("torch_driver_ranks:stream_run_case", 2,
              _inputs(seq8, 8, ckpt_at=4, ckpt_path=str(tmp[1] / "ss.npz")), tmp[1],
              deadline_s=DEADLINE_S),
    ]
    try:
        ckpt = str(tmp[2] / "jax.npz")
        leaves, draws, after = _jax_side(seq8, 8, ckpt)
        started.append(Ranks(
            "torch_driver_ranks:stream_from_jax_case", 2,
            _inputs(seq8, 8, ckpt_path=ckpt, leaves=leaves, draws=draws, frame=K_JAX,
                    scan=np.asarray(seq8.scans[K_JAX]), imu=seq8.imu_windows[K_JAX]),
            tmp[2], deadline_s=DEADLINE_S))
        track, resume, from_jax = (r.join() for r in started)
    except BaseException:
        for r in started:
            r.kill()
        raise
    return dict(seq10=seq10, track=track, resume=resume, from_jax=from_jax, ckpt=ckpt,
                after=after)


def test_streaming_sharded_tracks_on_4_ranks(runs):
    seq, out = runs["seq10"], runs["track"]
    r0 = out[0]
    assert not r0["failed"]
    m = metrics.absolute_error(r0["odom_poses"][:10], seq.poses[:10], align=False)
    assert m["ate_rmse_m"] < 0.35, m
    counts = np.array([r["count"] for r in out])
    assert counts.shape == (4,)
    assert (counts > 0).all(), counts
    assert all(r["neural_points"] == counts.sum() for r in out)


def test_streaming_sharded_checkpoint_resume_on_2_ranks(runs):
    for r in runs["resume"]:
        np.testing.assert_array_equal(r["resumed_odom_poses"], r["odom_poses"])
        assert r["resumed_replicated"] == r["replicated"]


@pytest.mark.parametrize("run", ["track", "resume", "from_jax"])
def test_ranks_hold_the_same_replicated_state(runs, run):
    out = runs[run]
    for r in out[1:]:
        assert r["replicated"] == out[0]["replicated"]
        for k in ("odom_poses", "losses", "track_iters", "pose"):
            if k in r:
                np.testing.assert_array_equal(r[k], out[0][k])


def test_tracked_frame_one_step_ahead_matches_jax(runs):
    want = runs["after"]
    for r, got in enumerate(runs["from_jax"]):
        np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-4)
        assert got["track_iters"] == want["track_iters"] > 0
        assert got["count"] == want["counts"][r]
        assert got["pool_size"] == want["pool_size"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-2)


def test_jax_sharded_checkpoint_loads_array_for_array(runs):
    got = runs["from_jax"][0]
    assert got["processed"] == K_JAX
    with np.load(runs["ckpt"]) as z:
        want = [z[f"leaf_{i}"] for i in range(int(z["n_leaves"]))]
    assert len(got["reloaded"]) == len(want)
    for i, (a, b) in enumerate(zip(got["reloaded"], want)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        assert a.dtype == b.dtype and a.shape == b.shape, f"leaf {i}"


@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("option", [dict(ba_freq_frame=10, ba_frame=5),
                                    dict(prune_map_on=True)], ids=["ba", "prune"])
def test_options_that_fail_on_a_sharded_map_are_refused(one_rank, option):
    """The JAX package's BA and prune fail on its [S, ...] map leaves at the
    first call; the port refuses them at construction."""
    cfg = port_config(tiny_config(**option))
    with pytest.raises(ValueError, match=next(iter(option))):
        PortSlam(cfg, total_frames=4, device="cpu")


def test_dynamic_filter_is_not_run_and_says_so(one_rank):
    """The JAX sharded step has no filter (its run with the filter on equals
    the run without it); the port runs none and warns."""
    cfg = port_config(tiny_config(dynamic_filter_on=True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s = PortSlam(cfg, total_frames=4, device="cpu")
    assert any("dynamic_filter_on" in str(w.message) for w in caught)
    assert s.n_shards == 1 and len(s.steps) == 4


def test_card_entry_point_needs_an_nccl_group(one_rank):
    """A gloo group does not serve the card: no fallback."""
    with pytest.raises((ValueError, RuntimeError)):
        PortSlam(port_config(tiny_config()), total_frames=4, device="cuda")

