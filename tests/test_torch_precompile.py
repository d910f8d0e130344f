"""``precompile()`` on the port's streaming drivers (clid_slam_torch/
pipeline/streaming.py and streaming_sharded.py), the counterpart of
``StreamingSlam.precompile`` in the JAX package (tests/test_streaming_sharded.py:33
calls it before its frames):

- it runs every frame-step variant (and the prune) without raising on the
  tiny config and on configs that take other code paths: prune on, the
  dynamic filter with BA, the re-querying tracker, a config the fused
  mapping kernel does not take (leaky ReLU); and leaves every state leaf,
  the generator's state and the host records as they were, bit for bit;
- 8 frames after ``precompile()`` equal 8 frames without it, bit for bit:
  poses, map, pool, losses, ``track_iters``, every leaf and the generator;
- on 2 spawned gloo ranks, ``StreamingShardedSlam.precompile()`` followed
  by frames equals the same frames without it, and ``map_iters`` is the
  run's own.
"""

import numpy as np
import pytest
import torch

from clid_slam_torch.mapping import mapper as mp
from clid_slam_torch.models import neural_map as nm
from clid_slam_torch.pipeline.streaming import StreamingSlam, clone_state
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from torch_dist import Ranks
from torch_driver_ranks import recorded
from torch_parity import port_config, tiny_config

N_FRAMES = 8
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]  # (track, pool filter)
CONFIGS = {
    "tiny": {},
    "prune": dict(prune_map_on=True, prune_freq_frame=4),
    "filter_ba": dict(dynamic_filter_on=True, ba_freq_frame=4, ba_frame=4, ba_iters=20,
                      ba_bs=1024),
    "requery": dict(track_cached=False),
    "k1_ineligible": dict(mlp_leaky_relu=True),
}


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=N_FRAMES, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


def _seed_pose(seq):
    w = 2 * np.pi / 20.0
    rot = seq.poses[0][:3, :3]
    return rot.copy(), seq.poses[0][:3, 3].copy(), rot @ np.array([3.0 * w, 0, 0])


def _system(seq, **overrides):
    s = StreamingSlam(port_config(tiny_config(**overrides)), total_frames=N_FRAMES + 4,
                      device="cpu")
    s.seed_pose(*_seed_pose(seq))
    return s


def _snapshot(system):
    """Copies of every state leaf (the generator as its state) and of the
    host records."""
    leaves = [x.get_state() if isinstance(x, torch.Generator) else x.clone()
              for x in system.state.leaves()]
    records = (system.processed, int(system.insert_dropped), list(system.prune_log),
               list(system.filter_log), list(system.ba_log))
    return leaves, records


def _assert_same_leaves(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i}"


def test_clone_state_is_deep(seq):
    """The clone shares no tensor and no generator with the state: drawing
    from the clone's generator and writing into its tables leave the
    state as it was."""
    s = _system(seq)
    before, _ = _snapshot(s)
    c = clone_state(s.state)
    assert c.key is not s.state.key
    assert torch.equal(c.key.get_state(), s.state.key.get_state())
    torch.rand(16, generator=c.key)
    c.map_state.hash_table.fill_(7)
    c.pool.data.fill_(3.0)
    c.mlp.weights[0].zero_()
    _assert_same_leaves(_snapshot(s)[0], before)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_precompile_leaves_the_state_unchanged(seq, name, monkeypatch):
    """Each variant runs once, with JAX's frame (an empty scan, no IMU rows,
    frame 1), and the prune once with prune_map_on; nothing of it stays."""
    s = _system(seq, **CONFIGS[name])
    calls, seen = [], []

    def recording(step_key, fn):
        def rec(state, frame_id, points, pmask, point_ts, imu_rows, imu_count, *rest):
            seen.append((step_key, frame_id, int(pmask.sum()), imu_count, rest[:4]))
            return fn(state, frame_id, points, pmask, point_ts, imu_rows, imu_count, *rest)

        return rec

    s.steps = {k: recording(k, f) for k, f in s.steps.items()}
    monkeypatch.setattr(nm, "prune_and_rehash",
                        recorded(nm.prune_and_rehash, calls, "prune"))
    monkeypatch.setattr(mp, "map_loop", recorded(mp.map_loop, calls, "map_loop"))
    before, records = _snapshot(s)
    s.precompile()
    after, records_after = _snapshot(s)
    _assert_same_leaves(after, before)
    assert records_after == records
    cfg = s.cfg
    want = [(k, 1, 0, 0, (cfg.max_range, cfg.iters, 1.0, False)) for k in VARIANTS]
    assert seen == want
    assert calls.count("prune") == (1 if cfg.prune_map_on else 0)
    # K1 (its plain version here) in each tracked variant, where the config takes it
    assert calls.count("map_loop") == (0 if cfg.mlp_leaky_relu else 2)


@pytest.mark.parametrize("name", ["tiny", "prune"])
def test_frames_after_precompile_equal_frames_without(seq, name):
    runs = []
    for warm in (True, False):
        s = _system(seq, **CONFIGS[name])
        if warm:
            s.precompile()
        for i in range(N_FRAMES):
            s.process_frame(i, seq.scans[i], seq.imu_windows[i])
        runs.append((s, s.sync()))
    (a, oa), (b, ob) = runs
    for k in ("odom_poses", "travel_dist", "losses", "track_iters"):
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    for k in ("neural_points", "insert_dropped", "prunes", "failed"):
        assert oa[k] == ob[k], k
    assert [f for f, _, _ in oa["prunes"]] == ([3, 7] if name == "prune" else [])
    _assert_same_leaves(_snapshot(a)[0], _snapshot(b)[0])


def test_sharded_precompile_on_2_ranks(seq, tmp_path):
    """tests/test_streaming_sharded.py:33's ``precompile()`` before the
    frames, on 2 gloo ranks: the run equals the run without it and
    ``map_iters`` lists the frames' own steps. Frame 0 maps 4 x iters
    steps here (init_iter_ratio 4) to keep the two runs short."""
    n = 4
    cfg = port_config(tiny_config(init_iter_ratio=4))
    out = Ranks("torch_driver_ranks:stream_precompile_case", 2,
                dict(cfg=cfg, n=n, scans=[np.asarray(x) for x in seq.scans[:n]],
                     imus=list(seq.imu_windows[:n]), seed_pose=_seed_pose(seq)),
                tmp_path, deadline_s=400).join()
    for r in out:
        assert r["unchanged_by_precompile"]
        assert sorted(r["precompiled_variants"]) == sorted(VARIANTS)
        warm, cold = r["warm"], r["cold"]
        for k in ("odom_poses", "losses", "track_iters"):
            np.testing.assert_array_equal(warm[k], cold[k], err_msg=k)
        assert warm["map_iters"] == cold["map_iters"]
        assert [f for f, _ in warm["map_iters"]] == list(range(n))
        assert warm["map_iters"][0][1] == cfg.iters * 4
        assert warm["state"] == cold["state"]
    assert out[0]["warm"]["replicated"] == out[1]["warm"]["replicated"]
