"""The port's fused mapping path held against the JAX package's own fused
path. The JAX frame step turns its Pallas kernel on only on a TPU, so off
it the JAX tracked frames run the XLA loop; ``torch_jax_draws.jax_fused``
puts them on the kernel (interpreted on the CPU), and the port's tracked
frames run the kernel's plain version (``ops/map_loop.py:
map_loop_reference``). Both then follow one rule, the kernel's, at
samples whose logit and target saturate together (there ``sigmoid(z) - t``
rounds to 0; the XLA loop's autodiff keeps a few 1e-9, which Adam's eps of
1e-15 turns into lr-sized steps).

- The switch: under it JAX builds its kernel and calls it once a tracked
  frame, and never without it; the key chain does not move.
- One tracked frame one step ahead, from the same JAX state with the same
  draws and JAX's replay batch injected, on the tiny sequence of
  tests/test_torch_streaming.py and on the cut large scenario
  (tests/torch_seed_sweep.py:cut_large, a frame whose batch holds free-space
  samples with a saturated logit and target): pose, iteration count, point
  count, pool size, the trained features and the MLP, and the frame's
  losses, under ``TOL``. What remains is Adam's first, sign-like steps
  (``lr * g / (|g| + eps)``) flipping at elements whose gradient is near
  zero, seeded by the two sides' f32 reduction orders and by prep's
  rounding-level label differences (hundreds of rows of the cut large
  batch, at most 2e-3 in the logistic target): the largest differences
  reach 0.8 lr (cut large) and 0.01 lr (tiny), while 99 % of the elements
  agree to 0.02 lr and 2e-4 lr. The XLA loop leaves the features 10 to
  1000 times further apart at these frames.
- The kernel's marshalling alone: JAX's fast mapping body on its kernel and
  the port's ``make_mapping_fn(use_pallas=True)`` on one scene and batch,
  at a ``bs`` (1000) that the kernel pads to its chunk (1024) and a tap
  count ``bd`` (100) that it pads to 128: one Adam step agrees to 1e-6
  (tap rows, permutation and padding), seven to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench as jax_bench
import torch_jax_draws as jd
from clid_slam_torch.convert import (
    mlp_from_numpy, neural_map_from_numpy, pool_from_numpy, stream_state_from_numpy,
)
from clid_slam_torch.mapping import mapper as tmapper
from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
from clid_slam_tpu.mapping import mapper as jmp
from clid_slam_tpu.mapping.pool import sample_batch_indices as jax_batch
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence, large_world
from test_torch_mapper import MAP_KW, _scene
from torch_parity import n, port_config, t, tiny_config
from torch_seed_sweep import cut_large

LR = 0.01  # both scenarios' cfg.lr
# measured one step ahead (features: largest, 99.9th and 99th percentile
# of |port - JAX| over the live rows): tiny frame 3 8.1e-5, 2.3e-5, 1.8e-6,
# MLP 7.5e-7, losses 0 relative; cut large frame 2 8.0e-3, 2.2e-3, 2.0e-4,
# MLP 1.2e-3, losses 2e-5 relative. With JAX on its XLA loop the same
# frames read 99.9th percentiles of 2.6e-2 and 2.4e-2.
TOL = {
    "tiny": dict(max=0.1 * LR, q999=0.02 * LR, q99=0.002 * LR, mlp=1e-5, loss=1e-5),
    "large": dict(max=3 * LR, q999=0.5 * LR, q99=0.05 * LR, mlp=0.5 * LR, loss=2e-4),
}
POSE_ATOL = 1e-5  # measured 2.4e-7 (tracking runs before mapping)


def _tiny():
    seq = generate_sequence(n_frames=12, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    vel = seq.poses[0][:3, :3] @ np.array([3.0 * 2 * np.pi / 20.0, 0, 0])
    return tiny_config(), seq, vel


def _cut_large():
    cfg = cut_large(jax_bench.build_config(large=True), 1 << 16, 1 << 19)
    seq = generate_sequence(
        n_frames=4, n_azimuth=256, n_elev=24, noise_std=0.01, radius=32.0,
        period_frames=400.0, seed=3, world=large_world(np.random.default_rng(11), room_radius=50.0),
        ramp_frames=25.0, hold_frames=15.0, spin_phase=True,
    )
    return cfg, seq, (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / 0.1


def _jax_run(cfg, seq, vel, last, on=True):
    """The JAX StreamingSlam over frames 0..last under ``jax_fused(on)``:
    the state leaves and key before frame ``last``, the system after it,
    its replay batch of that frame (final indices, on its post-frame pool),
    the key after each frame, the pool after frame 1 and the kernel's
    counts."""
    with jd.jax_fused(on) as count:
        s = JaxSlam(cfg, total_frames=16)
        s.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], vel=vel)
        keys = []
        for i in range(last + 1):
            if i == last:
                before = [np.array(x) for x in jax.tree_util.tree_leaves(s.state)]
                key = s.state.key
                # the fast body's batch key: the frame's second split of the
                # state key, split once more (pipeline/streaming.py:490,
                # mapping/mapper.py:1061)
                _, k_map = jax.random.split(jax.random.split(key)[0])
                k_batch = jax.random.split(k_map)[1]
            s.process_frame(i, seq.scans[i], seq.imu_windows[i])
            keys.append(np.asarray(s.state.key))
            if i == 1:
                pool1 = np.asarray(s.state.pool.data)
        s.block()
        idx = np.asarray(jax_batch(s.state.pool, k_batch, cfg.bs, cfg.bs_new_sample))
        counts = count.read()
    return dict(cfg=cfg, seq=seq, frame=last, before=before, key=key, after=s.state,
                idx=idx, keys=keys, pool1=pool1, counts=counts)


def _saturated_rows(f0, w0, encw0, label_op, wsel, mlp, sdf_scale, sigma):
    """Batch rows whose logit (at the batch's features and MLP) and target
    both saturate: ``sigmoid(z)`` and the target round to 1 in f32, so the
    kernel's gradient ``sigmoid(z) - t`` is exactly 0 there."""
    h = torch.cat([torch.sum(f0 * w0[..., None], 1), encw0], -1)
    for w, b in zip(mlp.weights, mlp.biases):
        h = torch.relu(h @ w + b)
    z = ((h @ mlp.w_out)[..., 0] + mlp.b_out.reshape(())) * sdf_scale / sigma
    return int(((torch.sigmoid(z) == 1.0) & (label_op == 1.0) & (wsel > 0)).sum())


def _port_one_step(run, monkeypatch):
    """The port's frame ``run["frame"]`` from the JAX state before it, with
    the JAX draws and the JAX replay batch; returns the port's state and
    the fused loop's calls (saturated rows of each)."""
    cfg, seq, i = run["cfg"], run["seq"], run["frame"]
    port = TorchSlam(port_config(cfg), total_frames=16, device="cpu")
    gen = port.state.key
    port.state = stream_state_from_numpy(run["before"], "cpu")
    port.state.key = gen
    idx = torch.tensor(run["idx"]).long()
    monkeypatch.setattr(tmapper, "sample_batch_indices", lambda *a, **k: idx)
    calls, real = [], tmapper.map_loop

    def loop(*a, **k):
        calls.append(_saturated_rows(*a[:5], a[8], k["sdf_scale"], k["sigma"]))
        return real(*a, **k)

    monkeypatch.setattr(tmapper, "map_loop", loop)
    port.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=jd.frame_draws(cfg, run["key"])[1])
    return port.state, calls


@pytest.fixture(scope="module")
def tiny_run():
    return _jax_run(*_tiny(), last=3)


@pytest.fixture(scope="module")
def large_run():
    return _jax_run(*_cut_large(), last=2)


def test_switch_runs_the_pallas_kernel_once_a_tracked_frame(tiny_run):
    """Four frames under the switch: frame 0 maps on the general body, the
    three tracked frames each call the kernel once (one build: they share a
    trace). Two frames without it: neither build nor call. How the key
    chain was checked: the state key after each frame and the pool that
    frame 1's prep wrote (prep draws its samples from that chain) are
    bit-equal with and without the switch, so ``frame_draws`` feeds the
    port the same numbers either way; the kernel path splits the mapping
    key as the XLA loop does (mapping/mapper.py:1061)."""
    builds, calls = tiny_run["counts"]
    assert builds >= 1 and calls == 3, (builds, calls)
    off = _jax_run(*_tiny(), last=1, on=False)
    assert off["counts"] == (0, 0)
    assert len(off["keys"]) == 2
    for a, b in zip(off["keys"], tiny_run["keys"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(off["pool1"], tiny_run["pool1"])


def _assert_one_step(run, state, tol):
    js, i = run["after"], run["frame"]
    np.testing.assert_allclose(n(state.odom_poses[i]), np.asarray(js.odom_poses[i]), atol=POSE_ATOL)
    assert int(state.track_iters[i]) == int(js.track_iters[i])
    assert int(state.map_state.count) == int(js.map_state.count)
    assert int(state.pool.size) == int(js.pool.size)
    live = int(js.map_state.count)
    got, want = n(state.map_state.geo_feats[:live]), np.asarray(js.map_state.geo_feats[:live])
    d = np.abs(got - want)
    moved = np.abs(want - run["before"][14][:live])  # geo_feats leaf of the state
    assert moved.max() > 5 * LR  # the frame trained the map
    assert d.max() < tol["max"], d.max()
    assert np.quantile(d, 0.999) < tol["q999"], np.quantile(d, 0.999)
    assert np.quantile(d, 0.99) < tol["q99"], np.quantile(d, 0.99)
    for a, b in zip(state.mlp.tensors(), jax.tree_util.tree_leaves(js.mlp)):
        assert np.abs(n(a) - np.asarray(b)).max() < tol["mlp"]
    np.testing.assert_allclose(n(state.losses[i]), np.asarray(js.losses[i]), rtol=tol["loss"])


def test_tiny_tracked_frame_one_step_ahead_on_the_fused_paths(tiny_run, monkeypatch):
    state, calls = _port_one_step(tiny_run, monkeypatch)
    assert len(calls) == 1
    _assert_one_step(tiny_run, state, TOL["tiny"])


def test_cut_large_tracked_frame_one_step_ahead_on_the_fused_paths(large_run, monkeypatch):
    builds, calls = large_run["counts"]
    assert builds >= 1 and calls == 2, (builds, calls)
    state, sat = _port_one_step(large_run, monkeypatch)
    # the batch holds rows where the two rules part (measured: 20)
    assert len(sat) == 1 and sat[0] >= 5, sat
    _assert_one_step(large_run, state, TOL["large"])


def test_kernel_marshalling_at_padded_bs_and_bd():
    """JAX's fast body on its kernel and the port's kernel-path body, one
    scene and batch, bs 1000 (padded to 1024) and bd 100 (padded to 128):
    1 Adam step to 1e-6 (measured 3e-8), 7 steps to 1e-5 (measured 7.5e-7
    features, 6.5e-7 MLP); certainty to 1e-4 relative, update stamps
    exact."""
    bs = 1000
    kw = dict(MAP_KW, bs=bs, resample_every=20, max_outer=1, dup_independent=True, use_pallas=True)
    assert bs // kw["gradient_decimation"] % 128 and bs % 1024
    ms, pool, mlp, td = _scene()
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(jax.random.split(key)[1])
    draws = [(np.asarray(jax.random.randint(k1, (bs,), 0, int(pool.size))),
              np.asarray(jax.random.randint(k2, (kw["bs_new"],), 0, int(pool.new_count))))]
    tmap = neural_map_from_numpy([np.asarray(x) for x in ms], "cpu")
    tpool = pool_from_numpy([np.asarray(x) for x in pool], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, mlp), "cpu")
    with jd.jax_fused(on=False) as count:
        jbody = jax.jit(jmp.make_mapping_fn(**kw, as_body=True))
        tbody = tmapper.make_mapping_fn(**kw)
        for iters, atol in ((1, 1e-6), (7, 1e-5)):
            js, jm, _, _, jl = jbody(ms, mlp, mlp, mlp, pool, td, 1, 1e9, key, jnp.int32(iters),
                                     jnp.float32(1.0))
            ts, tm, _, _, tl = tbody(tmap, tmlp, tmlp, tmlp, tpool, t(td), 1, 1e9, iters, 1.0,
                                     batch_draws=draws)
            moved = np.abs(np.asarray(js.geo_feats) - np.asarray(ms.geo_feats)).max()
            assert moved > 0.9 * iters * LR  # every step moved some feature by about lr
            np.testing.assert_allclose(n(ts.geo_feats), np.asarray(js.geo_feats), rtol=0, atol=atol)
            for a, b in zip(tm.tensors(), jax.tree_util.tree_leaves(jm)):
                np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=atol)
            np.testing.assert_allclose(n(tl), np.asarray(jl), rtol=1e-5)
            np.testing.assert_allclose(n(ts.certainty), np.asarray(js.certainty), rtol=1e-4, atol=1e-5)
            np.testing.assert_array_equal(n(ts.ts_update), np.asarray(js.ts_update))
        assert count.read() == (1, 2)  # one trace, two kernel calls: the kernel ran
