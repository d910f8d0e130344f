"""Frame-step options of the port's StreamingSlam against the JAX package:
a tracked frame at ``feature_dim`` 6 (the mapper's autograd loop) one step
ahead from the JAX state with the JAX draws (pose within 1e-4, as
tests/test_torch_streaming.py holds width 8), and so with decode-then-weight,
with bf16 decoding (pose within 1e-3) and with the color and semantic heads;
and the port's own run of tests/test_streaming.py:128, the dynamic filter
and sliding-window BA on together, under that test's gates."""

import warnings

import numpy as np
import jax
import pytest

from clid_slam_torch.convert import stream_state_from_numpy
from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
from clid_slam_torch.utils import metrics as tmetrics
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from test_torch_streaming import _jax_frame_draws, _seed
from torch_parity import n, port_config, tiny_config

N_JAX = 3


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=12, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


def test_feature_dim_6_tracked_frame_one_step_ahead_matches_jax(seq):
    cfg = tiny_config(feature_dim=6)
    s = JaxSlam(cfg, total_frames=16)
    _seed(s, seq)
    for i in range(N_JAX):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    port = TorchSlam(port_config(cfg), total_frames=16, device="cpu")
    gen = port.state.key
    port.state = stream_state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], "cpu"
    )
    port.state.key = gen
    assert port.state.map_state.geo_feats.shape[1] == 6
    i = N_JAX
    draws = _jax_frame_draws(cfg, s.state.key)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws)
    assert any("feature_dim=6" in str(w.message) for w in caught)  # the autograd loop
    s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    np.testing.assert_allclose(n(port.state.odom_poses[i]), np.asarray(s.state.odom_poses[i]), atol=1e-4)
    assert int(port.state.track_iters[i]) == int(s.state.track_iters[i])
    assert int(port.state.map_state.count) == int(s.state.map_state.count)
    np.testing.assert_allclose(n(port.state.losses[i]), np.asarray(s.state.losses[i]), rtol=5e-2)


# (overrides, pose atol, losses rtol). In bf16 a hidden activation on a
# bf16 rounding boundary rounds either way under any change of the sum's
# order, and the eikonal loss's finite differences over 2 num_grad_eps see
# it: the JAX package's own frame moves its eikonal loss by 13 % when the
# scan moves by 1e-6 m (0.262 -> 0.229 at this frame;
# tests/torch_bf16_sensitivity.py), so the losses are held to 0.2 there
STREAM_OPTIONS = {
    "decode_then_weight": (dict(weighted_first=False), 1e-4, 5e-2),
    "bf16": (dict(mlp_bf16=True), 1e-3, 0.2),
    "color_sem": (dict(color_on=True, color_channel=1, semantic_on=True, sem_class_count=20),
                  1e-4, 5e-2),
}


@pytest.mark.parametrize("option", sorted(STREAM_OPTIONS))
def test_option_tracked_frame_one_step_ahead_matches_jax(seq, option):
    """Each option of the JAX frame step that the port once refused: one
    tracked frame from the JAX state (its wider color slab and semantic
    MLP carried across) with the JAX draws. The tracker decodes as the
    option says, and the mapper runs its autograd loop."""
    overrides, atol, loss_rtol = STREAM_OPTIONS[option]
    cfg = tiny_config(**overrides)
    s = JaxSlam(cfg, total_frames=16)
    _seed(s, seq)
    for i in range(2):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    port = TorchSlam(port_config(cfg), total_frames=16, device="cpu")
    gen = port.state.key
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)]
    assert [x.shape for x in port.state.leaves() if not hasattr(x, "get_state")] == [
        x.shape for i, x in enumerate(leaves) if i != len(leaves) - 3]
    port.state = stream_state_from_numpy(leaves, "cpu")
    port.state.key = gen
    i = 2
    draws = _jax_frame_draws(cfg, s.state.key)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws)
    assert any("running the autograd loop" in str(w.message) for w in caught)
    s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    np.testing.assert_allclose(n(port.state.odom_poses[i]), np.asarray(s.state.odom_poses[i]), atol=atol)
    assert int(port.state.track_iters[i]) == int(s.state.track_iters[i])
    assert int(port.state.map_state.count) == int(s.state.map_state.count)
    np.testing.assert_allclose(n(port.state.losses[i]), np.asarray(s.state.losses[i]), rtol=loss_rtol)
    if option == "color_sem":
        for got, want in ((port.state.color_mlp, s.state.color_mlp), (port.state.sem_mlp, s.state.sem_mlp)):
            for a, b in zip(got.tensors(), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(n(a), np.asarray(b), atol=3 * cfg.lr)
        assert port.state.sem_mlp.w_out.shape[1] == 20 and port.state.map_state.color_feats.shape[1] == 8


def test_port_streaming_with_filter_and_ba_tracks(seq):
    """tests/test_streaming.py:128 on the port: BA every 4 frames over a
    4-frame window and the dynamic filter on every tracked frame."""
    cfg = port_config(tiny_config(
        ba_freq_frame=4, ba_frame=4, ba_iters=20, ba_bs=1024, dynamic_filter_on=True,
    ))
    system = TorchSlam(cfg, total_frames=16, device="cpu")
    _seed(system, seq)
    for i in range(len(seq.scans)):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = system.sync()
    assert not out["failed"]
    m = tmetrics.absolute_error(out["odom_poses"], seq.poses, align=False)
    assert m["ate_rmse_m"] < 0.3, m
    assert out["neural_points"] > 500
    assert out["ba_frames"] == [7, 11]
    assert out["ba_ms"] == [None, None]  # timed on the card only
    assert [f for f, _, _ in out["filtered"]] == list(range(1, len(seq.scans)))
    assert all(0 < a <= b for _, b, a in out["filtered"])
