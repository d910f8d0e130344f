"""Frame-step options of the port's StreamingSlam against the JAX package:
a tracked frame at ``feature_dim`` 6 (the mapper's autograd loop) one step
ahead from the JAX state with the JAX draws (pose within 1e-4, as
tests/test_torch_streaming.py holds width 8); and the port's own run of
tests/test_streaming.py:128, the dynamic filter and sliding-window BA on
together, under that test's gates."""

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
