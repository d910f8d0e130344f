"""The port's classic driver (clid_slam_torch/pipeline/slam.py) in closed
loop on the CPU, under the JAX tests' own sequence, seed and gates
(tests/test_slam_integration.py:64-175): 12 tracked frames (ATE < 0.2 m,
ARE < 3 deg), mapping only with ground-truth poses, a checkpoint
roundtrip that keeps tracking, and ``adjust_map`` by a PGO-style
correction that keeps tracking in the corrected frame (ATE < 0.25 m). Then
the port's classic and streaming drivers on one sequence, under
tests/test_streaming.py:159's gates.

The JAX tests' seed is a JAX key: the port's systems start from the JAX
systems' initial decoders and take the JAX key chain's random numbers
every frame (tests/torch_jax_draws.py), so each test runs the JAX test's
own random experiment."""

import numpy as np
import pytest

import jax

import torch_jax_draws as jd
from clid_slam_torch.convert import classic_state_from_numpy, stream_state_from_numpy
from clid_slam_torch.odometry.iekf import _so3_exp
from clid_slam_torch.pipeline.slam import SlamSystem
from clid_slam_torch.pipeline.streaming import StreamingSlam
from clid_slam_torch.utils import metrics
from clid_slam_tpu.pipeline.slam import SlamSystem as JaxSystem
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxStreaming
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from test_torch_slam import _jax_arrays
from torch_parity import port_config, tiny_config


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=12, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


class JaxDraws:
    """The JAX driver's key chain from a JAX system's key: ``next(i)`` is
    frame i's draws."""

    def __init__(self, cfg, key):
        self.cfg, self.key = cfg, key

    def next(self, frame_id):
        n = jd.first_frame_batches(self.cfg) if frame_id == 0 else 1
        self.key, draws = jd.frame_draws(self.cfg, self.key, n)
        return draws


def _port_system(**overrides):
    """The port's system at the JAX system's initial state, and the JAX
    key chain that follows it."""
    cfg = tiny_config(**overrides)
    jsys = JaxSystem(cfg, total_frames=16)
    system = SlamSystem(port_config(cfg), total_frames=16, device="cpu")
    classic_state_from_numpy(system, _jax_arrays(jsys))
    return system, JaxDraws(cfg, jsys.key)


def _run(system, draws, seq, frames):
    return [system.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws.next(i))
            for i in frames]


def _seeded(seq, **overrides):
    system, draws = _port_system(**overrides)
    w = 2 * np.pi / 20.0
    system.tracker.x.pos = seq.poses[0][:3, 3].copy()
    system.tracker.x.rot = seq.poses[0][:3, :3].copy()
    system.tracker.x.vel = seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0])
    return system, draws


@pytest.fixture(scope="module")
def classic_run(seq):
    system, draws = _seeded(seq)
    return system, _run(system, draws, seq, range(len(seq.scans)))


def test_slam_closed_loop_tracks(classic_run, seq):
    system, stats = classic_run
    for i, st in enumerate(stats):
        assert st.tracking_ok, f"tracking failed at frame {i}"
    est = system.dataset.odom_poses[: len(seq.scans)]
    m = metrics.absolute_error(est, seq.poses, align=False)
    assert m["ate_rmse_m"] < 0.2, m
    assert m["are_rmse_deg"] < 3.0, m
    assert int(system.map_state.count) > 500
    assert all(st.track_iters > 0 for st in stats[1:])


def test_slam_mapping_only_with_gt_poses(seq):
    system, draws = _port_system(track_on=False)
    system.dataset.gt_poses = seq.poses
    system.dataset.gt_pose_provided = True
    for i in range(6):
        system.dataset.cur_pose_ref = seq.poses[i]
        system.dataset.odom_poses[i] = seq.poses[i]
        if i > 0:
            system.dataset.travel_dist[i] = system.dataset.travel_dist[i - 1] + np.linalg.norm(
                seq.poses[i][:3, 3] - seq.poses[i - 1][:3, 3]
            )
        st = system.process_frame(i, seq.scans[i], None, draws=draws.next(i))
        assert np.isfinite(st.sdf_loss)
    assert int(system.map_state.count) > 300


def test_checkpoint_roundtrip(tmp_path, seq):
    system, draws = _seeded(seq)
    _run(system, draws, seq, range(4))
    p = str(tmp_path / "ckpt.npz")
    system.save_checkpoint(p)

    system2 = SlamSystem(system.cfg, total_frames=16, device="cpu")
    system2.load_checkpoint(p)
    assert int(system2.map_state.count) == int(system.map_state.count)
    assert system2.dataset.processed_frame == 4
    np.testing.assert_array_equal(system2.map_state.geo_feats.numpy(),
                                  system.map_state.geo_feats.numpy())
    assert system2.key.get_state().equal(system.key.get_state())
    # the resumed system keeps tracking
    for st in _run(system2, draws, seq, range(4, 8)):
        assert st.tracking_ok


def test_adjust_map_keeps_tracking(seq):
    """A PGO-style global pose correction mid-run: the map moves rigidly
    with the corrected trajectory, every query switches to rotate_vecs,
    and tracking continues against the adjusted map."""
    system, draws = _seeded(seq)
    for st in _run(system, draws, seq, range(6)):
        assert st.tracking_ok

    D = np.eye(4)
    D[:3, :3] = _so3_exp(np.array([0.0, 0.0, 0.05]))
    D[:3, 3] = [0.2, -0.1, 0.05]
    corrected = np.einsum("ij,tjk->tik", D, system.dataset.odom_poses[:6])
    system.tracker.x.rot = D[:3, :3] @ system.tracker.x.rot
    system.tracker.x.pos = D[:3, :3] @ system.tracker.x.pos + D[:3, 3]
    system.tracker.x.vel = D[:3, :3] @ system.tracker.x.vel
    system.adjust_map(corrected)
    assert system.after_pgo

    for i, st in zip(range(6, len(seq.scans)), _run(system, draws, seq, range(6, len(seq.scans)))):
        assert st.tracking_ok, f"tracking failed at frame {i} after adjust"

    est = system.dataset.odom_poses[: len(seq.scans)]
    gt_corr = np.einsum("ij,tjk->tik", D, seq.poses)
    m = metrics.absolute_error(est, gt_corr, align=False)
    assert m["ate_rmse_m"] < 0.25, m


def test_classic_and_streaming_drivers_agree(classic_run, seq):
    """Both drivers run the JAX key chain's random experiment (the JAX
    drivers share it); what differs is the host f64 filter and the
    whole-scan tracker against the device f32 propagation and the compacted
    source cloud (tests/test_streaming.py:159)."""
    system, _ = classic_run
    est_classic = system.dataset.odom_poses[: len(seq.scans)]
    cfg = tiny_config()
    jstream = JaxStreaming(cfg, total_frames=16)
    stream = StreamingSlam(port_config(cfg), total_frames=16, device="cpu")
    gen = stream.state.key
    stream.state = stream_state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jstream.state)], "cpu")
    stream.state.key = gen
    draws = JaxDraws(cfg, jstream.state.key)
    w = 2 * np.pi / 20.0
    stream.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3],
                     vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]))
    for i in range(len(seq.scans)):
        stream.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws.next(i))
    est_stream = stream.sync()["odom_poses"]
    np.testing.assert_array_equal(stream.dataset.odom_poses[: len(seq.scans)], est_stream)

    d = np.linalg.norm(est_classic[:, :3, 3] - est_stream[:, :3, 3], axis=-1)
    assert d[:5].max() < 0.05, d
    m_c = metrics.absolute_error(est_classic, seq.poses[: len(est_classic)], align=False)
    m_s = metrics.absolute_error(est_stream, seq.poses[: len(est_stream)], align=False)
    assert m_c["ate_rmse_m"] < 0.2 and m_s["ate_rmse_m"] < 0.2, (m_c, m_s)
    assert abs(m_c["ate_rmse_m"] - m_s["ate_rmse_m"]) < 0.08, (m_c, m_s)
