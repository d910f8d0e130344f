"""The streaming frame step as a whole. A JAX StreamingSlam state carried
across with clid_slam_torch.convert: array by array, the SDF at the scan
points (atol 1e-5), the cached update on the JAX-trained map (poses within
2e-3) and one tracked frame with the JAX draws (pose within 1e-4). Then the
port's own StreamingSlam over the 12-frame sequence of
tests/test_streaming.py under that file's gates. Last, the prune cadence:
a tracked frame that ends in a prune (the same rows kept in the same order,
positions within 1e-5, features' 99.9th percentile within 3 lr) and the frame after it, one step ahead
from the pruned state (pose within 1e-4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clid_slam_torch.convert import stream_state_from_numpy
from clid_slam_torch.models import decoder as tdec
from clid_slam_torch.models import neural_map as tnm
from clid_slam_torch.odometry import iekf as tie
from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
from clid_slam_torch.utils import metrics as tmetrics
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.odometry import iekf as jie
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence
import torch_jax_draws as jd
from torch_parity import n, port_config, t, tiny_config

N_JAX = 3


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=12, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


def _seed(system, seq):
    w = 2 * np.pi / 20.0
    system.seed_pose(
        seq.poses[0][:3, :3], seq.poses[0][:3, 3],
        vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]),
    )


@pytest.fixture(scope="module")
def jax_run(seq):
    cfg = tiny_config()
    s = JaxSlam(cfg, total_frames=16)
    _seed(s, seq)
    for i in range(N_JAX):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    s.block()
    return cfg, s


def _port_tensors(st):
    """The port state's tensors in the JAX tree order (the key slot holds
    a generator, not a tensor, and is skipped)."""
    out = [st.rot, st.pos, st.rest, st.P, st.last_pose, st.odom_poses,
           st.travel_dist, st.lose_track, st.consec_lose, st.stop_count,
           st.stop_status, st.failed]
    out += st.map_state.tensors() + st.local_map.tensors() + st.pool.tensors()
    out += st.mlp.tensors() + st.color_mlp.tensors() + st.sem_mlp.tensors()
    return out + [None, st.losses, st.track_iters]


def test_state_conversion_array_by_array(jax_run):
    _, s = jax_run
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)]
    st = stream_state_from_numpy(leaves, device="cpu")
    ours = _port_tensors(st)
    assert len(ours) == len(leaves)
    for i, (a, b) in enumerate(zip(ours, leaves)):
        if a is not None:
            np.testing.assert_array_equal(n(a), b.astype(n(a).dtype), err_msg=f"leaf {i}")
    assert int(st.map_state.count) > 500


def test_sdf_at_scan_points_after_conversion(jax_run, seq):
    cfg, s = jax_run
    st = stream_state_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], "cpu")
    pose = np.asarray(s.state.odom_poses[N_JAX - 1])
    pts = seq.scans[N_JAX - 1][:4000] @ pose[:3, :3].T + pose[:3, 3]
    pts = pts.astype(np.float32)
    nb = s.nb_offs
    mvd2 = 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2
    jq = jnm.query_feature(s.state.map_state, jnp.asarray(pts), nb, cfg.voxel_size_m, mvd2,
                           cfg.query_nn_k, s.state.travel_dist, N_JAX - 1, 1e9, True)
    want = np.asarray(jdec.sdf(s.state.mlp, jq.feature, cfg.sdf_scale))
    tq = tnm.query_feature(st.map_state, t(pts), t(nb), cfg.voxel_size_m, mvd2,
                           cfg.query_nn_k, st.travel_dist, N_JAX - 1, 1e9, True)
    got = n(tdec.sdf(st.mlp, tq.feature, cfg.sdf_scale))
    np.testing.assert_array_equal(n(tq.knn_idx), np.asarray(jq.knn_idx))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (np.asarray(jq.nn_count) > 0).mean() > 0.9


def test_cached_update_on_trained_map(jax_run, seq):
    cfg, s = jax_run
    st = stream_state_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], "cpu")
    kw = dict(
        knn_k=cfg.query_nn_k, n_cand=16, nb_offs=s.nb_offs, resolution=cfg.voxel_size_m,
        max_valid_dist2=3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2,
        sdf_scale=cfg.sdf_scale, min_grad_norm=cfg.reg_min_grad_norm,
        max_grad_norm=cfg.reg_max_grad_norm, min_nn_count=cfg.track_mask_query_nn_k,
        max_iteration=cfg.reg_iter_n, term_thre_deg=cfg.reg_term_thre_deg,
        term_thre_m=cfg.reg_term_thre_m,
    )
    src = seq.scans[N_JAX][::6][:1500].astype(np.float32)
    mask = np.ones(len(src), bool)
    # start from the last pose pushed 3 cm / 0.6 degrees off the truth
    c, sn = np.cos(0.01), np.sin(0.01)
    rot0 = (seq.poses[N_JAX][:3, :3] @ np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])).astype(np.float32)
    pos0 = (np.asarray(seq.poses[N_JAX][:3, 3]) + [0.03, -0.02, 0.01]).astype(np.float32)
    rest0, P = np.asarray(s.state.rest), np.asarray(s.state.P)
    jr = jax.jit(jie.make_cached_update_fn(**kw))(
        s.state.map_state, s.state.mlp, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(rot0),
        jnp.asarray(pos0), jnp.asarray(rest0), jnp.asarray(P), s.state.travel_dist, N_JAX, 1e9,
    )
    tr = tie.make_cached_update_fn(**kw)(
        st.map_state, st.mlp, t(src), t(mask), t(rot0), t(pos0), t(rest0), t(P),
        st.travel_dist, N_JAX, 1e9,
    )
    np.testing.assert_allclose(n(tr[1]), np.asarray(jr[1]), atol=2e-3)
    np.testing.assert_allclose(n(tr[0]), np.asarray(jr[0]), atol=2e-3)
    assert bool(tr[4]) == bool(jr[4])
    # the update pulls the perturbed start toward the true pose
    err0 = np.linalg.norm(pos0 - seq.poses[N_JAX][:3, 3])
    assert np.linalg.norm(n(tr[1]) - seq.poses[N_JAX][:3, 3]) < 0.7 * err0


def test_port_streaming_slam_tracks(seq):
    cfg = port_config(tiny_config())
    system = TorchSlam(cfg, total_frames=16, device="cpu")
    _seed(system, seq)
    for i in range(len(seq.scans)):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = system.sync()
    assert not out["failed"]
    m = tmetrics.absolute_error(out["odom_poses"], seq.poses, align=False)
    assert m["ate_rmse_m"] < 0.2, m
    assert m["are_rmse_deg"] < 3.5, m
    assert out["neural_points"] > 500
    assert out["insert_dropped"] == 0
    assert np.all(np.isfinite(out["losses"])) and np.all(out["track_iters"][1:] > 0)


def _jax_frame_draws(cfg, key):
    """The random numbers the JAX tracked frame step draws from ``key``,
    in the port's injection format (pipeline/streaming.py:make_frame_step;
    tests/torch_jax_draws.py)."""
    return jd.frame_draws(cfg, key)[1]


def test_tracked_frame_one_step_ahead_matches_jax(jax_run, seq):
    """One tracked frame from the same state with the same draws: the whole
    frame step (IMU, tracking, prep, kernel-path mapping) agrees before the
    loop's chaos can amplify anything. Runs last: it advances the shared
    JAX system by one frame."""
    cfg, s = jax_run
    i = N_JAX
    port = TorchSlam(port_config(cfg), total_frames=16, device="cpu")
    gen = port.state.key
    port.state = stream_state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], "cpu"
    )
    port.state.key = gen
    draws = _jax_frame_draws(cfg, s.state.key)
    port.process_frame(i, seq.scans[i], seq.imu_windows[i], draws=draws)
    s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    np.testing.assert_allclose(n(port.state.odom_poses[i]), np.asarray(s.state.odom_poses[i]), atol=1e-4)
    assert int(port.state.track_iters[i]) == int(s.state.track_iters[i])
    assert int(port.state.map_state.count) == int(s.state.map_state.count)
    assert int(port.state.pool.size) == int(s.state.pool.size)
    np.testing.assert_allclose(n(port.state.losses[i]), np.asarray(s.state.losses[i]), rtol=5e-2)


def test_frame_after_prune_one_step_ahead_matches_jax(jax_run, seq, monkeypatch):
    """The prune cadence of StreamingSlam: the next frame ends in a
    prune on both sides (``(frame_id + 1) % prune_freq_frame == 0``), and
    the frame after it starts from the pruned, rehashed map. Advances the
    shared JAX system by two frames, so it runs after the other tests."""
    cfg, s = jax_run
    while s.processed < N_JAX + 1:  # run alone: the test above has not advanced it
        s.process_frame(s.processed, seq.scans[s.processed], seq.imu_windows[s.processed])
    i = s.processed
    port = TorchSlam(port_config(cfg), total_frames=16, device="cpu")
    gen = port.state.key
    names = ("prune_map_on", "prune_freq_frame", "diff_travel_dist_local", "max_prune_certainty")
    saved = [getattr(cfg, k) for k in names]
    pruned_from = []  # the port's point count going into each prune
    port_prune = tnm.prune_and_rehash

    def counting_prune(state, *a, **kw):
        pruned_from.append(int(state.count))
        return port_prune(state, *a, **kw)

    monkeypatch.setattr(tnm, "prune_and_rehash", counting_prune)
    try:
        # both packages read these at the prune, after the frame step: a window
        # of 0.01 m makes every point that this frame did not touch inactive.
        # (At a certainty limit of 3.0 one sample of frame i + 1 sits on the
        # novelty threshold and flips between the two sides, which shifts
        # the whole replay batch; 4.0 has no such sample.)
        for c in (cfg, port.cfg):
            for k, v in zip(names, (True, i + 1, 0.01, 4.0)):
                setattr(c, k, v)
        for frame in (i, i + 1):
            port.state = stream_state_from_numpy(
                [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], "cpu"
            )
            port.state.key = gen
            draws = _jax_frame_draws(cfg, s.state.key)
            port.process_frame(frame, seq.scans[frame], seq.imu_windows[frame], draws=draws)
            s.process_frame(frame, seq.scans[frame], seq.imu_windows[frame])
            np.testing.assert_allclose(
                n(port.state.odom_poses[frame]), np.asarray(s.state.odom_poses[frame]), atol=1e-4
            )
            assert int(port.state.track_iters[frame]) == int(s.state.track_iters[frame])
            tm, jm = port.state.map_state, s.state.map_state
            assert int(tm.count) == int(jm.count)
            np.testing.assert_allclose(n(port.state.losses[frame]), np.asarray(s.state.losses[frame]), rtol=5e-2)
            if frame == i:  # right after the prune
                kept = int(tm.count)
                assert 0.3 * pruned_from[0] < kept <= pruned_from[0] - 50, (pruned_from, kept)
                # the same rows survive in the same order; this frame's new
                # points carry the pose's rounding (1e-4 above), so their
                # positions agree to 1e-5 and a few may hash one voxel over
                for f in ("ts_create", "ts_update", "quats"):
                    np.testing.assert_array_equal(n(getattr(tm, f)), np.asarray(getattr(jm, f)), err_msg=f)
                np.testing.assert_allclose(n(tm.positions), np.asarray(jm.positions), atol=1e-5)
                assert (n(tm.hash_table) == np.asarray(jm.hash_table)).mean() > 0.999
                # up to 20 Adam steps here against the mapper test's 7: the
                # sign-like first steps at the noise floor leave a few
                # elements further apart, so hold the 99.9th percentile to
                # that test's 3 lr and the largest to 10 lr
                d = np.abs(n(tm.geo_feats) - np.asarray(jm.geo_feats))
                assert np.quantile(d, 0.999) < 3 * cfg.lr and d.max() < 10 * cfg.lr, d.max()
                assert not tm.geo_feats[kept:].any() and not tm.certainty[kept:].any()
        assert len(pruned_from) == 1  # the cadence: frame i prunes, frame i + 1 does not
    finally:
        for k, v in zip(names, saved):
            setattr(cfg, k, v)
