"""A frame's predict and bookkeep with every per-frame value a device
tensor (``pipeline/streaming.py``: ``eager_frame``, ``predict_stage``,
``bookkeep_stage``; on the card ``GraphedTrackStages`` replays them)
against the arithmetic they replace, bit for bit on the CPU: the crop
range, the IMU count and the frame's row as Python numbers, ``torch.linalg.
inv`` and deskew's identity quaternion made by ``torch.tensor``
(``_parent_*`` below keep those forms). The frames run on the switches of
the benchmark's ``quad`` deployment and differ in crop range, IMU rows and
id (``torch_track_frames.py``); a short run of them matches a run recorded
from the code before the device forms (``torch_track_frames_parent.npz``:
the trajectory, the filter's counts and the rest of ``results``)."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (few threads: the recorded run's numbers depend on them)
import torch_track_frames as tf
from clid_slam_torch.odometry import iekf
from clid_slam_torch.ops.voxel import voxel_down_sample_mask
from clid_slam_torch.pipeline import streaming as sm
from clid_slam_torch.pipeline.streaming import clone_state
from clid_slam_torch.utils import lie
from clid_slam_torch.utils.transforms import crop_mask, deskew


@pytest.fixture(scope="module")
def recorded():
    """The frames run on the CPU at the recording's two threads, and each
    frame's state and step arguments as the step got them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s, fr = tf.system("cpu")
        seen = []

        def recording(step):
            def wrapped(state, *args):
                seen.append((clone_state(state), [a.clone() if isinstance(a, torch.Tensor)
                                                  else a for a in args]))
                return step(state, *args)
            return wrapped

        s.steps = {k: recording(v) for k, v in s.steps.items()}
        tf.run(s, fr, range(tf.N_FRAMES))
        return s, seen
    finally:
        torch.set_num_threads(threads)


def _parent_deskew(points, ts, rel_pose, ts_mid_pose=0.5):
    ts = ts.reshape(-1)
    t_min, t_max = torch.min(ts), torch.max(ts)
    ts = (ts - t_min) / torch.clamp(t_max - t_min, min=1e-12)
    ts = ts - ts_mid_pose
    n = points.shape[0]
    q_rel = lie.rotmat_to_quat(rel_pose[:3, :3])
    q_id = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=points.dtype, device=points.device)
    q_t = lie.quat_slerp(q_id.expand(n, 4), q_rel.expand(n, 4), ts[:, None])
    R_t = lie.quat_to_rotmat(q_t)
    tran = ts[:, None] * rel_pose[:3, 3]
    return torch.einsum("nij,nj->ni", R_t, points) + tran


def _parent_stages(cfg, state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
                   crop_max_range, track, tracker):
    """The frame step's predict and bookkeep in the forms the device ones
    replace; ``tracker(rot, pos, rest, P)`` stands in for the tracker."""
    crop = torch.tensor(crop_max_range, dtype=torch.float32, device=points.device)
    pmask = pmask & crop_mask(points, cfg.min_z, cfg.max_z, cfg.min_range, crop)
    scale = crop / cfg.max_range
    train_mask = voxel_down_sample_mask(points, pmask, scale * cfg.vox_down_m,
                                        cfg.map_hash_size)
    rot, pos, rest, P = state.rot, state.pos, state.rest, state.P
    odom_poses = state.odom_poses.clone()
    travel_dist = state.travel_dist.clone()
    lose_track, consec_lose = state.lose_track, state.consec_lose
    stop_count, stop_status = state.stop_count, state.stop_status
    failed = state.failed
    track_iters = state.track_iters
    out = dict(train_mask=train_mask)
    if track:
        rot, pos, rest, P = sm.predict_imu(cfg, rot, pos, rest, P, imu_rows, imu_count)
        src_idx, smask = sm.source_indices(cfg, points, train_mask, scale)
        src_pts = points[src_idx]
        if cfg.deskew:
            rel = torch.linalg.inv(state.last_pose) @ sm._pose(rot, pos)
            src_pts = _parent_deskew(src_pts, point_ts[src_idx], rel)
        out.update(pred=(rot, pos, rest, P), src_pts=src_pts, smask=smask)
        rot, pos, rest, P, ok, n_iter = tracker(rot, pos, rest, P)
        rot = sm._orthonormalize(rot)
        track_iters = track_iters.clone()
        track_iters[frame_id] = n_iter
        pose = sm._pose(rot, pos)
        last_tran = torch.linalg.inv(state.last_pose) @ pose
        tran_norm = torch.linalg.norm(last_tran[:3, 3])
        I3 = torch.eye(3, device=pose.device)
        near_I = torch.all(torch.abs(last_tran[:3, :3] - I3) < 1e-3) & torch.all(
            torch.abs(last_tran[:3, 3]) < cfg.voxel_size_m * 0.1)
        stop_count = torch.where(near_I, state.stop_count + 1,
                                 torch.zeros_like(state.stop_count))
        stop_status = stop_count > cfg.stop_frame_thre
        too_big = tran_norm > cfg.surface_sample_range_m * 40.0
        lose_track = ~ok | too_big
        consec_lose = torch.where(lose_track, state.consec_lose + 1,
                                  torch.zeros_like(state.consec_lose))
        failed = state.failed | too_big | (consec_lose > 10)
        travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)] + tran_norm
        odom_poses[frame_id] = pose
        if cfg.deskew:
            full = _parent_deskew(points, point_ts, last_tran)
            points = torch.where(train_mask[:, None], full, points)
    else:
        pose = sm._pose(rot, pos)
        odom_poses[frame_id] = pose
        travel_dist[frame_id] = travel_dist[max(frame_id - 1, 0)]
    out.update(map_points=points, valid_mapping=~lose_track & ~stop_status, new=dict(
        rot=rot, pos=pos, rest=rest, P=P, last_pose=pose, odom_poses=odom_poses,
        travel_dist=travel_dist, lose_track=lose_track, consec_lose=consec_lose,
        stop_count=stop_count, stop_status=stop_status, failed=failed,
        track_iters=track_iters))
    return out


def _tracker(frame_id):
    """A tracker's outputs from the predicted state: moved a little, with
    ``ok`` false on every third frame so that the lose-track flags move."""
    def tracker(rot, pos, rest, P):
        turn = lie.so3_exp(torch.tensor([0.0, 0.0, 0.01 * frame_id]))
        return (rot @ turn, pos + torch.tensor([0.03, -0.02, 0.01]), rest + 1e-3, P * 1.5,
                torch.tensor(frame_id % 3 != 0), torch.tensor(frame_id + 2, dtype=torch.int32))
    return tracker


@pytest.mark.parametrize("i", range(tf.N_FRAMES))
def test_predict_and_bookkeep_equal_the_parent_forms(recorded, i):
    """Frame ``i`` of the run, from the state it started from: every output
    of the stages (the masks, the IMU propagation, the source points, the
    pose, the flags, the written rows, the points the map trains on) equals
    the parent forms' to the bit; the state given stays as it was."""
    s, seen = recorded
    state, args = seen[i]
    frame_id, points, pmask, point_ts, imu_rows, imu_count, crop = args[:7]
    assert (frame_id, imu_count) == (i, tf.IMU_ROWS[i])
    track = frame_id > 0
    given = clone_state(state)
    want = _parent_stages(s.cfg, state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
                          crop, track, _tracker(frame_id))
    f = sm.eager_frame(state, frame_id, points, pmask, point_ts, imu_rows, imu_count, crop,
                       track)
    sm.predict_stage(s.cfg, f, track)
    f.trk = _tracker(frame_id)(*f.pred) if track else None
    sm.bookkeep_stage(s.cfg, f, track)
    names = ["train_mask", "map_points", "valid_mapping"]
    if track:
        names += ["src_pts", "smask"]
        for k, (x, y) in enumerate(zip(f.pred, want["pred"])):
            assert torch.equal(x, y), ("pred", k)
    for name in names:
        assert torch.equal(getattr(f, name), want[name]), name
    assert list(f.new) == list(sm.TRACK_LEAVES)
    for name in sm.TRACK_LEAVES:
        assert torch.equal(f.new[name], want["new"][name]), name
    for x, y in zip(state.leaves(), given.leaves()):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


@pytest.mark.parametrize("count", [0, 4, 16, sm.IMU_MAX_ROWS])
def test_predict_imu_takes_its_live_rows_from_a_device_scalar(count):
    """``device_predict_imu`` with the live rows an i64 device scalar, as
    the graphs fill it, equals it with a Python int: the rows past the
    count, filled with other numbers, stay identity steps either way."""
    rng = np.random.default_rng(count)
    rows = torch.from_numpy(rng.normal(0, 1, (sm.IMU_MAX_ROWS, 7)).astype(np.float32))
    rows[:, 0] = torch.from_numpy(rng.uniform(1e-3, 2e-3, sm.IMU_MAX_ROWS).astype(np.float32))
    rot = lie.so3_exp(torch.tensor([0.1, -0.2, 0.3]))
    pos, vel = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.5, 0.0, -0.1])
    bg, ba = torch.full((3,), 1e-3), torch.full((3,), -2e-3)
    grav = torch.tensor([0.0, 0.0, -9.81])
    P = torch.eye(18) * 1e-2
    Q = torch.eye(12) * 1e-4
    args = (rot, pos, vel, bg, ba, grav, P, Q, rows)
    want = iekf.device_predict_imu(*args, count)
    got = iekf.device_predict_imu(*args, torch.tensor(count, dtype=torch.int64))
    for k, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), k


def test_inv_ex_and_the_identity_quaternion_constant_give_the_parent_bits():
    """``torch.linalg.inv_ex`` gives ``torch.linalg.inv``'s bits, and deskew
    with its identity quaternion copied to the device once gives the bits of
    one made by ``torch.tensor`` at each call, on poses and scans drawn from
    a seed."""
    rng = np.random.default_rng(7)
    for _ in range(16):
        T = torch.eye(4)
        T[:3, :3] = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.3, 3).astype(np.float32)))
        T[:3, 3] = torch.from_numpy(rng.normal(0, 5.0, 3).astype(np.float32))
        assert torch.equal(sm._inv(T), torch.linalg.inv(T))
        pts = torch.from_numpy(rng.normal(0, 10.0, (500, 3)).astype(np.float32))
        ts = torch.from_numpy(rng.uniform(0, 1, 500).astype(np.float32))
        assert torch.equal(deskew(pts, ts, T), _parent_deskew(pts, ts, T))


def test_an_adaptive_range_run_matches_the_parents_recording(recorded):
    """The run's trajectory, travel distances, iteration counts, losses,
    filter counts and map size equal the recording of the same run made
    by the code before the device forms, to the bit; the run's crop range
    moved every frame and cut points, its IMU rows took every count, and
    the filter dropped points."""
    s, seen = recorded
    want = np.load(tf.RECORDED)
    got = tf.results(s)
    assert sorted(got) == sorted(want.files)
    for name in want.files:
        assert np.array_equal(got[name], want[name]), name
    crops = [args[6] for _, args in seen]
    assert len(set(crops)) == tf.N_FRAMES and max(crops) < s.cfg.max_range
    assert sorted({args[5] for _, args in seen}) == sorted(set(tf.IMU_ROWS))
    assert np.any(got["filtered"][:, 1] > got["filtered"][:, 2])
