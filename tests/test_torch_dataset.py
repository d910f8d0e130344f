"""The port's SLAMDataset (clid_slam_torch/pipeline/dataset.py) against the
JAX package's, on a sequence that the port's ``write_sequence_dataset``
wrote (the converter's layout, deskewing on): the frames read equal; each
frame's host filter propagation (the same IMU rows), crop and voxel masks
and source mask bit-equal, points within 1e-6, deskewed points within
1e-5; ``update_odom_pose``'s bookkeeping and both of its failure exits;
``write_results``' pose files byte-equal and ``metrics.json`` with the same
keys; the merged cloud within 1e-5; the kiss-icp mode's ImportError. The
JAX reader looks for ``imu/<i>.csv`` while the writer of both packages
writes ``imu/<i:06d>.csv``; the port reads both names (ROADMAP C5)."""

import json
import os

import numpy as np
import pytest

from clid_slam_torch.config import Config as TConfig
from clid_slam_torch.odometry import iekf as tie
from clid_slam_torch.pipeline.dataset import SLAMDataset as TData
from clid_slam_torch.pipeline.synthetic import write_sequence_dataset
from clid_slam_torch.utils import io as tio
from clid_slam_tpu.config import Config as JConfig
from clid_slam_tpu.odometry import iekf as jie
from clid_slam_tpu.pipeline.dataset import SLAMDataset as JData
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from torch_parity import n

N_FRAMES = 4


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    seq = generate_sequence(n_frames=N_FRAMES, n_azimuth=256, n_elev=24, noise_std=0.01,
                            seed=3, ramp_frames=6)
    path = write_sequence_dataset(seq, root, {"eval.save_mesh": False, "setting.deskew": True})
    return seq, path


def _pair(path, **overrides):
    jc, tc = JConfig.load(path), TConfig.load(path)
    for c in (jc, tc):
        for k, v in overrides.items():
            setattr(c, k, v)
    kw = dict(init_grav=[0.0, 0.0, -9.81])
    jd = JData(jc, tracker=jie.IEKF(jie.IEKFConfig(), **kw), min_frames=8)
    td = TData(tc, tracker=tie.IEKF(tie.IEKFConfig(), **kw), min_frames=8, device="cpu")
    return jd, td


def test_frames_and_preprocessing_match_jax(written):
    seq, path = written
    jd, td = _pair(path)
    assert td.pc_filenames == jd.pc_filenames and td.total_pc_count == N_FRAMES
    np.testing.assert_array_equal(td.gt_poses, jd.gt_poses)
    for i in range(N_FRAMES):
        jd.read_frame(i)
        td.read_frame(i)
        np.testing.assert_array_equal(td._raw_points, jd._raw_points)
        np.testing.assert_array_equal(td._raw_ts, jd._raw_ts)
        imu = td.read_imu_window(i)
        assert jd.read_imu_window(i) is None  # the JAX reader's unpadded name
        np.testing.assert_array_equal(imu, tio.read_imu_csv(
            os.path.join(td.cfg.imu_path, f"{i:06d}.csv")))
        assert jd.preprocess_frame(imu) and td.preprocess_frame(imu)
        np.testing.assert_allclose(td.tracker.x.pos, jd.tracker.x.pos, atol=1e-12, rtol=0)
        np.testing.assert_allclose(td.tracker.P, jd.tracker.P, atol=1e-12, rtol=0)
        np.testing.assert_allclose(n(td.cur_points), np.asarray(jd.cur_points), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(n(td.cur_mask), np.asarray(jd.cur_mask))
        assert 0 < int(n(td.cur_mask).sum()) < len(seq.scans[i])
        if i > 0:
            np.testing.assert_array_equal(n(td.cur_source_mask), np.asarray(jd.cur_source_mask))
            np.testing.assert_allclose(n(td.cur_source_points), np.asarray(jd.cur_source_points),
                                       atol=1e-5, rtol=0)
            # the last pose's deskew moved the source points
            assert np.abs(n(td.cur_source_points) - n(td.cur_points)).max() > 1e-4
        pose = seq.poses[i].copy()
        if i == 0:
            jd.cur_pose_ref = td.cur_pose_ref = pose
            jd.odom_poses[0] = td.odom_poses[0] = pose
        else:
            jd.update_odom_pose(pose)
            td.update_odom_pose(pose)
            np.testing.assert_allclose(n(td.cur_points), np.asarray(jd.cur_points), atol=1e-5,
                                       rtol=0)  # deskewed with the final relative pose
        for k in ("stop_count", "stop_status", "lose_track", "consecutive_lose_track_frame"):
            assert getattr(td, k) == getattr(jd, k), k
        np.testing.assert_array_equal(td.last_odom_tran, jd.last_odom_tran)
        jd.processed_frame += 1
        td.processed_frame += 1
    np.testing.assert_array_equal(td.odom_poses, jd.odom_poses)
    np.testing.assert_array_equal(td.travel_dist, jd.travel_dist)
    assert td.travel_dist[N_FRAMES - 1] > 0


@pytest.mark.parametrize("exit_kind", ["too_large_translation", "lost_too_long"])
def test_update_odom_pose_failure_exits_match_jax(written, exit_kind):
    _, path = written
    for d in _pair(path):
        d.processed_frame = 1
        d.last_pose_ref = np.eye(4)
        if exit_kind == "too_large_translation":
            far = np.eye(4)
            far[0, 3] = d.cfg.surface_sample_range_m * 40.0 + 0.5
            with pytest.raises(RuntimeError, match="Too large translation"):
                d.update_odom_pose(far)
            assert d.lose_track
        else:
            d.lose_track = True
            d.consecutive_lose_track_frame = 10
            with pytest.raises(RuntimeError, match="Lose track for a long time"):
                d.update_odom_pose(np.eye(4))
            assert d.consecutive_lose_track_frame == 11


def test_write_results_match_jax(written, tmp_path):
    seq, path = written
    out = {}
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 0.02, (N_FRAMES, 3))
    times = rng.uniform(0.01, 0.05, (N_FRAMES, 5)).tolist()
    for d in _pair(path):
        tag = type(d).__module__.split(".")[0]
        d.processed_frame = N_FRAMES
        d.odom_poses[:N_FRAMES] = seq.poses
        d.odom_poses[:N_FRAMES, :3, 3] += noise
        d.time_table = [list(r) for r in times]
        run = str(tmp_path / tag)
        res = d.write_results(run)
        with open(os.path.join(run, "metrics.json")) as f:
            assert json.load(f).keys() == res.keys()
        merged = d.write_merged_point_cloud(run)
        out[tag] = (run, res, tio.read_ply(merged))
    (tr, tres, tm), (jr, jres, jm) = out["clid_slam_torch"], out["clid_slam_tpu"]
    for f in ("odom_poses_kitti.txt", "odom_poses_tum.txt", "mean_time.txt", "time_table.csv"):
        with open(os.path.join(tr, f), "rb") as a, open(os.path.join(jr, f), "rb") as b:
            assert a.read() == b.read(), f
    assert tres.keys() == jres.keys()
    np.testing.assert_allclose([tres[k] for k in tres], [jres[k] for k in tres], rtol=1e-9)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=0)


def test_kiss_icp_mode_raises_the_same_import_error(written):
    _, path = written
    msgs = []
    for cfg_cls, data_cls, kw in ((JConfig, JData, {}), (TConfig, TData, {"device": "cpu"})):
        cfg = cfg_cls.load(path)
        cfg.use_kiss_dataloader = True
        with pytest.raises(ImportError) as e:
            data_cls(cfg, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "kiss-icp" in msgs[1]
