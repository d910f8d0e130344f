"""Dataset name/sequence -> path wiring (the port's copy of
clid_slam_tpu/pipeline/dataset_indexing.py).

Equivalent of utils/dataset_indexing.py:9-117: given a dataset family name
and sequence id, rewrite the config's pc/pose/calib/label paths to the
conventional on-disk layout for the common benchmarks. The ``base`` is
derived from the configured pc_path exactly like the reference (rsplit of
the shipped path pattern).

One addition: the ``clid`` family selects the CLID converter layout
(dataset/converter/rosbag2dataset_parallel.py output: per-sequence
``lidar/*.ply`` + ``imu/*.csv`` + ``pose_ts.txt``), which the reference
configures by hand in its YAMLs (config/run_ncd128.yaml:4-6).
"""

from __future__ import annotations

import os

from ..config import Config


def set_dataset_path(cfg: Config, dataset_name: str = "", seq: str = ""):
    if not dataset_name:
        return cfg
    name = dataset_name.lower()
    seq = str(seq)
    root = cfg.pc_path or "."

    if cfg.use_kiss_dataloader:
        # kiss-icp dataloader mode (reference dataset_indexing.py:12-18):
        # the dataset name selects the kiss loader, the sequence is
        # passed through verbatim
        cfg.name += f"_{dataset_name}_{seq.replace('/', '')}"
        cfg.data_loader_name = dataset_name
        cfg.data_loader_seq = seq
        return cfg

    if name == "kitti":
        base = root.rsplit("/", 3)[0]
        seq = seq.zfill(2)
        cfg.name += f"_kitti_{seq}"
        cfg.pc_path = os.path.join(base, "sequences", seq, "velodyne")
        cfg.pose_path = os.path.join(base, "poses", seq + ".txt")
        cfg.calib_path = os.path.join(base, "sequences", seq, "calib.txt")
        cfg.label_path = os.path.join(base, "sequences", seq, "labels")
        cfg.kitti_correction_on = True
        cfg.correction_deg = 0.195
    elif name == "kitti_carla":
        base = root.rsplit("/", 3)[0]
        cfg.name += f"_kitti_carla_{seq}"
        cfg.pc_path = os.path.join(base, seq, "generated", "frames")
        cfg.pose_path = os.path.join(base, seq, "generated", "poses.txt")
        cfg.calib_path = os.path.join(base, seq, "generated", "calib.txt")
    elif name == "mulran":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_mulran_{seq}"
        cfg.pc_path = os.path.join(base, seq, "Ouster")
        cfg.pose_path = os.path.join(base, seq, "poses.txt")
    elif name == "ncd":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_ncd_{seq}"
        cfg.pc_path = os.path.join(base, seq, "bin")
        cfg.pose_path = os.path.join(base, seq, "poses.txt")
        cfg.calib_path = os.path.join(base, seq, "calib.txt")
    elif name == "ncd128":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_ncd128_{seq}"
        cfg.pc_path = os.path.join(base, seq, "ply")
        cfg.pose_path = os.path.join(base, seq, "poses.txt")
    elif name == "ipbcar":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_ipbcar_{seq}"
        cfg.pc_path = os.path.join(base, seq, "ouster")
        cfg.pose_path = os.path.join(base, seq, "poses.txt")
        cfg.calib_path = os.path.join(base, seq, "calib.txt")
    elif name == "hilti":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_hilti_{seq}"
        cfg.pc_path = os.path.join(base, seq, "ply")
    elif name == "m2dgr":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_m2dgr_{seq}"
        cfg.pc_path = os.path.join(base, seq, "points")
        cfg.pose_path = os.path.join(base, seq, "poses.txt")
    elif name == "replica":
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_replica_{seq}"
        cfg.pc_path = os.path.join(base, seq, "rgbd_down_ply")
        cfg.pose_path = os.path.join(base, seq, "poses.txt")
    elif name in ("clid", "subt", "subt_mrs"):
        # CLID converter layout: lidar PLYs + per-frame IMU CSVs
        base = root.rsplit("/", 2)[0]
        cfg.name += f"_{name}_{seq}"
        cfg.pc_path = os.path.join(base, seq, "lidar")
        cfg.imu_path = os.path.join(base, seq, "imu")
        cfg.pose_ts_path = os.path.join(base, seq, "pose_ts.txt")
        gt = os.path.join(base, seq, "gt_poses.txt")
        if os.path.isfile(gt):
            cfg.pose_path = gt
    else:
        raise ValueError(f"unknown dataset family: {dataset_name}")
    return cfg
