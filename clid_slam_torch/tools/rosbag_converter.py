"""ROS bag -> dataset converter (offline host tooling; the port's copy of
clid_slam_tpu/tools/rosbag_converter.py).

Equivalent of dataset/converter/rosbag2dataset_parallel.py:86-195: sync
LiDAR scans with the IMU stream and write the per-frame layout the engine
consumes — ``lidar/{i}.ply`` (x, y, z, intensity, timestamp) and
``imu/{i}.csv`` windows of (dt, acc, gyro) between consecutive scans, plus
``pose_ts.txt``.

ROS libraries are not part of the training environment; this module degrades to
a clear error unless ``rosbag`` (or ``rosbags``) is importable, and the
PointCloud2 struct parsing (utils/point_cloud2.py:60-91 equivalent) is
pure-python so it works with either backend.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_DATATYPES = {
    1: ("b", 1),
    2: ("B", 1),
    3: ("h", 2),
    4: ("H", 2),
    5: ("i", 4),
    6: ("I", 4),
    7: ("f", 4),
    8: ("d", 8),
}


def parse_pointcloud2(fields, point_step, is_bigendian, data, want=None):
    """Decode a PointCloud2 payload into a dict of numpy arrays."""
    if want is None:
        want = ["x", "y", "z", "intensity", "t", "time", "timestamp"]
    fmt_map = {}
    np_fields = []
    for f in fields:
        name = f.name if hasattr(f, "name") else f["name"]
        if name not in want:
            continue
        datatype = f.datatype if hasattr(f, "datatype") else f["datatype"]
        offset = f.offset if hasattr(f, "offset") else f["offset"]
        ch, size = _DATATYPES[datatype]
        np_fields.append((name, offset, ("<" if not is_bigendian else ">") + {
            "b": "i1", "B": "u1", "h": "i2", "H": "u2",
            "i": "i4", "I": "u4", "f": "f4", "d": "f8",
        }[ch]))
    n = len(data) // point_step
    raw = np.frombuffer(data, dtype=np.uint8).reshape(n, point_step)
    out = {}
    for name, offset, dt in np_fields:
        width = np.dtype(dt).itemsize
        out[name] = raw[:, offset : offset + width].copy().view(dt).reshape(n)
    return out


def convert(bag_path: str, out_dir: str, lidar_topic: str, imu_topic: str):
    try:
        from rosbags.highlevel import AnyReader  # rosbags (pure python)
        from pathlib import Path
    except ImportError:
        sys.exit(
            "rosbags not installed in this environment — run the converter "
            "on a machine with `pip install rosbags` (offline tooling; not "
            "needed on the training host)."
        )

    os.makedirs(os.path.join(out_dir, "lidar"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "imu"), exist_ok=True)

    from ..utils.io import write_ply

    imu_rows = []  # (t, ax..az, gx..gz)
    scan_times = []
    scan_idx = 0
    last_scan_t = None
    pending_imu = []

    with AnyReader([Path(bag_path)]) as reader:
        conns = [
            c for c in reader.connections if c.topic in (lidar_topic, imu_topic)
        ]
        for conn, ts, raw in reader.messages(connections=conns):
            msg = reader.deserialize(raw, conn.msgtype)
            t = ts * 1e-9
            if conn.topic == imu_topic:
                pending_imu.append(
                    (
                        t,
                        msg.linear_acceleration.x,
                        msg.linear_acceleration.y,
                        msg.linear_acceleration.z,
                        msg.angular_velocity.x,
                        msg.angular_velocity.y,
                        msg.angular_velocity.z,
                    )
                )
            else:
                d = parse_pointcloud2(
                    msg.fields, msg.point_step, msg.is_bigendian, msg.data
                )
                pts = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
                finite = np.isfinite(pts).all(-1)
                pts = pts[finite]
                inten = d.get("intensity", np.zeros(len(finite)))[finite]
                tskey = next(
                    (k for k in ("t", "time", "timestamp") if k in d), None
                )
                pt_ts = (
                    d[tskey][finite].astype(np.float64)
                    if tskey
                    else np.zeros(len(pts))
                )
                write_ply(
                    os.path.join(out_dir, "lidar", f"{scan_idx}.ply"),
                    pts,
                    extra={
                        "intensity": inten.astype(np.float32),
                        "timestamp": pt_ts.astype(np.float32),
                    },
                )
                if last_scan_t is not None and pending_imu:
                    rows = np.asarray(pending_imu)
                    dts = np.diff(
                        np.concatenate([[last_scan_t], rows[:, 0]])
                    )
                    win = np.column_stack([dts, rows[:, 1:7]])
                    np.savetxt(
                        os.path.join(out_dir, "imu", f"{scan_idx}.csv"),
                        win,
                        delimiter=",",
                        header="dt,ax,ay,az,gx,gy,gz",
                        comments="",
                    )
                pending_imu = []
                last_scan_t = t
                scan_times.append(t)
                scan_idx += 1

    np.savetxt(os.path.join(out_dir, "pose_ts.txt"), np.asarray(scan_times))
    print(f"wrote {scan_idx} frames to {out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--lidar-topic", default="/os_cloud_node/points")
    ap.add_argument("--imu-topic", default="/os_cloud_node/imu")
    a = ap.parse_args(argv)
    convert(a.bag, a.out, a.lidar_topic, a.imu_topic)


if __name__ == "__main__":
    main()
