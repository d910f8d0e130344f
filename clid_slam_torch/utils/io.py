"""Point-cloud / pose / IMU file IO in pure numpy (no Open3D dependency);
the port's copy of clid_slam_tpu/utils/io.py.

Covers the loaders of the reference frontend:
- KITTI ``.bin`` float32 x,y,z,i  (utils/slam_dataset.py:993-1009)
- ``.ply`` ascii + binary_little_endian with optional intensity/color/
  timestamp properties (the converter writes x,y,z,intensity,timestamp
  PLYs — dataset/converter/rosbag2dataset_parallel.py:55-76)
- ``.pcd`` ascii + binary
- per-frame IMU CSV "dt, ax, ay, az, gx, gy, gz" with one header line
  (written by rosbag2dataset_parallel.py:44-56, read at
  utils/slam_dataset.py:380-388)
- KITTI (Nx12) and TUM (ts x y z qx qy qz qw) pose files with optional
  calibration (utils/slam_dataset.py:1097-1228)
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- point IO

_PLY_DTYPES = {
    "char": "i1",
    "uchar": "u1",
    "short": "i2",
    "ushort": "u2",
    "int": "i4",
    "uint": "u4",
    "int8": "i1",
    "uint8": "u1",
    "int16": "i2",
    "uint16": "u2",
    "int32": "i4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "float64": "f8",
    "double": "f8",
}


def read_ply(path: str):
    """Returns dict of vertex property arrays (by name)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []  # (name, dtype) in order
        in_vertex_element = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex_element = tok[1] == "vertex"
                if in_vertex_element:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex_element:
                if tok[1] == "list":
                    raise ValueError("list property on vertex not supported")
                props.append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex)
            if data.ndim == 1:
                data = data[None, :]
            out = {
                name: data[:, i].astype(np.dtype(dt))
                for i, (name, dt) in enumerate(props)
            }
        else:
            endian = "<" if "little" in fmt else ">"
            dt = np.dtype([(name, endian + d) for name, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt)
            out = {name: np.ascontiguousarray(raw[name]) for name, _ in props}
        return out


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              extra: Optional[dict] = None):
    """Binary little-endian PLY writer for point clouds."""
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    arrays = [points[:, 0], points[:, 1], points[:, 2]]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        c = np.clip(colors * 255.0, 0, 255).astype(np.uint8) if colors.dtype != np.uint8 else colors
        for i, name in enumerate(("red", "green", "blue")):
            props.append(f"property uchar {name}")
            arrays.append(c[:, i])
            fields.append((name, "u1"))
    if extra:
        for name, arr in extra.items():
            props.append(f"property float {name}")
            arrays.append(arr.astype(np.float32))
            fields.append((name, "<f4"))
    rec = np.zeros(n, dtype=np.dtype(fields))
    for (name, _), arr in zip(fields, arrays):
        rec[name] = arr
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def write_ply_mesh(path: str, vertices: np.ndarray, triangles: np.ndarray,
                   colors: Optional[np.ndarray] = None):
    n, m = len(vertices), len(triangles)
    props = ["property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        for name in ("red", "green", "blue"):
            props.append(f"property uchar {name}")
            fields.append((name, "u1"))
    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = vertices.T.astype(np.float32)
    if colors is not None:
        c = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c.T
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\n"
        f"element face {m}\nproperty list uchar int vertex_indices\nend_header\n"
    )
    face = np.zeros(m, dtype=np.dtype([("k", "u1"), ("v", "<i4", (3,))]))
    face["k"] = 3
    face["v"] = triangles.astype(np.int32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
        f.write(face.tobytes())


def read_pcd(path: str):
    """Minimal PCD reader (ascii + binary)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
                    ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
        if header["DATA"] == "ascii":
            data = np.loadtxt(f, max_rows=n)
            if data.ndim == 1:
                data = data[None]
            out, col = {}, 0
            for name, cnt in zip(fields, counts):
                out[name] = data[:, col] if cnt == 1 else data[:, col:col + cnt]
                col += cnt
            return out
        elif header["DATA"] == "binary":
            dt = np.dtype([
                (name, "<" + np_types[(t, s)], (cnt,) if cnt > 1 else ())
                for name, t, s, cnt in zip(fields, types, sizes, counts)
            ])
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt)
            return {name: np.ascontiguousarray(raw[name]) for name in fields}
        raise ValueError(f"unsupported PCD DATA {header['DATA']}")


def read_las(path: str, color_channel: int = 0) -> np.ndarray:
    """Minimal pure-numpy LAS 1.x reader (point formats 0-3): XYZ from the
    scaled int32 triplet + optional intensity — the subset the reference
    loads via laspy (utils/slam_dataset.py:1040-1055)."""
    with open(path, "rb") as f:
        header = f.read(227)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        point_data_offset = struct.unpack("<I", header[96:100])[0]
        point_format = header[104] & 0x3F
        point_size = struct.unpack("<H", header[105:107])[0]
        n = struct.unpack("<I", header[107:111])[0]
        sx, sy, sz = struct.unpack("<3d", header[131:155])
        ox, oy, oz = struct.unpack("<3d", header[155:179])
        f.seek(point_data_offset)
        raw = np.frombuffer(f.read(point_size * n), dtype=np.uint8)
    raw = raw.reshape(n, point_size)
    xyz_i = raw[:, :12].copy().view("<i4").reshape(n, 3)
    pts = xyz_i.astype(np.float64) * np.array([sx, sy, sz]) + np.array(
        [ox, oy, oz]
    )
    pts = pts.astype(np.float32)
    if color_channel == 1 and point_size >= 14:
        intensity = (
            raw[:, 12:14].copy().view("<u2").reshape(n).astype(np.float32)
        )
        pts = np.concatenate([pts, intensity[:, None]], -1)
    return pts


def load_nclt_bin(path: str) -> np.ndarray:
    """NCLT velodyne bin: int16 x,y,z(,i) quadruplets scaled by 0.005 with
    -100 offset, z flipped up (utils/slam_dataset.py:1345-1366)."""
    binary = np.fromfile(path, dtype=np.int16)
    x = binary[0::4].astype(np.float32) * 0.005 - 100.0
    y = binary[1::4].astype(np.float32) * 0.005 - 100.0
    z = binary[2::4].astype(np.float32) * 0.005 - 100.0
    return np.stack([x, -y, -z], axis=1)


# SemanticKITTI raw-id -> learning-id (0-20) lookup (the reference's
# sem_kitti_learning_map, utils/semantic_kitti_utils.py:37-73)
_SEM_KITTI_LEARNING_LUT = np.zeros(260, np.int32)
for _raw, _learn in {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 20,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 20, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}.items():
    _SEM_KITTI_LEARNING_LUT[_raw] = _learn


def read_semantic_point_label(
    bin_path: str, label_path: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SemanticKITTI frame: (points[N,4] xyz+intensity, raw labels[N],
    reduced learning labels[N] in 0-20) —
    utils/slam_dataset.py:1066-1094 semantics with an O(1) LUT instead of
    np.vectorize."""
    points = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
    labels = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
    labels = (labels & 0xFFFF).astype(np.int32)
    reduced = _SEM_KITTI_LEARNING_LUT[np.clip(labels, 0, 259)]
    return points, labels, reduced


def filter_sem_kitti_mask(
    sem_labels_raw: np.ndarray, filter_outlier=True, filter_moving=False
) -> np.ndarray:
    """Keep-mask for semantic frames (utils/slam_dataset.py:1293-1317):
    drop label<=1 outliers, optionally drop moving classes (raw id >=100)."""
    keep = sem_labels_raw > 1 if filter_outlier else sem_labels_raw >= 0
    if filter_moving:
        keep = keep & (sem_labels_raw < 100)
    return keep


def read_point_cloud(
    path: str, color_channel: int = 0, use_native: Optional[bool] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load a frame; returns (points [N,3 or 3+c] f32, point_ts or None).
    Mirrors utils/slam_dataset.py:993-1062's format dispatch.

    Parses via the native C++ runtime when it is available (same output,
    ~an order of magnitude faster on ascii formats); ``use_native=False``
    or env CLID_NATIVE=0 forces the pure-numpy path."""
    if use_native is not False and not path.lower().endswith(".las"):
        from .. import native

        if native.available():
            return native.read_point_cloud(path, color_channel)
        if use_native:
            raise RuntimeError(
                f"native IO requested but unavailable: "
                f"{native.why_unavailable()}"
            )
    ext = os.path.splitext(path)[1].lower()
    ts = None
    if ext == ".bin":
        data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        pts = data[:, :3] if color_channel == 0 else data
    elif ext == ".las":
        pts = read_las(path, color_channel)
    elif ext == ".ply":
        d = read_ply(path)
        pts = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
        if color_channel == 1 and "intensity" in d:
            pts = np.concatenate(
                [pts, d["intensity"].astype(np.float32)[:, None]], -1
            )
        elif color_channel == 3 and "red" in d:
            rgb = np.stack([d["red"], d["green"], d["blue"]], -1).astype(np.float32)
            pts = np.concatenate([pts, rgb], -1)
        for k in ("timestamp", "time", "t"):
            if k in d:
                ts = d[k].astype(np.float64)
                break
    elif ext == ".pcd":
        d = read_pcd(path)
        if "x" in d:
            pts = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
        else:
            raise ValueError(f"{path}: no x/y/z")
        if color_channel == 1 and "intensity" in d:
            pts = np.concatenate(
                [pts, d["intensity"].astype(np.float32)[:, None]], -1
            )
        for k in ("timestamp", "time", "t"):
            if k in d:
                ts = np.asarray(d[k], np.float64)
                break
    else:
        raise ValueError(f"unsupported point cloud format: {ext}")
    # drop non-finite points (matches the reference's implicit filtering)
    finite = np.isfinite(pts[:, :3]).all(-1)
    if not finite.all():
        pts = pts[finite]
        if ts is not None:
            ts = ts[finite]
    return pts, ts


# ------------------------------------------------------------------ IMU IO


def read_imu_csv(path: str) -> np.ndarray:
    """Per-frame IMU window: rows of (dt, ax, ay, az, gx, gy, gz); one
    header line (utils/slam_dataset.py:380-388)."""
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2, dtype=np.float64)


# ----------------------------------------------------------------- pose IO


def read_kitti_poses(path: str, calib_T: Optional[np.ndarray] = None) -> np.ndarray:
    """KITTI format: N rows of 12 floats (3x4 row-major). Optional
    calibration: T_cal^-1 @ T @ T_cal (utils/slam_dataset.py:1097-1140)."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    n = data.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :4] = data[:, :12].reshape(n, 3, 4)
    if calib_T is not None:
        inv = np.linalg.inv(calib_T)
        poses = np.einsum("ij,njk,kl->nil", inv, poses, calib_T)
    return poses


def write_kitti_poses(path: str, poses: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9f}" for v in T[:3, :4].reshape(-1)) + "\n")


def read_tum_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: ts x y z qx qy qz qw (comment lines allowed).
    Returns (poses [N,4,4], timestamps [N])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(list(map(float, line.split())))
    arr = np.asarray(rows, np.float64)
    ts = arr[:, 0]
    t = arr[:, 1:4]
    qx, qy, qz, qw = arr[:, 4], arr[:, 5], arr[:, 6], arr[:, 7]
    n = len(arr)
    poses = np.tile(np.eye(4), (n, 1, 1))
    # quaternion (x,y,z,w) -> rotation matrix
    poses[:, 0, 0] = 1 - 2 * (qy**2 + qz**2)
    poses[:, 0, 1] = 2 * (qx * qy - qw * qz)
    poses[:, 0, 2] = 2 * (qx * qz + qw * qy)
    poses[:, 1, 0] = 2 * (qx * qy + qw * qz)
    poses[:, 1, 1] = 1 - 2 * (qx**2 + qz**2)
    poses[:, 1, 2] = 2 * (qy * qz - qw * qx)
    poses[:, 2, 0] = 2 * (qx * qz - qw * qy)
    poses[:, 2, 1] = 2 * (qy * qz + qw * qx)
    poses[:, 2, 2] = 1 - 2 * (qx**2 + qy**2)
    poses[:, :3, 3] = t
    return poses, ts


def write_tum_poses(path: str, poses: np.ndarray, timestamps=None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, T in enumerate(poses):
            ts = timestamps[i] if timestamps is not None else float(i)
            R = T[:3, :3]
            # rotation matrix -> quaternion (w,x,y,z), Shepperd
            tr = np.trace(R)
            if tr > 0:
                s = np.sqrt(tr + 1.0) * 2
                qw = 0.25 * s
                qx = (R[2, 1] - R[1, 2]) / s
                qy = (R[0, 2] - R[2, 0]) / s
                qz = (R[1, 0] - R[0, 1]) / s
            elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
                s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
                qw = (R[2, 1] - R[1, 2]) / s
                qx = 0.25 * s
                qy = (R[0, 1] + R[1, 0]) / s
                qz = (R[0, 2] + R[2, 0]) / s
            elif R[1, 1] > R[2, 2]:
                s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
                qw = (R[0, 2] - R[2, 0]) / s
                qx = (R[0, 1] + R[1, 0]) / s
                qy = 0.25 * s
                qz = (R[1, 2] + R[2, 1]) / s
            else:
                s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
                qw = (R[1, 0] - R[0, 1]) / s
                qx = (R[0, 2] + R[2, 0]) / s
                qy = (R[1, 2] + R[2, 1]) / s
                qz = 0.25 * s
            f.write(
                f"{ts:.6f} {T[0,3]:.6f} {T[1,3]:.6f} {T[2,3]:.6f} "
                f"{qx:.8f} {qy:.8f} {qz:.8f} {qw:.8f}\n"
            )


def read_calib_file(path: str) -> dict:
    """KITTI calib file: 'key: 12 floats' rows -> {key: T[4,4]}
    (utils/slam_dataset.py semantics)."""
    calib = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                arr = np.array([float(v) for v in vals.split()])
            except ValueError:
                continue
            if arr.size == 12:
                T = np.eye(4)
                T[:3, :4] = arr.reshape(3, 4)
                calib[key.strip()] = T
    return calib
