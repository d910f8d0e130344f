"""Format-conversion odds and ends from the reference's tools.ipynb (the
port's copy of clid_slam_tpu/tools/convert.py; host numpy only).

Subcommands (capability parity with the reference's tools.ipynb cells
1-4 and 11-12; the mesh-eval cells are covered by
utils/metrics.py:mesh_f_score):

  pose-csv-to-tum   in.csv out.txt      nsec,x,y,z,qx,qy,qz,qw CSV ->
                                        TUM ``sec x y z qx qy qz qw``
  pose-kitti-to-tum in.txt out.txt      KITTI 3x4 rows -> TUM
  pose-tum-to-kitti in.txt out.txt      TUM -> KITTI 3x4 rows
  mesh-transform    in.ply out.ply -m "r00 r01 ... t2"  (12 or 16 vals)
                                        apply a rigid transform to a mesh
  bag-merge         in_folder out.bag   concatenate rosbags (needs the
                                        optional ``rosbags`` package)

Run: python -m clid_slam_torch.tools.convert <subcommand> ...
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from ..utils import io


def pose_csv_to_tum(src: str, dst: str):
    """tools.ipynb cell 4: SubT-MRS ground_truth_path.csv -> TUM."""
    n = 0
    with open(src) as f, open(dst, "w") as out:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            nsec, x, y, z, qx, qy, qz, qw = map(float, row[:8])
            out.write(
                f"{nsec * 1e-9} {x} {y} {z} {qx} {qy} {qz} {qw}\n"
            )
            n += 1
    return n


def _read_mesh_ply(path: str):
    """Minimal binary/ascii PLY triangle-mesh reader (vertices +
    triangle indices; colors preserved when present)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vert = n_face = 0
        vert_props = []
        face_types = ("uchar", "int")
        in_vert = in_face = False
        fmt = "binary_little_endian"
        for line in header:
            t = line.split()
            if not t:
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                in_vert = t[1] == "vertex"
                in_face = t[1] == "face"
                if in_vert:
                    n_vert = int(t[2])
                if in_face:
                    n_face = int(t[2])
            elif t[0] == "property" and in_vert and t[1] != "list":
                vert_props.append((t[2], t[1]))
            elif t[0] == "property" and in_face and t[1] == "list":
                face_types = (t[2], t[3])  # list <count type> <index type>
        np_type = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        }
        end = ">" if fmt == "binary_big_endian" else "<"
        if fmt == "ascii":
            verts = np.loadtxt(
                f, max_rows=n_vert, dtype=np.float64
            ).reshape(n_vert, -1)
            vdata = {nm: verts[:, i] for i, (nm, _) in enumerate(vert_props)}
            # one face reads as a 1-D row: keep the [n_face, 1 + 3] shape
            tris = np.loadtxt(
                f, max_rows=n_face, dtype=np.int64
            ).reshape(n_face, -1)[:, 1:4]
        else:
            dt = np.dtype(
                [(nm, end + np_type[ty]) for nm, ty in vert_props]
            )
            raw = np.frombuffer(f.read(n_vert * dt.itemsize), dtype=dt)
            vdata = {nm: np.asarray(raw[nm]) for nm, _ in vert_props}
            cnt, idx = (end + np_type[ty] for ty in face_types)
            fdt = np.dtype([("n", cnt), ("idx", idx, (3,))])
            tris = np.frombuffer(
                f.read(n_face * fdt.itemsize), dtype=fdt
            )["idx"]
        v = np.stack([vdata["x"], vdata["y"], vdata["z"]], 1).astype(
            np.float64
        )
        colors = None
        if "red" in vdata:
            colors = (
                np.stack(
                    [vdata["red"], vdata["green"], vdata["blue"]], 1
                ).astype(np.float64)
                / 255.0
            )
        return v, np.asarray(tris, np.int64), colors


def mesh_transform(src: str, dst: str, T: np.ndarray):
    """tools.ipynb cell 12 without the open3d dependency."""
    v, t, colors = _read_mesh_ply(src)
    v = v @ T[:3, :3].T + T[:3, 3]
    io.write_ply_mesh(dst, v.astype(np.float32), t, colors=colors)
    return len(v), len(t)


def bag_merge(in_folder: str, out_bag: str):
    """tools.ipynb cell 2 on the pure-python ``rosbags`` stack."""
    try:
        from rosbags.rosbag1 import Reader, Writer
    except ImportError as e:
        raise ImportError(
            "bag-merge needs the optional 'rosbags' package "
            "(pip install rosbags)"
        ) from e
    bags = sorted(
        os.path.join(in_folder, f)
        for f in os.listdir(in_folder)
        if f.endswith(".bag")
    )
    conns = {}
    with Writer(out_bag) as w:
        for path in bags:
            with Reader(path) as r:
                for conn, ts, raw in r.messages():
                    key = (conn.topic, conn.msgtype)
                    if key not in conns:
                        conns[key] = w.add_connection(
                            conn.topic, conn.msgtype,
                            msgdef=conn.msgdef, md5sum=conn.md5sum,
                        )
                    w.write(conns[key], ts, raw)
    return len(bags)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pose-csv-to-tum")
    p.add_argument("src")
    p.add_argument("dst")
    p = sub.add_parser("pose-kitti-to-tum")
    p.add_argument("src")
    p.add_argument("dst")
    p = sub.add_parser("pose-tum-to-kitti")
    p.add_argument("src")
    p.add_argument("dst")
    p = sub.add_parser("mesh-transform")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument(
        "-m", "--matrix", required=True,
        help="12 or 16 whitespace-separated row-major values",
    )
    p = sub.add_parser("bag-merge")
    p.add_argument("in_folder")
    p.add_argument("out_bag")
    args = ap.parse_args(argv)

    if args.cmd == "pose-csv-to-tum":
        n = pose_csv_to_tum(args.src, args.dst)
        print(f"wrote {n} poses -> {args.dst}")
    elif args.cmd == "pose-kitti-to-tum":
        poses = io.read_kitti_poses(args.src)
        io.write_tum_poses(args.dst, poses)
        print(f"wrote {len(poses)} poses -> {args.dst}")
    elif args.cmd == "pose-tum-to-kitti":
        poses, _ = io.read_tum_poses(args.src)
        io.write_kitti_poses(args.dst, poses)
        print(f"wrote {len(poses)} poses -> {args.dst}")
    elif args.cmd == "mesh-transform":
        vals = [float(x) for x in args.matrix.split()]
        T = np.eye(4)
        if len(vals) == 16:
            T = np.array(vals).reshape(4, 4)
        elif len(vals) == 12:
            T[:3, :4] = np.array(vals).reshape(3, 4)
        else:
            sys.exit("matrix needs 12 or 16 values")
        nv, nt = mesh_transform(args.src, args.dst, T)
        print(f"transformed mesh: {nv} verts, {nt} tris -> {args.dst}")
    elif args.cmd == "bag-merge":
        n = bag_merge(args.in_folder, args.out_bag)
        print(f"merged {n} bags -> {args.out_bag}")


if __name__ == "__main__":
    main()
