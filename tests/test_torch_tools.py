"""The port's host tools against the JAX package's: the map inspector
(``tools/inspect_map.py``) on tests/test_inspect.py's checkpoint and on a
checkpoint that the port's ``SlamSystem`` writes (the same files; the
point clouds byte for byte, the meshes within 1 % in vertex count and 1e-4
m in symmetric Chamfer distance), ``tools/convert.py``'s subcommands on
tests/test_convert.py's cases (the same output bytes),
``tools/rosbag_converter.parse_pointcloud2`` on packed PointCloud2 bytes of
either byte order (equal arrays), and the optional packages' messages:
``live_viewer`` without open3d and ``bag-merge`` and the bag converter
without rosbags say what to install (those cases skip where the package
is present, as the JAX package's tests never reach them)."""

import importlib.util
import os
import struct

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from clid_slam_torch.models import decoder as tdec
from clid_slam_torch.models import neural_map as tnm
from clid_slam_torch.pipeline import slam as tslam
from clid_slam_torch.tools import convert, inspect_map, live_viewer, rosbag_converter
from clid_slam_torch.utils import io
from clid_slam_tpu.tools import convert as jconvert
from clid_slam_tpu.tools import inspect_map as jinspect
from clid_slam_tpu.tools import rosbag_converter as jrosbag
from clid_slam_tpu.utils import io as jio
from torch_parity import port_config, tiny_config


def _test_inspect_npz(path, rng):
    """tests/test_inspect.py's checkpoint: 32 points, an empty hash."""
    cap, hsize, f, n = 64, 256, 8, 32
    pos = np.zeros((cap + 1, 3), np.float32)
    pos[:n] = rng.normal(size=(n, 3)).astype(np.float32)
    np.savez(
        path, positions=pos, quats=np.tile(np.array([1, 0, 0, 0], np.float32), (cap + 1, 1)),
        geo_feats=rng.normal(size=(cap + 1, f)).astype(np.float32),
        color_feats=np.zeros((cap + 1, 1), np.float32), certainty=np.ones(cap + 1, np.float32),
        ts_create=np.zeros(cap + 1, np.int32), ts_update=np.zeros(cap + 1, np.int32),
        count=np.asarray(n, np.int32), hash_table=np.full(hsize, -1, np.int32),
        hash_mirror=np.full((hsize, 4), 1e9, np.float32),
        mlp_weights=rng.normal(size=(11, 64)).astype(np.float32),
        mlp_biases=np.zeros((64,), np.float32),
        mlp_w_out=rng.normal(size=(64, 1)).astype(np.float32), mlp_b_out=np.zeros((1,), np.float32),
    )


def _port_checkpoint(path):
    """A checkpoint written by the port's SlamSystem: a map of points on a
    sphere of 2 m with features and a decoder from seeds."""
    system = tslam.SlamSystem(port_config(tiny_config()), total_frames=4, device="cpu")
    rng = np.random.default_rng(5)
    u = rng.normal(size=(4000, 3))
    pts = (2.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    state, _ = tnm.insert_points(system.map_state, torch.from_numpy(pts),
                                 torch.ones(4000, dtype=torch.bool), 0.3, torch.zeros(4), 0, 1e9)
    feats = state.geo_feats.clone()
    cnt = int(state.count)
    feats[:cnt] = torch.from_numpy(rng.normal(0, 0.5, (cnt, 8)).astype(np.float32))
    system.map_state = state._replace(geo_feats=feats)
    system.mlp = tdec.init_mlp(torch.Generator().manual_seed(2), 11, 64, 1)
    system.save_checkpoint(path)


@pytest.mark.parametrize("ckpt", ["test_inspect", "port_written"])
def test_inspect_map_matches_jax(tmp_path, rng, ckpt):
    path = str(tmp_path / "ckpt.npz")
    if ckpt == "test_inspect":
        _test_inspect_npz(path, rng)
    else:
        _port_checkpoint(path)
    args = [path, "-m", "0.15", "--sdf-slice-height", "0.05"]
    jinspect.main(args + ["-o", str(tmp_path / "jax")])
    inspect_map.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "mesh.ply", "neural_points.ply", "sdf_slice.ply"]
    read = lambda side, name: (tmp_path / side / name).read_bytes()
    assert read("port", "neural_points.ply") == read("jax", "neural_points.ply")
    jv, jt, _ = convert._read_mesh_ply(str(tmp_path / "jax" / "mesh.ply"))
    pv, pt, _ = convert._read_mesh_ply(str(tmp_path / "port" / "mesh.ply"))
    if ckpt == "test_inspect":  # no neighbours in an empty hash: no surface
        assert len(jv) == len(pv) == 0 and read("port", "mesh.ply") == read("jax", "mesh.ply")
        return
    assert len(jv) > 1000 and abs(len(pv) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(pt) - len(jt)) <= 0.01 * len(jt)
    assert 0.5 * (cKDTree(jv).query(pv)[0].mean() + cKDTree(pv).query(jv)[0].mean()) < 1e-4
    js, ps = (io.read_ply(str(tmp_path / side / "sdf_slice.ply")) for side in ("jax", "port"))
    assert abs(len(ps["x"]) - len(js["x"])) <= 0.01 * len(js["x"]) and len(js["x"]) > 0


def test_inspect_map_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inspect_map.main([str(tmp_path / "missing.npz")])


def _pose_files(tmp_path):
    rows = ["nsec,x,y,z,qx,qy,qz,qw", "1000000000,1.0,2.0,3.0,0,0,0,1",
            "2000000000,4.0,5.0,6.0,0,0,0.3826834,0.9238795"]
    (tmp_path / "gt.csv").write_text("\n".join(rows) + "\n")
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, 3] = np.random.default_rng(0).normal(size=(5, 3))
    jio.write_kitti_poses(str(tmp_path / "k.txt"), poses)
    jio.write_tum_poses(str(tmp_path / "t.txt"), poses, np.arange(5) * 0.1)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    jio.write_ply_mesh(str(tmp_path / "m.ply"), v, np.array([[0, 1, 2]], np.int64),
                       colors=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64))
    return poses


@pytest.mark.parametrize("cmd", [
    ["pose-csv-to-tum", "gt.csv"], ["pose-kitti-to-tum", "k.txt"], ["pose-tum-to-kitti", "t.txt"],
    ["mesh-transform", "m.ply", "-m", "1 0 0 10 0 1 0 0 0 0 1 0"],
    ["mesh-transform", "m.ply", "-m", "0 -1 0 1 1 0 0 2 0 0 1 3 0 0 0 1"],
], ids=["csv_to_tum", "kitti_to_tum", "tum_to_kitti", "mesh_12", "mesh_16"])
def test_convert_subcommands_match_jax(tmp_path, cmd):
    poses = _pose_files(tmp_path)
    src = str(tmp_path / cmd[1])
    out = {}
    for side, module in (("jax", jconvert), ("port", convert)):
        dst = str(tmp_path / f"{side}_{cmd[1]}")
        module.main([cmd[0], src, dst, *cmd[2:]])
        out[side] = open(dst, "rb").read()
    assert out["port"] == out["jax"] and len(out["port"]) > 0
    dst = str(tmp_path / f"port_{cmd[1]}")
    if cmd[0] == "pose-kitti-to-tum":  # tests/test_convert.py's round trip
        convert.main(["pose-tum-to-kitti", dst, str(tmp_path / "back.txt")])
        np.testing.assert_allclose(io.read_kitti_poses(str(tmp_path / "back.txt")), poses, atol=1e-5)
    elif cmd[0] == "pose-csv-to-tum":
        got, ts = io.read_tum_poses(dst)
        np.testing.assert_allclose(got[0][:3, 3], [1, 2, 3])
        np.testing.assert_allclose(ts, [1.0, 2.0])
    elif cmd[0] == "mesh-transform":
        v, t, colors = convert._read_mesh_ply(dst)
        assert v.shape == (3, 3) and (t == [[0, 1, 2]]).all() and colors is not None
        if len(cmd[-1].split()) == 12:
            np.testing.assert_allclose(v[:, 0], [10, 11, 10], atol=1e-6)


def test_pose_csv_to_tum_counts_rows(tmp_path):
    _pose_files(tmp_path)
    assert convert.pose_csv_to_tum(str(tmp_path / "gt.csv"), str(tmp_path / "o.txt")) == 2


@pytest.mark.parametrize("bigendian", [False, True], ids=["little", "big"])
def test_parse_pointcloud2_matches_jax(bigendian):
    """x, y, z and intensity as f32, t as u32 and a ring as u16 at their
    offsets in a 24-byte point, packed in either byte order; ``want``
    drops the ring, and fields given as dicts or as objects."""
    rng = np.random.default_rng(1)
    n = 257
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, n).astype(np.float32)
    t = rng.integers(0, 1 << 30, n).astype(np.uint32)
    ring = rng.integers(0, 128, n).astype(np.uint16)
    e = ">" if bigendian else "<"
    data = b"".join(struct.pack(e + "ffffIH2x", *xyz[i], inten[i], t[i], ring[i]) for i in range(n))
    fields = [dict(name=k, offset=o, datatype=d) for k, o, d in
              (("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7), ("t", 16, 6),
               ("ring", 20, 4))]
    got = rosbag_converter.parse_pointcloud2(fields, 24, bigendian, data)
    want = jrosbag.parse_pointcloud2(fields, 24, bigendian, data)
    assert sorted(got) == sorted(want) == ["intensity", "t", "x", "y", "z"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["t"], t)
    np.testing.assert_array_equal(np.stack([got["x"], got["y"], got["z"]], 1), xyz)
    objs = [type("Field", (), f) for f in fields]
    ring_only = rosbag_converter.parse_pointcloud2(objs, 24, bigendian, data, want=["ring"])
    np.testing.assert_array_equal(ring_only["ring"], ring)


def _absent(module):
    if importlib.util.find_spec(module) is not None:
        pytest.skip(f"{module} is installed")


def test_live_viewer_says_to_install_open3d():
    _absent("open3d")
    with pytest.raises(SystemExit, match="pip install open3d"):
        live_viewer.main(["--port", "1"])


def test_bag_tools_say_to_install_rosbags(tmp_path):
    _absent("rosbags")
    with pytest.raises(ImportError, match="pip install rosbags"):
        convert.main(["bag-merge", str(tmp_path), str(tmp_path / "out.bag")])
    with pytest.raises(SystemExit, match="pip install rosbags"):
        rosbag_converter.main([str(tmp_path / "in.bag"), "-o", str(tmp_path / "ds")])
