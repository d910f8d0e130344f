"""Three host faults of the JAX package that the port repairs (ROADMAP C11),
each pinned beside the JAX package's behaviour on inputs the test writes:

- a one-face ASCII PLY: JAX's reader fails (``np.loadtxt`` returns one 1-D
  row), the port's reads the triangle;
- binary PLYs whose face list is not ``uchar int``: JAX's reader assumes
  that layout and misreads them, the port's takes the count and index
  types from the header;
- a kiss-icp loader with ``gt_poses`` and ``calibration`` (a stand-in
  object behind a stand-in ``kiss_icp.datasets`` module, since kiss-icp is
  not installed): JAX takes the poses as they are, the port puts them
  through the calibration as it does a pose file's (``inv(Tr) @ T @ Tr``,
  ``utils/io.py:read_kitti_poses``).
"""

import sys
import types

import numpy as np
import pytest

from clid_slam_torch.config import Config as TConfig
from clid_slam_torch.pipeline.dataset import SLAMDataset as TData
from clid_slam_torch.tools import convert as tconv
from clid_slam_tpu.config import Config as JConfig
from clid_slam_tpu.pipeline.dataset import SLAMDataset as JData
from clid_slam_tpu.tools import convert as jconv

VERTS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.5], [1.0, 1.0, 0.25]],
                 np.float32)
TRIS = np.array([[0, 1, 2], [1, 3, 2]])


def _header(fmt, n_face, count_t="uchar", index_t="int"):
    return (f"ply\nformat {fmt} 1.0\nelement vertex {len(VERTS)}\nproperty float x\n"
            f"property float y\nproperty float z\nelement face {n_face}\n"
            f"property list {count_t} {index_t} vertex_indices\nend_header\n")


def test_one_face_ascii_ply(tmp_path):
    path = tmp_path / "one.ply"
    body = "".join(f"{x} {y} {z}\n" for x, y, z in VERTS) + "3 0 1 2\n"
    path.write_text(_header("ascii", 1) + body)
    with pytest.raises(IndexError):  # JAX: loadtxt's 1-D row has no second axis
        jconv._read_mesh_ply(str(path))
    v, t, colors = tconv._read_mesh_ply(str(path))
    np.testing.assert_array_equal(t, [[0, 1, 2]])
    np.testing.assert_array_equal(v, VERTS.astype(np.float64))
    assert colors is None
    # two faces read the same in both packages
    path.write_text(_header("ascii", 2) + body + "3 1 3 2\n")
    for conv in (jconv, tconv):
        np.testing.assert_array_equal(conv._read_mesh_ply(str(path))[1], TRIS)


@pytest.mark.parametrize("count_t,index_t", [("uint", "uint"), ("uchar", "ushort"),
                                             ("ushort", "int")])
def test_binary_ply_list_types(tmp_path, count_t, index_t):
    np_t = {"uchar": "<u1", "ushort": "<u2", "int": "<i4", "uint": "<u4"}
    path = tmp_path / "mesh.ply"
    face = np.zeros(len(TRIS), np.dtype([("n", np_t[count_t]), ("v", np_t[index_t], (3,))]))
    face["n"], face["v"] = 3, TRIS
    path.write_bytes(_header("binary_little_endian", len(TRIS), count_t, index_t).encode()
                     + VERTS.tobytes() + face.tobytes())
    v, t, _ = tconv._read_mesh_ply(str(path))
    np.testing.assert_array_equal(t, TRIS)
    np.testing.assert_array_equal(v, VERTS.astype(np.float64))
    try:
        jt = jconv._read_mesh_ply(str(path))[1]
    except ValueError:  # JAX: the u1 + i4 records overrun the buffer
        return
    assert not np.array_equal(jt, TRIS)


def test_uchar_int_binary_ply_reads_alike(tmp_path):
    """The layout JAX's reader assumes (the port's own writer's) reads the
    same in both packages."""
    path = tmp_path / "mesh.ply"
    tconv.io.write_ply_mesh(str(path), VERTS, TRIS)
    for conv in (jconv, tconv):
        v, t, _ = conv._read_mesh_ply(str(path))
        np.testing.assert_array_equal(t, TRIS)
        np.testing.assert_array_equal(v, VERTS.astype(np.float64))


def _poses(n):
    rng = np.random.default_rng(4)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-0.3, 0.3)
        out[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        out[i, :3, 3] = rng.uniform(-5, 5, 3)
    return out


class _Loader:
    """A kiss-icp loader's surface that the datasets read."""

    def __init__(self, gt, tr):
        self.gt_poses = gt
        if tr is not None:
            self.calibration = {"Tr": tr}

    def __len__(self):
        return len(self.gt_poses)


@pytest.mark.parametrize("calibrated", [True, False])
def test_kiss_loader_gt_poses_go_through_its_calibration(monkeypatch, calibrated):
    gt = _poses(6)
    tr4 = np.eye(4)
    tr4[:3, :3] = [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    tr4[:3, 3] = [0.27, -0.08, -0.01]
    tr = tr4[:3, :4].reshape(-1) if calibrated else None  # kiss-icp's 12 values
    mod = types.ModuleType("kiss_icp.datasets")
    mod.dataset_factory = lambda **kw: _Loader(gt, tr)
    monkeypatch.setitem(sys.modules, "kiss_icp", types.ModuleType("kiss_icp"))
    monkeypatch.setitem(sys.modules, "kiss_icp.datasets", mod)
    got = {}
    for name, cfg_cls, data_cls, kw in (("jax", JConfig, JData, {}),
                                        ("port", TConfig, TData, {"device": "cpu"})):
        cfg = cfg_cls()
        cfg.use_kiss_dataloader = True
        cfg.end_frame = 100
        d = data_cls(cfg, min_frames=8, **kw)
        assert d.total_pc_count == len(gt) and d.gt_pose_provided
        got[name] = d.gt_poses
    np.testing.assert_array_equal(got["jax"], gt)  # JAX leaves them as they are
    want = np.linalg.inv(tr4) @ gt @ tr4 if calibrated else gt
    np.testing.assert_allclose(got["port"], want, rtol=0, atol=1e-12)
