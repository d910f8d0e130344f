"""The port's file IO (clid_slam_torch/utils/io.py) and its native reader
(clid_slam_torch/native) against the JAX package's: both read the same
files to the same arrays, bit for bit, and write the same bytes. The
port's native reader equals its numpy reader and the JAX native reader;
its prefetcher serves frames out of order and reports unreadable files
(the patterns of tests/test_io.py and tests/test_native.py)."""

import os

import numpy as np
import pytest

from clid_slam_torch import native as tnative
from clid_slam_torch.odometry.iekf import _so3_exp
from clid_slam_torch.utils import io as tio
from clid_slam_tpu import native as jnative
from clid_slam_tpu.utils import io as jio

needs_native = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason=f"native lib unavailable: {tnative.why_unavailable()}",
)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _ply(tmp_path, rng, name, n=300, colors=False):
    pts = (rng.normal(size=(n, 3)) * 10).astype(np.float32)
    pts[7, 1] = np.nan  # dropped by every reader
    extra = {"intensity": rng.uniform(0, 1, n).astype(np.float32),
             "timestamp": np.linspace(0, 0.1, n)}
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32) if colors else None
    paths = []
    for mod in (tio, jio):
        p = str(tmp_path / f"{name}_{mod.__name__.split('.')[0]}.ply")
        mod.write_ply(p, pts, colors=col, extra=extra)
        paths.append(p)
    assert _bytes(paths[0]) == _bytes(paths[1])
    return paths[0]


def _ascii_ply(tmp_path, rng):
    pts = rng.normal(size=(32, 3))
    body = "".join(f"{x:.6f} {y:.6f} {z:.6f} {i:.3f}\n" for (x, y, z), i in
                   zip(pts, rng.uniform(0, 1, 32)))
    p = str(tmp_path / "a.ply")
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 32\nproperty float x\n"
                "property float y\nproperty float z\nproperty float intensity\n"
                "end_header\n" + body)
    return p


def _pcd(tmp_path, rng, binary):
    n = 100
    cols = {k: rng.normal(size=n).astype(np.float32) for k in ("x", "y", "z", "intensity")}
    head = (b"# .PCD v0.7\nVERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
            b"TYPE F F F F\nCOUNT 1 1 1 1\n"
            + f"WIDTH {n}\nHEIGHT 1\nPOINTS {n}\nDATA {'binary' if binary else 'ascii'}\n".encode())
    p = str(tmp_path / f"f_{binary}.pcd")
    with open(p, "wb") as f:
        f.write(head)
        if binary:
            rec = np.zeros(n, np.dtype([(k, "<f4") for k in cols]))
            for k, v in cols.items():
                rec[k] = v
            f.write(rec.tobytes())
        else:
            f.write("".join(" ".join(f"{cols[k][i]:.6f}" for k in cols) + "\n"
                            for i in range(n)).encode())
    return p


def _kitti_bin(tmp_path, rng):
    p = str(tmp_path / "000000.bin")
    rng.normal(size=(128, 4)).astype(np.float32).tofile(p)
    return p


CLOUDS = {
    "ply_binary": lambda tp, rng: _ply(tp, rng, "b"),
    "ply_rgb": lambda tp, rng: _ply(tp, rng, "rgb", colors=True),
    "ply_ascii": _ascii_ply,
    "pcd_binary": lambda tp, rng: _pcd(tp, rng, True),
    "pcd_ascii": lambda tp, rng: _pcd(tp, rng, False),
    "kitti_bin": _kitti_bin,
}


def _same(a, b):
    (pa, ta), (pb, tb) = a, b
    assert pa.dtype == pb.dtype and pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)
    assert (ta is None) == (tb is None)
    if ta is not None:
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("color_channel", [0, 1, 3])
@pytest.mark.parametrize("kind", sorted(CLOUDS))
def test_numpy_readers_match_jax(tmp_path, rng, kind, color_channel):
    p = CLOUDS[kind](tmp_path, rng)
    _same(tio.read_point_cloud(p, color_channel, use_native=False),
          jio.read_point_cloud(p, color_channel, use_native=False))


@needs_native
@pytest.mark.parametrize("kind", sorted(k for k in CLOUDS if k != "ply_ascii"))
def test_native_reader_matches_numpy_and_jax_native(tmp_path, rng, kind):
    p = CLOUDS[kind](tmp_path, rng)
    for cc in (0, 1, 3):
        got = tnative.read_point_cloud(p, cc)
        _same(got, tio.read_point_cloud(p, cc, use_native=False))
        _same(got, jnative.read_point_cloud(p, cc))


@needs_native
def test_native_ascii_ply_matches_jax_native(tmp_path, rng):
    """Ascii floats: the native parser's rounding is its own (the JAX tests
    hold it to 1e-6 of numpy's), and the port's equals the JAX one's."""
    p = _ascii_ply(tmp_path, rng)
    for cc in (0, 1):
        _same(tnative.read_point_cloud(p, cc), jnative.read_point_cloud(p, cc))
        np.testing.assert_allclose(tnative.read_point_cloud(p, cc)[0],
                                   tio.read_point_cloud(p, cc, use_native=False)[0], atol=1e-6)


def test_native_is_the_ports_own_build():
    assert tnative._SRC != jnative._SRC
    assert os.path.dirname(tnative._SRC).endswith(os.path.join("clid_slam_torch", "native"))
    if tnative.available():
        assert os.path.basename(os.path.dirname(tnative._build())) == "build"


@needs_native
def test_prefetcher_out_of_order_and_errors(tmp_path, rng):
    paths = [_ply(tmp_path, rng, f"{i:06d}") for i in range(4)]
    bad = str(tmp_path / "missing.ply")
    pf = tnative.FramePrefetcher(paths + [bad], lookahead=8, threads=2, color_channel=1)
    try:
        for i in (3, 0, 2, 1):
            _same(pf.get(i), tio.read_point_cloud(paths[i], 1, use_native=False))
        with pytest.raises(ValueError):
            pf.get(4)
    finally:
        pf.close()


def test_pose_files_match_jax(tmp_path, rng):
    n = 9
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        poses[i, :3, :3] = _so3_exp(rng.normal(size=3) * (2.5 if i % 3 == 0 else 0.5))
        poses[i, :3, 3] = rng.uniform(-20, 20, 3)
    ts = np.arange(n) * 0.1
    out = {}
    for mod in (tio, jio):
        tag = mod.__name__.split(".")[0]
        out[tag] = (str(tmp_path / f"kitti_{tag}.txt"), str(tmp_path / f"tum_{tag}.txt"))
        mod.write_kitti_poses(out[tag][0], poses)
        mod.write_tum_poses(out[tag][1], poses, ts)
    (tk, tt), (jk, jt) = out["clid_slam_torch"], out["clid_slam_tpu"]
    assert _bytes(tk) == _bytes(jk) and _bytes(tt) == _bytes(jt)
    np.testing.assert_array_equal(tio.read_kitti_poses(tk), jio.read_kitti_poses(tk))
    calib = np.eye(4)
    calib[:3, :3] = _so3_exp(np.array([0.1, -0.2, 0.3]))
    calib[:3, 3] = [0.3, -0.1, 0.8]
    np.testing.assert_array_equal(tio.read_kitti_poses(tk, calib), jio.read_kitti_poses(tk, calib))
    for a, b in zip(tio.read_tum_poses(tt), jio.read_tum_poses(tt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tio.read_tum_poses(tt)[0], poses, atol=1e-6)


def test_imu_csv_and_calib_match_jax(tmp_path, rng):
    p = str(tmp_path / "7.csv")
    rows = rng.normal(size=(13, 7))
    with open(p, "w") as f:
        f.write("dt,ax,ay,az,gx,gy,gz\n")
        f.write("".join(",".join(f"{v:.9f}" for v in r) + "\n" for r in rows))
    np.testing.assert_array_equal(tio.read_imu_csv(p), jio.read_imu_csv(p))
    np.testing.assert_allclose(tio.read_imu_csv(p), rows, atol=1e-9)
    c = str(tmp_path / "calib.txt")
    with open(c, "w") as f:
        f.write("P0: " + " ".join(f"{v:.6e}" for v in rng.normal(size=12)) + "\n")
        f.write("Tr: " + " ".join(f"{v:.6e}" for v in rng.normal(size=12)) + "\n")
        f.write("note: not a matrix\n")
    tc, jc = tio.read_calib_file(c), jio.read_calib_file(c)
    assert sorted(tc) == sorted(jc) == ["P0", "Tr"]
    for k in tc:
        np.testing.assert_array_equal(tc[k], jc[k])


def test_mesh_ply_nclt_bin_and_labels_match_jax(tmp_path, rng):
    v = rng.normal(size=(20, 3)).astype(np.float32)
    tri = rng.integers(0, 20, (15, 3))
    col = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    paths = [str(tmp_path / f"mesh{i}.ply") for i in range(2)]
    tio.write_ply_mesh(paths[0], v, tri, colors=col)
    jio.write_ply_mesh(paths[1], v, tri, colors=col)
    assert _bytes(paths[0]) == _bytes(paths[1])
    b = str(tmp_path / "nclt.bin")
    rng.integers(0, 40000, 400).astype(np.int16).tofile(b)
    np.testing.assert_array_equal(tio.load_nclt_bin(b), jio.load_nclt_bin(b))
    labels = rng.choice([0, 10, 40, 50, 252, 259], 100).astype(np.uint32)
    pc, lb = str(tmp_path / "000000.bin"), str(tmp_path / "000000.label")
    rng.normal(size=(100, 4)).astype(np.float32).tofile(pc)
    (labels | (rng.integers(0, 50, 100).astype(np.uint32) << 16)).tofile(lb)
    for a, b in zip(tio.read_semantic_point_label(pc, lb), jio.read_semantic_point_label(pc, lb)):
        np.testing.assert_array_equal(a, b)
    for moving in (False, True):
        np.testing.assert_array_equal(tio.filter_sem_kitti_mask(labels, True, moving),
                                      jio.filter_sem_kitti_mask(labels, True, moving))
