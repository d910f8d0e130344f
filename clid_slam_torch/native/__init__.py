"""Native host runtime (C++) — frame parsing, voxel downsample, prefetch
(the port's own copy of clid_slam_tpu/native, with its own C++ source).

The compute path is PyTorch on the card; this package is the C++ host side
that keeps the card fed, replacing the roles the reference delegates to Open3D's
C++ core (point-cloud parsing/containers — utils/slam_dataset.py:187-193,
993-1062) and the synchronous per-frame disk reads inside its SLAM loop
(utils/slam_dataset.py:250-295).

The shared library is compiled from ``clid_native.cpp`` on first use with
g++ (plain C ABI + ctypes) into ``clid_slam_torch/build/`` (listed in
``.gitignore``), keyed by a source hash. Everything here
degrades gracefully: if the toolchain is missing, ``available()`` returns
False and callers fall back to the pure-numpy readers in utils/io.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "clid_native.cpp")
_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()


class _ClidCloud(ctypes.Structure):
    _fields_ = [
        ("xyz", ctypes.POINTER(ctypes.c_float)),
        ("intensity", ctypes.POINTER(ctypes.c_float)),
        ("ts", ctypes.POINTER(ctypes.c_double)),
        ("rgb", ctypes.POINTER(ctypes.c_float)),
        ("n", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
        ("err", ctypes.c_char * 256),
    ]


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_cache_dir(), f"clid_native_{tag}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-fno-math-errno", _SRC, "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    os.replace(tmp, so)  # atomic: concurrent builds race safely
    return so


def _bind(lib):
    lib.clid_read_cloud.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ClidCloud)]
    lib.clid_read_cloud.restype = ctypes.c_int
    lib.clid_cloud_free.argtypes = [ctypes.POINTER(_ClidCloud)]
    lib.clid_cloud_free.restype = None
    lib.clid_voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.clid_voxel_downsample.restype = ctypes.c_int64
    lib.clid_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.clid_loader_create.restype = ctypes.c_void_p
    lib.clid_loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(_ClidCloud),
    ]
    lib.clid_loader_get.restype = ctypes.c_int
    lib.clid_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.clid_loader_destroy.restype = None


def _get_lib():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if os.environ.get("CLID_NATIVE", "1") == "0":
            _lib_err = "disabled via CLID_NATIVE=0"
            return None
        try:
            lib = ctypes.CDLL(_build())
            _bind(lib)
            _lib = lib
        except Exception as e:  # no g++, no write access, etc.: fall back
            _lib_err = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _get_lib() is not None


def why_unavailable() -> Optional[str]:
    _get_lib()
    return _lib_err


def _cloud_to_arrays(c: _ClidCloud, color_channel: int):
    """ClidCloud -> (points [N,3(+c)] f32, ts [N] f64 or None), matching
    utils/io.read_point_cloud's contract."""
    n = c.n
    xyz = np.ctypeslib.as_array(c.xyz, shape=(n, 3)).copy() if n else \
        np.zeros((0, 3), np.float32)
    parts = [xyz]
    if color_channel == 1 and c.intensity:
        parts.append(
            np.ctypeslib.as_array(c.intensity, shape=(n, 1)).copy()
        )
    elif color_channel == 3 and c.rgb:
        parts.append(np.ctypeslib.as_array(c.rgb, shape=(n, 3)).copy())
    pts = np.concatenate(parts, axis=1) if len(parts) > 1 else xyz
    ts = np.ctypeslib.as_array(c.ts, shape=(n,)).copy() if c.ts else None
    return pts, ts


def read_point_cloud(
    path: str, color_channel: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Native-parsed frame load; same signature/semantics as
    utils/io.read_point_cloud (raises on parse failure)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    # KITTI .bin has no rgb: any nonzero color channel means intensity
    # (utils/slam_dataset.py:993-1009 returns all 4 columns there)
    if color_channel == 3 and path.lower().endswith(".bin"):
        color_channel = 1
    c = _ClidCloud()
    rc = lib.clid_read_cloud(path.encode(), ctypes.byref(c))
    if rc != 0:
        raise ValueError(c.err.decode(errors="replace"))
    try:
        return _cloud_to_arrays(c, color_channel)
    finally:
        lib.clid_cloud_free(ctypes.byref(c))


def voxel_downsample_mask(
    points: np.ndarray,
    resolution: float,
    table_size: int,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host-side keep-mask with the exact selection semantics of
    ops/voxel.voxel_down_sample_mask (closest point to voxel center wins,
    smaller index breaks ties; power-of-two table)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = pts.shape[0]
    keep = np.zeros(n, np.uint8)
    m_ptr = None
    if mask is not None:
        m = np.ascontiguousarray(mask, np.uint8)
        m_ptr = m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.clid_voxel_downsample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.c_float(resolution), table_size, m_ptr,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)


class FramePrefetcher:
    """Background read+parse of upcoming frames while the card works on the
    current one. ``get(i)`` blocks until frame i is parsed and extends the
    prefetch horizon to i+1+lookahead."""

    def __init__(
        self,
        paths,
        lookahead: int = 4,
        threads: int = 2,
        color_channel: int = 0,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_lib_err}")
        self._lib = lib
        self._color_channel = color_channel
        self._lookahead = lookahead
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._keepalive = arr
        self._h = lib.clid_loader_create(
            arr, len(self._paths), lookahead, threads
        )

    def __len__(self):
        return len(self._paths)

    def get(self, idx: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        c = _ClidCloud()
        rc = self._lib.clid_loader_get(
            self._h, idx, self._lookahead, ctypes.byref(c)
        )
        if rc != 0:
            raise ValueError(c.err.decode(errors="replace"))
        try:
            return _cloud_to_arrays(c, self._color_channel)
        finally:
            self._lib.clid_cloud_free(ctypes.byref(c))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.clid_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
