"""Build and load the port's hand-written CUDA sources.

Each ``clid_slam_torch/csrc/<name>.cu`` is compiled with ``nvcc`` for
``sm_90a`` into a C-ABI shared library at first use, under
``clid_slam_torch/build/`` (listed in ``.gitignore``), and bound with
``ctypes``. The library's file name carries a hash of the source and of
``NVCC_FLAGS``, so a change to either builds a new one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


def lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(source_path(name), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def start_build(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library is there. Returns
    ``(process or None, temporary path, final path)`` for ``finish_build``;
    starting several before finishing any compiles them side by side."""
    path = lib_path(name)
    if os.path.exists(path):
        return None, "", path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, path


def finish_build(started) -> str:
    """Wait for a ``start_build`` and move the library into place. Returns
    nvcc's -Xptxas -v report ("" when nothing was compiled)."""
    proc, tmp, path = started
    if proc is None:
        return ""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
    os.replace(tmp, path)
    return err


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``lib_path(name)`` unless it is
    there. Returns nvcc's -Xptxas -v report when it compiled."""
    return finish_build(start_build(name))


def load(name: str, declare) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use.
    ``declare(lib)`` sets the argtypes and restypes of its functions."""
    with _lock:
        if name not in _libs:
            build(name)
            lib = ctypes.CDLL(lib_path(name))
            declare(lib)
            _libs[name] = lib
        return _libs[name]
