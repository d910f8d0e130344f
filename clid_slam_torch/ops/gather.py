"""Row, lane and column gathers of f32 tables: CUDA kernel wrappers and
their plain PyTorch versions.

They replace the Pallas gather probes of the JAX package
(``scripts/probe_pallas_gather.py`` ``gather_a``, ``gather_a2``,
``gather_b``; ``scripts/probe_pallas_gather2.py`` ``make_a``, ``make_b``,
``make_c``), and ``gather_rows`` is the mapper's gather of the frame's work
slab. The kernel source is ``clid_slam_torch/csrc/gather.cu`` (its header
note says what bounds the kernels on the H100); ``ops/_build.py`` compiles
it at first use and binds it with ``ctypes``.

Each wrapper dispatches on the table's device: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version. There is no fallback
from one to the other. Indices are int32 or int64 and are not checked or
clamped: an index outside the table is the caller's error.

A call on the card costs host time beside the kernel's few microseconds,
so the launch path is kept short: the library's functions are bound once,
pointers and the current stream pass to ctypes as plain ints (the stream
from ``torch._C._cuda_getCurrentRawStream``, a CUDA build's own accessor,
so no ``Stream`` object is made per call), and the checks are those the
kernels need.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of each kernel (one per wrapper call on CUDA tensors)
launches = {"gather_rows": 0, "gather_lanes": 0, "gather_cols": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _declare(lib):
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.clid_gather_rows.argtypes = [vp, vp, vp, ll, ci, ci, ci, vp]
    lib.clid_gather_lanes.argtypes = [vp, vp, vp, ll, ci, ci, ci, vp]
    lib.clid_gather_cols.argtypes = [vp, vp, vp, ll, ll, ll, ci, vp]
    for fn in (lib.clid_gather_rows, lib.clid_gather_lanes, lib.clid_gather_cols):
        fn.restype = ci


_fns = {}  # kernel name -> bound C function, filled at the first launch


def _fn(name):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("gather", _declare)
        for k in launches:
            _fns[k] = getattr(lib, "clid_" + k)
        fn = _fns[name]
    return fn


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_lanes_reference(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(src, sel.long(), dim=1)


def gather_cols_reference(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table_t[:, idx.long()]


def _check(fn, table, idx, table_dim, idx_dim):
    if table.dtype is not torch.float32:
        raise TypeError(f"{fn}: the table must be float32, got {table.dtype}")
    if idx.dtype is not torch.int32 and idx.dtype is not torch.int64:
        raise TypeError(f"{fn}: indices must be int32 or int64, got {idx.dtype}")
    if table.dim() != table_dim or idx.dim() != idx_dim:
        raise ValueError(
            f"{fn}: expected a {table_dim}-d table and {idx_dim}-d indices, got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}"
        )
    if idx.device != table.device:
        raise ValueError(f"{fn}: indices are on {idx.device}, the table on {table.device}")
    if not table.is_cuda and table.device.type != "cpu":
        raise ValueError(f"{fn}: unsupported device {table.device}")


def _launch(fn, table, idx, out, *dims):
    """Launch one kernel of csrc/gather.cu on the current stream."""
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{fn}: the table and the indices must be contiguous")
    err = _fn(fn)(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), *dims,
        torch._C._cuda_getCurrentRawStream(table.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")
    launches[fn] += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: table [R, C] f32, idx [N] -> [N, C]. Rows of a
    multiple of 4 floats move as 16-byte pieces (the table must then be
    16-byte aligned), other rows as single floats."""
    _check("gather_rows", table, idx, 2, 1)
    C = table.shape[1]
    if C == 0:
        raise ValueError("gather_rows: the rows are empty")
    if not table.is_cuda:
        return gather_rows_reference(table, idx)
    wide = C % 4 == 0
    if wide and table.data_ptr() % 16 != 0:
        raise ValueError("gather_rows: the table is not 16-byte aligned")
    n = idx.shape[0]
    out = table.new_empty((n, C))
    if n == 0:
        return out
    return _launch("gather_rows", table, idx, out, n, C // 4 if wide else C, int(wide),
                   int(idx.dtype is torch.int64))


def gather_rows_nd(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for indices of any shape: [*idx.shape, C] through
    ``gather_rows`` (the hash-mirror probes gather [N, K] buckets)."""
    return gather_rows(table, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def gather_lanes(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``out[n, j] = src[n, sel[n, j]]``: src [N, L] f32, sel [N, L']
    -> [N, L']."""
    _check("gather_lanes", src, sel, 2, 2)
    if sel.shape[0] != src.shape[0]:
        raise ValueError(
            f"gather_lanes: {sel.shape[0]} selector rows for {src.shape[0]} source rows"
        )
    if not src.is_cuda:
        return gather_lanes_reference(src, sel)
    out = src.new_empty(sel.shape)
    if out.numel() == 0:
        return out
    return _launch("gather_lanes", src, sel, out, src.shape[0], src.shape[1], sel.shape[1],
                   int(sel.dtype is torch.int64))


def gather_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[f, j] = table_t[f, idx[j]]``: table_t [F, W] f32, idx [N]
    -> [F, N]."""
    _check("gather_cols", table_t, idx, 2, 1)
    if not table_t.is_cuda:
        return gather_cols_reference(table_t, idx)
    out = table_t.new_empty((table_t.shape[0], idx.shape[0]))
    if out.numel() == 0:
        return out
    return _launch("gather_cols", table_t, idx, out, table_t.shape[0], table_t.shape[1],
                   idx.shape[0], int(idx.dtype is torch.int64))
