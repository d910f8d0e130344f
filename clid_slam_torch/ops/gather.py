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


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_lanes_reference(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(src, sel.long(), dim=1)


def gather_cols_reference(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table_t[:, idx.long()]


def _check(fn, table, idx, table_dim, idx_dim):
    if table.dtype != torch.float32:
        raise TypeError(f"{fn}: the table must be float32, got {table.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{fn}: indices must be int32 or int64, got {idx.dtype}")
    if table.dim() != table_dim or idx.dim() != idx_dim:
        raise ValueError(
            f"{fn}: expected a {table_dim}-d table and {idx_dim}-d indices, got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}"
        )
    if idx.device != table.device:
        raise ValueError(f"{fn}: indices are on {idx.device}, the table on {table.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {table.device}")


def _launch(fn, c_fn, table, idx, out, *dims):
    """Launch one kernel of csrc/gather.cu on the current stream."""
    for name, x in (("table", table), ("indices", idx)):
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    err = c_fn(
        ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), *dims, int(idx.dtype == torch.int64),
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
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
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    wide = C % 4 == 0
    if wide and table.data_ptr() % 16 != 0:
        raise ValueError("gather_rows: the table is not 16-byte aligned")
    out = torch.empty((idx.shape[0], C), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    lib = _build.load("gather", _declare)
    return _launch("gather_rows", lib.clid_gather_rows, table, idx, out, idx.shape[0],
                   C // 4 if wide else C, int(wide))


def gather_lanes(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``out[n, j] = src[n, sel[n, j]]``: src [N, L] f32, sel [N, L']
    -> [N, L']."""
    _check("gather_lanes", src, sel, 2, 2)
    if sel.shape[0] != src.shape[0]:
        raise ValueError(
            f"gather_lanes: {sel.shape[0]} selector rows for {src.shape[0]} source rows"
        )
    if src.device.type == "cpu":
        return gather_lanes_reference(src, sel)
    out = torch.empty(sel.shape, dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = _build.load("gather", _declare)
    return _launch(
        "gather_lanes", lib.clid_gather_lanes, src, sel, out,
        src.shape[0], src.shape[1], sel.shape[1],
    )


def gather_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[f, j] = table_t[f, idx[j]]``: table_t [F, W] f32, idx [N]
    -> [F, N]."""
    _check("gather_cols", table_t, idx, 2, 1)
    if table_t.device.type == "cpu":
        return gather_cols_reference(table_t, idx)
    out = torch.empty((table_t.shape[0], idx.shape[0]), dtype=torch.float32, device=table_t.device)
    if out.numel() == 0:
        return out
    lib = _build.load("gather", _declare)
    return _launch(
        "gather_cols", lib.clid_gather_cols, table_t, idx, out,
        table_t.shape[0], table_t.shape[1], idx.shape[0],
    )
