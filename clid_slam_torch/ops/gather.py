"""Row and column gathers of f32 tables and lane gathers of 1-, 4-, 8- and
16-byte elements: CUDA kernel wrappers and their plain PyTorch versions.

They replace the Pallas gather probes of the JAX package
(``scripts/probe_pallas_gather.py`` ``gather_a``, ``gather_a2``,
``gather_b``; ``scripts/probe_pallas_gather2.py`` ``make_a``, ``make_b``,
``make_c``). On the main path ``gather_rows`` gathers the mapper's work
slab and the hash mirrors' rows, and ``gather_lanes`` the kNN selection's
picks out of the 81 candidate buckets of each point. The kernel source is
``clid_slam_torch/csrc/gather.cu`` (its header note says what bounds the
kernels on the H100); ``ops/_build.py`` compiles it at first use and loads
it as the Python extension module it defines.

Each wrapper dispatches on the table's device: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version. There is no fallback
from one to the other. Indices are int32 or int64 and are not checked or
clamped: an index outside the table is the caller's error.

A call on the card costs host time beside the kernel's few microseconds,
so the launch path is kept short: the module's entry points take plain ints
(pointers, sizes and the current stream from
``torch._C._cuda_getCurrentRawStream``, a CUDA build's own accessor, so no
``Stream`` object is made per call) in one METH_FASTCALL call, cheaper than
ctypes' argument conversion, and the checks are those the kernels need.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .scatter import segment_add

# launches of each kernel (one per wrapper call on CUDA tensors)
launches = {"gather_rows": 0, "gather_lanes": 0, "gather_cols": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_module = None  # the kernels' Python module (clid_gather), loaded at the first launch


def _kernels():
    global _module
    if _module is None:
        _module = _build.load_module("gather")
    return _module


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_lanes_reference(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    sel = sel.long()
    if src.dim() == 3:
        sel = sel[..., None].expand(-1, -1, src.shape[2])
    return torch.take_along_dim(src, sel, dim=1)


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
    err = getattr(_module or _kernels(), fn)(
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


class _RowsBackward(torch.autograd.Function):
    """``gather_rows_nd`` of a table that needs a gradient: the kernel
    forward, and a backward that sums each row's cotangents in a fixed
    order (``ops/scatter.py:segment_add``). Autograd's own backward of
    ``table[idx]`` accumulates with atomics on CUDA and in thread order on
    the CPU, so a run would not repeat bit for bit. It sorts the indices on
    every backward, since the filter's and BA's change from call to call;
    the mapper's slab gather (``mapping/mapper.py:_SlabGatherSorted``) keeps
    its own, whose sort is made once a batch and reused by every inner
    step."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return gather_rows_nd(table.detach(), idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        zeros = grad.new_zeros((shape[0], math.prod(shape[1:])))
        rows = segment_add(zeros, idx.reshape(-1).long(), grad.reshape(idx.numel(), -1))
        return rows.reshape(shape), None


def gather_rows_nd(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for indices of any shape: [*idx.shape, *row] through
    ``gather_rows`` (the hash-mirror probes gather [N, K] buckets). Rows of
    more than one dimension move flattened. Differentiable wrt ``table``,
    with a backward of fixed summation order."""
    if table.requires_grad and torch.is_grad_enabled():
        return _RowsBackward.apply(table, idx)
    flat = table.reshape(table.shape[0], -1)
    return gather_rows(flat, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


# gather_lanes: the lane sizes its kernel copies
LANE_BYTES = (1, 4, 8, 16)


class _LanesBackward(torch.autograd.Function):
    """``gather_lanes`` of a source that needs a gradient: the kernel
    forward, and ``torch.gather``'s own backward (a scatter-add of the
    output's gradient into zeros)."""

    @staticmethod
    def forward(ctx, src, sel):
        ctx.save_for_backward(sel)
        ctx.src_shape = src.shape
        return gather_lanes(src.detach(), sel)

    @staticmethod
    def backward(ctx, grad):
        # one addend a target: smallest_k picks distinct lanes in a row, so
        # the scatter-add (atomics on CUDA) has no order to vary
        (sel,) = ctx.saved_tensors
        sel = sel.long()
        if len(ctx.src_shape) == 3:
            sel = sel[..., None].expand(-1, -1, ctx.src_shape[2])
        return grad.new_zeros(ctx.src_shape).scatter_add_(1, sel, grad), None


def gather_lanes(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``out[n, j] = src[n, sel[n, j]]``: src [N, L] of 1-, 4- or 8-byte
    elements (bool, f32, int32, int64, ...) or [N, L, C] of 16-byte pieces
    ([N, L, 4] f32), sel [N, K] -> [N, K] or [N, K, C], copied bit for bit.
    The source must be aligned to its lane size; selector rows may be
    strided (a slice of columns). The kernel picks its regime from the
    shapes (``csrc/gather.cu``'s note).

    The main path calls it 7 times a tracked frame, so the checks are
    written for few tensor attribute reads (each costs the host about
    0.1 µs)."""
    shape, sshape = src.shape, sel.shape
    lane = src.element_size()
    if len(shape) == 3:
        lane *= shape[2]
    elif len(shape) != 2:
        lane = 0
    if lane not in LANE_BYTES:
        raise TypeError(
            f"gather_lanes: lanes of 1, 4, 8 or 16 bytes, got {tuple(shape)} {src.dtype}"
        )
    idx_type = sel.dtype
    if idx_type is not torch.int64 and idx_type is not torch.int32:
        raise TypeError(f"gather_lanes: selectors must be int32 or int64, got {idx_type}")
    if len(sshape) != 2 or sshape[0] != shape[0]:
        raise ValueError(
            f"gather_lanes: selectors {tuple(sshape)} for a source {tuple(shape)}"
        )
    ptr = src.data_ptr()
    if ptr % lane:
        raise ValueError(f"gather_lanes: the source is not aligned to its {lane}-byte lanes")
    dev = src.get_device()
    if dev != sel.get_device():
        raise ValueError(f"gather_lanes: selectors on {sel.device}, the source on {src.device}")
    if dev < 0:
        if src.device.type != "cpu":
            raise ValueError(f"gather_lanes: unsupported device {src.device}")
        return gather_lanes_reference(src, sel)
    if not src.is_cuda:
        raise ValueError(f"gather_lanes: unsupported device {src.device}")
    if src.requires_grad and torch.is_grad_enabled():
        return _LanesBackward.apply(src, sel)
    sel_ld, sel_step = sel.stride()
    if not src.is_contiguous() or sel_step != 1:
        raise ValueError("gather_lanes: the source must be contiguous and each selector "
                         "row's lanes adjacent")
    if len(shape) == 2:
        out = torch.empty_like(sel, dtype=src.dtype)  # contiguous, as sel.stride(1) == 1
    else:
        out = src.new_empty((sshape[0], sshape[1], shape[2]))
    if sshape[0] == 0 or sshape[1] == 0:
        return out
    err = (_module or _kernels()).gather_lanes(
        ptr, sel.data_ptr(), out.data_ptr(), sshape[0], shape[1], sshape[1], sel_ld,
        lane | (32 if idx_type is torch.int64 else 0),
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"gather_lanes kernel launch failed: cudaError {err}")
    launches["gather_lanes"] += 1
    return out


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
