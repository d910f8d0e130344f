"""Row, lane and column gathers in plain PyTorch: a frozen copy of the
plain versions in ``clid_slam_torch/ops/gather.py`` (lines 55-68 and
121-159 as of commit 806f431), with the CUDA kernels taken out. Every
wrapper runs its plain version on any device; ``gather_rows_nd`` keeps the
fixed-order backward (``ops/scatter.py:segment_add``) so that a run
repeats bit for bit.
"""

from __future__ import annotations

import math

import torch

from .scatter import segment_add


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_lanes_reference(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    sel = sel.long()
    if src.dim() == 3:
        sel = sel[..., None].expand(-1, -1, src.shape[2])
    return torch.take_along_dim(src, sel, dim=1)


def gather_cols_reference(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table_t[:, idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: table [R, C], idx [N] -> [N, C]."""
    return gather_rows_reference(table, idx)


def gather_lanes(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``out[n, j] = src[n, sel[n, j]]`` (lanes of [N, L] or [N, L, C])."""
    return gather_lanes_reference(src, sel)


def gather_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[f, j] = table_t[f, idx[j]]``."""
    return gather_cols_reference(table_t, idx)


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
