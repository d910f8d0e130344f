"""The collectives of the sharded runtime, on ``torch.distributed`` with one
rank per shard (the port's counterpart of the mesh axis that
``clid_slam_tpu/parallel`` runs ``shard_map`` over).

Every float reduction across ranks is an ``all_gather`` followed by a sum
over the rank axis in rank order, so a run repeats bit for bit and every
rank holds the same sum: ``all_reduce(SUM)`` is not used, since neither
NCCL nor gloo pins the order in which it adds. ``pmax`` is exact in any
order and takes ``all_reduce(MAX)``.

The differentiable collectives are ``torch.autograd.Function``s whose
backward is the transpose JAX takes inside ``shard_map(...,
check_vma=False)``, which is what the reference computes:
- ``psum``'s transpose is ``psum``;
- ``psum_scatter``'s (tiled, over the leading axis) is ``all_gather``;
- ``all_gather``'s (stacked ``[S, ...]``) is ``psum_scatter``.
So a per-rank gradient through ``psum`` of a replicated loss carries a
factor of the rank count, as JAX's does.

Bringing up the process group is the caller's job; ``Mesh`` names this
rank's place in it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's view of a one-axis mesh: the process group, the rank in
    it and the number of ranks (shards)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int


def make_group_mesh(n_devices: Optional[int] = None, group=None) -> Mesh:
    """``Mesh`` over ``group`` (the default group when None). ``n_devices``
    must be None or the group's size: a mesh of fewer shards is a process
    group of that many ranks, made by the caller."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call init_process_group first"
        )
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {size} ranks; "
            "make a group of n_devices ranks and pass it"
        )
    return Mesh(group, dist.get_rank(group), size)


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (rank) axis, rank 0 first."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.stack(parts)


def _psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ordered_sum(_all_gather(x, mesh))


def _psum_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of the leading axis, summed over ranks in order:
    one all-to-all brings every rank's copy of the chunk here."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"psum_scatter: {n} rows do not split over {mesh.size} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return _ordered_sum(out.reshape((mesh.size, n // mesh.size) + tuple(x.shape[1:])))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _psum_scatter(x, mesh)

    @staticmethod
    def backward(ctx, g):
        parts = _all_gather(g, ctx.mesh)
        return parts.reshape((-1,) + tuple(g.shape[1:])), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return _psum_scatter(g.reshape((-1,) + tuple(g.shape[2:])), mesh).reshape(
            g.shape[1:]
        ), None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.psum``: the sum of every rank's ``x``, in rank order."""
    return _Psum.apply(x, mesh)


def psum_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, scatter_dimension=0, tiled=True)``: rows
    ``[rank * n/S, (rank + 1) * n/S)`` of the sum over ranks."""
    return _PsumScatter.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's ``x`` stacked, ``[S, ...]``."""
    return _AllGather.apply(x, mesh)


def psum_all(tensors, mesh: Mesh) -> list:
    """``psum`` of each tensor (not differentiable), as one collective over
    their flat concatenation."""
    flat = _psum(torch.cat([t.detach().reshape(-1) for t in tensors]), mesh)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.pmax`` (not differentiable)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out
