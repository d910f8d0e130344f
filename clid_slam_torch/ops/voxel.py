"""Voxel hashing and masked voxel downsampling (port of
clid_slam_tpu/ops/voxel.py), bit-exact with the JAX version.

The JAX hash works in uint32 with wrap-around multiplies and logical right
shifts. PyTorch has no general uint32 arithmetic, so the port carries the
hash in int64 holding values in [0, 2^32): additions and the prime products
(< 2^61) fit, every result is masked back to 32 bits, and the murmur
multiplies by 32-bit constants are split into two 16-bit halves so that no
product leaves int64. Right shifts of non-negative int64 values are logical
shifts. Negative voxel coordinates enter as their two's-complement uint32
value (``& 0xFFFFFFFF``), exactly as ``astype(jnp.uint32)`` reinterprets
them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import scalar

INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF
_P1, _P2, _P3 = 73856093, 19349669, 83492791


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _murmur_mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _prime_sum(c: torch.Tensor) -> torch.Tensor:
    """p1·x + p2·y + p3·z mod 2^32 over [..., 3] integer coordinates."""
    u = c.to(torch.int64) & _M32
    return (u[..., 0] * _P1 + u[..., 1] * _P2 + u[..., 2] * _P3) & _M32


def grid_coords(points: torch.Tensor, resolution) -> torch.Tensor:
    """[N,3] float -> [N,3] int32 voxel coordinates."""
    return torch.floor(points / resolution).to(torch.int32)


def voxel_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """[...,3] integer voxel coords -> [...] int64 bucket in [0, table_size).
    ``table_size`` must be a power of two."""
    return _murmur_mix(_prime_sum(coords)) & (table_size - 1)


def _packed_score_key(score_unit: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(score in [0,1], index) packed into one int32 key: lower score wins,
    ties go to the smaller index; invalid entries get INT32_MAX."""
    n = score_unit.shape[0]
    levels = max(2, (INT32_MAX - 1) // n - 1)
    levels = min(levels, 32766)
    sq = torch.clamp(score_unit * levels, 0, levels).to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=score_unit.device)
    key = sq * n + idx
    return torch.where(mask, key, torch.full_like(key, INT32_MAX))


def _winner_mask(h: torch.Tensor, key: torch.Tensor, mask, table_size: int):
    # table.at[h].min(key): amin is order-free, hence exact on any device
    table = torch.full(
        (table_size,), INT32_MAX, dtype=torch.int32, device=key.device
    )
    table.scatter_reduce_(0, h, key, "amin", include_self=True)
    return (table[h] == key) & mask


def voxel_down_sample_mask(
    points: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    table_size: int,
) -> torch.Tensor:
    """Keep-mask selecting, per voxel, the point closest to the voxel
    center; invalid points never win nor survive. The resolution is carried
    as an f32 scalar so that every derived constant rounds as JAX's traced
    f32 arithmetic does (the keys must match bit for bit)."""
    resolution = scalar(resolution, torch.float32, points.device)
    g = torch.floor(points / resolution)
    center = (g + 0.5) * resolution
    dist2 = torch.sum((points - center) ** 2, dim=-1)
    max_d2 = 0.75 * resolution * resolution + 1e-12
    key = _packed_score_key(dist2 / max_d2, mask)
    h = voxel_hash(g.to(torch.int32), table_size)
    return _winner_mask(h, key, mask, table_size)


def voxel_down_sample_min_value_mask(
    points: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    value: torch.Tensor,
    table_size: int,
) -> torch.Tensor:
    """Keep-mask selecting, per voxel, the point with the minimum ``value``
    (ties to the smaller index); invalid points never win nor survive."""
    resolution = scalar(resolution, torch.float32, points.device)
    g = grid_coords(points, resolution)
    vmax = torch.max(torch.where(mask, value, torch.full_like(value, -torch.inf)))
    vmin = torch.min(torch.where(mask, value, torch.full_like(value, torch.inf)))
    unit = (value - vmin) / torch.clamp(vmax - vmin, min=1e-12)
    key = _packed_score_key(unit, mask)
    h = voxel_hash(g, table_size)
    return _winner_mask(h, key, mask, table_size)


def neighbor_hash_soa(
    points: torch.Tensor,  # [N,3]
    nb_offs: torch.Tensor,  # [K,3] int
    resolution,
    table_size: int,
) -> torch.Tensor:
    """[N,K] buckets of the K-cell neighborhood of each point; the per-cell
    prime products are hoisted so hash(g+dx) is one add plus the mix."""
    g = torch.floor(points / resolution).to(torch.int32)
    base = _prime_sum(g)  # [N]
    off = _prime_sum(nb_offs)  # [K]
    h = _murmur_mix((base[:, None] + off[None, :]) & _M32)
    return h & (table_size - 1)


def neighbor_offsets(num_nei_cells: int, search_alpha: float) -> np.ndarray:
    """Static [K,3] int32 offsets within the search sphere
    (|dx|² < (cells+alpha)²); K = 33/57/81/93 for cells=2 and
    alpha=0.2/0.3/0.5/1.0."""
    r = np.arange(-num_nei_cells, num_nei_cells + 1)
    dx = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    d2 = (dx**2).sum(-1)
    keep = d2 < (num_nei_cells + search_alpha) ** 2
    return np.asarray(dx[keep], dtype=np.int32)
