"""Replay data pool: fixed-capacity ring of SDF training samples (port of
clid_slam_tpu/mapping/pool.py).

Every sample is one packed [8+C] float32 row: (x, y, z, sdf, weight, ts,
sem, pad, color...). ``valid`` marks live rows inside the sliding window;
``new_buf``/``new_count`` index the current frame's novel samples.

Random draws: each function that draws takes either a ``generator`` or the
draws themselves, so a test can inject the numbers the JAX side drew.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import torch

from ..ops.scatter import ordered_cumsum, scatter_set

_X, _SDF, _W, _TS, _SEM = 0, 3, 4, 5, 6
BASE_COLS = 8


@dataclass
class ReplayPool:
    data: torch.Tensor  # [P, 8+C]
    valid: torch.Tensor  # [P] bool
    size: torch.Tensor  # scalar i32, high-water prefix length
    new_buf: torch.Tensor  # [B] i32
    new_count: torch.Tensor  # scalar i32

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)]

    # column views (cold paths; hot paths gather whole rows and split them)
    @property
    def coords(self) -> torch.Tensor:
        return self.data[..., _X : _X + 3]

    @property
    def sdf(self) -> torch.Tensor:
        return self.data[..., _SDF]

    @property
    def weight(self) -> torch.Tensor:
        return self.data[..., _W]

    @property
    def ts(self) -> torch.Tensor:
        return self.data[..., _TS].to(torch.int32)

    @property
    def sem(self) -> torch.Tensor:
        return self.data[..., _SEM].to(torch.int32)

    @property
    def color(self) -> torch.Tensor:
        return self.data[..., BASE_COLS:]


def split_rows(rows: torch.Tensor):
    """[N, 8+C] rows -> (coords, sdf, weight, ts_i32, sem_i32, color)."""
    return (
        rows[..., _X : _X + 3],
        rows[..., _SDF],
        rows[..., _W],
        rows[..., _TS].to(torch.int32),
        rows[..., _SEM].to(torch.int32),
        rows[..., BASE_COLS:],
    )


def init_pool(
    capacity: int, new_buf_size: int, color_channels: int = 1, device=None
) -> ReplayPool:
    data = torch.zeros(
        (capacity, BASE_COLS + color_channels), dtype=torch.float32, device=device
    )
    data[:, _SEM] = -1.0
    return ReplayPool(
        data=data,
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device),
        new_buf=torch.zeros((new_buf_size,), dtype=torch.int32, device=device),
        new_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def filter_pool(pool: ReplayPool, origin: torch.Tensor, window_radius) -> ReplayPool:
    """Mask-only sliding-window filter; invalidates the new-sample buffer."""
    d2 = torch.sum((pool.coords - origin) ** 2, dim=-1)
    keep = pool.valid & (d2 < window_radius * window_radius)
    return replace(
        pool,
        valid=keep,
        new_buf=torch.zeros_like(pool.new_buf),
        new_count=torch.zeros_like(pool.new_count),
    )


def append_slots(pool: ReplayPool, mask: torch.Tensor, uniform: Optional[torch.Tensor]):
    """Destination slot per row (the JAX ``append_samples`` slot rule):
    filling phase ``size + cumsum(mask)``; when the frame does not fit,
    sorted uniform order statistics over [0, P) from ``uniform`` [M+1];
    masked rows take the next valid row's slot, the trailing run gets P.
    Returns (slot [M] int64, fits, n_valid)."""
    p = pool.data.shape[0]
    m = mask.shape[0]
    offs = torch.cumsum(mask.to(torch.int64), 0) - 1
    n_valid = torch.sum(mask.to(torch.int32))
    fits = pool.size + n_valid <= p
    slot = pool.size.long() + offs
    if uniform is not None:
        e = -torch.log(torch.clamp(uniform, 1e-12, 1.0))
        s = ordered_cumsum(e)
        slot_evict = torch.clamp((s[:m] / s[m] * p).to(torch.int64), max=p - 1)
        slot = torch.where(fits, slot, slot_evict)
    slot = torch.where(mask, slot, torch.full_like(slot, p))
    slot = torch.flip(torch.cummin(torch.flip(slot, [0]), 0).values, [0])
    return torch.clamp(slot, max=p), fits, n_valid


def append_samples(
    pool: ReplayPool,
    coords: torch.Tensor,  # [M,3] world frame
    sdf: torch.Tensor,
    weight: torch.Tensor,
    mask: torch.Tensor,
    frame_id,
    is_new: torch.Tensor,  # [M] bool
    uniform: Optional[torch.Tensor] = None,  # [M+1] U(0,1) draws
    generator: Optional[torch.Generator] = None,
    color: Optional[torch.Tensor] = None,  # [M, C] color labels
    sem: Optional[torch.Tensor] = None,  # [M] class labels
) -> ReplayPool:
    """Append one frame's masked samples; when the frame does not fit,
    samples evict uniform-random old slots. The class and color columns are
    written only when ``sem`` and ``color`` are given (else they keep -1
    and 0, as ``init_pool`` made them).

    Duplicate slots arise from two sources: a masked row backfilled with the
    next valid row's slot, and two evicting rows drawing the same slot. As
    in the JAX version (whose CPU scatter applies rows in order), the last
    row in index order wins each slot: the write gathers every duplicate's
    data from that winning row, so the result is deterministic on any
    device. Mirrors JAX on purpose, including its eviction over [0, P) for
    a frame that only partly fits."""
    m = coords.shape[0]
    if uniform is None and generator is not None:
        uniform = torch.rand(m + 1, generator=generator, device=coords.device)
    elif uniform is not None:
        uniform = torch.as_tensor(uniform, device=coords.device)
    slot, fits, n_valid = append_slots(pool, mask, uniform)

    ts = torch.full_like(sdf, 1.0) * torch.as_tensor(
        frame_id, dtype=torch.float32, device=sdf.device
    )
    vals = torch.stack([coords[:, 0], coords[:, 1], coords[:, 2], sdf, weight, ts], 1)
    data = pool.data.clone()
    scatter_set(data[:, : _TS + 1], slot, vals)
    if sem is not None:
        scatter_set(data[:, _SEM], slot, sem.to(torch.float32))
    if color is not None:
        scatter_set(data[:, BASE_COLS : BASE_COLS + color.shape[1]], slot, color)
    valid = scatter_set(pool.valid.clone(), slot, torch.ones_like(mask))

    nb = pool.new_buf.shape[0]
    new_flag = mask & is_new
    noffs = torch.cumsum(new_flag.to(torch.int64), 0) - 1
    new_buf = torch.zeros_like(pool.new_buf)
    scatter_set(new_buf, noffs, slot.to(torch.int32), new_flag & (noffs < nb))
    new_count = torch.clamp(torch.sum(new_flag.to(torch.int32)), max=nb)
    size = torch.where(
        fits, pool.size + n_valid, torch.full_like(pool.size, pool.data.shape[0])
    ).to(torch.int32)
    return ReplayPool(data, valid, size, new_buf, new_count.to(torch.int32))


def retransform_coords(
    pool: ReplayPool, old_poses: torch.Tensor, new_poses: torch.Tensor
) -> ReplayPool:
    """Re-express the stored world coords after a pose correction (BA):
    coords' = T_new[ts] · T_old[ts]⁻¹ · coords, each row by the poses of
    its frame (``ts`` clipped to the pose table)."""
    R_o, t_o = old_poses[:, :3, :3], old_poses[:, :3, 3]
    R_n, t_n = new_poses[:, :3, :3], new_poses[:, :3, 3]
    # diff = T_new @ inv(T_old):  R_d = R_n R_oᵀ,  t_d = t_n - R_d t_o
    R_d = torch.sum(R_n[:, :, None, :] * R_o[:, None, :, :], dim=-1)
    t_d = t_n - torch.sum(R_d * t_o[:, None, :], dim=-1)
    ts = pool.data[:, _TS].to(torch.int64).clamp(0, old_poses.shape[0] - 1)
    coords = torch.sum(R_d[ts] * pool.coords[:, None, :], dim=-1) + t_d[ts]
    data = pool.data.clone()
    data[:, _X : _X + 3] = coords
    return replace(pool, data=data)


def sample_batch_indices(
    pool: ReplayPool,
    bs: int,
    bs_new: int,
    generator: Optional[torch.Generator] = None,
    draws=None,
) -> torch.Tensor:
    """Mixed replay batch: ``bs_new`` indices from the new-sample buffer
    (when it holds any) + the rest uniform over [0, size).

    ``draws`` = (idx_hist [bs], pick [bs_new]) injects the integer draws,
    or is a function of the pool that returns them; otherwise they come
    from ``generator`` as floor(u * n) on the device."""
    dev = pool.data.device
    if callable(draws):
        draws = draws(pool)
    hi = torch.clamp(pool.size.long(), min=1)
    n_new = torch.clamp(pool.new_count.long(), min=1)
    if draws is None:
        u1 = torch.rand(bs, generator=generator, device=dev, dtype=torch.float64)
        idx_hist = torch.minimum((u1 * hi).long(), hi - 1)
        pick = None
        if bs_new > 0:
            u2 = torch.rand(bs_new, generator=generator, device=dev, dtype=torch.float64)
            pick = torch.minimum((u2 * n_new).long(), n_new - 1)
    else:
        idx_hist = torch.as_tensor(draws[0], device=dev).long()
        pick = None if draws[1] is None else torch.as_tensor(draws[1], device=dev).long()
    if bs_new <= 0:
        return idx_hist
    idx_new = pool.new_buf.long()[pick]
    use_new = (pool.new_count > 0) & (torch.arange(bs, device=dev) >= bs - bs_new)
    padded = torch.cat([torch.zeros(bs - bs_new, dtype=torch.int64, device=dev), idx_new])
    return torch.where(use_new, padded, idx_hist)
