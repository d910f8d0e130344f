"""Raw-point local map + region-specific SDF label estimation (port of
clid_slam_tpu/models/local_map.py): point-to-plane distance where a 4-NN
plane fit succeeds, 1-NN distance otherwise
(model/local_point_cloud_map.py:11-201 of the reference)."""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..device import on_device
from ..ops.gather import gather_rows_nd
from ..ops.plane_fit import fit_plane_masked
from ..ops.scatter import scatter_set
from ..ops.voxel import (
    grid_coords,
    neighbor_offsets,
    voxel_down_sample_mask,
    voxel_hash,
)

# 7-cell probe: num_nei_cells=1, alpha=0.2
LOCAL_NB_OFFSETS = torch.from_numpy(neighbor_offsets(1, 0.2))
_local_nb_offsets = on_device(LOCAL_NB_OFFSETS)

_EMPTY_POS = 1e9


def local_max_valid_range(resolution: float) -> float:
    return 1.732 * 2.0 * resolution


@dataclass
class LocalMapState:
    positions: torch.Tensor  # [C+1, 3] f32, sentinel last row
    count: torch.Tensor  # scalar i32
    hash_table: torch.Tensor  # [H] i32, -1 empty
    hash_mirror: torch.Tensor  # [H, 4] f32 (x, y, z, pad)

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)]


def init_local_map(capacity: int, hash_size: int, device=None) -> LocalMapState:
    return LocalMapState(
        positions=torch.zeros((capacity + 1, 3), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        hash_table=torch.full((hash_size,), -1, dtype=torch.int32, device=device),
        hash_mirror=torch.full(
            (hash_size, 4), _EMPTY_POS, dtype=torch.float32, device=device
        ),
    )


def update_local_map(
    state: LocalMapState,
    sensor_position: torch.Tensor,  # [3]
    points: torch.Tensor,  # [M,3] world frame
    mask: torch.Tensor,  # [M]
    resolution,
    map_size,
    crop_now: bool = True,
    inplace: bool = False,
) -> LocalMapState:
    """Insert new surface points into empty voxels, then (``crop_now``)
    radius-crop to ``map_size`` around the sensor and rebuild the hash;
    otherwise append only. ``inplace`` writes ``state``'s own tensors (the
    returned state holds them) instead of new ones."""
    cap = state.positions.shape[0] - 1
    hsize = state.hash_table.shape[0]
    dev = points.device

    mask = voxel_down_sample_mask(points, mask, resolution, hsize)
    d_in = torch.linalg.norm(points - sensor_position, dim=-1)
    h = voxel_hash(grid_coords(points, resolution), hsize)
    empty = state.hash_table[h] == -1
    insert = mask & empty & (d_in < map_size)

    offs = torch.cumsum(insert.to(torch.int64), 0) - 1
    new_idx = state.count.long() + offs
    insert = insert & (new_idx < cap)
    own = (lambda t: t) if inplace else torch.clone
    positions = scatter_set(own(state.positions), new_idx, points, insert)
    count = torch.clamp(
        state.count + torch.sum(insert.to(torch.int32)), max=cap
    ).to(torch.int32)

    if not crop_now:
        hash_table = scatter_set(own(state.hash_table), h, new_idx.to(torch.int32), insert)
        mir_rows = torch.cat(
            [points, torch.zeros((points.shape[0], 1), device=dev)], dim=1
        )
        hash_mirror = scatter_set(own(state.hash_mirror), h, mir_rows, insert)
        if inplace:
            count = state.count.copy_(count)
        return LocalMapState(positions, count, hash_table, hash_mirror)

    # radius crop + compaction + rehash (one O(C) pass)
    rows = torch.arange(cap + 1, device=dev)
    live = rows < count
    d = torch.linalg.norm(positions - sensor_position, dim=-1)
    keep = live & (d < map_size)
    new_pos_idx = torch.cumsum(keep.to(torch.int64), 0) - 1
    new_count = torch.sum(keep.to(torch.int32))
    live2 = rows < new_count
    if inplace:
        # a kept row moves down only, and scatter_set reads its rows before
        # it writes: the rows past the new count are then zeroed
        compacted = scatter_set(positions, new_pos_idx, positions, keep)
        compacted.masked_fill_(~live2[:, None], 0.0)
        new_count = state.count.copy_(new_count)
        hash_table = state.hash_table.fill_(-1)
        hash_mirror = state.hash_mirror.fill_(_EMPTY_POS)
    else:
        compacted = scatter_set(torch.zeros_like(positions), new_pos_idx, positions, keep)
        hash_table = torch.full((hsize,), -1, dtype=torch.int32, device=dev)
        hash_mirror = torch.full((hsize, 4), _EMPTY_POS, dtype=torch.float32, device=dev)

    h2 = voxel_hash(grid_coords(compacted, resolution), hsize)
    scatter_set(hash_table, h2, rows.to(torch.int32), live2)
    mir_rows = torch.cat([compacted, torch.zeros((cap + 1, 1), device=dev)], dim=1)
    scatter_set(hash_mirror, h2, mir_rows, live2)
    return LocalMapState(compacted, new_count, hash_table, hash_mirror)


def region_specific_sdf(
    state: LocalMapState,
    points: torch.Tensor,  # [N,3] world frame
    resolution,
    eta_threshold: float = 0.2,
    residual_threshold: float = 0.1,
    with_normal: bool = False,
):
    """Region-specific |SDF| labels: (sdf_abs [N], surface_mask [N]) and,
    with ``with_normal``, (normal [N,3], fit_success [N])."""
    hsize = state.hash_table.shape[0]
    maxr = local_max_valid_range(resolution)
    offs = _local_nb_offsets(points.device)

    g = grid_coords(points, resolution)
    cells = g[:, None, :] + offs[None, :, :]
    h = voxel_hash(cells, hsize)
    mir = gather_rows_nd(state.hash_mirror, h)  # [N,7,4]
    nb = mir[..., :3]
    dist = torch.linalg.norm(nb - points[:, None, :], dim=-1)
    dist = torch.clamp(dist, max=maxr)

    # 4 nearest as a rank mask over the 7 cells; a duplicate bucket keeps
    # its first occurrence (later equal-distance copies go to maxr)
    iot = torch.arange(offs.shape[0], device=points.device)
    lower = iot[None, None, :] < iot[None, :, None]
    dup = (h[:, None, :] == h[:, :, None]) & lower & (
        dist[:, None, :] == dist[:, :, None]
    )
    dist = torch.where(torch.any(dup, dim=-1), torch.full_like(dist, maxr), dist)
    before = (dist[:, None, :] < dist[:, :, None]) | (
        (dist[:, None, :] == dist[:, :, None]) & lower
    )
    rank = torch.sum(before.to(torch.int32), dim=-1)
    real = dist < maxr
    sel4 = (rank < 4) & real

    nn1 = torch.amin(dist, dim=-1)
    valid_fit = torch.sum(real.to(torch.int32), dim=-1) >= 4
    normal, constant, fit_success = fit_plane_masked(
        nb, sel4, eta_threshold, residual_threshold
    )
    fit_success = fit_success & valid_fit
    plane_dist = torch.abs(torch.sum(normal * points, dim=-1) + constant)
    sdf_abs = torch.where(fit_success, plane_dist, nn1)
    surface_mask = nn1 < maxr
    if with_normal:
        return sdf_abs, surface_mask, normal, fit_success
    return sdf_abs, surface_mask
