"""Training-sample generation along LiDAR rays (port of
clid_slam_tpu/mapping/sampler.py, CLID mode).

Per ray: 1 endpoint + n_surf Gaussian near-surface + n_front/n_behind
uniform freespace samples, in part-major [S*N] order; near-surface labels
come from the raw-point local map. With per-ray ``colors`` and
``sem_labels`` the endpoint and near-surface samples carry the ray's color
and class, freespace samples color 0 and class 0; without labels the class
is -1 everywhere. ``draws`` = (normal [S_s,N], u_front
[F_n,N], u_behind [B_n,N]) injects the random numbers; otherwise they come
from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.local_map import LocalMapState, region_specific_sdf
from ..utils.transforms import transform_points


class SampleBatch(NamedTuple):
    coords: torch.Tensor  # [N*S, 3] sensor-frame sample coordinates
    sdf_label: torch.Tensor  # [N*S]
    weight: torch.Tensor  # [N*S] (sign = surface(+)/freespace(-))
    mask: torch.Tensor  # [N*S] bool
    color: torch.Tensor  # [N*S, C] (C = 1 without colors)
    sem: torch.Tensor  # [N*S] i32 (-1 without labels)


def sample_rays(
    points: torch.Tensor,  # [N,3] sensor-frame ray endpoints
    mask: torch.Tensor,  # [N]
    pose: torch.Tensor,  # [4,4] sensor->world
    local_map: LocalMapState,
    local_voxel_size,
    *,
    surface_sample_range_m: float,
    surface_sample_n: int,
    free_front_n: int,
    free_behind_n: int,
    free_sample_begin_ratio: float,
    free_sample_end_dist_m: float,
    max_range: float,
    dist_weight_on: bool = True,
    dist_weight_scale: float = 0.8,
    pin_mode: bool = False,
    behind_dropoff_on: bool = False,
    incidence_label_on: bool = False,
    incidence_min_factor: float = 0.1,
    incidence_degenerate_factor: float = 1.0,
    free_behind_weight: float = 1.0,
    generator: Optional[torch.Generator] = None,
    draws=None,
    colors: Optional[torch.Tensor] = None,  # [N, C]
    sem_labels: Optional[torch.Tensor] = None,  # [N] i32
) -> SampleBatch:
    n = points.shape[0]
    dev = points.device
    s_total = 1 + surface_sample_n + free_front_n + free_behind_n
    sigma = surface_sample_range_m
    if draws is None:
        draws = (
            torch.randn((surface_sample_n, n), generator=generator, device=dev),
            torch.rand((free_front_n, n), generator=generator, device=dev),
            torch.rand((free_behind_n, n), generator=generator, device=dev),
        )
    normal, u_f, u_b = (torch.as_tensor(d, device=dev) for d in draws)

    dist = torch.linalg.norm(points, dim=-1)
    safe_dist = torch.clamp(dist, min=1e-6)

    ratio0 = torch.ones((1, n), device=dev)
    disp0 = torch.zeros((1, n), device=dev)
    disp_s = normal * sigma  # [S_s, N]
    ratio_s = disp_s / safe_dist[None, :] + 1.0
    sigma_ratio = 2.0
    free_max_ratio_f = 1.0 - sigma_ratio * sigma / safe_dist[None, :]
    diff_f = free_max_ratio_f - free_sample_begin_ratio
    ratio_f = u_f * diff_f + free_sample_begin_ratio
    disp_f = (ratio_f - 1.0) * safe_dist[None, :]
    max_ratio_b = free_sample_end_dist_m / safe_dist[None, :] + 1.0
    min_ratio_b = 1.0 + sigma_ratio * sigma / safe_dist[None, :]
    ratio_b = u_b * (max_ratio_b - min_ratio_b) + min_ratio_b
    disp_b = (ratio_b - 1.0) * safe_dist[None, :]

    all_ratio = torch.cat([ratio0, ratio_s, ratio_f, ratio_b], 0)  # [S,N]
    all_disp = torch.cat([disp0, disp_s, disp_f, disp_b], 0)
    coords = points[None, :, :] * all_ratio[:, :, None]  # [S,N,3]
    sdf_label = -all_disp

    surf_lo, surf_hi = 1, 1 + surface_sample_n
    est_valid = None
    if not pin_mode:
        surf_coords = coords[surf_lo:surf_hi].reshape(-1, 3)
        surf_global = transform_points(surf_coords, pose)
        est_dist, est_valid, est_normal, est_fit = region_specific_sdf(
            local_map, surf_global, local_voxel_size, with_normal=True
        )
        sdf_sign = torch.where(disp_s.reshape(-1) < 0, 1.0, -1.0)
        sdf_label = sdf_label.clone()
        sdf_label[surf_lo:surf_hi] = (sdf_sign * est_dist).reshape(
            surface_sample_n, n
        )
        if incidence_label_on:
            # incidence-corrected freespace labels (see the JAX sampler):
            # scale by sin(incidence) from the first successful fit
            nrm = est_normal.reshape(surface_sample_n, n, 3)
            fit = est_fit.reshape(surface_sample_n, n)
            sup = est_valid.reshape(surface_sample_n, n)
            first = torch.argmax(fit.to(torch.int32), dim=0)
            onehot = first[None, :] == torch.arange(surface_sample_n, device=dev)[:, None]
            n_best = torch.sum(nrm * onehot[..., None], dim=0)
            fit_any = torch.any(fit, dim=0)
            sup_any = torch.any(sup, dim=0)
            d_world = points @ pose[:3, :3].T
            d_hat = d_world / torch.clamp(
                torch.linalg.norm(d_world, dim=-1, keepdim=True), min=1e-9
            )
            sin_inc = torch.abs(torch.sum(d_hat * n_best, dim=-1))
            factor = torch.where(
                fit_any,
                torch.clamp(sin_inc, incidence_min_factor, 1.0),
                torch.where(
                    sup_any,
                    torch.full_like(sin_inc, incidence_degenerate_factor),
                    torch.ones_like(sin_inc),
                ),
            )
            sdf_label[surf_hi:] = sdf_label[surf_hi:] * factor[None, :]

    weight = torch.ones((s_total, n), device=dev)
    if dist_weight_on:
        w_surface = 1.0 + dist_weight_scale * 0.5 - (dist / max_range) * dist_weight_scale
        weight[:surf_hi] = w_surface[None, :].expand(surf_hi, n)
    if behind_dropoff_on:
        dropoff_min = 0.2 * free_sample_end_dist_m
        dropoff_max = free_sample_end_dist_m
        dw = (dropoff_max - all_disp) / (dropoff_max - dropoff_min)
        weight = weight * (torch.clamp(dw, 0.0, 1.0) * 0.8 + 0.2)
    weight[surf_hi:] = weight[surf_hi:] * -1.0
    if free_behind_weight != 1.0:
        weight[surf_hi + free_front_n :] = (
            weight[surf_hi + free_front_n :] * free_behind_weight
        )

    valid = mask[None, :].expand(s_total, n).clone()
    if est_valid is not None:
        valid[surf_lo:surf_hi] = valid[surf_lo:surf_hi] & est_valid.reshape(
            surface_sample_n, n
        )
    if colors is not None:
        color_s = torch.zeros((s_total, n, colors.shape[1]), device=dev)
        color_s[:surf_hi] = colors.to(torch.float32)[None]
    else:
        color_s = torch.zeros((s_total, n, 1), device=dev)
    if sem_labels is not None:
        sem_s = torch.zeros((s_total, n), dtype=torch.int32, device=dev)
        sem_s[:surf_hi] = sem_labels.to(torch.int32)[None]
    else:
        sem_s = torch.full((s_total, n), -1, dtype=torch.int32, device=dev)
    return SampleBatch(
        coords=coords.reshape(-1, 3),
        sdf_label=sdf_label.reshape(-1),
        weight=weight.reshape(-1),
        mask=valid.reshape(-1),
        color=color_s.reshape(s_total * n, -1),
        sem=sem_s.reshape(-1),
    )
