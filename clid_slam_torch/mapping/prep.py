"""Per-frame map preparation (port of clid_slam_tpu/mapping/prep.py):
local raw-map update, ray sampling with region-specific labels, neural
point insertion from near-surface samples, replay-pool window filter and
append, and the novelty flags for adaptive iterations. Per-point colors and
class labels, when given, ride with the samples into the pool."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import local_map as lm
from ..models import neural_map as nm
from ..mapping import pool as pl
from ..mapping.mapper import make_novelty_fn
from ..mapping.sampler import sample_rays
from ..utils import observability as obs
from ..utils.transforms import transform_points


class PrepResult(NamedTuple):
    map_state: nm.NeuralMapState
    local_map: lm.LocalMapState
    pool: pl.ReplayPool
    new_point_ratio: torch.Tensor
    new_sample_count: torch.Tensor
    cur_sample_count: torch.Tensor
    insert_dropped: torch.Tensor  # candidates lost to the insert compaction


def make_prep_fn(
    *,
    resolution: float,
    local_resolution: float,
    local_map_size: float,
    window_radius: float,
    surface_sample_range_m: float,
    surface_sample_n: int,
    free_front_n: int,
    free_behind_n: int,
    free_sample_begin_ratio: float,
    free_sample_end_dist_m: float,
    max_range: float,
    dist_weight_on: bool,
    dist_weight_scale: float,
    map_surface_ratio: float,
    from_sample_points: bool,
    new_certainty_thre: float,
    novelty_on: bool,
    novelty_mode: str = "travel",
    filter_pool_now: bool = True,
    pin_mode: bool = False,
    behind_dropoff_on: bool = False,
    incidence_label_on: bool = False,
    incidence_min_factor: float = 0.1,
    incidence_degenerate_factor: float = 1.0,
    free_behind_weight: float = 1.0,
):
    """Returns ``prep(map_state, local_map, pool, points, mask, pose,
    travel_dist, frame_id, diff_travel_dist_local, generator=None,
    sample_draws=None, append_uniform=None, colors=None, sem_labels=None)
    -> PrepResult``; ``colors`` [P, C] and ``sem_labels`` [P] label the
    points. The novelty
    gate reads the own-cell certainty when ``novelty_mode == "fast"`` and
    the distance-checked 1-cell maximum otherwise."""
    novelty = make_novelty_fn(
        resolution=resolution,
        new_certainty_thre=new_certainty_thre,
        surface_sample_range_m=surface_sample_range_m,
        mode=novelty_mode,
    )

    def prep(
        map_state: nm.NeuralMapState,
        local_map: lm.LocalMapState,
        pool: pl.ReplayPool,
        points: torch.Tensor,  # [P,3] sensor/IMU frame
        mask: torch.Tensor,  # [P]
        pose: torch.Tensor,  # [4,4]
        travel_dist: torch.Tensor,
        frame_id,
        diff_travel_dist_local,
        generator: Optional[torch.Generator] = None,
        sample_draws=None,
        append_uniform: Optional[torch.Tensor] = None,
        colors: Optional[torch.Tensor] = None,
        sem_labels: Optional[torch.Tensor] = None,
    ) -> PrepResult:
        origin = pose[:3, 3]
        world_pts = transform_points(points, pose)
        if not pin_mode:
            with obs.span("frame.prep.local_map"):
                local_map = lm.update_local_map(
                    local_map, origin, world_pts, mask, local_resolution,
                    local_map_size, crop_now=filter_pool_now,
                )
        with obs.span("frame.prep.sample"):
            batch = sample_rays(
                points, mask, pose, local_map, local_resolution,
                surface_sample_range_m=surface_sample_range_m,
                surface_sample_n=surface_sample_n,
                free_front_n=free_front_n,
                free_behind_n=free_behind_n,
                free_sample_begin_ratio=free_sample_begin_ratio,
                free_sample_end_dist_m=free_sample_end_dist_m,
                max_range=max_range,
                dist_weight_on=dist_weight_on,
                dist_weight_scale=dist_weight_scale,
                pin_mode=pin_mode,
                behind_dropoff_on=behind_dropoff_on,
                incidence_label_on=incidence_label_on,
                incidence_min_factor=incidence_min_factor,
                incidence_degenerate_factor=incidence_degenerate_factor,
                free_behind_weight=free_behind_weight,
                generator=generator,
                draws=sample_draws,
                colors=colors,
                sem_labels=sem_labels,
            )
            coords_global = transform_points(batch.coords, pose)

        with obs.span("frame.prep.insert"):
            if from_sample_points:
                upd_sel = batch.mask & (
                    torch.abs(batch.sdf_label) < surface_sample_range_m * map_surface_ratio
                )
                upd_pts = coords_global
                if map_surface_ratio <= 2.0:
                    # only the endpoint + near-surface block can pass the gate
                    surf_rows = (1 + surface_sample_n) * points.shape[0]
                    upd_sel = upd_sel[:surf_rows]
                    upd_pts = upd_pts[:surf_rows]
            else:
                upd_sel = mask
                upd_pts = world_pts
            map_state, ins = nm.insert_points(
                map_state, upd_pts, upd_sel, resolution, travel_dist, frame_id,
                diff_travel_dist_local,
            )
        with obs.span("frame.prep.pool"):
            if filter_pool_now:
                pool = pl.filter_pool(pool, origin, window_radius)
            if novelty_on:
                is_new = novelty(map_state, coords_global, batch.sdf_label, batch.mask)
            else:
                is_new = torch.zeros_like(batch.mask)
            pool = pl.append_samples(
                pool, coords_global, batch.sdf_label, batch.weight, batch.mask,
                frame_id, is_new, uniform=append_uniform, generator=generator,
                color=batch.color if colors is not None else None,
                sem=batch.sem if sem_labels is not None else None,
            )
        return PrepResult(
            map_state,
            local_map,
            pool,
            ins.new_ratio,
            torch.sum(is_new.to(torch.int32)),
            torch.sum(batch.mask.to(torch.int32)),
            ins.dropped,
        )

    return prep

