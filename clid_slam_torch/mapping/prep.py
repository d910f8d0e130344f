"""Per-frame map preparation (port of clid_slam_tpu/mapping/prep.py):
local raw-map update, ray sampling with region-specific labels, neural
point insertion from near-surface samples, replay-pool window filter and
append, and the novelty flags for adaptive iterations. Per-point colors and
class labels, when given, ride with the samples into the pool. On the card
a tracked frame's prep replays CUDA graphs of the same stages
(``GraphedPrep``)."""

from __future__ import annotations

import functools
from dataclasses import replace
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from .. import graphs
from ..models import local_map as lm
from ..ops import gather as gt
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
    the distance-checked 1-cell maximum otherwise.

    The returned function also carries its parts, for ``GraphedPrep``:
    ``prep.start`` and ``prep.stages`` (the nested spans' names and
    functions, which work on a frame namespace and, with its ``inplace``,
    write the local map, the map and the pool in place), ``prep.draw``
    (the frame's random numbers into buffers) and ``prep.draw_shapes``."""
    novelty = make_novelty_fn(
        resolution=resolution,
        new_certainty_thre=new_certainty_thre,
        surface_sample_range_m=surface_sample_range_m,
        mode=novelty_mode,
    )

    # the stages work on a frame ``f`` (a namespace: the inputs, then what
    # each stage leaves for the next); ``f.inplace`` writes the local map,
    # the map and the pool into their own tensors

    def start(f):
        f.origin = f.pose[:3, 3]
        f.world_pts = transform_points(f.points, f.pose)

    def local_map_stage(f):
        f.local_map = lm.update_local_map(
            f.local_map, f.origin, f.world_pts, f.mask, local_resolution,
            local_map_size, crop_now=filter_pool_now, inplace=f.inplace,
        )

    def sample_stage(f):
        f.batch = sample_rays(
            f.points, f.mask, f.pose, f.local_map, local_resolution,
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
            generator=f.generator,
            draws=f.sample_draws,
            colors=f.colors,
            sem_labels=f.sem_labels,
        )
        f.coords_global = transform_points(f.batch.coords, f.pose)

    def insert_stage(f):
        batch = f.batch
        if from_sample_points:
            upd_sel = batch.mask & (
                torch.abs(batch.sdf_label) < surface_sample_range_m * map_surface_ratio
            )
            upd_pts = f.coords_global
            if map_surface_ratio <= 2.0:
                # only the endpoint + near-surface block can pass the gate
                surf_rows = (1 + surface_sample_n) * f.points.shape[0]
                upd_sel = upd_sel[:surf_rows]
                upd_pts = upd_pts[:surf_rows]
        else:
            upd_sel = f.mask
            upd_pts = f.world_pts
        f.map_state, f.ins = nm.insert_points(
            f.map_state, upd_pts, upd_sel, resolution, f.travel_dist, f.frame_id,
            f.window, inplace=f.inplace,
        )

    def pool_stage(f):
        batch, pool = f.batch, f.pool
        if filter_pool_now:
            pool = pl.filter_pool(pool, f.origin, window_radius, inplace=f.inplace)
        if novelty_on:
            is_new = novelty(f.map_state, f.coords_global, batch.sdf_label, batch.mask)
        else:
            is_new = torch.zeros_like(batch.mask)
        f.pool = pl.append_samples(
            pool, f.coords_global, batch.sdf_label, batch.weight, batch.mask,
            f.frame_id, is_new, uniform=f.append_uniform, generator=f.generator,
            color=batch.color if f.colors is not None else None,
            sem=batch.sem if f.sem_labels is not None else None,
            inplace=f.inplace,
        )
        f.new_sample_count = torch.sum(is_new.to(torch.int32))
        f.cur_sample_count = torch.sum(batch.mask.to(torch.int32))

    stages = ([] if pin_mode else [("frame.prep.local_map", local_map_stage)]) + [
        ("frame.prep.sample", sample_stage),
        ("frame.prep.insert", insert_stage),
        ("frame.prep.pool", pool_stage),
    ]

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
        f = SimpleNamespace(
            map_state=map_state, local_map=local_map, pool=pool, points=points, mask=mask,
            pose=pose, travel_dist=travel_dist, frame_id=frame_id,
            window=diff_travel_dist_local, generator=generator, sample_draws=sample_draws,
            append_uniform=append_uniform, colors=colors, sem_labels=sem_labels,
            inplace=False,
        )
        start(f)
        for name, stage in stages:
            with obs.span(name):
                stage(f)
        return _result(f)

    def draw(generator, normal, u_front, u_behind, uniform):
        """Fill the draw buffers from ``generator`` with the calls, and in
        the order, of the eager prep's own draws (``sample_rays``' three,
        then ``append_samples``' uniforms): the same numbers, and the
        generator left in the same state."""
        torch.randn(normal.shape, generator=generator, out=normal)
        torch.rand(u_front.shape, generator=generator, out=u_front)
        torch.rand(u_behind.shape, generator=generator, out=u_behind)
        torch.rand(uniform.shape, generator=generator, out=uniform)

    prep.start, prep.stages, prep.draw = start, stages, draw
    prep.draw_shapes = lambda n: (
        (surface_sample_n, n), (free_front_n, n), (free_behind_n, n),
        ((1 + surface_sample_n + free_front_n + free_behind_n) * n + 1,),
    )
    return prep


def _result(f) -> PrepResult:
    return PrepResult(
        f.map_state, f.local_map, f.pool, f.ins.new_ratio, f.new_sample_count,
        f.cur_sample_count, f.ins.dropped,
    )


# the map's tensors that prep reads or writes (the rest pass through)
_MAP_LEAVES = ("positions", "ts_create", "ts_update", "count", "hash_table", "hash_mirror",
               "certainty")


class GraphedPrep:
    """A tracked frame's map prep on the card, replayed from CUDA graphs;
    it computes what the eager prep does, to the bit, and reads nothing on
    the host.

    ``preps`` maps ``filter_pool_now`` to ``make_prep_fn``'s two variants.
    Each is captured at its first call (``StreamingSlam.precompile()`` makes
    both), through one ``graphs.Capture`` of this object's that both share:
    a warm-up, then one stage per nested span (``frame.prep.local_map``,
    ``.sample``, ``.insert``, ``.pool``), each replayed inside its span. The
    capture breaks at the row gathers (``ops/gather.py:gather_rows``, a hand
    kernel): each runs eagerly between two graphs, where the benchmark's
    launch recorder sees it. The warm-up runs on the frames' stream and
    gathers with the plain version, so a frame that captures launches the
    kernels of one that replays.

    The graphs write the local map, the map and the pool in place, into
    buffers of this object's, which the returned state holds. A call whose
    state holds other tensors (frame 0's, a prune's, a BA's, a
    checkpoint's, the mapping's new certainty and stamps) copies them in
    first, so a caller's older state stays as it was; a state that came out
    of a call is written over by the next. The frame's points, mask, pose,
    travel distances and id go to fixed buffers, and so do its random
    numbers, drawn from ``generator`` before the replays (``prep.draw``).
    A capture leaves the state it is given and its generator as they were.
    """

    def __init__(self, preps: dict, window):
        self.preps = preps
        self.window = window
        self.bufs = None  # {"map": {name: t}, "local": LocalMapState, "pool": ReplayPool, ...}
        self.graphs = {}  # filter_pool_now -> (frame namespace, [(span, steps)])
        self.capture = None  # the graphs.Capture both variants share

    def __call__(self, filter_pool_now, map_state, local_map, pool, points, mask, pose,
                 travel_dist, frame_id: int, generator) -> PrepResult:
        live = self._leaves(map_state, local_map, pool)
        if self.bufs is None:
            self._make_buffers(live, points, mask, pose, travel_dist)
        if filter_pool_now not in self.graphs:
            self._capture(filter_pool_now, live, generator)
        graphs.fill(self._state_bufs(), live)
        b = self.bufs
        b["points"].copy_(points)
        b["mask"].copy_(mask)
        b["pose"].copy_(pose)
        b["travel_dist"].copy_(travel_dist)
        b["frame_id"].fill_(frame_id)
        self.preps[filter_pool_now].draw(generator, *b["draws"])
        f, stages = self.graphs[filter_pool_now]
        for name, steps in stages:
            with obs.span(name):
                graphs.replay(steps)
        obs.count("prep.graph_frames")
        # the scalars are the graphs' own memory: the caller gets copies
        return PrepResult(
            replace(map_state, **b["map"]), b["local"], b["pool"], f.ins.new_ratio.clone(),
            f.new_sample_count.clone(), f.cur_sample_count.clone(), f.ins.dropped.clone(),
        )

    @staticmethod
    def _leaves(map_state, local_map, pool) -> list:
        return ([getattr(map_state, k) for k in _MAP_LEAVES] + local_map.tensors()
                + pool.tensors())

    def _state_bufs(self) -> list:
        b = self.bufs
        return self._leaves(SimpleNamespace(**b["map"]), b["local"], b["pool"])

    def _make_buffers(self, live, points, mask, pose, travel_dist):
        live = graphs.buffers(live)
        nmap = len(_MAP_LEAVES)
        n_local = len(lm.LocalMapState.__dataclass_fields__)
        any_prep = next(iter(self.preps.values()))
        dev = points.device
        self.bufs = dict(
            map=dict(zip(_MAP_LEAVES, live[:nmap])),
            local=lm.LocalMapState(*live[nmap:nmap + n_local]),
            pool=pl.ReplayPool(*live[nmap + n_local:]),
            points=points.clone(), mask=mask.clone(), pose=pose.clone(),
            travel_dist=travel_dist.clone(),
            frame_id=torch.zeros((), dtype=torch.int32, device=dev),
            draws=[torch.empty(s, dtype=torch.float32, device=dev)
                   for s in any_prep.draw_shapes(points.shape[0])],
        )

    def _frame(self) -> SimpleNamespace:
        b = self.bufs
        normal, u_front, u_behind, uniform = b["draws"]
        # the slabs prep does not touch are left out
        map_state = nm.NeuralMapState(quats=None, geo_feats=None, color_feats=None, **b["map"])
        return SimpleNamespace(
            map_state=map_state, local_map=b["local"], pool=b["pool"],
            points=b["points"], mask=b["mask"], pose=b["pose"], travel_dist=b["travel_dist"],
            frame_id=b["frame_id"], window=self.window, generator=None,
            sample_draws=(normal, u_front, u_behind), append_uniform=uniform, colors=None,
            sem_labels=None, inplace=True,
        )

    def _capture(self, filter_pool_now, live, generator):
        prep = self.preps[filter_pool_now]
        state_bufs = self._state_bufs()
        # the buffers hold the live state once a call has returned them
        saved = ([x.clone() for x in state_bufs]
                 if any(x is buf for x, buf in zip(live, state_bufs)) else None)
        # the warm-up's numbers come from a copy: the generator stays put
        gen = torch.Generator(device=generator.device)
        gen.set_state(generator.get_state())
        prep.draw(gen, *self.bufs["draws"])

        def warm_up():  # on the frames' stream: no autograd runs in prep
            with gt.breaks(gt.gather_rows_reference):
                w = self._frame()
                prep.start(w)
                for _, stage in prep.stages:
                    stage(w)

        f = self._frame()
        (_, first), *rest = prep.stages
        stages = [lambda: (prep.start(f), first(f))] + [
            functools.partial(stage, f) for _, stage in rest]
        if self.capture is None:
            self.capture = graphs.Capture()
        steps = self.capture(stages, warm_up=warm_up, breaks=True)
        self.graphs[filter_pool_now] = (f, [(name, s) for (name, _), s in zip(prep.stages, steps)])
        if saved is not None:
            graphs.fill(state_bufs, saved)
