"""Streaming SLAM loop: the single-device frame step (port of
clid_slam_tpu/pipeline/streaming.py).

The whole recurrent state (IESEKF, odometry bookkeeping, neural map, local
label map, replay pool, decoder) lives on the device in ``StreamState``.
One frame = IMU propagation + iterated update (candidate-cached, or
re-querying the map each iteration with ``track_cached=False``) + the
dynamic filter (``dynamic_filter_on``, tracked frames) + map prep +
adaptive iteration count + mapping, with the host uploading the scan, the
IMU window and the frame's scalars as one buffer (``pack_frame_buffers``,
``pack_adapter``). Tracked frames map with the fused kernel
(``ops/map_loop.py``) or, where the config is ineligible for it, with the
mapper's autograd loop; frame 0 runs the general multi-batch body. After
the frame step, with ``ba_freq_frame > 0`` a sliding-window bundle
adjustment refines the last ``ba_frame`` poses and the map's features, and
with ``prune_map_on`` the map is pruned and rehashed every
``prune_freq_frame`` frames. ``save_checkpoint``/``load_checkpoint`` write
and read the whole state (the JAX package's file, plus the generator).
``precompile()`` runs every frame-step variant once on a throwaway clone
before frame 0, so that kernel builds and other first-use costs stay out
of the loop.
Frames come from in-memory arrays or, with ``points=None``, from the
config's directory of scans and IMU files (``self.dataset``, a
``SLAMDataset`` with no host filter); ``finalize`` writes the pose files
and ``metrics.json``.
Every option of the JAX frame step runs, decode-then-weight
(``weighted_first=False``), bf16 decoding (``mlp_bf16``) and the color and
semantic heads (``color_on``, ``semantic_on``) included; as in the JAX
frame step, the scan carries no per-point colors or classes, so the pool's
labels stay 0 and -1.

Host reads inside a frame: the iterated update reads its exit flag once
per iteration (on the card, after a replay of the iteration's CUDA graph,
captured in ``precompile()`` or at the first tracked frame), frame 0 reads its iteration count to size the outer
mapping loop, and a tracked frame on the autograd loop reads its step
count once. Everything else stays on the device until ``sync()``, but the
host still waits on the device where a step copies a host scalar or
constant to it, checks a linalg result or indexes with a device scalar:
the ``syncs`` counter below finds each such wait. On the card a tracked
frame's predict and bookkeep are one replay each of a CUDA graph
(``GraphedTrackStages``; every value that changes from frame to frame
enters through a device buffer filled before the replay) that writes the
trajectory's row and the state's small leaves in place, and its map prep
is a replay of CUDA graphs (``mapping/prep.py:GraphedPrep``) that writes
the map, the local map and the pool in place; both are captured in
``precompile()`` or at the first tracked frame. Predict, bookkeep, prep,
the adaptive step count and the fused kernel's mapping step wait for
nothing. Frame 0, the CPU and injected ``draws`` run the eager stages,
with the frame's values in device scalars all the same.

While torch's profiler records, ``process_frame`` runs under spans and
counters (``utils/observability.py``; no setting, and one flag check a
span when nothing records). Its top-level ranges, in order and never
nested in one another, each with the frame id as ``args``:
``frame.ingest`` (the scan's read, the adaptive crop range, the subsample,
the pack), ``frame.upload`` (the buffer's copy to the device),
``frame.predict`` (the masks, the IMU propagation, the source points),
``frame.track`` (the iterated update), ``frame.bookkeep`` (the pose, the
stop and lose-track flags, the deskew), ``frame.filter``, ``frame.prep``,
``frame.iters`` (the adaptive step count), ``frame.map`` and ``ba``; what
lies between them is host work of well under a millisecond. Nested
ranges: ``frame.track.candidates``, ``frame.track.iter`` (one an IESEKF
iteration), ``frame.prep.local_map``, ``frame.prep.sample``,
``frame.prep.insert``, ``frame.prep.pool`` and ``frame.map.cache``.
Counters: ``frames``, ``track.iters``, ``map.steps`` and, on the card,
``track.graph_iters``, ``track.graph_flops``, ``predict.graph_frames``,
``prep.graph_frames`` and ``syncs`` with ``syncs.<top-level range>`` and
``syncs.unspanned``.
"""

from __future__ import annotations

import functools
import os
import warnings
from dataclasses import dataclass, fields, is_dataclass, replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device, scalar
from ..mapping import mapper as mp
from ..mapping import pool as pl
from ..mapping import prep as prp
from ..mapping.bundle_adjustment import make_ba_fn
from ..mapping.dynamic_filter import make_dynamic_filter_fn
from ..models import decoder as dec
from ..models import local_map as lm
from ..models import neural_map as nm
from ..odometry import iekf
from ..ops import _build
from ..ops.encoding import make_encoder
from ..ops.scatter import compact_indices
from ..ops.voxel import neighbor_offsets, voxel_down_sample_mask
from ..utils import observability as obs
from ..utils.transforms import adaptive_crop_range, crop_mask, deskew

G_M_S2 = iekf.G_M_S2
IMU_MAX_ROWS = 64  # static IMU-row bucket (100-640 Hz IMU at 10 Hz LiDAR)


@dataclass
class StreamState:
    rot: torch.Tensor  # [3,3]
    pos: torch.Tensor  # [3]
    rest: torch.Tensor  # [12] vel, bg, ba, grav
    P: torch.Tensor  # [18,18]
    last_pose: torch.Tensor  # [4,4]
    odom_poses: torch.Tensor  # [T,4,4]
    travel_dist: torch.Tensor  # [T]
    lose_track: torch.Tensor  # bool
    consec_lose: torch.Tensor  # i32
    stop_count: torch.Tensor  # i32
    stop_status: torch.Tensor  # bool
    failed: torch.Tensor  # bool
    map_state: nm.NeuralMapState
    local_map: lm.LocalMapState
    pool: pl.ReplayPool
    mlp: dec.MLPParams
    color_mlp: dec.MLPParams
    sem_mlp: dec.MLPParams
    key: torch.Generator  # the JAX state's PRNG key slot
    losses: torch.Tensor  # [T,2]
    track_iters: torch.Tensor  # [T] i32

    def leaves(self) -> list:
        """The state in the JAX package's leaf order (``tree_leaves`` of
        its ``StreamState``); the key slot holds the generator."""
        return [
            self.rot, self.pos, self.rest, self.P, self.last_pose, self.odom_poses,
            self.travel_dist, self.lose_track, self.consec_lose, self.stop_count,
            self.stop_status, self.failed, *self.map_state.tensors(),
            *self.local_map.tensors(), *self.pool.tensors(), *self.mlp.tensors(),
            *self.color_mlp.tensors(), *self.sem_mlp.tensors(), self.key, self.losses,
            self.track_iters,
        ]


def clone_state(state):
    """A deep copy of ``state`` (a ``StreamState`` or any of its parts):
    every tensor copied, and a generator replaced by a new one on its
    device in the same state, so that work on the copy moves neither the
    original's tensors nor its draws."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, torch.Generator):
        gen = torch.Generator(device=state.device)
        gen.set_state(state.get_state())
        return gen
    if isinstance(state, list):
        return [clone_state(x) for x in state]
    if is_dataclass(state):
        return replace(state, **{f.name: clone_state(getattr(state, f.name))
                                 for f in fields(state)})
    return state


def pack_adapter(step, p_cap: int, imu_max_rows: int):
    """Wrap a frame step (``make_frame_step``'s call) into the one-buffer
    convention ``packed(state, frame_pack, draws=None)``, ``frame_pack``
    the host buffer of ``pack_frame_buffers``: the scan block [p_cap,5]
    (x, y, z, mask, point_ts), then the aux block [imu_max_rows+1,7] whose
    first rows are the IMU rows (dt, acc, gyro) and whose last row carries
    the frame scalars (frame_id, imu_count, crop_max_range, iters_base,
    mlp_lr_scale, allow_restart, 0). The buffer goes to the state's device
    in one copy and the step gets views of it; the scalars are read from
    the host buffer, so they cost no read from the device."""
    scan_n = p_cap * 5

    def packed(state: StreamState, frame_pack: np.ndarray, draws: Optional[dict] = None):
        host = np.asarray(frame_pack, np.float32)
        s = host[scan_n:].reshape(imu_max_rows + 1, 7)[-1]
        with obs.span("frame.upload", str(int(s[0]))):
            buf = torch.from_numpy(host).to(state.rot.device)
            scan = buf[:scan_n].reshape(p_cap, 5)
            aux = buf[scan_n:].reshape(imu_max_rows + 1, 7)
            pmask = scan[:, 3] > 0.5
        return step(
            state, int(s[0]), scan[:, :3], pmask, scan[:, 4], aux[:-1], int(s[1]),
            float(s[2]), int(s[3]), float(s[4]), bool(s[5] > 0.5), draws,
        )

    return packed


def pack_frame_buffers(
    p_cap: int,
    imu_max_rows: int,
    points,  # [n,3] np
    point_ts,  # [n] np or None
    imu_window,  # [k,7] np or None
    frame_id: int,
    crop_max_range: float,
    iters_base: int,
    mlp_lr_scale: float,
    allow_restart: bool,
) -> np.ndarray:
    """The host buffer of ``pack_adapter``'s convention (the JAX package's
    layout): the first ``p_cap`` points and ``imu_max_rows`` IMU rows."""
    n = min(points.shape[0], p_cap)
    pack = np.zeros(p_cap * 5 + (imu_max_rows + 1) * 7, np.float32)
    scan = pack[: p_cap * 5].reshape(p_cap, 5)
    aux = pack[p_cap * 5 :].reshape(imu_max_rows + 1, 7)
    scan[:n, :3] = points[:n, :3]
    scan[:n, 3] = 1.0
    if point_ts is not None:
        scan[:n, 4] = np.asarray(point_ts, np.float32).reshape(-1)[:n]
    k = 0
    if imu_window is not None and len(imu_window):
        k = min(len(imu_window), imu_max_rows)
        aux[:k] = imu_window[:k]
    aux[-1, :6] = (
        float(frame_id),
        float(k),
        float(crop_max_range),
        float(iters_base),
        float(mlp_lr_scale),
        1.0 if allow_restart else 0.0,
    )
    return pack


def _orthonormalize(R):
    """Project an almost-rotation back to SO(3) (Gram-Schmidt)."""
    a = R[:, 0] / torch.linalg.norm(R[:, 0])
    b = R[:, 1] - torch.dot(a, R[:, 1]) * a
    b = b / torch.linalg.norm(b)
    c = torch.linalg.cross(a, b, dim=0)
    return torch.stack([a, b, c], dim=1)


def _pose(rot, pos):
    T = torch.eye(4, device=rot.device)
    T[:3, :3] = rot
    T[:3, 3] = pos
    return T


def _inv(T):
    """``torch.linalg.inv(T)`` without its error check, which waits for the
    device (``inv`` is ``inv_ex`` and that check)."""
    return torch.linalg.inv_ex(T)[0]


def _max_valid_dist2(cfg: Config) -> float:
    return 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2


def mapping_kwargs(cfg: Config, nb_offs, encode_vecs) -> dict:
    """``mapper.make_mapping_fn``'s arguments for ``cfg``, as the frame step
    builds frame 0's general body (tracked frames add ``max_outer=1``)."""
    return dict(
        feature_dim=cfg.feature_dim,
        knn_k=cfg.query_nn_k,
        nb_offs=nb_offs,
        resolution=cfg.voxel_size_m,
        max_valid_dist2=_max_valid_dist2(cfg),
        sdf_scale=cfg.sdf_scale,
        sigma=cfg.sdf_scale,
        loss_type=cfg.main_loss_type,
        bs=cfg.bs,
        bs_new=cfg.bs_new_sample,
        gradient_decimation=cfg.gradient_decimation,
        num_grad_eps=cfg.num_grad_eps,
        weight_e=cfg.weight_e,
        loss_weight_on=cfg.loss_weight_on,
        lr=cfg.lr,
        adam_eps=cfg.adam_eps,
        mlp_leaky=cfg.mlp_leaky_relu,
        mlp_bf16=cfg.mlp_bf16,
        color_on=cfg.color_on,
        sem_on=cfg.semantic_on,
        weight_i=cfg.weight_i,
        weight_s=cfg.weight_s,
        surface_sample_range_m=cfg.surface_sample_range_m,
        encode_vecs=encode_vecs,
        weighted_first=cfg.weighted_first,
        layer_norm=cfg.layer_norm_on,
        resample_every=cfg.map_resample_every,
    )


def prep_kwargs(cfg: Config) -> dict:
    """``prep.make_prep_fn``'s arguments for ``cfg`` but ``filter_pool_now``."""
    return dict(
        resolution=cfg.voxel_size_m,
        local_resolution=cfg.local_voxel_size_m,
        local_map_size=cfg.local_map_size,
        window_radius=cfg.window_radius,
        surface_sample_range_m=cfg.surface_sample_range_m,
        surface_sample_n=cfg.surface_sample_n,
        free_front_n=cfg.free_front_n,
        free_behind_n=cfg.free_behind_n,
        free_sample_begin_ratio=cfg.free_sample_begin_ratio,
        free_sample_end_dist_m=cfg.free_sample_end_dist_m,
        max_range=cfg.max_range,
        dist_weight_on=cfg.dist_weight_on,
        dist_weight_scale=cfg.dist_weight_scale,
        map_surface_ratio=cfg.map_surface_ratio,
        from_sample_points=cfg.from_sample_points,
        new_certainty_thre=cfg.new_certainty_thre,
        novelty_on=cfg.bs_new_sample > 0,
        novelty_mode=cfg.novelty_mode,
        pin_mode=cfg.use_pin_mapper,
        behind_dropoff_on=cfg.behind_dropoff_on,
        incidence_label_on=cfg.incidence_label_on,
        incidence_min_factor=cfg.incidence_min_factor,
        incidence_degenerate_factor=cfg.incidence_degenerate_factor,
        free_behind_weight=cfg.resolved_free_behind_weight(),
    )


def predict_imu(cfg: Config, rot, pos, rest, P, imu_rows, imu_count):
    """The IESEKF's IMU propagation over a frame's rows on the device:
    (rot, pos, rest, P) after it; ``imu_count``, the live rows, an int or
    a device scalar."""
    f32 = dict(dtype=torch.float32, device=rot.device)
    Q = torch.zeros((12, 12), **f32)
    I3 = torch.eye(3, **f32)
    Q[0:3, 0:3] = cfg.measurement_noise_covariance * I3
    Q[3:6, 3:6] = cfg.measurement_noise_covariance * I3
    Q[6:9, 6:9] = cfg.bias_noise_covariance * I3
    Q[9:12, 9:12] = cfg.bias_noise_covariance * I3
    rot, pos, vel, bg, ba, grav, P = iekf.device_predict_imu(
        rot, pos, rest[0:3], rest[3:6], rest[6:9], rest[9:12], P, Q, imu_rows, imu_count,
    )
    return rot, pos, torch.cat([vel, bg, ba, grav]), P


def source_indices(cfg: Config, points, train_mask, scale):
    """The tracker's source points: (indices [S] into ``points``, their
    mask [S]) of the voxel keep-mask at ``source_vox_down_m`` within
    ``track_max_range``."""
    S = cfg.max_source_points
    src_mask = voxel_down_sample_mask(
        points, train_mask, scale * cfg.source_vox_down_m, cfg.map_hash_size
    )
    if cfg.track_max_range > 0:
        src_mask = src_mask & (torch.linalg.norm(points, dim=-1) <= cfg.track_max_range)
    n_src = torch.sum(src_mask.to(torch.int32))
    return compact_indices(src_mask, S), torch.arange(S, device=points.device) < n_src


def track_bookkeeping(cfg: Config, state: StreamState, pose, ok):
    """The stop, lose-track and failure flags after a tracked frame at
    ``pose``: (stop_count, stop_status, lose_track, consec_lose, failed,
    the relative transform from the last pose, its translation norm)."""
    last_tran = _inv(state.last_pose) @ pose
    tran_norm = torch.linalg.norm(last_tran[:3, 3])
    I3 = torch.eye(3, device=pose.device)
    near_I = torch.all(torch.abs(last_tran[:3, :3] - I3) < 1e-3) & torch.all(
        torch.abs(last_tran[:3, 3]) < cfg.voxel_size_m * 0.1
    )
    stop_count = torch.where(near_I, state.stop_count + 1, torch.zeros_like(state.stop_count))
    stop_status = stop_count > cfg.stop_frame_thre
    too_big = tran_norm > cfg.surface_sample_range_m * 40.0
    lose_track = ~ok | too_big
    consec_lose = torch.where(
        lose_track, state.consec_lose + 1, torch.zeros_like(state.consec_lose)
    )
    failed = state.failed | too_big | (consec_lose > 10)
    return stop_count, stop_status, lose_track, consec_lose, failed, last_tran, tran_norm


def adaptive_iters(cfg: Config, iters_base: int, new_count, cur_count, allow_restart: bool,
                   stop_status):
    """The frame's mapping steps on the device (utils/mapper.py:446-459):
    ``iters_base`` moved by the share of new samples, 10 fewer on a stop,
    at least 1."""
    iters = torch.full((), iters_base, dtype=torch.int32, device=stop_status.device)
    if cfg.adaptive_iters and cfg.bs_new_sample > 0:
        ratio = new_count / torch.clamp(cur_count, min=1)
        offset = torch.where(
            ratio < cfg.new_sample_ratio_less,
            torch.full_like(iters, -5),
            torch.where(
                ratio > cfg.new_sample_ratio_more,
                torch.where(
                    allow_restart & (ratio > cfg.new_sample_ratio_restart),
                    torch.full_like(iters, 10),
                    torch.full_like(iters, 5),
                ),
                torch.zeros_like(iters),
            ),
        )
        iters = iters + offset
    iters = torch.where(stop_status, iters - 10, iters)
    return torch.clamp(iters, min=1)


# the state's leaves that frame.predict and frame.bookkeep read or write
TRACK_LEAVES = ("rot", "pos", "rest", "P", "last_pose", "odom_poses", "travel_dist",
                "lose_track", "consec_lose", "stop_count", "stop_status", "failed",
                "track_iters")
_SCAN = ("points", "pmask", "point_ts", "imu_rows")  # a frame's scan and IMU rows


def predict_stage(cfg: Config, f, track: bool):
    """``frame.predict`` on a frame ``f``, a namespace of tensors: the scan
    (``points``, ``pmask``, ``point_ts``), ``imu_rows``, the device scalars
    ``crop`` (f32, the crop range) and ``imu_count`` (i64), and the state's
    ``TRACK_LEAVES``. Sets ``f.train_mask`` (the crop and the training
    voxel keep-mask) and, when tracking, ``f.pred`` (rot, pos, rest, P
    after the IMU propagation) and the tracker's source points
    ``f.src_pts`` (deskewed with ``cfg.deskew``) and ``f.smask``. No value
    of the frame enters as a Python number, so one CUDA graph of it serves
    every frame."""
    pmask = f.pmask & crop_mask(f.points, cfg.min_z, cfg.max_z, cfg.min_range, f.crop)
    scale = f.crop / cfg.max_range
    f.train_mask = voxel_down_sample_mask(f.points, pmask, scale * cfg.vox_down_m,
                                          cfg.map_hash_size)
    if not track:
        return
    rot, pos, rest, P = predict_imu(cfg, f.rot, f.pos, f.rest, f.P, f.imu_rows, f.imu_count)
    src_idx, f.smask = source_indices(cfg, f.points, f.train_mask, scale)
    src_pts = f.points[src_idx]
    if cfg.deskew:
        rel = _inv(f.last_pose) @ _pose(rot, pos)
        src_pts = deskew(src_pts, f.point_ts[src_idx], rel)
    f.pred, f.src_pts = (rot, pos, rest, P), src_pts


def bookkeep_stage(cfg: Config, f, track: bool):
    """``frame.bookkeep`` on a frame ``f`` after ``predict_stage``, with its
    row ``f.fid`` (a [1] i64 device index) and, when tracking, ``f.trk``,
    the tracker's (rot, pos, rest, P, ok, n_iter). Writes that row of
    ``f.odom_poses``, ``f.travel_dist`` and, when tracking,
    ``f.track_iters`` in place, and sets ``f.new`` (the state's
    ``TRACK_LEAVES`` after the frame), ``f.map_points`` (the points the
    map trains on, deskewed where it trains with ``cfg.deskew``) and
    ``f.valid_mapping``."""
    prev = torch.clamp(f.fid - 1, min=0)
    new = {k: getattr(f, k) for k in TRACK_LEAVES}
    f.map_points = f.points
    if track:
        rot, pos, rest, P, ok, n_iter = f.trk
        rot = _orthonormalize(rot)
        f.track_iters.index_copy_(0, f.fid, n_iter.reshape(1).to(f.track_iters.dtype))
        pose = _pose(rot, pos)
        (stop_count, stop_status, lose_track, consec_lose, failed, last_tran,
         tran_norm) = track_bookkeeping(cfg, f, pose, ok)
        f.travel_dist.index_copy_(0, f.fid, f.travel_dist.index_select(0, prev) + tran_norm)
        new.update(rot=rot, pos=pos, rest=rest, P=P, stop_count=stop_count,
                   stop_status=stop_status, lose_track=lose_track, consec_lose=consec_lose,
                   failed=failed)
        if cfg.deskew:
            full = deskew(f.points, f.point_ts, last_tran)
            f.map_points = torch.where(f.train_mask[:, None], full, f.points)
    else:
        pose = _pose(f.rot, f.pos)
        f.travel_dist.index_copy_(0, f.fid, f.travel_dist.index_select(0, prev))
    f.odom_poses.index_copy_(0, f.fid, pose[None])
    new["last_pose"] = pose
    f.new = new
    # map prep is gated by tracking validity (a lost or stopped frame must
    # not corrupt the map)
    f.valid_mapping = ~new["lose_track"] & ~new["stop_status"]


def eager_frame(state: StreamState, frame_id: int, points, pmask, point_ts, imu_rows,
                imu_count: int, crop_max_range: float, track: bool) -> SimpleNamespace:
    """A frame for the stages run eagerly: the frame's values filled into
    device scalars on the device (no host copy to wait for), the state's
    leaves, and copies of the arrays whose row the frame writes."""
    dev = points.device
    f = SimpleNamespace(
        points=points, pmask=pmask, point_ts=point_ts, imu_rows=imu_rows,
        crop=scalar(crop_max_range, torch.float32, dev),
        imu_count=scalar(imu_count, torch.int64, dev),
        fid=torch.full((1,), frame_id, dtype=torch.int64, device=dev),
        **{k: getattr(state, k) for k in TRACK_LEAVES},
    )
    for k in ("odom_poses", "travel_dist") + (("track_iters",) if track else ()):
        setattr(f, k, getattr(f, k).clone())
    return f


def _like(x):
    """A copy of ``x`` with its shape and strides (a strided view of the
    upload gets a buffer strided as it is)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)


def _graph(stage, mem) -> torch.cuda.CUDAGraph:
    """``stage()`` captured as a CUDA graph in the memory pool ``mem``;
    thread-local, as the tracker's graph (another thread's CUDA call
    neither fails nor invalidates it)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=mem, capture_error_mode="thread_local"):
        stage()
    return graph


class GraphedTrackStages:
    """A tracked frame's ``frame.predict`` and ``frame.bookkeep`` on the
    card: one replay each of a CUDA graph of ``predict_stage`` and of
    ``bookkeep_stage``, which compute what the eager stages do, to the bit
    (the same kernels on the same layouts), and read nothing on the host.

    The graphs are captured at the first call for a key of the inputs'
    shapes, strides, dtypes and device (``StreamingSlam.precompile()``
    makes it): a warm-up on a side stream, then both graphs in one memory
    pool, in the order they replay. A capture leaves the state it is given
    as it was (the graphs work on buffers of their own; nothing here draws
    from a generator).

    Everything that changes from frame to frame enters through a buffer
    written before the replay: the scan and the IMU rows (copied into
    buffers strided as the upload's views), the crop range, the IMU count
    and the frame id (filled on the device), the state's
    ``TRACK_LEAVES`` (copied in where the state holds other tensors), and
    the tracker's outputs (copied in before bookkeep). Bookkeep writes the
    frame's rows of the trajectory, the travel distances and the iteration
    counts, and the state's other leaves, in place into the state's
    buffers, after its last read of them; the returned frame's ``new``
    holds those buffers. So an older state that holds other tensors (a
    clone, an eager frame's, a checkpoint's, a BA's) stays as it was, and
    a state that came out of a call is written over by the next.

    A replay dispatches no operation for a profiler to count: while
    tracing, each frame counts its stages' operations in
    ``track.graph_flops``, those of one eager run on copies of the
    buffers, counted when the counters are read (``odometry/iekf.py:
    flops_of``)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.frames = {}  # the inputs' key -> the frame namespace its graphs work on

    def predict(self, state: StreamState, frame_id: int, points, pmask, point_ts, imu_rows,
                imu_count: int, crop_max_range: float) -> SimpleNamespace:
        """Replay ``frame.predict``: the returned frame holds its outputs
        (see ``predict_stage``) until the next call."""
        scan = (points, pmask, point_ts, imu_rows)
        leaves = [getattr(state, k) for k in TRACK_LEAVES]
        key = tuple((x.shape, x.stride(), x.dtype, x.device) for x in (*scan, *leaves))
        f = self.frames.get(key)
        if f is None:
            f = self.frames[key] = self._capture(scan, leaves)
        for x, buf in zip(leaves, f.bufs.values()):
            if x is not buf:
                buf.copy_(x)
        for k, x in zip(_SCAN, scan):
            getattr(f, k).copy_(x)
        f.crop.fill_(crop_max_range)
        f.imu_count.fill_(imu_count)
        f.fid.fill_(frame_id)
        f.graphs[0].replay()
        return f

    def bookkeep(self, f: SimpleNamespace, trk):
        """Replay ``frame.bookkeep`` of the frame ``predict`` returned, after
        the tracker's ``trk`` (rot, pos, rest, P, ok, n_iter)."""
        for buf, x in zip(f.trk, trk):
            buf.copy_(x)
        f.graphs[1].replay()
        obs.count("predict.graph_frames")
        obs.count("track.graph_flops", f.flops)

    def _capture(self, scan, leaves) -> SimpleNamespace:
        cfg = self.cfg
        dev = scan[0].device
        state = {k: _like(x) for k, x in zip(TRACK_LEAVES, leaves)}
        inputs = dict(
            zip(_SCAN, [_like(x) for x in scan]), **state,
            crop=torch.full((), cfg.max_range, dtype=torch.float32, device=dev),
            imu_count=torch.zeros((), dtype=torch.int64, device=dev),
            fid=torch.ones(1, dtype=torch.int64, device=dev),
            trk=[state[k].clone() for k in ("rot", "pos", "rest", "P")] + [
                torch.ones((), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev)],
        )
        f = SimpleNamespace(**inputs, bufs=state)

        def predict():
            predict_stage(cfg, f, True)

        def bookkeep():
            bookkeep_stage(cfg, f, True)
            for k, buf in state.items():  # after the stage's last read of the state
                if f.new[k] is not buf:
                    buf.copy_(f.new[k])

        with torch.cuda.device(dev):
            # cuBLAS's per-stream workspaces cleared around each phase, as
            # for the tracker's graph (odometry/iekf.py:_GraphedIterations)
            torch._C._cuda_clearCublasWorkspaces()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                predict()
                bookkeep()
            torch.cuda.current_stream().wait_stream(side)
            torch._C._cuda_clearCublasWorkspaces()
            mem = torch.cuda.graph_pool_handle()
            f.graphs = (_graph(predict, mem), _graph(bookkeep, mem))
            torch._C._cuda_clearCublasWorkspaces()
        f.new = state  # what the step reads after a replay
        counted = []

        def flops() -> int:
            if not counted:
                g = SimpleNamespace(**{k: v.clone() if isinstance(v, torch.Tensor)
                                       else [t.clone() for t in v] for k, v in inputs.items()})
                with torch.cuda.device(dev):
                    counted.append(sum(iekf.flops_of(lambda: (
                        predict_stage(cfg, g, True), bookkeep_stage(cfg, g, True))).values()))
            return counted[0]

        f.flops = flops
        return f


def make_frame_step(cfg: Config, nb_offs, encode_vecs):
    """The four frame-step variants keyed by (track, filter_pool_now):
    step(state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
    crop_max_range, iters_base, mlp_lr_scale, allow_restart) -> (state,
    insert_dropped, filtered); ``filtered`` is None or the [2] counts of
    points the map trains on before and after the dynamic filter."""
    max_valid_dist2 = _max_valid_dist2(cfg)
    max_sdf_std = cfg.surface_sample_range_m * cfg.max_sdf_std_ratio
    window = cfg.diff_travel_dist_local
    n_cand = cfg.track_n_cand or max(16, cfg.query_nn_k * 2)
    make_update = (
        functools.partial(iekf.make_cached_update_fn, n_cand=n_cand)
        if cfg.track_cached
        else iekf.make_update_iterated_fn
    )
    update = make_update(
        knn_k=cfg.query_nn_k,
        nb_offs=nb_offs,
        resolution=cfg.voxel_size_m,
        max_valid_dist2=max_valid_dist2,
        sdf_scale=cfg.sdf_scale,
        min_grad_norm=cfg.reg_min_grad_norm,
        max_grad_norm=cfg.reg_max_grad_norm,
        min_nn_count=cfg.track_mask_query_nn_k,
        max_iteration=cfg.reg_iter_n,
        term_thre_deg=cfg.reg_term_thre_deg,
        term_thre_m=cfg.reg_term_thre_m,
        mlp_leaky=cfg.mlp_leaky_relu,
        mlp_bf16=cfg.mlp_bf16,
        encode_vecs=encode_vecs,
        weighted_first=cfg.weighted_first,
        layer_norm=cfg.layer_norm_on,
        max_sdf_std=max_sdf_std,
        stagnation_iter=cfg.stagnation_iter,
        info_scale=cfg.tracker_info_scale,
    )
    map_kw = mapping_kwargs(cfg, nb_offs, encode_vecs)
    mapping_body = mp.make_mapping_fn(**map_kw)
    mapping_body_fast = mp.make_mapping_fn(
        **dict(
            map_kw,
            resample_every=max(cfg.map_resample_every, cfg.iters + 10),
            max_outer=1,
            dup_independent=cfg.map_dup_independent,
            use_pallas=cfg.map_pallas,
        )
    )
    prep_bodies = {
        fp: prp.make_prep_fn(filter_pool_now=fp, **prep_kwargs(cfg)) for fp in (False, True)
    }
    # a tracked frame's prep on the card: replays, captured at each variant's first call
    graphed_prep = prp.GraphedPrep(prep_bodies, window)
    # a tracked frame's predict and bookkeep on the card: replays, shared by the variants
    graphed_track = GraphedTrackStages(cfg)
    dyn_filter = None
    if cfg.dynamic_filter_on:
        # without layer_norm, as the JAX frame step builds it (ROADMAP C4)
        dyn_filter = make_dynamic_filter_fn(
            knn_k=cfg.query_nn_k,
            nb_offs=nb_offs,
            resolution=cfg.voxel_size_m,
            max_valid_dist2=max_valid_dist2,
            sdf_scale=cfg.sdf_scale,
            certainty_thre=cfg.dynamic_certainty_thre,
            sdf_ratio_thre=cfg.dynamic_sdf_ratio_thre,
            mlp_leaky=cfg.mlp_leaky_relu,
            mlp_bf16=cfg.mlp_bf16,
            encode_vecs=encode_vecs,
        )

    def make_step(track: bool, filter_pool_now: bool):
        prep_body = prep_bodies[filter_pool_now]

        def step(
            state: StreamState,
            frame_id: int,
            points,  # [P,3] sensor frame, padded
            pmask,  # [P] bool
            point_ts,  # [P] in [0,1] (zeros when deskew is off)
            imu_rows,  # [K,7]
            imu_count: int,
            crop_max_range: float,
            iters_base: int,
            mlp_lr_scale: float,
            allow_restart: bool,
            draws: Optional[dict] = None,
        ):
            """``draws`` injects the frame's random numbers (keys "sample",
            "append", "batches": see prep and mapper) in place of the
            state's generator."""
            draws = draws or {}
            fid = str(frame_id)
            # on the card a tracked frame replays predict's and bookkeep's graphs
            graphed = track and points.is_cuda and not draws
            frame = (state, frame_id, points, pmask, point_ts, imu_rows, imu_count,
                     crop_max_range)
            with obs.span("frame.predict", fid):
                if graphed:
                    f = graphed_track.predict(*frame)
                else:
                    f = eager_frame(*frame, track)
                    predict_stage(cfg, f, track)
            trk = None
            if track:
                with obs.span("frame.track", fid):
                    trk = update(state.map_state, state.mlp, f.src_pts, f.smask, *f.pred,
                                 f.travel_dist, frame_id, window)
            with obs.span("frame.bookkeep", fid):
                if graphed:
                    graphed_track.bookkeep(f, trk)
                else:
                    f.trk = trk
                    bookkeep_stage(cfg, f, track)
            points, train_mask, pose = f.map_points, f.train_mask, f.new["last_pose"]
            travel_dist = f.new["travel_dist"]

            # dynamic-object filter (slam.py:170-176: tracked frames only):
            # drop measurements landing in confidently observed free space
            filtered = None
            if dyn_filter is not None and track:
                with obs.span("frame.filter", fid):
                    world = points @ pose[:3, :3].T + pose[:3, 3]
                    before = torch.sum(train_mask.to(torch.int32))
                    train_mask = dyn_filter(
                        state.map_state, state.mlp, world, train_mask,
                        travel_dist, frame_id, window,
                    )
                    filtered = torch.stack([before, torch.sum(train_mask.to(torch.int32))])

            with obs.span("frame.prep", fid):
                prep_mask = train_mask & f.valid_mapping
                if graphed:
                    res = graphed_prep(
                        filter_pool_now, state.map_state, state.local_map, state.pool,
                        points, prep_mask, pose, travel_dist, frame_id, state.key,
                    )
                else:
                    res = prep_body(
                        state.map_state, state.local_map, state.pool, points, prep_mask,
                        pose, travel_dist, frame_id, window, generator=state.key,
                        sample_draws=draws.get("sample"), append_uniform=draws.get("append"),
                    )

            with obs.span("frame.iters", fid):
                iters = adaptive_iters(cfg, iters_base, res.new_sample_count,
                                       res.cur_sample_count, allow_restart,
                                       f.new["stop_status"])

            map_fn = mapping_body_fast if track else mapping_body
            with obs.span("frame.map", fid):
                map_state, mlp, color_mlp, sem_mlp, loss2 = map_fn(
                    res.map_state, state.mlp, state.color_mlp, state.sem_mlp, res.pool,
                    travel_dist, frame_id, window, iters, mlp_lr_scale,
                    generator=state.key, batch_draws=draws.get("batches"),
                )
            losses = state.losses.clone()
            losses[frame_id] = loss2
            new_state = replace(
                state, **f.new,
                map_state=map_state, local_map=res.local_map, pool=res.pool,
                mlp=mlp, color_mlp=color_mlp, sem_mlp=sem_mlp, losses=losses,
            )
            return new_state, res.insert_dropped, filtered

        return step

    return {(tr, fp): make_step(tr, fp) for tr in (False, True) for fp in (False, True)}


def make_ba_step(cfg: Config, nb_offs, encode_vecs):
    """Sliding-window bundle adjustment as a device step: refine the last
    ``ba_frame`` poses and the map's features, write the corrected poses
    into the trajectory and re-express the replay pool's world coords. The
    IESEKF state stays as it is (the reference's does too).
    ``ba_step(state, frame_id) -> state``."""
    w = cfg.ba_frame
    ba_fn = make_ba_fn(
        knn_k=cfg.query_nn_k,
        nb_offs=nb_offs,
        resolution=cfg.voxel_size_m,
        max_valid_dist2=_max_valid_dist2(cfg),
        sdf_scale=cfg.sdf_scale,
        window_size=w,
        ba_bs=cfg.ba_bs,
        lr_pose=cfg.lr_pose,
        lr_map=cfg.lr,
        adam_eps=cfg.adam_eps,
        mlp_leaky=cfg.mlp_leaky_relu,
        mlp_bf16=cfg.mlp_bf16,
        encode_vecs=encode_vecs,
    )

    def ba_step(state: StreamState, frame_id: int) -> StreamState:
        lo = max(frame_id - w + 1, 0)
        start = min(lo, state.odom_poses.shape[0] - w)  # jax.lax.dynamic_slice's clamp
        map_state, new_poses, _ = ba_fn(
            state.map_state, state.mlp, state.pool, state.odom_poses[start : start + w], lo,
            state.travel_dist, frame_id, cfg.diff_travel_dist_local, cfg.ba_iters,
            generator=state.key,
        )
        odom = state.odom_poses.clone()
        odom[start : start + w] = new_poses
        pool = pl.retransform_coords(state.pool, state.odom_poses, odom)
        return replace(
            state, map_state=map_state, odom_poses=odom, pool=pool,
            last_pose=odom[frame_id].clone(),
        )

    return ba_step


class StreamingSlam:
    """Host driver of the device-resident loop. ``device=None`` means the
    CUDA card; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: Config, total_frames: int = 1024, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.total_frames = total_frames
        self.nb_offs = neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
        self.encode_vecs, _ = make_encoder(
            num_bands=cfg.pos_encoding_band,
            freq=cfg.pos_encoding_freq,
            base=cfg.pos_encoding_base,
            use_gaussian=cfg.use_gaussian_pe,
            input_dim=cfg.pos_input_dim,
            seed=cfg.seed,
        )
        self.steps = self._make_steps()
        self._ba_step = (
            make_ba_step(cfg, self.nb_offs, self.encode_vecs) if cfg.ba_freq_frame > 0 else None
        )
        from .dataset import SLAMDataset

        self.dataset = SLAMDataset(cfg, tracker=None, min_frames=total_frames, device=self.device)
        self.imu_max_rows = IMU_MAX_ROWS
        self._init_state()
        self.processed = 0
        # insert candidates dropped by the pre-probe compaction (all frames)
        self.insert_dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        # (frame_id, point count before, after) of every prune, and of every
        # dynamic filter (points the map trains on); the counts stay device
        # scalars until sync()
        self.prune_log = []
        self.filter_log = []
        # (frame_id, start, end) of every BA call: CUDA events around it on
        # the card (read in sync()), None on the CPU
        self.ba_log = []

    # factory hooks (StreamingShardedSlam overrides both: a sharded map and a
    # collective frame step over the same StreamState)
    def _make_steps(self):
        return make_frame_step(self.cfg, self.nb_offs, self.encode_vecs)

    def _init_map_state(self) -> nm.NeuralMapState:
        cfg = self.cfg
        return nm.init_map(
            cfg.map_capacity, cfg.map_hash_size, cfg.feature_dim,
            cfg.feature_dim if cfg.color_on else 1, device=self.device,
        )

    def _init_state(self):
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        d_in = cfg.feature_dim + cfg.position_dim
        mlp = dec.init_mlp(
            gen, d_in, cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1, cfg.mlp_bias_on
        )
        color_mlp = dec.init_mlp(
            gen, d_in, cfg.color_mlp_hidden_dim, cfg.color_mlp_level,
            max(cfg.color_channel, 1), cfg.mlp_bias_on,
        )
        sem_mlp = dec.init_mlp(
            gen, d_in, cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level,
            cfg.sem_class_count if cfg.semantic_on else 1, cfg.mlp_bias_on,
        )
        P = np.eye(18, dtype=np.float32)
        P[9:12, 9:12] *= 1e-4
        P[12:15, 12:15] *= 1e-3
        P[15:18, 15:18] *= 1e-4
        rest = np.zeros(12, np.float32)
        rest[9:12] = cfg.init_gravity or [0.0, 0.0, -G_M_S2]
        if cfg.init_bg is not None:
            rest[3:6] = cfg.init_bg
        if cfg.init_ba is not None:
            rest[6:9] = cfg.init_ba
        T = self.total_frames
        t = lambda a: torch.as_tensor(a, device=dev)
        self.state = StreamState(
            rot=torch.eye(3, device=dev),
            pos=torch.zeros(3, device=dev),
            rest=t(rest),
            P=t(P),
            last_pose=torch.eye(4, device=dev),
            odom_poses=torch.eye(4, device=dev).repeat(T, 1, 1),
            travel_dist=torch.zeros(T, device=dev),
            lose_track=torch.zeros((), dtype=torch.bool, device=dev),
            consec_lose=torch.zeros((), dtype=torch.int32, device=dev),
            stop_count=torch.zeros((), dtype=torch.int32, device=dev),
            stop_status=torch.zeros((), dtype=torch.bool, device=dev),
            failed=torch.zeros((), dtype=torch.bool, device=dev),
            map_state=self._init_map_state(),
            local_map=lm.init_local_map(
                cfg.local_map_capacity, cfg.local_map_hash_size, device=dev
            ),
            pool=pl.init_pool(
                cfg.pool_capacity, cfg.max_scan_points * cfg.all_sample_n,
                max(cfg.color_channel, 1), device=dev,
            ),
            mlp=mlp,
            color_mlp=color_mlp,
            sem_mlp=sem_mlp,
            key=gen,
            losses=torch.zeros((T, 2), device=dev),
            track_iters=torch.zeros(T, dtype=torch.int32, device=dev),
        )

    def neural_point_count(self) -> int:
        return int(self.state.map_state.count)

    def precompile(self):
        """Run every frame-step variant (track on/off x pool filter on/off)
        once before frame 0, and the prune when ``prune_map_on``, each on a
        throwaway clone of the state, so that the one-time costs (the hand
        kernels' builds, the lazy loads of CUDA modules and library
        handles, a process group's first collectives) land here and not
        inside the odometry loop. The frame is the JAX package's: an empty
        scan, no IMU rows, frame 1, ``max_range``, ``iters``, learning-rate
        scale 1, no restart. The state, its generator and the host records
        stay as they were; the kernels' launch counts do count these
        launches. On the card the kernels not built yet build first, side
        by side."""
        cfg = self.cfg
        if self.device.type == "cuda":
            _build.build_all()
        pack = pack_frame_buffers(
            cfg.max_scan_points, self.imu_max_rows,
            np.zeros((0, 3), np.float32), None, None,
            1, cfg.max_range, cfg.iters, 1.0, False,
        )
        for step in self.steps.values():
            packed = pack_adapter(step, cfg.max_scan_points, self.imu_max_rows)
            packed(clone_state(self.state), pack)
        if cfg.prune_map_on:
            nm.prune_and_rehash(
                clone_state(self.state.map_state), cfg.max_prune_certainty,
                self.state.travel_dist, 0, cfg.diff_travel_dist_local, cfg.voxel_size_m,
            )
        self.block()

    def seed_pose(self, rot: np.ndarray, pos: np.ndarray, vel=None):
        """Anchor the initial pose (and optionally velocity) before frame 0."""
        dev = self.device
        st = self.state
        rest = st.rest.clone()
        if vel is not None:
            rest[0:3] = torch.as_tensor(np.asarray(vel, np.float32), device=dev)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rot
        T[:3, 3] = np.asarray(pos).reshape(3)
        self.state = replace(
            st,
            rot=torch.as_tensor(np.asarray(rot, np.float32), device=dev),
            pos=torch.as_tensor(np.asarray(pos, np.float32), device=dev),
            rest=rest,
            last_pose=torch.as_tensor(T, device=dev),
        )

    def process_frame(
        self,
        frame_id: int,
        points: Optional[np.ndarray] = None,
        imu_window: Optional[np.ndarray] = None,
        point_ts=None,
        draws: Optional[dict] = None,
    ):
        """One frame from in-memory arrays (sensor frame [N,3+], IMU rows
        [k,7] of (dt, acc, gyro), optional per-point timestamps) or, with
        ``points=None``, the scan and IMU window of ``frame_id`` read from
        the config's directories. ``draws`` injects the frame's random
        numbers (see make_frame_step)."""
        with obs.frame_scope(self.device):
            self._process_frame(frame_id, points, imu_window, point_ts, draws)

    def _process_frame(self, frame_id, points, imu_window, point_ts, draws):
        cfg = self.cfg
        d = self.dataset
        fid = str(frame_id)
        with obs.span("frame.ingest", fid):
            if points is None:
                d.read_frame(frame_id)
                imu_window = d.read_imu_window(frame_id)
            else:
                d.read_frame_arrays(np.asarray(points), point_ts)
            points, point_ts = d._raw_points, d._raw_ts
            crop_max_range = cfg.max_range
            if cfg.adaptive_range_on:
                crop_max_range = adaptive_crop_range(points, cfg.max_range)
            p_cap = cfg.max_scan_points
            n = points.shape[0]
            if n > p_cap:
                sel = np.random.default_rng(frame_id).permutation(n)[:p_cap]
                sel.sort()
                points = points[sel]
                point_ts = point_ts[sel] if point_ts is not None else None
            if imu_window is not None and len(imu_window) > self.imu_max_rows:
                warnings.warn(
                    f"frame {frame_id}: IMU window has {len(imu_window)} rows, "
                    f"truncating to imu_max_rows={self.imu_max_rows}",
                    RuntimeWarning,
                )
            track = cfg.track_on and frame_id > 0
            filter_now = (frame_id + 1) % cfg.pool_filter_freq == 0
            iters_base = cfg.iters * cfg.init_iter_ratio if frame_id == 0 else cfg.iters
            mlp_scale = 0.0 if frame_id >= cfg.freeze_after_frame else 1.0
            pack = pack_frame_buffers(
                p_cap, self.imu_max_rows, points, point_ts if cfg.deskew else None, imu_window,
                frame_id, crop_max_range, iters_base, mlp_scale,
                frame_id > cfg.freeze_after_frame,
            )
        step = pack_adapter(self.steps[(track, filter_now)], p_cap, self.imu_max_rows)
        self.state, dropped, filtered = step(self.state, pack, draws)
        self.insert_dropped = self.insert_dropped + dropped
        if filtered is not None:
            self.filter_log.append((frame_id, filtered[0], filtered[1]))

        # sliding-window BA cadence (no host read)
        if (
            self._ba_step is not None
            and frame_id >= cfg.ba_frame
            and (frame_id + 1) % cfg.ba_freq_frame == 0
        ):
            start = end = None
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            with obs.span("ba", fid):
                self.state = self._ba_step(self.state, frame_id)
            if end is not None:
                end.record()
            self.ba_log.append((frame_id, start, end))

        # prune cadence (no host read); the log keeps copies of the counts,
        # as the prep graphs write the map's count in place at a later frame
        if cfg.prune_map_on and (frame_id + 1) % cfg.prune_freq_frame == 0:
            before = self.state.map_state.count.clone()
            pruned = nm.prune_and_rehash(
                self.state.map_state, cfg.max_prune_certainty,
                self.state.travel_dist, frame_id, cfg.diff_travel_dist_local,
                cfg.voxel_size_m,
            )
            self.prune_log.append((frame_id, before, pruned.count.clone()))
            self.state = replace(self.state, map_state=pruned)
        self.processed = frame_id + 1

    def block(self):
        """Wait for all enqueued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_checkpoint(self, path: str):
        """Write the whole recurrent state as one compressed npz in the JAX
        package's format (``n_leaves``, ``processed``, ``leaf_i`` in its
        leaf order), plus the generator's state (``gen_state``) and the
        counters ``sync()`` reports, so that a resumed run continues
        exactly where this one stopped."""
        self.block()
        leaves = self._state_to_numpy()
        log = lambda entries: np.array(
            [(f, int(b), int(a)) for f, b, a in entries], np.int64
        ).reshape(-1, 3)
        self._write_checkpoint(path, dict(
            n_leaves=len(leaves),
            processed=self.processed,
            gen_state=self.state.key.get_state().numpy(),
            insert_dropped=int(self.insert_dropped),
            prune_log=log(self.prune_log),
            filter_log=log(self.filter_log),
            ba_frames=np.array([f for f, _, _ in self.ba_log], np.int64),
            **{f"leaf_{i}": v for i, v in enumerate(leaves)},
        ))

    # checkpoint hooks (StreamingShardedSlam overrides them: JAX's stacked
    # layout, written by one rank)
    def _state_to_numpy(self) -> list:
        from ..convert import stream_state_to_numpy

        return stream_state_to_numpy(self.state)

    def _state_from_numpy(self, leaves) -> StreamState:
        from ..convert import stream_state_from_numpy

        return stream_state_from_numpy(leaves, self.device)

    def _write_checkpoint(self, path: str, arrays: dict):
        np.savez_compressed(path, **arrays)

    def load_checkpoint(self, path: str):
        """Restore a ``save_checkpoint`` file of a system of the same
        config, and continue with ``process_frame`` from the frame after
        it. A file of the JAX package carries no generator state: the
        generator is then seeded from its key leaf, so the draws differ
        from the JAX run's."""
        with np.load(path) as z:
            n = int(z["n_leaves"])
            want = len(self.state.leaves())
            if n != want:
                raise ValueError(
                    f"checkpoint has {n} state leaves, this config builds {want} — config mismatch"
                )
            state = self._state_from_numpy([z[f"leaf_{i}"] for i in range(n)])
            if "gen_state" in z.files:
                state.key.set_state(torch.from_numpy(z["gen_state"]))
            dropped = int(z["insert_dropped"]) if "insert_dropped" in z.files else 0
            log = lambda key: [tuple(int(x) for x in r) for r in z[key]] if key in z.files else []
            self.prune_log, self.filter_log = log("prune_log"), log("filter_log")
            ba_frames = z["ba_frames"] if "ba_frames" in z.files else []
            self.ba_log = [(int(f), None, None) for f in ba_frames]
            self.processed = int(z["processed"])
        self.state = state
        self.insert_dropped = torch.tensor(dropped, dtype=torch.int64, device=self.device)

    def sync(self) -> dict:
        """Materialize results on the host, and write the poses and travel
        distances back into ``self.dataset``."""
        st = self.state
        n = self.processed
        out = {
            "odom_poses": st.odom_poses[:n].double().cpu().numpy(),
            "travel_dist": st.travel_dist[:n].double().cpu().numpy(),
            "losses": st.losses[:n].cpu().numpy(),
            "track_iters": st.track_iters[:n].cpu().numpy(),
            "failed": bool(st.failed),
            "lose_track": bool(st.lose_track),
            "neural_points": self.neural_point_count(),
            "insert_dropped": int(self.insert_dropped),
            "prunes": [(f, int(b), int(a)) for f, b, a in self.prune_log],
            "filtered": [(f, int(b), int(a)) for f, b, a in self.filter_log],
            # frames where BA ran, and the ms between the CUDA events around
            # each call (None on the CPU and for calls before a load_checkpoint)
            "ba_frames": [f for f, _, _ in self.ba_log],
            "ba_ms": [start.elapsed_time(end) if start is not None else None
                      for _, start, end in self.ba_log],
        }
        d = self.dataset
        d.odom_poses[:n] = out["odom_poses"]
        d.travel_dist[:n] = out["travel_dist"]
        d.processed_frame = n
        if n:
            d.cur_pose_ref = out["odom_poses"][n - 1]
        return out

    def finalize(self, run_path: str) -> dict:
        """``sync()``, then the pose files and ``metrics.json`` under
        ``run_path`` (``SLAMDataset.write_results``)."""
        os.makedirs(run_path, exist_ok=True)
        out = self.sync()
        result = self.dataset.write_results(run_path)
        result["neural_points"] = out["neural_points"]
        result["failed"] = out["failed"]
        return result
