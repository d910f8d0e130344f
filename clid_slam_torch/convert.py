"""Carry weights and state across from the JAX package as numpy arrays.

- ``mlp_from_numpy`` turns decoder params (weights [in, out] per hidden
  layer, biases, w_out, b_out) into the port's ``MLPParams``;
- ``stream_state_from_numpy`` takes the JAX ``StreamState`` leaves in tree
  order (the order of ``jax.tree_util.tree_leaves``, which
  ``StreamingSlam.save_checkpoint`` writes as leaf_0, leaf_1, ...) and
  builds the port's ``StreamState``, maps and pool included;
  ``stream_state_to_numpy`` is its inverse;
- ``classic_state_from_numpy`` carries a JAX ``SlamSystem``'s state (maps,
  pool, MLPs, the host filter, the dataset's poses) into the port's;
- ``sharded_map_from_numpy`` takes one rank's shard of a JAX sharded map
  (leaves with a leading [S] shard axis), ``sharded_map_to_numpy`` gives a
  rank's shard back as leaves without that axis;
- ``sharded_stream_state_{from,to}_numpy`` do the same for a whole
  ``StreamState`` of the sharded streaming driver, in the JAX package's
  layout: the map's leaves stacked ``[S, ...]``, every other leaf as
  ``stream_state_{from,to}_numpy`` has it.

Nothing here imports JAX: callers hand over numpy arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .device import resolve_device
from .mapping.pool import ReplayPool
from .models.decoder import MLPParams
from .models.local_map import LocalMapState
from .models.neural_map import NeuralMapState
from .pipeline.streaming import StreamState

_MAP_LEAVES = 10  # NeuralMapState fields
_LOCAL_LEAVES = 4
_POOL_LEAVES = 5


def _t(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a contiguous copy, 0-d stays 0-d
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def mlp_from_numpy(params, device=None) -> MLPParams:
    """``params`` has ``weights``, ``biases`` (lists), ``w_out``, ``b_out``
    (the JAX ``MLPParams`` or any object with those attributes), or is the
    flat leaf list [W1..Wn, b1..bn, w_out, b_out]."""
    dev = resolve_device(device)
    if hasattr(params, "weights"):
        ws, bs = list(params.weights), list(params.biases)
        wo, bo = params.w_out, params.b_out
    else:
        leaves = list(params)
        n = (len(leaves) - 2) // 2
        ws, bs, wo, bo = leaves[:n], leaves[n : 2 * n], leaves[2 * n], leaves[2 * n + 1]
    f = lambda a: _t(a, dev, torch.float32)
    return MLPParams([f(w) for w in ws], [f(b) for b in bs], f(wo), f(bo))


def _take_mlp(leaves, i):
    """Parse one MLP's leaves starting at i: n 2-D weights, n 1-D biases,
    then w_out (2-D) and b_out (1-D)."""
    n = 0
    while np.asarray(leaves[i + n]).ndim == 2:
        n += 1
    return leaves[i : i + 2 * n + 2], i + 2 * n + 2


def neural_map_from_numpy(leaves: Sequence, device=None) -> NeuralMapState:
    """The 10 ``NeuralMapState`` leaves (field order) as the port's state."""
    dev = resolve_device(device)
    f32 = lambda a: _t(a, dev, torch.float32)
    i32 = lambda a: _t(a, dev, torch.int32)
    m = list(leaves)
    return NeuralMapState(
        positions=f32(m[0]), quats=f32(m[1]), geo_feats=f32(m[2]),
        color_feats=f32(m[3]), certainty=f32(m[4]), ts_create=i32(m[5]),
        ts_update=i32(m[6]), count=i32(m[7]), hash_table=i32(m[8]),
        hash_mirror=f32(m[9]),
    )


def sharded_map_from_numpy(leaves: Sequence, rank: int, device=None) -> NeuralMapState:
    """Shard ``rank`` of the 10 stacked ``[S, ...]`` leaves of JAX's
    ``parallel/spatial.py:init_sharded_map`` state, as this rank's map."""
    return neural_map_from_numpy([np.asarray(a)[rank] for a in leaves], device)


def sharded_map_to_numpy(state: NeuralMapState) -> list:
    """This rank's shard as its 10 leaves in field order (stack the ranks'
    along a new leading axis for JAX's layout)."""
    return [x.detach().cpu().numpy() for x in state.tensors()]


def local_map_from_numpy(leaves: Sequence, device=None) -> LocalMapState:
    dev = resolve_device(device)
    p, c, h, mir = leaves
    return LocalMapState(
        _t(p, dev, torch.float32), _t(c, dev, torch.int32),
        _t(h, dev, torch.int32), _t(mir, dev, torch.float32),
    )


def pool_from_numpy(leaves: Sequence, device=None) -> ReplayPool:
    dev = resolve_device(device)
    data, valid, size, new_buf, new_count = leaves
    i32 = lambda a: _t(a, dev, torch.int32)
    return ReplayPool(
        _t(data, dev, torch.float32), _t(valid, dev, torch.bool), i32(size),
        i32(new_buf), i32(new_count),
    )


def stream_state_from_numpy(leaves: Sequence, device=None) -> StreamState:
    """Build the port's ``StreamState`` from the JAX state's leaves."""
    dev = resolve_device(device)
    L = list(leaves)
    f32 = lambda a: _t(a, dev, torch.float32)
    i32 = lambda a: _t(a, dev, torch.int32)
    b8 = lambda a: _t(a, dev, torch.bool)
    (rot, pos, rest, P, last_pose, odom, travel, lose, consec, stop_c,
     stop_s, failed) = L[:12]
    i = 12
    map_state = neural_map_from_numpy(L[i : i + _MAP_LEAVES], dev)
    i += _MAP_LEAVES
    local_map = local_map_from_numpy(L[i : i + _LOCAL_LEAVES], dev)
    i += _LOCAL_LEAVES
    pool = pool_from_numpy(L[i : i + _POOL_LEAVES], dev)
    i += _POOL_LEAVES
    mlps = []
    for _ in range(3):
        leaves_mlp, i = _take_mlp(L, i)
        mlps.append(mlp_from_numpy(leaves_mlp, dev))
    key_bits = np.asarray(L[i]).astype(np.uint64).ravel()
    i += 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key_bits[0] << np.uint64(32) | key_bits[-1]))
    losses, track_iters = L[i], L[i + 1]
    if i + 2 != len(L):
        raise ValueError(f"expected {i + 2} StreamState leaves, got {len(L)}")
    return StreamState(
        rot=f32(rot), pos=f32(pos), rest=f32(rest), P=f32(P),
        last_pose=f32(last_pose), odom_poses=f32(odom), travel_dist=f32(travel),
        lose_track=b8(lose), consec_lose=i32(consec), stop_count=i32(stop_c),
        stop_status=b8(stop_s), failed=b8(failed), map_state=map_state,
        local_map=local_map, pool=pool, mlp=mlps[0], color_mlp=mlps[1],
        sem_mlp=mlps[2], key=gen, losses=f32(losses), track_iters=i32(track_iters),
    )


def stream_state_to_numpy(state: StreamState) -> list:
    """The port's ``StreamState`` as numpy leaves in the JAX tree order.
    The key slot holds the generator's initial seed as two uint32 words
    (high, low), from which ``stream_state_from_numpy`` seeds; the
    generator's current state is not a JAX leaf (``save_checkpoint``
    stores it beside the leaves)."""
    out = []
    for x in state.leaves():
        if isinstance(x, torch.Generator):
            seed = x.initial_seed()
            out.append(np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32))
        else:
            out.append(x.detach().cpu().numpy())
    return out


_CLASSIC_DATASET = ("odom_poses", "travel_dist", "cur_pose_ref", "last_pose_ref",
                    "last_odom_tran", "stop_count", "stop_status", "lose_track")


def classic_state_from_numpy(system, arrays: dict) -> None:
    """Carry a JAX ``SlamSystem``'s state into the port's ``system`` (a
    ``pipeline/slam.py:SlamSystem`` of the same config), in place, from
    numpy arrays: ``map``, ``local_map`` and ``pool`` (each the state's
    leaves in field order), ``mlp``, ``color_mlp`` and ``sem_mlp`` (leaf
    lists or objects with the params' attributes), the host filter's
    ``iekf_rot``, ``iekf_pos``, ``iekf_vel``, ``iekf_bg``, ``iekf_ba``,
    ``iekf_grav`` and ``iekf_P``, ``processed_frame``, and the dataset's
    ``odom_poses`` and ``travel_dist`` with, where given, its
    ``cur_pose_ref``, ``last_pose_ref``, ``last_odom_tran`` and stop and
    lose-track flags. ``travel_dist_dev`` (the device copy) defaults to the
    dataset's. The generator is left as it is."""
    from .odometry.iekf import IEKFState

    dev = system.device
    system.map_state = neural_map_from_numpy(arrays["map"], dev)
    system.local_map = local_map_from_numpy(arrays["local_map"], dev)
    system.pool = pool_from_numpy(arrays["pool"], dev)
    system.mlp = mlp_from_numpy(arrays["mlp"], dev)
    system.color_mlp = mlp_from_numpy(arrays["color_mlp"], dev)
    system.sem_mlp = mlp_from_numpy(arrays["sem_mlp"], dev)
    f64 = lambda k: np.array(arrays[k], np.float64)
    system.tracker.x = IEKFState(
        rot=f64("iekf_rot"), pos=f64("iekf_pos"), vel=f64("iekf_vel"), bg=f64("iekf_bg"),
        ba=f64("iekf_ba"), grav=f64("iekf_grav"),
    )
    system.tracker.P = f64("iekf_P")
    d = system.dataset
    for k in _CLASSIC_DATASET:
        if k in arrays:
            v = arrays[k]
            setattr(d, k, np.array(v) if np.ndim(v) else type(getattr(d, k))(v))
    d.processed_frame = int(arrays["processed_frame"])
    td = arrays.get("travel_dist_dev", np.asarray(d.travel_dist)[: system.total_frames])
    system.travel_dist_dev = _t(td, dev, torch.float32)


_MAP_AT = 12  # the map's first leaf in the StreamState leaf order


def sharded_stream_state_from_numpy(leaves: Sequence, rank: int, device=None) -> StreamState:
    """This rank's ``StreamState`` from the leaves of a JAX sharded
    ``StreamState`` (map leaves ``[S, ...]``): shard ``rank`` of the map,
    the replicated leaves as they are."""
    L = list(leaves)
    L[_MAP_AT : _MAP_AT + _MAP_LEAVES] = [np.asarray(a)[rank]
                                          for a in L[_MAP_AT : _MAP_AT + _MAP_LEAVES]]
    return stream_state_from_numpy(L, device)


def sharded_stream_state_to_numpy(state: StreamState, mesh) -> list:
    """The leaves of the JAX sharded ``StreamState`` from every rank's
    state: the map's leaves all-gathered and stacked ``[S, ...]`` in rank
    order. A collective: every rank of ``mesh`` calls it, and every rank
    gets the whole list."""
    from .parallel.collectives import all_gather

    out = stream_state_to_numpy(state)
    out[_MAP_AT : _MAP_AT + _MAP_LEAVES] = [
        all_gather(x.reshape(-1), mesh).reshape((mesh.size,) + tuple(x.shape)).cpu().numpy()
        for x in state.map_state.tensors()
    ]
    return out
