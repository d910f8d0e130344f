"""Rank-side cases of the sharded drivers' tests (``tests/test_torch_{streaming_sharded,
slam_sharded,distributed}.py``), run by ``torch_dist`` in spawned gloo
ranks. Like ``torch_sharded_ranks`` this module imports neither JAX nor
clid_slam_tpu: its inputs are numpy arrays and a port ``Config``, and it
returns numpy arrays and digests of the replicated state, which the tests
compare across ranks and with the JAX package's results."""

import hashlib

import numpy as np
import torch

from clid_slam_torch import convert


def digest(tensors) -> str:
    """One hash of the bytes of ``tensors`` (the replicated state that every
    rank must hold bit for bit)."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _stream(cfg, inp, mesh):
    from clid_slam_torch.pipeline.streaming_sharded import StreamingShardedSlam

    s = StreamingShardedSlam(cfg, n_devices=mesh.size, total_frames=inp["n"] + 2, device="cpu")
    rot, pos, vel = inp["seed_pose"]
    s.seed_pose(rot, pos, vel)
    return s


def _replicated(st) -> dict:
    return dict(pose=digest([st.rot, st.pos, st.rest, st.P, st.odom_poses]),
                pool=digest(st.pool.tensors()), local_map=digest(st.local_map.tensors()),
                mlp=digest(st.mlp.tensors()), gen=digest([st.key.get_state()]))


def stream_run_case(mesh, inp):
    """``StreamingShardedSlam`` over ``inp["n"]`` frames; with ``ckpt_at``
    saved after that frame and resumed in a fresh system over the frames
    after it."""
    cfg, n = inp["cfg"], inp["n"]
    s = _stream(cfg, inp, mesh)
    for i in range(n):
        s.process_frame(i, inp["scans"][i], inp["imus"][i])
        if i == inp.get("ckpt_at"):
            s.save_checkpoint(inp["ckpt_path"])
    out = s.sync()
    res = dict(odom_poses=out["odom_poses"], failed=out["failed"],
               neural_points=out["neural_points"], count=int(s.state.map_state.count),
               losses=out["losses"], track_iters=out["track_iters"],
               replicated=_replicated(s.state))
    if inp.get("ckpt_at") is not None:
        r = _stream(cfg, inp, mesh)
        r.load_checkpoint(inp["ckpt_path"])
        for i in range(inp["ckpt_at"] + 1, n):
            r.process_frame(i, inp["scans"][i], inp["imus"][i])
        res["resumed_odom_poses"] = r.sync()["odom_poses"]
        res["resumed_replicated"] = _replicated(r.state)
    return res


def _leaves_digest(st) -> str:
    return digest([x.get_state() if isinstance(x, torch.Generator) else x for x in st.leaves()])


def recorded(fn, calls, key):
    """``fn`` appending ``key`` to ``calls`` at each call."""
    def call(*args, **kw):
        calls.append(key)
        return fn(*args, **kw)

    return call


def stream_precompile_case(mesh, inp):
    """``StreamingShardedSlam`` over ``inp["n"]`` frames after
    ``precompile()`` ("warm") and without it ("cold"); whether precompile
    left the state and ``map_log`` as they were."""
    cfg, n = inp["cfg"], inp["n"]
    res = {}
    for name in ("warm", "cold"):
        s = _stream(cfg, inp, mesh)
        if name == "warm":
            before = _leaves_digest(s.state)
            ran, steps = [], s.steps
            s.steps = {k: recorded(f, ran, k) for k, f in steps.items()}
            s.precompile()
            s.steps = steps
            res["precompiled_variants"] = ran
            res["unchanged_by_precompile"] = (_leaves_digest(s.state) == before
                                              and s.map_log == [])
        for i in range(n):
            s.process_frame(i, inp["scans"][i], inp["imus"][i])
        out = s.sync()
        res[name] = dict(odom_poses=out["odom_poses"], losses=out["losses"],
                         track_iters=out["track_iters"], map_iters=out["map_iters"],
                         state=_leaves_digest(s.state), replicated=_replicated(s.state))
    return res


def stream_from_jax_case(mesh, inp):
    """A JAX sharded checkpoint loaded and written back as JAX's leaves, and
    one frame from JAX's state with JAX's draws."""
    from clid_slam_torch.pipeline.streaming_sharded import StreamingShardedSlam

    cfg, i = inp["cfg"], inp["frame"]
    s = StreamingShardedSlam(cfg, n_devices=mesh.size, total_frames=inp["n"] + 2, device="cpu")
    s.load_checkpoint(inp["ckpt_path"])
    reloaded = convert.sharded_stream_state_to_numpy(s.state, mesh)
    processed = s.processed
    s.state = convert.sharded_stream_state_from_numpy(inp["leaves"], mesh.rank, "cpu")
    draws = dict(inp["draws"], append=torch.from_numpy(inp["draws"]["append"]))
    s.process_frame(i, inp["scan"], inp["imu"], draws=draws)
    st = s.state
    return dict(reloaded=reloaded if mesh.rank == 0 else None, processed=processed,
                pose=st.odom_poses[i].numpy(), track_iters=int(st.track_iters[i]),
                count=int(st.map_state.count), pool_size=int(st.pool.size),
                losses=st.losses[i].numpy(), replicated=_replicated(st))


def _classic(cfg, inp, mesh, total_frames):
    from clid_slam_torch.parallel.slam_sharded import ShardedSlamSystem

    s = ShardedSlamSystem(cfg, n_devices=mesh.size, total_frames=total_frames, device="cpu")
    rot, pos, vel = inp["seed_pose"]
    s.tracker.x.pos, s.tracker.x.rot, s.tracker.x.vel = pos.copy(), rot.copy(), vel.copy()
    return s


def classic_run_case(mesh, inp):
    """``ShardedSlamSystem`` over ``inp["n"]`` frames: the trajectory, the
    shards' counts after ``inp["counts_after"]`` frames and at the end."""
    cfg, n = inp["cfg"], inp["n"]
    s = _classic(cfg, inp, mesh, n + 4)
    counts_after = None
    for i in range(n):
        s.process_frame(i, inp["scans"][i], inp["imus"][i])
        if i + 1 == inp["counts_after"]:
            counts_after = int(s.map_state.count)
    return dict(odom_poses=s.odom_poses[:n].copy(), failed=s.failed,
                neural_points=s.neural_point_count(), count=int(s.map_state.count),
                counts_after=counts_after,
                replicated=dict(pool=digest(s.pool.tensors()), mlp=digest(s.mlp.tensors()),
                                local_map=digest(s.local_map.tensors()),
                                gen=digest([s.key.get_state()])))


def classic_from_jax_case(mesh, inp):
    """One frame of ``ShardedSlamSystem`` from the JAX system's state with
    JAX's draws."""
    from clid_slam_torch.odometry.iekf import IEKFState

    cfg, i, a = inp["cfg"], inp["frame"], inp["state"]
    s = _classic(cfg, inp, mesh, a["total_frames"])
    s.map_state = convert.sharded_map_from_numpy(a["map"], mesh.rank, "cpu")
    s.local_map = convert.local_map_from_numpy(a["local_map"], "cpu")
    s.pool = convert.pool_from_numpy(a["pool"], "cpu")
    s.mlp = convert.mlp_from_numpy(a["mlp"], "cpu")
    s.tracker.x = IEKFState(**{k: np.array(v, np.float64) for k, v in a["x"].items()})
    s.tracker.P = np.array(a["P"], np.float64)
    s.odom_poses, s.travel_dist = a["odom_poses"].copy(), a["travel_dist"].copy()
    s.travel_dist_dev = torch.from_numpy(a["travel_dist_dev"].copy())
    s.last_pose, s.lose_track, s.failed = a["last_pose"].copy(), a["lose_track"], a["failed"]
    draws = dict(inp["draws"], append=torch.from_numpy(inp["draws"]["append"]))
    s.process_frame(i, inp["scan"], inp["imu"], draws=draws)
    return dict(pose=s.odom_poses[i].copy(), count=int(s.map_state.count),
                pool_size=int(s.pool.size), losses=s._last_losses.numpy(),
                lose_track=s.lose_track, pool=digest(s.pool.tensors()),
                mlp=digest(s.mlp.tensors()))


def run_sharded_case(mesh, inp):
    """``run_sharded_slam`` on the ranks' group beside a direct
    ``ShardedSlamSystem`` loop over the same frames."""
    from clid_slam_torch.parallel.distributed import run_sharded_slam

    cfg, n = inp["cfg"], inp["n"]
    poses, system = run_sharded_slam(cfg, inp["scans"][:n], inp["imus"][:n],
                                     seed_pose=inp["seed_pose"], device="cpu")
    direct = _classic(cfg, inp, mesh, n + 4)
    for i in range(n):
        direct.process_frame(i, inp["scans"][i], inp["imus"][i])
    return dict(poses=poses, direct=direct.odom_poses[:n].copy(),
                points=system.neural_point_count(), direct_points=direct.neural_point_count(),
                shards=system.n_shards)


def join_case(mesh, inp):
    """No group from the harness: ``initialize`` with explicit arguments
    joins this rank, then a collective, ``shutdown`` and a second
    ``shutdown`` (a no-op)."""
    from clid_slam_torch.parallel import distributed as dd
    from clid_slam_torch.parallel.collectives import make_group_mesh, psum

    assert not dd.dist.is_initialized()
    ctx = dd.initialize(inp["url"], mesh.size, mesh.rank, device="cpu")
    total = psum(torch.tensor([float(mesh.rank + 1)]), make_group_mesh()).item()
    dd.shutdown()
    dd.shutdown()
    return dict(ctx=vars(ctx), coordinator=ctx.is_coordinator, total=total,
                after=dd.dist.is_initialized())


def lone_case(mesh, inp):
    """No group and nothing in the environment: ``run_sharded_slam`` runs
    on one rank and leaves that group up for the system's collectives."""
    import os

    from clid_slam_torch.parallel import distributed as dd

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(k, None)
    ctx = dd.initialize(device="cpu")
    cfg, n = inp["cfg"], inp["n"]
    poses, system = dd.run_sharded_slam(cfg, inp["scans"][:n], inp["imus"][:n],
                                        seed_pose=inp["seed_pose"], device="cpu")
    out = dict(ctx=vars(ctx), poses=poses, shards=system.n_shards,
               points=system.neural_point_count(), world=dd.dist.get_world_size())
    dd.shutdown()
    return out
