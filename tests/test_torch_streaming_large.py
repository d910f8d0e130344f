"""The streaming frame step under the large bench configuration's options
(registration range gate, tracker information scale, bias noise, a finite
travel-distance window, prune cadence) on the large scenario's trajectory,
which starts at rest (hold, then ramp: the stop logic is live): each frame
one step ahead of the JAX package from the same state with the same draws.

Cut to CPU size: 256x24 beams, bs 4096, small tables, a prune every 4
frames. Poses within 1e-4 (the tracked-frame test's tolerance); iteration
counts, stop counters, point counts and pool sizes equal. The trained
features are not compared here: a sample on the novelty threshold may flip
between the two sides and shift the replay batch.

Run as a script for a longer stretch (prints one line per frame), or
uncut (1024x32 beams, the bench's tables and prune cadence) with the port
on a card:

    JAX_PLATFORMS=cpu python tests/test_torch_streaming_large.py 45
    XLA_PYTHON_CLIENT_PREALLOCATE=false \
        python tests/test_torch_streaming_large.py 200 --full --device cuda

``--arrays FILE`` compares every array of the state that the two frame
steps return (neural map, local map, replay pool, MLP, tracker state), the
frame's new pool rows as prep wrote them (sample coordinates, labels,
weights) and the SDF field that each side's map decodes at the frame's
ground-truth surface points, frame by frame. The port's mapper takes the
JAX package's replay batch (its final indices, new-sample mix included),
so a threshold flip in prep does not shift the mapper's input. For each
array it prints the max |diff| and the signed mean of the difference, and
marks the first frame where an integer array differs or a float array's
signed mean outgrows the frames before it; FILE gets one JSON line a frame:

    JAX_PLATFORMS=cpu python tests/test_torch_streaming_large.py 70 --full \
        --device cpu --arrays every_array.jsonl
"""

import os
import sys

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench as jax_bench
from clid_slam_torch.convert import stream_state_from_numpy
from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence, large_world
from test_torch_streaming import _jax_frame_draws
from torch_parity import n, port_config
from torch_seed_sweep import cut_large


def one_step_ahead(n_frames, prune_freq_frame=4, full=False, device="cpu"):
    """Yield, for frames 1..n_frames-1, the port's and the JAX package's
    results of that frame from the JAX state before it."""
    cfg = jax_bench.build_config(large=True)
    if not full:
        # a 9-frame map is small: tables a quarter of the sweep's keep the test short
        cut_large(cfg, 1 << 16, 1 << 19).prune_freq_frame = prune_freq_frame
    az, el = (1024, 32) if full else (256, 24)
    seq = generate_sequence(
        n_frames=n_frames, n_azimuth=az, n_elev=el, noise_std=0.01, radius=32.0,
        period_frames=400.0, seed=3, world=large_world(np.random.default_rng(11), room_radius=50.0),
        ramp_frames=25.0, hold_frames=15.0, spin_phase=True,
    )
    vel = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / 0.1
    s = JaxSlam(cfg, total_frames=n_frames + 8)
    s.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], vel)
    s.process_frame(0, seq.scans[0], seq.imu_windows[0])
    port = TorchSlam(port_config(cfg), total_frames=n_frames + 8, device=device)
    gen = port.state.key
    for frame in range(1, n_frames):
        port.state = stream_state_from_numpy(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], device
        )
        port.state.key = gen
        draws = _jax_frame_draws(cfg, s.state.key)
        port.process_frame(frame, seq.scans[frame], seq.imu_windows[frame], draws=draws)
        s.process_frame(frame, seq.scans[frame], seq.imu_windows[frame])
        yield frame, port, s


def _ints(state, frame):
    return (int(state.track_iters[frame]), int(state.stop_count), bool(state.stop_status),
            bool(state.lose_track), int(state.map_state.count), int(state.pool.size))


def test_large_options_one_step_ahead_matches_jax():
    stopped = 0
    for frame, port, s in one_step_ahead(9):
        np.testing.assert_allclose(
            n(port.state.odom_poses[frame]), np.asarray(s.state.odom_poses[frame]), atol=1e-4
        )
        np.testing.assert_allclose(n(port.state.rest), np.asarray(s.state.rest), atol=1e-4)
        assert _ints(port.state, frame) == _ints(s.state, frame), frame
        stopped += int(s.state.stop_count) > 0
    assert [f for f, _, _ in port.prune_log] == [3, 7]  # the cadence
    assert stopped >= 3  # the hold phase exercised the stop counter


# the StreamState leaves in the JAX tree order, the PRNG key left out
_TOP = ("rot", "pos", "rest", "P", "last_pose", "odom_poses", "travel_dist",
        "lose_track", "consec_lose", "stop_count", "stop_status", "failed")
_MAP = ("positions", "quats", "geo_feats", "color_feats", "certainty", "ts_create",
        "ts_update", "count", "hash_table", "hash_mirror")


def _named_port_leaves(state):
    out = [(k, getattr(state, k)) for k in _TOP]
    out += [("map." + k, getattr(state.map_state, k)) for k in _MAP]
    out += [("local." + k, v) for k, v in zip(("positions", "count", "hash_table", "hash_mirror"),
                                              state.local_map.tensors())]
    out += [("pool." + k, v) for k, v in zip(("data", "valid", "size", "new_buf", "new_count"),
                                             state.pool.tensors())]
    for name in ("mlp", "color_mlp", "sem_mlp"):
        m = getattr(state, name)
        out += [(f"{name}.w{i}", w) for i, w in enumerate(m.weights)]
        out += [(f"{name}.b{i}", b) for i, b in enumerate(m.biases)]
        out += [(f"{name}.w_out", m.w_out), (f"{name}.b_out", m.b_out)]
    out += [("losses", state.losses), ("track_iters", state.track_iters)]
    return [(k, n(v)) for k, v in out]


def _jax_leaves(state):
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    key_at = len(leaves) - 3  # key, losses, track_iters end the tree
    return leaves[:key_at] + leaves[key_at + 1:]


def _diff(a, b):
    """max |a - b|, signed mean of a - b, and how many elements differ."""
    d = a.astype(np.float64) - b.astype(np.float64)
    return {"max": float(np.abs(d).max()) if d.size else 0.0,
            "mean": float(d.mean()) if d.size else 0.0, "n_diff": int((d != 0).sum()),
            "size": int(d.size), "int": a.dtype.kind in "biu"}


def _new_rows(pool_data, frame):
    """Aggregates of the pool rows this frame's prep wrote."""
    rows = pool_data[pool_data[:, 5] == frame]
    if not len(rows):
        return {"rows": 0}
    return {"rows": int(len(rows)), "z": float(rows[:, 2].mean()),
            "sdf": float(rows[:, 3].mean()), "weight": float(rows[:, 4].mean()),
            "sdf_w": float((rows[:, 3] * rows[:, 4]).sum() / max(rows[:, 4].sum(), 1e-12))}


def _field(state, slam, points):
    """The SDF that the map and MLP of ``state`` (the port's) decode at
    ``points`` with ``slam``'s query settings (the tracker's query, no time
    filter), and each point's neighbour count, on the CPU."""
    import torch

    from clid_slam_torch.models import decoder as tdec
    from clid_slam_torch.models import neural_map as tnm

    cfg = slam.cfg
    cpu = lambda x: x.cpu()
    ms = type(state.map_state)(*map(cpu, state.map_state.tensors()))
    m = state.mlp
    mlp = type(m)([*map(cpu, m.weights)], [*map(cpu, m.biases)], cpu(m.w_out), cpu(m.b_out))
    max_d2 = 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2
    q = tnm.query_feature(ms, torch.as_tensor(points), torch.as_tensor(slam.nb_offs),
                          cfg.voxel_size_m, max_d2, cfg.query_nn_k,
                          encode_vecs=slam.encode_vecs, layer_norm=cfg.layer_norm_on)
    return n(tdec.sdf(mlp, q.feature, cfg.sdf_scale, leaky=cfg.mlp_leaky_relu)), n(q.nn_count)


def _jax_prep_result(before, after, frame, device):
    """The JAX frame's map and pool as its prep handed them to its mapper,
    rebuilt from the states before and after the frame (no prune between):
    the pool is the mapper's as is; the map takes the insert's rows, hash
    and mirror from after the frame, and the trained fields (features,
    certainty, last-update frame) from before it, the new rows' last
    update being this frame."""
    from clid_slam_torch.convert import neural_map_from_numpy, pool_from_numpy

    i = len(_TOP)
    pre, post = before[i:i + len(_MAP)], after[i:i + len(_MAP)]
    f = dict(zip(_MAP, post))
    c0, c1 = int(pre[_MAP.index("count")]), int(post[_MAP.index("count")])
    ts_update = np.array(pre[_MAP.index("ts_update")])
    ts_update[c0:c1] = frame
    f.update(geo_feats=pre[_MAP.index("geo_feats")], certainty=pre[_MAP.index("certainty")],
             ts_update=ts_update)
    k = i + len(_MAP) + 4
    return (neural_map_from_numpy([f[m] for m in _MAP], device),
            pool_from_numpy(after[k:k + 5], device))


def every_array(n_frames, full, device, out_path, feed_prep=False):
    """One step ahead, every array: see the module's docstring."""
    import json

    import torch

    from clid_slam_torch.mapping import mapper as tmapper
    from clid_slam_torch.pipeline import streaming as tstreaming
    from clid_slam_tpu.mapping.pool import sample_batch_indices as jax_batch

    fed = {}
    if feed_prep:  # the port's mapper takes the JAX prep's map and pool
        real_make = tstreaming.prp.make_prep_fn

        def make_prep_fn(**kw):
            body = real_make(**kw)

            def prep(*a, **k):
                res = body(*a, **k)
                return res._replace(**fed) if fed else res
            return prep
        tstreaming.prp.make_prep_fn = make_prep_fn

    cfg = jax_bench.build_config(large=True)
    if not full:
        cut_large(cfg, 1 << 16, 1 << 19).prune_freq_frame = 4
    az, el = (1024, 32) if full else (256, 24)
    seq = generate_sequence(
        n_frames=n_frames, n_azimuth=az, n_elev=el, noise_std=0.01, radius=32.0,
        period_frames=400.0, seed=3, world=large_world(np.random.default_rng(11), room_radius=50.0),
        ramp_frames=25.0, hold_frames=15.0, spin_phase=True,
    )
    vel = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / 0.1
    s = JaxSlam(cfg, total_frames=n_frames + 8)
    s.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], vel)
    s.process_frame(0, seq.scans[0], seq.imu_windows[0])
    port = TorchSlam(port_config(cfg), total_frames=n_frames + 8, device=device)
    gen = port.state.key
    history, first = {}, {}
    fh = open(out_path, "w") if out_path else None
    for frame in range(1, n_frames):
        before = [np.array(x) for x in jax.tree_util.tree_leaves(s.state)]
        key = s.state.key
        draws = _jax_frame_draws(cfg, key)
        # the JAX mapper's replay batch key (pipeline/streaming.py: two splits
        # of the state key; the fast body draws one batch from the second),
        # taken before the frame step donates the key
        _, k_map = jax.random.split(jax.random.split(key)[0])
        k_batch = jax.random.split(k_map)[1]
        s.process_frame(frame, seq.scans[frame], seq.imu_windows[frame])
        idx = np.asarray(jax_batch(s.state.pool, k_batch, cfg.bs, cfg.bs_new_sample))
        feed = lambda pool, bs, bs_new, generator=None, draws=None: torch.as_tensor(
            idx, device=pool.data.device).long()
        port.state = stream_state_from_numpy(before, device)
        port.state.key = gen
        fed.clear()
        if feed_prep and (frame + 1) % cfg.prune_freq_frame:
            after = [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)]
            fed["map_state"], fed["pool"] = _jax_prep_result(before, after, frame, device)
        rec_fed = bool(fed)
        saved, tmapper.sample_batch_indices = tmapper.sample_batch_indices, feed
        try:
            port.process_frame(frame, seq.scans[frame], seq.imu_windows[frame], draws=draws)
        finally:
            tmapper.sample_batch_indices = saved
        jl = _jax_leaves(s.state)
        pl_ = _named_port_leaves(port.state)
        if len(jl) != len(pl_):
            raise AssertionError(f"{len(pl_)} port leaves against {len(jl)} JAX leaves")
        rec = {"frame": frame, "arrays": {}}
        for (name, a), b in zip(pl_, jl):
            d = _diff(a, b)
            rec["arrays"][name] = d
            h = history.setdefault(name, [])
            grown = (not d["int"] and d["n_diff"] and len(h) >= 3
                     and abs(d["mean"]) > 10 * max(abs(x) for x in h) + 1e-12)
            if name not in first and ((d["int"] and d["n_diff"]) or grown):
                first[name] = frame
            h.append(d["mean"])
        pd, jd = n(port.state.pool.data), np.asarray(s.state.pool.data)
        rec["prep_new_rows"] = {"port": _new_rows(pd, frame), "jax": _new_rows(jd, frame)}
        rec["pool_columns"] = {c: _diff(pd[:, i], jd[:, i])
                               for i, c in enumerate(("x", "y", "z", "sdf", "weight", "ts"))}
        world = (seq.scans[frame][:, :3] @ seq.poses[frame][:3, :3].T
                 + seq.poses[frame][:3, 3]).astype(np.float32)
        fp, cp = _field(port.state, port, world)
        after = [np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)]
        fj, cj = _field(stream_state_from_numpy(after, "cpu"), port, world)
        ok = (cp > 0) & (cj > 0)
        below = ok & (world[:, 2] < seq.poses[frame][2, 3] - 1.0)
        rec["field_at_surface"] = {
            "points": int(ok.sum()), "port_mean": float(fp[ok].mean()),
            "jax_mean": float(fj[ok].mean()), "diff_mean": float((fp - fj)[ok].mean()),
            "diff_max": float(np.abs(fp - fj)[ok].max()),
            "floor_points": int(below.sum()),
            "floor_diff_mean": float((fp - fj)[below].mean()) if below.any() else 0.0,
        }
        rec["batch_fed"], rec["prep_fed"] = True, rec_fed
        dz = float(n(port.state.odom_poses[frame])[2, 3] - np.asarray(s.state.odom_poses[frame])[2, 3])
        rec["pose_z_diff"] = dz
        if fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
        worst = sorted(((v["max"], k) for k, v in rec["arrays"].items() if v["n_diff"]), reverse=True)
        print(f"frame {frame}: z {dz:+.2e}, field at surface {rec['field_at_surface']['diff_mean']:+.2e} "
              f"(floor {rec['field_at_surface']['floor_diff_mean']:+.2e}), new rows "
              f"{rec['prep_new_rows']['port'].get('rows')} / {rec['prep_new_rows']['jax'].get('rows')}, "
              f"pool columns: " + ", ".join(f"{c} {v['max']:.1e}/{v['mean']:+.1e}/{v['n_diff']}"
                                            for c, v in rec["pool_columns"].items()) + "; "
              f"differing: " + ", ".join(
                  f"{k} max {m:.2e} mean {rec['arrays'][k]['mean']:+.2e} n {rec['arrays'][k]['n_diff']}"
                  for m, k in worst[:12]), flush=True)
    summary = {"first_frame": first, "frames": n_frames, "full": full}
    print(json.dumps(summary), flush=True)
    if fh:
        fh.write(json.dumps(summary) + "\n")
        fh.close()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", type=int, nargs="?", default=45)
    ap.add_argument("--full", action="store_true", help="uncut, for a card")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--arrays", metavar="FILE", default=None,
                    help="compare every array of the state; one JSON line a frame to FILE")
    ap.add_argument("--feed-prep", action="store_true",
                    help="with --arrays: the port's mapper takes the JAX prep's map and pool")
    args = ap.parse_args()
    if args.arrays:
        every_array(args.frames, args.full, args.device, args.arrays, args.feed_prep)
        sys.exit(0)
    dz = []
    for frame, port, s in one_step_ahead(args.frames, full=args.full, device=args.device):
        pp, pj = n(port.state.odom_poses[frame]), np.asarray(s.state.odom_poses[frame])
        r = np.abs(n(port.state.rest) - np.asarray(s.state.rest)).max()
        live = int(s.state.map_state.count)
        fp = n(port.state.map_state.geo_feats[:live])
        fj = np.asarray(s.state.map_state.geo_feats[:live])
        dz.append(pp[2, 3] - pj[2, 3])
        print(f"frame {frame}: pose diff {np.abs(pp - pj).max():.2e} (z {dz[-1]:+.2e}), "
              f"tracker state diff {r:.2e}, features diff mean {np.abs(fp - fj).mean():.2e} "
              f"max {np.abs(fp - fj).max():.2e}, losses port {n(port.state.losses[frame]).round(4).tolist()} "
              f"jax {np.asarray(s.state.losses[frame]).round(4).tolist()}, "
              f"ints port {_ints(port.state, frame)} jax {_ints(s.state, frame)}", flush=True)
    print(f"z of the port minus z of JAX, one step ahead: mean {np.mean(dz):+.3e}, "
          f"std {np.std(dz):.3e} over {len(dz)} frames")
