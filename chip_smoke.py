#!/usr/bin/env python3
"""Drive the PyTorch port (clid_slam_torch) on one CUDA card.

    python3 chip_smoke.py             # all phases
    python3 chip_smoke.py --profile   # adds torch.profiler phases

Phases, each printing one JSON line:
  device  the card (nvidia-smi name and power limit);
  build   nvcc of every clid_slam_torch/csrc/*.cu for sm_90a, side by side,
          with its seconds and the ptxas summary;
  kernel  the fused mapping Adam loop against its plain PyTorch version at
          the bench shapes (bs 16384, K 6, F 8, P 3, bd 1638, 10 iterations),
          in every variant (1 or 2 hidden layers of 32 or 64, layer norm off
          or on) and with its slab streamed from device memory: errors, ms
          issued eagerly (CUDA events, host enqueue included, as for every
          kernel of the summary line), the kernel's device time (profiler)
          beside it as device_ms, plain ms and the card's bound;
  gather  the gather probe (clid_slam_torch/tools/probe_gather.py): the
          row, lane and column gather kernels at the six probe shapes and
          at the main path's: the hash mirrors (2^22 and 2^21 rows of 4
          floats, neighbour-cell buckets), the mapper's work slab (int64
          indices; feature_dim 8, and 6 for rows that move as single
          floats) and the kNN selection (K 6 of 81 lanes for 16384 points,
          16 of 81 for 8192, of f32, int64, bool and 16-byte lanes, the
          selectors the first K columns of smallest_k's sort, rows 81
          apart, as the path hands them over), and the dynamic filter's and
          BA's (BA's [20, 16] window-pose gather by 16384 clamped window
          rows, the filter's mirror probe and K 6 selection over a whole
          scan of 32768 points, query_feature's feature rows of a 2^18-row
          map with its sentinel row at BA's 16384 and the filter's 32768
          points), and one mesh chunk's (48^3 points through the probe, the
          K 6 selection and the feature rows), each
          equal to its plain version bit for bit, with kernel, plain and
          library-call ms (and table[idx] at the mirror shapes) and the
          card's bound; then the host time of one call of each gather
          wrapper and of the library calls beside them;
  precompile  StreamingSlam.precompile() on the small configuration: a
          fresh process with an empty build directory runs it (every kernel
          compiles at its first use there) and then 12 frames of the small
          sequence; a second fresh one runs the frames without it:
          precompile's ms (host clock, CUDA events) and its launches by
          kernel, frames 0 and 1 on either side (host clock up to the
          card's idle) and their difference, the one-time cost that
          precompile moved out of the loop; the two runs equal bit for bit;
  stream  the port's StreamingSlam on the bench's small sequence
          (1024x32 beams, 25 frames as bench.py runs them: 10 warm-up
          frames, 15 timed), with ATE/ARE against ground truth and the
          kernels' launch counts on that run (map_loop one a tracked
          frame, gather_rows at least 6 and gather_lanes at least 7: the
          tracker's 3 and the mapper's 4);
  stream_large     the same StreamingSlam on the bench's large sequence and
          configuration (200 frames, 10 warm-up; prune and rehash every 50
          frames), nothing cut, with the point count around each prune.
          On this trajectory no point goes inactive, so these prunes are an
          identity compaction and a rehash;
  sharded          the sharded runtime (clid_slam_torch/parallel) at world
          size 1 on NCCL (a one-rank process group through a FileStore),
          at the large configuration's widths: a shard of 2^19 rows and a
          2^23 hash table filled by insert_fn with that run's map points
          beside a single map filled by insert_points (equal bit for bit),
          then with the run's features; query_fn at 16384 pool rows against
          query_feature on the single map (counts and selections exact,
          features within 1e-5) and the sharded certainty against
          query_certainty_max (exact); mapping_fn in its three bodies, 10
          iterations of bs 16384 (losses falling, the batch-sharded and
          replicated bodies within test_spatial.py's tolerances, the cached
          body twice and under the plain gathers bit for bit);
          make_dp_mapping_fn twice, bit for bit; the sharded tracker on the
          last scan against make_cached_update_fn (pose within 1e-4): ms
          per call by CUDA events, the gathers' launches per call,
          collective_bytes_per_query, the backend and world size, and the
          rows the inserts did not add split by cause (insert_shortfall:
          rows sharing a voxel or voxels sharing a bucket within a call,
          voxels an earlier call put in; the causes must sum to the
          shortfall). More than one rank is checked only on gloo on the CPU
          (tests/test_torch_{collectives,data_parallel,spatial,
          spatial_mapping}.py);
  prune_check      on the map that run ends with: the configured prune (the map
          must probe as before) and a global prune at the median certainty
          (which drops about half the rows); in both, the survivors are the
          kept rows in order and the rebuilt hash resolves each of them;
  mesh_large       that map meshed with the large configuration's Mesher
          (chunk_dim 48, 0.1 m): the whole map's chunks on the device, then
          a 20 m window around the last pose meshed and welded (the whole
          map instead where its projected time fits 60 s): chunks, launches
          a chunk, the device loop and the weld timed apart, vertex
          distances to the world's surfaces, both triangle soups equal
          under the plain gathers;
  stream_sharded   StreamingShardedSlam (pipeline/streaming_sharded.py) at
          world size 1 on NCCL over the small sequence (25 frames, 10
          warm-up) at the small configuration's widths (a 2^19-row shard,
          a 2^23 table): frame 0's ms, the steady ms a frame (CUDA events),
          ATE under 0.35 m (the JAX package's sharded test's gate), not
          failed, and the gathers' launches equal to the count worked out
          from the code (expected_sharded_launches; map_loop 0: the
          sharded mapping bodies are the autograd loop);
  sharded_checkpoint_resume  the same run saved after frame 14 (one npz
          in the JAX package's sharded layout), loaded into a fresh system
          and run on: frames 15-24, losses, iteration counts and every
          state tensor equal stream_sharded's bit for bit;
  sharded_precompile  StreamingShardedSlam.precompile() at world size 1 in
          a new NCCL group (its first collectives set the communicator up):
          its ms and launches, then frames 0 and 1 (host clock and CUDA
          events) beside stream_sharded's frame 0; poses, losses and mapping
          steps equal stream_sharded's bit for bit;
  classic_sharded  run_sharded_slam (parallel/distributed.py) with no
          process group and nothing in the environment (it brings up a
          one-process NCCL group) over the same 25 frames: ATE under
          0.25 m and ARE under 4 deg (the JAX sharded test's gates), poses
          equal to a direct ShardedSlamSystem loop's bit for bit, the
          launches equal to the count worked out from the code, ms of the
          call and the direct loop's frame 0 and steady ms a frame;
  stream_fallback  the small sequence with leaky ReLU, which the fused
          kernel does not take: 12 frames on the mapper's autograd loop;
  stream_dynba     the small configuration with the dynamic filter on every
          tracked frame and a 20-frame sliding-window BA every 10 frames
          from frame 20 (80 iterations of 16384 pool rows, at frames 29 and
          39), 40 frames of the small sequence (10 warm-up): ATE under 0.3 m
          (the JAX package's own gate for the two together), the BA's ms
          per call (CUDA events around each call) and the share of the
          points the map trains on that the filter dropped, frame by frame;
          the launch counts gain the filter's (4 gather_lanes a tracked
          frame) and the BA's (4 gather_lanes an iteration);
  gradient_check   on the map that run ends with, the gradients the filter
          and BA take through the gather kernels at their full-width shapes
          (query_feature's decoded SDF wrt the points and the features at
          the last scan's 32768 points and at 16384 pool samples; BA's
          window-pose gather), and at the filter's shape decode-then-weight's
          (wrt the points and the features) and the color query's (wrt a
          color slab of feature_dim columns): through the kernels twice and
          through their plain versions on the card, all equal bit for bit;
  checkpoint_resume  the same configuration for frames 0-24 in a fresh
          system, saved with save_checkpoint, loaded into another fresh
          system and continued over frames 25-39: its trajectory, losses,
          iteration counts and every state tensor equal stream_dynba's bit
          for bit;
  stream_requery   the small configuration with track_cached=False (the
          map re-queried at every IESEKF iteration), 12 frames: ATE under
          0.2 m and at least 3 gather_lanes launches an iteration;
  stream_dtw, stream_bf16, stream_color_sem  the small configuration, 12
          frames (10 warm-up), with decode-then-weight (weighted_first=False),
          with bf16 decoding (mlp_bf16), and with the color (1 channel) and
          20-class semantic heads: ATE under 0.3 m each, tracked frames on the
          mapper's autograd loop (map_loop not launched), the color slab's
          gathers counted with the others (2 more gather_rows a tracked frame);
  color_sem_map    the modules at bench widths on labelled data: the first
          scan of the small sequence with an intensity from each point's
          azimuth and a class 1..4 from its quadrant, through prep (colors and
          classes into the pool) and the tracked frames' single-batch mapping
          body with both heads, 10 frames: the color L1 and the semantic NLL
          at the scan's points must fall, and the color slab's gathers at the
          mapper's shapes equal their plain versions bit for bit; the
          trained map's mesh and its vertex colors and classes equal under
          the plain gathers, with the share of classes that match the
          azimuth quadrant;
  classic the classic driver's CLI (``pipeline/slam.py:run_slam``) on a
          written dataset: the small configuration's widths in the config
          file, the small sequence's geometry (1024x32 beams, 25 frames)
          starting at rest (the CLI boots its filter with zero velocity),
          scans read through the native prefetcher, IMU rows through the
          host f64 filter, the re-querying tracker, K1 on tracked frames,
          then ``finalize``: ATE/ARE (gate ATE < 0.2 m), the steady ms a
          frame and its FrameStats split (preprocess, tracking, map_prep,
          map_opt), the launch counts (map_loop one a tracked frame,
          gather_lanes at least 4 an IESEKF iteration and 4 a mapping
          batch), the output files;
  classic_arrays  the same frames through ``process_frame(i, points, imu)``
          from memory: the trajectory equal to classic's bit for bit;
  classic_mesh  the classic CLI again with the mesh options (local meshes
          and SDF slices at frame 0 and every 10 frames, one mesh_now and one
          slice_now written to the control file mid-run, mesh.ply at 0.1 m):
          poses equal classic's bit for bit, the files written, the final
          mesh's vertices on the room (median under 0.1 m, at least 10,000),
          the mesh equal under the plain gathers, its time split and
          launches a chunk; then ``python -m clid_slam_torch.tools.inspect_map``
          on the run's checkpoint;
  classic_pgo  12 frames from the files, ``adjust_map`` by a fixed
          correction, 12 more frames on the post-PGO (rotate_vecs) queries:
          K1 once a tracked frame, ATE against the corrected ground truth
          under 0.25 m; ``finalize`` meshes the moved map in the post-PGO
          mode, and its vertices mapped back lie on the room;
  stream_files  the bench's small sequence written to files and run by
          StreamingSlam from them (``points=None``), then ``finalize``: its
          trajectory, losses and iteration counts equal the in-memory
          ``stream`` phase's bit for bit;
  kernels the per-kernel summary line.
Then the nvidia-smi line and, last, {"ok": true, "device": {...}}.

Any failed check raises (non-zero exit, no result line). Without a CUDA
card the script exits non-zero before any phase. Nothing here imports JAX
or clid_slam_tpu.
"""

import argparse
import contextlib
import functools
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the color (1 channel) and 20-class semantic heads of stream_color_sem
COLOR_SEM = dict(color_on=True, color_channel=1, semantic_on=True, sem_class_count=20)

# bench shapes of the mapping kernel (bench.py small config)
BS, K, F, P, H = 16384, 6, 8, 3, 64
DEC, BD = 10, 1638
LR, N_ITERS = 0.01, 10


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_case(n_hidden, layer_norm, device, hidden=H, streamed=False):
    import torch

    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.tools import time_map_loop as tml

    seed = n_hidden * 10 + int(layer_norm) + (hidden != H)
    x = tml.make_inputs(n_hidden, seed=seed, device=device, hidden=hidden)
    kw = dict(tml.KW, layer_norm=layer_norm)
    kernel = functools.partial(ml._launch, True) if streamed else ml.map_loop
    args = lambda n: tml.call_args(x, n, device)
    # one step: rtol 1e-5 / atol 1e-6 elementwise. Adam's first step is
    # lr * g / (|g| + eps): where the plain step is below 0.999 lr the
    # gradient lies within ~1000 eps of zero, i.e. at f32 rounding noise,
    # and the step is a sign function of that noise: there only |diff| < 2 lr
    f1, _, _ = kernel(*args(1), **kw)
    r1, _, _ = ml.map_loop_reference(*args(1), **kw)
    torch.cuda.synchronize()
    d1 = (f1 - r1).abs()
    step = (r1 - x["f0"]).abs()
    noise = (step > 0) & (step < 0.999 * LR)
    err1 = float(d1.max())
    tight = d1 <= 1e-6 + 1e-5 * r1.abs()
    if not bool((tight | (noise & (d1 < 2 * LR))).all()):
        raise AssertionError(f"kernel vs plain, 1 step: max err {err1}")
    n_noise = int((~tight).sum())
    # N steps: the t=1 Adam step is a sign function, so near-zero gradients
    # may flip by ~2 lr under reduction-order noise; the largest error is
    # held to 3 lr for that, and the bulk of the features, the losses and
    # the MLP to tight limits that see gradient magnitudes and the state
    # carried from step to step
    fk, mk, lk = kernel(*args(N_ITERS), **kw)
    fr, mr, lr_ = ml.map_loop_reference(*args(N_ITERS), **kw)
    torch.cuda.synchronize()
    d = (fk - fr).abs().flatten()
    dmax, d99 = float(d.max()), float(torch.quantile(d, 0.99))
    if not (np.isfinite(dmax) and dmax < 3 * LR and d99 <= 1e-5):
        raise AssertionError(f"kernel vs plain, {N_ITERS} steps: max {dmax} p99 {d99}")
    loss_rel = float(((lk - lr_).abs() / lr_.abs()).max())
    if not loss_rel <= 1e-4:
        raise AssertionError(f"losses kernel {lk.tolist()} plain {lr_.tolist()}")
    md = torch.cat([(a - b).abs().flatten() for a, b in zip(mk.tensors(), mr.tensors())])
    mlp_err, mlp_med = float(md.max()), float(md.median())
    if not (mlp_err < 3 * LR and mlp_med <= 1e-5):
        raise AssertionError(f"MLP kernel vs plain: max err {mlp_err} median {mlp_med}")
    call = lambda: kernel(*args(N_ITERS), **kw)
    # bit for bit from call to call (no float atomics)
    again = kernel(*args(N_ITERS), **kw)
    if not all(torch.equal(a, b) for a, b in zip([fk, *mk.tensors(), lk],
                                                [again[0], *again[1].tensors(), again[2]])):
        raise AssertionError("two calls of the kernel on the same inputs differ")
    # ms: CUDA events around calls issued eagerly, host enqueue included (as
    # every kernel of the summary line is timed); device_ms: the profiler's
    # kernel time alone
    ms = tml.eager_ms(call, reps=20)
    device_ms = tml.device_ms(call, reps=20)
    plain_ms = tml.eager_ms(lambda: ml.map_loop_reference(*args(N_ITERS), **kw), reps=3)
    plan = ml.plan(BS, K, P, hidden, n_hidden, layer_norm, BD, DEC, device, streamed)
    return {
        "phase": "kernel", "name": "map_loop", "n_hidden": n_hidden,
        "layer_norm": layer_norm, "bs": BS, "K": K, "F": F, "P": P, "H": hidden,
        "bd": BD, "iters": N_ITERS, "plan": plan._asdict(), "max_abs_err_1step": err1,
        "noise_floor_elems_1step": n_noise,
        "max_abs_err": dmax, "p99_abs_err": d99, "mlp_max_abs_err": mlp_err,
        "mlp_median_abs_err": mlp_med, "losses_max_rel_err": loss_rel,
        "losses_kernel": lk.tolist(), "losses_plain": lr_.tolist(),
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "flop": tml.flops(n_hidden, N_ITERS, hidden), "bytes": tml.nbytes(n_hidden, hidden),
        **tml.bound(n_hidden, N_ITERS, hidden),
        "tolerance": "1 step: atol 1e-6 + rtol 1e-5 (< 2 lr where |g| is at the "
        "noise floor); 10 steps: features max < 3 lr and p99 <= 1e-5, losses "
        "rtol 1e-4, MLP max < 3 lr and median <= 1e-5",
    }


def make_system(large, n_frames, device, seq=None, **overrides):
    """The bench configuration (with ``overrides`` set on it), its sequence
    (made here unless ``seq`` is given) and a seeded StreamingSlam."""
    from clid_slam_torch.pipeline import bench_cases as bc
    from clid_slam_torch.pipeline.streaming import StreamingSlam

    cfg = bc.build_config(large=large)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    if seq is None:
        seq = bc.make_sequence(large, n_frames)
    system = StreamingSlam(cfg, total_frames=bc.TOTAL_FRAMES, device=device)
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], bc.initial_velocity(seq, large))
    return cfg, seq, system


def expected_launches(cfg, n_frames, track_iters, ba_frames):
    """The least gather_rows and gather_lanes launches a run makes: per
    tracked frame the mapper's slab and mirror gathers and the tracker's,
    the insert's and the labels' mirror gathers (6 rows; 8 with the color
    slab), the selection's lane gathers (3 in the tracker, 4 in the
    mapper); with the re-querying
    tracker 3 lane gathers an IESEKF iteration; the dynamic filter's query
    (2 rows, 4 lanes) a tracked frame; the BA's query and pose gather (3
    rows, 4 lanes) an iteration."""
    tracked = sum(1 for i in range(n_frames) if cfg.track_on and i > 0)
    tracker_lanes = 3 * (int(sum(track_iters[1:n_frames])) if not cfg.track_cached else tracked)
    # the color slab's work rows and references: 2 more a tracked frame
    rows, lanes = (8 if cfg.color_on else 6) * tracked, tracker_lanes + 4 * tracked
    if cfg.dynamic_filter_on:
        rows, lanes = rows + 2 * tracked, lanes + 4 * tracked
    n_ba = len(ba_frames) * cfg.ba_iters
    return tracked, rows + 3 * n_ba, lanes + 4 * n_ba


def stream_phase(phase, large, n_frames, warmup, device, fused=True, ate_gate=0.2,
                 **overrides):
    """Drive StreamingSlam over a bench sequence as bench.py times it and
    check the result (ATE under ``ate_gate``). The kernels' launch counts
    are set to 0 just before the run and read just after. ``fused`` says
    whether tracked frames are expected on the map_loop kernel (else on the
    autograd loop). Returns the phase's line and the system."""
    import torch

    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.utils import metrics

    cfg, seq, system = make_system(large, n_frames, device, **overrides)
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    ml.launches = 0  # count only this path's launches
    gt.reset_launches()
    for i in range(min(warmup, n_frames)):
        t0 = time.perf_counter()
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
        system.block()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    system.block()
    t0 = time.perf_counter()
    for i in range(warmup, n_frames):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    system.block()
    steady = (time.perf_counter() - t0) / max(n_frames - warmup, 1)
    launches, gathers = ml.launches, dict(gt.launches)
    out = system.sync()  # the prune counts are device scalars until here
    est = out["odom_poses"][:n_frames]
    if not np.all(np.isfinite(est)) or not np.all(np.isfinite(out["losses"])):
        raise AssertionError("non-finite poses or losses")
    m = metrics.absolute_error(est, seq.poses[:n_frames], align=False)
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    last_err = est[-1, :3, 3] - seq.poses[n_frames - 1, :3, 3]
    ba_frames = out["ba_frames"]
    tracked, want_rows, want_lanes = expected_launches(cfg, n_frames, out["track_iters"], ba_frames)
    res = {
        "phase": phase, "frames": n_frames, "warmup": warmup,
        "warmup_frame_ms": frame_ms, "steady_ms_per_frame": steady * 1e3,
        "ate_rmse_m": m["ate_rmse_m"], "are_rmse_deg": m["are_rmse_deg"],
        "last_frame_error_xyz_m": last_err.tolist(),
        "neural_points": out["neural_points"], "failed": out["failed"],
        "insert_dropped": out["insert_dropped"], "track_iters": out["track_iters"].tolist(),
        "prunes": [{"frame": f, "points_before": b, "points_after": a}
                   for f, b, a in out["prunes"]],
        "map_loop_launches": launches, "gather_rows_launches": gathers["gather_rows"],
        "gather_lanes_launches": gathers["gather_lanes"],
        "tracked_frames": tracked,
        "gather_rows_launches_least": want_rows, "gather_lanes_launches_least": want_lanes,
        "peak_mem_gb": peak_mem_gb,
    }
    if cfg.dynamic_filter_on:
        res["filter_dropped_share"] = [
            {"frame": f, "train_points": b, "dropped": b - a, "share": (b - a) / max(b, 1)}
            for f, b, a in out["filtered"]]
    if ba_frames:
        res["ba"] = {"frames": ba_frames, "iters": cfg.ba_iters, "bs": cfg.ba_bs,
                     "window": cfg.ba_frame, "ms_per_call": out["ba_ms"]}
    emit(res)
    if out["failed"]:
        raise AssertionError("tracking failed")
    if not m["ate_rmse_m"] < ate_gate:
        raise AssertionError(f"ATE {m['ate_rmse_m']} >= {ate_gate} m")
    if launches != (tracked if fused else 0):
        raise AssertionError(f"map_loop launched {launches} times for {tracked} tracked frames")
    if gathers["gather_rows"] < want_rows:
        raise AssertionError(
            f"gather_rows launched {gathers['gather_rows']} times, expected at least {want_rows}"
        )
    if gathers["gather_lanes"] < want_lanes:
        raise AssertionError(
            f"gather_lanes launched {gathers['gather_lanes']} times, expected at least {want_lanes}"
        )
    want_ba = [f for f in range(n_frames) if cfg.ba_freq_frame > 0 and f >= cfg.ba_frame
               and (f + 1) % cfg.ba_freq_frame == 0]
    if ba_frames != want_ba:
        raise AssertionError(f"BA at frames {ba_frames}, expected at {want_ba}")
    if cfg.dynamic_filter_on and [f for f, _, _ in out["filtered"]] != list(range(1, n_frames)):
        raise AssertionError(f"the filter ran at frames {[f for f, _, _ in out['filtered']]}")
    want_prunes = (
        [f for f in range(n_frames) if (f + 1) % cfg.prune_freq_frame == 0]
        if cfg.prune_map_on else []
    )
    if [p["frame"] for p in res["prunes"]] != want_prunes:
        raise AssertionError(f"prunes at {res['prunes']}, expected at frames {want_prunes}")
    if any(not 0 < p["points_after"] <= p["points_before"] for p in res["prunes"]):
        raise AssertionError(f"a prune lost the map or grew it: {res['prunes']}")
    return res, system


def checkpoint_resume(reference, seq, split, device, **overrides):
    """The configuration of ``reference`` (a finished run over the small
    sequence ``seq``) for frames 0..split-1 in a fresh system, saved, loaded
    into another fresh system and continued to the end: every output and
    state tensor must equal the reference run's bit for bit."""
    import tempfile

    import torch

    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml

    n_frames = len(seq.scans)
    cfg, _, first = make_system(False, n_frames, device, seq=seq, **overrides)
    ml.launches = 0
    gt.reset_launches()
    for i in range(split):
        first.process_frame(i, seq.scans[i], seq.imu_windows[i])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.npz")
        t0 = time.perf_counter()
        first.save_checkpoint(path)
        save_s, size_mb = time.perf_counter() - t0, os.path.getsize(path) / 1e6
        del first
        _, _, resumed = make_system(False, n_frames, device, seq=seq, **overrides)
        t0 = time.perf_counter()
        resumed.load_checkpoint(path)
        load_s = time.perf_counter() - t0
    for i in range(split, n_frames):
        resumed.process_frame(i, seq.scans[i], seq.imu_windows[i])
    resumed.block()
    launches, gathers = ml.launches, dict(gt.launches)
    got, want = resumed.sync(), reference.sync()
    differ = [k for k in ("odom_poses", "losses", "track_iters", "travel_dist")
              if not np.array_equal(got[k], want[k])]
    differ += [k for k in ("neural_points", "insert_dropped", "prunes", "filtered", "ba_frames",
                           "failed") if got[k] != want[k]]
    leaves = list(zip(resumed.state.leaves(), reference.state.leaves()))
    differ += [f"leaf {i}" for i, (a, b) in enumerate(leaves) if not (
        torch.equal(a.get_state(), b.get_state()) if isinstance(a, torch.Generator)
        else torch.equal(a, b))]
    res = {"phase": "checkpoint_resume", "frames": n_frames, "saved_after_frame": split - 1,
           "leaves": len(leaves), "file_mb": size_mb, "save_s": save_s, "load_s": load_s,
           "differ": differ, "map_loop_launches": launches,
           "gather_rows_launches": gathers["gather_rows"],
           "gather_lanes_launches": gathers["gather_lanes"]}
    emit(res)
    if differ:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {differ}")
    return res


# the small bench configuration (pipeline/bench_cases.py:build_config) in
# the sections of a config file, over the written dataset's defaults
SMALL_YAML = {
    "process.min_range_m": 0.5, "process.max_range_m": 60.0, "process.vox_down_m": 0.1,
    "sampler.local_voxel_size_m": 0.2, "sampler.surface_sample_range_m": 0.25,
    "sampler.surface_sample_n": 4, "sampler.free_front_sample_n": 2,
    "sampler.free_behind_sample_n": 1, "neuralpoints.voxel_size_m": 0.4,
    "neuralpoints.search_alpha": 0.5, "optimizer.batch_size": 16384, "optimizer.iters": 10,
    "optimizer.init_iter_ratio": 40, "optimizer.adaptive_iters": True,
    "continual.batch_size_new_sample": 1000, "continual.pool_filter_freq": 10,
    "tracker.iter_n": 50, "tracker.source_vox_down_m": 0.6, "decoder.freeze_after_frame": 15,
    "loss.loss_weight_on": True, "tpu.map_capacity": 1 << 18, "tpu.map_hash_size": 1 << 22,
    "tpu.local_map_capacity": 1 << 19, "tpu.local_map_hash_size": 1 << 21,
    "tpu.max_scan_points": 1 << 15, "tpu.max_source_points": 1 << 13,
    "tpu.pool_capacity": 1 << 21, "eval.save_mesh": False, "eval.silence_log": True,
}


def write_small_dataset(root, n_frames, rest_start, seq=None, extra=None):
    """The small sequence written in the converter's layout with the small
    configuration (and the config entries ``extra``): ``rest_start`` ramps
    the platform up from rest over 6 frames (the file-based CLI boots its
    filter with zero velocity), else the bench's own sequence; ``seq``
    reuses one made before. Returns (sequence, config path, the config
    differences from bench_cases.build_config)."""
    import dataclasses

    from clid_slam_torch.config import Config
    from clid_slam_torch.pipeline import bench_cases as bc
    from clid_slam_torch.pipeline.synthetic import generate_sequence, write_sequence_dataset

    if seq is None:
        seq = (generate_sequence(n_frames=n_frames, n_azimuth=1024, n_elev=32, noise_std=0.01,
                                 seed=3, ramp_frames=6)
               if rest_start else bc.make_sequence(False, n_frames))
    path = write_sequence_dataset(seq, root, {**SMALL_YAML, **(extra or {})})
    loaded, bench = Config.load(path), bc.build_config(False)
    differ = sorted(f.name for f in dataclasses.fields(loaded) if f.name not in (
        "name", "run_name", "output_root", "pc_path", "imu_path", "pose_path")
        and not np.array_equal(np.asarray(getattr(loaded, f.name)), np.asarray(getattr(bench, f.name))))
    return seq, path, differ


@contextlib.contextmanager
def captured_systems(cls):
    """Collect every ``cls`` instance that ``finalize`` runs on (the CLI
    returns only the metrics)."""
    seen, orig = [], cls.finalize

    def finalize(self, run_path):
        seen.append(self)
        return orig(self, run_path)

    cls.finalize = finalize
    try:
        yield seen
    finally:
        cls.finalize = orig


def imu_rows(seq, i):
    w = seq.imu_windows[i]
    return np.zeros((1, 7)) if w is None else w


def classic_phase(device, root, n_frames=25, warmup=10):
    """The CLI (``run_slam``) on a written small sequence that starts at
    rest: scans read through the native prefetcher, IMU rows from the
    CSV files through the host f64 filter, the re-querying tracker, K1 on
    tracked frames, then ``finalize``. Launch counts set to 0 just before
    and read just after."""
    from clid_slam_torch import native
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.pipeline import slam as tslam

    seq, path, differ = write_small_dataset(root, n_frames, rest_start=True)
    ml.launches = 0
    gt.reset_launches()
    t0 = time.perf_counter()
    with captured_systems(tslam.SlamSystem) as seen:
        result = tslam.run_slam(path, device=device)
    wall_s = time.perf_counter() - t0
    launches, gathers = ml.launches, dict(gt.launches)
    system = seen[0]
    stats = system.stats
    steady = [st for st in stats if st.frame_id >= warmup]
    split = {k: float(np.mean([st.timings[k] for st in steady]) * 1e3)
             for k in ("preprocess", "tracking", "map_prep", "map_opt")}
    iters = [st.track_iters for st in stats]
    tracked = sum(1 for st in stats if st.frame_id > 0)
    lanes_least = 4 * int(sum(iters)) + 4 * tracked
    files = ("metrics.json", "odom_poses_kitti.txt", "odom_poses_tum.txt", "time_table.csv",
             "map_checkpoint.npz", "neural_points.ply")
    missing = [f for f in files if not os.path.isfile(os.path.join(system.run_path, f))]
    res = {
        "phase": "classic", "frames": n_frames, "warmup": warmup, "config_differs_from_bench": differ,
        "native_reader": native.available() and system.dataset._frame_loader() is not None,
        "wall_s": wall_s, "steady_ms_per_frame": float(sum(split.values())),
        "frame_stats_ms": split,
        "ate_rmse_m": result["ate_rmse_m_noalign"], "are_rmse_deg": result["are_rmse_deg_noalign"],
        "neural_points": result["neural_points"], "track_iters": iters,
        "map_loop_launches": launches, "tracked_frames": tracked,
        "gather_rows_launches": gathers["gather_rows"],
        "gather_lanes_launches": gathers["gather_lanes"], "gather_lanes_launches_least": lanes_least,
        "missing_files": missing,
    }
    emit(res)
    if missing:
        raise AssertionError(f"the CLI did not write {missing}")
    if not res["native_reader"]:
        raise AssertionError(f"scans not read natively: {native.why_unavailable()}")
    if not result["ate_rmse_m_noalign"] < 0.2:
        raise AssertionError(f"classic ATE {result['ate_rmse_m_noalign']} >= 0.2 m")
    if launches != tracked:
        raise AssertionError(f"map_loop launched {launches} times for {tracked} tracked frames")
    if gathers["gather_lanes"] < lanes_least:
        raise AssertionError(f"gather_lanes launched {gathers['gather_lanes']} times, "
                             f"expected at least {lanes_least}")
    if gathers["gather_rows"] < 2 * int(sum(iters)):
        raise AssertionError(f"gather_rows launched {gathers['gather_rows']} times")
    return res, seq, path, system


def classic_arrays_phase(device, seq, path, reference):
    """The same frames from memory (``process_frame(i, points, imu)``):
    the trajectory must equal the CLI run's bit for bit."""
    from clid_slam_torch.config import Config
    from clid_slam_torch.pipeline import slam as tslam

    system = tslam.SlamSystem(Config.load(path), device=device)
    n = len(seq.scans)
    for i in range(n):
        system.process_frame(i, seq.scans[i], imu_rows(seq, i))
    got, want = system.dataset.odom_poses[:n], reference.dataset.odom_poses[:n]
    res = {"phase": "classic_arrays", "frames": n, "bit_equal": bool(np.array_equal(got, want)),
           "max_abs_diff": float(np.abs(got - want).max())}
    emit(res)
    if not res["bit_equal"]:
        raise AssertionError("the run from memory differs from the run from the files")
    return res


def classic_pgo_phase(device, seq, path, split=12):
    """``split`` frames from the files, then ``adjust_map`` by a fixed
    correction (tests/test_slam_integration.py:137's), then the rest of the
    frames on the post-PGO (rotate_vecs) queries: K1 still once a tracked
    frame, ATE against the corrected ground truth under 0.25 m. Then
    ``finalize`` with ``save_mesh`` at 0.1 m: the mesh of the moved map,
    queried in the post-PGO mode, mapped back through the correction, must
    lie on the synthetic room (median distance under 0.1 m)."""
    from clid_slam_torch.config import Config
    from clid_slam_torch.odometry.iekf import _so3_exp
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.pipeline import slam as tslam
    from clid_slam_torch.tools.convert import _read_mesh_ply
    from clid_slam_torch.utils import metrics

    n = min(len(seq.scans), 2 * split)
    cfg = Config.load(path)
    cfg.save_mesh, cfg.mc_res_m = True, 0.1
    system = tslam.SlamSystem(cfg, device=device)
    ml.launches = 0
    gt.reset_launches()
    for i in range(split):
        system.process_frame(i)
    D = np.eye(4)
    D[:3, :3] = _so3_exp(np.array([0.0, 0.0, 0.05]))
    D[:3, 3] = [0.2, -0.1, 0.05]
    x = system.tracker.x
    system.adjust_map(np.einsum("ij,tjk->tik", D, system.dataset.odom_poses[:split]))
    x.rot, x.pos, x.vel = D[:3, :3] @ x.rot, D[:3, :3] @ x.pos + D[:3, 3], D[:3, :3] @ x.vel
    before_pgo = ml.launches
    lost = [i for i in range(split, n) if not system.process_frame(i).tracking_ok]
    launches, gathers = ml.launches, dict(gt.launches)
    m = metrics.absolute_error(system.dataset.odom_poses[:n],
                               np.einsum("ij,tjk->tik", D, seq.poses[:n]), align=False)
    t0 = time.perf_counter()
    result = system.finalize(system.run_path)
    mesh_s = time.perf_counter() - t0
    v, _, _ = _read_mesh_ply(os.path.join(system.run_path, "mesh.ply"))
    back = (v - D[:3, 3]) @ D[:3, :3]  # D^-1 v: the room's own frame
    dist = distance_stats(seq.world, back)
    res = {"phase": "classic_pgo", "frames": n, "adjusted_after_frame": split - 1,
           "after_pgo": system.after_pgo, "ate_rmse_m": m["ate_rmse_m"],
           "are_rmse_deg": m["are_rmse_deg"], "lost_frames": lost,
           "map_loop_launches": launches, "map_loop_launches_after_pgo": launches - before_pgo,
           "tracked_frames": n - 1, "gather_rows_launches": gathers["gather_rows"],
           "gather_lanes_launches": gathers["gather_lanes"],
           "post_pgo_mesh": {"mesher_rotate_vecs": system.mesher.query_kw["rotate_vecs"],
                             "finalize_s": mesh_s, "mesh_vertices": result["mesh_vertices"],
                             **dist}}
    emit(res)
    if not system.after_pgo or lost:
        raise AssertionError(f"post-PGO run: after_pgo {system.after_pgo}, lost frames {lost}")
    if launches != n - 1:
        raise AssertionError(f"map_loop launched {launches} times for {n - 1} tracked frames")
    if not m["ate_rmse_m"] < 0.25:
        raise AssertionError(f"post-PGO ATE {m['ate_rmse_m']} >= 0.25 m")
    if not (system.mesher.query_kw["rotate_vecs"] and dist["p50_m"] < 0.1 and len(v) >= 10000):
        raise AssertionError(f"post-PGO mesh: {res['post_pgo_mesh']}")
    return res


def stream_files_phase(device, root, reference, n_frames=25):
    """The bench's small sequence written to files and run by StreamingSlam
    from them (``points=None``), then ``finalize``: its trajectory, losses
    and iteration counts equal the in-memory ``stream`` phase's
    (``reference``) bit for bit."""
    from clid_slam_torch.config import Config
    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.pipeline import bench_cases as bc
    from clid_slam_torch.pipeline.streaming import StreamingSlam

    seq, path, differ = write_small_dataset(root, n_frames, rest_start=False)
    cfg = Config.load(path)
    cfg.diff_travel_dist_local = 1e9  # as build_config sets it for the small scale
    system = StreamingSlam(cfg, total_frames=bc.TOTAL_FRAMES, device=device)
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], bc.initial_velocity(seq, False))
    ml.launches = 0
    for i in range(n_frames):
        system.process_frame(i)
    launches = ml.launches
    result = system.finalize(os.path.join(root, "stream_out"))
    got, want = system.sync(), reference.sync()
    differ_out = [k for k in ("odom_poses", "losses", "track_iters") if not np.array_equal(got[k], want[k])]
    res = {"phase": "stream_files", "frames": n_frames, "config_differs_from_bench": differ,
           "ate_rmse_m": result["ate_rmse_m_noalign"], "map_loop_launches": launches,
           "differs_from_stream": differ_out,
           "max_pose_diff": float(np.abs(got["odom_poses"] - want["odom_poses"]).max())}
    emit(res)
    if differ_out:
        raise AssertionError(f"the run from the files differs from the stream phase: {differ_out}")
    if launches != n_frames - 1:
        raise AssertionError(f"map_loop launched {launches} times for {n_frames - 1} tracked frames")
    return res


# the classic run's mesh options (classic_mesh), over SMALL_YAML: meshes and
# slices at frame 0 and every 10 frames, the final mesh at 0.1 m
MESH_YAML = {
    "eval.save_mesh": True, "eval.mesh_default_on": True, "eval.mesh_freq_frame": 10,
    "eval.sdf_default_on": True, "eval.sdf_freq_frame": 10, "eval.vis_sdf_slice_v": True,
    "eval.mc_res_m": 0.1,
}
# frames before which classic_mesh writes a command to the control file
CONTROL_AT = {5: {"mesh_now": True}, 14: {"slice_now": True}}


def surface_distance(world, pts):
    """Each point's distance to the nearest analytic surface of the
    synthetic ``world``: the room's cylinder wall, its floor and ceiling,
    the pillars (cylinders) and the boxes."""
    p = np.asarray(pts, np.float64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    d = np.abs(np.hypot(x, y) - world.room_radius)
    d = np.minimum(d, np.minimum(np.abs(z - world.floor_z), np.abs(z - world.ceil_z)))
    for cx, cy, r in world.pillars:
        d = np.minimum(d, np.abs(np.hypot(x - cx, y - cy) - r))
    for cx, cy, hx, hy, z0, z1 in world.boxes:
        q = np.abs(p - [cx, cy, (z0 + z1) / 2]) - [hx, hy, (z1 - z0) / 2]
        box = np.linalg.norm(np.maximum(q, 0), axis=1) + np.minimum(q.max(1), 0)
        d = np.minimum(d, np.abs(box))
    return d


def distance_stats(world, verts):
    d = surface_distance(world, verts)
    return {"vertices": len(verts), "p50_m": float(np.median(d)),
            "p90_m": float(np.quantile(d, 0.9)), "p99_m": float(np.quantile(d, 0.99))}


@contextlib.contextmanager
def control_writes(cls, schedule):
    """Write ``schedule[i]`` to the run's control file just before
    ``cls.process_frame(i)`` (an operator steering a running CLI)."""
    orig = cls.process_frame

    def process_frame(self, frame_id, *args, **kw):
        if frame_id in schedule:
            os.makedirs(self.run_path, exist_ok=True)
            with open(os.path.join(self.run_path, "control.json"), "w") as f:
                json.dump(schedule[frame_id], f)
        return orig(self, frame_id, *args, **kw)

    cls.process_frame = process_frame
    try:
        yield
    finally:
        cls.process_frame = orig


def counted_soup(mesher, state, mlp, pts, mc_res, **kw):
    """``mesher.triangle_soup`` over ``pts``' AABB, guided by ``pts``, with
    the gathers' launches set to 0 just before and read just after; returns
    (soup, chunks, launches, seconds)."""
    import torch

    from clid_slam_torch.ops import gather as gt

    gt.reset_launches()
    t0 = time.perf_counter()
    soup, chunks = mesher.triangle_soup(state, mlp, pts.min(0), pts.max(0), mc_res,
                                        guide_points=pts, **kw)
    torch.cuda.synchronize()
    return soup, chunks, dict(gt.launches), time.perf_counter() - t0


def weld_timed(soup, mc_res, min_cluster):
    """``_weld_mesh`` of ``soup`` and, apart, its cluster filter: (verts,
    tris, weld seconds without the filter, the filter's seconds)."""
    from clid_slam_torch.mesher import _cluster_keep, _weld_mesh

    t0 = time.perf_counter()
    v, t = _weld_mesh(soup, mc_res)
    t1 = time.perf_counter()
    if min_cluster > 1 and len(v):
        t = t[_cluster_keep(t, len(v), min_cluster)]
    return v, t, t1 - t0, time.perf_counter() - t1


def classic_mesh_phase(device, root, seq, reference_poses, reference_ate, profile=False):
    """The classic CLI on the classic phase's sequence, written with the
    mesh options (MESH_YAML) and steered mid-run through the control file
    (CONTROL_AT): the trajectory and ATE must equal the classic phase's
    bit for bit (meshing reads the map and draws no random numbers); the
    local meshes, slices and ``mesh.ply`` must be written; the final mesh's
    vertices must lie on the synthetic room (median distance under
    ``mc_res_m`` over at least 10,000 vertices); meshing the final map again
    under ``plain_gathers()`` must give the same vertices and triangles bit
    for bit. Then the inspector's CLI on the run's checkpoint."""
    import subprocess

    from clid_slam_torch.config import Config
    from clid_slam_torch.pipeline import slam as tslam
    from clid_slam_torch.tools.convert import _read_mesh_ply

    n_frames = len(seq.scans)
    _, path, _ = write_small_dataset(root, n_frames, True, seq=seq, extra=MESH_YAML)
    cfg = Config.load(path)
    with captured_systems(tslam.SlamSystem) as seen, control_writes(tslam.SlamSystem, CONTROL_AT):
        result = tslam.run_slam(path, device=device)
    system = seen[0]
    run = system.run_path
    mesh_frames = sorted({0, *range(cfg.mesh_freq_frame - 1, n_frames, cfg.mesh_freq_frame),
                          *(i for i, c in CONTROL_AT.items() if c.get("mesh_now"))})
    slice_frames = sorted({0, *range(cfg.sdfslice_freq_frame - 1, n_frames, cfg.sdfslice_freq_frame),
                           *(i for i, c in CONTROL_AT.items() if c.get("slice_now"))})
    want = (["mesh.ply"] + [f"mesh/mesh_{i}.ply" for i in mesh_frames]
            + [f"sdf_slice/{k}_{i}.ply" for i in slice_frames for k in ("slice", "slice_v")])
    missing = [f for f in want if not os.path.isfile(os.path.join(run, f))]
    mesh_ms = {st.frame_id: st.timings["mesh"] * 1e3 for st in system.stats if st.timings["mesh"]}

    # the final map again: the device loop, the weld and its cluster filter
    # apart, each chunk's launches; then the whole mesh under the plain gathers
    n = int(system.map_state.count)
    pts = system.map_state.positions[:n].cpu().numpy()
    kw = dict(pad_voxel=cfg.pad_voxel, skip_top_voxel=cfg.skip_top_voxel)
    soup, chunks, launches, soup_s = counted_soup(system.mesher, system.map_state, system.mlp, pts,
                                                  cfg.mc_res_m, **kw)
    v, t, weld_s, cluster_s = weld_timed(soup, cfg.mc_res_m, cfg.min_cluster_vertices)
    recon = lambda: system.mesher.recon_aabb_mesh(
        system.map_state, system.mlp, pts.min(0), pts.max(0), cfg.mc_res_m, cfg.pad_voxel,
        cfg.min_cluster_vertices, guide_points=pts, skip_top_voxel=cfg.skip_top_voxel)
    with plain_gathers():
        pv, pt = recon()
    fv, ft, _ = _read_mesh_ply(os.path.join(run, "mesh.ply"))
    exact = (np.array_equal(v, pv) and np.array_equal(t, pt)
             and np.array_equal(fv, v.astype(np.float64)) and np.array_equal(ft, t))
    dist = distance_stats(seq.world, v)
    poses_equal = bool(np.array_equal(system.dataset.odom_poses[:n_frames], reference_poses))

    out = os.path.join(root, "inspect")
    cli = subprocess.run(
        [sys.executable, "-m", "clid_slam_torch.tools.inspect_map",
         os.path.join(run, "map_checkpoint.npz"), "-m", "0.15", "--sdf-slice-height", "0",
         "-o", out], cwd=REPO, capture_output=True, text=True, timeout=600)
    inspect_files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    res = {"phase": "classic_mesh", "frames": n_frames, "mc_res_m": cfg.mc_res_m,
           "ate_rmse_m": result["ate_rmse_m_noalign"], "poses_equal_classic": poses_equal,
           "mesh_frames": mesh_frames, "slice_frames": slice_frames, "missing_files": missing,
           "frame_mesh_ms": mesh_ms, "mesh_vertices": result.get("mesh_vertices"),
           "final_mesh": {"chunks": chunks, "triangles_soup": len(soup), "triangles": len(t),
                          "device_loop_s": soup_s, "weld_s": weld_s, "cluster_filter_s": cluster_s,
                          "launches_per_chunk": {k: c / chunks for k, c in launches.items()},
                          **dist},
           "plain_gathers_exact": exact,
           "inspect_map": {"rc": cli.returncode, "files": inspect_files,
                           "stdout": cli.stdout.strip().splitlines()[-2:]}}
    emit(res)
    wrong = []
    if not poses_equal or result["ate_rmse_m_noalign"] != reference_ate:
        wrong.append("the trajectory differs from the classic phase's")
    if missing:
        wrong.append(f"missing {missing}")
    if not (dist["p50_m"] < cfg.mc_res_m and len(v) >= 10000):
        wrong.append(f"mesh off the room: {dist}")
    if not exact:
        wrong.append("the mesh through the kernels differs from the plain gathers' or mesh.ply")
    if launches["gather_rows"] < 2 * chunks or launches["gather_lanes"] < 4 * chunks:
        wrong.append(f"launches {launches} for {chunks} chunks")
    if cli.returncode != 0 or inspect_files != ["mesh.ply", "neural_points.ply", "sdf_slice.ply"]:
        wrong.append(f"inspect_map: rc {cli.returncode}, {inspect_files}, {cli.stderr[-2000:]}")
    if wrong:
        raise AssertionError(f"classic_mesh: {wrong}")
    if profile:
        mesh_profile(system, pts, cfg)
    return res


def config_mesher(cfg, system, **kw):
    """The Mesher that ``SlamSystem`` builds for ``cfg``, for a
    StreamingSlam ``system``'s map."""
    from clid_slam_torch.mesher import Mesher
    from clid_slam_torch.pipeline.streaming import _max_valid_dist2

    return Mesher(knn_k=cfg.query_nn_k, nb_offs=system.nb_offs, resolution=cfg.voxel_size_m,
                  max_valid_dist2=_max_valid_dist2(cfg), sdf_scale=cfg.sdf_scale,
                  mesh_min_nn=cfg.mesh_min_nn, mlp_leaky=cfg.mlp_leaky_relu, mlp_bf16=cfg.mlp_bf16,
                  feature_dim=cfg.feature_dim, encode_vecs=system.encode_vecs,
                  weighted_first=cfg.weighted_first, layer_norm=cfg.layer_norm_on, **kw)


def mesh_large(system, seq, n_frames, mc_res=0.1, window_m=20.0, limit_s=60.0):
    """The large run's final map meshed at the large configuration's widths
    (chunk_dim 48, ``mc_res`` 0.1 m). The whole map's chunks run first (the
    device loop, timed, with its launches a chunk). Then the map points
    within ``window_m`` (the large configuration's track_max_range) of the
    last pose, as ``_write_local_mesh`` cuts its window, are meshed and
    welded, the weld and its cluster filter timed apart. If the whole map's
    device loop and its weld, projected from the window's weld rate a soup
    triangle, fit in ``limit_s``, the whole soup is welded instead. Vertex
    distances to the world's surfaces of the mesh kept, and again with the
    vertices moved by the last pose's error (truth times the inverse of the
    estimate: the map around the last pose was built at poses that carry
    about that error, so this part is the trajectory's, not the mesher's);
    both triangle soups
    (which the weld turns into the mesh) again under ``plain_gathers()``:
    equal bit for bit."""
    cfg, st = system.cfg, system.state
    mesher = config_mesher(cfg, system, chunk_dim=48)
    n = int(st.map_state.count)
    pts = st.map_state.positions[:n].cpu().numpy()
    center = st.odom_poses[n_frames - 1, :3, 3].cpu().numpy()
    near = pts[np.linalg.norm(pts - center, axis=-1) < window_m]
    kw = dict(pad_voxel=cfg.pad_voxel, skip_top_voxel=cfg.skip_top_voxel)
    soups, exact = {}, True
    for name, guide in (("whole", pts), ("window", near)):
        soup, chunks, launches, soup_s = counted_soup(mesher, st.map_state, st.mlp, guide, mc_res,
                                                      **kw)
        with plain_gathers():
            plain, _ = mesher.triangle_soup(st.map_state, st.mlp, guide.min(0), guide.max(0),
                                            mc_res, guide_points=guide, **kw)
        exact &= bool(np.array_equal(soup, plain))
        soups[name] = dict(soup=soup, chunks=chunks, guide_points=len(guide),
                           triangles_soup=len(soup), device_loop_s=soup_s,
                           ms_per_chunk=soup_s / chunks * 1e3,
                           launches_per_chunk={k: c / chunks for k, c in launches.items()})
        del plain
    v, t, weld_s, cluster_s = weld_timed(soups["window"]["soup"], mc_res, cfg.min_cluster_vertices)
    rate = (weld_s + cluster_s) / len(soups["window"]["soup"])
    whole = soups["whole"]
    whole["projected_s"] = whole["device_loop_s"] + rate * whole["triangles_soup"]
    meshed = "whole" if whole["projected_s"] <= limit_s else "window"
    if meshed == "whole":
        v, t, weld_s, cluster_s = weld_timed(whole["soup"], mc_res, cfg.min_cluster_vertices)
    for d in soups.values():
        del d["soup"]
    err = seq.poses[n_frames - 1] @ np.linalg.inv(st.odom_poses[n_frames - 1].cpu().double().numpy())
    res = {"phase": "mesh_large", "map_points": n, "mc_res_m": mc_res, "chunk_dim": 48,
           "window_m": window_m, "limit_s": limit_s, "meshed": meshed, **soups,
           "triangles": len(t), "weld_s": weld_s, "cluster_filter_s": cluster_s,
           "mesh_s": soups[meshed]["device_loop_s"] + weld_s + cluster_s,
           **distance_stats(seq.world, v),
           "corrected_by_last_pose_error": distance_stats(seq.world, v @ err[:3, :3].T + err[:3, 3]),
           "plain_gathers_exact": exact}
    emit(res)
    if not exact or len(v) == 0:
        raise AssertionError(f"mesh_large: exact {exact}, {len(v)} vertices")
    for name, d in soups.items():
        if d["launches_per_chunk"]["gather_rows"] < 2 or d["launches_per_chunk"]["gather_lanes"] < 4:
            raise AssertionError(f"mesh_large {name}: launches a chunk {d['launches_per_chunk']}")
    return res


def mesh_profile(system, pts, cfg):
    """torch.profiler over the device loop of the classic run's final mesh:
    device ms by op and by launch span (``mesh.query``, ``mesh.decode``,
    ``mesh.marching``, ``mesh.compaction``), the busy share of the loop,
    then the host ms of the weld and of its cluster filter (union-find)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(pad_voxel=cfg.pad_voxel, skip_top_voxel=cfg.skip_top_voxel)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        soup, chunks = system.mesher.triangle_soup(system.map_state, system.mlp, pts.min(0),
                                                   pts.max(0), cfg.mc_res_m, guide_points=pts, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    self_dev_ms = lambda e: getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == cuda and not is_stage(e.key)),
                     key=self_dev_ms, reverse=True)
    busy_ms = sum(self_dev_ms(e) for e in kernels)
    by_op = [{"op": e.key[:80], "device_ms": self_dev_ms(e), "calls": e.count}
             for e in sorted((e for e in prof.key_averages() if e.device_type != cuda
                              and e.key.startswith("aten::") and self_dev_ms(e) > 0),
                             key=self_dev_ms, reverse=True)[:15]]
    spans, hand = launch_attribution(prof, 1)
    _, _, weld_s, cluster_s = weld_timed(soup, cfg.mc_res_m, cfg.min_cluster_vertices)
    emit({"phase": "profile_mesh", "chunks": chunks, "triangles_soup": len(soup),
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "device_ms_by_span": spans, "hand_kernels_by_span": hand,
          "top_kernels": [{"name": e.key[:80], "device_ms": self_dev_ms(e), "calls": e.count}
                          for e in kernels[:15]],
          "device_ms_by_op": by_op, "host_weld_ms": weld_s * 1e3,
          "host_union_find_ms": cluster_s * 1e3})


@contextlib.contextmanager
def plain_gathers():
    """The gather wrappers swapped for their plain PyTorch versions, which
    then run on the card too, to hold a computation through the kernels
    against the same computation without them."""
    import torch

    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops import gather as gt

    def lanes(src, sel):
        if src.requires_grad and torch.is_grad_enabled():
            return gt._LanesBackward.apply(src, sel)  # its forward calls the swapped wrapper
        return gt.gather_lanes_reference(src, sel)

    saved = gt.gather_rows, gt.gather_lanes, nm.gather_lanes
    gt.gather_rows, gt.gather_lanes, nm.gather_lanes = gt.gather_rows_reference, lanes, lanes
    try:
        yield
    finally:
        gt.gather_rows, gt.gather_lanes, nm.gather_lanes = saved


def gradient_check(system, seq, n_frames, device):
    """The gradients that the dynamic filter and BA take through the gather
    kernels, at their full-width shapes on the map that ``system`` (a
    finished stream_dynba run) ends with: ``query_feature``'s decoded SDF
    wrt the points and the map's features at the filter's points (the last
    scan in the world frame) and at BA's (``ba_bs`` pool samples), and BA's
    window-pose gather (``gather_rows_nd``'s sorted backward) at its
    [window, 4, 4] poses by ``ba_bs`` window rows; at the filter's points
    also decode-then-weight's (each neighbour decoded, then weighted) wrt
    the points and the features, and ``query_color_feature``'s decoded color
    wrt a color slab of feature_dim columns. Each through the kernels twice
    and through their plain versions on the card once: all three equal bit
    for bit."""
    from dataclasses import replace

    import torch

    from clid_slam_torch.mapping.pool import split_rows
    from clid_slam_torch.models import decoder as dec
    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops import gather as gt

    cfg, st = system.cfg, system.state
    cur, w = n_frames - 1, cfg.ba_frame
    offs = torch.as_tensor(system.nb_offs, device=device)
    dist2 = 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2
    pose = st.odom_poses[cur]
    scan = torch.from_numpy(np.asarray(seq.scans[cur][:, :3], np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    draw = torch.randint(0, int(st.pool.size), (cfg.ba_bs,), generator=gen, device=device)
    samples, _, _, ts, _, _ = split_rows(st.pool.data[draw])
    w_idx = torch.clamp(ts - (cur - w + 1), 0, w - 1).long()
    poses = st.odom_poses[cur - w + 1 : cur + 1]
    cot = torch.randn((cfg.ba_bs, 4, 4), generator=gen, device=device)

    # a color slab of feature_dim columns (the dynba map has none), from a seed
    color_feats = torch.randn((st.map_state.geo_feats.shape[0], cfg.feature_dim),
                              generator=gen, device=device)

    def query(state, points, weighted_first=True):
        return nm.query_feature(state, points, offs, cfg.voxel_size_m, dist2, cfg.query_nn_k,
                                st.travel_dist, cur, cfg.diff_travel_dist_local, True,
                                encode_vecs=system.encode_vecs, weighted_first=weighted_first)

    def query_grads(points, weighted_first=True):
        p = points.clone().requires_grad_(True)
        f = st.map_state.geo_feats.clone().requires_grad_(True)
        q = query(replace(st.map_state, geo_feats=f), p, weighted_first)
        pred = dec.sdf(st.mlp, q.feature, cfg.sdf_scale, leaky=cfg.mlp_leaky_relu)
        if not weighted_first:  # decode-then-weight
            pred = torch.sum(pred * q.weights, dim=1)
        return torch.autograd.grad(torch.sum(pred + pred**2), (p, f))

    def color_grads(points):
        c = color_feats.clone().requires_grad_(True)
        state = replace(st.map_state, color_feats=c)
        cf = nm.query_color_feature(state, query(state, points), cfg.feature_dim)
        return torch.autograd.grad(torch.sum(dec.regress_color(st.color_mlp, cf)), c)

    def pose_grad():
        t = poses.clone().requires_grad_(True)
        return torch.autograd.grad(torch.sum(gt.gather_rows_nd(t, w_idx) * cot), t)

    world = scan @ pose[:3, :3].T + pose[:3, 3]
    cases = (
        ("filter", ("points", "features"), lambda: query_grads(world),
         {"gather_rows": 2, "gather_lanes": 4}),
        ("filter_decode_then_weight", ("points", "features"), lambda: query_grads(world, False),
         {"gather_rows": 2, "gather_lanes": 4}),
        ("filter_color_query", ("color_feats",), lambda: color_grads(world),
         {"gather_rows": 3, "gather_lanes": 4}),
        ("ba", ("points", "features"), lambda: query_grads(samples),
         {"gather_rows": 2, "gather_lanes": 4}),
        ("ba_pose_gather", ("poses",), pose_grad, {"gather_rows": 1, "gather_lanes": 0}),
    )
    res = {"phase": "gradient_check", "map_points": int(st.map_state.count), "cases": []}
    wrong = []
    for name, wrt, grads, want in cases:
        gt.reset_launches()
        kernel = grads()
        launches = {k: gt.launches[k] for k in want}
        again = grads()
        with plain_gathers():
            plain = grads()
        if gt.launches["gather_rows"] + gt.launches["gather_lanes"] != sum(want.values()) * 2:
            wrong.append(f"{name}: launches {dict(gt.launches)}")
        if launches != want:
            wrong.append(f"{name}: launched {launches}, expected {want}")
        for label, k, a, p in zip(wrt, kernel, again, plain):
            exact = torch.equal(k, a) and torch.equal(k, p)
            rows = int((k.reshape(k.shape[0], -1).abs().sum(1) > 0).sum())
            res["cases"].append({"case": name, "wrt": label, "shape": list(k.shape),
                                 "rows_with_gradient": rows, "max_abs": float(k.abs().max()),
                                 "max_abs_err": float((k - p).abs().max()), "exact": exact,
                                 "launches": launches})
            if not exact:
                wrong.append(f"{name} wrt {label}: kernels and plain versions differ")
            if rows == 0:
                wrong.append(f"{name} wrt {label}: no gradient")
    res["tolerance"] = "exact: torch.equal, kernels twice and plain versions on the card"
    emit(res)
    if wrong:
        raise AssertionError(f"gradient_check: {wrong}")
    return res


@contextlib.contextmanager
def one_rank_group(device):
    """A process group of one rank (NCCL on the card, gloo on the CPU)
    through a FileStore in a temporary directory."""
    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                                world_size=1)
        try:
            yield dist.get_backend()
        finally:
            dist.destroy_process_group()


def sharded_phase(system, seq, n_frames, device):
    """The sharded runtime (``clid_slam_torch/parallel``) at world size 1 on
    NCCL, at the large configuration's widths: a shard of 2 x map_capacity
    rows and a 2 x map_hash_size table (``slam_sharded.py:79-80`` at one
    shard), filled by ``insert_fn`` with the points of the map that
    ``system`` (the finished large run) ends with, 32768 a call, beside a
    single map filled by ``insert_points`` with the same calls; the shard
    then takes that run's features and certainty row by row. Checked:
    - the shard equals the single map bit for bit after the inserts;
    - ``query_fn`` at 16384 pool rows: ``nn_count`` and each row's selected
      map rows equal ``query_feature``'s on the single map, features within
      1e-5; the sharded certainty equals ``query_certainty_max`` bit for bit;
    - ``mapping_fn`` in each body (cached, batch-sharded, replicated), 10
      iterations of bs 16384 from the shard's untrained features (the run's
      MLP and pool, one generator seed): losses finite, the last step's SDF
      loss under the first step's; the first step's SDF loss, on one batch in
      all three bodies, within rtol 2e-3; the batch-sharded and replicated
      bodies' features, MLP and losses within rtol 2e-3 / atol 2e-4
      (test_spatial.py:222), certainty within 2e-3; the cached body twice
      and under ``plain_gathers()`` bit for bit;
    - ``make_dp_mapping_fn`` twice (10 iterations) bit for bit;
    - ``make_sharded_tracker_fn`` on the last scan (its points within
      ``track_max_range``, 8192 of them) from the run's last pose moved by 5
      cm: pose within 1e-4 of the single-device ``make_cached_update_fn`` on
      the single map, iteration counts within 1.
    ms per call (CUDA events) and the gathers' launches per call; the
    launch counts are set to 0 before the driven calls and read after."""
    import torch

    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.odometry import iekf
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.ops.voxel import grid_coords, voxel_hash
    from clid_slam_torch.parallel import data_parallel as dp
    from clid_slam_torch.parallel import spatial as sp
    from clid_slam_torch.pipeline.streaming import mapping_kwargs

    cfg, st = system.cfg, system.state
    big, pool, mlp = st.map_state, st.pool, st.mlp
    cur, travel, window = n_frames - 1, st.travel_dist, cfg.diff_travel_dist_local
    res_m = cfg.voxel_size_m
    offs = torch.as_tensor(system.nb_offs, device=device)
    mk = mapping_kwargs(cfg, system.nb_offs, system.encode_vecs)
    kw = {k: mk[k] for k in ("feature_dim", "knn_k", "nb_offs", "resolution", "max_valid_dist2",
                             "sdf_scale", "sigma", "bs", "bs_new", "gradient_decimation",
                             "num_grad_eps", "weight_e", "loss_weight_on", "lr", "adam_eps",
                             "mlp_leaky", "mlp_bf16", "encode_vecs")}
    mvd2 = kw["max_valid_dist2"]
    cap, hsize = 2 * cfg.map_capacity, 2 * cfg.map_hash_size
    wrong, calls = [], {}

    def timed(name, fn):
        """fn() with CUDA events around it (the host clock on the CPU, where
        the phase is rehearsed); its ms and gather launches."""
        before = dict(gt.launches)
        if device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
        else:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
        calls.setdefault(name, []).append({
            "ms": ms, **{k: gt.launches[k] - before[k] for k in ("gather_rows", "gather_lanes")}})
        return out

    def equal_state(a, b):
        return all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))

    with one_rank_group(device) as backend:
        mesh = sp.make_spatial_mesh()
        insert_fn, query_fn, _ = sp.make_spatial_fns(mesh, **kw)
        bodies = {b: sp.make_spatial_fns(mesh, batch_shard=b, **kw)[2]
                  for b in ("cached", True, False)}
        certainty_fn = sp.make_sharded_certainty_fn(mesh, resolution=res_m,
                                                    max_valid_dist2=3.0 * (2.0 * res_m) ** 2)
        dp_map = dp.make_dp_mapping_fn(mesh, **kw)
        n_cand = cfg.track_n_cand or max(16, cfg.query_nn_k * 2)
        body = iekf.make_cached_update_fn(
            knn_k=cfg.query_nn_k, n_cand=n_cand, nb_offs=system.nb_offs, resolution=res_m,
            max_valid_dist2=mvd2, sdf_scale=cfg.sdf_scale, min_grad_norm=cfg.reg_min_grad_norm,
            max_grad_norm=cfg.reg_max_grad_norm, min_nn_count=cfg.track_mask_query_nn_k,
            max_iteration=cfg.reg_iter_n, term_thre_deg=cfg.reg_term_thre_deg,
            term_thre_m=cfg.reg_term_thre_m, mlp_leaky=cfg.mlp_leaky_relu, mlp_bf16=cfg.mlp_bf16,
            encode_vecs=system.encode_vecs, weighted_first=cfg.weighted_first,
            layer_norm=cfg.layer_norm_on, stagnation_iter=cfg.stagnation_iter,
            info_scale=cfg.tracker_info_scale,
        )
        tracker = sp.make_sharded_tracker_fn(mesh, body, nb_offs=system.nb_offs,
                                             resolution=res_m, max_valid_dist2=mvd2,
                                             layer_norm=cfg.layer_norm_on)
        ml.launches = 0  # count only this path's launches
        gt.reset_launches()

        # fill: the run's map points, 32768 a call (the insert's budget)
        count = int(big.count)
        shard = sp.init_sharded_map(mesh, cap, hsize, cfg.feature_dim, device=device)
        single = nm.init_map(cap, hsize, cfg.feature_dim, device=device)
        ratios, shortfall = [], {}
        for i in range(0, count, 32768):
            pts = big.positions[i : min(i + 32768, count)]
            mask = torch.ones(len(pts), dtype=torch.bool, device=device)
            for k, v in insert_shortfall(shard, pts, res_m).items():
                shortfall[k] = shortfall.get(k, 0) + v
            shard, ratio = timed("insert_fn", lambda: insert_fn(shard, pts, mask, travel, cur,
                                                                 window))
            single, _ = nm.insert_points(single, pts, mask, res_m, travel, cur, window)
            ratios.append(float(ratio))
        if not equal_state(shard, single):
            wrong.append("the shard differs from the single map after the same inserts")
        n_shard = sp.total_count(shard, mesh)
        shortfall["rows"] = count - n_shard
        fresh = shard
        # the run's features and certainty, by each row's position in its map
        rows = torch.arange(n_shard, device=device)
        pos = shard.positions[:n_shard]
        src = big.hash_table[voxel_hash(grid_coords(pos, res_m), big.hash_table.shape[0])].long()
        src_ok = (src >= 0) & torch.all(big.positions[src.clamp(min=0)] == pos, dim=-1)
        feats, cert = shard.geo_feats.clone(), shard.certainty.clone()
        feats[rows[src_ok]] = big.geo_feats[src[src_ok]]
        cert[rows[src_ok]] = big.certainty[src[src_ok]]
        shard = shard._replace(geo_feats=feats, certainty=cert)
        single = single._replace(geo_feats=feats, certainty=cert)

        # query and certainty at 16384 pool rows
        gen = torch.Generator(device=device).manual_seed(5)
        qpts = pool.data[torch.randint(0, int(pool.size), (16384,), generator=gen,
                                       device=device), :3].contiguous()
        q = timed("query_fn", lambda: query_fn(shard, qpts, travel, cur, window))
        r1 = nm.query_feature(single, qpts, offs, res_m, mvd2, cfg.query_nn_k, travel, cur,
                              window, False, encode_vecs=system.encode_vecs)

        def picked(idx):
            return torch.sort(torch.where(idx >= 0, idx, torch.full_like(idx, -1)), dim=1).values

        feat_err = float((q.feature - r1.feature).abs().max())
        if not torch.equal(q.nn_count, r1.nn_count):
            wrong.append("query nn_count")
        if not torch.equal(picked(q.knn_idx), picked(r1.knn_idx)):
            wrong.append("query selections")
        if not feat_err <= 1e-5:
            wrong.append(f"query features: max err {feat_err}")
        c_sh = timed("certainty_fn", lambda: certainty_fn(shard, qpts))
        if not torch.equal(c_sh, nm.query_certainty_max(single, qpts, res_m,
                                                        3.0 * (2.0 * res_m) ** 2)):
            wrong.append("certainty")

        # mapping: the three bodies from the shard's untrained features
        def mapped(b, iters, name=None):
            fn = lambda: bodies[b](fresh, mlp, pool, travel, cur, window, iters, 1.0,  # noqa: E731
                                   generator=torch.Generator(device=device).manual_seed(11))
            return timed(name, fn) if name else fn()

        names = {"cached": "cached", True: "sharded_batch", False: "replicated"}
        first = {b: mapped(b, 1) for b in bodies}
        runs = {b: mapped(b, N_ITERS, f"mapping_fn {names[b]}") for b in bodies}
        again = mapped("cached", N_ITERS, "mapping_fn cached")
        dp_runs = [timed("dp_mapping", lambda: dp_map(fresh, mlp, pool, travel, cur, window,
                                                      N_ITERS, 1.0,
                                                      generator=torch.Generator(
                                                          device=device).manual_seed(11)))
                   for _ in range(2)]

        # tracking: the last scan from the run's last pose moved by 5 cm
        scan = torch.as_tensor(np.asarray(seq.scans[cur][:, :3], np.float32), device=device)
        if cfg.track_max_range > 0:
            scan = scan[torch.linalg.norm(scan, dim=-1) <= cfg.track_max_range]
        pick = torch.randperm(len(scan), generator=gen.manual_seed(6), device=device)
        pts_imu = scan[pick[: cfg.max_source_points]].contiguous()
        tmask = torch.ones(len(pts_imu), dtype=torch.bool, device=device)
        pos0 = st.pos + torch.tensor([0.04, -0.02, 0.02], device=device)
        targs = (pts_imu, tmask, st.rot, pos0, st.rest, st.P, travel, cur, window)
        tr = timed("tracker", lambda: tracker(shard, mlp, *targs))
        # warm calls beside the first ones, then the comparisons' runs
        timed("query_fn", lambda: query_fn(shard, qpts, travel, cur, window))
        timed("certainty_fn", lambda: certainty_fn(shard, qpts))
        timed("tracker", lambda: tracker(shard, mlp, *targs))
        launches = {"map_loop": ml.launches, **{k: gt.launches[k]
                                                for k in ("gather_rows", "gather_lanes")}}
        t1 = body(single, mlp, *targs)
        before = gt.launches["gather_rows"] + gt.launches["gather_lanes"]
        with plain_gathers():
            plain = mapped("cached", N_ITERS)
        plain_launches = gt.launches["gather_rows"] + gt.launches["gather_lanes"] - before

    def same(a, b):
        s_a, m_a, l_a = a
        s_b, m_b, l_b = b
        return (equal_state(s_a, s_b) and torch.equal(l_a, l_b)
                and all(torch.equal(x, y) for x, y in zip(m_a.tensors(), m_b.tensors())))

    def max_err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    losses = {names[b]: runs[b][2].tolist() for b in bodies}
    first_sdf = {names[b]: float(first[b][2][0]) for b in bodies}
    for b in bodies:
        l1, l10 = first[b][2], runs[b][2]
        if not (bool(torch.isfinite(l10).all()) and float(l10[0]) < float(l1[0])):
            wrong.append(f"{names[b]}: SDF loss {float(l1[0])} after 1 step, "
                         f"{l10.tolist()} after {N_ITERS}")
    f_ref = first_sdf["sharded_batch"]
    if any(abs(v - f_ref) > 2e-3 * abs(f_ref) for v in first_sdf.values()):
        wrong.append(f"first-step SDF losses differ: {first_sdf}")
    (s_b, m_b, l_b), (s_r, m_r, l_r) = runs[True], runs[False]
    body_err = {
        "features": float((s_b.geo_feats - s_r.geo_feats).abs().max()),
        "mlp": max_err(m_b.tensors(), m_r.tensors()),
        "losses": float((l_b - l_r).abs().max()),
        "certainty": float((s_b.certainty - s_r.certainty).abs().max()),
    }
    close = lambda x, y: bool(torch.all((x - y).abs() <= 2e-4 + 2e-3 * y.abs()))  # noqa: E731
    if not (close(s_b.geo_feats, s_r.geo_feats) and close(l_b, l_r)
            and all(close(x, y) for x, y in zip(m_b.tensors(), m_r.tensors()))
            and bool(torch.all((s_b.certainty - s_r.certainty).abs()
                               <= 2e-3 + 2e-3 * s_r.certainty.abs()))):
        wrong.append(f"batch-sharded vs replicated body: {body_err}")
    if not same(runs["cached"], again):
        wrong.append("the cached body differs from call to call")
    if not same(runs["cached"], plain):
        wrong.append("the cached body differs under the plain gathers")
    if plain_launches != 0:
        wrong.append(f"{plain_launches} gather launches under the plain gathers")
    if not same(dp_runs[0], dp_runs[1]):
        wrong.append("make_dp_mapping_fn differs from call to call")
    if not bool(torch.isfinite(dp_runs[0][2]).all()):
        wrong.append(f"dp losses {dp_runs[0][2].tolist()}")
    pose_err = max(float((tr[1] - t1[1]).abs().max()), float((tr[0] - t1[0]).abs().max()))
    if not (pose_err <= 1e-4 and bool(tr[4]) and abs(int(tr[5]) - int(t1[5])) <= 1):
        wrong.append(f"tracker: pose err {pose_err}, ok {bool(tr[4])}, iterations "
                     f"{int(tr[5])} vs {int(t1[5])}")
    if launches["map_loop"] != 0 or min(launches["gather_rows"], launches["gather_lanes"]) == 0:
        wrong.append(f"launches {launches}")
    if shortfall["rows"] != sum(v for k, v in shortfall.items() if k != "rows"):
        wrong.append(f"the insert shortfall is not explained: {shortfall}")
    gt_pose = seq.poses[cur]
    res = {
        "phase": "sharded", "backend": backend, "world_size": mesh.size,
        "shard_capacity": cap, "shard_hash_size": hsize, "map_points_in": count,
        "shard_points": n_shard, "rows_given_features": int(src_ok.sum()),
        "insert_shortfall": shortfall,
        "insert_new_ratios": ratios, "bs": kw["bs"], "iters": N_ITERS, "query_points": 16384,
        "collective_bytes_per_query": dict(zip(
            ("full_candidate", "partial_knn"),
            sp.collective_bytes_per_query(len(system.nb_offs), cfg.query_nn_k, cfg.feature_dim))),
        "query_feature_max_abs_err": feat_err, "first_step_sdf_loss": first_sdf,
        "losses": losses, "dp_losses": dp_runs[0][2].tolist(),
        "batch_sharded_vs_replicated_max_abs_err": body_err,
        "tracker": {"n_points": len(pts_imu), "pose_max_abs_err_vs_single": pose_err,
                    "iters": int(tr[5]), "single_iters": int(t1[5]), "ok": bool(tr[4]),
                    "position_error_to_ground_truth_m": float(np.linalg.norm(
                        tr[1].cpu().numpy() - gt_pose[:3, 3]))},
        "calls": calls, "map_loop_launches": launches["map_loop"],
        "gather_rows_launches": launches["gather_rows"],
        "gather_lanes_launches": launches["gather_lanes"],
        "tolerance": "shard = single map, nn_count, selections, certainty, repeats and plain "
        "gathers: exact; query features 1e-5; first-step SDF losses rtol 2e-3; batch-sharded "
        "vs replicated rtol 2e-3 / atol 2e-4 (certainty 2e-3); tracker pose 1e-4, iterations 1",
        "wrong": wrong,
    }
    emit(res)
    if wrong:
        raise AssertionError(f"sharded: {wrong}")
    return res


def insert_shortfall(state, points, resolution):
    """Why one insert of ``points`` (all valid, one call) into ``state``
    adds fewer rows than it is given: rows that share a voxel with another
    row of the call and voxels that share a bucket of the table with
    another voxel of the call (the insert's down-sampling keeps one
    candidate a voxel and one a bucket), then the kept candidates whose
    bucket already holds a point of their own voxel (``in_map``) or of a
    voxel within sqrt(3) voxels (``in_map_near``): the probe refuses both
    (tests/test_torch_insert_shortfall.py)."""
    import torch

    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops.voxel import grid_coords, voxel_down_sample_mask, voxel_hash

    hsize = state.hash_table.shape[0]
    g = grid_coords(points, resolution)
    vox = torch.unique(g, dim=0)
    keep = voxel_down_sample_mask(points, torch.ones(len(points), dtype=torch.bool,
                                                     device=points.device), resolution, hsize)
    mir = state.hash_mirror[voxel_hash(g[keep], hsize)]
    near = (mir[:, 0] < nm._EMPTY_POS * 0.5) & (
        torch.sum((mir[:, :3] - points[keep]) ** 2, dim=-1) <= 3.0 * resolution * resolution)
    near = near & (state.count > 0)  # the first insert into a map takes every candidate
    same = near & torch.all(grid_coords(mir[:, :3], resolution) == g[keep], dim=-1)
    return {"same_voxel": len(points) - len(vox),
            "shared_bucket": len(vox) - len(torch.unique(voxel_hash(vox, hsize))),
            "in_map": int(same.sum()), "in_map_near": int((near & ~same).sum())}


def expected_sharded_launches(cfg, tracked, map_iters):
    """The gather launches of a sharded driver's run, worked out from
    ``clid_slam_torch/parallel/spatial.py``: a tracked frame's candidate
    build (the probe, the winners' positions and features: 3 rows; the
    local selection's 3 lanes and the global top-k's 2); every mapped
    frame the local map's label probe (1 row; none with use_pin_mapper),
    the insert's mirror probe (1 row) and, with novelty samples, the
    certainty's (1 row); the cached mapping body on frames after 0 (its
    probe and positions, 2 rows, then the feature payload a step; 5 lanes),
    frame 0's uncached body two combined queries a step (6 rows, 10 lanes).
    ``tracked``: the frames the tracker ran; ``map_iters``: (frame, steps)
    of each mapped frame. Returns (rows, lanes)."""
    prep = (0 if cfg.use_pin_mapper else 1) + 1 + (1 if cfg.bs_new_sample > 0 else 0)
    rows, lanes = 3 * len(tracked), 5 * len(tracked)
    for f, it in map_iters:
        rows += prep + (2 + it if f > 0 else 6 * it)
        lanes += 5 if f > 0 else 10 * it
    return rows, lanes


def cuda_ms(device, fn):
    """fn() and its ms between CUDA events (the host clock on the CPU)."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(stop)


def launch_counts():
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml

    return {"map_loop": ml.launches, "gather_rows": gt.launches["gather_rows"],
            "gather_lanes": gt.launches["gather_lanes"]}


def reset_launch_counts():
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml

    ml.launches = 0
    gt.reset_launches()


def sharded_stream_system(device, seq):
    """A seeded StreamingShardedSlam of the small configuration over the
    process group that is up."""
    from clid_slam_torch.pipeline import bench_cases as bc
    from clid_slam_torch.pipeline.streaming_sharded import StreamingShardedSlam

    system = StreamingShardedSlam(bc.build_config(large=False), total_frames=bc.TOTAL_FRAMES,
                                  device=device)
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], bc.initial_velocity(seq, False))
    return system


def check_launches(phase, cfg, tracked, map_iters, launches, wrong):
    rows, lanes = expected_sharded_launches(cfg, tracked, map_iters)
    got = (launches["gather_rows"], launches["gather_lanes"])
    if launches["map_loop"] != 0 or got != (rows, lanes):
        wrong.append(f"{phase}: launches {launches}, expected gather_rows {rows}, "
                     f"gather_lanes {lanes}, map_loop 0")
    return {"gather_rows": rows, "gather_lanes": lanes, "map_loop": 0}


def stream_sharded_phase(device, seq, n_frames=25, warmup=10):
    """StreamingShardedSlam (pipeline/streaming_sharded.py) at world size 1
    on NCCL over the small sequence, at the small configuration's widths (a
    shard of 2 x map_capacity rows and a 2 x map_hash_size table): frame
    0's ms and each warm-up frame's, the steady ms a frame (CUDA events
    around frames warmup..n-1), ATE under 0.35 m (the JAX package's sharded
    test's gate), not failed, and the kernels' launches equal to
    ``expected_sharded_launches`` (map_loop 0: the sharded mapping bodies
    are the autograd loop). Returns the phase's line and the system."""
    from clid_slam_torch.utils import metrics

    wrong = []
    with one_rank_group(device) as backend:
        system = sharded_stream_system(device, seq)
        reset_launch_counts()
        frame_ms = [cuda_ms(device, lambda: system.process_frame(
            i, seq.scans[i], seq.imu_windows[i]))[1] for i in range(warmup)]

        def steady():
            for i in range(warmup, n_frames):
                system.process_frame(i, seq.scans[i], seq.imu_windows[i])

        steady_ms = cuda_ms(device, steady)[1] / (n_frames - warmup)
        launches = launch_counts()
        out = system.sync()
    est = out["odom_poses"][:n_frames]
    m = metrics.absolute_error(est, seq.poses[:n_frames], align=False)
    tracked = [i for i in range(1, n_frames) if system.cfg.track_on]
    want = check_launches("stream_sharded", system.cfg, tracked, out["map_iters"], launches,
                          wrong)
    if not (np.isfinite(est).all() and np.isfinite(out["losses"]).all()):
        wrong.append("non-finite poses or losses")
    if out["failed"] or not m["ate_rmse_m"] < 0.35:
        wrong.append(f"ATE {m['ate_rmse_m']} (gate 0.35 m), failed {out['failed']}")
    res = {
        "phase": "stream_sharded", "backend": backend, "world_size": system.n_shards,
        "frames": n_frames, "warmup": warmup, "frame0_ms": frame_ms[0],
        "warmup_frame_ms": frame_ms, "steady_ms_per_frame": steady_ms,
        "ate_rmse_m": m["ate_rmse_m"], "are_rmse_deg": m["are_rmse_deg"],
        "failed": out["failed"], "neural_points": out["neural_points"],
        "track_iters": out["track_iters"].tolist(), "map_iters": out["map_iters"],
        "map_loop_launches": launches["map_loop"],
        "gather_rows_launches": launches["gather_rows"],
        "gather_lanes_launches": launches["gather_lanes"], "expected_launches": want,
        "wrong": wrong,
    }
    emit(res)
    if wrong:
        raise AssertionError(f"stream_sharded: {wrong}")
    return res, system


def sharded_checkpoint_resume(device, seq, reference, split=15):
    """The stream_sharded run again in a fresh system for frames 0..split-1,
    saved (one npz in the JAX package's sharded layout), loaded into
    another fresh system and run on to the end: the trajectory, losses,
    iteration counts and every state tensor equal ``reference``'s (the
    finished stream_sharded system) bit for bit."""
    import torch

    n_frames = len(seq.scans)
    with one_rank_group(device):
        first = sharded_stream_system(device, seq)
        reset_launch_counts()
        for i in range(split):
            first.process_frame(i, seq.scans[i], seq.imu_windows[i])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sharded.npz")
            save_ms = cuda_ms(device, lambda: first.save_checkpoint(path))[1]
            size_mb = os.path.getsize(path) / 1e6
            del first
            resumed = sharded_stream_system(device, seq)
            load_ms = cuda_ms(device, lambda: resumed.load_checkpoint(path))[1]
        for i in range(split, n_frames):
            resumed.process_frame(i, seq.scans[i], seq.imu_windows[i])
        launches = launch_counts()
        got, want = resumed.sync(), reference.sync()
    differ = [k for k in ("odom_poses", "losses", "track_iters", "travel_dist")
              if not np.array_equal(got[k], want[k])]
    differ += [k for k in ("neural_points", "failed") if got[k] != want[k]]
    if got["map_iters"] != want["map_iters"][split:]:
        differ.append("map_iters")
    leaves = list(zip(resumed.state.leaves(), reference.state.leaves()))
    differ += [f"leaf {i}" for i, (a, b) in enumerate(leaves) if not (
        torch.equal(a.get_state(), b.get_state()) if isinstance(a, torch.Generator)
        else torch.equal(a, b))]
    res = {"phase": "sharded_checkpoint_resume", "frames": n_frames,
           "saved_after_frame": split - 1, "leaves": len(leaves), "file_mb": size_mb,
           "save_ms": save_ms, "load_ms": load_ms, "differ": differ,
           "map_loop_launches": launches["map_loop"],
           "gather_rows_launches": launches["gather_rows"],
           "gather_lanes_launches": launches["gather_lanes"]}
    emit(res)
    if differ:
        raise AssertionError(f"the resumed sharded run differs from the uninterrupted one: {differ}")
    return res


def classic_sharded_phase(device, seq, n_frames=25, warmup=10):
    """``run_sharded_slam`` (parallel/distributed.py) with no process group
    and nothing in the environment, so it brings up a group of this one
    process on NCCL, over the small sequence at the small configuration's
    widths: ATE under 0.25 m and ARE under 4 deg (the JAX package's
    sharded test's gates), the poses equal to a direct ShardedSlamSystem
    loop's on the same group bit for bit, the launches of the
    run_sharded_slam run equal to ``expected_sharded_launches``; ms of the
    whole call, and frame 0's and the steady ms a frame of the direct loop
    (CUDA events)."""
    import torch.distributed as dist

    from clid_slam_torch.parallel import distributed as dd
    from clid_slam_torch.parallel.slam_sharded import ShardedSlamSystem
    from clid_slam_torch.pipeline import bench_cases as bc
    from clid_slam_torch.utils import metrics

    cfg = bc.build_config(large=False)
    rot, pos = seq.poses[0][:3, :3], seq.poses[0][:3, 3]
    seed = (rot, pos, bc.initial_velocity(seq, False))
    wrong = []
    env = [k for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK") if k in os.environ]
    if dist.is_initialized() or env:
        raise AssertionError(f"classic_sharded: a process group is up or configured ({env})")
    try:
        reset_launch_counts()
        (poses, system), call_ms = cuda_ms(device, lambda: dd.run_sharded_slam(
            cfg, seq.scans[:n_frames], seq.imu_windows[:n_frames], seed_pose=seed,
            device=device))
        launches = launch_counts()
        backend, world = dist.get_backend(), dist.get_world_size()
        points = system.neural_point_count()
        direct = ShardedSlamSystem(cfg, total_frames=n_frames + 4, device=device)
        direct.tracker.x.rot, direct.tracker.x.pos = rot.copy(), pos.copy()
        direct.tracker.x.vel = seed[2].copy()
        frame_ms = [cuda_ms(device, lambda: direct.process_frame(
            i, seq.scans[i], seq.imu_windows[i]))[1] for i in range(warmup)]

        def steady():
            for i in range(warmup, n_frames):
                direct.process_frame(i, seq.scans[i], seq.imu_windows[i])

        steady_ms = cuda_ms(device, steady)[1] / (n_frames - warmup)
    finally:
        dd.shutdown()
    m = metrics.absolute_error(poses, seq.poses[:n_frames], align=False)
    tracked = [i for i in range(1, n_frames) if cfg.track_on]
    want = check_launches("classic_sharded", cfg, tracked, system.map_log, launches, wrong)
    if not np.array_equal(poses, direct.odom_poses[:n_frames]):
        wrong.append("run_sharded_slam's poses differ from the direct loop's")
    if system.failed or not (m["ate_rmse_m"] < 0.25 and m["are_rmse_deg"] < 4.0):
        wrong.append(f"ATE {m['ate_rmse_m']} m, ARE {m['are_rmse_deg']} deg "
                     f"(gates 0.25 m, 4 deg), failed {system.failed}")
    res = {
        "phase": "classic_sharded", "backend": backend, "world_size": world,
        "frames": n_frames, "warmup": warmup, "call_ms": call_ms,
        "call_ms_per_frame": call_ms / n_frames, "frame0_ms": frame_ms[0],
        "warmup_frame_ms": frame_ms, "steady_ms_per_frame": steady_ms,
        "ate_rmse_m": m["ate_rmse_m"], "are_rmse_deg": m["are_rmse_deg"],
        "failed": system.failed, "neural_points": points, "map_iters": system.map_log,
        "map_loop_launches": launches["map_loop"],
        "gather_rows_launches": launches["gather_rows"],
        "gather_lanes_launches": launches["gather_lanes"], "expected_launches": want,
        "wrong": wrong,
    }
    emit(res)
    if wrong:
        raise AssertionError(f"classic_sharded: {wrong}")
    return res


PRECOMPILE_FRAMES = 12


def precompile_child(mode, out_path):
    """One side of the precompile phase, in a fresh process with an empty
    build directory, so that every first-use cost is paid in it: the small
    configuration's StreamingSlam over PRECOMPILE_FRAMES frames of the small
    sequence, after ``precompile()`` ("warm") or without it ("cold"). Each
    frame is timed on the host clock up to the card's idle (the frame as
    the host sees it). Writes the trajectory, losses and iteration counts
    to ``out_path`` (npz) and prints one JSON line."""
    import torch

    from clid_slam_torch import set_full_precision
    from clid_slam_torch.ops import _build

    set_full_precision()
    device = torch.device("cuda", 0)
    n = PRECOMPILE_FRAMES
    with tempfile.TemporaryDirectory() as build_dir:
        _build.BUILD_DIR = build_dir  # nothing built: the kernels compile at first use
        t0 = time.perf_counter()
        cfg, seq, system = make_system(False, n, device)
        res = {"mode": mode, "construct_ms": (time.perf_counter() - t0) * 1e3}
        if mode == "warm":
            reset_launch_counts()
            res["precompile_host_ms"], res["precompile_event_ms"] = host_and_event_ms(
                device, system.precompile)
            res["precompile_launches"] = launch_counts()
        reset_launch_counts()
        frame_ms = []
        for i in range(n):
            t0 = time.perf_counter()
            system.process_frame(i, seq.scans[i], seq.imu_windows[i])
            system.block()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        res["frame_ms"] = frame_ms
        res["frame_launches"] = launch_counts()
        res["built"] = sorted(os.listdir(build_dir))
    out = system.sync()
    np.savez(out_path, odom_poses=out["odom_poses"], losses=out["losses"],
             track_iters=out["track_iters"])
    emit(res)


def precompile_phase():
    """``StreamingSlam.precompile()`` (pipeline/streaming.py) on the small
    configuration: a fresh process runs it and then PRECOMPILE_FRAMES
    frames; a second fresh process runs the same frames without it. Each
    starts with an empty build directory, so its first use of a kernel
    compiles it. Printed: precompile's ms (host clock and CUDA events) and
    its launches by kernel (map_loop once a tracked variant, so 2; the
    gathers' counts), frame 0's and frame 1's ms on either side and the
    one-time share of each (cold minus warm). Fails unless the two
    trajectories, losses and iteration counts are equal bit for bit and
    precompile launched every kernel of the path."""
    import subprocess

    sides = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("warm", "cold"):
            path = os.path.join(tmp, f"{mode}.npz")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--precompile-child", mode, path],
                capture_output=True, text=True, timeout=400, cwd=REPO)
            if proc.returncode != 0:
                raise AssertionError(f"precompile child {mode} failed:\n{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["process_s"] = time.perf_counter() - t0
            with np.load(path) as z:
                res["arrays"] = {k: z[k] for k in z.files}
            sides[mode] = res
    warm, cold = sides["warm"], sides["cold"]
    differ = [k for k in warm["arrays"]
              if not np.array_equal(warm["arrays"][k], cold["arrays"][k])]
    pre = warm["precompile_launches"]
    res = {
        "phase": "precompile", "frames": PRECOMPILE_FRAMES,
        "precompile_host_ms": warm["precompile_host_ms"],
        "precompile_event_ms": warm["precompile_event_ms"],
        "precompile_launches": pre, "map_loop_launches": pre["map_loop"],
        "gather_rows_launches": pre["gather_rows"], "gather_lanes_launches": pre["gather_lanes"],
        "frame_ms_warm": warm["frame_ms"][:2], "frame_ms_cold": cold["frame_ms"][:2],
        "one_time_ms": [c - w for c, w in zip(cold["frame_ms"][:2], warm["frame_ms"][:2])],
        "steady_ms_warm": float(np.mean(warm["frame_ms"][2:])),
        "steady_ms_cold": float(np.mean(cold["frame_ms"][2:])),
        "all_frame_ms": {"warm": warm["frame_ms"], "cold": cold["frame_ms"]},
        "frame_launches": {"warm": warm["frame_launches"], "cold": cold["frame_launches"]},
        "construct_ms": {"warm": warm["construct_ms"], "cold": cold["construct_ms"]},
        "process_s": {"warm": warm["process_s"], "cold": cold["process_s"]},
        "built": {"warm": warm["built"], "cold": cold["built"]},
        "differ": differ,
    }
    emit(res)
    if differ:
        raise AssertionError(f"precompile changed the run: {differ}")
    if pre["map_loop"] != 2 or pre["gather_rows"] == 0 or pre["gather_lanes"] == 0:
        raise AssertionError(f"precompile did not launch every kernel of the path: {pre}")
    if warm["frame_launches"] != cold["frame_launches"]:
        raise AssertionError(f"the frames' launches differ: {res['frame_launches']}")
    return res


def host_and_event_ms(device, fn):
    """(host ms, CUDA-event ms) of fn(), both up to the card's idle."""
    t0 = time.perf_counter()
    event_ms = cuda_ms(device, fn)[1]
    return (time.perf_counter() - t0) * 1e3, event_ms


def sharded_precompile_phase(device, seq, reference, reference_frame0_ms, n_frames=2):
    """``StreamingShardedSlam.precompile()`` at world size 1 on NCCL in a
    new process group, so that its first collectives set the communicator
    up: precompile's ms (host clock and CUDA events) and launches, then
    frames 0..n_frames-1 timed the same two ways, beside stream_sharded's
    frame 0 (``reference_frame0_ms``, CUDA events, no precompile). The
    frames' poses, losses, iteration counts and mapping steps equal
    ``reference``'s (the finished stream_sharded system) bit for bit, and
    precompile leaves ``map_iters`` empty."""
    wrong = []
    with one_rank_group(device) as backend:
        system = sharded_stream_system(device, seq)
        reset_launch_counts()
        host_ms, event_ms = host_and_event_ms(device, system.precompile)
        launches = launch_counts()
        if system.map_log:
            wrong.append(f"precompile left map_iters {system.map_log}")
        if launches["gather_rows"] == 0 or launches["gather_lanes"] == 0:
            wrong.append(f"precompile did not launch the gathers: {launches}")
        frames = [host_and_event_ms(device, lambda: system.process_frame(
            i, seq.scans[i], seq.imu_windows[i])) for i in range(n_frames)]
        got, want = system.sync(), reference.sync()
    for k in ("odom_poses", "losses", "track_iters"):
        if not np.array_equal(got[k], want[k][:n_frames]):
            wrong.append(k)
    if got["map_iters"] != want["map_iters"][:n_frames]:
        wrong.append(f"map_iters {got['map_iters']} != {want['map_iters'][:n_frames]}")
    res = {"phase": "sharded_precompile", "backend": backend, "world_size": system.n_shards,
           "precompile_host_ms": host_ms, "precompile_event_ms": event_ms,
           "precompile_launches": launches, "map_loop_launches": launches["map_loop"],
           "gather_rows_launches": launches["gather_rows"],
           "gather_lanes_launches": launches["gather_lanes"],
           "frame_host_ms": [h for h, _ in frames],
           "frame_event_ms": [e for _, e in frames],
           "stream_sharded_frame0_event_ms": reference_frame0_ms,
           "map_iters": got["map_iters"], "wrong": wrong}
    emit(res)
    if wrong:
        raise AssertionError(f"sharded_precompile: {wrong}")
    return res


def color_sem_map(device, n_frames=10):
    """The color and semantic heads at bench widths on labelled data: the
    small sequence's first scan, each point with an intensity from its
    azimuth and a class 1..4 from its quadrant (a tenth left unlabelled,
    drawn from the config's seed), through ``prep`` (colors and classes into
    a 2^21-row pool) and the tracked frames' single-batch mapping body (bs
    16384) with both heads, ``n_frames`` frames of that scan. After each
    frame the color L1 and the semantic NLL at the scan's points (those with
    a neighbour) are read through ``query_color_feature`` and the heads:
    both must fall from the first frame to the last. Then the color slab's
    gathers at the mapper's shapes (its work rows, [2^18+1, 8] by 98304,
    and their expanded references) through the kernel and through its plain
    version: equal bit for bit. Last, the trained map's mesh (0.1 m) and its
    vertices' colors and classes (``estimate_vertex_colors`` with the
    1-channel doubling to gray, ``estimate_vertex_sem``) through the
    kernels and under ``plain_gathers()``: equal bit for bit; the share of
    the kept vertices whose class is the azimuth quadrant the scan was
    labelled by is printed."""
    import torch

    from clid_slam_torch.mapping import mapper as mp
    from clid_slam_torch.mapping import prep as prp
    from clid_slam_torch.models import decoder as dec
    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.pipeline import streaming as sm
    from clid_slam_torch.tools import time_map_loop as tml

    cfg, seq, system = make_system(False, 1, device, **COLOR_SEM)
    st, F = system.state, cfg.feature_dim
    pts = np.asarray(seq.scans[0][:, :3], np.float32)
    az = np.arctan2(pts[:, 1], pts[:, 0]) + np.pi
    rng = np.random.default_rng(cfg.seed)
    intensity = (0.5 * (np.sin(2 * az) + 1)).astype(np.float32)
    cls = np.minimum(az // (np.pi / 2), 3).astype(np.int32) + 1
    cls[rng.uniform(size=len(cls)) < 0.1] = 0
    t = lambda a: torch.from_numpy(a).to(device)
    points, colors, sem = t(pts), t(intensity[:, None]), t(cls)
    mask = torch.ones(len(pts), dtype=torch.bool, device=device)
    pose = torch.from_numpy(np.asarray(seq.poses[0], np.float32)).to(device)
    world = points @ pose[:3, :3].T + pose[:3, 3]
    prep = prp.make_prep_fn(filter_pool_now=False, **sm.prep_kwargs(cfg))
    mapping = mp.make_mapping_fn(**dict(
        sm.mapping_kwargs(cfg, system.nb_offs, system.encode_vecs),
        resample_every=max(cfg.map_resample_every, cfg.iters + 10), max_outer=1,
        dup_independent=cfg.map_dup_independent, use_pallas=cfg.map_pallas))
    offs = torch.as_tensor(system.nb_offs, device=device)
    dist2 = 3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2
    window = cfg.diff_travel_dist_local
    map_state, local_map, pool = st.map_state, st.local_map, st.pool
    mlps = (st.mlp, st.color_mlp, st.sem_mlp)
    ml.launches = 0
    gt.reset_launches()
    color_l1, sem_nll, ms = [], [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        res = prep(map_state, local_map, pool, points, mask, pose, st.travel_dist, i, window,
                   generator=st.key, colors=colors, sem_labels=sem)
        map_state, local_map, pool = res.map_state, res.local_map, res.pool
        map_state, *mlps, _ = mapping(map_state, *mlps, pool, st.travel_dist, i, window,
                                      cfg.iters, 1.0, generator=st.key)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            q = nm.query_feature(map_state, world, offs, cfg.voxel_size_m, dist2, cfg.query_nn_k,
                                 st.travel_dist, i, window, True, encode_vecs=system.encode_vecs)
            ok = q.nn_count > 0
            cpred = dec.regress_color(mlps[1], nm.query_color_feature(map_state, q, F))[:, 0]
            color_l1.append(float(torch.abs(cpred - colors[:, 0])[ok].mean()))
            logp = dec.sem_label_prob(mlps[2], q.feature)
            nll = -torch.gather(logp, 1, sem.long()[:, None].clamp(min=0))[:, 0]
            sem_nll.append(float(nll[ok & (sem > 0)].mean()))
    launches, gathers = ml.launches, dict(gt.launches)
    # the color slab's gathers at the mapper's shapes, on the trained map
    c = mapping.build_cache(map_state, pool, st.travel_dist, n_frames - 1, window,
                            torch.Generator(device=device).manual_seed(1), None)
    slab = map_state.color_feats
    work = gt.gather_rows(slab, c.src_rows)
    refs = gt.gather_rows_nd(work, c.local_idx)
    exact = (torch.equal(work, gt.gather_rows_reference(slab, c.src_rows))
             and torch.equal(refs, gt.gather_rows_reference(work, c.local_idx)))
    gather_ms = tml.eager_ms(lambda: gt.gather_rows(slab, c.src_rows), reps=50)
    plain_ms = tml.eager_ms(lambda: gt.gather_rows_reference(slab, c.src_rows), reps=50)
    labelled = int(((pool.data[:, 6] > 0) & pool.valid).sum())
    # the trained map's mesh, and its vertices' colors and classes
    mesher = config_mesher(cfg, system)
    live = map_state.positions[: int(map_state.count)].cpu().numpy()
    v, _ = mesher.recon_aabb_mesh(map_state, mlps[0], live.min(0), live.max(0), 0.1, cfg.pad_voxel,
                                  cfg.min_cluster_vertices, guide_points=live,
                                  skip_top_voxel=cfg.skip_top_voxel)
    attrs = lambda: (mesher.estimate_vertex_colors(map_state, mlps[1], v, cfg.color_channel),
                     *mesher.estimate_vertex_sem(map_state, mlps[2], v))
    gt.reset_launches()
    vcolor, vcls, vkeep = attrs()
    attr_launches = dict(gt.launches)
    with plain_gathers():
        plain_attrs = attrs()
    attrs_exact = all(np.array_equal(a, b) for a, b in zip((vcolor, vcls, vkeep), plain_attrs))
    R, tr = np.asarray(seq.poses[0][:3, :3]), np.asarray(seq.poses[0][:3, 3])
    local = (v - tr) @ R  # the sensor frame the scan was labelled in
    vaz = np.arctan2(local[:, 1], local[:, 0]) + np.pi
    quadrant = np.minimum(vaz // (np.pi / 2), 3).astype(np.int32) + 1
    res = {"phase": "color_sem_map", "frames": n_frames, "points": len(pts),
           "pool_rows_labelled": labelled, "neural_points": int(map_state.count),
           "ms_per_frame": ms, "color_l1": color_l1, "sem_nll": sem_nll,
           "color_l1_first_last": [color_l1[0], color_l1[-1]],
           "sem_nll_first_last": [sem_nll[0], sem_nll[-1]],
           "map_loop_launches": launches, "gather_rows_launches": gathers["gather_rows"],
           "gather_lanes_launches": gathers["gather_lanes"],
           "color_slab_gather": {"table": list(slab.shape), "idx": list(c.src_rows.shape),
                                 "refs": list(c.local_idx.shape), "exact": exact,
                                 "ms": gather_ms, "plain_ms": plain_ms},
           "mesh_vertex_attributes": {
               "vertices": len(v), "kept": int(vkeep.sum()), "exact": attrs_exact,
               "launches": attr_launches, "gray": bool(np.array_equal(vcolor[:, 0], vcolor[:, 2])),
               "class_matches_quadrant_share": float((vcls == quadrant)[vkeep].mean())
               if vkeep.any() else None}}
    emit(res)
    wrong = []
    if not (np.isfinite(color_l1).all() and np.isfinite(sem_nll).all()):
        wrong.append("non-finite losses")
    if not color_l1[-1] < color_l1[0]:
        wrong.append(f"color L1 {color_l1[0]} -> {color_l1[-1]} did not fall")
    if not sem_nll[-1] < sem_nll[0]:
        wrong.append(f"semantic NLL {sem_nll[0]} -> {sem_nll[-1]} did not fall")
    if not exact:
        wrong.append("the color slab's gathers differ from their plain versions")
    if not (attrs_exact and len(v) > 0 and vkeep.any()):
        wrong.append(f"vertex attributes: {res['mesh_vertex_attributes']}")
    if launches != 0 or gathers["gather_rows"] < 4 * n_frames or labelled == 0:
        wrong.append(f"launches {launches} map_loop, {gathers}; labelled rows {labelled}")
    if wrong:
        raise AssertionError(f"color_sem_map: {wrong}")
    return res


def prune_check(system, n_frames):
    """prune_and_rehash on the map that the large run ends with, held to
    what it must do on any device. Twice: as the run's configuration prunes
    (on this trajectory: nothing dropped, the hash rebuilt), where the map
    must answer a neighbourhood probe at 4096 of its own points as before;
    and as a global prune at the live points' median certainty, which drops
    about half the rows. In both, the survivors are the kept rows in order,
    the freed rows are zero, and the rebuilt hash resolves every survivor
    to the last row of its bucket, with that row's position in the mirror."""
    import torch

    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops.voxel import grid_coords, voxel_hash

    cfg, st = system.cfg, system.state
    old, travel = st.map_state, st.travel_dist
    count = int(old.count)
    median = float(old.certainty[:count].median())
    rows = torch.arange(old.positions.shape[0], device=old.positions.device)
    live = rows < count
    stale = torch.abs(travel[n_frames - 1] - travel[old.ts_update.long()]) > cfg.diff_travel_dist_local
    res = {"phase": "prune_check", "points": count, "median_certainty": median, "cases": []}
    for name, thre, keep, global_prune in (
        ("configured", cfg.max_prune_certainty,
         live & ~(stale & (old.certainty < cfg.max_prune_certainty)), False),
        ("global_at_median", median, live & (old.certainty >= median), True),
    ):
        got = nm.prune_and_rehash(old, thre, travel, n_frames - 1, cfg.diff_travel_dist_local,
                                  cfg.voxel_size_m, global_prune)
        n_kept = int(got.count)
        wrong = []
        if n_kept != int(keep.sum()):
            wrong.append("count")
        for field in ("positions", "geo_feats", "certainty", "ts_create", "ts_update"):
            new, was = getattr(got, field), getattr(old, field)
            if not torch.equal(new[:n_kept], was[keep]):
                wrong.append(field)
            if field != "positions" and bool((new[n_kept:] != 0).any()):
                wrong.append(field + " of freed rows")
        h = voxel_hash(grid_coords(got.positions[:n_kept], cfg.voxel_size_m),
                       got.hash_table.shape[0])
        winner = got.hash_table[h].long()
        entries = int((got.hash_table >= 0).sum())
        if entries != int(torch.unique(h).numel()):
            wrong.append("hash entries")
        if bool(((winner < rows[:n_kept]) | (winner >= n_kept)).any()) or not torch.equal(h[winner], h):
            wrong.append("hash winners")
        if not torch.equal(got.hash_mirror[h][:, :3], got.positions[winner]):
            wrong.append("hash mirror")
        if n_kept == count:  # nothing dropped: the map must probe as before
            pick = torch.linspace(0, count - 1, 4096, device=rows.device).long()
            probe = lambda m: nm.neighborhood_probe(
                m, old.positions[pick], torch.as_tensor(system.nb_offs, device=rows.device),
                cfg.voxel_size_m, 1e9, travel, n_frames - 1, cfg.diff_travel_dist_local, True)
            if any(not torch.equal(a, b) for a, b in zip(probe(got), probe(old))):
                wrong.append("probe after an identity prune")
        res["cases"].append({"prune": name, "points_after": n_kept, "hash_entries": entries,
                             "wrong": wrong})
    emit(res)
    if any(c["wrong"] for c in res["cases"]):
        raise AssertionError(f"prune_and_rehash: {res['cases']}")
    dropped = count - res["cases"][1]["points_after"]
    if not 0.25 * count < dropped < 0.75 * count:
        raise AssertionError(f"the global prune dropped {dropped} of {count} points")
    return res


def is_stage(name):
    """The profiler ranges of StreamingSlam's stages (``frame.*`` and
    ``ba``) and of the Mesher's launch spans (``mesh.*``)."""
    return name.startswith(("frame.", "mesh.")) or name == "ba"


def launch_attribution(prof, n_profiled):
    """Device time per frame of every device activity, by the ``frame.*``
    range whose host span holds the runtime call that launched it. The
    profiler ties a kernel to a stage only through a torch op; a kernel
    launched through ctypes (the hand kernels) has none, so its launch's
    host time places it here. Returns (ms by stage, with "outside" and
    "unlinked"; the hand kernels' ms and launches by stage, with PyTorch's
    scatter/gather elementwise kernel beside them)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if is_stage(e.name()) and e.device_type() != cuda]
    launch_at = {e.correlation_id(): e.start_ns() for e in events if e.device_type() != cuda
                 and any(w in e.name() for w in ("Launch", "Memcpy", "Memset"))}
    by_stage, hand = {}, {}
    for e in events:
        # device activity only: the frame.* ranges are mirrored onto the
        # device's timeline as annotations, which are no work
        if e.device_type() != cuda or e.is_user_annotation() or is_stage(e.name()):
            continue
        t = launch_at.get(e.correlation_id(), launch_at.get(e.linked_correlation_id()))
        stage = "unlinked" if t is None else next(
            (name for lo, hi, name in ranges if lo <= t <= hi), "outside")
        ms = e.duration_ns() / 1e6 / n_profiled
        by_stage[stage] = by_stage.get(stage, 0.0) + ms
        kernel = re.search(r"(map_loop|gather_rows|gather_lanes|gather_cols)_(kernel|narrow|staged)"
                           r"|(_scatter_gather_elementwise)_kernel", e.name())
        if kernel:
            name = kernel.group(1) or "torch" + kernel.group(3)
            row = hand.setdefault(f"{name} @ {stage}", {"device_ms_per_frame": 0.0,
                                                        "launches_per_frame": 0.0})
            row["device_ms_per_frame"] += ms
            row["launches_per_frame"] += 1 / n_profiled
    return by_stage, hand


def profile_phase(large, n_frames, n_profiled, device, **overrides):
    """torch.profiler over the last ``n_profiled`` frames of a fresh run:
    device time per stage range and per kernel, and the device busy share
    of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg, seq, system = make_system(large, n_frames, device, **overrides)
    for i in range(n_frames - n_profiled):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    system.block()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(n_frames - n_profiled, n_frames):
            system.process_frame(i, seq.scans[i], seq.imu_windows[i])
        system.block()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
    self_dev_ms = lambda e: getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)
    ) / 1e3
    # stage ranges: the host-side range carries the host time and the
    # device time of the kernels launched inside it
    stages = {}
    for e in events:
        if is_stage(e.key) and e.device_type != cuda:
            stages[e.key] = {"device_ms_per_frame": dev_ms(e) / n_profiled,
                             "host_ms_per_frame": e.cpu_time_total / 1e3 / n_profiled}
    # device work: the kernel (and memcpy/memset) rows, each counted once
    kernels = sorted(
        (e for e in events if e.device_type == cuda and not is_stage(e.key)),
        key=self_dev_ms, reverse=True,
    )
    busy_ms = sum(self_dev_ms(e) for e in kernels)
    top = [{"name": e.key[:80], "device_ms_per_frame": self_dev_ms(e) / n_profiled,
            "calls_per_frame": e.count / n_profiled} for e in kernels[:15]]
    launched, hand = launch_attribution(prof, n_profiled)
    for name, ms in launched.items():
        stages.setdefault(name, {})["launched_device_ms_per_frame"] = ms
    # PyTorch's own row gathers by input shape (the hash-mirror gathers are
    # [2^21-2^22, 4] tables), with the device time of their kernels
    index_rows = [
        {"op": e.key, "input_shapes": e.input_shapes, "device_ms_per_frame": dev_ms(e) / n_profiled,
         "calls_per_frame": e.count / n_profiled}
        for e in prof.key_averages(group_by_input_shape=True)
        if e.key in ("aten::index", "aten::index_select") and dev_ms(e) > 0
    ]
    index_rows.sort(key=lambda r: r["device_ms_per_frame"], reverse=True)
    # PyTorch's own gathers and scatters by op and input shape, with the
    # device time of the kernels each op launched itself (the scatter/gather
    # elementwise kernel serves gather, scatter_, scatter_add_ and
    # scatter_reduce_), so the selection's gathers ([N, 81] sources) and the
    # scatters part
    scatter_gather = [
        {"op": e.key, "input_shapes": e.input_shapes,
         "device_ms_per_frame": self_dev_ms(e) / n_profiled, "calls_per_frame": e.count / n_profiled}
        for e in prof.key_averages(group_by_input_shape=True)
        if e.device_type != cuda and re.search("gather|scatter", e.key) and self_dev_ms(e) > 0
    ]
    scatter_gather.sort(key=lambda r: r["device_ms_per_frame"], reverse=True)
    res = {"phase": "profile", "large": large, "overrides": overrides, "frames": n_profiled,
           "wall_ms_per_frame": wall_ms / n_profiled,
           "device_busy_ms_per_frame": busy_ms / n_profiled,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "stages": stages, "hand_kernels_by_stage": hand, "top_kernels": top,
           "index_ops": index_rows[:12], "scatter_gather_ops": scatter_gather[:24]}
    emit(res)
    return res


def ptxas_summary(report):
    """Registers and spill stores per kernel entry from nvcc -Xptxas -v
    (map_loop's entries named by their <n_hidden, hidden, layer_norm,
    resident> template arguments, the gathers by their index type)."""
    out, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.search(r"map_loop_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", m.group(1))
            gather = re.search(r"(gather_(?:rows|lanes|cols)_(?:kernel|narrow|staged))I([il])(\w*?)E+v", m.group(1))
            if args:
                name = "map_loop<%s>" % ",".join(args.groups())
            elif gather:
                # the second template argument as mangled: the row piece
                # (6float4, f), the lane (h, j, y, 5uint4) or the cols
                # kernel's 16-byte path (Lb1, Lb0)
                name = "%s<%s>" % (gather.group(1), {"i": "int32", "l": "int64"}[gather.group(2)]
                                   + "," + {"6float4": "float4", "f": "float", "h": "1B",
                                            "j": "4B", "y": "8B", "5uint4": "16B", "Lb1": "vec",
                                            "Lb0": "scalar"}.get(gather.group(3), gather.group(3)))
            else:
                name = m.group(1)
            out.append({"entry": name})
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and out:
            out[-1]["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def gather_phase(device):
    """The probe entry point's six variants and the main path's shapes (the
    hash mirrors, the mapper's work slab, the kNN selection, the filter's
    and BA's), and the host time of one call of each wrapper. Returns the rows and the probe run's launch counts."""
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.tools import probe_gather as pg

    gt.reset_launches()
    rows = pg.run(device, main_path=True)
    probe_launches = dict(gt.launches)
    emit({"phase": "gather", "reps": 200, "probe_launches": probe_launches, "rows": rows,
          "tolerance": "exact: torch.equal with the plain version"})
    emit(pg.host_cost(device))
    for name, count in probe_launches.items():
        if count == 0:
            raise AssertionError(f"the probe entry point never launched {name}")
    return rows, probe_launches


def gather_kernel_entry(name, rows, main_variant, launches, by_path, other_variants=()):
    """The summary entry of one gather kernel: times and bound of its row at
    ``main_variant``, the largest error over all of its rows, and beside
    them the times of its rows at ``other_variants``."""
    mine = [r for r in rows if r["kernel"] == name]
    main = next(r for r in mine if r["variant"] == main_variant)
    keys = ("variant", "table", "dtype", "idx", "idx_dtype", "ms", "graph_ms", "graph_hot_ms",
            "bound_ms", "library_ms", "library_graph_ms", "library_graph_hot_ms", "index_ms",
            "index_graph_ms")
    others = [{k: r[k] for k in keys if k in r} for v in other_variants
              for r in mine if r["variant"] == v]
    return {"other_variants": others, "main_variant": main_variant,
        "name": name, "route": "cuda", "source": "clid_slam_torch/csrc/gather.cu",
        "replaces": "; ".join(sorted({r["replaces"] for r in mine if r["replaces"].startswith("scripts/")})),
        "launches": launches, "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "shape": {"variant": main_variant, "table": main["table"], "idx": main["idx"],
                  "idx_dtype": main["idx_dtype"]},
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "graph_ms": main["graph_ms"], "library_graph_ms": main["library_graph_ms"],
        "graph_hot_ms": main["graph_hot_ms"],
        "library_graph_hot_ms": main["library_graph_hot_ms"],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 5 steady frames of a fresh small run and of a "
                    "fresh 60-frame large run, the last 10 frames of stream_dynba's, "
                    "the last 5 of each option phase's and classic_mesh's final mesh")
    ap.add_argument("--precompile-child", nargs=2, metavar=("MODE", "OUT"),
                    help=argparse.SUPPRESS)  # one side of the precompile phase
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "clid_slam_torch")):
        print("chip_smoke: clid_slam_torch/ not found beside this script", file=sys.stderr)
        sys.exit(3)
    sys.path.insert(0, REPO)
    if args.precompile_child:
        precompile_child(*args.precompile_child)
        return
    from clid_slam_torch import set_full_precision
    from clid_slam_torch.ops import _build
    from clid_slam_torch.pipeline import bench_cases
    from clid_slam_torch.tools.time_map_loop import nvidia_smi_line

    set_full_precision()
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    reports = _build.build_all()  # one nvcc each, side by side
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"clid_slam_torch/csrc/{n}.cu" for n in reports],
          "ptxas": {n: ptxas_summary(r) for n, r in reports.items()}})

    # the bench config first: 1 hidden layer of 64, no layer norm
    cases = [kernel_case(nh, ln, device, hidden) for nh in (1, 2) for hidden in (64, 32)
             for ln in (False, True)]
    cases.append(kernel_case(1, False, device, streamed=True))
    for c in cases:
        emit(c)
    gather_table, probe_launches = gather_phase(device)
    precompiled = precompile_phase()

    small, small_system = stream_phase("stream", False, 25, 10, device)
    large_seq = bench_cases.make_sequence(True, 200)
    large, large_system = stream_phase("stream_large", True, 200, 10, device, seq=large_seq)
    sharded = sharded_phase(large_system, large_seq, 200, device)
    prune_check(large_system, 200)
    mesh_large(large_system, large_seq, 200)
    del large_system, large_seq
    small_seq = bench_cases.make_sequence(False, 25)
    stream_sh, stream_sh_system = stream_sharded_phase(device, small_seq)
    resumed_sh = sharded_checkpoint_resume(device, small_seq, stream_sh_system)
    sharded_pre = sharded_precompile_phase(device, small_seq, stream_sh_system,
                                           stream_sh["frame0_ms"])
    del stream_sh_system
    classic_sh = classic_sharded_phase(device, small_seq)
    fallback = stream_phase("stream_fallback", False, 12, 10, device, fused=False,
                            mlp_leaky_relu=True)[0]
    dynba_kw = dict(dynamic_filter_on=True, ba_frame=20, ba_freq_frame=10)
    dynba_seq = bench_cases.make_sequence(False, 40)
    dynba, dynba_system = stream_phase("stream_dynba", False, 40, 10, device, ate_gate=0.3,
                                       seq=dynba_seq, **dynba_kw)
    gradient_check(dynba_system, dynba_seq, 40, device)
    resumed = checkpoint_resume(dynba_system, dynba_seq, 25, device, **dynba_kw)
    del dynba_system
    requery = stream_phase("stream_requery", False, 12, 10, device, track_cached=False)[0]
    seq12 = bench_cases.make_sequence(False, 12)
    options = [stream_phase(name, False, 12, 10, device, fused=False, ate_gate=0.3, seq=seq12,
                            **kw)[0]
               for name, kw in (("stream_dtw", dict(weighted_first=False)),
                                ("stream_bf16", dict(mlp_bf16=True)),
                                ("stream_color_sem", COLOR_SEM))]
    labelled = color_sem_map(device)
    with tempfile.TemporaryDirectory() as tmp:
        classic, classic_seq, classic_cfg, classic_system = classic_phase(device, tmp)
        classic_arrays_phase(device, classic_seq, classic_cfg, classic_system)
        classic_poses = classic_system.dataset.odom_poses[: len(classic_seq.scans)].copy()
        del classic_system
        classic_mesh_phase(device, os.path.join(tmp, "mesh"), classic_seq, classic_poses,
                           classic["ate_rmse_m"], profile=args.profile)
        pgo = classic_pgo_phase(device, classic_seq, classic_cfg)
        files = stream_files_phase(device, os.path.join(tmp, "bench"), small_system)
    del small_system
    if args.profile:
        profile_phase(False, 20, 5, device)
        profile_phase(True, 60, 5, device)
        profile_phase(False, 40, 10, device, **dynba_kw)  # frames 30-39, BA at 39
        # the option phases' last 5 frames: frame.map on the autograd loop
        for kw in (dict(weighted_first=False), dict(mlp_bf16=True), COLOR_SEM):
            profile_phase(False, 12, 5, device, **kw)

    def by_path(key):
        return {r["phase"]: r[key]
                for r in (precompiled, small, large, sharded, stream_sh, resumed_sh,
                          sharded_pre, classic_sh, fallback,
                          dynba, resumed, requery, *options,
                          labelled, classic, pgo, files) if key in r}

    main_case = cases[0]  # the bench config: 1 hidden layer, no layer norm
    # launches: the count on the large run, this script's full-width path;
    # the column gather runs on the probe entry point only
    emit({"kernels": [
        {
            "name": "map_loop", "route": "cuda",
            "source": "clid_slam_torch/csrc/map_loop.cu",
            "replaces": "clid_slam_tpu/ops/pallas_mapping.py:391",
            "launches": large["map_loop_launches"],
            "launches_by_path": by_path("map_loop_launches"),
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "device_ms": main_case["device_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": None,
        },
        gather_kernel_entry(
            "gather_rows", gather_table, "mapper f0", large["gather_rows_launches"],
            dict(by_path("gather_rows_launches"), probe=probe_launches["gather_rows"]),
            other_variants=["mirror mapper probe", "mapper color work0", "mapper color f0",
                            "BA pose gather", "mirror filter probe",
                            "query feats BA", "query feats filter", "mirror mesh probe",
                            "query feats mesh"],
        ),
        gather_kernel_entry(
            "gather_lanes", gather_table, "select mapper d2s", large["gather_lanes_launches"],
            dict(by_path("gather_lanes_launches"), probe=probe_launches["gather_lanes"]),
            other_variants=["K4 gather_b"] + [f"select {w} {s}"
                                               for w in ("mapper", "tracker", "filter", "mesh")
                                               for s in ("d2s", "h", "pvalid", "mir")][1:],
        ),
        gather_kernel_entry("gather_cols", gather_table, "K7 make_c",
                            probe_launches["gather_cols"],
                            {"probe": probe_launches["gather_cols"]}),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
