#!/usr/bin/env python3
"""Drive the PyTorch port (clid_slam_torch) on one CUDA card.

    python3 chip_smoke.py             # all phases
    python3 chip_smoke.py --profile   # adds a torch.profiler phase

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
          floats, neighbour-cell buckets) and the mapper's work slab (int64
          indices; feature_dim 8, and 6 for rows that move as single
          floats), each equal to its plain version bit for bit, with
          kernel, plain and library-call ms (and table[idx] at the mirror
          shapes) and the card's bound; then the host time of one call
          of each gather wrapper;
  stream  the port's StreamingSlam on the bench's small sequence
          (1024x32 beams, 25 frames as bench.py runs them: 10 warm-up
          frames, 15 timed), with ATE/ARE against ground truth and the
          kernels' launch counts on that run;
  stream_large     the same StreamingSlam on the bench's large sequence and
          configuration (200 frames, 10 warm-up; prune and rehash every 50
          frames), nothing cut, with the point count around each prune.
          On this trajectory no point goes inactive, so these prunes are an
          identity compaction and a rehash;
  prune_check      on the map that run ends with: the configured prune (the map
          must probe as before) and a global prune at the median certainty
          (which drops about half the rows); in both, the survivors are the
          kept rows in order and the rebuilt hash resolves each of them;
  stream_fallback  the small sequence with leaky ReLU, which the fused
          kernel does not take: 12 frames on the mapper's autograd loop;
  kernels the per-kernel summary line.
Then the nvidia-smi line and, last, {"ok": true, "device": {...}}.

Any failed check raises (non-zero exit, no result line). Without a CUDA
card the script exits non-zero before any phase. Nothing here imports JAX
or clid_slam_tpu.
"""

import argparse
import functools
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

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


def stream_phase(phase, large, n_frames, warmup, device, fused=True, **overrides):
    """Drive StreamingSlam over a bench sequence as bench.py times it and
    check the result. The kernels' launch counts are set to 0 just before
    the run and read just after. ``fused`` says whether tracked frames are
    expected on the map_loop kernel (else on the autograd loop). Returns the
    phase's line and the system."""
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
    tracked = sum(1 for i in range(n_frames) if cfg.track_on and i > 0)
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
        "tracked_frames": tracked,
        "peak_mem_gb": peak_mem_gb,
    }
    emit(res)
    if out["failed"]:
        raise AssertionError("tracking failed")
    if not m["ate_rmse_m"] < 0.2:
        raise AssertionError(f"ATE {m['ate_rmse_m']} >= 0.2 m")
    if launches != (tracked if fused else 0):
        raise AssertionError(f"map_loop launched {launches} times for {tracked} tracked frames")
    # per tracked frame at least: the mapper's two slab gathers, and the
    # mirror gathers of the tracker's and the mapper's probes, the insert and
    # the labels
    if gathers["gather_rows"] < 6 * tracked:
        raise AssertionError(
            f"gather_rows launched {gathers['gather_rows']} times for {tracked} tracked frames"
        )
    want_prunes = (
        [f for f in range(n_frames) if (f + 1) % cfg.prune_freq_frame == 0]
        if cfg.prune_map_on else []
    )
    if [p["frame"] for p in res["prunes"]] != want_prunes:
        raise AssertionError(f"prunes at {res['prunes']}, expected at frames {want_prunes}")
    if any(not 0 < p["points_after"] <= p["points_before"] for p in res["prunes"]):
        raise AssertionError(f"a prune lost the map or grew it: {res['prunes']}")
    return res, system


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


def launch_attribution(prof, n_profiled):
    """Device time per frame of every device activity, by the ``frame.*``
    range whose host span holds the runtime call that launched it. The
    profiler ties a kernel to a stage only through a torch op; a kernel
    launched through ctypes (the hand kernels) has none, so its launch's
    host time places it here. Returns (ms by stage, with "outside" and
    "unlinked"; the hand kernels' ms and launches by stage)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.name().startswith("frame.") and e.device_type() != cuda]
    launch_at = {e.correlation_id(): e.start_ns() for e in events if e.device_type() != cuda
                 and any(w in e.name() for w in ("Launch", "Memcpy", "Memset"))}
    by_stage, hand = {}, {}
    for e in events:
        # device activity only: the frame.* ranges are mirrored onto the
        # device's timeline as annotations, which are no work
        if e.device_type() != cuda or e.is_user_annotation() or e.name().startswith("frame."):
            continue
        t = launch_at.get(e.correlation_id(), launch_at.get(e.linked_correlation_id()))
        stage = "unlinked" if t is None else next(
            (name for lo, hi, name in ranges if lo <= t <= hi), "outside")
        ms = e.duration_ns() / 1e6 / n_profiled
        by_stage[stage] = by_stage.get(stage, 0.0) + ms
        kernel = re.search(r"(map_loop|gather_rows|gather_lanes|gather_cols)_kernel", e.name())
        if kernel:
            row = hand.setdefault(f"{kernel.group(1)} @ {stage}", {"device_ms_per_frame": 0.0,
                                                                  "launches_per_frame": 0.0})
            row["device_ms_per_frame"] += ms
            row["launches_per_frame"] += 1 / n_profiled
    return by_stage, hand


def profile_phase(large, n_frames, n_profiled, device):
    """torch.profiler over the last ``n_profiled`` frames of a fresh run:
    device time per stage range and per kernel, and the device busy share
    of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg, seq, system = make_system(large, n_frames, device)
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
        if e.key.startswith("frame.") and e.device_type != cuda:
            stages[e.key] = {"device_ms_per_frame": dev_ms(e) / n_profiled,
                             "host_ms_per_frame": e.cpu_time_total / 1e3 / n_profiled}
    # device work: the kernel (and memcpy/memset) rows, each counted once
    kernels = sorted(
        (e for e in events if e.device_type == cuda and not e.key.startswith("frame.")),
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
    res = {"phase": "profile", "large": large, "frames": n_profiled, "wall_ms_per_frame": wall_ms / n_profiled,
           "device_busy_ms_per_frame": busy_ms / n_profiled,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "stages": stages, "hand_kernels_by_stage": hand, "top_kernels": top,
           "index_ops": index_rows[:12]}
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
            gather = re.search(r"(gather_\w+?)_kernelI([il])(6float4|f)?E", m.group(1))
            if args:
                name = "map_loop<%s>" % ",".join(args.groups())
            elif gather:
                name = "%s<%s>" % (gather.group(1), {"i": "int32", "l": "int64"}[gather.group(2)]
                                   + {None: "", "6float4": ",float4", "f": ",float"}[gather.group(3)])
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
    hash mirrors and the mapper's work slab), and the host time of one call
    of each wrapper. Returns the rows and the probe run's launch counts."""
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


def gather_kernel_entry(name, rows, main_variant, launches, by_path, mirror_variant=None):
    """The summary entry of one gather kernel: times and bound of its row at
    ``main_variant``, the largest error over all of its rows, and beside
    them the times of its row at ``mirror_variant``."""
    mine = [r for r in rows if r["kernel"] == name]
    main = next(r for r in mine if r["variant"] == main_variant)
    extra = {}
    if mirror_variant:
        m = next(r for r in mine if r["variant"] == mirror_variant)
        extra["mirror_variant"] = {k: m[k] for k in (
            "variant", "table", "idx", "idx_dtype", "ms", "graph_ms", "bound_ms", "library_ms",
            "library_graph_ms", "index_ms", "index_graph_ms")}
    return {**extra, "main_variant": main_variant,
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
                    "fresh 60-frame large run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "clid_slam_torch")):
        print("chip_smoke: clid_slam_torch/ not found beside this script", file=sys.stderr)
        sys.exit(3)
    sys.path.insert(0, REPO)
    from clid_slam_torch import set_full_precision
    from clid_slam_torch.ops import _build
    from clid_slam_torch.tools.time_map_loop import nvidia_smi_line

    set_full_precision()
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    names = ("map_loop", "gather")
    started = [_build.start_build(n) for n in names]  # one nvcc each, side by side
    reports = [_build.finish_build(b) for b in started]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"clid_slam_torch/csrc/{n}.cu" for n in names],
          "ptxas": {n: ptxas_summary(r) for n, r in zip(names, reports)}})

    # the bench config first: 1 hidden layer of 64, no layer norm
    cases = [kernel_case(nh, ln, device, hidden) for nh in (1, 2) for hidden in (64, 32)
             for ln in (False, True)]
    cases.append(kernel_case(1, False, device, streamed=True))
    for c in cases:
        emit(c)
    gather_table, probe_launches = gather_phase(device)

    small = stream_phase("stream", False, 25, 10, device)[0]
    large, large_system = stream_phase("stream_large", True, 200, 10, device)
    prune_check(large_system, 200)
    del large_system
    fallback = stream_phase("stream_fallback", False, 12, 10, device, fused=False,
                            mlp_leaky_relu=True)[0]
    if args.profile:
        profile_phase(False, 20, 5, device)
        profile_phase(True, 60, 5, device)

    def by_path(key):
        return {r["phase"]: r[key] for r in (small, large, fallback)}

    main_case = cases[0]  # the bench config: 1 hidden layer, no layer norm
    # launches: the count on the large run, this script's full-width path;
    # the lane and column gathers run on the probe entry point only
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
            mirror_variant="mirror mapper probe",
        ),
        gather_kernel_entry("gather_lanes", gather_table, "K4 gather_b",
                            probe_launches["gather_lanes"],
                            {"probe": probe_launches["gather_lanes"]}),
        gather_kernel_entry("gather_cols", gather_table, "K7 make_c",
                            probe_launches["gather_cols"],
                            {"probe": probe_launches["gather_cols"]}),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
