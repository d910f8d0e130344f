#!/usr/bin/env python3
"""Drive the PyTorch port (clid_slam_torch) on one CUDA card.

    python3 chip_smoke.py             # all phases
    python3 chip_smoke.py --profile   # adds a torch.profiler phase

Phases, each printing one JSON line:
  device  the card (nvidia-smi name and power limit);
  build   nvcc of every clid_slam_torch/csrc/*.cu for sm_90a, side by side,
          with its seconds and the ptxas summary;
  kernel  the fused mapping Adam loop against its plain PyTorch version at
          the bench shapes (bs 16384, K 6, F 8, P 3, H 64, bd 1638,
          10 iterations), for 1 and 2 hidden layers and layer norm on:
          errors, kernel ms, plain ms and the card's bound;
  gather  the gather probe (clid_slam_torch/tools/probe_gather.py): the
          row, lane and column gather kernels at the six probe shapes and
          at the mapper's two shapes (int64 indices), each equal to its
          plain version bit for bit, with kernel, plain and library-call ms
          and the card's bound;
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
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): plain f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# bench shapes of the mapping kernel (bench.py small config)
BS, K, F, P, H = 16384, 6, 8, 3, 64
DEC, BD = 10, 1638
LR, SDF_SCALE, SIGMA, ADAM_EPS, W_E, NGE = 0.01, 0.055, 0.055, 1e-15, 0.5, 0.08
N_ITERS = 10


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_kernel_inputs(n_hidden, seed, device):
    """Bench-shaped inputs made from a seed with numpy (the layout the
    mapper's cache hands the kernel)."""
    import torch

    from clid_slam_torch.models.decoder import MLPParams

    rng = np.random.default_rng(seed)
    f = rng.normal(0, 0.1, (BS, K, F)).astype(np.float32)
    w0 = rng.uniform(0, 1, (BS, K)).astype(np.float32)
    w0[rng.uniform(size=(BS, K)) < 0.2] = 0.0
    w0 /= np.maximum(w0.sum(1, keepdims=True), 1e-9)
    encw0 = rng.normal(0, 0.2, (BS, P)).astype(np.float32)
    label = rng.normal(0, 0.1, BS).astype(np.float32)
    bvalid = (rng.uniform(size=BS) < 0.9).astype(np.float32)
    wsel = (rng.uniform(0.5, 1.5, BS) * bvalid).astype(np.float32)
    wtap = rng.uniform(0, 1, (6, BD, K)).astype(np.float32)
    wtap /= np.maximum(wtap.sum(-1, keepdims=True), 1e-9)
    enctapw = rng.normal(0, 0.2, (6, BD, P)).astype(np.float32)
    vd = bvalid[::DEC][:BD].copy()
    ws = [rng.normal(0, 0.3, (F + P, H)).astype(np.float32)]
    bs_ = [rng.normal(0, 0.1, (H,)).astype(np.float32)]
    if n_hidden == 2:
        ws.append(rng.normal(0, 0.2, (H, H)).astype(np.float32))
        bs_.append(rng.normal(0, 0.1, (H,)).astype(np.float32))
    wo = rng.normal(0, 0.3, (H, 1)).astype(np.float32)
    bo = rng.normal(0, 0.1, (1,)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    mlp = MLPParams([t(w) for w in ws], [t(b) for b in bs_], t(wo), t(bo))
    label_op = torch.sigmoid(t(label) / SIGMA)
    denom_inv = 1.0 / max(float(bvalid.sum()), 1.0)
    eik_den_inv = 1.0 / max(float(vd.sum()), 1.0)
    return dict(
        f0=t(f), w0=t(w0), encw0=t(encw0), label_op=label_op, wsel=t(wsel),
        wtap=t(wtap), enctapw=t(enctapw), vd=t(vd), mlp=mlp,
        denom_inv=denom_inv, eik_den_inv=eik_den_inv,
    )


def map_loop_flops(n_hidden, n_iters):
    """Operations the loop needs: per sample and per tap one MLP forward
    and backward, the IDW feature sums both ways, and Adam on every
    parameter (~10 ops each)."""
    D = F + P
    fwd = 2 * D * H + 2 * H + (2 * H * H if n_hidden == 2 else 0)
    bwd = 2 * H + 2 * H + 2 * D * H + 2 * F * H + (4 * H * H if n_hidden == 2 else 0)
    feat = 4 * K * F
    n_params = D * H + H + (H * H + H if n_hidden == 2 else 0) + H + 1
    per_iter = (BS + 6 * BD) * (fwd + bwd + feat) + 10 * (BS * K * F + n_params)
    return per_iter * n_iters


def map_loop_bytes(n_hidden):
    """Each input read once, each output written once."""
    D = F + P
    n_params = D * H + H + (H * H + H if n_hidden == 2 else 0) + H + 1
    inputs = BS * K * F + BS * K + BS * P + 2 * BS + 6 * BD * (K + P) + BD + n_params
    outputs = BS * K * F + n_params + 2
    return 4 * (inputs + outputs)


def kernel_case(n_hidden, layer_norm, device):
    import torch

    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.tools.probe_gather import time_cuda

    x = make_kernel_inputs(n_hidden, seed=n_hidden * 10 + int(layer_norm), device=device)
    kw = dict(
        dec_step=DEC, sdf_scale=SDF_SCALE, sigma=SIGMA, lr=LR, adam_eps=ADAM_EPS,
        weight_e=W_E, num_grad_eps=NGE, layer_norm=layer_norm,
    )
    args = lambda n: (
        x["f0"], x["w0"], x["encw0"], x["label_op"], x["wsel"], x["wtap"],
        x["enctapw"], x["vd"], x["mlp"], torch.tensor(n, dtype=torch.int32, device=device),
        N_ITERS, LR, x["denom_inv"], x["eik_den_inv"],
    )
    # one step: rtol 1e-5 / atol 1e-6 elementwise. Adam's first step is
    # lr * g / (|g| + eps): where the plain step is below 0.999 lr the
    # gradient lies within ~1000 eps of zero, i.e. at f32 rounding noise,
    # and the step is a sign function of that noise: there only |diff| < 2 lr
    f1, _, _ = ml.map_loop(*args(1), **kw)
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
    fk, mk, lk = ml.map_loop(*args(N_ITERS), **kw)
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
    ms = time_cuda(lambda: ml.map_loop(*args(N_ITERS), **kw), reps=20)
    plain_ms = time_cuda(lambda: ml.map_loop_reference(*args(N_ITERS), **kw), reps=3)
    flops = map_loop_flops(n_hidden, N_ITERS)
    nbytes = map_loop_bytes(n_hidden)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {
        "phase": "kernel", "name": "map_loop", "n_hidden": n_hidden,
        "layer_norm": layer_norm, "bs": BS, "K": K, "F": F, "P": P, "H": H,
        "bd": BD, "iters": N_ITERS, "max_abs_err_1step": err1,
        "noise_floor_elems_1step": n_noise,
        "max_abs_err": dmax, "p99_abs_err": d99, "mlp_max_abs_err": mlp_err,
        "mlp_median_abs_err": mlp_med, "losses_max_rel_err": loss_rel,
        "losses_kernel": lk.tolist(), "losses_plain": lr_.tolist(),
        "ms": ms, "plain_ms": plain_ms, "flop": flops, "bytes": nbytes,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
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
    if gathers["gather_rows"] < 2 * tracked:
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
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
    res = {"phase": "profile", "large": large, "frames": n_profiled, "wall_ms_per_frame": wall_ms / n_profiled,
           "device_busy_ms_per_frame": busy_ms / n_profiled,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "stages": stages, "top_kernels": top}
    emit(res)
    return res


def ptxas_summary(report):
    """Registers and spill stores per kernel entry from nvcc -Xptxas -v
    (map_loop's sample-kernel entries named by their <n_hidden, hidden/32,
    layer_norm, warps> template arguments, the gathers by their index
    type)."""
    out, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.search(r"map_loop_samplesILi(\d+)ELi(\d+)ELb(\d)ELi(\d+)E", m.group(1))
            gather = re.search(r"(gather_\w+?)_kernelI([il])E", m.group(1))
            if args:
                name = "samples<%s>" % ",".join(args.groups())
            elif gather:
                name = "%s<%s>" % (gather.group(1), {"i": "int32", "l": "int64"}[gather.group(2)])
            else:
                name = "reduce"
            out.append({"entry": name})
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and out:
            out[-1]["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def mapper_gather_cases():
    """gather_rows at the two shapes the mapper's single-batch body gives
    it on the bench configuration, made from a seed: the work slab out of
    the map's features (ascending unique map rows, the tail padded with the
    sentinel row) and the expanded features out of the work slab (the
    batch's kNN references in batch order). Both index vectors are int64."""
    rng = np.random.default_rng(7)
    cap, w, n_rows = 1 << 18, BS * K, 24000
    feats = rng.normal(0, 0.1, (cap + 1, F)).astype(np.float32)
    src_rows = np.full(w, cap, dtype=np.int64)
    src_rows[:n_rows] = np.sort(rng.choice(cap, n_rows, replace=False))
    work = feats[src_rows]
    local_idx = rng.integers(0, n_rows, w).astype(np.int64)
    site = "clid_slam_torch/mapping/mapper.py single_batch_body"
    return [
        dict(variant="mapper work0", kernel="gather_rows", table=feats, idx=src_rows,
             replaces=site),
        dict(variant="mapper f0", kernel="gather_rows", table=work, idx=local_idx,
             replaces=site),
    ]


def gather_phase(device):
    """The probe entry point's six variants and the mapper's two shapes.
    Returns the rows and the probe run's launch counts."""
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.tools import probe_gather as pg

    gt.reset_launches()
    rows = pg.run(device)
    probe_launches = dict(gt.launches)
    rows += [pg.run_case(c, device) for c in mapper_gather_cases()]
    emit({"phase": "gather", "reps": 200, "probe_launches": probe_launches, "rows": rows,
          "tolerance": "exact: torch.equal with the plain version"})
    for name, count in probe_launches.items():
        if count == 0:
            raise AssertionError(f"the probe entry point never launched {name}")
    return rows, probe_launches


def gather_kernel_entry(name, rows, main_variant, launches, by_path):
    """The summary entry of one gather kernel: times and bound of its row at
    ``main_variant``, the largest error over all of its rows."""
    mine = [r for r in rows if r["kernel"] == name]
    main = next(r for r in mine if r["variant"] == main_variant)
    return {
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

    cases = [kernel_case(1, False, device), kernel_case(2, False, device),
             kernel_case(1, True, device)]
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
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": None,
        },
        gather_kernel_entry(
            "gather_rows", gather_table, "mapper f0", large["gather_rows_launches"],
            dict(by_path("gather_rows_launches"), probe=probe_launches["gather_rows"]),
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
