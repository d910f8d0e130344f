"""Gather probe: the port's counterpart of scripts/probe_pallas_gather.py
and scripts/probe_pallas_gather2.py.

    python -m clid_slam_torch.tools.probe_gather [--device cpu] [--shrink N] [--main-path]
        [--host-cost]

Makes the two scripts' inputs from their seeds with numpy, runs the six
variants through the port's gather kernels (``ops/gather.py``), requires
each result to equal the plain PyTorch version bit for bit, and prints one
JSON line per variant. On the card a line also carries the kernel's time,
the plain version's, the time of the one PyTorch call that computes the
same function (``index_select`` / ``torch.gather``), and the card's bound:
the bytes the function needs (the indices, the 32-byte sectors of the table
that these indices touch, and the output, each once) over the H100's
3.35 TB/s. ``ms``, ``plain_ms`` and ``library_ms`` are CUDA events over
``reps`` back-to-back calls from Python on one set of tensors, as the mapper
issues them, so they hold the host's cost of issuing a call where that
exceeds the kernel's own time. ``graph_ms`` and ``library_graph_ms`` replay
``reps`` calls from one CUDA graph and hold the device time alone; they
cycle through enough copies of the inputs (three times the 50 MB L2) that
every launch reads its table from device memory, which is what the bound
counts. ``graph_hot_ms`` and ``library_graph_hot_ms`` replay the calls on
one set of tensors: every table here fits the L2 and stays there across
back-to-back launches, so these can lie under the bound. With
``--device cpu`` the plain versions run and no time is printed.

``--main-path`` adds the shapes at which the main path gathers
(``mirror_cases``, ``mapper_cases``): the hash mirrors, [2^22, 4] and
[2^21, 4] tables of (x, y, z, travel) rows indexed by the neighbour-cell
buckets of a synthetic frame's points as the neural map's probe, the
tracker, the local map's labels and the insert make them (those rows also
carry ``index_ms``, ``table[idx]`` eager and cold, what the port ran for
them before), and the mapper's work-slab gathers. ``--host-cost`` adds
the host microseconds of each wrapper call and of each part of a launch,
over 10k calls on the card.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import gather as gt

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth, L2 size, memory sector
PEAK_BYTES_S = 3.35e12
L2_BYTES = 50e6
SECTOR_BYTES = 32


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_cuda_graph(fn, reps: int, args_sets) -> float:
    """Milliseconds per call on the device alone: ``reps`` calls of ``fn``,
    cycling through ``args_sets``, captured into one CUDA graph and
    replayed, so no host launch cost is in it."""
    fn(*args_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fn(*args_sets[r % len(args_sets)])
    graph.replay()  # warm-up replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_cases(shrink: int = 1) -> List[dict]:
    """The six variants with the scripts' inputs (same seeds, same draw
    order). ``shrink`` divides every row count, for CPU tests."""
    rng = np.random.default_rng(0)  # probe_pallas_gather.py:43
    ht, nk = (1 << 15) // shrink, (128 * 1024) // shrink
    table = rng.normal(size=(ht, 4)).astype(np.float32)
    idx = rng.integers(0, ht, size=(nk,)).astype(np.int32)
    ht2 = n2 = (1 << 14) // shrink
    table2 = rng.normal(size=(ht2, 128)).astype(np.float32)
    idx2 = rng.integers(0, ht2, size=(n2,)).astype(np.int32)
    n3, k3 = 16384 // shrink, 128
    src = rng.normal(size=(n3, k3)).astype(np.float32)
    sel = rng.integers(0, k3, size=(n3, k3)).astype(np.int32)

    rng = np.random.default_rng(0)  # probe_pallas_gather2.py:46
    w, f = 98304 // shrink, 8
    slab = rng.normal(size=(w, f)).astype(np.float32)
    # sorted with duplicates, like the mapper's sorted kNN references
    sidx = np.sort(rng.integers(0, w, size=(w,))).astype(np.int32)

    rows, lanes, cols = "gather_rows", "gather_lanes", "gather_cols"
    return [
        dict(variant="K2 gather_a", kernel=rows, table=table, idx=idx,
             replaces="scripts/probe_pallas_gather.py:58"),
        dict(variant="K3 gather_a2", kernel=rows, table=table2, idx=idx2,
             replaces="scripts/probe_pallas_gather.py:89"),
        dict(variant="K4 gather_b", kernel=lanes, table=src, idx=sel,
             replaces="scripts/probe_pallas_gather.py:121"),
        dict(variant="K5 make_a", kernel=rows, table=slab, idx=sidx,
             replaces="scripts/probe_pallas_gather2.py:71"),
        dict(variant="K6 make_b", kernel=rows, table=slab, idx=sidx,
             replaces="scripts/probe_pallas_gather2.py:83"),
        dict(variant="K7 make_c", kernel=cols, table=np.ascontiguousarray(slab.T), idx=sidx,
             replaces="scripts/probe_pallas_gather2.py:96"),
    ]


def mapper_cases(shrink: int = 1) -> List[dict]:
    """gather_rows at the two shapes the mapper's single-batch body gives
    it on the bench configuration (bs 16384, K 6, F 8, map 2^18), made from
    a seed: the work slab out of the map's features (ascending unique map
    rows, the tail padded with the sentinel row) and the expanded features
    out of the work slab (the batch's kNN references in batch order). Both
    index vectors are int64. The same expanded-feature gather at
    feature_dim 6, whose rows move as single floats. ``shrink`` divides the
    row counts."""
    rng = np.random.default_rng(7)
    cap, w, n_rows = (1 << 18) // shrink, 16384 * 6 // shrink, 24000 // shrink
    feats = rng.normal(0, 0.1, (cap + 1, 8)).astype(np.float32)
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
        dict(variant="mapper f0 feature_dim 6", kernel="gather_rows",
             table=np.ascontiguousarray(work[:, :6]), idx=local_idx, replaces=site),
    ]


def mirror_cases(shrink: int = 1) -> List[dict]:
    """``gather_rows`` at the shapes of the main path's hash-mirror
    gathers, with indices made as the main path makes them: the bench's
    small sequence's first scan in the world frame (points jittered by
    0.1 m where they stand for samples), occupied buckets holding their
    voxel's point, the rest the empty sentinel (1e9), and int64 bucket
    indices from ``neighbor_hash_soa`` (81 cells of 0.4 m, search_alpha
    0.5; the local map 7 cells of 0.2 m). ``shrink`` divides the table rows
    and the point counts, for CPU tests."""
    from ..models.local_map import LOCAL_NB_OFFSETS
    from ..ops.voxel import grid_coords, neighbor_hash_soa, neighbor_offsets, voxel_hash
    from ..pipeline import bench_cases as bc

    seq = bc.make_sequence(False, 1)
    pose = seq.poses[0]
    world = (seq.scans[0][:, :3] @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    rng = np.random.default_rng(5)

    def mirror(rows, voxel):
        table = np.full((rows, 4), 1e9, np.float32)
        pts = torch.from_numpy(world)
        h = voxel_hash(grid_coords(pts, voxel), rows).numpy()
        table[h, :3] = world
        table[h, 3] = 0.0
        return table

    def pick(count, jitter):
        sel = rng.choice(world.shape[0], count, replace=count > world.shape[0])
        return world[sel] + rng.normal(0, jitter, (count, 3)).astype(np.float32)

    def idx(points, offs, voxel, rows):
        return neighbor_hash_soa(torch.from_numpy(points), torch.as_tensor(offs), voxel,
                                 rows).reshape(-1).numpy()

    nmap, local = (1 << 22) // shrink, (1 << 21) // shrink
    nb81 = neighbor_offsets(2, 0.5)
    own = np.zeros((1, 3), np.int32)
    t_map, t_local = mirror(nmap, 0.4), mirror(local, 0.2)
    site = "clid_slam_torch/models/"
    return [
        dict(variant="mirror mapper probe", kernel="gather_rows", table=t_map,
             idx=idx(pick(16384 // shrink, 0.1), nb81, 0.4, nmap),
             replaces=site + "neural_map.py neighborhood_probe (mapping/mapper.py)"),
        dict(variant="mirror tracker probe", kernel="gather_rows", table=t_map,
             idx=idx(pick(8192 // shrink, 0.0), nb81, 0.4, nmap),
             replaces=site + "neural_map.py neighborhood_probe (odometry/iekf.py)"),
        dict(variant="mirror local map", kernel="gather_rows", table=t_local,
             idx=idx(pick(131072 // shrink, 0.1), LOCAL_NB_OFFSETS, 0.2, local),
             replaces=site + "local_map.py region_specific_sdf"),
        dict(variant="mirror insert", kernel="gather_rows", table=t_map,
             idx=idx(pick(65536 // shrink, 0.1), own, 0.4, nmap),
             replaces=site + "neural_map.py insert_points"),
    ]


_KERNELS = {
    # kernel wrapper, plain version, the one PyTorch call of the same function
    "gather_rows": (gt.gather_rows, gt.gather_rows_reference,
                    lambda t, i: t.index_select(0, i)),
    "gather_lanes": (gt.gather_lanes, gt.gather_lanes_reference,
                     lambda t, i: torch.gather(t, 1, i)),
    "gather_cols": (gt.gather_cols, gt.gather_cols_reference,
                    lambda t, i: t.index_select(1, i)),
}


def gather_bytes(kernel: str, table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> int:
    """The bytes this call needs: the indices read once, the output written
    once, and of the table the 32-byte sectors that these indices touch
    (not the whole table: an index vector may leave most of it unread)."""
    i = idx.long()
    width = table.shape[1]
    if kernel == "gather_rows":  # every element of a touched row
        elems = (torch.unique(i)[:, None] * width
                 + torch.arange(width, device=i.device)).flatten()
    elif kernel == "gather_lanes":
        elems = (torch.arange(table.shape[0], device=i.device)[:, None] * width + i).flatten()
    else:  # gather_cols
        elems = (torch.arange(table.shape[0], device=i.device)[:, None] * width
                 + torch.unique(i)).flatten()
    per_sector = SECTOR_BYTES // table.element_size()
    sectors = torch.unique(torch.div(elems, per_sector, rounding_mode="floor")).numel()
    return sectors * SECTOR_BYTES + sum(x.numel() * x.element_size() for x in (idx, out))


def run_case(case: dict, dev: torch.device, reps: int = 200) -> dict:
    """One variant (a dict as ``make_cases`` makes them) on ``dev``: the row
    that ``run`` returns for it. Raises on a mismatch with the plain version."""
    kernel, plain, library = _KERNELS[case["kernel"]]
    table = torch.from_numpy(case["table"]).to(dev)
    idx = torch.from_numpy(case["idx"]).to(dev)
    out = kernel(table, idx)
    want = plain(table, idx)
    if out.shape != want.shape or not torch.equal(out, want):
        raise AssertionError(f"{case['variant']}: {case['kernel']} differs from its plain version")
    nbytes = gather_bytes(case["kernel"], table, idx, out)
    row = {
        "variant": case["variant"], "kernel": case["kernel"],
        "replaces": case["replaces"], "table": list(table.shape),
        "idx": list(idx.shape), "idx_dtype": str(idx.dtype).replace("torch.", ""),
        "exact": True, "max_abs_err": float((out - want).abs().max()),
        "bytes": nbytes, "device": str(dev),
    }
    if dev.type == "cuda":
        # torch.gather takes int64 only: converted outside the timing
        lib_idx = idx.long() if case["kernel"] == "gather_lanes" else idx
        if not torch.equal(library(table, lib_idx), want):
            raise AssertionError(f"{case['variant']}: the library call differs")
        hot, lib_hot = [(table, idx)], [(table, lib_idx)]
        whole = sum(x.numel() * x.element_size() for x in (table, idx, out))
        copies = min(reps, int(3 * L2_BYTES // whole) + 1)
        cold = [(table.clone(), idx.clone()) for _ in range(copies)]
        lib_cold = [(t, i.long() if case["kernel"] == "gather_lanes" else i) for t, i in cold]
        row.update(
            ms=time_cuda(lambda: kernel(table, idx), reps),
            plain_ms=time_cuda(lambda: plain(table, idx), reps),
            library_ms=time_cuda(lambda: library(table, lib_idx), reps),
            graph_ms=time_cuda_graph(kernel, reps, cold),
            library_graph_ms=time_cuda_graph(library, reps, lib_cold),
            graph_hot_ms=time_cuda_graph(kernel, reps, hot),
            library_graph_hot_ms=time_cuda_graph(library, reps, lib_hot),
            copies=copies, bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes",
        )
        if case["variant"].startswith("mirror"):
            index = lambda t, i: t[i]
            row.update(index_ms=time_cuda(lambda: index(table, idx), reps),
                       index_graph_ms=time_cuda_graph(index, reps, cold))
    return row


def _launch_parts(dev, table, idx):
    """The parts of a ``gather_rows`` launch on the card, each as a
    callable, for ``host_cost``; the bound C call launches the kernel."""
    import ctypes

    from ..ops import _build

    out = gt.gather_rows(table, idx)
    fn = gt._fn("gather_rows")
    index = dev.index or 0
    args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), 1, 1, 1, 0)
    vp = ctypes.c_void_p
    return {
        "checks": lambda: gt._check("gather_rows", table, idx, 2, 1),
        "new_empty": lambda: table.new_empty((1, 4)),
        "torch_empty": lambda: torch.empty((1, 4), dtype=torch.float32, device=dev),
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
        "c_void_p_objects": lambda: (vp(args[0]), vp(args[1]), vp(args[2]), vp(args[0])),
        "data_ptrs": lambda: (table.data_ptr(), idx.data_ptr(), out.data_ptr()),
        "library_lookup_locked": lambda: _build.load("gather", gt._declare),
        "c_call_launch": lambda: fn(*args, torch._C._cuda_getCurrentRawStream(index)),
    }


def host_cost(device=None, reps: int = 10000, parts: bool = False) -> dict:
    """Host microseconds per call of each whole gather wrapper call, over
    ``reps`` calls on the card, at a one-row shape (so the device keeps
    up). With ``parts``, also each part of a launch: the wrapper's checks,
    the output allocation, the current stream as a ``Stream`` object and as
    a raw handle, ctypes ``c_void_p`` objects against plain ints, the
    library lookup under its lock and the bound C call alone."""
    import time

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("host_cost measures launches on the card")
    table = torch.zeros((4, 4), device=dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    sel = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    calls = {
        "gather_rows": lambda: gt.gather_rows(table, idx),
        "gather_lanes": lambda: gt.gather_lanes(table, sel),
        "gather_cols": lambda: gt.gather_cols(table, idx),
    }
    if parts:
        calls = {**_launch_parts(dev, table, idx), **calls}
    res = {"phase": "host_cost", "reps": reps, "device": str(dev), "us_per_call": {}}
    for name, f in calls.items():
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        res["us_per_call"][name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return res


def run(device=None, shrink: int = 1, reps: int = 200, main_path: bool = False) -> List[dict]:
    """Run the six variants (and with ``main_path`` the hash-mirror and
    mapper shapes) on ``device`` (None: the card). Returns one row per
    variant; raises on any mismatch with the plain version."""
    dev = resolve_device(device)
    extra = mirror_cases(shrink) + mapper_cases(shrink) if main_path else []
    cases = make_cases(shrink) + extra
    return [run_case(case, dev, reps) for case in cases]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' runs the plain versions; default: the card")
    ap.add_argument("--shrink", type=int, default=1, help="divide every row count by this")
    ap.add_argument("--main-path", action="store_true",
                    help="add the main path's shapes: the hash mirrors and the mapper's slab")
    ap.add_argument("--host-cost", action="store_true",
                    help="also time each part of a launch's host path (card only)")
    args = ap.parse_args(argv)
    for row in run(args.device, args.shrink, main_path=args.main_path):
        print(json.dumps(row), flush=True)
    if args.host_cost:
        print(json.dumps(host_cost(args.device, parts=True)), flush=True)


if __name__ == "__main__":
    main()
