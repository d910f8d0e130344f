"""Gather probe: the port's counterpart of scripts/probe_pallas_gather.py
and scripts/probe_pallas_gather2.py.

    python -m clid_slam_torch.tools.probe_gather [--device cpu] [--shrink N]

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
    return row


def run(device=None, shrink: int = 1, reps: int = 200) -> List[dict]:
    """Run the six variants on ``device`` (None: the card). Returns one row
    per variant; raises on any mismatch with the plain version."""
    dev = resolve_device(device)
    return [run_case(case, dev, reps) for case in make_cases(shrink)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' runs the plain versions; default: the card")
    ap.add_argument("--shrink", type=int, default=1, help="divide every row count by this")
    args = ap.parse_args(argv)
    for row in run(args.device, args.shrink):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
