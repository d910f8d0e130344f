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
(``mirror_cases``, ``mapper_cases``, ``selection_cases``, ``dynba_cases``,
``mesh_cases``):
the hash mirrors, [2^22, 4] and
[2^21, 4] tables of (x, y, z, travel) rows indexed by the neighbour-cell
buckets of a synthetic frame's points as the neural map's probe, the
tracker, the local map's labels and the insert make them (those rows also
carry ``index_ms``, ``table[idx]`` eager and cold, what the port ran for
them before), the mapper's work-slab gathers, and the kNN selection's lane
gathers (``selection_cases``: the mapper's K 6 and the tracker's 16 of 81
candidate buckets, picked by ``smallest_k`` out of a synthetic frame's
probe, at the four element widths the path gathers: f32 distances, int64
buckets, bool validity and 16-byte mirror rows; the selectors are handed
over as the path hands them, the first K columns of the whole sort, rows
81 apart; ``torch.gather(1)``, the library call, is what the port ran
there before), and those of the dynamic filter and BA (``dynba_cases``:
BA's window-pose gather, the filter's mirror probe and selection over a
whole scan, and ``query_feature``'s feature rows at both), and those of
one mesh chunk (``mesh_cases``: 48^3 grid points through the probe, the
selection and the feature rows). ``--host-cost`` adds the host microseconds of each wrapper
call and of each part of a launch, over 10k calls on the card.
"""

from __future__ import annotations

import argparse
import functools
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
    feature_dim 6, whose rows move as single floats. With ``color_on`` the
    same two gathers move the color slab ([cap+1, feature_dim]) beside the
    geometric one: the color work rows and their references. ``shrink``
    divides the row counts."""
    rng = np.random.default_rng(7)
    cap, w, n_rows = (1 << 18) // shrink, 16384 * 6 // shrink, 24000 // shrink
    feats = rng.normal(0, 0.1, (cap + 1, 8)).astype(np.float32)
    src_rows = np.full(w, cap, dtype=np.int64)
    src_rows[:n_rows] = np.sort(rng.choice(cap, n_rows, replace=False))
    work = feats[src_rows]
    local_idx = rng.integers(0, n_rows, w).astype(np.int64)
    color = rng.uniform(0, 1, (cap + 1, 8)).astype(np.float32)
    color[cap] = 0.0  # the sentinel row
    site = "clid_slam_torch/mapping/mapper.py single_batch_body"
    return [
        dict(variant="mapper work0", kernel="gather_rows", table=feats, idx=src_rows,
             replaces=site),
        dict(variant="mapper f0", kernel="gather_rows", table=work, idx=local_idx,
             replaces=site),
        dict(variant="mapper f0 feature_dim 6", kernel="gather_rows",
             table=np.ascontiguousarray(work[:, :6]), idx=local_idx, replaces=site),
        dict(variant="mapper color work0", kernel="gather_rows", table=color, idx=src_rows,
             replaces=site),
        dict(variant="mapper color f0", kernel="gather_rows", table=color[src_rows],
             idx=local_idx, replaces=site),
    ]


@functools.lru_cache(maxsize=2)
def _frame(shrink: int):
    """The bench's small sequence's first scan in the world frame, and the
    neural map's hash mirror ([2^22 / shrink, 4]) built from it: occupied
    buckets hold their voxel's point and travel 0, the rest the empty
    sentinel (1e9). Cached, since the mirror and the selection cases share
    it (64 MB uncut); callers only read it."""
    from ..pipeline import bench_cases as bc

    seq = bc.make_sequence(False, 1)
    pose = seq.poses[0]
    world = (seq.scans[0][:, :3] @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    return world, _mirror(world, (1 << 22) // shrink, 0.4)


def _mirror(world, rows, voxel):
    from ..ops.voxel import grid_coords, voxel_hash

    table = np.full((rows, 4), 1e9, np.float32)
    h = voxel_hash(grid_coords(torch.from_numpy(world), voxel), rows).numpy()
    table[h, :3] = world
    table[h, 3] = 0.0
    return table


def _buckets(points, offs, voxel, rows):
    """The int64 buckets of ``points``' neighbour cells ``offs``, flat."""
    from ..ops.voxel import neighbor_hash_soa

    return neighbor_hash_soa(torch.from_numpy(points), torch.as_tensor(offs), voxel,
                             rows).reshape(-1).numpy()


def _pick(world, rng, count, jitter):
    sel = rng.choice(world.shape[0], count, replace=count > world.shape[0])
    return world[sel] + rng.normal(0, jitter, (count, 3)).astype(np.float32)


def _select(pts: torch.Tensor, table: np.ndarray):
    """The neighbourhood probe and the kNN sort as ``query_feature`` makes
    them at the bench's 0.4 m voxels (81 cells, search_alpha 0.5): the
    [N, 81] sorted distances (over the bench's max_valid_dist2, 4.32 m^2:
    9e3), buckets, validity and mirror rows of ``pts`` in the mirror
    ``table``, and the whole stable sort of the distances."""
    from ..models.neural_map import smallest_k
    from ..ops.voxel import neighbor_hash_soa, neighbor_offsets

    nb81 = torch.as_tensor(neighbor_offsets(2, 0.5))
    h = neighbor_hash_soa(pts, nb81, 0.4, table.shape[0])
    mir = torch.from_numpy(table)[h]
    d2 = torch.sum((mir[..., :3] - pts[:, None, :]) ** 2, dim=-1)
    valid = d2 <= 4.32
    d2s = torch.where(valid, d2, torch.full_like(d2, 9e3))
    return d2s, h, valid, mir, smallest_k(d2s, d2s.shape[1])


def _selection(who, pts, table, k, site):
    """The four ``gather_lanes`` cases of one selection (``_select``):
    its f32 distances, int64 buckets, bool validity and 16-byte mirror
    rows, picked by the first ``k`` columns of the sort."""
    d2s, h, valid, mir, order = _select(pts, table)
    return [dict(variant=f"select {who} {name}", kernel="gather_lanes", table=src.numpy(),
                 idx=order.numpy(), k=k, replaces=site)
            for name, src in (("d2s", d2s), ("h", h), ("pvalid", valid), ("mir", mir))]


def selection_cases(shrink: int = 1) -> List[dict]:
    """``gather_lanes`` at the kNN selection's shapes, with selectors made
    as the main path makes them: a frame's points (jittered by 0.1 m for the
    mapper's samples) probe the neural map's mirror at their 81 neighbour
    cells (``_frame``; 0.4 m voxels, search_alpha 0.5) as
    ``neighborhood_probe`` does, distances over the bench's
    max_valid_dist2 (4.32 m^2) become 9e3, and ``smallest_k`` picks the
    mapper's K 6 of 16384 points and the tracker's 16 of 8192. Each shape
    at the four sources the path gathers from: the distances (f32), the
    buckets (int64), the validity (bool) and the mirror rows ([N, 81, 4]
    f32, 16-byte lanes). A case's ``idx`` is the whole sort [N, 81] and
    ``k`` its first columns that the path gathers with (``run_case`` hands
    the kernel that strided view, as ``smallest_k`` does). ``shrink``
    divides the point counts and the mirror's rows."""
    world, table = _frame(shrink)
    rng = np.random.default_rng(6)
    cases = []
    for who, count, k, jitter, site in (
        ("mapper", 16384, 6, 0.1, "clid_slam_torch/mapping/mapper.py build_cache"),
        ("tracker", 8192, 16, 0.0, "clid_slam_torch/odometry/iekf.py build_candidates"),
    ):
        pts = torch.from_numpy(_pick(world, rng, count // shrink, jitter))
        cases += _selection(who, pts, table, k, site)
    return cases


def dynba_cases(shrink: int = 1) -> List[dict]:
    """``gather_rows`` and ``gather_lanes`` at the shapes that the dynamic
    filter and sliding-window BA give them on the bench's small
    configuration (the filter over a whole scan of 32768 points, BA 16384
    pool samples an iteration over a 20-frame window, K 6, a map of 2^18
    rows of 8 features and the sentinel row), with indices made as the
    path makes them:

    - BA's window-pose gather: the window's [20, 4, 4] poses as [20, 16]
      rows, by ``clamp(ts - 20, 0, 19)`` of uniform draws from a pool that
      holds 40 frames' samples (about half of them on row 0);
    - the filter's hash-mirror probe, [2^22, 4] by the 81 neighbour cells
      of the scan's points;
    - the filter's kNN selection (``_selection``, K 6 of 81 for 32768
      points);
    - ``query_feature``'s feature rows for BA's samples (jittered by
      0.1 m) and the filter's points: the map row of each of the K picks,
      the sentinel row where a pick is invalid, a duplicate or empty; map
      rows are numbered in the order the scan first reaches their bucket,
      as the insert numbers them.

    ``shrink`` divides the point counts, the map's rows and the mirror's."""
    from ..ops.voxel import neighbor_offsets

    world, table = _frame(shrink)
    rng = np.random.default_rng(8)
    scan = torch.from_numpy(world[: 32768 // shrink])
    samples = torch.from_numpy(_pick(world, rng, 16384 // shrink, 0.1))
    feats, feature_rows = _map_rows(world, table, shrink, rng)
    poses = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 1.0, (20, 3))
    ts = rng.integers(0, 40, 16384 // shrink)
    ba, flt = "clid_slam_torch/mapping/bundle_adjustment.py", "clid_slam_torch/mapping/dynamic_filter.py"
    query = "clid_slam_torch/models/neural_map.py query_feature ("
    return [
        dict(variant="BA pose gather", kernel="gather_rows", table=poses.reshape(20, 16),
             idx=np.clip(ts - 20, 0, 19).astype(np.int64), replaces=ba + " bundle_adjust"),
        dict(variant="mirror filter probe", kernel="gather_rows", table=table,
             idx=_buckets(world[: 32768 // shrink], neighbor_offsets(2, 0.5), 0.4, table.shape[0]),
             replaces="clid_slam_torch/models/neural_map.py neighborhood_probe (" + flt + ")"),
        *_selection("filter", scan, table, 6, query + flt + ")"),
        dict(variant="query feats BA", kernel="gather_rows", table=feats,
             idx=feature_rows(samples), replaces=query + ba + ")"),
        dict(variant="query feats filter", kernel="gather_rows", table=feats,
             idx=feature_rows(scan), replaces=query + flt + ")"),
    ]


def _map_rows(world, table, shrink, rng):
    """The feature slab of a 2^18-row map (``/ shrink``) with its sentinel
    row, from ``rng``, and ``feature_rows(pts)``: ``query_feature``'s
    ``safe`` rows for the first K 6 picks of ``pts`` in the mirror
    ``table`` (the map row of each pick, the sentinel row where a pick is
    invalid, a duplicate or empty; map rows numbered in the order the scan
    ``world`` first reaches their bucket, as the insert numbers them)."""
    from ..models.neural_map import dedupe_mask

    cap = (1 << 18) // shrink
    buckets, first = np.unique(_buckets(world, np.zeros((1, 3), np.int32), 0.4, table.shape[0]),
                               return_index=True)
    hash_rows = np.full(table.shape[0], -1, np.int64)
    hash_rows[buckets[np.argsort(first)]] = np.arange(buckets.size) % cap
    feats = rng.normal(0, 0.1, (cap + 1, 8)).astype(np.float32)

    def feature_rows(pts):
        d2s, h, valid, _, order = _select(pts, table)
        sel = order[:, :6]
        h_sel = torch.gather(h, 1, sel)
        rows = torch.from_numpy(hash_rows)[h_sel]
        ok = torch.gather(valid, 1, sel) & ~dedupe_mask(h_sel) & (rows >= 0)
        return torch.where(ok, rows, torch.full_like(rows, cap)).reshape(-1).numpy()

    return feats, feature_rows


def mesh_cases(shrink: int = 1) -> List[dict]:
    """``gather_rows`` and ``gather_lanes`` at the shapes that one mesh
    chunk gives them (``mesher.py``: chunk_dim 48, so 48^3 = 110592 grid
    points through ``query_feature``; the small configuration's 0.1 m
    marching resolution, 0.4 m voxels, K 6): the chunk's hash-mirror probe
    ([2^22, 4] by its points' 81 neighbour cells), its kNN selection (K 6
    of 81, the four sources) and its feature rows ([2^18+1, 8] by 110592 x
    6). The chunk is the one centred on the first scan's first point, so
    its grid crosses the wall there. ``shrink`` divides the points (the
    first of the chunk's grid), the map's rows and the mirror's."""
    from ..ops.voxel import neighbor_offsets

    world, table = _frame(shrink)
    feats, feature_rows = _map_rows(world, table, shrink, np.random.default_rng(9))
    cd, res = 48, 0.1
    r = np.arange(cd, dtype=np.float32)
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    origin = (world[0] - (cd - 1) * res / 2).astype(np.float32)
    pts = (origin + grid * np.float32(res))[: cd**3 // shrink]
    nm, by = "clid_slam_torch/models/neural_map.py", "(clid_slam_torch/mesher.py query_chunk)"
    return [
        dict(variant="mirror mesh probe", kernel="gather_rows", table=table,
             idx=_buckets(pts, neighbor_offsets(2, 0.5), 0.4, table.shape[0]),
             replaces=f"{nm} neighborhood_probe {by}"),
        *_selection("mesh", torch.from_numpy(pts), table, 6, f"{nm} query_feature {by}"),
        dict(variant="query feats mesh", kernel="gather_rows", table=feats,
             idx=feature_rows(torch.from_numpy(pts)), replaces=f"{nm} query_feature {by}"),
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
    from ..ops.voxel import neighbor_offsets

    world, t_map = _frame(shrink)
    rng = np.random.default_rng(5)
    pick = lambda count, jitter: _pick(world, rng, count, jitter)
    idx = _buckets

    nmap, local = (1 << 22) // shrink, (1 << 21) // shrink
    nb81 = neighbor_offsets(2, 0.5)
    own = np.zeros((1, 3), np.int32)
    t_local = _mirror(world, local, 0.2)
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
                     lambda t, i: torch.gather(t, 1, i if t.dim() == 2
                                               else i[..., None].expand(-1, -1, t.shape[2]))),
    "gather_cols": (gt.gather_cols, gt.gather_cols_reference,
                    lambda t, i: t.index_select(1, i)),
}


def gather_bytes(kernel: str, table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> int:
    """The bytes this call needs: the indices read once, the output written
    once, and of the table the 32-byte sectors that these indices touch
    (not the whole table: an index vector may leave most of it unread)."""
    i = idx.long()
    width = table.shape[1]
    element = table.element_size()
    if kernel == "gather_rows":  # every element of a touched row
        elems = (torch.unique(i)[:, None] * width
                 + torch.arange(width, device=i.device)).flatten()
    elif kernel == "gather_lanes":  # a lane: an element, or a [.., C] piece
        elems = (torch.arange(table.shape[0], device=i.device)[:, None] * width + i).flatten()
        element *= table[0, 0].numel()
    else:  # gather_cols
        elems = (torch.arange(table.shape[0], device=i.device)[:, None] * width
                 + torch.unique(i)).flatten()
    per_sector = SECTOR_BYTES // element
    sectors = torch.unique(torch.div(elems, per_sector, rounding_mode="floor")).numel()
    return sectors * SECTOR_BYTES + sum(x.numel() * x.element_size() for x in (idx, out))


def run_case(case: dict, dev: torch.device, reps: int = 200) -> dict:
    """One variant (a dict as ``make_cases`` makes them) on ``dev``: the row
    that ``run`` returns for it. Raises on a mismatch with the plain version."""
    kernel, plain, library = _KERNELS[case["kernel"]]
    # the first k columns of a selection case's whole sort, rows strided
    cols = (lambda i: i[:, :case["k"]]) if "k" in case else (lambda i: i)
    table = torch.from_numpy(case["table"]).to(dev)
    whole_idx = torch.from_numpy(case["idx"]).to(dev)
    idx = cols(whole_idx)
    out = kernel(table, idx)
    want = plain(table, idx)
    if out.shape != want.shape or out.dtype != want.dtype or not torch.equal(out, want):
        raise AssertionError(f"{case['variant']}: {case['kernel']} differs from its plain version")
    nbytes = gather_bytes(case["kernel"], table, idx, out)
    row = {
        "variant": case["variant"], "kernel": case["kernel"],
        "replaces": case["replaces"], "table": list(table.shape),
        "dtype": str(table.dtype).replace("torch.", ""),
        "idx": list(idx.shape), "idx_dtype": str(idx.dtype).replace("torch.", ""),
        # equal bit for bit (checked above), so no element differs
        "exact": True, "max_abs_err": 0.0,
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
        cold = [(table.clone(), cols(whole_idx.clone())) for _ in range(copies)]
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


def _launch_parts(dev, table, sel):
    """The parts of a ``gather_lanes`` launch on the card, each as a
    callable, for ``host_cost``: the output allocation, the current stream,
    the pointers, and the kernel module's entry with the wrapper's
    arguments, once refused at once (no rows: the call alone) and once
    launching the kernel."""
    out = gt.gather_lanes(table, sel)
    fn = gt._kernels().gather_lanes
    index = dev.index or 0
    ptrs = (table.data_ptr(), sel.data_ptr(), out.data_ptr())
    return {
        "new_empty": lambda: table.new_empty((1, 1)),
        "empty_like": lambda: torch.empty_like(sel, dtype=table.dtype),
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
        "data_ptrs": lambda: (table.data_ptr(), sel.data_ptr(), out.data_ptr()),
        "call_refused": lambda: fn(*ptrs, 0, 4, 1, 1, 4, 0),
        "call_launch": lambda: fn(*ptrs, 1, 4, 1, 1, 4, torch._C._cuda_getCurrentRawStream(index)),
    }


def host_cost(device=None, reps: int = 10000, parts: bool = False) -> dict:
    """Host microseconds per call of each whole gather wrapper call and of
    the library calls beside them (``torch.gather(1)``, ``index_select``),
    over ``reps`` calls on the card, at a one-row shape (so the device keeps
    up). With ``parts``, also the parts of a ``gather_lanes`` launch
    (``_launch_parts``)."""
    import time

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("host_cost measures launches on the card")
    table = torch.zeros((4, 4), device=dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    sel = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    sel64 = sel.long()
    calls = {
        "gather_rows": lambda: gt.gather_rows(table, idx),
        "gather_lanes": lambda: gt.gather_lanes(table, sel),
        "gather_cols": lambda: gt.gather_cols(table, idx),
        "torch_gather": lambda: torch.gather(table, 1, sel64),
        "index_select": lambda: table.index_select(0, idx),
    }
    if parts:
        calls = {**_launch_parts(dev, table, sel), **calls}
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
    """Run the six variants (and with ``main_path`` the hash-mirror,
    mapper, selection, filter, BA and mesh-chunk shapes) on ``device`` (None: the card). Returns
    one row per variant; raises on any mismatch with the plain version."""
    dev = resolve_device(device)
    extra = (mirror_cases(shrink) + mapper_cases(shrink) + selection_cases(shrink)
             + dynba_cases(shrink) + mesh_cases(shrink) if main_path else [])
    cases = make_cases(shrink) + extra
    return [run_case(case, dev, reps) for case in cases]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' runs the plain versions; default: the card")
    ap.add_argument("--shrink", type=int, default=1, help="divide every row count by this")
    ap.add_argument("--main-path", action="store_true",
                    help="add the main path's shapes: the hash mirrors, the mapper's slab, "
                    "the kNN selection, the dynamic filter's and BA's, a mesh chunk's")
    ap.add_argument("--host-cost", action="store_true",
                    help="also time each part of a launch's host path (card only)")
    args = ap.parse_args(argv)
    for row in run(args.device, args.shrink, main_path=args.main_path):
        print(json.dumps(row), flush=True)
    if args.host_cost:
        print(json.dumps(host_cost(args.device, parts=True)), flush=True)


if __name__ == "__main__":
    main()
