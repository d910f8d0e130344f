"""``ops/scatter.py:scatter_set`` against the winner-table version it
replaced (below: a table the size of the target filled with -1, the
winners resolved by ``scatter_reduce_`` "amax", skipped rows rewriting slot
0), bit for bit: random indices with duplicates, out-of-range indices,
masks that keep all, some or none of the rows, rows of one and of several
columns, a broadcast source, int32 indices, and a source that is the
target itself (the local map's compaction in place). The last-wins cases
against XLA are ``tests/test_torch_neural_map.py``'s."""

import numpy as np
import pytest
import torch

from clid_slam_torch.ops.scatter import scatter_set


def scatter_set_winner_table(dst, idx, src, valid=None):
    n, m = dst.shape[0], idx.shape[0]
    idx = idx.to(torch.int64)
    inb = (idx >= 0) & (idx < n)
    if valid is not None:
        inb = inb & valid
    tgt = torch.where(inb, idx, torch.zeros_like(idx))
    pos = torch.arange(m, device=idx.device)
    win = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    win.scatter_reduce_(
        0, tgt, torch.where(inb, pos, torch.full_like(pos, -1)), "amax", include_self=True,
    )
    src = src.to(dst.dtype).expand((m,) + dst.shape[1:])
    w0 = win[0]
    final0 = torch.where(w0 >= 0, src[w0.clamp(min=0)], dst[0])
    rows = src[win[tgt].clamp(min=0)]
    keep = inb.reshape((m,) + (1,) * (dst.dim() - 1))
    vals = torch.where(keep, rows, final0)
    dst.index_put_((tgt,), vals)
    return dst


CASES = {
    # name: (rows n, updates m, index range, share of rows kept or None, columns)
    "random": (64, 200, (0, 64), None, 3),
    "duplicates": (8, 300, (0, 8), None, 1),
    "out_of_range": (32, 100, (-40, 72), None, 4),
    "some_masked": (50, 120, (0, 50), 0.5, 2),
    "all_masked": (20, 60, (0, 20), 0.0, 3),
    "none_masked": (40, 90, (-5, 45), 1.0, 0),
    "slot_zero_only": (16, 50, (0, 1), 0.3, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_set_equals_the_winner_table_version(case, seed):
    n, m, (lo, hi), keep, cols = CASES[case]
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if cols == 0 else (n, cols)
    dst = torch.randn(shape, generator=g)
    idx = torch.randint(lo, hi, (m,), generator=g)
    src = torch.randn((m,) + shape[1:], generator=g)
    valid = None if keep is None else torch.rand(m, generator=g) < keep
    want = scatter_set_winner_table(dst.clone(), idx, src, valid)
    got = scatter_set(dst.clone(), idx, src, valid)
    assert torch.equal(got, want)


def test_scatter_set_takes_a_broadcast_source_and_int32_indices():
    g = torch.Generator().manual_seed(3)
    dst = torch.zeros(30, dtype=torch.int32)
    idx = torch.randint(-3, 33, (80,), generator=g, dtype=torch.int32)
    valid = torch.rand(80, generator=g) < 0.6
    ts = torch.tensor(7, dtype=torch.int32)  # a frame stamp, broadcast to every row
    want = scatter_set_winner_table(dst.clone(), idx, ts, valid)
    assert torch.equal(scatter_set(dst.clone(), idx, ts, valid), want)
    assert int((want == 7).sum()) > 0


def test_scatter_set_compacts_a_table_onto_itself():
    # a kept row moves down only: the rows are read before any is written
    rng = np.random.default_rng(4)
    pos = torch.tensor(rng.normal(size=(200, 3)), dtype=torch.float32)
    keep = torch.tensor(rng.uniform(size=200) < 0.4)
    new_idx = torch.cumsum(keep.to(torch.int64), 0) - 1
    want = scatter_set_winner_table(torch.zeros_like(pos), new_idx, pos, keep)
    got = scatter_set(pos.clone(), new_idx, pos.clone(), keep)
    n = int(keep.sum())
    assert torch.equal(got[:n], want[:n])
    inplace = pos.clone()
    scatter_set(inplace, new_idx, inplace, keep)
    assert torch.equal(inplace[:n], want[:n]) and torch.equal(inplace[n:], pos[n:])


def test_scatter_set_with_no_updates_leaves_the_target():
    dst = torch.arange(5.0)
    assert torch.equal(scatter_set(dst, torch.zeros(0, dtype=torch.int64), dst[:0]),
                       torch.arange(5.0))
