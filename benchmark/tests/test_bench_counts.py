"""The yardstick's counts at the bench shapes, against the figures that
the kernel table of PERF.md gives for them."""

import numpy as np
import torch

from harness import counts

PEAK = counts.peaks("NVIDIA H100 80GB HBM3")
# the bench shapes of K1: bs 16384, K 6, F 8, P 3, one 64-wide hidden
# layer, 1638 taps, 10 steps
BENCH = dict(bs=16384, K=6, F=8, P=3)


def test_k1_counts_at_the_bench_shapes():
    flops = counts.k1_flops(1, 10, 64, 1638, **BENCH)
    nbytes = counts.k1_bytes(1, 64, 1638, **BENCH)
    assert round(flops / 1e9, 3) == 1.236  # GFLOP
    assert round(nbytes / 1e6, 2) == 7.38  # MB
    bound_us = counts.bound_s(flops, nbytes, PEAK) * 1e6
    assert round(bound_us, 1) == 18.5  # operations bound


def test_k1_steps_scale_the_operations_only():
    one = counts.k1_flops(1, 1, 64, 1638, **BENCH)
    assert counts.k1_flops(1, 20, 64, 1638, **BENCH) == 20 * one


def test_gather_rows_bytes_at_k2():
    # K2: [32768, 4] f32 rows <- 131072 int32 indices that touch every row
    table = torch.zeros((32768, 4))
    idx = torch.from_numpy(np.random.default_rng(0).permutation(131072) % 32768).int()
    out = torch.zeros((131072, 4))
    nbytes = counts.gather_bytes("gather_rows", table, idx, out)
    assert nbytes == 32768 * 16 + 131072 * 4 + 131072 * 16
    assert round(counts.bound_s(0, nbytes, PEAK) * 1e6, 2) == 0.94


def test_gather_lanes_counts_the_sectors_the_picks_touch():
    src = torch.zeros((4, 81))  # f32 lanes, 8 to a sector
    sel = torch.tensor([[0, 1], [0, 8], [80, 79], [40, 41]])
    out = torch.zeros((4, 2))
    # sectors: row 0 one, row 1 two, row 2 one (lanes 79, 80 share one), row 3 one
    sectors = 1 + 2 + 1 + 1
    row = lambda r, lane: (r * 81 + lane) // 8
    touched = {row(r, int(l)) for r in range(4) for l in sel[r]}
    assert len(touched) == sectors
    assert counts.gather_bytes("gather_lanes", src, sel, out) == (
        sectors * 32 + sel.numel() * 8 + out.numel() * 4)
