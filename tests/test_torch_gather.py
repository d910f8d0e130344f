"""The gather kernels' plain versions against jnp indexing (exact: a gather
copies bits), the wrappers' dispatch and argument checks on CPU tensors, and
the probe entry point on the CPU at cut shapes.

The Pallas probes themselves are defined inside the scripts' ``main()`` with
TPU-only VMEM block specs, so the comparison is with the references those
scripts validate against: ``table[idx]`` and ``take_along_axis``."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.ops import gather as gt
from clid_slam_torch.tools import probe_gather as pg
from torch_parity import n, t

IDX_TYPES = {"i32": np.int32, "i64": np.int64}


def _jnp_idx(idx):
    return jnp.asarray(idx.astype(np.int32))  # JAX runs without x64 here


@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("width", [4, 6, 8, 128])
def test_gather_rows_matches_jnp(width, idx_type):
    rng = np.random.default_rng(width)
    table = rng.normal(size=(700, width)).astype(np.float32)
    # sorted with duplicates, as the mapper's work-slab references are
    idx = np.sort(rng.integers(0, 700, 3000)).astype(IDX_TYPES[idx_type])
    want = np.asarray(jnp.asarray(table)[_jnp_idx(idx)])
    np.testing.assert_array_equal(n(gt.gather_rows_reference(t(table), t(idx))), want)
    before = dict(gt.launches)
    np.testing.assert_array_equal(n(gt.gather_rows(t(table), t(idx))), want)
    assert gt.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
def test_gather_lanes_matches_jnp(idx_type):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(300, 128)).astype(np.float32)
    sel = rng.integers(0, 128, (300, 40)).astype(IDX_TYPES[idx_type])
    want = np.asarray(jnp.take_along_axis(jnp.asarray(src), _jnp_idx(sel), axis=1))
    np.testing.assert_array_equal(n(gt.gather_lanes_reference(t(src), t(sel))), want)
    np.testing.assert_array_equal(n(gt.gather_lanes(t(src), t(sel))), want)


@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
def test_gather_cols_matches_jnp(idx_type):
    rng = np.random.default_rng(2)
    table_t = rng.normal(size=(8, 900)).astype(np.float32)
    idx = np.sort(rng.integers(0, 900, 2000)).astype(IDX_TYPES[idx_type])
    ib = jnp.broadcast_to(_jnp_idx(idx)[None, :], (8, 2000))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(table_t), ib, axis=1))
    np.testing.assert_array_equal(n(gt.gather_cols_reference(t(table_t), t(idx))), want)
    np.testing.assert_array_equal(n(gt.gather_cols(t(table_t), t(idx))), want)


@pytest.mark.parametrize(
    "fn, table, idx, error",
    [
        (gt.gather_rows, torch.zeros(5, 0), torch.zeros(3, dtype=torch.int64), ValueError),
        (gt.gather_rows, torch.zeros(5, 8, dtype=torch.float64), torch.zeros(3, dtype=torch.int64), TypeError),
        (gt.gather_rows, torch.zeros(5, 8), torch.zeros(3), TypeError),
        (gt.gather_rows, torch.zeros(5, 8), torch.zeros(3, 2, dtype=torch.int64), ValueError),
        (gt.gather_lanes, torch.zeros(5, 8), torch.zeros(4, 2, dtype=torch.int64), ValueError),
        (gt.gather_cols, torch.zeros(40), torch.zeros(3, dtype=torch.int32), ValueError),
    ],
    ids=["width_0", "f64_table", "float_idx", "idx_2d", "row_mismatch", "table_1d"],
)
def test_gather_rejects_what_the_kernels_cannot_take(fn, table, idx, error):
    with pytest.raises(error):
        fn(table, idx)


def test_probe_entry_point_on_cpu(capsys):
    rows = pg.run("cpu", shrink=64)
    assert [r["variant"][:2] for r in rows] == ["K2", "K3", "K4", "K5", "K6", "K7"]
    assert [r["table"] for r in rows] == [
        [512, 4], [256, 128], [256, 128], [1536, 8], [1536, 8], [8, 1536]
    ]
    for r in rows:
        assert r["exact"] and r["max_abs_err"] == 0.0 and r["device"] == "cpu"
        assert "ms" not in r and "library_ms" not in r  # no card time from a CPU run
    k5 = pg.make_cases(64)[3]
    assert np.all(np.diff(k5["idx"]) >= 0) and len(np.unique(k5["idx"])) < len(k5["idx"])
    pg.main(["--device", "cpu", "--shrink", "64"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["kernel"] for r in printed] == [r["kernel"] for r in rows]


@pytest.mark.parametrize(
    "kernel, table, idx, table_bytes",
    [
        # rows 0 and 1 of 16 bytes share one 32-byte sector; row 7 has its own
        ("gather_rows", torch.zeros(100, 4), torch.tensor([0, 1, 1, 7]), 2 * 32),
        # two distinct rows of 48 bytes: rows 2 and 3 cover bytes 96-191 = sectors 3, 4, 5
        ("gather_rows", torch.zeros(100, 12), torch.tensor([2, 3, 3]), 3 * 32),
        # per source row the sectors of 8 floats that its picks fall into
        ("gather_lanes", torch.zeros(2, 16), torch.tensor([[0, 7, 1], [8, 8, 15]]), 2 * 32),
        # columns 0 and 9 of each of the 3 table rows: two sectors a row
        ("gather_cols", torch.zeros(3, 24), torch.tensor([9, 0, 9]), 6 * 32),
    ],
    ids=["rows_shared_sector", "rows_wide", "lanes", "cols"],
)
def test_gather_bytes_counts_the_sectors_the_indices_touch(kernel, table, idx, table_bytes):
    out = getattr(gt, kernel + "_reference")(table, idx)
    got = pg.gather_bytes(kernel, table, idx, out)
    assert got == table_bytes + idx.numel() * 8 + out.numel() * 4
    assert got < table.numel() * 4 + idx.numel() * 8 + out.numel() * 4
