"""The gather kernels' plain versions against jnp indexing (exact: a gather
copies bits), the wrappers' dispatch and argument checks on CPU tensors, the
probe entry point on the CPU at cut shapes, and the kNN selection's call
sites, routed through ``gather_lanes``, against the ``torch.gather`` calls
they replaced.

The Pallas probes themselves are defined inside the scripts' ``main()`` with
TPU-only VMEM block specs, so the comparison is with the references those
scripts validate against: ``table[idx]`` and ``take_along_axis``."""

import json

import numpy as np
import jax
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
@pytest.mark.parametrize("cells", [81, 7])
def test_gather_rows_at_a_mirror_shape_matches_jax(cells, idx_type):
    """A hash mirror ([2^12, 4], empty buckets at the 1e9 sentinel) read at
    the neighbour-cell buckets of a point cloud, as the neural map's probe
    (81 cells) and the local map's labels (7 cells) read it: the port's
    buckets equal JAX's, and ``gather_rows`` on them equals JAX's
    ``mirror[h]`` bit for bit."""
    from clid_slam_tpu.ops.voxel import neighbor_hash_soa, neighbor_offsets, voxel_hash
    from clid_slam_torch.ops.voxel import neighbor_hash_soa as port_hash

    rng = np.random.default_rng(cells)
    rows, res = 1 << 12, 0.4
    pts = rng.normal(0, 3.0, (500, 3)).astype(np.float32)
    mirror = np.full((rows, 4), 1e9, np.float32)
    occupied = np.asarray(voxel_hash(jnp.floor(jnp.asarray(pts[:300]) / res).astype(jnp.int32), rows))
    mirror[occupied, :3], mirror[occupied, 3] = pts[:300], 1.5
    offs = neighbor_offsets(2, 0.5) if cells == 81 else neighbor_offsets(1, 0.2)
    assert offs.shape[0] == cells
    hj = neighbor_hash_soa(jnp.asarray(pts), jnp.asarray(offs), res, rows)
    want = np.asarray(jnp.asarray(mirror)[hj])
    ht = port_hash(t(pts), t(offs), res, rows)
    np.testing.assert_array_equal(n(ht), np.asarray(hj))
    got = gt.gather_rows_nd(t(mirror), ht.to(torch.int32 if idx_type == "i32" else torch.int64))
    np.testing.assert_array_equal(n(got), want)
    assert (want[..., 0] > 1e8).any() and (want[..., 0] < 1e8).any()


@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
def test_gather_lanes_matches_jnp(idx_type):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(300, 128)).astype(np.float32)
    sel = rng.integers(0, 128, (300, 40)).astype(IDX_TYPES[idx_type])
    want = np.asarray(jnp.take_along_axis(jnp.asarray(src), _jnp_idx(sel), axis=1))
    np.testing.assert_array_equal(n(gt.gather_lanes_reference(t(src), t(sel))), want)
    np.testing.assert_array_equal(n(gt.gather_lanes(t(src), t(sel))), want)


def _lane_source(kind, rng, rows, lanes):
    """A [rows, lanes] source of one of the selection's element kinds:
    bool, f32, int64 (full 64-bit values) or [rows, lanes, 4] f32 (16-byte
    lanes)."""
    if kind == "bool":
        return rng.uniform(size=(rows, lanes)) < 0.5
    if kind == "f32":
        return rng.normal(size=(rows, lanes)).astype(np.float32)
    if kind == "i64":
        return rng.integers(-(1 << 62), 1 << 62, (rows, lanes), dtype=np.int64)
    return rng.normal(size=(rows, lanes, 4)).astype(np.float32)


def _jnp_lanes(src, sel):
    """``take_along_axis`` on the lane axis in JAX (which holds no int64
    without x64: 64-bit lanes go as two int32 halves, a 16-byte lane as its
    four floats), back as numpy of the source's type."""
    sj = _jnp_idx(sel)
    if src.dtype == np.int64:
        halves = jnp.asarray(src.view(np.int32).reshape(src.shape + (2,)))
        got = jnp.take_along_axis(halves, sj[..., None], axis=1)
        return np.ascontiguousarray(np.asarray(got)).view(np.int64)[..., 0]
    if src.ndim == 3:
        return np.asarray(jnp.take_along_axis(jnp.asarray(src), sj[..., None], axis=1))
    return np.asarray(jnp.take_along_axis(jnp.asarray(src), sj, axis=1))


@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("k", [6, 16])
@pytest.mark.parametrize("kind", ["bool", "f32", "i64", "f32x4"])
def test_gather_lanes_at_each_width_matches_jnp(kind, k, idx_type):
    """The selection's shape cut to 64 points (K 6 and 16 of 81 lanes) at
    each lane width the kernel copies (1, 4, 8 and 16 bytes): the wrapper
    equals JAX's take_along_axis bit for bit, and the selection's own
    selectors (the first K columns of a sort: rows strided by 81) give the
    same as contiguous ones."""
    rng = np.random.default_rng(k)
    src = _lane_source(kind, rng, 64, 81)
    order = torch.argsort(torch.from_numpy(rng.uniform(size=(64, 81))), dim=1, stable=True)
    sel = order[:, :k].to(IDX_TYPES[idx_type] == np.int64 and torch.int64 or torch.int32)
    want = _jnp_lanes(src, n(sel))
    got = gt.gather_lanes(t(src), sel)
    assert got.dtype == t(src).dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(gt.gather_lanes(t(src), sel.contiguous())), want)
    np.testing.assert_array_equal(n(gt.gather_lanes_reference(t(src), sel)), want)


def test_gather_lanes_rejects_a_misaligned_piece_table():
    """16-byte lanes must start on 16 bytes (the kernel moves them as one
    vector): a [N, L, 4] view one float into its storage is refused on any
    device, as are 8-byte lanes off their alignment."""
    base = torch.zeros(64 * 81 * 4 + 4)
    sel = torch.zeros((64, 6), dtype=torch.int64)
    with pytest.raises(ValueError, match="aligned"):
        gt.gather_lanes(base[1:1 + 64 * 81 * 4].view(64, 81, 4), sel)
    with pytest.raises(ValueError, match="aligned"):
        gt.gather_lanes(base[1:1 + 64 * 81 * 2].view(64, 81, 2), sel)
    assert gt.gather_lanes(base[4:4 + 64 * 81 * 4].view(64, 81, 4), sel).shape == (64, 6, 4)


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
        (gt.gather_lanes, torch.zeros(5, 8, dtype=torch.float16), torch.zeros(5, 2, dtype=torch.int64),
         TypeError),
        (gt.gather_lanes, torch.zeros(5, 8, 3), torch.zeros(5, 2, dtype=torch.int64), TypeError),
        (gt.gather_lanes, torch.zeros(5, 8), torch.zeros(5, 2, dtype=torch.int16), TypeError),
        (gt.gather_cols, torch.zeros(40), torch.zeros(3, dtype=torch.int32), ValueError),
    ],
    ids=["width_0", "f64_table", "float_idx", "idx_2d", "row_mismatch", "lanes_2_bytes",
         "lanes_12_bytes", "lanes_int16_selectors", "table_1d"],
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


def test_probe_main_path_shapes_on_cpu():
    """The probe's main-path variants, cut 64-fold: the hash-mirror tables
    hold the sentinel and occupied rows, their buckets come from 81 and 7
    cells (1 for the insert) of the same points, and every plain result,
    the mapper's slab gathers too, is exact."""
    cases = pg.mirror_cases(64)
    assert [c["variant"] for c in cases] == [
        "mirror mapper probe", "mirror tracker probe", "mirror local map", "mirror insert"]
    assert [c["table"].shape for c in cases] == [(65536, 4), (65536, 4), (32768, 4), (65536, 4)]
    assert [c["idx"].shape[0] for c in cases] == [256 * 81, 128 * 81, 2048 * 7, 1024]
    for c in cases:
        assert c["idx"].dtype == np.int64 and c["idx"].max() < c["table"].shape[0]
        hit = c["table"][c["idx"], 0] < 1e8
        assert 0 < hit.mean() < 1
    rows = pg.run("cpu", shrink=64, main_path=True)[6:]
    assert [r["variant"] for r in rows] == [
        c["variant"] for c in
        cases + pg.mapper_cases(64) + pg.selection_cases(64) + pg.dynba_cases(64)
        + pg.mesh_cases(64)]
    assert all(r["exact"] and "ms" not in r for r in rows)


def test_probe_selection_shapes_on_cpu():
    """The probe's selection variants, cut 64-fold: the mapper's K 6 and the
    tracker's 16 of 81 lanes at f32, int64, bool and 16-byte sources, with
    selectors that pick each row's smallest distances (valid lanes first,
    ties to the lower lane) as smallest_k does, and plain results equal to
    torch.gather's."""
    cases = pg.selection_cases(64)
    assert [c["variant"] for c in cases] == [
        f"select {w} {s}" for w in ("mapper", "tracker") for s in ("d2s", "h", "pvalid", "mir")]
    for c, (rows, k) in zip(cases, [(256, 6)] * 4 + [(128, 16)] * 4):
        assert c["idx"].shape == (rows, 81) and c["idx"].dtype == np.int64 and c["k"] == k
        assert c["table"].shape[:2] == (rows, 81)
    d2s, h, valid, mir = (cases[i]["table"] for i in range(4))
    assert (d2s.dtype, h.dtype, valid.dtype, mir.shape[2]) == (np.float32, np.int64, bool, 4)
    np.testing.assert_array_equal(cases[0]["idx"], np.argsort(d2s, axis=1, kind="stable"))
    sel = cases[0]["idx"][:, :6]
    picked = np.take_along_axis(valid, sel, 1)
    assert picked.mean() > valid.mean() and valid.mean() < 1
    for c in cases:
        src = torch.from_numpy(c["table"])
        idx = torch.from_numpy(c["idx"])[:, :c["k"]]  # strided, as smallest_k hands it over
        lib = pg._KERNELS["gather_lanes"][2]
        assert torch.equal(gt.gather_lanes(src, idx), lib(src, idx))
    rows = [pg.run_case(c, torch.device("cpu")) for c in cases[:1] + cases[4:5]]
    assert [r["idx"] for r in rows] == [[256, 6], [128, 16]]


def test_probe_filter_and_ba_shapes_on_cpu():
    """The probe's filter and BA variants, cut 64-fold: the window-pose
    gather's rows clamp to the window (about half on its first row), the
    filter's probe and selection cover the whole scan, and the feature
    rows are map rows of occupied buckets or the sentinel row, as
    query_feature makes them."""
    world, mirror = pg._frame(64)
    cases = {c["variant"]: c for c in pg.dynba_cases(64)}
    assert list(cases) == ["BA pose gather", "mirror filter probe"] + [
        f"select filter {s}" for s in ("d2s", "h", "pvalid", "mir")] + [
        "query feats BA", "query feats filter"]
    pose = cases["BA pose gather"]
    assert pose["table"].shape == (20, 16) and pose["idx"].shape == (256,)
    assert set(np.unique(pose["idx"])) == set(range(20)) and 0.4 < np.mean(pose["idx"] == 0) < 0.6
    assert cases["mirror filter probe"]["idx"].shape == (512 * 81,)
    assert cases["select filter d2s"]["table"].shape == (512, 81)
    assert all(cases[f"select filter {s}"]["k"] == 6 for s in ("d2s", "h", "pvalid", "mir"))
    n_map = np.sum(mirror[:, 3] == 0.0)  # occupied buckets: one map row each
    for who, count in (("BA", 256), ("filter", 512)):
        c = cases[f"query feats {who}"]
        cap = c["table"].shape[0] - 1
        assert cap == (1 << 18) // 64 and c["idx"].shape == (count * 6,)
        rows = c["idx"][c["idx"] != cap]
        assert rows.size > 0.9 * c["idx"].size and rows.max() < min(n_map, cap)
    rows = [pg.run_case(c, torch.device("cpu")) for c in cases.values()]
    assert all(r["exact"] for r in rows)


@pytest.mark.parametrize(
    "kernel, table, idx, table_bytes",
    [
        # rows 0 and 1 of 16 bytes share one 32-byte sector; row 7 has its own
        ("gather_rows", torch.zeros(100, 4), torch.tensor([0, 1, 1, 7]), 2 * 32),
        # two distinct rows of 48 bytes: rows 2 and 3 cover bytes 96-191 = sectors 3, 4, 5
        ("gather_rows", torch.zeros(100, 12), torch.tensor([2, 3, 3]), 3 * 32),
        # per source row the sectors of 8 floats that its picks fall into
        ("gather_lanes", torch.zeros(2, 16), torch.tensor([[0, 7, 1], [8, 8, 15]]), 2 * 32),
        # 16-byte lanes, two a sector: lanes 0 and 1 share one, 7 has its own
        ("gather_lanes", torch.zeros(1, 16, 4), torch.tensor([[0, 1, 7]]), 2 * 32),
        # bool lanes, 32 a sector, rows of 64 bytes: bytes 0, 127 and 131
        # (row 2, lane 3) in sectors 0, 3 and 4
        ("gather_lanes", torch.zeros(3, 64, dtype=torch.bool), torch.tensor([[0], [63], [3]]),
         3 * 32),
        # columns 0 and 9 of each of the 3 table rows: two sectors a row
        ("gather_cols", torch.zeros(3, 24), torch.tensor([9, 0, 9]), 6 * 32),
    ],
    ids=["rows_shared_sector", "rows_wide", "lanes", "lanes_16_bytes", "lanes_bool", "cols"],
)
def test_gather_bytes_counts_the_sectors_the_indices_touch(kernel, table, idx, table_bytes):
    out = getattr(gt, kernel + "_reference")(table, idx)
    got = pg.gather_bytes(kernel, table, idx, out)
    size = table.element_size()
    assert got == table_bytes + idx.numel() * 8 + out.numel() * size
    assert got < table.numel() * size + idx.numel() * 8 + out.numel() * size


def _parent_lanes(src, sel):
    """The selection's gathers as the port made them before ``gather_lanes``:
    ``torch.gather`` on the lane axis, the mirror rows' selector expanded
    over their 4 floats."""
    return torch.gather(src, 1, sel if src.dim() == 2 else sel[..., None].expand(-1, -1, 4))


def _mapper_selection():
    """The fast mapping body (one batch of 1024 on a box scene, JAX's batch
    draw) with every BatchCache that build_cache makes recorded."""
    import test_torch_mapper as tm
    from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy, pool_from_numpy
    from clid_slam_torch.mapping import mapper as tmp

    ms, pool, mlp, td = tm._scene()
    draws = [tm._draws(pool, jax.random.split(jax.random.PRNGKey(5))[1])]
    fn = tmp.make_mapping_fn(**dict(tm.MAP_KW, **tm.BODIES["fast"]))

    def run():
        caches = []
        real = tmp.BatchCache
        tmp.BatchCache = lambda **kw: caches.append(kw) or real(**kw)
        try:
            tmlp = mlp_from_numpy(jax.tree.map(np.asarray, mlp), "cpu")
            state, mlp2, _, _, losses = fn(
                neural_map_from_numpy([np.asarray(x) for x in ms], "cpu"), tmlp, tmlp, tmlp,
                pool_from_numpy([np.asarray(x) for x in pool], "cpu"), t(td), 1, 1e9, 7, 1.0,
                batch_draws=draws)
        finally:
            tmp.BatchCache = real
        assert len(caches) == 1
        return [v for c in caches for v in c.values()] + [state.geo_feats, losses, *mlp2.tensors()]

    return tmp, run


def _tracker_selection():
    """The cached IESEKF update on a sphere map (tests/test_torch_iekf.py's
    scene): candidates built once, then the iterated update."""
    import test_torch_iekf as ti
    from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy
    from clid_slam_torch.odometry import iekf as tie
    from clid_slam_tpu.ops.voxel import neighbor_offsets

    rng = np.random.default_rng(0)
    js, jmlp, td = ti._scene(rng)
    fn = tie.make_cached_update_fn(
        knn_k=6, n_cand=16, nb_offs=neighbor_offsets(2, 0.5), resolution=0.3,
        max_valid_dist2=3.0 * 0.9 ** 2, sdf_scale=0.055, min_grad_norm=0.0, max_grad_norm=100.0,
        min_nn_count=1, max_iteration=20, term_thre_deg=0.01, term_thre_m=0.001)
    u = rng.standard_normal((512, 3))
    pts = (3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    c, s = np.cos(0.01), np.sin(0.01)
    rest0 = np.zeros(12, np.float32)
    rest0[9:12] = [0, 0, -9.81]
    args = (neural_map_from_numpy([np.asarray(x) for x in js], "cpu"),
            mlp_from_numpy(jax.tree.map(np.asarray, jmlp), "cpu"), t(pts), torch.ones(512, dtype=torch.bool),
            t(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)),
            t(np.array([0.02, -0.01, 0.005], np.float32)), t(rest0),
            t((np.eye(18) * 1e-2).astype(np.float32)), t(td), 0, 1e9)
    return tie, lambda: list(fn(*args))


def _query_selection():
    """query_feature on a map of 4000 random points with layer norm."""
    import test_torch_neural_map as tn
    from clid_slam_torch.models import neural_map as tnm
    from clid_slam_tpu.ops.voxel import neighbor_offsets

    rng = np.random.default_rng(6)
    _, ts, td = tn._built_map(rng)
    q = t(rng.normal(0, 2.0, (1500, 3)).astype(np.float32))
    nb = t(neighbor_offsets(2, 0.5))
    return tnm, lambda: list(tnm.query_feature(ts, q, nb, 0.3, 3.0 * 0.9 ** 2, 6, t(td), 0, 1e9,
                                               True, layer_norm=True))


# the selection's sources in each site's order: distances, buckets, validity
# and mirror rows (the tracker reads no validity: its distances hold it)
SELECTED = {"mapper": ["float32", "int64", "bool", "float32"],
            "tracker": ["int64", "float32", "float32"],
            "query_feature": ["float32", "int64", "bool", "float32"]}


@pytest.mark.parametrize("site", sorted(SELECTED))
def test_selection_through_gather_lanes_equals_the_parents_gathers(site, monkeypatch):
    """build_cache (the mapper's batch), build_candidates (the tracker) and
    query_feature pick their kNN lanes through ``gather_lanes``, and every
    output equals, bit for bit, what the same call gives with the
    ``torch.gather`` calls it had before."""
    module, run = {"mapper": _mapper_selection, "tracker": _tracker_selection,
                   "query_feature": _query_selection}[site]()
    seen = []
    routed = module.gather_lanes
    monkeypatch.setattr(module, "gather_lanes",
                        lambda src, sel: seen.append(str(src.dtype)[6:]) or routed(src, sel))
    got = run()
    assert seen == SELECTED[site]
    monkeypatch.setattr(module, "gather_lanes", _parent_lanes)
    want = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), (a, b)


def test_probe_mesh_chunk_shapes_on_cpu():
    """The probe's mesh-chunk variants, cut 64-fold: the chunk's grid points
    probe the [2^22 / 64, 4] mirror at their 81 neighbour cells, the
    selection picks K 6 of 81 lanes from the four sources, and the feature
    rows are map rows or the sentinel row."""
    cases = {c["variant"]: c for c in pg.mesh_cases(64)}
    assert list(cases) == ["mirror mesh probe"] + [
        f"select mesh {s}" for s in ("d2s", "h", "pvalid", "mir")] + ["query feats mesh"]
    n_pts = 48**3 // 64
    assert cases["mirror mesh probe"]["table"].shape == ((1 << 22) // 64, 4)
    assert cases["mirror mesh probe"]["idx"].shape == (n_pts * 81,)
    assert cases["select mesh mir"]["table"].shape == (n_pts, 81, 4)
    assert all(cases[f"select mesh {s}"]["k"] == 6 for s in ("d2s", "h", "pvalid", "mir"))
    feats = cases["query feats mesh"]
    cap = feats["table"].shape[0] - 1
    assert cap == (1 << 18) // 64 and feats["idx"].shape == (n_pts * 6,)
    assert 0 < np.mean(feats["idx"] != cap)  # some grid points reach the map
    rows = [pg.run_case(c, torch.device("cpu")) for c in cases.values()]
    assert all(r["exact"] for r in rows)
