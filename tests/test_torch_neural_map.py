"""Neural-map parity. insert_points: integer state bit-exact, positions and
mirror exact, including hash collisions between staged voxels and the
65,536-row pre-probe compaction. Queries: indices exact, weights and
features atol 1e-6. The duplicate-index scatter rule is pinned against
XLA's CPU scatter. prune_and_rehash (local and global): every field bit for
bit, moved floats included, also with several live points per hash bucket.
adjust_map: positions and quaternions atol 1e-5, the rebuilt hash exact
where the moved positions agree bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import neural_map_from_numpy
from clid_slam_torch.models import neural_map as tnm
from clid_slam_torch.ops.scatter import compact_indices, scatter_set
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.ops.voxel import neighbor_offsets
from torch_parity import n, t

RES = 0.3


def _assert_map_equal(tstate, jstate):
    for f, a in zip(
        ("positions", "quats", "geo_feats", "color_feats", "certainty",
         "ts_create", "ts_update", "count", "hash_table", "hash_mirror"),
        jstate,
    ):
        np.testing.assert_array_equal(n(getattr(tstate, f)), np.asarray(a), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_duplicate_scatter_last_wins_matches_xla(seed):
    rng = np.random.default_rng(seed)
    dst = rng.normal(size=(37, 4)).astype(np.float32)
    # duplicates and out-of-range sentinels past the end (the port, like
    # the JAX package, never scatters through negative indices)
    idx = rng.integers(0, 45, 300).astype(np.int32)
    src = rng.normal(size=(300, 4)).astype(np.float32)
    want = np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(src), mode="drop"))
    got = n(scatter_set(t(dst), t(idx).long(), t(src)))
    np.testing.assert_array_equal(got, want)
    valid = rng.uniform(size=300) < 0.5
    want = np.asarray(
        jnp.asarray(dst).at[jnp.where(jnp.asarray(valid), jnp.asarray(idx), 99)].set(
            jnp.asarray(src), mode="drop"
        )
    )
    got = n(scatter_set(t(dst), t(idx).long(), t(src), t(valid)))
    np.testing.assert_array_equal(got, want)


def test_compact_indices_matches_nonzero():
    mask = np.random.default_rng(3).uniform(size=500) < 0.3
    for size in (10, 150, 600):
        (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=0)
        np.testing.assert_array_equal(n(compact_indices(t(mask), size)), np.asarray(want))


def _insert_both(pts, mask, cap, hsize, frames, downsample=True):
    """Insert the same point batches frame by frame into both maps."""
    td = np.linspace(0.0, 3.0, 8).astype(np.float32)
    js = jnm.init_map(cap, hsize, 8)
    ts = tnm.init_map(cap, hsize, 8, device="cpu")
    dropped = []
    for f, (p, m) in enumerate(zip(pts, mask)):
        js, jr = jnm.insert_points(
            js, jnp.asarray(p), jnp.asarray(m), RES, jnp.asarray(td), f, 1.0,
            downsample=downsample,
        )
        ts, st = tnm.insert_points(ts, t(p), t(m), RES, t(td), f, 1.0, downsample=downsample)
        np.testing.assert_allclose(float(st.new_ratio), float(jr), rtol=1e-6)
        dropped.append(int(st.dropped))
    return ts, js, dropped


@pytest.mark.parametrize("hsize", [1 << 16, 1 << 9])
def test_insert_points_bit_exact(hsize):
    rng = np.random.default_rng(4)
    pts = [rng.normal(0, 2.0 + f, (3000, 3)).astype(np.float32) for f in range(3)]
    mask = [rng.uniform(size=3000) < 0.9 for _ in range(3)]
    ts, js, dropped = _insert_both(pts, mask, 1 << 12, hsize, 3)
    _assert_map_equal(ts, js)
    assert int(ts.count) > 100 and dropped == [0, 0, 0]
    if hsize == 1 << 9:  # many staged voxels share a bucket
        assert int((n(ts.hash_table) >= 0).sum()) < int(ts.count)


def test_insert_compaction_drops_and_counts():
    # 70,000 distinct voxels > the 65,536-row pre-probe compaction
    rng = np.random.default_rng(5)
    g = rng.permutation(60**3)[:70000]
    cells = np.stack([g // 3600, (g // 60) % 60, g % 60], 1).astype(np.float32)
    pts = ((cells + 0.5) * RES).astype(np.float32)
    mask = np.ones(70000, bool)
    ts, js, dropped = _insert_both([pts], [mask], 1 << 17, 1 << 18, 1, downsample=False)
    _assert_map_equal(ts, js)
    assert dropped == [70000 - 65536]


def test_mirror_gathers_go_through_gather_rows_and_stay_exact(monkeypatch):
    """insert_points (past the 65,536-row compaction) and
    neighborhood_probe read the hash mirror through ``gather_rows`` (the
    kernel on the card, its plain version here) and stay bit for bit with
    JAX: the whole map after the insert, the probe's mirror rows."""
    calls = []
    real = tnm.gather_rows_nd
    monkeypatch.setattr(tnm, "gather_rows_nd",
                        lambda table, idx: calls.append((table.shape, idx.shape)) or real(table, idx))
    rng = np.random.default_rng(8)
    g = rng.permutation(60**3)[:70000]
    cells = np.stack([g // 3600, (g // 60) % 60, g % 60], 1).astype(np.float32)
    pts = ((cells + 0.5) * RES).astype(np.float32)
    ts, js, dropped = _insert_both([pts], [np.ones(70000, bool)], 1 << 17, 1 << 18, 1,
                                   downsample=False)
    _assert_map_equal(ts, js)
    assert calls == [((1 << 18, 4), (65536,))]
    nb = neighbor_offsets(2, 0.5)
    q = pts[:2000] + rng.normal(0, 0.2, (2000, 3)).astype(np.float32)
    _, hj, _, mj = jnm.neighborhood_probe(js, jnp.asarray(q), nb, RES, 1.0)
    _, ht, _, mt = tnm.neighborhood_probe(ts, t(q), t(nb), RES, 1.0)
    assert calls[1] == ((1 << 18, 4), (2000, 81))
    np.testing.assert_array_equal(n(ht), np.asarray(hj))
    np.testing.assert_array_equal(n(mt), np.asarray(mj))


def _built_map(rng):
    """A map with random features and certainties, as both sides' states."""
    pts = rng.normal(0, 2.0, (4000, 3)).astype(np.float32)
    td = jnp.zeros((8,), jnp.float32)
    js = jnm.init_map(1 << 13, 1 << 15, 8)
    js, _ = jnm.insert_points(js, jnp.asarray(pts), jnp.ones(4000, bool), RES, td, 0, 1e9)
    c = int(js.count)
    js = js._replace(
        geo_feats=js.geo_feats.at[:c].set(jnp.asarray(rng.normal(0, 0.1, (c, 8)).astype(np.float32))),
        certainty=js.certainty.at[:c].set(jnp.asarray(rng.uniform(0, 3, c).astype(np.float32))),
    )
    return js, neural_map_from_numpy([np.asarray(x) for x in js], device="cpu"), td


@pytest.mark.parametrize("layer_norm", [False, True])
def test_query_feature_matches_jax(layer_norm):
    rng = np.random.default_rng(6)
    js, ts, td = _built_map(rng)
    nb = neighbor_offsets(2, 0.5)
    mvd2 = 3.0 * (3 * RES) ** 2
    q = rng.normal(0, 2.0, (1500, 3)).astype(np.float32)
    jr = jnm.query_feature(js, jnp.asarray(q), nb, RES, mvd2, 6, td, 0, 1e9, True,
                           layer_norm=layer_norm)
    tr = tnm.query_feature(ts, t(q), t(nb), RES, mvd2, 6, t(td), 0, 1e9, True,
                           layer_norm=layer_norm)
    np.testing.assert_array_equal(n(tr.knn_idx), np.asarray(jr.knn_idx))
    np.testing.assert_array_equal(n(tr.nn_count), np.asarray(jr.nn_count))
    np.testing.assert_allclose(n(tr.weights), np.asarray(jr.weights), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(tr.feature), np.asarray(jr.feature), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(tr.certainty), np.asarray(jr.certainty), atol=1e-5, rtol=0)
    assert (n(tr.knn_idx) >= 0).sum() > 1000

    d2j, hj, vj, mj = jnm.neighborhood_probe(js, jnp.asarray(q), nb, RES, mvd2)
    d2t, ht, vt, mt = tnm.neighborhood_probe(ts, t(q), t(nb), RES, mvd2)
    np.testing.assert_array_equal(n(ht), np.asarray(hj))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    np.testing.assert_allclose(n(d2t), np.asarray(d2j), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("weighted_first", [True, False], ids=["weighted_first", "per_neighbour"])
def test_decode_then_weight_and_color_query_match_jax(weighted_first):
    """query_feature(weighted_first=False) gives the per-neighbour [N, k,
    F+P] features and the IDW weights (atol 1e-6), and query_color_feature
    reads the color slab on the geometric query's neighbours in both
    modes; the weighted sum of the per-neighbour features is the
    weighted-first feature."""
    rng = np.random.default_rng(8)
    js, _, td = _built_map(rng)
    c = int(js.count)
    cf = np.zeros((js.positions.shape[0], 5), np.float32)
    cf[:c] = rng.uniform(0, 1, (c, 5))
    js = js._replace(color_feats=jnp.asarray(cf))
    ts = neural_map_from_numpy([np.asarray(x) for x in js], device="cpu")
    nb = neighbor_offsets(2, 0.5)
    mvd2 = 3.0 * (3 * RES) ** 2
    q = rng.normal(0, 2.0, (1500, 3)).astype(np.float32)
    kw = dict(weighted_first=weighted_first)
    jr = jnm.query_feature(js, jnp.asarray(q), nb, RES, mvd2, 6, td, 0, 1e9, True, **kw)
    tr = tnm.query_feature(ts, t(q), t(nb), RES, mvd2, 6, t(td), 0, 1e9, True, **kw)
    assert tuple(tr.feature.shape) == ((1500, 11) if weighted_first else (1500, 6, 11))
    np.testing.assert_array_equal(n(tr.knn_idx), np.asarray(jr.knn_idx))
    np.testing.assert_allclose(n(tr.weights), np.asarray(jr.weights), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(tr.feature), np.asarray(jr.feature), atol=1e-6, rtol=0)
    jc = jnm.query_color_feature(js, jr, 8)
    tc = tnm.query_color_feature(ts, tr, 8)
    assert tuple(tc.shape) == jc.shape == (tr.feature.shape[:-1] + (5 + 3,))
    np.testing.assert_allclose(n(tc), np.asarray(jc), atol=1e-6, rtol=0)
    if not weighted_first:
        tw = tnm.query_feature(ts, t(q), t(nb), RES, mvd2, 6, t(td), 0, 1e9, True)
        np.testing.assert_allclose(
            n(torch.sum(tr.feature * tr.weights[..., None], dim=1)), n(tw.feature), atol=1e-6
        )
    assert (n(tr.knn_idx) >= 0).sum() > 1000


def test_color_query_backward_sums_through_gather_rows_nd():
    """The color slab's gradient is the fixed-order sum of its rows'
    references, as JAX's autodiff of the same query gives it."""
    import jax

    rng = np.random.default_rng(9)
    js, _, td = _built_map(rng)
    js = js._replace(color_feats=jnp.asarray(rng.uniform(0, 1, (js.positions.shape[0], 4)).astype(np.float32)))
    ts = neural_map_from_numpy([np.asarray(x) for x in js], device="cpu")
    nb = neighbor_offsets(2, 0.5)
    mvd2 = 3.0 * (3 * RES) ** 2
    q = rng.normal(0, 2.0, (800, 3)).astype(np.float32)
    cot = rng.normal(size=(800, 7)).astype(np.float32)
    jq = jnm.query_feature(js, jnp.asarray(q), nb, RES, mvd2, 6, td, 0, 1e9, True)
    want = jax.grad(lambda c: jnp.sum(jnm.query_color_feature(js._replace(color_feats=c), jq, 8)
                                      * cot))(js.color_feats)
    cfeat = ts.color_feats.clone().requires_grad_(True)
    tq = tnm.query_feature(ts, t(q), t(nb), RES, mvd2, 6, t(td), 0, 1e9, True)
    out = tnm.query_color_feature(tnm.NeuralMapState(**{**ts.__dict__, "color_feats": cfeat}), tq, 8)
    (got,) = torch.autograd.grad(torch.sum(out * t(cot)), cfeat)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert (np.abs(n(got)).sum(1) > 0).sum() > 500


def test_certainty_ops_match_jax():
    rng = np.random.default_rng(7)
    js, ts, td = _built_map(rng)
    q = rng.normal(0, 2.0, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tnm.query_certainty_own_cell(ts, t(q), RES)),
        np.asarray(jnm.query_certainty_own_cell(js, jnp.asarray(q), RES)),
    )
    mvd2 = 3.0 * (2.0 * RES) ** 2
    np.testing.assert_array_equal(
        n(tnm.query_certainty_max(ts, t(q), RES, mvd2)),
        np.asarray(jnm.query_certainty_max(js, jnp.asarray(q), RES, mvd2)),
    )
    c = int(js.count)
    idx = rng.integers(-1, c, (800, 6)).astype(np.int32)
    w = rng.uniform(0, 1, (800, 6)).astype(np.float32)
    qts = rng.integers(0, 9, 800).astype(np.int32)
    jst = jnm.accumulate_certainty(js, jnp.asarray(idx), jnp.asarray(w), jnp.asarray(qts))
    tst = tnm.accumulate_certainty(ts, t(idx).long(), t(w), t(qts))
    np.testing.assert_allclose(n(tst.certainty), np.asarray(jst.certainty), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(n(tst.ts_update), np.asarray(jst.ts_update))
    assert torch.equal(tst.ts_create, ts.ts_create)


def _aged_map(hsize):
    """Three frames of inserts with growing travel distance, then random
    certainties and update stamps, as both sides' states."""
    rng = np.random.default_rng(8)
    pts = [rng.normal(0, 2.0 + f, (3000, 3)).astype(np.float32) for f in range(3)]
    mask = [np.ones(3000, bool)] * 3
    _, js, _ = _insert_both(pts, mask, 1 << 13, hsize, 3)
    c = int(js.count)
    js = js._replace(
        geo_feats=js.geo_feats.at[:c].set(jnp.asarray(rng.normal(0, 0.1, (c, 8)).astype(np.float32))),
        certainty=js.certainty.at[:c].set(jnp.asarray(rng.uniform(0, 6, c).astype(np.float32))),
        ts_update=js.ts_update.at[:c].set(jnp.asarray(rng.integers(0, 8, c).astype(np.int32))),
        quats=js.quats.at[:c].set(jnp.asarray(rng.normal(size=(c, 4)).astype(np.float32))),
    )
    td = np.linspace(0.0, 3.0, 8).astype(np.float32)
    leaves = [np.array(x) for x in js]  # copies: the JAX prune donates its input
    return js, neural_map_from_numpy(leaves, device="cpu"), td, c


@pytest.mark.parametrize("global_prune", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("hsize", [1 << 15, 1 << 9], ids=["sparse_hash", "shared_buckets"])
def test_prune_and_rehash_bit_exact(hsize, global_prune):
    js, ts, td, c = _aged_map(hsize)
    tout = tnm.prune_and_rehash(ts, 3.0, t(td), 7, 1.0, RES, global_prune=global_prune)
    jout = jnm.prune_and_rehash(js, 3.0, jnp.asarray(td), 7, 1.0, RES, global_prune=global_prune)
    _assert_map_equal(tout, jout)
    kept = int(tout.count)
    assert 0.2 * c < kept < 0.9 * c
    # freed rows satisfy the insert invariant
    assert torch.all(tout.quats[kept:, 0] == 1) and not tout.quats[kept:, 1:].any()
    assert not tout.geo_feats[kept:].any() and not tout.certainty[kept:].any()
    if hsize == 1 << 9:  # several live points per bucket: the last one wins
        assert int((n(tout.hash_table) >= 0).sum()) < kept
    # the pruned map takes inserts as a fresh one does
    p = np.random.default_rng(9).normal(0, 6.0, (2000, 3)).astype(np.float32)
    t2, _ = tnm.insert_points(tout, t(p), torch.ones(2000, dtype=torch.bool), RES, t(td), 7, 1.0)
    j2, _ = jnm.insert_points(jout, jnp.asarray(p), jnp.ones(2000, bool), RES, jnp.asarray(td), 7, 1.0)
    _assert_map_equal(t2, j2)
    assert int(t2.count) > kept


@pytest.mark.parametrize("use_mid_ts", [True, False])
def test_adjust_map_matches_jax(use_mid_ts):
    from clid_slam_tpu.utils import lie as jlie

    js, ts, td, c = _aged_map(1 << 15)
    rng = np.random.default_rng(10)
    tau = rng.normal(0, 0.05, (8, 6)).astype(np.float32)
    pose_diff = np.asarray(jlie.se3_exp(jnp.asarray(tau)))
    jout = jnm.adjust_map(js, jnp.asarray(pose_diff), jnp.asarray(td), RES, use_mid_ts)
    tout = tnm.adjust_map(ts, t(pose_diff), t(td), RES, use_mid_ts)
    np.testing.assert_allclose(n(tout.positions), np.asarray(jout.positions), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tout.quats), np.asarray(jout.quats), atol=1e-5, rtol=0)
    assert np.abs(n(tout.positions[:c]) - n(ts.positions[:c])).max() > 0.05
    if np.array_equal(n(tout.positions), np.asarray(jout.positions)):
        np.testing.assert_array_equal(n(tout.hash_table), np.asarray(jout.hash_table))
        np.testing.assert_array_equal(n(tout.hash_mirror), np.asarray(jout.hash_mirror))
    else:  # a position one ulp apart may sit in the neighbouring voxel
        assert (n(tout.hash_table) == np.asarray(jout.hash_table)).mean() > 0.999
    for f in ("geo_feats", "certainty", "ts_create", "ts_update", "count"):
        np.testing.assert_array_equal(n(getattr(tout, f)), np.asarray(getattr(jout, f)), err_msg=f)
