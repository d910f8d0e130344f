"""Parity of the sharded map's insert, query, certainty and tracker
(clid_slam_torch/parallel/spatial.py) on 2 and 4 spawned gloo ranks against
the JAX package's shard_map version on as many of the conftest's virtual
CPU devices, on the scenes of tests/test_spatial.py
(tests/torch_spatial_scenes.py). The mapping bodies are in
tests/test_torch_spatial_mapping.py.

Tolerances:
- ``shard_owner`` (negative coordinates included), each rank's slab and
  hash table after ``insert_fn`` and the new-point ratio, ``query_fn``'s
  neighbour counts and local winner rows, and the certainty: bit for bit;
- ``query_fn``'s features, weights and certainty: atol 1e-6 against JAX's,
  and the features atol 2e-4 against the port's single map holding the
  same points (test_spatial.py:125's);
- the tracker update: position and rotation atol 2e-3, iterations within
  3 (tests/test_torch_iekf.py's), and the same bits on every rank.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import sharded_map_from_numpy, sharded_map_to_numpy
from clid_slam_torch.models import neural_map as tnm
from clid_slam_torch.parallel import spatial as tsp
from clid_slam_tpu.odometry import iekf as jie
from clid_slam_tpu.parallel import spatial as jsp
from torch_dist import Ranks
from torch_parity import n, t
from torch_sharded_ranks import features_of
from torch_spatial_scenes import (CAP, F, HASH, KNN, KW, MVD2, NB, RES, TRACKER_KW, scenes,
                                  with_position_features)

FIELDS = ("positions", "quats", "geo_feats", "color_feats", "certainty", "ts_create",
          "ts_update", "count", "hash_table", "hash_mirror")


def _jax_side(S, inp, mlp):
    mesh = jsp.make_spatial_mesh(S)
    travel = jnp.zeros((8,), jnp.float32)
    insert_fn, query_fn, _ = jsp.make_spatial_fns(mesh, **KW)
    out = {}

    def insert(pts, mask):
        st = jsp.init_sharded_map(mesh, CAP, HASH, F)
        return insert_fn(st, jnp.asarray(pts), jnp.asarray(mask), travel, 0, 1e9)

    st, ratio = insert(inp["insert_pts"], np.ones(len(inp["insert_pts"]), bool))
    out["insert"] = ([np.asarray(a) for a in st], float(ratio))
    qst, _ = insert(inp["cluster_pts"], np.ones(len(inp["cluster_pts"]), bool))
    qst = with_position_features(qst, certainty=True)
    q = query_fn(qst, jnp.asarray(inp["query_pts"]), travel, 0, 1e9)
    out["query"] = {k: np.asarray(v) for k, v in q._asdict().items()}
    cert_fn = jsp.make_sharded_certainty_fn(mesh, resolution=RES, max_valid_dist2=MVD2)
    out["certainty"] = np.asarray(cert_fn(qst, jnp.asarray(inp["query_pts"])))

    sst, _ = insert(inp["sphere_pts"], inp["sphere_mask"])
    out["sphere_map"] = [np.asarray(a) for a in sst]
    update = jsp.make_sharded_tracker_fn(mesh, jie.make_cached_update_fn(**TRACKER_KW),
                                         nb_offs=NB, resolution=RES, max_valid_dist2=MVD2)
    res = update(with_position_features(sst), mlp,
                 *[jnp.asarray(a) for a in inp["tracker_args"]], travel, 0, 1e9)
    out["tracker"] = [np.asarray(r) for r in res]
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda s: f"S{s}")
def run(request, tmp_path_factory):
    """(S, inputs, JAX's results, the ranks' results): the ranks run while
    the JAX side computes."""
    S = request.param
    inp, _, mlp = scenes()
    ranks = Ranks("torch_sharded_ranks:spatial_query_case", S, inp,
                  tmp_path_factory.mktemp(f"spatial{S}"))
    try:
        jax_out = _jax_side(S, inp, mlp)
    except BaseException:
        ranks.kill()
        raise
    return S, inp, jax_out, ranks.join()


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_shard_owner_matches_jax_bit_for_bit(S):
    rng = np.random.default_rng(S)
    pts = rng.uniform(-50, 50, size=(20000, 3)).astype(np.float32)  # negative coords too
    want = np.asarray(jsp.shard_owner(jnp.asarray(pts), RES, S))
    got = n(tsp.shard_owner(t(pts), RES, S))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    counts = np.bincount(got, minlength=S)
    assert counts.min() > 0.8 * counts.mean()
    # the same voxel, the same owner (test_spatial.py:40)
    jit = pts + np.float32(RES * 0.01)
    same = (np.floor(pts / RES).astype(int) == np.floor(jit / RES).astype(int)).all(-1)
    assert (n(tsp.shard_owner(t(jit), RES, S))[same] == got[same]).all()


def test_insert_matches_jax_shard_by_shard(run):
    S, inp, jx, port = run
    leaves, ratio = jx["insert"]
    for r in range(S):
        got, got_ratio, total = port[r]["insert"]
        for name, a, b in zip(FIELDS, got, leaves):
            np.testing.assert_array_equal(a, b[r], err_msg=f"rank {r} {name}")
        assert got_ratio == ratio
        assert total == int(leaves[7].sum())
        # every live point sits on the rank that owns its voxel
        cnt = int(got[7])
        assert (n(tsp.shard_owner(t(got[0][:cnt]), RES, S)) == r).all()
    for r in range(S):  # the sphere scene's masked insert too
        for name, a, b in zip(FIELDS, port[r]["sphere_map"], jx["sphere_map"]):
            np.testing.assert_array_equal(a, b[r], err_msg=f"sphere rank {r} {name}")


def test_sharded_map_converts_to_and_from_jaxs_stacked_leaves(run):
    """``convert.sharded_map_from_numpy`` takes shard r of JAX's stacked
    state, ``sharded_map_to_numpy`` gives it back, dtypes included."""
    S, inp, jx, port = run
    leaves, _ = jx["insert"]
    for r in range(S):
        shard = sharded_map_from_numpy(leaves, r, "cpu")
        for name, a, b in zip(FIELDS, sharded_map_to_numpy(shard), leaves):
            np.testing.assert_array_equal(a, b[r], err_msg=name)
            assert a.dtype == b.dtype, name


def test_query_matches_jax(run):
    S, inp, jx, port = run
    want = jx["query"]
    for r in range(S):
        got = port[r]["query"]
        np.testing.assert_array_equal(got["nn_count"], want["nn_count"])
        np.testing.assert_array_equal(got["knn_idx"], want["knn_idx"][r])
        for k in ("feature", "weights", "certainty"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
            # replicated outputs: the same bits on every rank
            np.testing.assert_array_equal(got[k], port[0]["query"][k])
    # every weighted slot is claimed by exactly one rank
    claims = sum((port[r]["query"]["knn_idx"] >= 0).astype(int) for r in range(S))
    w = port[0]["query"]["weights"]
    assert (claims[w > 0] == 1).all()


def test_query_matches_the_ports_single_map(run):
    """The sharded query equals one unsharded map holding the same points
    (test_spatial.py:77): neighbour counts, and features at atol 2e-4."""
    S, inp, jx, port = run
    travel = torch.zeros(8)
    single = tnm.init_map(CAP, HASH, F)
    pts = t(inp["cluster_pts"])
    single, _ = tnm.insert_points(single, pts, torch.ones(len(pts), dtype=torch.bool), RES,
                                  travel, 0, 1e9)
    cnt = int(single.count)
    feats = n(single.geo_feats).copy()
    feats[:cnt] = features_of(n(single.positions)[:cnt], F)
    single = single._replace(geo_feats=t(feats))
    r1 = tnm.query_feature(single, t(inp["query_pts"]), t(NB), RES, MVD2, KNN)
    got = port[0]["query"]
    n_a, n_b = n(r1.nn_count), got["nn_count"]
    ok = (n_a == n_b) & (n_a > 0)
    assert ok.sum() >= 0.8 * len(n_a)
    np.testing.assert_allclose(got["feature"][ok], n(r1.feature)[ok], atol=2e-4)


def test_certainty_matches_jax_bit_for_bit(run):
    S, inp, jx, port = run
    for r in range(S):
        np.testing.assert_array_equal(port[r]["certainty"], jx["certainty"])
    assert (jx["certainty"] > 0).any()


def test_tracker_matches_jax(run):
    S, inp, jx, port = run
    want = jx["tracker"]
    for r in range(S):
        for a, b in zip(port[r]["tracker"], port[0]["tracker"]):
            np.testing.assert_array_equal(a, b)  # the same bits on every rank
    got = port[0]["tracker"]
    np.testing.assert_allclose(got[1], want[1], atol=2e-3)  # position
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)  # rotation
    assert bool(got[4]) and bool(want[4])
    assert abs(int(got[5]) - int(want[5])) <= 3
