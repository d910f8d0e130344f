"""Meshing against the JAX package: ``ops/marching.py`` on
tests/test_mesher.py's sphere grids and on a random grid with a random
mask (masks equal, triangles within 1e-6 m: f32, and XLA may contract
``pa + t * (pb - pa)`` into a fused multiply-add), ``_weld_mesh`` and
``filter_mesh_vertices`` on the same soups (arrays equal exactly), and the
``Mesher`` on one trained map (tests/test_color_semantic.py's cylinder wall
with its color and semantic heads, carried across with
clid_slam_torch.convert) under decode-then-weight, bf16 decoding, layer
norm and the post-PGO queries after ``adjust_map``:

- ``query_sdf_points``, ``sdf_slice`` and ``sdf_slice_vertical``: masks
  equal, SDF within 1e-5 (bf16: the decoder tests' bf16 limits, relative
  99th percentile 1e-5 and the largest 2^-7 of the scale, since a hidden
  activation on a bf16 rounding boundary may round the other way);
- one chunk's marching fed JAX's own SDF grid: triangles within 1e-6 and
  masks equal, and the port's query of that grid as above;
- ``recon_aabb_mesh`` with guide points: vertex counts within 1 % and a
  symmetric Chamfer distance under 1e-4 m;
- ``estimate_vertex_colors`` within 1e-5 (1 and 3 channels; bf16 as
  above);
- ``estimate_vertex_sem``: labels equal wherever the top two
  log-probabilities differ by more than 1e-4.

Then the port's mirrors of tests/test_mesher.py's geometric checks,
tests/test_color_semantic.py::test_mesher_vertex_attributes and
tests/test_mesh_eval.py.

Grids of points whose spacing is commensurate with the voxels (the slices,
a chunk's grid) put points on voxel faces. There JAX's jitted chunk query,
whose XLA rewrites ``points / resolution`` into a product with the
reciprocal, may floor into the next cell, where JAX's op-by-op query and
the port divide (``on_voxel_face``). The masks and SDFs are compared off
those points, and every disagreement must lie on them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial import cKDTree

from clid_slam_torch import mesher as tms
from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy
from clid_slam_torch.models import decoder as tdec
from clid_slam_torch.models import neural_map as tnm
from clid_slam_torch.ops.marching import marching_tetrahedra as t_march
from clid_slam_torch.utils import metrics as tmetrics
from clid_slam_tpu import mesher as jms
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.ops.marching import marching_tetrahedra as j_march
from clid_slam_tpu.ops.voxel import neighbor_offsets
from clid_slam_tpu.utils import lie as jlie
from test_color_semantic import F, KNN, RES, SDF_SCALE, _wall_points, trained  # noqa: F401
from test_mesher import sphere_grid
from torch_parity import n, t

NB = neighbor_offsets(2, 0.5)
MVD2 = 3.0 * (3 * RES) ** 2
MC_RES, CD = 0.15, 16
MESHER_KW = dict(knn_k=KNN, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2,
                 sdf_scale=SDF_SCALE, mesh_min_nn=3, chunk_dim=CD, feature_dim=F)
CASES = {
    "weighted_first": {},
    "decode_then_weight": dict(weighted_first=False),
    "bf16": dict(mlp_bf16=True),
    "layer_norm": dict(layer_norm=True),
    "rotate_vecs": dict(rotate_vecs=True),  # on the map moved by adjust_map
}


def chamfer(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric Chamfer distance: the mean nearest-neighbour distance
    from a to b and from b to a, halved."""
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def on_voxel_face(pts: np.ndarray) -> np.ndarray:
    """Points whose cell differs between the f32 division by the voxel size
    and the f32 product with its reciprocal."""
    res = np.float32(RES)
    return np.any(np.floor(pts / res) != np.floor(pts * (np.float32(1) / res)), axis=-1)


def _march_both(sdf, mask, origin, res, dims):
    j = j_march(jnp.asarray(sdf), jnp.asarray(mask), jnp.asarray(origin), res, dims)
    p = t_march(t(sdf), t(mask), t(origin), res, dims)
    return [np.asarray(x) for x in j], [n(x) for x in p]


def _sphere(dims, lo, res, radius):
    origin = np.full(3, lo, np.float32)
    sdf, _ = sphere_grid(dims, origin, res, radius)
    return sdf, np.ones(len(sdf), bool), origin, res, dims


def _random_grid():
    rng = np.random.default_rng(7)
    dims = (9, 11, 7)
    sdf = rng.normal(0, 1, int(np.prod(dims))).astype(np.float32)
    return sdf, rng.uniform(size=len(sdf)) < 0.9, np.array([0.3, -1.2, 2.5], np.float32), 0.07, dims


GRIDS = {
    "sphere_24": lambda: _sphere((24, 24, 24), -1.15, 0.1, 0.8),
    "sphere_32": lambda: _sphere((32, 32, 32), -1.24, 0.08, 0.9),
    "sphere_masked_out": lambda: (*_sphere((12, 12, 12), -0.55, 0.1, 0.4)[:1],
                                  np.zeros(12**3, bool), np.full(3, -0.55, np.float32), 0.1,
                                  (12, 12, 12)),
    "random_masked": _random_grid,
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_marching_tetrahedra_matches_jax(grid):
    sdf, mask, origin, res, dims = GRIDS[grid]()
    (jt, jok), (pt, pok) = _march_both(sdf, mask, origin, res, dims)
    assert pt.shape == jt.shape == ((dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1) * 12, 3, 3)
    assert pt.dtype == np.float32
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_allclose(pt[pok], jt[jok], atol=1e-6, rtol=0)
    if grid == "sphere_masked_out":
        assert not pok.any()
    elif grid.startswith("sphere"):  # tests/test_mesher.py's checks, on the port's triangles
        tris = pt[pok]
        radius = {"sphere_24": 0.8, "sphere_32": 0.9}[grid]
        d = np.abs(np.linalg.norm(tris.reshape(-1, 3), axis=-1) - radius)
        assert len(tris) > 500 and d.max() < res and d.mean() < 0.02
        area = 0.5 * np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]),
                                    axis=-1).sum()
        assert abs(area - 4 * np.pi * radius**2) / (4 * np.pi * radius**2) < 0.08
    else:
        assert 0 < pok.sum() < len(pok)


def _soups():
    quad = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[1, 0, 0], [1, 1, 0], [0, 1, 0]]],
                    np.float32)
    iso = np.array([[[5, 5, 5], [6, 5, 5], [5, 6, 5]]], np.float32)
    sdf, mask, origin, res, dims = GRIDS["sphere_24"]()
    (jt, jok), _ = _march_both(sdf, mask, origin, res, dims)
    # two spheres far apart, the second cut by a mask: clusters of two sizes
    sdf2, _, origin2, res2, dims2 = _sphere((12, 12, 12), -0.55, 0.1, 0.4)
    m2 = np.random.default_rng(3).uniform(size=len(sdf2)) < 0.97
    (jt2, jok2), _ = _march_both(sdf2, m2, origin2 + 5.0, res2, dims2)
    return {"quad_and_isolated": (np.concatenate([quad, iso]), 0.1),
            "spheres": (np.concatenate([jt[jok], jt2[jok2]]), res)}


@pytest.mark.parametrize("min_cluster", [0, 4, 300], ids=lambda m: f"min_cluster_{m}")
@pytest.mark.parametrize("soup", ["quad_and_isolated", "spheres"])
def test_weld_and_vertex_filter_match_jax(soup, min_cluster):
    tris, res = _soups()[soup]
    jv, jf = jms._weld_mesh(tris, res, min_cluster)
    pv, pf = tms._weld_mesh(tris, res, min_cluster)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    assert pv.dtype == jv.dtype and pf.dtype == jf.dtype
    if soup == "quad_and_isolated":  # tests/test_mesher.py: 4 vertices, the triangle dropped
        assert len(pv) == 7 and len(pf) == (3 if min_cluster == 0 else 2 if min_cluster == 4 else 0)
    keep = np.random.default_rng(min_cluster).uniform(size=len(jv)) < 0.8
    for got, want in zip(tms.filter_mesh_vertices(pv, pf, keep),
                         jms.filter_mesh_vertices(jv, jf, keep)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tms.SEM_KITTI_COLORS, jms.SEM_KITTI_COLORS)


# ------------------------------------------------------------- the Mesher


@pytest.fixture(scope="module", params=list(CASES))
def case(request, trained):
    """Both packages' Meshers of one case on the trained map (moved by a
    known correction for the post-PGO case), and JAX's mesh of it."""
    nmap, mlp, color_mlp, sem_mlp, _, _, _ = trained
    kw = CASES[request.param]
    jmap = nmap
    if kw.get("rotate_vecs"):
        D = np.eye(4, dtype=np.float32)
        D[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.3])))
        D[:3, 3] = [0.2, -0.1, 0.05]
        diff = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
        diff[0] = D  # every point of the map was made at frame 0
        jmap = jnm.adjust_map(nmap, jnp.asarray(diff), jnp.zeros(8), RES)
        tmap = tnm.adjust_map(neural_map_from_numpy([np.asarray(x) for x in nmap], "cpu"),
                              t(diff), torch.zeros(8), RES)
    else:
        tmap = neural_map_from_numpy([np.asarray(x) for x in jmap], "cpu")
    jm = jms.Mesher(**MESHER_KW, **kw)
    tm = tms.Mesher(**MESHER_KW, **kw)
    cnt = int(jmap.count)
    guide = np.asarray(jmap.positions[:cnt])
    recon = dict(aabb_min=guide.min(0), aabb_max=guide.max(0), mc_res=MC_RES, pad_voxel=2,
                 min_cluster_vertices=20, guide_points=guide, skip_top_voxel=2)
    jv, jf = jm.recon_aabb_mesh(jmap, mlp, **recon)
    port_mlp = lambda m: mlp_from_numpy(jax.tree.map(np.asarray, m), "cpu")
    return dict(name=request.param, kw=kw, jm=jm, tm=tm, jmap=jmap, tmap=tmap, recon=recon,
                jmesh=(jv, jf), mlps=(mlp, color_mlp, sem_mlp),
                tmlps=(port_mlp(mlp), port_mlp(color_mlp), port_mlp(sem_mlp)))


def _assert_close(case, got, want):
    if case["kw"].get("mlp_bf16"):
        scale = np.abs(want).max()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * scale)
        assert np.quantile(rel, 0.99) <= 1e-5 and np.abs(got - want).max() <= 2.0**-7 * scale
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _assert_queries_agree(case, pts, got, want):
    """(sdf, ok) of the port and of JAX at ``pts``: masks equal and SDFs
    close off the voxel faces; a disagreement only on a face."""
    (ps, pok), (js, jok) = got, want
    face = on_voxel_face(pts)
    assert not (pok != jok)[~face].any()
    both = pok & jok & ~face
    assert both.sum() > 0.9 * (jok & ~face).sum() > 0
    _assert_close(case, ps[both], js[both])


def test_sdf_queries_match_jax(case):
    jm, tm, jmap, tmap = case["jm"], case["tm"], case["jmap"], case["tmap"]
    mlp, tmlp = case["mlps"][0], case["tmlps"][0]
    pts = np.random.default_rng(1).uniform([-5, -5, -1.5], [5, 5, 1.5], (5000, 3)).astype(np.float32)
    js, jok = jm.query_sdf_points(jmap, mlp, pts)
    ps, pok = tm.query_sdf_points(tmap, tmlp, pts)
    assert ps.dtype == np.float32 and 0 < jok.sum() < len(pts)
    assert not on_voxel_face(pts).any()
    _assert_queries_agree(case, pts, (ps, pok), (js, jok))
    for name, args in (("sdf_slice", (np.zeros(3), 4.5, 0.3, 0.2)),
                       ("sdf_slice_vertical", (np.array([0.5, 0.0, 0.0]), 4.5, 0.5, 0.2))):
        jp, js, jok = getattr(jm, name)(jmap, mlp, *args)
        pp, ps, pok = getattr(tm, name)(tmap, tmlp, *args)
        np.testing.assert_array_equal(pp, jp)
        _assert_queries_agree(case, pp, (ps, pok), (js, jok))


def test_chunk_marching_on_jax_sdf_grid_matches_jax(case):
    """JAX's SDF grid of one chunk across the wall (its chunk query at the
    port's grid points), through the port's marching and through JAX's:
    triangles within 1e-6, masks equal; and the port's own query of the
    same grid agrees with JAX's as above."""
    jm, tm, jmap, mlp = case["jm"], case["tm"], case["jmap"], case["mlps"][0]
    origin = np.array([2.9, -1.0, -1.1], np.float32)
    pts = n(tm.chunk_points(t(origin), MC_RES))
    np.testing.assert_allclose(pts[-1], origin + (CD - 1) * MC_RES, atol=1e-6)
    jsdf, jok = (np.asarray(x) for x in jm._query_chunk(jmap, mlp, jnp.asarray(pts),
                                                        jnp.ones(CD**3, bool)))
    (jt, jtok), (pt, ptok) = _march_both(jsdf, jok, origin, MC_RES, (CD, CD, CD))
    np.testing.assert_array_equal(ptok, jtok)
    assert jtok.sum() > 100
    np.testing.assert_allclose(pt[ptok], jt[jtok], atol=1e-6, rtol=0)
    psdf, pok = tm.query_chunk(case["tmap"], case["tmlps"][0], t(pts),
                               torch.ones(CD**3, dtype=torch.bool))
    _assert_queries_agree(case, pts, (n(psdf), n(pok)), (jsdf, jok))


def test_recon_aabb_mesh_matches_jax(case):
    jv, jf = case["jmesh"]
    pv, pf = case["tm"].recon_aabb_mesh(case["tmap"], case["tmlps"][0], **case["recon"])
    assert pv.dtype == np.float32 and pf.dtype == np.int64
    assert len(jv) > 1000, len(jv)
    assert abs(len(pv) - len(jv)) <= 0.01 * len(jv), (len(pv), len(jv))
    assert abs(len(pf) - len(jf)) <= 0.01 * len(jf), (len(pf), len(jf))
    assert chamfer(pv, jv) < 1e-4


@pytest.mark.parametrize("channels", [1, 3])
def test_vertex_colors_match_jax(case, channels):
    verts = case["jmesh"][0]
    want = case["jm"].estimate_vertex_colors(case["jmap"], case["mlps"][1], verts, channels)
    got = case["tm"].estimate_vertex_colors(case["tmap"], case["tmlps"][1], verts, channels)
    assert got.shape == want.shape
    _assert_close(case, got, want)


def test_vertex_classes_match_jax(case):
    """Labels and keep-masks equal wherever the top two log-probabilities
    (decoded as the chunk decodes them) differ by more than 1e-4."""
    verts = case["jmesh"][0]
    jl, jkeep = case["jm"].estimate_vertex_sem(case["jmap"], case["mlps"][2], verts)
    tm, tmap, sem = case["tm"], case["tmap"], case["tmlps"][2]
    pl, pkeep = tm.estimate_vertex_sem(tmap, sem, verts)
    q = tm._query(tmap, t(verts))
    logp = tm._weighted(tdec.sem_label_prob(sem, q.feature, **tm.dec_kw), q)
    top2 = np.sort(n(logp), axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.95 and jkeep.any()
    np.testing.assert_array_equal(pl[clear], jl[clear])
    np.testing.assert_array_equal(pkeep[clear], jkeep[clear])


# --------------------------------------------- mirrors of the JAX tests


def test_mesher_vertex_attributes(trained):
    """tests/test_color_semantic.py::test_mesher_vertex_attributes on the
    port: vertex colors and classes agree with the heads' truth and
    free-space vertices are dropped."""
    nmap, mlp, color_mlp, sem_mlp, nb, mvd2, _ = trained
    tmap = neural_map_from_numpy([np.asarray(x) for x in nmap], "cpu")
    cm, sm = (mlp_from_numpy(jax.tree.map(np.asarray, m), "cpu") for m in (color_mlp, sem_mlp))
    mesher = tms.Mesher(knn_k=KNN, nb_offs=nb, resolution=RES, max_valid_dist2=mvd2,
                        sdf_scale=SDF_SCALE, mesh_min_nn=3, chunk_dim=8, feature_dim=F)
    ang_q, qpts = _wall_points(96)
    colors = mesher.estimate_vertex_colors(tmap, cm, qpts, color_channel=1)
    assert colors.shape == (96, 3)
    np.testing.assert_allclose(colors[:, 0], colors[:, 1])
    q = tnm.query_feature(tmap, t(qpts), torch.as_tensor(nb), RES, mvd2, KNN)
    okq = n(q.nn_count) >= 3
    truth = 0.5 * (np.sin(2 * ang_q) + 1)
    assert np.corrcoef(colors[okq, 0], np.clip(truth * 2, 0, 1)[okq])[0, 1] > 0.6
    labels, keep = mesher.estimate_vertex_sem(tmap, sm, qpts)
    truth_cls = (ang_q // (np.pi / 2)).astype(int) + 1
    assert (labels[okq] == truth_cls[okq]).mean() > 0.7
    _, keep_far = mesher.estimate_vertex_sem(tmap, sm, np.full((16, 3), 50.0, np.float32))
    assert not keep_far.any()
    verts = qpts[:6]
    tris = np.array([[0, 1, 2], [2, 3, 4], [3, 4, 5]])
    v2, t2, kept = tms.filter_mesh_vertices(verts, tris, np.array([1, 1, 1, 0, 1, 1], bool))
    assert len(v2) == 5 and len(t2) == 1 and (t2 == [[0, 1, 2]]).all()
    np.testing.assert_array_equal(kept, [0, 1, 2, 4, 5])
    assert tms.SEM_KITTI_COLORS.shape == (20, 3)


def _unit_cube_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    t_ = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                   [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.int64)
    return v, t_


@pytest.mark.parametrize("check", ["sampling_on_surface", "perfect_match", "detects_offset",
                                   "incomplete_reconstruction", "empty_inputs"])
def test_mesh_eval(check):
    """tests/test_mesh_eval.py on the port's utils/metrics.py."""
    v, f = _unit_cube_mesh()
    score = tmetrics.mesh_f_score
    if check == "sampling_on_surface":
        pts = tmetrics.sample_mesh_points(v, f, n=5000, seed=1)
        assert pts.shape == (5000, 3)
        assert np.any((np.abs(pts) < 1e-5) | (np.abs(pts - 1.0) < 1e-5), axis=1).all()
        assert (pts >= -1e-5).all() and (pts <= 1 + 1e-5).all()
    elif check == "perfect_match":
        m = score(tmetrics.sample_mesh_points(v, f, n=20000, seed=1),
                  tmetrics.sample_mesh_points(v, f, n=20000, seed=2), threshold_m=0.05)
        assert m["f_score"] > 0.99 and m["chamfer_l1_m"] < 0.02
    elif check == "detects_offset":
        a = tmetrics.sample_mesh_points(v, f, n=10000, seed=1)
        m = score(a, a + np.array([0.2, 0.0, 0.0], np.float32), threshold_m=0.05)
        assert m["f_score"] < 0.6 and m["chamfer_l1_m"] > 0.05
    elif check == "incomplete_reconstruction":
        gt = tmetrics.sample_mesh_points(v, f, n=20000, seed=1)
        m = score(gt[gt[:, 2] < 0.5], gt, threshold_m=0.05)
        assert m["precision"] > 0.95 and m["recall"] < 0.8
        assert m["completeness_m"] > m["accuracy_m"]
    else:
        m = score(np.zeros((0, 3)), np.ones((10, 3)))
        assert m["f_score"] == 0.0 and np.isinf(m["completeness_m"])
