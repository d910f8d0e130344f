"""The post-PGO query mode (``rotate_vecs=True``) against the JAX package:
a trained cylinder map (tests/test_torch_bundle_adjustment.py's scene) is
moved by a known correction with ``adjust_map`` on both sides, its replay
pool re-expressed with ``retransform_coords``, and then each map query of
the port runs beside JAX's on the moved map: ``query_feature`` (the
gathered features and neighbour rows exact, the rotated relative vectors
within 1e-5), the tracker's ``h_reduce`` (rtol 1e-4, as
tests/test_torch_iekf.py), one mapping call on the fused kernel's path
(its plain version; features within test_torch_mapper.py's 3 lr), the
dynamic filter's mask (equal) and one BA call (poses atol 1e-4, as the
one-step frame tests hold a pose; features as
test_torch_bundle_adjustment.py, the near-converged loss rtol 1e-2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clid_slam_torch.convert import pool_from_numpy
from clid_slam_torch.mapping import bundle_adjustment as tba
from clid_slam_torch.mapping import dynamic_filter as tdf
from clid_slam_torch.mapping import mapper as tmp
from clid_slam_torch.models import neural_map as tnm
from clid_slam_torch.odometry import iekf as tie
from clid_slam_tpu.mapping import bundle_adjustment as jba
from clid_slam_tpu.mapping import dynamic_filter as jdf
from clid_slam_tpu.mapping import mapper as jmp
from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.odometry import iekf as jie
from clid_slam_tpu.utils import lie as jlie
from test_torch_bundle_adjustment import BA_KW, MVD2, NB, RES, _port_scene, scene  # noqa: F401
from torch_parity import n, t

F = 8
LR = 0.01


def _correction():
    D = np.eye(4, dtype=np.float32)
    D[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.3])))
    D[:3, 3] = [0.2, -0.1, 0.05]
    return D


@pytest.fixture(scope="module")
def moved(scene):
    """The scene's map and pool after the correction, on both sides."""
    D = _correction()
    T = len(scene["travel"])
    diff = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    diff[0] = D  # every point of the scene was made at frame 0
    jmap = jnm.NeuralMapState(*[jnp.asarray(x) for x in scene["map"]])
    jmoved = jnm.adjust_map(jmap, jnp.asarray(diff), jnp.asarray(scene["travel"]), RES)
    tmap, tmlp, travel = _port_scene(scene)
    tmoved = tnm.adjust_map(tmap, t(diff), travel, RES)
    old = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    jpool = jpl.retransform_coords(scene["pool"], jnp.asarray(old), jnp.asarray(diff))
    return dict(D=D, jmap=jmoved, jmlp=jax.tree.map(jnp.asarray, scene["mlp"]), tmap=tmoved,
                tmlp=tmlp, travel=scene["travel"], tpool=pool_from_numpy(
                    [np.asarray(x) for x in jpool], "cpu"), jpool=jpool,
                world=(scene["batch"].coords @ D[:3, :3].T + D[:3, 3]).astype(np.float32),
                mask=np.asarray(scene["batch"].mask))


def test_adjusted_map_matches_jax(moved):
    jm, tm = moved["jmap"], moved["tmap"]
    np.testing.assert_allclose(n(tm.positions), np.asarray(jm.positions), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tm.quats), np.asarray(jm.quats), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(n(tm.hash_table), np.asarray(jm.hash_table))
    cnt = int(tm.count)
    assert np.abs(n(tm.quats)[:cnt, 0] - 1).max() > 1e-3  # the points did turn


@pytest.mark.parametrize("weighted_first", [True, False])
def test_query_feature_rotates_vecs_as_jax(moved, weighted_first):
    pts = moved["world"][::3]
    kw = dict(time_filtering=True, rotate_vecs=True, weighted_first=weighted_first)
    jq = jnm.query_feature(moved["jmap"], jnp.asarray(pts), NB, RES, MVD2, 6,
                           jnp.asarray(moved["travel"]), 0, 1e9, **kw)
    tq = tnm.query_feature(moved["tmap"], t(pts), t(NB), RES, MVD2, 6, t(moved["travel"]), 0,
                           1e9, **kw)
    np.testing.assert_array_equal(n(tq.knn_idx), np.asarray(jq.knn_idx))
    np.testing.assert_array_equal(n(tq.nn_count), np.asarray(jq.nn_count))
    got, want = n(tq.feature), np.asarray(jq.feature)
    if weighted_first:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(got[..., :F], want[..., :F])
        np.testing.assert_allclose(got[..., F:], want[..., F:], atol=1e-5, rtol=0)
    # the mode matters: the unrotated vectors differ by far more
    plain = tnm.query_feature(moved["tmap"], t(pts), t(NB), RES, MVD2, 6, t(moved["travel"]), 0,
                              1e9, time_filtering=True, weighted_first=weighted_first)
    assert np.abs(n(plain.feature)[..., F:] - want[..., F:]).max() > 1e-2
    assert (np.asarray(jq.nn_count) > 0).mean() > 0.5  # the batch holds free-space samples too


def test_h_reduce_rotates_vecs_as_jax(moved):
    kw = dict(knn_k=6, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2, sdf_scale=0.055,
              min_grad_norm=0.0, max_grad_norm=100.0, min_nn_count=1, rotate_vecs=True)
    D = moved["D"]
    src = (moved["world"][moved["mask"]][::4] - D[:3, 3]) @ D[:3, :3]  # sensor frame, pose D
    m = np.ones(len(src), bool)
    R, p = D[:3, :3].copy(), D[:3, 3] + np.float32([0.02, -0.01, 0.0])
    jS, jb, jv, _ = jie.make_h_reduce_fn(**kw)(
        moved["jmap"], moved["jmlp"], jnp.asarray(src), jnp.asarray(m), jnp.asarray(R),
        jnp.asarray(p), jnp.asarray(moved["travel"]), 0, 1e9,
    )
    tS, tb, tv = tie.make_h_reduce_fn(**kw)(
        moved["tmap"], moved["tmlp"], t(src), t(m), t(R), t(p), t(moved["travel"]), 0, 1e9,
    )
    assert int(tv) == int(jv) > 0.5 * len(src)
    np.testing.assert_allclose(n(tS), np.asarray(jS), rtol=1e-4, atol=1e-4 * np.abs(jS).max())
    np.testing.assert_allclose(n(tb), np.asarray(jb), rtol=1e-4, atol=1e-4 * np.abs(jb).max())


def test_mapping_on_the_kernel_path_rotates_vecs_as_jax(moved):
    """The fast body with ``use_pallas`` (the port's fused loop, its plain
    version on the CPU; JAX's XLA loop): the kernel takes the rotated
    encodings that ``build_cache`` makes."""
    bs, bs_new, iters = 1024, 0, 7
    kw = dict(feature_dim=F, knn_k=6, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2,
              sdf_scale=0.055, sigma=0.055, bs=bs, bs_new=bs_new, gradient_decimation=10,
              num_grad_eps=RES * 0.2, weight_e=0.5, loss_weight_on=True, lr=LR, adam_eps=1e-15,
              rotate_vecs=True, resample_every=20, max_outer=1, dup_independent=True)
    jpool, key = moved["jpool"], jax.random.PRNGKey(5)
    kb = jax.random.split(key)[1]
    k1, k2 = jax.random.split(kb)
    draws = [(np.asarray(jax.random.randint(k1, (bs,), 0, max(int(jpool.size), 1))),
              np.asarray(jax.random.randint(k2, (bs_new,), 0, max(int(jpool.new_count), 1))))]
    jm = moved["jmlp"]
    jres = jmp.make_mapping_fn(**kw, as_body=True)(
        moved["jmap"], jm, jm, jm, jpool, jnp.asarray(moved["travel"]), 1, 1e9, key,
        jnp.int32(iters), jnp.float32(1.0),
    )
    fn = tmp.make_mapping_fn(**kw, use_pallas=True)
    tm = moved["tmlp"]
    cache = fn.build_cache(moved["tmap"], moved["tpool"], t(moved["travel"]), 1, 1e9, None,
                           draws[0])
    plain = tmp.make_mapping_fn(**dict(kw, rotate_vecs=False)).build_cache(
        moved["tmap"], moved["tpool"], t(moved["travel"]), 1, 1e9, None, draws[0])
    assert (cache.encw0 - plain.encw0).abs().max() > 1e-2  # the kernel sees rotated encodings
    tres = fn(moved["tmap"], tm, tm, tm, moved["tpool"], t(moved["travel"]), 1, 1e9, iters, 1.0,
              batch_draws=draws)
    geo0 = np.asarray(moved["jmap"].geo_feats)
    d = np.abs(n(tres[0].geo_feats) - np.asarray(jres[0].geo_feats))
    assert d.max() < 3.0 * LR + 1e-6 and np.quantile(d, 0.99) < 2.5 * LR + 1e-6, d.max()
    assert np.abs(np.asarray(jres[0].geo_feats) - geo0).max() > 5 * LR
    for got, want in zip(tres[1].tensors(), jax.tree_util.tree_leaves(jres[1])):
        assert np.abs(n(got) - np.asarray(want)).max() < 3.0 * LR + 1e-6
    np.testing.assert_allclose(n(tres[4]), np.asarray(jres[4]), rtol=5e-2, atol=1e-4)


def test_dynamic_filter_rotates_vecs_as_jax(moved):
    kw = dict(knn_k=6, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2, sdf_scale=0.055,
              certainty_thre=0.5, sdf_ratio_thre=0.5, rotate_vecs=True)
    rng = np.random.default_rng(4)
    pts = moved["world"] + rng.normal(0, 0.3, moved["world"].shape).astype(np.float32)
    m = moved["mask"]
    want = np.asarray(jdf.make_dynamic_filter_fn(**kw)(
        moved["jmap"], moved["jmlp"], jnp.asarray(pts), jnp.asarray(m),
        jnp.asarray(moved["travel"]), 0, 1e9))
    got = n(tdf.make_dynamic_filter_fn(**kw)(
        moved["tmap"], moved["tmlp"], t(pts), t(m), t(moved["travel"]), 0, 1e9))
    np.testing.assert_array_equal(got, want)
    assert 0 < (m & ~want).sum() < m.sum()  # the filter drops some and keeps most


def test_ba_rotates_vecs_as_jax(moved):
    iters = 5
    kw = dict(BA_KW, window_size=2, lr_pose=2e-3, lr_map=LR, rotate_vecs=True)
    D = moved["D"]
    poses0 = np.stack([D, D]).astype(np.float32)
    poses0[1, :3, 3] += [0.03, -0.02, 0.01]
    jpool, key = moved["jpool"], jax.random.PRNGKey(5)
    draws, k = [], key
    for _ in range(iters):
        k, kb = jax.random.split(k)
        draws.append(np.asarray(jax.random.randint(kb, (kw["ba_bs"],), 0, max(int(jpool.size), 1))))
    jst, jposes, jloss = jba.make_ba_fn(feature_dim=F, **kw)(
        moved["jmap"], moved["jmlp"], jpool, jnp.asarray(poses0), 0,
        jnp.asarray(moved["travel"]), 0, 1e9, key, iters,
    )
    tst, tposes, tloss = tba.make_ba_fn(**kw)(
        moved["tmap"], moved["tmlp"], moved["tpool"], t(poses0), 0, t(moved["travel"]), 0, 1e9,
        iters, draws=np.stack(draws),
    )
    # rotated window poses: f32 rounding of a turned frame, far below one
    # Adam step (2e-3); the one-step frame tests' pose tolerance
    np.testing.assert_allclose(n(tposes), np.asarray(jposes), atol=1e-4, rtol=0)
    assert np.abs(n(tposes) - poses0).max() > 1e-3  # the poses did move
    d = np.abs(n(tst.geo_feats) - np.asarray(jst.geo_feats))
    assert np.quantile(d, 0.999) < 3 * LR, np.quantile(d, 0.999)
    # a near-converged loss (7e-4): the poses' rounding moves it by 0.2 %
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)
    assert np.isfinite(float(tloss)) and float(tloss) < 0.05
