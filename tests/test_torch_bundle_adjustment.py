"""Sliding-window bundle adjustment and the pool's re-transform against the
JAX package: ``retransform_coords`` (coords atol 1e-5, other columns
exact); five BA iterations on the JAX draws (poses atol 1e-5, features'
99.9th percentile within 3 lr, the Adam sign rule of
tests/test_torch_streaming.py, loss rtol 1e-4); and the port's BA on its own
draws under the gates of tests/test_bundle_adjustment.py (it recovers a
pose offset and cuts a drifted window's ATE by 40 %). The scene is that
file's: a cylinder map trained by the JAX mapper, carried across with
clid_slam_torch.convert."""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy, pool_from_numpy
from clid_slam_torch.mapping import bundle_adjustment as tba
from clid_slam_torch.mapping import pool as tpl
from clid_slam_tpu.mapping import bundle_adjustment as jba
from clid_slam_tpu.mapping import mapper as jmp
from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.mapping.sampler import sample_rays
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import local_map as jlm
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.ops.voxel import neighbor_offsets
from clid_slam_tpu.utils import lie as jlie
from torch_parity import n, t

RES, F = 0.3, 8
NB = neighbor_offsets(2, 0.5)
MVD2 = 3.0 * (3 * RES) ** 2
BA_KW = dict(knn_k=6, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2, sdf_scale=0.055,
             ba_bs=4096, adam_eps=1e-15)


@pytest.fixture(scope="module")
def scene():
    """tests/test_bundle_adjustment.py's trained cylinder map (true pose I)
    and its ray batch, as JAX arrays."""
    rng = np.random.default_rng(0)
    m = 1024
    ang = rng.uniform(0, 2 * np.pi, m)
    z = rng.uniform(-1.0, 1.0, m)
    pts = np.stack([4 * np.cos(ang), 4 * np.sin(ang), z], -1).astype(np.float32)
    mask = jnp.ones((m,), bool)
    lmap = jlm.init_local_map(1 << 13, 1 << 15)
    lmap = jlm.update_local_map(lmap, jnp.zeros(3), jnp.asarray(pts), mask, 0.1, 100.0)
    batch = sample_rays(
        jax.random.PRNGKey(0), jnp.asarray(pts), mask, jnp.eye(4), lmap, 0.1,
        surface_sample_range_m=0.25, surface_sample_n=3, free_front_n=2,
        free_behind_n=1, free_sample_begin_ratio=0.3, free_sample_end_dist_m=1.0,
        max_range=60.0,
    )
    nmap = jnm.init_map(1 << 13, 1 << 15, F)
    travel = jnp.zeros((8,), jnp.float32)
    nmap, _ = jnm.insert_points(
        nmap, batch.coords, batch.mask & (jnp.abs(batch.sdf_label) < 0.125), RES, travel, 0, 1e9,
    )
    pool = jpl.append_samples(
        jpl.init_pool(1 << 15, 1 << 15), batch.coords, batch.sdf_label, batch.weight,
        batch.mask, 0, jnp.zeros_like(batch.mask),
    )
    mlp = jdec.init_mlp(jax.random.PRNGKey(1), F + 3, 64, 1)
    mapping = jmp.make_mapping_fn(
        feature_dim=F, knn_k=6, nb_offs=NB, resolution=RES, max_valid_dist2=MVD2,
        sdf_scale=0.055, sigma=0.055, bs=2048, bs_new=0, gradient_decimation=10,
        num_grad_eps=RES * 0.2, weight_e=0.5, loss_weight_on=True, lr=0.01, adam_eps=1e-15,
    )
    cm = jdec.init_mlp(jax.random.PRNGKey(3), F + 3, 32, 1)
    sm = jdec.init_mlp(jax.random.PRNGKey(4), F + 3, 32, 1)
    nmap, mlp, _, _, _ = mapping(nmap, mlp, cm, sm, pool, travel, 0, 1e9, jax.random.PRNGKey(2),
                                 300, 1.0)
    return dict(map=[np.asarray(x) for x in nmap], mlp=jax.tree.map(np.asarray, mlp),
                travel=np.asarray(travel), batch=jax.tree.map(np.asarray, batch), pool=pool)


def _port_scene(scene):
    return (neural_map_from_numpy(scene["map"], "cpu"), mlp_from_numpy(scene["mlp"], "cpu"),
            t(scene["travel"]))


DRIFT = np.array([[0, 0, 0], [0.02, -0.01, 0.01], [0.05, -0.03, 0.02], [0.08, -0.05, 0.03]])


def _drifted_window_pool(scene, append):
    """tests/test_bundle_adjustment.py:93's window: each of 4 frames adds
    the batch's surface endpoints at its drifted world coords."""
    b = scene["batch"]
    sel = b.mask & (np.abs(b.sdf_label) < 1e-6)
    rows = len(b.coords)
    pool = None
    for k in range(len(DRIFT)):
        pool = append(pool, (b.coords + DRIFT[k][None, :]).astype(np.float32),
                      np.zeros(rows, np.float32), np.ones(rows, np.float32), sel, k,
                      np.zeros(rows, bool))
    return pool


def _jax_append(pool, *a):
    pool = pool if pool is not None else jpl.init_pool(1 << 15, 1 << 15)
    coords, sdf, w, mask, k, new = a
    return jpl.append_samples(pool, jnp.asarray(coords), jnp.asarray(sdf), jnp.asarray(w),
                              jnp.asarray(mask), k, jnp.asarray(new))


def _port_append(pool, *a):
    pool = pool if pool is not None else tpl.init_pool(1 << 15, 1 << 15)
    coords, sdf, w, mask, k, new = a
    return tpl.append_samples(pool, t(coords), t(sdf), t(w), t(mask), k, t(new),
                              generator=torch.Generator().manual_seed(k))


def _window_poses():
    poses = np.tile(np.eye(4, dtype=np.float32), (len(DRIFT), 1, 1))
    poses[:, :3, 3] = DRIFT
    return poses


def test_retransform_coords_matches_jax():
    rng = np.random.default_rng(3)
    T = 6
    tau = lambda: jnp.asarray((rng.normal(size=(T, 6)) * 0.3).astype(np.float32))
    old, new = np.asarray(jlie.se3_exp(tau())), np.asarray(jlie.se3_exp(tau()))
    rows = 5000
    data = rng.normal(0, 5, (rows, 9)).astype(np.float32)
    data[:, 5] = rng.integers(-2, T + 3, rows)  # frame ids, some outside the table
    jp = jpl.init_pool(rows, 64)._replace(data=jnp.asarray(data))
    want = np.asarray(jpl.retransform_coords(jp, jnp.asarray(old), jnp.asarray(new)).data)
    tp = pool_from_numpy([np.asarray(x) for x in jp], "cpu")
    got = n(tpl.retransform_coords(tp, t(old), t(new)).data)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    assert not np.allclose(got[:, :3], data[:, :3], atol=1e-2)  # the coords did move
    np.testing.assert_array_equal(n(tp.data), data)  # the input pool is untouched


def test_ba_matches_jax_on_the_jax_draws(scene):
    iters, lr = 5, 0.01
    kw = dict(BA_KW, window_size=len(DRIFT), lr_pose=2e-3, lr_map=lr)
    jpool = _drifted_window_pool(scene, _jax_append)
    poses0 = _window_poses()
    key = jax.random.PRNGKey(5)
    draws, k = [], key
    for _ in range(iters):
        k, kb = jax.random.split(k)
        draws.append(np.asarray(jax.random.randint(kb, (kw["ba_bs"],), 0, max(int(jpool.size), 1))))
    jmap = jnm.NeuralMapState(*[jnp.asarray(x) for x in scene["map"]])
    jmlp = jax.tree.map(jnp.asarray, scene["mlp"])
    jst, jposes, jloss = jba.make_ba_fn(feature_dim=F, **kw)(
        jmap, jmlp, jpool, jnp.asarray(poses0), 0, jnp.asarray(scene["travel"]), 0, 1e9, key, iters,
    )
    tmap, tmlp, travel = _port_scene(scene)
    tpool = pool_from_numpy([np.asarray(x) for x in jpool], "cpu")
    feats0 = tmap.geo_feats.clone()
    tst, tposes, tloss = tba.make_ba_fn(**kw)(
        tmap, tmlp, tpool, t(poses0), 0, travel, 0, 1e9, iters, draws=np.stack(draws),
    )
    assert torch.equal(tmap.geo_feats, feats0)  # the input state is untouched
    np.testing.assert_allclose(n(tposes), np.asarray(jposes), atol=1e-5, rtol=0)
    assert np.abs(n(tposes) - poses0).max() > 1e-3  # the poses did move
    d = np.abs(n(tst.geo_feats) - np.asarray(jst.geo_feats))
    assert np.quantile(d, 0.999) < 3 * lr, np.quantile(d, 0.999)
    assert np.abs(n(tst.geo_feats) - n(feats0)).max() > lr  # the features did move
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)


def test_port_ba_recovers_pose_offset(scene):
    """tests/test_bundle_adjustment.py:20 on the port: a window of 2 poses
    both offset from the truth, with the pool's coords consistent with
    them; BA moves frame 0's pose toward the identity."""
    tmap, tmlp, travel = _port_scene(scene)
    offset = np.eye(4, dtype=np.float32)
    offset[:3, 3] = [0.06, -0.04, 0.02]
    pool = pool_from_numpy([np.asarray(x) for x in scene["pool"]], "cpu")
    data = pool.data.clone()
    data[:, 0:3] += t(offset[:3, 3])
    ba = tba.make_ba_fn(**dict(BA_KW, window_size=2, lr_pose=2e-3, lr_map=0.0))
    _, new_poses, loss = ba(tmap, tmlp, replace(pool, data=data), t(np.stack([offset, offset])),
                            0, travel, 0, 1e9, 150, generator=torch.Generator().manual_seed(5))
    err_before = np.linalg.norm(offset[:3, 3])
    err_after = np.linalg.norm(n(new_poses)[0][:3, 3])
    assert np.isfinite(float(loss))
    assert err_after < err_before * 0.6, (err_before, err_after)


def test_port_ba_reduces_window_ate(scene):
    """tests/test_bundle_adjustment.py:93 on the port: a static platform
    whose 4 estimated poses drift; BA cuts the window's ATE by 40 %."""
    tmap, tmlp, travel = _port_scene(scene)
    pool = _drifted_window_pool(scene, _port_append)
    ba = tba.make_ba_fn(**dict(BA_KW, window_size=len(DRIFT), lr_pose=2e-3, lr_map=0.0))
    _, new_poses, loss = ba(tmap, tmlp, pool, t(_window_poses()), 0, travel, 0, 1e9, 200,
                            generator=torch.Generator().manual_seed(5))
    ate_before = float(np.sqrt((DRIFT**2).sum(1).mean()))
    ate_after = float(np.sqrt((n(new_poses)[:, :3, 3] ** 2).sum(1).mean()))
    assert np.isfinite(float(loss))
    assert ate_after < ate_before * 0.6, (ate_before, ate_after)
