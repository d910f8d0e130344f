"""Sampler and replay-pool parity with the JAX side's random draws injected:
sample_rays (labels atol 1e-5, masks exact), pool append through the
filling and the eviction phase (backfilled masked rows, colliding
eviction slots: data, validity and slots exact), window filter, and batch
index sampling (exact)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import local_map_from_numpy, pool_from_numpy
from clid_slam_torch.mapping import pool as tpl
from clid_slam_torch.mapping import sampler as tsm
from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.mapping import sampler as jsm
from clid_slam_tpu.models import local_map as jlm
from clid_slam_tpu.utils import lie as jlie

from torch_parity import n, t

LRES = 0.15
SAMPLER_KW = dict(
    surface_sample_range_m=0.25, surface_sample_n=3, free_front_n=2,
    free_behind_n=1, free_sample_begin_ratio=0.3, free_sample_end_dist_m=1.0,
    max_range=30.0, dist_weight_on=True, dist_weight_scale=0.8,
    incidence_label_on=True, incidence_min_factor=0.1,
    incidence_degenerate_factor=1.0, free_behind_weight=2.0,
)


def _room_scan(rng, m=4000):
    """Sensor-frame returns from a box room (walls, floor, ceiling)."""
    d = rng.normal(size=(m, 3))
    d[:, 2] *= 0.4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    box = np.array([3.0, 2.5, 1.5])
    tt = np.min(np.where(np.abs(d) > 1e-9, box / np.abs(d), np.inf), axis=1)
    return (d * tt[:, None] + rng.normal(0, 0.01, (m, 3))).astype(np.float32)


def _pose(rng):
    T = np.asarray(jlie.se3_exp(jnp.asarray((rng.normal(size=6) * 0.1).astype(np.float32))))
    return T.astype(np.float32)


def _sampler_case(seed):
    rng = np.random.default_rng(seed)
    pts = _room_scan(rng)
    mask = rng.uniform(size=len(pts)) < 0.95
    pose = _pose(rng)
    world = pts @ pose[:3, :3].T + pose[:3, 3]
    lm0 = jlm.init_local_map(1 << 14, 1 << 15)
    lm0 = jlm.update_local_map(
        lm0, jnp.asarray(pose[:3, 3]), jnp.asarray(world), jnp.asarray(mask), LRES, 50.0, crop_now=True
    )
    return pts, mask, pose, lm0


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_rays_matches_jax(seed):
    pts, mask, pose, lm0 = _sampler_case(seed)
    key = jax.random.PRNGKey(seed)
    jb = jsm.sample_rays(key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pose), lm0, LRES, **SAMPLER_KW)
    k_surf, k_front, k_behind = jax.random.split(key, 3)
    m = len(pts)
    draws = (
        np.asarray(jax.random.normal(k_surf, (3, m))),
        np.asarray(jax.random.uniform(k_front, (2, m))),
        np.asarray(jax.random.uniform(k_behind, (1, m))),
    )
    tb = tsm.sample_rays(
        t(pts), t(mask), t(pose), local_map_from_numpy([np.asarray(x) for x in lm0], "cpu"),
        LRES, draws=draws, **SAMPLER_KW,
    )
    np.testing.assert_array_equal(n(tb.mask), np.asarray(jb.mask))
    np.testing.assert_allclose(n(tb.coords), np.asarray(jb.coords), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tb.sdf_label), np.asarray(jb.sdf_label), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tb.weight), np.asarray(jb.weight), atol=1e-6, rtol=0)
    assert n(tb.mask).mean() > 0.5


def _batch(rng, m, p_mask=0.8):
    coords = rng.normal(0, 5.0, (m, 3)).astype(np.float32)
    sdf = rng.normal(0, 0.3, m).astype(np.float32)
    w = rng.uniform(-1, 1.4, m).astype(np.float32)
    mask = rng.uniform(size=m) < p_mask
    mask[-7:] = False  # a trailing masked run takes the sentinel slot
    is_new = rng.uniform(size=m) < 0.3
    return coords, sdf, w, mask, is_new


def _leaves(pool):
    return [np.asarray(x) for x in pool]


def _assert_pool_equal(tp, jp):
    for name, a in zip(("data", "valid", "size", "new_buf", "new_count"), jp):
        np.testing.assert_array_equal(n(getattr(tp, name)), np.asarray(a), err_msg=name)


def test_pool_append_fill_evict_filter_matches_jax():
    """Three frames into a pool that holds ~1.5 of them: fill, partial
    fit (whole frame through eviction), full eviction; masked rows in
    every frame, colliding eviction slots at this capacity."""
    rng = np.random.default_rng(2)
    cap, m = 3000, 2000
    jp = jpl.init_pool(cap, m, 1)
    tp = tpl.init_pool(cap, m, 1, device="cpu")
    for f in range(3):
        coords, sdf, w, mask, is_new = _batch(rng, m)
        key = jax.random.PRNGKey(100 + f)
        uni = np.asarray(jax.random.uniform(key, (m + 1,)))
        jp = jpl.append_samples(
            jp, jnp.asarray(coords), jnp.asarray(sdf), jnp.asarray(w), jnp.asarray(mask),
            f, jnp.asarray(is_new), key=key,
        )
        tp = tpl.append_samples(tp, t(coords), t(sdf), t(w), t(mask), f, t(is_new), uniform=t(uni))
        _assert_pool_equal(tp, jp)
        slots, _, _ = tpl.append_slots(tp, t(mask), t(uni))
        if f == 2:  # eviction draws collide at this capacity
            live = n(slots)[mask]
            assert len(np.unique(live)) < len(live)
    origin = np.array([1.0, -2.0, 0.5], np.float32)
    jf = jpl.filter_pool(jp, jnp.asarray(origin), 6.0)
    tf = tpl.filter_pool(tp, t(origin), 6.0)
    _assert_pool_equal(tf, jf)
    assert 0 < n(tf.valid).sum() < cap


@pytest.mark.parametrize("bs_new", [0, 64])
def test_sample_batch_indices_matches_jax(bs_new):
    rng = np.random.default_rng(3)
    jp = jpl.init_pool(5000, 2000, 1)
    coords, sdf, w, mask, is_new = _batch(rng, 2000)
    jp = jpl.append_samples(
        jp, jnp.asarray(coords), jnp.asarray(sdf), jnp.asarray(w), jnp.asarray(mask), 0,
        jnp.asarray(is_new), key=jax.random.PRNGKey(0),
    )
    tp = pool_from_numpy(_leaves(jp), "cpu")
    key = jax.random.PRNGKey(9)
    want = np.asarray(jpl.sample_batch_indices(jp, key, 512, bs_new))
    k1, k2 = jax.random.split(key)
    hi = max(int(jp.size), 1)
    draws = (
        np.asarray(jax.random.randint(k1, (512,), 0, hi)),
        np.asarray(jax.random.randint(k2, (bs_new,), 0, max(int(jp.new_count), 1))) if bs_new else None,
    )
    np.testing.assert_array_equal(n(tpl.sample_batch_indices(tp, 512, bs_new, draws=draws)), want)
    import torch

    g = torch.Generator().manual_seed(0)
    drawn = n(tpl.sample_batch_indices(tp, 512, bs_new, generator=g))
    assert drawn.min() >= 0 and drawn.max() < hi


def test_ordered_cumsum_is_the_float64_prefix_sum():
    """The eviction draw's prefix sum is exact to float32: it equals the
    float64 prefix sum rounded once (what torch.cumsum gives on the CPU),
    and jnp.cumsum within float32 summation error (rtol 1e-5)."""
    from clid_slam_torch.ops.scatter import ordered_cumsum

    e = -np.log(np.random.default_rng(3).uniform(1e-6, 1.0, 20001)).astype(np.float32)
    got = n(ordered_cumsum(t(e)))
    np.testing.assert_array_equal(got, np.cumsum(e.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(got, n(torch.cumsum(t(e), 0)))
    np.testing.assert_allclose(got, np.asarray(jnp.cumsum(jnp.asarray(e))), rtol=1e-5)
