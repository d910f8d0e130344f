"""Mapper parity with the JAX batch draws injected: the fast tracked-frame
body (max_outer=1, dup_independent; the port runs the fused loop's plain
version here, JAX its autograd loop), the autograd fallback of that body
for configs the kernel does not take, the static single-batch body
(dup_independent off) and the general multi-batch body of frame 0 (Adam
moments carried across batches). Tolerances as for the map
loop: features and MLP max diff < 3 lr and 99th percentile < 2.5 lr,
losses rtol 5e-2; certainty rtol 1e-5, update timestamps exact. Each of
the three bodies also with the color and semantic heads on a labelled
pool, decode-then-weight and bf16 decoding (the autograd loop on both
sides): losses rtol 1e-4 (bf16 1e-2), the three MLPs and both feature
slabs at the tolerances above."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy, pool_from_numpy
from clid_slam_torch.mapping import mapper as tmp
from clid_slam_tpu.mapping import mapper as jmp
from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.ops.voxel import neighbor_offsets
from torch_parity import n, t

RES = 0.3
LR = 0.01
BS, BS_NEW = 1024, 128
MAP_KW = dict(
    feature_dim=8, knn_k=6, nb_offs=neighbor_offsets(2, 0.5), resolution=RES,
    max_valid_dist2=3.0 * (3 * RES) ** 2, sdf_scale=0.055, sigma=0.055, bs=BS,
    bs_new=BS_NEW, gradient_decimation=10, num_grad_eps=0.06, weight_e=0.5,
    loss_weight_on=True, lr=LR, adam_eps=1e-15,
)


def _scene(feature_dim=8):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(6000, 3))
    d[:, 2] *= 0.4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    box = np.array([3.0, 2.5, 1.5])
    surf = d * np.min(box / np.abs(d), axis=1)[:, None]
    td = jnp.zeros((8,), jnp.float32)
    ms = jnm.init_map(1 << 13, 1 << 15, feature_dim)
    ms, _ = jnm.insert_points(
        ms, jnp.asarray(surf.astype(np.float32)), jnp.ones(6000, bool), RES, td, 0, 1e9
    )
    c = int(ms.count)
    ms = ms._replace(geo_feats=ms.geo_feats.at[:c].set(
        jnp.asarray(rng.normal(0, 0.1, (c, feature_dim)).astype(np.float32))
    ))
    disp = rng.normal(0, 0.2, (6000, 1))
    coords = (surf * (1 + disp / np.linalg.norm(surf, axis=1, keepdims=True))).astype(np.float32)
    pool = jpl.init_pool(1 << 14, 6000, 1)
    pool = jpl.append_samples(
        pool, jnp.asarray(coords), jnp.asarray(-disp[:, 0].astype(np.float32)),
        jnp.asarray(rng.uniform(-1, 1.4, 6000).astype(np.float32)),
        jnp.asarray(rng.uniform(size=6000) < 0.95), 1,
        jnp.asarray(rng.uniform(size=6000) < 0.3), key=jax.random.PRNGKey(0),
    )
    mlp = jdec.init_mlp(jax.random.PRNGKey(2), feature_dim + 3, 64, 1, 1, True)
    return ms, pool, mlp, td


def _draws(pool, kb):
    k1, k2 = jax.random.split(kb)
    return (
        np.asarray(jax.random.randint(k1, (BS,), 0, max(int(pool.size), 1))),
        np.asarray(jax.random.randint(k2, (BS_NEW,), 0, max(int(pool.new_count), 1))),
    )


def _close(got, want, scale=1.0):
    d = np.abs(n(got) - np.asarray(want))
    assert d.max() < 3.0 * LR * scale + 1e-6, d.max()
    assert np.quantile(d, 0.99) < 2.5 * LR * scale + 1e-6


# the single-batch bodies beside the kernel path (use_pallas, as
# cfg.map_pallas passes it): the autograd fallback on the expanded features
# (a loss or a feature width the kernel does not take, or use_pallas off)
# and the static body on the work slab (dup_independent off)
SINGLE = dict(resample_every=20, max_outer=1)
KERNEL = dict(SINGLE, dup_independent=True, use_pallas=True)
BODIES = {
    "fast": KERNEL,
    "general": dict(resample_every=3),
    "fallback_zhong": dict(KERNEL, loss_type="zhong"),
    "fallback_feature_dim4": dict(KERNEL, feature_dim=4),
    "fallback_feature_dim6": dict(KERNEL, feature_dim=6),
    # map_pallas off: the autograd loop on the expanded features, no warning
    "no_pallas": dict(SINGLE, dup_independent=True),
    "static_feature_dim6": dict(SINGLE, dup_independent=False, feature_dim=6),
    "static": dict(SINGLE, dup_independent=False),
    "static_sdf_l2": dict(SINGLE, dup_independent=False, loss_type="sdf_l2"),
}


def _run_both(kw, iters, n_batches):
    """The JAX mapping body and the port's on the same scene and draws."""
    ms, pool, mlp, td = _scene(kw["feature_dim"])
    key = jax.random.PRNGKey(5)
    draws, k = [], key
    for _ in range(n_batches):
        k, kb = jax.random.split(k)
        draws.append(_draws(pool, kb))
    tmap = neural_map_from_numpy([np.asarray(x) for x in ms], "cpu")
    tpool = pool_from_numpy([np.asarray(x) for x in pool], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, mlp), "cpu")
    geo0 = np.asarray(ms.geo_feats)
    # the JAX side runs its XLA loop, as its frame step does off the TPU
    jkw = {k: v for k, v in kw.items() if k != "use_pallas"}
    jres = jmp.make_mapping_fn(**jkw, as_body=True)(
        ms, mlp, mlp, mlp, pool, td, 1, 1e9, key, jnp.int32(iters), jnp.float32(1.0)
    )
    tres = tmp.make_mapping_fn(**kw)(
        tmap, tmlp, tmlp, tmlp, tpool, t(td), 1, 1e9, iters, 1.0, batch_draws=draws
    )
    return geo0, (jres[0], jres[1], jres[4]), (tres[0], tres[1], tres[4])


def _assert_mapping_close(geo0, jres, tres):
    (jstate, jmlp, jloss), (tstate, tmlp2, tloss) = jres, tres
    _close(tstate.geo_feats, jstate.geo_feats)
    assert np.abs(np.asarray(jstate.geo_feats) - geo0).max() > 5 * LR
    for got, want in zip(tmlp2.tensors(), jax.tree_util.tree_leaves(jmlp)):
        _close(got, want)
    np.testing.assert_allclose(n(tloss), np.asarray(jloss), rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(n(tstate.certainty), np.asarray(jstate.certainty), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(tstate.ts_update), np.asarray(jstate.ts_update))
    assert float(tstate.certainty.sum()) > 100
    assert not tstate.geo_feats.requires_grad


@pytest.mark.parametrize("body", sorted(BODIES))
def test_mapping_body_matches_jax(body):
    kw = dict(MAP_KW, **BODIES[body])
    general = body == "general"
    geo0, jres, tres = _run_both(kw, 8 if general else 7, 3 if general else 1)
    _assert_mapping_close(geo0, jres, tres)


def test_ineligible_fast_body_raises():
    """A config the fused kernel does not take (leaky ReLU) runs the
    autograd loop on the expanded features, as the JAX package's XLA loop
    does, and says so in a RuntimeWarning that names the reasons."""
    kw = dict(KERNEL, mlp_leaky=True, **MAP_KW)
    with pytest.warns(RuntimeWarning, match="mlp_leaky_relu"):
        geo0, jres, tres = _run_both(kw, 7, 1)
    _assert_mapping_close(geo0, jres, tres)
    assert tmp.pallas_ineligible_reasons(
        color_on=False, sem_on=False, weighted_first=True, mlp_bf16=False,
        mlp_leaky=False, loss_type="bce", feature_dim=8, n_hidden=3,
    ) == jmp.pallas_ineligible_reasons(
        color_on=False, sem_on=False, weighted_first=True, mlp_bf16=False,
        mlp_leaky=False, loss_type="bce", feature_dim=8, n_hidden=3,
    ) == ["geo_mlp_level=3"]


def test_feature_dim_6_builds_and_only_the_fused_kernel_refuses_it():
    """The row-gather kernel moves single floats where a row is not a
    multiple of 4 floats, so a feature_dim-6 mapper builds (and maps as JAX
    does: the ``*_feature_dim6`` cases of test_mapping_body_matches_jax);
    only the fused kernel's own eligibility rule names the width."""
    tmp.make_mapping_fn(**dict(MAP_KW, feature_dim=6))
    assert tmp.pallas_ineligible_reasons(
        color_on=False, sem_on=False, weighted_first=True, mlp_bf16=False,
        mlp_leaky=False, loss_type="bce", feature_dim=6, n_hidden=1,
    ) == ["feature_dim=6"]


def test_sdf_loss_keeps_optax_gradient_where_logit_and_target_saturate():
    """The autograd loop's logistic loss has the gradient of the JAX
    package's loss (optax's ``sigmoid_binary_cross_entropy``), also in free
    space far in front of a surface, where the logit z and the target
    saturate together (label / sigma and z past ~17, the target rounds to
    1): there it is -sigmoid(-z), a few 1e-9 and not 0, and Adam (eps
    1e-15) steps on it. The fused kernel rounds it to 0 as the JAX Pallas
    kernel does (``test_torch_map_loop.py``), and so does the loss of
    frame 0's general body (``saturated_grad=False``)."""
    rng = np.random.default_rng(5)
    sigma = 0.055
    label = rng.uniform(-0.5, 2.0, 512).astype(np.float32)
    pred = (label + rng.normal(0, 0.05, 512)).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 512).astype(np.float32)
    bvalid = (rng.uniform(size=512) < 0.9).astype(np.float32)
    kw = dict(loss_type="bce", sigma=sigma, loss_weight_on=True)
    jloss = jmp.make_sdf_loss(jnp.asarray(label), jnp.asarray(weight), jnp.asarray(bvalid), **kw)
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(pred)))
    p = t(pred).requires_grad_(True)
    tl = tmp.make_sdf_loss(t(label), t(weight), t(bvalid), **kw)(p)
    tl.backward()
    tg = n(p.grad)
    np.testing.assert_allclose(n(tl), np.asarray(jloss(jnp.asarray(pred))), rtol=1e-6)
    saturated = (label / sigma > 17) & (pred / sigma > 17) & (bvalid > 0)
    assert saturated.sum() > 100 and np.all(jg[saturated] < 0)
    np.testing.assert_allclose(tg[saturated], jg[saturated], rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6 * np.abs(jg).max())
    p = t(pred).requires_grad_(True)
    tmp.make_sdf_loss(t(label), t(weight), t(bvalid), saturated_grad=False, **kw)(p).backward()
    assert np.all(n(p.grad)[saturated] == 0)
    np.testing.assert_allclose(n(p.grad)[~saturated], jg[~saturated], rtol=1e-4,
                               atol=1e-5 * np.abs(jg).max())


OPTIONS = {
    "color_sem": dict(color_on=True, sem_on=True),
    "decode_then_weight": dict(weighted_first=False),
    "bf16": dict(mlp_bf16=True),
}
OPTION_BODIES = {"fast": BODIES["fast"], "static": BODIES["static"], "general": BODIES["general"]}


def _labelled_scene():
    """The box scene with a color slab, a pool of colors (from the azimuth)
    and classes (1..4 by quadrant, 0 in free space and on a tenth of the
    surface samples), and color and semantic MLPs."""
    ms, _, mlp, td = _scene()
    rng = np.random.default_rng(1)
    c = int(ms.count)
    cf = np.zeros((ms.positions.shape[0], 8), np.float32)
    cf[:c] = rng.normal(0, 0.1, (c, 8))
    ms = ms._replace(color_feats=jnp.asarray(cf))
    d = rng.normal(size=(6000, 3))
    d[:, 2] *= 0.4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    surf = d * np.min(np.array([3.0, 2.5, 1.5]) / np.abs(d), axis=1)[:, None]
    disp = rng.normal(0, 0.2, (6000, 1))
    coords = (surf * (1 + disp / np.linalg.norm(surf, axis=1, keepdims=True))).astype(np.float32)
    az = np.arctan2(surf[:, 1], surf[:, 0]) + np.pi
    color = (0.5 * (np.sin(2 * az) + 1)).astype(np.float32)[:, None]
    sem = (az // (np.pi / 2)).astype(np.int32).clip(0, 3) + 1
    sem[(np.abs(disp[:, 0]) > 0.25) | (rng.uniform(size=6000) < 0.1)] = 0
    pool = jpl.init_pool(1 << 14, 6000, 1)
    pool = jpl.append_samples(
        pool, jnp.asarray(coords), jnp.asarray(-disp[:, 0].astype(np.float32)),
        jnp.asarray(rng.uniform(-1, 1.4, 6000).astype(np.float32)),
        jnp.asarray(rng.uniform(size=6000) < 0.95), 1,
        jnp.asarray(rng.uniform(size=6000) < 0.3), key=jax.random.PRNGKey(0),
        color=jnp.asarray(color), sem=jnp.asarray(sem),
    )
    color_mlp = jdec.init_mlp(jax.random.PRNGKey(3), 11, 64, 1, 1, True)
    sem_mlp = jdec.init_mlp(jax.random.PRNGKey(4), 11, 64, 1, 5, True)
    return ms, pool, (mlp, color_mlp, sem_mlp), td


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("body", sorted(OPTION_BODIES))
def test_mapping_body_with_option_matches_jax(body, option):
    """Each body with the color and semantic heads, with decode-then-weight
    and with bf16 decoding, fed the JAX batch draws: none of these is in the
    fused kernel, so both packages run their autograd loops."""
    import warnings

    kw = dict(MAP_KW, **OPTION_BODIES[body], **OPTIONS[option])
    general = body == "general"
    iters, n_batches = (8, 3) if general else (7, 1)
    ms, pool, mlps, td = _labelled_scene()
    key = jax.random.PRNGKey(5)
    draws, k = [], key
    for _ in range(n_batches):
        k, kb = jax.random.split(k)
        draws.append(_draws(pool, kb))
    tmap = neural_map_from_numpy([np.asarray(x) for x in ms], "cpu")
    tpool = pool_from_numpy([np.asarray(x) for x in pool], "cpu")
    tmlps = [mlp_from_numpy(jax.tree.map(np.asarray, m), "cpu") for m in mlps]
    geo0, col0 = np.asarray(ms.geo_feats), np.asarray(ms.color_feats)
    # the JAX side runs its XLA loop, as its frame step does off the TPU
    jkw = {k: v for k, v in kw.items() if k != "use_pallas"}
    jres = jmp.make_mapping_fn(**jkw, as_body=True)(
        ms, *mlps, pool, td, 1, 1e9, key, jnp.int32(iters), jnp.float32(1.0)
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the autograd loop, by design
        tres = tmp.make_mapping_fn(**kw)(
            tmap, *tmlps, tpool, t(td), 1, 1e9, iters, 1.0, batch_draws=draws
        )
    (jstate, *jm, jloss), (tstate, *tm, tloss) = jres, tres
    np.testing.assert_allclose(n(tloss), np.asarray(jloss), rtol=1e-2 if option == "bf16" else 1e-4)
    _close(tstate.geo_feats, jstate.geo_feats)
    _close(tstate.color_feats, jstate.color_feats)
    assert np.abs(np.asarray(jstate.geo_feats) - geo0).max() > 5 * LR
    for i, (got, want) in enumerate(zip(tm, jm)):
        for a, b in zip(got.tensors(), jax.tree_util.tree_leaves(want)):
            _close(a, b)
        moved = max(float(np.abs(np.asarray(b) - np.asarray(c)).max()) for b, c in
                    zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(mlps[i])))
        # a head that is off is neither decoded nor updated
        on = i == 0 or (option == "color_sem")
        assert (moved > LR) if on else (moved == 0.0), (i, moved)
    moved_c = np.abs(np.asarray(jstate.color_feats) - col0).max()
    assert (moved_c > 5 * LR) if option == "color_sem" else (moved_c == 0.0)
    np.testing.assert_allclose(n(tstate.certainty), np.asarray(jstate.certainty), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(tstate.ts_update), np.asarray(jstate.ts_update))
