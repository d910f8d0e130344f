"""Decoder and encoder parity: JAX-initialised params converted with
clid_slam_torch.convert.mlp_from_numpy give the same outputs (atol 1e-6),
the occupancy, semantic and color heads too. In bf16 (bf16 operands, f32
accumulation) the two packages differ only in the order of each sum, where
a hidden activation on a bf16 rounding boundary may round the other way:
the relative error's 99th percentile within 1e-5 and the largest within
2^-7 of the output's scale."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import mlp_from_numpy
from clid_slam_torch.models import decoder as tdec
from clid_slam_torch.ops import encoding as tenc
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.ops import encoding as jenc
from torch_parity import n, t


@pytest.mark.parametrize("levels,leaky", [(1, False), (2, False), (1, True)])
def test_sdf_decoder_matches_jax(levels, leaky):
    params = jdec.init_mlp(jax.random.PRNGKey(levels), 11, 64, levels, 1, True)
    mlp = mlp_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    x = np.random.default_rng(0).normal(0, 1.0, (257, 11)).astype(np.float32)
    want = np.asarray(jdec.sdf(params, jnp.asarray(x), 0.055, leaky=leaky))
    got = n(tdec.sdf(mlp, t(x), 0.055, leaky=leaky))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        n(tdec.mlp_forward(mlp, t(x), leaky=leaky)),
        np.asarray(jdec.mlp_forward(params, jnp.asarray(x), leaky=leaky)),
        atol=1e-6, rtol=0,
    )


def _bf16_case(levels, out_dim=1):
    params = jdec.init_mlp(jax.random.PRNGKey(levels + 7), 11, 64, levels, out_dim, True)
    mlp = mlp_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    x = np.random.default_rng(levels).normal(0, 1.0, (2048, 11)).astype(np.float32)
    return params, mlp, x


def _assert_bf16_close(got, want):
    scale = np.abs(want).max()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * scale)
    assert np.quantile(rel, 0.99) <= 1e-5, np.quantile(rel, 0.99)
    assert np.abs(got - want).max() <= 2.0**-7 * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("levels,leaky", [(1, False), (2, False), (1, True)])
def test_bf16_mlp_forward_matches_jax(levels, leaky):
    params, mlp, x = _bf16_case(levels)
    want = np.asarray(jdec.mlp_forward(params, jnp.asarray(x), leaky=leaky, bf16=True))
    got = tdec.mlp_forward(mlp, t(x), leaky=leaky, bf16=True)
    assert got.dtype == torch.float32
    _assert_bf16_close(n(got), want)
    # not the f32 decoder: the bf16 rounding shows
    f32 = np.asarray(jdec.mlp_forward(params, jnp.asarray(x), leaky=leaky))
    assert np.abs(f32 - want).max() > 1e-4


def test_bf16_rounds_before_the_bias_as_jax_does():
    """The product accumulates in f32 before the f32 bias is added: a
    bf16 matmul output (torch.matmul of bf16 tensors) would round the sum
    first and land further from the JAX package."""
    params, mlp, x = _bf16_case(1)
    want = np.asarray(jdec.mlp_forward(params, jnp.asarray(x), bf16=True))
    bf = lambda a: a.to(torch.bfloat16)
    h = torch.relu((bf(t(x)) @ bf(mlp.weights[0])).float() + bf(mlp.biases[0]).float())
    naive = n((bf(h) @ bf(mlp.w_out)).float() + mlp.b_out)
    got = n(tdec.mlp_forward(mlp, t(x), bf16=True))
    assert np.abs(got - want).max() < np.abs(naive - want).max()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_heads_match_jax(bf16):
    x = np.random.default_rng(4).normal(0, 1.0, (1024, 11)).astype(np.float32)
    heads = (
        ("occupancy", 1, lambda m, f, **kw: m.occupancy(*f, 0.055, **kw)),
        ("sem_label_prob", 20, lambda m, f, **kw: m.sem_label_prob(*f, **kw)),
        ("regress_color", 3, lambda m, f, **kw: m.regress_color(*f, **kw)),
    )
    for name, out_dim, head in heads:
        params, mlp, _ = _bf16_case(1, out_dim)
        want = np.asarray(head(jdec, (params, jnp.asarray(x)), bf16=bf16))
        got = n(head(tdec, (mlp, t(x)), bf16=bf16))
        assert got.shape == want.shape, name
        if bf16:
            _assert_bf16_close(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)


def test_mlp_from_leaf_list():
    params = jdec.init_mlp(jax.random.PRNGKey(3), 11, 64, 2, 1, True)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    mlp = mlp_from_numpy(leaves, device="cpu")
    for got, want in zip(mlp.tensors(), leaves):
        np.testing.assert_array_equal(n(got), want)


def test_init_mlp_shapes_and_bounds():
    import torch

    g = torch.Generator().manual_seed(0)
    mlp = tdec.init_mlp(g, 11, 64, 2, 1, True, device="cpu")
    ref = jdec.init_mlp(jax.random.PRNGKey(0), 11, 64, 2, 1, True)
    for a, b in zip(mlp.tensors(), jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == tuple(np.shape(b))
    assert float(mlp.weights[0].abs().max()) <= 1 / np.sqrt(11)


# the Gaussian projection is a matmul whose f32 result feeds sin(): at
# freq 200 the argument reaches ~1e3, where one ulp (6e-5) of summation-order
# difference already moves sin() by 1e-4, so it is compared at freq 1
@pytest.mark.parametrize("gaussian,freq", [(False, 200.0), (True, 1.0)])
def test_encoder_matches_jax(gaussian, freq):
    kw = dict(num_bands=4, freq=freq, base=2.0, use_gaussian=gaussian, input_dim=3, seed=42)
    jf, jd = jenc.make_encoder(**kw)
    tf, td = tenc.make_encoder(**kw)
    assert jd == td
    x = np.random.default_rng(1).normal(0, 0.3, (50, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tf(t(x))), np.asarray(jf(jnp.asarray(x))), atol=1e-6, rtol=0
    )
    assert tenc.make_encoder(**dict(kw, num_bands=0)) == (None, 3)
