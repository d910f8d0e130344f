"""Parity of the data-parallel mapper (clid_slam_torch/parallel/
data_parallel.py) on 1, 2 and 4 spawned gloo ranks: against the JAX
package's ``make_dp_mapping_fn`` on 2 and 4 of the conftest's virtual CPU
devices (tests/test_parallel.py's scene, the JAX key chain's batch draws
handed to the ranks, 3 iterations), against the port's own single rank,
and against itself on a repeat.

JAX's version is the single-device math partitioned by XLA; the port sums
partials over ranks in rank order, so only the order of float sums
differs. Tolerances: features and MLP rtol 1e-3 / atol 1e-5 (Adam's steps
are about lr = 0.01; a step of a gradient at rounding level could flip, and
none does here), losses rtol 1e-5, certainty rtol 1e-5 / atol 1e-5, update
stamps exact; the repeat bit for bit, the MLP and losses the same bits on
every rank.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.ops.voxel import neighbor_offsets
from clid_slam_tpu.parallel.data_parallel import make_dp_mapping_fn, make_mesh
from torch_dist import Ranks

RES = 0.3
F = 8
BS = 512
ITERS = 3
KW = dict(
    feature_dim=F, knn_k=6, nb_offs=neighbor_offsets(2, 0.5), resolution=RES,
    max_valid_dist2=3.0 * (3 * RES) ** 2, sdf_scale=0.055, sigma=0.055, bs=BS, bs_new=0,
    gradient_decimation=8, num_grad_eps=RES * 0.2, weight_e=0.5, loss_weight_on=True,
    lr=0.01, adam_eps=1e-15,
)
SIZES = (1, 2, 4)


def _setup():
    """tests/test_parallel.py:21's map, pool and MLP."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(2000, 3)).astype(np.float32)
    state = jnm.init_map(1 << 13, 1 << 15, F)
    state, _ = jnm.insert_points(state, jnp.asarray(pts), jnp.ones((2000,), bool), RES,
                                 jnp.zeros((8,), jnp.float32), 0, 1e9)
    pool = jpl.init_pool(8192, 512)
    m = 4096
    pool = jpl.append_samples(
        pool, jnp.asarray(rng.uniform(-3, 3, (m, 3)).astype(np.float32)),
        jnp.asarray(rng.normal(0, 0.1, m).astype(np.float32)), jnp.ones((m,), jnp.float32),
        jnp.ones((m,), bool), 0, jnp.zeros((m,), bool),
    )
    mlp = jdec.init_mlp(jax.random.PRNGKey(0), F + 3, 64, 1)
    return state, pool, mlp


def _draws(pool):
    """The batch of each iteration, as JAX's mapping draws it from
    PRNGKey(1)."""
    key, out = jax.random.PRNGKey(1), []
    for _ in range(ITERS):
        key, kb = jax.random.split(key)
        k1, _ = jax.random.split(kb)
        out.append((np.asarray(jax.random.randint(k1, (BS,), 0, max(int(pool.size), 1))), None))
    return out


def _result(state, mlp, losses):
    return dict(geo_feats=np.asarray(state.geo_feats), certainty=np.asarray(state.certainty),
                ts_update=np.asarray(state.ts_update),
                mlp=[np.asarray(a) for a in jax.tree.leaves(mlp)], losses=np.asarray(losses))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's results at 1, 2 and 4 ranks (each rank's list) and
    JAX's at 2 and 4 devices; the ranks run while JAX computes."""
    state, pool, mlp = _setup()
    rng = np.random.default_rng(5)
    inp = dict(
        kw=KW, map=[np.asarray(a) for a in state], pool=[np.asarray(a) for a in pool],
        mlp=[np.asarray(a) for a in jax.tree.leaves(mlp)], iters=ITERS, draws=_draws(pool),
        pipeline=[rng.uniform(size=(64, 3)).astype(np.float32),
                  rng.uniform(size=(64,)).astype(np.float32)],
    )
    started = {S: Ranks("torch_sharded_ranks:dp_case", S, inp, tmp_path_factory.mktemp(f"dp{S}"))
               for S in SIZES}
    try:
        jx = {}
        for S in (2, 4):
            mapping = make_dp_mapping_fn(make_mesh(S), **KW)
            jx[S] = _result(*mapping(jax.tree.map(jnp.copy, state), mlp, pool,
                                     jnp.zeros((8,), jnp.float32), 0, 1e9,
                                     jax.random.PRNGKey(1), ITERS, 1.0))
    except BaseException:
        for r in started.values():
            r.kill()
        raise
    return inp, jx, {S: r.join() for S, r in started.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(got["geo_feats"], want["geo_feats"], rtol=1e-3, atol=1e-5,
                               err_msg=what)
    for a, b in zip(got["mlp"], want["mlp"]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5, err_msg=what)
    np.testing.assert_allclose(got["certainty"], want["certainty"], rtol=1e-5, atol=1e-5,
                               err_msg=what)
    np.testing.assert_array_equal(got["ts_update"], want["ts_update"], err_msg=what)


@pytest.mark.parametrize("S", [2, 4])
def test_dp_mapping_matches_jax(runs, S):
    inp, jx, port = runs
    for r in range(S):
        _close(port[S][r]["runs"][0], jx[S], f"rank {r} of {S}")


@pytest.mark.parametrize("S", [2, 4])
def test_dp_mapping_matches_the_ports_single_rank(runs, S):
    inp, jx, port = runs
    for r in range(S):
        _close(port[S][r]["runs"][0], port[1][0]["runs"][0], f"rank {r} of {S} vs 1 rank")


@pytest.mark.parametrize("S", SIZES)
def test_dp_mapping_repeats_bit_for_bit_and_agrees_across_ranks(runs, S):
    inp, jx, port = runs
    ref = port[S][0]["runs"][0]
    for r in range(S):
        for run in port[S][r]["runs"]:
            for k in ("geo_feats", "certainty", "ts_update", "losses"):
                np.testing.assert_array_equal(run[k], ref[k], err_msg=f"rank {r} {k}")
            for a, b in zip(run["mlp"], ref["mlp"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", SIZES)
def test_dp_mapping_runs(runs, S):
    """test_parallel.py:43: finite losses, the features moved."""
    inp, jx, port = runs
    got = port[S][0]["runs"][0]
    assert np.isfinite(got["losses"]).all()
    assert np.abs(got["geo_feats"]).max() > 0
    assert got["certainty"].sum() > 0


@pytest.mark.parametrize("S", SIZES)
def test_shard_batch_pipeline(runs, S):
    """test_parallel.py:106: each rank holds its rows in order, and the
    ranks' rows make up the array."""
    inp, jx, port = runs
    for i, a in enumerate(inp["pipeline"]):
        parts = [port[S][r]["pipeline"][i] for r in range(S)]
        assert all(len(p) == len(a) // S for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts), a)
