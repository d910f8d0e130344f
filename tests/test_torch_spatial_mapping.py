"""Parity of the sharded map's three mapping bodies
(clid_slam_torch/parallel/spatial.py ``make_spatial_fns``' mapping_fn) on 2
and 4 spawned gloo ranks against the JAX package's shard_map bodies on as
many virtual CPU devices: tests/test_spatial.py's sphere scene, the same
pool, MLP and batch draws (the JAX key chain's, handed to the ranks),
5 Adam steps.

Tolerances:
- each body against JAX's, and the port's batch-sharded body against its
  replicated one: JAX's own (test_spatial.py:222), rtol 2e-3 / atol 2e-4 on
  the losses, features and MLP, atol 2e-3 on the certainty; update stamps
  exact;
- the raw gradients of one step (the update replaced by the gradient
  itself), which carry JAX's factor of S through the collectives'
  transposes: rtol 1e-4, atol 1e-6 of the largest entry;
- the MLP and losses, replicated: the same bits on every rank; a repeat of
  the cached body: bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from clid_slam_tpu.mapping import mapper as jmp
from clid_slam_tpu.parallel import spatial as jsp
from torch_dist import Ranks
from torch_spatial_scenes import BODIES, CAP, F, HASH, ITERS, KW, scenes


def _jax_side(S, inp, pool, mlp):
    mesh = jsp.make_spatial_mesh(S)
    travel = jnp.zeros((8,), jnp.float32)
    insert_fn, _, _ = jsp.make_spatial_fns(mesh, **KW)
    sst, _ = insert_fn(jsp.init_sharded_map(mesh, CAP, HASH, F), jnp.asarray(inp["sphere_pts"]),
                       jnp.asarray(inp["sphere_mask"]), travel, 0, 1e9)

    def map_run(batch_shard, iters):
        _, _, mapping_fn = jsp.make_spatial_fns(mesh, batch_shard=batch_shard, **KW)
        s2, m2, losses = mapping_fn(jax.tree.map(jnp.copy, sst), mlp, pool, travel, 0, 1e9,
                                    jax.random.PRNGKey(2), iters, 1.0)
        return dict(geo_feats=np.asarray(s2.geo_feats), certainty=np.asarray(s2.certainty),
                    ts_update=np.asarray(s2.ts_update),
                    mlp=[np.asarray(a) for a in jax.tree.leaves(m2)], losses=np.asarray(losses))

    out = {"mapping": {name: map_run(b, ITERS) for name, b in BODIES.items()}}
    saved = jmp._adam_update
    jmp._adam_update = lambda g, st_, t_, lr, eps=1e-15: (g, st_)  # the raw gradient
    try:
        out["raw_grads"] = {name: map_run(b, 1) for name, b in BODIES.items()}
    finally:
        jmp._adam_update = saved
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda s: f"S{s}")
def run(request, tmp_path_factory):
    """(S, inputs, JAX's results, the ranks' results): the ranks run while
    the JAX side computes."""
    S = request.param
    inp, pool, mlp = scenes()
    ranks = Ranks("torch_sharded_ranks:spatial_mapping_case", S, inp,
                  tmp_path_factory.mktemp(f"spatial_mapping{S}"))
    try:
        jax_out = _jax_side(S, inp, pool, mlp)
    except BaseException:
        ranks.kill()
        raise
    return S, inp, jax_out, ranks.join()


def _close(got, want, rank, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3, atol=2e-4,
                               err_msg=what)
    wf = want["geo_feats"] if rank is None else want["geo_feats"][rank]
    np.testing.assert_allclose(got["geo_feats"], wf, rtol=2e-3, atol=2e-4, err_msg=what)
    for a, b in zip(got["mlp"], want["mlp"]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=what)
    wc = want["certainty"] if rank is None else want["certainty"][rank]
    np.testing.assert_allclose(got["certainty"], wc, rtol=2e-3, atol=2e-3, err_msg=what)


@pytest.mark.parametrize("body", list(BODIES))
def test_mapping_body_matches_jax(run, body):
    S, inp, jx, port = run
    want = jx["mapping"][body]
    for r in range(S):
        got = port[r]["mapping"][body]
        _close(got, want, r, body)
        np.testing.assert_array_equal(got["ts_update"], want["ts_update"][r])
        # the MLP and the losses are replicated: the same bits on every rank
        ref = port[0]["mapping"][body]
        for a, b in zip(got["mlp"] + [got["losses"]], ref["mlp"] + [ref["losses"]]):
            np.testing.assert_array_equal(a, b)
    assert np.isfinite(want["losses"]).all()
    assert np.abs(port[0]["mapping"][body]["geo_feats"]).max() > 0  # the features moved
    assert sum(port[r]["mapping"][body]["certainty"].sum() for r in range(S)) > 0


@pytest.mark.parametrize("body", list(BODIES))
def test_raw_gradients_match_jax(run, body):
    """One step with the update replaced by the gradient: the feature and
    MLP gradients themselves, JAX's factor of S through the collectives'
    transposes included."""
    S, inp, jx, port = run
    want = jx["raw_grads"][body]
    for r in range(S):
        got = port[r]["raw_grads"][body]
        gw = want["geo_feats"][r]
        assert np.abs(gw).max() > 0
        np.testing.assert_allclose(got["geo_feats"], gw, rtol=1e-4, atol=1e-6 * np.abs(gw).max())
        for a, b, p0 in zip(got["mlp"], want["mlp"], inp["mlp"]):
            gm = b - p0
            np.testing.assert_allclose(a - p0, gm, rtol=1e-4, atol=1e-6 * np.abs(gm).max())


def test_raw_gradients_carry_the_factor_of_s(run):
    """The batch-sharded body ``psum``s its loss, whose transpose multiplies
    the cotangent by S, and sums the MLP gradients over ranks; the
    replicated body decodes the whole batch on every rank with no collective
    on the MLP's path. On the same first batch the former's MLP gradient is
    S times the latter's (rtol 2e-3), as in JAX."""
    S, inp, jx, port = run
    shb, rep = port[0]["raw_grads"]["sharded_batch"], port[0]["raw_grads"]["replicated"]
    for a, b, p0 in zip(shb["mlp"], rep["mlp"], inp["mlp"]):
        want = S * (b - p0)
        np.testing.assert_allclose(a - p0, want, rtol=2e-3, atol=1e-5 * np.abs(want).max())


def test_cached_body_repeats_bit_for_bit(run):
    S, inp, jx, port = run
    for r in range(S):
        a, b = port[r]["mapping"]["cached"], port[r]["cached_again"]
        for k in ("geo_feats", "certainty", "ts_update", "losses"):
            np.testing.assert_array_equal(a[k], b[k])
        for x, y in zip(a["mlp"], b["mlp"]):
            np.testing.assert_array_equal(x, y)


def test_batch_sharded_matches_replicated(run):
    """test_spatial.py:177 on the port: the batch-sharded body against the
    replicated one at JAX's tolerances (the collectives' gradient routing:
    every chunk's feature cotangent reaches every owning rank)."""
    S, inp, jx, port = run
    for r in range(S):
        rep = dict(port[r]["mapping"]["replicated"])
        _close(port[r]["mapping"]["sharded_batch"], rep, None, "sharded_batch vs replicated")
