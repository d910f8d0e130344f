"""The port's collectives (clid_slam_torch/parallel/collectives.py) on 2 and
4 spawned gloo ranks, and the rank harness (tests/torch_dist.py) itself.

- ``psum``, ``psum_scatter`` and ``all_gather``, forward and backward,
  against ``jax.lax``'s inside ``shard_map(..., check_vma=False)`` on as
  many virtual CPU devices, under the same losses: the backward is JAX's
  transpose (``psum`` for ``psum``, ``all_gather`` for ``psum_scatter``,
  ``psum_scatter`` for ``all_gather``), factor of S included. rtol 1e-6.
- Float sums are in rank order: ``psum`` equals the sequential sum rank 0
  first, bit for bit, on every rank; integer sums and ``pmax`` exact.
- A rank that raises fails its test at once with its traceback, a rank
  left alone in a collective fails it at the process group's timeout, and
  ranks that never end fail it at the join's deadline.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from clid_slam_tpu.parallel import spatial as jsp
from torch_dist import Ranks, run_ranks

N, M = 8, 3
OPS = {
    "psum": lambda v: jax.lax.psum(v, "sp"),
    "psum_scatter": lambda v: jax.lax.psum_scatter(v, "sp", scatter_dimension=0, tiled=True),
    "all_gather": lambda v: jax.lax.all_gather(v, "sp"),
}


def _inputs(S):
    rng = np.random.default_rng(S)
    x = rng.normal(size=(S, N, M)).astype(np.float32)
    w = {"psum": rng.normal(size=(N, M)), "psum_scatter": rng.normal(size=(N // S, M)),
         "all_gather": rng.normal(size=(S, N, M))}
    return dict(x=x, w={k: v.astype(np.float32) for k, v in w.items()})


def _jax_side(S, inp):
    mesh = jsp.make_spatial_mesh(S)
    out = {}
    for name, op in OPS.items():
        w = jnp.asarray(inp["w"][name])

        def body(xl, wl, op=op):
            xl = xl[0]
            g = jax.grad(lambda v: jnp.sum(op(v) * op(v) * wl))(xl)
            return op(xl)[None], g[None]

        y, g = shard_map(body, mesh=mesh, in_specs=(P("sp"), P()), out_specs=(P("sp"), P("sp")),
                         check_vma=False)(jnp.asarray(inp["x"]), w)
        out[name] = (np.asarray(y), np.asarray(g))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda s: f"S{s}")
def run(request, tmp_path_factory):
    S = request.param
    inp = _inputs(S)
    ranks = Ranks("torch_sharded_ranks:collectives_case", S, inp,
                  tmp_path_factory.mktemp(f"coll{S}"))
    try:
        jx = _jax_side(S, inp)
    except BaseException:
        ranks.kill()
        raise
    return S, inp, jx, ranks.join()


@pytest.mark.parametrize("name", list(OPS))
def test_forward_and_backward_match_jax_transposes(run, name):
    S, inp, jx, port = run
    y_want, g_want = jx[name]
    for r in range(S):
        y, g = port[r][name]
        np.testing.assert_allclose(y, y_want[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, g_want[r], rtol=1e-6, atol=1e-6)


def test_psum_sums_in_rank_order_on_every_rank(run):
    S, inp, jx, port = run
    want = inp["x"][0]
    for r in range(1, S):
        want = want + inp["x"][r]  # float32, rank 0 first
    for r in range(S):
        np.testing.assert_array_equal(port[r]["psum"][0], want)
        chunk = slice(r * N // S, (r + 1) * N // S)
        np.testing.assert_array_equal(port[r]["psum_scatter"][0], want[chunk])
        np.testing.assert_array_equal(port[r]["all_gather"][0], inp["x"])
        np.testing.assert_array_equal(port[r]["pmax"], inp["x"].max(0))
        np.testing.assert_array_equal(port[r]["psum_int"], inp["x"].astype(np.int32).sum(0))


def test_a_raising_rank_fails_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks("torch_sharded_ranks:raise_case", 2, {}, tmp_path, deadline_s=60)
    assert time.monotonic() - t0 < 30


def test_a_rank_alone_in_a_collective_fails_at_the_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        run_ranks("torch_sharded_ranks:hang_case", 2, {"sleep_s": 120}, tmp_path,
                  deadline_s=60, timeout_s=3)
    assert time.monotonic() - t0 < 30


def test_ranks_that_never_end_fail_at_the_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks("torch_sharded_ranks:hang_case", 2, {"sleep_s": 120}, tmp_path,
                  deadline_s=8, timeout_s=60)
    assert time.monotonic() - t0 < 20
