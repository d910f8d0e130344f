"""Rank-side cases of the sharded parity tests, run by ``torch_dist.run_ranks``
in spawned gloo ranks. This module imports neither JAX nor clid_slam_tpu:
its inputs are numpy arrays (the JAX side's draws and states included) and
it returns numpy arrays, which the tests compare with the JAX package's
results in the parent process."""

import numpy as np
import torch

from clid_slam_torch.convert import mlp_from_numpy, pool_from_numpy, sharded_map_to_numpy


def t(a, dtype=None):
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(x):
    return x.detach().cpu().numpy()


def mlp_leaves(mlp):
    return [n(p) for p in mlp.tensors()]


def features_of(positions, feature_dim):
    """Features that are a function of each point's position (numpy, so
    both packages compute the same bits): the parity scenes give a shard's
    points features without matching them across the two packages."""
    w = np.random.default_rng(7).normal(size=(3, feature_dim))
    p = np.asarray(positions, np.float64)
    v = p[:, 0:1] * w[0] + p[:, 1:2] * w[1] + p[:, 2:3] * w[2]  # elementwise: no BLAS order
    return (2.0 * (v - np.floor(v)) - 1.0).astype(np.float32)


def set_features(state, feature_dim):
    cnt = int(state.count)
    feats = n(state.geo_feats).copy()
    feats[:cnt] = features_of(n(state.positions)[:cnt], feature_dim)
    return state._replace(geo_feats=t(feats))


def _identity_adam(g, m, v, t_, lr, eps=1e-15, b1=0.9, b2=0.99):
    """An update of ``g`` itself: one step then returns the raw gradient."""
    return g, m, v


def _sphere(mesh, inp):
    from clid_slam_torch.parallel import spatial as sp

    kw = inp["kw"]
    insert_fn, _, _ = sp.make_spatial_fns(mesh, **kw)
    empty = sp.init_sharded_map(mesh, inp["cap"], inp["hash"], kw["feature_dim"], device="cpu")
    st, _ = insert_fn(empty, t(inp["sphere_pts"]), t(inp["sphere_mask"]), torch.zeros(8), 0, 1e9)
    return st


def spatial_query_case(mesh, inp):
    """The insert, the query and the certainty of parallel/spatial.py on
    this rank (the cluster scene), the sphere scene's masked insert, and
    the tracker update on it."""
    from clid_slam_torch.odometry import iekf
    from clid_slam_torch.parallel import spatial as sp

    kw = inp["kw"]
    F = kw["feature_dim"]
    travel = torch.zeros(8)
    out = {}

    def new_map():
        return sp.init_sharded_map(mesh, inp["cap"], inp["hash"], F, device="cpu")

    insert_fn, query_fn, _ = sp.make_spatial_fns(mesh, **kw)
    st, ratio = insert_fn(new_map(), t(inp["insert_pts"]), torch.ones(len(inp["insert_pts"]),
                          dtype=torch.bool), travel, 0, 1e9)
    out["insert"] = (sharded_map_to_numpy(st), float(ratio), sp.total_count(st, mesh))

    qst, _ = insert_fn(new_map(), t(inp["cluster_pts"]), torch.ones(len(inp["cluster_pts"]),
                       dtype=torch.bool), travel, 0, 1e9)
    qst = set_features(qst, F)
    cnt = int(qst.count)
    cert = n(qst.certainty).copy()
    cert[:cnt] = np.abs(features_of(n(qst.positions)[:cnt], 1)[:, 0])
    qst = qst._replace(certainty=t(cert))
    q = query_fn(qst, t(inp["query_pts"]), travel, 0, 1e9)
    out["query"] = {k: n(v) for k, v in q._asdict().items()}
    certainty_fn = sp.make_sharded_certainty_fn(mesh, resolution=kw["resolution"],
                                                max_valid_dist2=kw["max_valid_dist2"])
    out["certainty"] = n(certainty_fn(qst, t(inp["query_pts"])))

    sst = _sphere(mesh, inp)
    out["sphere_map"] = sharded_map_to_numpy(sst)
    body = iekf.make_cached_update_fn(**inp["tracker_kw"])
    update = sp.make_sharded_tracker_fn(mesh, body, nb_offs=kw["nb_offs"],
                                        resolution=kw["resolution"],
                                        max_valid_dist2=kw["max_valid_dist2"])
    pts, mask, rot0, pos0, rest0, P = inp["tracker_args"]
    res = update(set_features(sst, F), mlp_from_numpy(inp["mlp"], "cpu"), t(pts), t(mask),
                 t(rot0), t(pos0), t(rest0), t(P), travel, 0, 1e9)
    out["tracker"] = [n(r) for r in res]
    return out


def spatial_mapping_case(mesh, inp):
    """The three mapping bodies of parallel/spatial.py on the sphere scene
    (the cached one twice, for repeatability) and one step of each with the
    update replaced by the raw gradient."""
    from clid_slam_torch.mapping import mapper as mp
    from clid_slam_torch.parallel import spatial as sp

    sst = _sphere(mesh, inp)
    pool = pool_from_numpy(inp["pool"], "cpu")
    mlp = mlp_from_numpy(inp["mlp"], "cpu")

    def map_run(batch_shard, iters, draws):
        _, _, mapping_fn = sp.make_spatial_fns(mesh, batch_shard=batch_shard, **inp["kw"])
        s2, m2, losses = mapping_fn(sst, mlp, pool, torch.zeros(8), 0, 1e9, iters, 1.0,
                                    batch_draws=draws)
        return dict(geo_feats=n(s2.geo_feats), certainty=n(s2.certainty),
                    ts_update=n(s2.ts_update), mlp=mlp_leaves(m2), losses=n(losses))

    bodies = (("cached", "cached"), ("sharded_batch", True), ("replicated", False))
    out = {"mapping": {name: map_run(b, inp["iters"], inp["draws"][name]) for name, b in bodies}}
    out["cached_again"] = map_run("cached", inp["iters"], inp["draws"]["cached"])
    saved = mp._adam_update
    mp._adam_update = _identity_adam
    try:
        out["raw_grads"] = {name: map_run(b, 1, inp["draws"][name][:1]) for name, b in bodies}
    finally:
        mp._adam_update = saved
    return out


def dp_case(mesh, inp):
    """make_dp_mapping_fn twice on the same inputs (the second for
    repeatability) and shard_batch_pipeline."""
    from clid_slam_torch.convert import neural_map_from_numpy
    from clid_slam_torch.parallel import data_parallel as dp

    mapping = dp.make_dp_mapping_fn(mesh, **inp["kw"])
    state = neural_map_from_numpy(inp["map"], "cpu")
    pool = pool_from_numpy(inp["pool"], "cpu")
    mlp = mlp_from_numpy(inp["mlp"], "cpu")
    runs = []
    for _ in range(2):
        s2, m2, losses = mapping(state, mlp, pool, torch.zeros(8), 0, 1e9, inp["iters"], 1.0,
                                 batch_draws=inp["draws"])
        runs.append(dict(geo_feats=n(s2.geo_feats), certainty=n(s2.certainty),
                         ts_update=n(s2.ts_update), mlp=mlp_leaves(m2), losses=n(losses)))
    a, b = dp.shard_batch_pipeline(mesh, [t(x) for x in inp["pipeline"]])
    return dict(runs=runs, pipeline=[n(a), n(b)])


def collectives_case(mesh, inp):
    """Forward and backward of psum, psum_scatter and all_gather on this
    rank's rows of ``inp["x"]`` ([S, n, m]), each under the loss of
    ``inp["w"]`` (the JAX side differentiates the same losses), and pmax."""
    from clid_slam_torch.parallel import collectives as c

    out = {}
    for name, fn in (("psum", c.psum), ("psum_scatter", c.psum_scatter),
                     ("all_gather", c.all_gather)):
        x = t(inp["x"][mesh.rank]).requires_grad_(True)
        y = fn(x, mesh)
        (g,) = torch.autograd.grad(torch.sum(y * y * t(inp["w"][name])), x)
        out[name] = (n(y), n(g))
    out["pmax"] = n(c.pmax(t(inp["x"][mesh.rank]), mesh))
    out["psum_int"] = n(c.psum(t(inp["x"][mesh.rank]).to(torch.int32), mesh))
    return out


def raise_case(mesh, inp):
    """Rank 1 raises; the others wait in a collective."""
    from clid_slam_torch.parallel import collectives as c

    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return n(c.psum(torch.ones(3), mesh))


def hang_case(mesh, inp):
    """Rank 0 enters a collective that rank 1 never joins."""
    import time

    from clid_slam_torch.parallel import collectives as c

    if mesh.rank == 0:
        return n(c.psum(torch.ones(3), mesh))
    time.sleep(inp["sleep_s"])
    return None
