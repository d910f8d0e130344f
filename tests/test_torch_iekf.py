"""IESEKF parity: device IMU propagation (atol 1e-5), and the
candidate-cached and the re-querying iterated updates on a converted JAX
map (poses within 2e-3, as tests/test_streaming.py holds the cached update
to the re-query update), weighted-first and decode-then-weight with the
weighted SDF std gate (a gate of 10 keeps the points, 0 drops them all).
Then the host f64 filter of the classic driver: ``predict`` over 200 IMU
rows (1e-12) and ``update_iterated`` on JAX's trained cylinder room (pose
within 1e-4, the same iteration count). Last, the cached update's eager
loop on CPU tensors at each exit rule (the card's tests hold its CUDA
graph to the same loop)."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clid_slam_torch import graphs
from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy
from clid_slam_torch.mapping import pool as pl
from clid_slam_torch.mapping import prep as prp
from clid_slam_torch.models import local_map as lm
from clid_slam_torch.models import neural_map as nm
from clid_slam_torch.odometry import iekf as tie
from clid_slam_torch.pipeline import streaming as sm
from clid_slam_torch.utils import observability as obs
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.odometry import iekf as jie
from clid_slam_tpu.ops.voxel import neighbor_offsets
from clid_slam_tpu.utils import lie as jlie
from test_iekf import trained_scene  # noqa: F401  (JAX's trained cylinder room)
from test_torch_cuda import (TRACKER_EXITS, TRACKER_KW, TRACKER_OPTIONS, _exit_holds,
                             _payload_candidates, _tracker_inputs, _tracker_option)
from torch_parity import n, t


@pytest.mark.parametrize("count", [10, 64, 0])
def test_device_predict_imu_matches_jax(count):
    rng = np.random.default_rng(count)
    rot = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    pos, vel = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    bg, ba = (rng.normal(0, 0.01, 3).astype(np.float32) for _ in range(2))
    grav = np.array([0, 0, -9.81], np.float32)
    A = rng.normal(0, 0.1, (18, 18))
    P = (np.eye(18) * 0.1 + A @ A.T * 0.01).astype(np.float32)
    Q = np.diag(np.r_[np.full(6, 0.01), np.full(6, 1e-4)]).astype(np.float32)
    rows = np.zeros((64, 7), np.float32)
    rows[:, 0] = 0.01
    rows[:, 1:4] = rng.normal(0, 1.0, (64, 3)) + [0, 0, 9.81]
    rows[:, 4:7] = rng.normal(0, 0.3, (64, 3))
    args = (rot, pos, vel, bg, ba, grav, P, Q, rows)
    want = jie.device_predict_imu(*[jnp.asarray(a) for a in args], count)
    got = tie.device_predict_imu(*[t(a) for a in args], count)
    for name, g, w in zip(("rot", "pos", "vel", "bg", "ba", "grav", "P"), got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


def _scene(rng, res=0.3):
    """Neural points on a sphere with random features and a JAX-initialised
    decoder (the scene of tests/test_streaming.py)."""
    u = rng.standard_normal((4000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * 3.0).astype(np.float32)
    state = jnm.init_map(1 << 13, 1 << 15, 8)
    td = jnp.zeros((8,), jnp.float32)
    state, _ = jnm.insert_points(
        state, jnp.asarray(pts), jnp.ones((4000,), bool), res, td, 0, 1e9, downsample=False
    )
    cnt = int(state.count)
    state = state._replace(
        geo_feats=state.geo_feats.at[:cnt].set(
            0.1 * jnp.asarray(rng.standard_normal((cnt, 8)).astype(np.float32))
        )
    )
    return state, jdec.init_mlp(jax.random.PRNGKey(1), 11, 64, 1), td


def test_cached_update_matches_jax():
    rng = np.random.default_rng(0)
    res = 0.3
    js, jmlp, td = _scene(rng, res)
    nb = neighbor_offsets(2, 0.5)
    kw = dict(
        knn_k=6, n_cand=16, nb_offs=nb, resolution=res,
        max_valid_dist2=3.0 * (3 * res) ** 2, sdf_scale=0.055,
        min_grad_norm=0.0, max_grad_norm=100.0, min_nn_count=1,
        max_iteration=20, term_thre_deg=0.01, term_thre_m=0.001,
    )
    m = 512
    u = rng.standard_normal((m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * 3.0).astype(np.float32)
    mask = np.ones(m, bool)
    mask[-20:] = False
    c, s = np.cos(0.01), np.sin(0.01)
    rot0 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pos0 = np.array([0.02, -0.01, 0.005], np.float32)
    rest0 = np.zeros(12, np.float32)
    rest0[9:12] = [0, 0, -9.81]
    P = (np.eye(18) * 1e-2).astype(np.float32)
    jr = jax.jit(jie.make_cached_update_fn(**kw))(
        js, jmlp, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rot0), jnp.asarray(pos0),
        jnp.asarray(rest0), jnp.asarray(P), td, 0, 1e9,
    )
    ts = neural_map_from_numpy([np.asarray(x) for x in js], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, jmlp), "cpu")
    tr = tie.make_cached_update_fn(**kw)(
        ts, tmlp, t(pts), t(mask), t(rot0), t(pos0), t(rest0), t(P), t(td), 0, 1e9
    )
    np.testing.assert_allclose(n(tr[1]), np.asarray(jr[1]), atol=2e-3)  # position
    np.testing.assert_allclose(n(tr[0]), np.asarray(jr[0]), atol=2e-3)  # rotation
    assert bool(tr[4]) and bool(jr[4])
    assert abs(int(tr[5]) - int(jr[5])) <= 3


def _update_case():
    """tests/test_streaming.py:55's scene and start: the sphere's map, a
    scan of it from inside and a slightly perturbed pose."""
    rng = np.random.default_rng(0)
    res = 0.3
    js, jmlp, td = _scene(rng, res)
    kw = dict(
        knn_k=6, nb_offs=neighbor_offsets(2, 0.5), resolution=res,
        max_valid_dist2=3.0 * (3 * res) ** 2, sdf_scale=0.055, min_grad_norm=0.0,
        max_grad_norm=100.0, min_nn_count=1, max_iteration=20, term_thre_deg=0.01,
        term_thre_m=0.001,
    )
    u = rng.standard_normal((512, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c, s = np.cos(0.01), np.sin(0.01)
    rest0 = np.zeros(12, np.float32)
    rest0[9:12] = [0, 0, -9.81]
    args = ((u * 3.0).astype(np.float32), np.ones(512, bool),
            np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32),
            np.array([0.02, -0.01, 0.005], np.float32), rest0,
            (np.eye(18) * 1e-2).astype(np.float32))
    return js, jmlp, td, kw, args


def test_requery_update_matches_cached_update():
    """tests/test_streaming.py:55 on the port: the update that re-queries
    the map each iteration and the candidate-cached one reach one pose."""
    js, jmlp, td, kw, args = _update_case()
    ts = neural_map_from_numpy([np.asarray(x) for x in js], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, jmlp), "cpu")
    targs = (ts, tmlp, *[t(a) for a in args], t(td), 0, 1e9)
    r1 = tie.make_update_iterated_fn(**kw)(*targs)
    r2 = tie.make_cached_update_fn(n_cand=16, **kw)(*targs)
    np.testing.assert_allclose(n(r1[1]), n(r2[1]), atol=2e-3)  # position
    np.testing.assert_allclose(n(r1[0]), n(r2[0]), atol=2e-3)  # rotation
    assert bool(r1[4]) and bool(r2[4])


def test_requery_update_matches_jax():
    js, jmlp, td, kw, args = _update_case()
    jr = jie.make_update_iterated_fn(**kw)(
        js, jmlp, *[jnp.asarray(a) for a in args], td, 0, 1e9,
    )
    ts = neural_map_from_numpy([np.asarray(x) for x in js], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, jmlp), "cpu")
    tr = tie.make_update_iterated_fn(**kw)(ts, tmlp, *[t(a) for a in args], t(td), 0, 1e9)
    np.testing.assert_allclose(n(tr[1]), np.asarray(jr[1]), atol=2e-3)  # position
    np.testing.assert_allclose(n(tr[0]), np.asarray(jr[0]), atol=2e-3)  # rotation
    np.testing.assert_allclose(n(tr[2]), np.asarray(jr[2]), atol=2e-3)  # vel, biases, gravity
    assert bool(tr[4]) == bool(jr[4])
    assert abs(int(tr[5]) - int(jr[5])) <= 3


@pytest.mark.parametrize("max_sdf_std", [10.0, 0.0], ids=["gate_10", "gate_0"])
def test_decode_then_weight_measurement_matches_jax(max_sdf_std):
    """The re-querying update's reduction with weighted_first=False: the
    per-neighbour decode, its weighted mean and std, and the gradient wrt
    the points inside S6 and b6 (rtol 1e-4), the same valid count, and no
    NaN from points with no neighbour (their std is sqrt(0))."""
    js, jmlp, td, kw, args = _update_case()
    rkw = {k: v for k, v in kw.items()
           if k not in ("max_iteration", "term_thre_deg", "term_thre_m")}
    rkw.update(weighted_first=False, max_sdf_std=max_sdf_std)
    pts = np.concatenate([args[0], np.full((16, 3), 20.0, np.float32)])  # 16 far from the map
    mask = np.ones(len(pts), bool)
    R, tr_ = args[2], args[3]
    jS, jb, jn, _ = jie.make_h_reduce_fn(**rkw)(
        js, jmlp, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(R), jnp.asarray(tr_), td, 0, 1e9,
    )
    ts = neural_map_from_numpy([np.asarray(x) for x in js], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, jmlp), "cpu")
    tS, tb, tn = tie.make_h_reduce_fn(**rkw)(
        ts, tmlp, t(pts), t(mask), t(R), t(tr_), t(td), 0, 1e9,
    )
    assert np.isfinite(n(tS)).all() and np.isfinite(n(tb)).all()
    assert int(tn) == int(jn)
    if max_sdf_std > 0:
        assert int(tn) > 400
        np.testing.assert_allclose(n(tS), np.asarray(jS), rtol=1e-4, atol=1e-4 * np.abs(jS).max())
        np.testing.assert_allclose(n(tb), np.asarray(jb), rtol=1e-4, atol=1e-4 * np.abs(jb).max())
    else:
        assert int(tn) == 0 and not n(tS).any()


@pytest.mark.parametrize("max_sdf_std", [10.0, 0.0], ids=["gate_10", "gate_0"])
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "requery"])
def test_decode_then_weight_updates_match_jax(cached, max_sdf_std):
    """Both iterated updates with weighted_first=False against the JAX
    package's: the pose within 2e-3 and the same verdict. A gate of 0 keeps
    no point: the update has no measurement, so it stops at once where it
    started."""
    js, jmlp, td, kw, args = _update_case()
    kw = dict(kw, weighted_first=False, max_sdf_std=max_sdf_std)
    if cached:
        kw["n_cand"] = 16
    jmake, tmake = ((jie.make_cached_update_fn, tie.make_cached_update_fn) if cached else
                    (jie.make_update_iterated_fn, tie.make_update_iterated_fn))
    jr = jax.jit(jmake(**kw))(js, jmlp, *[jnp.asarray(a) for a in args], td, 0, 1e9)
    ts = neural_map_from_numpy([np.asarray(x) for x in js], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, jmlp), "cpu")
    tr = tmake(**kw)(ts, tmlp, *[t(a) for a in args], t(td), 0, 1e9)
    assert all(np.isfinite(n(x)).all() for x in tr[:4])
    np.testing.assert_allclose(n(tr[1]), np.asarray(jr[1]), atol=2e-3)  # position
    np.testing.assert_allclose(n(tr[0]), np.asarray(jr[0]), atol=2e-3)  # rotation
    assert bool(tr[4]) == bool(jr[4])
    assert abs(int(tr[5]) - int(jr[5])) <= 3
    if max_sdf_std == 0:
        assert int(tr[5]) == int(jr[5]) == 1
        np.testing.assert_allclose(n(tr[1]), args[3], atol=1e-6)
        np.testing.assert_allclose(n(tr[0]), args[2], atol=1e-6)


def test_host_predict_matches_jax_over_200_imu_rows():
    """The host f64 filter of the classic driver: 200 IMU rows one at a
    time, numpy f64 on both sides, to 1e-12."""
    rng = np.random.default_rng(11)
    rows = np.zeros((200, 7))
    rows[:, 0] = 0.005
    rows[:, 1:4] = rng.normal(size=(200, 3)) + [0.0, 0.0, 9.81]
    rows[:, 4:7] = rng.normal(size=(200, 3)) * 0.5
    kw = dict(init_bg=[0.01, -0.02, 0.005], init_ba=[0.05, 0.0, -0.03], init_grav=[0, 0, -9.81])
    filters = []
    for mod in (jie, tie):
        f = mod.IEKF(mod.IEKFConfig(measurement_noise_covariance=0.02), **kw)
        f.x.vel = np.array([1.0, -0.5, 0.2])
        for r in rows:
            f.predict(r[1:4], r[4:7], float(r[0]))
        filters.append(f)
    jf, tf = filters
    for name in ("rot", "pos", "vel", "bg", "ba", "grav"):
        np.testing.assert_allclose(getattr(tf.x, name), getattr(jf.x, name), atol=1e-12, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(tf.P, jf.P, atol=1e-12, rtol=0)
    assert np.linalg.norm(tf.x.pos) > 0.1  # the state did move
    dx = rng.normal(size=18) * 0.1
    np.testing.assert_allclose(tf.x.boxplus(dx).boxminus(tf.x), jf.x.boxplus(dx).boxminus(jf.x),
                               atol=1e-12, rtol=0)


def test_host_update_iterated_matches_jax(trained_scene):
    """``IEKF.update_iterated`` over each package's ``make_h_reduce_fn`` on
    JAX's trained cylinder room (tests/test_iekf.py), from a perturbed
    start: the pose within 1e-4, the same number of iterations, the same
    validity flag."""
    pts, nmap, mlp, travel = trained_scene
    kw = dict(knn_k=6, nb_offs=neighbor_offsets(2, 0.5), resolution=0.3,
              max_valid_dist2=3.0 * 0.9**2, sdf_scale=0.055, min_grad_norm=0.5,
              max_grad_norm=1.5, min_nn_count=6)
    tmap = neural_map_from_numpy([np.asarray(x) for x in nmap], "cpu")
    tmlp = mlp_from_numpy(jax.tree.map(np.asarray, mlp), "cpu")
    jcore, tcore = jie.make_h_reduce_fn(**kw), tie.make_h_reduce_fn(**kw)
    calls = {"jax": 0, "torch": 0}

    def jh(points, mask, R, t_, *a):
        calls["jax"] += 1
        return jcore(nmap, mlp, points, mask, R, t_, travel, 0, 1e9)

    def th(points, mask, R, t_, *a):
        calls["torch"] += 1
        return tcore(tmap, tmlp, points, mask, R, t_, t(travel), 0, 1e9)

    dx0 = np.zeros(18)
    dx0[0:3] = [0.0, 0.0, np.deg2rad(2.0)]
    dx0[3:6] = [0.15, -0.1, 0.05]
    src = np.asarray(pts[::2])
    out = {}
    for name, mod, h, conv in (("jax", jie, jh, jnp.asarray), ("torch", tie, th, t)):
        f = mod.IEKF(mod.IEKFConfig(max_iteration=50))
        f.x = f.x.boxplus(dx0)
        out[name] = f.update_iterated(h, conv(src), conv(np.ones(len(src), bool))) + (f.P,)
    (jp, jok, jP), (tp, tok, tP) = out["jax"], out["torch"]
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    assert calls["torch"] == calls["jax"] > 1 and tok == jok is True
    np.testing.assert_allclose(tP, jP, rtol=1e-3, atol=1e-9)
    assert np.linalg.norm(tp[:3, 3]) < 0.05  # recovered near the true pose (identity)


@pytest.mark.parametrize("exit_", sorted(TRACKER_EXITS))
def test_cached_update_takes_the_eager_loop_on_the_cpu(exit_, monkeypatch):
    """On CPU tensors the cached update's iterations run eagerly: nothing is
    captured, no replay is counted, each exit rule ends the loop where the
    card's test expects it, and ``n_iter`` is the iterations counted."""
    def no_capture(*a):
        raise AssertionError("a CUDA graph was built for CPU tensors")

    monkeypatch.setattr(tie, "_GraphedIterations", no_capture)
    kw = dict(TRACKER_KW, **TRACKER_EXITS[exit_])
    inputs = _tracker_inputs(7, "cpu")
    obs.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        rot, pos, rest, P, ok, n_iter = tie.make_cached_update_fn(**kw).dense_update(*inputs)
    counted = obs.counters()
    obs.reset_counters()
    assert n_iter.dtype == torch.int32 and n_iter.device.type == "cpu"
    assert _exit_holds(exit_, int(n_iter), bool(ok), kw), (int(n_iter), bool(ok))
    assert counted["track.iters"] == int(n_iter) and "track.graph_iters" not in counted
    assert torch.equal(P, P.T) and P.is_contiguous()


def _profiled_flops(prof):
    return {e.key: e.flops for e in prof.key_averages() if e.flops}


@pytest.mark.parametrize("option", [None] + sorted(TRACKER_OPTIONS))
def test_flops_of_counts_as_the_profiler_does(option):
    """``flops_of``, which counts the card's captured iteration once for its
    replays, runs the eager update and counts its products and its
    elementwise ``mul`` as torch's profiler's ``with_flops`` does, forward
    and backward, with each option's decoder; its ``add`` count holds the
    profiler's and, beside it, the autograd engine's sums of gradients,
    which the profiler does not record."""
    kw, inputs = _tracker_option(option, 5, "cpu")
    body = tie.make_cached_update_fn(**dict(kw, **TRACKER_EXITS["converged"]))
    got = []
    counted = graphs.flops_of(lambda: got.append(body.dense_update(*inputs)))
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        want = body.dense_update(*inputs)
    obs.reset_counters()
    profiled = _profiled_flops(prof)
    assert set(counted) == set(profiled) and counted["aten::mm"] > 0
    for op, n in counted.items():
        assert n >= profiled[op] if op == "aten::add" else n == profiled[op], op
    assert counted["aten::add"] < 0.05 * sum(profiled.values()) + profiled["aten::add"]
    for x, y in zip(got[0], want):
        assert torch.equal(x, y)


def test_flops_of_counts_inside_a_traced_run():
    """A capture inside a traced run counts its iteration too: ``flops_of``
    starts no profiler (one would end the running one), and the running
    profiler goes on recording (the counted ops twice: as dispatched and as
    the counting mode runs them)."""
    body = tie.make_cached_update_fn(**dict(TRACKER_KW, **TRACKER_EXITS["converged"]))
    inputs = _tracker_inputs(5, "cpu")
    alone = graphs.flops_of(lambda: body.dense_update(*inputs))
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as outer:
        inside = graphs.flops_of(lambda: body.dense_update(*inputs))
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as plain:
        body.dense_update(*inputs)
    obs.reset_counters()
    outer, plain = _profiled_flops(outer), _profiled_flops(plain)
    assert inside == alone and set(outer) == set(plain)
    assert all(outer[op] >= 2 * plain[op] for op in plain)


def _tracker_leaves():
    """The sharded tracker's: candidates handed over as strided views of
    its exchanged payload."""
    return tie._leaves(_payload_candidates(_tracker_inputs(3, "cpu", n=64)))


def _upload_views():
    """``GraphedTrackStages``': the scan and the IMU rows as the views of the
    frame's upload that ``pack_adapter`` hands to the step."""
    rng = np.random.default_rng(0)
    pack = sm.pack_frame_buffers(64, 8, rng.normal(size=(50, 3)), rng.uniform(size=50),
                                 rng.normal(size=(5, 7)), 3, 20.0, 10, 1.0, False)
    args = sm.pack_adapter(lambda *a: a, 64, 8)(SimpleNamespace(rot=torch.eye(3)), pack)
    return list(args[2:6])  # points, pmask, point_ts, imu_rows


def _prep_leaves():
    """``GraphedPrep``'s: the leaves of the map, the local map and the pool
    that prep reads or writes."""
    return prp.GraphedPrep._leaves(nm.init_map(64, 256, 8), lm.init_local_map(64, 256),
                                   pl.init_pool(128, 32))


GRAPH_INPUTS = {"tracker": _tracker_leaves, "track_stages": _upload_views,
                "prep": _prep_leaves}


@pytest.mark.parametrize("family", sorted(GRAPH_INPUTS))
def test_graph_buffers_keep_the_inputs_strides(family):
    """The buffers a capture reads (``graphs.buffers``) are copies of a
    graph family's first inputs with their shapes and strides, strided
    views of the sharded tracker's payload and of the frame's upload too,
    so the replays run the eager kernels on their layouts; the copies read
    the inputs' ``layout_key``. The tracker's copies go back into its
    inputs' structure, candidates, decoder and the rest in place."""
    leaves = GRAPH_INPUTS[family]()
    copies = graphs.buffers(leaves)
    assert len(copies) == len(leaves) > 1
    assert family == "prep" or not all(x.is_contiguous() for x in leaves)
    for x, b in zip(leaves, copies):
        assert b.stride() == x.stride() and b.dtype == x.dtype and torch.equal(b, x)
        assert b.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert graphs.layout_key(copies) == graphs.layout_key(leaves)
    if family == "tracker":
        inputs = _payload_candidates(_tracker_inputs(3, "cpu", n=64))
        rebuilt = tie._rebuilt(inputs, copies)
        assert [id(x) for x in tie._leaves(rebuilt)] == [id(x) for x in copies]
        assert rebuilt[0][3] is None and len(rebuilt) == len(inputs)
