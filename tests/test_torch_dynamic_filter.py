"""The dynamic filter against the JAX package on a map that the JAX
StreamingSlam trained over three frames of tests/test_streaming.py's
sequence, carried across with clid_slam_torch.convert. The query points
are a scan and the same returns pulled up to 1.2 m toward the sensor, into
free space, so that every threshold has points on both sides. The fields
the mask is made of agree (SDF and certainty within 1e-5, gradient norm
within 1e-4 relative away from the neural points themselves, where the
IDW weight's gradient is singular), and the masks are equal wherever no
field sits within 1e-4 of its threshold."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import stream_state_from_numpy
from clid_slam_torch.mapping import dynamic_filter as tdf
from clid_slam_torch.models import decoder as tdec
from clid_slam_torch.models import neural_map as tnm
from clid_slam_tpu.mapping import dynamic_filter as jdf
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from test_torch_streaming import _seed
from torch_parity import n, t, tiny_config

N_JAX = 3


@pytest.fixture(scope="module")
def jax_run():
    seq = generate_sequence(n_frames=N_JAX, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    cfg = tiny_config()
    s = JaxSlam(cfg, total_frames=16)
    _seed(s, seq)
    for i in range(N_JAX):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    s.block()
    return cfg, s, seq


def test_filter_mask_matches_jax(jax_run):
    cfg, s, seq = jax_run
    st = stream_state_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(s.state)], "cpu")
    rng = np.random.default_rng(0)
    scan = seq.scans[N_JAX - 1][::2][:3000].astype(np.float64)
    pull = np.where(rng.uniform(size=len(scan)) < 0.3, 0.0, rng.uniform(0, 1.2, len(scan)))
    local = scan * (1.0 - pull / np.linalg.norm(scan, axis=1))[:, None]
    pose = np.asarray(s.state.odom_poses[N_JAX - 1])
    world = (local @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    mask = rng.uniform(size=len(world)) < 0.9
    res, cur = cfg.voxel_size_m, N_JAX - 1
    mvd2 = 3.0 * ((cfg.num_nei_cells + 1) * res) ** 2
    kw = dict(knn_k=cfg.query_nn_k, nb_offs=s.nb_offs, resolution=res, max_valid_dist2=mvd2,
              sdf_scale=cfg.sdf_scale, certainty_thre=cfg.dynamic_certainty_thre,
              sdf_ratio_thre=cfg.dynamic_sdf_ratio_thre)
    want = np.asarray(jdf.make_dynamic_filter_fn(**kw)(
        s.state.map_state, s.state.mlp, jnp.asarray(world), jnp.asarray(mask),
        s.state.travel_dist, cur, 1e9,
    ))
    got = tdf.make_dynamic_filter_fn(**kw)(
        st.map_state, st.mlp, t(world), t(mask), st.travel_dist, cur, 1e9,
    )
    assert got.dtype == torch.bool and not got.requires_grad

    # the three fields the mask is made of, on both sides
    def jax_sdf(pts):
        q = jnm.query_feature(s.state.map_state, pts, s.nb_offs, res, mvd2, cfg.query_nn_k,
                              s.state.travel_dist, cur, 1e9, True)
        pred = jdec.sdf(s.state.mlp, q.feature, cfg.sdf_scale)
        return jnp.sum(pred), (pred, q.certainty)

    jgrad, (jpred, jcert) = jax.grad(jax_sdf, has_aux=True)(jnp.asarray(world))
    pts = t(world).requires_grad_(True)
    q = tnm.query_feature(st.map_state, pts, t(s.nb_offs), res, mvd2, cfg.query_nn_k,
                          st.travel_dist, cur, 1e9, True)
    tpred = tdec.sdf(st.mlp, q.feature, cfg.sdf_scale)
    (tgrad,) = torch.autograd.grad(tpred.sum(), pts)
    gn = lambda g: np.sqrt(np.sum(np.asarray(g, np.float64) ** 2, axis=-1) + 1e-20)
    pred, cert, grad_norm = n(tpred), n(q.certainty), gn(n(tgrad))
    np.testing.assert_allclose(pred, np.asarray(jpred), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cert, np.asarray(jcert), atol=1e-5, rtol=1e-6)
    # a query point on a neural point (a raw return the map inserted) has
    # d2 ~ 1e-14 to it, where the IDW weight 1/(d2 + 1e-15) has a singular
    # gradient: rounding moves it by percents there, so those few points
    # are left out of the gradient comparison (not of the mask's)
    knn = n(q.knn_idx)
    d2 = np.sum((n(st.map_state.positions)[np.maximum(knn, 0)] - world[:, None]) ** 2, -1)
    on_point = np.any((knn >= 0) & (d2 < 1e-6), axis=1)
    assert on_point.mean() < 0.05
    np.testing.assert_allclose(grad_norm[~on_point], gn(jgrad)[~on_point], rtol=1e-4, atol=1e-10)

    fields = ((cert, cfg.dynamic_certainty_thre), (pred, cfg.dynamic_sdf_ratio_thre * res),
              (grad_norm, 0.1))
    for x, thre in fields:  # points on both sides of every threshold
        assert (x < thre - 1e-4).sum() > 10 and (x > thre + 1e-4).sum() > 10, thre
    clear = np.all([np.abs(x - thre) > 1e-4 for x, thre in fields], axis=0)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(n(got)[clear], want[clear])
    dropped = mask & ~n(got)
    assert 10 < dropped.sum() < mask.sum() - 10  # the filter drops points, not all
    assert not (n(got) & ~mask).any()
