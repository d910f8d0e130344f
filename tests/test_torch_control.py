"""The port's runtime control channel and its visual artifacts against
tests/test_control.py: the channel's one-shot flags, overrides, pause and
stop (``pipeline/control.py``), the PCA feature colors (equal to the JAX
package's within 1e-6), the vertical SDF slice of a random map against the
JAX ``Mesher``'s (points equal, masks equal, SDF within 1e-5), and the
metrics logger with and without wandb."""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import jax
import jax.numpy as jnp

from clid_slam_torch.convert import mlp_from_numpy, neural_map_from_numpy
from clid_slam_torch.mesher import Mesher
from clid_slam_torch.pipeline.control import ControlChannel
from clid_slam_torch.utils.observability import MetricsLogger
from clid_slam_torch.utils.plots import feature_pca_colors
from clid_slam_tpu.mesher import Mesher as JaxMesher
from clid_slam_tpu.models import decoder as jdec
from clid_slam_tpu.models import neural_map as jnm
from clid_slam_tpu.ops.voxel import neighbor_offsets
from clid_slam_tpu.utils.plots import feature_pca_colors as jax_pca_colors


def _write(path, cmd):
    with open(os.path.join(path, "control.json"), "w") as f:
        json.dump(cmd, f)


def test_control_channel_roundtrip(tmp_path):
    ch = ControlChannel(str(tmp_path))
    st = ch.poll()
    assert not st.stop and not st.mesh_now and not st.slice_now
    _write(tmp_path, {"mesh_now": True, "slice_now": True, "mesh_res_m": 0.05})
    st = ch.poll()
    assert st.mesh_now and st.slice_now
    assert st.overrides["mesh_res_m"] == 0.05
    st = ch.poll()  # one-shot: consumed
    assert not st.mesh_now and not st.slice_now
    assert st.overrides["mesh_res_m"] == 0.05  # the override persists
    _write(tmp_path, {"stop": True})
    assert ch.poll().stop


def test_control_pause_released(tmp_path):
    ch = ControlChannel(str(tmp_path))
    _write(tmp_path, {"pause": True})

    def release():
        time.sleep(0.5)
        _write(tmp_path, {"pause": False})

    t = threading.Thread(target=release)
    t.start()
    t0 = time.time()
    st = ch.poll()  # blocks until released
    t.join(timeout=10)
    assert not t.is_alive()
    assert time.time() - t0 >= 0.4
    assert not st.pause


def test_feature_pca_colors_match_jax(rng):
    feats = rng.normal(size=(500, 8)).astype(np.float32)
    colors, pcs = feature_pca_colors(feats)
    assert colors.shape == (500, 3) and pcs.shape == (8, 3)
    assert colors.min() >= 0.0 and colors.max() <= 1.0
    c2, _ = feature_pca_colors(feats, principal_components=pcs)
    np.testing.assert_allclose(colors, c2, atol=1e-9)
    want, _ = jax_pca_colors(feats)
    np.testing.assert_allclose(colors, want, atol=1e-6)


def test_vertical_sdf_slice_matches_jax(rng):
    """tests/test_control.py::test_vertical_sdf_slice on both packages: the
    same random map and decoder, the slice through x = 0.05 (off the voxel
    faces, see tests/test_torch_mesher.py)."""
    res = 0.3
    pts = rng.uniform(-2, 2, size=(1500, 3)).astype(np.float32)
    state = jnm.init_map(1 << 12, 1 << 14, 8)
    state, _ = jnm.insert_points(state, jnp.asarray(pts), jnp.ones((1500,), bool), res,
                                 jnp.zeros((4,), jnp.float32), 0, 1e9)
    mlp = jdec.init_mlp(jax.random.PRNGKey(0), 11, 32, 1)
    kw = dict(knn_k=6, nb_offs=neighbor_offsets(2, 0.5), resolution=res,
              max_valid_dist2=3.0 * (3 * res) ** 2, sdf_scale=0.055, mesh_min_nn=6, feature_dim=8)
    center = np.array([0.0, 0.013, -0.021])
    jp, js, jok = JaxMesher(**kw).sdf_slice_vertical(state, mlp, center, 1.5, 0.05, 0.25)
    p, sdf, ok = Mesher(**kw).sdf_slice_vertical(
        neural_map_from_numpy([np.asarray(x) for x in state], "cpu"),
        mlp_from_numpy(jax.tree.map(np.asarray, mlp), "cpu"), center, 1.5, 0.05, 0.25)
    assert ok.any()
    np.testing.assert_allclose(p[:, 0], 0.05)  # every point on the slice plane
    assert np.isfinite(sdf[ok]).all()
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_allclose(sdf[ok], js[jok], atol=1e-5, rtol=0)


def test_metrics_logger_wandb_plumbing(monkeypatch):
    logged = []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: None
    fake.run = types.SimpleNamespace(name="")
    fake.log = lambda d: logged.append(d)
    fake.finish = lambda: logged.append("finish")
    monkeypatch.setitem(sys.modules, "wandb", fake)
    ml = MetricsLogger(enabled=True, run_name="t", silence=True)
    ml.log_frame(3, {"tracking": 0.01}, {"sdf": 0.5})
    ml.log_final({"ate_rmse_m": 0.05, "frames": 10})
    ml.finish()
    assert logged[0]["frame"] == 3
    assert logged[0]["timing(s)/tracking"] == 0.01
    assert logged[0]["loss/sdf"] == 0.5
    assert logged[1]["final/ate_rmse_m"] == 0.05
    assert logged[-1] == "finish"


def test_metrics_logger_noop_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    ml = MetricsLogger(enabled=True, run_name="t", silence=True)
    ml.log_frame(0, {"a": 1.0}, {})  # must not raise
    ml.log_final({"x": 1.0})
    ml.finish()
