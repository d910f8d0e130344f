"""The port's counterparts of the JAX package's small public helpers, on
seeded numpy inputs:

- ``pipeline/streaming.py:pack_frame_buffers``: bit-equal to JAX's, with
  and without per-point timestamps, IMU windows under and over
  ``imu_max_rows``, scans under and over ``p_cap``; ``pack_adapter`` hands
  a step the same arguments as JAX's (exact);
- ``ops/voxel.py:voxel_down_sample_min_value_mask``: bit-equal at two table
  sizes, with masked rows and tied values;
- ``utils/transforms.py:transform_points_batch``: to 1e-6;
- ``mapping/mapper.py:pallas_ineligible_reasons_config``: equal lists for
  every ``configs/*.yaml`` and for one config per ineligible option;
- ``mapping/pool.py:ReplayPool``'s column views: equal.
"""

import glob
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clid_slam_torch.config import Config as TConfig
from clid_slam_torch.convert import pool_from_numpy
from clid_slam_torch.mapping import mapper as tmp
from clid_slam_torch.ops import voxel as tv
from clid_slam_torch.pipeline import streaming as tst
from clid_slam_torch.utils import transforms as ttr
from clid_slam_tpu.config import Config as JConfig
from clid_slam_tpu.mapping import mapper as jmp
from clid_slam_tpu.mapping import pool as jpl
from clid_slam_tpu.ops import voxel as jv
from clid_slam_tpu.pipeline import streaming as jst
from clid_slam_tpu.utils import transforms as jtr
from torch_parity import n, t

P_CAP, IMU_ROWS = 96, 8
CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _frame(rng, n_points, n_imu, with_ts):
    points = rng.normal(0, 10.0, (n_points, 3)).astype(np.float32)
    ts = rng.uniform(0, 1, n_points) if with_ts else None  # float64, cast by the packer
    imu = rng.normal(0, 1.0, (n_imu, 7)).astype(np.float32) if n_imu is not None else None
    return points, ts, imu


PACK_CASES = {
    "ts_imu_under": (60, 5, True),
    "no_ts_imu_under": (60, 5, False),
    "ts_imu_over": (60, 20, True),
    "no_ts_no_imu": (60, None, False),
    "empty_imu_window": (60, 0, True),
    "scan_over_p_cap": (150, IMU_ROWS, True),
    "empty_scan": (0, None, False),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_frame_buffers_bit_equal(case):
    rng = np.random.default_rng(sorted(PACK_CASES).index(case))
    points, ts, imu = _frame(rng, *PACK_CASES[case])
    args = (P_CAP, IMU_ROWS, points, ts, imu, 7, 27.3, 40, 0.5, True)
    got = tst.pack_frame_buffers(*args)
    want = jst.pack_frame_buffers(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_pack_adapter_hands_the_step_jax_arguments():
    """A step that returns its arguments, behind each package's adapter."""
    rng = np.random.default_rng(11)
    points, ts, imu = _frame(rng, 70, 6, True)
    pack = jst.pack_frame_buffers(P_CAP, IMU_ROWS, points, ts, imu, 5, 29.7, 10, 1.0, False)

    def echo(state, *args, draws=None):
        return args

    want = jst.pack_adapter(echo, P_CAP, IMU_ROWS)(jnp.zeros(()), jnp.asarray(pack))
    state = SimpleNamespace(rot=torch.eye(3))  # the adapter reads the state's device
    got = tst.pack_adapter(lambda st, *a: a, P_CAP, IMU_ROWS)(state, pack)
    assert len(got) == len(want) + 1 and got[-1] is None  # draws
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(n(a) if hasattr(a, "numpy") else np.asarray(a),
                                      np.asarray(b), err_msg=f"argument {i}")


def _voxel_inputs(seed, n_points, tied):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (n_points, 3)).astype(np.float32)
    pts[: n_points // 4] = np.floor(pts[: n_points // 4] / 0.5) * 0.5 + 0.01  # crowded voxels
    mask = rng.uniform(size=n_points) < 0.8
    if tied:
        value = rng.integers(0, 4, n_points).astype(np.float32)  # many ties per voxel
    else:
        value = rng.normal(0, 2.0, n_points).astype(np.float32)
    value[~mask] = -100.0  # masked rows must not win, nor set the range
    return pts, mask, value


@pytest.mark.parametrize("table_size", [1 << 8, 1 << 14])
@pytest.mark.parametrize("tied", [False, True])
def test_voxel_down_sample_min_value_mask_bit_equal(table_size, tied):
    pts, mask, value = _voxel_inputs(table_size + tied, 2000, tied)
    want = np.asarray(jv.voxel_down_sample_min_value_mask(
        jnp.asarray(pts), jnp.asarray(mask), 0.5, jnp.asarray(value), table_size))
    got = n(tv.voxel_down_sample_min_value_mask(t(pts), t(mask), 0.5, t(value), table_size))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum() and not (got & ~mask).any()


def test_voxel_down_sample_min_value_mask_all_masked():
    pts, _, value = _voxel_inputs(5, 64, False)
    mask = np.zeros(64, bool)
    got = n(tv.voxel_down_sample_min_value_mask(t(pts), t(mask), 0.5, t(value), 256))
    assert not got.any()


def test_transform_points_batch():
    rng = np.random.default_rng(4)
    m = 500
    q = rng.normal(size=(m, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(m, 3, 3)
    T = np.tile(np.eye(4), (m, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(0, 5.0, (m, 3))
    T = T.astype(np.float32)
    pts = rng.normal(0, 10.0, (m, 3)).astype(np.float32)
    want = np.asarray(jtr.transform_points_batch(jnp.asarray(pts), jnp.asarray(T)))
    got = n(ttr.transform_points_batch(t(pts), t(T)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))


INELIGIBLE = {
    "color_on": dict(color_on=True),
    "semantic_on": dict(semantic_on=True),
    "weighted_first": dict(weighted_first=False),
    "mlp_bf16": dict(mlp_bf16=True),
    "mlp_leaky_relu": dict(mlp_leaky_relu=True),
    "loss_type": dict(main_loss_type="sdf_l1"),
    "feature_dim": dict(feature_dim=6),
    "geo_mlp_level": dict(geo_mlp_level=3),
    "all": dict(color_on=True, semantic_on=True, weighted_first=False, mlp_bf16=True,
                mlp_leaky_relu=True, main_loss_type="zhong", feature_dim=16, geo_mlp_level=4),
}


@pytest.mark.parametrize("yaml_name", sorted(os.path.basename(p) for p in
                                             glob.glob(os.path.join(CONFIG_DIR, "*.yaml"))))
def test_pallas_ineligible_reasons_config_on_shipped_configs(yaml_name):
    path = os.path.join(CONFIG_DIR, yaml_name)
    want = jmp.pallas_ineligible_reasons_config(JConfig.load(path))
    assert tmp.pallas_ineligible_reasons_config(TConfig.load(path)) == want


@pytest.mark.parametrize("option", sorted(INELIGIBLE))
def test_pallas_ineligible_reasons_config_per_option(option):
    jcfg, tcfg = JConfig(), TConfig()
    for k, v in INELIGIBLE[option].items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    want = jmp.pallas_ineligible_reasons_config(jcfg)
    assert want  # the option makes the config ineligible
    assert tmp.pallas_ineligible_reasons_config(tcfg) == want


def test_pool_column_views():
    rng = np.random.default_rng(8)
    jp = jpl.init_pool(64, 16, 3)
    data = rng.normal(0, 1.0, (64, jpl.BASE_COLS + 3)).astype(np.float32)
    data[:, 5] = rng.integers(0, 300, 64)  # frame ids
    data[:, 6] = rng.integers(-1, 20, 64)  # class labels, -1 unlabelled
    jp = jp._replace(data=jnp.asarray(data))
    tp = pool_from_numpy([np.asarray(x) for x in jp], "cpu")
    for name in ("coords", "sdf", "weight", "ts", "sem", "color"):
        want = np.asarray(getattr(jp, name))
        got = n(getattr(tp, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
