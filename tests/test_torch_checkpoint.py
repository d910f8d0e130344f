"""Checkpoint and resume of the port's StreamingSlam: a run saved at frame
5 and resumed in a fresh system equals the uninterrupted run bit for bit on
the CPU (the pattern of tests/test_streaming.py:208, also with the
dynamic filter and bundle adjustment on, whose draws come from the saved
generator); a checkpoint written by the JAX package loads into the port
array by array and tracks on, also with the color and semantic heads'
wider leaves; a file of another config is refused; every leaf of the state
is row-major, as a checkpoint holds it."""

import numpy as np
import jax
import pytest
import torch

from clid_slam_torch.pipeline.streaming import StreamingSlam as TorchSlam
from clid_slam_torch.utils import metrics as tmetrics
from clid_slam_tpu.pipeline.streaming import StreamingSlam as JaxSlam
from clid_slam_tpu.pipeline.synthetic import generate_sequence
from test_torch_streaming import _seed
from torch_parity import n, port_config, tiny_config

DYNBA = dict(ba_freq_frame=4, ba_frame=4, ba_iters=5, ba_bs=1024, dynamic_filter_on=True)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=10, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)


def _boot(cfg, seq):
    s = TorchSlam(cfg, total_frames=14, device="cpu")
    _seed(s, seq)
    return s


@pytest.mark.parametrize("options", [{}, DYNBA], ids=["plain", "filter_and_ba"])
def test_resume_equals_the_uninterrupted_run(seq, tmp_path, options):
    cfg = port_config(tiny_config(**options))
    a = _boot(cfg, seq)
    for i in range(10):
        a.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out_a = a.sync()

    b = _boot(cfg, seq)
    for i in range(5):
        b.process_frame(i, seq.scans[i], seq.imu_windows[i])
    ckpt = str(tmp_path / "stream_ckpt.npz")
    b.save_checkpoint(ckpt)
    del b

    c = _boot(cfg, seq)
    c.load_checkpoint(ckpt)
    assert c.processed == 5
    for i in range(5, 10):
        c.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out_c = c.sync()

    for k in ("odom_poses", "losses", "track_iters", "travel_dist"):
        np.testing.assert_array_equal(out_a[k], out_c[k], err_msg=k)
    for k in ("neural_points", "insert_dropped", "prunes", "filtered", "ba_frames", "failed"):
        assert out_a[k] == out_c[k], k
    for x, y in zip(a.state.leaves(), c.state.leaves()):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert torch.equal(x, y)
    if options:
        assert len(out_c["filtered"]) == 9  # every tracked frame was filtered
        assert out_c["ba_frames"] == [7]


@pytest.mark.parametrize("options", [{}, DYNBA], ids=["plain", "filter_and_ba"])
def test_state_leaves_are_row_major(seq, options):
    # a checkpoint, or any host copy, holds the state row-major: a leaf in
    # another layout would make the next frame round otherwise after a copy
    # than without one (on the card a tracked pose can move by 1e-4)
    s = _boot(port_config(tiny_config(**options)), seq)
    for i in range(8):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    assert s.sync()["ba_frames"] == ([7] if options else [])
    leaves = s.state.leaves()
    assert [k for k, x in enumerate(leaves)
            if isinstance(x, torch.Tensor) and not x.is_contiguous()] == []


def test_jax_checkpoint_loads_into_the_port(seq, tmp_path):
    """The JAX package's file (no generator state) carries over leaf by
    leaf; the port then tracks two more frames (its draws differ from the
    JAX run's from here, so only the outcome is checked)."""
    _load_jax_checkpoint(seq, tmp_path)


def test_jax_color_semantic_checkpoint_loads_into_the_port(seq, tmp_path):
    """As above with the color and semantic heads on: the color slab of
    feature_dim columns, the color MLP and the 20-class semantic MLP carry
    over leaf by leaf, and the port's own file of that state (written
    after the load) reads back bit for bit."""
    port = _load_jax_checkpoint(
        seq, tmp_path, color_on=True, color_channel=1, semantic_on=True, sem_class_count=20
    )
    assert port.state.map_state.color_feats.shape[1] == 8
    assert port.state.sem_mlp.w_out.shape[1] == 20
    ckpt = str(tmp_path / "port_ckpt.npz")
    port.save_checkpoint(ckpt)
    again = _boot(port.cfg, seq)
    again.load_checkpoint(ckpt)
    for x, y in zip(port.state.leaves(), again.state.leaves()):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert torch.equal(x, y)


def _load_jax_checkpoint(seq, tmp_path, **options):
    jcfg = tiny_config(**options)
    s = JaxSlam(jcfg, total_frames=14)
    _seed(s, seq)
    for i in range(3):
        s.process_frame(i, seq.scans[i], seq.imu_windows[i])
    ckpt = str(tmp_path / "jax_ckpt.npz")
    s.save_checkpoint(ckpt)
    port = _boot(port_config(jcfg), seq)
    port.load_checkpoint(ckpt)
    assert port.processed == 3
    leaves = jax.tree_util.tree_leaves(s.state)
    ours = port.state.leaves()
    assert len(ours) == len(leaves)
    for i, (a, b) in enumerate(zip(ours, leaves)):
        if not isinstance(a, torch.Generator):
            np.testing.assert_array_equal(n(a), np.asarray(b).astype(n(a).dtype), err_msg=f"leaf {i}")
    for i in (3, 4):
        port.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = port.sync()
    assert not out["failed"] and np.all(out["track_iters"][3:] > 0)
    m = tmetrics.absolute_error(out["odom_poses"], seq.poses[:5], align=False)
    assert m["ate_rmse_m"] < 0.2, m  # tests/test_streaming.py's gate
    return port


def test_checkpoint_of_another_config_is_refused(seq, tmp_path):
    a = _boot(port_config(tiny_config()), seq)
    ckpt = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(ckpt)
    b = _boot(port_config(tiny_config(geo_mlp_level=2)), seq)
    with pytest.raises(ValueError, match="config mismatch"):
        b.load_checkpoint(ckpt)
