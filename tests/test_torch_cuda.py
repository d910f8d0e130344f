"""Card-only tests of the port: the hand-written kernels (map_loop and the
three gathers) against their plain PyTorch versions, and short streaming runs
that go through them. A gather copies bits, so its comparison is exact.

They skip without a CUDA card (the kernel has no CPU mode). This file
imports neither JAX nor clid_slam_tpu, so the card's machine runs it
without them; there, run it without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: one Adam step rtol 1e-5 / atol 1e-6; n steps max diff < 3 lr
(the t=1 Adam step is a sign function of the gradient, so elements whose
gradient sits at the rounding noise may flip), and beside it tight limits
that see gradient magnitudes and the Adam state carried between steps:
features 99th percentile <= 1e-5, losses rtol 1e-4, MLP median <= 1e-5.
"""

import numpy as np
import pytest
import torch

K, F, P, H, DEC = 6, 8, 3, 64, 10
LR = 0.01
KW = dict(dec_step=DEC, sdf_scale=0.055, sigma=0.055, lr=LR, adam_eps=1e-15,
          weight_e=0.5, num_grad_eps=0.08)
CASES = {
    "base": dict(bs=1024, mlp_scale=1.0, layer_norm=False, n_hidden=1),
    "mlp_frozen": dict(bs=1024, mlp_scale=0.0, layer_norm=False, n_hidden=1),
    "layer_norm": dict(bs=1024, mlp_scale=1.0, layer_norm=True, n_hidden=1),
    "two_hidden": dict(bs=1024, mlp_scale=1.0, layer_norm=False, n_hidden=2),
    "padded_ln_two_hidden": dict(bs=900, mlp_scale=1.0, layer_norm=True, n_hidden=2),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from clid_slam_torch import set_full_precision

    set_full_precision()
    return torch.device("cuda")


def _inputs(bs, n_hidden, dev, seed=5):
    from clid_slam_torch.models.decoder import MLPParams

    rng = np.random.default_rng(seed)
    bd = max(1, bs // DEC // 4)
    f = rng.normal(0, 0.1, (bs, K, F))
    w0 = rng.uniform(0, 1, (bs, K))
    w0[rng.uniform(size=(bs, K)) < 0.2] = 0.0
    w0 /= np.maximum(w0.sum(1, keepdims=True), 1e-9)
    bvalid = (rng.uniform(size=bs) < 0.9).astype(np.float64)
    wtap = rng.uniform(0, 1, (6, bd, K))
    wtap /= np.maximum(wtap.sum(-1, keepdims=True), 1e-9)
    vd = bvalid[::DEC][:bd]
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    ws = [rng.normal(0, 0.3, (F + P, H))] + ([rng.normal(0, 0.2, (H, H))] if n_hidden == 2 else [])
    bs_ = [rng.normal(0, 0.1, H) for _ in ws]
    mlp = MLPParams([t(w) for w in ws], [t(b) for b in bs_], t(rng.normal(0, 0.3, (H, 1))),
                    t(rng.normal(0, 0.1, 1)))
    return dict(
        args=(t(f), t(w0), t(rng.normal(0, 0.2, (bs, P))),
              torch.sigmoid(t(rng.normal(0, 0.1, bs)) / KW["sigma"]),
              t(rng.uniform(0.5, 1.5, bs) * bvalid), t(wtap),
              t(rng.normal(0, 0.2, (6, bd, P))), t(vd), mlp),
        denom_inv=1.0 / max(bvalid.sum(), 1.0), eik_inv=1.0 / max(vd.sum(), 1.0),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_map_loop_kernel_matches_plain_version(case):
    from clid_slam_torch.ops import map_loop as ml

    dev = _cuda()
    c = CASES[case]
    x = _inputs(c["bs"], c["n_hidden"], dev)

    def run(fn, n_it):
        return fn(*x["args"], torch.tensor(n_it, dtype=torch.int32, device=dev), 20,
                  LR * c["mlp_scale"], x["denom_inv"], x["eik_inv"],
                  layer_norm=c["layer_norm"], **KW)

    launches = ml.launches
    k1, r1 = run(ml.map_loop, 1), run(ml.map_loop_reference, 1)
    torch.cuda.synchronize()
    assert ml.launches == launches + 1
    np.testing.assert_allclose(k1[0].cpu().numpy(), r1[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    kn, rn = run(ml.map_loop, 5), run(ml.map_loop_reference, 5)
    d = (kn[0] - rn[0]).abs().flatten().cpu().numpy()
    assert d.max() < 3 * LR and np.quantile(d, 0.99) <= 1e-5
    np.testing.assert_allclose(kn[2].cpu().numpy(), rn[2].cpu().numpy(), rtol=1e-4, atol=0)
    md = torch.cat([(got - want).abs().flatten() for got, want in
                    zip(kn[1].tensors(), rn[1].tensors())]).cpu().numpy()
    assert md.max() < 3 * LR * max(c["mlp_scale"], 1e-9) + 1e-6 and np.median(md) <= 1e-5


@pytest.mark.gpu
def test_map_loop_rejects_what_the_kernel_cannot_take():
    from clid_slam_torch.ops import map_loop as ml

    dev = _cuda()
    x = _inputs(256, 1, dev)
    args = list(x["args"])
    args[0] = args[0].double()
    with pytest.raises(TypeError):
        ml.map_loop(*args, torch.tensor(2, device=dev), 20, LR, x["denom_inv"], x["eik_inv"], **KW)


def _tiny_system(**overrides):
    """A small StreamingSlam on the card with its seeded synthetic sequence."""
    from clid_slam_torch.config import Config
    from clid_slam_torch.pipeline.streaming import StreamingSlam
    from clid_slam_torch.pipeline.synthetic import generate_sequence

    _cuda()
    c = Config()
    for k, v in {**dict(
        voxel_size_m=0.3, search_alpha=0.5, local_voxel_size_m=0.15, vox_down_m=0.08,
        source_vox_down_m=0.4, min_range=0.5, max_range=30.0, max_z=30.0, bs=4096,
        bs_new_sample=512, iters=10, reg_iter_n=20, freeze_after_frame=6,
        loss_weight_on=True, map_capacity=1 << 15, map_hash_size=1 << 17,
        local_map_capacity=1 << 16, local_map_hash_size=1 << 17,
        max_scan_points=1 << 13, max_source_points=1 << 11, pool_capacity=1 << 18,
    ), **overrides}.items():
        setattr(c, k, v)
    c._derive()
    c.diff_travel_dist_local = 1e9
    seq = generate_sequence(n_frames=4, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3)
    system = StreamingSlam(c, total_frames=8)  # the card by default
    w = 2 * np.pi / 20.0
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3],
                     vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]))
    return system, seq


@pytest.mark.gpu
def test_streaming_runs_the_kernel_on_the_card():
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml

    system, seq = _tiny_system()
    launches, gathers = ml.launches, gt.launches["gather_rows"]
    for i in range(4):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = system.sync()
    assert ml.launches == launches + 3  # one per tracked frame
    assert gt.launches["gather_rows"] >= gathers + 2 * 3  # two per tracked frame
    assert not out["failed"] and np.all(np.isfinite(out["odom_poses"]))
    err = np.linalg.norm(out["odom_poses"][:, :3, 3] - seq.poses[:4, :3, 3], axis=1)
    assert err.max() < 0.1, err


IDX_TYPES = {"i32": torch.int32, "i64": torch.int64}
# (table rows, row width, indices): the probes' widths and one width that is
# neither (a multiple of 4 floats), at sizes that end inside a block
ROW_SHAPES = {"w4": (32768, 4, 131072), "w8": (98304, 8, 98304),
              "w128": (4096, 128, 4099), "w12_ragged": (1001, 12, 777)}


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("shape", sorted(ROW_SHAPES))
def test_gather_rows_kernel_is_exact(shape, idx_type):
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    rows, width, count = ROW_SHAPES[shape]
    rng = np.random.default_rng(rows + width)
    table = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(np.sort(rng.integers(0, rows, count))).to(dev, IDX_TYPES[idx_type])
    before = gt.launches["gather_rows"]
    out = gt.gather_rows(table, idx)
    assert gt.launches["gather_rows"] == before + 1
    assert torch.equal(out, gt.gather_rows_reference(table, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
def test_gather_lanes_kernel_is_exact(idx_type):
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.normal(size=(1531, 128)).astype(np.float32)).to(dev)
    sel = torch.from_numpy(rng.integers(0, 128, (1531, 37))).to(dev, IDX_TYPES[idx_type])
    before = gt.launches["gather_lanes"]
    out = gt.gather_lanes(src, sel)
    assert gt.launches["gather_lanes"] == before + 1
    assert torch.equal(out, gt.gather_lanes_reference(src, sel))


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
def test_gather_cols_kernel_is_exact(idx_type):
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    rng = np.random.default_rng(4)
    table_t = torch.from_numpy(rng.normal(size=(8, 98304)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(np.sort(rng.integers(0, 98304, 5003))).to(dev, IDX_TYPES[idx_type])
    before = gt.launches["gather_cols"]
    out = gt.gather_cols(table_t, idx)
    assert gt.launches["gather_cols"] == before + 1
    assert torch.equal(out, gt.gather_cols_reference(table_t, idx))


@pytest.mark.gpu
def test_gather_rows_rejects_what_the_kernel_cannot_take():
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    table = torch.zeros(64, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gt.gather_rows(table.t().contiguous().t(), torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="aligned"):
        gt.gather_rows(torch.zeros(64 * 8 + 1, device=dev)[1:].view(64, 8),
                       torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="indices are on"):
        gt.gather_rows(table, torch.zeros(4, dtype=torch.int64))


@pytest.mark.gpu
def test_autograd_loop_gathers_through_the_kernel_on_the_card():
    """A config the fused kernel does not take (leaky ReLU): tracked frames
    map with the autograd loop, map_loop is not launched and every frame
    still gathers its work slab through gather_rows."""
    import warnings

    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops import map_loop as ml

    system, seq = _tiny_system(mlp_leaky_relu=True)
    launches, gathers = ml.launches, gt.launches["gather_rows"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(3):
            system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = system.sync()
    assert ml.launches == launches
    assert gt.launches["gather_rows"] >= gathers + 2 * 2
    assert any("mlp_leaky_relu" in str(w.message) for w in caught)
    assert not out["failed"] and np.all(np.isfinite(out["odom_poses"]))


@pytest.mark.gpu
def test_ordered_cumsum_repeats_bit_for_bit_on_the_card():
    """The pool's eviction draw must not depend on the order in which a
    parallel scan meets its partial sums: the same input gives the same
    bits on every call, within 1e-6 relative of the float64 prefix sum."""
    dev = _cuda()
    from clid_slam_torch.ops.scatter import ordered_cumsum

    e = -torch.log(torch.rand(262145, generator=torch.Generator().manual_seed(1)).clamp(1e-12, 1.0))
    e = e.to(dev)
    first = ordered_cumsum(e)
    for _ in range(20):
        assert torch.equal(ordered_cumsum(e), first)
    want = torch.cumsum(e.double(), 0)
    assert float(((first.double() - want).abs() / want).max()) < 1e-6


@pytest.mark.gpu
def test_streaming_repeats_bit_for_bit_on_the_card():
    """Two systems from one seed, frame by frame: every state tensor equal
    after every frame. The pool is small enough to be full from frame 1, so
    the eviction draw (a float prefix sum, ops/scatter.py:ordered_cumsum)
    runs on the tracked frames."""
    a, seq = _tiny_system(pool_capacity=1 << 16)
    b, _ = _tiny_system(pool_capacity=1 << 16)
    for i in range(4):
        for system in (a, b):
            system.process_frame(i, seq.scans[i], seq.imu_windows[i])
        sa, sb = a.state, b.state
        for x, y in zip(
            [sa.rot, sa.pos, sa.rest, sa.P, sa.odom_poses, sa.losses, *sa.map_state.tensors(),
             *sa.pool.tensors(), *sa.mlp.tensors()],
            [sb.rot, sb.pos, sb.rest, sb.P, sb.odom_poses, sb.losses, *sb.map_state.tensors(),
             *sb.pool.tensors(), *sb.mlp.tensors()],
        ):
            assert torch.equal(x, y), i
    assert int(a.state.pool.size) == 1 << 16  # the pool was full: rows were evicted
