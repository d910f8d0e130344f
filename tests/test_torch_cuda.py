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

import functools

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


def _inputs(bs, n_hidden, dev, seed=5, k=K, p=P, h=H, bd=None):
    from clid_slam_torch.models.decoder import MLPParams

    K, P, H = k, p, h
    rng = np.random.default_rng(seed)
    bd = bd or max(1, bs // DEC // 4)
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


def _run_loop(fn, x, n_it, dev, max_iters=20, mlp_lr=LR, **kw):
    return fn(*x["args"], torch.tensor(n_it, dtype=torch.int32, device=dev), max_iters,
              mlp_lr, x["denom_inv"], x["eik_inv"], **KW, **kw)


def _kernel(streamed):
    """The kernel's entry: ``map_loop``, or the launch with the slab kept in
    device memory whatever the plan would choose."""
    from clid_slam_torch.ops import map_loop as ml

    return functools.partial(ml._launch, True) if streamed else ml.map_loop


def _assert_matches_plain(x, n_it, dev, layer_norm, streamed=False):
    """The kernel against its plain version under chip_smoke.py's limits:
    one step elementwise (or < 2 lr where the gradient is at the noise
    floor, as Adam's first step is a sign function there); n steps: features
    max < 3 lr and p99 <= 1e-5, losses rtol 1e-4, MLP max < 3 lr and median
    <= 1e-5."""
    from clid_slam_torch.ops import map_loop as ml

    before = ml.launches
    fk, mk, lk = _run_loop(_kernel(streamed), x, n_it, dev, layer_norm=layer_norm)
    fr, mr, lr_ = _run_loop(ml.map_loop_reference, x, n_it, dev, layer_norm=layer_norm)
    torch.cuda.synchronize()
    assert ml.launches == before + 1
    d = (fk - fr).abs()
    if n_it == 1:
        step = (fr - x["args"][0]).abs()
        noise = (step > 0) & (step < 0.999 * LR)
        assert bool(((d <= 1e-6 + 1e-5 * fr.abs()) | (noise & (d < 2 * LR))).all()), float(d.max())
    d = d.flatten().cpu().numpy()
    assert d.max() < 3 * LR and np.quantile(d, 0.99) <= 1e-5, (d.max(), np.quantile(d, 0.99))
    np.testing.assert_allclose(lk.cpu().numpy(), lr_.cpu().numpy(), rtol=1e-4, atol=0)
    md = torch.cat([(a - b).abs().flatten() for a, b in zip(mk.tensors(), mr.tensors())])
    md = md.cpu().numpy()
    assert md.max() < 3 * LR and np.median(md) <= 1e-5, (md.max(), np.median(md))


@pytest.mark.gpu
@pytest.mark.parametrize("layer_norm", [False, True], ids=["plain", "ln"])
@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("n_hidden", [1, 2])
def test_map_loop_every_variant_matches_plain_version(n_hidden, hidden, layer_norm):
    dev = _cuda()
    x = _inputs(2048, n_hidden, dev, seed=7, h=hidden)
    for n_it in (1, 5):
        _assert_matches_plain(x, n_it, dev, layer_norm)


# (bs, K, P, bd or None, streamed): neighbour counts and encoding widths at
# their limits, a batch that is not a multiple of any grid, the last tap on
# the last sample, and slabs kept in device memory, forced at a small batch
# and chosen by the plan at a batch whose slab does not fit on an SM
EDGE = {
    "K1_P0": (1024, 1, 0, None, False),
    "K8_P8": (1024, 8, 8, None, False),
    "K6_P3_bs1001": (1001, 6, 3, None, False),
    "last_tap_on_last_sample": (1001, 6, 3, 101, False),
    "streamed_small": (1001, 8, 3, None, True),
    "streamed_bs65536_K8": (65536, 8, 3, None, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EDGE))
def test_map_loop_edge_shapes_match_plain_version(case):
    from clid_slam_torch.ops import map_loop as ml

    dev = _cuda()
    bs, k, p, bd, streamed = EDGE[case]
    x = _inputs(bs, 2 if k == 8 else 1, dev, seed=11, k=k, p=p, bd=bd)
    if bd is not None:
        assert (bd - 1) * DEC == bs - 1
    plan = ml.plan(bs, k, p, H, 2 if k == 8 else 1, True, x["args"][7].shape[0], DEC, dev, streamed)
    if case.startswith("streamed"):
        assert not plan.resident and plan.work > 0
    for n_it in (1, 4):
        _assert_matches_plain(x, n_it, dev, True, streamed)


@pytest.mark.gpu
def test_map_loop_step_counts():
    """n_iters 0 passes the features and the MLP through with zero losses;
    n_iters below max_iters stops there; above it, max_iters caps it."""
    from clid_slam_torch.ops import map_loop as ml

    dev = _cuda()
    x = _inputs(1024, 1, dev)
    f0, mlp0 = x["args"][0], x["args"][8]
    f, mlp, losses = _run_loop(ml.map_loop, x, 0, dev)
    assert torch.equal(f, f0) and not bool(losses.any())
    assert all(torch.equal(a, b) for a, b in zip(mlp.tensors(), mlp0.tensors()))
    _assert_matches_plain(x, 3, dev, False)
    capped = _run_loop(ml.map_loop, x, 9, dev, max_iters=4)
    four = _run_loop(ml.map_loop, x, 4, dev, max_iters=20)
    for a, b in zip([capped[0], *capped[1].tensors(), capped[2]],
                    [four[0], *four[1].tensors(), four[2]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_map_loop_repeats_bit_for_bit(streamed):
    """No float atomics: two calls on the same inputs give the same bits."""
    dev = _cuda()
    x = _inputs(16384, 1, dev, seed=3)
    a = _run_loop(_kernel(streamed), x, 10, dev, layer_norm=True)
    b = _run_loop(_kernel(streamed), x, 10, dev, layer_norm=True)
    for u, v in zip([a[0], *a[1].tensors(), a[2]], [b[0], *b[1].tensors(), b[2]]):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_map_loop_plan_at_the_bench_shapes():
    """One persistent launch: as many blocks as fit on the card at once, at
    the bench shapes with the slab in shared memory; a slab too large for an
    SM streams from device memory."""
    from clid_slam_torch.ops import map_loop as ml

    dev = _cuda()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ml.plan(16384, 6, 3, 64, 1, False, 1638, DEC, dev)
    assert plan.resident and plan.grid % n_sm == 0 and plan.spc * plan.grid >= 16384
    assert plan.smem_bytes <= 232448 and plan.work == 0
    big = ml.plan(65536, 8, 3, 64, 2, True, 1638, DEC, dev)
    assert not big.resident and big.work > 0


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
# (table rows, row width, indices): the probes' widths, one width that is
# neither (a multiple of 4 floats), and widths that are not multiples of 4
# (single-float pieces; feature_dim 6), at sizes that end inside a block
ROW_SHAPES = {"w4": (32768, 4, 131072), "w8": (98304, 8, 98304),
              "w128": (4096, 128, 4099), "w12_ragged": (1001, 12, 777),
              "w6": (98304, 6, 98304), "w3_ragged": (1001, 3, 777)}


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


@functools.lru_cache(maxsize=1)
def _mirror_cases():
    from clid_slam_torch.tools import probe_gather as pg

    return {c["variant"]: c for c in pg.mirror_cases()}


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("variant", ["mirror mapper probe", "mirror tracker probe",
                                     "mirror local map", "mirror insert"])
def test_gather_rows_kernel_is_exact_at_the_mirror_shapes(variant, idx_type):
    """The main path's hash-mirror gathers: [2^22, 4] and [2^21, 4] tables
    whose empty buckets hold the 1e9 sentinel, neighbour-cell buckets of a
    frame's points, int32 and int64."""
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    case = _mirror_cases()[variant]
    table = torch.from_numpy(case["table"]).to(dev)
    idx = torch.from_numpy(case["idx"]).to(dev, IDX_TYPES[idx_type])
    before = gt.launches["gather_rows"]
    out = gt.gather_rows(table, idx)
    assert gt.launches["gather_rows"] == before + 1
    want = gt.gather_rows_reference(table, idx)
    assert torch.equal(out, want)
    empty = want[:, 0] > 1e8
    assert 0 < int(empty.sum()) < want.shape[0]  # sentinel and occupied rows both met


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("count", [1, 8 * 256 * 3 + 13, 8 * 256 * 132 * 8 + 5])
def test_gather_rows_kernel_at_ragged_and_striding_counts(count, width, idx_type):
    """One row, a count that ends inside a block, and a count larger than
    the card's resident grid holds (the grid strides), for 16-byte and
    single-float pieces."""
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    rng = np.random.default_rng(count + width)
    table = torch.from_numpy(rng.normal(size=(5000, width)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 5000, count)).to(dev, IDX_TYPES[idx_type])
    out = gt.gather_rows(table, idx)
    assert torch.equal(out, gt.gather_rows_reference(table, idx))


@pytest.mark.gpu
def test_gather_rows_of_zero_rows_launches_nothing():
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    before = gt.launches["gather_rows"]
    out = gt.gather_rows(torch.zeros(64, 4, device=dev), torch.zeros(0, dtype=torch.int64, device=dev))
    assert out.shape == (0, 4) and out.is_cuda
    assert gt.launches["gather_rows"] == before


@pytest.mark.gpu
def test_mirror_probes_gather_through_the_kernel_on_the_card():
    """The neural map's probe and insert and the local map's labels gather
    their mirror rows through gather_rows on the card."""
    from clid_slam_torch.models import local_map as lm
    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops.voxel import neighbor_offsets

    dev = _cuda()
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(rng.normal(0, 2.0, (3000, 3)).astype(np.float32)).to(dev)
    ones = torch.ones(3000, dtype=torch.bool, device=dev)
    td = torch.zeros(8, device=dev)
    state = nm.init_map(1 << 13, 1 << 15, 8, device=dev)
    before = gt.launches["gather_rows"]
    state, _ = nm.insert_points(state, pts, ones, 0.3, td, 0, 1e9)
    assert gt.launches["gather_rows"] == before + 1
    nb = torch.as_tensor(neighbor_offsets(2, 0.5), device=dev)
    d2, h, valid, mir = nm.neighborhood_probe(state, pts, nb, 0.3, 1.0)
    assert gt.launches["gather_rows"] == before + 2
    assert torch.equal(mir, state.hash_mirror[h])
    local = lm.update_local_map(lm.init_local_map(1 << 13, 1 << 14, device=dev),
                                torch.zeros(3, device=dev), pts, ones, 0.2, 10.0, crop_now=False)
    lm.region_specific_sdf(local, pts, 0.2)
    assert gt.launches["gather_rows"] == before + 3


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
