"""Card-only tests of the port: the hand-written kernels (map_loop and the
three gathers) against their plain PyTorch versions, and short streaming runs
that go through them. A gather copies bits, so its comparison is exact.

They skip without a CUDA card (the kernel has no CPU mode). This file
imports neither JAX nor clid_slam_tpu, so the card's machine runs it
without them; there, run it without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The cached tracker's iterations, replayed from a CUDA graph, equal the
eager loop on the card bit for bit: at each exit, with each option, across
frames, and in a short stream. So does a tracked frame's map prep replayed
from its CUDA graphs, against the eager prep, over frames of new inputs in
each pool-filter variant and in a stream; its capture leaves the state and
the generator as they were, and prep, the step count and the fused
kernel's mapping step wait for nothing on the host. A tracked frame's
predict and bookkeep replayed from their CUDA graphs equal the eager stages
bit for bit over frames whose crop range, IMU rows and id change, captured
at the first tracked frame or in ``precompile()``; they wait for nothing,
leave earlier states as they were and count the operations they hide.

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


@pytest.mark.gpu
@pytest.mark.parametrize("entry,n", [("map_loop", 36), ("plan", 9)])
def test_map_loop_module_refuses_a_wrong_argument_count(entry, n):
    """The kernel's module entries (``csrc/map_loop.cu``) count their
    arguments: one too few or too many raises ``TypeError`` before any
    launch, as does a float where an int goes; the card is left as it was."""
    from clid_slam_torch.ops import _build

    _cuda()
    fn = getattr(_build.load_module("map_loop"), entry)
    for args in ([0] * (n - 1), [0] * (n + 1), [0.5] + [0] * (n - 1)):
        with pytest.raises(TypeError):
            fn(*args)
    torch.cuda.synchronize()


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


# gather_lanes: (rows, lanes in, lanes out) at the probe's shape, the
# selection's, one that ends inside a staged tile, K 4 of 128 and one row;
# sources of each lane width the kernel copies. The shapes pick the
# kernel's regime (csrc/gather.cu): probe and tile_end (K >= L / 4, K % 4
# == 0) run staged, the others narrow.
LANE_SHAPES = {"probe": (16384, 128, 128), "select_mapper": (16384, 81, 6),
               "select_tracker": (8192, 81, 16), "ragged": (1531, 128, 37),
               "tile_end": (1003, 128, 64), "k4": (4099, 128, 4), "one_row": (1, 81, 1)}
LANE_KINDS = {"bool": (torch.bool, ()), "f32": (torch.float32, ()),
              "i64": (torch.int64, ()), "f32x4": (torch.float32, (4,))}


def _lanes_inputs(shape, kind, idx_type, dev, seed=3):
    rows, lanes, k = LANE_SHAPES[shape]
    dtype, tail = LANE_KINDS[kind]
    g = torch.Generator().manual_seed(seed)
    if dtype is torch.bool:
        src = torch.rand((rows, lanes), generator=g) < 0.5
    elif dtype is torch.int64:
        src = torch.randint(-(1 << 62), 1 << 62, (rows, lanes), generator=g)
    else:
        src = torch.randn((rows, lanes, *tail), generator=g)
    sel = torch.randint(0, lanes, (rows, k), generator=g)
    return src.to(dev), sel.to(dev, IDX_TYPES[idx_type])


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("kind", sorted(LANE_KINDS))
@pytest.mark.parametrize("shape", sorted(LANE_SHAPES))
def test_gather_lanes_kernel_is_exact(shape, kind, idx_type):
    """Every lane width and both selector types, in the regime each shape
    takes, equal the plain version bit for bit and launch once."""
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    src, sel = _lanes_inputs(shape, kind, idx_type, dev)
    before = gt.launches["gather_lanes"]
    out = gt.gather_lanes(src, sel)
    torch.cuda.synchronize()
    assert gt.launches["gather_lanes"] == before + 1
    want = gt.gather_lanes_reference(src, sel)
    assert out.dtype == want.dtype and torch.equal(out, want)


@functools.lru_cache(maxsize=1)
def _selection_cases():
    from clid_slam_torch.tools import probe_gather as pg

    return {c["variant"]: c for c in pg.selection_cases()}


@pytest.mark.gpu
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("variant", [f"select {w} {s}" for w in ("mapper", "tracker")
                                     for s in ("d2s", "h", "pvalid", "mir")])
def test_gather_lanes_kernel_is_exact_at_the_selection_shapes(variant, idx_type):
    """The kNN selection's lane gathers with the path's selectors
    (smallest_k of a frame's probe), as the path hands them over (the
    first K columns of the sort, rows 81 apart) and contiguous."""
    from clid_slam_torch.models.neural_map import smallest_k
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    case = _selection_cases()[variant]
    src = torch.from_numpy(case["table"]).to(dev)
    strided = torch.from_numpy(case["idx"]).to(dev, IDX_TYPES[idx_type])[:, :case["k"]]
    assert strided.stride() == (81, 1)
    if variant.endswith("d2s"):
        assert torch.equal(smallest_k(src, case["k"]), strided.long())
    want = gt.gather_lanes_reference(src, strided)
    assert torch.equal(gt.gather_lanes(src, strided), want)
    assert torch.equal(gt.gather_lanes(src, strided.contiguous()), want)


@functools.lru_cache(maxsize=1)
def _dynba_cases():
    from clid_slam_torch.tools import probe_gather as pg

    return {c["variant"]: c for c in pg.dynba_cases()}


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["BA pose gather", "mirror filter probe", "query feats BA",
                                     "query feats filter"] + [
                                         f"select filter {s}" for s in ("d2s", "h", "pvalid", "mir")])
def test_gather_kernels_are_exact_at_the_filter_and_ba_shapes(variant):
    """The dynamic filter's and BA's gathers with the path's indices (int64,
    the selectors strided as smallest_k hands them over): one launch each,
    equal to the plain version bit for bit."""
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    case = _dynba_cases()[variant]
    table = torch.from_numpy(case["table"]).to(dev)
    idx = torch.from_numpy(case["idx"]).to(dev)
    if "k" in case:
        idx = idx[:, :case["k"]]
    before = dict(gt.launches)
    out = getattr(gt, case["kernel"])(table, idx)
    assert gt.launches[case["kernel"]] == before[case["kernel"]] + 1
    assert torch.equal(out, getattr(gt, case["kernel"] + "_reference")(table, idx))


@pytest.mark.gpu
def test_gather_lanes_kernel_passes_the_gradient():
    """A source that needs a gradient (query_feature's distances when its
    points do): the kernel's output carries torch.gather's backward."""
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    src, _ = _lanes_inputs("select_mapper", "f32", "i64", dev)
    # distinct lanes a row, as smallest_k picks them (repeated lanes would
    # sum their gradients in an order that differs between runs)
    sel = torch.argsort(torch.rand(src.shape, device=dev), dim=1)[:, :6]
    a, b = src.clone().requires_grad_(True), src.clone().requires_grad_(True)
    w = torch.randn(sel.shape, device=dev)
    before = gt.launches["gather_lanes"]
    (gt.gather_lanes(a, sel) * w).sum().backward()
    (torch.gather(b, 1, sel) * w).sum().backward()
    assert gt.launches["gather_lanes"] == before + 1
    assert torch.equal(a.grad, b.grad)


def _query_gradients(state, mlp, points, nb, travel):
    """The gradients of query_feature's decoded SDF wrt the points and the
    features (as the dynamic filter and BA take them)."""
    from dataclasses import replace

    from clid_slam_torch.models import decoder as dec
    from clid_slam_torch.models import neural_map as nm

    p = points.clone().requires_grad_(True)
    f = state.geo_feats.clone().requires_grad_(True)
    q = nm.query_feature(replace(state, geo_feats=f), p, nb, 0.3, 2.43, 6, travel, 0, 1e9, True)
    pred = dec.sdf(mlp, q.feature, 0.055)
    return torch.autograd.grad(torch.sum(pred + pred**2), (p, f))


@pytest.mark.gpu
def test_query_feature_gradients_on_the_card(monkeypatch):
    """Through the gather kernels (4 gather_lanes, 2 gather_rows launches)
    the gradients wrt the points (the lane gathers' backward) and wrt the
    features (gather_rows_nd's sorted backward) equal, bit for bit, those
    of the plain versions on the card and of a second kernel run, and the
    CPU's within 1e-6 of their largest magnitude."""
    from clid_slam_torch.models import decoder as dec
    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.ops.voxel import neighbor_offsets

    dev = _cuda()
    rng = np.random.default_rng(4)
    u = rng.normal(size=(6000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    travel = torch.zeros(8, device=dev)
    state = nm.init_map(1 << 13, 1 << 15, 8, device=dev)
    state, _ = nm.insert_points(state, torch.from_numpy((u * 3.0).astype(np.float32)).to(dev),
                                torch.ones(6000, dtype=torch.bool, device=dev), 0.3, travel, 0, 1e9,
                                downsample=False)
    count = int(state.count)
    feats = state.geo_feats.clone()
    feats[:count] = torch.from_numpy(rng.normal(0, 0.1, (count, 8)).astype(np.float32)).to(dev)
    state = state._replace(geo_feats=feats)
    mlp = dec.init_mlp(torch.Generator(device=dev).manual_seed(1), 11, 64, 1)
    v = rng.normal(size=(4000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = torch.from_numpy((v * rng.uniform(2.7, 3.3, (4000, 1))).astype(np.float32)).to(dev)
    nb = torch.as_tensor(neighbor_offsets(2, 0.5), device=dev)

    before = dict(gt.launches)
    kernel = _query_gradients(state, mlp, pts, nb, travel)
    assert gt.launches["gather_lanes"] == before["gather_lanes"] + 4
    assert gt.launches["gather_rows"] == before["gather_rows"] + 2
    again = _query_gradients(state, mlp, pts, nb, travel)

    def plain_lanes(src, sel):
        if src.requires_grad and torch.is_grad_enabled():
            return gt._LanesBackward.apply(src, sel)
        return gt.gather_lanes_reference(src, sel)

    with monkeypatch.context() as m:
        m.setattr(gt, "gather_rows", gt.gather_rows_reference)
        m.setattr(gt, "gather_lanes", plain_lanes)
        m.setattr(nm, "gather_lanes", plain_lanes)
        before = dict(gt.launches)
        plain = _query_gradients(state, mlp, pts, nb, travel)
        assert gt.launches == before
    to_cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    cpu_state = nm.NeuralMapState(*[to_cpu(x) for x in state.tensors()])
    cpu_mlp = dec.MLPParams([w.cpu() for w in mlp.weights], [b.cpu() for b in mlp.biases],
                            mlp.w_out.cpu(), mlp.b_out.cpu())
    cpu = _query_gradients(cpu_state, cpu_mlp, pts.cpu(), nb.cpu(), travel.cpu())
    for k, a, p, c in zip(kernel, again, plain, cpu):
        assert torch.equal(k, a) and torch.equal(k, p)
        assert float((k.cpu() - c).abs().max()) <= 1e-6 * max(1.0, float(c.abs().max()))
        assert float(c.abs().max()) > 0
    assert int((kernel[1].abs().sum(1) > 0).sum()) > 100  # many feature rows get a gradient


@pytest.mark.gpu
def test_gather_lanes_rejects_what_the_kernel_cannot_take():
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    sel = torch.zeros((64, 6), dtype=torch.int64, device=dev)
    base = torch.zeros(64 * 81 * 4 + 4, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        gt.gather_lanes(base[1:1 + 64 * 81 * 4].view(64, 81, 4), sel)
    with pytest.raises(ValueError, match="contiguous"):
        gt.gather_lanes(torch.zeros(81, 64, device=dev).t(), sel)
    with pytest.raises(ValueError, match="adjacent"):
        gt.gather_lanes(torch.zeros(64, 81, device=dev), torch.zeros((6, 64), dtype=torch.int64,
                                                                    device=dev).t())
    with pytest.raises(ValueError, match="selectors on"):
        gt.gather_lanes(torch.zeros(64, 81, device=dev), sel.cpu())


# gather_cols: (table rows, table width, count) at the probe's shape, counts
# that are not a multiple of 4, one row and one index
COL_SHAPES = {"probe": (8, 98304, 98304), "ragged": (8, 98304, 5003),
              "ragged_3": (8, 1000, 4099), "one_row": (1, 5000, 4096), "one": (3, 7, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("idx_type", sorted(IDX_TYPES))
@pytest.mark.parametrize("shape", sorted(COL_SHAPES))
def test_gather_cols_kernel_is_exact(shape, idx_type, offset):
    """Sorted indices with duplicates as the probe's, on the 16-byte path
    and (counts not a multiple of 4, or indices one element off their
    16-byte alignment: ``offset``) on the single-float one."""
    from clid_slam_torch.ops import gather as gt

    dev = _cuda()
    rows, width, count = COL_SHAPES[shape]
    rng = np.random.default_rng(rows + count)
    table_t = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(np.sort(rng.integers(0, width, count + offset))).to(
        dev, IDX_TYPES[idx_type])[offset:]
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
def test_tracked_frames_gather_lanes_in_the_tracker_and_the_mapper(monkeypatch):
    """Each tracked frame picks its kNN lanes through the gather_lanes
    kernel: 3 launches from the tracker's candidates, 4 from the mapper's
    batch."""
    from clid_slam_torch.mapping import mapper
    from clid_slam_torch.odometry import iekf
    from clid_slam_torch.ops import gather as gt

    system, seq = _tiny_system()
    system.process_frame(0, seq.scans[0], seq.imu_windows[0])
    system.sync()
    by_site = {"tracker": 0, "mapper": 0}
    for site, module in (("tracker", iekf), ("mapper", mapper)):
        def counted(src, sel, site=site):
            before = gt.launches["gather_lanes"]
            out = gt.gather_lanes(src, sel)
            by_site[site] += gt.launches["gather_lanes"] - before
            return out
        monkeypatch.setattr(module, "gather_lanes", counted)
    for i in (1, 2):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = system.sync()
    assert by_site == {"tracker": 3 * 2, "mapper": 4 * 2}
    assert not out["failed"]


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


@pytest.mark.gpu
def test_bf16_decoding_on_the_card():
    """bf16 decoding multiplies bf16-rounded operands as f32 tensors (exact
    products, f32 sums): on the card it equals the CPU's up to the order of
    the sums, the relative error's 99th percentile within 1e-5 and the
    largest within 2^-7 of the output's scale (a hidden activation on a
    bf16 rounding boundary may round the other way). Where this PyTorch has
    ``torch.mm(..., out_dtype=torch.float32)`` for bf16 operands, a layer
    through it agrees with the f32 form to 1e-6 of its scale."""
    from clid_slam_torch.models import decoder as dec

    dev = _cuda()
    mlp = dec.init_mlp(torch.Generator().manual_seed(3), 11, 64, 2, 1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(16384, 11)).astype(np.float32))
    to = lambda m, d: dec.MLPParams([w.to(d) for w in m.weights], [b.to(d) for b in m.biases],
                                    m.w_out.to(d), m.b_out.to(d))
    want = dec.mlp_forward(mlp, x, bf16=True)
    got = dec.mlp_forward(to(mlp, dev), x.to(dev), bf16=True).cpu()
    scale = float(want.abs().max())
    rel = (got - want).abs() / want.abs().clamp(min=1e-6 * scale)
    assert float(torch.quantile(rel.flatten(), 0.99)) <= 1e-5
    assert float((got - want).abs().max()) <= 2.0**-7 * scale
    a, b = x.to(dev).to(torch.bfloat16), mlp.weights[0].to(dev).to(torch.bfloat16)
    try:
        fused = torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return  # not in this PyTorch: the f32 form above is the one the port runs
    upcast = a.float() @ b.float()
    assert fused.dtype == torch.float32
    assert float((fused - upcast).abs().max()) <= 1e-6 * float(upcast.abs().max())


@pytest.mark.gpu
def test_color_slab_gathers_through_gather_rows_on_the_card():
    """With color and semantics on, a tracked frame gathers the color work
    slab and its expanded references through gather_rows beside the
    geometric ones (8 launches a tracked frame, not 6), and the color slab's
    gather at a batch's work rows equals the plain version bit for bit."""
    import warnings

    from clid_slam_torch.mapping import mapper as mp
    from clid_slam_torch.ops import gather as gt

    opts = dict(color_on=True, color_channel=1, semantic_on=True, sem_class_count=20)
    system, seq = _tiny_system(**opts)
    system.process_frame(0, seq.scans[0], seq.imu_windows[0])
    system.block()
    before = gt.launches["gather_rows"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in (1, 2):
            system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    out = system.sync()
    assert gt.launches["gather_rows"] - before >= 8 * 2
    assert not out["failed"] and np.all(np.isfinite(out["odom_poses"]))
    st, cfg = system.state, system.cfg
    assert st.map_state.color_feats.shape[1] == cfg.feature_dim
    fn = mp.make_mapping_fn(
        feature_dim=cfg.feature_dim, knn_k=cfg.query_nn_k, nb_offs=system.nb_offs,
        resolution=cfg.voxel_size_m, max_valid_dist2=3.0 * (3 * cfg.voxel_size_m) ** 2,
        sdf_scale=cfg.sdf_scale, sigma=cfg.sdf_scale, bs=cfg.bs, bs_new=cfg.bs_new_sample,
        gradient_decimation=cfg.gradient_decimation, num_grad_eps=cfg.num_grad_eps,
        weight_e=cfg.weight_e, loss_weight_on=cfg.loss_weight_on, lr=cfg.lr,
        adam_eps=cfg.adam_eps, color_on=True, sem_on=True, max_outer=1,
    )
    c = fn.build_cache(st.map_state, st.pool, st.travel_dist, 2, 1e9,
                       torch.Generator(device=st.pool.data.device).manual_seed(0), None)
    n0 = gt.launches["gather_rows"]
    got = gt.gather_rows(st.map_state.color_feats, c.src_rows)
    assert gt.launches["gather_rows"] == n0 + 1
    assert torch.equal(got, gt.gather_rows_reference(st.map_state.color_feats, c.src_rows))
    assert bool((got != 0).any())


@pytest.mark.gpu
def test_every_option_repeats_bit_for_bit_on_the_card():
    """Decode-then-weight, bf16 decoding and the color and semantic heads
    together: two systems from one seed agree in every state tensor after
    every frame (the autograd loop's backward sums in a fixed order)."""
    import warnings

    opts = dict(weighted_first=False, mlp_bf16=True, color_on=True, color_channel=1,
                semantic_on=True, sem_class_count=20)
    a, seq = _tiny_system(**opts)
    b, _ = _tiny_system(**opts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(4):
            for system in (a, b):
                system.process_frame(i, seq.scans[i], seq.imu_windows[i])
            for x, y in zip(a.state.leaves(), b.state.leaves()):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), i
    assert not a.sync()["failed"]


@pytest.mark.gpu
@pytest.mark.parametrize("driver", ["streaming", "classic"])
def test_map_pallas_off_runs_no_fused_kernel_and_warns_nothing(driver):
    """``map_pallas: false``: tracked frames map on the autograd loop (the
    JAX package's loop off the Pallas path), so ``map_loop`` makes no
    launch, and no RuntimeWarning names a reason; ``map_pallas: true``
    launches it once per tracked frame."""
    import warnings

    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.pipeline.slam import SlamSystem

    counts = {}
    for flag in (False, True):
        system, seq = _tiny_system(map_pallas=flag)
        if driver == "classic":
            system = SlamSystem(system.cfg, total_frames=8)
            x = system.tracker.x
            x.rot, x.pos = seq.poses[0][:3, :3].copy(), seq.poses[0][:3, 3].copy()
            x.vel = seq.poses[0][:3, :3] @ np.array([3.0 * 2 * np.pi / 20.0, 0, 0])
        run = lambda i: system.process_frame(i, seq.scans[i], seq.imu_windows[i])
        run(0)
        before = ml.launches
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            for i in (1, 2, 3):
                run(i)
        torch.cuda.synchronize()
        counts[flag] = ml.launches - before
    assert counts == {False: 0, True: 3}, counts


@pytest.mark.gpu
@pytest.mark.parametrize("rotate_vecs", [False, True], ids=["plain_queries", "post_pgo"])
def test_mesh_through_the_kernels_equals_the_plain_gathers(monkeypatch, rotate_vecs):
    """A small map (3 frames of the tiny sequence) meshed on the card at
    chunk_dim 48: each chunk queries through the hand gathers (2
    gather_rows and 4 gather_lanes launches a chunk, 3 gather_rows with the
    post-PGO quaternion rows), and the welded mesh, the slice and the
    vertex colors equal those of the same calls with the gathers swapped
    for their plain versions, bit for bit."""
    from clid_slam_torch.mesher import Mesher
    from clid_slam_torch.models import neural_map as nm
    from clid_slam_torch.ops import gather as gt

    system, seq = _tiny_system()
    for i in range(3):
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])
    system.block()
    cfg, st = system.cfg, system.state
    mesher = Mesher(knn_k=cfg.query_nn_k, nb_offs=system.nb_offs, resolution=cfg.voxel_size_m,
                    max_valid_dist2=3.0 * ((cfg.num_nei_cells + 1) * cfg.voxel_size_m) ** 2,
                    sdf_scale=cfg.sdf_scale, mesh_min_nn=cfg.mesh_min_nn,
                    feature_dim=cfg.feature_dim, rotate_vecs=rotate_vecs)
    # a color slab of feature_dim columns from a seed (the map has none)
    gen = torch.Generator(device=st.mlp.w_out.device).manual_seed(0)
    state = st.map_state._replace(color_feats=torch.randn(
        (st.map_state.geo_feats.shape[0], cfg.feature_dim), generator=gen, device=gen.device))
    n = int(state.count)
    pts = state.positions[:n].cpu().numpy()

    def mesh():
        soup, chunks = mesher.triangle_soup(state, st.mlp, pts.min(0), pts.max(0), 0.1,
                                            guide_points=pts)
        v, t = mesher.recon_aabb_mesh(state, st.mlp, pts.min(0), pts.max(0), 0.1,
                                      min_cluster_vertices=50, guide_points=pts)
        s = mesher.sdf_slice(state, st.mlp, pts.mean(0), 6.0, 0.1, 0.1)
        c = mesher.estimate_vertex_colors(state, st.color_mlp, v[:5000])
        return chunks, (soup, v, t, *s, c)

    gt.reset_launches()
    chunks, kernel = mesh()
    rows = 3 if rotate_vecs else 2
    per_query = chunks * 2 + 2  # the soup's and the mesh's chunks, the slice's and colors' batches
    assert gt.launches["gather_lanes"] >= 4 * per_query
    assert gt.launches["gather_rows"] >= rows * per_query
    assert len(kernel[1]) > 2000

    def plain_lanes(src, sel):
        return gt.gather_lanes_reference(src, sel)

    with monkeypatch.context() as m:
        m.setattr(gt, "gather_rows", gt.gather_rows_reference)
        m.setattr(gt, "gather_lanes", plain_lanes)
        m.setattr(nm, "gather_lanes", plain_lanes)
        before = dict(gt.launches)
        _, plain = mesh()
        assert gt.launches == before
    for a, b in zip(kernel, plain):
        np.testing.assert_array_equal(a, b)


class _EagerIterations:
    """Stands in for ``iekf._GraphedIterations``: the eager loop on the card,
    the graph's reference."""

    def __init__(self, make_h_reduce, inputs, loop_kw):
        self.make_h_reduce, self.loop_kw = make_h_reduce, loop_kw

    def run(self, inputs):
        from clid_slam_torch.odometry import iekf

        cands, mlp, points, mask, rot0, pos0, rest0, P = inputs
        h_reduce = self.make_h_reduce(cands, mlp, points, mask)
        return iekf._iterated_update(h_reduce, mask, rot0, pos0, rest0, P, **self.loop_kw)


def _tracker_inputs(seed, dev, n=2048, c=16, f=8, pos_dim=3, quats=False):
    """Built candidates, a decoder, scan points and a start for the cached
    update's dense iterations: points on a sphere of radius 3 seen from
    inside, neural points scattered about the surface (with ``quats``, each
    with a random orientation), a pose off by a few centimetres and half a
    degree. The decoder takes ``f`` features and a ``pos_dim`` wide
    position (an encoded one where it is not 3)."""
    from clid_slam_torch.models.decoder import init_mlp
    from clid_slam_torch.utils import lie

    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    u = rng.standard_normal((n, 3))
    pts = 3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    cand_pos = pts[:, None, :] + rng.normal(0, 0.25, (n, c, 3))
    cvalid = rng.uniform(size=(n, c)) < 0.9
    feat = rng.normal(0, 0.1, (n, c, f)) * cvalid[..., None]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mlp = init_mlp(gen, f + pos_dim, 64, 1, 1)
    mask = rng.uniform(size=n) < 0.95
    rot0 = lie.so3_exp(t(rng.normal(0, np.deg2rad(0.5), 3)))
    rest0 = np.zeros(12)
    rest0[9:12] = [0.0, 0.0, -9.81]
    P = np.eye(18) * 1e-2
    q = rng.standard_normal((n, c, 4))
    cand_quat = t(q / np.linalg.norm(q, axis=-1, keepdims=True)) if quats else None
    return ((t(cand_pos), t(feat), t(cvalid, torch.bool), cand_quat), mlp, t(pts),
            t(mask, torch.bool), rot0, t(rng.normal(0, 0.03, 3)), t(rest0), t(P))


TRACKER_KW = dict(knn_k=6, n_cand=16, nb_offs=np.zeros((1, 3), np.int32), resolution=0.3,
                  max_valid_dist2=3.0 * 0.9 ** 2, sdf_scale=0.055, min_grad_norm=0.0,
                  max_grad_norm=100.0, min_nn_count=1, max_iteration=20, term_thre_deg=0.01,
                  term_thre_m=0.001)
# each exit of the iterations, by its constants
TRACKER_EXITS = {
    "first_iteration": dict(term_thre_deg=1e6, term_thre_m=1e6, eps=1e6),
    "converged": dict(term_thre_deg=0.05, term_thre_m=0.005, eps=0.01, stagnation_iter=50),
    "stalled": dict(term_thre_deg=0.0, term_thre_m=0.0, eps=0.0, stagnation_iter=2),
    "low_valid_max_iteration": dict(term_thre_deg=0.0, term_thre_m=0.0, eps=0.0,
                                    stagnation_iter=50, max_iteration=4, min_valid_ratio=2.0),
}


def _exit_holds(name, n_iter, ok, kw):
    if name == "first_iteration":
        return n_iter == 1 and ok
    if name == "converged":
        return 1 < n_iter < kw["max_iteration"] and ok
    if name == "stalled":
        return kw["stagnation_iter"] < n_iter < kw["max_iteration"] and ok
    return n_iter == kw["max_iteration"] and not ok


@pytest.mark.gpu
@pytest.mark.parametrize("exit_", sorted(TRACKER_EXITS))
def test_tracker_graph_equals_the_eager_loop_at_each_exit(exit_, monkeypatch):
    """The cached update's iterations replayed from one captured CUDA graph
    give the eager loop's rot, pos, rest, P, ok and n_iter bit for bit, at
    each exit of the loop, and count each replay."""
    from torch.profiler import ProfilerActivity, profile

    from clid_slam_torch.odometry import iekf
    from clid_slam_torch.utils import observability as obs

    dev = _cuda()
    kw = dict(TRACKER_KW, **TRACKER_EXITS[exit_])
    inputs = _tracker_inputs(7, dev)
    obs.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        graphed = iekf.make_cached_update_fn(**kw).dense_update(*inputs)
    counted = obs.counters()
    obs.reset_counters()
    with monkeypatch.context() as m:
        m.setattr(iekf, "_GraphedIterations", _EagerIterations)
        eager = iekf.make_cached_update_fn(**kw).dense_update(*inputs)
    for name, g, e in zip(("rot", "pos", "rest", "P", "ok", "n_iter"), graphed, eager):
        assert g.device == e.device and g.dtype == e.dtype and g.shape == e.shape, name
        assert torch.equal(g, e), name
    n_iter, ok = int(eager[5]), bool(eager[4])
    assert _exit_holds(exit_, n_iter, ok, kw), (n_iter, ok)
    assert counted["track.iters"] == counted["track.graph_iters"] == n_iter


# the options that change what an iteration computes
TRACKER_OPTIONS = {
    "rotated_positional": dict(rotate_vecs=True, encode="positional"),
    "gaussian": dict(encode="gaussian"),
    "decode_then_weight_bf16_leaky": dict(weighted_first=False, max_sdf_std=0.5, mlp_bf16=True,
                                          mlp_leaky=True),
}


def _tracker_option(option, seed, dev):
    """The cached update's keywords and inputs with the option ``option``
    of TRACKER_OPTIONS (None: the defaults)."""
    from clid_slam_torch.ops.encoding import make_encoder

    opts = dict(TRACKER_OPTIONS.get(option, {}))
    encode = opts.pop("encode", None)
    encode_vecs, pos_dim = (None, 3) if encode is None else make_encoder(
        num_bands=4, freq=8.0, base=2.0, use_gaussian=encode == "gaussian")
    kw = dict(TRACKER_KW, encode_vecs=encode_vecs, **opts)
    return kw, _tracker_inputs(seed, dev, pos_dim=pos_dim, quats=opts.get("rotate_vecs", False))


@pytest.mark.gpu
@pytest.mark.parametrize("option", sorted(TRACKER_OPTIONS))
def test_tracker_graph_equals_the_eager_loop_with_each_option(option, monkeypatch):
    """Each option's iteration captures (no host constant inside it: the
    quaternions' conjugate, the encoders' tables) and replays to the eager
    loop's bits."""
    from clid_slam_torch.odometry import iekf

    kw, inputs = _tracker_option(option, 5, _cuda())
    graphed = iekf.make_cached_update_fn(**kw).dense_update(*inputs)
    with monkeypatch.context() as m:
        m.setattr(iekf, "_GraphedIterations", _EagerIterations)
        eager = iekf.make_cached_update_fn(**kw).dense_update(*inputs)
    for name, g, e in zip(("rot", "pos", "rest", "P", "ok", "n_iter"), graphed, eager):
        assert torch.equal(g, e), name
    assert int(eager[5]) > 1


@pytest.mark.gpu
def test_one_captured_tracker_graph_serves_frames_with_new_inputs(monkeypatch):
    """One capture, then frames whose candidates, decoder, points, mask,
    start and covariance all change: each replayed frame equals the eager
    loop on its own inputs, so no buffer keeps a stale frame."""
    from clid_slam_torch.odometry import iekf

    dev = _cuda()
    captures = []

    class Counted(iekf._GraphedIterations):
        def __init__(self, *a):
            captures.append(1)
            super().__init__(*a)

    monkeypatch.setattr(iekf, "_GraphedIterations", Counted)
    body = iekf.make_cached_update_fn(**TRACKER_KW)
    frames = [_tracker_inputs(seed, dev) for seed in (11, 12, 13, 12)]
    graphed = []
    for inputs in frames:
        graphed.append(body.dense_update(*inputs))
        # scribble over the allocator's free blocks: a graph that reads memory
        # it does not hold reads this
        junk = [torch.full((n,), 0x7F, dtype=torch.uint8, device=dev)
                for n in (256, 4096, 1 << 16, 1 << 20) for _ in range(64)]
        del junk
    assert len(captures) == 1
    monkeypatch.setattr(iekf, "_GraphedIterations", _EagerIterations)
    eager_body = iekf.make_cached_update_fn(**TRACKER_KW)
    iters = set()
    for inputs, g in zip(frames, graphed):
        e = eager_body.dense_update(*inputs)
        for x, y in zip(g, e):
            assert torch.equal(x, y)
        iters.add(int(e[5]))
    assert not torch.equal(graphed[0][1], graphed[1][1])  # the frames differ
    for x, y in zip(graphed[1], graphed[3]):  # the same inputs again
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_streaming_with_the_tracker_graph_equals_the_eager_loop(monkeypatch):
    """A short stream turning fast (36 degrees a second, so the IESEKF
    iterates several times a frame), once with the captured tracker
    (captured in ``precompile()``) and once with the eager loop on the card:
    the same pose, iteration count and state after every frame."""
    from clid_slam_torch.odometry import iekf
    from clid_slam_torch.pipeline.synthetic import generate_sequence

    graphed, _ = _tiny_system()
    graphed.precompile()
    eager, _ = _tiny_system()
    seq = generate_sequence(n_frames=6, n_azimuth=256, n_elev=24, noise_std=0.01, seed=3,
                            period_frames=100.0)
    for system in (graphed, eager):
        w = 2 * np.pi / 10.0
        system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3],
                         vel=seq.poses[0][:3, :3] @ np.array([3.0 * w, 0, 0]))
    for i in range(6):
        graphed.process_frame(i, seq.scans[i], seq.imu_windows[i])
        with monkeypatch.context() as m:
            m.setattr(iekf, "_GraphedIterations", _EagerIterations)
            eager.process_frame(i, seq.scans[i], seq.imu_windows[i])
        assert torch.equal(graphed.state.odom_poses[i], eager.state.odom_poses[i]), i
        for x, y in zip(graphed.state.leaves(), eager.state.leaves()):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), i
    iters = graphed.sync()["track_iters"][1:6]
    assert np.array_equal(iters, eager.sync()["track_iters"][1:6]) and iters.max() > 2


def _payload_candidates(inputs):
    """``inputs`` with the candidates handed over as the sharded tracker
    does (``parallel/spatial.py:make_sharded_tracker_fn``): positions and
    features strided views of one exchanged [S,C,3+F+1] payload, the
    validity computed from its last column."""
    (cand_pos, cand_feat, cvalid, _), *rest = inputs
    payload = torch.cat([cand_pos, cand_feat, cvalid[..., None].to(torch.float32)], -1)
    return ((payload[..., :3], payload[..., 3:-1], payload[..., -1] > 0.5, None), *rest)


@pytest.mark.gpu
def test_tracker_graph_equals_the_eager_loop_on_strided_candidates(monkeypatch):
    """Candidates as the sharded tracker hands them over, strided views of
    its payload: the graph's buffers keep those strides, and the replays
    give the eager loop's bits on the same views."""
    from clid_slam_torch.odometry import iekf

    inputs = _payload_candidates(_tracker_inputs(9, _cuda()))
    assert not inputs[0][0].is_contiguous()
    kw = dict(TRACKER_KW, **TRACKER_EXITS["converged"])
    built = []

    class Kept(iekf._GraphedIterations):
        def __init__(self, *a):
            super().__init__(*a)
            built.append(self)

    monkeypatch.setattr(iekf, "_GraphedIterations", Kept)
    graphed = iekf.make_cached_update_fn(**kw).dense_update(*inputs)
    assert [b.stride() for b in iekf._leaves(built[0].inputs)] == [
        x.stride() for x in iekf._leaves(inputs)]
    monkeypatch.setattr(iekf, "_GraphedIterations", _EagerIterations)
    eager = iekf.make_cached_update_fn(**kw).dense_update(*inputs)
    for name, g, e in zip(("rot", "pos", "rest", "P", "ok", "n_iter"), graphed, eager):
        assert torch.equal(g, e), name
    assert int(eager[5]) > 1


def _profiled_flops(fn):
    """torch's profiler's ``with_flops`` count of what ``fn()`` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.flops or 0 for e in prof.key_averages())


@pytest.mark.gpu
@pytest.mark.parametrize("option", [None] + sorted(TRACKER_OPTIONS))
def test_tracker_graph_counts_the_operations_its_replays_hide(option, monkeypatch):
    """A replay dispatches no torch operation, so the profiler counts only
    what runs around the replays; with ``track.graph_flops`` added, the
    count is the profiler's count of the eager loop on the same inputs, and
    above it by no more than the autograd engine's sums of gradients, which
    ``graphs.flops_of`` counts and the profiler does not (under 5 %)."""
    from clid_slam_torch.odometry import iekf
    from clid_slam_torch.utils import observability as obs

    kw, inputs = _tracker_option(option, 5, _cuda())
    body = iekf.make_cached_update_fn(**kw)
    body.dense_update(*inputs)  # the capture, outside the profiled call
    obs.reset_counters()
    seen = _profiled_flops(lambda: body.dense_update(*inputs))
    hidden = obs.counters()["track.graph_flops"]
    obs.reset_counters()
    monkeypatch.setattr(iekf, "_GraphedIterations", _EagerIterations)
    eager_body = iekf.make_cached_update_fn(**kw)
    eager = _profiled_flops(lambda: eager_body.dense_update(*inputs))
    obs.reset_counters()
    assert hidden > 0 and eager <= seen + hidden < eager + 0.05 * hidden


class _EagerPrep:
    """Stands in for ``prep.GraphedPrep``: the eager prep on the card, the
    graphs' reference."""

    def __init__(self, preps, window):
        self.preps, self.window = preps, window

    def __call__(self, filter_pool_now, map_state, local_map, pool, points, mask, pose,
                 travel_dist, frame_id, generator):
        return self.preps[filter_pool_now](map_state, local_map, pool, points, mask, pose,
                                           travel_dist, frame_id, self.window,
                                           generator=generator)


PREP_VARIANTS = {"no_filter": lambda i: False, "filter": lambda i: True,
                 "alternating": lambda i: i % 2 == 0}


@pytest.mark.gpu
@pytest.mark.parametrize("variants", sorted(PREP_VARIANTS))
def test_prep_graph_equals_the_eager_prep_over_frames(variants):
    """Five tracked frames of new inputs through one ``GraphedPrep`` and
    through the eager prep, from the same state after frame 0: every
    tensor of the result and the generator's state equal after each frame.
    Between frames the map gets new certainty and stamp tensors, as the
    mapping step makes (copied into the graphs' buffers), and free memory
    is written over, so a graph that read a freed block would differ.
    ``alternating`` captures its second variant while the buffers hold the
    state of the first's replays."""
    from clid_slam_torch.mapping import prep as prp
    from clid_slam_torch.pipeline.streaming import clone_state
    from torch_prep_frames import after_mapping, frame_inputs, preps, prep_leaves, small_system

    _cuda()
    system, seq = small_system("cuda")
    pp = preps(system.cfg)
    window = system.cfg.diff_travel_dist_local
    graphed = prp.GraphedPrep(pp, window)
    eager, mine = clone_state(system.state), clone_state(system.state)
    e = [eager.map_state, eager.local_map, eager.pool]
    g = [mine.map_state, mine.local_map, mine.pool]
    for i in range(1, 6):
        fp = PREP_VARIANTS[variants](i)
        points, mask, pose, travel = frame_inputs(system, seq, i)
        want = pp[fp](*e, points, mask, pose, travel, i, window, generator=eager.key)
        given = [x.clone() for x in g[0].tensors() + g[1].tensors() + g[2].tensors()]
        got = graphed(fp, *g, points, mask, pose, travel, i, mine.key)
        if i == 1:  # the state given stays as it was: the graphs write their buffers
            for x, y in zip(given, g[0].tensors() + g[1].tensors() + g[2].tensors()):
                assert torch.equal(x, y)
        for k, (x, y) in enumerate(zip(prep_leaves(got), prep_leaves(want))):
            assert torch.equal(x, y), (i, k)
        assert torch.equal(mine.key.get_state(), eager.key.get_state()), i
        junk = torch.full((1 << 26,), float("nan"), device="cuda")
        del junk
        e = [after_mapping(want.map_state, i), want.local_map, want.pool]
        g = [after_mapping(got.map_state, i), got.local_map, got.pool]
    assert sorted(graphed.graphs) == sorted({PREP_VARIANTS[variants](i) for i in range(1, 6)})


def _prep_frames(system, seq, frames):
    for i in frames:
        system.process_frame(i, seq.scans[i], seq.imu_windows[i])


@pytest.mark.gpu
def test_streaming_with_the_prep_graph_equals_the_eager_prep(monkeypatch):
    """Six frames, the pool filtered every second frame so that both
    variants run, with the prep graphs (captured in ``precompile()``) and
    with the eager prep on the card: every state leaf and the generator's
    state equal after every frame."""
    from clid_slam_torch.mapping import prep as prp
    from torch_prep_frames import N_FRAMES, small_system

    _cuda()
    graphed, seq = small_system("cuda", frame0=False, pool_filter_freq=2)
    graphed.precompile()
    with monkeypatch.context() as m:
        m.setattr(prp, "GraphedPrep", _EagerPrep)
        eager, _ = small_system("cuda", frame0=False, pool_filter_freq=2)
    for i in range(N_FRAMES):
        for system in (graphed, eager):
            _prep_frames(system, seq, [i])
        for k, (x, y) in enumerate(zip(graphed.state.leaves(), eager.state.leaves())):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (i, k)
            else:
                assert torch.equal(x.get_state(), y.get_state()), (i, k)
    assert int(graphed.sync()["insert_dropped"]) == int(eager.sync()["insert_dropped"])


@pytest.mark.gpu
def test_prep_capture_leaves_the_state_and_its_generator_as_they_were(monkeypatch):
    """``precompile()`` captures both variants and changes no state leaf
    and not the generator; a capture at a first call on the live state
    changes neither the state given nor the generator beyond the frame's
    own draws (the eager prep's, on a copy), and launches no gather kernel
    beyond the replay's own (a second call launches as many)."""
    from clid_slam_torch.mapping import prep as prp
    from clid_slam_torch.ops import gather as gt
    from clid_slam_torch.pipeline.streaming import clone_state
    from torch_prep_frames import frame_inputs, preps, small_system

    _cuda()
    captured = []
    capture = prp.GraphedPrep._capture
    monkeypatch.setattr(prp.GraphedPrep, "_capture",
                        lambda self, fp, *a: captured.append(fp) or capture(self, fp, *a))
    system, seq = small_system("cuda")
    before = clone_state(system.state)
    system.precompile()
    assert sorted(captured) == [False, True]
    for x, y in zip(system.state.leaves(), before.leaves()):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert torch.equal(x.get_state(), y.get_state())
    pp = preps(system.cfg)
    window = system.cfg.diff_travel_dist_local
    st = system.state
    copy = clone_state(st)
    points, mask, pose, travel = frame_inputs(system, seq, 1)
    graphed = prp.GraphedPrep(pp, window)
    launched = gt.launches["gather_rows"]
    res = graphed(True, st.map_state, st.local_map, st.pool, points, mask, pose, travel, 1,
                  st.key)
    first = gt.launches["gather_rows"] - launched
    pp[True](copy.map_state, copy.local_map, copy.pool, points, mask, pose, travel, 1, window,
             generator=copy.key)
    assert torch.equal(st.key.get_state(), copy.key.get_state())
    for x, y in zip(st.leaves(), before.leaves()):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    launched = gt.launches["gather_rows"]
    graphed(True, res.map_state, res.local_map, res.pool, points, mask, pose, travel, 1,
            clone_state(st.key))
    assert first == gt.launches["gather_rows"] - launched > 0


@pytest.mark.gpu
def test_a_tracked_frames_prep_iters_and_mapping_wait_for_nothing(monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` inside the
    ``frame.prep``, ``frame.iters`` and ``frame.map`` ranges, a tracked
    frame on the fused kernel's path raises nothing: no host read, no
    blocking copy there."""
    import contextlib

    from clid_slam_torch.ops import map_loop as ml
    from clid_slam_torch.utils import observability as obs
    from torch_prep_frames import small_system

    _cuda()
    system, seq = small_system("cuda", frame0=False)
    system.precompile()
    _prep_frames(system, seq, [0, 1])
    span = obs.span
    strict = []

    @contextlib.contextmanager
    def strict_span(name, args=None):
        if name not in ("frame.prep", "frame.iters", "frame.map"):
            with span(name, args):
                yield
            return
        strict.append(name)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(obs, "span", strict_span)
    launches = ml.launches
    _prep_frames(system, seq, [2, 3])
    assert strict == ["frame.prep", "frame.iters", "frame.map"] * 2
    assert ml.launches == launches + 2  # K1, once a tracked frame


@pytest.mark.gpu
def test_the_prune_log_keeps_its_counts_across_prep_replays(monkeypatch):
    """The map is pruned every second frame and each next frame is tracked,
    so the prep graphs write the map's count in place after every prune:
    the counts the driver logged at each prune (``sync()["prunes"]``) equal
    the eager prep's, and each count after a prune is the one read at that
    frame."""
    from clid_slam_torch.mapping import prep as prp
    from torch_prep_frames import N_FRAMES, small_system

    _cuda()
    kw = dict(frame0=False, prune_map_on=True, prune_freq_frame=2)
    graphed, seq = small_system("cuda", **kw)
    graphed.precompile()
    with monkeypatch.context() as m:
        m.setattr(prp, "GraphedPrep", _EagerPrep)
        eager, _ = small_system("cuda", **kw)
    read = []
    for i in range(N_FRAMES):
        for system in (graphed, eager):
            _prep_frames(system, seq, [i])
        if (i + 1) % 2 == 0:
            read.append(graphed.neural_point_count())
    got, want = graphed.sync()["prunes"], eager.sync()["prunes"]
    assert [f for f, _, _ in got] == [1, 3, 5]
    assert got == want
    assert [a for _, _, a in got] == read
    assert all(0 < a <= b for _, b, a in got)


class _EagerTrackStages:
    """Stands in for ``streaming.GraphedTrackStages``: a tracked frame's
    predict and bookkeep run eagerly on the card, the graphs' reference."""

    def __init__(self, cfg):
        self.cfg = cfg

    def predict(self, *frame):
        from clid_slam_torch.pipeline import streaming as sm

        f = sm.eager_frame(*frame, True)
        sm.predict_stage(self.cfg, f, True)
        return f

    def bookkeep(self, f, trk):
        from clid_slam_torch.pipeline import streaming as sm

        f.trk = trk
        sm.bookkeep_stage(self.cfg, f, True)


def _recording(cls, log):
    """``cls`` with copies of every output of each call appended to ``log``:
    predict's masks, IMU propagation and source points, then bookkeep's
    points, validity and the state's leaves after the frame."""

    class Recording(cls):
        def predict(self, *frame):
            f = super().predict(*frame)
            log.append([x.clone() for x in (f.train_mask, *f.pred, f.src_pts, f.smask)])
            return f

        def bookkeep(self, f, trk):
            super().bookkeep(f, trk)
            log.append([x.clone() for x in (f.map_points, f.valid_mapping, *f.new.values())])

    return Recording


def _assert_same_states(a, b, where):
    for k, (x, y) in enumerate(zip(a.state.leaves(), b.state.leaves())):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), (where, k)
        else:
            assert torch.equal(x.get_state(), y.get_state()), (where, k)
    counts = lambda s: [(f, int(n), int(m)) for f, n, m in s.filter_log]
    assert counts(a) == counts(b), where


@pytest.mark.gpu
@pytest.mark.parametrize("capture", ["first_tracked_frame", "precompile"])
def test_track_graphs_equal_the_eager_stages_over_frames(capture, monkeypatch):
    """Eight frames on quad's switches (the adaptive crop range, the
    dynamic filter, deskew, the rotated ``T_imu_lidar``; ``torch_track_
    frames.py``) whose crop range, IMU rows (none, 4, 16, 32, the whole
    64-row bucket) and id change from frame to frame, with predict and
    bookkeep replayed from their graphs and run eagerly on the card: every
    output of both stages, every state leaf (the rows written included),
    the generator and the filter's kept counts equal after every frame. The
    graphs are captured at the first tracked frame, or in ``precompile()``
    on its frame (``max_range``, no IMU rows, frame 1), which no frame
    here repeats: a value frozen in a capture differs."""
    import torch_track_frames as tf
    from clid_slam_torch.pipeline import streaming as sm
    from clid_slam_torch.utils.transforms import adaptive_crop_range

    _cuda()
    logs = {"graphed": [], "eager": []}
    systems = {}
    for name, cls in (("graphed", sm.GraphedTrackStages), ("eager", _EagerTrackStages)):
        with monkeypatch.context() as m:
            m.setattr(sm, "GraphedTrackStages", _recording(cls, logs[name]))
            systems[name], fr = tf.system("cuda")
        if capture == "precompile":
            systems[name].precompile()
            logs[name].clear()
    graphed, eager = systems["graphed"], systems["eager"]
    for i in range(tf.N_FRAMES):
        tf.run(graphed, fr, [i])
        tf.run(eager, fr, [i])
        _assert_same_states(graphed, eager, i)
    assert len(logs["graphed"]) == len(logs["eager"]) == 2 * (tf.N_FRAMES - 1)
    for j, (got, want) in enumerate(zip(logs["graphed"], logs["eager"])):
        for k, (x, y) in enumerate(zip(got, want)):
            assert torch.equal(x, y), (j, k)
    crops = {adaptive_crop_range(p @ tf.T_IMU_LIDAR[:3, :3].T + tf.T_IMU_LIDAR[:3, 3],
                                 graphed.cfg.max_range) for p, _, _ in fr[1:]}
    assert len(crops) == tf.N_FRAMES - 1 and max(crops) < graphed.cfg.max_range
    assert len(graphed.filter_log) == tf.N_FRAMES - 1


@pytest.mark.gpu
def test_a_tracked_frames_predict_and_bookkeep_wait_for_nothing(monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` inside the
    ``frame.predict`` and ``frame.bookkeep`` ranges, tracked frames on
    quad's switches (deskew and the adaptive crop range on) raise nothing:
    no host read, no blocking copy there."""
    import contextlib

    import torch_track_frames as tf
    from clid_slam_torch.utils import observability as obs

    _cuda()
    system, fr = tf.system("cuda")
    system.precompile()
    tf.run(system, fr, [0, 1])
    span = obs.span
    strict = []

    @contextlib.contextmanager
    def strict_span(name, args=None):
        if name not in ("frame.predict", "frame.bookkeep"):
            with span(name, args):
                yield
            return
        strict.append(name)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(obs, "span", strict_span)
    tf.run(system, fr, [2, 3, 4])
    assert strict == ["frame.predict", "frame.bookkeep"] * 3


@pytest.mark.gpu
def test_earlier_states_keep_their_rows_across_track_replays():
    """The graphs write the trajectory, the travel distances and the
    iteration counts in place, into their own buffers: a clone of the state
    after frame 2, and the state frame 0 (eager) returned, held as it is,
    keep their values across five more replayed frames, while the live
    state gets the new rows and keeps the old."""
    import torch_track_frames as tf
    from clid_slam_torch.pipeline.streaming import clone_state

    _cuda()
    system, fr = tf.system("cuda")
    system.precompile()
    tf.run(system, fr, [0])
    first = system.state
    first_host = [x.cpu() for x in first.leaves() if isinstance(x, torch.Tensor)]
    tf.run(system, fr, [1, 2])
    held = clone_state(system.state)
    names = ("odom_poses", "travel_dist", "track_iters")
    host = {k: getattr(held, k).cpu() for k in names}
    tf.run(system, fr, range(3, tf.N_FRAMES))
    for k in names:
        assert torch.equal(getattr(held, k).cpu(), host[k]), k
        live = getattr(system.state, k).cpu()
        assert torch.equal(live[:3], host[k][:3]), k
        assert not torch.equal(live[3:tf.N_FRAMES], host[k][3:tf.N_FRAMES]), k
    for x, y in zip([x for x in first.leaves() if isinstance(x, torch.Tensor)], first_host):
        assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
def test_inv_ex_and_the_identity_quaternion_constant_give_the_parent_bits_on_the_card():
    """On the card, ``torch.linalg.inv_ex`` gives ``torch.linalg.inv``'s
    bits on poses, and deskew with its identity quaternion copied to the
    card once gives the bits of one made by ``torch.tensor`` at each call."""
    from clid_slam_torch.pipeline.streaming import _inv
    from clid_slam_torch.utils import lie
    from clid_slam_torch.utils.transforms import deskew

    dev = _cuda()
    rng = np.random.default_rng(7)
    for _ in range(16):
        T = torch.eye(4, device=dev)
        T[:3, :3] = lie.so3_exp(torch.from_numpy(rng.normal(0, 0.3, 3).astype(np.float32)).to(dev))
        T[:3, 3] = torch.from_numpy(rng.normal(0, 5.0, 3).astype(np.float32)).to(dev)
        assert torch.equal(_inv(T), torch.linalg.inv(T))
        pts = torch.from_numpy(rng.normal(0, 10.0, (65536, 3)).astype(np.float32)).to(dev)
        ts = torch.from_numpy(rng.uniform(0, 1, 65536).astype(np.float32)).to(dev)
        n = pts.shape[0]
        t = (ts - ts.min()) / torch.clamp(ts.max() - ts.min(), min=1e-12) - 0.5
        q_id = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        q_t = lie.quat_slerp(q_id.expand(n, 4), lie.rotmat_to_quat(T[:3, :3]).expand(n, 4),
                             t[:, None])
        want = torch.einsum("nij,nj->ni", lie.quat_to_rotmat(q_t), pts) + t[:, None] * T[:3, 3]
        assert torch.equal(deskew(pts, ts, T), want)


@pytest.mark.gpu
def test_track_graphs_count_the_operations_their_replays_hide():
    """A replay dispatches no torch operation, so the profiler counts only
    what runs around a frame's two replays; with ``track.graph_flops``
    added (one eager run of the stages, counted on copies), the count is the
    profiler's count of the eager stages on the same frame, within 0.1 %:
    the profiler also records the few adds that run nested inside another
    op, which the counting dispatch mode does not see (3 operations of 13
    million on the CPU at these shapes)."""
    import torch_track_frames as tf
    from clid_slam_torch.pipeline import streaming as sm
    from clid_slam_torch.pipeline.streaming import clone_state
    from clid_slam_torch.utils import observability as obs

    _cuda()
    system, fr = tf.system("cuda")
    tf.run(system, fr, [0, 1])
    seen = []
    system.steps = {k: (lambda st, *a, step=v: seen.append((clone_state(st), a)) or step(st, *a))
                    for k, v in system.steps.items()}
    tf.run(system, fr, [2])
    state, args = seen[0]
    frame = (state, *args[:7])
    dev = state.rot.device
    trk = (state.rot, state.pos, state.rest, state.P, torch.ones((), dtype=torch.bool, device=dev),
           torch.full((), 3, dtype=torch.int32, device=dev))
    stages = sm.GraphedTrackStages(system.cfg)
    stages.bookkeep(stages.predict(*frame), trk)  # the capture, outside the profiled call
    obs.reset_counters()
    replayed = _profiled_flops(lambda: stages.bookkeep(stages.predict(*frame), trk))
    counted = obs.counters()
    obs.reset_counters()
    eager_stages = _EagerTrackStages(system.cfg)
    eager = _profiled_flops(lambda: eager_stages.bookkeep(eager_stages.predict(*frame), trk))
    hidden = counted["track.graph_flops"]
    assert counted["predict.graph_frames"] == 1
    assert hidden > 0 and abs(replayed + hidden - eager) <= 1e-3 * eager
