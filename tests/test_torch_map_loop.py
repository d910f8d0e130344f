"""The fused mapping Adam loop: its plain PyTorch version
(``map_loop_reference``, what the wrapper runs on CPU tensors) against the
JAX Pallas kernel in interpret mode and against ``ref_loop`` of
tests/test_pallas_mapping.py. The hand-written CUDA kernel is held against
the plain version in tests/test_torch_cuda.py (card only).

Tolerances (those of tests/test_pallas_mapping.py): one iteration rtol
1e-5 / atol 1e-6; n iterations max diff < 3 lr, 99th percentile < 2.5 lr,
losses rtol 5e-2 — the t=1 Adam step is a sign function of the gradient,
so near-zero gradients flip by ~2 lr under reduction-order noise."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clid_slam_torch.convert import mlp_from_numpy
from clid_slam_torch.ops import map_loop as tml
from clid_slam_tpu.ops.pallas_mapping import make_pallas_map_loop
from test_pallas_mapping import DEC, EPS_A, F, H, K, LR, NGE, P, SDF_SCALE, SIGMA, W_E, ref_loop
from torch_parity import n, t

N_ITERS = 5
KW = dict(
    dec_step=DEC, sdf_scale=SDF_SCALE, sigma=SIGMA, lr=LR, adam_eps=EPS_A,
    weight_e=W_E, num_grad_eps=NGE,
)


def _inputs(bs, n_hidden, seed=0):
    rng = np.random.default_rng(seed)
    bd = max(1, bs // DEC // 4)
    f = rng.normal(0, 0.1, (bs, K, F)).astype(np.float32)
    w0 = rng.uniform(0, 1, (bs, K)).astype(np.float32)
    w0[rng.uniform(size=(bs, K)) < 0.2] = 0.0
    w0 /= np.maximum(w0.sum(1, keepdims=True), 1e-9)
    encw0 = rng.normal(0, 0.2, (bs, P)).astype(np.float32)
    label = rng.normal(0, 0.1, bs).astype(np.float32)
    bvalid = (rng.uniform(size=bs) < 0.9).astype(np.float32)
    wsel = (rng.uniform(0.5, 1.5, bs) * bvalid).astype(np.float32)
    wtap = rng.uniform(0, 1, (6, bd, K)).astype(np.float32)
    wtap /= np.maximum(wtap.sum(-1, keepdims=True), 1e-9)
    enctapw = rng.normal(0, 0.2, (6, bd, P)).astype(np.float32)
    vd = bvalid[::DEC][:bd].copy()
    mlp = {"weights": [rng.normal(0, 0.3, (F + P, H)).astype(np.float32)],
           "biases": [rng.normal(0, 0.1, (H,)).astype(np.float32)]}
    if n_hidden == 2:
        mlp["weights"].append(rng.normal(0, 0.2, (H, H)).astype(np.float32))
        mlp["biases"].append(rng.normal(0, 0.1, (H,)).astype(np.float32))
    mlp["w_out"] = rng.normal(0, 0.3, (H, 1)).astype(np.float32)
    mlp["b_out"] = np.array([rng.normal(0, 0.1)], np.float32)
    label_op = np.asarray(jax.nn.sigmoid(jnp.asarray(label) / SIGMA))
    return dict(
        f=f, w0=w0, encw0=encw0, label_op=label_op, wsel=wsel, wtap=wtap,
        enctapw=enctapw, vd=vd, mlp=mlp, bd=bd,
        denom=float(max(bvalid.sum(), 1.0)), eik_den=float(max(vd.sum(), 1.0)),
    )


class _Mlp:
    def __init__(self, d):
        self.__dict__.update(d)


def _port(x, n_iters, mlp_scale, layer_norm, fn=tml.map_loop):
    return fn(
        t(x["f"]), t(x["w0"]), t(x["encw0"]), t(x["label_op"]), t(x["wsel"]),
        t(x["wtap"]), t(x["enctapw"]), t(x["vd"]), mlp_from_numpy(_Mlp(x["mlp"]), "cpu"),
        torch.tensor(n_iters, dtype=torch.int32), 20, LR * mlp_scale,
        1.0 / x["denom"], 1.0 / x["eik_den"], layer_norm=layer_norm, **KW,
    )


def _ref_loop(x, n_iters, mlp_scale, layer_norm):
    m = x["mlp"]
    params = [jnp.asarray(w) for w in m["weights"]]
    params = [p for pair in zip(params, [jnp.asarray(b) for b in m["biases"]]) for p in pair]
    params += [jnp.asarray(m["w_out"]), jnp.float32(m["b_out"][0])]
    out, losses = ref_loop(
        jnp.asarray(x["f"]), jnp.asarray(x["w0"]), jnp.asarray(x["encw0"]),
        jnp.asarray(x["label_op"]), jnp.asarray(x["wsel"]), jnp.asarray(x["wtap"]),
        jnp.asarray(x["enctapw"]), jnp.asarray(x["vd"]), params, n_iters,
        LR * mlp_scale, x["denom"], x["eik_den"], x["bd"], layer_norm,
    )
    # ref_loop's MLP leaves interleave (W, b) per layer
    nh = len(m["weights"])
    mlp_p = out[1:]
    weights = [np.asarray(mlp_p[2 * i]) for i in range(nh)]
    biases = [np.asarray(mlp_p[2 * i + 1]) for i in range(nh)]
    return np.asarray(out[0]), weights + biases + [np.asarray(mlp_p[-2]), np.asarray(mlp_p[-1])], losses


def _pallas(x, n_iters, mlp_scale, layer_norm, chunk=256):
    """The JAX Pallas kernel in interpret mode, marshalled as the mapper
    does (tap rows first, feature-major, padded)."""
    bs, bd = x["f"].shape[0], x["bd"]
    nh = len(x["mlp"]["weights"])
    bsp = ((bs + chunk - 1) // chunk) * chunk
    BD = ((bd + 127) // 128) * 128
    ru = lambda v: ((v + 7) // 8) * 8
    run = make_pallas_map_loop(
        bs=bsp, knn_k=K, feature_dim=F, pos_dim=P, hidden=H, bd=bd, dec_step=DEC,
        sdf_scale=SDF_SCALE, sigma=SIGMA, lr=LR, adam_eps=EPS_A, weight_e=W_E,
        num_grad_eps=NGE, chunk=chunk, n_hidden=nh, layer_norm=layer_norm, interpret=True,
    )
    taps = np.arange(0, bs, DEC)[:bd]
    perm = np.concatenate([taps, np.setdiff1d(np.arange(bs), taps)])
    z = lambda *s: jnp.zeros(s, jnp.float32)
    fT = z(K * F, bsp).at[:, :bs].set(x["f"][perm].transpose(1, 2, 0).reshape(K * F, bs))
    w0T = z(8, bsp).at[:K, :bs].set(x["w0"][perm].T)
    encT = z(8, bsp).at[:P, :bs].set(x["encw0"][perm].T)
    rowsT = z(8, bsp).at[0, :bs].set(x["label_op"][perm]).at[1, :bs].set(x["wsel"][perm])
    wtapT = z(ru(6 * K), BD).at[: 6 * K, :bd].set(x["wtap"].transpose(0, 2, 1).reshape(6 * K, bd))
    encT2 = z(ru(6 * P), BD).at[: 6 * P, :bd].set(x["enctapw"].transpose(0, 2, 1).reshape(6 * P, bd))
    vdT = z(8, BD).at[0, :bd].set(x["vd"])
    m = x["mlp"]
    parts = [z(16, H).at[: F + P].set(m["weights"][0]), jnp.asarray(m["biases"][0])[:, None]]
    if nh == 2:
        parts += [jnp.asarray(m["weights"][1]), jnp.asarray(m["biases"][1])[:, None]]
    parts += [z(8, H).at[0].set(m["w_out"][:, 0]), jnp.full((1, 1), m["b_out"][0])]
    fT2, _, losses = run(
        fT, w0T, encT, rowsT, wtapT, encT2, vdT, tuple(parts), n_iters,
        LR * mlp_scale, 1.0 / x["denom"], 1.0 / x["eik_den"],
    )
    inv = np.argsort(perm)
    f_out = np.asarray(fT2)[:, :bs].reshape(K, F, bs).transpose(2, 0, 1)[inv]
    return f_out, np.asarray(losses).reshape(2)


def _check_n_iters(got_f, want_f, got_l, want_l):
    d = np.abs(got_f - want_f)
    assert d.max() < 3.0 * LR, d.max()
    assert np.quantile(d, 0.99) < 2.5 * LR
    np.testing.assert_allclose(float(got_l[0]), float(want_l[0]), rtol=5e-2)
    np.testing.assert_allclose(float(got_l[1]), float(want_l[1]), rtol=5e-2, atol=1e-4)


CASES = {
    "base": dict(bs=512, mlp_scale=1.0, layer_norm=False, n_hidden=1),
    "mlp_frozen": dict(bs=512, mlp_scale=0.0, layer_norm=False, n_hidden=1),
    "layer_norm": dict(bs=512, mlp_scale=1.0, layer_norm=True, n_hidden=1),
    "two_hidden": dict(bs=512, mlp_scale=1.0, layer_norm=False, n_hidden=2),
    "padded_ln_two_hidden": dict(bs=450, mlp_scale=1.0, layer_norm=True, n_hidden=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax(case):
    c = CASES[case]
    x = _inputs(c["bs"], c["n_hidden"])
    args = (c["mlp_scale"], c["layer_norm"])
    f1, _, _ = _port(x, 1, *args)
    np.testing.assert_allclose(n(f1), _pallas(x, 1, *args)[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(f1), _ref_loop(x, 1, *args)[0], rtol=1e-5, atol=1e-6)

    f5, mlp5, l5 = _port(x, N_ITERS, *args)
    fp, lp = _pallas(x, N_ITERS, *args)
    fr, mlp_r, (sdf_r, eik_r) = _ref_loop(x, N_ITERS, *args)
    _check_n_iters(n(f5), fp, n(l5), lp)
    _check_n_iters(n(f5), fr, n(l5), (sdf_r, eik_r))
    for got, want in zip(mlp5.tensors(), mlp_r):
        # same tolerance; a frozen MLP (lr scale 0) stays exactly put
        assert np.abs(n(got) - np.asarray(want).reshape(n(got).shape)).max() \
            < 3.0 * LR * max(c["mlp_scale"], 1e-9) + 1e-6


def test_wrapper_runs_plain_version_on_cpu():
    x = _inputs(512, 1, seed=3)
    a = _port(x, 3, 1.0, False)
    b = _port(x, 3, 1.0, False, fn=tml.map_loop_reference)
    for u, v in zip([a[0], *a[1].tensors(), a[2]], [b[0], *b[1].tensors(), b[2]]):
        assert torch.equal(u, v)
    zero = _port(x, 0, 1.0, False)
    assert torch.equal(zero[0], t(x["f"]))


def test_flatten_mlp_roundtrip():
    x = _inputs(64, 2)
    mlp = mlp_from_numpy(_Mlp(x["mlp"]), "cpu")
    flat = tml.flatten_mlp(mlp)
    assert flat.numel() == (F + P) * H + H + H * H + H + H + 1
    # the kernel's layout: W1, b1, W2, b2, w_out, b_out
    assert torch.equal(flat[(F + P) * H : (F + P) * H + H], mlp.biases[0])
    back = tml.unflatten_mlp(flat, mlp)
    for u, v in zip(back.tensors(), mlp.tensors()):
        assert torch.equal(u, v)


@pytest.mark.parametrize("streamed", [False, True])
def test_kernel_launch_refuses_cpu_tensors(streamed):
    """Only ``map_loop`` runs the plain version on CPU tensors; its kernel
    launch (and the streamed-slab hook of the card tests) raises there
    rather than fall back to it."""
    x = _inputs(256, 1, seed=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tml._launch(
            streamed, t(x["f"]), t(x["w0"]), t(x["encw0"]), t(x["label_op"]), t(x["wsel"]),
            t(x["wtap"]), t(x["enctapw"]), t(x["vd"]), mlp_from_numpy(_Mlp(x["mlp"]), "cpu"),
            torch.tensor(2, dtype=torch.int32), 20, LR, 1.0 / x["denom"], 1.0 / x["eik_den"],
            layer_norm=True, **KW,
        )


@pytest.mark.parametrize(
    "n_hidden, hidden, bd, gflop, bound_us",
    [(1, 64, 1638, 1.2362, 18.45), (2, 64, 1638, 7.6785, 114.60), (1, 64, 1, 0.8025, 11.98)],
)
def test_timing_tool_bound_at_the_bench_shapes(n_hidden, hidden, bd, gflop, bound_us):
    """The operations bound that PERF.md holds K1 against (f32 at 67 TFLOP/s;
    the bytes, about 7 MB at 3.35 TB/s, bound it less)."""
    from clid_slam_torch.tools import time_map_loop as tm

    b = tm.bound(n_hidden, tm.N_ITERS, hidden, bd)
    assert b["bound_by"] == "operations"
    assert abs(tm.flops(n_hidden, tm.N_ITERS, hidden, bd) / 1e9 - gflop) < 1e-3
    assert abs(b["bound_ms"] * 1e3 - bound_us) < 0.01


def test_timing_tool_inputs_keep_the_first_taps():
    from clid_slam_torch.tools import time_map_loop as tm

    full = tm.make_inputs(1, seed=1, device="cpu")
    cut = tm.make_inputs(1, seed=1, device="cpu", bd=5)
    assert cut["wtap"].shape == (6, 5, tm.K) and cut["vd"].shape == (5,)
    assert torch.equal(cut["wtap"], full["wtap"][:, :5]) and torch.equal(cut["f0"], full["f0"])
    assert cut["wtap"].is_contiguous() and cut["enctapw"].is_contiguous()
