"""Time the fused mapping loop (``ops/map_loop.py``) on the card at the
bench shapes.

    python -m clid_slam_torch.tools.time_map_loop [--n-hidden 1] [--hidden 64]
        [--layer-norm] [--streamed] [--bd 1638] [--iters 10] [--reps 20]

Prints one JSON line: the kernel's device time per call (torch.profiler,
the kernels whose name holds ``map_loop``), the time per call issued eagerly
(CUDA events around back-to-back calls, the host's enqueue included), the
card's bound for the same work and the card's name and power limit. The
inputs are made from a seed with numpy at the bench shapes (bs 16384, K 6,
F 8, P 3, bd 1638 taps every 10th sample); ``--bd`` keeps the first taps
only. ``clid_slam_torch`` is imported from the path, so running this file
with another checkout first on ``PYTHONPATH`` times that tree's kernel on
the same inputs (``--streamed`` needs this tree's wrapper).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
from typing import List, Optional

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): plain f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# bench shapes of the mapping kernel (bench.py small config)
BS, K, F, P, H = 16384, 6, 8, 3, 64
DEC, BD = 10, 1638
LR, SDF_SCALE, SIGMA, ADAM_EPS, W_E, NGE = 0.01, 0.055, 0.055, 1e-15, 0.5, 0.08
N_ITERS = 10
KW = dict(dec_step=DEC, sdf_scale=SDF_SCALE, sigma=SIGMA, lr=LR, adam_eps=ADAM_EPS,
          weight_e=W_E, num_grad_eps=NGE)


def make_inputs(n_hidden: int, seed: int, device, hidden: int = H, bd: int = BD) -> dict:
    """Bench-shaped inputs made from a seed with numpy (the layout the
    mapper's cache hands the kernel); the first ``bd`` of the 1638 taps."""
    from clid_slam_torch.models.decoder import MLPParams

    rng = np.random.default_rng(seed)
    f = rng.normal(0, 0.1, (BS, K, F)).astype(np.float32)
    w0 = rng.uniform(0, 1, (BS, K)).astype(np.float32)
    w0[rng.uniform(size=(BS, K)) < 0.2] = 0.0
    w0 /= np.maximum(w0.sum(1, keepdims=True), 1e-9)
    encw0 = rng.normal(0, 0.2, (BS, P)).astype(np.float32)
    label = rng.normal(0, 0.1, BS).astype(np.float32)
    bvalid = (rng.uniform(size=BS) < 0.9).astype(np.float32)
    wsel = (rng.uniform(0.5, 1.5, BS) * bvalid).astype(np.float32)
    wtap = rng.uniform(0, 1, (6, BD, K)).astype(np.float32)
    wtap /= np.maximum(wtap.sum(-1, keepdims=True), 1e-9)
    enctapw = rng.normal(0, 0.2, (6, BD, P)).astype(np.float32)
    vd = bvalid[::DEC][:BD].copy()
    ws = [rng.normal(0, 0.3, (F + P, hidden)).astype(np.float32)]
    bs_ = [rng.normal(0, 0.1, (hidden,)).astype(np.float32)]
    if n_hidden == 2:
        ws.append(rng.normal(0, 0.2, (hidden, hidden)).astype(np.float32))
        bs_.append(rng.normal(0, 0.1, (hidden,)).astype(np.float32))
    wo = rng.normal(0, 0.3, (hidden, 1)).astype(np.float32)
    bo = rng.normal(0, 0.1, (1,)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    mlp = MLPParams([t(w) for w in ws], [t(b) for b in bs_], t(wo), t(bo))
    return dict(
        f0=t(f), w0=t(w0), encw0=t(encw0), label_op=torch.sigmoid(t(label) / SIGMA),
        wsel=t(wsel), wtap=t(wtap[:, :bd]), enctapw=t(enctapw[:, :bd]), vd=t(vd[:bd]),
        mlp=mlp, denom_inv=1.0 / max(float(bvalid.sum()), 1.0),
        eik_den_inv=1.0 / max(float(vd[:bd].sum()), 1.0),
    )


def call_args(x: dict, n_iters: int, device) -> tuple:
    """Positional arguments of ``map_loop`` for ``n_iters`` steps (at most
    ``N_ITERS``)."""
    return (
        x["f0"], x["w0"], x["encw0"], x["label_op"], x["wsel"], x["wtap"], x["enctapw"],
        x["vd"], x["mlp"], torch.tensor(n_iters, dtype=torch.int32, device=device),
        N_ITERS, LR, x["denom_inv"], x["eik_den_inv"],
    )


def flops(n_hidden: int, n_iters: int, hidden: int = H, bd: int = BD) -> int:
    """Operations the loop needs: per sample and per tap one MLP forward
    and backward, the IDW feature sums both ways, and Adam on every
    parameter (~10 ops each)."""
    D = F + P
    fwd = 2 * D * hidden + 2 * hidden + (2 * hidden * hidden if n_hidden == 2 else 0)
    bwd = (2 * hidden + 2 * hidden + 2 * D * hidden + 2 * F * hidden
           + (4 * hidden * hidden if n_hidden == 2 else 0))
    feat = 4 * K * F
    n_params = D * hidden + hidden + (hidden * hidden + hidden if n_hidden == 2 else 0) + hidden + 1
    per_iter = (BS + 6 * bd) * (fwd + bwd + feat) + 10 * (BS * K * F + n_params)
    return per_iter * n_iters


def nbytes(n_hidden: int, hidden: int = H, bd: int = BD) -> int:
    """Each input read once, each output written once."""
    D = F + P
    n_params = D * hidden + hidden + (hidden * hidden + hidden if n_hidden == 2 else 0) + hidden + 1
    inputs = BS * K * F + BS * K + BS * P + 2 * BS + 6 * bd * (K + P) + bd + n_params
    outputs = BS * K * F + n_params + 2
    return 4 * (inputs + outputs)


def bound(n_hidden: int, n_iters: int, hidden: int = H, bd: int = BD) -> dict:
    """The least time the card could take: the larger of the operations at
    the f32 peak and the bytes at the memory rate."""
    t_ops = flops(n_hidden, n_iters, hidden, bd) / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes(n_hidden, hidden, bd) / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def eager_ms(fn, reps: int) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back calls
    after one warm-up call (the host's enqueue included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel_key: str = "map_loop") -> float:
    """Device milliseconds per call of the kernels whose name holds
    ``kernel_key``, from torch.profiler over ``reps`` calls: the kernels'
    own time, without the host's enqueue."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if kernel_key in e.key)
    if us <= 0:
        raise AssertionError(f"the profiler saw no {kernel_key} kernel on the device")
    return us / 1e3 / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def measure(n_hidden: int = 1, hidden: int = H, layer_norm: bool = False,
            streamed: bool = False, bd: int = BD, n_iters: int = N_ITERS,
            reps: int = 20) -> dict:
    from clid_slam_torch import set_full_precision
    from clid_slam_torch.ops import map_loop as ml

    if not torch.cuda.is_available():
        raise SystemExit("time_map_loop: needs a CUDA card")
    set_full_precision()
    dev = torch.device("cuda", 0)
    x = make_inputs(n_hidden, seed=n_hidden * 10 + int(layer_norm), device=dev,
                    hidden=hidden, bd=bd)
    kernel = functools.partial(ml._launch, True) if streamed else ml.map_loop
    call = lambda: kernel(*call_args(x, n_iters, dev), **KW, layer_norm=layer_norm)
    return {
        "n_hidden": n_hidden, "hidden": hidden, "layer_norm": layer_norm,
        "streamed": streamed, "bd": bd, "iters": n_iters,
        "device_ms": device_ms(call, reps), "eager_ms": eager_ms(call, reps),
        **bound(n_hidden, n_iters, hidden, bd), "card": nvidia_smi_line(),
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-hidden", type=int, default=1, choices=(1, 2))
    ap.add_argument("--hidden", type=int, default=H, choices=(32, 64))
    ap.add_argument("--layer-norm", action="store_true")
    ap.add_argument("--streamed", action="store_true",
                    help="keep each block's slab in device memory")
    ap.add_argument("--bd", type=int, default=BD, help="taps kept (1..1638)")
    ap.add_argument("--iters", type=int, default=N_ITERS)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.n_hidden, a.hidden, a.layer_norm, a.streamed,
                             max(1, min(a.bd, BD)), min(a.iters, N_ITERS), a.reps)),
          flush=True)


if __name__ == "__main__":
    main()
