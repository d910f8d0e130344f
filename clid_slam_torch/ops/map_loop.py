"""The fused per-frame mapping Adam loop: CUDA kernel wrapper and its plain
PyTorch version.

Replaces ``clid_slam_tpu/ops/pallas_mapping.py:make_pallas_map_loop``. The
kernel source is ``clid_slam_torch/csrc/map_loop.cu`` (its header note
says what bounds it on the H100 and how the design answers that);
``ops/_build.py`` compiles it at first use and loads it as the Python
extension module it defines, as it does the gathers (``ops/gather.py``).

``map_loop`` dispatches on the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors run ``map_loop_reference``. There is no
fallback from one to the other.

Inputs are in the natural layout that the mapper's cache produces:
features [bs, K, F], IDW weights [bs, K], hoisted encodings [bs, P],
targets/weights [bs], tap weights [6, bd, K], tap encodings [6, bd, P],
tap validity [bd]. Tap j belongs to sample j * dec_step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..models.decoder import MLPParams
from . import _build

# launches of the kernel (one per map_loop call on CUDA tensors)
launches = 0


class Plan(NamedTuple):
    """How one call runs on the card (the module's ``plan``): blocks of
    the cooperative launch, samples per block, tap capacity per block,
    whether the slab stays in shared memory, dynamic shared memory bytes
    and device-memory scratch floats per block (streamed slabs only)."""

    grid: int
    spc: int
    ntap: int
    resident: bool
    smem_bytes: int
    work: int


_plans: Dict[tuple, Plan] = {}


def flatten_mlp(mlp: MLPParams) -> torch.Tensor:
    """[W1 (D*H), b1, (W2 (H*H), b2,) w_out (H), b_out] as one f32 vector,
    the kernel's parameter layout."""
    parts = []
    for w, b in zip(mlp.weights, mlp.biases):
        parts += [w.reshape(-1), b.reshape(-1)]
    parts += [mlp.w_out.reshape(-1), mlp.b_out.reshape(-1)]
    return torch.cat(parts).to(torch.float32).contiguous()


def unflatten_mlp(flat: torch.Tensor, like: MLPParams) -> MLPParams:
    """Views of ``flat`` shaped like ``like`` (inverse of flatten_mlp)."""
    o = 0

    def take(t):
        nonlocal o
        o += t.numel()
        return flat[o - t.numel() : o].reshape(t.shape)

    weights, biases = [], []
    for w, b in zip(like.weights, like.biases):
        weights.append(take(w))
        biases.append(take(b))
    return MLPParams(weights, biases, take(like.w_out), take(like.b_out))


def plan(bs: int, K: int, P: int, H: int, n_hidden: int, layer_norm: bool, bd: int,
         dec_step: int, device, streamed: bool = False) -> Plan:
    """The kernel's plan for these shapes on ``device`` (cached): the slab
    stays in shared memory where it fits, unless ``streamed`` (``_launch``)."""
    key = (bs, K, P, H, n_hidden, bool(layer_norm), bd, dec_step, str(device), streamed)
    if key not in _plans:
        # the plan also sets the kernels' shared-memory limit on the device;
        # it raises RuntimeError with the cudaError_t where it fails
        with torch.cuda.device(device):
            out = _build.load_module("map_loop").plan(
                bs, K, P, H, n_hidden, int(bool(layer_norm)), bd, dec_step, int(streamed))
        _plans[key] = Plan(out[0], out[1], out[2], bool(out[3]), out[4], out[5])
    return _plans[key]


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"map_loop: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"map_loop: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"map_loop: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"map_loop: {name} must be contiguous")


def map_loop(
    f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp: MLPParams,
    n_iters, max_iters: int, mlp_lr, denom_inv, eik_den_inv, *,
    dec_step: int, sdf_scale: float, sigma: float, lr: float,
    adam_eps: float, weight_e: float, num_grad_eps: float,
    layer_norm: bool = False,
) -> Tuple[torch.Tensor, MLPParams, torch.Tensor]:
    """min(n_iters, max_iters) Adam steps; returns (features, mlp,
    [sdf_loss, eik_loss] of the last step). ``n_iters``, ``mlp_lr``,
    ``denom_inv`` and ``eik_den_inv`` may be device scalars."""
    args = (f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp, n_iters, max_iters,
            mlp_lr, denom_inv, eik_den_inv)
    kw = dict(dec_step=dec_step, sdf_scale=sdf_scale, sigma=sigma, lr=lr, adam_eps=adam_eps,
              weight_e=weight_e, num_grad_eps=num_grad_eps, layer_norm=layer_norm)
    if f0.device.type == "cpu":
        return map_loop_reference(*args, **kw)
    return _launch(False, *args, **kw)


def _launch(
    streamed: bool, f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp: MLPParams,
    n_iters, max_iters: int, mlp_lr, denom_inv, eik_den_inv, *,
    dec_step: int, sdf_scale: float, sigma: float, lr: float,
    adam_eps: float, weight_e: float, num_grad_eps: float, layer_norm: bool = False,
) -> Tuple[torch.Tensor, MLPParams, torch.Tensor]:
    """``map_loop``'s kernel launch. ``streamed`` keeps each block's slab in
    device memory even where it fits in shared memory, a hook for the card
    tests and the timing tools; the result does not depend on it."""
    if f0.device.type != "cuda":
        raise ValueError(f"map_loop: unsupported device {f0.device}")
    global launches
    dev = f0.device
    bs, K, F = f0.shape
    P = encw0.shape[1]
    bd = vd.shape[0]
    nh = len(mlp.weights)
    H = mlp.weights[0].shape[1]
    if F != 8 or not 1 <= K <= 8 or F + P > 16 or H not in (32, 64) or nh not in (1, 2):
        raise ValueError(
            f"map_loop kernel takes feature_dim 8, K<=8, P<=8, hidden 32|64 and "
            f"1-2 hidden layers; got F={F} K={K} P={P} H={H} levels={nh}"
        )
    if mlp.w_out.shape != (H, 1) or mlp.weights[0].shape[0] != F + P:
        raise ValueError("map_loop: MLP shapes do not match the inputs")
    if bd < 1 or (bd - 1) * dec_step >= bs:
        raise ValueError(f"map_loop: bd={bd} tap rows do not fit bs={bs}")
    for name, t, shape in (
        ("f0", f0, (bs, K, F)), ("w0", w0, (bs, K)), ("encw0", encw0, (bs, P)),
        ("label_op", label_op, (bs,)), ("wsel", wsel, (bs,)),
        ("wtap", wtap, (6, bd, K)), ("enctapw", enctapw, (6, bd, P)), ("vd", vd, (bd,)),
    ):
        _check(name, t, shape, dev)
    if f0.data_ptr() % 16 != 0:
        raise ValueError("map_loop: f0 is not 16-byte aligned")
    pl = plan(bs, K, P, H, nh, layer_norm, bd, dec_step, dev, streamed)
    flat = flatten_mlp(mlp)
    npg = flat.numel() + 2
    f_out = torch.empty_like(f0)
    mom = torch.empty((2,) + (f0.shape if not pl.resident else (1,)), dtype=torch.float32, device=dev)
    partials = torch.empty((pl.grid, npg), dtype=torch.float32, device=dev)
    scratch = torch.empty(max(1, pl.grid * pl.work), dtype=torch.float32, device=dev)
    losses = torch.zeros(2, dtype=torch.float32, device=dev)

    def dev_scalar(x):
        return torch.as_tensor(x, device=dev).to(torch.float32).reshape(())

    scal = torch.stack([
        dev_scalar(n_iters), dev_scalar(mlp_lr), dev_scalar(denom_inv), dev_scalar(eik_den_inv)
    ]).contiguous()
    err = _build.load_module("map_loop").map_loop(
        f0.data_ptr(), f_out.data_ptr(), mom[0].data_ptr(), mom[1].data_ptr(), w0.data_ptr(),
        encw0.data_ptr(), label_op.data_ptr(), wsel.data_ptr(), wtap.data_ptr(),
        enctapw.data_ptr(), vd.data_ptr(), flat.data_ptr(), partials.data_ptr(),
        scratch.data_ptr(), losses.data_ptr(), scal.data_ptr(),
        bs, K, P, H, nh, int(bool(layer_norm)), bd, dec_step, int(max_iters),
        pl.grid, pl.spc, pl.ntap, int(pl.resident),
        sdf_scale, sigma, lr, adam_eps, weight_e, num_grad_eps,
        torch._C._cuda_getCurrentRawStream(f0.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"map_loop kernel launch failed: cudaError {err}")
    # the scratch tensors may be freed before the kernel runs: the caching
    # allocator hands their blocks out again only in this stream's order
    launches += 1
    return f_out, unflatten_mlp(flat, mlp), losses


def map_loop_reference(
    f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp: MLPParams,
    n_iters, max_iters: int, mlp_lr, denom_inv, eik_den_inv, *,
    dec_step: int, sdf_scale: float, sigma: float, lr: float,
    adam_eps: float, weight_e: float, num_grad_eps: float,
    layer_norm: bool = False,
) -> Tuple[torch.Tensor, MLPParams, torch.Tensor]:
    """Plain PyTorch version of the kernel's function (autograd + Adam),
    the math of ``tests/test_pallas_mapping.py:ref_loop``."""
    n = min(int(n_iters), int(max_iters))
    bd = vd.shape[0]
    mlp_lr = torch.as_tensor(mlp_lr, device=f0.device, dtype=torch.float32)
    denom_inv = torch.as_tensor(denom_inv, device=f0.device, dtype=torch.float32)
    eik_den_inv = torch.as_tensor(eik_den_inv, device=f0.device, dtype=torch.float32)

    def ln(x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)

    def mlp_apply(x, ps):
        nh = (len(ps) - 2) // 2
        h = x
        for i in range(nh):
            h = torch.relu(h @ ps[i] + ps[nh + i])
        return (h @ ps[-2])[..., 0] + ps[-1][0]

    def loss_fn(f, ps):
        fk = ln(f) if layer_norm else f
        fw = torch.sum(fk * w0[..., None], dim=1)
        pred = mlp_apply(torch.cat([fw, encw0], -1), ps) * sdf_scale
        z = pred / sigma
        bce = torch.relu(z) - z * label_op + torch.log1p(torch.exp(-torch.abs(z)))
        sdf_loss = torch.sum(wsel * bce) * denom_inv
        fdk = fk[::dec_step][:bd]
        fw_tap = torch.sum(fdk[None] * wtap[..., None], dim=2)  # [6,bd,F]
        tp = mlp_apply(torch.cat([fw_tap, enctapw], -1), ps) * sdf_scale
        g = torch.stack([tp[0] - tp[3], tp[1] - tp[4], tp[2] - tp[5]], -1) / (
            2 * num_grad_eps
        )
        gn = torch.sqrt(torch.sum(g * g, -1) + 1e-20)
        eik = torch.sum(((gn - 1.0) ** 2) * vd) * eik_den_inv
        return sdf_loss + weight_e * eik, sdf_loss, eik

    params = [f0.detach().clone()] + [t.detach().clone() for t in mlp.tensors()]
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    losses = torch.zeros(2, dtype=torch.float32, device=f0.device)
    for i in range(n):
        with torch.enable_grad():
            leaves = [p.requires_grad_(True) for p in params]
            loss, sdf_l, eik_l = loss_fn(leaves[0], leaves[1:])
            grads = torch.autograd.grad(loss, leaves)
        t = float(i + 1)
        new = []
        for j, (p, g) in enumerate(zip(params, grads)):
            lr_j = lr if j == 0 else mlp_lr
            ms[j] = 0.9 * ms[j] + 0.1 * g
            vs[j] = 0.99 * vs[j] + 0.01 * g * g
            mh = ms[j] / (1 - 0.9**t)
            vh = vs[j] / (1 - 0.99**t)
            new.append((p.detach() - lr_j * mh / (torch.sqrt(vh) + adam_eps)))
        params = new
        losses = torch.stack([sdf_l.detach(), eik_l.detach()])
    nh = len(mlp.weights)
    ps = params[1:]
    return params[0], MLPParams(ps[:nh], ps[nh : 2 * nh], ps[2 * nh], ps[2 * nh + 1]), losses
