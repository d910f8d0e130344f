"""The fused per-frame mapping Adam loop in plain PyTorch: a frozen copy of
``map_loop_reference``, ``flatten_mlp`` and ``unflatten_mlp`` in
``clid_slam_torch/ops/map_loop.py`` (lines 62-85 and 205-271 as of commit
806f431). ``map_loop`` runs the plain version on any device: the
reference never launches the hand-written kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.decoder import MLPParams


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


def map_loop(
    f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp: MLPParams,
    n_iters, max_iters: int, mlp_lr, denom_inv, eik_den_inv, *,
    dec_step: int, sdf_scale: float, sigma: float, lr: float,
    adam_eps: float, weight_e: float, num_grad_eps: float,
    layer_norm: bool = False,
) -> Tuple[torch.Tensor, MLPParams, torch.Tensor]:
    """min(n_iters, max_iters) Adam steps of the plain loop."""
    return map_loop_reference(
        f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp, n_iters, max_iters, mlp_lr,
        denom_inv, eik_den_inv, dec_step=dec_step, sdf_scale=sdf_scale, sigma=sigma, lr=lr,
        adam_eps=adam_eps, weight_e=weight_e, num_grad_eps=num_grad_eps, layer_norm=layer_norm)


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
