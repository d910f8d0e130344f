"""Map optimization: the online Adam loop over the neural point map (port
of clid_slam_tpu/mapping/mapper.py, candidate-cached path).

Two bodies, as in the JAX streaming step:
- the single-batch body (``max_outer=1``), used on tracked frames: one
  replay batch per frame, its kNN geometry frozen in a cache. With
  ``dup_independent`` the expanded [bs, K, F] features are trained as
  independent parameters and the per-point mean delta is written back
  once: with ``use_pallas`` (``cfg.map_pallas``) by the fused kernel
  (``ops/map_loop.py``) where the config is eligible, else by the autograd
  loop, with a ``RuntimeWarning`` that names the reasons when
  ``use_pallas`` asked for the kernel. Without ``dup_independent`` the
  autograd loop trains the compact [W, F] work slab itself;
- the general multi-batch body, used on frame 0: ``ceil(iters / R)``
  batches of R Adam steps each on a compact working slab, with torch
  autograd, Adam moments persisting across batches in full-capacity slabs.

The work-slab gathers go through ``ops/gather.py:gather_rows`` (the
hand-written row-gather kernel on the card): once per autograd step in
``_SlabGatherSorted`` and twice per single-batch call, for the geometric
slab and, with ``color_on``, for the color slab.

Color, semantics, decode-then-weight and bf16 decoding are not in the
fused kernel: tracked frames with any of them map with the autograd loop.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models import decoder as dec
from ..models import neural_map as nm
from ..mapping.pool import ReplayPool, sample_batch_indices, split_rows
from ..ops.gather import gather_lanes, gather_rows, gather_rows_nd
from ..ops.map_loop import map_loop
from ..ops.voxel import grid_coords, voxel_hash
from ..utils import observability as obs

SUPPORTED_LOSS_TYPES = ("bce", "zhong", "sdf_l1", "sdf_l2")


def _adam_update(g, m, v, t, lr, eps=1e-15, b1=0.9, b2=0.99):
    """One Adam step (betas 0.9/0.99, the reference's online setting).
    Returns (update, m, v)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1**t)
    vh = v / (1 - b2**t)
    return -lr * mh / (torch.sqrt(vh) + eps), m, v


def pallas_ineligible_reasons(
    *,
    color_on: bool,
    sem_on: bool,
    weighted_first: bool,
    mlp_bf16: bool,
    mlp_leaky: bool,
    loss_type: str,
    feature_dim: int,
    n_hidden: int,
):
    """Static eligibility of the fused mapping kernel (the same rules as
    the JAX Pallas loop); an empty list means the kernel runs."""
    reasons = []
    if color_on:
        reasons.append("color_on")
    if sem_on:
        reasons.append("semantic_on")
    if not weighted_first:
        reasons.append("weighted_first=False")
    if mlp_bf16:
        reasons.append("mlp_bf16")
    if mlp_leaky:
        reasons.append("mlp_leaky_relu")
    if loss_type != "bce":
        reasons.append(f"loss_type={loss_type}")
    if feature_dim != 8:
        reasons.append(f"feature_dim={feature_dim}")
    if n_hidden > 2:
        reasons.append(f"geo_mlp_level={n_hidden}")
    return reasons


def pallas_ineligible_reasons_config(cfg):
    """``pallas_ineligible_reasons`` of a Config (for tests and user
    diagnostics)."""
    return pallas_ineligible_reasons(
        color_on=cfg.color_on,
        sem_on=cfg.semantic_on,
        weighted_first=cfg.weighted_first,
        mlp_bf16=cfg.mlp_bf16,
        mlp_leaky=cfg.mlp_leaky_relu,
        loss_type=cfg.main_loss_type,
        feature_dim=cfg.feature_dim,
        n_hidden=cfg.geo_mlp_level,
    )


def make_sdf_loss(label, weight, bvalid, *, loss_type, sigma, loss_weight_on,
                  saturated_grad=True):
    """Main SDF loss: ``loss(pred)`` = masked mean over live rows.

    ``bce`` is optax's ``sigmoid_binary_cross_entropy``, the JAX package's
    loss: where the logit z and the target saturate together (free space
    far in front of a surface) its gradient, -sigmoid(-z), stays a few
    1e-9, and Adam (eps 1e-15) steps on it. ``saturated_grad=False`` takes
    relu(z) - z t + log1p(e^-|z|) instead, whose gradient rounds to 0
    there, as the fused kernel's does; only frame 0's general body uses it
    (ROADMAP C)."""
    w_abs = torch.abs(weight) * bvalid
    denom = torch.clamp(torch.sum(bvalid), min=1.0)
    w = w_abs if loss_weight_on else bvalid
    if loss_type == "bce":
        target = torch.sigmoid(label / sigma)

        def per(pred):
            z = pred / sigma
            if saturated_grad:
                return -target * F.logsigmoid(z) - (1.0 - target) * F.logsigmoid(-z)
            return torch.relu(z) - z * target + torch.log1p(torch.exp(-torch.abs(z)))

    elif loss_type == "zhong":
        mid = label / 2.0

        def per(pred):
            return torch.relu(torch.abs(pred - mid) - torch.abs(mid))

    elif loss_type == "sdf_l1":
        w = w_abs

        def per(pred):
            return torch.abs(pred - label)

    elif loss_type == "sdf_l2":
        w = w_abs

        def per(pred):
            return (pred - label) ** 2

    else:
        raise ValueError(
            f"unsupported main_loss_type {loss_type!r}; "
            f"choose one of {SUPPORTED_LOSS_TYPES}"
        )

    return lambda pred: torch.sum(per(pred) * w) / denom


def _sorted_scatter_add(exp, order, run_lengths):
    """Sum expanded [bs,k,F] values into their work rows through the
    frame-constant sorted permutation: one segment sum per work row, in
    sorted order (the order JAX's sorted scatter-add applies). Fixed order
    on any device, unlike ``index_add_`` with atomics or the CPU
    ``index_put_`` accumulation behind autograd's gather backward."""
    gf = exp.reshape(-1, exp.shape[-1])[order]
    return torch.segment_reduce(gf, "sum", lengths=run_lengths, axis=0, unsafe=True)


class _SlabGatherSorted(torch.autograd.Function):
    """``slab[idx2d]`` whose backward sums the cotangents per work row with
    ``_sorted_scatter_add`` (JAX: ``mapper._slab_gather_sorted``)."""

    @staticmethod
    def forward(ctx, slab, idx2d, order, run_lengths):
        ctx.save_for_backward(order, run_lengths)
        return gather_rows_nd(slab, idx2d)

    @staticmethod
    def backward(ctx, g):
        order, run_lengths = ctx.saved_tensors
        return _sorted_scatter_add(g, order, run_lengths), None, None, None


class BatchCache(NamedTuple):
    bvalid: torch.Tensor  # [bs] f32
    label: torch.Tensor
    weight: torch.Tensor
    ts: torch.Tensor  # [bs] i32
    sem_lbl: torch.Tensor  # [bs] i32
    color_lbl: torch.Tensor  # [bs,C]
    valid: torch.Tensor  # [bs,k]
    knn_idx: torch.Tensor  # [bs,k] map rows (-1 invalid)
    local_idx: torch.Tensor  # [bs,k] work-slab rows
    src_rows: torch.Tensor  # [W] map row of each work row (cap = unused)
    order: torch.Tensor  # [bs*k] argsort of the flat map rows
    run_lengths: torch.Tensor  # [W] references per work row
    w0: torch.Tensor  # [bs,k]
    enc0: torch.Tensor  # [bs,k,P] per neighbour (decode-then-weight)
    encw0: torch.Tensor  # [bs,P] weighted sum (weighted-first)
    vd: torch.Tensor  # [bd]
    w_tap: torch.Tensor  # [6,bd,k]
    enc_tap: torch.Tensor  # [6,bd,k,P]
    enc_tapw: torch.Tensor  # [6,bd,P]


def make_mapping_fn(
    *,
    feature_dim: int,
    knn_k: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    sigma: float,
    bs: int,
    bs_new: int,
    gradient_decimation: int,
    num_grad_eps: float,
    weight_e: float,
    loss_weight_on: bool,
    lr: float,
    adam_eps: float,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    color_on: bool = False,
    sem_on: bool = False,
    weight_i: float = 1.0,
    weight_s: float = 1.0,
    surface_sample_range_m: float = 0.25,
    freespace_label_on: bool = False,
    rotate_vecs: bool = False,
    encode_vecs=None,
    weighted_first: bool = True,
    layer_norm: bool = False,
    resample_every: int = 10,
    loss_type: str = "bce",
    max_outer: int = 0,
    dup_independent: bool = False,
    use_pallas: bool = False,
):
    """Returns ``mapping(map_state, mlp, color_mlp, sem_mlp, pool,
    travel_dist, cur_ts, window, iter_count, mlp_lr_scale, generator=None,
    batch_draws=None) -> (map_state, mlp, color_mlp, sem_mlp, losses[2])``.
    ``batch_draws`` is a list with one (idx_hist, pick) pair per replay
    batch (see ``pool.sample_batch_indices``); otherwise batches come from
    ``generator``. ``mapping.build_cache`` samples and freezes one batch.

    Beside the SDF and eikonal losses: with ``color_on`` the second feature
    slab ``color_feats`` trains with ``color_mlp`` (an L1 loss on surface
    samples, weight ``weight_i``); with ``sem_on`` ``sem_mlp`` decodes the
    geometric features (an NLL loss on labelled samples, weight
    ``weight_s``), so its gradient reaches those features too. A head that
    is off is neither decoded nor updated. ``weighted_first=False`` decodes
    each neighbour and weights the decoded values; ``mlp_bf16`` decodes in
    bf16 (``models/decoder.py``).

    ``use_pallas`` (the JAX package's name) picks the fused kernel for the
    single-batch body with ``dup_independent``; without it that body runs
    the autograd loop on the expanded features, the JAX package's loop off
    the Pallas path. ``rotate_vecs`` is the post-PGO mode of
    ``neural_map.query_feature``: the relative vectors are rotated before
    they are encoded, so the kernel receives rotated encodings."""
    if max_outer not in (0, 1):
        raise NotImplementedError(
            "the port has the general body (max_outer=0) and the single-batch "
            "body (max_outer=1)"
        )
    bd = max(1, bs // gradient_decimation)
    dec_step = gradient_decimation
    R = max(1, resample_every)
    W = bs * knn_k
    offs_t = torch.as_tensor(nb_offs)
    dkw = dict(leaky=mlp_leaky, bf16=mlp_bf16)

    def build_cache(map_state, pool, travel_dist, cur_ts, window, generator, draws):
        """Sample one batch and freeze its query geometry."""
        dev = pool.data.device
        cap = nm.map_capacity(map_state)
        idx = sample_batch_indices(pool, bs, bs_new, generator, draws)
        rows = pool.data[idx]
        # batch sorted by voxel hash (a free reordering: losses are sums)
        key_h = voxel_hash(
            grid_coords(rows[:, :3], resolution), map_state.hash_table.shape[0]
        )
        order = torch.argsort(key_h, stable=True)
        idx, rows = idx[order], rows[order]
        bvalid = (pool.valid[idx] & (idx < pool.size)).to(torch.float32)
        coord, label, weight, ts, sem_lbl, color_lbl = split_rows(rows)

        d2, h, pvalid, mir = nm.neighborhood_probe(
            map_state, coord, offs_t.to(dev), resolution, max_valid_dist2,
            travel_dist, cur_ts, window, True,
        )
        nn_count = torch.sum(pvalid.to(torch.int32), dim=-1)
        d2s = torch.where(pvalid, d2, torch.full_like(d2, 9e3))
        sel = nm.smallest_k(d2s, knn_k)
        knn_d2 = gather_lanes(d2s, sel)
        h_sel = gather_lanes(h, sel)
        valid = gather_lanes(pvalid, sel) & ~nm.dedupe_mask(h_sel)
        idx_sel = map_state.hash_table[h_sel].to(torch.int64)
        valid = valid & (idx_sel >= 0)
        knn_idx = torch.where(valid, idx_sel, torch.full_like(idx_sel, -1))
        safe = torch.where(valid, idx_sel, torch.full_like(idx_sel, cap))
        nb_pos = gather_lanes(mir, sel)[..., :3]

        vec0 = coord[:, None, :] - nb_pos  # [bs,k,3]
        quat_sel = gather_rows_nd(map_state.quats, safe) if rotate_vecs else None
        vec0_r = nm.conj_rotate(quat_sel, vec0) if rotate_vecs else vec0
        w0 = nm.idw_weights(knn_d2, valid, nn_count)
        enc0 = encode_vecs(vec0_r) if encode_vecs is not None else vec0_r
        enc0 = torch.where(valid[..., None], enc0, torch.zeros_like(enc0))

        # tap geometry (±eps per axis on decimated rows), reusing the
        # center's kNN; validity re-gated by the distance cap
        vd = bvalid[::dec_step][:bd]
        vec_d = vec0[::dec_step][:bd]
        valid_d = valid[::dec_step][:bd]
        eps3 = torch.eye(3, device=dev) * num_grad_eps
        tap_off = torch.cat([eps3, -eps3], 0)  # [6,3]
        tap_vec = vec_d[None] + tap_off[:, None, None, :]  # [6,bd,k,3]
        tap_d2 = torch.sum(tap_vec * tap_vec, dim=-1)
        tap_valid = valid_d[None] & (tap_d2 <= max_valid_dist2)
        tap_nc = torch.sum(tap_valid.to(torch.int32), dim=-1)
        w_tap = nm.idw_weights(tap_d2, tap_valid, tap_nc)
        if rotate_vecs:
            tap_vec = nm.conj_rotate(quat_sel[::dec_step][:bd][None], tap_vec)
        enc_tap = encode_vecs(tap_vec) if encode_vecs is not None else tap_vec
        enc_tap = torch.where(tap_valid[..., None], enc_tap, torch.zeros_like(enc_tap))

        # frame-local working set: sorted runs of the batch's map rows; the
        # run id is the compact work row, in ascending map-row order
        flat_g = safe.reshape(-1)
        order_g = torch.argsort(flat_g, stable=True)
        sorted_g = flat_g[order_g]
        newrun = torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev), sorted_g[1:] != sorted_g[:-1]]
        )
        runid = torch.cumsum(newrun.to(torch.int64), 0) - 1
        local_idx = torch.zeros_like(flat_g).scatter_(0, order_g, runid).reshape(safe.shape)
        src_ext = torch.full((W + 1,), cap, dtype=torch.int64, device=dev)
        src_ext.scatter_(0, torch.where(newrun, runid, torch.full_like(runid, W)), sorted_g)
        run_lengths = torch.zeros(W, dtype=torch.int64, device=dev).index_add_(
            0, runid, torch.ones_like(runid)
        )
        return BatchCache(
            bvalid=bvalid, label=label, weight=weight, ts=ts, sem_lbl=sem_lbl,
            color_lbl=color_lbl, valid=valid, knn_idx=knn_idx, local_idx=local_idx,
            src_rows=src_ext[:W], order=order_g, run_lengths=run_lengths, w0=w0,
            enc0=enc0, encw0=torch.sum(enc0 * w0[..., None], dim=1), vd=vd, w_tap=w_tap,
            enc_tap=enc_tap, enc_tapw=torch.sum(enc_tap * w_tap[..., None], dim=2),
        )

    def decode_weighted(mlp_, feats, enc, w, encw, head, **kw):
        """``head`` over the kNN features [..., k, F] and encodings: of the
        weighted feature ‖ the weighted encoding ``encw`` (weighted-first),
        or per neighbour and then weighted (decode-then-weight)."""
        if weighted_first:
            fw = torch.sum(feats * w[..., None], dim=-2)
            return head(mlp_, torch.cat([fw, encw], -1), **kw)
        pred_k = head(mlp_, torch.cat([feats, enc], -1), **kw)
        if pred_k.dim() == w.dim():  # a scalar head
            return torch.sum(pred_k * w, dim=-1)
        return torch.sum(pred_k * w[..., None], dim=-2)

    def make_loss_fn(c: BatchCache, expanded: bool = False, saturated_grad: bool = True):
        """``loss_fn(works, mlps)``; ``works`` holds the [W, F] work slab
        (and the color slab with ``color_on``) or, with ``expanded``, the
        [bs, k, F] per-reference features; ``mlps`` the geometric MLP (then
        the color and the semantic MLP when on); ``saturated_grad`` as in
        ``make_sdf_loss``."""
        sdf_loss_of = make_sdf_loss(
            c.label, c.weight, c.bvalid, loss_type=loss_type, sigma=sigma,
            loss_weight_on=loss_weight_on, saturated_grad=saturated_grad,
        )
        eik_den = torch.clamp(torch.sum(c.vd), min=1.0)
        w_lbl = torch.abs(c.weight) * c.bvalid if loss_weight_on else c.bvalid
        surface_mask = (torch.abs(c.label) < surface_sample_range_m).to(torch.float32) * c.bvalid
        lbl_ok = (c.sem_lbl >= 0) if freespace_label_on else (c.sem_lbl > 0)
        sem_mask = lbl_ok.to(torch.float32) * c.bvalid
        sem_idx = torch.clamp(c.sem_lbl, min=0).long()[:, None]

        def gather(slab):
            return slab if expanded else _SlabGatherSorted.apply(
                slab, c.local_idx, c.order, c.run_lengths
            )

        def loss_fn(works, mlps):
            mlp_ = mlps[0]
            f = gather(works[0])
            if layer_norm:
                f = nm.layer_norm_feats(f)
            f = torch.where(c.valid[..., None], f, torch.zeros_like(f))
            pred = decode_weighted(mlp_, f, c.enc0, c.w0, c.encw0, dec.sdf,
                                   sdf_scale=sdf_scale, **dkw)
            sdf_loss = sdf_loss_of(pred)
            fd = f[::dec_step][:bd]
            tap_pred = decode_weighted(
                mlp_, fd[None].expand((6,) + fd.shape), c.enc_tap, c.w_tap, c.enc_tapw,
                dec.sdf, sdf_scale=sdf_scale, **dkw,
            )  # [6,bd]
            g = torch.stack(
                [
                    tap_pred[0] - tap_pred[3],
                    tap_pred[1] - tap_pred[4],
                    tap_pred[2] - tap_pred[5],
                ],
                dim=-1,
            ) / (2 * num_grad_eps)
            gn = torch.sqrt(torch.sum(g * g, dim=-1) + 1e-20)
            eik = torch.sum(((gn - 1.0) ** 2) * c.vd) / eik_den
            loss = sdf_loss + weight_e * eik
            if color_on:
                cf = gather(works[1])
                cf = torch.where(c.valid[..., None], cf, torch.zeros_like(cf))
                cpred = decode_weighted(mlps[1], cf, c.enc0, c.w0, c.encw0,
                                        dec.regress_color, **dkw)
                cdiff = torch.mean(torch.abs(cpred - c.color_lbl), dim=-1)
                color_loss = torch.sum(cdiff * surface_mask * w_lbl) / torch.clamp(
                    torch.sum(surface_mask * w_lbl), min=1.0
                )
                loss = loss + weight_i * color_loss
            if sem_on:
                logp = decode_weighted(mlps[-1], f, c.enc0, c.w0, c.encw0,
                                       dec.sem_label_prob, **dkw)  # [bs,S]
                nll = -torch.gather(logp, 1, sem_idx)[:, 0]
                sem_loss = torch.sum(nll * sem_mask) / torch.clamp(torch.sum(sem_mask), min=1.0)
                loss = loss + weight_s * sem_loss
            return loss, sdf_loss, eik

        return loss_fn

    def accumulate_cert(map_state, c: BatchCache, inner_n):
        """Certainty + update-ts once per batch, scaled by its step count."""
        itf = torch.clamp(torch.as_tensor(inner_n, device=c.w0.device).to(torch.float32), min=0.0)
        st = nm.accumulate_certainty(map_state, c.knn_idx, c.w0 * itf, c.ts)
        tap_idx_d = c.knn_idx[::dec_step][:bd]
        tap_w_sum = torch.sum(c.w_tap, dim=0) * itf
        return nm.accumulate_certainty(st, tap_idx_d, tap_w_sum, None)

    def mlps_of(leaves, sizes):
        """The flat MLP leaves as one ``MLPParams`` per entry of ``sizes``
        (each MLP's leaf count)."""
        out, i = [], 0
        for n in sizes:
            ps, nh = leaves[i : i + n], (n - 2) // 2
            out.append(dec.MLPParams(list(ps[:nh]), list(ps[nh : 2 * nh]), ps[2 * nh], ps[2 * nh + 1]))
            i += n
        return out

    def adam_steps(loss_fn, works, mws, vws, mlp_ps, mlp_m, mlp_v, sizes, t_base, n_steps,
                   mlp_lr):
        """``n_steps`` autograd Adam steps on the slabs ``works`` and the MLP
        leaves ``mlp_ps`` (``sizes`` leaves per MLP), step numbers
        continuing from ``t_base``. Returns the new (works, mws, vws,
        mlp_ps, mlp_m, mlp_v, [sdf_loss, eik_loss])."""
        losses = torch.zeros(2, device=works[0].device)
        # new leaves: the caller's tensors stay grad-free
        works = [w.detach() for w in works]
        nw = len(works)
        for i in range(n_steps):
            with torch.enable_grad():
                leaves = [w.requires_grad_(True) for w in works] + [
                    p.requires_grad_(True) for p in mlp_ps
                ]
                loss, sdf_l, eik_l = loss_fn(leaves[:nw], mlps_of(leaves[nw:], sizes))
                grads = torch.autograd.grad(loss, leaves)
            t = float(t_base + i + 1)
            new_w, new_mw, new_vw = [], [], []
            for w, g, m, v in zip(works, grads[:nw], mws, vws):
                upd, m, v = _adam_update(g, m, v, t, lr, adam_eps)
                new_w.append(w.detach() + upd)
                new_mw.append(m)
                new_vw.append(v)
            works, mws, vws = new_w, new_mw, new_vw
            new_ps, new_m, new_v = [], [], []
            for p, g, m, v in zip(mlp_ps, grads[nw:], mlp_m, mlp_v):
                u, m, v = _adam_update(g, m, v, t, mlp_lr, adam_eps)
                new_ps.append(p.detach() + u)
                new_m.append(m)
                new_v.append(v)
            mlp_ps, mlp_m, mlp_v = new_ps, new_m, new_v
            losses = torch.stack([sdf_l.detach(), eik_l.detach()])
        return works, mws, vws, mlp_ps, mlp_m, mlp_v, losses

    def flat_leaves(mlps):
        return [t.detach().clone() for m in mlps for t in m.tensors()], [
            len(m.tensors()) for m in mlps
        ]

    def autograd_loop(loss_fn, works0, mlps, n_steps, mlp_lr):
        """A fresh Adam (zero moments) for ``n_steps`` steps on the slabs
        ``works0`` and the MLPs. Returns (works, mlps, losses)."""
        mlp_ps, sizes = flat_leaves(mlps)
        zeros = [torch.zeros_like(t) for t in mlp_ps]
        works, _, _, mlp_ps, _, _, losses = adam_steps(
            loss_fn, works0, [torch.zeros_like(w) for w in works0],
            [torch.zeros_like(w) for w in works0], mlp_ps, zeros, list(zeros), sizes, 0,
            n_steps, mlp_lr,
        )
        return works, mlps_of(mlp_ps, sizes), losses

    def slabs_of(map_state):
        """The trained feature slabs: geometric, and color with ``color_on``."""
        return [map_state.geo_feats] + ([map_state.color_feats] if color_on else [])

    def with_slabs(st, slabs):
        if color_on:
            return st._replace(geo_feats=slabs[0], color_feats=slabs[1])
        return st._replace(geo_feats=slabs[0])

    def single_batch_body(map_state, mlps, pool, travel_dist, cur_ts, window,
                          iter_count, mlp_lr_scale, generator, batch_draws):
        dev = pool.data.device
        cap = nm.map_capacity(map_state)
        draws = batch_draws[0] if batch_draws is not None else None
        with obs.span("frame.map.cache"):
            c = build_cache(map_state, pool, travel_dist, cur_ts, window, generator, draws)
            works0 = [gather_rows(slab, c.src_rows) for slab in slabs_of(map_state)]  # [W,F]
            n_iters = torch.as_tensor(iter_count, device=dev).to(torch.int32)
            inner_n = torch.clamp(n_iters, max=R)
            mlp_lr = lr * torch.as_tensor(mlp_lr_scale, device=dev, dtype=torch.float32)
            if dup_independent:
                f0s = [gather_rows_nd(w, c.local_idx) for w in works0]
        if not dup_independent:
            # the autograd loop reads its step count on the host, once
            n_steps = int(inner_n)
            obs.count("map.steps", n_steps)
            rows, mlps_new, losses = autograd_loop(
                make_loss_fn(c), works0, mlps, n_steps, mlp_lr
            )
        else:
            reasons = pallas_ineligible_reasons(
                color_on=color_on, sem_on=sem_on, weighted_first=weighted_first,
                mlp_bf16=mlp_bf16, mlp_leaky=mlp_leaky, loss_type=loss_type,
                feature_dim=feature_dim, n_hidden=len(mlps[0].weights),
            ) if use_pallas else []
            if reasons:
                warnings.warn(
                    "fused mapping kernel disabled for this config "
                    f"({', '.join(reasons)}); running the autograd loop",
                    RuntimeWarning,
                    stacklevel=3,
                )
            if reasons or not use_pallas:
                n_steps = int(inner_n)
                obs.count("map.steps", n_steps)
                f_new, mlps_new, losses = autograd_loop(
                    make_loss_fn(c, expanded=True), f0s, mlps, n_steps, mlp_lr
                )
            else:
                obs.count("map.steps", inner_n)  # read when the counters are
                wsel = torch.abs(c.weight) * c.bvalid if loss_weight_on else c.bvalid
                f_geo, mlp_new, losses = map_loop(
                    f0s[0], c.w0.contiguous(), c.encw0.contiguous(),
                    torch.sigmoid(c.label / sigma).contiguous(), wsel.contiguous(),
                    c.w_tap.contiguous(), c.enc_tapw.contiguous(), c.vd.contiguous(), mlps[0],
                    inner_n, R, mlp_lr,
                    1.0 / torch.clamp(torch.sum(c.bvalid), min=1.0),
                    1.0 / torch.clamp(torch.sum(c.vd), min=1.0),
                    dec_step=dec_step, sdf_scale=sdf_scale, sigma=sigma, lr=lr,
                    adam_eps=adam_eps, weight_e=weight_e, num_grad_eps=num_grad_eps,
                    layer_norm=layer_norm,
                )
                f_new, mlps_new = [f_geo], [mlp_new]
            counts = torch.clamp(c.run_lengths[:, None].to(torch.float32), min=1.0)
            # each work row moves by the mean delta of its references
            rows = [
                w0 + _sorted_scatter_add(fn - f0, c.order, c.run_lengths) / counts
                for w0, fn, f0 in zip(works0, f_new, f0s)
            ]
        slabs = []
        for slab, r in zip(slabs_of(map_state), rows):
            slab = slab.clone()
            slab[c.src_rows] = r  # duplicates only at the sentinel row
            slab[cap] = 0.0
            slabs.append(slab)
        st = accumulate_cert(map_state, c, inner_n)
        return with_slabs(st, slabs), mlps_new, losses

    def general_body(map_state, mlps, pool, travel_dist, cur_ts, window,
                     iter_count, mlp_lr_scale, generator, batch_draws):
        dev = pool.data.device
        cap = nm.map_capacity(map_state)
        n_iters = int(iter_count)  # host read: sizes the outer loop
        obs.count("map.steps", n_iters)
        n_outer = (n_iters + R - 1) // R
        slabs = [slab.clone() for slab in slabs_of(map_state)]
        m_slabs = [torch.zeros_like(slab) for slab in slabs]
        v_slabs = [torch.zeros_like(slab) for slab in slabs]
        mlp_ps, sizes = flat_leaves(mlps)
        mlp_m = [torch.zeros_like(t) for t in mlp_ps]
        mlp_v = [torch.zeros_like(t) for t in mlp_ps]
        mlp_lr = lr * torch.as_tensor(mlp_lr_scale, device=dev, dtype=torch.float32)
        st = map_state
        losses = torch.zeros(2, device=dev)
        for o in range(n_outer):
            draws = batch_draws[o] if batch_draws is not None else None
            c = build_cache(st, pool, travel_dist, cur_ts, window, generator, draws)
            works = [gather_rows(slab, c.src_rows) for slab in slabs]
            if o == 0:  # moments start at zero in every mapping call
                mws = [torch.zeros_like(w) for w in works]
                vws = [torch.zeros_like(w) for w in works]
            else:
                mws = [gather_rows(m, c.src_rows) for m in m_slabs]
                vws = [gather_rows(v, c.src_rows) for v in v_slabs]
            inner_n = min(R, n_iters - o * R)
            # frame 0 keeps the rule of the fused kernel at saturated
            # samples (make_sdf_loss; ROADMAP C)
            works, mws, vws, mlp_ps, mlp_m, mlp_v, losses = adam_steps(
                make_loss_fn(c, saturated_grad=False), works, mws, vws, mlp_ps, mlp_m, mlp_v,
                sizes, o * R, inner_n, mlp_lr,
            )
            # write back (duplicate src_rows only at the zeroed sentinel)
            for slab, w in zip(slabs, works):
                slab[c.src_rows] = w
                slab[cap] = 0.0
            if o + 1 < n_outer:
                for dst, src in zip(m_slabs + v_slabs, mws + vws):
                    dst[c.src_rows] = src
                    dst[cap] = 0.0
            st = accumulate_cert(st, c, inner_n)
        return with_slabs(st, slabs), mlps_of(mlp_ps, sizes), losses

    body = single_batch_body if max_outer == 1 else general_body

    def mapping(
        map_state: nm.NeuralMapState,
        mlp: dec.MLPParams,
        color_mlp: dec.MLPParams,
        sem_mlp: dec.MLPParams,
        pool: ReplayPool,
        travel_dist,
        cur_ts,
        window,
        iter_count,
        mlp_lr_scale,
        generator: Optional[torch.Generator] = None,
        batch_draws: Optional[List] = None,
    ):
        trained = [mlp] + [color_mlp] * color_on + [sem_mlp] * sem_on
        st, new, losses = body(map_state, trained, pool, travel_dist, cur_ts, window,
                               iter_count, mlp_lr_scale, generator, batch_draws)
        color_out = new[1] if color_on else color_mlp
        sem_out = new[-1] if sem_on else sem_mlp
        return st, new[0], color_out, sem_out, losses

    mapping.build_cache = build_cache
    return mapping


def make_novelty_fn(
    *,
    resolution: float,
    new_certainty_thre: float,
    surface_sample_range_m: float,
    mode: str = "certainty",
):
    """Novelty flags for adaptive-iteration batch mixing: a sample is new
    where the map certainty is low and it lies near the surface. ``mode ==
    "fast"`` reads the own-cell certainty (two gathers, the prep step's
    default); otherwise the distance-checked 1-cell maximum."""
    one_cell_mvd2 = 3.0 * (2.0 * resolution) ** 2

    def novelty(map_state, coords_global, sdf_label, mask):
        if mode == "fast":
            cert = nm.query_certainty_own_cell(map_state, coords_global, resolution)
        else:
            cert = nm.query_certainty_max(
                map_state, coords_global, resolution, one_cell_mvd2
            )
        return (
            (cert < new_certainty_thre)
            & (torch.abs(sdf_label) < surface_sample_range_m * 3.0)
            & mask
        )

    return novelty
