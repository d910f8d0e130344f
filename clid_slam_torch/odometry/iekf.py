"""IESEKF pieces of the streaming frame step (port of
clid_slam_tpu/odometry/iekf.py): device IMU propagation and the two
iterated updates. The host float64 ``IEKF`` of the JAX package is not
ported (the classic driver is later work).

Device loops:
- ``device_predict_imu`` composes the per-row rotation increments and the
  affine covariance maps with a log-depth (Hillis-Steele) scan, the same
  associative formulation as JAX's ``associative_scan``.
- ``make_cached_update_fn`` (one probe per frame, dense math per
  iteration) and ``make_update_iterated_fn`` (the map re-queried at every
  iteration through ``make_h_reduce_fn``) share one Python loop with the
  JAX while-loop's exit rules (convergence, stagnation, low validity). It
  reads the exit flag on the host once per iteration.

Both measurement reductions decode weighted-first (the IDW-weighted
feature decoded once) or, with ``weighted_first=False``, decode each
neighbour and take the weighted mean; a point then also needs a weighted
SDF standard deviation under ``max_sdf_std``. The std is read off the
graph (``_decoded_mean_std``), as the JAX package's is an auxiliary output
that its ``jax.grad`` does not differentiate.
"""

from __future__ import annotations

import math

import torch

from ..models import decoder as dec
from ..models import neural_map as nm
from ..ops.gather import gather_lanes
from ..utils import lie

G_M_S2 = 9.81


def _inclusive_scan(combine, xs):
    """Inclusive scan along dim 0 with an associative ``combine(earlier,
    later)`` in ceil(log2 K) batched steps."""
    n = xs[0].shape[0]
    d = 1
    while d < n:
        prev = tuple(x[:-d] for x in xs)
        cur = tuple(x[d:] for x in xs)
        comb = combine(prev, cur)
        xs = tuple(torch.cat([x[:d], c], 0) for x, c in zip(xs, comb))
        d *= 2
    return xs


def device_predict_imu(rot, pos, vel, bg, ba, grav, P, Q, imu_rows, imu_count):
    """IMU forward propagation, f32. ``imu_rows`` is a fixed [K,7] (dt, acc,
    gyro) buffer; rows at or past ``imu_count`` are exact identity steps."""
    K = imu_rows.shape[0]
    dev = imu_rows.device
    I3 = torch.eye(3, device=dev)
    live = (torch.arange(K, device=dev) < imu_count).to(torch.float32)
    dt = imu_rows[:, 0] * live
    acc = imu_rows[:, 1:4]
    gyro = imu_rows[:, 4:7]

    # orientation chain: inclusive prefix products of exp((gyro-bg) dt)
    dR = lie.so3_exp((gyro - bg) * dt[:, None])
    (M_inc,) = _inclusive_scan(lambda a, b: (a[0] @ b[0],), (dR,))
    R_pre = torch.cat([I3[None], M_inc[:-1]], 0)
    R_pre = rot @ R_pre
    rot_n = rot @ M_inc[-1]

    a_c = acc - ba
    f_vel = torch.einsum("kij,kj->ki", R_pre, a_c) + grav
    dvel = f_vel * dt[:, None]
    vel_pre = vel + torch.cat(
        [torch.zeros((1, 3), device=dev), torch.cumsum(dvel, 0)[:-1]], 0
    )
    vel_n = vel + torch.sum(dvel, 0)
    pos_n = pos + torch.sum(vel_pre * dt[:, None], 0)

    # covariance: P -> F P Fᵀ + G per row, composed as affine pairs
    a_skew = lie.skew(a_c)
    dtk = dt[:, None, None]
    F = torch.eye(18, device=dev).repeat(K, 1, 1)
    F[:, 0:3, 9:12] = -I3 * dtk
    F[:, 3:6, 6:9] = I3 * dtk
    F[:, 6:9, 0:3] = -(R_pre @ a_skew) * dtk
    F[:, 6:9, 12:15] = -R_pre * dtk
    F[:, 6:9, 15:18] = I3 * dtk
    Fw = torch.zeros((K, 18, 12), device=dev)
    Fw[:, 0:3, 0:3] = -I3 * dtk
    Fw[:, 6:9, 3:6] = -R_pre * dtk
    Fw[:, 9:12, 6:9] = I3 * dtk
    Fw[:, 12:15, 9:12] = I3 * dtk
    G = Fw @ Q @ Fw.transpose(-1, -2)

    def compose(x, y):  # apply x first, then y
        Ax, Bx = x
        Ay, By = y
        return Ay @ Ax, Ay @ Bx @ Ay.transpose(-1, -2) + By

    A_tot, B_tot = _inclusive_scan(compose, (F, G))
    A_last, B_last = A_tot[-1], B_tot[-1]
    P_n = A_last @ P @ A_last.T + B_last
    P_n = 0.5 * (P_n + P_n.T)
    return rot_n, pos_n, vel_n, bg, ba, grav, P_n


def _equilibrated_solve(A, B):
    """Solve A X = B with Jacobi equilibration (unit diagonal first)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-20))
    Dinv = 1.0 / d
    An = A * Dinv[:, None] * Dinv[None, :]
    Bn = B * Dinv[:, None]
    return torch.linalg.solve(An, Bn) * Dinv[:, None]


def _normal_equations(points_imu, rot, grad, sdf_pred, valid, info_scale):
    """The 6x6 reduction S = Hᵀ R⁻¹ H, b = Hᵀ R⁻¹ z over the valid points
    (utils/error_state_iekf.py:249-262): H = [p × (Rᵀ g), g] and robust
    weights. Returns (S6, b6, n_valid)."""
    vf = valid.to(torch.float32)
    grad_norm = torch.linalg.norm(grad, dim=-1)
    gR = grad @ rot
    h_rot = torch.linalg.cross(points_imu, gR, dim=-1)
    H = torch.cat([h_rot, grad], -1)
    w_grad = 1.0 / (1.0 + (grad_norm - 1.0) ** 2)
    w_res = 0.4 / (0.4 + sdf_pred**2)
    r_inv = info_scale * w_grad * w_res * vf
    S6 = (H * r_inv[:, None]).T @ H
    b6 = (H * r_inv[:, None]).T @ sdf_pred
    return S6, b6, torch.sum(vf)


def _iterated_update(h_reduce, mask, rot0, pos0, rest0, P, *, max_iteration, term_rad,
                     term_thre_m, eps, min_valid_ratio, stagnation_iter):
    """The iterated IESEKF update over ``h_reduce(rot, pos) -> (S6, b6,
    n_valid)`` (utils/error_state_iekf.py:266-337). Returns (rot, pos,
    rest, P_new, ok, n_iter)."""
    dev = mask.device
    n_total = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    I18 = torch.eye(18, device=dev)
    P_inv = _equilibrated_solve(P, I18)
    rot, pos, rest, A_inv = rot0, pos0, rest0, P
    n_valid = torch.zeros((), device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    prev_step = torch.full((), float("inf"), device=dev)
    i = 0
    while i < max_iteration:
        drot = lie.so3_log(rot0.T @ rot)
        dx_new = torch.cat([drot, pos - pos0, rest - rest0])
        S6, b6, n_valid = h_reduce(rot, pos)
        S18 = torch.zeros((18, 18), device=dev)
        S18[:6, :6] = S6
        b18 = torch.zeros(18, device=dev)
        b18[:6] = b6
        sol = _equilibrated_solve(S18 + P_inv, torch.cat([b18[:, None], S18, I18], 1))
        KH = sol[:, 1:19]
        A_inv = sol[:, 19:]
        dx = -sol[:, 0] + (KH - I18) @ dx_new
        # trust region: steps beyond the frame-level failure bound are
        # solver blow-ups, never real motion
        tran_raw = torch.linalg.norm(dx[3:6])
        dx = dx * torch.clamp(10.0 / torch.clamp(tran_raw, min=1e-12), max=1.0)
        rot = rot @ lie.so3_exp(dx[0:3])
        pos = pos + dx[3:6]
        rest = rest + dx[6:18]
        tran_m = torch.linalg.norm(dx[3:6])
        rot_rad = torch.linalg.norm(dx[0:3])
        converged = (
            (rot_rad < term_rad) & (tran_m < term_thre_m)
            & torch.all(torch.abs(dx[6:]) < eps)
        )
        step = rot_rad + tran_m
        stalled = (i >= stagnation_iter) & (step >= prev_step)
        low_valid = (n_valid / n_total < min_valid_ratio) & (i == max_iteration - 1)
        ok = ~low_valid
        prev_step = step
        i += 1
        if bool(converged | low_valid | stalled):  # one host read per iteration
            break
    ok = ok & ~((n_valid / n_total < min_valid_ratio) & (i == max_iteration))
    P_new = 0.5 * (A_inv + A_inv.T)
    return rot, pos, rest, P_new, ok, torch.tensor(i, dtype=torch.int32, device=dev)


def _decoded_mean_std(pred_k, w):
    """Decode-then-weight: the IDW-weighted mean of the per-neighbour SDFs
    [N, k] and, detached, their weighted standard deviation (detached: the
    square root's gradient at a zero variance is not finite)."""
    pred = torch.sum(pred_k * w, dim=1)
    pk, pm, wd = pred_k.detach(), pred.detach(), w.detach()
    var = torch.sum(wd * (pk - pm[:, None]) ** 2, dim=1)
    return pred, torch.sqrt(torch.clamp(var, min=0.0))


def _loop_kw(max_iteration, term_thre_deg, term_thre_m, eps, min_valid_ratio,
             stagnation_iter) -> dict:
    """``_iterated_update``'s exit rules from an update factory's arguments."""
    return dict(
        max_iteration=max_iteration, term_rad=term_thre_deg * math.pi / 180.0,
        term_thre_m=term_thre_m, eps=eps, min_valid_ratio=min_valid_ratio,
        stagnation_iter=stagnation_iter,
    )


def make_cached_update_fn(
    *,
    knn_k: int,
    n_cand: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    min_grad_norm: float,
    max_grad_norm: float,
    min_nn_count: int,
    max_iteration: int,
    term_thre_deg: float,
    term_thre_m: float,
    eps: float = 0.001,
    min_valid_ratio: float = 0.2,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    encode_vecs=None,
    weighted_first: bool = True,
    layer_norm: bool = False,
    max_sdf_std: float = float("inf"),
    stagnation_iter: int = 10,
    info_scale: float = 1000.0,
):
    """Candidate-cached iterated IESEKF update: one hash probe + feature
    gather at the propagated pose, then dense [S, n_cand] math per
    iteration. Returns body(map_state, mlp, points_imu[S,3], mask[S], rot0,
    pos0, rest0[12], P, travel_dist, cur_ts, window) -> (rot, pos, rest,
    P_new, ok, n_iter)."""
    loop_kw = _loop_kw(max_iteration, term_thre_deg, term_thre_m, eps, min_valid_ratio,
                       stagnation_iter)
    offs_t = torch.as_tensor(nb_offs)

    def build_candidates(map_state, points_imu, rot0, pos0, travel_dist, cur_ts, window):
        cap = nm.map_capacity(map_state)
        pc0 = points_imu @ rot0.T + pos0
        d2, h, pvalid, mir = nm.neighborhood_probe(
            map_state, pc0, offs_t.to(pc0.device), resolution, max_valid_dist2,
            travel_dist, cur_ts, window, True,
        )
        d2s = torch.where(pvalid, d2, torch.full_like(d2, 9e3))
        sel = nm.smallest_k(d2s, n_cand)
        h_sel = gather_lanes(h, sel)
        cand_pos = gather_lanes(mir, sel)[..., :3]
        cvalid = (gather_lanes(d2s, sel) < 9e3) & ~nm.dedupe_mask(h_sel)
        idx = map_state.hash_table[h_sel].to(torch.int64)
        cvalid = cvalid & (idx >= 0)
        safe = torch.where(cvalid, idx, torch.full_like(idx, cap))
        cand_feat = map_state.geo_feats[safe]
        if layer_norm:
            cand_feat = nm.layer_norm_feats(cand_feat)
        cand_feat = torch.where(cvalid[..., None], cand_feat, torch.zeros_like(cand_feat))
        return cand_pos, cand_feat, cvalid

    def dense_update(candidates, mlp, points_imu, mask, rot0, pos0, rest0, P):
        cand_pos, cand_feat, cvalid = candidates
        iot = torch.arange(n_cand, device=points_imu.device)
        tie = iot[None, :] < iot[:, None]  # [C,C] j<i

        def h_reduce_cached(rot, pos):
            pc_map = (points_imu @ rot.T + pos).detach()
            with torch.enable_grad():
                pc = pc_map.requires_grad_(True)
                vecs = pc[:, None, :] - cand_pos
                cd2 = torch.sum(vecs * vecs, dim=-1)
                valid = cvalid & (cd2 <= max_valid_dist2)
                nn_count = torch.sum(valid.to(torch.int32), dim=-1)
                cd2s = torch.where(valid, cd2, torch.full_like(cd2, 9e3)).detach()
                before = (cd2s[:, None, :] < cd2s[:, :, None]) | (
                    (cd2s[:, None, :] == cd2s[:, :, None]) & tie[None]
                )
                rank = torch.sum(before.to(torch.int32), dim=-1)
                kvalid = (rank < knn_k) & valid
                kvecs = encode_vecs(vecs) if encode_vecs is not None else vecs
                kvecs = torch.where(kvalid[..., None], kvecs, torch.zeros_like(kvecs))
                w = nm.idw_weights(cd2, kvalid, nn_count)
                feat_vec = torch.cat([cand_feat, kvecs], -1)
                if weighted_first:
                    feature = torch.sum(feat_vec * w[..., None], dim=1)
                    pred = dec.sdf(mlp, feature, sdf_scale, leaky=mlp_leaky, bf16=mlp_bf16)
                else:
                    pred, sdf_std = _decoded_mean_std(
                        dec.sdf(mlp, feat_vec, sdf_scale, leaky=mlp_leaky, bf16=mlp_bf16), w
                    )
                (grad,) = torch.autograd.grad(pred.sum(), pc)
            grad_norm = torch.linalg.norm(grad, dim=-1)
            valid = (
                mask
                & (nn_count >= min_nn_count)
                & (grad_norm > min_grad_norm)
                & (grad_norm < max_grad_norm)
            )
            if not weighted_first:
                valid = valid & (sdf_std < max_sdf_std)
            return _normal_equations(points_imu, rot, grad, pred.detach(), valid, info_scale)

        return _iterated_update(h_reduce_cached, mask, rot0, pos0, rest0, P, **loop_kw)

    def body(map_state, mlp, points_imu, mask, rot0, pos0, rest0, P,
             travel_dist, cur_ts, window):
        cands = build_candidates(map_state, points_imu, rot0, pos0, travel_dist, cur_ts, window)
        return dense_update(cands, mlp, points_imu, mask, rot0, pos0, rest0, P)

    return body


def make_h_reduce_fn(
    *,
    knn_k: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    min_grad_norm: float,
    max_grad_norm: float,
    min_nn_count: int,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    encode_vecs=None,
    weighted_first: bool = True,
    layer_norm: bool = False,
    max_sdf_std: float = float("inf"),
    info_scale: float = 1000.0,
):
    """The measurement reduction with the map queried at the given pose
    (``query_feature`` over the whole neighbourhood).
    Returns h_reduce(map_state, mlp, points_imu[N,3], mask[N], R[3,3], t[3],
    travel_dist, cur_ts, window) -> (S6[6,6], b6[6], n_valid)."""
    offs_t = torch.as_tensor(nb_offs)

    def h_reduce(map_state, mlp, points_imu, mask, R, t, travel_dist, cur_ts, window):
        pc_map = (points_imu @ R.T + t).detach()
        with torch.enable_grad():
            pc = pc_map.requires_grad_(True)
            q = nm.query_feature(
                map_state, pc, offs_t.to(pc.device), resolution, max_valid_dist2, knn_k,
                travel_dist, cur_ts, window, True, encode_vecs=encode_vecs,
                layer_norm=layer_norm, weighted_first=weighted_first,
            )
            pred = dec.sdf(mlp, q.feature, sdf_scale, leaky=mlp_leaky, bf16=mlp_bf16)
            if not weighted_first:
                pred, sdf_std = _decoded_mean_std(pred, q.weights)
            (grad,) = torch.autograd.grad(pred.sum(), pc)
        grad_norm = torch.linalg.norm(grad, dim=-1)
        valid = (
            mask
            & (q.nn_count >= min_nn_count)
            & (grad_norm > min_grad_norm)
            & (grad_norm < max_grad_norm)
        )
        if not weighted_first:
            valid = valid & (sdf_std < max_sdf_std)
        return _normal_equations(points_imu, R, grad, pred.detach(), valid, info_scale)

    return h_reduce


def make_update_iterated_fn(
    *,
    knn_k: int,
    nb_offs,
    resolution: float,
    max_valid_dist2: float,
    sdf_scale: float,
    min_grad_norm: float,
    max_grad_norm: float,
    min_nn_count: int,
    max_iteration: int,
    term_thre_deg: float,
    term_thre_m: float,
    eps: float = 0.001,
    min_valid_ratio: float = 0.2,
    mlp_leaky: bool = False,
    mlp_bf16: bool = False,
    encode_vecs=None,
    weighted_first: bool = True,
    layer_norm: bool = False,
    max_sdf_std: float = float("inf"),
    stagnation_iter: int = 10,
    info_scale: float = 1000.0,
):
    """The iterated update that re-queries the map at every iteration
    (``track_cached=False``): the body of ``make_cached_update_fn`` with
    ``make_h_reduce_fn`` in place of the candidate cache."""
    h_core = make_h_reduce_fn(
        knn_k=knn_k, nb_offs=nb_offs, resolution=resolution,
        max_valid_dist2=max_valid_dist2, sdf_scale=sdf_scale,
        min_grad_norm=min_grad_norm, max_grad_norm=max_grad_norm,
        min_nn_count=min_nn_count, mlp_leaky=mlp_leaky, mlp_bf16=mlp_bf16,
        encode_vecs=encode_vecs, weighted_first=weighted_first, layer_norm=layer_norm,
        max_sdf_std=max_sdf_std, info_scale=info_scale,
    )
    loop_kw = _loop_kw(max_iteration, term_thre_deg, term_thre_m, eps, min_valid_ratio,
                       stagnation_iter)

    def body(map_state, mlp, points_imu, mask, rot0, pos0, rest0, P,
             travel_dist, cur_ts, window):
        def h_reduce(rot, pos):
            return h_core(map_state, mlp, points_imu, mask, rot, pos,
                          travel_dist, cur_ts, window)

        return _iterated_update(h_reduce, mask, rot0, pos0, rest0, P, **loop_kw)

    return body
