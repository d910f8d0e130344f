"""IESEKF (port of clid_slam_tpu/odometry/iekf.py): the host float64
filter of the classic driver (``IEKF``: numpy ``predict`` one IMU row at a
time, and ``update_iterated`` over a measurement reduction on the device),
and the device pieces of the streaming frame step: IMU propagation and the
two iterated updates.

Device loops:
- ``device_predict_imu`` composes the per-row rotation increments and the
  affine covariance maps with a log-depth (Hillis-Steele) scan, the same
  associative formulation as JAX's ``associative_scan``.
- ``make_cached_update_fn`` (one probe per frame, dense math per
  iteration) and ``make_update_iterated_fn`` (the map re-queried at every
  iteration through ``make_h_reduce_fn``) share one iteration
  (``_iteration``) with the JAX while-loop's exit rules (convergence,
  stagnation, low validity) computed on the device. The host reads the exit
  flag once per iteration. On a CUDA device the cached update replays the
  iteration from a CUDA graph captured at its first call
  (``_GraphedIterations``, through ``graphs.py``), the same kernels on the
  same layouts; on the CPU, and in the re-querying update (data-dependent
  map probes), the iterations run eagerly.

Both measurement reductions decode weighted-first (the IDW-weighted
feature decoded once) or, with ``weighted_first=False``, decode each
neighbour and take the weighted mean; a point then also needs a weighted
SDF standard deviation under ``max_sdf_std``. The std is read off the
graph (``_decoded_mean_std``), as the JAX package's is an auxiliary output
that its ``jax.grad`` does not differentiate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import graphs
from ..device import on_device
from ..models import decoder as dec
from ..models import neural_map as nm
from ..ops.gather import gather_lanes
from ..utils import lie
from ..utils import observability as obs

G_M_S2 = 9.81


# ------------------------------------------------------- host float64 SO(3)


def _skew(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def _so3_exp(w):
    th = np.linalg.norm(w)
    if th < 1e-10:
        return np.eye(3)
    a = w / th
    K = _skew(a)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _so3_log(R):
    tr = np.trace(R)
    ct = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(ct)
    w = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], dtype=np.float64
    )
    if abs(th) < 1e-4:
        scale = 0.5 + th * th / 12.0
    else:
        scale = 0.5 * th / (np.sin(th) + 1e-12)
    return scale * w


@dataclass
class IEKFConfig:
    measurement_noise_covariance: float = 0.01
    bias_noise_covariance: float = 0.0001
    max_iteration: int = 50
    term_thre_deg: float = 0.01
    term_thre_m: float = 0.001
    eps: float = 0.001
    min_valid_ratio: float = 0.2


@dataclass
class IEKFState:
    """Nominal state; error-state covariance P."""

    rot: np.ndarray = field(default_factory=lambda: np.eye(3))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    vel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    bg: np.ndarray = field(default_factory=lambda: np.zeros(3))
    ba: np.ndarray = field(default_factory=lambda: np.zeros(3))
    grav: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -G_M_S2]))

    def boxplus(self, dx: np.ndarray) -> "IEKFState":
        return IEKFState(
            rot=self.rot @ _so3_exp(dx[0:3]),
            pos=self.pos + dx[3:6],
            vel=self.vel + dx[6:9],
            bg=self.bg + dx[9:12],
            ba=self.ba + dx[12:15],
            grav=self.grav + dx[15:18],
        )

    def boxminus(self, other: "IEKFState") -> np.ndarray:
        return np.concatenate(
            [
                _so3_log(other.rot.T @ self.rot),
                self.pos - other.pos,
                self.vel - other.vel,
                self.bg - other.bg,
                self.ba - other.ba,
                self.grav - other.grav,
            ]
        )

    def pose_matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.rot
        T[:3, 3] = self.pos
        return T


class IEKF:
    """Host-side filter. Mirrors utils/error_state_iekf.py:90-165 for the
    prediction step and :266-337 for the iterated update loop."""

    def __init__(self, cfg: IEKFConfig, init_bg=None, init_ba=None, init_grav=None):
        self.cfg = cfg
        self.x = IEKFState()
        if init_bg is not None:
            self.x.bg = np.asarray(init_bg, np.float64)
        if init_ba is not None:
            self.x.ba = np.asarray(init_ba, np.float64)
        if init_grav is not None:
            self.x.grav = np.asarray(init_grav, np.float64)
        P = np.eye(18)
        P[9:12, 9:12] *= 1e-4
        P[12:15, 12:15] *= 1e-3
        P[15:18, 15:18] *= 1e-4
        self.P = P
        Q = np.zeros((12, 12))
        Q[0:3, 0:3] = cfg.measurement_noise_covariance * np.eye(3)
        Q[3:6, 3:6] = cfg.measurement_noise_covariance * np.eye(3)
        Q[6:9, 6:9] = cfg.bias_noise_covariance * np.eye(3)
        Q[9:12, 9:12] = cfg.bias_noise_covariance * np.eye(3)
        self.Q = Q

    # ------------------------------------------------------------ predict
    def predict(self, acc: np.ndarray, gyro: np.ndarray, dt: float):
        x = self.x
        acc = np.asarray(acc, np.float64)
        gyro = np.asarray(gyro, np.float64)
        # motion model f (utils/error_state_iekf.py:167-174)
        f = np.zeros(18)
        f[0:3] = gyro - x.bg
        f[3:6] = x.vel
        f[6:9] = x.rot @ (acc - x.ba) + x.grav
        # F = df/dx (:126-141), with the reference's small-angle shortcuts
        F = np.eye(18)
        I_dt = np.eye(3) * dt
        F[0:3, 9:12] = -I_dt
        F[3:6, 6:9] = I_dt
        F[6:9, 0:3] = -x.rot @ _skew(acc - x.ba) * dt
        F[6:9, 12:15] = -x.rot * dt
        F[6:9, 15:18] = I_dt
        # Fw = df/dw (:143-156)
        Fw = np.zeros((18, 12))
        Fw[0:3, 0:3] = -np.eye(3)
        Fw[6:9, 3:6] = -x.rot
        Fw[9:12, 6:9] = np.eye(3)
        Fw[12:15, 9:12] = np.eye(3)
        Fw *= dt

        self.x = x.boxplus(f * dt)
        P = F @ self.P @ F.T + Fw @ self.Q @ Fw.T
        self.P = 0.5 * (P + P.T)  # keep P exactly symmetric

    # ---------------------------------------------------- iterated update
    def update_iterated(
        self,
        h_reduce: Callable,
        points_imu,  # [N,3] tensor, sensor/IMU frame
        mask,  # [N] bool tensor
        *h_args,
    ):
        """h_reduce(points_imu, mask, R_f32, t_f32, *h_args) -> (S6, b6,
        n_valid) on the device, as ``make_h_reduce_fn`` returns them (the
        JAX reduction's fourth output, the mask's count, is counted here).
        R and t go to the device as f32 tensors on ``mask``'s device; the
        filter algebra stays numpy f64."""
        cfg = self.cfg
        dev = mask.device
        n_total = max(int(torch.sum(mask.to(torch.int64))), 1)
        x_propagated = self.x
        P_inv = np.linalg.inv(self.P)
        I = np.eye(18)
        valid_flag = True
        converged = False
        S18 = np.zeros((18, 18))
        KH = np.zeros((18, 18))
        A_inv = self.P.copy()

        for i in range(cfg.max_iteration):
            dx_new = self.x.boxminus(x_propagated)
            S6, b6, n_valid = h_reduce(
                points_imu,
                mask,
                torch.as_tensor(self.x.rot, dtype=torch.float32, device=dev),
                torch.as_tensor(self.x.pos, dtype=torch.float32, device=dev),
                *h_args,
            )
            S6 = S6.detach().cpu().double().numpy()
            b6 = b6.detach().cpu().double().numpy()
            n_valid = int(n_valid)

            if (
                n_valid / n_total < cfg.min_valid_ratio
                and i == cfg.max_iteration - 1
            ):
                valid_flag = False

            S18[:] = 0.0
            S18[:6, :6] = S6
            b18 = np.zeros(18)
            b18[:6] = b6

            A_inv = np.linalg.inv(S18 + P_inv)
            KH = A_inv @ S18  # = K @ H
            dx = -(A_inv @ b18) + (KH - I) @ dx_new
            # trust region: a per-iteration step beyond the frame-level
            # catastrophic-failure bound (utils/slam_dataset.py:544-550) is
            # never legitimate — it means (S+P⁻¹) went near-singular; scale
            # the whole step back so the iteration stays in a sane basin
            step_cap = 10.0
            tran_raw = np.linalg.norm(dx[3:6])
            if tran_raw > step_cap:
                dx = dx * (step_cap / tran_raw)

            self.x = self.x.boxplus(dx)
            tran_m = np.linalg.norm(dx[3:6])
            rot_deg = np.linalg.norm(dx[0:3]) * 180.0 / np.pi
            if (
                rot_deg < cfg.term_thre_deg
                and tran_m < cfg.term_thre_m
                and np.all(np.abs(dx[6:]) < cfg.eps)
            ):
                converged = True
            if not valid_flag or converged:
                break

        # information-form covariance update: (I-KH)P == (S+P⁻¹)⁻¹ exactly,
        # but the right-hand form is symmetric-PSD by construction — the
        # product form loses definiteness in finite precision and a
        # non-PSD P eventually makes (S+P⁻¹) indefinite, exploding dx
        # (observed: 95 m iteration steps once P degraded)
        self.P = 0.5 * (A_inv + A_inv.T)
        return self.x.pose_matrix(), valid_flag



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
    gyro) buffer; rows at or past ``imu_count`` (an int or an integer
    device scalar) are exact identity steps."""
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
    """Solve A X = B with Jacobi equilibration (unit diagonal first). The
    factorisation's error flag is not read: a singular A gives non-finite
    values, as the JAX solve does, and the host never waits on the card."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-20))
    Dinv = 1.0 / d
    An = A * Dinv[:, None] * Dinv[None, :]
    Bn = B * Dinv[:, None]
    return torch.linalg.solve_ex(An, Bn)[0] * Dinv[:, None]


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


def _update_start(mask, rot0, pos0, rest0, P):
    """What an iterated update fixes before its first iteration: the
    constants (rot0, pos0, rest0, P⁻¹, n_total, I18) and the initial state
    (rot, pos, rest, A_inv, prev_step, ok, n_valid, i), all on the card."""
    dev = mask.device
    n_total = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    I18 = torch.eye(18, device=dev)
    consts = (rot0, pos0, rest0, _equilibrated_solve(P, I18), n_total, I18)
    state = (rot0, pos0, rest0, P, torch.full((), float("inf"), device=dev),
             torch.ones((), dtype=torch.bool, device=dev), torch.zeros((), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    return consts, state


def _iteration(h_reduce, consts, state, *, max_iteration, term_rad, term_thre_m, eps,
               min_valid_ratio, stagnation_iter):
    """One iteration of the iterated IESEKF update over ``h_reduce(rot, pos)
    -> (S6, b6, n_valid)`` (utils/error_state_iekf.py:266-337), with its
    exit rules on the card: (the next state, a bool that says stop). The
    state's ``i`` counts the iterations run."""
    rot0, pos0, rest0, P_inv, n_total, I18 = consts
    rot, pos, rest, _, prev_step, _, _, i = state
    drot = lie.so3_log(rot0.T @ rot)
    dx_new = torch.cat([drot, pos - pos0, rest - rest0])
    S6, b6, n_valid = h_reduce(rot, pos)
    S18 = torch.zeros((18, 18), device=rot.device)
    S18[:6, :6] = S6
    b18 = torch.zeros(18, device=rot.device)
    b18[:6] = b6
    sol = _equilibrated_solve(S18 + P_inv, torch.cat([b18[:, None], S18, I18], 1))
    KH = sol[:, 1:19]
    A_inv = sol[:, 19:]
    dx = -sol[:, 0] + (KH - I18) @ dx_new
    # trust region: steps beyond the frame-level failure bound are solver
    # blow-ups, never real motion
    tran_raw = torch.linalg.norm(dx[3:6])
    dx = dx * torch.clamp(10.0 / torch.clamp(tran_raw, min=1e-12), max=1.0)
    rot = rot @ lie.so3_exp(dx[0:3])
    pos = pos + dx[3:6]
    rest = rest + dx[6:18]
    tran_m = torch.linalg.norm(dx[3:6])
    rot_rad = torch.linalg.norm(dx[0:3])
    converged = (
        (rot_rad < term_rad) & (tran_m < term_thre_m) & torch.all(torch.abs(dx[6:]) < eps)
    )
    step = rot_rad + tran_m
    stalled = (i >= stagnation_iter) & (step >= prev_step)
    low_valid = (n_valid / n_total < min_valid_ratio) & (i == max_iteration - 1)
    state = (rot, pos, rest, A_inv, step, ~low_valid, n_valid, i + 1)
    return state, converged | low_valid | stalled


def _update_result(consts, state, *, max_iteration, min_valid_ratio, **_):
    """(rot, pos, rest, P_new, ok, n_iter) of the state the iterations left."""
    n_total = consts[4]
    rot, pos, rest, A_inv, _, ok, n_valid, n_iter = state
    ok = ok & ~((n_valid / n_total < min_valid_ratio) & (n_iter == max_iteration))
    # row-major, as a host copy or a checkpoint of the state holds it: the sum
    # comes out transposed, and the next frame's products round otherwise in
    # the two layouts
    P_new = (0.5 * (A_inv + A_inv.T)).contiguous()
    return rot, pos, rest, P_new, ok, n_iter


def _iterated_update(h_reduce, mask, rot0, pos0, rest0, P, **loop_kw):
    """The iterated IESEKF update, its iterations run eagerly. Returns (rot,
    pos, rest, P_new, ok, n_iter)."""
    consts, state = _update_start(mask, rot0, pos0, rest0, P)
    i = 0
    while i < loop_kw["max_iteration"]:
        with obs.span("frame.track.iter"):
            state, stop = _iteration(h_reduce, consts, state, **loop_kw)
            i += 1
            if bool(stop):  # one host read per iteration
                break
    obs.count("track.iters", i)
    return _update_result(consts, state, **loop_kw)


class _GraphedIterations:
    """The cached update's iterations on the card: one iteration captured
    as a CUDA graph over fixed buffers (``graphs.Capture``, at the first
    call for these shapes: ``precompile()`` makes that call before frame
    0), replayed once an iteration, with one host read of its stop flag. It
    computes what ``_iterated_update`` does to the bit: the same kernels on
    the same layouts.

    ``inputs`` (candidates, mlp, points_imu, mask, rot0, pos0, rest0, P) fix
    the buffers' shapes and strides; ``run`` copies a frame's inputs into
    them. While tracing, ``run`` counts the replays' operations in
    ``track.graph_flops``: one eager iteration's (``graphs.op_count``),
    counted when the counters are read, after the traced frames."""

    def __init__(self, make_h_reduce, inputs, loop_kw):
        self.loop_kw = loop_kw
        self.inputs = _rebuilt(inputs, graphs.buffers(_leaves(inputs)))
        self.device = inputs[2].device
        cands, mlp, points_imu, mask, rot0, pos0, rest0, P = self.inputs
        # held for the graph's life: the graph reads the tensors it closes over
        self.h_reduce = h_reduce = make_h_reduce(cands, mlp, points_imu, mask)
        with torch.cuda.device(self.device):
            self.consts, state = _update_start(mask, rot0, pos0, rest0, P)
            self.state = tuple(x.clone() for x in state)
            self.stop = torch.zeros((), dtype=torch.bool, device=self.device)

            def step():
                state, stop = _iteration(h_reduce, self.consts, self.state, **loop_kw)
                for buf, x in zip(self.state, state):
                    buf.copy_(x)
                self.stop.copy_(stop)

            (self.steps,) = graphs.Capture()([step])
        # an eager iteration over the buffers leaves them as they are
        self.flops = graphs.op_count(
            lambda: _iteration(h_reduce, self.consts, self.state, **loop_kw), self.device)

    def run(self, inputs):
        graphs.fill(_leaves(self.inputs), _leaves(inputs))
        cands, mlp, points_imu, mask, rot0, pos0, rest0, P = self.inputs
        consts, state = _update_start(mask, rot0, pos0, rest0, P)
        # rot0, pos0, rest0 and I18 are buffers already
        graphs.fill(self.consts[3:5] + self.state, consts[3:5] + state)
        i = 0
        with torch.cuda.device(self.device):
            while i < self.loop_kw["max_iteration"]:
                with obs.span("frame.track.iter"):
                    graphs.replay(self.steps)
                    i += 1
                    if bool(self.stop):  # one host read per iteration
                        break
        obs.count("track.iters", i)
        obs.count("track.graph_iters", i)
        obs.count("track.graph_flops", lambda: i * self.flops())
        rot, pos, rest, P_new, ok, n_iter = _update_result(self.consts, self.state,
                                                           **self.loop_kw)
        # the buffers are this object's: the caller gets copies
        return rot.clone(), pos.clone(), rest.clone(), P_new, ok, n_iter.clone()


def _leaves(inputs):
    """The tensors of (candidates, mlp, points_imu, mask, rot0, pos0, rest0,
    P): the decoder's, the candidates' (a candidate may be None), then the
    rest."""
    cands, mlp, *rest = inputs
    return mlp.tensors() + [c for c in cands if c is not None] + rest


def _rebuilt(inputs, leaves):
    """``inputs`` with its tensors, in ``_leaves``' order, replaced by
    ``leaves``."""
    cands, mlp, *rest = inputs
    it = iter(leaves)
    mlp = dec.MLPParams([next(it) for _ in mlp.weights], [next(it) for _ in mlp.biases],
                        next(it), next(it))
    return (tuple(None if c is None else next(it) for c in cands), mlp, *it)


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
    rotate_vecs: bool = False,
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
    offs_t = on_device(torch.as_tensor(nb_offs))

    def build_candidates(map_state, points_imu, rot0, pos0, travel_dist, cur_ts, window):
        cap = nm.map_capacity(map_state)
        pc0 = points_imu @ rot0.T + pos0
        d2, h, pvalid, mir = nm.neighborhood_probe(
            map_state, pc0, offs_t(pc0.device), resolution, max_valid_dist2,
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
        cand_quat = map_state.quats[safe] if rotate_vecs else None
        return cand_pos, cand_feat, cvalid, cand_quat

    def make_h_reduce(candidates, mlp, points_imu, mask):
        """h_reduce(rot, pos) -> (S6, b6, n_valid) over the frame's candidates."""
        cand_pos, cand_feat, cvalid, cand_quat = candidates
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
                kvecs = nm.conj_rotate(cand_quat, vecs) if rotate_vecs else vecs
                kvecs = encode_vecs(kvecs) if encode_vecs is not None else kvecs
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

        return h_reduce_cached

    captured = {}  # the captured iterations by their inputs' shapes, layouts and device

    def dense_update(candidates, mlp, points_imu, mask, rot0, pos0, rest0, P):
        """The iterations over built candidates: replays of one captured
        iteration on a CUDA device, the eager loop elsewhere."""
        inputs = (candidates, mlp, points_imu, mask, rot0, pos0, rest0, P)
        if points_imu.device.type != "cuda":
            h_reduce = make_h_reduce(candidates, mlp, points_imu, mask)
            return _iterated_update(h_reduce, mask, rot0, pos0, rest0, P, **loop_kw)
        # the factory fixes the options and exit constants; the inputs' shapes,
        # layouts, dtypes and device fix the rest of what a capture holds
        key = graphs.layout_key(_leaves(inputs))
        if key not in captured:
            captured[key] = _GraphedIterations(make_h_reduce, inputs, loop_kw)
        return captured[key].run(inputs)

    def body(map_state, mlp, points_imu, mask, rot0, pos0, rest0, P,
             travel_dist, cur_ts, window):
        with obs.span("frame.track.candidates"):
            cands = build_candidates(map_state, points_imu, rot0, pos0, travel_dist, cur_ts,
                                     window)
        return dense_update(cands, mlp, points_imu, mask, rot0, pos0, rest0, P)

    # the sharded tracker builds the candidates collectively and runs the
    # same dense iterations (parallel/spatial.py:make_sharded_tracker_fn)
    body.dense_update = dense_update
    body.n_cand = n_cand
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
    rotate_vecs: bool = False,
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
                travel_dist, cur_ts, window, True, rotate_vecs=rotate_vecs,
                encode_vecs=encode_vecs, layer_norm=layer_norm, weighted_first=weighted_first,
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
    rotate_vecs: bool = False,
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
        rotate_vecs=rotate_vecs, encode_vecs=encode_vecs, weighted_first=weighted_first, layer_norm=layer_norm,
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
