"""SO(3)/SE(3) Lie-group math and quaternion utilities (port of
clid_slam_tpu/utils/lie.py). Branch-free (``torch.where`` for the
small-angle series) and batched over leading dimensions.

Quaternion convention: wxyz (scalar first).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _outer(w: torch.Tensor) -> torch.Tensor:
    """w wᵀ as a broadcast multiply (W@W = w wᵀ − (wᵀw) I for W = skew(w))."""
    return w[..., :, None] * w[..., None, :]


def _matvec3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(M * v[..., None, :], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix [v]_x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]; the untaken branch is evaluated
    at θ²=1 so gradients stay finite at θ=0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    ts = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / t2s)
    W = skew(w)
    I = _eye3(w).expand(W.shape)
    bb = b[..., None, None]
    return (
        (1.0 - bb * theta2[..., None, None]) * I
        + a[..., None, None] * W
        + bb * _outer(w)
    )


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]: scale·vee(R - Rᵀ), scale = 0.5 θ/sin θ."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = torch.abs(theta) < 1e-4
    theta_s = torch.where(small, torch.ones_like(theta), theta)
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        0.5 * theta_s / (torch.sin(theta_s) + _EPS),
    )
    return scale[..., None] * w


def so3_jacobian_right_T(v: torch.Tensor) -> torch.Tensor:
    """A(v)ᵀ, the transposed left Jacobian of SO(3)."""
    n2 = torch.sum(v * v, dim=-1)
    n = torch.sqrt(n2 + _EPS * _EPS)
    small = n2 < 1e-22
    n2c = n2.clamp(min=1e-24)
    t1 = torch.where(small, torch.full_like(n2, 0.5), (1.0 - torch.cos(n)) / n2c)
    t2 = torch.where(
        small, torch.full_like(n2, 1.0 / 6.0), (1.0 - torch.sin(n) / n) / n2c
    )
    S = skew(v)
    I = _eye3(v).expand(S.shape)
    tt2 = t2[..., None, None]
    return (
        (1.0 - tt2 * n2[..., None, None]) * I
        + t1[..., None, None] * S
        + tt2 * _outer(v)
    )


# ---------------------------------------------------------------- SE(3)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """se(3) [..., 6] (rot first, then trans) -> [..., 4, 4]."""
    w, u = tau[..., :3], tau[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    ts = torch.sqrt(t2s)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1 - torch.cos(ts)) / t2s)
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (ts - torch.sin(ts)) / (t2s * ts),
    )
    W = skew(w)
    I = _eye3(tau).expand(W.shape)
    cc = c[..., None, None]
    V = (
        (1.0 - cc * theta2[..., None, None]) * I
        + b[..., None, None] * W
        + cc * _outer(w)
    )
    t = _matvec3(V, u)
    T = torch.zeros(tau.shape[:-1] + (4, 4), dtype=tau.dtype, device=tau.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> se(3) [..., 6] (rot, trans)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    ts = torch.sqrt(t2s)
    W = skew(w)
    I = _eye3(T).expand(W.shape)
    coef = torch.where(
        small,
        torch.full_like(theta2, 1.0 / 12.0),
        1.0 / t2s - (1.0 + torch.cos(ts)) / (2.0 * ts * torch.sin(ts) + _EPS),
    )
    cf = coef[..., None, None]
    Vinv = (1.0 - cf * theta2[..., None, None]) * I - 0.5 * W + cf * _outer(w)
    u = _matvec3(Vinv, t)
    return torch.cat([w, u], dim=-1)


# ------------------------------------------------------------ quaternions


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors [..., 3] by quaternions [..., 4] (wxyz)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u.expand(v.shape), v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u.expand(v.shape), uv, dim=-1))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                dim=-1,
            ),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> wxyz quaternion (branch-free Shepperd selection)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        dim=-1,
    )
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        dim=-1,
    )
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        dim=-1,
    )
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        dim=-1,
    )
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions; t broadcastable."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d).clamp(-1.0, 1.0)
    theta = torch.arccos(d.clamp(max=1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    small = d > 1.0 - 1e-6
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    w0 = torch.where(
        small, 1.0 - t, torch.sin((1.0 - t) * theta) / (sin_theta + _EPS)
    )
    w1 = torch.where(small, t, torch.sin(t * theta) / (sin_theta + _EPS))
    return quat_normalize(w0 * q0 + w1 * q1)
