"""Point-cloud transforms with masked fixed-shape semantics (port of
clid_slam_tpu/utils/transforms.py): filters return masks, never compact."""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_device
from .lie import quat_slerp, quat_to_rotmat, rotmat_to_quat

_Q_ID = on_device(torch.tensor([1.0, 0.0, 0.0, 0.0]))  # the identity quaternion, wxyz


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply one rigid transform T[4,4] to points [N,3]."""
    return points @ T[:3, :3].T + T[:3, 3]


def transform_points_batch(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply per-point transforms T[N,4,4] to points [N,3]."""
    return torch.einsum("nij,nj->ni", T[:, :3, :3], points) + T[:, :3, 3]


def deskew(
    points: torch.Tensor,
    ts: torch.Tensor,
    rel_pose: torch.Tensor,
    ts_mid_pose: float = 0.5,
) -> torch.Tensor:
    """Move each point along ``rel_pose`` (T_last<-cur) in proportion to its
    normalized timestamp: rotation slerped from identity, translation
    lerped (utils/tools.py:802-837 of the reference)."""
    if ts is None:
        return points
    ts = ts.reshape(-1)
    t_min, t_max = torch.min(ts), torch.max(ts)
    ts = (ts - t_min) / torch.clamp(t_max - t_min, min=1e-12)
    ts = ts - ts_mid_pose
    n = points.shape[0]
    q_rel = rotmat_to_quat(rel_pose[:3, :3])
    # copied to the device once, so that a frame's deskew waits for nothing
    q_id = _Q_ID(points.device).to(points.dtype)
    q_t = quat_slerp(q_id.expand(n, 4), q_rel.expand(n, 4), ts[:, None])
    R_t = quat_to_rotmat(q_t)  # [N,3,3]
    tran = ts[:, None] * rel_pose[:3, 3]
    return torch.einsum("nij,nj->ni", R_t, points) + tran


def adaptive_crop_range(points, max_range: float) -> float:
    """Adaptive max-range crop (host numpy, before upload)."""
    p = np.asarray(points)[:, :3]
    mx = np.abs(p.max(0))
    mn = np.abs(p.min(0))
    inner = max(min(mx[0], mn[0]), min(mx[1], mn[1]))
    return min(float(max_range), 2.0 * float(inner))


def crop_mask(
    points: torch.Tensor,
    min_z: float,
    max_z: float,
    min_range: float,
    max_range,
) -> torch.Tensor:
    """Range/z crop as a boolean mask (no compaction)."""
    dist = torch.linalg.norm(points, dim=-1)
    return (
        (dist > min_range)
        & (dist < max_range)
        & (points[:, 2] > min_z)
        & (points[:, 2] < max_z)
    )
