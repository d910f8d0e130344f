"""Trajectory error: ATE (translation RMSE, mean, median) and ARE
(rotation RMSE) against the ground truth, with optional SE(3) alignment.
A frozen copy of ``clid_slam_torch/utils/metrics.py:align_se3`` and
``absolute_error`` (lines 17-61 as of commit 806f431). The benchmark
writes them on standard error, not as metrics: one seed's ATE moves
chaotically with any change of reduction order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def align_se3(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form rigid alignment est->gt (rotation R, translation t)."""
    mu_e = est_xyz.mean(0)
    mu_g = gt_xyz.mean(0)
    E = est_xyz - mu_e
    G = gt_xyz - mu_g
    W = G.T @ E
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_g - R @ mu_e
    return R, t


def absolute_error(
    est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True
) -> Dict[str, float]:
    """ATE translation RMSE (+ mean/median) and rotation RMSE (deg) after
    optional SE(3) alignment (utils/eval_traj_utils.py:11-107)."""
    n = min(len(est_poses), len(gt_poses))
    est = np.asarray(est_poses[:n], np.float64)
    gt = np.asarray(gt_poses[:n], np.float64)
    e_xyz = est[:, :3, 3]
    g_xyz = gt[:, :3, 3]
    if align and n >= 3:
        R, t = align_se3(e_xyz, g_xyz)
        e_xyz = e_xyz @ R.T + t
        e_rot = np.einsum("ij,njk->nik", R, est[:, :3, :3])
    else:
        e_rot = est[:, :3, :3]
    terr = np.linalg.norm(e_xyz - g_xyz, axis=-1)
    ate_rmse = float(np.sqrt(np.mean(terr**2)))

    rel = np.einsum("nij,nik->njk", gt[:, :3, :3], e_rot)  # gtᵀ·est
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    ang = np.degrees(np.arccos(tr))
    are_rmse = float(np.sqrt(np.mean(ang**2)))
    return {
        "ate_rmse_m": ate_rmse,
        "ate_mean_m": float(terr.mean()),
        "ate_median_m": float(np.median(terr)),
        "are_rmse_deg": are_rmse,
    }
