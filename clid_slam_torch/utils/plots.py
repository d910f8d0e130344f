"""Result plotting: per-stage timing chart and trajectory plots (the port's
copy of clid_slam_tpu/utils/plots.py).

Equivalent of the reference's timing stack plot (utils/tools.py:926-1040,
with the 100 ms real-time line) and the evo-style trajectory plots
(utils/eval_traj_utils.py:241-314). Matplotlib only; every function is a
no-op returning False if matplotlib is unavailable.
"""

from __future__ import annotations

import numpy as np


def plot_timing_detail(time_table, path: str, realtime_limit_ms: float = 100.0):
    """Stacked per-frame stage timing with a real-time budget line."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    tt = np.asarray(time_table) * 1e3  # ms
    if tt.ndim != 2 or len(tt) == 0:
        return False
    labels = ["preprocess", "odometry", "map prep", "map opt", "mesh"][
        : tt.shape[1]
    ]
    frames = np.arange(len(tt))
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.stackplot(frames, tt.T, labels=labels, alpha=0.85)
    ax.axhline(
        realtime_limit_ms, color="k", ls="--", lw=1, label="real-time limit"
    )
    ax.set_xlabel("frame")
    ax.set_ylabel("time (ms)")
    ax.set_ylim(0, min(np.percentile(tt.sum(1), 99) * 1.3, 1e4))
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def plot_trajectory(est_poses, gt_poses, path: str):
    """Top-down x-y trajectory plot, est vs ground truth."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    est = np.asarray(est_poses)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(est[:, 0, 3], est[:, 1, 3], "b-", lw=1.2, label="estimate")
    if gt_poses is not None:
        gt = np.asarray(gt_poses)
        n = min(len(gt), len(est))
        ax.plot(gt[:n, 0, 3], gt[:n, 1, 3], "r--", lw=1.0, label="ground truth")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def feature_pca_colors(
    feats: np.ndarray,
    principal_components: np.ndarray = None,
    down_rate: int = 1,
):
    """Project per-point latent features onto their top-3 principal
    components and normalize to RGB in [0,1] — the reference's neural-point
    feature visualization (utils/tools.py:858-923: center, covariance
    eigendecomposition, 2%/98% quantile normalization).

    Returns (colors [N,3], principal_components [D,3]); pass the
    components back in to color further batches consistently."""
    feats = np.asarray(feats, np.float64)
    n = feats.shape[0]
    centered = feats - feats.mean(0)
    if principal_components is None:
        sub = centered[::down_rate]
        cov = sub.T @ sub / max(n - 1, 1)
        eigval, eigvec = np.linalg.eigh(cov)  # ascending
        principal_components = eigvec[:, ::-1][:, :3]
    proj = centered @ principal_components
    lo = np.quantile(proj[::37] if n > 37 * 4 else proj, 0.02, axis=0)
    hi = np.quantile(proj[::37] if n > 37 * 4 else proj, 0.98, axis=0)
    colors = (proj - lo) / np.maximum(hi - lo, 1e-12)
    return np.clip(colors, 0.0, 1.0), principal_components
