"""The end-to-end arithmetic of a window."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def frames_per_s(n_frames: int, window_s: float) -> float:
    """All frames completed in the window over the window's seconds."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    return n_frames / window_s


def p95_ms(latencies_s: Sequence[float]) -> float:
    """The 95th percentile of every frame's call-to-pose time, in ms
    (numpy's linear interpolation between order statistics)."""
    if len(latencies_s) == 0:
        raise ValueError("no frame completed in the window")
    return float(np.percentile(np.asarray(latencies_s, np.float64), 95.0)) * 1e3
