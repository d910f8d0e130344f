"""Positional encodings for the relative-position suffix of map queries
(port of clid_slam_tpu/ops/encoding.py). With ``num_bands = 0`` (every
shipped config) encoding is off and queries carry the raw 3-vector."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import on_device


def positional_scales(num_bands: int, freq: float, base: float) -> np.ndarray:
    """Log-spaced scales: logspace(0, log_base(freq/2), bands, base)."""
    stop = np.log(freq / 2) / np.log(base)
    return np.logspace(0.0, stop, num_bands, base=base).astype(np.float32)


def positional_encode(
    x: torch.Tensor, scales: torch.Tensor, input_dim: int = 3
) -> torch.Tensor:
    """[..., D] -> [..., D*(2*bands+1)]: per-dim (sin, cos over bands, x)."""
    x = x[..., :input_dim, None]  # [..., D, 1]
    xs = x * scales.to(x.device) * math.pi
    enc = torch.cat([torch.sin(xs), torch.cos(xs), x], dim=-1)
    return enc.reshape(*enc.shape[:-2], -1)


def gaussian_fourier_matrix(
    num_bands: int, freq: float, input_dim: int = 3, seed: int = 42
) -> np.ndarray:
    """Fixed random projection B ~ N(0, freq²), [D, bands]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((input_dim, num_bands)) * freq).astype(
        np.float32
    )


def gaussian_fourier_encode(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., D + 2*bands]."""
    proj = (2.0 * math.pi * x) @ B.to(x.device)
    return torch.cat([x, torch.sin(proj), torch.cos(proj)], dim=-1)


def make_encoder(
    *,
    num_bands: int,
    freq: float,
    base: float,
    use_gaussian: bool,
    input_dim: int = 3,
    seed: int = 42,
) -> Tuple[Optional[Callable[[torch.Tensor], torch.Tensor]], int]:
    """(encode_fn | None, encoded_dim); ``num_bands <= 0`` disables it."""
    if num_bands <= 0:
        return None, input_dim
    if use_gaussian:
        B = on_device(torch.from_numpy(
            gaussian_fourier_matrix(num_bands, freq, input_dim, seed)
        ))
        return (lambda x: gaussian_fourier_encode(x, B(x.device))), input_dim + 2 * num_bands
    scales = on_device(torch.from_numpy(positional_scales(num_bands, freq, base)))
    return (
        lambda x: positional_encode(x, scales(x.device), input_dim)
    ), input_dim * (2 * num_bands + 1)
