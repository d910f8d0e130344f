"""The yardstick of the kernels: the card's published peaks, and the
operations and bytes that a launch of K1 (the fused mapping Adam loop) or
of a gather needs, computed from its shapes and indices.

Frozen copies: ``k1_flops`` and ``k1_bytes`` of
``clid_slam_torch/tools/time_map_loop.py:flops`` and ``nbytes`` (lines
88-108 as of commit 806f431), with the bench's fixed sample count, taps
and widths (``BS``, ``K``, ``F``, ``P``) made arguments, so that each
launch is counted at its own shapes; ``gather_bytes`` of
``clid_slam_torch/tools/probe_gather.py:gather_bytes`` (lines 424-442).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, published (data sheet, dense): plain f32 outside the
# tensor cores, and the HBM3 rate. "NVIDIA H100 80GB HBM3" is the SXM part.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_s": 3.35e12},
}
SECTOR_BYTES = 32  # the unit in which the card's L2 moves device memory


def peaks(device_name: str) -> dict:
    """The published peaks of the card named ``device_name``; the H100's
    for any other name, which a reader should then not trust."""
    return PEAKS.get(device_name, PEAKS["NVIDIA H100 80GB HBM3"])


def k1_flops(n_hidden: int, n_iters: int, hidden: int, bd: int, bs: int, K: int, F: int,
             P: int) -> int:
    """Operations the loop needs: per sample and per tap one MLP forward
    and backward, the IDW feature sums both ways, and Adam on every
    parameter (~10 ops each)."""
    D = F + P
    fwd = 2 * D * hidden + 2 * hidden + (2 * hidden * hidden if n_hidden == 2 else 0)
    bwd = (2 * hidden + 2 * hidden + 2 * D * hidden + 2 * F * hidden
           + (4 * hidden * hidden if n_hidden == 2 else 0))
    feat = 4 * K * F
    n_params = D * hidden + hidden + (hidden * hidden + hidden if n_hidden == 2 else 0) + hidden + 1
    per_iter = (bs + 6 * bd) * (fwd + bwd + feat) + 10 * (bs * K * F + n_params)
    return per_iter * n_iters


def k1_bytes(n_hidden: int, hidden: int, bd: int, bs: int, K: int, F: int, P: int) -> int:
    """Each input read once, each output written once."""
    D = F + P
    n_params = D * hidden + hidden + (hidden * hidden + hidden if n_hidden == 2 else 0) + hidden + 1
    inputs = bs * K * F + bs * K + bs * P + 2 * bs + 6 * bd * (K + P) + bd + n_params
    outputs = bs * K * F + n_params + 2
    return 4 * (inputs + outputs)


def gather_bytes(kernel: str, table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> int:
    """The bytes this call needs: the indices read once, the output written
    once, and of the table the 32-byte sectors that these indices touch
    (not the whole table: an index vector may leave most of it unread)."""
    i = idx.long()
    width = table.shape[1]
    element = table.element_size()
    if kernel == "gather_rows":  # every element of a touched row
        elems = (torch.unique(i)[:, None] * width
                 + torch.arange(width, device=i.device)).flatten()
    elif kernel == "gather_lanes":  # a lane: an element, or a [.., C] piece
        elems = (torch.arange(table.shape[0], device=i.device)[:, None] * width + i).flatten()
        element *= table[0, 0].numel()
    else:  # gather_cols
        elems = (torch.arange(table.shape[0], device=i.device)[:, None] * width
                 + torch.unique(i)).flatten()
    per_sector = SECTOR_BYTES // element
    sectors = torch.unique(torch.div(elems, per_sector, rounding_mode="floor")).numel()
    return sectors * SECTOR_BYTES + sum(x.numel() * x.element_size() for x in (idx, out))


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the f32 peak and the bytes at the memory rate."""
    return max(flops / peak["f32_flops"], nbytes / peak["bytes_s"])
