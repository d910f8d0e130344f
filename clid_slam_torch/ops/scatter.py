"""Fixed-shape scatter and compaction helpers with explicit winners.

XLA leaves the winner of a set-scatter with duplicate indices undefined in
principle; on the CPU it applies the updates in index order, so the LAST
occurrence wins (pinned by tests/test_torch_neural_map.py). ``index_put_`` on
CUDA picks an arbitrary winner. ``scatter_set`` resolves the winner
explicitly as the last occurrence and then writes the winner's row through
every duplicate index, so all writes to one slot carry the same data and the
result is deterministic on any device. ``segment_add`` does the same for
additive scatters, which ``index_add_`` on CUDA sums with atomics in no
fixed order, and ``ordered_cumsum`` for a float prefix sum, which
``torch.cumsum`` on CUDA combines in an order that varies from run to run.
"""

from __future__ import annotations

import torch


def scatter_set(
    dst: torch.Tensor,
    idx: torch.Tensor,
    src: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """In place ``dst[idx] = src`` along dim 0 with JAX's ``mode="drop"``
    (out-of-range indices, and rows where ``valid`` is False, are skipped)
    and last-occurrence-wins for duplicate indices. Returns ``dst``.

    The work follows the m updates, not dst's rows: a stable sort of the
    slots, each update's winner the last of its slot's run (a binary
    search in the sorted slots), and one write a row. Skipped rows sort
    after the kept ones, each on a slot of its own, and then repeat a
    winner's write (or, with nothing kept, rewrite row 0 with itself), so
    no slot takes a pile of writes and every write to a slot carries the
    same row. Nothing is read on the host."""
    n, m = dst.shape[0], idx.shape[0]
    if m == 0:
        return dst
    dev = idx.device
    idx = idx.to(torch.int64)
    inb = (idx >= 0) & (idx < n)
    if valid is not None:
        inb = inb & valid
    pos = torch.arange(m, device=dev)
    key = torch.where(inb, idx, n + pos)
    if n + m < 2**31:
        key = key.to(torch.int32)  # a radix sort of half the bits
    skey, order = torch.sort(key, stable=True)
    last = torch.searchsorted(skey, skey, right=True) - 1
    n_in = torch.sum(inb.to(torch.int64))
    spare = torch.remainder(pos - n_in, torch.clamp(n_in, min=1))
    writer = last[torch.where(pos < n_in, pos, spare)]
    any_in = n_in > 0
    tgt = torch.where(any_in, skey[writer].to(torch.int64), torch.zeros_like(pos))
    src = src.to(dst.dtype).expand((m,) + dst.shape[1:])
    vals = torch.where(any_in, src[order[writer]], dst[:1])
    dst.index_put_((tgt,), vals)
    return dst


def compact_indices(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=0)`` without a host sync:
    the first ``size`` True positions in order, padded with 0."""
    n = mask.shape[0]
    offs = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (offs < size), offs, torch.full_like(offs, size))
    out = torch.zeros(size + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, device=mask.device))
    return out[:size]


def segment_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.index_add(0, idx, src)`` (out of place) with a fixed summation
    order on any device: contributions are sorted by target (stably), summed
    per target in index order, and each sum is added to its row once."""
    n, m = dst.shape[0], idx.shape[0]
    order = torch.argsort(idx, stable=True)
    s_idx = idx[order]
    newrun = torch.ones_like(s_idx, dtype=torch.bool)
    newrun[1:] = s_idx[1:] != s_idx[:-1]
    runid = torch.cumsum(newrun.to(torch.int64), 0) - 1
    lengths = torch.zeros(m, dtype=torch.int64, device=idx.device).index_add_(
        0, runid, torch.ones_like(runid)
    )
    sums = torch.segment_reduce(src[order], "sum", lengths=lengths, axis=0, unsafe=True)
    # every entry of a run writes the same target; unused runs go to row n
    target = torch.full((m,), n, dtype=torch.int64, device=idx.device)
    target.scatter_(0, runid, s_idx)
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    ext.index_put_((target,), ext[target] + sums.to(dst.dtype))
    return ext[:n]


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum of a non-negative float vector that repeats bit for bit
    from run to run on any device. ``torch.cumsum`` of floats on CUDA is a
    parallel scan whose partial sums meet in an order that depends on
    timing. Here the terms are summed in 2^-32 fixed point: integer addition
    is exact, hence the same in any order. (On the CPU ``torch.cumsum``
    accumulates in float64; this agrees with it to the last float32 bit but
    for rounding ties.)"""
    scale = float(1 << 32)
    fixed = torch.round(x.to(torch.float64) * scale).to(torch.int64)
    return (torch.cumsum(fixed, 0).to(torch.float64) / scale).to(x.dtype)
