"""Device-wide primitives (port of hagrid_tpu/ops/segment.py).

Also home of the two helpers that give torch the reference's
out-of-range semantics, which torch does not share:
- `add_at_drop` is `jnp.zeros(n).at[idx].add(vals, mode="drop")`: torch
  raises (CPU) or device-asserts (CUDA) on an index past the end, so the
  scatter goes into a buffer one slot longer and the overflow slot is
  cut off.
- `trunc_i32` is XLA's saturating f32 -> i32 cast: torch wraps
  out-of-range values to INT_MIN, which turns a saturated upper bound
  into column 0. Values are clamped in float first (NaN -> 0).
- `take` is a jnp gather `table[idx]`: a negative index counts from the
  end once, and what is still out of range is clamped. torch raises
  (CPU) or device-asserts (CUDA) instead.
"""

from __future__ import annotations

import torch

_I32_SAFE = float(1 << 30)


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along axis 0, same length and dtype as x."""
    return torch.cumsum(x, dim=0, dtype=x.dtype) - x


def add_at_drop(n: int, idx: torch.Tensor, vals) -> torch.Tensor:
    """zeros[n] with `vals` added at `idx`; indices >= n are dropped
    (idx must be non-negative). The result has the dtype of a tensor
    `vals`, i32 for a Python number."""
    if not torch.is_tensor(vals):
        vals = torch.tensor(vals, dtype=torch.int32, device=idx.device)
    out = torch.zeros((n + 1,), dtype=vals.dtype, device=idx.device)
    out.index_add_(0, idx.clamp(max=n).long(), vals.expand(idx.shape))
    return out[:n]


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 truncation that saturates like XLA's cast. Exact for
    |x| < 2^30; beyond that the result is +-2^30 (callers clip to grid
    dims far below), NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-_I32_SAFE, _I32_SAFE)
    return x.to(torch.int32)


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0 with jnp's out-of-range semantics."""
    n = table.shape[0]
    idx = idx.long()
    return table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def cumsum_i32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=torch.int32)


def expand_by_counts(counts: torch.Tensor, capacity: int):
    """Run-length expansion of per-source counts i32[N] into `capacity`
    slots: (src, rank, valid, total) with src[j] the run slot j falls in,
    rank[j] its offset within the run, valid[j] = j < total. A +1 marker
    at every run start, prefix-summed, gives src (empty runs stack their
    markers on one slot and the sum jumps past them); the run offsets
    forward-fill by a delta scatter and a prefix sum. Slots past the total
    get a clamped src and valid False; run starts at or past `capacity`
    are dropped."""
    dev = counts.device
    j = torch.arange(capacity, dtype=torch.int32, device=dev)
    if counts.shape[0] == 0:  # empty source (empty scenes)
        return (torch.zeros((capacity,), dtype=torch.int32, device=dev), j,
                torch.zeros((capacity,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    counts = counts.to(torch.int32)
    offsets = exclusive_scan(counts)
    total = offsets[-1] + counts[-1]
    src = (cumsum_i32(add_at_drop(capacity, offsets, 1)) - 1).clamp(
        0, counts.shape[0] - 1)
    d_off = torch.diff(offsets, prepend=offsets.new_zeros(1))
    rank = j - cumsum_i32(add_at_drop(capacity, offsets, d_off))
    return src, rank, j < total, total


def sort_pairs(keys: torch.Tensor, *values: torch.Tensor):
    """STABLE ascending sort of keys, carrying values by the returned
    permutation. Returns (keys, *values). Stability decides the row order
    of equal keys (the packet build's per-cell ref order)."""
    skeys, perm = torch.sort(keys, stable=True)
    return (skeys,) + tuple(v[perm] for v in values)


def segment_starts(sorted_keys: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Ascending keys i32[R] (invalid = key >= num_segments, sorted to the
    back) -> starts i32[num_segments + 1]: segment k occupies sorted rows
    [starts[k], starts[k+1])."""
    k = sorted_keys.to(torch.int32).clamp(0, num_segments)
    counts = add_at_drop(num_segments + 1, k + 1,
                         (sorted_keys < num_segments).to(torch.int32))
    return cumsum_i32(counts)


def rows_to_segments(starts: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Inverse of segment_starts: owner segment id per row j in
    [0, num_rows). starts i32[S+1]. Rows beyond starts[S] get S-1."""
    s = starts.shape[0] - 1
    markers = add_at_drop(num_rows, starts[:s], 1)
    return (cumsum_i32(markers) - 1).clamp(0, s - 1)


def compact_indices(mask: torch.Tensor):
    """Stable compaction: indices of True entries packed to the front.

    Returns (idx i32[N], count). Rows past count hold the False indices (in
    order), so gathers with idx are always in-bounds."""
    idx = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    _, packed = sort_pairs((~mask).to(torch.int32), idx)
    return packed, mask.sum(dtype=torch.int32)


def segmented_unique(sorted_seg: torch.Tensor, sorted_val: torch.Tensor,
                     invalid_val):
    """Deduplicate (segment, value) pairs that are sorted by (segment,
    value): a row equal to the previous one in both gets `invalid_val`.
    Returns (values, keep_mask)."""
    keep = torch.ones_like(sorted_seg, dtype=torch.bool)
    keep[1:] = ((sorted_seg[1:] != sorted_seg[:-1])
                | (sorted_val[1:] != sorted_val[:-1]))
    return torch.where(keep, sorted_val, invalid_val), keep
