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


def cumsum_i32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=torch.int32)


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
