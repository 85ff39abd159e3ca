"""Device-wide primitives (port of hagrid_tpu/ops/segment.py).

Also home of the two helpers that give torch the reference's
out-of-range semantics, which torch does not share:
- `add_at_drop` is `jnp.zeros(n).at[idx].add(vals, mode="drop")`: torch
  raises (CPU) or device-asserts (CUDA) on an index past the end, so the
  plain version `add_at_drop_plain` scatters into a buffer one slot
  longer and cuts the overflow slot off. Integer addends on the card go
  to csrc/scatter.cu's kernel instead, which drops those rows and
  issues no atomic for them (`launches` counts its launches).
- `running_max` / `running_min` are `torch.cummax(x, 0).values` /
  `torch.cummin(x, 0).values`, the reference's associative_scan of
  max / min. On the card they are csrc/scan.cu's device-wide scan of a
  1-D int32 / int64 tensor (anything else raises): torch runs a 1-D
  scan on one thread block and writes an index array nobody reads.
- `trunc_i32` is XLA's saturating f32 -> i32 cast: torch wraps
  out-of-range values to INT_MIN, which turns a saturated upper bound
  into column 0. Values are clamped in float first (NaN -> 0).
- `take` is a jnp gather `table[idx]`: a negative index counts from the
  end once, and what is still out of range is clamped. torch raises
  (CPU) or device-asserts (CUDA) instead.
"""

from __future__ import annotations

import operator

import torch

from ..utils.profiling import count_launch
from . import _build

_I32_SAFE = float(1 << 30)
_INTS = (torch.int32, torch.int64)

# Kernel launches, counted where the kernel is launched (a captured
# graph's at each replay: utils/profiling.count_launch).
launches = {"scatter_add_drop": 0, "running_scan": 0}


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along axis 0, same length and dtype as x."""
    return torch.cumsum(x, dim=0, dtype=x.dtype) - x


def add_at_drop(n: int, idx: torch.Tensor, vals) -> torch.Tensor:
    """zeros[n] with `vals` added at `idx`; indices >= n are dropped
    (idx must be non-negative). The result has the dtype of a tensor
    `vals`, i32 for a Python number. Integer addends (i32, i64 or a
    Python int) on the card take the scatter kernel, anything else
    (CPU tensors, float addends) the plain version: integer sums do not
    depend on their order, so both give the same bits."""
    if idx.device.type != "cpu" and (
            not torch.is_tensor(vals) or vals.dtype in _INTS):
        return add_at_drop_kernel(n, idx, vals)
    return add_at_drop_plain(n, idx, vals)


def add_at_drop_kernel(n: int, idx: torch.Tensor, vals) -> torch.Tensor:
    """`add_at_drop` by csrc/scatter.cu's kernel: idx i32 or i64 and vals
    i32, i64 or a Python int, read where they lie (an expanded vals is
    read with stride 0); no atomic for a dropped row or a zero addend,
    one for each run of equal indices in a warp's rows."""
    if idx.dim() != 1:
        raise ValueError(f"add_at_drop: idx must be 1-D, got {idx.dim()}-D")
    if not 0 <= n < (1 << 31) - 1:
        raise ValueError(f"add_at_drop: n = {n} outside [0, 2^31 - 1)")
    if idx.dtype not in _INTS:
        idx = idx.long()
    if torch.is_tensor(vals):
        if vals.dtype not in _INTS or vals.device != idx.device:
            raise TypeError(f"add_at_drop: the kernel takes i32 or i64 "
                            f"addends on {idx.device}, got {vals.dtype} "
                            f"on {vals.device}")
        vals = vals.expand(idx.shape)
        dtype, vptr, vstride, fill = (vals.dtype, vals.data_ptr(),
                                      vals.stride(0), 0)
    else:
        dtype, vptr, vstride, fill = torch.int32, None, 0, operator.index(
            vals)
        if not -(1 << 31) <= fill < (1 << 31):
            raise OverflowError(f"add_at_drop: fill {fill} does not fit "
                                f"int32")
    out = torch.zeros((n,), dtype=dtype, device=idx.device)
    if n == 0 or idx.numel() == 0:
        return out
    lib = _build.load()
    err = lib.hagrid_scatter_add_drop(
        idx.data_ptr(), idx.element_size(), idx.stride(0), vptr,
        out.element_size(), vstride, fill, idx.numel(), n, out.data_ptr(),
        torch.cuda.get_device_properties(idx.device).multi_processor_count,
        torch.cuda.current_stream(idx.device).cuda_stream)
    _build.raise_on(lib, err, "scatter_add_drop")
    count_launch(launches, "scatter_add_drop")
    return out


def add_at_drop_plain(n: int, idx: torch.Tensor, vals) -> torch.Tensor:
    """Plain version of `add_at_drop`: index_add_ into n + 1 slots, every
    dropped index clamped onto the last, which is cut off."""
    if not torch.is_tensor(vals):   # a fill, not a copy from the host
        vals = torch.full(idx.shape, vals, dtype=torch.int32,
                          device=idx.device)
    out = torch.zeros((n + 1,), dtype=vals.dtype, device=idx.device)
    out.index_add_(0, idx.clamp(max=n).long(), vals.expand(idx.shape))
    return out[:n]


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Running max along axis 0: y[i] = max(x[:i + 1]). A CPU tensor
    takes the plain version, any other the scan kernel, which takes 1-D
    int32 / int64 and raises on the rest; both are exact."""
    if x.device.type == "cpu":
        return running_max_plain(x)
    return running_max_kernel(x)


def running_min(x: torch.Tensor) -> torch.Tensor:
    """Running min along axis 0: y[i] = min(x[:i + 1]); dispatched as
    `running_max`."""
    if x.device.type == "cpu":
        return running_min_plain(x)
    return running_min_kernel(x)


def running_max_kernel(x: torch.Tensor) -> torch.Tensor:
    """`running_max` by csrc/scan.cu's kernel (1-D int32 / int64)."""
    return _running_scan(x, True)


def running_min_kernel(x: torch.Tensor) -> torch.Tensor:
    """`running_min` by csrc/scan.cu's kernel (1-D int32 / int64)."""
    return _running_scan(x, False)


def _running_scan(x: torch.Tensor, is_max: bool) -> torch.Tensor:
    """One launch of the scan kernel on the current stream: the output
    and the workspace (tile counter, flags and the tiles' values, which
    the entry point zeroes on the stream) come from torch's allocator."""
    if x.dim() != 1:
        raise ValueError(f"running scan: x must be 1-D, got {x.dim()}-D")
    if x.dtype not in _INTS:
        raise TypeError(f"running scan: the kernel takes int32 or int64, "
                        f"got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.load()
    nbytes = lib.hagrid_running_scan_workspace(x.numel(), x.element_size())
    work = (torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
            if nbytes > 0 else None)
    err = lib.hagrid_running_scan(
        x.data_ptr(), y.data_ptr(), x.numel(), x.element_size(), int(is_max),
        None if work is None else work.data_ptr(), nbytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(lib, err, "running_scan")
    count_launch(launches, "running_scan")
    return y


def running_max_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `running_max`: torch.cummax's values."""
    return torch.cummax(x, 0).values


def running_min_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `running_min`: torch.cummin's values."""
    return torch.cummin(x, 0).values


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
