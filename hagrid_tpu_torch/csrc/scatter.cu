// Integer scatter-add with drop mode for Hopper (sm_90a):
// out[k] += vals[i] for every i with 0 <= idx[i] < n; out (n entries) is
// zeroed by the caller.
//
// Replaces no Pallas kernel: it is the counterpart of the reference's XLA
// scatter `jnp.zeros(n).at[idx].add(vals, mode="drop")` (hagrid_tpu/ops/
// segment.py), which the port ran as `index_add_` into a buffer one slot
// longer, every index past the end clamped onto that slot. The grid
// builds' scatters send most of their rows there (rows sorted past the
// last cell, dropped run starts), and most of those add 0; their atomics
// all queue on one L2 address, one a clock. Their valid rows come in long
// runs of equal indices (sorted keys, the stacked markers of empty runs).
//
// Design: a warp walks a contiguous span of rows, 32 at a time in index
// order. A row whose index is out of range, or whose addend is 0, issues
// no atomic. A segmented inclusive sum over the lanes (head flags where
// the index changes, five shuffle steps) sums each run of equal indices;
// the run's last lane issues one atomicAdd (32-bit for int32 addends,
// 64-bit for int64), and a run that reaches lane 31 is carried into the
// warp's next 32 rows, so a sorted run costs one atomic a warp span.
// The sums and the atomics are done in the unsigned type of the addends'
// width, where addition wraps modulo 2^32 (2^64) by the language's rules
// and is associative, so the result is bit-equal to index_add_'s, whose
// atomics wrap the same, in any order and past the signed range too.
//
// Bound: the bytes of the indices and addends, read once (3.35 TB/s); the
// atomics left are one per run a warp span.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;    // warps a block
constexpr int kUnroll = 4;   // groups of 32 rows loaded before summing
constexpr int kRows = 32 * kUnroll;
constexpr unsigned kAll = 0xffffffffu;

// Rows [warp * span, min(warp * span + span, m)) of warp `warp`; span is
// a multiple of kRows. Index n stands for every dropped row. V is the
// unsigned type of the addends' width (their bits, read and added as is).
template <typename I, typename V>
__global__ void __launch_bounds__(kWarps * 32)
scatter_add_drop_kernel(const I* __restrict__ idx, int64_t istride,
                        const V* __restrict__ vals, int64_t vstride, V fill,
                        int64_t m, int n, int64_t span, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t begin =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * span;
  const int64_t end = begin + span < m ? begin + span : m;
  const unsigned upto = kAll >> (31 - lane);   // lanes 0..lane
  int ckey = n;   // the run carried from the rows before: index and sum
  V csum = 0;
  for (int64_t base = begin; base < end; base += kRows) {
    int key[kUnroll];
    V val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * 32 + lane;
      key[u] = n;
      val[u] = 0;
      if (i < end) {
        const I x = idx[i * istride];
        key[u] = x >= 0 && x < static_cast<I>(n) ? static_cast<int>(x) : n;
        val[u] = vals ? vals[i * vstride] : fill;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = key[u];
      V v = val[u];
      const int before = __shfl_up_sync(kAll, k, 1);
      const unsigned heads = __ballot_sync(kAll, lane == 0 || k != before);
      const int first = 31 - __clz(heads & upto);   // this run's first lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const V o = __shfl_up_sync(kAll, v, off);
        if (lane - off >= first) v += o;
      }
      if (first == 0 && k == ckey) v += csum;   // the carried run goes on
      if (lane == 0 && k != ckey && ckey < n && csum != 0)
        atomicAdd(out + ckey, csum);            // the carried run ended
      const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
      if (last && lane != 31 && k < n && v != 0) atomicAdd(out + k, v);
      ckey = __shfl_sync(kAll, k, 31);
      csum = __shfl_sync(kAll, v, 31);
    }
  }
  if (lane == 0 && ckey < n && csum != 0) atomicAdd(out + ckey, csum);
}

template <typename I, typename V>
cudaError_t launch(const void* idx, int64_t istride, const void* vals,
                   int64_t vstride, long long fill, int64_t m, int n,
                   void* out, int sms, cudaStream_t s) {
  // 32 warps an SM (four blocks, resident at once), enough loads in
  // flight to keep the bytes moving; fewer rows than that fill fewer
  // warps, one group of rows each.
  const int64_t warps = static_cast<int64_t>(sms) * 32;
  int64_t span = (m + warps - 1) / warps;
  span = (span + kRows - 1) / kRows * kRows;
  const int64_t blocks = ((m + span - 1) / span + kWarps - 1) / kWarps;
  scatter_add_drop_kernel<I, V><<<static_cast<unsigned>(blocks),
                                  kWarps * 32, 0, s>>>(
      static_cast<const I*>(idx), istride, static_cast<const V*>(vals),
      vstride, static_cast<V>(fill), m, n, span, static_cast<V*>(out));
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes): out[k] += vals[i * vstride] (or
// `fill` where vals is null) for each i < m with 0 <= idx[i * istride] < n.
// idx_bytes and val_bytes (4 or 8) pick int32 / int64 indices and
// addends; out holds n zeroed addends of val_bytes each. sms: the card's
// SM count, which sizes the grid. Launches on `stream`, does not
// synchronise and returns cudaGetLastError() of the launch; launches
// nothing for m == 0 or n == 0.
extern "C" int hagrid_scatter_add_drop(const void* idx, int idx_bytes,
                                       long long istride, const void* vals,
                                       int val_bytes, long long vstride,
                                       long long fill, long long m, int n,
                                       void* out, int sms, void* stream) {
  if ((idx_bytes != 4 && idx_bytes != 8) ||
      (val_bytes != 4 && val_bytes != 8) || m < 0 || n < 0 ||
      n == 0x7fffffff || istride < 0 || vstride < 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 4)
    return (int)(val_bytes == 4
        ? launch<int, unsigned>(idx, istride, vals, vstride, fill, m, n,
                                out, sms, s)
        : launch<int, unsigned long long>(idx, istride, vals, vstride, fill,
                                          m, n, out, sms, s));
  return (int)(val_bytes == 4
      ? launch<long long, unsigned>(idx, istride, vals, vstride, fill, m, n,
                                    out, sms, s)
      : launch<long long, unsigned long long>(idx, istride, vals, vstride,
                                              fill, m, n, out, sms, s));
}
