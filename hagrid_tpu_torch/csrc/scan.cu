// Running max / min along a 1-D int32 or int64 array for Hopper (sm_90a):
// y[i] = max (min) of x[0..i].
//
// Replaces no Pallas kernel: it is the counterpart of the reference's XLA
// scan `lax.associative_scan(jnp.minimum, x)` in the sweep planner's
// segmented suffix min (hagrid_tpu/ops/sweep_trace.py), which the port ran
// as torch.cummin. (The reference's two running maxes, the packet build's
// run starts and the planner's tile-first offsets, scan non-decreasing
// values, and the port reads them with a gather instead.) For a 1-D tensor
// torch.cummax / cummin run the whole array on one thread block (PyTorch's
// scan_innermost_dim_with_indices: one block a row) and write an index
// array besides, so a scan of 10^6 elements takes about a millisecond on
// one of the card's 132 SMs.
//
// Design: a single-pass scan with decoupled look-back (Merrill and
// Garland, 2016). A block takes the next tile of 32 KiB of consecutive
// values (8192 int32 or 4096 int64; at the port's lengths int32 tiles of
// 2048 and 4096 and int64 tiles of 8192 ran slower) from an atomic
// counter, so every tile it waits on belongs to a block that is already
// running. Each warp loads its eighth of the tile as 16-byte vectors, 32
// lanes on consecutive vectors (coalesced), scans each vector in
// registers and the lanes with shuffles, carrying from one group of 32
// vectors to the next; the block combines its warps' totals through
// shared memory. The block then publishes its tile's aggregate, and warp
// 0 looks back over its predecessors 32 tiles at a time: an inclusive
// prefix ends the walk, an aggregate is folded in and the walk goes on.
// Last it publishes its own inclusive prefix. Each status is a value,
// then a flag written with release semantics and read with acquire
// semantics, the flag in an int32 array of its own (an int64 value could
// not share its word). The values are written once; no index array. The
// caller's workspace holds the tile counter and the flags, zeroed on the
// stream by a memset (a memset node when captured in a graph, so each
// replay starts afresh), and the tiles' aggregates and prefixes. An array
// of one tile or less runs one block with no workspace and no look-back.
//
// Bound: the bytes of x read once and of y written once (3.35 TB/s); for
// the arrays the port scans (10^5 to 10^6 elements) the launch and the
// look-back's latency decide instead.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 32768;           // a tile's values
constexpr unsigned kAll = 0xffffffffu;
constexpr int kAggregate = 1, kInclusive = 2;   // a tile's flag; 0: none

template <typename T> struct Limits;
template <> struct Limits<int> {
  static constexpr int lo = INT_MIN, hi = INT_MAX;
};
template <> struct Limits<long long> {
  static constexpr long long lo = LLONG_MIN, hi = LLONG_MAX;
};

template <typename T, bool Max> struct Op {
  static constexpr T identity = Max ? Limits<T>::lo : Limits<T>::hi;
  __device__ static T apply(T a, T b) {
    return Max ? (a > b ? a : b) : (a < b ? a : b);
  }
};

// 16-byte vectors of each type, unpacked into and packed from registers.
__device__ __forceinline__ void unpack(int (&v)[4], const void* p) {
  const int4 q = *static_cast<const int4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void unpack(long long (&v)[2], const void* p) {
  const longlong2 q = *static_cast<const longlong2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void pack(void* p, const int (&v)[4]) {
  *static_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(void* p, const long long (&v)[2]) {
  *static_cast<longlong2*>(p) = make_longlong2(v[0], v[1]);
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The tiles' status: flags[t], then the value its flag names.
template <typename T> struct Status {
  int* counter;
  int* flags;
  T* aggregate;
  T* inclusive;
};

// Warp 0 of tile `tile` (> 0): the op over every tile before it.
template <typename T, bool Max>
__device__ T look_back(const Status<T>& st, int tile, int lane) {
  using O = Op<T, Max>;
  T acc = O::identity;
  for (int top = tile - 1;; top -= 32) {
    const int t = top - lane;   // lane 0 nearest; t < 0 past tile 0
    int f = kInclusive;
    if (t >= 0) {
      do f = load_acquire(st.flags + t); while (f == 0);
    }
    T v = O::identity;
    if (t >= 0)
      v = f == kInclusive ? *(volatile const T*)(st.inclusive + t)
                          : *(volatile const T*)(st.aggregate + t);
    // Fold lanes up to the nearest inclusive prefix; past it, nothing.
    const unsigned inc = __ballot_sync(kAll, f == kInclusive);
    if (inc && lane > __ffs(inc) - 1) v = O::identity;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = O::apply(v, __shfl_xor_sync(kAll, v, off));
    acc = O::apply(acc, v);
    if (inc) return acc;
  }
}

// One block a tile. `st.counter` null: a single tile, no look-back. vec:
// x and y are 16-byte aligned, so full warp spans move as 16-byte vectors.
template <typename T, bool Max>
__global__ void __launch_bounds__(kThreads)
running_scan_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                    Status<T> st, bool vec) {
  using O = Op<T, Max>;
  constexpr int V = 16 / sizeof(T);            // elements a vector
  constexpr int kTile = kTileBytes / sizeof(T);
  constexpr int kWarpTile = kTile / kWarps;
  constexpr int kGroups = kWarpTile / (32 * V);   // 8
  __shared__ T warp_total[kWarps];
  __shared__ T tile_prefix;
  __shared__ int tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int tile = 0;
  if (st.counter) {
    if (threadIdx.x == 0) tile_s = atomicAdd(st.counter, 1);
    __syncthreads();
    tile = tile_s;
  }
  const int64_t base = static_cast<int64_t>(tile) * kTile + warp * kWarpTile;
  const bool full = vec && base + kWarpTile <= n;

  T v[kGroups][V];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t i = base + (g * 32 + lane) * V;
    if (full) {
      unpack(v[g], x + i);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[g][e] = i + e < n ? x[i + e] : O::identity;
    }
  }

  // Scan the warp's span: each vector, then across lanes, group by group.
  T carry = O::identity;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int e = 1; e < V; ++e) v[g][e] = O::apply(v[g][e - 1], v[g][e]);
    T s = v[g][V - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_up_sync(kAll, s, off);
      if (lane >= off) s = O::apply(o, s);
    }
    T before = __shfl_up_sync(kAll, s, 1);
    before = O::apply(carry, lane == 0 ? O::identity : before);
#pragma unroll
    for (int e = 0; e < V; ++e) v[g][e] = O::apply(before, v[g][e]);
    carry = O::apply(carry, __shfl_sync(kAll, s, 31));
  }
  if (lane == 0) warp_total[warp] = carry;
  __syncthreads();
  T prefix = O::identity, total = O::identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T t = warp_total[w];
    if (w < warp) prefix = O::apply(prefix, t);
    total = O::apply(total, t);
  }

  if (st.counter) {
    if (tile == 0) {
      if (threadIdx.x == 0) {
        *(volatile T*)(st.inclusive) = total;
        store_release(st.flags, kInclusive);
      }
    } else {
      if (warp == 0) {
        if (lane == 0) {
          *(volatile T*)(st.aggregate + tile) = total;
          store_release(st.flags + tile, kAggregate);
        }
        const T before = look_back<T, Max>(st, tile, lane);
        if (lane == 0) {
          *(volatile T*)(st.inclusive + tile) = O::apply(before, total);
          store_release(st.flags + tile, kInclusive);
          tile_prefix = before;
        }
      }
      __syncthreads();
      prefix = O::apply(tile_prefix, prefix);
    }
  }

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[g][e] = O::apply(prefix, v[g][e]);
    const int64_t i = base + (g * 32 + lane) * V;
    if (full) {
      pack(y + i, v[g]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (i + e < n) y[i + e] = v[g][e];
    }
  }
}

int64_t tiles_of(int64_t n, int val_bytes) {
  const int64_t tile = kTileBytes / val_bytes;
  return (n + tile - 1) / tile;
}

// Workspace layout: the counter (16 bytes), the flags, then 16-byte
// aligned the aggregates and the inclusive prefixes.
int64_t flags_end(int64_t tiles) { return (16 + 4 * tiles + 15) / 16 * 16; }

template <typename T, bool Max>
cudaError_t launch(const void* x, void* y, int64_t n, void* work,
                   cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int64_t tiles = tiles_of(n, sizeof(T));
  Status<T> st{nullptr, nullptr, nullptr, nullptr};
  if (tiles > 1) {
    char* w = static_cast<char*>(work);
    const int64_t end = flags_end(tiles);
    st = {reinterpret_cast<int*>(w), reinterpret_cast<int*>(w + 16),
          reinterpret_cast<T*>(w + end),
          reinterpret_cast<T*>(w + end + tiles * sizeof(T))};
    const cudaError_t e = cudaMemsetAsync(work, 0, end, s);
    if (e != cudaSuccess) return e;
  }
  running_scan_kernel<T, Max><<<static_cast<unsigned>(tiles), kThreads, 0,
                                s>>>(static_cast<const T*>(x),
                                     static_cast<T*>(y), n, st, vec);
  return cudaGetLastError();
}

}  // namespace

// Bytes of workspace hagrid_running_scan needs for n values of val_bytes
// (4 or 8) each: 0 for one tile or less; -1 for bad arguments.
extern "C" long long hagrid_running_scan_workspace(long long n,
                                                   int val_bytes) {
  if ((val_bytes != 4 && val_bytes != 8) || n < 0) return -1;
  const int64_t tiles = tiles_of(n, val_bytes);
  return tiles > 1 ? flags_end(tiles) + 2 * tiles * val_bytes : 0;
}

// C entry point (loaded with ctypes): y[i] = max (is_max) or min of
// x[0..i] for i < n, x and y contiguous int32 (val_bytes 4) or int64 (8)
// arrays that do not overlap. work: work_bytes of device memory, at least
// hagrid_running_scan_workspace(n, val_bytes) (null when that is 0),
// 16-byte aligned. Zeroes the workspace's counter and flags and launches
// on `stream`, does not synchronise, and returns the first CUDA error of
// the two; launches nothing for n == 0.
extern "C" int hagrid_running_scan(const void* x, void* y, long long n,
                                   int val_bytes, int is_max, void* work,
                                   long long work_bytes, void* stream) {
  const long long need = hagrid_running_scan_workspace(n, val_bytes);
  if (need < 0 || work_bytes < need || tiles_of(n, val_bytes) > INT_MAX ||
      (need > 0 && (work == nullptr ||
                    reinterpret_cast<uintptr_t>(work) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (val_bytes == 4)
    return (int)(is_max ? launch<int, true>(x, y, n, work, s)
                        : launch<int, false>(x, y, n, work, s));
  return (int)(is_max ? launch<long long, true>(x, y, n, work, s)
                      : launch<long long, false>(x, y, n, work, s));
}
