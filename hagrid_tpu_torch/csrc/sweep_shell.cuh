// The sweep's shell, shared by the production kernels (sweep.cu) and the
// det-only cost probe (micro.cu): everything of the planned sweep except
// what is done with one (ray, ref) pair.
//
// A launch is three kernels on one stream (launch() below):
// 1. plan_kernel, one CTA: each tile's run of 768-ref stream blocks
//    (binary searches of the ascending tile_of) cut into chunks of at most
//    C blocks, longer chunks first. The launch is sized from shapes
//    (nt + ceil(n_blocks / C) rows); rows past the last chunk have no
//    blocks.
// 2. sweep_kernel, one CTA per row of the plan. tile/2 threads, two rays a
//    thread, their running best in registers. Per block: the early-out
//    vote (a block is skipped when every ray's best t is <= the block's
//    threshold, f32 bit patterns compared as int32, one
//    __syncthreads_or), then the block's 32 gather units stream through a
//    ring of four 8 KB pieces in shared memory: warp 0 copies each 2 KB
//    unit with one bulk copy (cp.async.bulk, the TMA's 1-D copy) that
//    completes on the piece's mbarrier, so pieces p+1..p+3 land while
//    piece p is swept, with one __syncthreads a piece before its slot is
//    refilled (none for the block's last four: the next block's vote
//    guards them). Each thread runs the body on its rays against the
//    piece's 96 refs, skipping the 8 pad lanes of every row. At the end a
//    chunk that owns its whole tile writes the rays' outputs; a chunk of a
//    split tile writes its partial (key, u, v) per ray to its scratch slot.
// 3. resolve_kernel, one thread a ray: each ray of a split tile takes the
//    least key over the tile's chunks' slots (the key: ordered t bits above, id
//    below; the minimum is associative, so the result does not depend on
//    the order the chunks ran in), and rays of tiles without blocks get
//    "no hit".
//
// The body is a policy struct with three static functions:
//   Body::bounds(RayState&)  after the ray's best changed (or was loaded);
//   Body::test(RayState&, q0, q1, q2, q3, q)  one pair; q0..q3 are the
//       ref's first 16 coefficients, q its 5 float4 in shared memory (the
//       id, coefficient 16, is q[4].x);
//   Body::flush(const RayState&, t, id, u, v)  the ray's four outputs.
// All are inlined, so an instance holds only its own body's loads and
// arithmetic: what two instances' times differ by is the body.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep_shell {

constexpr int kRowF4 = 32;          // float4 per 128-float group row
constexpr int kUnitRows = 4;        // group rows per gather unit
constexpr int kUnitF4 = kUnitRows * kRowF4;  // 128 float4 per unit
constexpr int kUnitBytes = kUnitF4 * 16;     // 2048
constexpr int kUnitsPerBlock = 32;  // units per 768-ref stream block
constexpr int kPieceUnits = 4;      // units per piece of the ring
constexpr int kPieces = kUnitsPerBlock / kPieceUnits;  // 8 per block
constexpr int kPieceRows = kPieceUnits * kUnitRows;    // 16 rows
constexpr int kPieceF4 = kPieceUnits * kUnitF4;        // 512 float4 = 8 KB
constexpr int kPieceBytes = kPieceUnits * kUnitBytes;
constexpr int kRing = 4;            // pieces in flight (32 KB)
constexpr int kRefsPerRow = 6;
constexpr int kRefF4 = 5;           // 20 coefficients per ref
constexpr int kRaysPerThread = 2;  // 4 measured slower (more registers)
constexpr int kMaxThreads = 256;    // tiles of up to 512 rays
constexpr float kBig = 3e38f;
constexpr long long kKeyNone = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kPlanThreads = 1024;
// Launch-order keys of the plan: chunk sizes, capped at kPlanBins - 1.
constexpr int kPlanBins = 64;
constexpr int kResolveThreads = 256;

struct RayState {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, tmin, tmax;
  float bt, bu, bv;
  float bid;     // the best hit's id as a float value (exact below 2^24)
  float lo, hi;  // the body's bounds on t (Body::bounds)
};

// What a launch of the shell reads and writes.
struct Params {
  const float* xt;        // f32[16, n_cols]
  int n_cols;
  const float4* cols;     // the grid's group rows, 2 KB units
  const int* gidx;        // i32[n_blocks * 32] unit per block slot
  const int4* chunks;     // the plan: (tile, first block, blocks, slot)
                          // per CTA; a CTA with no blocks exits, slot < 0
                          // = the chunk owns its whole tile
  const int* tminb;       // i32[n_blocks] early-out thresholds
  float* out_t;
  int* out_id;
  float* out_u;
  float* out_v;
  int tile;
  int* skipped;           // i32[nt] or null: blocks skipped per tile
  int4* partial;          // [plan rows, tile]: (key lo, key hi, u, v)
};

// Ordered key of a hit (t, id): the f32 bits of t mapped to int32 with
// the floats' order, above the id; no hit is kKeyNone.
__device__ __forceinline__ long long hit_key(float t, float id) {
  if (!(id >= 0.0f)) return kKeyNone;
  const int b = __float_as_int(t);
  const int o = b < 0 ? b ^ 0x7FFFFFFF : b;
  return ((long long)o << 32) | (unsigned)(int)id;
}

// The f32 bits of a key's t (the inverse of hit_key's map); kKeyNone gives
// 0x7FFFFFFF, above every threshold.
__device__ __forceinline__ int key_t_bits(long long key) {
  const int o = (int)(key >> 32);
  return o < 0 ? o ^ 0x7FFFFFFF : o;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// Warp 0 fills one piece: lane 0 arms the barrier with the piece's bytes,
// lanes 0..kPieceUnits-1 each start one unit's bulk copy; `unit` holds
// the block's 32 unit indices, one per lane.
__device__ __forceinline__ void issue_piece(const float4* cols, int unit,
                                            int piece, float4* dst,
                                            uint64_t* bar) {
  const int lane = threadIdx.x;
  const int u = __shfl_sync(0xFFFFFFFFu, unit,
                            piece * kPieceUnits + (lane % kPieceUnits));
  if (lane == 0)
    asm volatile(
        "fence.proxy.async.shared::cta;\n\t"
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem(bar)),
        "r"(kPieceBytes)
        : "memory");
  __syncwarp();
  if (lane < kPieceUnits)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst + lane * kUnitF4)),
        "l"(cols + (size_t)u * kUnitF4), "r"(kUnitBytes), "r"(smem(bar))
        : "memory");
}

// kLoadTmax: the body reads RayState::tmax (xt row 13).
template <class Body, bool kLoadTmax>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(const Params p) {
  __shared__ __align__(128) float4 ring[kRing * kPieceF4];
  __shared__ __align__(8) uint64_t full[kRing];
  const int4 ch = p.chunks[blockIdx.x];
  if (ch.z <= 0) return;  // a surplus CTA: the table has fewer chunks
  const int tile_idx = ch.x, b_begin = ch.y, b_end = ch.y + ch.z;
  const int slot = ch.w;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }  // the first vote's barrier orders the inits before any use

  const int n = p.n_cols;
  RayState ray[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int c = tile_idx * p.tile + threadIdx.x + k * blockDim.x;
    RayState& r = ray[k];
    r.ox = p.xt[1 * n + c];
    r.oy = p.xt[2 * n + c];
    r.oz = p.xt[3 * n + c];
    r.dx = p.xt[4 * n + c];
    r.dy = p.xt[5 * n + c];
    r.dz = p.xt[6 * n + c];
    r.mx = p.xt[7 * n + c];
    r.my = p.xt[8 * n + c];
    r.mz = p.xt[9 * n + c];
    r.tmin = p.xt[12 * n + c];
    r.tmax = kLoadTmax ? p.xt[13 * n + c] : 0.0f;
    // Seed: closest hit min(best, tmax), any hit the raw best; -BIG if
    // dead.
    r.bt = p.xt[14 * n + c];
    r.bid = -1.0f;
    r.bu = 0.0f;
    r.bv = 0.0f;
    Body::bounds(r);
  }
  uint32_t parity = 0;  // bit s: the phase parity slot s waits for next
  int n_skipped = 0;
  for (int b = b_begin; b < b_end; ++b) {
    const int thr = p.tminb[b];
    int busy = 0;
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k)
      busy |= __float_as_int(ray[k].bt) > thr;
    if (!__syncthreads_or(busy)) {  // every ray already done
      ++n_skipped;
      continue;
    }
    int unit = 0;
    if (threadIdx.x < 32) {
      unit = p.gidx[(size_t)b * kUnitsPerBlock + threadIdx.x];
      for (int s = 0; s < kRing; ++s)
        issue_piece(p.cols, unit, s, ring + s * kPieceF4, &full[s]);
    }
    for (int pc = 0; pc < kPieces; ++pc) {
      const int s = pc % kRing;
      mbar_wait(&full[s], (parity >> s) & 1u);
      parity ^= 1u << s;
      const float4* piece = ring + s * kPieceF4;
      for (int row = 0; row < kPieceRows; ++row) {
        const float4* rp = piece + row * kRowF4;
#pragma unroll
        for (int j = 0; j < kRefsPerRow; ++j) {
          const float4* q = rp + j * kRefF4;
          const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
#pragma unroll
          for (int k = 0; k < kRaysPerThread; ++k)
            Body::test(ray[k], q0, q1, q2, q3, q);
        }
      }
      if (pc + kRing < kPieces) {
        __syncthreads();  // slot s has been consumed by every thread
        if (threadIdx.x < 32)
          issue_piece(p.cols, unit, pc + kRing, ring + s * kPieceF4,
                      &full[s]);
      }
    }  // the next vote's barrier guards the last kRing slots' refill
  }

#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    const int c = tile_idx * p.tile + lane;
    const RayState& r = ray[k];
    if (slot < 0) {
      Body::flush(r, p.out_t[c], p.out_id[c], p.out_u[c], p.out_v[c]);
    } else {
      const long long key = hit_key(r.bt, r.bid);
      p.partial[(size_t)slot * p.tile + lane] =
          make_int4((int)(key & 0xFFFFFFFF), (int)(key >> 32),
                    __float_as_int(r.bu), __float_as_int(r.bv));
    }
  }
  if (p.skipped != nullptr && threadIdx.x == 0 && n_skipped > 0)
    atomicAdd(p.skipped + tile_idx, n_skipped);
}

// The first index of the ascending a[0..n) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The launch plan, in one CTA of kPlanThreads threads. Tile t's run is
// [first_block(t), first_block(t + 1)); it is cut into nf = run / C full
// chunks of C blocks and, if rem = run % C > 0, a last chunk of rem
// blocks. Chunks go in order of decreasing size, sizes capped at top =
// min(C, kPlanBins - 1), by tile and block within a size (a stable sort,
// as chunk_plan_plain in ops/sweep_kernel.py sorts): every full chunk
// before every shorter one. Writes table[n_rows] = (tile, first block,
// blocks, slot; rows past the last chunk (0, 0, 0, -1)), tile_first[t]
// and tile_chunks[t] = n (the tile's chunks). A tile of n > 1 chunks
// owns scratch slots tile_first[t] + 0..n-1, numbered by tile, its j-th
// chunk (in block order) the j-th; a tile of one chunk has slot -1 and
// tile_first 0; tile_first[nt] is scratch.
// Steps: the first blocks by binary search (tile_first doubles as their
// store, tile_chunks as the runs'), the chunks per size (shared atomics),
// each size's first row, then the tiles kPlanThreads at a time: a tile's
// rows at size top follow its size's next row and the rows of the earlier
// tiles of this round (a scan), its last chunk below top follows the
// earlier tiles with a last chunk of its size (a count), and its slots
// follow the earlier split tiles' (a scan).
template <int kBins>
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(
    const int* __restrict__ tile_of, int n_blocks, int nt, int chunk,
    int n_rows, int4* __restrict__ table, int* __restrict__ tile_first,
    int* __restrict__ tile_chunks) {
  constexpr int kWarps = kPlanThreads / 32;
  __shared__ int next_row[kBins];
  __shared__ int warp_rows[kWarps][kBins];
  __shared__ int warp_slots[kWarps];
  __shared__ int total, next_slot;
  const int top = min(chunk, kBins - 1);
  for (int t = threadIdx.x; t <= nt; t += blockDim.x)
    tile_first[t] = lower_bound(tile_of, n_blocks, t);
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) next_row[k] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    const int run = tile_first[t + 1] - tile_first[t];
    const int nf = run / chunk, rem = run - nf * chunk;
    tile_chunks[t] = run;
    if (nf + (rem >= top)) atomicAdd(&next_row[top], nf + (rem >= top));
    if (rem > 0 && rem < top) atomicAdd(&next_row[rem], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int row = 0;
    for (int k = top; k >= 1; --k) {
      const int n = next_row[k];
      next_row[k] = row;
      row += n;
    }
    total = row;
    next_slot = 0;
  }
  __syncthreads();
  for (int r = total + threadIdx.x; r < n_rows; r += blockDim.x)
    table[r] = make_int4(0, 0, 0, -1);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < nt; base += blockDim.x) {
    for (int i = threadIdx.x; i < kWarps * kBins; i += blockDim.x)
      (&warp_rows[0][0])[i] = 0;
    __syncthreads();
    const int t = base + threadIdx.x;
    const int run = t < nt ? tile_chunks[t] : 0;
    const int first = t < nt ? tile_first[t] : 0;
    const int nf = run / chunk, rem = run - nf * chunk;
    const int n = nf + (rem > 0);
    const int at_top = nf + (rem >= top);  // rows at size top
    const int key = rem > 0 && rem < top ? rem : 0;  // last chunk below top
    const int split = n > 1 ? n : 0;                 // slots
    const unsigned same = __match_any_sync(0xFFFFFFFFu, key);
    int rows_top = at_top, slots = split;  // inclusive scans over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xFFFFFFFFu, rows_top, o);
      const int y = __shfl_up_sync(0xFFFFFFFFu, slots, o);
      if (lane >= o) {
        rows_top += x;
        slots += y;
      }
    }
    if (lane == 31) {
      warp_rows[warp][top] = rows_top;
      warp_slots[warp] = slots;
    }
    if (key > 0 && (same & below) == 0) warp_rows[warp][key] = __popc(same);
    __syncthreads();
    int slot = next_slot + slots - split;
    int row = next_row[top] + rows_top - at_top;
    for (int w = 0; w < warp; ++w) {
      slot += warp_slots[w];
      row += warp_rows[w][top];
    }
    for (int j = 0; j < at_top; ++j)
      table[row + j] = make_int4(t, first + j * chunk, j < nf ? chunk : rem,
                                 n > 1 ? slot + j : -1);
    if (key > 0) {
      int r = next_row[key] + __popc(same & below);
      for (int w = 0; w < warp; ++w) r += warp_rows[w][key];
      table[r] = make_int4(t, first + nf * chunk, rem, n > 1 ? slot + nf : -1);
    }
    if (t < nt) {
      tile_first[t] = n > 1 ? slot : 0;
      tile_chunks[t] = n;
    }
    __syncthreads();
    for (int k = threadIdx.x; k <= top; k += blockDim.x) {
      int rows = 0;
      for (int w = 0; w < kWarps; ++w) rows += warp_rows[w][k];
      next_row[k] += rows;
    }
    if (threadIdx.x == kPlanThreads - 1) {
      int slots_all = 0;
      for (int w = 0; w < kWarps; ++w) slots_all += warp_slots[w];
      next_slot += slots_all;
    }
    __syncthreads();
  }
}

// One thread a ray of the n_cols: rays of a split tile (tile_chunks[t] >
// 1) take the least key over the tile's chunks, whose partials sit in
// slots tile_first[t] + 0..n-1, and that chunk's u, v; rays of tiles
// without chunks (and of the dummy tile) get "no hit"; a tile of one
// chunk was written by its CTA.
template <int kThreads>
__global__ void __launch_bounds__(kThreads) resolve_kernel(
    const int4* __restrict__ partial, const int* __restrict__ tile_first,
    const int* __restrict__ tile_chunks, int nt, int tile, int n_cols,
    float* __restrict__ out_t, int* __restrict__ out_id,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cols) return;
  const int t = c / tile;
  const int n_chunks = t < nt ? tile_chunks[t] : 0;
  if (n_chunks == 1) return;
  long long best = kKeyNone;
  int bu = 0, bv = 0;
  const int4* s = partial + (size_t)tile_first[min(t, nt - 1)] * tile
                  + (c - t * tile);
  for (int k = 0; k < n_chunks; ++k) {
    const int4 e = s[(size_t)k * tile];
    const long long key = ((long long)e.y << 32) | (unsigned)e.x;
    if (key < best) {
      best = key;
      bu = e.z;
      bv = e.w;
    }
  }
  const bool found = best != kKeyNone;
  out_t[c] = found ? __int_as_float(key_t_bits(best)) : kBig;
  out_id[c] = found ? (int)(best & 0xFFFFFFFF) : -1;
  out_u[c] = found ? __int_as_float(bu) : 0.0f;
  out_v[c] = found ? __int_as_float(bv) : 0.0f;
}

// Tiles the shell takes: 64..512 rays in steps of 64.
inline bool launch_ok(int tile) {
  return tile % 64 == 0 && tile >= 64 &&
         tile <= kMaxThreads * kRaysPerThread;
}

// What a launch needs beside Params: the ascending tile_of[n_blocks], the
// tile count, C, the plan's row count (nt + ceil(n_blocks / C), from
// shapes) and its scratch: i32[4 * n_rows + 2 * nt + 1] for the table,
// tile_first[nt + 1] and tile_chunks[nt].
struct Plan {
  const int* tile_of;
  int n_blocks, nt, chunk, n_rows;
  int* scratch;
};

inline bool plan_ok(const Plan& q) {
  return q.nt > 0 && q.n_blocks > 0 && q.chunk > 0 &&
         q.n_rows == q.nt + (q.n_blocks + q.chunk - 1) / q.chunk;
}

inline cudaError_t launch_plan(const Plan& q, cudaStream_t s) {
  int4* table = reinterpret_cast<int4*>(q.scratch);
  int* tile_first = q.scratch + 4 * (size_t)q.n_rows;
  plan_kernel<kPlanBins><<<1, kPlanThreads, 0, s>>>(
      q.tile_of, q.n_blocks, q.nt, q.chunk, q.n_rows, table, tile_first,
      tile_first + q.nt + 1);
  return cudaGetLastError();
}

// The plan, the sweep over its rows and the resolve pass, on stream s;
// does not synchronise; returns the first non-zero cudaGetLastError() of
// the three launches. p.chunks is set here; p.partial may be null when
// no chunk is ever split (C >= n_blocks).
template <class Body, bool kLoadTmax>
cudaError_t launch(Params p, const Plan& q, cudaStream_t s) {
  if (!plan_ok(q) || !launch_ok(p.tile) ||
      (p.partial == nullptr && q.chunk < q.n_blocks))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_plan(q, s);
  if (err != cudaSuccess) return err;
  p.chunks = reinterpret_cast<const int4*>(q.scratch);
  sweep_kernel<Body, kLoadTmax>
      <<<q.n_rows, p.tile / kRaysPerThread, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int* tile_first = q.scratch + 4 * (size_t)q.n_rows;
  resolve_kernel<kResolveThreads>
      <<<(p.n_cols + kResolveThreads - 1) / kResolveThreads,
         kResolveThreads, 0, s>>>(
      p.partial, tile_first, tile_first + q.nt + 1, q.nt, p.tile, p.n_cols,
      p.out_t, p.out_id, p.out_u, p.out_v);
  return cudaGetLastError();
}

template <class Body, bool kLoadTmax>
cudaError_t occupancy(int tile, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, sweep_kernel<Body, kLoadTmax>, tile / kRaysPerThread, 0);
}

}  // namespace sweep_shell
