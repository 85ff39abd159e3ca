// Sweep-cost micro-kernels for Hopper (sm_90a): what the planned sweep
// (csrc/sweep.cu) spends on its shell, and what its four linear forms cost
// on the FP32 pipes and on the tensor cores. They measure; the renderer
// never calls them.
//
// K4, det_sweep_kernel: replaces exp/r3_kernel_mt20.py::make_det_kernel.
//   The production shell (csrc/sweep_shell.cuh: the plan, one CTA per
//   chunk of a tile's run of stream blocks, here always the whole run,
//   early-out vote, bulk copies into a four-piece ring, two rays a
//   thread, final flush, the resolve pass) with the body cut to
//   det = d.n per ref and a running min.
//   Output per ray: t = min(seed, min det), id = -1, u = v = 0. Bound on
//   this card: FP32 operations (6 per pair: 3 multiplies, 2 adds, 1 min)
//   against 64 KB staged per stream block; the staging and the barrier
//   per piece are what it is there to expose.
//   `full - det3` is the production body, `det3 - skipped` the staging.
//
// K5, dots_fp32_kernel<false / true>: replaces
//   exp/r4_mxu_micro.py::vpu_kernel. Per stream block of 128 rows x 6
//   refs and 512 rays: det = d.n, tt = f - o.n, uu = m.b + d.c,
//   vv = m.d' + d.e in FP32, added into the row's accumulator as
//   acc + det + tt + uu + vv, ref after ref. Bound: FP32 operations (37
//   per pair); since the library is built with -fmad=false like the
//   production kernel, whose share it measures, the plain instance issues
//   one instruction an operation and its ceiling is that issue rate. The
//   FMA instance writes each form as its own chain of __fmaf_rn (tt's
//   chain starts from f, the origin negated once per ray): 22
//   instructions a pair, each form still a value of its own.
//   Design (Hopper): a persistent grid, one CTA per SM walking the stream
//   blocks with a stride of the grid. Each of 256 consumer threads keeps 8
//   rays' 9 features in registers, so that one broadcast of a ref's 16
//   coefficients (four 16-byte shared loads) serves 8 pairs; the 64
//   threads that cover the 512 rays form a row group, and the four groups
//   take rows 4j, 4j + 1, 4j + 2, 4j + 3 of the block. A producer warp
//   streams the blocks through a ring of 16 mbarrier-guarded 8 KB stages
//   (16 rows each, two blocks in flight) with 1-D bulk copies, so that no
//   copy waits on a barrier of all threads. A block's column sums: each
//   group adds its 32 rows in order, then the four groups' sums are added
//   in group order through shared memory. The owner of the last block
//   writes out.
//
// K6 / K7, dots_bf16_kernel<false / true>: replace
//   exp/r4_mxu_micro.py::mxu1_kernel and ::mxu3_kernel. Per stream block,
//   C_blk (3072 x 16) . phi (16 x 512) with both operands cast to bf16
//   inside the kernel and f32 accumulation, the 24 groups of 128 rows
//   summed: out = sum_q C_q . phi. K7 splits both operands into
//   hi = bf16(x) and lo = bf16(x - f32(hi)) and sums hi.hi + hi.lo + lo.hi.
//   Bound: K6 by the bytes of C (403 MB at 2048 blocks against 103 GFLOP
//   at the bf16 tensor-core rate), K7 by its 3 x operations.
//   Design (Hopper): a persistent grid of CTA pairs, one CTA per SM,
//   each pair walking the stream blocks with a stride of the number of
//   pairs. CTA r of a pair owns rays 256r..256r+255: its (128 x 256) f32
//   sums are one wgmma m64n256k16 accumulator (128 registers a thread) in
//   each of two consumer warpgroups, rows 0-63 and 64-127 of every row
//   group. phi's bf16 hi (and lo) tile for the CTA's rays is written once
//   into shared memory in the K-major no-swizzle layout that wgmma reads
//   through its descriptor. A producer warp streams C through a ring of
//   12 mbarrier-guarded 8 KB stages (one row group each) with 1-D bulk
//   copies; both CTAs of a pair read the same block at about the same
//   time, the second read mostly from L2. Each
//   consumer thread reads its A fragment of f32 from the stage (two
//   16-byte loads: k is permuted the same way in A and B so that a
//   thread's four k pairs are neighbours), converts it in registers
//   once, frees the stage, and issues wgmma with A from registers (K6 24
//   products a block, two groups in flight; K7 72, one group of three at
//   a time). Per block, the epilogue folds each warp's 16 rows by
//   shuffles, adds the 8 warps' column sums through shared memory and
//   writes csum[b] (and, for the last block, out) while the producer
//   already loads the next block.
//
// All of K5-K7 write the (128, 512) sums of the LAST stream block only
// (the TPU kernels' sequential grid rewrites one output block), and every
// stream block also writes its 512 column sums to csum[b], so that no
// block's arithmetic is dead code and the plain version can check all of
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_shell.cuh"

namespace {

using namespace sweep_shell;

constexpr int kTile = 512;          // rays of K5-K7
constexpr int kBlockRows = 128;     // group rows per stream block
// A barrier wait that outlasts this traps, so a fault in a pipeline ends
// the launch with an error instead of hanging the card.
constexpr unsigned long long kWaitLimitNs = 4000000000ull;

// ------------------------------------------ barriers and bulk copies (K5-K7)

__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` of the barrier at `bar`.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arm the barrier at `bar` with `bytes` and start one 1-D bulk copy of
// them from global `src` to shared `dst`; the barrier's phase completes
// when they have landed.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// CTAs of `kernel` resident on the whole card at once (computed once per
// instance into `cache`, after raising its dynamic shared memory limit).
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, int smem_bytes,
                          int& cache) {
  if (cache > 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem_bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache = per_sm * sms;
  return cudaSuccess;
}

// ---------------------------------------------------------------- K4

struct DetBody {
  static __device__ __forceinline__ void bounds(RayState&) {}

  static __device__ __forceinline__ void test(RayState& r, const float4 q0,
                                              const float4, const float4,
                                              const float4, const float4*) {
    const float det = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
    r.bt = fminf(r.bt, det);
  }

  static __device__ __forceinline__ void flush(const RayState& r, float& t,
                                               int& id, float& u, float& v) {
    t = r.bt;
    id = -1;
    u = 0.0f;
    v = 0.0f;
  }
};

// ---------------------------------------------------------------- K5

constexpr int kDotConsumers = 256;                 // eight warps
constexpr int kDotThreads = kDotConsumers + 32;    // and the producer warp
constexpr int kDotRays = 8;                        // rays a consumer thread
constexpr int kDotSet = kTile / kDotRays;          // threads of a row group
constexpr int kDotGroups = kDotConsumers / kDotSet;  // 4 row groups
constexpr int kDotStageRows = 16;                  // rows of a stage
constexpr int kDotStageBytes = kDotStageRows * kRowF4 * 16;   // 8 KB
constexpr int kDotStages = kBlockRows / kDotStageRows;        // 8 a block
constexpr int kDotRing = 2 * kDotStages;           // two blocks in flight
constexpr int kDotColsumOff = kDotRing * kDotStageBytes;
constexpr int kDotColsumBytes = kDotGroups * kTile * 4;  // groups' sums
constexpr int kDotBarOff = kDotColsumOff + 2 * kDotColsumBytes;
constexpr int kDotSmem = kDotBarOff + 2 * kDotRing * 8;

// a * b + c: one fused instruction, or a multiply and an add rounded
// separately (the library is built with -fmad=false, so the compiler never
// fuses them itself). Addition commutes, so chains of mad() round exactly
// like the left-to-right sums of the plain version.
template <bool kFma>
__device__ __forceinline__ float mad(float a, float b, float c) {
  return kFma ? __fmaf_rn(a, b, c) : a * b + c;
}

// One pair: the row's accumulator after this ref. The FMA instance gets
// the origin negated (o holds -o) and starts tt's chain from f.
template <bool kFma>
__device__ __forceinline__ float linear_forms(
    float acc, float ox, float oy, float oz, float dx, float dy, float dz,
    float mx, float my, float mz, const float4 q0, const float4 q1,
    const float4 q2, const float4 q3) {
  // det = d.n, tt = f - o.n, uu = m.b + d.c, vv = m.d' + d.e
  const float det = mad<kFma>(dz, q0.z, mad<kFma>(dy, q0.y, dx * q0.x));
  const float tt =
      kFma ? mad<true>(oz, q0.z, mad<true>(oy, q0.y, mad<true>(ox, q0.x,
                                                                 q3.w)))
           : q3.w - mad<false>(oz, q0.z, mad<false>(oy, q0.y, ox * q0.x));
  float uu = mad<kFma>(my, q1.x, mx * q0.w);
  uu = mad<kFma>(mz, q1.y, uu);
  uu = mad<kFma>(dx, q1.z, uu);
  uu = mad<kFma>(dy, q1.w, uu);
  uu = mad<kFma>(dz, q2.x, uu);
  float vv = mad<kFma>(my, q2.z, mx * q2.y);
  vv = mad<kFma>(mz, q2.w, vv);
  vv = mad<kFma>(dx, q3.x, vv);
  vv = mad<kFma>(dy, q3.y, vv);
  vv = mad<kFma>(dz, q3.z, vv);
  return acc + det + tt + uu + vv;
}

static_assert(kDotStageRows % kDotGroups == 0, "a stage splits evenly");

template <bool kFma>
__global__ void __launch_bounds__(kDotThreads, 1) dots_fp32_kernel(
    const float* __restrict__ xt, const float* __restrict__ g,
    float* __restrict__ out, float* __restrict__ csum, int n_blocks) {
  extern __shared__ __align__(1024) uint8_t sm[];
  const uint32_t base = smem(sm);
  const uint32_t full = base + kDotBarOff;      // kDotRing barriers
  const uint32_t empty = full + kDotRing * 8;   // kDotRing barriers
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kDotRing; ++s) {
      mbar_init_count(full + 8 * s, 1);
      mbar_init_count(empty + 8 * s, kDotConsumers / 32);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kDotConsumers) {
    // Producer: one thread streams the CTA's blocks, stage by stage.
    if (tid == kDotConsumers) {
      int it = 0;  // stages issued
      for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
        const char* src = reinterpret_cast<const char*>(g)
                          + (size_t)b * kDotStages * kDotStageBytes;
        for (int p = 0; p < kDotStages; ++p, ++it) {
          const int s = it % kDotRing;
          mbar_wait_bounded(empty + 8 * s, ((it / kDotRing) & 1) ^ 1);
          bulk_copy(base + s * kDotStageBytes, src + p * kDotStageBytes,
                    kDotStageBytes, full + 8 * s);
        }
      }
    }
    __syncwarp();
    return;
  }

  // Consumers: thread tid takes rays c + kDotSet k (k < kDotRays) of rows
  // grp + kDotGroups j of the block.
  const int grp = tid / kDotSet;
  const int c = tid % kDotSet;
  float ox[kDotRays], oy[kDotRays], oz[kDotRays], dx[kDotRays],
      dy[kDotRays], dz[kDotRays], mx[kDotRays], my[kDotRays], mz[kDotRays];
#pragma unroll
  for (int k = 0; k < kDotRays; ++k) {
    const int r = c + kDotSet * k;
    ox[k] = kFma ? -xt[1 * kTile + r] : xt[1 * kTile + r];
    oy[k] = kFma ? -xt[2 * kTile + r] : xt[2 * kTile + r];
    oz[k] = kFma ? -xt[3 * kTile + r] : xt[3 * kTile + r];
    dx[k] = xt[4 * kTile + r];
    dy[k] = xt[5 * kTile + r];
    dz[k] = xt[6 * kTile + r];
    mx[k] = xt[7 * kTile + r];
    my[k] = xt[8 * kTile + r];
    mz[k] = xt[9 * kTile + r];
  }
  int it = 0;  // stages consumed
  int n = 0;   // blocks done
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x, ++n) {
    const bool last = b == n_blocks - 1;
    float cs[kDotRays];
#pragma unroll
    for (int k = 0; k < kDotRays; ++k) cs[k] = 0.0f;
    for (int p = 0; p < kDotStages; ++p, ++it) {
      const int s = it % kDotRing;
      mbar_wait_bounded(full + 8 * s, (it / kDotRing) & 1);
      const float4* stage =
          reinterpret_cast<const float4*>(sm + s * kDotStageBytes);
#pragma unroll 1
      for (int row = grp; row < kDotStageRows; row += kDotGroups) {
        const float4* rp = stage + row * kRowF4;
        float acc[kDotRays];
#pragma unroll
        for (int k = 0; k < kDotRays; ++k) acc[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < kRefsPerRow; ++j) {
          const float4* q = rp + j * kRefF4;
          const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
#pragma unroll
          for (int k = 0; k < kDotRays; ++k)
            acc[k] = linear_forms<kFma>(acc[k], ox[k], oy[k], oz[k], dx[k],
                                        dy[k], dz[k], mx[k], my[k], mz[k],
                                        q0, q1, q2, q3);
        }
#pragma unroll
        for (int k = 0; k < kDotRays; ++k) cs[k] = cs[k] + acc[k];
        if (last) {
          float* o = out + (size_t)(p * kDotStageRows + row) * kTile + c;
#pragma unroll
          for (int k = 0; k < kDotRays; ++k) o[kDotSet * k] = acc[k];
        }
      }
      // Free the stage: one arrive a warp.
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty + 8 * s);
    }
    // The groups' column sums, added in group order (buffers alternate per
    // block, so this barrier also orders the reads of two blocks ago
    // before the writes).
    float* cb = reinterpret_cast<float*>(sm + kDotColsumOff
                                         + (n & 1) * kDotColsumBytes);
#pragma unroll
    for (int k = 0; k < kDotRays; ++k)
      cb[grp * kTile + c + kDotSet * k] = cs[k];
    asm volatile("bar.sync 1, %0;\n" ::"n"(kDotConsumers) : "memory");
#pragma unroll
    for (int r = tid; r < kTile; r += kDotConsumers) {
      float sum = cb[r];
#pragma unroll
      for (int w = 1; w < kDotGroups; ++w) sum = sum + cb[w * kTile + r];
      csum[(size_t)b * kTile + r] = sum;
    }
  }
}

// One launch of a K5 instance: a persistent grid of as many CTAs as fit
// on the card at once (at most one per block).
template <bool kFma>
cudaError_t launch_dots_fp32(const float* xt, const float* g, float* out,
                             float* csum, int n_blocks, cudaStream_t s) {
  static int max_ctas = 0;
  auto* kernel = dots_fp32_kernel<kFma>;
  const cudaError_t e =
      resident_ctas(kernel, kDotThreads, kDotSmem, max_ctas);
  if (e != cudaSuccess) return e;
  const int ctas = n_blocks < max_ctas ? n_blocks : max_ctas;
  kernel<<<ctas, kDotThreads, kDotSmem, s>>>(xt, g, out, csum, n_blocks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K6, K7

constexpr int kK = 16;              // depth of the product
constexpr int kBlockCRows = 3072;   // rows of C per stream block
constexpr int kGroups = kBlockCRows / kBlockRows;  // 24 row groups
constexpr int kHalfRays = kTile / 2;        // rays per CTA of a pair: N
constexpr int kNTiles = kHalfRays / 8;      // n8 tiles of an accumulator
constexpr int kAcc = 4 * kNTiles;           // accumulator registers: 128
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kBf16Threads = kConsumers + 32;  // and the producer warp
constexpr int kStageBytes = kBlockRows * kK * 4;  // one row group: 8 KB
constexpr int kStages = 12;        // of the ring: half a block
constexpr int kPhiBytes = kK * kHalfRays * 2;   // one bf16 B tile: 8 KB
constexpr int kColsumBytes = 8 * kHalfRays * 4;  // 8 warps' column sums
// Dynamic shared memory: the ring, B hi and lo, two column-sum buffers,
// the full and empty barriers.
constexpr int kPhiOff = kStages * kStageBytes;
constexpr int kColsumOff = kPhiOff + 2 * kPhiBytes;
constexpr int kBarOff = kColsumOff + 2 * kColsumBytes;
constexpr int kBf16Smem = kBarOff + 2 * kStages * 8;
constexpr int kPairs = 2;           // CTAs a stream block is split over
// The ring's stages divide a block's groups, so group q of every block
// takes slot q % kStages; only the phase parity depends on the block.
static_assert(kGroups % kStages == 0, "a block fills whole rounds");

// Phase parity of group q of the CTA's k-th block (constant per q when a
// block is an even number of rounds of the ring).
__device__ __forceinline__ uint32_t ring_parity(int k, int q) {
  return (k * (kGroups / kStages) + q / kStages) & 1;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
       | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two neighbouring f32 operands -> one packed register of hi parts and,
// for the split, one of lo = bf16(x - f32(hi)) parts.
template <bool kSplit>
__device__ __forceinline__ void to_bf16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  if (kSplit)
    lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                   __float2bfloat16_rn(x1 - __bfloat162float(h1)));
  else
    lo = 0u;
}

// The column of a stage row (of C) and the row of phi that hold logical
// depth k. wgmma's A fragment gives a thread depths 2t, 2t+1, 2t+8, 2t+9
// (t = lane % 4); read as one float4 at column 4t, they are the four
// neighbouring columns 4t..4t+3. B holds phi's rows in the same order, so
// every product C[., p] . phi[p, .] is made once, as before.
__host__ __device__ constexpr int phys_k(int k) {
  return 4 * ((k & 7) >> 1) + 2 * (k >> 3) + (k & 1);
}

// wgmma's shared-memory descriptor of a K-major B tile without swizzle:
// 8 x 16-byte core matrices (8 rays x 8 depths), the two depth halves
// 128 bytes apart (leading byte offset), the next 8 rays 256 bytes on
// (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
       | ((uint64_t)(256 >> 4) << 32);
}

// Byte offset of (depth k, ray n) in such a tile.
__device__ __forceinline__ int b_offset(int k, int n) {
  return (n >> 3) * 256 + (n & 7) * 16 + (k >> 3) * 128 + (k & 7) * 2;
}

#define HG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HG_D16(i) HG_D4(i), HG_D4(i + 4), HG_D4(i + 8), HG_D4(i + 12)
#define HG_D64(i) HG_D16(i), HG_D16(i + 16), HG_D16(i + 32), HG_D16(i + 48)

// D (64 x 256, f32) (+)= A (64 x 16, bf16, registers) . B (16 x 256,
// bf16, shared memory, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAcc],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : HG_D64(0), HG_D64(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

#undef HG_D64
#undef HG_D16
#undef HG_D4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}

// Ties the accumulator's registers to this point, so that no read of them
// moves above a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One step of a reduce-scatter across the lanes `m` apart: the lane with
// `upper` keeps the upper half of v[0..kLen), its partner the lower half,
// each adding what the other sends.
template <int kLen>
__device__ __forceinline__ void fold(float* v, bool upper, int m) {
#pragma unroll
  for (int i = 0; i < kLen / 2; ++i) {
    const float send = upper ? v[i] : v[i + kLen / 2];
    const float keep = upper ? v[i + kLen / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kBf16Threads, 1) dots_bf16_kernel(
    const float* __restrict__ phi, const float* __restrict__ c,
    float* __restrict__ out, float* __restrict__ csum, int n_blocks) {
  extern __shared__ __align__(1024) uint8_t sm[];
  const uint32_t base = smem(sm);
  const uint32_t full = base + kBarOff;             // kStages barriers
  const uint32_t empty = full + kStages * 8;        // kStages barriers
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % kPairs;   // CTAs 2i and 2i + 1: pair i
  const int pair = blockIdx.x / kPairs;
  const int n_pairs = gridDim.x / kPairs;
  const int n0 = rank * kHalfRays;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init_count(full + 8 * s, 1);
      mbar_init_count(empty + 8 * s, 8);  // every consumer warp frees it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // B tiles: thread n converts phi's 16 rows for ray n0 + n.
  if (tid < kHalfRays) {
    uint32_t hw[8], lw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      to_bf16<kSplit>(phi[phys_k(2 * j) * kTile + n0 + tid],
                      phi[phys_k(2 * j + 1) * kTile + n0 + tid], hw[j],
                      lw[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint8_t* dst = sm + kPhiOff + b_offset(8 * h, tid);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(hw[4 * h], hw[4 * h + 1], hw[4 * h + 2], hw[4 * h + 3]);
      if (kSplit)
        *reinterpret_cast<uint4*>(dst + kPhiBytes) = make_uint4(
            lw[4 * h], lw[4 * h + 1], lw[4 * h + 2], lw[4 * h + 3]);
    }
    // The tiles are read by wgmma, through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // The barriers exist and the B tiles are written.
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread streams the pair's blocks, group by group.
    if (tid == kConsumers) {
      for (int b = pair, k = 0; b < n_blocks; b += n_pairs, ++k) {
        const char* src = reinterpret_cast<const char*>(
            c + (size_t)b * kBlockCRows * kK);
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const int s = q % kStages;
          mbar_wait_bounded(empty + 8 * s, ring_parity(k, q) ^ 1);
          bulk_copy(base + s * kStageBytes, src + q * kStageBytes,
                    kStageBytes, full + 8 * s);
        }
      }
    }
    __syncwarp();
  } else {
    // Consumers: warpgroup wg takes rows 64 wg.. of every row group; the
    // thread's A fragment is rows gid and gid + 8 of its warp's 16, depths
    // as phys_k places them.
    const int wg = tid >> 7;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int row0 = 64 * wg + 16 * (warp & 3) + gid;
    const uint8_t* a_src = sm + (row0 * kK + 4 * tig) * 4;
    const uint64_t desc_hi = b_desc(base + kPhiOff);
    const uint64_t desc_lo = b_desc(base + kPhiOff + kPhiBytes);
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;  // (each block's first
                                                    // product overwrites)
    // Group q of the CTA's k-th block: wait for its stage, convert this
    // thread's A fragment into (h, l), free the stage, issue the group's
    // products.
    auto group = [&](int k, int q, uint32_t(&h)[4], uint32_t(&l)[4]) {
      const int s = q % kStages;
      mbar_wait_bounded(full + 8 * s, ring_parity(k, q));
      const float4 x0 =
          *reinterpret_cast<const float4*>(a_src + s * kStageBytes);
      const float4 x1 = *reinterpret_cast<const float4*>(
          a_src + s * kStageBytes + 8 * kK * 4);
      // a0: row gid, depths 2t, 2t+1; a1: row gid+8; a2: row gid, depths
      // 2t+8, 2t+9; a3: row gid+8.
      to_bf16<kSplit>(x0.x, x0.y, h[0], l[0]);
      to_bf16<kSplit>(x1.x, x1.y, h[1], l[1]);
      to_bf16<kSplit>(x0.z, x0.w, h[2], l[2]);
      to_bf16<kSplit>(x1.z, x1.w, h[3], l[3]);
      // Free the stage: one arrive for the warp.
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      wgmma_fence();
      wgmma_bf16(acc, h, desc_hi, q > 0);
      if (kSplit) {
        wgmma_bf16(acc, h, desc_lo, 1);
        wgmma_bf16(acc, l, desc_hi, 1);
      }
      wgmma_commit();
      // K6: the group before this one is done, so its A registers are
      // free. K7 waits for its own group: with a second group's A (hi and
      // lo) in flight its registers do not fit and ptxas serialises every
      // product, 16-19% slower on an H100 (PERF.md).
      wgmma_wait<kSplit ? 0 : 1>();
    };
    // Two A fragments alternate: one being read by the group in flight,
    // one being filled (K6).
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    int k = 0;  // blocks this CTA has done
    for (int b = pair; b < n_blocks; b += n_pairs, ++k) {
#pragma unroll
      for (int q = 0; q < kGroups; q += 2) {
        group(k, q, ah0, al0);
        group(k, q + 1, ah1, al1);
      }
      wgmma_wait<0>();
      fence_acc(acc);

      // acc[4j + e]: row gid, ray 8j + 2 tig + e; acc[4j + 2 + e]: row
      // gid + 8, the same ray.
      if (b == n_blocks - 1) {
        float* o = out + (size_t)row0 * kTile + n0 + 2 * tig;
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(o + 8 * kTile + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      // Column sums of the warp's 16 rows, folded across gid: lane
      // (gid, tig) ends with rays 32 gid + 8 (i / 2) + 2 tig + i % 2.
      float v[2 * kNTiles];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        v[2 * j] = acc[4 * j] + acc[4 * j + 2];
        v[2 * j + 1] = acc[4 * j + 1] + acc[4 * j + 3];
      }
      fold<64>(v, lane & 16, 16);
      fold<32>(v, lane & 8, 8);
      fold<16>(v, lane & 4, 4);
      float* cs = reinterpret_cast<float*>(sm + kColsumOff
                                           + (k & 1) * kColsumBytes)
                + warp * kHalfRays;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cs[32 * gid + 8 * (i >> 1) + 2 * tig + (i & 1)] = v[i];
      // The 8 warps' sums are written (buffers alternate per block, so
      // this barrier also orders the reads of two blocks ago before the
      // writes above).
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      const float* cb = reinterpret_cast<const float*>(
                            sm + kColsumOff + (k & 1) * kColsumBytes)
                      + tid;
      const float s0 = ((cb[0] + cb[256]) + cb[512]) + cb[768];
      const float s1 = ((cb[1024] + cb[1280]) + cb[1536]) + cb[1792];
      csum[(size_t)b * kTile + n0 + tid] = s0 + s1;
    }
  }
}

// One launch of a K6/K7 instance: a persistent grid of as many CTA pairs
// as fit on the card at once (at most one per block).
template <bool kSplit>
cudaError_t launch_dots_bf16(const float* phi, const float* c, float* out,
                             float* csum, int n_blocks, cudaStream_t s) {
  static int max_ctas = 0;
  auto* kernel = dots_bf16_kernel<kSplit>;
  const cudaError_t e =
      resident_ctas(kernel, kBf16Threads, kBf16Smem, max_ctas);
  if (e != cudaSuccess) return e;
  const int max_pairs = max_ctas / kPairs;
  if (max_pairs < 1) return cudaErrorInvalidConfiguration;
  const int pairs = n_blocks < max_pairs ? n_blocks : max_pairs;
  dots_bf16_kernel<kSplit><<<kPairs * pairs, kBf16Threads, kBf16Smem, s>>>(
      phi, c, out, csum, n_blocks);
  return cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream`, does not
// synchronise and returns cudaGetLastError() of its launch.

// K4: the arguments of hagrid_sweep without any_hit, skipped, partial and
// C: every tile is one chunk (C = n_blocks, so n_rows = nt + 1).
extern "C" int hagrid_det_sweep(const float* xt, int n_cols,
                                const float* cols, const int* gidx,
                                const int* tile_of, int n_blocks,
                                const int* tminb, float* out_t, int* out_id,
                                float* out_u, float* out_v, int nt, int tile,
                                int* plan, void* stream) {
  const sweep_shell::Params p{
      xt, n_cols, reinterpret_cast<const float4*>(cols), gidx, nullptr,
      tminb, out_t, out_id, out_u, out_v, tile, nullptr, nullptr};
  const sweep_shell::Plan q{tile_of, n_blocks, nt, n_blocks, nt + 1, plan};
  return (int)sweep_shell::launch<DetBody, false>(p, q,
                                                  (cudaStream_t)stream);
}

// K5: xt f32[16, 512], g f32[n_blocks * 128, 128] -> out f32[128, 512]
// (the last block's sums), csum f32[n_blocks, 512]. fma != 0 launches the
// instance with explicit fused multiply-adds.
extern "C" int hagrid_dots_fp32(const float* xt, const float* g, float* out,
                                float* csum, int n_blocks, int fma,
                                void* stream) {
  if (n_blocks <= 0 || n_blocks > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(fma
      ? launch_dots_fp32<true>(xt, g, out, csum, n_blocks, s)
      : launch_dots_fp32<false>(xt, g, out, csum, n_blocks, s));
}

// K6 (split == 0) and K7 (split != 0): phi f32[16, 512],
// c f32[n_blocks * 3072, 16] -> out f32[128, 512], csum f32[n_blocks, 512].
extern "C" int hagrid_dots_bf16(const float* phi, const float* c, float* out,
                                float* csum, int n_blocks, int split,
                                void* stream) {
  if (n_blocks <= 0 || n_blocks > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(split
      ? launch_dots_bf16<true>(phi, c, out, csum, n_blocks, s)
      : launch_dots_bf16<false>(phi, c, out, csum, n_blocks, s));
}
