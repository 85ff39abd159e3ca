// Sweep-cost micro-kernels for Hopper (sm_90a): what the planned sweep
// (csrc/sweep.cu) spends on its shell, and what its four linear forms cost
// on the FP32 pipes and on the tensor cores. They measure; the renderer
// never calls them.
//
// K4, det_sweep_kernel: replaces exp/r3_kernel_mt20.py::make_det_kernel.
//   The production shell (csrc/sweep_shell.cuh: one CUDA block per tile
//   walking its run of stream blocks, early-out vote, 4-piece staging, two
//   rays a thread, final flush) with the body cut to det = d.n per ref and
//   a running min. Output per ray: t = min(seed, min det), id = -1,
//   u = v = 0. Bound on this card: FP32 operations (6 per pair: 3
//   multiplies, 2 adds, 1 min) against 64 KB staged per stream block; the
//   staging and the two barriers per piece are what it is there to expose.
//   `full - det3` is the production body, `det3 - skipped` the staging.
//
// K5, dots_fp32_kernel: replaces exp/r4_mxu_micro.py::vpu_kernel. Per
//   stream block of 128 rows x 6 refs and 512 rays: det, f - o.n,
//   m.b + d.c, m.d' + d.e in FP32, all four summed over a row's 6 refs.
//   Bound: FP32 operations (37 per pair, no FMA: the library is built with
//   -fmad=false like the production kernel, whose share it measures). One
//   CUDA block per stream block, the block's coefficients staged in 16 KB
//   pieces and read as broadcasts, two rays a thread in registers. A
//   second instance, dots_fp32_kernel<true>, writes every multiply-add as
//   an explicit __fmaf_rn (23 instructions per pair instead of 37): what
//   contraction would buy the sweep, at the price of rounding once where
//   the plain version rounds twice.
//
// K6 / K7, dots_bf16_kernel<false / true>: replace
//   exp/r4_mxu_micro.py::mxu1_kernel and ::mxu3_kernel. Per stream block,
//   C_blk (3072 x 16) . phi (16 x 512) with both operands cast to bf16
//   inside the kernel and f32 accumulation, the 24 groups of 128 rows
//   summed: out = sum_q C_q . phi. K = 16 is one bf16 mma.sync step
//   (m16n8k16), and the group sum is 24 such steps chained into one
//   accumulator fragment. K7 splits both operands into hi = bf16(x) and
//   lo = bf16(x - f32(hi)) and sums hi.hi + hi.lo + lo.hi. Bound: K6 by
//   the bytes of C (403 MB at 2048 blocks against 103 GFLOP at the bf16
//   tensor-core rate), K7 by its 3 x operations. A CUDA block of 8 warps
//   takes one stream block and one quarter of the rays (128 x 128
//   outputs, 64 accumulator registers a thread, phi's fragments held in
//   registers for the whole block); the 4 quarters of a stream block are
//   neighbours in the grid, so C comes from device memory once and from
//   L2 three times. Operand fragments are loaded from global memory as
//   float2 and converted in registers: no shared-memory staging.
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
constexpr int kDotThreads = 256;

// ---------------------------------------------------------------- K4

struct DetBody {
  static __device__ __forceinline__ void test(RayState& r, const float4 q0,
                                              const float4, const float4,
                                              const float4, int) {
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

// a * b + c: one fused instruction, or a multiply and an add rounded
// separately (the library is built with -fmad=false, so the compiler never
// fuses them itself). Addition commutes, so chains of mad() round exactly
// like the left-to-right sums of the plain version.
template <bool kFma>
__device__ __forceinline__ float mad(float a, float b, float c) {
  return kFma ? __fmaf_rn(a, b, c) : a * b + c;
}

template <bool kFma>
__global__ void __launch_bounds__(kDotThreads) dots_fp32_kernel(
    const float* __restrict__ xt, const float4* __restrict__ g,
    float* __restrict__ out, float* __restrict__ csum, int n_blocks) {
  __shared__ float4 piece[kPieceF4];
  const int b = blockIdx.x;
  const bool last = b == n_blocks - 1;
  float ox[2], oy[2], oz[2], dx[2], dy[2], dz[2], mx[2], my[2], mz[2];
  float cs[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = threadIdx.x + k * kDotThreads;
    ox[k] = xt[1 * kTile + c];
    oy[k] = xt[2 * kTile + c];
    oz[k] = xt[3 * kTile + c];
    dx[k] = xt[4 * kTile + c];
    dy[k] = xt[5 * kTile + c];
    dz[k] = xt[6 * kTile + c];
    mx[k] = xt[7 * kTile + c];
    my[k] = xt[8 * kTile + c];
    mz[k] = xt[9 * kTile + c];
    cs[k] = 0.0f;
  }
  const float4* rows = g + (size_t)b * kBlockRows * kRowF4;
  for (int p = 0; p < kBlockRows / kPieceRows; ++p) {
    __syncthreads();  // the previous piece has been consumed
    for (int i = threadIdx.x; i < kPieceF4; i += kDotThreads)
      piece[i] = rows[p * kPieceF4 + i];
    __syncthreads();
    for (int row = 0; row < kPieceRows; ++row) {
      const float4* rp = piece + row * kRowF4;
      float acc[2] = {0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kRefsPerRow; ++s) {
        const float4* q = rp + s * kRefF4;
        const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          // det = d.n, tt = f - o.n, uu = m.b + d.c, vv = m.d' + d.e
          const float det = mad<kFma>(
              dz[k], q0.z, mad<kFma>(dy[k], q0.y, dx[k] * q0.x));
          const float tt = q3.w - mad<kFma>(
              oz[k], q0.z, mad<kFma>(oy[k], q0.y, ox[k] * q0.x));
          float uu = mad<kFma>(my[k], q1.x, mx[k] * q0.w);
          uu = mad<kFma>(mz[k], q1.y, uu);
          uu = mad<kFma>(dx[k], q1.z, uu);
          uu = mad<kFma>(dy[k], q1.w, uu);
          uu = mad<kFma>(dz[k], q2.x, uu);
          float vv = mad<kFma>(my[k], q2.z, mx[k] * q2.y);
          vv = mad<kFma>(mz[k], q2.w, vv);
          vv = mad<kFma>(dx[k], q3.x, vv);
          vv = mad<kFma>(dy[k], q3.y, vv);
          vv = mad<kFma>(dz[k], q3.z, vv);
          acc[k] = acc[k] + det + tt + uu + vv;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        cs[k] = cs[k] + acc[k];
        if (last)
          out[(p * kPieceRows + row) * kTile + threadIdx.x
              + k * kDotThreads] = acc[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    csum[(size_t)b * kTile + threadIdx.x + k * kDotThreads] = cs[k];
}

// ---------------------------------------------------------------- K6, K7

constexpr int kK = 16;              // depth of the product
constexpr int kBlockCRows = 3072;   // rows of C per stream block
constexpr int kGroups = kBlockCRows / kBlockRows;  // 24 row groups
constexpr int kQuarterRays = 128;   // rays per CUDA block
constexpr int kNTiles = kQuarterRays / 8;  // n8 tiles per warp: 16
constexpr int kWarps = kDotThreads / 32;   // 8 warps x 16 rows = 128 rows

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

// D (16x8, f32) += A (16x16, bf16, row-major) . B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kSplit>
__global__ void __launch_bounds__(kDotThreads) dots_bf16_kernel(
    const float* __restrict__ phi, const float* __restrict__ c,
    float* __restrict__ out, float* __restrict__ csum, int n_blocks) {
  __shared__ float colsum[kWarps][kQuarterRays];
  const int b = blockIdx.x >> 2;
  const int n0 = (blockIdx.x & 3) * kQuarterRays;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;   // fragment row (A, D) / column (B)
  const int tig = lane & 3;    // thread in group

  // phi's fragments for this CUDA block's 128 rays, held for all 24 groups:
  // register h of tile j holds phi[tig*2 + 8h + {0,1}][n0 + 8j + gid].
  uint32_t bh[kNTiles][2], bl[kNTiles][2];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = tig * 2 + h * 8;
      const int n = n0 + j * 8 + gid;
      to_bf16<kSplit>(phi[k * kTile + n], phi[(k + 1) * kTile + n],
                      bh[j][h], bl[j][h]);
    }
  }

  float acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  // This warp's 16 rows of every group: rows gid and gid + 8, columns
  // tig*2 + {0,1} and tig*2 + 8 + {0,1}, as float2 loads.
  const float* cw = c + ((size_t)b * kBlockCRows + warp * 16) * kK;
  for (int q = 0; q < kGroups; ++q) {
    const float* a = cw + (size_t)q * kBlockRows * kK;
    const float2 x0 = *reinterpret_cast<const float2*>(
        a + gid * kK + tig * 2);
    const float2 x1 = *reinterpret_cast<const float2*>(
        a + (gid + 8) * kK + tig * 2);
    const float2 x2 = *reinterpret_cast<const float2*>(
        a + gid * kK + tig * 2 + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(
        a + (gid + 8) * kK + tig * 2 + 8);
    uint32_t ah[4], al[4];
    to_bf16<kSplit>(x0.x, x0.y, ah[0], al[0]);
    to_bf16<kSplit>(x1.x, x1.y, ah[1], al[1]);
    to_bf16<kSplit>(x2.x, x2.y, ah[2], al[2]);
    to_bf16<kSplit>(x3.x, x3.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      mma_bf16(acc[j], ah, bh[j]);
      if (kSplit) {
        mma_bf16(acc[j], ah, bl[j]);
        mma_bf16(acc[j], al, bh[j]);
      }
    }
  }

  // D fragment: acc[j][0..1] = row gid, rays n0 + 8j + tig*2 + {0,1};
  // acc[j][2..3] = row gid + 8, the same rays.
  if (b == n_blocks - 1) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int n = n0 + j * 8 + tig * 2;
      float* r0 = out + (warp * 16 + gid) * kTile + n;
      float* r1 = out + (warp * 16 + gid + 8) * kTile + n;
      r0[0] = acc[j][0];
      r0[1] = acc[j][1];
      r1[0] = acc[j][2];
      r1[1] = acc[j][3];
    }
  }

  // Column sums over the block's 128 rows: the warp's 16 rows by shuffles
  // across gid, then the 8 warps through shared memory.
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    float s0 = acc[j][0] + acc[j][2];
    float s1 = acc[j][1] + acc[j][3];
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    }
    if (gid == 0) {
      colsum[warp][j * 8 + tig * 2] = s0;
      colsum[warp][j * 8 + tig * 2 + 1] = s1;
    }
  }
  __syncthreads();
  if (threadIdx.x < kQuarterRays) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += colsum[w][threadIdx.x];
    csum[(size_t)b * kTile + n0 + threadIdx.x] = s;
  }
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream`, does not
// synchronise and returns cudaGetLastError() of its launch.

// K4: the arguments of hagrid_sweep without any_hit and skipped.
extern "C" int hagrid_det_sweep(const float* xt, int n_cols,
                                const float* cols, const int* gidx,
                                const int* bstart, const int* bend,
                                const int* tminb, float* out_t, int* out_id,
                                float* out_u, float* out_v, int nt, int tile,
                                void* stream) {
  if (!sweep_shell::launch_ok(nt, tile)) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt), block(tile / sweep_shell::kRaysPerThread);
  sweep_shell::sweep_kernel<DetBody, false>
      <<<grid, block, 0, (cudaStream_t)stream>>>(
      xt, n_cols, reinterpret_cast<const float4*>(cols), gidx, bstart, bend,
      tminb, out_t, out_id, out_u, out_v, tile, nullptr);
  return (int)cudaGetLastError();
}

// K5: xt f32[16, 512], g f32[n_blocks * 128, 128] -> out f32[128, 512]
// (the last block's sums), csum f32[n_blocks, 512]. fma != 0 launches the
// instance with explicit fused multiply-adds.
extern "C" int hagrid_dots_fp32(const float* xt, const float* g, float* out,
                                float* csum, int n_blocks, int fma,
                                void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const cudaStream_t s = (cudaStream_t)stream;
  if (fma)
    dots_fp32_kernel<true><<<n_blocks, kDotThreads, 0, s>>>(xt, g4, out,
                                                            csum, n_blocks);
  else
    dots_fp32_kernel<false><<<n_blocks, kDotThreads, 0, s>>>(xt, g4, out,
                                                             csum, n_blocks);
  return (int)cudaGetLastError();
}

// K6 (split == 0) and K7 (split != 0): phi f32[16, 512],
// c f32[n_blocks * 3072, 16] -> out f32[128, 512], csum f32[n_blocks, 512].
extern "C" int hagrid_dots_bf16(const float* phi, const float* c, float* out,
                                float* csum, int n_blocks, int split,
                                void* stream) {
  if (n_blocks <= 0 || n_blocks > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks * 4), block(kDotThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (split)
    dots_bf16_kernel<true><<<grid, block, 0, s>>>(phi, c, out, csum,
                                                  n_blocks);
  else
    dots_bf16_kernel<false><<<grid, block, 0, s>>>(phi, c, out, csum,
                                                   n_blocks);
  return (int)cudaGetLastError();
}
