// Planned-sweep closest-hit kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels hagrid_tpu/ops/sweep_trace.py::_make_kernel
// (K1, pre-gathered block stream) and ::_make_kernel_dma (K2, in-kernel
// gather from `cols` by `gidx`). Both compute one function; this kernel
// takes K2's interface and stands for K1 when called with the
// pre-gathered stream as `cols` and gidx = arange.
//
// Work: every ray of a tile against every ref of the tile's run of
// 768-ref blocks, in the linear form of Moller-Trumbore
// (grid/packet.py): det = d.n, t = (f - o.n)/det, u = (m.b + d.c)/det,
// v = (m.d' + d.e)/det, accepted when u, v, 1-u-v >= 0, |det| > 1e-12 and
// t > tmin, and kept when better than the ray's running best.
//
// What bounds it on this card: fp32 ALU work per ray-ref pair (about 45
// FP32 instructions and one IEEE division; the build uses -fmad=false, so
// no FMAs, to round exactly as the plain torch version does). Memory is
// not the limit: a block's 64 KB of coefficients is read from device
// memory once and reused by all rays of the tile from shared memory, where
// every thread reads the same address (a broadcast, no bank conflicts).
//
// Design:
// - One CUDA block per ray tile, tile/2 threads, two rays per thread, so
//   each coefficient loaded from shared memory serves two pairs. The
//   running best (t, id, u, v) of each ray lives in registers.
// - The TPU grid walks blocks in order and carries the accumulator from
//   one grid step to the next; here a loop inside the CUDA block walks the
//   tile's run of stream blocks [bstart[t], bend[t]).
// - Early-out per stream block: skipped when every ray's best t is <= the
//   block's threshold, compared as f32 bit patterns read as int32 (the
//   TPU kernel's compare; dead lanes are seeded with -BIG and count as
//   done).
// - A block's 32 units (4 rows x 128 floats each) are staged into shared
//   memory in 4 pieces of 8 units (16 KB) with coalesced float4 loads;
//   each thread then tests its rays against the piece's 192 refs,
//   skipping the 8 pad lanes of every row.
// - Ties: a hit wins on smaller t, or on equal t with a smaller id; the
//   seed carries id -1 and never loses a tie (the oracle's and _merge's
//   rule).

#include <cuda_runtime.h>

namespace {

constexpr int kRowF4 = 32;          // float4 per 128-float group row
constexpr int kUnitRows = 4;        // group rows per gather unit
constexpr int kUnitF4 = kUnitRows * kRowF4;  // 128 float4 per unit
constexpr int kUnitsPerBlock = 32;  // units per 768-ref stream block
constexpr int kPieceUnits = 8;      // units staged per shared piece
constexpr int kPieceRows = kPieceUnits * kUnitRows;  // 32 rows
constexpr int kPieceF4 = kPieceUnits * kUnitF4;      // 1024 float4 = 16 KB
constexpr int kRefsPerRow = 6;
constexpr int kRefF4 = 5;           // 20 coefficients per ref
constexpr int kRaysPerThread = 2;
constexpr int kMaxThreads = 256;    // tiles of up to 512 rays
constexpr float kBig = 3e38f;

struct RayState {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, tmin;
  float bt, bu, bv;
  int bid;
};

// Ref coefficients, as four float4 of one 20-float ref row:
// q0 = [n0 n1 n2 b0], q1 = [b1 b2 c0 c1], q2 = [c2 d0 d1 d2],
// q3 = [e0 e1 e2 f]; the id rides as a float value in q4.x.
__device__ __forceinline__ void test_ref(RayState& r, const float4 q0,
                                         const float4 q1, const float4 q2,
                                         const float4 q3, int id) {
  const float det = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
  const float tt = q3.w - (r.ox * q0.x + r.oy * q0.y + r.oz * q0.z);
  const float uu = r.mx * q0.w + r.my * q1.x + r.mz * q1.y
                 + r.dx * q1.z + r.dy * q1.w + r.dz * q2.x;
  const float vv = r.mx * q2.y + r.my * q2.z + r.mz * q2.w
                 + r.dx * q3.x + r.dy * q3.y + r.dz * q3.z;
  const float inv = 1.0f / det;
  const float t = tt * inv;
  const float u = uu * inv;
  const float v = vv * inv;
  // min(u, v, 1-(u+v)) >= 0 with NaN-propagating min == all three >= 0.
  const bool ok = (u >= 0.0f) & (v >= 0.0f) & (1.0f - (u + v) >= 0.0f)
                & (fabsf(det) > 1e-12f) & (t > r.tmin);
  const bool better = ok & ((t < r.bt) |
                            ((t == r.bt) & (r.bid >= 0) & (id < r.bid)));
  if (better) {
    r.bt = t;
    r.bid = id;
    r.bu = u;
    r.bv = v;
  }
}

__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(
    const float* __restrict__ xt, int n_cols,
    const float4* __restrict__ cols, const int* __restrict__ gidx,
    const int* __restrict__ bstart, const int* __restrict__ bend,
    const int* __restrict__ tminb, float* __restrict__ out_t,
    int* __restrict__ out_id, float* __restrict__ out_u,
    float* __restrict__ out_v, int tile) {
  __shared__ float4 piece[kPieceF4];
  const int b_begin = bstart[blockIdx.x];
  const int b_end = bend[blockIdx.x];
  if (b_begin >= b_end) return;  // the tile has no blocks this round

  RayState ray[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int c = blockIdx.x * tile + threadIdx.x + k * blockDim.x;
    RayState& r = ray[k];
    r.ox = xt[1 * n_cols + c];
    r.oy = xt[2 * n_cols + c];
    r.oz = xt[3 * n_cols + c];
    r.dx = xt[4 * n_cols + c];
    r.dy = xt[5 * n_cols + c];
    r.dz = xt[6 * n_cols + c];
    r.mx = xt[7 * n_cols + c];
    r.my = xt[8 * n_cols + c];
    r.mz = xt[9 * n_cols + c];
    r.tmin = xt[12 * n_cols + c];
    r.bt = xt[14 * n_cols + c];  // seed: min(best, tmax); -BIG if dead
    r.bid = -1;
    r.bu = 0.0f;
    r.bv = 0.0f;
  }

  for (int b = b_begin; b < b_end; ++b) {
    const int thr = tminb[b];
    int busy = 0;
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k)
      busy |= __float_as_int(ray[k].bt) > thr;
    if (!__syncthreads_or(busy)) continue;  // every ray already done

    const int* units = gidx + (size_t)b * kUnitsPerBlock;
    for (int p = 0; p < kUnitsPerBlock / kPieceUnits; ++p) {
      __syncthreads();  // the previous piece has been consumed
      for (int i = threadIdx.x; i < kPieceF4; i += blockDim.x) {
        const int unit = units[p * kPieceUnits + i / kUnitF4];
        piece[i] = cols[(size_t)unit * kUnitF4 + i % kUnitF4];
      }
      __syncthreads();
      for (int row = 0; row < kPieceRows; ++row) {
        const float4* rp = piece + row * kRowF4;
#pragma unroll
        for (int s = 0; s < kRefsPerRow; ++s) {
          const float4* q = rp + s * kRefF4;
          const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
          const int id = (int)q[4].x;
#pragma unroll
          for (int k = 0; k < kRaysPerThread; ++k)
            test_ref(ray[k], q0, q1, q2, q3, id);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int c = blockIdx.x * tile + threadIdx.x + k * blockDim.x;
    const RayState& r = ray[k];
    const bool found = r.bid >= 0;
    out_t[c] = found ? r.bt : kBig;
    out_id[c] = r.bid;
    out_u[c] = found ? r.bu : 0.0f;
    out_v[c] = found ? r.bv : 0.0f;
  }
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, returns cudaGetLastError() of the launch.
extern "C" int hagrid_sweep(const float* xt, int n_cols, const float* cols,
                            const int* gidx, const int* bstart,
                            const int* bend, const int* tminb, float* out_t,
                            int* out_id, float* out_u, float* out_v, int nt,
                            int tile, void* stream) {
  if (nt <= 0 || tile % 64 != 0 || tile < 64 ||
      tile > kMaxThreads * kRaysPerThread)
    return (int)cudaErrorInvalidValue;
  sweep_kernel<<<nt, tile / kRaysPerThread, 0, (cudaStream_t)stream>>>(
      xt, n_cols, reinterpret_cast<const float4*>(cols), gidx, bstart, bend,
      tminb, out_t, out_id, out_u, out_v, tile);
  return (int)cudaGetLastError();
}

extern "C" const char* hagrid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
