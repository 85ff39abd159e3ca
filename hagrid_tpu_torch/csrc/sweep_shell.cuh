// The sweep's shell, shared by the production kernels (sweep.cu) and the
// det-only cost probe (micro.cu): everything of the planned sweep except
// what is done with one (ray, ref) pair.
//
// One CUDA block per ray tile, tile/2 threads, two rays per thread. The
// block walks the tile's run of 768-ref stream blocks [bstart, bend);
// a stream block is skipped when every ray's best t is <= the block's
// threshold (f32 bit patterns compared as int32, one __syncthreads_or);
// otherwise its 32 gather units (4 rows x 128 floats each) are staged into
// shared memory in 4 pieces of 8 units (16 KB) with coalesced float4
// loads, and each thread runs the body on its two rays against the
// piece's 192 refs, skipping the 8 pad lanes of every row. After the last
// block every ray is flushed once.
//
// The body is a policy struct with two static functions:
//   Body::test(RayState&, q0, q1, q2, q3, id)  one pair; q0..q3 are the
//       ref's first 16 coefficients, id its tri id (coefficient 16);
//   Body::flush(const RayState&, t, id, u, v)  the ray's four outputs.
// Both are inlined, so an instance holds only its own body's loads and
// arithmetic: what two instances' times differ by is the body.

#pragma once

#include <cuda_runtime.h>

namespace sweep_shell {

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
  float ox, oy, oz, dx, dy, dz, mx, my, mz, tmin, tmax;
  float bt, bu, bv;
  int bid;
};

// kLoadTmax: the body reads RayState::tmax (xt row 13).
template <class Body, bool kLoadTmax>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(
    const float* __restrict__ xt, int n_cols,
    const float4* __restrict__ cols, const int* __restrict__ gidx,
    const int* __restrict__ bstart, const int* __restrict__ bend,
    const int* __restrict__ tminb, float* __restrict__ out_t,
    int* __restrict__ out_id, float* __restrict__ out_u,
    float* __restrict__ out_v, int tile, int* __restrict__ skipped) {
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
    r.tmax = kLoadTmax ? xt[13 * n_cols + c] : 0.0f;
    // Seed: closest hit min(best, tmax), any hit the raw best; -BIG if
    // dead.
    r.bt = xt[14 * n_cols + c];
    r.bid = -1;
    r.bu = 0.0f;
    r.bv = 0.0f;
  }

  int n_skipped = 0;
  for (int b = b_begin; b < b_end; ++b) {
    const int thr = tminb[b];
    int busy = 0;
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k)
      busy |= __float_as_int(ray[k].bt) > thr;
    if (!__syncthreads_or(busy)) {  // every ray already done
      ++n_skipped;
      continue;
    }

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
            Body::test(ray[k], q0, q1, q2, q3, id);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int c = blockIdx.x * tile + threadIdx.x + k * blockDim.x;
    Body::flush(ray[k], out_t[c], out_id[c], out_u[c], out_v[c]);
  }
  if (skipped != nullptr && threadIdx.x == 0)
    skipped[blockIdx.x] += n_skipped;
}

// Tiles the shell takes: 64..512 rays in steps of 64.
inline bool launch_ok(int nt, int tile) {
  return nt > 0 && tile % 64 == 0 && tile >= 64 &&
         tile <= kMaxThreads * kRaysPerThread;
}

}  // namespace sweep_shell
