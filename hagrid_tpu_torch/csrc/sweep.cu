// Planned-sweep kernel for Hopper (sm_90a), closest hit and any hit.
//
// Replaces the TPU kernels hagrid_tpu/ops/sweep_trace.py::_make_kernel
// (K1, pre-gathered block stream) and ::_make_kernel_dma (K2, in-kernel
// gather from `cols` by `gidx`), and their any_hit=True instances (K3,
// sweep_trace.py:132-133 and 179-180). K1 and K2 compute one function;
// this kernel takes K2's interface and stands for K1 when called with the
// pre-gathered stream as `cols` and gidx = arange.
//
// Work: every ray of a tile against every ref of the tile's run of
// 768-ref blocks, in the linear form of Moller-Trumbore
// (grid/packet.py): det = d.n, t = (f - o.n)/det, u = (m.b + d.c)/det,
// v = (m.d' + d.e)/det, accepted when u, v, 1-u-v >= 0, |det| > 1e-12 and
// t > tmin, and kept when better than the ray's running best.
//
// Any hit (kAnyHit): a pair is accepted only when also t < tmax (xt row
// 13); the seed is the ray's raw best (BIG until it has a hit) and every
// block's threshold is the largest float below BIG, so a block is skipped
// exactly when every ray of the tile already has a hit or is dead. The
// hit kept is the closest one among the blocks swept, not necessarily the
// ray's closest hit. Closest hit folds tmax into the seed instead.
//
// What bounds it on this card: fp32 ALU work per ray-ref pair (about 45
// FP32 instructions and one IEEE division; the build uses -fmad=false, so
// no FMAs, to round exactly as the plain torch version does). Memory is
// not the limit: a block's 64 KB of coefficients is read from device
// memory once and reused by all rays of the tile from shared memory, where
// every thread reads the same address (a broadcast, no bank conflicts).
//
// Design (the shell is csrc/sweep_shell.cuh, shared with the det-only cost
// probe of csrc/micro.cu; this file holds the production body):
// - One CUDA block per ray tile, tile/2 threads, two rays per thread, so
//   each coefficient loaded from shared memory serves two pairs. The
//   running best (t, id, u, v) of each ray lives in registers.
// - The TPU grid walks blocks in order and carries the accumulator from
//   one grid step to the next; here a loop inside the CUDA block walks the
//   tile's run of stream blocks [bstart[t], bend[t]).
// - Early-out per stream block: skipped when every ray's best t is <= the
//   block's threshold, compared as f32 bit patterns read as int32 (the
//   TPU kernel's compare; dead lanes are seeded with -BIG and count as
//   done). With a non-null `skipped`, thread 0 adds the tile's count of
//   skipped blocks to skipped[tile] (for counting the pairs swept).
// - A block's 32 units (4 rows x 128 floats each) are staged into shared
//   memory in 4 pieces of 8 units (16 KB) with coalesced float4 loads;
//   each thread then tests its rays against the piece's 192 refs,
//   skipping the 8 pad lanes of every row.
// - Ties: a hit wins on smaller t, or on equal t with a smaller id; the
//   seed carries id -1 and never loses a tie (the oracle's and _merge's
//   rule).

#include <cuda_runtime.h>

#include "sweep_shell.cuh"

namespace {

using sweep_shell::RayState;
using sweep_shell::kBig;

// Ref coefficients, as four float4 of one 20-float ref row:
// q0 = [n0 n1 n2 b0], q1 = [b1 b2 c0 c1], q2 = [c2 d0 d1 d2],
// q3 = [e0 e1 e2 f]; the id rides as a float value in q4.x.
template <bool kAnyHit>
struct HitBody {
  static __device__ __forceinline__ void test(RayState& r, const float4 q0,
                                              const float4 q1,
                                              const float4 q2,
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
    bool ok = (u >= 0.0f) & (v >= 0.0f) & (1.0f - (u + v) >= 0.0f)
            & (fabsf(det) > 1e-12f) & (t > r.tmin);
    if (kAnyHit) ok &= t < r.tmax;
    const bool better = ok & ((t < r.bt) |
                              ((t == r.bt) & (r.bid >= 0) & (id < r.bid)));
    if (better) {
      r.bt = t;
      r.bid = id;
      r.bu = u;
      r.bv = v;
    }
  }

  static __device__ __forceinline__ void flush(const RayState& r, float& t,
                                               int& id, float& u, float& v) {
    const bool found = r.bid >= 0;
    t = found ? r.bt : kBig;
    id = r.bid;
    u = found ? r.bu : 0.0f;
    v = found ? r.bv : 0.0f;
  }
};

}  // namespace

// C entry point (loaded with ctypes). any_hit != 0 launches the any-hit
// instance; `skipped` (i32[nt], may be null) receives the count of skipped
// blocks per tile. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() of the launch.
extern "C" int hagrid_sweep(const float* xt, int n_cols, const float* cols,
                            const int* gidx, const int* bstart,
                            const int* bend, const int* tminb, float* out_t,
                            int* out_id, float* out_u, float* out_v, int nt,
                            int tile, int any_hit, int* skipped,
                            void* stream) {
  if (!sweep_shell::launch_ok(nt, tile)) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt), block(tile / sweep_shell::kRaysPerThread);
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* c4 = reinterpret_cast<const float4*>(cols);
  if (any_hit)
    sweep_shell::sweep_kernel<HitBody<true>, true><<<grid, block, 0, s>>>(
        xt, n_cols, c4, gidx, bstart, bend, tminb, out_t, out_id, out_u,
        out_v, tile, skipped);
  else
    sweep_shell::sweep_kernel<HitBody<false>, false><<<grid, block, 0, s>>>(
        xt, n_cols, c4, gidx, bstart, bend, tminb, out_t, out_id, out_u,
        out_v, tile, skipped);
  return (int)cudaGetLastError();
}

extern "C" const char* hagrid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
