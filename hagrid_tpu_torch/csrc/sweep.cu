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
// Design (the shell is csrc/sweep_shell.cuh, shared with the det-only cost
// probe of csrc/micro.cu; this file holds the production body):
// - Work is balanced over the SMs: the TPU walked a tile's run of blocks
//   in order on one core, but here one CTA per whole run let the longest
//   runs of incoherent waves (hundreds of blocks against a mean of about
//   15) finish alone on an emptied card. A one-CTA plan kernel cuts every
//   run into chunks of at most C blocks, one CTA each, longest runs first;
//   a tile of one chunk writes its outputs itself, the chunks of a split
//   tile merge by the plain version's (t, id) key (a partial per chunk,
//   then the shell's resolve pass). Each chunk starts from the seed, so a
//   later chunk of a split tile skips only what its own rays finished.
// - Reject without dividing: the four linear forms are computed as before
//   (no FMA: -fmad=false, so each product and sum rounds like the plain
//   version's), then a cheap test by sign and magnitude, with
//   s = sign(det), a = |det|, w = a * 2^-16, rejects a pair when
//     s*uu < -w, or s*vv < -w, or s*(uu+vv) > a + w, or !(a > 1e-12), or
//     s*tt > a*hi, or s*tt < a*lo,
//   hi = U + |U|*2^-16 + 2^-60 (U = best t; any hit min(best, tmax)) and
//   lo = tmin - |tmin|*2^-16 - 2^-60. Only the pairs it passes take the
//   exact path: 1/det, t, u, v and the same compares in the same order, so
//   every kept (t, id, u, v) is bit-exact. Why the test rejects no pair
//   that the exact path accepts: with a > 1e-12, inv = 1/det is finite,
//   nonzero and within 2^-22 of 1/det, so u = RN(uu*inv) >= -0 needs
//   s*uu >= -2^-150*a*(1+2^-21) > -w; RN(u+v) <= 1 needs
//   u+v <= 1+2^-24, hence s*(uu+vv) <= a*(1+2^-21) < a+w (a*2^-16 is
//   exact, RN is monotone); and t = RN(tt*inv) <= U needs
//   s*tt <= a*(U + |U|*2^-20.4 + 2^-149), which RN(a*hi) exceeds because
//   a*2^-60 > 2^-150 + a*2^-149 (the denormal rounding of the product and
//   of t) for every a > 1e-12; likewise for tmin. A product that
//   overflows to +-inf errs only on the accepting side: s*tt is then
//   beyond every finite t, and the exact path rejects t = +-inf. NaNs
//   fail both tests. tests/test_torch_sweep_design.py holds a plain model
//   of the test against the exact path on adversarial pairs.
// - Ids stay float values (exact below 2^24, the seed's -1 included),
//   compared as floats and converted once, at the flush.
// - Staging is asynchronous: bulk copies into a four-piece ring on
//   mbarriers (sweep_shell.cuh), at most one barrier a piece.
// - Ties: a hit wins on smaller t, or on equal t with a smaller id; the
//   seed carries id -1 and never loses a tie (the oracle's and _merge's
//   rule).
//
// What bounds it on this card: the instruction issue rate. In the SASS a
// pair costs about 54 instructions outside the exact path: the 33 of the
// four linear forms (no FMA), 15 of the test (3 sign flips, 4 products,
// 2 adds, 6 compares), 2 shared loads and 3 for the branch around the
// exact path (about 75 with the division on every pair). The exact path
// runs for the few pairs the test passes, but for a whole warp when any
// of its lanes passes. Memory is not the limit: a block's 64 KB of
// coefficients is read from device memory once per chunk and reused by
// all rays of the tile from shared memory, where every thread reads the
// same address (a broadcast).

#include <cuda_runtime.h>

#include "sweep_shell.cuh"

namespace {

using sweep_shell::kBig;
using sweep_shell::RayState;

constexpr float kSlack = 1.52587890625e-05f;  // 2^-16
constexpr float kTiny = 8.673617379884035e-19f;  // 2^-60

// Ref coefficients, as four float4 of one 20-float ref row:
// q0 = [n0 n1 n2 b0], q1 = [b1 b2 c0 c1], q2 = [c2 d0 d1 d2],
// q3 = [e0 e1 e2 f]; the id rides as a float value in q4.x.
template <bool kAnyHit>
struct HitBody {
  static __device__ __forceinline__ void bounds(RayState& r) {
    const float u = kAnyHit ? fminf(r.bt, r.tmax) : r.bt;
    r.hi = u + (fabsf(u) * kSlack + kTiny);
    r.lo = r.tmin - (fabsf(r.tmin) * kSlack + kTiny);
  }

  // The exact test of a pair the filter passed: the division, the three
  // scalings and the compares of the plain version, in its order.
  static __device__ __forceinline__ void exact(RayState& r, float det,
                                            float tt, float uu, float vv,
                                            const float4* q) {
    const float inv = 1.0f / det;
    const float t = tt * inv;
    const float u = uu * inv;
    const float v = vv * inv;
    // min(u, v, 1-(u+v)) >= 0 with NaN-propagating min == all three >= 0.
    bool ok = (u >= 0.0f) & (v >= 0.0f) & (1.0f - (u + v) >= 0.0f)
            & (fabsf(det) > 1e-12f) & (t > r.tmin);
    if (kAnyHit) ok &= t < r.tmax;
    const float id = q[4].x;
    const bool better = ok & ((t < r.bt) |
                              ((t == r.bt) & (r.bid >= 0.0f) & (id < r.bid)));
    if (better) {
      r.bt = t;
      r.bid = id;
      r.bu = u;
      r.bv = v;
      bounds(r);
    }
  }

  static __device__ __forceinline__ void test(RayState& r, const float4 q0,
                                              const float4 q1,
                                              const float4 q2,
                                              const float4 q3,
                                              const float4* q) {
    const float det = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
    const float tt = q3.w - (r.ox * q0.x + r.oy * q0.y + r.oz * q0.z);
    const float uu = r.mx * q0.w + r.my * q1.x + r.mz * q1.y
                   + r.dx * q1.z + r.dy * q1.w + r.dz * q2.x;
    const float vv = r.mx * q2.y + r.my * q2.z + r.mz * q2.w
                   + r.dx * q3.x + r.dy * q3.y + r.dz * q3.z;
    const float a = fabsf(det);
    const unsigned sgn = __float_as_uint(det) & 0x80000000u;
    const float ts = __uint_as_float(__float_as_uint(tt) ^ sgn);
    const float us = __uint_as_float(__float_as_uint(uu) ^ sgn);
    const float vs = __uint_as_float(__float_as_uint(vv) ^ sgn);
    const float w = a * kSlack;
    const bool pass = (us >= -w) & (vs >= -w) & (us + vs <= a + w)
                    & (a > 1e-12f) & (ts <= a * r.hi) & (ts >= a * r.lo);
    if (pass) exact(r, det, tt, uu, vv, q);
  }

  static __device__ __forceinline__ void flush(const RayState& r, float& t,
                                               int& id, float& u, float& v) {
    const bool found = r.bid >= 0.0f;
    t = found ? r.bt : kBig;
    id = found ? (int)r.bid : -1;
    u = found ? r.bu : 0.0f;
    v = found ? r.bv : 0.0f;
  }
};

}  // namespace

// C entry point (loaded with ctypes). any_hit != 0 launches the any-hit
// instance. tile_of: i32[n_blocks], ascending; chunk: C; n_rows = nt +
// ceil(n_blocks / C); plan: i32[4 * n_rows + 2 * nt + 1] scratch;
// partial: i32[n_rows, tile, 4] scratch; skipped: i32[nt] (may be null)
// receives the count of skipped blocks per tile. The outputs need no
// initial values: every ray is written. Launches the plan, the sweep and
// the resolve pass on `stream`, does not synchronise, returns the first
// non-zero cudaGetLastError() of the three launches.
extern "C" int hagrid_sweep(const float* xt, int n_cols, const float* cols,
                            const int* gidx, const int* tile_of,
                            int n_blocks, const int* tminb, float* out_t,
                            int* out_id, float* out_u, float* out_v, int nt,
                            int tile, int chunk, int n_rows, int any_hit,
                            int* skipped, int* plan, int* partial,
                            void* stream) {
  const sweep_shell::Params p{
      xt, n_cols, reinterpret_cast<const float4*>(cols), gidx, nullptr,
      tminb, out_t, out_id, out_u, out_v, tile, skipped,
      reinterpret_cast<int4*>(partial)};
  const sweep_shell::Plan q{tile_of, n_blocks, nt, chunk, n_rows, plan};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(any_hit ? sweep_shell::launch<HitBody<true>, true>(p, q, s)
                       : sweep_shell::launch<HitBody<false>, false>(p, q, s));
}

// The plan alone (the first of hagrid_sweep's launches), for checking it:
// the arguments of the same names.
extern "C" int hagrid_sweep_plan(const int* tile_of, int n_blocks, int nt,
                                 int chunk, int n_rows, int* plan,
                                 void* stream) {
  const sweep_shell::Plan q{tile_of, n_blocks, nt, chunk, n_rows, plan};
  if (!sweep_shell::plan_ok(q)) return (int)cudaErrorInvalidValue;
  return (int)sweep_shell::launch_plan(q, (cudaStream_t)stream);
}

// Resident CTAs per SM of the instance that hagrid_sweep launches for
// (any_hit, tile), from the CUDA occupancy calculator.
extern "C" int hagrid_sweep_occupancy(int any_hit, int tile,
                                      int* blocks_per_sm) {
  if (!sweep_shell::launch_ok(tile)) return (int)cudaErrorInvalidValue;
  return (int)(any_hit
      ? sweep_shell::occupancy<HitBody<true>, true>(tile, blocks_per_sm)
      : sweep_shell::occupancy<HitBody<false>, false>(tile, blocks_per_sm));
}

extern "C" const char* hagrid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
