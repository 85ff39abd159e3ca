// Wavefront march kernel for Hopper (sm_90a): one launch marches every ray
// of a trace from its slab test to its end.
//
// Replaces the reference's compacted round loop, hagrid_tpu/ops/
// wavefront.py:350-418 (`trace`): `_jit_init`, rounds of `_jit_segment`
// (:290-311, an XLA `while_loop` of `cap` lockstep iterations of
// `_make_body`; no Pallas kernel), `_jit_scatter` and `_jit_compact`. The
// rounds exist because the TPU marches a batch in lockstep, so one long
// ray holds the whole batch. On the card a ray's update reads only that
// ray's state and a dead ray is a fixed point of the body, so one thread
// marches a ray from its start to its end without stopping, and the round
// schedule changes nothing but the `rounds` statistic. The plain version
// is ops/wavefront.py::trace_plain (the round loop of `segment_plain`);
// on every ray that neither version truncates, this kernel gives the same
// tri id, the same bits of t, u and v and the same step count (the library
// is built with -fmad=false, and every expression below keeps
// `_init_state`'s and `_make_body`'s operation order, each product and sum
// rounded on its own).
//
// Safety cap: each ray marches at most `hard_cap` iterations, computed here
// with max_march_iters's formula from the largest cell's ref count (a
// device scalar, so the caller reads nothing before the launch). The
// reference's rounds give a ray still marching at least `hard_cap`
// iterations (the last round alone runs `hard_cap`), so the kernel's count
// of truncated rays is >= the plain version's; both are 0 at full size.
//
// Three lookups (kMode), each closest hit and any hit:
// - kQuad: the irregular grid's packed tables: top_info (offset << 3 |
//   res_log) and the 8-int erec row [cmin, cmax, start, end] per cell
//   fetch, one 48-float row of `ref_tris` for 4 refs per test iteration
//   (rows % 4 == 0);
// - kRows: the same lookup, `refs_per_iter` 12-float rows per iteration;
// - kUniform: cell = linear_cell(voxel), cmin = cmax = voxel,
//   `cell_starts`, `ref_ids` and the triangles' v0/e1/e2 rows.
//
// What bounds it: dependent gathers. Every step reads a row whose address
// comes from the row before (top_info -> erec -> ref rows), the rays of a
// warp scatter over the tables, and the arithmetic per gathered row is a
// few dozen FP32 operations: latency-bound, far from both the FP32 and the
// byte bound. What the design does about that:
// - No state traffic: a thread reads its ray (32 bytes) and writes its
//   hit and steps (20 bytes); the march state stays in registers from the
//   slab test to the end. No rounds: no compaction, no scatter, no host
//   read of a live count; one launch a trace.
// - Persistent warps that refill dead lanes (Aila and Laine, HPG 2009):
//   the grid is as large as the card holds at once (occupancy), a warp
//   starts with 32 consecutive rays and, once fewer than `refill` of its
//   lanes are marching, its empty lanes take the next indices of a global
//   ray counter with one warp-aggregated atomicAdd. Every lane stays in the
//   loop until the counter runs out, so the full-mask votes stay legal.
// - Registers: the state in scalars (no arrays passed by pointer, so no
//   stack frame), the grid geometry in shared memory, and launch bounds
//   that fit kMinBlocks blocks of kThreads an SM; the tables are read
//   through the read-only path (__ldg, 16-byte loads of erec and ref rows).
//
// Gather semantics are jnp's (ops/segment.py::take): a negative index
// counts from the end once, the rest is clamped. Casts are XLA's
// (ops/segment.py::trunc_i32: NaN -> 0, saturating at +-2^30); max and min
// propagate NaN as torch.maximum / torch.minimum do.

#include <cuda_runtime.h>

#include <cstdint>

// Mirrored by ops/wavefront.py::_MarchArgs (ctypes): keep the order.
// Outside the anonymous namespace: the C entry point below takes it, and a
// type with internal linkage would give that entry point internal linkage.
struct MarchArgs {
  int n, refs_per_iter, no_tris, refill;
  int dims[3];
  int cap_base;  // 8 * (dims[0] + dims[1] + dims[2]) + 256
  const float* bbox_lo;
  const float* bbox_hi;
  const int* max_cell_refs;  // device scalar: the largest cell's refs
  // Packed irregular tables.
  const int* top_info;
  int n_top, n_erec, n_ref_rows, levels;
  int top_dims[3];
  int pad0_;
  const int* erec;
  const float* ref_tris;
  // Uniform tables.
  const int* cell_starts;
  const int* ref_ids;
  const float* v0;
  const float* e1;
  const float* e2;
  int n_starts, n_ref_ids, n_tris, pad1_;
  // Rays.
  const float* org;
  const float* dir;
  const float* tmin;
  const float* tmax;
  // Hits and steps, one slot a ray.
  float* t;
  int* id;
  float* u;
  float* v;
  int* steps;
  // Four zeroed u64: the ray counter, the rays the cap cut, the step
  // total and (written here) hard_cap. work: null, or five zeroed u64
  // (refs tested, rows gathered, cell exits computed, cells fetched,
  // warp iterations).
  unsigned long long* stats;
  unsigned long long* work;
};

namespace {

constexpr int kQuad = 0;
constexpr int kRows = 1;
constexpr int kUniform = 2;
// Launch bounds: 128 threads, 8 blocks an SM (at most 64 registers, 32
// warps an SM), chosen on the card among (128, 4/6/8/10), (256, 4) and
// (64, 16): PERF.md.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ int take_idx(int i, int n) {
  long long j = i < 0 ? (long long)i + n : (long long)i;
  return (int)(j < 0 ? 0 : (j > n - 1 ? n - 1 : j));
}

__device__ __forceinline__ int trunc_i32(float x) {
  if (x != x) return 0;
  x = fminf(fmaxf(x, -1073741824.0f), 1073741824.0f);
  return (int)x;
}

// core/intersect.py::safe_inv_dir for one component: 1/d, zero -> +-inf.
__device__ __forceinline__ float safe_inv(float d) {
  return d != 0.0f ? 1.0f / d : copysignf(inf_f(), d);
}

// The grid's geometry: bbox_lo, cell size and its inverse (wavefront.py's
// _geometry), computed once a block.
struct Geo {
  float lo[3], cs[3], inv_cs[3], hi[3];
};

// One ray's march state.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax, t_cur;
  int cursor, end, x0, y0, z0, x1, y1, z1;  // [cursor, end), cmin, cmax
};

struct Best {
  float t, u, v;
  int id;
};

// core/intersect.py::moller_trumbore and wavefront.py's mt_update for one
// (ray, triangle) pair, the pair already masked in.
__device__ __forceinline__ void mt_update(
    const Ray& r, float v0x, float v0y, float v0z, float ax, float ay,
    float az, float bx, float by, float bz, int tid, Best& b) {
  const float px = r.dy * bz - r.dz * by;
  const float py = r.dz * bx - r.dx * bz;
  const float pz = r.dx * by - r.dy * bx;
  const float det = ax * px + ay * py + az * pz;
  const bool ok_det = fabsf(det) > 1e-9f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * az - tz * ay;
  const float qy = tz * ax - tx * az;
  const float qz = tx * ay - ty * ax;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (bx * qx + by * qy + bz * qz) * inv_det;
  const bool hit = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > r.tmin && t < r.tmax;
  if (hit && (t < b.t || (t == b.t && tid < b.id))) {
    b.t = t;
    b.u = u;
    b.v = v;
    b.id = tid;
  }
}

// One 12-float ref row [v0, e1, e2, id, pad, pad], 16-byte aligned.
__device__ __forceinline__ void test_row(const float* row, const Ray& r,
                                         Best& b) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(r4), c = __ldg(r4 + 1);
  const float2 e = __ldg(reinterpret_cast<const float2*>(row + 8));
  mt_update(r, a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, e.x, (int)e.y, b);
}

// wavefront.py::_load_cell for an in-bounds voxel: sets the ray's cell
// bbox and ref range.
template <int kMode>
__device__ __forceinline__ void load_cell(const MarchArgs& a, int x, int y,
                                          int z, Ray& r) {
  if (kMode == kUniform) {
    const int cell = (z * a.dims[1] + y) * a.dims[0] + x;
    r.cursor = __ldg(a.cell_starts + take_idx(cell, a.n_starts));
    r.end = __ldg(a.cell_starts + take_idx(cell + 1, a.n_starts));
    r.x0 = r.x1 = x;
    r.y0 = r.y1 = y;
    r.z0 = r.z1 = z;
    return;
  }
  const int lv = a.levels;
  const int tidx =
      ((z >> lv) * a.top_dims[1] + (y >> lv)) * a.top_dims[0] + (x >> lv);
  const int info = __ldg(a.top_info + take_idx(tidx, a.n_top));
  const int res = info & 7;
  const int off = info >> 3;
  const int mask = (1 << lv) - 1;
  const int lx = (x & mask) >> (lv - res);
  const int ly = (y & mask) >> (lv - res);
  const int lz = (z & mask) >> (lv - res);
  const int side = 1 << res;
  const int sub = (lz * side + ly) * side + lx;
  const int4* rec = reinterpret_cast<const int4*>(
      a.erec + 8 * (long long)take_idx(off + sub, a.n_erec));
  const int4 lo4 = __ldg(rec), hi4 = __ldg(rec + 1);
  r.x0 = lo4.x; r.y0 = lo4.y; r.z0 = lo4.z;
  r.x1 = lo4.w; r.y1 = hi4.x; r.z1 = hi4.y;
  r.cursor = hi4.z;
  r.end = hi4.w;
}

// wavefront.py::_init_state for ray i: safe_inv_dir, slab_test, the entry
// point, the first voxel (divided by the cell size, as _init_state does)
// and its cell. Returns whether the ray starts alive.
template <int kMode>
__device__ __forceinline__ bool init_ray(const MarchArgs& a, const Geo& g,
                                         int i, Ray& r) {
  r.ox = a.org[3 * i];
  r.oy = a.org[3 * i + 1];
  r.oz = a.org[3 * i + 2];
  r.dx = a.dir[3 * i];
  r.dy = a.dir[3 * i + 1];
  r.dz = a.dir[3 * i + 2];
  r.tmin = a.tmin[i];
  r.tmax = a.tmax[i];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  // core/intersect.py::slab_test: an axis whose t0 * t1 is NaN (the
  // origin on a slab plane of a zero direction) always overlaps.
  float tnear[3], tfar[3];
  const float o[3] = {r.ox, r.oy, r.oz}, inv[3] = {r.ix, r.iy, r.iz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (g.lo[k] - o[k]) * inv[k];
    const float t1 = (g.hi[k] - o[k]) * inv[k];
    const bool on_plane = isnan(t0 * t1);
    tnear[k] = on_plane ? -inf_f() : min_nan(t0, t1);
    tfar[k] = on_plane ? inf_f() : max_nan(t0, t1);
  }
  const float enter =
      max_nan(max_nan(max_nan(tnear[0], tnear[1]), tnear[2]), r.tmin);
  const float exit_ =
      min_nan(min_nan(min_nan(tfar[0], tfar[1]), tfar[2]), r.tmax);
  if (!(enter <= exit_)) return false;
  const int x = min(max(trunc_i32(floorf((r.ox + enter * r.dx - g.lo[0]) /
                                         g.cs[0])), 0), a.dims[0] - 1);
  const int y = min(max(trunc_i32(floorf((r.oy + enter * r.dy - g.lo[1]) /
                                         g.cs[1])), 0), a.dims[1] - 1);
  const int z = min(max(trunc_i32(floorf((r.oz + enter * r.dz - g.lo[2]) /
                                         g.cs[2])), 0), a.dims[2] - 1);
  load_cell<kMode>(a, x, y, z, r);
  r.t_cur = max_nan(enter, r.tmin);
  return true;
}

// One exit plane's t if it lies ahead of t_cur (else inf): wavefront.py's
// t_axes / t_ahead for one axis.
__device__ __forceinline__ float t_ahead(float lo, float cs, int c0, int c1,
                                         float o, float d, float inv_d,
                                         float t_cur) {
  const float plane = d >= 0.0f ? lo + (float)(c1 + 1) * cs
                                : lo + (float)c0 * cs;
  const float ta = d != 0.0f ? (plane - o) * inv_d : inf_f();
  return ta > t_cur ? ta : inf_f();
}

// The next voxel on one axis: past the cell bbox on the exit axis, else
// the ray point at t_step clamped into the bbox (or, with no plane ahead,
// the true voxel).
__device__ __forceinline__ int next_vox(float lo, float inv_cs, int c0,
                                        int c1, float o, float d,
                                        float t_step, bool exit_axis,
                                        bool has_ahead) {
  const int vt = trunc_i32(floorf((o + t_step * d - lo) * inv_cs));
  int v = min(max(vt, c0), c1);
  if (exit_axis) v = d >= 0.0f ? c1 + 1 : c0 - 1;
  return has_ahead ? v : vt;
}

struct Work {
  unsigned tests, rows, exits, loads, warp_iters;
};

// One iteration of wavefront.py's body for a live ray: a chunk of
// Moller-Trumbore tests, or, its cell exhausted, a step past the cell's
// bbox and the next cell's fetch. Returns whether the ray is still alive.
template <int kMode, bool kAnyHit, bool kWork>
__device__ __forceinline__ bool march_step(const MarchArgs& a, const Geo& g,
                                           Ray& r, Best& b, Work& w) {
  // Phase 1: a chunk of Moller-Trumbore tests.
  if (!a.no_tris) {
    if (kMode == kQuad) {
      const int nq = a.n_ref_rows >> 2;
      const int qidx = min(r.cursor >> 2, nq - 1);
      const int base = qidx << 2;
      const float* qrow = a.ref_tris + 48 * (long long)take_idx(qidx, nq);
      bool any = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ridx = base + k;
        if (ridx >= r.cursor && ridx < r.end) {
          test_row(qrow + 12 * k, r, b);
          any = true;
          if (kWork) ++w.tests;
        }
      }
      if (kWork) w.rows += any;
      r.cursor = min(base + 4, r.end);
    } else {
      for (int k = 0; k < a.refs_per_iter; ++k) {
        const int ref = r.cursor + k;
        if (ref < r.end) {
          if (kWork) {
            ++w.tests;
            ++w.rows;
          }
          if (kMode == kRows) {
            test_row(a.ref_tris + 12 * (long long)take_idx(ref, a.n_ref_rows),
                     r, b);
          } else {
            const int tid = __ldg(a.ref_ids + take_idx(ref, a.n_ref_ids));
            const long long t3 = 3 * (long long)take_idx(tid, a.n_tris);
            mt_update(r, __ldg(a.v0 + t3), __ldg(a.v0 + t3 + 1),
                      __ldg(a.v0 + t3 + 2), __ldg(a.e1 + t3),
                      __ldg(a.e1 + t3 + 1), __ldg(a.e1 + t3 + 2),
                      __ldg(a.e2 + t3), __ldg(a.e2 + t3 + 1),
                      __ldg(a.e2 + t3 + 2), tid, b);
          }
        }
      }
      r.cursor = min(r.cursor + a.refs_per_iter, r.end);
    }
  }
  if (r.cursor < r.end) return true;

  // Phase 2: the cell is exhausted; step past its bbox.
  if (kWork) ++w.exits;
  const float tx = t_ahead(g.lo[0], g.cs[0], r.x0, r.x1, r.ox, r.dx, r.ix,
                           r.t_cur);
  const float ty = t_ahead(g.lo[1], g.cs[1], r.y0, r.y1, r.oy, r.dy, r.iy,
                           r.t_cur);
  const float tz = t_ahead(g.lo[2], g.cs[2], r.z0, r.z1, r.oz, r.dz, r.iz,
                           r.t_cur);
  // argmin, first index on ties.
  int axis = 0;
  float t_exit = tx;
  if (ty < t_exit) { t_exit = ty; axis = 1; }
  if (tz < t_exit) { t_exit = tz; axis = 2; }
  const bool has_ahead = isfinite(t_exit);
  const float t_step = has_ahead ? t_exit : r.t_cur * 1.000001f + 1e-5f;
  const bool terminated =
      (kAnyHit ? b.id >= 0 : b.t <= t_step) || t_step >= r.tmax;
  const int x = next_vox(g.lo[0], g.inv_cs[0], r.x0, r.x1, r.ox, r.dx,
                         t_step, axis == 0, has_ahead);
  const int y = next_vox(g.lo[1], g.inv_cs[1], r.y0, r.y1, r.oy, r.dy,
                         t_step, axis == 1, has_ahead);
  const int z = next_vox(g.lo[2], g.inv_cs[2], r.z0, r.z1, r.oz, r.dz,
                         t_step, axis == 2, has_ahead);
  const bool in_bounds = x >= 0 && x < a.dims[0] && y >= 0 &&
                         y < a.dims[1] && z >= 0 && z < a.dims[2];
  if (terminated || !in_bounds) return false;
  if (kWork) ++w.loads;
  load_cell<kMode>(a, x, y, z, r);
  r.t_cur = t_step;
  return true;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

template <int kMode, bool kAnyHit, bool kWork>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    march_kernel(const MarchArgs a, int total_warps) {
  __shared__ float geo[12];
  if (threadIdx.x < 3) {
    const int k = threadIdx.x;
    const float lo = a.bbox_lo[k], hi = a.bbox_hi[k];
    const float cs = (hi - lo) / (float)a.dims[k];
    geo[k] = lo;
    geo[3 + k] = cs;
    geo[6 + k] = 1.0f / cs;
    geo[9 + k] = hi;
  }
  __syncthreads();
  Geo g;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.lo[k] = geo[k];
    g.cs[k] = geo[3 + k];
    g.inv_cs[k] = geo[6 + k];
    g.hi[k] = geo[9 + k];
  }
  // max_march_iters(fine_dims, max cell refs, refs_per_iter).
  const int hard_cap = a.cap_base + 8 * (*a.max_cell_refs /
                                         max(a.refs_per_iter, 1));
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp == 0 && lane == 0) a.stats[3] = (unsigned long long)hard_cap;
  const unsigned below = (1u << lane) - 1u;

  Ray r;
  Best b;
  Work w{0, 0, 0, 0, 0};
  int i = 0, steps = 0;
  bool has = false;
  unsigned truncated = 0;
  unsigned long long step_total = 0;

  // A ray's end: its hit and steps into its slot.
  auto finish = [&]() {
    a.t[i] = b.id >= 0 ? b.t : inf_f();
    a.id[i] = b.id;
    a.u[i] = b.u;
    a.v[i] = b.v;
    a.steps[i] = steps;
    step_total += steps;
    has = false;
  };
  // Lane takes ray j: its start, or (dead at its start) its empty hit.
  auto take = [&](int j) {
    i = j;
    steps = 0;
    b = Best{inf_f(), 0.0f, 0.0f, -1};
    has = true;
    if (!init_ray<kMode>(a, g, j, r)) finish();
  };

  // The first 32 consecutive rays of each warp, then the counter's.
  const long long first = 32LL * warp + lane;
  if (first < a.n) take((int)first);
  const long long start = 32LL * total_warps;
  bool drained = start >= a.n;  // warp-uniform
  for (;;) {
    unsigned live = __ballot_sync(kFull, has);
    if (!drained && __popc(live) < a.refill) {
      // Refill the empty lanes until each has a live ray or the counter
      // runs out (a ray dead at its start leaves its lane empty).
      for (unsigned need = ~live; need && !drained;
           need = ~__ballot_sync(kFull, has)) {
        const int k = __popc(need);
        unsigned long long got = 0;
        if (lane == 0) got = atomicAdd(a.stats, (unsigned long long)k);
        const long long base =
            start + (long long)__shfl_sync(kFull, got, 0);
        drained = base + k >= a.n;
        if (need >> lane & 1u) {
          const long long j = base + __popc(need & below);
          if (j < a.n) take((int)j);
        }
      }
      live = __ballot_sync(kFull, has);
    }
    if (!live) break;  // the counter ran out and every lane is done
    if (kWork && lane == 0) ++w.warp_iters;
    if (has) {
      ++steps;
      const bool alive = march_step<kMode, kAnyHit, kWork>(a, g, r, b, w);
      if (alive && steps >= hard_cap) ++truncated;
      if (!alive || steps >= hard_cap) finish();
    }
  }

  // One atomic a warp for each counter.
  const unsigned long long tot_trunc = warp_sum(truncated);
  const unsigned long long tot_steps = warp_sum(step_total);
  if (lane == 0) {
    if (tot_trunc) atomicAdd(a.stats + 1, tot_trunc);
    atomicAdd(a.stats + 2, tot_steps);
  }
  if (kWork) {
    const unsigned long long s[5] = {warp_sum(w.tests), warp_sum(w.rows),
                                     warp_sum(w.exits), warp_sum(w.loads),
                                     warp_sum(w.warp_iters)};
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 5; ++k) atomicAdd(a.work + k, s[k]);
    }
  }
}

template <int kMode, bool kAnyHit, bool kWork>
cudaError_t grid_of(int n, int* blocks_per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, march_kernel<kMode, kAnyHit, kWork>, kThreads, 0);
  if (err) return err;
  const long long need = ((long long)n + kThreads - 1) / kThreads;
  const long long full = (long long)*blocks_per_sm * sms;
  *blocks = (int)(need < full ? need : full);
  return cudaSuccess;
}

template <int kMode, bool kAnyHit, bool kWork>
cudaError_t launch(const MarchArgs& a, cudaStream_t s, int* grid) {
  int per_sm = 0, blocks = 0;
  cudaError_t err = grid_of<kMode, kAnyHit, kWork>(a.n, &per_sm, &blocks);
  if (err) return err;
  if (grid) {
    grid[0] = per_sm;
    grid[1] = blocks;
  }
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  march_kernel<kMode, kAnyHit, kWork>
      <<<blocks, kThreads, 0, s>>>(a, blocks * kWarps);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const MarchArgs& a, int any_hit, cudaStream_t s,
                        int* grid) {
  const bool work = a.work != nullptr;
  if (any_hit)
    return work ? launch<kMode, true, true>(a, s, grid)
                : launch<kMode, true, false>(a, s, grid);
  return work ? launch<kMode, false, true>(a, s, grid)
              : launch<kMode, false, false>(a, s, grid);
}

}  // namespace

// One march of `args->n` rays to their ends; mode 0 quad rows, 1 per-row
// packed, 2 uniform. grid: null, or two ints that receive the blocks an SM
// (occupancy) and the blocks launched. Returns the launch's CUDA error.
extern "C" int hagrid_wavefront_march(const MarchArgs* args, int mode,
                                      int any_hit, void* stream, int* grid) {
  const MarchArgs& a = *args;
  if (a.n <= 0 || a.refill < 1 || a.refill > 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kQuad: return (int)launch_mode<kQuad>(a, any_hit, s, grid);
    case kRows: return (int)launch_mode<kRows>(a, any_hit, s, grid);
    case kUniform: return (int)launch_mode<kUniform>(a, any_hit, s, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}
