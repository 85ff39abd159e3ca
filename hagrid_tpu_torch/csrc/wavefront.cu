// Wavefront segment kernel for Hopper (sm_90a): up to `cap` march
// iterations of every ray of a batch, one thread per ray.
//
// Replaces hagrid_tpu/ops/wavefront.py:290-311, `_jit_segment`: an XLA
// `while_loop` of `cap` lockstep iterations of `_make_body` over the whole
// batch (no Pallas kernel). Each iteration a live ray either tests a chunk
// of its cell's refs (Moller-Trumbore) or, its cell exhausted, steps past
// the cell's integer bbox and fetches the next cell. A dead ray is a fixed
// point of the body and one ray's update never reads another's, so the
// lockstep loop equals running each ray alone for `cap` iterations or
// until it dies: one thread per ray is exact. The plain version is
// ops/wavefront.py::segment_plain; this kernel reproduces it bit for bit
// (the library is built with -fmad=false, and every expression below
// keeps _make_body's operation order, each product and sum rounded on its
// own).
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
// few dozen FP32 operations: latency-bound, far from both the FP32 and
// the byte bound. The design keeps what the eager loop paid for off the
// memory path: the ray's whole state stays in registers for all `cap`
// iterations (read once, written once, instead of every field streamed
// through HBM by ~466 torch kernels an iteration), the tables are read
// through the read-only path (__ldg, 16-byte loads of erec and ref rows),
// only the rows a ray really tests are gathered, and no shared memory is
// needed: rays share nothing.
//
// Gather semantics are jnp's (ops/segment.py::take): a negative index
// counts from the end once, the rest is clamped. Casts are XLA's
// (ops/segment.py::trunc_i32: NaN -> 0, saturating at +-2^30).

#include <cuda_runtime.h>

#include <cstdint>

// Mirrored by ops/wavefront.py::_SegArgs (ctypes): keep the order. Outside
// the anonymous namespace: the C entry point below takes it, and a type
// with internal linkage would give that entry point internal linkage too.
struct SegArgs {
  int n, cap, refs_per_iter, no_tris;
  int dims[3];
  const float* geom;  // lo[3], cell size[3], 1 / cell size[3]
  // Packed irregular tables.
  const int* top_info;
  int n_top, n_erec, n_ref_rows, levels;
  int top_dims[3];
  const int* erec;
  const float* ref_tris;
  // Uniform tables.
  const int* cell_starts;
  const int* ref_ids;
  const float* v0;
  const float* e1;
  const float* e2;
  int n_starts, n_ref_ids, n_tris, pad_;
  // State in.
  const uint8_t* alive;
  const int* cursor;
  const int* end;
  const int* cmin;
  const int* cmax;
  const float* t_cur;
  const float* org;
  const float* dir;
  const float* tmin;
  const float* tmax;
  const float* best_t;
  const int* best_id;
  const float* best_u;
  const float* best_v;
  const int* steps;
  // State out.
  uint8_t* alive_o;
  int* cursor_o;
  int* end_o;
  int* cmin_o;
  int* cmax_o;
  float* t_cur_o;
  float* best_t_o;
  int* best_id_o;
  float* best_u_o;
  float* best_v_o;
  int* steps_o;
  // Outputs: rays alive after the segment (one int, zeroed by the
  // caller), and optional work counters (null, or four zeroed u64: refs
  // tested, rows gathered, cell exits computed, cells fetched).
  int* live;
  unsigned long long* work;
};

namespace {

constexpr int kQuad = 0;
constexpr int kRows = 1;
constexpr int kUniform = 2;
constexpr int kThreads = 128;

__device__ __forceinline__ int take_idx(int i, int n) {
  long long j = i < 0 ? (long long)i + n : (long long)i;
  return (int)(j < 0 ? 0 : (j > n - 1 ? n - 1 : j));
}

__device__ __forceinline__ int trunc_i32(float x) {
  if (x != x) return 0;
  x = fminf(fmaxf(x, -1073741824.0f), 1073741824.0f);
  return (int)x;
}

struct Best {
  float t, u, v;
  int id;
};

// core/intersect.py::moller_trumbore and wavefront.py's mt_update for one
// (ray, triangle) pair, the pair already masked in.
__device__ __forceinline__ void mt_update(
    const float o[3], const float d[3], float v0x, float v0y, float v0z,
    float ax, float ay, float az, float bx, float by, float bz, int tid,
    float tmin, float tmax, Best& b) {
  const float px = d[1] * bz - d[2] * by;
  const float py = d[2] * bx - d[0] * bz;
  const float pz = d[0] * by - d[1] * bx;
  const float det = ax * px + ay * py + az * pz;
  const bool ok_det = fabsf(det) > 1e-9f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = o[0] - v0x, ty = o[1] - v0y, tz = o[2] - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * az - tz * ay;
  const float qy = tz * ax - tx * az;
  const float qz = tx * ay - ty * ax;
  const float v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  const float t = (bx * qx + by * qy + bz * qz) * inv_det;
  const bool hit = ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > tmin && t < tmax;
  if (hit && (t < b.t || (t == b.t && tid < b.id))) {
    b.t = t;
    b.u = u;
    b.v = v;
    b.id = tid;
  }
}

// One 12-float ref row [v0, e1, e2, id, pad], 16-byte aligned.
__device__ __forceinline__ void test_row(const float* row, const float o[3],
                                         const float d[3], float tmin,
                                         float tmax, Best& b) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(r4), c = __ldg(r4 + 1), e = __ldg(r4 + 2);
  mt_update(o, d, a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, e.x,
            (int)e.y, tmin, tmax, b);
}

// wavefront.py::_load_cell for an in-bounds voxel.
template <int kMode>
__device__ __forceinline__ void load_cell(const SegArgs& a, const int vox[3],
                                          int cmin[3], int cmax[3], int& s0,
                                          int& s1) {
  if (kMode == kUniform) {
    const int cell = (vox[2] * a.dims[1] + vox[1]) * a.dims[0] + vox[0];
    s0 = __ldg(a.cell_starts + take_idx(cell, a.n_starts));
    s1 = __ldg(a.cell_starts + take_idx(cell + 1, a.n_starts));
    for (int k = 0; k < 3; ++k) cmin[k] = cmax[k] = vox[k];
    return;
  }
  const int lv = a.levels;
  const int tidx = ((vox[2] >> lv) * a.top_dims[1] + (vox[1] >> lv)) *
                       a.top_dims[0] + (vox[0] >> lv);
  const int info = __ldg(a.top_info + take_idx(tidx, a.n_top));
  const int r = info & 7;
  const int off = info >> 3;
  const int mask = (1 << lv) - 1;
  const int lx = (vox[0] & mask) >> (lv - r);
  const int ly = (vox[1] & mask) >> (lv - r);
  const int lz = (vox[2] & mask) >> (lv - r);
  const int side = 1 << r;
  const int sub = (lz * side + ly) * side + lx;
  const int4* rec = reinterpret_cast<const int4*>(
      a.erec + 8 * (long long)take_idx(off + sub, a.n_erec));
  const int4 lo4 = __ldg(rec), hi4 = __ldg(rec + 1);
  cmin[0] = lo4.x; cmin[1] = lo4.y; cmin[2] = lo4.z;
  cmax[0] = lo4.w; cmax[1] = hi4.x; cmax[2] = hi4.y;
  s0 = hi4.z;
  s1 = hi4.w;
}

template <int kMode, bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const SegArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < a.n;
  bool alive = false;
  unsigned long long n_tests = 0, n_rows = 0, n_exits = 0, n_loads = 0;
  if (valid) {
    float o[3], d[3], inv_d[3], lo[3], cs[3], inv_cs[3];
    int cmin[3], cmax[3];
    for (int k = 0; k < 3; ++k) {
      o[k] = a.org[3 * i + k];
      d[k] = a.dir[3 * i + k];
      // core/intersect.py::safe_inv_dir: 1/d, a zero maps to +-inf.
      inv_d[k] = d[k] != 0.0f ? 1.0f / d[k]
                              : copysignf(__int_as_float(0x7f800000), d[k]);
      lo[k] = a.geom[k];
      cs[k] = a.geom[3 + k];
      inv_cs[k] = a.geom[6 + k];
      cmin[k] = a.cmin[3 * i + k];
      cmax[k] = a.cmax[3 * i + k];
    }
    const float tmin = a.tmin[i], tmax = a.tmax[i];
    alive = a.alive[i] != 0;
    int cursor = a.cursor[i], end = a.end[i], steps = a.steps[i];
    float t_cur = a.t_cur[i];
    Best b{a.best_t[i], a.best_u[i], a.best_v[i], a.best_id[i]};
    const float inf = __int_as_float(0x7f800000);

    int it = 0;
    for (; it < a.cap && alive; ++it) {
      ++steps;
      // Phase 1: a chunk of Moller-Trumbore tests.
      if (!a.no_tris) {
        if (kMode == kQuad) {
          const int nq = a.n_ref_rows >> 2;
          const int qidx = min(cursor >> 2, nq - 1);
          const int base = qidx << 2;
          const float* qrow = a.ref_tris + 48 * (long long)take_idx(qidx, nq);
          bool any = false;
          for (int k = 0; k < 4; ++k) {
            const int ridx = base + k;
            if (ridx >= cursor && ridx < end) {
              test_row(qrow + 12 * k, o, d, tmin, tmax, b);
              any = true;
              ++n_tests;
            }
          }
          n_rows += any;
          cursor = min(base + 4, end);
        } else {
          for (int k = 0; k < a.refs_per_iter; ++k) {
            const int r = cursor + k;
            if (r < end) {
              ++n_tests;
              ++n_rows;
              if (kMode == kRows) {
                test_row(a.ref_tris + 12 * (long long)take_idx(r, a.n_ref_rows),
                         o, d, tmin, tmax, b);
              } else {
                const int tid = __ldg(a.ref_ids + take_idx(r, a.n_ref_ids));
                const long long t3 = 3 * (long long)take_idx(tid, a.n_tris);
                mt_update(o, d, __ldg(a.v0 + t3), __ldg(a.v0 + t3 + 1),
                          __ldg(a.v0 + t3 + 2), __ldg(a.e1 + t3),
                          __ldg(a.e1 + t3 + 1), __ldg(a.e1 + t3 + 2),
                          __ldg(a.e2 + t3), __ldg(a.e2 + t3 + 1),
                          __ldg(a.e2 + t3 + 2), tid, tmin, tmax, b);
              }
            }
          }
          cursor = min(cursor + a.refs_per_iter, end);
        }
      }
      if (cursor < end) continue;

      // Phase 2: the cell is exhausted; step past its bbox.
      ++n_exits;
      float t_ahead[3];
      for (int k = 0; k < 3; ++k) {
        const float plane = d[k] >= 0.0f
                                ? lo[k] + (float)(cmax[k] + 1) * cs[k]
                                : lo[k] + (float)cmin[k] * cs[k];
        float ta = (plane - o[k]) * inv_d[k];
        if (!(d[k] != 0.0f)) ta = inf;
        t_ahead[k] = ta > t_cur ? ta : inf;
      }
      // argmin, first index on ties.
      int axis = 0;
      float t_exit = t_ahead[0];
      if (t_ahead[1] < t_exit) { t_exit = t_ahead[1]; axis = 1; }
      if (t_ahead[2] < t_exit) { t_exit = t_ahead[2]; axis = 2; }
      const bool has_ahead = isfinite(t_exit);
      const float t_step = has_ahead ? t_exit : t_cur * 1.000001f + 1e-5f;
      const bool terminated =
          (kAnyHit ? b.id >= 0 : b.t <= t_step) || t_step >= tmax;

      int vox[3];
      bool in_bounds = true;
      for (int k = 0; k < 3; ++k) {
        const float p = o[k] + t_step * d[k];
        const int vt = trunc_i32(floorf((p - lo[k]) * inv_cs[k]));
        int v = min(max(vt, cmin[k]), cmax[k]);
        if (k == axis) v = d[k] >= 0.0f ? cmax[k] + 1 : cmin[k] - 1;
        vox[k] = has_ahead ? v : vt;
        in_bounds = in_bounds && vox[k] >= 0 && vox[k] < a.dims[k];
      }
      if (terminated || !in_bounds) {
        alive = false;  // ends the loop after this iteration's ++it
        continue;
      }
      ++n_loads;
      load_cell<kMode>(a, vox, cmin, cmax, cursor, end);
      t_cur = t_step;
    }
    // The lockstep loop's per-row modes move every ray's cursor each
    // iteration, a dead one's too (toward its end): the iterations this
    // thread did not run.
    if (kMode != kQuad && !a.no_tris && it < a.cap) {
      const long long c =
          (long long)cursor + (long long)a.refs_per_iter * (a.cap - it);
      cursor = (int)(c < end ? c : end);
    }

    a.alive_o[i] = alive;
    a.cursor_o[i] = cursor;
    a.end_o[i] = end;
    for (int k = 0; k < 3; ++k) {
      a.cmin_o[3 * i + k] = cmin[k];
      a.cmax_o[3 * i + k] = cmax[k];
    }
    a.t_cur_o[i] = t_cur;
    a.best_t_o[i] = b.t;
    a.best_id_o[i] = b.id;
    a.best_u_o[i] = b.u;
    a.best_v_o[i] = b.v;
    a.steps_o[i] = steps;
  }

  // One atomic a warp for the live count (and the work counters).
  const unsigned live = __ballot_sync(0xffffffffu, valid && alive);
  const int lane = threadIdx.x & 31;
  if (lane == 0 && live) atomicAdd(a.live, __popc(live));
  if (a.work) {
    for (int off = 16; off > 0; off >>= 1) {
      n_tests += __shfl_down_sync(0xffffffffu, n_tests, off);
      n_rows += __shfl_down_sync(0xffffffffu, n_rows, off);
      n_exits += __shfl_down_sync(0xffffffffu, n_exits, off);
      n_loads += __shfl_down_sync(0xffffffffu, n_loads, off);
    }
    if (lane == 0) {
      atomicAdd(a.work, n_tests);
      atomicAdd(a.work + 1, n_rows);
      atomicAdd(a.work + 2, n_exits);
      atomicAdd(a.work + 3, n_loads);
    }
  }
}

template <int kMode>
cudaError_t launch(const SegArgs& a, int any_hit, cudaStream_t s) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (any_hit)
    segment_kernel<kMode, true><<<blocks, kThreads, 0, s>>>(a);
  else
    segment_kernel<kMode, false><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One segment of `args->cap` iterations on `args->n` rays; mode 0 quad
// rows, 1 per-row packed, 2 uniform. Returns the launch's CUDA error.
extern "C" int hagrid_wavefront_segment(const SegArgs* args, int mode,
                                        int any_hit, void* stream) {
  const SegArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kQuad: return (int)launch<kQuad>(a, any_hit, s);
    case kRows: return (int)launch<kRows>(a, any_hit, s);
    case kUniform: return (int)launch<kUniform>(a, any_hit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
