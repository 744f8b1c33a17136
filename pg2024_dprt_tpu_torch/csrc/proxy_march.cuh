// Device functions of the proxy-AABB march, shared by the march kernel
// (proxy_march.cu: K4 proxy_march) and the fused route kernel (route.cu: K7
// route), so that the fused and the composed routing stage march with
// identical arithmetic.
//
// What they compute, per ray (render/proxy_stages.py, ops/march.py
// march_proxies_plain): the slab test of every allowed proxy box with the
// guarded reciprocal direction, then up to max_hits selections front to
// back. A candidate of a box is its entry distance when the segment start
// (t_lo + eps) is outside the box, else its exit distance, flagged inside;
// it must lie in (t_lo + eps, t_cap). The step's hit is the lexicographic
// minimum of (t, row). An inside hit of a row already recorded advances the
// march without a record. A record carries the nets' features: the hit point
// normalized to the box (to the object-space box when the table is
// instanced), and phi / 2pi, theta / pi of the direction (object space when
// instanced; negated on an inside hit), theta = acos(y), phi = atan2(z, x)
// wrapped to [0, 2pi).
//
// Rows that are not allowed (the caller's own partition; empty partitions,
// which carry inverted infinite boxes and max_length 0) are skipped before
// any arithmetic touches them. The slab distances are recomputed at every
// step from the P boxes instead of being kept in a per-thread array: P is at
// most 32 and a slab test is some 20 operations.
//
// Everything must be compiled with --fmad=false, so that the distances and
// features round like the plain version's.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace march {

constexpr float kF32Max = 3.402823466e38f;
constexpr int kMaxRows = 32;  // the dedup mask has 32 bits

// The proxy table (layouts: scene/geometry.py ProxyTable). The instancing
// pointers are null for a plain table.
struct Table {
  const float* __restrict__ bmin;        // (P, 3)
  const float* __restrict__ bmax;        // (P, 3)
  const float* __restrict__ max_length;  // (P,)
  const int32_t* __restrict__ node;      // (P,) owning partition of the row
  const int32_t* __restrict__ obj;       // (P,) net of the row
  const float* __restrict__ xf;          // (P, 3, 4) world -> object, or null
  const float* __restrict__ omin;        // (P, 3) object-space box min, or null
  const float* __restrict__ ospan;       // (P, 3) object-space box extent, or null
  int p;
  int my_node;
};

// One recorded hit.
struct Record {
  float feat[5];
  int32_t row;   // proxy row, -1 = no record
  bool inside;
  float t;
  float ratio;   // world-t / object-t scale (1 unless instanced)
};

__device__ __forceinline__ float guarded_inv(float d) {
  const float g = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / g;
}

__device__ __forceinline__ bool row_allowed(const Table& tb, int r) {
  return tb.node[r] != tb.my_node && tb.max_length[r] > 0.0f;
}

// Features of a hit at distance t on row r.
__device__ __forceinline__ void featurize(const Table& tb, const float o[3],
                                          const float d[3], int r, float t,
                                          bool inside, Record& rec) {
  float point[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) point[ax] = o[ax] + t * d[ax];
  float fd[3];
  if (tb.xf != nullptr) {
    const float* m = tb.xf + 12 * r;
    float dl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float pl = m[4 * i] * point[0] + m[4 * i + 1] * point[1] +
                       m[4 * i + 2] * point[2] + m[4 * i + 3];
      dl[i] = m[4 * i] * d[0] + m[4 * i + 1] * d[1] + m[4 * i + 2] * d[2];
      rec.feat[i] = (pl - tb.omin[3 * r + i]) / fmaxf(tb.ospan[3 * r + i], 1e-12f);
    }
    const float len = sqrtf(dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]);
    rec.ratio = 1.0f / fmaxf(len, 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) fd[i] = inside ? -dl[i] : dl[i];
  } else {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float lo = tb.bmin[3 * r + ax];
      const float span = fmaxf(tb.bmax[3 * r + ax] - lo, 1e-12f);
      rec.feat[ax] = (point[ax] - lo) / span;
      fd[ax] = inside ? -d[ax] : d[ax];
    }
    rec.ratio = 1.0f;
  }
  const float len = fmaxf(sqrtf(fd[0] * fd[0] + fd[1] * fd[1] + fd[2] * fd[2]), 1e-8f);
  const float nx = fd[0] / len, ny = fd[1] / len, nz = fd[2] / len;
  const float theta = acosf(fminf(fmaxf(ny, -1.0f), 1.0f));
  float phi = atan2f(nz, nx);
  if (phi < 0.0f) phi = phi + 6.283185307179586f;
  rec.feat[3] = phi / 6.283185307179586f;
  rec.feat[4] = theta / 3.141592653589793f;
  rec.row = r;
  rec.inside = inside;
  rec.t = t;
}

// Marches one active ray; calls emit(slot, record) for each record in order
// of t (slot = 0, 1, ...) and returns the number of records (<= max_hits).
template <typename Emit>
__device__ __forceinline__ int march_ray(const Table& tb, const float o[3],
                                         const float d[3], float t_cap,
                                         int max_hits, float eps, Emit emit) {
  float inv[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) inv[ax] = guarded_inv(d[ax]);
  float t_lo = 0.0f;
  uint32_t seen = 0u;
  int slot = 0;
  // at most max_hits steps: a step either records or skips a duplicate
  for (int step = 0; step < max_hits && slot < max_hits; ++step) {
    const float lo = t_lo + eps;
    float best_t = kF32Max;
    int best = -1;
    bool best_inside = false;
    for (int r = 0; r < tb.p; ++r) {
      if (!row_allowed(tb, r)) continue;
      float te = -CUDART_INF_F, tx = CUDART_INF_F;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float t0 = (tb.bmin[3 * r + ax] - o[ax]) * inv[ax];
        const float t1 = (tb.bmax[3 * r + ax] - o[ax]) * inv[ax];
        te = fmaxf(te, fminf(t0, t1));
        tx = fminf(tx, fmaxf(t0, t1));
      }
      if (!(tx >= te)) continue;
      const bool inside = te <= lo;
      const float cand = inside ? tx : te;
      // rows ascend, so a strict < keeps the first row among equal t
      if (cand > lo && cand < t_cap && cand < best_t) {
        best_t = cand;
        best = r;
        best_inside = inside;
      }
    }
    if (best < 0) break;
    const bool dup = best_inside && ((seen >> best) & 1u);
    if (!dup) {
      Record rec;
      featurize(tb, o, d, best, best_t, best_inside, rec);
      emit(slot, rec);
      seen |= 1u << best;
      ++slot;
    }
    t_lo = best_t;
  }
  return slot;
}

}  // namespace march
