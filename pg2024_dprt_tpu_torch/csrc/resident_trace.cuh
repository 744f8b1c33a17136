// Device functions of the resident ray-triangle traversal, shared by the
// trace kernels (resident_trace.cu: K1 resident_closest, K2 resident_anyhit)
// and the whole-sample frame kernel (frame.cu: K3 frame_sample), so that the
// fused and the composed frame intersect with identical arithmetic — the
// counterpart of pallas_frame.py::_frame_kernel reusing pallas_resident's
// _recull_loop / _occl_recull_loop / _mt_body_t.
//
// What they compute, per ray:
//   * the scene-exit horizon cap of the ray's tmax (_load_ray_rows);
//   * the exact per-ray cluster slab test with its rounding guard
//     (_cluster_enters, exact mode);
//   * the triple-product Moller-Trumbore test and its acceptance rules
//     (_mt_body): det = -n.d, u = e2.m, v = -e1.m, t = n.s / det with
//     m = s x d, s = o - v0; accepted when |det| > 1e-12, the signed
//     barycentrics lie in the triangle, and tmin < t < capped tmax;
//   * closest hit: clusters visited front to back in order of (enter
//     distance, cluster), the next one selected by a fresh O(K) slab pass (no
//     per-ray list in memory), stopping when the next enter distance is
//     beyond the current best t (with the guard the TPU kernels use); the
//     winner is the lexicographic minimum of (t, slot), slot = cluster * C +
//     lane, so the result does not depend on visit order; then the exact
//     winner refinement with barycentric re-validation (_refine_winners and
//     the epilogue at pallas_resident.py:2400-2455);
//   * any-hit: entered clusters in index order, return at the first
//     accepted hit.
//
// Everything must be compiled with --fmad=false: contracted multiply-adds
// would round grazing and edge hits differently from the plain versions.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace resident {

constexpr float kF32Max = 3.402823466e38f;

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  float tmin;
  float tmax;  // capped at the scene exit
};

// The cluster tables of one scene (layouts: scene/geometry.py DeviceScene).
struct Tables {
  const float* __restrict__ boxes;      // (8, K)
  const float* __restrict__ table;      // (K, 16, C)
  const int32_t* __restrict__ tri_map;  // (K*C,) slot -> canonical id
  const int32_t* __restrict__ counts;   // (K,)
  const float* __restrict__ scene_aabb; // (2, 3)
  int nk;
  int c;
};

struct Hit {
  float t, u, v;
  int32_t tri;
  bool hit;
};

__device__ __forceinline__ float guarded_inv(float d) {
  const float g = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / g;
}

// Fills r.inv, r.tmin and r.tmax from r.o, r.d and the raw limits, capping
// tmax at the scene-AABB exit (so escaping rays end at the scene boundary).
__device__ __forceinline__ void cap_ray(Ray& r, float tmin, float tmax,
                                        const float* __restrict__ scene_aabb) {
  float ex = kF32Max;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    r.inv[ax] = guarded_inv(r.d[ax]);
    const float t0 = (scene_aabb[ax] - r.o[ax]) * r.inv[ax];
    const float t1 = (scene_aabb[3 + ax] - r.o[ax]) * r.inv[ax];
    ex = fminf(ex, fmaxf(t0, t1));
  }
  const float cap = fmaxf(ex, 0.0f) * 1.001f + 1e-4f;
  r.tmin = tmin;
  r.tmax = fminf(tmax, cap);
}

// Loads ray i of a wavefront and caps its tmax. Returns false for inactive
// rays.
__device__ __forceinline__ bool load_ray(
    int i, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, const float* __restrict__ scene_aabb,
    Ray& r) {
  if (!active[i]) return false;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    r.o[ax] = o[3 * i + ax];
    r.d[ax] = d[3 * i + ax];
  }
  cap_ray(r, tmin[i], tmax[i], scene_aabb);
  return true;
}

// Exact slab test of the ray against cluster k (boxes: (8, K) rows min xyz,
// max xyz, non-empty flag, pad). Returns the clamped enter distance, or +inf
// when the ray provably does not enter the cluster before its tmax.
__device__ __forceinline__ float cluster_enter(
    const Ray& r, const float* __restrict__ boxes, int k, int nk) {
  if (!(boxes[6 * nk + k] > 0.0f)) return CUDART_INF_F;
  float enter = 0.0f;
  float exit_ = CUDART_INF_F;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (boxes[ax * nk + k] - r.o[ax]) * r.inv[ax];
    const float t1 = (boxes[(3 + ax) * nk + k] - r.o[ax]) * r.inv[ax];
    enter = fmaxf(enter, fminf(t0, t1));
    exit_ = fminf(exit_, fmaxf(t0, t1));
  }
  const float exit_g = exit_ * 1.0000004f + 1e-7f;  // rounding guard
  const bool ok = enter <= exit_g && exit_g > 0.0f && enter < r.tmax;
  return ok ? fmaxf(enter, 0.0f) : CUDART_INF_F;
}

// Triple-product Moller-Trumbore against slot j of one cluster's (16, C)
// table slice. Writes t; returns the acceptance (without the tmax test).
__device__ __forceinline__ bool mt_test(const Ray& r,
                                        const float* __restrict__ tab,
                                        int c, int j, float& t) {
  const float v0x = __ldg(tab + 0 * c + j), v0y = __ldg(tab + 1 * c + j),
              v0z = __ldg(tab + 2 * c + j);
  const float e1x = __ldg(tab + 3 * c + j), e1y = __ldg(tab + 4 * c + j),
              e1z = __ldg(tab + 5 * c + j);
  const float e2x = __ldg(tab + 6 * c + j), e2y = __ldg(tab + 7 * c + j),
              e2z = __ldg(tab + 8 * c + j);
  const float nx = __ldg(tab + 9 * c + j), ny = __ldg(tab + 10 * c + j),
              nz = __ldg(tab + 11 * c + j);
  const float rdx = r.d[0], rdy = r.d[1], rdz = r.d[2];
  const float sx = r.o[0] - v0x, sy = r.o[1] - v0y, sz = r.o[2] - v0z;
  const float mx = sy * rdz - sz * rdy;
  const float my = sz * rdx - sx * rdz;
  const float mz = sx * rdy - sy * rdx;
  const float det = -(rdx * nx + rdy * ny + rdz * nz);
  const float u = e2x * mx + e2y * my + e2z * mz;
  const float v = -(e1x * mx + e1y * my + e1z * mz);
  const float t_raw = nx * sx + ny * sy + nz * sz;
  const float adet = fabsf(det);
  const bool ok = adet > 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  t = t_raw * inv_det;
  const float su = det < 0.0f ? -u : u;
  const float sv = det < 0.0f ? -v : v;
  return ok && su >= 0.0f && sv >= 0.0f && su + sv <= adet && t > r.tmin;
}

// Closest hit of a capped ray: front-to-back cluster visits, (t, slot)
// winner, exact refinement. A miss is t = F32_MAX, tri = -1.
__device__ __forceinline__ Hit closest_hit(const Ray& r, const Tables& s) {
  Hit res = {kF32Max, 0.0f, 0.0f, -1, false};
  const int nk = s.nk, c = s.c;
  float best_t = kF32Max;
  long long best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  for (;;) {
    // clusters entered beyond the horizon cannot hold a closer hit; the
    // guard keeps rounding from pruning a tie (pallas_resident rekeys)
    const float horizon =
        best_slot >= 0 ? best_t * (1.0f + 1e-4f) + 1e-7f : r.tmax;
    float next_en = CUDART_INF_F;
    int next_k = -1;
    for (int k = 0; k < nk; ++k) {
      const float en = cluster_enter(r, s.boxes, k, nk);
      if (!(en <= horizon)) continue;
      if (en < last_en || (en == last_en && k <= last_k)) continue;
      if (en < next_en || (en == next_en && k < next_k)) {
        next_en = en;
        next_k = k;
      }
    }
    if (next_k < 0) break;
    const float* tab = s.table + (size_t)next_k * 16 * c;
    const int cnt = s.counts[next_k];
    for (int j = 0; j < cnt; ++j) {
      float t;
      if (mt_test(r, tab, c, j, t) && t < r.tmax) {
        const long long slot = (long long)next_k * c + j;
        if (best_slot < 0 || t < best_t ||
            (t == best_t && slot < best_slot)) {
          best_t = t;
          best_slot = slot;
        }
      }
    }
    last_en = next_en;
    last_k = next_k;
  }
  if (best_slot >= 0) {
    // exact refinement of the winner (standard MT with p = d x e2,
    // q = s x e1) and barycentric re-validation: a bad winner becomes a
    // miss, never a phantom hit
    const int k = (int)(best_slot / c), j = (int)(best_slot % c);
    const float* tab = s.table + (size_t)k * 16 * c;
    float v0[3], e1[3], e2[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v0[q] = tab[q * c + j];
      e1[q] = tab[(3 + q) * c + j];
      e2[q] = tab[(6 + q) * c + j];
    }
    const float px = r.d[1] * e2[2] - r.d[2] * e2[1];
    const float py = r.d[2] * e2[0] - r.d[0] * e2[2];
    const float pz = r.d[0] * e2[1] - r.d[1] * e2[0];
    const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
    const bool ok = fabsf(det) > 1e-12f;
    const float inv = ok ? 1.0f / det : 0.0f;
    const float tx = r.o[0] - v0[0], ty = r.o[1] - v0[1], tz = r.o[2] - v0[2];
    const float u = (tx * px + ty * py + tz * pz) * inv;
    const float qx = ty * e1[2] - tz * e1[1];
    const float qy = tz * e1[0] - tx * e1[2];
    const float qz = tx * e1[1] - ty * e1[0];
    const float v = (r.d[0] * qx + r.d[1] * qy + r.d[2] * qz) * inv;
    const float t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv;
    const float slack = 1e-5f;
    if (ok && u >= -slack && v >= -slack && u + v <= 1.0f + 2.0f * slack &&
        t > 0.0f) {
      res.t = t;
      res.u = u;
      res.v = v;
      res.tri = s.tri_map[best_slot];  // int32 ids: exact past 2^24
      res.hit = true;
    }
  }
  return res;
}

// Any accepted hit with tmin < t < capped tmax.
__device__ __forceinline__ bool any_hit(const Ray& r, const Tables& s) {
  const int nk = s.nk, c = s.c;
  for (int k = 0; k < nk; ++k) {
    if (cluster_enter(r, s.boxes, k, nk) == CUDART_INF_F) continue;
    const float* tab = s.table + (size_t)k * 16 * c;
    const int cnt = s.counts[k];
    for (int j = 0; j < cnt; ++j) {
      float t;
      if (mt_test(r, tab, c, j, t) && t < r.tmax) return true;
    }
  }
  return false;
}

}  // namespace resident
