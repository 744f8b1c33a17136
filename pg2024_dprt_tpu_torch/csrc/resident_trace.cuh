// Device functions of the resident ray-triangle traversal, shared by the
// trace kernels (resident_trace.cu: K1 resident_closest, K2 resident_anyhit,
// K9 grouped_closest, K10 grouped_anyhit) and the whole-sample frame kernel
// (frame.cu: K3 frame_sample), so that the fused and the composed frame
// intersect with identical arithmetic — the counterpart of
// pallas_frame.py::_frame_kernel reusing pallas_resident's _recull_loop /
// _occl_recull_loop / _grouped_recull_loop / _mt_body_t.
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
//     accepted hit;
//   * two-level instancing (_xform_visit): cluster k of an instanced scene
//     belongs to instance k / KB and reads base table slice k % KB; the ray
//     is culled in world space against the instance-level boxes and tested
//     in the instance's object space, o_l[i] = o0 m[3i] + o1 m[3i+1] +
//     o2 m[3i+2] + m[9+i] (left to right), d_l the same without the
//     translation and NOT normalized, so object t equals world t and the
//     world tmin / tmax apply unchanged; the winner is refined in object
//     space and its id is the virtual id instance * TB + base canonical id;
//   * the grouped walks (_grouped_recull_loop / _grouped_occl_loop): the
//     same results through a two-level cull over groups of 8 consecutive
//     clusters. A group box contains its members' boxes and the slab
//     arithmetic is monotone in the box bounds, so a member never enters
//     before its group: the grouped walks visit the clusters the flat ones
//     visit, in the same order, and their results are equal bit for bit.
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

constexpr int kGroup = 8;  // scene/geometry.py CL_GROUP

// The cluster tables of one scene (layouts: scene/geometry.py DeviceScene).
struct Tables {
  const float* __restrict__ boxes;      // (8, K)
  const float* __restrict__ table;      // (KB, 16, C); KB = K when flat
  const int32_t* __restrict__ tri_map;  // (K*C,) slot -> canonical id
  const int32_t* __restrict__ counts;   // (K,)
  const float* __restrict__ scene_aabb; // (2, 3)
  int nk;
  int c;
  // two-level instancing: one (16,) row per instance, nullptr when flat
  const float* __restrict__ xf = nullptr;
  int kb = 0;  // base clusters (table slices)
  int tb = 0;  // base triangles: the virtual id stride
  // group tables of the grouped walks: gboxes (8, Kg), mboxes (Kg, 8, 8)
  const float* __restrict__ gboxes = nullptr;
  const float* __restrict__ mboxes = nullptr;
  int kg = 0;
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

// Exact slab test of the ray against the box [lo, hi] with non-empty flag
// `flag`. Returns the clamped enter distance, or +inf when the ray provably
// does not enter the box before its tmax.
__device__ __forceinline__ float slab_enter_box(const Ray& r, const float lo[3],
                                                const float hi[3], float flag) {
  if (!(flag > 0.0f)) return CUDART_INF_F;
  float enter = 0.0f;
  float exit_ = CUDART_INF_F;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (lo[ax] - r.o[ax]) * r.inv[ax];
    const float t1 = (hi[ax] - r.o[ax]) * r.inv[ax];
    enter = fmaxf(enter, fminf(t0, t1));
    exit_ = fminf(exit_, fmaxf(t0, t1));
  }
  const float exit_g = exit_ * 1.0000004f + 1e-7f;  // rounding guard
  const bool ok = enter <= exit_g && exit_g > 0.0f && enter < r.tmax;
  return ok ? fmaxf(enter, 0.0f) : CUDART_INF_F;
}

// The same test against the box whose component q (min xyz, max xyz,
// non-empty flag) is b[q * stride].
__device__ __forceinline__ float slab_enter(const Ray& r,
                                            const float* __restrict__ b,
                                            int stride) {
  const float lo[3] = {b[0], b[stride], b[2 * stride]};
  const float hi[3] = {b[3 * stride], b[4 * stride], b[5 * stride]};
  return slab_enter_box(r, lo, hi, b[6 * stride]);
}

// Slab test against cluster (or group) k of a planar (8, nk) box table.
__device__ __forceinline__ float cluster_enter(
    const Ray& r, const float* __restrict__ boxes, int k, int nk) {
  return slab_enter(r, boxes + k, nk);
}

// The ray in the object space of instance `inst` (_xform_visit): the
// unnormalized direction keeps object t equal to world t.
__device__ __forceinline__ Ray object_ray(const Ray& r, const Tables& s,
                                          int inst) {
  const float* m = s.xf + 16 * static_cast<size_t>(inst);
  Ray l = r;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m0 = m[3 * i], m1 = m[3 * i + 1], m2 = m[3 * i + 2];
    l.o[i] = r.o[0] * m0 + r.o[1] * m1 + r.o[2] * m2 + m[9 + i];
    l.d[i] = r.d[0] * m0 + r.d[1] * m1 + r.d[2] * m2;
  }
  return l;
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

// Tests the triangles of instance-level cluster k against the ray `l`
// (already in the cluster's object space) and keeps the lexicographic
// (t, slot) minimum of the accepted hits with t < tmax, slot = k * C + lane.
__device__ __forceinline__ void visit_closest(const Ray& l, const Tables& s,
                                              int k, float& best_t,
                                              long long& best_slot) {
  const int c = s.c;
  const int kt = s.xf ? k % s.kb : k;
  const float* tab = s.table + static_cast<size_t>(kt) * 16 * c;
  const int cnt = s.counts[k];
  for (int j = 0; j < cnt; ++j) {
    float t;
    if (mt_test(l, tab, c, j, t) && t < l.tmax) {
      const long long slot = static_cast<long long>(k) * c + j;
      if (best_slot < 0 || t < best_t || (t == best_t && slot < best_slot)) {
        best_t = t;
        best_slot = slot;
      }
    }
  }
}

// Any accepted triangle of cluster k with tmin < t < tmax (`l` in the
// cluster's object space).
__device__ __forceinline__ bool visit_any(const Ray& l, const Tables& s,
                                          int k) {
  const int c = s.c;
  const int kt = s.xf ? k % s.kb : k;
  const float* tab = s.table + static_cast<size_t>(kt) * 16 * c;
  const int cnt = s.counts[k];
  for (int j = 0; j < cnt; ++j) {
    float t;
    if (mt_test(l, tab, c, j, t) && t < l.tmax) return true;
  }
  return false;
}

// The horizon of the front-to-back walks: clusters entered beyond it cannot
// hold a closer hit; the guard keeps rounding from pruning a tie
// (pallas_resident rekeys).
__device__ __forceinline__ float horizon(const Ray& r, float best_t,
                                         long long best_slot) {
  return best_slot >= 0 ? best_t * (1.0f + 1e-4f) + 1e-7f : r.tmax;
}

// The exact refinement of the winning slot (standard MT with p = d x e2,
// q = s x e1, in the winner's object space) and barycentric re-validation:
// a bad winner becomes a miss, never a phantom hit. A miss is t = F32_MAX,
// tri = -1.
__device__ __forceinline__ Hit refine(const Ray& r, const Tables& s,
                                      long long best_slot) {
  Hit res = {kF32Max, 0.0f, 0.0f, -1, false};
  if (best_slot < 0) return res;
  const int c = s.c;
  const int k = static_cast<int>(best_slot / c), j = static_cast<int>(best_slot % c);
  const int inst = s.xf ? k / s.kb : 0;
  const Ray l = s.xf ? object_ray(r, s, inst) : r;
  const float* tab =
      s.table + static_cast<size_t>(s.xf ? k % s.kb : k) * 16 * c;
  float v0[3], e1[3], e2[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v0[q] = tab[q * c + j];
    e1[q] = tab[(3 + q) * c + j];
    e2[q] = tab[(6 + q) * c + j];
  }
  const float px = l.d[1] * e2[2] - l.d[2] * e2[1];
  const float py = l.d[2] * e2[0] - l.d[0] * e2[2];
  const float pz = l.d[0] * e2[1] - l.d[1] * e2[0];
  const float det = e1[0] * px + e1[1] * py + e1[2] * pz;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv = ok ? 1.0f / det : 0.0f;
  const float tx = l.o[0] - v0[0], ty = l.o[1] - v0[1], tz = l.o[2] - v0[2];
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1[2] - tz * e1[1];
  const float qy = tz * e1[0] - tx * e1[2];
  const float qz = tx * e1[1] - ty * e1[0];
  const float v = (l.d[0] * qx + l.d[1] * qy + l.d[2] * qz) * inv;
  const float t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv;
  const float slack = 1e-5f;
  if (ok && u >= -slack && v >= -slack && u + v <= 1.0f + 2.0f * slack &&
      t > 0.0f) {
    res.t = t;
    res.u = u;
    res.v = v;
    // int32 ids from cl_tri_map: exact past 2^24; instanced: virtual ids
    const int32_t canon = s.tri_map[best_slot];
    res.tri = s.xf ? __float2int_rn(s.xf[16 * static_cast<size_t>(inst) + 13]) * s.tb + canon
                   : canon;
    res.hit = true;
  }
  return res;
}

// Closest hit of a capped ray: front-to-back cluster visits, (t, slot)
// winner, exact refinement.
__device__ __forceinline__ Hit closest_hit(const Ray& r, const Tables& s) {
  const int nk = s.nk;
  float best_t = kF32Max;
  long long best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  for (;;) {
    const float hz = horizon(r, best_t, best_slot);
    float next_en = CUDART_INF_F;
    int next_k = -1;
    for (int k = 0; k < nk; ++k) {
      const float en = cluster_enter(r, s.boxes, k, nk);
      if (!(en <= hz)) continue;
      if (en < last_en || (en == last_en && k <= last_k)) continue;
      if (en < next_en || (en == next_en && k < next_k)) {
        next_en = en;
        next_k = k;
      }
    }
    if (next_k < 0) break;
    // instanced: the ray in this cluster's instance frame, per visit
    const Ray l = s.xf ? object_ray(r, s, next_k / s.kb) : r;
    visit_closest(l, s, next_k, best_t, best_slot);
    last_en = next_en;
    last_k = next_k;
  }
  return refine(r, s, best_slot);
}

// Any accepted hit with tmin < t < capped tmax.
__device__ __forceinline__ bool any_hit(const Ray& r, const Tables& s) {
  const int nk = s.nk;
  for (int k = 0; k < nk; ++k) {
    if (cluster_enter(r, s.boxes, k, nk) == CUDART_INF_F) continue;
    const Ray l = s.xf ? object_ray(r, s, k / s.kb) : r;
    if (visit_any(l, s, k)) return true;
  }
  return false;
}

// First member's cluster id of group g: mboxes[g][0][7] for an instanced
// scene (groups are cut per instance), g * 8 for a flat one.
__device__ __forceinline__ int group_cid0(const Tables& s, int g) {
  return s.xf ? __float2int_rn(s.mboxes[static_cast<size_t>(g) * kGroup * 8 + 7])
              : g * kGroup;
}

// Closest hit through the two-level cull, one thread per ray (K3's grouped
// mode; K9 walks the same picks a warp per ray, resident_trace.cu). It visits
// the clusters closest_hit visits, in the same order: each pick finds the
// next (enter, cluster) after the last one under the horizon, as
// closest_hit's pass over the K boxes does, but passes over the Kg group
// boxes and slab-tests the 8 member boxes only of the groups entered no
// later than the best candidate so far. A member never enters before its
// group, so a skipped group holds no better candidate, and the member boxes
// equal the cluster boxes, so the picks are closest_hit's. The walk of the
// JAX kernel (_grouped_recull_loop: groups front to back, then a group's
// members) visits more clusters at 512 triangles each and lost to K1 on
// the card at every K measured.
__device__ __forceinline__ Hit closest_hit_grouped(const Ray& r,
                                                   const Tables& s) {
  const int kg = s.kg;
  float best_t = kF32Max;
  long long best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  for (;;) {
    const float hz = horizon(r, best_t, best_slot);
    float next_en = CUDART_INF_F;
    int next_k = -1;
    for (int g = 0; g < kg; ++g) {
      const float eg = cluster_enter(r, s.gboxes, g, kg);
      if (!(eg <= hz) || eg > next_en) continue;
      const float* mb = s.mboxes + static_cast<size_t>(g) * kGroup * 8;
      const int cid0 = group_cid0(s, g);
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        const float en = slab_enter(r, mb + 8 * m, 1);
        const int k = cid0 + m;
        if (!(en <= hz)) continue;
        if (en < last_en || (en == last_en && k <= last_k)) continue;
        if (en < next_en || (en == next_en && k < next_k)) {
          next_en = en;
          next_k = k;
        }
      }
    }
    if (next_k < 0) break;
    const Ray l = s.xf ? object_ray(r, s, next_k / s.kb) : r;
    visit_closest(l, s, next_k, best_t, best_slot);
    last_en = next_en;
    last_k = next_k;
  }
  return refine(r, s, best_slot);
}

// Any-hit through the two-level cull, one thread per ray (K3's grouped
// mode; K10 walks it a warp per ray): entered
// groups in index order, their entered members in index order, return at
// the first accepted hit (_grouped_occl_loop). Equals any_hit: a member is
// entered only inside an entered group.
__device__ __forceinline__ bool any_hit_grouped(const Ray& r, const Tables& s) {
  const int kg = s.kg;
  for (int g = 0; g < kg; ++g) {
    if (cluster_enter(r, s.gboxes, g, kg) == CUDART_INF_F) continue;
    const float* mb = s.mboxes + static_cast<size_t>(g) * kGroup * 8;
    const int cid0 = group_cid0(s, g);
    const Ray l = s.xf ? object_ray(r, s, cid0 / s.kb) : r;
    for (int m = 0; m < kGroup; ++m) {
      if (slab_enter(r, mb + 8 * m, 1) == CUDART_INF_F) continue;
      if (visit_any(l, s, cid0 + m)) return true;
    }
  }
  return false;
}

// The closest hit and any-hit of K3: the grouped walks when the wrapper
// passed group tables (ops/resident.py use_grouped), else the flat ones.
__device__ __forceinline__ Hit closest(const Ray& r, const Tables& s) {
  return s.gboxes ? closest_hit_grouped(r, s) : closest_hit(r, s);
}

__device__ __forceinline__ bool occluded(const Ray& r, const Tables& s) {
  return s.gboxes ? any_hit_grouped(r, s) : any_hit(r, s);
}

}  // namespace resident
