// Device functions of the resident ray-triangle traversal, shared by the
// trace kernels (resident_trace.cu: K1 resident_closest, K2 resident_anyhit,
// K9 grouped_closest, K10 grouped_anyhit, K8 schedule_keys), the whole-sample frame kernel
// (frame.cu: K3 frame_sample) and the fused route (route.cu: K7), so that
// the fused and the composed paths intersect with identical arithmetic — the counterpart of
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
//     clusters, walked by a warp per ray (the section "The warp walks"
//     below). A group box contains its members' boxes and the slab
//     arithmetic is monotone in the box bounds, so a member never enters
//     before its group: the grouped walks visit the clusters the flat ones
//     visit, in the same order, and their results are equal bit for bit;
//   * the flat team walks of K1 / K2 (flat_team_closest / flat_team_anyhit,
//     the section "The flat team walks"): the flat walks' results by a team
//     of W lanes a ray; at one cluster on a large launch K1 / K2 walk a
//     lane a ray through closest_hit / any_hit;
//   * the traces of K3 and K7 (closest / occluded at the end): each lane's
//     ray through the flat walks, or the warp's rays one after another
//     through the warp walks.
//
// Everything must be compiled with --fmad=false: contracted multiply-adds
// would round grazing and edge hits differently from the plain versions.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cycles.cuh"

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

// ---------------------------------------------------------------------------
// The warp walks of the two-level cull (K9 / K10, and K3 and K7 in their
// grouped mode): a warp (a team of 32 lanes) walks ONE ray, so the work of a
// ray is spread over lanes:
//   * group pass: lane j slab-tests group box base + j (planar (8, Kg) rows,
//     coalesced); the entered groups go through a per-warp ring in shared
//     memory, and lanes 8q..8q+7 test the 8 member boxes of the ring's q-th
//     group (two 16-byte loads a lane; a group's (8, 8) block is 256
//     contiguous bytes), four groups at a time;
//   * closest hit: every member the ray enters under the horizon, after the
//     last pick, goes into a per-warp candidate buffer in shared memory (up
//     to kCandidates) while the least (enter, cluster) is kept by shuffles.
//     When the buffer holds them all, every later pick is a lexicographic
//     minimum over the buffer, under the current horizon (it only falls),
//     so one pass over the Kg boxes serves the whole walk; when it
//     overflows, the walk visits the least candidate and passes again;
//   * cluster visits: lane j tests slots j, j + 32, ... of the (16, C) table
//     slice (coalesced); the closest hit keeps the lexicographic (t, slot)
//     minimum and reduces it across the warp after each visit, the any-hit
//     leaves the walk at the first __any_sync hit.
// The closest hit visits closest_hit's clusters in closest_hit's order: the
// picks are the successive lexicographic (enter, cluster) minima under the
// same horizon, and a member never enters before its group (a group box
// contains its members' boxes and the slab arithmetic is monotone in the
// bounds). The any-hit visits any_hit's entered clusters in index order. The
// (t, slot) minimum and the any-hit OR do not depend on how the tests are
// spread over lanes, so the results equal the flat walks' bit for bit.
// Every lane of the warp must reach every call below: they shuffle, ballot
// and __syncwarp over all 32 lanes.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 64;                        // entered groups in flight
constexpr int kGroupsPerStep = 32 / kGroup;
constexpr int kCandidates = 512;                 // buffered picks of a walk

// Shared memory of one team (one warp).
struct Team {
  int ring[kRing];
  float cand_en[kCandidates];
  int cand_k[kCandidates];
};

// The warp walks read the member boxes as float4: the table must be 16-byte
// aligned (ops/resident.py group_args copies a misaligned one).
__host__ __device__ inline bool group_tables_ok(const float* gboxes, const float* mboxes,
                                                int kg) {
  return gboxes != nullptr && mboxes != nullptr && kg >= 1 &&
         reinterpret_cast<uintptr_t>(mboxes) % 16 == 0;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// (en, k) before (en0, k0) in (enter, cluster) order; k < 0 is no candidate.
__device__ __forceinline__ bool cand_before(float en, int k, float en0, int k0) {
  return k >= 0 && (k0 < 0 || en < en0 || (en == en0 && k < k0));
}

// The least (en, k) over the warp, on every lane.
__device__ __forceinline__ void warp_min_cand(float& en, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float en2 = __shfl_xor_sync(kFull, en, off);
    const int k2 = __shfl_xor_sync(kFull, k, off);
    if (cand_before(en2, k2, en, k)) {
      en = en2;
      k = k2;
    }
  }
}

// The lexicographic (t, slot) minimum over the warp, on every lane; slot < 0
// is no hit.
__device__ __forceinline__ void warp_min_hit(float& t, int& slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(kFull, t, off);
    const int s2 = __shfl_xor_sync(kFull, slot, off);
    if (s2 >= 0 && (slot < 0 || t2 < t || (t2 == t && s2 < slot))) {
      t = t2;
      slot = s2;
    }
  }
}

// Lane `lane`'s member of the ring's (lane / 8)-th group from `head`:
// (enter, cluster), or (+inf, -1) past the ring's end. A group's member
// boxes are 8 x 8 contiguous floats: lane m reads its box as two float4.
__device__ __forceinline__ void member_enter(const Ray& r, const Tables& s,
                                             const int* ring, int head, int tail,
                                             int lane, float& en, int& k) {
  en = CUDART_INF_F;
  k = -1;
  const int q = head + (lane >> 3);
  if (q >= tail) return;
  const int g = ring[q & (kRing - 1)];
  const float4* mb = reinterpret_cast<const float4*>(
      s.mboxes + static_cast<size_t>(g) * kGroup * 8 + 8 * (lane & 7));
  const float4 a = __ldg(mb), b = __ldg(mb + 1);
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  en = slab_enter_box(r, lo, hi, b.z);
  k = group_cid0(s, g) + (lane & 7);
}

// Appends this chunk's entered groups (lane j: group base + j) to the ring.
__device__ __forceinline__ void push_groups(const Ray& r, const Tables& s, float hz,
                                            int base, int lane, int* ring, int& tail) {
  const int g = base + lane;
  const float eg = g < s.kg ? cluster_enter(r, s.gboxes, g, s.kg) : CUDART_INF_F;
  const bool in = eg <= hz && eg < CUDART_INF_F;
  const unsigned mask = __ballot_sync(kFull, in);
  if (in) ring[(tail + __popc(mask & lanes_below(lane))) & (kRing - 1)] = g;
  tail += __popc(mask);
  __syncwarp();
}

// The closest hit's pass: every cluster entered at en <= hz after
// (last_en, last_k) in (enter, cluster) order. Returns their least (en, k)
// on every lane (k = -1: none) and their number; they are in the team's
// buffer when the number is at most kCandidates.
__device__ __forceinline__ int closest_pass(const Ray& r, const Tables& s, float hz,
                                            float last_en, int last_k, int lane, Team& tm,
                                            float& next_en, int& next_k) {
  int head = 0, tail = 0, count = 0;
  float my_en = CUDART_INF_F;
  int my_k = -1;
  for (int base = 0; base < s.kg; base += 32) {
    push_groups(r, s, hz, base, lane, tm.ring, tail);
    const bool last_chunk = base + 32 >= s.kg;
    while (tail - head >= kGroupsPerStep || (last_chunk && head < tail)) {
      float en;
      int k;
      member_enter(r, s, tm.ring, head, tail, lane, en, k);
      const bool ok = en <= hz && en < CUDART_INF_F &&
                      !(en < last_en || (en == last_en && k <= last_k));
      if (ok && cand_before(en, k, my_en, my_k)) {
        my_en = en;
        my_k = k;
      }
      const unsigned mask = __ballot_sync(kFull, ok);
      const int at = count + __popc(mask & lanes_below(lane));
      if (ok && at < kCandidates) {
        tm.cand_en[at] = en;
        tm.cand_k[at] = k;
      }
      count += __popc(mask);
      head = min(head + kGroupsPerStep, tail);
      __syncwarp();
    }
  }
  warp_min_cand(my_en, my_k);
  next_en = my_en;
  next_k = my_k;
  return count;
}

// The pick from a buffer that holds every candidate of its pass: the least
// buffered (en, k) after (last_en, last_k) with en <= hz.
__device__ __forceinline__ void buffered_pick(const Team& tm, int count, float hz,
                                              float last_en, int last_k, int lane,
                                              float& next_en, int& next_k) {
  float my_en = CUDART_INF_F;
  int my_k = -1;
  for (int i = lane; i < count; i += 32) {
    const float en = tm.cand_en[i];
    const int k = tm.cand_k[i];
    if (!(en <= hz) || en < last_en || (en == last_en && k <= last_k)) continue;
    if (cand_before(en, k, my_en, my_k)) {
      my_en = en;
      my_k = k;
    }
  }
  warp_min_cand(my_en, my_k);
  next_en = my_en;
  next_k = my_k;
}

// Tests cluster k's triangles against `l` (in the cluster's object space),
// lane j slots j, j + 32, ...; the warp's lexicographic (t, slot) minimum
// with the hits so far, on every lane.
__device__ __forceinline__ void team_visit_closest(const Ray& l, const Tables& s, int k,
                                                   int lane, float& best_t, int& best_slot) {
  const int c = s.c;
  const float* tab = s.table + static_cast<size_t>(s.xf ? k % s.kb : k) * 16 * c;
  const int cnt = __ldg(s.counts + k);
  float t_min = best_t;
  int slot_min = best_slot;
  for (int j = lane; j < cnt; j += 32) {
    float t;
    if (mt_test(l, tab, c, j, t) && t < l.tmax) {
      const int slot = k * c + j;
      if (slot_min < 0 || t < t_min || (t == t_min && slot < slot_min)) {
        t_min = t;
        slot_min = slot;
      }
    }
  }
  warp_min_hit(t_min, slot_min);
  best_t = t_min;
  best_slot = slot_min;
}

// Any accepted triangle of cluster k (`l` in its object space), 32 slots a
// step; the same answer on every lane.
__device__ __forceinline__ bool team_visit_any(const Ray& l, const Tables& s, int k,
                                               int lane) {
  const int c = s.c;
  const float* tab = s.table + static_cast<size_t>(s.xf ? k % s.kb : k) * 16 * c;
  const int cnt = __ldg(s.counts + k);
  for (int j0 = 0; j0 < cnt; j0 += 32) {
    const int j = j0 + lane;
    float t;
    const bool hit = j < cnt && mt_test(l, tab, c, j, t) && t < l.tmax;
    if (__any_sync(kFull, hit)) return true;
  }
  return false;
}

// The closest-hit walk of one ray (K9): closest_hit's visits in its order;
// returns the winning slot (-1: none) on every lane.
__device__ __forceinline__ int team_closest(const Ray& r, const Tables& s, int lane,
                                            Team& tm) {
  float best_t = kF32Max;
  int best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  float hz = horizon(r, best_t, best_slot);
  float next_en;
  int next_k;
  int count = closest_pass(r, s, hz, last_en, last_k, lane, tm, next_en, next_k);
  bool buffered = count <= kCandidates;
  while (next_k >= 0) {
    // instanced: the ray in this cluster's instance frame, per visit
    const Ray l = s.xf ? object_ray(r, s, next_k / s.kb) : r;
    team_visit_closest(l, s, next_k, lane, best_t, best_slot);
    last_en = next_en;
    last_k = next_k;
    hz = horizon(r, best_t, best_slot);
    if (buffered) {
      buffered_pick(tm, count, hz, last_en, last_k, lane, next_en, next_k);
    } else {
      count = closest_pass(r, s, hz, last_en, last_k, lane, tm, next_en, next_k);
      buffered = count <= kCandidates;
    }
  }
  return best_slot;
}

// The any-hit walk of one ray (K10): entered groups in index order, their
// entered members in index order, leaving at the first accepted hit; the
// same answer on every lane.
__device__ __forceinline__ bool team_anyhit(const Ray& r, const Tables& s, int lane,
                                            int* ring) {
  int head = 0, tail = 0;
  for (int base = 0; base < s.kg; base += 32) {
    push_groups(r, s, r.tmax, base, lane, ring, tail);
    const bool last_chunk = base + 32 >= s.kg;
    while (tail - head >= kGroupsPerStep || (last_chunk && head < tail)) {
      float en;
      int k;
      member_enter(r, s, ring, head, tail, lane, en, k);
      unsigned mask = __ballot_sync(kFull, en < CUDART_INF_F);
      head = min(head + kGroupsPerStep, tail);
      __syncwarp();
      while (mask) {
        const int k0 = __shfl_sync(kFull, k, __ffs(mask) - 1);
        mask &= mask - 1;
        const Ray l = s.xf ? object_ray(r, s, k0 / s.kb) : r;
        if (team_visit_any(l, s, k0, lane)) return true;
      }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// The flat team walks (K1 / K2): a team of W lanes (W = 4 .. 32, a power of
// two; a warp carries 32 / W rays) walks ONE ray through the flat cull, the
// one-level counterpart of the warp walks above:
//   * box pass: lane j slab-tests clusters j, j + W, ... of the planar
//     (8, K) box table (the team's loads coalesced, the warp's teams read
//     the same boxes); the closest hit puts every cluster entered under the
//     horizon after the last pick into the team's candidate buffer in shared
//     memory (up to kFlatCandidates) and keeps the least (enter, cluster);
//   * picks: when the buffer holds every candidate of its pass, each later
//     pick is the least buffered (enter, cluster) after the last one under
//     the current horizon (it only falls), so one pass serves the whole
//     walk; when it overflows (many clusters, e.g. a forced-flat K1 on a
//     large scene), the walk visits the least candidate and passes again;
//   * visits: lane j tests slots j, j + W, ... of the (16, C) table slice;
//     the closest hit reduces the lexicographic (t, slot) minimum across
//     the team by shuffles after each visit, the any-hit visits the entered
//     clusters in index order and leaves at the first __any_sync hit; lane
//     0 refines the winner (refine).
// The picks are closest_hit's successive (enter, cluster) minima under the
// same horizon, so the team visits closest_hit's clusters in its order; the
// any-hit ORs any_hit's entered clusters. The (t, slot) minimum and the OR do
// not depend on how the tests are spread over lanes, so the results equal
// the thread walks' bit for bit. Every decision of a walk is the same on all
// lanes of its team (ballots and reductions), so every lane of the team
// reaches every shuffle, ballot and __syncwarp below, each over the team's
// own lanes; the teams of a warp need not walk in step.

constexpr int kFlatCandidates = 64;  // buffered picks of a walk (K < 64: all)

// Shared memory of one flat team.
struct FlatBuf {
  float en[kFlatCandidates];
  int k[kFlatCandidates];
};

// counters of a -DPG_CYCLES build (csrc/cycles.cuh): kept by lane 0 of the
// team of one ray in kFlatSample (scripts/torch_grouped_probe.py --parts
// flat): cycles in the box pass and the picks, in the visits, in the
// refinement and in the whole walk; the rays, passes and picks, visits and
// triangles tested
constexpr int kFlatPass = 8, kFlatVisit = 9, kFlatRefine = 10, kFlatRays = 11,
              kFlatPasses = 12, kFlatVisits = 13, kFlatWalk = 14, kFlatTris = 15;
constexpr int kFlatSample = 8;

// The lanes of one team of W in its warp.
template <int W>
struct Lanes {
  static_assert(W >= 4 && W <= 32 && (W & (W - 1)) == 0, "a team is 4 .. 32 lanes, a power of two");
  int t;          // this lane's index in its team
  int first;      // the team's first lane in the warp
  unsigned mask;  // the team's lanes

  __device__ explicit Lanes(int lane)
      : t(lane & (W - 1)), first(lane & ~(W - 1)), mask(team_mask(lane)) {}

  static __device__ unsigned team_mask(int lane) {
    if constexpr (W == 32) {
      return kFull;
    } else {
      return ((1u << W) - 1u) << (lane & ~(W - 1));
    }
  }
  // the team's ballot, bit j for team lane j
  __device__ unsigned ballot(bool p) const {
    const unsigned b = __ballot_sync(mask, p);
    if constexpr (W == 32) {
      return b;
    } else {
      return (b >> first) & ((1u << W) - 1u);
    }
  }
  __device__ bool any(bool p) const { return __any_sync(mask, p); }
  __device__ void sync() const { __syncwarp(mask); }
  // the least (en, k) over the team, on every lane of it
  __device__ void min_cand(float& en, int& k) const {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      const float en2 = __shfl_xor_sync(mask, en, off, W);
      const int k2 = __shfl_xor_sync(mask, k, off, W);
      if (cand_before(en2, k2, en, k)) {
        en = en2;
        k = k2;
      }
    }
  }
  // the lexicographic (t, slot) minimum over the team; slot < 0 is no hit
  __device__ void min_hit(float& tv, int& slot) const {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      const float t2 = __shfl_xor_sync(mask, tv, off, W);
      const int s2 = __shfl_xor_sync(mask, slot, off, W);
      if (s2 >= 0 && (slot < 0 || t2 < tv || (t2 == tv && s2 < slot))) {
        tv = t2;
        slot = s2;
      }
    }
  }
};

// The closest hit's box pass: every cluster entered at en <= hz after
// (last_en, last_k) in (enter, cluster) order. Returns their least (en, k)
// on every lane of the team (k = -1: none) and their number; they are in
// the team's buffer when the number is at most kFlatCandidates.
template <int W>
__device__ __forceinline__ int flat_pass(const Ray& r, const Tables& s, float hz,
                                         float last_en, int last_k, const Lanes<W>& tl,
                                         FlatBuf& fb, float& next_en, int& next_k) {
  int count = 0;
  float my_en = CUDART_INF_F;
  int my_k = -1;
  for (int base = 0; base < s.nk; base += W) {
    const int k = base + tl.t;
    const float en = k < s.nk ? cluster_enter(r, s.boxes, k, s.nk) : CUDART_INF_F;
    const bool ok = en <= hz && en < CUDART_INF_F &&
                    !(en < last_en || (en == last_en && k <= last_k));
    if (ok && cand_before(en, k, my_en, my_k)) {
      my_en = en;
      my_k = k;
    }
    const unsigned m = tl.ballot(ok);
    const int at = count + __popc(m & lanes_below(tl.t));
    if (ok && at < kFlatCandidates) {
      fb.en[at] = en;
      fb.k[at] = k;
    }
    count += __popc(m);
  }
  tl.sync();
  tl.min_cand(my_en, my_k);
  next_en = my_en;
  next_k = my_k;
  return count;
}

// The pick from a buffer that holds every candidate of its pass: the least
// buffered (en, k) after (last_en, last_k) with en <= hz.
template <int W>
__device__ __forceinline__ void flat_pick(const FlatBuf& fb, int count, float hz, float last_en,
                                          int last_k, const Lanes<W>& tl, float& next_en,
                                          int& next_k) {
  float my_en = CUDART_INF_F;
  int my_k = -1;
  for (int i = tl.t; i < count; i += W) {
    const float en = fb.en[i];
    const int k = fb.k[i];
    if (!(en <= hz) || en < last_en || (en == last_en && k <= last_k)) continue;
    if (cand_before(en, k, my_en, my_k)) {
      my_en = en;
      my_k = k;
    }
  }
  tl.min_cand(my_en, my_k);
  next_en = my_en;
  next_k = my_k;
}

// Tests cluster k's triangles against `l` (in the cluster's object space),
// lane j slots j, j + W, ...; the team's (t, slot) minimum with the hits so
// far, on every lane of it.
template <int W>
__device__ __forceinline__ void flat_visit_closest(const Ray& l, const Tables& s, int k,
                                                   const Lanes<W>& tl, float& best_t,
                                                   int& best_slot) {
  const int c = s.c;
  const float* tab = s.table + static_cast<size_t>(s.xf ? k % s.kb : k) * 16 * c;
  const int cnt = __ldg(s.counts + k);
  float t_min = best_t;
  int slot_min = best_slot;
  for (int j = tl.t; j < cnt; j += W) {
    float t;
    if (mt_test(l, tab, c, j, t) && t < l.tmax) {
      const int slot = k * c + j;
      if (slot_min < 0 || t < t_min || (t == t_min && slot < slot_min)) {
        t_min = t;
        slot_min = slot;
      }
    }
  }
  tl.min_hit(t_min, slot_min);
  best_t = t_min;
  best_slot = slot_min;
}

// Any accepted triangle of cluster k (`l` in its object space), W slots a
// step; the same answer on every lane of the team.
template <int W>
__device__ __forceinline__ bool flat_visit_any(const Ray& l, const Tables& s, int k,
                                               const Lanes<W>& tl) {
  const int c = s.c;
  const float* tab = s.table + static_cast<size_t>(s.xf ? k % s.kb : k) * 16 * c;
  const int cnt = __ldg(s.counts + k);
  for (int j0 = 0; j0 < cnt; j0 += W) {
    const int j = j0 + tl.t;
    float t;
    const bool hit = j < cnt && mt_test(l, tab, c, j, t) && t < l.tmax;
    if (tl.any(hit)) return true;
  }
  return false;
}

// The closest-hit walk of one ray (K1): closest_hit's visits in its order;
// returns the winning slot (-1: none) on every lane of the team. `sample`:
// this lane keeps the counters of a -DPG_CYCLES build.
template <int W>
__device__ __forceinline__ int flat_team_closest(const Ray& r, const Tables& s,
                                                 const Lanes<W>& tl, FlatBuf& fb,
                                                 bool sample) {
  float best_t = kF32Max;
  int best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  float hz = horizon(r, best_t, best_slot);
  float next_en;
  int next_k;
  CYCLES_NOW(t_pass);
  int count = flat_pass(r, s, hz, last_en, last_k, tl, fb, next_en, next_k);
  bool buffered = count <= kFlatCandidates;
  if (sample) {
    CYCLES_ADD(kFlatPass, t_pass);
    CYCLES_COUNT(kFlatPasses, 1);
  }
  while (next_k >= 0) {
    CYCLES_NOW(t_visit);
    // instanced: the ray in this cluster's instance frame, per visit
    const Ray l = s.xf ? object_ray(r, s, next_k / s.kb) : r;
    flat_visit_closest(l, s, next_k, tl, best_t, best_slot);
    if (sample) {
      CYCLES_ADD(kFlatVisit, t_visit);
      CYCLES_COUNT(kFlatVisits, 1);
      CYCLES_COUNT(kFlatTris, __ldg(s.counts + next_k));
    }
    last_en = next_en;
    last_k = next_k;
    hz = horizon(r, best_t, best_slot);
    CYCLES_NOW(t_pick);
    if (buffered) {
      flat_pick(fb, count, hz, last_en, last_k, tl, next_en, next_k);
    } else {
      count = flat_pass(r, s, hz, last_en, last_k, tl, fb, next_en, next_k);
      buffered = count <= kFlatCandidates;
    }
    if (sample) {
      CYCLES_ADD(kFlatPass, t_pick);
      CYCLES_COUNT(kFlatPasses, 1);
    }
  }
  return best_slot;
}

// The any-hit walk of one ray (K2): entered clusters in index order, leaving
// at the first accepted hit; the same answer on every lane of the team.
template <int W>
__device__ __forceinline__ bool flat_team_anyhit(const Ray& r, const Tables& s,
                                                 const Lanes<W>& tl) {
  for (int base = 0; base < s.nk; base += W) {
    const int k = base + tl.t;
    unsigned m = tl.ballot(k < s.nk && cluster_enter(r, s.boxes, k, s.nk) < CUDART_INF_F);
    while (m) {
      const int k0 = base + __ffs(m) - 1;
      m &= m - 1;
      const Ray l = s.xf ? object_ray(r, s, k0 / s.kb) : r;
      if (flat_visit_any(l, s, k0, tl)) return true;
    }
  }
  return false;
}

// Lane `src`'s ray on every lane.
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    q.o[ax] = __shfl_sync(kFull, r.o[ax], src);
    q.d[ax] = __shfl_sync(kFull, r.d[ax], src);
    q.inv[ax] = __shfl_sync(kFull, r.inv[ax], src);
  }
  q.tmin = __shfl_sync(kFull, r.tmin, src);
  q.tmax = __shfl_sync(kFull, r.tmax, src);
  return q;
}

// ---------------------------------------------------------------------------
// The traces of K3 and K7: the closest hit and any-hit of each lane's capped
// ray (`has`: the lane holds one). With group tables (ops/resident.py
// use_grouped) the warp traces its rays one after another, all 32 lanes on
// each (a ballot of the lanes that hold a ray; each such lane's ray is
// broadcast by shuffles and walked by the team, the owner keeps the answer
// and refines its own winner): a lane without a ray only skips its turn, and
// a warp without any ray pays one ballot. Every lane of the warp must call
// them then. Without group tables each lane walks its own ray through the
// flat cull (closest_hit / any_hit). Either way the answers are the flat
// walks'.

__device__ __forceinline__ Hit closest(bool has, const Ray& r, const Tables& s,
                                       Team& tm) {
  const Hit miss = {kF32Max, 0.0f, 0.0f, -1, false};
  if (!s.gboxes) return has ? closest_hit(r, s) : miss;
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(kFull, has);
  int slot = -1;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int won = team_closest(shfl_ray(r, src), s, lane, tm);
    if (lane == src) slot = won;
    __syncwarp();  // the next walk refills the team's buffers
  }
  return slot >= 0 ? refine(r, s, slot) : miss;
}

__device__ __forceinline__ bool occluded(bool has, const Ray& r, const Tables& s,
                                         Team& tm) {
  if (!s.gboxes) return has && any_hit(r, s);
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(kFull, has);
  bool occ = false;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const bool o = team_anyhit(shfl_ray(r, src), s, lane, tm.ring);
    if (lane == src) occ = o;
    __syncwarp();
  }
  return occ;
}

}  // namespace resident
