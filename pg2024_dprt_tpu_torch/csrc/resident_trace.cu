// Resident closest-hit (K1) and any-hit (K2) ray-triangle traversal, their
// two-level grouped counterparts (K9, K10) and the cluster-schedule sort keys
// (K8) for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).
//
// K1 resident_closest replaces the JAX package's closest-hit Pallas kernels
// pallas_resident.py::_kernel (also its instanced mode), _kernel_hbm,
// _kernel_tiny and _kernel_tiny_t; K2 resident_anyhit replaces _occl_kernel,
// _occl_kernel_hbm, _occl_kernel_tiny and _occl_kernel_tiny_t. Those eight
// compute two functions on four TPU layouts; on this card every table is
// read from global memory, so the VMEM/HBM split collapses into one kernel
// each, which computes the same two functions once, per ray:
//
//   * the scene-exit horizon cap of each ray's tmax (_load_ray_rows);
//   * the exact per-ray cluster slab test with its rounding guard
//     (_cluster_enters, exact mode);
//   * the triple-product Moller-Trumbore test and its acceptance rules
//     (_mt_body): det = -n.d, u = e2.m, v = -e1.m, t = n.s / det with
//     m = s x d, s = o - v0; accepted when |det| > 1e-12, the signed
//     barycentrics lie in the triangle, and tmin < t (closest hit:
//     t < capped tmax as well; any-hit: t < capped tmax, as in
//     _occl_kernel);
//   * for K1, the exact winner refinement with barycentric re-validation
//     (_refine_winners and the epilogue at pallas_resident.py:2400-2455);
//   * for an instanced scene (cl_xf), the per-cluster object-space
//     transform of _xform_visit and the virtual ids of the epilogue
//     (pallas_resident.py:2417-2428).
//
// The TPU kernels' layout is not carried over: no (8, mp) ray packing, no
// packed t|lane keys, no one-hot MXU extraction. The winner is the
// lexicographic minimum of (t, slot), slot = cluster * C + lane, so the
// result does not depend on visit order and equals the dense plain version
// in ops/resident.py.
//
// The per-ray device functions (scene-exit cap, slab test, MT test, the
// closest-hit and any-hit loops, the refinement) live in resident_trace.cuh,
// which the frame kernel (frame.cu) shares; K1, K2 and K8 here are thin
// wrappers that load one ray of a wavefront and store its record, and K9 /
// K10's warp-wide walks are written here on the same device functions.
//
// Design of K1 / K2: one thread per ray. K1 visits the clusters the ray
// enters in front-to-back order of (enter distance, cluster), selecting the
// next one by a fresh O(K) slab pass (no per-ray list in memory), and stops when the
// next enter distance is beyond the current best t (with the guard the TPU
// kernels use). K2 visits entered clusters in index order and returns at
// the first accepted hit. Neighbouring rays (tiled pixel order) visit the
// same clusters, so a warp's table loads are mostly broadcasts and hit L1.
//
// What bounds it on an H100: FP32 operations. Each ray-triangle test is
// about 40 FP32 operations and reads 48 bytes of table that neighbouring
// rays share from cache, each cluster slab test about 30 operations; the
// bytes every call must move (rays in, records out, the table once) are
// far below the operations' time at 67 TFLOP/s FP32.
//
// K9 grouped_closest replaces _kernel_grouped and _kernel_grouped_hbm
// (pallas_call at :2269); K10 grouped_anyhit replaces _occl_kernel_grouped
// and _occl_kernel_grouped_hbm. They compute K1's and K2's functions through
// the two-level cull of _grouped_recull_loop / _grouped_occl_loop /
// _member_enters over groups of 8 clusters, and equal K1 / K2 bit for bit.
//
// What bounds them on an H100: latency, not arithmetic. Walked by one
// thread per ray (as K3 still walks them), every pick is a serial pass over
// all Kg group boxes (Kg = 1,488 on the 4.2M-triangle instanced scene) and
// a visit a serial loop over up to C = 512 triangles, lanes whose rays
// open different groups or clusters serialise, and a 65,536-row launch
// brings 15.5 warps an SM, so nothing hides the loads: 52-2,107x the
// bound, 48-95 % of the thread cycles in the cull passes (PERF.md, measured
// with cycle counters). The work itself is within a few times its bound.
//
// Design: a warp per ray (a team of 32 lanes), so a launch of N rays brings
// N warps, and the work of one ray is spread over lanes:
//   * group pass: lane j slab-tests group box base + j (planar (8, Kg) rows,
//     coalesced); the entered groups go through a per-warp ring in shared
//     memory, and lanes 8q..8q+7 test the 8 member boxes of the ring's q-th
//     group (two 16-byte loads a lane; a group's (8, 8) block is 256
//     contiguous bytes), four groups at a time;
//   * K9 collects every member the ray enters under the horizon, after the
//     last pick, into a per-warp candidate buffer in shared memory (up to
//     kCandidates) while keeping the least (enter, cluster) by shuffles.
//     When the buffer holds them all, every later pick is a lexicographic
//     minimum over the buffer, under the current horizon (it only falls),
//     so one pass over the Kg boxes serves the whole walk; when it
//     overflows, the walk visits the least candidate and passes again;
//   * cluster visits: lane j tests slots j, j + 32, ... of the (16, C)
//     table slice (coalesced), K9 keeps the lexicographic (t, slot) minimum
//     and reduces it across the warp after each visit, K10 leaves the walk
//     at the first __any_sync hit;
//   * an inactive ray's warp writes its miss and exits at once.
// K9's visits are K1's, in K1's order: the picks are the successive
// lexicographic (enter, cluster) minima under the same horizon (with the
// guard best_t * (1 + 1e-4) + 1e-7), and a member never enters before its
// group; K10 visits K2's entered clusters in index order. The (t, slot)
// minimum and the any-hit OR do not depend on how the tests are spread over
// lanes. K3 keeps the per-thread walks (resident_trace.cuh
// closest_hit_grouped / any_hit_grouped).
// What bounds them now (PERF.md): K9 runs 7-17x its bound and K10 3-105x,
// the most on small or sparse wavefronts, where a live ray's group pass is
// a chain of Kg / 32 dependent steps and a 65,536-row buffer's dead rows
// still cost a warp each.
//
// K8 schedule_keys replaces pallas_resident.py::_sched_kernel (pallas_call
// at :1221): for each ray the FIRST and SECOND cluster it enters, by the exact
// slab enter distance, packed into one sortable key (first << 12) | second.
// Sorting an incoherent wavefront by this key puts rays that will visit the
// same clusters in the same order next to each other, so the rays of a warp
// of K1 / K7 walk the same tables. The order is that of the TPU kernel: a
// cluster's rank is (enter bits with the low 12 bits cleared) | cluster, so
// enter distances within 2^12 ulps rank by cluster index; a ray that enters
// no cluster gets 0xFFF in both halves and an inactive ray 0x7FFFFFFF, which
// sort last. Needs K < 4096. One thread per ray, one pass over the K boxes
// that keeps the two smallest ranks in registers. Bound by FP32 operations
// (K slab tests per active ray).
//
// Built with --fmad=false: contracted multiply-adds would round grazing
// and edge hits differently from the plain version.

#include "resident_trace.cuh"

namespace {

using resident::Hit;
using resident::Ray;
using resident::Tables;

constexpr int kThreads = 128;

// K1 / K2: one thread per ray.
__global__ void __launch_bounds__(kThreads) closest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int32_t* __restrict__ out_tri,
    uint8_t* __restrict__ out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Hit h = {resident::kF32Max, 0.0f, 0.0f, -1, false};
  Ray r;
  if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
    h = resident::closest_hit(r, s);
  }
  out_t[i] = h.t;
  out_u[i] = h.u;
  out_v[i] = h.v;
  out_tri[i] = h.tri;
  out_hit[i] = h.hit ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) anyhit_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s,
    uint8_t* __restrict__ out_occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = false;
  Ray r;
  if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
    occ = resident::any_hit(r, s);
  }
  out_occ[i] = occ ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K9 / K10: a warp per ray (the design note above)

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTeamWarps = 4;                   // rays per block
constexpr int kTeamThreads = 32 * kTeamWarps;
constexpr int kRing = 64;                       // entered groups in flight
constexpr int kGroupsPerStep = 32 / resident::kGroup;
constexpr int kCandidates = 512;                // K9's buffered picks

// Shared memory of one team.
struct Team {
  int ring[kRing];
  float cand_en[kCandidates];
  int cand_k[kCandidates];
};

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
      s.mboxes + static_cast<size_t>(g) * resident::kGroup * 8 + 8 * (lane & 7));
  const float4 a = __ldg(mb), b = __ldg(mb + 1);
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  en = resident::slab_enter_box(r, lo, hi, b.z);
  k = resident::group_cid0(s, g) + (lane & 7);
}

// Appends this chunk's entered groups (lane j: group base + j) to the ring.
__device__ __forceinline__ void push_groups(const Ray& r, const Tables& s, float hz,
                                            int base, int lane, int* ring, int& tail) {
  const int g = base + lane;
  const float eg = g < s.kg ? resident::cluster_enter(r, s.gboxes, g, s.kg) : CUDART_INF_F;
  const bool in = eg <= hz && eg < CUDART_INF_F;
  const unsigned mask = __ballot_sync(kFull, in);
  if (in) ring[(tail + __popc(mask & lanes_below(lane))) & (kRing - 1)] = g;
  tail += __popc(mask);
  __syncwarp();
}

// K9's pass: every cluster entered at en <= hz after (last_en, last_k) in
// (enter, cluster) order. Returns their least (en, k) on every lane (k = -1:
// none) and their number; they are in the team's buffer when the number is
// at most kCandidates.
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

// K9's pick from a buffer that holds every candidate of its pass: the least
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
    if (resident::mt_test(l, tab, c, j, t) && t < l.tmax) {
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
    const bool hit = j < cnt && resident::mt_test(l, tab, c, j, t) && t < l.tmax;
    if (__any_sync(kFull, hit)) return true;
  }
  return false;
}

// K9's walk: K1's visits in K1's order; returns the winning slot (-1: none).
__device__ __forceinline__ int team_closest(const Ray& r, const Tables& s, int lane,
                                            Team& tm) {
  float best_t = resident::kF32Max;
  int best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  float hz = resident::horizon(r, best_t, best_slot);
  float next_en;
  int next_k;
  int count = closest_pass(r, s, hz, last_en, last_k, lane, tm, next_en, next_k);
  bool buffered = count <= kCandidates;
  while (next_k >= 0) {
    // instanced: the ray in this cluster's instance frame, per visit
    const resident::Ray l = s.xf ? resident::object_ray(r, s, next_k / s.kb) : r;
    team_visit_closest(l, s, next_k, lane, best_t, best_slot);
    last_en = next_en;
    last_k = next_k;
    hz = resident::horizon(r, best_t, best_slot);
    if (buffered) {
      buffered_pick(tm, count, hz, last_en, last_k, lane, next_en, next_k);
    } else {
      count = closest_pass(r, s, hz, last_en, last_k, lane, tm, next_en, next_k);
      buffered = count <= kCandidates;
    }
  }
  return best_slot;
}

// K10's walk: entered groups in index order, their entered members in index
// order, leaving at the first accepted hit.
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
        const resident::Ray l = s.xf ? resident::object_ray(r, s, k0 / s.kb) : r;
        if (team_visit_any(l, s, k0, lane)) return true;
      }
    }
  }
  return false;
}

__global__ void __launch_bounds__(kTeamThreads) grouped_closest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int32_t* __restrict__ out_tri,
    uint8_t* __restrict__ out_hit) {
  __shared__ Team teams[kTeamWarps];
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kTeamWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp
  const int i = static_cast<int>(row);
  Ray r;
  int slot = -1;
  if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
    slot = team_closest(r, s, lane, teams[threadIdx.x >> 5]);
  }
  if (lane != 0) return;
  const Hit h = slot >= 0 ? resident::refine(r, s, slot)
                          : Hit{resident::kF32Max, 0.0f, 0.0f, -1, false};
  out_t[i] = h.t;
  out_u[i] = h.u;
  out_v[i] = h.v;
  out_tri[i] = h.tri;
  out_hit[i] = h.hit ? 1 : 0;
}

__global__ void __launch_bounds__(kTeamThreads) grouped_anyhit_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s,
    uint8_t* __restrict__ out_occ) {
  __shared__ int rings[kTeamWarps][kRing];
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kTeamWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp
  const int i = static_cast<int>(row);
  Ray r;
  bool occ = false;
  if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
    occ = team_anyhit(r, s, lane, rings[threadIdx.x >> 5]);
  }
  if (lane == 0) out_occ[i] = occ ? 1 : 0;
}

Tables make_tables(const float* boxes, const float* table, const int32_t* tri_map,
                   const int32_t* counts, const float* scene_aabb, int nk, int c,
                   const float* xf, int kb, int tb, const float* gboxes,
                   const float* mboxes, int kg) {
  Tables s{boxes, table, tri_map, counts, scene_aabb, nk, c};
  s.xf = xf;  // nullptr: a flat scene
  s.kb = kb;
  s.tb = tb;
  s.gboxes = gboxes;
  s.mboxes = mboxes;
  s.kg = kg;
  return s;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }
int team_blocks(int n) { return static_cast<int>((n + kTeamWarps - 1LL) / kTeamWarps); }

// K9 / K10 read the member boxes as float4: the table must be 16-byte
// aligned.
bool group_tables_ok(const float* gboxes, const float* mboxes, int kg) {
  return gboxes != nullptr && mboxes != nullptr && kg >= 1 &&
         reinterpret_cast<uintptr_t>(mboxes) % 16 == 0;
}

constexpr int kClusterBits = 12;
constexpr int32_t kClusterMask = (1 << kClusterBits) - 1;
constexpr int32_t kNoRank = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads) schedule_keys_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, const float* __restrict__ boxes,
    const float* __restrict__ scene_aabb, int nk, int32_t* __restrict__ out_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  if (!resident::load_ray(i, o, d, tmin, tmax, active, scene_aabb, r)) {
    out_key[i] = kNoRank;
    return;
  }
  // ranks are distinct (their low bits are the cluster), so the two
  // smallest are the first and the second entered cluster
  int32_t r1 = kNoRank, r2 = kNoRank;
  for (int k = 0; k < nk; ++k) {
    const float en = resident::cluster_enter(r, boxes, k, nk);
    if (en == CUDART_INF_F) continue;
    const int32_t rank = (__float_as_int(en) & ~kClusterMask) | k;
    if (rank < r1) {
      r2 = r1;
      r1 = rank;
    } else if (rank < r2) {
      r2 = rank;
    }
  }
  const int32_t first = r1 != kNoRank ? (r1 & kClusterMask) : kClusterMask;
  const int32_t second = r2 != kNoRank ? (r2 & kClusterMask) : kClusterMask;
  out_key[i] = (first << kClusterBits) | second;
}

}  // namespace

// C entry points: launch on the caller's stream and return
// cudaGetLastError() (0 = launched). xf is nullptr for a flat scene; the
// grouped entry points need the group tables.
extern "C" int resident_closest(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* tri_map, const int32_t* counts, const float* scene_aabb,
    int nk, int c, const float* xf, int kb, int tb, float* out_t, float* out_u,
    float* out_v, int32_t* out_tri, uint8_t* out_hit, void* stream) {
  if (n > 0) {
    closest_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        make_tables(boxes, table, tri_map, counts, scene_aabb, nk, c, xf, kb, tb,
                    nullptr, nullptr, 0),
        out_t, out_u, out_v, out_tri, out_hit);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resident_anyhit(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* counts, const float* scene_aabb, int nk, int c,
    const float* xf, int kb, uint8_t* out_occ, void* stream) {
  if (n > 0) {
    anyhit_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        make_tables(boxes, table, nullptr, counts, scene_aabb, nk, c, xf, kb, 0,
                    nullptr, nullptr, 0),
        out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grouped_closest(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* tri_map, const int32_t* counts, const float* scene_aabb,
    int nk, int c, const float* xf, int kb, int tb, const float* gboxes,
    const float* mboxes, int kg, float* out_t, float* out_u, float* out_v,
    int32_t* out_tri, uint8_t* out_hit, void* stream) {
  if (!group_tables_ok(gboxes, mboxes, kg)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    grouped_closest_kernel<<<team_blocks(n), kTeamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        make_tables(boxes, table, tri_map, counts, scene_aabb, nk, c, xf, kb, tb,
                    gboxes, mboxes, kg),
        out_t, out_u, out_v, out_tri, out_hit);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grouped_anyhit(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* counts, const float* scene_aabb, int nk, int c,
    const float* xf, int kb, const float* gboxes, const float* mboxes, int kg,
    uint8_t* out_occ, void* stream) {
  if (!group_tables_ok(gboxes, mboxes, kg)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    grouped_anyhit_kernel<<<team_blocks(n), kTeamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        make_tables(boxes, table, nullptr, counts, scene_aabb, nk, c, xf, kb, 0,
                    gboxes, mboxes, kg),
        out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int schedule_keys(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* scene_aabb,
    int nk, int32_t* out_key, void* stream) {
  if (nk < 1 || nk > kClusterMask) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    schedule_keys_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n, boxes, scene_aabb, nk, out_key);
  }
  return static_cast<int>(cudaGetLastError());
}
