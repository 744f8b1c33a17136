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
// closest-hit and any-hit loops, the refinement), the flat team walks of K1
// / K2 and the warp walks of the two-level cull live in resident_trace.cuh,
// which the frame kernel (frame.cu) and the fused route (route.cu) share;
// K1, K2, K8, K9 and K10 here are thin wrappers that load one ray of a
// wavefront and store its record.
//
// What bounds K1 / K2 on an H100: FP32 operations. Each ray-triangle test
// is about 40 FP32 operations and reads 48 bytes of table that neighbouring
// rays share from cache, each cluster slab test about 30 operations; the
// bytes every call must move (rays in, records out, the table once) are
// far below the operations' time at 67 TFLOP/s FP32.
//
// Design: a team of W lanes walks one ray (flat_team_closest /
// flat_team_anyhit in resident_trace.cuh): lane j slab-tests clusters j, j
// + W, ... of the box table in one pass whose entered clusters fill a
// per-team candidate buffer in shared memory, every later pick comes from
// that buffer, and a visit spreads the cluster's slots over the lanes. So
// a ray's work is spread over W lanes and a launch brings W times the
// threads: 8 lanes for K1 (4 rays a warp: fewer idle lanes on small
// clusters and few boxes), a warp for K2 (whose visits leave at the first
// hit). At one cluster on a large launch a lane walks its own ray instead
// (closest_hit / any_hit, the walks K3 and K7 run too): there a team would
// repeat its ray's set-up on every lane and wait on one lane's refinement,
// and the launch fills the card without teams. The wrapper picks the walk
// per launch from K and N (ops/resident.py flat_lanes). A team visits
// closest_hit's clusters in its order (K1) or ORs any_hit's entered
// clusters (K2), so both walks' results are equal bit for bit. What bounds
// the team walks (PERF.md): 21-39x the bound on the statues (K = 45-46),
// the box pass and picks a third of a team's cycles.
//
// K9 grouped_closest replaces _kernel_grouped and _kernel_grouped_hbm
// (pallas_call at :2269); K10 grouped_anyhit replaces _occl_kernel_grouped
// and _occl_kernel_grouped_hbm. They compute K1's and K2's functions through
// the two-level cull of _grouped_recull_loop / _grouped_occl_loop /
// _member_enters over groups of 8 clusters, and equal K1 / K2 bit for bit.
//
// What bounds them on an H100: latency, not arithmetic. Walked by one
// thread per ray (their first design), every pick is a serial pass over
// all Kg group boxes (Kg = 1,488 on the 4.2M-triangle instanced scene) and
// a visit a serial loop over up to C = 512 triangles, lanes whose rays
// open different groups or clusters serialise, and a 65,536-row launch
// brings 15.5 warps an SM, so nothing hides the loads: 52-2,107x the
// bound, 48-95 % of the thread cycles in the cull passes (PERF.md, measured
// with cycle counters). The work itself is within a few times its bound.
//
// Design: a warp per ray (a team of 32 lanes), so a launch of N rays brings
// N warps, and the work of one ray is spread over lanes: the warp walks of
// resident_trace.cuh (team_closest / team_anyhit; their design note says how
// the group pass, the candidate buffer and the cluster visits are spread),
// which K3 and K7 run in their grouped mode too. K9's visits are K1's, in
// K1's order, and K10 visits K2's entered clusters in index order, so they
// equal K1 / K2 bit for bit. An inactive ray's warp writes its miss and
// exits at once.
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
// sort last. Needs K < 4096. Bound by FP32 operations: each active ray's
// least cull, K slab tests or the group boxes and the members of the groups
// that can hold its first two clusters.
//
// Design of K8: a warp per ray. Its first design ran a thread per ray over
// all K boxes: on the sparse wavefronts the stages hand over (a rooms_p8
// partition's bounce-1 buffer of 65,536 rows holds 1-4 % live rows, which
// lie together) a few dozen warps each walked K ~ 1,500 boxes one after
// another at the latency of a global load (about 340 cycles a box), and a
// dense launch brought 16 warps an SM. Now each ray is a warp, so a dead
// row costs one flag load and one store and the live rays spread over the
// card wherever they lie in the buffer. (A block that compacted its 64
// rows' live rays for its 8 warps left those concentrated rows to a few
// blocks: 0.076 ms on the rooms buffer, PERF.md.) Where the dispatch rule
// takes the grouped kernels (ops/resident.py use_grouped), the lanes test
// the group boxes, 32 at a time, and then the members of the groups the ray
// enters, 32 a step (a ray of neural_route_64k enters 6.8 of 92 groups,
// of neural_route_1m 13.6 of 379: PERF.md); else they test clusters k = lane,
// lane + 32, ..., four boxes at a time with their loads in flight. Each
// lane keeps its own two smallest ranks without a branch, and a butterfly
// of shuffles gives the warp's two smallest. A cluster the ray enters lies
// in a group it enters, the ranks are distinct and their order of arrival
// does not change the key, and every rank comes from the same slab
// arithmetic (resident_trace.cuh, --fmad=false): the keys equal the plain
// version's on every ray in both modes.
//
// Built with --fmad=false: contracted multiply-adds would round grazing
// and edge hits differently from the plain version.

#include "cycles.cuh"
#include "resident_trace.cuh"

namespace {

using resident::Hit;
using resident::Ray;
using resident::Tables;

// K1 / K2: W lanes a ray (the design note above), kFlatThreads threads a
// block. Two instances each: W = 1 (a lane walks its own ray) and a team,
// kClosestTeam lanes for K1, kAnyhitTeam for K2 (the widths that won on the
// card: PERF.md).
constexpr int kClosestTeam = 8;
constexpr int kAnyhitTeam = 32;
constexpr int kFlatThreads = 128;

template <int W>
__global__ void __launch_bounds__(kFlatThreads) closest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int32_t* __restrict__ out_tri,
    uint8_t* __restrict__ out_hit) {
  constexpr int kRays = kFlatThreads / W;
  const int team = threadIdx.x / W;
  const long long row = static_cast<long long>(blockIdx.x) * kRays + team;
  if (row >= n) return;  // the whole team
  const int i = static_cast<int>(row);
  Ray r;
  const bool live = resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r);
  Hit h = {resident::kF32Max, 0.0f, 0.0f, -1, false};
  if constexpr (W == 1) {
    if (live) h = resident::closest_hit(r, s);
  } else {
    __shared__ resident::FlatBuf bufs[kRays];
    CYCLES_NOW(t_walk);
    const resident::Lanes<W> tl(threadIdx.x & 31);
    const bool sample = tl.t == 0 && i % resident::kFlatSample == 0;
    const int slot = live ? resident::flat_team_closest(r, s, tl, bufs[team], sample) : -1;
    if (tl.t != 0) return;
    CYCLES_NOW(t_refine);
    if (slot >= 0) h = resident::refine(r, s, slot);
    if (sample && live) {
      CYCLES_ADD(resident::kFlatRefine, t_refine);
      CYCLES_ADD(resident::kFlatWalk, t_walk);
      CYCLES_COUNT(resident::kFlatRays, 1);
    }
  }
  out_t[i] = h.t;
  out_u[i] = h.u;
  out_v[i] = h.v;
  out_tri[i] = h.tri;
  out_hit[i] = h.hit ? 1 : 0;
}

template <int W>
__global__ void __launch_bounds__(kFlatThreads) anyhit_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s,
    uint8_t* __restrict__ out_occ) {
  // the lane walk keeps the first design's kernel body: the team walk's
  // indexing in its place ran 1-8 % slower on cornell's shadow rays
  // (PERF.md)
  if constexpr (W == 1) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bool occ = false;
    Ray r;
    if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
      occ = resident::any_hit(r, s);
    }
    out_occ[i] = occ ? 1 : 0;
  } else {
    constexpr int kRays = kFlatThreads / W;
    const resident::Lanes<W> tl(threadIdx.x & 31);
    const long long row = static_cast<long long>(blockIdx.x) * kRays + threadIdx.x / W;
    if (row >= n) return;  // the whole team
    const int i = static_cast<int>(row);
    Ray r;
    bool occ = false;
    if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
      occ = resident::flat_team_anyhit(r, s, tl);
    }
    if (tl.t == 0) out_occ[i] = occ ? 1 : 0;
  }
}

// blocks of kFlatThreads for n rays at `lanes` lanes a ray
int flat_blocks(int n, int lanes) {
  const int rays = kFlatThreads / lanes;
  return static_cast<int>((n + rays - 1LL) / rays);
}

// ---------------------------------------------------------------------------
// K9 / K10: a warp per ray (the design note above)

using resident::Team;

constexpr int kTeamWarps = 4;                   // rays per block
constexpr int kTeamThreads = 32 * kTeamWarps;

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
    slot = resident::team_closest(r, s, lane, teams[threadIdx.x >> 5]);
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
  __shared__ int rings[kTeamWarps][resident::kRing];
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kTeamWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp
  const int i = static_cast<int>(row);
  Ray r;
  bool occ = false;
  if (resident::load_ray(i, o, d, tmin, tmax, active, s.scene_aabb, r)) {
    occ = resident::team_anyhit(r, s, lane, rings[threadIdx.x >> 5]);
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

int team_blocks(int n) { return static_cast<int>((n + kTeamWarps - 1LL) / kTeamWarps); }

constexpr int kClusterBits = 12;
constexpr int32_t kClusterMask = (1 << kClusterBits) - 1;
constexpr int32_t kNoRank = 0x7FFFFFFF;

// K8: a warp per ray, kKeyWarps rays a block (the design note above)
constexpr int kKeyWarps = 8;
constexpr int kKeyThreads = 32 * kKeyWarps;
// boxes a lane of the flat mode loads before it tests them (their loads in
// flight together)
constexpr int kKeyBatch = 4;
// counters of a -DPG_CYCLES build (csrc/cycles.cuh), kept for one row in
// kKeysSample so that their atomics stay few: the live warps' cycles in the
// box tests, every warp's cycles, the live rays and the warps
constexpr int kKeysLoop = 0, kKeysWarp = 1, kKeysLive = 2, kKeysWarps = 3;
constexpr int kKeysSample = 8;

// A cluster's rank (enter bits with the low 12 bits cleared, then the
// cluster) into a lane's two smallest, without a branch.
__device__ __forceinline__ void keep_rank(float en, int k, int32_t& r1, int32_t& r2) {
  const int32_t rank = en == CUDART_INF_F ? kNoRank : (__float_as_int(en) & ~kClusterMask) | k;
  const int32_t above = max(r1, rank);
  r1 = min(r1, rank);
  r2 = min(r2, above);
}

// Flat mode: lane l tests clusters l, l + 32, ... of the (8, K) box table.
__device__ __forceinline__ void lane_ranks_flat(const Ray& r, const Tables& s, int lane,
                                                int32_t& r1, int32_t& r2) {
  for (int k0 = lane; k0 < s.nk; k0 += 32 * kKeyBatch) {
    float b[kKeyBatch][7];
#pragma unroll
    for (int u = 0; u < kKeyBatch; ++u) {
      const float* bk = s.boxes + min(k0 + 32 * u, s.nk - 1);
#pragma unroll
      for (int q = 0; q < 7; ++q) b[u][q] = __ldg(bk + q * s.nk);
      if (k0 + 32 * u >= s.nk) b[u][6] = 0.0f;  // past the last cluster: not entered
    }
#pragma unroll
    for (int u = 0; u < kKeyBatch; ++u) {
      const float lo[3] = {b[u][0], b[u][1], b[u][2]};
      const float hi[3] = {b[u][3], b[u][4], b[u][5]};
      keep_rank(resident::slab_enter_box(r, lo, hi, b[u][6]), k0 + 32 * u, r1, r2);
    }
  }
}

// Grouped mode: the lanes test 32 group boxes at a time, and the members of
// the groups the ray enters, 4 groups (32 members) a step, through the warp
// walks' push_groups / member_enter. A cluster the ray enters lies in a
// group it enters (the group box contains its members and the slab
// arithmetic is monotone in the bounds), so every entered cluster is ranked
// and each once: padding members carry flag 0.
__device__ __forceinline__ void lane_ranks_grouped(const Ray& r, const Tables& s, int lane,
                                                   int* ring, int32_t& r1, int32_t& r2) {
  int head = 0, tail = 0;
  for (int base = 0; base < s.kg; base += 32) {
    resident::push_groups(r, s, CUDART_INF_F, base, lane, ring, tail);
    for (; head < tail; head = min(head + resident::kGroupsPerStep, tail)) {
      float en;
      int k;
      resident::member_enter(r, s, ring, head, tail, lane, en, k);
      keep_rank(en, k, r1, r2);
    }
    __syncwarp();  // the ring's slots are read before the next push
  }
}

__global__ void __launch_bounds__(kKeyThreads) schedule_keys_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, int n, Tables s, int32_t* __restrict__ out_key) {
  CYCLES_NOW(t_warp);
  __shared__ int rings[kKeyWarps][resident::kRing];
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kKeyWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp
  const int i = static_cast<int>(row);
  // the flag and the ray in one round trip (load_ray reads the ray after
  // the flag), then load_ray's scene-exit cap
  const bool live = active[i] != 0;
  Ray r;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    r.o[ax] = o[3 * i + ax];
    r.d[ax] = d[3 * i + ax];
  }
  const float t0 = tmin[i], t1 = tmax[i];
  if (live) {
    resident::cap_ray(r, t0, t1, s.scene_aabb);
    CYCLES_NOW(t_loop);
    int32_t r1 = kNoRank, r2 = kNoRank;
    if (s.gboxes != nullptr) {
      lane_ranks_grouped(r, s, lane, rings[threadIdx.x >> 5], r1, r2);
    } else {
      lane_ranks_flat(r, s, lane, r1, r2);
    }
    // the warp's two smallest: the lanes' clusters are disjoint and their
    // ranks distinct
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t b1 = __shfl_xor_sync(resident::kFull, r1, off);
      const int32_t b2 = __shfl_xor_sync(resident::kFull, r2, off);
      r2 = min(max(r1, b1), min(r2, b2));
      r1 = min(r1, b1);
    }
    if (lane == 0) {
      const int32_t first = r1 != kNoRank ? (r1 & kClusterMask) : kClusterMask;
      const int32_t second = r2 != kNoRank ? (r2 & kClusterMask) : kClusterMask;
      out_key[i] = (first << kClusterBits) | second;
      if (i % kKeysSample == 0) {
        CYCLES_ADD(kKeysLoop, t_loop);
        CYCLES_COUNT(kKeysLive, 1);
      }
    }
  } else if (lane == 0) {
    out_key[i] = kNoRank;
  }
  if (lane == 0 && i % kKeysSample == 0) {
    CYCLES_ADD(kKeysWarp, t_warp);
    CYCLES_COUNT(kKeysWarps, 1);
  }
}

}  // namespace

// C entry points: launch on the caller's stream and return
// cudaGetLastError() (0 = launched). xf is nullptr for a flat scene; the
// grouped entry points need the group tables. K1 / K2 take `lanes`, the
// lanes that walk a ray: 1, or kClosestTeam (K1) / kAnyhitTeam (K2).
extern "C" int resident_closest(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* tri_map, const int32_t* counts, const float* scene_aabb,
    int nk, int c, const float* xf, int kb, int tb, int lanes, float* out_t,
    float* out_u, float* out_v, int32_t* out_tri, uint8_t* out_hit, void* stream) {
  if (lanes != 1 && lanes != kClosestTeam) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const Tables s = make_tables(boxes, table, tri_map, counts, scene_aabb, nk, c, xf, kb, tb,
                                 nullptr, nullptr, 0);
    auto kernel = lanes == 1 ? closest_kernel<1> : closest_kernel<kClosestTeam>;
    kernel<<<flat_blocks(n, lanes), kFlatThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n, s, out_t, out_u, out_v, out_tri, out_hit);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resident_anyhit(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* counts, const float* scene_aabb, int nk, int c,
    const float* xf, int kb, int lanes, uint8_t* out_occ, void* stream) {
  if (lanes != 1 && lanes != kAnyhitTeam) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const Tables s = make_tables(boxes, table, nullptr, counts, scene_aabb, nk, c, xf, kb, 0,
                                 nullptr, nullptr, 0);
    auto kernel = lanes == 1 ? anyhit_kernel<1> : anyhit_kernel<kAnyhitTeam>;
    kernel<<<flat_blocks(n, lanes), kFlatThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n, s, out_occ);
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
  if (!resident::group_tables_ok(gboxes, mboxes, kg)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!resident::group_tables_ok(gboxes, mboxes, kg)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    grouped_anyhit_kernel<<<team_blocks(n), kTeamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        make_tables(boxes, table, nullptr, counts, scene_aabb, nk, c, xf, kb, 0,
                    gboxes, mboxes, kg),
        out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// gboxes nullptr: the flat mode; else the grouped mode over the group tables
// (xf tells an instanced scene's group layout).
extern "C" int schedule_keys(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* scene_aabb,
    int nk, const float* xf, int kb, const float* gboxes, const float* mboxes, int kg,
    int32_t* out_key, void* stream) {
  if (nk < 1 || nk > kClusterMask) return static_cast<int>(cudaErrorInvalidValue);
  if (gboxes != nullptr && !resident::group_tables_ok(gboxes, mboxes, kg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    schedule_keys_kernel<<<static_cast<int>((n + kKeyWarps - 1LL) / kKeyWarps), kKeyThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        make_tables(boxes, nullptr, nullptr, nullptr, scene_aabb, nk, 0, xf, kb, 0, gboxes,
                    mboxes, gboxes != nullptr ? kg : 0),
        out_key);
  }
  return static_cast<int>(cudaGetLastError());
}
