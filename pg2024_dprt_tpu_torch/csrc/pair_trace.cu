// Streaming pair tracer for Hopper (sm_90a): closest hit (K11 pair_closest),
// any hit (K12 pair_anyhit) and the Woop-transform closest hit (K13
// pair_woop), bound to PyTorch through a plain C interface (ctypes).
//
// K11 replaces the JAX package's pallas_tracer.py::_kernel, K12 its
// _occl_kernel and K13 its _woop_kernel (pallas_calls at :530 and :540). The
// TPU grid walks a global pool of (tile, cluster) pair slots, pp slots per
// step, revisiting one tile's output block for all the steps of its region;
// each slot's triangle row (cl_tri_table, 10*C floats, or cl_woop_table's
// 16*C) is streamed into VMEM by the scalar-prefetched cluster id.
// ops/tracer.py prepares the regions: the interval cull, the front-to-back
// order, the budget. A tile that did not fit the budget writes a miss.
//
// The function. Each ray's winner is the least t below its capped tmax over
// the listed slots of its tile's region; among equal t the earliest slot of
// the region, then the lowest lane j of the cluster: the lexicographic
// (t, slot position, j) minimum, which the TPU kernels' sequential strict
// improvement (min + lowest lane) selects. The id is cl_tri_map[slot]
// (int32), not the f32 tmap row, which is exact only below 2^24; tmap >= 0
// stays the validity test.
//
// K11 and K13: the walk split across the card.
//   * What bounds them (and K12). About 40 FP32 operations a ray-triangle
//     test, at half the FMA peak (the library is built with --fmad=false,
//     so that every kernel rounds as its plain version; a mul-add is two
//     instructions), plus the correctly rounded divide, the comparisons
//     and the loads. A block a tile would last as long as its longest
//     tile, whose region may walk several times the mean, on one SM; so
//     the walk is split into units small enough to spread every region
//     over the whole card, and what is left is the per-slot work of a unit
//     (the metadata, the horizon ballot, the staging, the key traffic) and
//     the start-up of its pieces.
//   * Units. A warp holds 32 rays of a tile (one a lane) and one of up to
//     kShares contiguous shares of each cluster's C triangles (about kChunk
//     triangles a share, a multiple of 4), and walks one of up to kPieces
//     contiguous pieces of the tile's region (at least kMinPiece slots
//     each). The grid enumerates (piece, tile, ray group, share)
//     piece-major, so the block scheduler hands out the first pieces of
//     every region before the later ones, and a later piece mostly finds
//     the earlier pieces' hits published.
//   * Merge. Each ray's best is a 64-bit key, t's bits made order-preserving
//     (-0 taken as +0) above the slot's position in its region, lowered by
//     atomicMin after each walked slot that improved it (the keys are set to
//     all ones first). A unit keeps its own running best (t, position),
//     initialised to (capped tmax, -1) and merged with the ray's published
//     key at the start of each slot (read one slot ahead, from L2). A test
//     is accepted when its t is below the best's, or equal to it while the
//     best is a later position's: an earlier position wins a tie at equal
//     t, and within a slot the lowest lane of a share.
//   * Horizon. A slot is skipped when no lane's best is above (enter,
//     position): enter is the tile's conservative lower bound of t in the
//     cluster, so it holds for any 32 of its rays, and a best taken from a
//     later position is beaten by a tie. A warp's decision is a ballot, with
//     no barrier.
//   * Staging. The slot's flags, enter and cluster are read 32 slots at a
//     time, a slot a lane, and move to the walk by shuffles. Each warp has
//     a ring of two stages in shared memory of at most 32 triangles of its
//     share (10 planes, or the 13 of the 16 Woop planes the test reads);
//     the next chunk, or the first chunk of the next listed slot that the
//     horizon keeps, is in flight by cp.async while the current one is
//     tested. 16-byte copies where C % 4 == 0 (4-byte ones otherwise).
//     Once a chunk has landed, a lane a triangle replaces v1 and v2 by the
//     edges (the same subtractions, once for the 32 rays) and sets tmap to
//     -1 past the chunk's end, so that the test reads 4 neighbouring
//     triangles of a plane with one 16-byte load (the rows are
//     component-planar) and the tail fails tmap >= 0.
//   * Resolve. A second kernel, a warp a ray, reads the winning key, tests
//     the winning slot's C triangles with the same arithmetic and takes the
//     lowest lane whose accepted t equals the key's: the winner's t, u, v
//     bits, and its id. A ray with no key returns its capped tmax. The key
//     holds the slot's position, not its lane, so it fits any region of
//     the int32 budget.
//   * The reciprocals 1/det and 1/d'z stay correctly rounded, as the plain
//     versions compute them on the CPU, with their range check and slow
//     path. No early rejection.
//
// K12: the same units, slot metadata and staging (decode_unit, Slots,
// fetch_chunk and walk_piece are shared), with an occlusion flag a ray in
// place of the key.
//   * Units of one share (kAnyShares): a ray found occluded in a chunk is
//     closed for the slot's later chunks at once, and the slot scan and
//     its box tests run once for a group's rays, not once a share.
//   * A team loop. In a chunk a lane holds one triangle (its planes and
//     edges in registers, read from the stage without bank conflicts) and
//     the warp takes its open rays in turn, each read from shared memory by
//     broadcast: every lane tests its triangle, a ballot says whether the
//     ray is occluded. A ray is open for a slot while it is active, not
//     yet occluded, its capped tmax lies above the slot's enter (no
//     triangle of the slot lies nearer, the assumption K11's horizon
//     makes), and its own segment may enter the cluster's box, grown by
//     2^-14 of its magnitude and extent (a tile's rays share its pair
//     list, but an incoherent ray passes through few of its boxes). A
//     chunk costs as many warp steps as it has open rays, a slot no step
//     and no copy when no ray is open, and a unit ends when none is left.
//   * Publication. out_occ, zeroed by the entry, is the output and the
//     shared state: a unit stores 1 for the rays it finds occluded and
//     reads its rays' bytes from L2 a slot ahead, so later pieces (and
//     other shares, where there are several) drop rays already found. OR
//     is order-free: no key, no resolve pass.
//
// The tests:
//   * K11 / K12 compute the edges (e1 = v1 - v0, e2 = v2 - v0) and run the
//     TPU kernels' Moller-Trumbore: p = d x e2, det = e1.p, u = s.p / det,
//     q = s x e1, v = d.q / det, t = e2.q / det.
//   * K13 moves the ray into each triangle's unit space, o' = [o, 1] W and
//     d' = [d, 0] W, from the JAX (4, 4*C) block layout as explicit FP32
//     sums in a fixed order (no tensor cores: TF32 loses grazing hits, and
//     the TPU's HIGHEST-precision MXU path was slower than its VPU one),
//     then t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y with the
//     |d'z| > 1e-12 and eps = 1e-5 tests (pallas_tracer.py:90-107).
// Every operation is written as in the plain versions in ops/tracer.py, so
// kernel and plain version agree ray for ray.

#include <math_constants.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;  // tile_rays / 32, at most (JAX's tiles)
constexpr int kWalkWarps = 4;  // warps of a walk block
constexpr int kChunk = 32;     // triangles of a staged chunk
constexpr int kShares = 4;     // K11 / K13: shares of a cluster's triangles, at most
constexpr int kAnyShares = 1;  // K12: a unit walks all of a slot's triangles
constexpr int kPieces = 32;    // pieces of a tile's region, at most
constexpr int kMinPiece = 2;   // slots of a piece, at least
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoHit = ~0ull;

struct Pairs {
  const int32_t* tile_offset;  // (T,) first slot of each tile's region
  const int32_t* tile_region;  // (T,) slots of each tile's region
  const uint8_t* tile_fit;     // (T,) the region's first step fits the budget
  const int32_t* cluster;      // (budget,) cluster of each slot
  const int32_t* flags;        // (budget,) bit 0 init, bit 1 pair present
  const int32_t* enter;        // (budget,) conservative enter distance, int bits
  int budget;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* rays, int64_t r) {
  const float* p = rays + r * 8;
  return Ray{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

struct Test {
  float t, u, v;
  bool inside;  // accepted, before the comparison with the running best
};

// Moller-Trumbore of one triangle (ops/tracer.py _mt) from v0 and its edges
// e1 = v1 - v0, e2 = v2 - v0
__device__ __forceinline__ Test mt_edges(const Ray& r, float t0x, float t0y, float t0z,
                                         float e1x, float e1y, float e1z, float e2x, float e2y,
                                         float e2z, float tmap) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > 1e-12f;
  // as the plain version computes it: 1 / where(ok, det, 1)
  const float inv_det = ok ? 1.0f / (ok ? det : 1.0f) : 0.0f;
  const float tx = r.ox - t0x, ty = r.oy - t0y, tz = r.oz - t0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return Test{t, u, v,
              ok && tmap >= 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin};
}

// the same from the vertices
__device__ __forceinline__ Test mt_test(const Ray& r, float t0x, float t0y, float t0z,
                                        float v1x, float v1y, float v1z, float v2x, float v2y,
                                        float v2z, float tmap) {
  return mt_edges(r, t0x, t0y, t0z, v1x - t0x, v1y - t0y, v1z - t0z, v2x - t0x, v2y - t0y,
                  v2z - t0z, tmap);
}

// the Woop unit-space test of one triangle (ops/tracer.py _woop): w[q][p]
// is row q (input x, y, z, 1) of output column p (x', y', z'); tmap is
// row 3 of column 3
__device__ __forceinline__ Test woop_test(const Ray& r, const float (&w)[4][3], float tmap) {
  const float opx = r.ox * w[0][0] + r.oy * w[1][0] + r.oz * w[2][0] + w[3][0];
  const float opy = r.ox * w[0][1] + r.oy * w[1][1] + r.oz * w[2][1] + w[3][1];
  const float opz = r.ox * w[0][2] + r.oy * w[1][2] + r.oz * w[2][2] + w[3][2];
  const float dpx = r.dx * w[0][0] + r.dy * w[1][0] + r.dz * w[2][0];
  const float dpy = r.dx * w[0][1] + r.dy * w[1][1] + r.dz * w[2][1];
  const float dpz = r.dx * w[0][2] + r.dy * w[1][2] + r.dz * w[2][2];
  const bool dz_ok = fabsf(dpz) > 1e-12f;
  const float inv_dz = dz_ok ? 1.0f / (dz_ok ? dpz : 1.0f) : 0.0f;
  const float t = -opz * inv_dz;
  const float u = opx + t * dpx;
  const float v = opy + t * dpy;
  return Test{t, u, v,
              dz_ok && tmap >= 0.0f && u >= -1e-5f && v >= -1e-5f && u + v <= 1.00001f &&
                  t > r.tmin};
}

// the planes a test reads: cl_tri_table's 10 (v0, v1, v2 by component,
// tmap); of cl_woop_table's 16 (row q, column p at (4q + p) * C), the 12 of
// columns x', y', z' and tmap (row 3, column 3)
template <bool WOOP>
struct Planes {
  static constexpr int kCount = WOOP ? 13 : 10;
  static constexpr int kWidth = WOOP ? 16 : 10;  // row width in units of C
  __device__ static int offset(int plane) {  // in units of C
    return WOOP ? (plane < 12 ? (plane / 3) * 4 + plane % 3 : 15) : plane;
  }
};

// the test of one triangle from its planes; EDGES: cl_tri_table's planes
// 3-8 hold e1 and e2 in place of v1 and v2
template <bool WOOP, bool EDGES = false>
__device__ __forceinline__ Test plane_test(const Ray& r, const float (&pl)[Planes<WOOP>::kCount]) {
  if constexpr (WOOP) {
    const float w[4][3] = {{pl[0], pl[1], pl[2]}, {pl[3], pl[4], pl[5]},
                           {pl[6], pl[7], pl[8]}, {pl[9], pl[10], pl[11]}};
    return woop_test(r, w, pl[12]);
  } else if constexpr (EDGES) {
    return mt_edges(r, pl[0], pl[1], pl[2], pl[3], pl[4], pl[5], pl[6], pl[7], pl[8], pl[9]);
  } else {
    return mt_test(r, pl[0], pl[1], pl[2], pl[3], pl[4], pl[5], pl[6], pl[7], pl[8], pl[9]);
  }
}

// t's bits made order-preserving as an unsigned integer; -0 is taken as +0
// (equal t compare equal, and the slot order decides)
__device__ __forceinline__ uint32_t ordered(float t) {
  const uint32_t b = t == 0.0f ? 0u : __float_as_uint(t);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// (t, position) below (bt, bp) lexicographically
__device__ __forceinline__ bool below(float t, int p, float bt, int bp) {
  return t < bt || (t == bt && p < bp);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes16) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

struct Job {
  int pos;  // the slot's position in its region; -1: none
  int enter;
  int cluster;
  int chunk;
};

// A unit of a walk: warp `unit` of the grid as (piece, tile, ray group,
// share), piece-major; the piece's positions [a, b) in the region that
// starts at slot s0, the share's triangles [j0, j1) and its chunks, the
// lane's ray r. False when the unit has nothing to walk.
struct Unit {
  int tile, s0, a, b, j0, j1, chunks;
  int64_t r;
};

__device__ __forceinline__ bool decode_unit(int64_t unit, const Pairs& pairs, int tiles,
                                            int tile_rays, int c, int subsets, int lane,
                                            Unit& u) {
  const int groups = tile_rays >> 5;
  const int share_id = static_cast<int>(unit % subsets);
  unit /= subsets;
  const int group = static_cast<int>(unit % groups);
  unit /= groups;
  u.tile = static_cast<int>(unit % tiles);
  const int64_t piece = unit / tiles;
  if (piece >= kPieces || !pairs.tile_fit[u.tile]) return false;
  u.s0 = pairs.tile_offset[u.tile];
  const int len = static_cast<int>(
      max(int64_t{0}, min(static_cast<int64_t>(pairs.tile_region[u.tile]),
                          static_cast<int64_t>(pairs.budget) - u.s0)));
  const int per = max(kMinPiece, (len + kPieces - 1) / kPieces);
  if (piece * per >= len) return false;
  u.a = static_cast<int>(piece * per);
  u.b = min(len, u.a + per);
  const int share = ((c + subsets - 1) / subsets + 3) & ~3;
  u.j0 = share_id * share;
  if (u.j0 >= c) return false;
  u.j1 = min(c, u.j0 + share);
  u.chunks = (u.j1 - u.j0 + kChunk - 1) / kChunk;
  u.r = static_cast<int64_t>(u.tile) * tile_rays + group * 32 + lane;
  return true;
}

// The listed slots of a unit's piece: flags, enter and cluster read 32
// positions at a time, a lane each, handed to the walk by ballot and
// shuffles.
struct Slots {
  const Pairs& pairs;
  const Unit& u;
  int lane;
  int base, m_enter, m_cluster;
  unsigned listed;

  __device__ __forceinline__ void load() {
    const int pos = base + lane;
    bool in = pos < u.b;
    m_enter = 0;
    m_cluster = 0;
    if (in) {
      in = (pairs.flags[u.s0 + pos] & 2) != 0;
      m_enter = pairs.enter[u.s0 + pos];
      m_cluster = pairs.cluster[u.s0 + pos];
    }
    listed = __ballot_sync(kFull, in);
  }

  // the next listed slot after position `after` that keep(enter, position,
  // cluster) lets some lane walk; cluster() is the slot's cluster (a
  // shuffle, every lane calls it or none)
  template <class Keep>
  __device__ __forceinline__ Job next(int after, Keep keep) {
    for (;;) {
      const int skip = after - base + 1;
      unsigned cand = skip <= 0 ? listed : (skip >= 32 ? 0u : listed & (kFull << skip));
      while (cand) {
        const int i = __ffs(cand) - 1;
        const int e = __shfl_sync(kFull, m_enter, i);
        const auto cluster = [&] { return __shfl_sync(kFull, m_cluster, i); };
        if (__any_sync(kFull, keep(__int_as_float(e), base + i, cluster)))
          return Job{base + i, e, cluster(), 0};
        cand &= cand - 1;
      }
      if (base + 32 >= u.b) return Job{-1, 0, 0, 0};
      base += 32;
      after = base - 1;
      load();
    }
  }
};

// cp.async of one chunk of the share (at most kChunk triangles of each of
// the planes a test reads) into a stage
template <bool WOOP>
__device__ __forceinline__ void fetch_chunk(const float* table, int c, int vec, const Unit& u,
                                            const Job& job, float* stage, int lane) {
  using P = Planes<WOOP>;
  const int jb = u.j0 + job.chunk * kChunk;
  const int n = min(kChunk, u.j1 - jb);
  const float* row = table + job.cluster * (static_cast<int64_t>(P::kWidth) * c) + jb;
  if (vec) {  // 16-byte copies: 4 triangles of a plane
    const int quads = n >> 2;
#pragma unroll
    for (int i = lane; i < P::kCount * 8; i += 32) {
      const int pl = i >> 3, k = i & 7;
      if (k < quads) cp_async(stage + pl * kChunk + 4 * k, row + P::offset(pl) * c + 4 * k, 1);
    }
  } else if (lane < n) {
#pragma unroll
    for (int pl = 0; pl < P::kCount; ++pl)
      cp_async(stage + pl * kChunk + lane, row + P::offset(pl) * c + lane, 0);
  }
}

// The walk of one unit over its piece, shared by K11 / K13 and K12: the
// slots that keep(enter, position, cluster) lets some lane walk, chunk by
// chunk, in the warp's ring of two stages (the next chunk in flight by cp.async
// while the current one is tested). At a slot's first chunk, start(job)
// merges what other units published and says whether the warp walks the
// slot; test(stage, n, job) tests a landed chunk of n triangles.
template <bool WOOP, class Keep, class Start, class TestChunk>
__device__ __forceinline__ void walk_piece(const Pairs& pairs, const Unit& u, const float* table,
                                           int c, int vec,
                                           float (*stages)[Planes<WOOP>::kCount * kChunk],
                                           int lane, Keep keep, Start start, TestChunk test) {
  Slots slots{pairs, u, lane, u.a, 0, 0, 0u};
  slots.load();
  Job cur = slots.next(u.a - 1, keep);
  if (cur.pos >= 0) fetch_chunk<WOOP>(table, c, vec, u, cur, stages[0], lane);
  asm volatile("cp.async.commit_group;\n" ::);
  int st = 0;
  bool walk = false;
  while (cur.pos >= 0) {
    if (cur.chunk == 0) walk = start(cur);
    const Job nxt = (walk && cur.chunk + 1 < u.chunks)
                        ? Job{cur.pos, cur.enter, cur.cluster, cur.chunk + 1}
                        : slots.next(cur.pos, keep);
    if (nxt.pos >= 0) fetch_chunk<WOOP>(table, c, vec, u, nxt, stages[st ^ 1], lane);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    if (walk) test(stages[st], min(kChunk, u.j1 - (u.j0 + cur.chunk * kChunk)), cur);
    __syncwarp();
    cur = nxt;
    st ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// K11 (WOOP false) and K13 (WOOP true): the closest-hit walk
template <bool WOOP>
__global__ void __launch_bounds__(kWalkWarps * 32)
    pair_walk_kernel(const float* __restrict__ rays, Pairs pairs, int tiles, int tile_rays,
                     const float* __restrict__ table, int c, int vec, int subsets,
                     unsigned long long* __restrict__ keys,
                     unsigned long long* __restrict__ counters) {
  using P = Planes<WOOP>;
  constexpr int kStage = P::kCount * kChunk;
  __shared__ __align__(16) float stages[kWalkWarps][2][kStage];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Unit u;
  if (!decode_unit(static_cast<int64_t>(blockIdx.x) * kWalkWarps + warp, pairs, tiles,
                   tile_rays, c, subsets, lane, u))
    return;
  const int64_t r = u.r;
  const Ray ray = load_ray(rays, r);
  float bt = ray.tmax;  // the running best (t, position); -1: nothing below tmax
  int bp = -1;
  auto merge = [&](unsigned long long key) {
    if (key != kNoHit) {
      const float kt = unordered(static_cast<uint32_t>(key >> 32));
      const int kp = static_cast<int>(key & 0xffffffffu);
      if (below(kt, kp, bt, bp)) {
        bt = kt;
        bp = kp;
      }
    }
  };
  merge(__ldcg(keys + r));
  unsigned long long snap = kNoHit;
  bool improved = false;
  unsigned long long tests = 0;
  // a slot may improve a lane's best when (enter, position) is below it
  auto keep = [&](float enter, int pos, auto) { return below(enter, pos, bt, bp); };
  // the horizon, with the best published a slot ago
  auto start = [&](const Job& cur) {
    merge(snap);
    const bool walk = __any_sync(kFull, below(__int_as_float(cur.enter), cur.pos, bt, bp));
    snap = __ldcg(keys + r);
    return walk;
  };
  auto test = [&](float* stage, int n, const Job& cur) {
    // a lane a triangle: the edges once for the 32 rays (the same
    // subtractions as the plain version's), and tmap -1 past the chunk's
    // end, so that the 4-wide loop rejects the tail
    if (lane >= n) {
      stage[(P::kCount - 1) * kChunk + lane] = -1.0f;
    } else if (!WOOP) {
#pragma unroll
      for (int e = 3; e < 9; ++e) stage[e * kChunk + lane] -= stage[(e % 3) * kChunk + lane];
    }
    __syncwarp();
    // a test is accepted below lim: the running best t, or the next float
    // above it when the best is a later position's (which loses a tie)
    const float lim0 = cur.pos < bp ? nextafterf(bt, CUDART_INF_F) : bt;
    float lim = lim0;
    for (int jj = 0; jj < n; jj += 4) {
      float4 q[P::kCount];
#pragma unroll
      for (int pl = 0; pl < P::kCount; ++pl)
        q[pl] = *reinterpret_cast<const float4*>(stage + pl * kChunk + jj);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float pl[P::kCount];
#pragma unroll
        for (int i = 0; i < P::kCount; ++i)
          pl[i] = m == 0 ? q[i].x : m == 1 ? q[i].y : m == 2 ? q[i].z : q[i].w;
        const Test h = plane_test<WOOP, true>(ray, pl);
        if (h.inside && h.t < lim) lim = h.t;
      }
    }
    if (lim < lim0) {
      bt = lim;
      bp = cur.pos;
      improved = true;
    }
    tests += static_cast<unsigned long long>(n);
    if (cur.chunk + 1 == u.chunks && improved) {
      atomicMin(keys + r, (static_cast<unsigned long long>(ordered(bt)) << 32) |
                              static_cast<uint32_t>(bp));
      improved = false;
    }
  };
  walk_piece<WOOP>(pairs, u, table, c, vec, stages[warp], lane, keep, start, test);
  if (counters != nullptr && lane == 0 && tests) atomicAdd(counters, tests * 32);
}

// K11 / K13: the outputs, a warp a ray, from the walk's keys
template <bool WOOP>
__global__ void pair_resolve_kernel(const float* __restrict__ rays, Pairs pairs, int tile_rays,
                                    int64_t mp, const float* __restrict__ table,
                                    const int32_t* __restrict__ tri_map, int c,
                                    const unsigned long long* __restrict__ keys,
                                    float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                                    float* __restrict__ out_u, float* __restrict__ out_v) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= mp) return;
  const int tile = static_cast<int>(r / tile_rays);
  float t = 0.0f, u = 0.0f, v = 0.0f;  // a tile that did not fit: the TPU wrapper's miss row
  int32_t tri = -1;
  if (pairs.tile_fit[tile]) {
    const Ray ray = load_ray(rays, r);
    const unsigned long long key = keys[r];
    t = ray.tmax;
    if (key != kNoHit) {
      const float kt = unordered(static_cast<uint32_t>(key >> 32));
      const int pos = static_cast<int>(key & 0xffffffffu);
      const int64_t cl = pairs.cluster[pairs.tile_offset[tile] + pos];
      const float* row = table + cl * Planes<WOOP>::kWidth * c;
      for (int jb = 0; jb < c; jb += 32) {
        const int j = jb + lane;
        Test h{0.0f, 0.0f, 0.0f, false};
        if (j < c) {
          float pl[Planes<WOOP>::kCount];
#pragma unroll
          for (int i = 0; i < Planes<WOOP>::kCount; ++i)
            pl[i] = row[Planes<WOOP>::offset(i) * c + j];
          h = plane_test<WOOP>(ray, pl);
        }
        const unsigned found = __ballot_sync(kFull, h.inside && h.t == kt);
        if (found) {
          const int src = __ffs(found) - 1;
          t = __shfl_sync(kFull, h.t, src);
          u = __shfl_sync(kFull, h.u, src);
          v = __shfl_sync(kFull, h.v, src);
          tri = tri_map[cl * c + jb + src];
          break;
        }
      }
    }
  }
  if (lane == 0) {
    out_t[r] = t;
    out_tri[r] = tri;
    out_u[r] = u;
    out_v[r] = v;
  }
}

// K12's conservative slab test of a ray (origin o, inverse direction inv)
// against a cluster's box, each axis grown by 2^-14 of its magnitude and
// extent (the slab's and the triangle test's rounding, a few ulps, stay
// far inside): whether the ray's segment may meet a triangle of the
// cluster below its capped tmax
__device__ __forceinline__ bool may_enter(const float* __restrict__ lo,
                                          const float* __restrict__ hi, const float (&o)[3],
                                          const float (&inv)[3], float tmax) {
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float l = __ldg(lo + k), h = __ldg(hi + k);
    const float g = (fmaxf(fabsf(l), fabsf(h)) + (h - l)) * 0x1p-14f + 0x1p-100f;
    const float a = (l - g - o[k]) * inv[k], b = (h + g - o[k]) * inv[k];
    tn = fmaxf(tn, fminf(a, b));  // fminf / fmaxf drop a 0 * inf NaN
    tf = fminf(tf, fmaxf(a, b));
  }
  return tn <= tf && tf >= 0.0f && tn < tmax;
}

// K12: the any-hit walk. Units and staging are the closest-hit walk's; in
// a chunk a lane holds one triangle and the warp takes its open rays in
// turn. A ray is open for a slot while it is active and not yet occluded,
// its capped tmax lies above the slot's enter, and its segment may enter
// the cluster's box. out_occ, zeroed by the entry, is both the output and
// what units publish: a ray's byte is set to 1 where a unit finds it
// occluded and read by the others a slot ahead.
__global__ void __launch_bounds__(kWalkWarps * 32)
    pair_anyhit_walk_kernel(const float* __restrict__ rays, Pairs pairs, int tiles,
                            int tile_rays, const float* __restrict__ table, int c, int vec,
                            int subsets, const float* __restrict__ box_min,
                            const float* __restrict__ box_max, uint8_t* __restrict__ out_occ,
                            unsigned long long* __restrict__ counters) {
  constexpr int kStage = Planes<false>::kCount * kChunk;
  __shared__ __align__(16) float stages[kWalkWarps][2][kStage];
  __shared__ float4 group_rays[kWalkWarps][32][2];  // the warp's rays, read by broadcast
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Unit u;
  if (!decode_unit(static_cast<int64_t>(blockIdx.x) * kWalkWarps + warp, pairs, tiles,
                   tile_rays, c, subsets, lane, u))
    return;
  const Ray ray = load_ray(rays, u.r);
  bool occ = __ldcg(out_occ + u.r) != 0;
  // an inactive ray (tmax 0) is below every enter (>= 0): never open
  if (!__any_sync(kFull, !occ && ray.tmax > 0.0f)) return;
  group_rays[warp][lane][0] = make_float4(ray.ox, ray.oy, ray.oz, ray.dx);
  group_rays[warp][lane][1] = make_float4(ray.dy, ray.dz, ray.tmin, ray.tmax);
  __syncwarp();
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float inv[3] = {1.0f / ray.dx, 1.0f / ray.dy, 1.0f / ray.dz};
  uint8_t snap = 0;
  bool slot_open = false;  // the lane's ray is open for the walked slot
  unsigned long long tests = 0;
  // no triangle of a slot lies nearer than its enter, or outside its box
  auto is_open = [&](float enter, int cluster) {
    return !occ && enter < ray.tmax &&
           may_enter(box_min + 3 * cluster, box_max + 3 * cluster, o, inv, ray.tmax);
  };
  auto keep = [&](float enter, int, auto cluster) { return is_open(enter, cluster()); };
  auto start = [&](const Job& cur) {
    occ = occ || snap != 0;
    slot_open = is_open(__int_as_float(cur.enter), cur.cluster);
    snap = __ldcg(out_occ + u.r);
    return __any_sync(kFull, slot_open);
  };
  auto test = [&](const float* stage, int n, const Job&) {
    // the lane's triangle in registers, its edges once for the chunk (the
    // plain version's subtractions); past the chunk's end tmap -1
    const float t0x = stage[lane], t0y = stage[kChunk + lane], t0z = stage[2 * kChunk + lane];
    const float e1x = stage[3 * kChunk + lane] - t0x, e1y = stage[4 * kChunk + lane] - t0y,
                e1z = stage[5 * kChunk + lane] - t0z;
    const float e2x = stage[6 * kChunk + lane] - t0x, e2y = stage[7 * kChunk + lane] - t0y,
                e2z = stage[8 * kChunk + lane] - t0z;
    const float tmap = lane < n ? stage[9 * kChunk + lane] : -1.0f;
    unsigned todo = __ballot_sync(kFull, slot_open && !occ);
    tests += static_cast<unsigned long long>(__popc(todo)) * n;
    unsigned found = 0;
    while (todo) {  // warp-uniform: every lane tests its triangle against ray i
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const float4 p = group_rays[warp][i][0], q = group_rays[warp][i][1];
      const Ray ri{p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
      const Test h = mt_edges(ri, t0x, t0y, t0z, e1x, e1y, e1z, e2x, e2y, e2z, tmap);
      if (__any_sync(kFull, h.inside && h.t < ri.tmax)) found |= 1u << i;
    }
    if ((found >> lane) & 1u) {
      occ = true;
      out_occ[u.r] = 1;
    }
  };
  walk_piece<false>(pairs, u, table, c, vec, stages[warp], lane, keep, start, test);
  if (counters != nullptr && lane == 0 && tests) atomicAdd(counters, tests);
}

// the walks' grid: up to `shares` shares of a cluster's triangles (about
// kChunk or more each), kPieces pieces of every tile's region, kWalkWarps
// units a block; vec: 16-byte copies
struct Grid {
  int subsets, vec;
  int64_t blocks;
};

int walk_grid(int tiles, int tile_rays, const float* table, int c, int shares, Grid& g) {
  if (tile_rays < 32 || tile_rays > 32 * kMaxWarps || tile_rays % 32 != 0 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  g.subsets = min(shares, (c + kChunk - 1) / kChunk);
  const int64_t warps =
      static_cast<int64_t>(kPieces) * max(tiles, 0) * (tile_rays / 32) * g.subsets;
  g.blocks = (warps + kWalkWarps - 1) / kWalkWarps;
  if (g.blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  g.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  return 0;
}

template <bool WOOP>
int launch_closest(const float* rays, int tiles, int tile_rays, Pairs pairs, const float* table,
                   const int32_t* tri_map, int c, unsigned long long* keys,
                   unsigned long long* counters, float* out_t, int32_t* out_tri, float* out_u,
                   float* out_v, void* stream) {
  Grid g;
  if (const int bad = walk_grid(tiles, tile_rays, table, c, kShares, g)) return bad;
  if (tiles < 1) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t mp = static_cast<int64_t>(tiles) * tile_rays;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * mp, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  pair_walk_kernel<WOOP><<<static_cast<unsigned>(g.blocks), kWalkWarps * 32, 0, s>>>(
      rays, pairs, tiles, tile_rays, table, c, g.vec, g.subsets, keys, counters);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t rblocks = (mp * 32 + 255) / 256;
  pair_resolve_kernel<WOOP><<<static_cast<unsigned>(rblocks), 256, 0, s>>>(
      rays, pairs, tile_rays, mp, table, tri_map, c, keys, out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

int launch_anyhit(const float* rays, int tiles, int tile_rays, Pairs pairs, const float* table,
                  int c, const float* box_min, const float* box_max,
                  unsigned long long* counters, uint8_t* out_occ, void* stream) {
  Grid g;
  if (const int bad = walk_grid(tiles, tile_rays, table, c, kAnyShares, g)) return bad;
  if (tiles < 1) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cudaMemsetAsync(out_occ, 0, static_cast<size_t>(tiles) * tile_rays, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  pair_anyhit_walk_kernel<<<static_cast<unsigned>(g.blocks), kWalkWarps * 32, 0, s>>>(
      rays, pairs, tiles, tile_rays, table, c, g.vec, g.subsets, box_min, box_max, out_occ,
      counters);
  return static_cast<int>(cudaGetLastError());
}

Pairs make_pairs(const int32_t* tile_offset, const int32_t* tile_region, const uint8_t* tile_fit,
                 const int32_t* cluster, const int32_t* flags, const int32_t* enter,
                 int budget) {
  return Pairs{tile_offset, tile_region, tile_fit, cluster, flags, enter, budget};
}

}  // namespace

// rays: (tiles * tile_rays, 8) packed [o, d, tmin, tmax] (inactive rays:
// tmin = FLT_MAX, tmax = 0); table: (K, 10*C) cl_tri_table, or (K, 16*C)
// cl_woop_table for pair_woop. Outputs per packed ray. keys: (tiles *
// tile_rays,) scratch of the closest-hit walks; out_occ: (tiles *
// tile_rays,) bytes, zeroed by pair_anyhit; box_min / box_max: (K, 3)
// cl_aabb_min / cl_aabb_max, which K12 tests each ray against; counters: null, or one zeroed
// counter to which the walk adds the ray-triangle tests it runs (lanes x
// triangles of each walked chunk; K12: open rays x triangles).
extern "C" int pair_closest(const float* rays, int tiles, int tile_rays,
                            const int32_t* tile_offset, const int32_t* tile_region,
                            const uint8_t* tile_fit, const int32_t* cluster,
                            const int32_t* flags, const int32_t* enter, int budget,
                            const float* table, const int32_t* tri_map, int c,
                            unsigned long long* keys, unsigned long long* counters, float* out_t, int32_t* out_tri,
                            float* out_u, float* out_v, void* stream) {
  return launch_closest<false>(
      rays, tiles, tile_rays,
      make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table,
      tri_map, c, keys, counters, out_t, out_tri, out_u, out_v, stream);
}

extern "C" int pair_woop(const float* rays, int tiles, int tile_rays,
                         const int32_t* tile_offset, const int32_t* tile_region,
                         const uint8_t* tile_fit, const int32_t* cluster, const int32_t* flags,
                         const int32_t* enter, int budget, const float* table,
                         const int32_t* tri_map, int c, unsigned long long* keys, unsigned long long* counters, float* out_t,
                         int32_t* out_tri, float* out_u, float* out_v, void* stream) {
  return launch_closest<true>(
      rays, tiles, tile_rays,
      make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table,
      tri_map, c, keys, counters, out_t, out_tri, out_u, out_v, stream);
}

extern "C" int pair_anyhit(const float* rays, int tiles, int tile_rays,
                           const int32_t* tile_offset, const int32_t* tile_region,
                           const uint8_t* tile_fit, const int32_t* cluster,
                           const int32_t* flags, const int32_t* enter, int budget,
                           const float* table, int c, const float* box_min,
                           const float* box_max, unsigned long long* counters,
                           uint8_t* out_occ, void* stream) {
  return launch_anyhit(
      rays, tiles, tile_rays,
      make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table, c,
      box_min, box_max, counters, out_occ, stream);
}
