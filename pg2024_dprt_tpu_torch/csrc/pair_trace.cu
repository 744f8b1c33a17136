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
//   * What bounds them. About 40 FP32 operations a ray-triangle test, at
//     half the FMA peak (the library is built with --fmad=false, so that
//     every kernel rounds as its plain version; a mul-add is two
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
// K12 keeps the first design's walk until its own redesign: a block of tile_rays threads
// (a ray a thread) walks its tile's region slot by slot, stages the row in
// shared memory behind two barriers, and stops once every ray is occluded
// (__syncthreads_and).
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

constexpr int kMaxWarps = 32;  // K12: tile_rays / 32
constexpr int kWalkWarps = 4;  // warps of a walk block
constexpr int kChunk = 32;     // triangles of a staged chunk
constexpr int kShares = 4;     // K11 / K13: shares of a cluster's triangles, at most
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

// K11 (WOOP false) and K13 (WOOP true): the walk. Warp u of the grid is
// (piece, tile, ray group, share), piece-major.
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
  int64_t unit = static_cast<int64_t>(blockIdx.x) * kWalkWarps + warp;
  const int groups = tile_rays >> 5;
  const int share_id = static_cast<int>(unit % subsets);
  unit /= subsets;
  const int group = static_cast<int>(unit % groups);
  unit /= groups;
  const int tile = static_cast<int>(unit % tiles);
  const int64_t piece = unit / tiles;
  if (piece >= kPieces || !pairs.tile_fit[tile]) return;
  const int s0 = pairs.tile_offset[tile];
  const int len = static_cast<int>(
      max(int64_t{0}, min(static_cast<int64_t>(pairs.tile_region[tile]),
                          static_cast<int64_t>(pairs.budget) - s0)));
  const int per = max(kMinPiece, (len + kPieces - 1) / kPieces);
  if (piece * per >= len) return;
  const int a = static_cast<int>(piece * per);
  const int b = min(len, a + per);
  const int share = ((c + subsets - 1) / subsets + 3) & ~3;
  const int j0 = share_id * share;
  if (j0 >= c) return;
  const int j1 = min(c, j0 + share);
  const int chunks = (j1 - j0 + kChunk - 1) / kChunk;

  const int64_t r = static_cast<int64_t>(tile) * tile_rays + group * 32 + lane;
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

  // the slots' flags, enter and cluster, 32 positions from `base`, a lane each
  int base = a, m_enter = 0, m_cluster = 0;
  unsigned listed = 0;
  auto load_meta = [&]() {
    const int pos = base + lane;
    bool in = pos < b;
    m_enter = 0;
    m_cluster = 0;
    if (in) {
      in = (pairs.flags[s0 + pos] & 2) != 0;
      m_enter = pairs.enter[s0 + pos];
      m_cluster = pairs.cluster[s0 + pos];
    }
    listed = __ballot_sync(kFull, in);
  };
  // the next listed slot after position `after` that may improve a lane's best
  auto next_slot = [&](int after) {
    for (;;) {
      const int skip = after - base + 1;
      unsigned cand = skip <= 0 ? listed : (skip >= 32 ? 0u : listed & (kFull << skip));
      while (cand) {
        const int i = __ffs(cand) - 1;
        const int e = __shfl_sync(kFull, m_enter, i);
        if (__any_sync(kFull, below(__int_as_float(e), base + i, bt, bp)))
          return Job{base + i, e, __shfl_sync(kFull, m_cluster, i), 0};
        cand &= cand - 1;
      }
      if (base + 32 >= b) return Job{-1, 0, 0, 0};
      base += 32;
      after = base - 1;
      load_meta();
    }
  };
  const int64_t width = static_cast<int64_t>(P::kWidth) * c;
  auto fetch = [&](const Job& job, float* stage) {
    const int jb = j0 + job.chunk * kChunk;
    const int n = min(kChunk, j1 - jb);
    const float* row = table + job.cluster * width + jb;
    if (vec) {  // 16-byte copies: 4 triangles of a plane
      const int quads = n >> 2;
#pragma unroll
      for (int i = lane; i < P::kCount * 8; i += 32) {
        const int pl = i >> 3, k = i & 7;
        if (k < quads)
          cp_async(stage + pl * kChunk + 4 * k, row + P::offset(pl) * c + 4 * k, 1);
      }
    } else if (lane < n) {
#pragma unroll
      for (int pl = 0; pl < P::kCount; ++pl)
        cp_async(stage + pl * kChunk + lane, row + P::offset(pl) * c + lane, 0);
    }
  };

  load_meta();
  Job cur = next_slot(a - 1);
  if (cur.pos >= 0) fetch(cur, stages[warp][0]);
  asm volatile("cp.async.commit_group;\n" ::);
  int st = 0;
  bool walk = false, improved = false;
  unsigned long long tests = 0;
  while (cur.pos >= 0) {
    if (cur.chunk == 0) {  // the horizon, with the best published a slot ago
      merge(snap);
      walk = __any_sync(kFull, below(__int_as_float(cur.enter), cur.pos, bt, bp));
      snap = __ldcg(keys + r);
    }
    const Job nxt = (walk && cur.chunk + 1 < chunks)
                        ? Job{cur.pos, cur.enter, cur.cluster, cur.chunk + 1}
                        : next_slot(cur.pos);
    if (nxt.pos >= 0) fetch(nxt, stages[warp][st ^ 1]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    if (walk) {
      float* stage = stages[warp][st];
      const int n = min(kChunk, j1 - (j0 + cur.chunk * kChunk));
      // a lane a triangle: the edges once for the 32 rays (the same
      // subtractions as the plain version's), and tmap -1 past the chunk's
      // end, so that the 4-wide loop rejects the tail
      if (lane >= n) {
        stage[(P::kCount - 1) * kChunk + lane] = -1.0f;
      } else if (!WOOP) {
#pragma unroll
        for (int e = 3; e < 9; ++e)
          stage[e * kChunk + lane] -= stage[(e % 3) * kChunk + lane];
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
      if (cur.chunk + 1 == chunks && improved) {
        atomicMin(keys + r, (static_cast<unsigned long long>(ordered(bt)) << 32) |
                                static_cast<uint32_t>(bp));
        improved = false;
      }
    }
    __syncwarp();
    cur = nxt;
    st ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// K12: the first design's walk, a block a tile, a thread a ray
__global__ void pair_anyhit_kernel(const float* __restrict__ rays, Pairs pairs,
                                   const float* __restrict__ table, int c,
                                   uint8_t* __restrict__ out_occ) {
  extern __shared__ float row[];
  const int tile = blockIdx.x;
  const int64_t r = static_cast<int64_t>(tile) * blockDim.x + threadIdx.x;
  const float* ray = rays + r * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float tmin = ray[6], tmax = ray[7];
  bool occ = false;
  if (pairs.tile_fit[tile]) {
    const int width = 10 * c;
    const int s0 = pairs.tile_offset[tile];
    const int s1 = min(s0 + pairs.tile_region[tile], pairs.budget);
    for (int s = s0; s < s1; ++s) {
      if ((pairs.flags[s] & 2) == 0) continue;  // block-uniform
      if (__syncthreads_and(occ)) break;
      const int64_t cl = pairs.cluster[s];
      __syncthreads();  // the previous row has been read by every thread
      const float* src = table + cl * width;
      for (int i = threadIdx.x; i < width; i += blockDim.x) row[i] = src[i];
      __syncthreads();
      for (int j = 0; j < c; ++j) {
        const float t0x = row[j], t0y = row[c + j], t0z = row[2 * c + j];
        const float e1x = row[3 * c + j] - t0x;
        const float e1y = row[4 * c + j] - t0y;
        const float e1z = row[5 * c + j] - t0z;
        const float e2x = row[6 * c + j] - t0x;
        const float e2y = row[7 * c + j] - t0y;
        const float e2z = row[8 * c + j] - t0z;
        const float tmap = row[9 * c + j];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabsf(det) > 1e-12f;
        const float inv_det = ok ? 1.0f / det : 0.0f;
        const float tx = ox - t0x, ty = oy - t0y, tz = oz - t0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool inside = ok && tmap >= 0.0f && u >= 0.0f && v >= 0.0f &&
                            u + v <= 1.0f && t > tmin;
        occ = occ || (inside && t < tmax);
      }
    }
  }
  out_occ[r] = occ ? 1 : 0;
}

bool bad_tile(int tile_rays, int c) {
  return tile_rays < 32 || tile_rays > 32 * kMaxWarps || tile_rays % 32 != 0 || c < 1;
}

template <bool WOOP>
int launch_closest(const float* rays, int tiles, int tile_rays, Pairs pairs, const float* table,
                   const int32_t* tri_map, int c, unsigned long long* keys, unsigned long long* counters, float* out_t,
                   int32_t* out_tri, float* out_u, float* out_v, void* stream) {
  if (bad_tile(tile_rays, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles < 1) return 0;
  // about kChunk triangles a share
  const int subsets = min(kShares, (c + kChunk - 1) / kChunk);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t mp = static_cast<int64_t>(tiles) * tile_rays;
  const int64_t warps = static_cast<int64_t>(kPieces) * tiles * (tile_rays / 32) * subsets;
  const int64_t blocks = (warps + kWalkWarps - 1) / kWalkWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * mp, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  pair_walk_kernel<WOOP><<<static_cast<unsigned>(blocks), kWalkWarps * 32, 0, s>>>(
      rays, pairs, tiles, tile_rays, table, c, vec, subsets, keys, counters);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t rblocks = (mp * 32 + 255) / 256;
  pair_resolve_kernel<WOOP><<<static_cast<unsigned>(rblocks), 256, 0, s>>>(
      rays, pairs, tile_rays, mp, table, tri_map, c, keys, out_t, out_tri, out_u, out_v);
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
// tile_rays,) scratch of the closest-hit walks; counters: null, or one
// zeroed counter to which the walk adds the ray-triangle tests it runs.
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
                           const float* table, int c, uint8_t* out_occ, void* stream) {
  if (bad_tile(tile_rays, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles < 1) return 0;
  const size_t smem = sizeof(float) * 10 * static_cast<size_t>(c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_anyhit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pair_anyhit_kernel<<<tiles, tile_rays, smem, static_cast<cudaStream_t>(stream)>>>(
      rays, make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table,
      c, out_occ);
  return static_cast<int>(cudaGetLastError());
}
