// Fused neural routing (K7 route) for Hopper (sm_90a): local trace + proxy
// march + vis/depth nets + prediction consumption in ONE launch, bound to
// PyTorch through a plain C interface (ctypes). Two entry points over one
// templated kernel: route_secondary (closest hit; the routing decision of a
// secondary ray) and route_shadow (any-hit; the light weight of a shadow
// ray).
//
// Replaces the JAX package's Pallas kernel pallas_route.py::_route_kernel
// (pallas_call at :729). It is built from the device functions of the
// composed stage's kernels, so both paths share their arithmetic:
// resident_trace.cuh (the traces of K1 / K2, or of K9 / K10 in the grouped
// mode; the closest hit already returns the exact winner t, so the TPU
// kernel's _trace_exact_t scratch has no counterpart), proxy_march.cuh (K4)
// and proxy_mlp.cuh (K5 / K6).
//
// One block of 256 threads takes a tile of kTileRays rays, in two phases:
//   1. the local trace against the ray's tmax capped at the scene exit, by
//      the rule every trace uses (ops/resident.py use_grouped): with the
//      group tables, each warp traces its rays one after another through the
//      warp walks of K9 / K10 (resident_trace.cuh closest / occluded: all 32
//      lanes walk one ray; a lane without a ray, dead or past the end of the
//      wavefront, only skips its turn, so a warp of dead rows costs one
//      ballot); below the rule's threshold each thread walks its own ray
//      through the flat cull of K1 / K2. The walks' team buffers alias the
//      nets' activation planes, which phase 2 first touches after the
//      barrier that ends phase 1. Then, one thread per ray, the march,
//      bounded by the local hit's t or, on a miss, by the caller's UNCAPPED
//      tmax (proxies lie outside the local scene). A shadow ray that is
//      occluded locally does not march; survivors march against their full
//      tmax. The ray's records go to shared memory (features, table row,
//      inside flag, t, ratio).
//   2. the block groups the tile's valid records by object (counting sort in
//      shared memory) and runs each present object's vis and depth net over
//      chunks of at most kNetRows of its records only (two m16 tiles of the
//      tensor-core forward of proxy_mlp.cuh, whose values equal K5's / K6's
//      for the same record) (multi-geo mode: one shared net pair, one
//      group of every valid record, the sixth feature max(obj, 0) /
//      INSTANCE_DIVISOR of the record's proxy row, as the TPU kernel's
//      multi_geo mode, pallas_route.py:411-415); invalid records cost
//      nothing (the TPU kernel's rank-compaction helpers
//      lane_cumsum_exclusive / chunk_onehot exist to skip matrix-unit work on
//      zeroed rows; here such rows are simply not in any chunk). Then each
//      ray's thread consumes its
//      max_hits predictions:
//        secondary: pred_t per record (entry t + length, or inside: t -
//        length clamped at 0), the nearest visible prediction below the
//        local bound settles the ray on that record's node, else a local
//        hit settles it on this partition; no local hit and no record at all
//        is an environment miss; the rest is "no route".
//        shadow: a record occludes when vis > 0.5 and, for an inside hit,
//        depth <= the object-space entry depth; weight = survives * (1 -
//        any occluding record).
//
// Decisions are per ray, so the order of the wavefront changes no result,
// only the time: the wrapper launches this kernel on secondary rays in the
// schedule order of K8 (resident_trace.cu schedule_keys), which puts rays
// that visit the same clusters into the same warp and tile.
//
// What bounds it on an H100: operations — the ray-triangle and slab tests of
// the trace plus 2 x 286,944 multiply-adds per valid record at the
// production width (2 x 1,753,536 for the multi-geo nets at w512 / d3); the
// nets run on the tensor cores (proxy_mlp.cuh), the trace and the march on
// the FP32 pipes. Before the warp walks, each thread's flat walk made every
// pick a fresh pass over all K cluster boxes (PERF.md, cycle counters).
//
// Tile size: 256 rays (kTileRays), measured against 64 and 128 on an H100
// (scripts/torch_grouped_probe.py --parts tiles; PERF.md). The tile sets
// both the trace's parallelism (8 warps walk kTileRays / 8 rays each in
// series) and the fill of the nets' 16-row chunks (each object present in a
// tile runs at least one chunk there). 256 was the fastest on every dense
// production-width wavefront, 8-25 % ahead of 128 (the nets' fill decides),
// and within 2 % of it in the multi-geo mode; 64 won only on a sparse
// rooms_p8 partition, by 0.4 ms a pair of stage calls.
//
// Registers: one block an SM, so a thread may take up to 255 registers. At
// 2 blocks (128 registers) every instance spills in the nets' forward, and
// the measured times (scripts/torch_grouped_probe.py --parts tiles; PERF.md)
// were no better: one budget serves all four instances (stage x net mode).
//
// Built with --fmad=false for the trace and march arithmetic; the nets'
// sums run on the tensor cores in a fixed order (proxy_mlp.cuh).

#include "cycles.cuh"
#include "proxy_march.cuh"
#include "proxy_mlp.cuh"
#include "resident_trace.cuh"

namespace {

using mlp::Dims;
using mlp::Nets;
using resident::Ray;
using resident::Tables;

// Rays of a tile (the tile size note in the header). Each warp holds
// kTileRays / 8 of them, in lanes 0 .. kTileRays / 8 - 1.
constexpr int kTileRays = 256;
constexpr int kWarps = mlp::kThreads / 32;
// records of a nets chunk: two m16 tiles (ops/route.py NET_ROWS)
constexpr int kNetTiles = 2;
constexpr int kNetRows = 16 * kNetTiles;
constexpr int kWarpRays = kTileRays / kWarps;
static_assert(kTileRays % kWarps == 0 && kWarpRays >= 1 && kWarpRays <= 32,
              "a tile spreads its rays evenly over the block's warps");
constexpr float kF32Max = 3.402823466e38f;
// the multi-geo net reads the object id as id / kInstanceDivisor
// (models/proxy.py INSTANCE_DIVISOR)
constexpr float kInstanceDivisor = 4.0f;

struct Rays {
  const float* __restrict__ o;        // (N, 3)
  const float* __restrict__ d;        // (N, 3)
  const float* __restrict__ tmin;     // (N,)
  const float* __restrict__ tmax;     // (N,) uncapped
  const uint8_t* __restrict__ active; // (N,)
  int n;
};

// Secondary: node (my_node for a local settle, -1 none), t, has_node,
// env_miss, no_route, local_hit. Shadow: weight in t, occluded_local in
// local_hit, survives in has_node.
struct Out {
  int32_t* __restrict__ node;
  float* __restrict__ t;
  uint8_t* __restrict__ has_node;
  uint8_t* __restrict__ env_miss;
  uint8_t* __restrict__ no_route;
  uint8_t* __restrict__ local_hit;
};

// Bytes at the front of a tile's shared memory: the nets' chunk of kNetRows
// rows in phase 2, the warps' team buffers of the grouped trace in phase 1
// (aliased: phase 1 ends at a barrier before phase 2 touches the planes).
__host__ __device__ inline size_t front_bytes(const Dims& d) {
  const size_t teams = kWarps * sizeof(resident::Team);
  const size_t nets = mlp::smem_bytes(d, kNetRows);
  return nets > teams ? nets : teams;
}

// Bytes of dynamic shared memory of a tile (ops/route.py route_smem_bytes).
size_t smem_bytes(const Dims& d, int max_hits, int n_obj) {
  const size_t rows = (size_t)kTileRays * max_hits;
  return front_bytes(d) + rows * 11 * 4 + (size_t)3 * n_obj * 4;
}

// Blocks an SM must hold (the register budget; the note in the header).
constexpr int kMinBlocks = 1;

template <bool kShadow, bool kMultiGeo>
__global__ void __launch_bounds__(mlp::kThreads, kMinBlocks) route_kernel(
    Rays rays, Tables scene, march::Table tb, int max_hits, float eps, int n_obj,
    Dims dm_arg, Nets vis, Nets depth, Out out) {
  CYCLES_NOW(c_start);
  // the mode as a constant, so each instance compiles one forward
  Dims dm = dm_arg;
  dm.multi_geo = kMultiGeo ? 1 : 0;
  extern __shared__ float4 smem_f4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f4);
  const int rows = kTileRays * max_hits;
  // the tile's records, row = tile ray * max_hits + slot
  float* q_feat = reinterpret_cast<float*>(smem + front_bytes(dm));  // (rows, 5)
  float* q_t = q_feat + 5 * rows;
  float* q_ratio = q_t + rows;
  float* q_vis = q_ratio + rows;
  float* q_depth = q_vis + rows;
  int* q_code = reinterpret_cast<int*>(q_depth + rows);  // row | inside << 8, -1 none
  int* list = q_code + rows;                              // records grouped by object
  int* cnt = list + rows;                                 // (n_obj,)
  int* start = cnt + n_obj;
  int* fill = start + n_obj;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // this thread's ray of the tile, if it holds one
  const bool owner = lane < kWarpRays;
  const int ray = warp * kWarpRays + lane;
  const int i = blockIdx.x * kTileRays + ray;
  const bool in_range = owner && i < rays.n;
  const int base = ray * max_hits;
  for (int o = tid; o < n_obj; o += blockDim.x) cnt[o] = 0;
  for (int k = 0; owner && k < max_hits; ++k) {
    q_code[base + k] = -1;
    q_vis[base + k] = 0.0f;   // a record whose object has no net predicts 0
    q_depth[base + k] = 0.0f;
  }

  // ---- 1. local trace (every lane of the warp: the grouped walks trace the
  // warp's rays one after another) and march, one thread per ray
  bool act = false, local_hit = false, march_act = false;
  float cmp_t = 0.0f;
  Ray r = {};
  if (in_range) {
    act = resident::load_ray(i, rays.o, rays.d, rays.tmin, rays.tmax, rays.active,
                             scene.scene_aabb, r);
    cmp_t = rays.tmax[i];
  }
  resident::Team& team = reinterpret_cast<resident::Team*>(smem)[warp];
  CYCLES_NOW(c_trace);
  if (act) CYCLES_COUNT(5, 1);
  if (kShadow) {
    local_hit = resident::occluded(act, r, scene, team);
    march_act = act && !local_hit;
  } else {
    const resident::Hit h = resident::closest(act, r, scene, team);
    local_hit = act && h.hit;
    if (local_hit) cmp_t = h.t;
    march_act = act;
  }
  if (in_range) {
    CYCLES_ADD(0, c_trace);
    CYCLES_NOW(c_march);
    if (march_act) {
      march::march_ray(tb, r.o, r.d, cmp_t, max_hits, eps,
                       [&](int slot, const march::Record& rec) {
                         const int q = base + slot;
#pragma unroll
                         for (int f = 0; f < 5; ++f) q_feat[5 * q + f] = rec.feat[f];
                         q_t[q] = rec.t;
                         q_ratio[q] = rec.ratio;
                         q_code[q] = rec.row | (rec.inside ? 256 : 0);
                       });
    }
    CYCLES_ADD(1, c_march);
    CYCLES_COUNT(9, 1);
  }
  __syncthreads();
  CYCLES_NOW(c_nets);
  if (tid == 0) {
    CYCLES_ADD(2, c_start);
    CYCLES_COUNT(6, 1);
  }

  // ---- 2. the nets over the tile's valid records, grouped by object
  // the net of a record: its object's pair, or the one shared multi-geo pair
  auto net_of = [&](int code) {
    return code < 0 ? -1 : (kMultiGeo ? 0 : tb.obj[code & 255]);
  };
  for (int k = 0; owner && k < max_hits; ++k) {
    const int ob = net_of(q_code[base + k]);
    if (ob >= 0 && ob < n_obj) atomicAdd(&cnt[ob], 1);
    if (ob >= 0) CYCLES_COUNT(7, 1);
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int o = 0; o < n_obj; ++o) {
      start[o] = acc;
      fill[o] = acc;
      acc += cnt[o];
    }
  }
  __syncthreads();
  for (int k = 0; owner && k < max_hits; ++k) {
    const int ob = net_of(q_code[base + k]);
    if (ob >= 0 && ob < n_obj) list[atomicAdd(&fill[ob], 1)] = base + k;
  }
  __syncthreads();
  for (int o = 0; o < n_obj; ++o) {
    const int total = cnt[o];
    for (int b0 = 0; b0 < total; b0 += kNetRows) {
      if (tid == 0) CYCLES_COUNT(8, 1);
      const int* chunk = list + start[o] + b0;
      mlp::pair_chunk<kNetTiles, kMultiGeo>(
          dm, vis, depth, o, min(kNetRows, total - b0), kNetRows, smem,
          [&](int r, int f) {
            return f < 5 ? q_feat[5 * chunk[r] + f]
                         : fmaxf((float)tb.obj[q_code[chunk[r]] & 255], 0.0f) /
                               kInstanceDivisor;
          },
          [&](int r, float v, float dp) {
            q_vis[chunk[r]] = v;
            q_depth[chunk[r]] = dp;
          });
    }
  }

  if (tid == 0) CYCLES_ADD(3, c_nets);

  // ---- 3. consumption, one thread per ray
  if (!in_range) return;
  CYCLES_NOW(c_consume);
  if (kShadow) {
    bool occluded = false;
    for (int k = 0; k < max_hits; ++k) {
      const int code = q_code[base + k];
      if (code < 0) continue;
      const int row = code & 255;
      const bool inside = (code & 256) != 0;
      const float ml = tb.max_length[row];
      const float norm_t = q_t[base + k] / fmaxf(q_ratio[base + k] * ml, 1e-12f);
      if (q_vis[base + k] > 0.5f && (!inside || q_depth[base + k] <= norm_t)) {
        occluded = true;
      }
    }
    out.t[i] = march_act ? (occluded ? 0.0f : 1.0f) : 0.0f;
    out.local_hit[i] = local_hit ? 1 : 0;
    out.has_node[i] = march_act ? 1 : 0;
    CYCLES_ADD(4, c_consume);
    return;
  }
  float best_t = kF32Max;
  int best_node = -1;
  bool any_query = false;
  for (int k = 0; k < max_hits; ++k) {
    const int code = q_code[base + k];
    if (code < 0) continue;
    any_query = true;
    const int row = code & 255;
    const bool inside = (code & 256) != 0;
    const float t = q_t[base + k];
    const float pred_len = q_ratio[base + k] * tb.max_length[row] * q_depth[base + k];
    float pred_t = inside ? (pred_len > t ? 0.0f : t - pred_len) : t + pred_len;
    if (!(q_vis[base + k] > 0.5f && pred_t > 1.1920929e-7f)) pred_t = kF32Max;
    if (pred_t < best_t) {
      best_t = pred_t;
      best_node = tb.node[row];
    }
  }
  const bool use_pred = act && best_t < cmp_t;
  // a local settle is written as this partition's id; "no node" as -1
  const bool has_node = use_pred || local_hit;
  const bool env_miss = act && !local_hit && !any_query && !has_node;
  out.node[i] = use_pred ? best_node : (local_hit ? tb.my_node : -1);
  out.t[i] = has_node ? (use_pred ? best_t : cmp_t) : 0.0f;
  out.has_node[i] = has_node ? 1 : 0;
  out.env_miss[i] = env_miss ? 1 : 0;
  out.no_route[i] = (act && !has_node && !env_miss) ? 1 : 0;
  out.local_hit[i] = local_hit ? 1 : 0;
  CYCLES_ADD(4, c_consume);
}

Tables scene_tables(const float* boxes, const float* table, const int32_t* tri_map,
                    const int32_t* counts, const float* scene_aabb, int nk, int c,
                    const float* gboxes, const float* mboxes, int kg) {
  Tables s{boxes, table, tri_map, counts, scene_aabb, nk, c};
  s.gboxes = gboxes;  // nullptr: the flat trace
  s.mboxes = mboxes;
  s.kg = kg;
  return s;
}

template <bool kShadow, bool kMultiGeo>
int launch_as(const Rays& rays, const Tables& scene, const march::Table& tb,
              int max_hits, float eps, int n_obj, const Dims& dm, const Nets& vis,
              const Nets& depth, const Out& out, void* stream) {
  const size_t bytes = smem_bytes(dm, max_hits, n_obj);
  const cudaError_t rc = cudaFuncSetAttribute(
      route_kernel<kShadow, kMultiGeo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  route_kernel<kShadow, kMultiGeo><<<(rays.n + kTileRays - 1) / kTileRays, mlp::kThreads,
                                     bytes, static_cast<cudaStream_t>(stream)>>>(
      rays, scene, tb, max_hits, eps, n_obj, dm, vis, depth, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kShadow>
int launch(const Rays& rays, const Tables& scene, const march::Table& tb,
           int max_hits, float eps, int n_obj, const Dims& dm, const Nets& vis,
           const Nets& depth, const Out& out, void* stream) {
  if (!mlp::dims_ok(dm) || dm.in_features != (dm.multi_geo ? 6 : 5) || n_obj < 1 ||
      (dm.multi_geo && n_obj != 1) || max_hits < 1 ||
      tb.p < 1 || tb.p > march::kMaxRows ||
      (scene.gboxes != nullptr && !resident::group_tables_ok(scene.gboxes, scene.mboxes,
                                                             scene.kg))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rays.n <= 0) return 0;
  return dm.multi_geo
             ? launch_as<kShadow, true>(rays, scene, tb, max_hits, eps, n_obj, dm, vis,
                                        depth, out, stream)
             : launch_as<kShadow, false>(rays, scene, tb, max_hits, eps, n_obj, dm, vis,
                                         depth, out, stream);
}

}  // namespace

// C entry points: launch on the caller's stream and return the first CUDA
// error (0 = launched). Arguments in groups: the rays; the scene's cluster
// tables and its group tables (gboxes null: the flat trace); the proxy
// table (xf, omin, ospan null unless instanced); the march's and the nets'
// parameters (n_obj net pairs; one with multi_geo); the outputs.
#define ROUTE_ARGS                                                              \
  const float *o, const float *d, const float *tmin, const float *tmax,         \
      const uint8_t *active, int n, const float *boxes, const float *table,     \
      const int32_t *tri_map, const int32_t *counts, const float *scene_aabb,   \
      int nk, int c, const float *gboxes, const float *mboxes, int kg,          \
      const float *bmin, const float *bmax,                                     \
      const float *max_length, const int32_t *node, const int32_t *obj,         \
      const float *xf, const float *omin, const float *ospan, int p,            \
      int my_node, int max_hits, float eps, int n_obj, const void *vis_w,       \
      const float *vis_b, const void *depth_w, const float *depth_b, int width, \
      int depth, int in_features, int head_hidden, int multi_geo, int vis_act, \
      int depth_act

#define ROUTE_LAUNCH(SHADOW, OUT)                                                \
  launch<SHADOW>(                                                                \
      Rays{o, d, tmin, tmax, active, n},                                         \
      scene_tables(boxes, table, tri_map, counts, scene_aabb, nk, c, gboxes,     \
                   mboxes, kg),                                                  \
      march::Table{bmin, bmax, max_length, node, obj, xf, omin, ospan, p,        \
                   my_node},                                                     \
      max_hits, eps, n_obj,                                                      \
      Dims{width, depth, in_features, head_hidden, 1, multi_geo},                \
      Nets{static_cast<const uint4*>(vis_w), vis_b, vis_act},                    \
      Nets{static_cast<const uint4*>(depth_w), depth_b, depth_act}, OUT,         \
      stream)

extern "C" int route_secondary(ROUTE_ARGS, int32_t* out_node, float* out_t,
                               uint8_t* has_node, uint8_t* env_miss,
                               uint8_t* no_route, uint8_t* local_hit, void* stream) {
  return ROUTE_LAUNCH(false, (Out{out_node, out_t, has_node, env_miss, no_route,
                                  local_hit}));
}

extern "C" int route_shadow(ROUTE_ARGS, float* weight, uint8_t* occluded_local,
                            uint8_t* survives, void* stream) {
  return ROUTE_LAUNCH(true, (Out{nullptr, weight, survives, nullptr, nullptr,
                                 occluded_local}));
}
