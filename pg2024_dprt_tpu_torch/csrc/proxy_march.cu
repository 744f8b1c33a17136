// Proxy-AABB march (K4 proxy_march) for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes).
//
// Replaces the JAX package's Pallas kernel pallas_march.py::_march_kernel
// (pallas_call at :240). What it computes is in proxy_march.cuh, which the
// fused route kernel (route.cu) shares: per ray the slab test of all P proxy
// boxes, up to max_hits front-to-back selections with the inside-hit dedup,
// and the NNQuery record of each hit.
//
// The TPU kernel's layout is not carried over: no (8, P) transposed box
// table, no packed t|lane selection key (the winner is the exact
// lexicographic minimum of (t, row)), no one-hot extraction of the winning
// row, no precomputed ray angles with the phi + pi identity (the direction is
// negated and its angles taken with acosf / atan2f, as the oracle
// march_proxies_xla does), and records are written at their slot (valid rows
// front-packed per ray) with every NNQuery field, so no epilogue of gathers
// runs after the kernel.
//
// What bounds it on an H100: bytes. A ray reads 29 bytes, and every one of
// its max_hits rows of the oracle's layout is written, empty or not: 58
// bytes a row with the zero pixel_index / shadow_path_id column (203 bytes a
// ray at max_hits 3), against some max_hits * P * 25 = 600 FP32 operations
// at P = 8: 61 microseconds a million rays at 3.35 TB/s against 9 at 67
// TFLOP/s.
//
// Design: a thread per ray, a block of kThreads rays (fewer when a ray may
// record many hits: the block's records must fit its staging area). The
// block copies the proxy table into shared memory once (at most 32 rows of
// 36 bytes, 72 more when instanced), so the march's slab tests, which every
// ray repeats max_hits times over all P rows, read shared memory. Each ray
// marches (march::march_ray, the arithmetic K7 shares) and stages its
// records in shared memory, min(max_hits, P) slots a ray: a table row
// records at most once a ray (the inside-hit dedup), so no ray has more
// records than rows, and any max_hits fits. Then the block writes its
// output range, which is contiguous in every output array
// ([i0 * max_hits, (i0 + rays) * max_hits)), field by field: thread t
// writes rows t, t + kThreads, ..., so each warp store covers consecutive
// rows (128 bytes of a 4-byte field), and the features, five floats a row,
// are written by element. The empty rows (every slot past a ray's records)
// and the zero column are written by the same loop, so the wrapper launches
// nothing else.
//
// Built with --fmad=false, so that distances and features round like the
// plain version's.

#include "cycles.cuh"
#include "proxy_march.cuh"

namespace {

constexpr int kThreads = 128;
// records a block stages: kThreads rays of up to 6 slots each
constexpr int kStageRows = 768;
// counters of a -DPG_CYCLES build (csrc/cycles.cuh): the threads' cycles in
// the march and in the stores, the rays marched and the blocks
constexpr int kMarchLoop = 0, kMarchStore = 1, kMarchRays = 2, kMarchBlocks = 3;

struct Out {
  float* __restrict__ features;      // (Q, 5)
  int32_t* __restrict__ aabb_id;     // (Q,) object of the hit row, -1 invalid
  int32_t* __restrict__ node_id;     // (Q,) node of the hit row, -1 invalid
  int32_t* __restrict__ hit_sequence;
  uint8_t* __restrict__ is_inside;
  uint8_t* __restrict__ is_valid;
  int32_t* __restrict__ path_index;
  float* __restrict__ aabb_t;
  float* __restrict__ max_length;
  float* __restrict__ t_ratio;
  float* __restrict__ normalized_t;
  int32_t* __restrict__ zeros;       // (Q,) pixel_index / shadow_path_id
};

__global__ void __launch_bounds__(kThreads) proxy_march_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_cap, const uint8_t* __restrict__ active, int n,
    march::Table g, int max_hits, int slots, int rays_per_block, float eps, Out out) {
  CYCLES_NOW(t_start);
  constexpr int R = march::kMaxRows;
  __shared__ float s_bmin[3 * R], s_bmax[3 * R], s_ml[R];
  __shared__ float s_xf[12 * R], s_omin[3 * R], s_ospan[3 * R];
  __shared__ int32_t s_node[R], s_obj[R];
  // the block's records, `slots` a ray (ray * slots + slot)
  __shared__ float s_feat[5 * kStageRows], s_t[kStageRows], s_ratio[kStageRows];
  __shared__ int32_t s_row[kStageRows];  // proxy row << 1 | inside
  __shared__ int s_count[kThreads];

  const int t = threadIdx.x;
  for (int j = t; j < 3 * g.p; j += kThreads) {
    s_bmin[j] = g.bmin[j];
    s_bmax[j] = g.bmax[j];
    if (g.xf != nullptr) {
      s_omin[j] = g.omin[j];
      s_ospan[j] = g.ospan[j];
    }
  }
  for (int j = t; j < g.p; j += kThreads) {
    s_ml[j] = g.max_length[j];
    s_node[j] = g.node[j];
    s_obj[j] = g.obj[j];
  }
  if (g.xf != nullptr) {
    for (int j = t; j < 12 * g.p; j += kThreads) s_xf[j] = g.xf[j];
  }
  __syncthreads();
  const bool inst = g.xf != nullptr;
  const march::Table tb{s_bmin, s_bmax, s_ml, s_node, s_obj, inst ? s_xf : nullptr,
                        inst ? s_omin : nullptr, inst ? s_ospan : nullptr, g.p, g.my_node};

  const int i0 = blockIdx.x * rays_per_block;
  const int rays = min(rays_per_block, n - i0);
  if (t < rays) {
    const int i = i0 + t;
    int count = 0;
    if (active[i]) {
      const float ro[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
      const float rd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      count = march::march_ray(
          tb, ro, rd, t_cap[i], max_hits, eps,
          [&](int slot, const march::Record& rec) {
            const int e = t * slots + slot;
#pragma unroll
            for (int f = 0; f < 5; ++f) s_feat[5 * e + f] = rec.feat[f];
            s_t[e] = rec.t;
            s_ratio[e] = rec.ratio;
            s_row[e] = (rec.row << 1) | (rec.inside ? 1 : 0);
          });
      CYCLES_COUNT(kMarchRays, 1);
    }
    s_count[t] = count;
  }
  CYCLES_ADD(kMarchLoop, t_start);
  __syncthreads();
  CYCLES_NOW(t_store);

  // the block's rows, contiguous in every output array. Empty rows: zero
  // features, ids -1, ratio 1, and the diagonal of table row 0 (the oracle
  // gathers at the clamped id)
  const int rows = rays * max_hits;
  const size_t q0 = static_cast<size_t>(i0) * max_hits;
  const float ml0 = s_ml[0];
  for (int e = t; e < rows; e += kThreads) {
    const int ray = e / max_hits;
    const int slot = e - ray * max_hits;
    const size_t q = q0 + e;
    out.path_index[q] = i0 + ray;
    out.zeros[q] = 0;
    if (slot < s_count[ray]) {
      const int es = ray * slots + slot;
      const int r = s_row[es] >> 1;
      const float ml = s_ml[r];
      out.aabb_id[q] = s_obj[r];
      out.node_id[q] = s_node[r];
      out.hit_sequence[q] = slot;
      out.is_inside[q] = static_cast<uint8_t>(s_row[es] & 1);
      out.is_valid[q] = 1;
      out.aabb_t[q] = s_t[es];
      out.max_length[q] = ml;
      out.t_ratio[q] = s_ratio[es];
      out.normalized_t[q] = s_t[es] / fmaxf(s_ratio[es] * ml, 1e-12f);
    } else {
      out.aabb_id[q] = -1;
      out.node_id[q] = -1;
      out.hit_sequence[q] = 0;
      out.is_inside[q] = 0;
      out.is_valid[q] = 0;
      out.aabb_t[q] = 0.0f;
      out.max_length[q] = ml0;
      out.t_ratio[q] = 1.0f;
      out.normalized_t[q] = 0.0f / fmaxf(ml0, 1e-12f);
    }
  }
  float* feat = out.features + 5 * q0;
  for (int e = t; e < 5 * rows; e += kThreads) {
    const int row = e / 5;
    const int ray = row / max_hits;
    const int slot = row - ray * max_hits;
    feat[e] = slot < s_count[ray] ? s_feat[5 * (ray * slots + slot) + (e - 5 * row)] : 0.0f;
  }
  CYCLES_ADD(kMarchStore, t_store);
  if (t == 0) CYCLES_COUNT(kMarchBlocks, 1);
}

}  // namespace

// C entry point: launches on the caller's stream and returns
// cudaGetLastError() (0 = launched). zeros receives the zero pixel_index /
// shadow_path_id column. The caller keeps 5 * n * max_hits below 2^31 (the
// features' element count), so every index within a block fits an int.
extern "C" int proxy_march(
    const float* o, const float* d, const float* t_cap, const uint8_t* active,
    int n, const float* bmin, const float* bmax, const float* max_length,
    const int32_t* node, const int32_t* obj, const float* xf, const float* omin,
    const float* ospan, int p, int my_node, int max_hits, float eps,
    float* features, int32_t* aabb_id, int32_t* node_id, int32_t* hit_sequence,
    uint8_t* is_inside, uint8_t* is_valid, int32_t* path_index, float* aabb_t,
    float* out_max_length, float* t_ratio, float* normalized_t, int32_t* zeros,
    void* stream) {
  if (p < 1 || p > march::kMaxRows || max_hits < 0 ||
      5LL * n * max_hits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && max_hits > 0) {
    const int slots = min(max_hits, p);
    const int rays = min(kThreads, kStageRows / slots);
    proxy_march_kernel<<<static_cast<int>((n + rays - 1LL) / rays), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        o, d, t_cap, active, n,
        march::Table{bmin, bmax, max_length, node, obj, xf, omin, ospan, p, my_node},
        max_hits, slots, rays, eps,
        Out{features, aabb_id, node_id, hit_sequence, is_inside, is_valid,
            path_index, aabb_t, out_max_length, t_ratio, normalized_t, zeros});
  }
  return static_cast<int>(cudaGetLastError());
}
