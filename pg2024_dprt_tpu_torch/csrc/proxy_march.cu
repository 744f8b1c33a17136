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
// Design: one thread per ray; P is at most 32, so the table (at most 1.7 KB
// with the instancing rows) is read through the read-only cache and the
// slab distances are recomputed at every step rather than kept per thread.
//
// What bounds it on an H100: bytes. A ray reads 29 bytes and writes
// max_hits records of 54 bytes (191 bytes a ray at max_hits 3), against
// some max_hits * P * 25 = 600 FP32 operations at P = 8: 57 microseconds a
// million rays at 3.35 TB/s against 9 at 67 TFLOP/s.
//
// Built with --fmad=false, so that distances and features round like the
// plain version's.

#include "proxy_march.cuh"

namespace {

constexpr int kThreads = 128;

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
};

__global__ void __launch_bounds__(kThreads) proxy_march_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_cap, const uint8_t* __restrict__ active, int n,
    march::Table tb, int max_hits, float eps, Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t base = (size_t)i * max_hits;
  int count = 0;
  if (active[i]) {
    const float ro[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const float rd[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    count = march::march_ray(
        tb, ro, rd, t_cap[i], max_hits, eps,
        [&](int slot, const march::Record& rec) {
          const size_t q = base + slot;
#pragma unroll
          for (int f = 0; f < 5; ++f) out.features[5 * q + f] = rec.feat[f];
          const float ml = tb.max_length[rec.row];
          out.aabb_id[q] = tb.obj[rec.row];
          out.node_id[q] = tb.node[rec.row];
          out.hit_sequence[q] = slot;
          out.is_inside[q] = rec.inside ? 1 : 0;
          out.is_valid[q] = 1;
          out.path_index[q] = i;
          out.aabb_t[q] = rec.t;
          out.max_length[q] = ml;
          out.t_ratio[q] = rec.ratio;
          out.normalized_t[q] = rec.t / fmaxf(rec.ratio * ml, 1e-12f);
        });
  }
  // the empty rows of the oracle's layout: zero features, ids -1, ratio 1,
  // and the diagonal of table row 0 (the oracle gathers at the clamped id)
  const float ml0 = tb.max_length[0];
  for (int slot = count; slot < max_hits; ++slot) {
    const size_t q = base + slot;
#pragma unroll
    for (int f = 0; f < 5; ++f) out.features[5 * q + f] = 0.0f;
    out.aabb_id[q] = -1;
    out.node_id[q] = -1;
    out.hit_sequence[q] = 0;
    out.is_inside[q] = 0;
    out.is_valid[q] = 0;
    out.path_index[q] = i;
    out.aabb_t[q] = 0.0f;
    out.max_length[q] = ml0;
    out.t_ratio[q] = 1.0f;
    out.normalized_t[q] = 0.0f / fmaxf(ml0, 1e-12f);
  }
}

}  // namespace

// C entry point: launches on the caller's stream and returns
// cudaGetLastError() (0 = launched).
extern "C" int proxy_march(
    const float* o, const float* d, const float* t_cap, const uint8_t* active,
    int n, const float* bmin, const float* bmax, const float* max_length,
    const int32_t* node, const int32_t* obj, const float* xf, const float* omin,
    const float* ospan, int p, int my_node, int max_hits, float eps,
    float* features, int32_t* aabb_id, int32_t* node_id, int32_t* hit_sequence,
    uint8_t* is_inside, uint8_t* is_valid, int32_t* path_index, float* aabb_t,
    float* out_max_length, float* t_ratio, float* normalized_t, void* stream) {
  if (p < 1 || p > march::kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    proxy_march_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        o, d, t_cap, active, n,
        march::Table{bmin, bmax, max_length, node, obj, xf, omin, ospan, p, my_node},
        max_hits, eps,
        Out{features, aabb_id, node_id, hit_sequence, is_inside, is_valid,
            path_index, aabb_t, out_max_length, t_ratio, normalized_t});
  }
  return static_cast<int>(cudaGetLastError());
}
