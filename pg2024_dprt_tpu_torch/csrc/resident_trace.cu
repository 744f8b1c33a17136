// Resident closest-hit (K1) and any-hit (K2) ray-triangle traversal for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// K1 resident_closest replaces the JAX package's closest-hit Pallas kernels
// pallas_resident.py::_kernel, _kernel_tiny and _kernel_tiny_t; K2
// resident_anyhit replaces _occl_kernel, _occl_kernel_tiny and
// _occl_kernel_tiny_t. Those six compute two functions on three TPU layouts;
// this file computes the same two functions once, per ray:
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
//     (_refine_winners and the epilogue at pallas_resident.py:2400-2455).
//
// The TPU kernels' layout is not carried over: no (8, mp) ray packing, no
// packed t|lane keys, no one-hot MXU extraction. The winner is the
// lexicographic minimum of (t, slot), slot = cluster * C + lane, so the
// result does not depend on visit order and equals the dense plain version
// in ops/resident.py.
//
// The per-ray device functions (scene-exit cap, slab test, MT test, the
// closest-hit and any-hit loops, the refinement) live in resident_trace.cuh,
// which the frame kernel (frame.cu) shares; the kernels here are thin
// wrappers that load one ray of a wavefront and store its record.
//
// Design: one thread per ray. K1 visits the clusters the ray enters in
// front-to-back order of (enter distance, cluster), selecting the next one
// by a fresh O(K) slab pass (no per-ray list in memory), and stops when the
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
// Built with --fmad=false: contracted multiply-adds would round grazing
// and edge hits differently from the plain version.

#include "resident_trace.cuh"

namespace {

using resident::Hit;
using resident::Ray;
using resident::Tables;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) resident_closest_kernel(
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

__global__ void __launch_bounds__(kThreads) resident_anyhit_kernel(
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

}  // namespace

// C entry points: launch on the caller's stream and return
// cudaGetLastError() (0 = launched).
extern "C" int resident_closest(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* tri_map, const int32_t* counts, const float* scene_aabb,
    int nk, int c, float* out_t, float* out_u, float* out_v, int32_t* out_tri,
    uint8_t* out_hit, void* stream) {
  if (n > 0) {
    resident_closest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        Tables{boxes, table, tri_map, counts, scene_aabb, nk, c}, out_t,
        out_u, out_v, out_tri, out_hit);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resident_anyhit(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* active, int n, const float* boxes, const float* table,
    const int32_t* counts, const float* scene_aabb, int nk, int c,
    uint8_t* out_occ, void* stream) {
  if (n > 0) {
    resident_anyhit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, active, n,
        Tables{boxes, table, nullptr, counts, scene_aabb, nk, c}, out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}
