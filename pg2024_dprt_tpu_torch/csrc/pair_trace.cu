// Streaming pair tracer for Hopper (sm_90a): closest hit (K11 pair_closest),
// any hit (K12 pair_anyhit) and the Woop-transform closest hit (K13
// pair_woop), bound to PyTorch through a plain C interface (ctypes).
//
// K11 replaces the JAX package's pallas_tracer.py::_kernel, K12 its
// _occl_kernel and K13 its _woop_kernel (pallas_calls at :530 and :540). The
// TPU grid walks a global pool of (tile, cluster) pair slots, pp slots per
// step, revisiting one tile's output block for all the steps of its region;
// each slot's triangle row (cl_tri_table, 10*C floats, or cl_woop_table's
// 16*C) is streamed into VMEM by the scalar-prefetched cluster id. Here a
// thread block owns one tile of tile_rays rays (one thread per ray) and
// walks its region's slots in order (ops/tracer.py prepares the region:
// the interval cull, the front-to-back order, the budget). For each slot
// whose flag has bit 1 set the block stages the cluster's row in shared
// memory and each thread tests its ray against the C triangles in lane
// order. A tile that did not fit the budget writes a miss.
//
//   * Closest hit (K11, K13): strict improvement of the running best t
//     (initialised to the ray's capped tmax), so the lowest lane wins a tie
//     within a cluster and an earlier slot wins over a later one, as in the
//     TPU kernels' min + lowest-lane selection. The id is cl_tri_map[slot]
//     (int32), not the f32 tmap row, which is exact only below 2^24;
//     tmap >= 0 stays the validity test.
//   * Horizon (K11, K13): before each slot the block takes the max of its
//     rays' running t and skips the slot when the slot's conservative enter
//     distance (monotone int bits) is not below it. Such a slot cannot
//     improve any ray, so checking per slot gives the results of the TPU's
//     per-step check (pallas_tracer.py:210-213).
//   * K12 stops the tile once every ray is occluded (__syncthreads_and).
//   * K11 / K12 compute the edges in the kernel (e1 = v1 - v0, e2 = v2 - v0)
//     and run the TPU kernels' Moller-Trumbore: p = d x e2, det = e1.p,
//     u = s.p / det, q = s x e1, v = d.q / det, t = e2.q / det.
//   * K13 moves the ray into each triangle's unit space, o' = [o, 1] W and
//     d' = [d, 0] W, from the JAX (4, 4*C) block layout as explicit FP32
//     sums in a fixed order (no tensor cores: TF32 loses grazing hits, and
//     the TPU's HIGHEST-precision MXU path was slower than its VPU one),
//     then t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y with the
//     |d'z| > 1e-12 and eps = 1e-5 tests (pallas_tracer.py:90-107).
//
// Every operation is written as in the plain versions in ops/tracer.py, and
// the library is built with --fmad=false, so kernel and plain version agree
// ray for ray.
//
// What bounds it on an H100: FP32 operations, about 40 per ray-triangle
// test; each staged row is read once per block from global memory and then
// by every thread from shared memory. This first version keeps one tile per
// block (128 blocks for 65,536 rays at 512 rays a tile, fewer than the 132
// SMs) and no double buffering of the staged rows.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;

enum Mode { kClosest = 0, kAnyHit = 1, kWoop = 2 };

struct Pairs {
  const int32_t* tile_offset;  // (T,) first slot of each tile's region
  const int32_t* tile_region;  // (T,) slots of each tile's region
  const uint8_t* tile_fit;     // (T,) the region's first step fits the budget
  const int32_t* cluster;      // (budget,) cluster of each slot
  const int32_t* flags;        // (budget,) bit 0 init, bit 1 pair present
  const int32_t* enter;        // (budget,) conservative enter distance, int bits
  int budget;
};

// max over the block of v; every thread gets it. Contains two barriers,
// the second so that a following call may reuse the scratch.
__device__ float block_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < (blockDim.x >> 5); ++w) m = fmaxf(m, scratch[w]);
  __syncthreads();
  return m;
}

template <int MODE>
__global__ void pair_kernel(const float* __restrict__ rays, Pairs pairs,
                            const float* __restrict__ table,
                            const int32_t* __restrict__ tri_map, int c,
                            float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                            float* __restrict__ out_u, float* __restrict__ out_v,
                            uint8_t* __restrict__ out_occ) {
  extern __shared__ float row[];
  __shared__ float scratch[kMaxWarps];
  const int tile = blockIdx.x;
  const int64_t r = static_cast<int64_t>(tile) * blockDim.x + threadIdx.x;
  const float* ray = rays + r * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float tmin = ray[6], tmax = ray[7];

  float best_t = tmax, best_u = 0.0f, best_v = 0.0f;
  int64_t best_slot = -1;
  bool occ = false;

  if (pairs.tile_fit[tile]) {
    const int width = (MODE == kWoop ? 16 : 10) * c;
    const int s0 = pairs.tile_offset[tile];
    const int s1 = min(s0 + pairs.tile_region[tile], pairs.budget);
    for (int s = s0; s < s1; ++s) {
      if ((pairs.flags[s] & 2) == 0) continue;  // block-uniform
      if (MODE == kAnyHit) {
        if (__syncthreads_and(occ)) break;
      } else {
        const float worst = block_max(best_t, scratch);
        if (!(pairs.enter[s] < __float_as_int(worst))) continue;
      }
      const int64_t cl = pairs.cluster[s];
      __syncthreads();  // the previous row has been read by every thread
      const float* src = table + cl * width;
      for (int i = threadIdx.x; i < width; i += blockDim.x) row[i] = src[i];
      __syncthreads();

      if (MODE == kWoop) {
        // W is (4, 4C) row-major: row q input component (x, y, z, 1),
        // column block p output component (x', y', z', tmap)
        const float* w0 = row;
        const float* w1 = row + 4 * c;
        const float* w2 = row + 8 * c;
        const float* w3 = row + 12 * c;
        for (int j = 0; j < c; ++j) {
          const int jx = j, jy = c + j, jz = 2 * c + j, jm = 3 * c + j;
          const float opx = ox * w0[jx] + oy * w1[jx] + oz * w2[jx] + w3[jx];
          const float opy = ox * w0[jy] + oy * w1[jy] + oz * w2[jy] + w3[jy];
          const float opz = ox * w0[jz] + oy * w1[jz] + oz * w2[jz] + w3[jz];
          const float dpx = dx * w0[jx] + dy * w1[jx] + dz * w2[jx];
          const float dpy = dx * w0[jy] + dy * w1[jy] + dz * w2[jy];
          const float dpz = dx * w0[jz] + dy * w1[jz] + dz * w2[jz];
          const float tmap = w3[jm];
          const bool dz_ok = fabsf(dpz) > 1e-12f;
          const float inv_dz = dz_ok ? 1.0f / dpz : 0.0f;
          const float t = -opz * inv_dz;
          const float u = opx + t * dpx;
          const float v = opy + t * dpy;
          if (dz_ok && tmap >= 0.0f && u >= -1e-5f && v >= -1e-5f &&
              u + v <= 1.00001f && t > tmin && t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_slot = cl * c + j;
          }
        }
      } else {
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
          if (MODE == kAnyHit) {
            occ = occ || (inside && t < tmax);
          } else if (inside && t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_slot = cl * c + j;
          }
        }
      }
    }
  } else {
    best_t = 0.0f;  // a tile that did not fit: the TPU wrapper's miss row
  }

  if (MODE == kAnyHit) {
    out_occ[r] = occ ? 1 : 0;
  } else {
    out_t[r] = best_t;
    out_tri[r] = best_slot >= 0 ? tri_map[best_slot] : -1;
    out_u[r] = best_u;
    out_v[r] = best_v;
  }
}

template <int MODE>
int launch(const float* rays, int tiles, int tile_rays, Pairs pairs, const float* table,
           const int32_t* tri_map, int c, float* out_t, int32_t* out_tri, float* out_u,
           float* out_v, uint8_t* out_occ, void* stream) {
  if (tile_rays < 32 || tile_rays > 32 * kMaxWarps || tile_rays % 32 != 0 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles < 1) return 0;
  const size_t smem = sizeof(float) * (MODE == kWoop ? 16 : 10) * static_cast<size_t>(c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pair_kernel<MODE><<<tiles, tile_rays, smem, static_cast<cudaStream_t>(stream)>>>(
      rays, pairs, table, tri_map, c, out_t, out_tri, out_u, out_v, out_occ);
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
// cl_woop_table for pair_woop. Outputs per packed ray.
extern "C" int pair_closest(const float* rays, int tiles, int tile_rays,
                            const int32_t* tile_offset, const int32_t* tile_region,
                            const uint8_t* tile_fit, const int32_t* cluster,
                            const int32_t* flags, const int32_t* enter, int budget,
                            const float* table, const int32_t* tri_map, int c, float* out_t,
                            int32_t* out_tri, float* out_u, float* out_v, void* stream) {
  return launch<kClosest>(
      rays, tiles, tile_rays,
      make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table,
      tri_map, c, out_t, out_tri, out_u, out_v, nullptr, stream);
}

extern "C" int pair_woop(const float* rays, int tiles, int tile_rays,
                         const int32_t* tile_offset, const int32_t* tile_region,
                         const uint8_t* tile_fit, const int32_t* cluster, const int32_t* flags,
                         const int32_t* enter, int budget, const float* table,
                         const int32_t* tri_map, int c, float* out_t, int32_t* out_tri,
                         float* out_u, float* out_v, void* stream) {
  return launch<kWoop>(
      rays, tiles, tile_rays,
      make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table,
      tri_map, c, out_t, out_tri, out_u, out_v, nullptr, stream);
}

extern "C" int pair_anyhit(const float* rays, int tiles, int tile_rays,
                           const int32_t* tile_offset, const int32_t* tile_region,
                           const uint8_t* tile_fit, const int32_t* cluster,
                           const int32_t* flags, const int32_t* enter, int budget,
                           const float* table, int c, uint8_t* out_occ, void* stream) {
  return launch<kAnyHit>(
      rays, tiles, tile_rays,
      make_pairs(tile_offset, tile_region, tile_fit, cluster, flags, enter, budget), table,
      nullptr, c, nullptr, nullptr, nullptr, nullptr, out_occ, stream);
}
