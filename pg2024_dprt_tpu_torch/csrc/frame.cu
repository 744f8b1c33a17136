// Whole-sample frame kernel (K3 frame_sample) for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes).
//
// K3 replaces the JAX package's pallas_frame.py::_frame_kernel: every
// sample of a path-traced frame in ONE launch. Per pixel and sample it runs,
// for `bounces` bounces, what the composed frame (render/engine.py) runs as
// a closest-hit launch, some hundreds of eager shade ops and an any-hit
// launch:
//
//   0. the camera ray, from the pixel id, the sample id and the camera
//      (render/pathgen.py: TEA seed tea(pixel, sample), two LCG draws);
//   1. the closest hit with the scene-exit cap (resident_trace.cuh, the
//      walk K1 runs, or K9's warp walk in the grouped mode), exact t/u/v and
//      the canonical id;
//   2. the attributes: one row of tri_shade, smooth normal, optional
//      bilinear wrap albedo texture (scene/textures.py sample_textures),
//      the flip toward wo;
//   3. the BSDF sample with the per-bounce salt: Lambert hemisphere or water
//      Fresnel (render/shade.py bsdf_sample), next direction and weight;
//   4. on a miss the lat-long environment, bilinear, with the rotation;
//   5. NEE: S light candidates with seeds tea(pixel * S + j, salt), the
//      contribution formula, zero-contribution samples skipped, then either
//      every candidate's any-hit ray ("sum") or the RIS pick by left-to-right
//      running sums with the RIS-salt draw and one any-hit ray; unoccluded
//      contributions weighted 1/S;
//   6. the next throughput and Russian roulette with the RR-salt draw;
//   7. the sum over the launch's samples, in sample order.
//
// Steps 2-6 are the device functions of shade.cuh, which the shading kernel
// K14 (shade.cu) shares. Every random draw and the order of every float
// operation follow the composed path (render/shade.py, core/math.py), so
// the two frames differ only where sinf/cosf/acosf/atan2f round differently
// from PyTorch's kernels, and where PyTorch's CUDA kernels multiply by the
// reciprocal of a host scalar that K3 divides by (shade.cuh). Accumulation is deterministic: one thread owns one pixel and
// adds its samples in order, so two launches give identical images (the
// composed path's index_add_ adds with atomics).
//
// The TPU kernel's layout is not carried over: no (1, TM) row state and
// transposes, no transposed tiny-scene tables, no per-cluster attribute DMA
// loop, no one-hot MXU gathers (lights, env and texels are read by index),
// no HBM double buffering (every table is read from global memory), no
// polynomial atan2/acos, no (tiles, spp) grid that revisits an output block
// (the sample loop is inside the thread).
//
// Grouped mode (_frame_kernel's grouped mode, pallas_frame.py:360-375,
// :720-723): when the wrapper passes the group tables (ops/frame.py, by the
// rule of ops/resident.py use_grouped), every closest-hit and any-hit query
// goes through the warp walks of K9 / K10 (resident_trace.cuh closest /
// occluded): the warp traces its lanes' rays one after another, all 32 lanes
// on each. Both modes return the flat walks' results, so the image is
// bit-identical to the flat mode's; only the cull work differs.
//
// Design: one thread per pixel, threads in the tiled pixel order so that a
// warp's rays stay coherent; the thread loops over samples and bounces. The
// loops over samples, bounces and NEE rays run the same counts on every lane,
// and a path that ends (a miss, a failed roulette), a zero-weight light
// candidate and a lane past the last pixel only clear a per-lane flag, so the
// lanes of a warp reach every trace together, as the warp walks need. What
// bounds it on an H100: FP32 operations, as K1/K2 (the ray-triangle and slab
// tests of every bounce's closest and any-hit queries); the bytes it must
// move (4 B in and 24 B out per pixel, the tables once) are far below. What
// bounded it before the warp walks (PERF.md, cycle counters): the per-thread
// grouped walks, every pick a serial pass over the Kg group boxes. What it
// costs and does not fix: 65,536 pixels bring 2,048 warps (15.5 an SM), each
// tracing up to 32 rays in series a bounce, and after the first bounce a
// warp's lanes without a path wait for the others.
//
// Built with --fmad=false, like the trace kernels.

#include "cycles.cuh"
#include "resident_trace.cuh"
#include "shade.cuh"

namespace {

using resident::Hit;
using resident::Ray;
using resident::Tables;
using namespace shading;

// K3 divides by host scalars, as it did before its shading functions moved
// to shade.cuh, so that its images stay bit-identical to those it gave
// (shade.cuh, "Division by a host scalar")
using Div = Divide;

constexpr int kThreads = 128;
// per-sample salt row: cols 0..7 bounce salts, 8 the sample id, 16..23 the
// RIS draw salts, 24..31 the roulette draw salts (ops/frame.py salt_table)
constexpr int kSaltCols = 32;

struct FrameArgs {
  const int32_t* __restrict__ pix_ids;  // (npix,) tiled pixel order
  int npix, width, height;
  // camera (device pointers to the Camera record's tensors)
  const float* __restrict__ cam_origin;
  const float* __restrict__ cam_forward;
  const float* __restrict__ cam_right;
  const float* __restrict__ cam_up;
  const float* __restrict__ cam_tan_half_fov;
  float aspect;
  Tables scene;
  const float* __restrict__ tri_shade;  // (T, 24)
  Lights lights;
  EnvMap env;
  Textures tex;
  const int32_t* __restrict__ salts;  // (spp, 32), see kSaltCols
  int spp, bounces, s, ris, rr_start;
  float eps;
  float* __restrict__ out_direct;  // (npix, 3) pixel order
  float* __restrict__ out_env;     // (npix, 3)
};

__global__ void __launch_bounds__(kThreads) frame_sample_kernel(FrameArgs a) {
  // the warps' team buffers of the grouped walks (unused in the flat mode)
  __shared__ resident::Team teams[kThreads / 32];
  resident::Team& tm = teams[threadIdx.x >> 5];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past the last pixel stays in its warp as a lane without a path:
  // the warp walks need all 32 lanes at every trace
  const bool in_range = i < a.npix;
  CYCLES_NOW(c_kernel);
  const int32_t pixel = in_range ? a.pix_ids[i] : 0;
  const uint32_t pix = static_cast<uint32_t>(pixel);
  const int prow = pixel / a.width, pcol = pixel % a.width;

  const V3 cam_o = ld3(a.cam_origin), fwd = ld3(a.cam_forward),
           rgt = ld3(a.cam_right), upv = ld3(a.cam_up);
  const float thf = a.cam_tan_half_fov[0];
  const float thf_a = thf * a.aspect;
  const float s_f = static_cast<float>(a.s);
  const bool use_ris = a.ris && a.s > 1;
  const int n_rays = use_ris ? 1 : a.s;

  // The loops over samples, bounces and NEE rays run the same counts on
  // every lane, so the lanes of a warp reach every trace together; a path
  // that ends (a miss, a failed roulette) or a zero-weight candidate only
  // clears its lane's flag.
  V3 direct_sum = {0.0f, 0.0f, 0.0f}, env_sum = {0.0f, 0.0f, 0.0f};
  for (int si = 0; si < a.spp; ++si) {
    const uint32_t* salts =
        reinterpret_cast<const uint32_t*>(a.salts) + si * kSaltCols;
    // ---- 0. camera path (render/pathgen.py, core/camera.py)
    uint32_t cseed = tea(pix, salts[8]);
    const float cx1 = rnd(cseed), cx2 = rnd(cseed);
    const float px =
        (static_cast<float>(pcol) + cx1) / static_cast<float>(a.width) * 2.0f - 1.0f;
    const float py =
        1.0f - (static_cast<float>(prow) + cx2) / static_cast<float>(a.height) * 2.0f;
    V3 o = cam_o;
    V3 d = normalize(fwd + rgt * (px * thf_a) + upv * (py * thf));
    V3 tp = {1.0f, 1.0f, 1.0f};
    V3 direct = {0.0f, 0.0f, 0.0f}, env_acc = {0.0f, 0.0f, 0.0f};
    bool alive = in_range;

    for (int b = 0; b < a.bounces; ++b) {
      CYCLES_NOW(c_bounce);
      if (alive) CYCLES_COUNT(24 + b, 1);
      const uint32_t salt = salts[b];
      // ---- 1. closest hit
      Ray r;
      r.o[0] = o.x; r.o[1] = o.y; r.o[2] = o.z;
      r.d[0] = d.x; r.d[1] = d.y; r.d[2] = d.z;
      resident::cap_ray(r, a.eps, resident::kF32Max, a.scene.scene_aabb);
      CYCLES_NOW(c_closest);
      const Hit h = resident::closest(alive, r, a.scene, tm);
      CYCLES_ADD(8 + b, c_closest);
      if (alive && !h.hit) {
        // ---- 4. environment on a miss; the path ends
        env_acc = env_acc + tp * env_sample<Div>(a.env, d);
        alive = false;
      }

      V3 point = {0.0f, 0.0f, 0.0f}, normal = {0.0f, 0.0f, 1.0f};
      V3 albedo = {0.0f, 0.0f, 0.0f};
      BsdfSample bs = {{0.0f, 0.0f, 1.0f}, 0.0f, 0.0f};
      bool is_water = false;
      if (alive) {
        // ---- 2. attributes (render/shade.py surface_attributes)
        const Surface sf = triangle_surface(a.tri_shade, a.tex, h.tri, h.u, h.v);
        normal = normalize(sf.normal);
        albedo = sf.albedo;
        is_water = sf.is_water;
        point = o + d * h.t;
        const V3 wo_world = neg(d);
        const bool is_inside = dot(normal, wo_world) < 0.0f;
        if (is_inside) normal = neg(normal);

        // ---- 3. BSDF sample (render/shade.py bsdf_sample)
        uint32_t seed = tea(pix, salt);
        const float xi1 = rnd(seed), xi2 = rnd(seed);
        bs = bsdf_sample(normal, wo_world, is_inside, is_water, xi1, xi2);
      }

      // ---- 5. NEE (delta surfaces cast no shadow paths)
      const bool nee = alive && !is_water;
      Candidate pick = {};
      if (nee && use_ris) {
        pick = ris_pick<Div>(a.lights, a.s, pix, salt, salts[16 + b], point, normal,
                             tp, albedo);
      }
      for (int j = 0; j < n_rays; ++j) {
        Candidate cd = {};
        if (nee) {
          cd = use_ris ? pick
                       : light_candidate<Div>(a.lights, a.s, pix, j, salt, point,
                                              normal, tp, albedo);
        }
        const bool cast = nee && cd.w > 0.0f;
        // tmax is shaved so the light sample point never blocks itself
        Ray sr;
        sr.o[0] = point.x; sr.o[1] = point.y; sr.o[2] = point.z;
        sr.d[0] = cd.wi.x; sr.d[1] = cd.wi.y; sr.d[2] = cd.wi.z;
        resident::cap_ray(sr, a.eps, cd.dist * 0.999f, a.scene.scene_aabb);
        CYCLES_NOW(c_anyhit);
        const bool occ = resident::occluded(cast, sr, a.scene, tm);
        CYCLES_ADD(16 + b, c_anyhit);
        if (cast && !occ) direct = direct + cd.c / s_f;
      }

      // ---- 6. next bounce state, Russian roulette
      if (alive) {
        tp = tp * (bs.weight * bs.cos_theta) * albedo;
        if (a.rr_start && a.rr_start <= b + 1 && b + 1 < a.bounces) {
          uint32_t rseed = tea(pix, salts[24 + b]);
          alive = roulette(tp, rnd(rseed));
        }
        o = point;
        d = bs.wi_world;
      }
      CYCLES_ADD(b, c_bounce);
    }
    // ---- 7. samples add in sample order
    direct_sum = direct_sum + direct;
    env_sum = env_sum + env_acc;
  }
  if (!in_range) return;
  float* od = a.out_direct + 3 * static_cast<size_t>(pixel);
  float* oe = a.out_env + 3 * static_cast<size_t>(pixel);
  od[0] = direct_sum.x; od[1] = direct_sum.y; od[2] = direct_sum.z;
  oe[0] = env_sum.x; oe[1] = env_sum.y; oe[2] = env_sum.z;
  CYCLES_ADD(32, c_kernel);
  CYCLES_COUNT(33, 1);
}

}  // namespace

// C entry point: launches on the caller's stream and returns
// cudaGetLastError() (0 = launched). Pointers are device pointers.
extern "C" int frame_sample(
    const int32_t* pix_ids, int npix, int width, int height,
    const float* cam_origin, const float* cam_forward, const float* cam_right,
    const float* cam_up, const float* cam_tan_half_fov, float aspect,
    const float* boxes, const float* table, const int32_t* tri_map,
    const int32_t* counts, const float* scene_aabb, int nk, int c,
    const float* gboxes, const float* mboxes, int kg,
    const float* tri_shade, const float* lp0, const float* lp1,
    const float* lp2, const float* lrad, int l_count, const float* env, int eh,
    int ew, float env_rot, const float* texels, const int32_t* tex_offset,
    const int32_t* tex_height, const int32_t* tex_width, int n_tex,
    const int32_t* salts, int spp, int bounces,
    int s, int ris, int rr_start, float eps, float* out_direct, float* out_env,
    void* stream) {
  if (gboxes != nullptr && !resident::group_tables_ok(gboxes, mboxes, kg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (npix > 0) {
    FrameArgs a;
    a.pix_ids = pix_ids; a.npix = npix; a.width = width; a.height = height;
    a.cam_origin = cam_origin; a.cam_forward = cam_forward;
    a.cam_right = cam_right; a.cam_up = cam_up;
    a.cam_tan_half_fov = cam_tan_half_fov; a.aspect = aspect;
    a.scene = Tables{boxes, table, tri_map, counts, scene_aabb, nk, c};
    a.scene.gboxes = gboxes;  // nullptr: the flat walks
    a.scene.mboxes = mboxes;
    a.scene.kg = kg;
    a.tri_shade = tri_shade;
    a.lights = Lights{lp0, lp1, lp2, lrad, l_count};
    a.env = EnvMap{env, eh, ew, env_rot};
    a.tex = Textures{texels, tex_offset, tex_height, tex_width, n_tex};
    a.salts = salts; a.spp = spp;
    a.bounces = bounces; a.s = s; a.ris = ris; a.rr_start = rr_start;
    a.eps = eps;
    a.out_direct = out_direct; a.out_env = out_env;
    frame_sample_kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
