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
//      functions K1 runs), exact t/u/v and the canonical id;
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
// Every random draw and the order of every float operation follow the
// composed path (render/shade.py, core/math.py), so the two frames differ
// only where sinf/cosf/acosf/atan2f round differently from PyTorch's
// kernels. Accumulation is deterministic: one thread owns one pixel and
// adds its samples in order, so two launches give identical images (the
// composed path's index_add_ adds with atomics).
//
// The TPU kernel's layout is not carried over: no (1, TM) row state and
// transposes, no transposed tiny-scene tables, no per-cluster attribute DMA
// loop, no one-hot MXU gathers (lights, env and texels are read by index),
// no HBM double buffering or grouped dispatch, no polynomial atan2/acos, no
// (tiles, spp) grid that revisits an output block (the sample loop is inside
// the thread).
//
// Design: one thread per pixel, threads in the tiled pixel order so that a
// warp's rays stay coherent; the thread loops over samples and bounces and
// stops a path at its first miss or failed roulette. What bounds it on an
// H100: FP32 operations, as K1/K2 (the ray-triangle and slab tests of every
// bounce's closest and any-hit queries); the bytes it must move (4 B in and
// 24 B out per pixel, the tables once) are far below. What it costs and
// does not fix: after the first bounce a warp runs as long as its longest
// path and its slowest shadow ray while the other lanes idle.
//
// Built with --fmad=false, like the trace kernels.

#include "resident_trace.cuh"

namespace {

using resident::Hit;
using resident::Ray;
using resident::Tables;

constexpr int kThreads = 128;
constexpr float kEps = 1e-8f;         // core/math.py EPS
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kRrFloor = 0.05f;     // render/shade.py RR_FLOOR
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
  // lights (L, 3) x 4
  const float* __restrict__ lp0;
  const float* __restrict__ lp1;
  const float* __restrict__ lp2;
  const float* __restrict__ lrad;
  int l_count;
  // environment (H, W, 3)
  const float* __restrict__ env;
  int eh, ew;
  float env_rot;
  // textures: texels (T, 4), per-texture offset / height / width
  const float* __restrict__ texels;
  const int32_t* __restrict__ tex_offset;
  const int32_t* __restrict__ tex_height;
  const int32_t* __restrict__ tex_width;
  int n_tex;
  const int32_t* __restrict__ salts;  // (spp, 32), see kSaltCols
  int spp, bounces, s, ris, rr_start;
  float eps;
  float* __restrict__ out_direct;  // (npix, 3) pixel order
  float* __restrict__ out_env;     // (npix, 3)
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
// core/math.py dot: left to right, no reduction
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 normalize(V3 a) {
  return a / fmaxf(norm(a), kEps);
}

// core/math.py make_frame (Duff et al.): tangent t and bitangent b around n
__device__ __forceinline__ void make_frame(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float bb = n.x * n.y * a;
  t = {1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = {bb, sign + n.y * n.y * a, -n.y};
}

// core/rng.py tea (4 rounds) and rnd, natively in uint32
__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ float rnd(uint32_t& seed) {
  seed = 1664525u * seed + 1013904223u;
  return static_cast<float>(seed & 0x00FFFFFFu) / 16777216.0f;
}

// Python-style modulo for a positive divisor
__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// scene/lights.py EnvironmentMap.sample: lat-long bilinear, azimuth rotated
// and wrapped, rows clamped
__device__ V3 env_sample(const FrameArgs& a, V3 d) {
  const float theta = acosf(fminf(fmaxf(d.y, -1.0f), 1.0f));
  float phi = atan2f(d.z, d.x);
  if (phi < 0.0f) phi = phi + kTwoPi;
  phi = phi + a.env_rot;
  if (phi > kTwoPi) phi = phi - kTwoPi;
  const float u = phi / kTwoPi;
  const float v = theta / kPi;
  const int h = a.eh, w = a.ew;
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = pmod(static_cast<int>(x0), w);
  const int x1i = pmod(x0i + 1, w);
  const int y0i = clampi(static_cast<int>(y0), 0, h - 1);
  const int y1i = clampi(y0i + 1, 0, h - 1);
  const V3 c00 = ld3(a.env + 3 * (y0i * w + x0i));
  const V3 c01 = ld3(a.env + 3 * (y0i * w + x1i));
  const V3 c10 = ld3(a.env + 3 * (y1i * w + x0i));
  const V3 c11 = ld3(a.env + 3 * (y1i * w + x1i));
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return c00 * gx * gy + c01 * fx * gy + c10 * gx * fy + c11 * fx * fy;
}

// scene/textures.py sample_textures (rgb only): bilinear, integer wrap, the
// v flip
__device__ V3 texture_sample(const FrameArgs& a, int ti, float uu, float vv) {
  const int h = a.tex_height[ti], w = a.tex_width[ti], off = a.tex_offset[ti];
  const float x = uu * static_cast<float>(w) - 0.5f;
  const float y = (1.0f - vv) * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = pmod(static_cast<int>(x0), w);
  const int x1i = pmod(x0i + 1, w);
  const int y0i = pmod(static_cast<int>(y0), h);
  const int y1i = pmod(y0i + 1, h);
  const V3 c00 = ld3(a.texels + 4 * (off + y0i * w + x0i));
  const V3 c01 = ld3(a.texels + 4 * (off + y0i * w + x1i));
  const V3 c10 = ld3(a.texels + 4 * (off + y1i * w + x0i));
  const V3 c11 = ld3(a.texels + 4 * (off + y1i * w + x1i));
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return c00 * gx * gy + c01 * fx * gy + c10 * gx * fy + c11 * fx * fy;
}

// core/math.py dielectric_reflectance
__device__ __forceinline__ float fresnel(float cos_theta_i, float eta_i,
                                         float eta_t) {
  const float cos_i = fminf(fmaxf(cos_theta_i, 0.0f), 1.0f);
  const float sin2_i = fmaxf(1.0f - cos_i * cos_i, 0.0f);
  const float eta = eta_i / eta_t;
  const float sin2_t = eta * eta * sin2_i;
  const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
  const float r_parl = (eta_t * cos_i - eta_i * cos_t) /
                       fmaxf(eta_t * cos_i + eta_i * cos_t, kEps);
  const float r_perp = (eta_i * cos_i - eta_t * cos_t) /
                       fmaxf(eta_i * cos_i + eta_t * cos_t, kEps);
  const float f = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return sin2_t >= 1.0f ? 1.0f : f;
}

// One NEE light candidate of a shading point (render/shade.py shade).
struct Candidate {
  V3 wi;       // direction to the light sample
  float dist;
  V3 c;        // unoccluded contribution
  float w;     // c.x + c.y + c.z where valid, else 0
};

__device__ Candidate light_candidate(
    const FrameArgs& a, uint32_t pix, int j, uint32_t salt, V3 point,
    V3 normal, V3 tp, V3 albedo) {
  uint32_t seed = tea(pix * static_cast<uint32_t>(a.s) + static_cast<uint32_t>(j), salt);
  const float sx1 = rnd(seed), sx2 = rnd(seed), sx3 = rnd(seed);
  const float lf = static_cast<float>(a.l_count);
  int li = static_cast<int>(floorf(sx1 * lf));
  li = li > a.l_count - 1 ? a.l_count - 1 : li;
  const V3 p0 = ld3(a.lp0 + 3 * li), p1 = ld3(a.lp1 + 3 * li),
           p2 = ld3(a.lp2 + 3 * li), le = ld3(a.lrad + 3 * li);
  // core/math.py uniform_sample_triangle
  const float su = sqrtf(sx2);
  const float b0 = 1.0f - su, b1 = sx3 * su;
  const V3 e1 = p1 - p0, e2 = p2 - p0;
  const V3 lpnt = p0 + e1 * b0 + e2 * b1;
  const V3 cr = cross(e1, e2);
  const float area = 0.5f * norm(cr);
  const V3 lnorm = cr / fmaxf(2.0f * area, kEps);
  const float area_pdf = (1.0f / fmaxf(area, kEps)) / lf;

  Candidate cd;
  const V3 to_light = lpnt - point;
  cd.dist = norm(to_light);
  cd.wi = to_light / fmaxf(cd.dist, 1e-12f);
  const float cosl = fmaxf(dot(lnorm, neg(cd.wi)), 0.0f);
  const float coss = fmaxf(dot(cd.wi, normal), 0.0f);
  const float d2 = fmaxf(cd.dist * cd.dist, 1e-12f);
  const V3 base = le * tp * albedo;
  cd.c = {base.x * cosl * coss / area_pdf / d2 / kPi,
          base.y * cosl * coss / area_pdf / d2 / kPi,
          base.z * cosl * coss / area_pdf / d2 / kPi};
  const float c_sum = cd.c.x + cd.c.y + cd.c.z;
  // zero-contribution samples need no occlusion trace
  cd.w = c_sum > 0.0f ? c_sum : 0.0f;
  return cd;
}

__global__ void __launch_bounds__(kThreads) frame_sample_kernel(FrameArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.npix) return;
  const int32_t pixel = a.pix_ids[i];
  const uint32_t pix = static_cast<uint32_t>(pixel);
  const int prow = pixel / a.width, pcol = pixel % a.width;

  const V3 cam_o = ld3(a.cam_origin), fwd = ld3(a.cam_forward),
           rgt = ld3(a.cam_right), upv = ld3(a.cam_up);
  const float thf = a.cam_tan_half_fov[0];
  const float thf_a = thf * a.aspect;
  const float s_f = static_cast<float>(a.s);

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

    for (int b = 0; b < a.bounces; ++b) {
      const uint32_t salt = salts[b];
      // ---- 1. closest hit
      Ray r;
      r.o[0] = o.x; r.o[1] = o.y; r.o[2] = o.z;
      r.d[0] = d.x; r.d[1] = d.y; r.d[2] = d.z;
      resident::cap_ray(r, a.eps, resident::kF32Max, a.scene.scene_aabb);
      const Hit h = resident::closest_hit(r, a.scene);
      if (!h.hit) {
        // ---- 4. environment on a miss; the path ends
        env_acc = env_acc + tp * env_sample(a, d);
        break;
      }

      // ---- 2. attributes (render/shade.py surface_attributes)
      const float* row = a.tri_shade + static_cast<size_t>(h.tri) * 24;
      const float u = h.u, v = h.v;
      const float w = 1.0f - u - v;
      V3 normal = normalize(ld3(row) * w + ld3(row + 3) * u + ld3(row + 6) * v);
      V3 albedo = ld3(row + 15);
      const bool is_water = static_cast<int>(row[18]) == 1;  // BSDF_WATER
      if (a.n_tex > 0) {
        const int ti = static_cast<int>(row[19]);
        if (ti >= 0) {
          const float uu = w * row[9] + u * row[11] + v * row[13];
          const float vv = w * row[10] + u * row[12] + v * row[14];
          albedo = texture_sample(a, ti, uu, vv);
        }
      }
      const V3 point = o + d * h.t;
      const V3 wo_world = neg(d);
      const bool is_inside = dot(normal, wo_world) < 0.0f;
      if (is_inside) normal = neg(normal);

      // ---- 3. BSDF sample (render/shade.py bsdf_sample)
      uint32_t seed = tea(pix, salt);
      const float xi1 = rnd(seed), xi2 = rnd(seed);
      V3 ft, fb;
      make_frame(normal, ft, fb);
      V3 wi_local;
      float weight;
      if (is_water) {
        const V3 wo = {dot(wo_world, ft), dot(wo_world, fb), dot(wo_world, normal)};
        const float eta_i = is_inside ? 1.33f : 1.0f;
        const float eta_t = is_inside ? 1.0f : 1.33f;
        // core/math.py refract_z
        const float eta = eta_i / eta_t;
        const float cos_i = fabsf(wo.z);
        const float sin2_i = fmaxf(1.0f - cos_i * cos_i, 0.0f);
        const float sin2_t = eta * eta * sin2_i;
        const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
        const float sign = wo.z >= 0.0f ? 1.0f : -1.0f;
        const bool reflecting = xi1 < fresnel(fabsf(wo.z), eta_i, eta_t);
        wi_local = reflecting ? v3(-wo.x, -wo.y, wo.z)
                              : v3(-eta * wo.x, -eta * wo.y, -sign * cos_t);
        const float cos_wi = fabsf(wi_local.z);
        const float safe_cos = fmaxf(cos_wi, 1e-12f);
        const float eta_corr = (eta_i / eta_t) * (eta_i / eta_t);
        weight = reflecting ? 1.0f / safe_cos : eta_corr / safe_cos;
        if (cos_wi == 0.0f) weight = 0.0f;
      } else {
        // core/math.py uniform_hemisphere, weight 2
        const float rr = sqrtf(fmaxf(1.0f - xi1 * xi1, 0.0f));
        const float phi = kTwoPi * xi2;
        wi_local = {rr * cosf(phi), rr * sinf(phi), xi1};
        weight = 2.0f;
      }
      const V3 wi_world =
          normalize(ft * wi_local.x + fb * wi_local.y + normal * wi_local.z);
      const float cos_theta = fabsf(wi_local.z);

      // ---- 5. NEE (delta surfaces cast no shadow paths)
      if (!is_water) {
        const bool use_ris = a.ris && a.s > 1;
        Candidate pick;
        pick.w = 0.0f;
        if (use_ris) {
          // weighted reservoir over S candidates: running sums left to
          // right, the first cum > u * W wins (candidate 0 when none does)
          float w_tot = 0.0f;
          for (int j = 0; j < a.s; ++j) {
            w_tot = w_tot +
                light_candidate(a, pix, j, salt, point, normal, tp, albedo).w;
          }
          if (w_tot > 0.0f) {
            uint32_t useed = tea(pix, salts[16 + b]);
            const float thresh = rnd(useed) * w_tot;
            float cum = 0.0f;
            for (int j = 0; j < a.s; ++j) {
              const Candidate cd =
                  light_candidate(a, pix, j, salt, point, normal, tp, albedo);
              cum = cum + cd.w;
              if (j == 0 || cum > thresh) pick = cd;
              if (cum > thresh) break;
            }
            pick.c = pick.c * (w_tot / fmaxf(pick.w, 1e-30f));
          }
        }
        const int n_rays = use_ris ? 1 : a.s;
        for (int j = 0; j < n_rays; ++j) {
          const Candidate cd =
              use_ris ? pick
                      : light_candidate(a, pix, j, salt, point, normal, tp, albedo);
          if (!(cd.w > 0.0f)) continue;
          // tmax is shaved so the light sample point never blocks itself
          Ray sr;
          sr.o[0] = point.x; sr.o[1] = point.y; sr.o[2] = point.z;
          sr.d[0] = cd.wi.x; sr.d[1] = cd.wi.y; sr.d[2] = cd.wi.z;
          resident::cap_ray(sr, a.eps, cd.dist * 0.999f, a.scene.scene_aabb);
          if (!resident::any_hit(sr, a.scene)) direct = direct + cd.c / s_f;
        }
      }

      // ---- 6. next bounce state, Russian roulette
      tp = tp * (weight * cos_theta) * albedo;
      if (a.rr_start && a.rr_start <= b + 1 && b + 1 < a.bounces) {
        uint32_t rseed = tea(pix, salts[24 + b]);
        const float u_rr = rnd(rseed);
        const float p = fminf(fmaxf(fmaxf(fmaxf(tp.x, tp.y), tp.z), kRrFloor), 1.0f);
        if (!(u_rr < p)) break;
        tp = tp / p;
      }
      o = point;
      d = wi_world;
    }
    // ---- 7. samples add in sample order
    direct_sum = direct_sum + direct;
    env_sum = env_sum + env_acc;
  }
  float* od = a.out_direct + 3 * static_cast<size_t>(pixel);
  float* oe = a.out_env + 3 * static_cast<size_t>(pixel);
  od[0] = direct_sum.x; od[1] = direct_sum.y; od[2] = direct_sum.z;
  oe[0] = env_sum.x; oe[1] = env_sum.y; oe[2] = env_sum.z;
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
    const float* tri_shade, const float* lp0, const float* lp1,
    const float* lp2, const float* lrad, int l_count, const float* env, int eh,
    int ew, float env_rot, const float* texels, const int32_t* tex_offset,
    const int32_t* tex_height, const int32_t* tex_width, int n_tex,
    const int32_t* salts, int spp, int bounces,
    int s, int ris, int rr_start, float eps, float* out_direct, float* out_env,
    void* stream) {
  if (npix > 0) {
    FrameArgs a;
    a.pix_ids = pix_ids; a.npix = npix; a.width = width; a.height = height;
    a.cam_origin = cam_origin; a.cam_forward = cam_forward;
    a.cam_right = cam_right; a.cam_up = cam_up;
    a.cam_tan_half_fov = cam_tan_half_fov; a.aspect = aspect;
    a.scene = Tables{boxes, table, tri_map, counts, scene_aabb, nk, c};
    a.tri_shade = tri_shade;
    a.lp0 = lp0; a.lp1 = lp1; a.lp2 = lp2; a.lrad = lrad; a.l_count = l_count;
    a.env = env; a.eh = eh; a.ew = ew; a.env_rot = env_rot;
    a.texels = texels; a.tex_offset = tex_offset; a.tex_height = tex_height;
    a.tex_width = tex_width; a.n_tex = n_tex;
    a.salts = salts; a.spp = spp;
    a.bounces = bounces; a.s = s; a.ris = ris; a.rr_start = rr_start;
    a.eps = eps;
    a.out_direct = out_direct; a.out_env = out_env;
    frame_sample_kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
