// Device functions of shading, shared by the whole-sample frame kernel
// (frame.cu: K3 frame_sample) and the wavefront shading kernel (shade.cu:
// K14 shade_paths), so that the fused frame and the composed frame's
// shading stage run the same arithmetic:
//
//   * float3 helpers and core/math.py's dot, cross, norm, normalize and
//     make_frame, component by component, left to right;
//   * core/rng.py's TEA-4 hash and LCG draw, natively in uint32;
//   * scene/lights.py EnvironmentMap.sample and scene/textures.py
//     sample_textures (bilinear, wrapped);
//   * render/shade.py: a triangle row's attributes (surface_attributes),
//     the BSDF sample (bsdf_sample: Lambert hemisphere or water Fresnel),
//     one NEE light candidate and its unoccluded contribution, the RIS pick
//     by left-to-right running sums, Russian roulette.
//
// Every function keeps the order of the composed path's float operations,
// and the file must be compiled with --fmad=false, like the trace kernels.
//
// Division by a host scalar. The composed path divides by three Python
// numbers: the light count, pi and 2 pi. PyTorch on the CPU divides; its
// CUDA kernels multiply by the scalar's float reciprocal instead
// (BinaryDivTrueKernel.cu), which rounds differently in the last bit. The
// functions that divide by such a scalar take the rule as a template
// argument. K14 multiplies by the reciprocal, so that it equals the eager
// shade on the card bit for bit where no transcendental function differs.
// K3 keeps the division only so that its images stay bit-identical to those
// it gave before these functions moved here. No test needs that rule: the
// frame tests hold K3 against its plain version run on the card, which
// multiplies by the reciprocal, within the frame tolerance. Dropping
// `Divide` and the template argument is left open (ROADMAP.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace shading {

constexpr float kEps = 1e-8f;         // core/math.py EPS
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kRrFloor = 0.05f;     // render/shade.py RR_FLOOR
constexpr int kBsdfWater = 1;         // core/types.py BSDF_WATER

// x / c for a host scalar c: a division (PyTorch on the CPU) ...
struct Divide {
  static __device__ __forceinline__ float by(float x, float c) { return x / c; }
};
// ... or a product with c's float reciprocal (PyTorch's CUDA kernels)
struct TimesReciprocal {
  static __device__ __forceinline__ float by(float x, float c) { return x * (1.0f / c); }
};

// lights (L, 3) x 4 (scene/lights.py LightTable)
struct Lights {
  const float* __restrict__ p0;
  const float* __restrict__ p1;
  const float* __restrict__ p2;
  const float* __restrict__ radiance;
  int count;
};

// lat-long environment (H, W, 3) and its azimuth rotation
struct EnvMap {
  const float* __restrict__ image;
  int h, w;
  float rotation;
};

// textures: texels (T, 4), per-texture offset / height / width; count 0 for
// an untextured scene
struct Textures {
  const float* __restrict__ texels;
  const int32_t* __restrict__ offset;
  const int32_t* __restrict__ height;
  const int32_t* __restrict__ width;
  int count;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void st3(float* p, V3 a) {
  p[0] = a.x; p[1] = a.y; p[2] = a.z;
}
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
template <class Div>
__device__ V3 env_sample(const EnvMap& e, V3 d) {
  const float theta = acosf(fminf(fmaxf(d.y, -1.0f), 1.0f));
  float phi = atan2f(d.z, d.x);
  if (phi < 0.0f) phi = phi + kTwoPi;
  phi = phi + e.rotation;
  if (phi > kTwoPi) phi = phi - kTwoPi;
  const float u = Div::by(phi, kTwoPi);
  const float v = Div::by(theta, kPi);
  const int h = e.h, w = e.w;
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = pmod(static_cast<int>(x0), w);
  const int x1i = pmod(x0i + 1, w);
  const int y0i = clampi(static_cast<int>(y0), 0, h - 1);
  const int y1i = clampi(y0i + 1, 0, h - 1);
  const V3 c00 = ld3(e.image + 3 * (y0i * w + x0i));
  const V3 c01 = ld3(e.image + 3 * (y0i * w + x1i));
  const V3 c10 = ld3(e.image + 3 * (y1i * w + x0i));
  const V3 c11 = ld3(e.image + 3 * (y1i * w + x1i));
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return c00 * gx * gy + c01 * fx * gy + c10 * gx * fy + c11 * fx * fy;
}

// scene/textures.py sample_textures (rgb only): bilinear, integer wrap, the
// v flip
__device__ V3 texture_sample(const Textures& tx, int ti, float uu, float vv) {
  const int h = tx.height[ti], w = tx.width[ti], off = tx.offset[ti];
  const float x = uu * static_cast<float>(w) - 0.5f;
  const float y = (1.0f - vv) * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = pmod(static_cast<int>(x0), w);
  const int x1i = pmod(x0i + 1, w);
  const int y0i = pmod(static_cast<int>(y0), h);
  const int y1i = pmod(y0i + 1, h);
  const V3 c00 = ld3(tx.texels + 4 * (off + y0i * w + x0i));
  const V3 c01 = ld3(tx.texels + 4 * (off + y0i * w + x1i));
  const V3 c10 = ld3(tx.texels + 4 * (off + y1i * w + x0i));
  const V3 c11 = ld3(tx.texels + 4 * (off + y1i * w + x1i));
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return c00 * gx * gy + c01 * fx * gy + c10 * gx * fy + c11 * fx * fy;
}

// render/shade.py surface_attributes for a triangle hit, from its tri_shade
// row (T, 24): the interpolated smooth normal, not yet normalized or
// flipped; the albedo, textured where the row names a texture; the BSDF
struct Surface {
  V3 normal;
  V3 albedo;
  bool is_water;
};

__device__ __forceinline__ Surface triangle_surface(
    const float* __restrict__ tri_shade, const Textures& tx, int tri, float u,
    float v) {
  const float* row = tri_shade + static_cast<size_t>(tri) * 24;
  const float w = 1.0f - u - v;
  Surface sf;
  sf.normal = ld3(row) * w + ld3(row + 3) * u + ld3(row + 6) * v;
  sf.albedo = ld3(row + 15);
  sf.is_water = static_cast<int>(row[18]) == kBsdfWater;
  if (tx.count > 0) {
    const int ti = static_cast<int>(row[19]);
    if (ti >= 0) {
      const float uu = w * row[9] + u * row[11] + v * row[13];
      const float vv = w * row[10] + u * row[12] + v * row[14];
      sf.albedo = texture_sample(tx, ti, uu, vv);
    }
  }
  return sf;
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

// render/shade.py bsdf_sample at a shading point whose normal faces wo:
// the next direction in world space, the weight and |cos| of the local
// direction
struct BsdfSample {
  V3 wi_world;
  float weight;
  float cos_theta;
};

__device__ __forceinline__ BsdfSample bsdf_sample(V3 normal, V3 wo_world,
                                                  bool is_inside, bool is_water,
                                                  float xi1, float xi2) {
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
  BsdfSample bs;
  bs.wi_world = normalize(ft * wi_local.x + fb * wi_local.y + normal * wi_local.z);
  bs.weight = weight;
  bs.cos_theta = fabsf(wi_local.z);
  return bs;
}

// One NEE light candidate of a shading point (render/shade.py shade).
struct Candidate {
  V3 wi;       // direction to the light sample
  float dist;
  V3 c;        // unoccluded contribution
  float w;     // c.x + c.y + c.z where valid, else 0
};

// candidate j of S at the pixel: seed tea(pix * S + j, salt)
template <class Div>
__device__ Candidate light_candidate(
    const Lights& lt, int s, uint32_t pix, int j, uint32_t salt, V3 point,
    V3 normal, V3 tp, V3 albedo) {
  uint32_t seed = tea(pix * static_cast<uint32_t>(s) + static_cast<uint32_t>(j), salt);
  const float sx1 = rnd(seed), sx2 = rnd(seed), sx3 = rnd(seed);
  const float lf = static_cast<float>(lt.count);
  int li = static_cast<int>(floorf(sx1 * lf));
  li = li > lt.count - 1 ? lt.count - 1 : li;
  const V3 p0 = ld3(lt.p0 + 3 * li), p1 = ld3(lt.p1 + 3 * li),
           p2 = ld3(lt.p2 + 3 * li), le = ld3(lt.radiance + 3 * li);
  // core/math.py uniform_sample_triangle
  const float su = sqrtf(sx2);
  const float b0 = 1.0f - su, b1 = sx3 * su;
  const V3 e1 = p1 - p0, e2 = p2 - p0;
  const V3 lpnt = p0 + e1 * b0 + e2 * b1;
  const V3 cr = cross(e1, e2);
  const float area = 0.5f * norm(cr);
  const V3 lnorm = cr / fmaxf(2.0f * area, kEps);
  const float area_pdf = Div::by(1.0f / fmaxf(area, kEps), lf);

  Candidate cd;
  const V3 to_light = lpnt - point;
  cd.dist = norm(to_light);
  cd.wi = to_light / fmaxf(cd.dist, 1e-12f);
  const float cosl = fmaxf(dot(lnorm, neg(cd.wi)), 0.0f);
  const float coss = fmaxf(dot(cd.wi, normal), 0.0f);
  const float d2 = fmaxf(cd.dist * cd.dist, 1e-12f);
  const V3 base = le * tp * albedo;
  cd.c = {Div::by(base.x * cosl * coss / area_pdf / d2, kPi),
          Div::by(base.y * cosl * coss / area_pdf / d2, kPi),
          Div::by(base.z * cosl * coss / area_pdf / d2, kPi)};
  const float c_sum = cd.c.x + cd.c.y + cd.c.z;
  // zero-contribution samples need no occlusion trace
  cd.w = c_sum > 0.0f ? c_sum : 0.0f;
  return cd;
}

// The weighted reservoir over the S candidates (render/shade.py "ris"):
// running sums left to right, the first cum > u * W wins, u drawn from
// tea(pix, ris_salt). The pick's contribution carries W / w_pick. A zero
// candidate (w = 0) where W is 0: nothing to trace.
template <class Div>
__device__ Candidate ris_pick(const Lights& lt, int s, uint32_t pix, uint32_t salt,
                              uint32_t ris_salt, V3 point, V3 normal, V3 tp,
                              V3 albedo) {
  Candidate pick = {};
  float w_tot = 0.0f;
  for (int j = 0; j < s; ++j) {
    w_tot = w_tot +
        light_candidate<Div>(lt, s, pix, j, salt, point, normal, tp, albedo).w;
  }
  if (w_tot > 0.0f) {
    uint32_t useed = tea(pix, ris_salt);
    const float thresh = rnd(useed) * w_tot;
    float cum = 0.0f;
    for (int j = 0; j < s; ++j) {
      const Candidate cd =
          light_candidate<Div>(lt, s, pix, j, salt, point, normal, tp, albedo);
      cum = cum + cd.w;
      if (j == 0 || cum > thresh) pick = cd;
      if (cum > thresh) break;
    }
    pick.c = pick.c * (w_tot / fmaxf(pick.w, 1e-30f));
  }
  return pick;
}

// render/shade.py rr: survival p = clip(max channel, RR_FLOOR, 1) against
// the draw u; a survivor's throughput divides by p. Returns survival.
__device__ __forceinline__ bool roulette(V3& tp, float u_rr) {
  const float p = fminf(fmaxf(fmaxf(fmaxf(tp.x, tp.y), tp.z), kRrFloor), 1.0f);
  if (u_rr < p) {
    tp = tp / p;
    return true;
  }
  return false;
}

}  // namespace shading
