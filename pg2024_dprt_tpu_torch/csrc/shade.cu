// Wavefront shading kernel (K14 shade_paths) for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes).
//
// K14 is render/shade.py `shade` on CUDA tensors, in ONE launch: where the
// eager version issues about 700 small ops over every row of the buffer
// (each a launch, a pass over device memory and host work), a thread here
// shades one row of the path buffer:
//
//   * a live path (valid, not a shadow path) that missed: throughput *
//     env(direction), added atomically to the (npix, 3) environment image;
//   * a live hit: the attributes (shade.cuh triangle_surface: one tri_shade
//     row, smooth normal, textured albedo; an instanced hit's base row, its
//     normal through the instance's world-to-object map transposed; a curve
//     winner, tri_index <= -2, its round-cone normal and the strand colour,
//     diffuse), the flip toward wo, the BSDF sample with tea(pixel, salt),
//     the next path (throughput * weight * |cos| * albedo, Russian roulette
//     with the RR-salt draw where `rr`), and the NEE light candidates with
//     tea(pixel * S + j, salt): in "ris" mode the pick by running sums with
//     the RIS-salt draw, one shadow row a path; in "sum" mode S rows a path
//     (row i * S + j), as `shade` lays them out;
//   * a row that is not a live hit writes only what downstream reads: not
//     valid, not delta, throughput 0, its own origin and direction (finite),
//     the constant shadow_path_id, is_shadow and tmax (F32_MAX for the next
//     path, 0 for a shadow row that is not valid).
// The salts, S, the mode, `rr` and the light count are kernel arguments:
// no value goes to the card between launches.
//
// Same work, same precision as the eager version: float32 throughout, the
// same draws, the same zero-contribution skip, the same estimator. The
// arithmetic is shade.cuh's, which K3 shares, in the eager order of float
// operations, with PyTorch's CUDA rounding of a division by a host scalar
// (TimesReciprocal). So K14 equals the eager shade on the card except where
// its transcendental functions or the instanced normal's matrix product
// (a cuBLAS call in the eager version) round differently, and where the
// environment image's atomic adds meet in another order.
//
// Not a port of a TPU kernel: the JAX package shades with XLA-fused jnp
// code. The kernel exists because on this card the eager version's host
// issue time, not its device time, set the pace of the partitioned frame.
// What bounds it: bytes. Every row reads its flags, pixel id, origin and
// direction (34 B) and writes its next path and its shadow rows (102 B in
// "ris" mode, 51 + 59 S in "sum" mode); a live hit reads about 85 B more
// (its throughput, its hit, one tri_shade row). Rows are independent, so
// one thread a row.
//
// Built with --fmad=false, like the trace kernels.

#include "shade.cuh"

namespace {

using namespace shading;
using Div = TimesReciprocal;

constexpr int kThreads = 256;
constexpr float kF32Max = 3.402823466e38f;

struct ShadeArgs {
  int n, npix;
  // paths (N rows): origin, direction, throughput (N, 3); pixel (N,) int64;
  // valid / shadow flags (N,) bool
  const float* __restrict__ origin;
  const float* __restrict__ direction;
  const float* __restrict__ throughput;
  const int64_t* __restrict__ pixel;
  const uint8_t* __restrict__ valid;
  const uint8_t* __restrict__ shadow;
  // hits (N rows)
  const float* __restrict__ t;
  const int32_t* __restrict__ tri;
  const float* __restrict__ u;
  const float* __restrict__ v;
  const uint8_t* __restrict__ is_hit;
  // scene: tri_shade (T, 24); instances (I, 16) or null; curves or null
  const float* __restrict__ tri_shade;
  int num_base_tris;
  const float* __restrict__ xf;
  const float* __restrict__ cp0;
  const float* __restrict__ cp1;
  const float* __restrict__ cr0;
  const float* __restrict__ cr1;
  const float* __restrict__ ccolor;
  Textures tex;
  Lights lights;
  EnvMap env;
  uint32_t salt, ris_salt, rr_salt;
  int s, ris, rr;  // ris: the "ris" mode with S > 1 (the wrapper decides)
  // next paths (N rows); pixel_index is the input's
  float* __restrict__ n_origin;
  float* __restrict__ n_direction;
  float* __restrict__ n_tmax;
  float* __restrict__ n_throughput;
  int64_t* __restrict__ n_spid;
  uint8_t* __restrict__ n_shadow;
  uint8_t* __restrict__ n_delta;
  uint8_t* __restrict__ n_valid;
  // shadow paths (N rows "ris", N * S "sum"); s_pixel null in "ris" mode
  float* __restrict__ s_origin;
  float* __restrict__ s_direction;
  float* __restrict__ s_tmax;
  float* __restrict__ s_throughput;
  int64_t* __restrict__ s_pixel;
  int64_t* __restrict__ s_spid;
  uint8_t* __restrict__ s_shadow;
  uint8_t* __restrict__ s_delta;
  uint8_t* __restrict__ s_valid;
  float* __restrict__ env_out;  // (npix, 3), zeroed by the wrapper
};

// render/shade.py surface_attributes for the hit of row i at `point`: the
// shading normal (normalized, not yet flipped), albedo and BSDF
__device__ Surface hit_surface(const ShadeArgs& a, int i, V3 point) {
  const int32_t tri = a.tri[i];
  if (a.cp0 != nullptr && tri <= -2) {
    // curve winner: tri_index = -2 - piece. The round-cone normal at the
    // hit point (the axial coordinate y = (point - pa) . ba), diffuse in
    // the strand colour
    const int piece = -2 - tri;
    const V3 pa = ld3(a.cp0 + 3 * piece), pb = ld3(a.cp1 + 3 * piece);
    const V3 ba = pb - pa;
    const V3 oa = point - pa;
    const float y = dot(oa, ba);
    const float rr = a.cr0[piece] - a.cr1[piece];
    const float d2 = dot(ba, ba) - rr * rr;
    const V3 n_curve = y <= 0.0f ? oa : (y >= d2 ? point - pb : oa * d2 - ba * y);
    Surface sf;
    sf.normal = normalize(n_curve);
    sf.albedo = ld3(a.ccolor);
    sf.is_water = false;
    return sf;
  }
  int base = tri < 0 ? 0 : tri;
  const float* lin = nullptr;
  if (a.xf != nullptr) {
    // virtual id instance * num_base_tris + base id
    const int inst = base / a.num_base_tris;
    base = base - inst * a.num_base_tris;
    lin = a.xf + 16 * static_cast<size_t>(inst);  // world_to_obj, row-major
  }
  Surface sf = triangle_surface(a.tri_shade, a.tex, base, a.u[i], a.v[i]);
  if (lin != nullptr) {
    // object -> world normal: n_w ~ (M^-1)^T n_o = lin^T n_o
    const V3 n = sf.normal;
    sf.normal = {lin[0] * n.x + lin[3] * n.y + lin[6] * n.z,
                 lin[1] * n.x + lin[4] * n.y + lin[7] * n.z,
                 lin[2] * n.x + lin[5] * n.y + lin[8] * n.z};
  }
  sf.normal = normalize(sf.normal);
  return sf;
}

__device__ __forceinline__ void write_shadow(const ShadeArgs& a, size_t row, V3 o,
                                             V3 d, float tmax, V3 c, bool valid) {
  st3(a.s_origin + 3 * row, o);
  st3(a.s_direction + 3 * row, d);
  a.s_tmax[row] = tmax;
  st3(a.s_throughput + 3 * row, c);
  a.s_shadow[row] = 1;
  a.s_delta[row] = 0;
  a.s_valid[row] = valid;
}

__global__ void __launch_bounds__(kThreads) shade_paths_kernel(ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int64_t pixel = a.pixel[i];
  const uint32_t pix = static_cast<uint32_t>(pixel);
  const bool live = a.valid[i] && !a.shadow[i];
  const bool hit = live && a.is_hit[i];
  const V3 o = ld3(a.origin + 3 * i), d = ld3(a.direction + 3 * i);
  const V3 zero = {0.0f, 0.0f, 0.0f};

  V3 tp = zero;
  if (live) tp = ld3(a.throughput + 3 * i);
  if (live && !hit && pixel >= 0 && pixel < a.npix) {
    // environment on a miss
    const V3 c = tp * env_sample<Div>(a.env, d);
    float* e = a.env_out + 3 * pixel;
    atomicAdd(e, c.x);
    atomicAdd(e + 1, c.y);
    atomicAdd(e + 2, c.z);
  }

  // next path, and the shading point the shadow rows start from
  V3 point = o, n_dir = d, n_tp = zero;
  bool n_live = false, delta = false;
  V3 normal = zero, albedo = zero;
  if (hit) {
    point = o + d * a.t[i];
    const Surface sf = hit_surface(a, i, point);
    normal = sf.normal;
    albedo = sf.albedo;
    delta = sf.is_water;
    const V3 wo_world = neg(d);
    const bool is_inside = dot(normal, wo_world) < 0.0f;
    if (is_inside) normal = neg(normal);

    uint32_t seed = tea(pix, a.salt);
    const float xi1 = rnd(seed), xi2 = rnd(seed);
    const BsdfSample bs = bsdf_sample(normal, wo_world, is_inside, delta, xi1, xi2);
    n_dir = bs.wi_world;
    n_tp = tp * (bs.weight * bs.cos_theta) * albedo;
    n_live = true;
    if (a.rr) {
      uint32_t rseed = tea(pix, a.rr_salt);
      n_live = roulette(n_tp, rnd(rseed));
    }
    if (!n_live) n_tp = zero;
  }
  st3(a.n_origin + 3 * static_cast<size_t>(i), point);
  st3(a.n_direction + 3 * static_cast<size_t>(i), n_dir);
  a.n_tmax[i] = kF32Max;
  st3(a.n_throughput + 3 * static_cast<size_t>(i), n_tp);
  a.n_spid[i] = -1;
  a.n_shadow[i] = 0;
  a.n_delta[i] = delta && n_live;
  a.n_valid[i] = n_live;

  // NEE shadow rows (delta surfaces cast none)
  const bool nee = hit && !delta;
  if (a.ris) {
    Candidate pick = {};
    if (nee) {
      pick = ris_pick<Div>(a.lights, a.s, pix, a.salt, a.ris_salt, point, normal,
                           tp, albedo);
    }
    const bool valid = pick.w > 0.0f;
    write_shadow(a, i, point, valid ? pick.wi : d, valid ? pick.dist : 0.0f,
                 valid ? pick.c : zero, valid);
    a.s_spid[i] = 0;
    return;
  }
  for (int j = 0; j < a.s; ++j) {
    const size_t row = static_cast<size_t>(i) * a.s + j;
    Candidate cd = {};
    if (nee) {
      cd = light_candidate<Div>(a.lights, a.s, pix, j, a.salt, point, normal, tp,
                                albedo);
    }
    const bool valid = cd.w > 0.0f;
    write_shadow(a, row, point, valid ? cd.wi : d, valid ? cd.dist : 0.0f,
                 valid ? cd.c : zero, valid);
    a.s_pixel[row] = pixel;
    a.s_spid[row] = j;
  }
}

}  // namespace

// C entry point: launches on the caller's stream and returns
// cudaGetLastError() (0 = launched). Pointers are device pointers; the
// instance, curve and texture pointers may be null (none in the scene), as
// may s_pixel in "ris" mode.
extern "C" int shade_paths(
    int n, int npix, const float* origin, const float* direction,
    const float* throughput, const int64_t* pixel, const uint8_t* valid,
    const uint8_t* shadow, const float* t, const int32_t* tri, const float* u,
    const float* v, const uint8_t* is_hit, const float* tri_shade,
    int num_base_tris, const float* xf, const float* cp0, const float* cp1,
    const float* cr0, const float* cr1, const float* ccolor,
    const float* texels, const int32_t* tex_offset, const int32_t* tex_height,
    const int32_t* tex_width, int n_tex, const float* lp0, const float* lp1,
    const float* lp2, const float* lrad, int l_count, const float* env, int eh,
    int ew, float env_rot, uint32_t salt, uint32_t ris_salt, uint32_t rr_salt,
    int s, int ris, int rr, float* n_origin, float* n_direction, float* n_tmax,
    float* n_throughput, int64_t* n_spid, uint8_t* n_shadow, uint8_t* n_delta,
    uint8_t* n_valid, float* s_origin, float* s_direction, float* s_tmax,
    float* s_throughput, int64_t* s_pixel, int64_t* s_spid, uint8_t* s_shadow,
    uint8_t* s_delta, uint8_t* s_valid, float* env_out, void* stream) {
  if (n > 0) {
    ShadeArgs a;
    a.n = n; a.npix = npix;
    a.origin = origin; a.direction = direction; a.throughput = throughput;
    a.pixel = pixel; a.valid = valid; a.shadow = shadow;
    a.t = t; a.tri = tri; a.u = u; a.v = v; a.is_hit = is_hit;
    a.tri_shade = tri_shade; a.num_base_tris = num_base_tris; a.xf = xf;
    a.cp0 = cp0; a.cp1 = cp1; a.cr0 = cr0; a.cr1 = cr1; a.ccolor = ccolor;
    a.tex = Textures{texels, tex_offset, tex_height, tex_width, n_tex};
    a.lights = Lights{lp0, lp1, lp2, lrad, l_count};
    a.env = EnvMap{env, eh, ew, env_rot};
    a.salt = salt; a.ris_salt = ris_salt; a.rr_salt = rr_salt;
    a.s = s; a.ris = ris; a.rr = rr;
    a.n_origin = n_origin; a.n_direction = n_direction; a.n_tmax = n_tmax;
    a.n_throughput = n_throughput; a.n_spid = n_spid; a.n_shadow = n_shadow;
    a.n_delta = n_delta; a.n_valid = n_valid;
    a.s_origin = s_origin; a.s_direction = s_direction; a.s_tmax = s_tmax;
    a.s_throughput = s_throughput; a.s_pixel = s_pixel; a.s_spid = s_spid;
    a.s_shadow = s_shadow; a.s_delta = s_delta; a.s_valid = s_valid;
    a.env_out = env_out;
    shade_paths_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
