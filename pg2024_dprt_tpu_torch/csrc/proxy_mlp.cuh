// Device functions of the neural-proxy nets' forward pass, shared by the MLP
// kernels (proxy_mlp.cu: K5 mlp_pair, K6 mlp_dense) and the fused route
// kernel (route.cu: K7 route), so that the fused and the composed routing
// stage run the nets with identical arithmetic.
//
// The net (models/mlp.py net_forward, single-output family): two encoders,
// origin (in_features - 2) -> w/8 -> w/2 and direction 2 -> w/8 -> w/2,
// LeakyReLU after each Linear, concatenated to out1 (width w); `depth`
// residual blocks h = leaky(h + h W + b); the global skip out1 + h; the head
// w -> head_hidden (LeakyReLU) -> out_features; the final activation.
//
// The multi-geo net (models/mlp.py net_forward, multi_geo=True; JAX
// models/mlp.py:164-181): ONE net shared by every object, whose sixth input
// is the object id / INSTANCE_DIVISOR. Encoders, features (in_features - 1)
// -> w/8 -> w/2 and id 1 -> w/8 -> w/2 (LeakyReLU), concatenated to out1;
// pre h = leaky(out1 W + b); the residual lead h = leaky(h W + b); `depth`
// residual blocks; the trail h W + b without activation; the global skip
// out1 + trail; the head w -> w/2 -> head_hidden (LeakyReLU after each) ->
// out_features; the final activation.
//
// Arithmetic contract: every Linear runs on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulation), in the tensor
// core's order within a k-step of 16 inputs and in ascending k-steps from a
// zero accumulator; the bias is added in f32 afterwards; the features are
// rounded to bf16 on entry and every layer's output is rounded to bf16
// where a Linear reads it, while the residual state h and out1 stay f32
// (out1 is computed again, with the same bits, where it is added). A
// row's prediction depends only on its own features and its object's
// weights, not on the rows that share its chunk, the chunk's size or the
// kernel: K5, K6 and K7 agree bit for bit.
//
// Weights in fragment order (ops/mlp.py pack_nets): each Linear (in,
// out) zero-padded to K = round16(in) rows and N = round16(out) columns and
// stored as [pair p of 16 columns][k-step s][lane][8 bf16], so that a lane's
// B fragments of two n-tiles (8 columns each) over one k-step are one 16-byte
// load: lane = 4 g + t holds W[16 s + 2 t + e][16 p + 8 h + g] at
// 4 h + e (rows k = 2 t, 2 t + 1) and 4 h + 2 + e (rows 2 t + 8, 2 t + 9).
// Zero rows and columns add exact zeros, so odd widths (24, head_hidden 20,
// 3-8 inputs) take the same code path as the production ones.
//
// A chunk of at most `rows` (16 to 64, a multiple of 16) query rows runs both
// nets (vis, depth) of ONE object. Each Linear's output columns are cut into
// groups of one or two pairs (two where the Linear has at least 16 pairs),
// group g on warp (g + first warp) mod 8: the warp keeps kStages k-steps of
// its weight fragments in flight from global memory (all objects' nets stay
// in L2), reads the activations' A fragments with ldmatrix from shared
// memory, and issues one mma per m16 tile and n-tile, so one fetch of a
// weight meets every row of the chunk. Shared memory of a chunk (bytes,
// smem_bytes): two bf16 activation planes (rows, ldx) that layers read and
// write in turn, rows padded by 16 bytes so that ldmatrix's eight row
// addresses fall on distinct banks; the bf16 features (rows, 40) with the
// origin / feature inputs at columns 0.. and the direction / id inputs at
// 16..; the f32 plane h (rows, w + 8); the f32 predictions. The unrounded
// encoder output out1 is not kept: the encoders run again where the global
// skip adds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// counters of a -DPG_CYCLES build (the probe's nets part): 16 k-loop
// cycles, 17 epilogue cycles, 18 output groups, 19 k-steps x m16 tiles (per
// warp's lane 0); 20 chunk cycles, 21 chunks (per block)
#include "cycles.cuh"

namespace mlp {

constexpr int kRows = 16;          // rows of an m16 tile (ops/mlp.py KERNEL_ROWS)
constexpr int kThreads = 256;      // threads of a block that runs the nets
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeatures = 8;    // inputs a net may take
constexpr int kFeatCols = 32;      // feature plane: inputs at 0.., direction / id at 16..
constexpr int kSplitCol = 16;
constexpr int kPad = 8;            // bf16 pad of an activation row (16 bytes)
constexpr int kStages = 4;         // k-steps of weight fragments in flight per warp
constexpr float kLeakySlope = 0.01f;

enum Activation { kNone = 0, kLeaky = 1, kSigmoid = 2 };

// Architecture of a net (models/mlp.py MLPConfig): the single-output
// family, or the multi-geo net when multi_geo is 1.
struct Dims {
  int width;
  int depth;
  int in_features;
  int head_hidden;
  int out_features;
  int multi_geo;
};

// The nets of all objects: weights bf16 in fragment order (8 to a uint4)
// and biases f32, per object the Linears in param_shapes order.
struct Nets {
  const uint4* __restrict__ w;  // (O, weights_per_net / 8)
  const float* __restrict__ b;  // (O, biases_per_net)
  int final_act;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// bf16 elements of one Linear in fragment order.
__host__ __device__ inline int frag_size(int fan_in, int fan_out) {
  return round16(fan_in) * round16(fan_out);
}

__host__ __device__ inline int weights_per_net(const Dims& d) {
  const int eh = d.width / 8, eo = d.width / 2, w = d.width, hh = d.head_hidden;
  if (d.multi_geo) {
    return frag_size(d.in_features - 1, eh) + frag_size(eh, eo) + frag_size(1, eh) +
           frag_size(eh, eo) + (d.depth + 3) * frag_size(w, w) + frag_size(w, eo) +
           frag_size(eo, hh) + frag_size(hh, d.out_features);
  }
  return frag_size(d.in_features - 2, eh) + frag_size(eh, eo) + frag_size(2, eh) +
         frag_size(eh, eo) + d.depth * frag_size(w, w) + frag_size(w, hh) +
         frag_size(hh, d.out_features);
}

__host__ __device__ inline int biases_per_net(const Dims& d) {
  const int eh = d.width / 8, eo = d.width / 2;
  if (d.multi_geo) {
    return 2 * eh + 2 * eo + (d.depth + 3) * d.width + eo + d.head_hidden +
           d.out_features;
  }
  return 2 * eh + 2 * eo + d.depth * d.width + d.head_hidden + d.out_features;
}

// Row strides: activation planes (bf16; the widest Linear input, the
// encoders' two hidden blocks at 0 and round16(w / 8) included), feature
// plane (bf16), h plane (f32).
__host__ __device__ inline int ld_act(const Dims& d) {
  const int a = round16(d.width), e = 2 * round16(d.width / 8);
  return (a > e ? a : e) + kPad;
}
constexpr int kLdFeat = kFeatCols + kPad;
__host__ __device__ inline int ld_f32(const Dims& d) { return d.width + kPad; }

// Bytes of dynamic shared memory the forward needs for chunks of `rows`.
__host__ __device__ inline size_t smem_bytes(const Dims& d, int rows) {
  return (size_t)rows * (2 * ld_act(d) + kLdFeat) * 2 + (size_t)rows * ld_f32(d) * 4 +
         (size_t)rows * 2 * d.out_features * 4;
}

// What a kernel takes: a width divisible by 8 (encoder widths w/8, w/2) and
// at least 16, 3 to kMaxFeatures inputs, a head no wider than the net.
__host__ __device__ inline bool dims_ok(const Dims& d) {
  return d.width >= 16 && d.width % 8 == 0 && d.depth >= 0 &&
         d.in_features >= 3 && d.in_features <= kMaxFeatures &&
         d.head_hidden >= 1 && d.head_hidden <= d.width && d.out_features >= 1;
}

struct Smem {
  __nv_bfloat16* x0;    // (rows, ldx) activations
  __nv_bfloat16* x1;    // (rows, ldx)
  __nv_bfloat16* feat;  // (rows, kLdFeat) rounded features
  float* h;             // (rows, ldf) unrounded residual state (or out1)
  float* res;           // (2, out_features, rows) vis then depth predictions
  int rows, ldx, ldf;
};

__device__ __forceinline__ Smem carve(void* base, const Dims& d, int rows) {
  Smem s;
  s.rows = rows;
  s.ldx = ld_act(d);
  s.ldf = ld_f32(d);
  s.x0 = static_cast<__nv_bfloat16*>(base);
  s.x1 = s.x0 + (size_t)rows * s.ldx;
  s.feat = s.x1 + (size_t)rows * s.ldx;
  s.h = reinterpret_cast<float*>(s.feat + (size_t)rows * kLdFeat);
  s.res = s.h + (size_t)rows * s.ldf;
  return s;
}

__device__ __forceinline__ __nv_bfloat16 bf16(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : kLeakySlope * v;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kLeaky) return leaky(v);
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-v));
  return v;
}

// A fragment of one m16 tile over one k-step: lane l gives the address of
// row l % 16, columns (l / 16) * 8 ..
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a Linear's epilogue does with v = (sum) + bias of row r, output c.
enum Emit {
  kEmitLeaky,     // x = bf16(leaky(v))
  kEmitSet,       // a = leaky(v); h = a; x = bf16(a)
  kEmitRes,       // a = leaky(h + v); h = a; x = bf16(a)
  kEmitKeep,      // h = leaky(v)
  kEmitAddLeaky,  // x = bf16(h + leaky(v))
  kEmitAdd,       // x = bf16(h + v)
  kEmitHead       // res[c][r] = activate(v, act)
};

// Where a Linear's outputs go: the bf16 plane x (row stride ldx) and the f32
// plane h (ldf), each already offset to the Linear's first column, or the
// predictions res (rows a channel).
struct Out {
  int emit;
  __nv_bfloat16* x;
  float* h;
  float* res;
  int ldx, ldf, rows, act;
};

// Columns c and c + 1 (c even) of row r: v0 and v1 (v1 only where c + 1 <
// n, `two`).
template <int kEmit>
__device__ __forceinline__ void emit(const Out& o, int r, int c, float v0, float v1,
                                     bool two) {
  if (kEmit == kEmitHead) {
    o.res[c * o.rows + r] = activate(v0, o.act);
    if (two) o.res[(c + 1) * o.rows + r] = activate(v1, o.act);
    return;
  }
  float* h = o.h + r * o.ldf + c;
  float2 hv = make_float2(0.0f, 0.0f);
  if (kEmit == kEmitRes || kEmit == kEmitAddLeaky || kEmit == kEmitAdd) {
    if (two) {
      hv = *reinterpret_cast<const float2*>(h);
    } else {
      hv.x = h[0];
    }
  }
  float a0 = v0, a1 = v1;
  if (kEmit == kEmitAddLeaky) {
    a0 = hv.x + leaky(a0);
    a1 = hv.y + leaky(a1);
  } else if (kEmit == kEmitAdd) {
    a0 = hv.x + a0;
    a1 = hv.y + a1;
  } else {
    if (kEmit == kEmitRes) {
      a0 = hv.x + a0;
      a1 = hv.y + a1;
    }
    a0 = leaky(a0);
    a1 = leaky(a1);
  }
  if (kEmit == kEmitSet || kEmit == kEmitRes || kEmit == kEmitKeep) {
    if (two) {
      *reinterpret_cast<float2*>(h) = make_float2(a0, a1);
    } else {
      h[0] = a0;
    }
  }
  if (kEmit == kEmitKeep) return;
  __nv_bfloat16* x = o.x + r * o.ldx + c;
  if (two) {
    *reinterpret_cast<__nv_bfloat162*>(x) = __floats2bfloat162_rn(a0, a1);
  } else {
    x[0] = bf16(a0);
  }
}

// The epilogue of a group: acc[m][j][i] + bias is row 16 m + r0 (+ 8 for
// i >= 2), column c0 + 8 j (+ 1 for odd i); n-tiles j < nj are the group's.
template <int kEmit, int MT>
__device__ __forceinline__ void epilogue(const Out& o, const float (&acc)[MT][4][4],
                                         const float (&bv)[4][2], int r0, int c0, int nj,
                                         int n, int mt_used) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= mt_used) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 8 * j;
      if (j >= nj || c >= n) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        emit<kEmit>(o, 16 * m + r0 + 8 * hf, c, acc[m][j][2 * hf] + bv[j][0],
                    acc[m][j][2 * hf + 1] + bv[j][1], c + 1 < n);
      }
    }
  }
}

// Pairs of 16 columns a group of a Linear with `np` pairs takes.
__device__ __forceinline__ int group_pairs(int np) { return np >= 2 * kWarps ? 2 : 1; }

// Groups of a Linear with `n` outputs (the first warp of a Linear that runs
// beside it).
__device__ __forceinline__ int groups(int n) {
  const int np = round16(n) / 16, gp = group_pairs(np);
  return (np + gp - 1) / gp;
}

// One Linear over the first mt_used m16 tiles of the chunk, on the tensor
// cores: v = sum_k in[r][k] W[k][c] + bias[c] for every row r and output
// c < n, handed to the epilogue of o.emit. `in` points at the input's first
// column (row stride ld), `w` at the Linear's fragments. Group g of output
// columns runs on warp (g + first_warp) mod kWarps, so two Linears that
// write disjoint columns can run side by side. Reads `in`, writes only
// through `o`; the caller places the barriers.
template <int MT>
__device__ __noinline__ void linear(const __nv_bfloat16* in, int ld, int k,
                                    const uint4* __restrict__ w,
                                    const float* __restrict__ bias, int n, int first_warp,
                                    int mt_used, const Out o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nks = round16(k) / 16, np = round16(n) / 16;
  const int gp = group_pairs(np), ng = (np + gp - 1) / gp;
  const __nv_bfloat16* arow = in + (lane & 15) * ld + (lane >> 4) * 8;
  for (int g = (warp - first_warp % kWarps + kWarps) % kWarps; g < ng; g += kWarps) {
    CYCLES_NOW(c_mma);
    const int p0 = g * gp;
    const bool two = gp == 2 && p0 + 1 < np;
    const uint4* w0 = w + (size_t)p0 * nks * 32 + lane;
    const uint4* w1 = w0 + (size_t)nks * 32;
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
    uint4 ring[kStages][2];
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      ring[st][0] = st < nks ? __ldg(w0 + st * 32) : make_uint4(0, 0, 0, 0);
      ring[st][1] = two && st < nks ? __ldg(w1 + st * 32) : make_uint4(0, 0, 0, 0);
    }
    // the group's biases, loaded while the products run
    const int r0 = lane >> 2, c0 = 16 * p0 + 2 * (lane & 3), nj = two ? 4 : 2;
    float bv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        bv[j][e] = c < n ? __ldg(bias + c) : 0.0f;
      }
    for (int ks0 = 0; ks0 < nks; ks0 += kStages) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) {
        const int ks = ks0 + st;
        if (ks < nks) {
          const uint4 b0 = ring[st][0], b1 = ring[st][1];
          if (ks + kStages < nks) {
            ring[st][0] = __ldg(w0 + (ks + kStages) * 32);
            if (two) ring[st][1] = __ldg(w1 + (ks + kStages) * 32);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mt_used) {
              uint32_t a[4];
              ldmatrix_x4(a, arow + m * 16 * ld + ks * 16);
              mma(acc[m][0], a, b0.x, b0.y);
              mma(acc[m][1], a, b0.z, b0.w);
              if (two) {
                mma(acc[m][2], a, b1.x, b1.y);
                mma(acc[m][3], a, b1.z, b1.w);
              }
            }
          }
        }
      }
    }
    if (lane == 0) {
      CYCLES_ADD(16, c_mma);
      CYCLES_COUNT(18, 1);
      CYCLES_COUNT(19, nks * mt_used);
    }
    CYCLES_NOW(c_epi);
    switch (o.emit) {
      case kEmitLeaky:
        epilogue<kEmitLeaky, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
        break;
      case kEmitSet:
        epilogue<kEmitSet, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
        break;
      case kEmitRes:
        epilogue<kEmitRes, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
        break;
      case kEmitKeep:
        epilogue<kEmitKeep, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
        break;
      case kEmitAddLeaky:
        epilogue<kEmitAddLeaky, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
        break;
      case kEmitAdd:
        epilogue<kEmitAdd, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
        break;
      default:
        epilogue<kEmitHead, MT>(o, acc, bv, r0, c0, nj, n, mt_used);
    }
    if (lane == 0) CYCLES_ADD(17, c_epi);
  }
}

// Walks a net's Linears in param_shapes order.
struct Cursor {
  const uint4* w;
  const float* b;
  __device__ __forceinline__ void take(int fan_in, int fan_out, const uint4*& wl,
                                       const float*& bl) {
    wl = w;
    bl = b;
    w += frag_size(fan_in, fan_out) / 8;
    b += fan_out;
  }
};

// The encoders of a net: features (origin, or the multi-geo features) at
// column 0 and direction (or the id) at kSplitCol of s.feat -> first
// Linears -> `hid` columns [0, eh) and [eh16, ..) -> second Linears, handed
// to `emit` at `out` columns [0, eo) and [eo, w). Ends with a barrier.
template <int MT, bool kMultiGeo>
__device__ __forceinline__ void encoders(const Dims& d, Cursor cur, const Smem& s,
                                         int mt_used, __nv_bfloat16* hid,
                                         __nv_bfloat16* out, int emit) {
  const int eh = d.width / 8, eo = d.width / 2, eh16 = round16(eh);
  const int na = kMultiGeo ? d.in_features - 1 : d.in_features - 2;
  const int nb = kMultiGeo ? 1 : 2;
  const uint4 *wa0, *wa1, *wb0, *wb1;
  const float *ba0, *ba1, *bb0, *bb1;
  cur.take(na, eh, wa0, ba0);
  cur.take(eh, eo, wa1, ba1);
  cur.take(nb, eh, wb0, bb0);
  cur.take(eh, eo, wb1, bb1);
  const Out to_hid{kEmitLeaky, hid, nullptr, nullptr, s.ldx, s.ldf, s.rows, 0};
  Out to_hid_b = to_hid;
  to_hid_b.x += eh16;
  linear<MT>(s.feat, kLdFeat, na, wa0, ba0, eh, 0, mt_used, to_hid);
  linear<MT>(s.feat + kSplitCol, kLdFeat, nb, wb0, bb0, eh, groups(eh), mt_used, to_hid_b);
  __syncthreads();
  const Out to_out{emit, out, s.h, nullptr, s.ldx, s.ldf, s.rows, 0};
  Out to_out_b = to_out;
  to_out_b.x += eo;
  to_out_b.h += eo;
  linear<MT>(hid, s.ldx, eh, wa1, ba1, eo, 0, mt_used, to_out);
  linear<MT>(hid + eh16, s.ldx, eh, wb1, bb1, eo, groups(eo), mt_used, to_out_b);
  __syncthreads();
}

// One net of one object over the first mt_used m16 tiles of the chunk whose
// rounded features are in s.feat (the single-output family, or the
// multi-geo net with kMultiGeo). Writes the predictions to
// res[channel * s.rows + row]. All threads of the block call it; it ends
// with a barrier. out1 is not kept: the encoders run again where the global
// skip needs it (about 3 % of the net's multiply-adds at the production
// widths), which leaves one f32 plane, h, in shared memory.
template <int MT, bool kMultiGeo>
__device__ __noinline__ void forward(const Dims d, Cursor cur, int final_act, const Smem s,
                                     int mt_used, float* res) {
  const int eh = d.width / 8, eo = d.width / 2, wd = d.width;
  const Cursor enc = cur;
  const uint4* wl;
  const float* bl;
  cur.take(kMultiGeo ? d.in_features - 1 : d.in_features - 2, eh, wl, bl);
  cur.take(eh, eo, wl, bl);
  cur.take(kMultiGeo ? 1 : 2, eh, wl, bl);
  cur.take(eh, eo, wl, bl);
  __nv_bfloat16* x = s.x0;
  __nv_bfloat16* y = s.x1;
  auto swap = [&]() {
    __nv_bfloat16* t = x;
    x = y;
    y = t;
  };
  // a Linear from x to y, then the barrier and the swap
  auto step = [&](int fan_in, int fan_out, int emit) {
    cur.take(fan_in, fan_out, wl, bl);
    linear<MT>(x, s.ldx, fan_in, wl, bl, fan_out, 0, mt_used,
               Out{emit, y, s.h, nullptr, s.ldx, s.ldf, s.rows, final_act});
    __syncthreads();
    swap();
  };
  // out1 (the single-output family: also h) -> x
  encoders<MT, kMultiGeo>(d, enc, s, mt_used, y, x, kMultiGeo ? kEmitLeaky : kEmitSet);
  if (kMultiGeo) {
    step(wd, wd, kEmitSet);  // pre block: h = leaky(out1 W + b)
    step(wd, wd, kEmitSet);  // residual lead: h = leaky(h W + b)
  }
  for (int i = 0; i < d.depth; ++i) step(wd, wd, kEmitRes);  // h = leaky(h + h W + b)
  if (kMultiGeo) {
    // out1 again, into h; the trail, no activation, plus the global skip:
    // out1 + (h W + b)
    encoders<MT, kMultiGeo>(d, enc, s, mt_used, y, y, kEmitKeep);
    step(wd, wd, kEmitAdd);
    step(wd, eo, kEmitLeaky);  // head: w -> w/2
    step(eo, d.head_hidden, kEmitLeaky);
  } else {
    // the global skip: out1 (again) + h -> x
    encoders<MT, kMultiGeo>(d, enc, s, mt_used, y, x, kEmitAddLeaky);
    step(wd, d.head_hidden, kEmitLeaky);
  }
  // the last Linear: head_hidden -> out_features
  cur.take(d.head_hidden, d.out_features, wl, bl);
  linear<MT>(x, s.ldx, d.head_hidden, wl, bl, d.out_features, 0, mt_used,
             Out{kEmitHead, y, s.h, res, s.ldx, s.ldf, s.rows, final_act});
  __syncthreads();
}

// Both nets of object `obj` over a chunk of `count` (1 .. rows) rows, with
// chunks of `rows` (a multiple of 16, at most 16 MT) carved from `smem`:
// load(r, f) gives feature f of the chunk's row r, store(r, vis, depth)
// takes channel 0 of each net's prediction. All threads of the block call it
// with the same arguments; it ends with a barrier.
template <int MT, bool kMultiGeo, typename Load, typename Store>
__device__ __forceinline__ void pair_chunk(const Dims& d, const Nets& vis,
                                           const Nets& depth, int obj, int count, int rows,
                                           void* smem, Load load, Store store) {
  CYCLES_NOW(c_chunk);
  const Smem s = carve(smem, d, rows);
  // the bf16 planes start at zero: the weights' zero padding then meets
  // finite values, whatever the memory held before
  uint4* planes = reinterpret_cast<uint4*>(s.x0);
  const int n16 = rows * (2 * s.ldx + kLdFeat) * 2 / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) planes[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int split = kMultiGeo ? d.in_features - 1 : d.in_features - 2;
  for (int idx = threadIdx.x; idx < d.in_features * count; idx += blockDim.x) {
    const int f = idx / count, r = idx - f * count;
    s.feat[r * kLdFeat + (f < split ? f : kSplitCol + f - split)] = bf16(load(r, f));
  }
  __syncthreads();
  const int mt_used = (count + 15) / 16;
  const size_t wo = (size_t)obj * (weights_per_net(d) / 8);
  const size_t bo = (size_t)obj * biases_per_net(d);
  float* res_v = s.res;
  float* res_d = s.res + d.out_features * rows;
  forward<MT, kMultiGeo>(d, Cursor{vis.w + wo, vis.b + bo}, vis.final_act, s, mt_used, res_v);
  forward<MT, kMultiGeo>(d, Cursor{depth.w + wo, depth.b + bo}, depth.final_act, s, mt_used,
                         res_d);
  for (int r = threadIdx.x; r < count; r += blockDim.x) store(r, res_v[r], res_d[r]);
  __syncthreads();
  if (threadIdx.x == 0) {
    CYCLES_ADD(20, c_chunk);
    CYCLES_COUNT(21, 1);
  }
}

}  // namespace mlp
