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
// bf16 is the contract of the nets: every product rounds the activation and
// the weight to bf16 (round to nearest even) and accumulates in f32; the bias
// is added in f32; the features are rounded to bf16 on entry. Sums run over
// the input index in ascending order with explicit fmaf, so the result does
// not depend on the --fmad flag of the translation unit.
//
// The multi-geo net (models/mlp.py net_forward, multi_geo=True; JAX
// models/mlp.py:164-181): ONE net shared by every object, whose sixth input
// is the object id / INSTANCE_DIVISOR. Encoders, features (in_features - 1)
// -> w/8 -> w/2 and id 1 -> w/8 -> w/2 (LeakyReLU), concatenated to out1;
// pre h = leaky(out1 W + b); the residual lead h = leaky(h W + b); `depth`
// residual blocks; the trail h W + b without activation; the global skip
// out1 + trail; the head w -> w/2 -> head_hidden (LeakyReLU after each) ->
// out_features; the final activation. Same arithmetic contract as above.
//
// One block runs both nets (vis, depth) of ONE object over a chunk of at most
// kRows query rows. Thread j owns output column j of every layer (columns
// beyond the block size are strided) and keeps kRows accumulators in
// registers; a weight is read once from global memory (bf16, coalesced
// across the block; all objects' nets together stay in L2) and meets the
// kRows activations of its input index, which all threads read from shared
// memory as broadcasts. Activations live in shared memory as f32, transposed
// (index-major, row-minor): two buffers every thread reads, holding the
// bf16-rounded values of the current and the next layer's input (xa, xb),
// and two that only a column's own thread touches, holding the unrounded
// out1 and h for the residual adds. The kernels need more than 48 KiB of
// dynamic shared memory at the production width (66,176 bytes at width 256
// with 16 rows) and opt in with cudaFuncSetAttribute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int kRows = 16;           // query rows of one chunk (ops/mlp.py KERNEL_ROWS)
constexpr int kThreads = 256;       // threads of a block that runs the nets
constexpr int kMaxFeatures = 8;     // rows of the feature staging buffer
constexpr float kLeakySlope = 0.01f;

static_assert(kRows % 4 == 0, "rows are read as float4");

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

// The nets of all objects: weights bf16 and biases f32, per object the
// Linears in param_shapes order, each weight (in, out) row-major.
struct Nets {
  const __nv_bfloat16* __restrict__ w;  // (O, weights_per_net)
  const float* __restrict__ b;          // (O, biases_per_net)
  int final_act;
};

__host__ __device__ inline int weights_per_net(const Dims& d) {
  const int eh = d.width / 8, eo = d.width / 2, w = d.width;
  if (d.multi_geo) {
    return (d.in_features - 1) * eh + eh * eo + eh + eh * eo + (d.depth + 3) * w * w +
           w * eo + eo * d.head_hidden + d.head_hidden * d.out_features;
  }
  return (d.in_features - 2) * eh + eh * eo + 2 * eh + eh * eo +
         d.depth * w * w + w * d.head_hidden + d.head_hidden * d.out_features;
}

__host__ __device__ inline int biases_per_net(const Dims& d) {
  const int eh = d.width / 8, eo = d.width / 2;
  if (d.multi_geo) {
    return 2 * eh + 2 * eo + (d.depth + 3) * d.width + eo + d.head_hidden +
           d.out_features;
  }
  return 2 * eh + 2 * eo + d.depth * d.width + d.head_hidden + d.out_features;
}

// Floats of dynamic shared memory the forward pass needs.
__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return (size_t)(4 * d.width + kMaxFeatures + 2 * d.out_features) * kRows;
}

// What a kernel takes: a width divisible by 8 (encoder widths w/8, w/2) and
// at least 16 (the encoders' hidden rows fit a buffer), at most
// kMaxFeatures inputs.
__host__ __device__ inline bool dims_ok(const Dims& d) {
  return d.width >= 16 && d.width % 8 == 0 && d.depth >= 0 &&
         d.in_features >= 3 && d.in_features <= kMaxFeatures &&
         d.head_hidden >= 1 && d.head_hidden <= d.width && d.out_features >= 1;
}

struct Smem {
  float* out1;  // (width, kRows) unrounded encoder output, own columns only
  float* h;     // (width, kRows) unrounded residual state, own columns only
  float* xa;    // (width, kRows) bf16-rounded layer input / output
  float* xb;    // (width, kRows)
  float* feat;  // (kMaxFeatures, kRows) bf16-rounded features of the chunk
  float* res;   // (2, out_features, kRows) vis then depth predictions
};

__device__ __forceinline__ Smem carve(float* base, const Dims& d) {
  const size_t plane = (size_t)d.width * kRows;
  Smem s;
  s.out1 = base;
  s.h = base + plane;
  s.xa = base + 2 * plane;
  s.xb = base + 3 * plane;
  s.feat = base + 4 * plane;
  s.res = s.feat + kMaxFeatures * kRows;
  return s;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : kLeakySlope * v;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kLeaky) return leaky(v);
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-v));
  return v;
}

// One Linear over the chunk: for every output column c owned by this thread,
// value[r] = sum_k xin[k][r] * W[k][c] + bias[c], handed to epi(c, r, value).
// Thread t owns the columns c with c = (t - first_thread) mod blockDim.x, so
// two Linears that feed disjoint halves of a buffer can run side by side.
template <typename Epi>
__device__ __forceinline__ void linear(const float* __restrict__ xin, int in_dim,
                                       const __nv_bfloat16* __restrict__ w,
                                       const float* __restrict__ bias, int out_dim,
                                       int first_thread, Epi epi) {
  const int nt = blockDim.x;
  for (int c = ((int)threadIdx.x - first_thread % nt + nt) % nt; c < out_dim; c += nt) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < in_dim; ++k) {
      const float wv = __bfloat162float(w[(size_t)k * out_dim + c]);
      const float4* xr = reinterpret_cast<const float4*>(xin + (size_t)k * kRows);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 x = xr[q];
        acc[4 * q + 0] = fmaf(x.x, wv, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(x.y, wv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(x.z, wv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(x.w, wv, acc[4 * q + 3]);
      }
    }
    const float b = bias[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) epi(c, r, acc[r] + b);
  }
}

// The narrow last Linear: one thread per (channel, row), from the head's
// hidden rows in `x`. Ends with a barrier.
__device__ __forceinline__ void head_out(const Dims& d, const float* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ w,
                                         const float* __restrict__ b, int final_act,
                                         float* __restrict__ res) {
  for (int idx = threadIdx.x; idx < d.out_features * kRows; idx += blockDim.x) {
    const int ch = idx / kRows, r = idx % kRows;
    float acc = 0.0f;
    for (int k = 0; k < d.head_hidden; ++k) {
      acc = fmaf(x[k * kRows + r], __bfloat162float(w[k * d.out_features + ch]), acc);
    }
    res[ch * kRows + r] = activate(acc + b[ch], final_act);
  }
  __syncthreads();
}

// The multi-geo net over the chunk whose rounded features (the id column
// last) are in s.feat. Same buffers and contract as forward().
__device__ __forceinline__ void forward_multigeo(const Dims& d,
                                                 const __nv_bfloat16* __restrict__ w,
                                                 const float* __restrict__ b, int final_act,
                                                 const Smem& s, float* __restrict__ res) {
  const int eh = d.width / 8, eo = d.width / 2, wd = d.width;
  const int n_f = d.in_features - 1;
  // encoders, first Linear: features -> xb rows [0, eh), id -> [eh, 2 eh)
  linear(s.feat, n_f, w, b, eh, 0,
         [&](int c, int r, float v) { s.xb[c * kRows + r] = round_bf16(leaky(v)); });
  w += n_f * eh;
  b += eh;
  const __nv_bfloat16* w_f1 = w;
  const float* b_f1 = b;
  w += eh * eo;
  b += eo;
  linear(s.feat + n_f * kRows, 1, w, b, eh, eh,
         [&](int c, int r, float v) { s.xb[(eh + c) * kRows + r] = round_bf16(leaky(v)); });
  w += eh;
  b += eh;
  __syncthreads();
  // encoders, second Linear: -> out1 (unrounded) and xa (rounded)
  linear(s.xb, eh, w_f1, b_f1, eo, 0, [&](int c, int r, float v) {
    const float a = leaky(v);
    s.out1[c * kRows + r] = a;
    s.xa[c * kRows + r] = round_bf16(a);
  });
  linear(s.xb + eh * kRows, eh, w, b, eo, eo, [&](int c, int r, float v) {
    const float a = leaky(v);
    s.out1[(eo + c) * kRows + r] = a;
    s.xa[(eo + c) * kRows + r] = round_bf16(a);
  });
  w += eh * eo;
  b += eo;
  __syncthreads();
  // pre block, then the residual lead: h = leaky(x W + b)
  float* cur = s.xa;
  float* nxt = s.xb;
  for (int i = 0; i < 2; ++i) {
    linear(cur, wd, w, b, wd, 0, [&](int c, int r, float v) {
      const float a = leaky(v);
      s.h[c * kRows + r] = a;
      nxt[c * kRows + r] = round_bf16(a);
    });
    w += wd * wd;
    b += wd;
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // residual blocks: h = leaky(h + h W + b)
  for (int i = 0; i < d.depth; ++i) {
    linear(cur, wd, w, b, wd, 0, [&](int c, int r, float v) {
      const float a = leaky(s.h[c * kRows + r] + v);
      s.h[c * kRows + r] = a;
      nxt[c * kRows + r] = round_bf16(a);
    });
    w += wd * wd;
    b += wd;
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // the trail, no activation, and the global skip: out1 + (h W + b)
  linear(cur, wd, w, b, wd, 0, [&](int c, int r, float v) {
    nxt[c * kRows + r] = round_bf16(s.out1[c * kRows + r] + v);
  });
  w += wd * wd;
  b += wd;
  __syncthreads();
  // head: w -> w/2 -> head_hidden -> out_features
  linear(nxt, wd, w, b, eo, 0,
         [&](int c, int r, float v) { cur[c * kRows + r] = round_bf16(leaky(v)); });
  w += wd * eo;
  b += eo;
  __syncthreads();
  linear(cur, eo, w, b, d.head_hidden, 0,
         [&](int c, int r, float v) { nxt[c * kRows + r] = round_bf16(leaky(v)); });
  w += eo * d.head_hidden;
  b += d.head_hidden;
  __syncthreads();
  head_out(d, nxt, w, b, final_act, res);
}

// One net of one object over the chunk whose rounded features are in s.feat.
// Writes the predictions to res[channel * kRows + row]. All threads of the
// block call it; it ends with a barrier.
__device__ __forceinline__ void forward(const Dims& d, const __nv_bfloat16* __restrict__ w,
                                        const float* __restrict__ b, int final_act,
                                        const Smem& s, float* __restrict__ res) {
  if (d.multi_geo) {
    forward_multigeo(d, w, b, final_act, s, res);
    return;
  }
  const int eh = d.width / 8, eo = d.width / 2, wd = d.width;
  const int n_o = d.in_features - 2;
  // encoders, first Linear: features -> xb rows [0, eh) and [eh, 2 eh)
  linear(s.feat, n_o, w, b, eh, 0,
         [&](int c, int r, float v) { s.xb[c * kRows + r] = round_bf16(leaky(v)); });
  w += n_o * eh;
  b += eh;
  const __nv_bfloat16* w_o1 = w;
  const float* b_o1 = b;
  w += eh * eo;
  b += eo;
  linear(s.feat + n_o * kRows, 2, w, b, eh, eh,
         [&](int c, int r, float v) { s.xb[(eh + c) * kRows + r] = round_bf16(leaky(v)); });
  w += 2 * eh;
  b += eh;
  __syncthreads();
  // encoders, second Linear: -> out1 = h = xa, columns [0, eo) and [eo, w)
  linear(s.xb, eh, w_o1, b_o1, eo, 0, [&](int c, int r, float v) {
    const float a = leaky(v);
    s.out1[c * kRows + r] = a;
    s.h[c * kRows + r] = a;
    s.xa[c * kRows + r] = round_bf16(a);
  });
  linear(s.xb + eh * kRows, eh, w, b, eo, eo, [&](int c, int r, float v) {
    const float a = leaky(v);
    s.out1[(eo + c) * kRows + r] = a;
    s.h[(eo + c) * kRows + r] = a;
    s.xa[(eo + c) * kRows + r] = round_bf16(a);
  });
  w += eh * eo;
  b += eo;
  __syncthreads();
  float* cur = s.xa;
  float* nxt = s.xb;
  // residual blocks: h = leaky(h + h W + b)
  for (int i = 0; i < d.depth; ++i) {
    linear(cur, wd, w, b, wd, 0, [&](int c, int r, float v) {
      const float a = leaky(s.h[c * kRows + r] + v);
      s.h[c * kRows + r] = a;
      nxt[c * kRows + r] = round_bf16(a);
    });
    w += wd * wd;
    b += wd;
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // global skip: the head reads out1 + h (each thread its own columns)
  for (int c = threadIdx.x; c < wd; c += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      nxt[c * kRows + r] = round_bf16(s.out1[c * kRows + r] + s.h[c * kRows + r]);
    }
  }
  __syncthreads();
  // head: w -> head_hidden -> out_features
  linear(nxt, wd, w, b, d.head_hidden, 0,
         [&](int c, int r, float v) { cur[c * kRows + r] = round_bf16(leaky(v)); });
  w += wd * d.head_hidden;
  b += d.head_hidden;
  __syncthreads();
  // the last Linear is narrow: one thread per (channel, row)
  head_out(d, cur, w, b, final_act, res);
}

// Both nets of object `obj` over a chunk of `count` (<= kRows) rows:
// load(r, f) gives feature f of the chunk's row r, store(r, vis, depth)
// takes channel 0 of each net's prediction. All threads of the block call
// it with the same arguments; it ends with a barrier.
template <typename Load, typename Store>
__device__ __forceinline__ void pair_chunk(const Dims& d, const Nets& vis,
                                           const Nets& depth, int obj, int count,
                                           float* smem, Load load, Store store) {
  const Smem s = carve(smem, d);
  for (int idx = threadIdx.x; idx < d.in_features * kRows; idx += blockDim.x) {
    const int f = idx / kRows, r = idx % kRows;
    s.feat[idx] = r < count ? round_bf16(load(r, f)) : 0.0f;
  }
  __syncthreads();
  const size_t wo = (size_t)obj * weights_per_net(d), bo = (size_t)obj * biases_per_net(d);
  float* res_v = s.res;
  float* res_d = s.res + d.out_features * kRows;
  forward(d, vis.w + wo, vis.b + bo, vis.final_act, s, res_v);
  forward(d, depth.w + wo, depth.b + bo, depth.final_act, s, res_d);
  for (int r = threadIdx.x; r < count; r += blockDim.x) store(r, res_v[r], res_d[r]);
  __syncthreads();
}

}  // namespace mlp
