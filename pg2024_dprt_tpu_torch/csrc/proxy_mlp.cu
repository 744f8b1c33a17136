// The vis/depth net pair of the neural proxies for Hopper (sm_90a): K5
// mlp_pair and K6 mlp_dense, bound to PyTorch through a plain C interface
// (ctypes).
//
// K5 mlp_pair replaces the JAX package's Pallas kernel
// pallas_mlp.py::_pair_kernel (pallas_call at :113): the vis and the depth
// net of each query's own object, both nets in one launch, over queries the
// wrapper has grouped by object (one stable sort; `seg` holds the O + 1
// segment offsets). K6 mlp_dense replaces pallas_mlp.py::_dense_kernel
// (pallas_call at :203): the same result for queries in ray order with a
// per-row object id, with no sort or scatter around the kernel.
//
// The forward pass is in proxy_mlp.cuh (bf16 operands, f32 accumulation, the
// products in the kernels' own bodies), which the fused route kernel
// (route.cu) shares. The TPU kernels' layout is not carried over: no
// block-aligned dispatch budget and no block -> object table (a K5 block
// finds its object and chunk from the segment offsets, a grid of
// ceil(Q / rows) + O blocks always suffices), no pass over all O objects'
// nets per block in K6 (a block groups the valid rows of its 256-row tile by
// object in shared memory and runs each present object's nets over chunks
// of its own rows only), no (rows, 8) padded output.
//
// What bounds them on an H100: operations. A row costs 2 x 286,944
// multiply-adds at the production width against 20 bytes in and 8 out; all
// 16 production nets are 9.2 MB of bf16 and stay in L2. These first kernels
// run the products on the FP32 pipes (67 TFLOP/s), not on the tensor cores.

#include "proxy_mlp.cuh"

namespace {

using mlp::Dims;
using mlp::Nets;

constexpr int kTile = 256;  // rows of a K6 tile, one per thread
static_assert(kTile == mlp::kThreads, "a K6 thread owns one row of its tile");

// K5: block b runs chunk (b - first block of its object) of the object whose
// segment of the sorted queries holds it; blocks past the last chunk leave.
__global__ void __launch_bounds__(mlp::kThreads) mlp_pair_kernel(
    const float* __restrict__ xs, const int64_t* __restrict__ seg, int n_obj,
    Dims d, Nets vis, Nets depth, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  int b = blockIdx.x;
  int obj = -1, begin = 0, count = 0;
  for (int o = 0; o < n_obj; ++o) {
    const int lo = (int)seg[o], hi = (int)seg[o + 1];
    const int chunks = (hi - lo + mlp::kRows - 1) / mlp::kRows;
    if (b < chunks) {
      obj = o;
      begin = lo + b * mlp::kRows;
      count = min(mlp::kRows, hi - begin);
      break;
    }
    b -= chunks;
  }
  if (obj < 0) return;
  const int nf = d.in_features;
  mlp::pair_chunk(
      d, vis, depth, obj, count, reinterpret_cast<float*>(smem_f4),
      [&](int r, int f) { return xs[(size_t)(begin + r) * nf + f]; },
      [&](int r, float v, float dp) {
        out[2 * (size_t)(begin + r)] = v;
        out[2 * (size_t)(begin + r) + 1] = dp;
      });
}

// K6: one block per tile of kTile rows in ray order. The block groups its
// valid rows by object (counting sort in shared memory; the order inside a
// group does not matter, each row's result is its own), runs the nets of
// each object present over chunks of that object's rows, and writes zeros
// for invalid rows.
__global__ void __launch_bounds__(mlp::kThreads) mlp_dense_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ obj_id,
    const uint8_t* __restrict__ valid, int q, int n_obj, Dims d, Nets vis,
    Nets depth, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  int* list = reinterpret_cast<int*>(smem + mlp::smem_floats(d));  // (kTile,)
  int* cnt = list + kTile;                                          // (n_obj,)
  int* start = cnt + n_obj;                                         // (n_obj,)
  const int row = blockIdx.x * kTile + threadIdx.x;
  for (int o = threadIdx.x; o < n_obj; o += blockDim.x) cnt[o] = 0;
  __syncthreads();
  int my_obj = -1, my_rank = 0;
  if (row < q && valid[row]) {
    const int o = obj_id[row];
    if (o >= 0 && o < n_obj) {
      my_obj = o;
      my_rank = atomicAdd(&cnt[o], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int o = 0; o < n_obj; ++o) {
      start[o] = acc;
      acc += cnt[o];
    }
  }
  __syncthreads();
  if (my_obj >= 0) {
    list[start[my_obj] + my_rank] = row;
  } else if (row < q) {
    out[2 * (size_t)row] = 0.0f;
    out[2 * (size_t)row + 1] = 0.0f;
  }
  __syncthreads();
  const int nf = d.in_features;
  for (int o = 0; o < n_obj; ++o) {
    const int total = cnt[o];
    for (int base = 0; base < total; base += mlp::kRows) {
      const int* rows = list + start[o] + base;
      mlp::pair_chunk(
          d, vis, depth, o, min(mlp::kRows, total - base), smem,
          [&](int r, int f) { return x[(size_t)rows[r] * nf + f]; },
          [&](int r, float v, float dp) {
            out[2 * (size_t)rows[r]] = v;
            out[2 * (size_t)rows[r] + 1] = dp;
          });
    }
  }
}

// Opts a kernel in to `bytes` of dynamic shared memory; returns the CUDA
// error (0 = ok).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// C entry points: launch on the caller's stream and return the first CUDA
// error (0 = launched). `out` is (Q, 2): vis, depth.
extern "C" int mlp_pair(
    const float* xs, const int64_t* seg, int q, int n_obj,
    const void* vis_w, const float* vis_b, const void* depth_w, const float* depth_b,
    int width, int depth, int in_features, int head_hidden, int vis_act,
    int depth_act, float* out, void* stream) {
  const Dims d{width, depth, in_features, head_hidden, 1, 0};
  if (!mlp::dims_ok(d) || n_obj < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q <= 0) return 0;
  const size_t bytes = mlp::smem_floats(d) * sizeof(float);
  if (int rc = allow_smem(mlp_pair_kernel, bytes)) return rc;
  const int blocks = (q + mlp::kRows - 1) / mlp::kRows + n_obj;
  mlp_pair_kernel<<<blocks, mlp::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      xs, seg, n_obj, d,
      Nets{static_cast<const __nv_bfloat16*>(vis_w), vis_b, vis_act},
      Nets{static_cast<const __nv_bfloat16*>(depth_w), depth_b, depth_act}, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlp_dense(
    const float* x, const int32_t* obj_id, const uint8_t* valid, int q, int n_obj,
    const void* vis_w, const float* vis_b, const void* depth_w, const float* depth_b,
    int width, int depth, int in_features, int head_hidden, int vis_act,
    int depth_act, float* out, void* stream) {
  const Dims d{width, depth, in_features, head_hidden, 1, 0};
  if (!mlp::dims_ok(d) || n_obj < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q <= 0) return 0;
  const size_t bytes = mlp::smem_floats(d) * sizeof(float) +
                       (size_t)(kTile + 2 * n_obj) * sizeof(int);
  if (int rc = allow_smem(mlp_dense_kernel, bytes)) return rc;
  const int blocks = (q + kTile - 1) / kTile;
  mlp_dense_kernel<<<blocks, mlp::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, obj_id, valid, q, n_obj, d,
      Nets{static_cast<const __nv_bfloat16*>(vis_w), vis_b, vis_act},
      Nets{static_cast<const __nv_bfloat16*>(depth_w), depth_b, depth_act}, out);
  return static_cast<int>(cudaGetLastError());
}
