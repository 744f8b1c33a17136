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
// The forward pass is in proxy_mlp.cuh (every Linear on the tensor cores,
// bf16 operands, f32 accumulation), which the fused route kernel (route.cu)
// shares. The TPU kernels' layout is not carried over: no block-aligned
// dispatch budget and no block -> object table (a K5 block finds its object
// and chunk from the segment offsets, a grid of ceil(Q / rows) + O blocks
// always suffices), no pass over all O objects' nets per block in K6, no
// (rows, 8) padded output.
//
// What bounds them on an H100: operations at the bf16 tensor rate, 2 x
// 286,944 multiply-adds per valid row at the production width against 20
// bytes in and 8 out; all 16 production nets are 9.2 MB of bf16 and stay in
// L2. What the design does about it: the products run on the tensor cores,
// and each chunk fetches its object's weights once from L2 for up to 64
// rows (`rows`, chosen by the wrapper as large as shared memory allows), so
// the weight traffic per row falls with the chunk's fill. K5's chunks are
// full by construction (sorted segments). K6 runs one block per (object,
// part of the batch): the block scans its part in ray order, compacts its
// object's valid rows in shared memory, and runs a chunk whenever `rows` of
// them are held (the last one partial), so an object's rows per weight
// fetch grow with the part, not with a fixed tile.

#include "proxy_mlp.cuh"

namespace {

using mlp::Dims;
using mlp::Nets;

// the m16 tiles a K5 / K6 chunk may hold (ops/mlp.py MAX_CHUNK_ROWS / 16)
constexpr int kMaxTiles = 4;

// K5: block b runs chunk (b - first block of its object) of the object whose
// segment of the sorted queries holds it; blocks past the last chunk leave.
__global__ void __launch_bounds__(mlp::kThreads, 1) mlp_pair_kernel(
    const float* __restrict__ xs, const int64_t* __restrict__ seg, int n_obj,
    Dims d, int rows, Nets vis, Nets depth, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  int b = blockIdx.x;
  int obj = -1, begin = 0, count = 0;
  for (int o = 0; o < n_obj; ++o) {
    const int lo = (int)seg[o], hi = (int)seg[o + 1];
    const int chunks = (hi - lo + rows - 1) / rows;
    if (b < chunks) {
      obj = o;
      begin = lo + b * rows;
      count = min(rows, hi - begin);
      break;
    }
    b -= chunks;
  }
  if (obj < 0) return;
  const int nf = d.in_features;
  mlp::pair_chunk<kMaxTiles, false>(
      d, vis, depth, obj, count, rows, smem_f4,
      [&](int r, int f) { return xs[(size_t)(begin + r) * nf + f]; },
      [&](int r, float v, float dp) {
        out[2 * (size_t)(begin + r)] = v;
        out[2 * (size_t)(begin + r) + 1] = dp;
      });
}

// K6: block (part, obj) = blockIdx.x (part-major) scans rows [part * span,
// (part + 1) * span) in ray order, kThreads at a time, appends the valid
// rows of object `obj` to a list in shared memory (ballot compaction, in
// ray order), and runs the nets over the first `rows` of them whenever that
// many are held, then over the rest. The object-0 block of each part writes
// zeros for the part's rows that are invalid or whose object has no net.
__global__ void __launch_bounds__(mlp::kThreads, 1) mlp_dense_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ obj_id,
    const uint8_t* __restrict__ valid, int q, int n_obj, int span, Dims d, int rows,
    Nets vis, Nets depth, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f4);
  int* list = reinterpret_cast<int*>(smem + mlp::smem_bytes(d, rows));  // (rows + kThreads)
  int* warp_n = list + rows + mlp::kThreads;                            // (kWarps)
  const int obj = blockIdx.x % n_obj, part = blockIdx.x / n_obj;
  const int lo = part * span, hi = min(q, lo + span);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nf = d.in_features;
  auto run = [&](int count) {
    mlp::pair_chunk<kMaxTiles, false>(
        d, vis, depth, obj, count, rows, smem,
        [&](int r, int f) { return x[(size_t)list[r] * nf + f]; },
        [&](int r, float v, float dp) {
          out[2 * (size_t)list[r]] = v;
          out[2 * (size_t)list[r] + 1] = dp;
        });
  };
  int held = 0;  // rows in the list, the same in every thread
  for (int base = lo; base < hi; base += mlp::kThreads) {
    const int row = base + tid;
    bool mine = false;
    if (row < hi) {
      const int ob = obj_id[row];
      const bool ok = valid[row] && ob >= 0 && ob < n_obj;
      mine = ok && ob == obj;
      if (!ok && obj == 0) {
        out[2 * (size_t)row] = 0.0f;
        out[2 * (size_t)row + 1] = 0.0f;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = held, total = 0;
    for (int w = 0; w < mlp::kWarps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (mine) list[at + __popc(ballot & ((1u << lane) - 1u))] = row;
    held += total;
    __syncthreads();
    while (held >= rows) {
      run(rows);  // ends with a barrier
      const int rest = held - rows;  // < kThreads
      const int keep = tid < rest ? list[rows + tid] : 0;
      __syncthreads();
      if (tid < rest) list[tid] = keep;
      __syncthreads();
      held = rest;
    }
  }
  if (held > 0) run(held);
}

// Opts a kernel in to `bytes` of dynamic shared memory; returns the CUDA
// error (0 = ok).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool rows_ok(int rows) { return rows >= mlp::kRows && rows <= 16 * kMaxTiles && rows % 16 == 0; }

}  // namespace

// C entry points: launch on the caller's stream and return the first CUDA
// error (0 = launched). `out` is (Q, 2): vis, depth. Weights in fragment
// order (proxy_mlp.cuh); `rows` is the chunk size (16 .. 64, a multiple of
// 16).
extern "C" int mlp_pair(
    const float* xs, const int64_t* seg, int q, int n_obj,
    const void* vis_w, const float* vis_b, const void* depth_w, const float* depth_b,
    int width, int depth, int in_features, int head_hidden, int vis_act,
    int depth_act, int rows, float* out, void* stream) {
  const Dims d{width, depth, in_features, head_hidden, 1, 0};
  if (!mlp::dims_ok(d) || n_obj < 1 || !rows_ok(rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q <= 0) return 0;
  const size_t bytes = mlp::smem_bytes(d, rows);
  if (int rc = allow_smem(mlp_pair_kernel, bytes)) return rc;
  const int blocks = (q + rows - 1) / rows + n_obj;
  mlp_pair_kernel<<<blocks, mlp::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      xs, seg, n_obj, d, rows,
      Nets{static_cast<const uint4*>(vis_w), vis_b, vis_act},
      Nets{static_cast<const uint4*>(depth_w), depth_b, depth_act}, out);
  return static_cast<int>(cudaGetLastError());
}

// `parts`: the parts of the batch (blocks = parts x n_obj).
extern "C" int mlp_dense(
    const float* x, const int32_t* obj_id, const uint8_t* valid, int q, int n_obj,
    int parts, const void* vis_w, const float* vis_b, const void* depth_w,
    const float* depth_b, int width, int depth, int in_features, int head_hidden,
    int vis_act, int depth_act, int rows, float* out, void* stream) {
  const Dims d{width, depth, in_features, head_hidden, 1, 0};
  if (!mlp::dims_ok(d) || n_obj < 1 || parts < 1 || !rows_ok(rows) ||
      (long long)parts * n_obj >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q <= 0) return 0;
  const size_t bytes = mlp::smem_bytes(d, rows) +
                       (size_t)(rows + mlp::kThreads + mlp::kWarps) * sizeof(int);
  if (int rc = allow_smem(mlp_dense_kernel, bytes)) return rc;
  const int span = (q + parts - 1) / parts;
  mlp_dense_kernel<<<parts * n_obj, mlp::kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      x, obj_id, valid, q, n_obj, span, d, rows,
      Nets{static_cast<const uint4*>(vis_w), vis_b, vis_act},
      Nets{static_cast<const uint4*>(depth_w), depth_b, depth_act}, out);
  return static_cast<int>(cudaGetLastError());
}
