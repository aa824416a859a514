// Top-k wire-format packing for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/topk_wire.py:topk_wire
// (pallas_call at topk_wire.py:60). For each row of a (B, V) float32
// matrix it writes the k largest values (float32), their column indices
// (int32) and the row's logsumexp (float32). As in the TPU kernel there is
// no sort: k rounds of a row-wide argmax, where a tie goes to the lowest
// column (topk_wire.py:38-40), and the logsumexp is fused into the same
// pass over the row.
//
// Design. One block of 256 threads per row. Round r takes the best
// (value desc, column asc) element ranked strictly after round r-1's
// winner in that order, so nothing is masked out and the row is never
// written: the rounds only read. The row is staged in shared memory when
// V * 4 bytes fits, beside the reduction scratch, in the 48 KB every block
// may have (V = 1000 at the MHD shapes); a longer row is read from global memory (then L2) once per
// round. Each round is a strided scan plus a warp-shuffle argmax and one
// cross-warp step through shared memory.
//
// Bound on the H100: bytes. The function reads B*V*4 bytes and writes
// B*(8k+4); at the MHD publish shape (640 x 1000, k=32) that is 2.7 MB,
// under a microsecond at 3.35 TB/s, so a launch of this size is bound by
// launch latency and the k dependent block reductions, not by memory.
//
// Numerics: IEEE expf/logf (the file is never built with fast math), so
// values and indices are exact and the lse differs from a plain PyTorch
// logsumexp only through the order of the sum.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemBytes = 48 * 1024;  // a block's shared memory
                                          // without an opt-in

// (v, i) ranks ahead of (bv, bi): larger value first, then lower column.
__device__ __forceinline__ bool ranks_before(float v, int i, float bv,
                                             int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ranks_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide best (value, column); every thread returns the winner.
__device__ void block_best(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_best(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -INFINITY;
    i = lane < kWarps ? si[lane] : INT_MAX;
    warp_best(v, i);
    if (lane == 0) {
      sv[kWarps] = v;
      si[kWarps] = i;
    }
  }
  __syncthreads();
  v = sv[kWarps];
  i = si[kWarps];
  __syncthreads();  // the scratch is reused by the next reduction
}

template <bool kMax>
__device__ float block_reduce(float x, float* s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, o) : x + o;
  }
  if (lane == 0) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? s[lane] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, x, off);
      x = kMax ? fmaxf(x, o) : x + o;
    }
    if (lane == 0) s[kWarps] = x;
  }
  __syncthreads();
  x = s[kWarps];
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(kThreads)
topk_wire_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, float* __restrict__ lse, int V, int k,
                 int row_in_smem) {
  extern __shared__ float srow[];
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];

  const size_t r = blockIdx.x;
  const float* row = x + r * (size_t)V;
  if (row_in_smem) {
    for (int j = threadIdx.x; j < V; j += kThreads) srow[j] = row[j];
    __syncthreads();
    row = srow;
  }

  // fused logsumexp: m + log(sum(exp(x - m))), with a non-finite max
  // replaced by 0 as jax.nn.logsumexp does
  float m = -INFINITY;
  for (int j = threadIdx.x; j < V; j += kThreads) m = fmaxf(m, row[j]);
  m = block_reduce<true>(m, red_v);
  const float mu = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  for (int j = threadIdx.x; j < V; j += kThreads) s += expf(row[j] - mu);
  s = block_reduce<false>(s, red_v);
  if (threadIdx.x == 0) lse[r] = logf(s) + mu;

  // k rounds: the best element ranked after the previous winner
  float pv = INFINITY;
  int pi = -1;
  for (int round = 0; round < k; ++round) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < V; j += kThreads) {
      const float v = row[j];
      if (ranks_before(pv, pi, v, j) && ranks_before(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    block_best(bv, bi, red_v, red_i);
    if (threadIdx.x == 0) {
      vals[r * k + round] = bv;
      idx[r * k + round] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

}  // namespace

// x (B, V) float32 row-major -> vals (B, k) float32, idx (B, k) int32,
// lse (B,) float32, on `stream`. Returns the cudaError_t of the launch.
extern "C" int topk_wire_f32(const float* x, float* vals, int* idx,
                             float* lse, long long B, int V, int k,
                             void* stream) {
  if (B <= 0) return 0;
  // the row shares the block's 48 KB with the kernel's static scratch
  static const size_t static_smem = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, topk_wire_kernel) == cudaSuccess
               ? a.sharedSizeBytes
               : kSmemBytes;
  }();
  const size_t row_bytes = (size_t)V * sizeof(float);
  const int row_in_smem = row_bytes + static_smem <= kSmemBytes;
  topk_wire_kernel<<<(unsigned)B, kThreads, row_in_smem ? row_bytes : 0,
                     (cudaStream_t)stream>>>(x, vals, idx, lse, V, k,
                                             row_in_smem);
  return (int)cudaGetLastError();
}
