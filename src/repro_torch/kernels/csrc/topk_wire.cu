// Top-k wire-format packing for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/topk_wire.py:topk_wire
// (pallas_call at topk_wire.py:60). For each row of a (B, V) float32
// matrix it writes the k largest values (float32), their column indices
// (int32; a tie goes to the lowest column, topk_wire.py:38-40) and the
// row's logsumexp (float32).
//
// Bound on the H100: bytes. The function reads B*V*4 bytes and writes
// B*(8k+4): 0.738 ms at the LM path's publish (12,288 x 50,280, k = 8) and
// 0.470 ms at the hybrid path's (12,288 x 32,000) at 3.35 TB/s; its
// arithmetic, one IEEE expf and a few compares a value, hides under the
// loads (ablations/topk_wire.py). A row is 128-201 KB there, more than a
// block can stage beside enough others to keep the memory busy, so the
// design reads every row from device memory once and keeps only k entries
// of it on chip.
//
// Design (topk_wire_kernel). One warp a row, kWarps rows a block, no block
// barrier. The warp streams its row by 16-byte loads (__ldcs: read once),
// lane l on the l-th float4 of each 512 bytes, kUnroll loads in flight a
// lane. Each lane keeps an online logsumexp: m, the largest value it has
// seen, clamped to +-FLT_MAX so that x - m is never inf - inf, and s, the
// sum of exp(x - m) in double, rescaled by exp(m_old - m_new) once a group
// of kUnroll float4s. The selection is the warp's: a list in shared memory
// of at most k + kCap (value, column) entries, and a threshold (tv, ti),
// the k-th best entry at the last flush. A float4 whose largest value is
// below tv is dropped after one compare and a vote; otherwise the lane
// appends its four entries at a slot counted from a ballot. When the list
// is full, a flush keeps its best k in rank order (larger value first, then
// lower column): each lane sorts its own entries, then k rounds take the
// best of the lanes' heads by two warp reductions (__reduce_max_sync over
// order-preserving value keys, __reduce_min_sync over the columns that
// hold the max), the winner popping its head. The threshold then rises to
// the k-th entry. An entry left out ranks after k entries that are kept,
// so the row's top k stay, and values and columns are selected, never
// computed: both are exact. At the end one more flush gives the row's top
// k, and the lanes' (m, s) merge into the lse by shuffles in double.
//
// A row that does not start on 16 bytes (V % 4 != 0, every row but the
// first) takes its columns up to the first 16-byte boundary and its last
// (V - p) % 4 columns one a lane, around the float4 body; the body's last
// group of kUnroll float4s a lane is masked.
//
// k > kMaxK (no path asks for it): topk_wire_rank_kernel, one block a row,
// gives each element its rank, the count of elements ranked before it,
// against the row staged through shared memory kTile columns at a time,
// and writes the element at slot rank when rank < k. It does O(V^2) work
// and reads the row V / (kRankThreads * kRankPer) times more, from L2; its
// lse takes two passes (the max, then the sum).
//
// NaN is no candidate in either kernel: a row must hold k values that are
// not NaN (the codec refuses non-finite teachers). -inf and +inf are
// values like any other; an all -inf row gives lse -inf and its k lowest
// columns, as the plain version does.
//
// Numerics: IEEE expf/logf (the file is never built with fast math), so
// values and indices are exact and the lse differs from a plain PyTorch
// logsumexp only through the order and the width of its sum.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // rows a block, one warp each
constexpr int kUnroll = 4;    // float4 loads in flight a lane
constexpr int kCap = 256;     // list entries beyond k; at least 128, a
                              // float4 from every lane
constexpr int kMaxK = 256;    // a larger k takes topk_wire_rank_kernel
constexpr int kRankThreads = 256;
constexpr int kRankPer = 4;   // elements a thread ranks in one sweep
constexpr int kTile = 2048;   // columns staged at a time by the rank kernel

struct Entry {
  float v;
  int i;
};

// (v, i) ranks ahead of (bv, bi): larger value first, then lower column.
__device__ __forceinline__ bool ranks_before(float v, int i, float bv,
                                             int bi) {
  return v > bv || (v == bv && i < bi);
}

// A float's rank as an unsigned key: larger value, larger key; -0 as +0,
// so that they tie as floats do; NaN 0, below -inf (0x007fffff).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return v != v ? 0u : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The best min(k, n) entries of src[0, n) in rank order into dst[0, k),
// the rest (-inf, INT_MAX); every lane of the warp calls it, and src is
// reordered. Each lane first sorts its own entries, src[lane + 32 t], by
// rank (insertion); then each of k rounds takes the best of the lanes'
// heads, by a max over the value keys and a min over the columns of the
// lanes that hold it (two warp reductions), and the winning lane writes it
// and moves to its next entry.
__device__ __noinline__ void select_top(Entry* src, int n, int k,
                                        Entry* dst, int lane) {
  const int own = (n - lane + 31) >> 5;  // entries of this lane
  for (int t = 1; t < own; ++t) {
    const Entry e = src[lane + 32 * t];
    const unsigned ek = order_key(e.v);
    int j = t - 1;
    for (; j >= 0; --j) {
      const Entry o = src[lane + 32 * j];
      const unsigned ok = order_key(o.v);
      if (ek < ok || (ek == ok && e.i > o.i)) break;
      src[lane + 32 * (j + 1)] = o;
    }
    src[lane + 32 * (j + 1)] = e;
  }
  const Entry none{-INFINITY, INT_MAX};
  int h = 0;
  Entry head = own > 0 ? src[lane] : none;
  for (int r = 0; r < k; ++r) {
    const unsigned key = order_key(head.v);
    const unsigned best = __reduce_max_sync(kFull, key);
    const int col = __reduce_min_sync(kFull, key == best ? head.i : INT_MAX);
    if (key == best && head.i == col) {  // one lane, or all on `none`
      dst[r] = head;
      ++h;
      head = h < own ? src[lane + 32 * h] : none;
    }
  }
}

// A warp's candidate list in shared memory: list[0, n), n <= k + kCap,
// holds the best k of every entry offered so far and those offered since
// the last flush; tmp[0, k) is the flush's output.
struct WarpList {
  Entry* list;
  Entry* tmp;
  int k, n, lane;
  float tv;  // the threshold: the k-th entry at the last flush
  int ti;

  __device__ void flush() {
    __syncwarp();
    select_top(list, n, k, tmp, lane);
    __syncwarp();
    for (int j = lane; j < k; j += 32) list[j] = tmp[j];
    n = k;
    tv = tmp[k - 1].v;
    ti = tmp[k - 1].i;
  }

  // Lanes with `hot` set append their W entries, v[w] at column c0 + w.
  template <int W>
  __device__ __forceinline__ void offer(const float (&v)[W], int c0,
                                        bool hot) {
    const unsigned b = __ballot_sync(kFull, hot);
    const int add = W * __popc(b);
    if (n + add > k + kCap) flush();
    if (hot) {
      Entry* at = list + n + W * __popc(b & ((1u << lane) - 1u));
#pragma unroll
      for (int w = 0; w < W; ++w) at[w] = Entry{v[w], c0 + w};
    }
    n += add;
  }
};

__device__ __forceinline__ float4 load4(const float4* p) { return __ldcs(p); }

__device__ __forceinline__ float max4(const float4& q) {
  return fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w));
}

// One group of U float4s a lane, the first at column c0 and the others
// 128 columns apart; a slot that is not valid holds -inf and offers
// nothing.
template <int U>
__device__ __forceinline__ void take(const float4 (&q)[U], int c0,
                                     const bool (&valid)[U], float& m,
                                     double& s, WarpList& w) {
  float mx[U];
  float gm = -INFINITY;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    mx[u] = max4(q[u]);
    gm = fmaxf(gm, mx[u]);
  }
  const float mn = fminf(fmaxf(m, gm), FLT_MAX);
  float part = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    part += (expf(q[u].x - mn) + expf(q[u].y - mn)) +
            (expf(q[u].z - mn) + expf(q[u].w - mn));
  s = s * (double)expf(m - mn) + (double)part;
  m = mn;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bool hot = valid[u] && mx[u] >= w.tv;
    if (__any_sync(kFull, hot)) {
      const int c = c0 + 128 * u;
      hot = hot && (mx[u] > w.tv || c < w.ti);
      const float v[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      w.offer<4>(v, c, hot);
    }
  }
}

// One column a lane (the unaligned head and the tail).
__device__ __forceinline__ void take1(const float* row, int c, bool valid,
                                      float& m, double& s, WarpList& w) {
  const float x = valid ? row[c] : -INFINITY;
  const float mn = fminf(fmaxf(m, x), FLT_MAX);
  s = s * (double)expf(m - mn) + (double)expf(x - mn);
  m = mn;
  bool hot = valid && x >= w.tv;
  if (__any_sync(kFull, hot)) {
    hot = hot && (x > w.tv || c < w.ti);
    const float v[1] = {x};
    w.offer<1>(v, c, hot);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
topk_wire_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ idx, float* __restrict__ lse, long long B,
                 int V, int k) {
  extern __shared__ Entry slab[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= B) return;  // the whole warp: no block barrier follows
  WarpList w;
  w.list = slab + warp * (2 * k + kCap);
  w.tmp = w.list + k + kCap;
  w.k = k;
  w.n = 0;
  w.lane = lane;
  w.tv = -INFINITY;
  w.ti = INT_MAX;

  const float* row = x + r * V;
  // columns [0, p) before the first 16-byte boundary, a float4 body of n4,
  // then the tail
  const int p = min((int)((16u - ((uintptr_t)row & 15u)) & 15u) >> 2, V);
  const int n4 = (V - p) >> 2;
  const float4* body = reinterpret_cast<const float4*>(row + p);
  float m = -FLT_MAX;
  double s = 0.0;

  take1(row, lane, lane < p, m, s, w);
#pragma unroll 1
  for (int base = 0; base < n4; base += 32 * kUnroll) {
    float4 q[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = base + 32 * u + lane;
      valid[u] = f < n4;
      q[u] = valid[u] ? load4(body + f)
                      : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                    -INFINITY);
    }
    take<kUnroll>(q, p + 4 * (base + lane), valid, m, s, w);
  }
  const int t0 = p + 4 * n4;
  take1(row, t0 + lane, t0 + lane < V, m, s, w);

  __syncwarp();
  select_top(w.list, w.n, k, w.tmp, lane);
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    vals[r * k + j] = w.tmp[j].v;
    idx[r * k + j] = w.tmp[j].i;
  }

  // lse = M + log(sum over lanes of s * exp(m - M)), M the row's max
  float M = m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
  double t = s * exp((double)m - (double)M);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) lse[r] = (float)(log(t) + (double)M);
}

__global__ void __launch_bounds__(kRankThreads)
topk_wire_rank_kernel(const float* __restrict__ x, float* __restrict__ vals,
                      int* __restrict__ idx, float* __restrict__ lse, int V,
                      int k) {
  __shared__ float tile[kTile];
  __shared__ float red_m[kRankThreads / 32];
  __shared__ double red_s[kRankThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long r = blockIdx.x;
  const float* row = x + r * V;

  // lse as the plain version: mu + log(sum(exp(x - mu))), mu the row's max
  // or 0 where that is not finite
  float mx = -INFINITY;
  for (int j = tid; j < V; j += kRankThreads) mx = fmaxf(mx, row[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) red_m[warp] = mx;
  __syncthreads();
  mx = red_m[0];
  for (int j = 1; j < kRankThreads / 32; ++j) mx = fmaxf(mx, red_m[j]);
  const float mu = isfinite(mx) ? mx : 0.0f;
  double s = 0.0;
  for (int j = tid; j < V; j += kRankThreads) s += expf(row[j] - mu);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) red_s[warp] = s;
  __syncthreads();
  if (tid == 0) {
    for (int j = 1; j < kRankThreads / 32; ++j) s += red_s[j];
    lse[r] = (float)(log(s) + (double)mu);
  }

  for (int e0 = 0; e0 < V; e0 += kRankThreads * kRankPer) {
    float ev[kRankPer];
    int rank[kRankPer];
#pragma unroll
    for (int j = 0; j < kRankPer; ++j) {
      const int e = e0 + j * kRankThreads + tid;
      ev[j] = e < V ? row[e] : NAN;
      rank[j] = 0;
    }
    for (int c0 = 0; c0 < V; c0 += kTile) {
      const int len = min(kTile, V - c0);
      __syncthreads();  // the last tile's reads are done
      for (int j = tid; j < len; j += kRankThreads) tile[j] = row[c0 + j];
      __syncthreads();
      for (int c = 0; c < len; ++c) {
        const float v = tile[c];
#pragma unroll
        for (int j = 0; j < kRankPer; ++j)
          rank[j] += ranks_before(v, c0 + c, ev[j], e0 + j * kRankThreads + tid);
      }
    }
#pragma unroll
    for (int j = 0; j < kRankPer; ++j) {
      const int e = e0 + j * kRankThreads + tid;
      if (e < V && ev[j] == ev[j] && rank[j] < k) {
        vals[r * k + rank[j]] = ev[j];
        idx[r * k + rank[j]] = e;
      }
    }
  }
}

}  // namespace

// x (B, V) float32 row-major -> vals (B, k) float32, idx (B, k) int32,
// lse (B,) float32, on `stream`; 1 <= k <= V. Returns the cudaError_t of
// the launch.
extern "C" int topk_wire_f32(const float* x, float* vals, int* idx,
                             float* lse, long long B, int V, int k,
                             void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k > kMaxK) {
    topk_wire_rank_kernel<<<(unsigned)B, kRankThreads, 0, st>>>(
        x, vals, idx, lse, V, k);
  } else {
    const size_t smem = (size_t)kWarps * (2 * k + kCap) * sizeof(Entry);
    topk_wire_kernel<<<(unsigned)((B + kWarps - 1) / kWarps), kWarps * 32,
                       smem, st>>>(x, vals, idx, lse, B, V, k);
  }
  return (int)cudaGetLastError();
}
