// Normalized embedding distance (Eq. 2) for Hopper (sm_90a), forward and
// backward, plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/emb_dist.py:emb_dist
// (pallas_call at emb_dist.py:39). For each row of two (B, E) matrices s
// (the student's embeddings) and t (the teacher's), f32, bf16 or f16 each:
//
//     out = || s/(||s||+eps) - t/(||t||+eps) ||^2,   eps = 1e-8,  f32 (B,)
//
// The backward (the TPU kernel has none) is the gradient in s only: with
// n = ||s||, u = s/(n+eps), w = t/(||t||+eps) and r = 2(u - w),
//
//     d out/d s = g * ( r/(n+eps) - s*(s.r) / ((n+eps)^2 * n) ),
//
// whose second term is 0 at n = 0; written in s's type.
//
// Bound on the H100: bytes. The forward reads both matrices once and
// writes B floats; the backward reads them and g and writes a matrix in
// s's type. At the pod path's 2,044 x 1,024 f32 rows that is 16.7 MB,
// 0.0050 ms at 3.35 TB/s; the arithmetic, a dozen f32 operations an
// element, is far below it. So the design keeps as many bytes in flight as
// the card needs and reads each element once.
//
// Design. A row is held in registers by a group of warps_per_row warps
// (1, 2, 4 or 8: one warp holds up to 1,024 elements of s and of t, so one
// warp a row for E <= 1,024 and up to one block of 8 warps a row for E =
// 8,192). A block is max(4, warps_per_row) warps, so 4 rows a block of 4
// warps for E <= 1,024. Lane l of warp w of the group loads VEC contiguous
// elements at column ((c * warps_per_row + w) * 32 + l) * VEC for chunk
// c < CH, every load of the row issued before the first sum, so each warp
// has all of its row's bytes in flight at once: at 2,044 rows that is one
// wave of ~16 warps an SM, 8 KB each. VEC * sizeof is 16 bytes for the
// wider type (float4, or 8 bf16/f16 values), taken only when each
// tensor's base and row stride are aligned to its vector and E % VEC ==
// 0; otherwise VEC = 1 (odd E, a row off its vector). The launch geometry
// is worked out in Python (repro_torch/kernels/emb_dist.launch_geometry),
// which the CPU tests walk element by element.
//
// Numerics: f32 sums, reduced by __shfl_xor_sync within a warp (every lane
// ends with the same bits) and, across a row's warps, through shared
// memory in warp order. The distance is formed element by element, as the
// reference does (repro/kernels/emb_dist.py:16-21): d = s/(||s||+eps) -
// t/(||t||+eps), then sum d^2, never from ||s||^2, ||t||^2 and s.t, which
// cancel when s ~ t. Each element is scaled by the row's reciprocal
// 1/(||s||+eps), one IEEE division a row, where the reference divides
// each element: within an ulp of it, while an IEEE division an element
// (ablations/emb_dist.py's "divide each element") chains 64-96 divisions
// a lane and took 3.3x the time at 32 x 512 and 11-34 % more at the pod
// rows on the H100. The two products of a difference are rounded apart
// (__fmul_rn: nvcc would fuse one into an FMA), so s == t gives exactly
// 0. IEEE sqrtf and reciprocal: the file is never built with fast math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;      // a block's warps at most
constexpr int kWarpSpan = 1024;   // elements of a row one warp holds

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int N> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// VEC elements at p (aligned to VEC * sizeof(T)) as floats, in one load
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  T e[VEC];
  memcpy(e, &r, sizeof(R));
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = to_f(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  T e[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(x[i]);
  R r;
  memcpy(&r, e, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// a[0] + ... + a[N-1] pairwise, N a power of two: a chain of log2(N) adds
// where a running sum would be N long
template <int N>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) a[i] += a[i + w];
  return a[0];
}

// The row's sum of x over its group of warps; every thread of the group
// gets the same bits. `slot` is this round's shared array (a round never
// reuses another's, so no barrier is needed after the reads).
__device__ __forceinline__ float row_sum(float x, float* slot, int warp,
                                         int wr, int wpr) {
  x = warp_sum(x);
  if (wpr == 1) return x;  // the same for the whole block
  if ((threadIdx.x & 31) == 0) slot[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < wpr; ++i) total += slot[warp - wr + i];
  return total;
}

// The pieces both kernels share: this thread's place, its chunks of the
// row's s and t (zeros past E or past B), and the row's ||s||^2, ||t||^2.
template <typename TS, typename TT, int VEC, int CH>
struct RowTile {
  int warp, wr, wpr;
  long long row;
  bool live;
  float s[CH][VEC], t[CH][VEC];

  __device__ __forceinline__ int col(int c) const {
    return ((c * wpr + wr) * 32 + (int)(threadIdx.x & 31)) * VEC;
  }

  __device__ __forceinline__ void load(const TS* __restrict__ sp,
                                       const TT* __restrict__ tp, long long B,
                                       int E, long long ss, long long st,
                                       int wpr_) {
    wpr = wpr_;
    warp = threadIdx.x >> 5;
    wr = warp % wpr;
    const int rows_pb = (blockDim.x >> 5) / wpr;
    row = (long long)blockIdx.x * rows_pb + warp / wpr;
    live = row < B;
    const TS* sr = sp + (live ? row : 0) * ss;
    const TT* tr = tp + (live ? row : 0) * st;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = col(c);
      if (live && k < E) {
        load_vec<TS, VEC>(sr + k, s[c]);
        load_vec<TT, VEC>(tr + k, t[c]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) s[c][v] = t[c][v] = 0.f;
      }
    }
  }

  // a lane's sums go by chunk, then pairwise over the chunks
  __device__ __forceinline__ void norms2(float* slot, float& s2, float& t2) {
    float sc[CH], tc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      sc[c] = tc[c] = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        sc[c] = fmaf(s[c][v], s[c][v], sc[c]);
        tc[c] = fmaf(t[c][v], t[c][v], tc[c]);
      }
    }
    s2 = row_sum(tree_sum(sc), slot, warp, wr, wpr);
    t2 = row_sum(tree_sum(tc), slot + kMaxWarps, warp, wr, wpr);
  }
};

template <typename TS, typename TT, int VEC, int CH>
__global__ void __launch_bounds__(kMaxWarps * 32)
    emb_dist_fwd_kernel(const TS* __restrict__ s, const TT* __restrict__ t,
                        float* __restrict__ out, long long B, int E,
                        long long ss, long long st, int wpr, float eps) {
  __shared__ float red[3][kMaxWarps];
  RowTile<TS, TT, VEC, CH> x;
  x.load(s, t, B, E, ss, st, wpr);
  float s2, t2;
  x.norms2(red[0], s2, t2);
  const float ns = sqrtf(s2) + eps, nt = sqrtf(t2) + eps;
  const float is = 1.f / ns, it = 1.f / nt;
  float dc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    dc[c] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      // two rounded products (no FMA), so s == t gives d = 0 exactly
      const float d = __fmul_rn(x.s[c][v], is) - __fmul_rn(x.t[c][v], it);
      dc[c] = fmaf(d, d, dc[c]);  // 0 past E
    }
  }
  const float d2 = row_sum(tree_sum(dc), red[2], x.warp, x.wr, wpr);
  if (x.live && x.wr == 0 && (threadIdx.x & 31) == 0) out[x.row] = d2;
}

template <typename TS, typename TT, int VEC, int CH>
__global__ void __launch_bounds__(kMaxWarps * 32)
    emb_dist_bwd_kernel(const TS* __restrict__ s, const TT* __restrict__ t,
                        const float* __restrict__ g, TS* __restrict__ gs,
                        long long B, int E, long long ss, long long st,
                        long long sgs, int wpr, float eps) {
  __shared__ float red[3][kMaxWarps];
  RowTile<TS, TT, VEC, CH> x;
  x.load(s, t, B, E, ss, st, wpr);
  const float gr = x.live ? __ldg(g + x.row) : 0.f;
  float s2, t2;
  x.norms2(red[0], s2, t2);
  const float n = sqrtf(s2), ne = n + eps, nte = sqrtf(t2) + eps;
  const float ie = 1.f / ne, ite = 1.f / nte;
  // r = 2(u - w) takes t's registers; s.r
  float rc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    rc[c] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float r =
          2.f * (__fmul_rn(x.s[c][v], ie) - __fmul_rn(x.t[c][v], ite));
      x.t[c][v] = r;
      rc[c] = fmaf(x.s[c][v], r, rc[c]);
    }
  }
  const float sr = row_sum(tree_sum(rc), red[2], x.warp, x.wr, wpr);
  const float coef = n > 0.f ? sr / (ne * ne * n) : 0.f;
  if (!x.live) return;  // no barrier follows
  TS* gr_row = gs + x.row * sgs;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = x.col(c);
    if (k < E) {
      float o[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        o[v] = gr * (x.t[c][v] * ie - x.s[c][v] * coef);
      store_vec<TS, VEC>(gr_row + k, o);
    }
  }
}

template <typename TS, typename TT>
struct Widths {
  // elements a 16-byte load of the wider type holds, and the chunks that
  // fill one warp's 1,024 elements at that width and at 1
  static constexpr int kVec = 16 / (sizeof(TS) > sizeof(TT) ? sizeof(TS)
                                                            : sizeof(TT));
  static constexpr int kChunks = kWarpSpan / (32 * kVec);
  static constexpr int kScalarChunks = kWarpSpan / 32;
};

bool bad_geometry(int E, int vec, int wpr, int threads, int want_vec) {
  return E < 0 || (vec != want_vec && vec != 1) || wpr < 1 ||
         wpr > kMaxWarps || (wpr & (wpr - 1)) || E > wpr * kWarpSpan ||
         threads < 32 * wpr || threads > 32 * kMaxWarps ||
         threads % (32 * wpr) || (vec > 1 && E % vec);
}

unsigned grid_of(long long B, int wpr, int threads) {
  const long long rows_pb = threads / (32 * wpr);
  return (unsigned)((B + rows_pb - 1) / rows_pb);
}

template <typename TS, typename TT>
cudaError_t fwd(const void* s, const void* t, float* out, long long B, int E,
                long long ss, long long st, int vec, int wpr, int threads,
                float eps, cudaStream_t stream) {
  using W = Widths<TS, TT>;
  if (bad_geometry(E, vec, wpr, threads, W::kVec)) return cudaErrorInvalidValue;
  const unsigned grid = grid_of(B, wpr, threads);
  const TS* sp = static_cast<const TS*>(s);
  const TT* tp = static_cast<const TT*>(t);
  if (vec > 1)
    emb_dist_fwd_kernel<TS, TT, W::kVec, W::kChunks>
        <<<grid, threads, 0, stream>>>(sp, tp, out, B, E, ss, st, wpr, eps);
  else
    emb_dist_fwd_kernel<TS, TT, 1, W::kScalarChunks>
        <<<grid, threads, 0, stream>>>(sp, tp, out, B, E, ss, st, wpr, eps);
  return cudaGetLastError();
}

template <typename TS, typename TT>
cudaError_t bwd(const void* s, const void* t, const float* g, void* gs,
                long long B, int E, long long ss, long long st, long long sgs,
                int vec, int wpr, int threads, float eps,
                cudaStream_t stream) {
  using W = Widths<TS, TT>;
  if (bad_geometry(E, vec, wpr, threads, W::kVec)) return cudaErrorInvalidValue;
  const unsigned grid = grid_of(B, wpr, threads);
  const TS* sp = static_cast<const TS*>(s);
  const TT* tp = static_cast<const TT*>(t);
  TS* gp = static_cast<TS*>(gs);
  if (vec > 1)
    emb_dist_bwd_kernel<TS, TT, W::kVec, W::kChunks>
        <<<grid, threads, 0, stream>>>(sp, tp, g, gp, B, E, ss, st, sgs, wpr,
                                       eps);
  else
    emb_dist_bwd_kernel<TS, TT, 1, W::kScalarChunks>
        <<<grid, threads, 0, stream>>>(sp, tp, g, gp, B, E, ss, st, sgs, wpr,
                                       eps);
  return cudaGetLastError();
}

// calls F<TS, TT>(args...) for the two dtype codes
template <template <typename, typename> class F, typename... A>
cudaError_t by_types(int s_dtype, int t_dtype, A... args) {
#define EMB_DIST_T(TS, TT) return F<TS, TT>::run(args...)
#define EMB_DIST_TT(TS)                                      \
  switch (t_dtype) {                                         \
    case kF32: EMB_DIST_T(TS, float);                        \
    case kBF16: EMB_DIST_T(TS, __nv_bfloat16);               \
    case kF16: EMB_DIST_T(TS, __half);                       \
    default: return cudaErrorInvalidValue;                   \
  }
  switch (s_dtype) {
    case kF32: EMB_DIST_TT(float);
    case kBF16: EMB_DIST_TT(__nv_bfloat16);
    case kF16: EMB_DIST_TT(__half);
    default: return cudaErrorInvalidValue;
  }
#undef EMB_DIST_TT
#undef EMB_DIST_T
}

template <typename TS, typename TT>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... args) { return fwd<TS, TT>(args...); }
};

template <typename TS, typename TT>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... args) { return bwd<TS, TT>(args...); }
};

}  // namespace

// s, t: (B, E) with row strides ss, st (elements) and column stride 1;
// out: (B,) f32. dtype codes: 0 f32, 1 bf16, 2 f16. vec, warps_per_row and
// threads come from emb_dist.launch_geometry. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a geometry or a type it
// does not take (nothing launched).
extern "C" int emb_dist_fwd(const void* s, const void* t, float* out,
                            long long B, int E, long long ss, long long st,
                            int s_dtype, int t_dtype, int vec,
                            int warps_per_row, int threads, float eps,
                            void* stream) {
  if (B <= 0) return 0;
  return (int)by_types<Fwd>(s_dtype, t_dtype, s, t, out, B, E, ss, st, vec,
                            warps_per_row, threads, eps,
                            (cudaStream_t)stream);
}

// g: (B,) f32; gs: (B, E) in s's type with row stride sgs.
extern "C" int emb_dist_bwd(const void* s, const void* t, const float* g,
                            void* gs, long long B, int E, long long ss,
                            long long st, long long sgs, int s_dtype,
                            int t_dtype, int vec, int warps_per_row,
                            int threads, float eps, void* stream) {
  if (B <= 0) return 0;
  return (int)by_types<Bwd>(s_dtype, t_dtype, s, t, g, gs, B, E, ss, st, sgs,
                            vec, warps_per_row, threads, eps,
                            (cudaStream_t)stream);
}
