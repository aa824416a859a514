// A design that src/repro_torch/kernels/csrc/emb_dist.cu did not take, built
// and timed by ablations/emb_dist.py only: one warp a row loops over it in
// float4 steps (f32, rows on 16 bytes, E % 4 == 0) and reads the row again
// from the caches for each later pass (the forward twice, the backward
// three times), in place of holding it in the registers of a group of
// warps. The same function and sums in another order: its results agree
// with the kernel's to rounding.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // rows a block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

struct Row {
  const float4 *s, *t;
  int n, lane;
  bool live;
  long long row;

  __device__ Row(const float* sp, const float* tp, long long B, int E) {
    lane = threadIdx.x & 31;
    row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    live = row < B;
    s = reinterpret_cast<const float4*>(sp + (live ? row : 0) * E);
    t = reinterpret_cast<const float4*>(tp + (live ? row : 0) * E);
    n = live ? E / 4 : 0;
  }

  __device__ void norms(float eps, float& ns, float& nt, float& n0) const {
    float s2 = 0.f, t2 = 0.f;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const float4 a = __ldg(s + i), b = __ldg(t + i);
      s2 = dot4(a, a, s2);
      t2 = dot4(b, b, t2);
    }
    n0 = sqrtf(warp_sum(s2));
    ns = n0 + eps;
    nt = sqrtf(warp_sum(t2)) + eps;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
    loop_fwd(const float* __restrict__ s, const float* __restrict__ t,
             float* __restrict__ out, long long B, int E, float eps) {
  const Row r(s, t, B, E);
  float ns, nt, n0;
  r.norms(eps, ns, nt, n0);
  float d2 = 0.f;
#pragma unroll 4
  for (int i = r.lane; i < r.n; i += 32) {
    const float4 a = __ldg(r.s + i), b = __ldg(r.t + i);
    const float4 d = make_float4(a.x / ns - b.x / nt, a.y / ns - b.y / nt,
                                 a.z / ns - b.z / nt, a.w / ns - b.w / nt);
    d2 = dot4(d, d, d2);
  }
  d2 = warp_sum(d2);
  if (r.live && r.lane == 0) out[r.row] = d2;
}

__global__ void __launch_bounds__(kWarps * 32)
    loop_bwd(const float* __restrict__ s, const float* __restrict__ t,
             const float* __restrict__ g, float* __restrict__ gs, long long B,
             int E, float eps) {
  const Row r(s, t, B, E);
  float ne, nte, n;
  r.norms(eps, ne, nte, n);
  float sr = 0.f;
#pragma unroll 4
  for (int i = r.lane; i < r.n; i += 32) {
    const float4 a = __ldg(r.s + i), b = __ldg(r.t + i);
    const float4 q = make_float4(2.f * (a.x / ne - b.x / nte),
                                 2.f * (a.y / ne - b.y / nte),
                                 2.f * (a.z / ne - b.z / nte),
                                 2.f * (a.w / ne - b.w / nte));
    sr = dot4(a, q, sr);
  }
  sr = warp_sum(sr);
  const float coef = n > 0.f ? sr / (ne * ne * n) : 0.f;
  if (!r.live) return;
  const float gr = g[r.row];
  float4* o = reinterpret_cast<float4*>(gs + r.row * E);
#pragma unroll 4
  for (int i = r.lane; i < r.n; i += 32) {
    const float4 a = __ldg(r.s + i), b = __ldg(r.t + i);
    float4 q;
    q.x = gr * (2.f * (a.x / ne - b.x / nte) / ne - a.x * coef);
    q.y = gr * (2.f * (a.y / ne - b.y / nte) / ne - a.y * coef);
    q.z = gr * (2.f * (a.z / ne - b.z / nte) / ne - a.z * coef);
    q.w = gr * (2.f * (a.w / ne - b.w / nte) / ne - a.w * coef);
    o[i] = q;
  }
}

}  // namespace

extern "C" int loop_fwd_f32(const float* s, const float* t, float* out,
                            long long B, int E, float eps, void* stream) {
  if (B <= 0) return 0;
  loop_fwd<<<(unsigned)((B + kWarps - 1) / kWarps), kWarps * 32, 0,
             (cudaStream_t)stream>>>(s, t, out, B, E, eps);
  return (int)cudaGetLastError();
}

extern "C" int loop_bwd_f32(const float* s, const float* t, const float* g,
                            float* gs, long long B, int E, float eps,
                            void* stream) {
  if (B <= 0) return 0;
  loop_bwd<<<(unsigned)((B + kWarps - 1) / kWarps), kWarps * 32, 0,
             (cudaStream_t)stream>>>(s, t, g, gs, B, E, eps);
  return (int)cudaGetLastError();
}
