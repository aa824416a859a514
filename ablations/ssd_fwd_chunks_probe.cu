// The ssd_scan forward parallel over chunks, Mamba2's own split: a probe
// that ablations/ssd_fwd.py appends to csrc/ssd_scan.cu in place of
// the scan kernel, after the prep kernel (C B^T once per (b, chunk), every
// head's cumsum). Three launches:
//
//   chunkstate (b, h, chunk c): G_c = x_c^T (w o B_c), the state a chunk
//     adds, from zero, into a (Bt, H, nc, P, N) buffer;
//   carry (b, h, 256 of the P N entries): h_0 = 0, h_{c+1} = exp(total_c)
//     h_c + G_c, writing every h_c (the chunk-start states) and the final;
//   chunky (b, h, chunk c): y_c = M x + (exp(s_t) C) h_c^T + D x.
//
// Each of chunkstate and chunky is a block of 8 warps, two blocks an SM.

namespace {

template <int NMAX>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_fwd_chunkstate_kernel(const float* __restrict__ x,
                               const float* __restrict__ dt,
                               const float* __restrict__ Bm,
                               const float* __restrict__ sc,
                               float* __restrict__ G, int T, int H, int P,
                               int N) {
  using F = FwdTiles<NMAX>;
  extern __shared__ __align__(16) float qsm[];
  float* xs = qsm;         // [L][P]
  float* bs = xs + F::kX;  // [L][N]
  float* ss = bs + F::kB;  // s, dt, w
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i4 = lane & 3;
  const int t0 = c * kL, Lc = min(kL, T - t0);
  const bool vec = P % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(Bm)) & 15) == 0;
  stage_rows<kPMax, F::kLdX>(xs, x, (((size_t)b * T + t0) * H + h) * P,
                             H * P, Lc, P, vec);
  stage_rows<NMAX, F::kLdB>(bs, Bm, ((size_t)b * T + t0) * N, N, Lc, N, vec);
  if (threadIdx.x < kL)
    cp_async4(ss + threadIdx.x,
              sc + (((size_t)b * nc + c) * kL + threadIdx.x) * H + h, true);
  else if (threadIdx.x < 2 * kL) {
    const int t = threadIdx.x - kL;
    cp_async4(ss + kL + t, t < Lc ? dt + ((size_t)b * T + t0 + t) * H + h : dt,
              t < Lc);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < kL)
    ss[2 * kL + threadIdx.x] =
        expf(ss[kL - 1] - ss[threadIdx.x]) * ss[kL + threadIdx.x];
  __syncthreads();

  constexpr int NQ = NMAX / 16;
  const int p0 = 16 * (warp >> 1), n0 = (warp & 1) * (NMAX / 2);
  const float* ws = ss + 2 * kL;
  float acc[NQ][4] = {};
#pragma unroll
  for (int ks = 0; ks < kL / 8; ++ks) {
    const int u0 = 8 * ks + i4, u1 = u0 + 4;
    const float w0 = ws[u0], w1 = ws[u1];
    const float* x0 = xs + u0 * F::kLdX + p0 + g;
    const float* x1 = xs + u1 * F::kLdX + p0 + g;
    const float v[4] = {x0[0] * w0, x0[8] * w0, x1[0] * w1, x1[8] * w1};
    const Split<4> a = split(v);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      mma3(acc[q], a, frag_b<F::kLdB>(bs, n0 + 8 * q, 8 * ks, lane));
  }
  float* dst = G + (((size_t)b * H + h) * nc + c) * P * N;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + g + (k < 2 ? 0 : 8), n = n0 + 8 * q + 2 * i4 + (k & 1);
      if (p < P && n < N) dst[p * N + n] = acc[q][k];
    }
}

__global__ void ssd_scan_fwd_carry_kernel(const float* __restrict__ G,
                                          const float* __restrict__ sc,
                                          float* __restrict__ states,
                                          float* __restrict__ fin, int nc,
                                          int H, int PN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = (size_t)b * H + h;
  float hv = 0.f;
  for (int c = 0; c < nc; ++c) {
    states[(bh * nc + c) * PN + e] = hv;
    const float dec = expf(sc[(((size_t)b * nc + c) * kL + kL - 1) * H + h]);
    hv = dec * hv + G[(bh * nc + c) * PN + e];
  }
  fin[bh * PN + e] = hv;
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_fwd_chunky_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ D,
                           const float* __restrict__ Cm,
                           const float* __restrict__ cb,
                           const float* __restrict__ sc,
                           const float* __restrict__ states,
                           float* __restrict__ y, int T, int H, int P,
                           int N) {
  using F = FwdTiles<NMAX>;
  extern __shared__ __align__(16) float ysm[];
  float* hs = ysm;         // [P][N]
  float* xs = hs + F::kH;  // [L][P]
  float* cs = xs + F::kX;  // [L][N]
  float* ms = cs + F::kC;  // [L][L]
  float* ss = ms + F::kM;  // s, dt, exp(s)
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i4 = lane & 3;
  const int t0 = c * kL, Lc = min(kL, T - t0);
  const size_t bh = (size_t)b * H + h;
  const float Dh = D[h];
  const bool vec = P % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  stage_rows<kPMax, F::kLdX>(xs, x, (((size_t)b * T + t0) * H + h) * P,
                             H * P, Lc, P, vec);
  stage_rows<NMAX, F::kLdC>(cs, Cm, ((size_t)b * T + t0) * N, N, Lc, N, vec);
  stage_rows<NMAX, F::kLdH>(hs, states, (bh * nc + c) * P * N, N, P, N, vec);
  const float* src = cb + ((size_t)b * nc + c) * kL * kL;
  for (int i = threadIdx.x; i < kL * kL / 4; i += kThreads) {
    const int t = i / (kL / 4), u = 4 * (i % (kL / 4));
    if (u < 16 * (t / 16 + 1))
      cp_async16(ms + t * F::kLdM + u, src + t * kL + u, true);
  }
  if (threadIdx.x < kL)
    cp_async4(ss + threadIdx.x,
              sc + (((size_t)b * nc + c) * kL + threadIdx.x) * H + h, true);
  else if (threadIdx.x < 2 * kL) {
    const int t = threadIdx.x - kL;
    cp_async4(ss + kL + t, t < Lc ? dt + ((size_t)b * T + t0 + t) * H + h : dt,
              t < Lc);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {
    const int u = threadIdx.x % kL;
    const float su = ss[u], du = ss[kL + u];
    for (int t = threadIdx.x / kL; t < kL; t += kThreads / kL) {
      if (u < 16 * (t / 16 + 1)) {
        float* m = ms + t * F::kLdM + u;
        *m = u <= t ? *m * expf(ss[t] - su) * du : 0.f;
      }
    }
    if (threadIdx.x < kL) ss[2 * kL + u] = expf(su);
  }
  __syncthreads();

  const int r = warp >> 1, p0 = 32 * (warp & 1), ta = 16 * r + g;
  const float* es = ss + 2 * kL;
  float acc[4][4] = {};
  for (int ks = 0; ks < 2 * r + 2; ++ks) {
    const Split<4> a = frag_a<F::kLdM>(ms, 16 * r, 8 * ks, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mma3(acc[q], a, frag_b<F::kLdX>(xs, p0 + 8 * q, 8 * ks, lane));
  }
  const float ea = es[ta], eb = es[ta + 8];
#pragma unroll
  for (int ks = 0; ks < NMAX / 8; ++ks) {
    const float* cp = cs + ta * F::kLdC + 8 * ks + i4;
    const float v[4] = {cp[0] * ea, cp[8 * F::kLdC] * eb, cp[4] * ea,
                        cp[8 * F::kLdC + 4] * eb};
    const Split<4> a = split(v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mma3(acc[q], a, frag_bt<F::kLdH>(hs, p0 + 8 * q, 8 * ks, lane));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = ta + (k < 2 ? 0 : 8);
      const int p = p0 + 8 * q + 2 * i4 + (k & 1);
      if (t < Lc && p < P)
        y[(((size_t)b * T + t0 + t) * H + h) * P + p] =
            acc[q][k] + Dh * xs[t * F::kLdX + p];
    }
}

template <int NMAX>
int probe_chunks(const float* x, const float* dt, const float* D,
                 const float* B, const float* C, const float* cb,
                 const float* s, float* y, float* fin, float* states,
                 float* extra, int Bt, int T, int H, int P, int N,
                 cudaStream_t stream) {
  using F = FwdTiles<NMAX>;
  constexpr size_t smem1 = sizeof(float) * (F::kX + F::kB + 3 * kL);
  constexpr size_t smem3 =
      sizeof(float) * (F::kH + F::kX + F::kC + F::kM + 3 * kL);
  static const int attr =
      set_smem((const void*)ssd_scan_fwd_chunkstate_kernel<NMAX>, smem1) |
      set_smem((const void*)ssd_scan_fwd_chunky_kernel<NMAX>, smem3);
  if (attr) return attr;
  const int nc = (T + kL - 1) / kL;
  float* G = extra;
  float* st = states ? states : extra + (size_t)Bt * H * nc * kPMax * kNMax;
  ssd_scan_fwd_chunkstate_kernel<NMAX><<<dim3(H, nc, Bt), kThreads, smem1,
                                         stream>>>(x, dt, B, s, G, T, H, P, N);
  ssd_scan_fwd_carry_kernel<<<dim3((P * N + 255) / 256, H, Bt), 256, 0,
                              stream>>>(G, s, st, fin, nc, H, P * N);
  ssd_scan_fwd_chunky_kernel<NMAX><<<dim3(H, nc, Bt), kThreads, smem3,
                                     stream>>>(x, dt, D, C, cb, s, st, y, T,
                                               H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace
