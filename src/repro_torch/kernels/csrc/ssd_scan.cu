// Mamba2 SSD chunked scan for Hopper (sm_90a), forward and backward, with a
// plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:ssd_scan
// (pallas_call at ssd_scan.py:88). Per (batch b, head h), with the state
// h (P x N) carried over chunks of length L:
//
//   s_t   = cumsum_{tau <= t}(dt_tau * A)              (within the chunk)
//   y_t   = sum_{u <= t} (C_t . B_u) exp(s_t - s_u) dt_u x_u
//         + exp(s_t) h C_t + D x_t
//   h'    = exp(s_L) h + sum_u exp(s_L - s_u) dt_u x_u B_u^T
//
// x (Bt, T, H, P), dt (Bt, T, H), A and D (H), B and C (Bt, T, N) shared by
// all heads (ngroups = 1); y (Bt, T, H, P) and the final state
// (Bt, H, P, N), all float32.
//
// Design. The TPU kernel walks the chunks as a sequential grid axis and
// carries the state in VMEM scratch. Hopper's blocks run in no order, so
// here one block owns one (b, h) and loops over the chunks itself, with
// the state in shared memory. The chunk length is the kernels' own, L =
// 64: the TPU's L = 256 would need a 256 KB L x L tile, more than a
// block's 227 KB. The chunk length changes only the rounding, not the
// function. A ragged last chunk is zero-padded in shared memory (dt, x, B,
// C = 0 contribute nothing), so any T runs, and these kernels serve both
// cases the reference tells apart (ssd_chunked when T is a multiple of its
// chunk, the sequential ssd_reference otherwise). Sums accumulate in
// float32 with IEEE expf (the file is never built with fast math). The
// gate exp(s_t - s_u) is evaluated for u <= t only, where it is <= 1: the
// upper triangle, which overflows, is never exponentiated.
//
// Forward: two kernels, every product on the tensor cores by 3xTF32
// (mma.sync m16n8k8; each f32 operand split as big + small, three TF32
// products for each f32 one, about 21 bits kept a product, as in
// flash_attention.cu). A prep kernel forms C B^T once per (b, chunk), since
// B and C are shared by the heads, into a scratch of (Bt, nc, 64, 64), and
// every head's cumsum s, one thread a head in order (the backward launches
// it again, so both directions agree on s bitwise), into (Bt, nc, 64, H):
// 1.5 MB at the LM path's shape, 2.9 MB at the hybrid path's, read back from
// L2. The scan kernel is a block of 16 warps per (b, h). Per chunk: y = M x
// + (exp(s_t) C) h^T + D x, warp w taking rows 16 (w / 4).. and p columns 16
// (w % 4).., so each scheduler's 4 warps hold the 4 row blocks of M x's
// triangle; then h = exp(total) h + x^T (w o B), warp w taking p rows 16 (w
// / 4).. and n columns from (w % 4) N / 4. Chunk c + 1's x, C B^T, s, dt and
// B load by 16-byte cp.async into a second buffer while chunk c computes its
// y; after y, every thread turns C B^T into M = C B^T o gate o dt_u in place
// (each gate once), with w_u and exp(s_t) beside it, and chunk c + 1's C
// loads into the one C buffer. Tiles read along rows (C, M, h) have a row
// stride of 4 mod 32 and are read by ldmatrix; tiles read down columns (x,
// B), 8 mod 32: no bank conflicts. Templated on NMAX = 64 or 128 (N <=
// NMAX): shared memory 144,384 B and 209,920 B a scan block, so one block an
// SM; 124 and 109 registers a thread (at most 128 for 16 warps), the prep
// kernel 254, no spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8). No atomics:
// the forward is bitwise reproducible. It saves the state entering each
// chunk, (Bt, H, nc, P, N), when the caller asks for it.
// ablations/ssd_fwd.py times it against copies with one of its parts undone.
//
// Backward: two kernels, every product on the tensor cores by 3xTF32 as
// in the forward. The forward's prep kernel runs again for C B^T and s (8
// to 14 us of a call, ablations/ssd_bwd.py): the backward then needs only
// the inputs, the saved chunk states and dy, as its wrapper is called, no
// tensor more is saved, and s is the forward's bitwise. A block of 16
// warps per (b, h) reads the saved states and runs the chunks in reverse,
// carrying dh (P x N) in shared memory, so it never redoes the recurrence.
// Per chunk: dM = dy x^T on the 16 x 16 blocks on and below the diagonal;
// s1 = C B^T o gate and dCB = dM o gate o dt_u formed once from dM's
// accumulators, each gate exponentiated once; dx = dt_u s1^T dy + w_u B
// dh^T + D dy; dB = (w o x) dh + dCB^T C; dC = exp(s_t) dy h0 + dCB B; dh =
// exp(total) dh + (exp(s) o dy)^T C. The row and column sums of dM o s1 go
// by shuffles, and ds, its reverse cumsum and ddt by one warp's suffix scan
// beside the next chunk's first step. The gate's diagonal terms, which
// cancel exactly, are left out: at dt A = -10 a step their rounding would
// swamp dA. It returns dx, ddt, per-(b, h) partials of dA and dD and
// per-head partials of dB and dC (Bt, H, T, N): B and C are shared across
// heads, and the caller sums the partials over heads in a fixed order. No
// atomics: the backward is bitwise reproducible. dy, B, dh and dCB are read
// along rows by some products and down columns by others, where no padded
// stride serves both, so every tile is swizzled (at<W, true>) and neither
// read meets a bank conflict. Templated on NMAX = 64 or 128: shared memory
// 156,224 B and 221,760 B a block, so one block an SM; 124 and 127
// registers a thread, no spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8), with
// the product loops unrolled twice at NMAX 64 and not at 128, where more
// in flight spilled. ablations/ssd_bwd.py times it against copies with one
// of its parts undone.
//
// Bounds on the H100 at the LM path's shape (Bt 8, T 512, H 32, P 64, N
// 128). Forward: the products the function needs at L = 64 are 4.874
// GFLOP (C B^T once per (b, chunk), and per head the masked product with
// x, C h and the state update); by 3xTF32 at the card's 495 TFLOP/s of
// TF32 that is 0.0295 ms, and the arrays it must read and write (x, y 33.5
// MB each, B and C 2.1 MB each, the final state 8.4 MB; plus 67 MB of
// chunk states when training) move in 0.0239 ms (0.0440 ms) at 3.35 TB/s.
// At the hybrid path's (8, 512, 112, 64, N 64): 9.442 GFLOP, 0.0572 ms by
// 3xTF32 against 0.0757 ms of bytes (0.1107 saving states). So it is bound
// by operations at the LM shape and by bytes otherwise. It takes 0.169 ms
// and 0.370 ms (0.178 and 0.389 saving states) on an H100 80GB HBM3 at
// 700 W (chip_smoke.py's phase_ssd, call b7), 5.7x and 4.9x its bound; the
// float32 FMA kernel it replaced took 0.550 and 1.621 ms. The backward
// needs 9.787 GFLOP at the LM shape (C B^T again, and dB and dC once on
// the head-summed dCB; per head dM, dx's masked product and the four state
// products): 0.0593 ms by 3xTF32, against 177.2 MB of inputs, dy, chunk
// states and gradients, 0.0529 ms, so it is bound by operations; at the
// hybrid shape 18.92 GFLOP, 0.1146 ms, against 477.6 MB, 0.1426 ms, bound
// by bytes. It does more: dB and dC per head, 12.6 and 24.4 GFLOP of f32
// products at the two shapes. It takes 0.464 ms and 0.937 ms with its
// wrapper's head sums (the kernels alone 0.39 and 0.82 ms) on an H100 80GB
// HBM3 at 700 W (chip_smoke.py's phase_ssd and ablations/ssd_bwd.py, call
// c), 7.8x and 6.6x its bound; the float32 FMA kernel it replaced took
// 0.990 and 3.015 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;         // chunk length
constexpr int kThreads = 256;  // the prep kernel's 8 warps
constexpr int kPMax = 64;      // head dim P <= 64
constexpr int kNMax = 128;     // state size N <= 128

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// forward: every product on the tensor cores by 3xTF32
// ---------------------------------------------------------------------------

// mma.sync m16n8k8 fragments, lane = 4 g + i: a0 (g, i), a1 (g + 8, i), a2
// (g, i + 4), a3 (g + 8, i + 4); b0 (k i, n g), b1 (k i + 4, n g); c0, c1 (g,
// 2i and 2i + 1), c2, c3 (g + 8, the same columns).

// x = big + small: big is x rounded to TF32's 10-bit mantissa (add half of
// its last place, clear the 13 bits below), small = x - big exactly, passed
// as f32 bits, of which the tensor core reads the top 19 (TF32). big carries
// x's top 11 significant bits and small the next 11, so what the core sees
// is x to about 2^-21.
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    f.big[j] = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;
    f.small[j] = __float_as_uint(x[j] - __uint_as_float(f.big[j]));
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in f32 by 3xTF32: a.b = big.big + big.small + small.big, the
// dropped small.small below 2^-22 of it; the small terms go in first.
__device__ __forceinline__ void mma3(float (&c)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// A fragment of rows m0.. of a row-major tile x[m][k], columns k0..
template <int LD>
__device__ __forceinline__ Split<4> frag_a(const float* x, int m0, int k0,
                                           int lane) {
  const float* p = x + (m0 + (lane >> 2)) * LD + k0 + (lane & 3);
  const float v[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  return split(v);
}

// B fragment of B = x^T for a row-major x[n][k]: B[k][n] = x[n][k]
template <int LD>
__device__ __forceinline__ Split<2> frag_bt(const float* x, int n0, int k0,
                                            int lane) {
  const float* p = x + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  const float v[2] = {p[0], p[4]};
  return split(v);
}

// Offset of element (r, c) of a row-major tile of row stride LD. With SW
// the tile is swizzled: LD is a multiple of 32, and column c of row r lies
// at c ^ (8 (r % 4) + 4 (r / 4 % 2)). Fragments read along rows (8 rows of
// 4 columns, ldmatrix's pattern) and down columns (4 rows of 8 columns)
// then both hit 32 banks, with no padding; 4-aligned groups of 4 columns
// stay together, for 16-byte copies and ldmatrix rows.
template <int LD, bool SW = false>
__device__ __forceinline__ int at(int r, int c) {
  return r * LD + (SW ? c ^ (((r & 3) << 3) | (r & 4)) : c);
}

// B fragment of a row-major x[k][n]
template <int LD, bool SW = false>
__device__ __forceinline__ Split<2> frag_b(const float* x, int n0, int k0,
                                           int lane) {
  const int k = k0 + (lane & 3), n = n0 + (lane >> 2);
  const float v[2] = {x[at<LD, SW>(k, n)], x[at<LD, SW>(k + 4, n)]};
  return split(v);
}

// A fragment of rows m0.. of x^T for a row-major x[k][m] (A[m][k] =
// x[k][m]), columns k0.., read down x's columns; as floats, which the
// caller may scale by row of x before the split.
template <int LD, bool SW = false>
__device__ __forceinline__ void frag_at(float (&v)[4], const float* x, int m0,
                                        int k0, int lane) {
  const int k = k0 + (lane & 3), m = m0 + (lane >> 2);
  v[0] = x[at<LD, SW>(k, m)];
  v[1] = x[at<LD, SW>(k, m + 8)];
  v[2] = x[at<LD, SW>(k + 4, m)];
  v[3] = x[at<LD, SW>(k + 4, m + 8)];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(to),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// wait until at most N of the groups committed last are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

constexpr int kFwdThreads = 512;  // the scan kernel's 16 warps

// The forward's shared-memory tiles for state sizes N <= NMAX. A tile whose
// fragments are read along its rows (lane -> row lane / 4, column lane % 4)
// has a row stride of 4 mod 32; one read down its columns (lane -> row
// lane % 4, column lane / 4), 8 mod 32: either way the 32 lanes hit 32
// banks. Every stride is a multiple of 4 floats, so 16-byte copies align.
template <int NMAX>
struct FwdTiles {
  static constexpr int kLdX = kPMax + 8;  // x [u][p], read down columns
  static constexpr int kLdB = NMAX + 8;   // B [u][n], read down columns
  static constexpr int kLdC = NMAX + 4;   // C [t][n], read along rows
  static constexpr int kLdH = NMAX + 4;   // h [p][n], read along rows
  static constexpr int kLdM = kL + 4;     // C B^T [t][u], read along rows
  static constexpr int kH = kPMax * kLdH, kX = kL * kLdX, kB = kL * kLdB,
                       kC = kL * kLdC, kM = kL * kLdM;
  // x, B, M, and s, dt, w, exp(s) of a chunk
  static constexpr int kEarly = kX + kB + kM + 4 * kL;
  static constexpr size_t kSmem = sizeof(float) * (kH + kC + 2 * kEarly);
  static constexpr size_t kPrepSmem = sizeof(float) * 2 * kL * (NMAX + 4);
};

// Copy rows [0, rows) and columns [0, cols) of a chunk into a zeroed
// [kL][COLS] tile of row stride LD (swizzled with SW), by cp.async: 16
// bytes a copy when `vec` (cols % 4 == 0 and the rows 16-byte aligned),
// else 4. The caller commits and waits.
template <int COLS, int LD, bool SW = false>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           size_t row0, int stride, int rows,
                                           int cols, bool vec) {
  if (vec) {
    constexpr int Q4 = COLS / 4;
    for (int i = threadIdx.x; i < kL * Q4; i += blockDim.x) {
      const int r = i / Q4, c = 4 * (i % Q4);
      const bool ok = r < rows && c < cols;
      cp_async16(dst + at<LD, SW>(r, c),
                 ok ? src + row0 + (size_t)r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kL * COLS; i += blockDim.x) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + at<LD, SW>(r, c),
                ok ? src + row0 + (size_t)r * stride + c : src, ok);
    }
  }
}

// Blocks (c, b, 0): C B^T once per (b, chunk), the 64 x 64 tile's blocks
// of 16 x 32 that reach the diagonal or below it (warp w: rows 16 (w /
// 2).., columns 32 (w % 2)..), into cb (Bt, nc, L, L). Blocks (c, b, 1):
// every head's cumsum s over the chunk, one thread a head with its 64
// loads of dt in flight together, summed in order as fl(fl(s_{t-1}) +
// fl(dt_t A)) without contraction, into s (Bt, nc, L, H). The backward
// launches this kernel again, so both directions use the same s bitwise.
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
ssd_scan_prep_kernel(const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ cb,
                     float* __restrict__ s, int T, int H, int N) {
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int t0 = c * kL, Lc = min(kL, T - t0);
  const size_t bc = (size_t)b * nc + c;
  if (blockIdx.z == 1) {
    for (int hh = threadIdx.x; hh < H; hh += kThreads) {
      float d[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t)
        d[t] = t < Lc ? dt[((size_t)b * T + t0 + t) * H + hh] : 0.f;
      const float Ah = A[hh];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(d[t], Ah));
        s[(bc * kL + t) * H + hh] = acc;
      }
    }
    return;
  }
  constexpr int LD = NMAX + 4;  // both read along rows
  extern __shared__ __align__(16) float psm[];
  float* bs = psm;           // [L][N]
  float* cs = bs + kL * LD;  // [L][N]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp >> 1, half = warp & 1;
  const bool vec = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(Bm) |
                                   reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  stage_rows<NMAX, LD>(bs, Bm, ((size_t)b * T + t0) * N, N, Lc, N, vec);
  stage_rows<NMAX, LD>(cs, Cm, ((size_t)b * T + t0) * N, N, Lc, N, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (half == 1 && r < 2) return;  // wholly above the diagonal
  float acc[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < NMAX / 8; ++ks) {
    const Split<4> a = frag_a<LD>(cs, 16 * r, 8 * ks, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mma3(acc[q], a, frag_bt<LD>(bs, 32 * half + 8 * q, 8 * ks, lane));
  }
  const int g = lane >> 2, i4 = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* p = cb + (bc * kL + 16 * r + g) * kL + 32 * half + 8 * q + 2 * i4;
    *reinterpret_cast<float2*>(p) = make_float2(acc[q][0], acc[q][1]);
    *reinterpret_cast<float2*>(p + 8 * kL) = make_float2(acc[q][2], acc[q][3]);
  }
}

// dst (P x N, contiguous) = the state tile hs, 16 bytes a store when
// `vec` (N % 4 == 0, dst 16-byte aligned as P N % 4 == 0).
template <int LD>
__device__ __forceinline__ void store_state(float* __restrict__ dst,
                                            const float* hs, int P, int N,
                                            bool vec) {
  if (vec) {
    const int n4 = N / 4;
    for (int i = threadIdx.x; i < P * n4; i += blockDim.x) {
      const int p = i / n4, n = 4 * (i % n4);
      *reinterpret_cast<float4*>(dst + p * N + n) =
          *reinterpret_cast<const float4*>(hs + p * LD + n);
    }
  } else {
    for (int i = threadIdx.x; i < P * N; i += blockDim.x)
      dst[i] = hs[(i / N) * LD + i % N];
  }
}

// Four 8 x 4 f32 blocks of a row-major tile x by one ldmatrix (each f32 is
// two of its b16 elements): lane l gets x[m0 + l / 4 (+ 8)][k0 + l % 4 (+
// 4)] of rows m0..m0 + 15 and columns k0..k0 + 7, in the A fragment's
// order {a0, a1, a2, a3} = {(g, i), (g + 8, i), (g, i + 4), (g + 8, i + 4)};
// with `cols_first`, in the order {(g, i), (g, i + 4), (g + 8, i), (g + 8,
// i + 4)}: the B fragments {b0, b1} of x^T's n-tiles m0.. and m0 + 8...
// Each 8-row block reads 8 rows of 16 bytes: a row stride of 4 mod 32
// floats, or the swizzle (SW), puts them on 32 banks.
template <int LD, bool SW = false>
__device__ __forceinline__ void ldmatrix_a(float (&v)[4], const float* x,
                                           int m0, int k0, int lane,
                                           bool cols_first = false) {
  const int j = lane >> 3;  // the 8 x 4 block whose row this lane names
  const int hi_row = cols_first ? j >> 1 : j & 1;
  const int hi_col = cols_first ? j & 1 : j >> 1;
  const float* row =
      x + at<LD, SW>(m0 + (lane & 7) + 8 * hi_row, k0 + 4 * hi_col);
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(r[e]);
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// One block of 16 warps per (b, h), walking the chunks in order with the
// state h in shared memory. Per chunk: y = M x + (exp(s_t) C) h^T + D x
// (warp w: rows 16 (w / 4).., p columns 16 (w % 4)..; the 4 warps of a
// scheduler hold the 4 row blocks, so M x's triangle is shared evenly
// between the schedulers); then h = exp(total) h + x^T (w o B) (warp w: p
// rows 16 (w / 4).., n columns from (w % 4) NMAX / 4). Chunk c + 1's x, B,
// C B^T, s and dt load into a second buffer while chunk c computes its y;
// then every thread turns C B^T into M = C B^T o gate o dt_u in place,
// and w_u and exp(s_t) beside it, before chunk c's state update; chunk c +
// 1's C loads into the one buffer once chunk c's y is done with it.
template <int NMAX>
__global__ void __launch_bounds__(kFwdThreads, 1)
ssd_scan_fwd_scan_kernel(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ D,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ cb,
                         const float* __restrict__ sc, float* __restrict__ y,
                         float* __restrict__ fin, float* __restrict__ states,
                         int T, int H, int P, int N) {
  using F = FwdTiles<NMAX>;
  extern __shared__ __align__(16) float fsm[];
  float* hs = fsm;            // [P][N]  state
  float* cs = hs + F::kH;     // [L][N]
  float* early = cs + F::kC;  // two of: x [L][P], B [L][N], M [L][L], and
                              // s, dt, w, exp(s) [L] each

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i4 = lane & 3;
  const float Dh = D[h];
  const int nc = (T + kL - 1) / kL;
  const size_t bh = (size_t)b * H + h;
  const bool vec = P % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(Bm) |
                     reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;

  auto load_early = [&](int c) {
    const int t0 = c * kL, Lc = min(kL, T - t0);
    float* xs = early + (c & 1) * F::kEarly;
    stage_rows<kPMax, F::kLdX>(xs, x, (((size_t)b * T + t0) * H + h) * P,
                               H * P, Lc, P, vec);
    stage_rows<NMAX, F::kLdB>(xs + F::kX, Bm, ((size_t)b * T + t0) * N, N,
                              Lc, N, vec);
    // row t of C B^T as far as its row block's diagonal
    float* ms = xs + F::kX + F::kB;
    const float* src = cb + ((size_t)b * nc + c) * kL * kL;
    for (int i = threadIdx.x; i < kL * kL / 4; i += kFwdThreads) {
      const int t = i / (kL / 4), u = 4 * (i % (kL / 4));
      if (u < 16 * (t / 16 + 1))
        cp_async16(ms + t * F::kLdM + u, src + t * kL + u, true);
    }
    float* ss = ms + F::kM;
    if (threadIdx.x < kL)
      cp_async4(ss + threadIdx.x,
                sc + (((size_t)b * nc + c) * kL + threadIdx.x) * H + h, true);
    else if (threadIdx.x < 2 * kL) {
      const int t = threadIdx.x - kL;
      cp_async4(ss + kL + t,
                t < Lc ? dt + ((size_t)b * T + t0 + t) * H + h : dt, t < Lc);
    }
  };
  // M[t][u] = (C B^T)[t][u] exp(s_t - s_u) dt_u for u <= t, else 0, in
  // place, where its row block reaches; the gate is exponentiated only
  // where u <= t. Thread i takes column u = i % 64 of every eighth row.
  // Beside it w_u = exp(total - s_u) dt_u and exp(s_t).
  auto form_m = [&](int c) {
    float* ms = early + (c & 1) * F::kEarly + F::kX + F::kB;
    float* ss = ms + F::kM;
    const int u = threadIdx.x % kL;
    const float su = ss[u], du = ss[kL + u];
    for (int t = threadIdx.x / kL; t < kL; t += kFwdThreads / kL) {
      if (u < 16 * (t / 16 + 1)) {
        float* m = ms + t * F::kLdM + u;
        *m = u <= t ? *m * expf(ss[t] - su) * du : 0.f;
      }
    }
    if (threadIdx.x < kL) {
      ss[2 * kL + u] = expf(ss[kL - 1] - su) * du;
      ss[3 * kL + u] = expf(su);
    }
  };
  auto load_late = [&](int c) {
    const int t0 = c * kL, Lc = min(kL, T - t0);
    stage_rows<NMAX, F::kLdC>(cs, Cm, ((size_t)b * T + t0) * N, N, Lc, N, vec);
  };

  // y of row block R, p columns 16 (warp % 4)..
  auto y_part = [&](auto r_c, const float* xs, const float* ms,
                    const float* es, int t0, int Lc) {
    constexpr int R = decltype(r_c)::value;
    const int p0 = 16 * (warp & 3), ta = 16 * R + g;
    float acc[2][4] = {};
    // M x: M[t][u] = 0 for u > t, so row block R stops at k-slice 2 R + 1
#pragma unroll
    for (int ks = 0; ks < 2 * R + 2; ++ks) {
      float m[4];
      ldmatrix_a<F::kLdM>(m, ms, 16 * R, 8 * ks, lane);
      const Split<4> a = split(m);
      mma3(acc[0], a, frag_b<F::kLdX>(xs, p0, 8 * ks, lane));
      mma3(acc[1], a, frag_b<F::kLdX>(xs, p0 + 8, 8 * ks, lane));
    }
    // (exp(s_t) C) h^T
    const float ea = es[ta], eb = es[ta + 8];
#pragma unroll
    for (int ks = 0; ks < NMAX / 8; ++ks) {
      float v[4], hv[4];
      ldmatrix_a<F::kLdC>(v, cs, 16 * R, 8 * ks, lane);
      v[0] *= ea;
      v[1] *= eb;
      v[2] *= ea;
      v[3] *= eb;
      const Split<4> a = split(v);
      // h's B fragments of both n-tiles: {b0, b1} of p0.., then of p0 + 8..
      ldmatrix_a<F::kLdH>(hv, hs, p0, 8 * ks, lane, true);
      const float h0[2] = {hv[0], hv[1]}, h1[2] = {hv[2], hv[3]};
      mma3(acc[0], a, split(h0));
      mma3(acc[1], a, split(h1));
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int k = 0; k < 4; k += 2) {
        const int t = ta + (k < 2 ? 0 : 8), p = p0 + 8 * n + 2 * i4;
        if (t >= Lc || p >= P) continue;
        float* yp = y + (((size_t)b * T + t0 + t) * H + h) * P + p;
        const float* xp = xs + t * F::kLdX + p;
        const float y0 = acc[n][k] + Dh * xp[0];
        const float y1 = acc[n][k + 1] + Dh * xp[1];
        if (vec)  // P % 4 == 0: p + 1 < P, and the pair is 8-byte aligned
          *reinterpret_cast<float2*>(yp) = make_float2(y0, y1);
        else {
          yp[0] = y0;
          if (p + 1 < P) yp[1] = y1;
        }
      }
  };

  for (int i = threadIdx.x; i < F::kH; i += kFwdThreads) hs[i] = 0.f;
  load_early(0);
  load_late(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  form_m(0);

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kL;
    const int Lc = min(kL, T - t0);
    const float* xs = early + (c & 1) * F::kEarly;
    const float* bs = xs + F::kX;
    const float* ms = bs + F::kB;
    const float* ss = ms + F::kM;
    const float* ws = ss + 2 * kL;
    cp_async_wait_all();
    __syncthreads();  // chunk c's tiles and M are in; chunk c - 1 is done
    if (states)  // the state entering chunk c, for the backward
      store_state<F::kLdH>(states + (bh * nc + c) * (size_t)P * N, hs, P, N,
                           vec);
    if (c + 1 < nc) {
      load_early(c + 1);
      cp_async_commit();
    }

    // y[t][p] = sum_u M[t][u] x[u][p] + sum_n exp(s_t) C[t][n] h[p][n]
    //         + D x[t][p]
    switch (warp >> 2) {
      case 0: y_part(Int<0>(), xs, ms, ws + kL, t0, Lc); break;
      case 1: y_part(Int<1>(), xs, ms, ws + kL, t0, Lc); break;
      case 2: y_part(Int<2>(), xs, ms, ws + kL, t0, Lc); break;
      default: y_part(Int<3>(), xs, ms, ws + kL, t0, Lc);
    }
    cp_async_wait_all();
    __syncthreads();  // every read of the old state and C is done; chunk
                      // c + 1's x, B, C B^T, s and dt are in
    if (c + 1 < nc) {
      load_late(c + 1);
      cp_async_commit();
      form_m(c + 1);
    }

    // h[p][n] = exp(total) h[p][n] + sum_u x[u][p] w_u B[u][n]
    {
      constexpr int NQ = NMAX / 32;
      const int p0 = 16 * (warp >> 2), n0 = (warp & 3) * (NMAX / 4);
      const float dec = expf(ss[kL - 1]);
      float acc[NQ][4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float* hp = hs + (p0 + g) * F::kLdH + n0 + 8 * q + 2 * i4;
        const float2 h0 = *reinterpret_cast<const float2*>(hp);
        const float2 h1 = *reinterpret_cast<const float2*>(hp + 8 * F::kLdH);
        acc[q][0] = dec * h0.x;
        acc[q][1] = dec * h0.y;
        acc[q][2] = dec * h1.x;
        acc[q][3] = dec * h1.y;
      }
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
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float* hp = hs + (p0 + g) * F::kLdH + n0 + 8 * q + 2 * i4;
        *reinterpret_cast<float2*>(hp) = make_float2(acc[q][0], acc[q][1]);
        *reinterpret_cast<float2*>(hp + 8 * F::kLdH) =
            make_float2(acc[q][2], acc[q][3]);
      }
    }
  }
  __syncthreads();
  store_state<F::kLdH>(fin + bh * (size_t)P * N, hs, P, N, vec);
}

constexpr int kBwdThreads = 512;  // the backward's 16 warps

// A warp's 16 x 8 Q accumulator tiles, rows r0.. and columns n0.., into the
// rows [0, rows) and columns [0, cols) of a row-major dst of row stride
// cols, 8 bytes a store when `vec` (cols % 4 == 0, dst 16-byte aligned).
template <int Q>
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float (&acc)[Q][4], int r0,
                                           int n0, int rows, int cols,
                                           bool vec, int lane) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      const int r = r0 + (lane >> 2) + (k ? 8 : 0);
      const int n = n0 + 8 * q + 2 * (lane & 3);
      if (r >= rows || n >= cols) continue;
      float* o = dst + (size_t)r * cols + n;
      if (vec)  // n + 1 < cols, and the pair is 8-byte aligned
        *reinterpret_cast<float2*>(o) = make_float2(acc[q][k], acc[q][k + 1]);
      else {
        o[0] = acc[q][k];
        if (n + 1 < cols) o[1] = acc[q][k + 1];
      }
    }
}

// The backward's shared-memory tiles for state sizes N <= NMAX, every one
// swizzled (at<W, true>, W its width), and its vectors.
template <int NMAX>
struct BwdTiles {
  static constexpr int kPN = kPMax * NMAX, kLN = kL * NMAX, kLP = kL * kPMax,
                       kLL = kL * kL;
  // two of: s, dt, w, exp(s), the diagonal of dM o s1 [L] each and the
  // partial sums of dM o s1 by row and by column [4][L] each; the partial
  // sums dw and C (dy h0) [4][L] each; one float a warp
  static constexpr int kChunkVecs = 13 * kL;
  static constexpr int kVecs = 2 * kChunkVecs + 8 * kL + kBwdThreads / 32;
  // dh and h0; B and C; x and two of dy; C B^T (then s1) and dCB
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kPN + 2 * kLN + 3 * kLP + 2 * kLL + kVecs);
};

// One block of 16 warps per (b, h), walking the chunks in reverse from the
// saved chunk states, with dh (the gradient of the state leaving the
// chunk) in shared memory. C B^T and s come from the prep kernel's scratch.
// Per chunk, with s1 = C B^T o gate (u <= t) and dM = dy x^T:
//   1. dM (warps 0-9: the 16 x 16 blocks on and below the diagonal), s1 and
//      dCB = dM o gate o dt_u in place, the row and column sums of dM o s1;
//      w_u and exp(s_t) (warps 10-11);
//   2. dx = dt_u s1^T dy + w_u B dh^T + D dy, dw_u = sum_p x (B dh^T);
//   3. dB = (w o x) dh + dCB^T C;
//   4. dC = exp(s_t) dy h0 + dCB B, and sum_n C o (dy h0) for ds_t;
//   5. dh = exp(total) dh + (exp(s) o dy)^T C, and sum dh o h0;
//   6. one warp: ds_t, its reverse cumsum and ddt, by shuffles.
// Products 2-5: warp w takes row block 16 (w / 4).. and the quarter w % 4
// of the columns, so each scheduler holds all four row blocks of a
// triangle. Four barriers a chunk: before 1, 2, 3 and 5. Tiles load by
// cp.async as soon as their buffer is free, and each is waited for just
// before its first use: chunk c - 1's dy (two buffers), s and dt after 1,
// C B^T after 2, x and B after 4; chunk c's C and h0 at its top, while 1
// and 2 run. Step 6 of chunk c runs on warp 15 beside chunk c - 1's step 1,
// so the vectors of a chunk (s, dt, w, exp(s), the sums of 1) have two
// buffers, by the chunk's parity.
template <int NMAX>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_scan_bwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ states,
                    const float* __restrict__ dy,
                    const float* __restrict__ dfin,
                    const float* __restrict__ cb,
                    const float* __restrict__ sc, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dA_part,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dD_part, int T, int H, int P, int N) {
  using G = BwdTiles<NMAX>;
  constexpr int NQ = NMAX / 32;  // n-tiles of a warp's quarter of N
  // product loops unrolled twice at NMAX 64, not at all at NMAX 128, where
  // more in flight spills registers
  constexpr int kUnroll = NMAX == 128 ? 1 : 2;
  extern __shared__ __align__(16) float bsm[];
  float* dhs = bsm;              // [P][N] dh
  float* h0s = dhs + G::kPN;     // [P][N] the state entering the chunk
  float* bs = h0s + G::kPN;      // [L][N]
  float* cs = bs + G::kLN;       // [L][N]
  float* xs = cs + G::kLN;       // [L][P]
  float* dys = xs + G::kLP;      // two of [L][P]
  float* s1 = dys + 2 * G::kLP;  // [L][L] C B^T, then s1
  float* dcb = s1 + G::kLL;      // [L][L] dCB
  float* vs = dcb + G::kLL;      // two of G::kChunkVecs, by chunk parity
  float* dwp = vs + 2 * G::kChunkVecs;  // [4][L] dw_u, by quarter of P
  float* dsp = dwp + 4 * kL;     // [4][L] sum_n C (dy h0), by quarter of N
  float* red = dsp + 4 * kL;     // [16] sum dh o h0, by warp
  // chunk c's vectors: s, dt, w_u = exp(total - s_u) dt_u, exp(s_t), the
  // diagonal (dM o s1)[u][u], then [4][L] each: sum_{u < t} (dM o s1)
  // dt_u by block of u, sum_{t > u} (dM o s1) by block of t
  auto vec_of = [&](int c) { return vs + (c & 1) * G::kChunkVecs; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, i4 = lane & 3;
  const float Ah = A[h], Dh = D[h];
  const int nc = (T + kL - 1) / kL;
  const size_t bh = (size_t)b * H + h;
  const bool vec = P % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(dy) |
                     reinterpret_cast<uintptr_t>(Bm) |
                     reinterpret_cast<uintptr_t>(Cm) |
                     reinterpret_cast<uintptr_t>(states)) & 15) == 0;

  auto xrow = [&](int c) { return (((size_t)b * T + c * kL) * H + h) * P; };
  auto nrow = [&](int c) { return ((size_t)b * T + c * kL) * N; };
  auto rows = [&](int c) { return min(kL, T - c * kL); };
  auto load_dy = [&](int c) {  // dy, s and dt, into buffer c % 2
    stage_rows<kPMax, kPMax, true>(dys + (c & 1) * G::kLP, dy, xrow(c), H * P,
                                   rows(c), P, vec);
    float* v = vec_of(c);
    if (threadIdx.x < kL)
      cp_async4(v + threadIdx.x,
                sc + (((size_t)b * nc + c) * kL + threadIdx.x) * H + h, true);
    else if (threadIdx.x < 2 * kL) {
      const int t = threadIdx.x - kL;
      const bool ok = t < rows(c);
      cp_async4(v + kL + t, ok ? dt + ((size_t)b * T + c * kL + t) * H + h : dt,
                ok);
    }
  };
  auto load_cb = [&](int c) {  // C B^T as far as each row block's diagonal
    const float* src = cb + ((size_t)b * nc + c) * kL * kL;
    for (int i = threadIdx.x; i < kL * kL / 4; i += kBwdThreads) {
      const int t = i / (kL / 4), u = 4 * (i % (kL / 4));
      if (u < 16 * (t / 16 + 1))
        cp_async16(s1 + at<kL, true>(t, u), src + t * kL + u, true);
    }
  };
  auto load_x = [&](int c) {
    stage_rows<kPMax, kPMax, true>(xs, x, xrow(c), H * P, rows(c), P, vec);
  };
  auto load_b = [&](int c) {
    stage_rows<NMAX, NMAX, true>(bs, Bm, nrow(c), N, rows(c), N, vec);
  };
  auto load_ch = [&](int c) {
    stage_rows<NMAX, NMAX, true>(cs, Cm, nrow(c), N, rows(c), N, vec);
    stage_rows<NMAX, NMAX, true>(h0s, states, (bh * nc + c) * (size_t)P * N, N,
                                 P, N, vec);
  };
  for (int i = threadIdx.x; i < G::kPN; i += kBwdThreads) {
    const int p = i / NMAX, n = i % NMAX;
    dhs[at<NMAX, true>(p, n)] =
        (dfin && p < P && n < N) ? dfin[(bh * P + p) * N + n] : 0.f;
  }
  load_dy(nc - 1);
  load_cb(nc - 1);
  load_x(nc - 1);
  cp_async_commit();
  load_b(nc - 1);
  cp_async_commit();
  float dA_acc = 0.f, dD_acc = 0.f;
  // 6. chunk c's scalars: ds_t, its reverse cumsum da_t, ddt_t; lane l
  // takes t = 2 l, 2 l + 1. total = s_{Lc-1}, so w_{Lc-1} = dt_{Lc-1} does
  // not depend on s: its +dw w (through total) and -dw w (through s_{Lc-1})
  // are both left out. One warp, beside chunk c - 1's step 1.
  auto scalars = [&](int c) {
    const int t0 = c * kL, Lc = rows(c);
    const float* sv = vec_of(c);
    const float *dtv = sv + kL, *ws = sv + 2 * kL, *es = sv + 3 * kL,
                *dg = sv + 4 * kL, *rowp = sv + 5 * kL, *colp = sv + 9 * kL;
    const float total = sv[kL - 1];
    float dth = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) dth += red[w];
    float ds[2], ddtm[2], dwv[2], dwt = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = 2 * lane + j;
      float rowe = 0.f, cole = 0.f, dw = 0.f, cg = 0.f;
      for (int k = 0; k <= t / 16; ++k) rowe += rowp[k * kL + t];
      for (int k = t / 16; k < 4; ++k) cole += colp[k * kL + t];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dw += dwp[k * kL + t];
        cg += dsp[k * kL + t];
      }
      dwv[j] = dw;
      ddtm[j] = dg[t] + cole;
      ds[j] = rowe - cole * dtv[t] + es[t] * cg;
      if (t < Lc - 1) {
        ds[j] -= dw * ws[t];
        dwt += dw * ws[t];
      }
    }
    const float dtot = expf(total) * dth + warp_sum(dwt);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (2 * lane + j == Lc - 1) ds[j] += dtot;
    // da_t = sum_{tau >= t} ds_tau: a suffix scan over the lanes' pairs
    float suf = ds[0] + ds[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += v;
    }
    const float later = __shfl_down_sync(0xffffffffu, suf, 1);
    float da[2];
    da[1] = ds[1] + (lane < 31 ? later : 0.f);
    da[0] = ds[0] + da[1];
    float dAc = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = 2 * lane + j;
      if (t < Lc)
        ddt[((size_t)b * T + t0 + t) * H + h] =
            ddtm[j] + dwv[j] * expf(total - sv[t]) + da[j] * Ah;
      dAc += da[j] * dtv[t];
    }
    dA_acc += warp_sum(dAc);
  };

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kL, Lc = rows(c);
    const float* dyc = dys + (c & 1) * G::kLP;
    float* sv = vec_of(c);  // s, then dt, w, exp(s), ...
    const float* dtv = sv + kL;
    float *ws = sv + 2 * kL, *es = sv + 3 * kL, *dg = sv + 4 * kL,
          *rowp = sv + 5 * kL, *colp = sv + 9 * kL;
    cp_async_wait<1>();  // chunk c's dy, s, dt, C B^T and x are in
    __syncthreads();     // and chunk c + 1's steps 2-5 are done
    load_ch(c);
    cp_async_commit();

    // 1. dM[t][u] = dy_t . x_u on the 16 x 16 blocks (R, Cb <= R), and per
    // element u <= t: gate = exp(s_t - s_u), s1 = C B^T gate, dCB = dM gate
    // dt_u, e = dM s1. ddt takes the column sums of e through M's dt_u
    // factor, and ds the parts of both sums through the gate. The gate's
    // diagonal (u = t) is exp(s_t - s_t): it adds e[t][t] to ds_t and takes
    // it away again, so both sums leave it out rather than cancel it in
    // rounding (beside O(1) diagonal terms the others can be e^-10 smaller).
    if (warp < 10) {
      const int R = warp < 1 ? 0 : warp < 3 ? 1 : warp < 6 ? 2 : 3;
      const int Cb = warp - R * (R + 1) / 2;
      float acc[2][4] = {};
#pragma unroll (kUnroll)
      for (int ks = 0; ks < kPMax / 8; ++ks) {
        float a[4], xv[4];
        ldmatrix_a<kPMax, true>(a, dyc, 16 * R, 8 * ks, lane);
        // x's B fragments of both n-tiles: {b0, b1} of u 16 Cb.., then + 8
        ldmatrix_a<kPMax, true>(xv, xs, 16 * Cb, 8 * ks, lane, true);
        const Split<4> sa = split(a);
        const float x0[2] = {xv[0], xv[1]}, x1[2] = {xv[2], xv[3]};
        mma3(acc[0], sa, split(x0));
        mma3(acc[1], sa, split(x1));
      }
      float rs[2] = {0.f, 0.f};             // rows g, g + 8
      float cols[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // columns 8 q + 2 i4 + j
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = 16 * R + g + (k >> 1) * 8;
          const int u = 16 * Cb + 8 * q + 2 * i4 + (k & 1);
          float* cbp = s1 + at<kL, true>(t, u);
          float sv1 = 0.f, dcv = 0.f, e = 0.f;
          if (u <= t) {
            const float gate = expf(sv[t] - sv[u]);
            sv1 = *cbp * gate;
            dcv = acc[q][k] * (gate * dtv[u]);
            e = acc[q][k] * sv1;
          }
          *cbp = sv1;
          dcb[at<kL, true>(t, u)] = dcv;
          if (u == t)
            dg[u] = e;
          else {  // e = 0 above the diagonal
            rs[k >> 1] += e * dtv[u];
            cols[q][k & 1] += e;
          }
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            cols[q][j] += __shfl_xor_sync(0xffffffffu, cols[q][j], off);
      if (i4 == 0) {
        rowp[Cb * kL + 16 * R + g] = rs[0];
        rowp[Cb * kL + 16 * R + g + 8] = rs[1];
      }
      if (g == 0)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            colp[R * kL + 16 * Cb + 8 * q + 2 * i4 + j] = cols[q][j];
    } else if (threadIdx.x < 320 + kL) {
      const int u = threadIdx.x - 320;
      ws[u] = expf(sv[kL - 1] - sv[u]) * dtv[u];
      es[u] = expf(sv[u]);
    } else if (warp == 15 && c + 1 < nc) {
      scalars(c + 1);
    }
    cp_async_wait<1>();  // chunk c's B is in
    __syncthreads();     // s1, dCB, w, exp(s) and the sums of 1 are in;
                         // chunk c + 1's scalars are done with its buffers
    if (c > 0) load_dy(c - 1);
    cp_async_commit();

    // 2. dx[u][p] = dt_u sum_{t >= u} s1[t][u] dy[t][p] + w_u r[u][p] + D
    // dy[u][p], r = B dh^T; dw_u = sum_p x[u][p] r[u][p] (warp w: u rows 16
    // (w / 4).., p columns 16 (w % 4)..)
    auto dx_part = [&](auto u_c) {
      constexpr int U = decltype(u_c)::value;
      const int u0 = 16 * U, p0 = 16 * (warp & 3);
      float da[2][4] = {}, dr[2][4] = {};
      // s1[t][u] = 0 for t < u: from k-slice 2 U
#pragma unroll (kUnroll)
      for (int ks = 2 * U; ks < kL / 8; ++ks) {
        float a[4];
        frag_at<kL, true>(a, s1, u0, 8 * ks, lane);
        const Split<4> sa = split(a);
        mma3(da[0], sa, frag_b<kPMax, true>(dyc, p0, 8 * ks, lane));
        mma3(da[1], sa, frag_b<kPMax, true>(dyc, p0 + 8, 8 * ks, lane));
      }
#pragma unroll (kUnroll)
      for (int ks = 0; ks < NMAX / 8; ++ks) {
        float a[4], hv[4];
        ldmatrix_a<NMAX, true>(a, bs, u0, 8 * ks, lane);
        // dh's B fragments of both n-tiles: {b0, b1} of p0.., then p0 + 8..
        ldmatrix_a<NMAX, true>(hv, dhs, p0, 8 * ks, lane, true);
        const Split<4> sa = split(a);
        const float h0v[2] = {hv[0], hv[1]}, h1v[2] = {hv[2], hv[3]};
        mma3(dr[0], sa, split(h0v));
        mma3(dr[1], sa, split(h1v));
      }
      float dw[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int k = 0; k < 4; k += 2) {
          const int u = u0 + g + (k ? 8 : 0), p = p0 + 8 * n + 2 * i4;
          const float2 xv =
              *reinterpret_cast<const float2*>(xs + at<kPMax, true>(u, p));
          const float2 dv =
              *reinterpret_cast<const float2*>(dyc + at<kPMax, true>(u, p));
          dw[k >> 1] += xv.x * dr[n][k] + xv.y * dr[n][k + 1];
          dD_acc += dv.x * xv.x + dv.y * xv.y;
          const float dtu = dtv[u], wu = ws[u];
          const float d0 = dtu * da[n][k] + wu * dr[n][k] + Dh * dv.x;
          const float d1 = dtu * da[n][k + 1] + wu * dr[n][k + 1] + Dh * dv.y;
          if (u >= Lc || p >= P) continue;
          float* o = dx + xrow(c) + (size_t)u * H * P + p;
          if (vec)  // P % 4 == 0: p + 1 < P, and the pair is 8-byte aligned
            *reinterpret_cast<float2*>(o) = make_float2(d0, d1);
          else {
            o[0] = d0;
            if (p + 1 < P) o[1] = d1;
          }
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        dw[j] += __shfl_xor_sync(0xffffffffu, dw[j], 1);
        dw[j] += __shfl_xor_sync(0xffffffffu, dw[j], 2);
      }
      if (i4 == 0) {
        dwp[(warp & 3) * kL + u0 + g] = dw[0];
        dwp[(warp & 3) * kL + u0 + g + 8] = dw[1];
      }
    };
    switch (warp >> 2) {
      case 0: dx_part(Int<0>()); break;
      case 1: dx_part(Int<1>()); break;
      case 2: dx_part(Int<2>()); break;
      default: dx_part(Int<3>());
    }
    cp_async_wait<1>();  // chunk c's C and h0 are in
    __syncthreads();     // every read of s1 is done
    if (c > 0) load_cb(c - 1);
    cp_async_commit();

    // 3. dB[u][n] = w_u sum_p x[u][p] dh[p][n] + sum_{t >= u} dCB[t][u]
    // C[t][n] (warp w: u rows 16 (w / 4).., n columns from (w % 4) NMAX / 4)
    auto db_part = [&](auto u_c) {
      constexpr int U = decltype(u_c)::value;
      const int u0 = 16 * U, n0 = (warp & 3) * (NMAX / 4);
      const float wa = ws[u0 + g], wb = ws[u0 + g + 8];
      float acc[NQ][4] = {};
#pragma unroll (kUnroll)
      for (int ks = 0; ks < kPMax / 8; ++ks) {
        float a[4];
        ldmatrix_a<kPMax, true>(a, xs, u0, 8 * ks, lane);
        a[0] *= wa;
        a[1] *= wb;
        a[2] *= wa;
        a[3] *= wb;
        const Split<4> sa = split(a);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma3(acc[q], sa, frag_b<NMAX, true>(dhs, n0 + 8 * q, 8 * ks, lane));
      }
#pragma unroll (kUnroll)
      for (int ks = 2 * U; ks < kL / 8; ++ks) {
        float a[4];
        frag_at<kL, true>(a, dcb, u0, 8 * ks, lane);
        const Split<4> sa = split(a);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma3(acc[q], sa, frag_b<NMAX, true>(cs, n0 + 8 * q, 8 * ks, lane));
      }
      store_tile(dB_part + (bh * T + t0) * N, acc, u0, n0, Lc, N, vec, lane);
    };
    switch (warp >> 2) {
      case 0: db_part(Int<0>()); break;
      case 1: db_part(Int<1>()); break;
      case 2: db_part(Int<2>()); break;
      default: db_part(Int<3>());
    }

    // 4. dC[t][n] = exp(s_t) gq[t][n] + sum_{u <= t} dCB[t][u] B[u][n], gq =
    // dy h0; ds_t takes exp(s_t) sum_n C[t][n] gq[t][n] (warp w: t rows 16
    // (w / 4).., n columns from (w % 4) NMAX / 4)
    auto dc_part = [&](auto r_c) {
      constexpr int R = decltype(r_c)::value;
      const int r0 = 16 * R, n0 = (warp & 3) * (NMAX / 4);
      float acc[NQ][4] = {};
#pragma unroll (kUnroll)
      for (int ks = 0; ks < kPMax / 8; ++ks) {
        float a[4];
        ldmatrix_a<kPMax, true>(a, dyc, r0, 8 * ks, lane);
        const Split<4> sa = split(a);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma3(acc[q], sa, frag_b<NMAX, true>(h0s, n0 + 8 * q, 8 * ks, lane));
      }
      const float ea = es[r0 + g], eb = es[r0 + g + 8];
      float cg[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = n0 + 8 * q + 2 * i4;
        const float2 c0 =
            *reinterpret_cast<const float2*>(cs + at<NMAX, true>(r0 + g, n));
        const float2 c1 = *reinterpret_cast<const float2*>(
            cs + at<NMAX, true>(r0 + g + 8, n));
        cg[0] += c0.x * acc[q][0] + c0.y * acc[q][1];
        cg[1] += c1.x * acc[q][2] + c1.y * acc[q][3];
        acc[q][0] *= ea;
        acc[q][1] *= ea;
        acc[q][2] *= eb;
        acc[q][3] *= eb;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        cg[j] += __shfl_xor_sync(0xffffffffu, cg[j], 1);
        cg[j] += __shfl_xor_sync(0xffffffffu, cg[j], 2);
      }
      if (i4 == 0) {
        dsp[(warp & 3) * kL + r0 + g] = cg[0];
        dsp[(warp & 3) * kL + r0 + g + 8] = cg[1];
      }
      // dCB[t][u] = 0 for u > t: row block R stops at k-slice 2 R + 1
#pragma unroll (kUnroll)
      for (int ku = 0; ku < 2 * R + 2; ++ku) {
        float a[4];
        ldmatrix_a<kL, true>(a, dcb, r0, 8 * ku, lane);
        const Split<4> sa = split(a);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma3(acc[q], sa, frag_b<NMAX, true>(bs, n0 + 8 * q, 8 * ku, lane));
      }
      store_tile(dC_part + (bh * T + t0) * N, acc, r0, n0, Lc, N, vec, lane);
    };
    switch (warp >> 2) {
      case 0: dc_part(Int<0>()); break;
      case 1: dc_part(Int<1>()); break;
      case 2: dc_part(Int<2>()); break;
      default: dc_part(Int<3>());
    }
    __syncthreads();  // every read of x, B and the old dh is done
    if (c > 0) load_x(c - 1);
    cp_async_commit();
    if (c > 0) load_b(c - 1);
    cp_async_commit();

    // 5. dh[p][n] := exp(total) dh[p][n] + sum_t exp(s_t) dy[t][p] C[t][n],
    // and sum dh o h0 with the old dh (warp w: p rows 16 (w / 4).., n
    // columns from (w % 4) NMAX / 4; each warp reads only its own dh)
    {
      const int p0 = 16 * (warp >> 2), n0 = (warp & 3) * (NMAX / 4);
      const float dec = expf(sv[kL - 1]);
      float acc[NQ][4];
      float dth = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = n0 + 8 * q + 2 * i4;
        const int o0 = at<NMAX, true>(p0 + g, n);
        const int o1 = at<NMAX, true>(p0 + g + 8, n);
        const float2 d0 = *reinterpret_cast<const float2*>(dhs + o0);
        const float2 d1 = *reinterpret_cast<const float2*>(dhs + o1);
        const float2 k0 = *reinterpret_cast<const float2*>(h0s + o0);
        const float2 k1 = *reinterpret_cast<const float2*>(h0s + o1);
        dth += d0.x * k0.x + d0.y * k0.y + d1.x * k1.x + d1.y * k1.y;
        acc[q][0] = dec * d0.x;
        acc[q][1] = dec * d0.y;
        acc[q][2] = dec * d1.x;
        acc[q][3] = dec * d1.y;
      }
#pragma unroll (kUnroll)
      for (int ks = 0; ks < kL / 8; ++ks) {
        float a[4];
        frag_at<kPMax, true>(a, dyc, p0, 8 * ks, lane);
        const float e0 = es[8 * ks + i4], e1 = es[8 * ks + i4 + 4];
        a[0] *= e0;
        a[1] *= e0;
        a[2] *= e1;
        a[3] *= e1;
        const Split<4> sa = split(a);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma3(acc[q], sa, frag_b<NMAX, true>(cs, n0 + 8 * q, 8 * ks, lane));
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = n0 + 8 * q + 2 * i4;
        *reinterpret_cast<float2*>(dhs + at<NMAX, true>(p0 + g, n)) =
            make_float2(acc[q][0], acc[q][1]);
        *reinterpret_cast<float2*>(dhs + at<NMAX, true>(p0 + g + 8, n)) =
            make_float2(acc[q][2], acc[q][3]);
      }
      dth = warp_sum(dth);
      if (lane == 0) red[warp] = dth;
    }
  }
  __syncthreads();
  if (warp == 15) scalars(0);
  dD_acc = warp_sum(dD_acc);
  __syncthreads();  // warp 15 is done with red
  if (lane == 0) red[warp] = dD_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) s += red[w];
    dD_part[bh] = s;
  }
  if (threadIdx.x == kBwdThreads - 32) dA_part[bh] = dA_acc;
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int NMAX>
int launch_fwd(const float* x, const float* dt, const float* A, const float* B,
               const float* C, const float* D, float* y, float* fin,
               float* states, float* scratch, int Bt, int T, int H, int P,
               int N, cudaStream_t stream) {
  using F = FwdTiles<NMAX>;
  static const int attr =
      set_smem((const void*)ssd_scan_prep_kernel<NMAX>, F::kPrepSmem) |
      set_smem((const void*)ssd_scan_fwd_scan_kernel<NMAX>, F::kSmem);
  if (attr) return attr;
  const int nc = (T + kL - 1) / kL;
  float* cb = scratch;                              // (Bt, nc, L, L)
  float* s = scratch + (size_t)Bt * nc * kL * kL;   // (Bt, nc, L, H)
  ssd_scan_prep_kernel<NMAX><<<dim3(nc, Bt, 2), kThreads, F::kPrepSmem,
                               stream>>>(dt, A, B, C, cb, s, T, H, N);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ssd_scan_fwd_scan_kernel<NMAX><<<dim3(H, Bt), kFwdThreads, F::kSmem,
                                   stream>>>(
      x, dt, D, B, C, cb, s, y, fin, states, T, H, P, N);
  return (int)cudaGetLastError();
}

template <int NMAX>
int launch_bwd(const float* x, const float* dt, const float* A, const float* B,
               const float* C, const float* D, const float* states,
               const float* dy, const float* dfin, float* dx, float* ddt,
               float* dA_part, float* dB_part, float* dC_part, float* dD_part,
               float* scratch, int Bt, int T, int H, int P, int N,
               cudaStream_t stream) {
  using F = FwdTiles<NMAX>;
  using G = BwdTiles<NMAX>;
  static const int attr =
      set_smem((const void*)ssd_scan_prep_kernel<NMAX>, F::kPrepSmem) |
      set_smem((const void*)ssd_scan_bwd_kernel<NMAX>, G::kSmem);
  if (attr) return attr;
  const int nc = (T + kL - 1) / kL;
  float* cb = scratch;                              // (Bt, nc, L, L)
  float* s = scratch + (size_t)Bt * nc * kL * kL;   // (Bt, nc, L, H)
  ssd_scan_prep_kernel<NMAX><<<dim3(nc, Bt, 2), kThreads, F::kPrepSmem,
                               stream>>>(dt, A, B, C, cb, s, T, H, N);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ssd_scan_bwd_kernel<NMAX><<<dim3(H, Bt), kBwdThreads, G::kSmem, stream>>>(
      x, dt, A, B, C, D, states, dy, dfin, cb, s, dx, ddt, dA_part, dB_part,
      dC_part, dD_part, T, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_chunk() { return kL; }
extern "C" int ssd_scan_max_p() { return kPMax; }
extern "C" int ssd_scan_max_n() { return kNMax; }

// The prep kernel's scratch, in floats, for either direction: C B^T for
// each (b, chunk) and every head's cumsum, (Bt, ceil(T/64), 64, 64 + H).
extern "C" long long ssd_scan_fwd_scratch_floats(int Bt, int T, int H) {
  return (long long)Bt * ((T + kL - 1) / kL) * kL * (kL + H);
}

// Forward: x (Bt,T,H,P), dt (Bt,T,H), A, D (H), B, C (Bt,T,N) float32
// contiguous -> y (Bt,T,H,P), fin (Bt,H,P,N) and, when `states` is not
// null, the state entering each chunk (Bt,H,ceil(T/64),P,N). `scratch`
// holds ssd_scan_fwd_scratch_floats(Bt, T, H) floats. Returns the
// cudaError_t of the launches.
extern "C" int ssd_scan_fwd_f32(const float* x, const float* dt,
                                const float* A, const float* B,
                                const float* C, const float* D, float* y,
                                float* fin, float* states, float* scratch,
                                int Bt, int T, int H, int P, int N,
                                void* stream) {
  if (Bt <= 0 || H <= 0 || T <= 0) return 0;
  return N <= 64 ? launch_fwd<64>(x, dt, A, B, C, D, y, fin, states, scratch,
                                  Bt, T, H, P, N, (cudaStream_t)stream)
                 : launch_fwd<128>(x, dt, A, B, C, D, y, fin, states, scratch,
                                   Bt, T, H, P, N, (cudaStream_t)stream);
}

// Backward: the forward's inputs, its chunk states, dy (Bt,T,H,P) and dfin
// (Bt,H,P,N; null = zero) -> dx (Bt,T,H,P), ddt (Bt,T,H), and the partials
// dA_part, dD_part (Bt,H), dB_part, dC_part (Bt,H,T,N) that the caller sums.
// `scratch` holds ssd_scan_fwd_scratch_floats(Bt, T, H) floats, for the
// prep kernel's C B^T and cumsums. Returns the cudaError_t of the launches.
extern "C" int ssd_scan_bwd_f32(const float* x, const float* dt,
                                const float* A, const float* B,
                                const float* C, const float* D,
                                const float* states, const float* dy,
                                const float* dfin, float* dx, float* ddt,
                                float* dA_part, float* dB_part,
                                float* dC_part, float* dD_part,
                                float* scratch, int Bt, int T, int H, int P,
                                int N, void* stream) {
  if (Bt <= 0 || H <= 0 || T <= 0) return 0;
  return N <= 64
             ? launch_bwd<64>(x, dt, A, B, C, D, states, dy, dfin, dx, ddt,
                              dA_part, dB_part, dC_part, dD_part, scratch, Bt,
                              T, H, P, N, (cudaStream_t)stream)
             : launch_bwd<128>(x, dt, A, B, C, D, states, dy, dfin, dx, ddt,
                               dA_part, dB_part, dC_part, dD_part, scratch,
                               Bt, T, H, P, N, (cudaStream_t)stream);
}
