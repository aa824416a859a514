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
// every head's cumsum s, one thread a head in the backward's order (so both
// directions agree on s bitwise), into (Bt, nc, 64, H): 1.5 MB at the LM
// path's shape, 2.9 MB at the hybrid path's, read back from L2. The scan
// kernel is a block of 16 warps per (b, h). Per chunk: y = M x + (exp(s_t)
// C) h^T + D x, warp w taking rows 16 (w / 4).. and p columns 16 (w %
// 4).., so each scheduler's 4 warps hold the 4 row blocks of M x's
// triangle; then h = exp(total) h + x^T (w o B), warp w taking p rows 16
// (w / 4).. and n columns from (w % 4) N / 4. Chunk c + 1's x, C B^T, s,
// dt and B load by 16-byte cp.async into a second buffer while chunk c
// computes its y; after y, every thread turns C B^T into M = C B^T o gate
// o dt_u in place (each gate once), with w_u and exp(s_t) beside it, and
// chunk c + 1's C loads into the one C buffer. Tiles read along rows (C,
// M, h) have a row stride of 4 mod 32 and are read by ldmatrix; tiles
// read down columns (x, B), 8 mod 32: no bank conflicts. Templated on NMAX
// = 64 or 128 (N <= NMAX): shared memory 144,384 B and 209,920 B a scan
// block, so one block an SM; 124 and 109 registers a thread (at most 128
// for 16 warps), the prep kernel 254, no spills (nvcc -Xptxas -v, sm_90a,
// CUDA 12.8). No atomics: the forward is bitwise reproducible. It saves
// the state entering each chunk, (Bt, H, nc, P, N), when the caller asks
// for it. ablations/ssd_fwd.py times it against copies with one of
// its parts undone.
//
// Backward: one block of 256 threads per (b, h) reads the saved states
// and runs the chunks in reverse, carrying dh (P x N) in shared memory, so
// it never redoes the recurrence. It returns dx, ddt, and per-(b, h)
// partials of dA and dD and per-head partials of dB and dC (Bt, H, T, N):
// B and C are shared across heads, and the caller sums the partials over
// heads in a fixed order, so the result does not depend on the order in
// which blocks run. Every matrix product is written as: each warp owns
// whole rows of the output (its operand is read at one address by all
// lanes, a broadcast), and the lanes own consecutive columns. Every
// shared-memory matrix has an odd row stride (cols + 1), so a column read
// by consecutive lanes hits consecutive banks whichever index runs along
// the lanes. It does not use tensor cores.
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
// needs about 9.8 GFLOP, 0.15 ms at 67 TFLOP/s without tensor cores: dC
// and dB once on the head-summed dCB, so it is bound by operations; it
// does more (dB and dC per head, 5.9 and 13 GFLOP in all), reading its
// operands from shared memory with register tiles of up to 8 x 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;         // chunk length
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPMax = 64;      // head dim P <= 64
constexpr int kNMax = 128;     // state size N <= 128
constexpr int kLdP = kPMax + 1;
constexpr int kLdN = kNMax + 1;
constexpr int kLdL = kL + 1;
constexpr int kRowsL = kL / kWarps;     // output rows per warp: L rows
constexpr int kRowsP = kPMax / kWarps;  // output rows per warp: P rows
constexpr int kColsL = kL / 32;         // columns per lane: L columns
constexpr int kColsP = kPMax / 32;      // columns per lane: P columns
constexpr int kColsN = kNMax / 32;      // columns per lane: N columns
constexpr int kVec = 16;                // per-chunk vectors of length L

constexpr size_t kBwdSmem =
    sizeof(float) * (2 * kPMax * kLdN + 2 * kL * kLdP + 2 * kL * kLdN +
                     2 * kL * kLdL + kVec * kL + kWarps);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the result. `red` holds kWarps
// floats; the block synchronises inside.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Stage one chunk of x (or dy) as [t][p], and B, C as [t][n], zero-padded
// beyond the chunk's Lc rows and beyond P, N columns.
__device__ void load_xp(const float* __restrict__ src, float* dst, size_t row0,
                        int row_stride, int Lc, int P) {
  for (int i = threadIdx.x; i < kL * kPMax; i += kThreads) {
    const int t = i / kPMax, p = i % kPMax;
    dst[t * kLdP + p] =
        (t < Lc && p < P) ? src[row0 + (size_t)t * row_stride + p] : 0.f;
  }
}

__device__ void load_bc(const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* bs, float* cs,
                        size_t row0, int Lc, int N) {
  for (int i = threadIdx.x; i < kL * kNMax; i += kThreads) {
    const int t = i / kNMax, n = i % kNMax;
    float bv = 0.f, cv = 0.f;
    if (t < Lc && n < N) {
      const size_t o = row0 + (size_t)t * N + n;
      bv = Bm[o];
      cv = Cm[o];
    }
    bs[t * kLdN + n] = bv;
    cs[t * kLdN + n] = cv;
  }
}

// s_t = cumsum(dt_t * A) over the chunk, in order, rounded as
// fl(fl(s_{t-1}) + fl(dt_t * A)) without contraction. Thread 0 only.
__device__ void chunk_cumsum(const float* dts, float* ss, float Ah) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = 0; t < kL; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(dts[t], Ah));
      ss[t] = acc;
    }
  }
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

// B fragment of a row-major x[k][n]
template <int LD>
__device__ __forceinline__ Split<2> frag_b(const float* x, int n0, int k0,
                                           int lane) {
  const float* p = x + (k0 + (lane & 3)) * LD + n0 + (lane >> 2);
  const float v[2] = {p[0], p[4 * LD]};
  return split(v);
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
// [kL][COLS] tile of row stride LD, by cp.async: 16 bytes a copy when
// `vec` (cols % 4 == 0 and the rows 16-byte aligned), else 4. The caller
// commits and waits.
template <int COLS, int LD>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           size_t row0, int stride, int rows,
                                           int cols, bool vec) {
  if (vec) {
    constexpr int Q4 = COLS / 4;
    for (int i = threadIdx.x; i < kL * Q4; i += blockDim.x) {
      const int r = i / Q4, c = 4 * (i % Q4);
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * LD + c, ok ? src + row0 + (size_t)r * stride + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kL * COLS; i += blockDim.x) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * LD + c, ok ? src + row0 + (size_t)r * stride + c : src,
                ok);
    }
  }
}

// Blocks (c, b, 0): C B^T once per (b, chunk), the 64 x 64 tile's blocks
// of 16 x 32 that reach the diagonal or below it (warp w: rows 16 (w /
// 2).., columns 32 (w % 2)..), into cb (Bt, nc, L, L). Blocks (c, b, 1):
// every head's cumsum s over the chunk, one thread a head with its 64
// loads of dt in flight together, in chunk_cumsum's order, so that the
// backward's s is the same bitwise, into s (Bt, nc, L, H).
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
ssd_scan_fwd_prep_kernel(const float* __restrict__ dt,
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
// floats puts them on 32 banks.
template <int LD>
__device__ __forceinline__ void ldmatrix_a(float (&v)[4], const float* x,
                                           int m0, int k0, int lane,
                                           bool cols_first = false) {
  const int j = lane >> 3;  // the 8 x 4 block whose row this lane names
  const int hi_row = cols_first ? j >> 1 : j & 1;
  const int hi_col = cols_first ? j & 1 : j >> 1;
  const float* row = x + (m0 + (lane & 7) + 8 * hi_row) * LD + k0 + 4 * hi_col;
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

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ states,
                    const float* __restrict__ dy,
                    const float* __restrict__ dfin, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dA_part,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dD_part, int T, int H, int P,
                    int N) {
  extern __shared__ float sm[];
  float* h0 = sm;                   // [P][N]  state entering the chunk
  float* dh = h0 + kPMax * kLdN;    // [P][N]  gradient of the state leaving it
  float* xs = dh + kPMax * kLdN;    // [L][P]
  float* dys = xs + kL * kLdP;      // [L][P]
  float* bs = dys + kL * kLdP;      // [L][N]
  float* cs = bs + kL * kLdN;       // [L][N]
  float* s1 = cs + kL * kLdN;       // [L][L]  (C_t . B_u) exp(s_t - s_u), u <= t
  float* s2 = s1 + kL * kLdL;       // [L][L]  dM, then dCB
  float* ss = s2 + kL * kLdL;       // [L] cumulative log decay
  float* dts = ss + kL;             // [L]
  float* ws = dts + kL;             // [L] exp(total - s_u) dt_u
  float* ddtm = ws + kL;            // [L] sum_t dM[t][u] s1[t][u]
  float* rowe = ddtm + kL;          // [L] sum_u dM[t][u] M[t][u]
  float* dwv = rowe + kL;           // [L] dL/dw_u
  float* dsi = dwv + kL;            // [L] ds_t through the carried state
  float* cole = dsi + kL;           // [L] sum_{t > u} dM[t][u] M[t][u]
  float* red = ss + kVec * kL;      // [kWarps]

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float Ah = A[h], Dh = D[h];
  const int nc = (T + kL - 1) / kL;
  const size_t bh = (size_t)b * H + h;

  for (int i = threadIdx.x; i < kPMax * kLdN; i += kThreads) {
    const int p = i / kLdN, n = i % kLdN;
    dh[i] = (dfin && p < P && n < N) ? dfin[(bh * P + p) * N + n] : 0.f;
  }
  float dA_acc = 0.f, dD_acc = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kL;
    const int Lc = min(kL, T - t0);
    __syncthreads();
    const size_t xrow0 = (((size_t)b * T + t0) * H + h) * P;
    load_xp(x, xs, xrow0, H * P, Lc, P);
    load_xp(dy, dys, xrow0, H * P, Lc, P);
    load_bc(Bm, Cm, bs, cs, ((size_t)b * T + t0) * N, Lc, N);
    {
      const float* src = states + (bh * nc + c) * (size_t)P * N;
      for (int i = threadIdx.x; i < kPMax * kLdN; i += kThreads) {
        const int p = i / kLdN, n = i % kLdN;
        h0[i] = (p < P && n < N) ? src[p * N + n] : 0.f;
      }
    }
    if (threadIdx.x < kL)
      dts[threadIdx.x] = threadIdx.x < Lc
                             ? dt[((size_t)b * T + t0 + threadIdx.x) * H + h]
                             : 0.f;
    __syncthreads();
    chunk_cumsum(dts, ss, Ah);
    __syncthreads();
    const float total = ss[kL - 1];
    if (threadIdx.x < kL)
      ws[threadIdx.x] = expf(total - ss[threadIdx.x]) * dts[threadIdx.x];

    // s1[t][u] = (C_t . B_u) exp(s_t - s_u), s2[t][u] = dy_t . x_u (u <= t)
    {
      const int r0 = warp * kRowsL;
      float acc[kRowsL][kColsL] = {};
      for (int n = 0; n < N; ++n) {
        float yv[kColsL];
#pragma unroll
        for (int j = 0; j < kColsL; ++j) yv[j] = bs[(lane + 32 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = cs[(r0 + i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kColsL; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      float dm[kRowsL][kColsL] = {};
      for (int p = 0; p < P; ++p) {
        float yv[kColsL];
#pragma unroll
        for (int j = 0; j < kColsL; ++j) yv[j] = xs[(lane + 32 * j) * kLdP + p];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = dys[(r0 + i) * kLdP + p];
#pragma unroll
          for (int j = 0; j < kColsL; ++j) dm[i][j] = fmaf(xv, yv[j], dm[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int t = r0 + i;
#pragma unroll
        for (int j = 0; j < kColsL; ++j) {
          const int u = lane + 32 * j;
          const bool lower = u <= t;
          s1[t * kLdL + u] = lower ? acc[i][j] * expf(ss[t] - ss[u]) : 0.f;
          s2[t * kLdL + u] = lower ? dm[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // column and row sums of dM o s1: ddt through M's dt_u factor, and the
    // parts of ds through the gate. The gate's diagonal (u = t) is
    // exp(s_t - s_t): it adds E[t][t] to ds_t and takes it away again, so
    // both sums leave it out rather than cancel it in rounding — beside
    // O(1) diagonal terms the off-diagonal ones can be e^-10 smaller.
    if (threadIdx.x < kL) {
      const int u = threadIdx.x;
      float acc = 0.f;
      for (int t = u + 1; t < kL; ++t)
        acc += s2[t * kLdL + u] * s1[t * kLdL + u];
      ddtm[u] = s2[u * kLdL + u] * s1[u * kLdL + u] + acc;
      cole[u] = acc * dts[u];
    } else if (threadIdx.x < 2 * kL) {
      const int t = threadIdx.x - kL;
      float acc = 0.f;
      for (int u = 0; u < t; ++u)
        acc += s2[t * kLdL + u] * s1[t * kLdL + u] * dts[u];
      rowe[t] = acc;
    }
    __syncthreads();
    // s2 := dCB[t][u] = dM[t][u] exp(s_t - s_u) dt_u
    for (int i = threadIdx.x; i < kL * kL; i += kThreads) {
      const int t = i / kL, u = i % kL;
      if (u <= t) s2[t * kLdL + u] *= expf(ss[t] - ss[u]) * dts[u];
    }
    __syncthreads();

    // dx[u][p] = dt_u sum_t s1[t][u] dy[t][p] + w_u r[u][p] + D dy[u][p],
    // r[u][p] = sum_n B[u][n] dh[p][n];  dw_u = sum_p x[u][p] r[u][p]
    {
      const int r0 = warp * kRowsL;
      float a1[kRowsL][kColsP] = {};
      float a2[kRowsL][kColsP] = {};
      for (int t = r0; t < kL; ++t) {  // s1[t][u] = 0 for t < u
        float yv[kColsP];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = dys[t * kLdP + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = s1[t * kLdL + r0 + i];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) a1[i][j] = fmaf(xv, yv[j], a1[i][j]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float yv[kColsP];
#pragma unroll
        for (int j = 0; j < kColsP; ++j) yv[j] = dh[(lane + 32 * j) * kLdN + n];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = bs[(r0 + i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kColsP; ++j) a2[i][j] = fmaf(xv, yv[j], a2[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int u = r0 + i;
        float dw = 0.f;
#pragma unroll
        for (int j = 0; j < kColsP; ++j) {
          const int p = lane + 32 * j;
          const float xv = xs[u * kLdP + p], dyv = dys[u * kLdP + p];
          dw += xv * a2[i][j];
          dD_acc += dyv * xv;
          if (u < Lc && p < P)
            dx[xrow0 + (size_t)u * H * P + p] =
                dts[u] * a1[i][j] + ws[u] * a2[i][j] + Dh * dyv;
        }
        dw = warp_sum(dw);
        if (lane == 0) dwv[u] = dw;
      }
    }

    // dB[u][n] = sum_p w_u x[u][p] dh[p][n] + sum_t dCB[t][u] C[t][n]
    {
      const int r0 = warp * kRowsL;
      float acc[kRowsL][kColsN] = {};
      for (int p = 0; p < P; ++p) {
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = dh[p * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = ws[r0 + i] * xs[(r0 + i) * kLdP + p];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      for (int t = r0; t < kL; ++t) {  // dCB[t][u] = 0 for t < u
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = cs[t * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = s2[t * kLdL + r0 + i];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int u = r0 + i;
        if (u >= Lc) continue;
        float* row = dB_part + ((bh * T) + t0 + u) * N;
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int n = lane + 32 * j;
          if (n < N) row[n] = acc[i][j];
        }
      }
    }

    // dC[t][n] = exp(s_t) g[t][n] + sum_u dCB[t][u] B[u][n],
    // g[t][n] = sum_p dy[t][p] h0[p][n];  ds_t += exp(s_t) sum_n C[t][n] g[t][n]
    {
      const int r0 = warp * kRowsL;
      float g[kRowsL][kColsN] = {};
      float a2[kRowsL][kColsN] = {};
      for (int p = 0; p < P; ++p) {
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = h0[p * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = dys[(r0 + i) * kLdP + p];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) g[i][j] = fmaf(xv, yv[j], g[i][j]);
        }
      }
      const int umax = r0 + kRowsL;  // dCB[t][u] = 0 for u > t
      for (int u = 0; u < umax; ++u) {
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = bs[u * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsL; ++i) {
          const float xv = s2[(r0 + i) * kLdL + u];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) a2[i][j] = fmaf(xv, yv[j], a2[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsL; ++i) {
        const int t = r0 + i;
        const float es = expf(ss[t]);
        float cg = 0.f;
        float* row = dC_part + ((bh * T) + t0 + t) * N;
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int n = lane + 32 * j;
          cg += cs[t * kLdN + n] * g[i][j];
          if (t < Lc && n < N) row[n] = es * g[i][j] + a2[i][j];
        }
        cg = warp_sum(cg);
        if (lane == 0) dsi[t] = es * cg;
      }
    }
    __syncthreads();  // every read of dh (the old one) is done

    // dh[p][n] := exp(total) dh[p][n] + sum_t exp(s_t) dy[t][p] C[t][n];
    // dtot_h = sum dh_old o h0
    float dtot_h = 0.f;
    {
      const int r0 = warp * kRowsP;
      float acc[kRowsP][kColsN] = {};
      for (int t = 0; t < Lc; ++t) {
        const float es = expf(ss[t]);
        float yv[kColsN];
#pragma unroll
        for (int j = 0; j < kColsN; ++j) yv[j] = cs[t * kLdN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsP; ++i) {
          const float xv = es * dys[t * kLdP + r0 + i];
#pragma unroll
          for (int j = 0; j < kColsN; ++j) acc[i][j] = fmaf(xv, yv[j], acc[i][j]);
        }
      }
      const float dec = expf(total);
#pragma unroll
      for (int i = 0; i < kRowsP; ++i)
#pragma unroll
        for (int j = 0; j < kColsN; ++j) {
          const int o = (r0 + i) * kLdN + lane + 32 * j;
          dtot_h += dh[o] * h0[o];
          dh[o] = dec * dh[o] + acc[i][j];
        }
    }
    dtot_h = block_sum(dtot_h, red);  // synchronises: dwv, dsi, rowe ready

    // the chunk's scalars, in order: ds_t, its reverse cumsum da_t, ddt_t.
    // total = s_{Lc-1}, so w_{Lc-1} = dt_{Lc-1} does not depend on s: its
    // +dw w (through total) and -dw w (through s_{Lc-1}) are both left out
    if (threadIdx.x == 0) {
      float dtot = expf(total) * dtot_h;
      for (int u = 0; u < Lc - 1; ++u) dtot += dwv[u] * ws[u];
      float acc = 0.f;
      for (int t = Lc - 1; t >= 0; --t) {
        float ds = rowe[t] - cole[t] + dsi[t];
        ds += t == Lc - 1 ? dtot : -dwv[t] * ws[t];
        acc += ds;  // da_t = sum_{tau >= t} ds_tau
        ddt[((size_t)b * T + t0 + t) * H + h] =
            ddtm[t] + dwv[t] * expf(total - ss[t]) + acc * Ah;
        dA_acc += acc * dts[t];
      }
    }
  }
  dD_acc = block_sum(dD_acc, red);
  if (threadIdx.x == 0) {
    dA_part[bh] = dA_acc;
    dD_part[bh] = dD_acc;
  }
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
      set_smem((const void*)ssd_scan_fwd_prep_kernel<NMAX>, F::kPrepSmem) |
      set_smem((const void*)ssd_scan_fwd_scan_kernel<NMAX>, F::kSmem);
  if (attr) return attr;
  const int nc = (T + kL - 1) / kL;
  float* cb = scratch;                              // (Bt, nc, L, L)
  float* s = scratch + (size_t)Bt * nc * kL * kL;   // (Bt, nc, L, H)
  ssd_scan_fwd_prep_kernel<NMAX><<<dim3(nc, Bt, 2), kThreads, F::kPrepSmem,
                                   stream>>>(dt, A, B, C, cb, s, T, H, N);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  ssd_scan_fwd_scan_kernel<NMAX><<<dim3(H, Bt), kFwdThreads, F::kSmem,
                                   stream>>>(
      x, dt, D, B, C, cb, s, y, fin, states, T, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_chunk() { return kL; }
extern "C" int ssd_scan_max_p() { return kPMax; }
extern "C" int ssd_scan_max_n() { return kNMax; }

// The forward's scratch, in floats: C B^T for each (b, chunk) and every
// head's cumsum, (Bt, ceil(T/64), 64, 64 + H).
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
extern "C" int ssd_scan_bwd_f32(const float* x, const float* dt,
                                const float* A, const float* B,
                                const float* C, const float* D,
                                const float* states, const float* dy,
                                const float* dfin, float* dx, float* ddt,
                                float* dA_part, float* dB_part,
                                float* dC_part, float* dD_part, int Bt,
                                int T, int H, int P, int N, void* stream) {
  if (Bt <= 0 || H <= 0 || T <= 0) return 0;
  static const int attr = set_smem((const void*)ssd_scan_bwd_kernel, kBwdSmem);
  if (attr) return attr;
  ssd_scan_bwd_kernel<<<dim3(H, Bt), kThreads, kBwdSmem, (cudaStream_t)stream>>>(
      x, dt, A, B, C, D, states, dy, dfin, dx, ddt, dA_part, dB_part, dC_part,
      dD_part, T, H, P, N);
  return (int)cudaGetLastError();
}
