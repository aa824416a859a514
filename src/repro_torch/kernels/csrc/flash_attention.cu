// Causal / sliding-window attention for Hopper (sm_90a), forward and
// backward, with a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (pallas_call at flash_attention.py:99, body
// _flash_kernel). For q (B, T, H, d), k and v (B, S, KV, d), query head h
// reads kv head h / G (G = H / KV, no copy of K or V), and
//
//   s[t][u] = (q_t . k_u) / sqrt(d)      where the mask holds, else -1e30
//   mask    = u < S & t < T  [& u <= t if causal]  [& u > t - window]
//   o_t     = sum_{u < S} softmax(s[t])_u v_u    (f32 sums, o in q's type)
//
// and, given a logit softcap c > 0 (Gemma 2's attn_logit_softcapping; the
// reference's models/layers.py applies it, the TPU kernel does not), each
// scaled score is capped to c tanh(s / c) before the mask and the running
// max, as the reference caps it; the backward recomputes the capped score
// and multiplies dS by its derivative 1 - (capped / c)^2. The accurate
// tanhf (not tanh.approx.f32, whose ~2^-11 relative error would pass into
// every probability) and an IEEE division. The forward takes the cap as a
// template flag (one more instantiation a head dim and type): a run-time
// test in the kernel, a branch uniform over the block and outside the
// products, cost the uncapped forward 1.5-2.5 % on an H100
// (ablations/flash_softcap.py). The backward tests it at run time, at no
// cost measured there (+0.2 %). c = 0
// computes what the kernels computed before, bit for bit.
//
// with the online softmax over key tiles: a running max m and sum l per
// row, the accumulator rescaled by exp(m_old - m_new) as each tile comes,
// and o = acc / max(l, 1e-30). As in the TPU kernel a masked score is
// -1e30: in a row with any key in its band it contributes exactly 0 (once
// a real score arrives, exp(-1e30 - m) = 0 wipes what masked keys added),
// and a row with none (window > 0 and t >= S + window - 1, so only when
// T > S) takes the mean of v over the S keys. The query tiles that hold
// such rows visit every key tile. The forward also writes each row's
// logsumexp m + log l, (B, H, T) f32, for the backward; for a row with no
// key it is -1e30 (log S is below f32's resolution there), so the backward
// gives such a row P = 1/S by its index, not from lse.
//
// Forward design. The TPU kernel walks key blocks on a sequential grid axis
// with m, l and acc in VMEM scratch. Here one block of 8 warps owns a tile of
// 128 query rows and loops over the key tiles itself, 64 keys a tile (16 at d >
// 128, where two 32-key buffers would not fit); the last query tile launches
// first, since under a causal mask it has the most keys. A key tile that lies
// wholly outside the causal or window band is never loaded: the loop runs only
// over the key tiles that the band reaches. Each warp owns 16 whole query rows,
// one m16 block of both products: s = q.k^T (16 x 64 a warp) into registers;
// the online softmax on those C fragments, where each thread holds rows g and g
// + 8, so a row's max and sum are two quad shuffles and the rescale of acc
// stays in registers; the band mask only on the tiles that cross a row's band
// edge; and acc += P.V with P taken from the registers of s: V's rows are read
// in the order (0, 2, 4, 6, 1, 3, 5, 7) of each 8-key slice, in which the C
// fragment {c0, c2, c1, c3} is the A fragment. K and V are double-buffered:
// 16-byte cp.async brings the next tile while the block computes on this one
// (f32 rows with d % 4 == 0; bf16 and other d are staged by a thread loop,
// widened to f32). No MMA of P.V is under a runtime condition: it runs over all
// DMAX / 8 head-dim n-tiles, the zero columns beyond d included, because the
// compiler interleaves no accumulator chains across a branch (a condition on
// each n-tile beyond d cost 45-52 %). q.k^T's loop over the head dim ends at
// the first 8-column slice at or beyond d, by a break between slices; the
// key tile's independent chains inside a slice run unbranched. No warp skips the
// causal diagonal's tiles that its rows do not reach: per 8-key slice (a
// condition on each MMA) it was slower, per whole tile no faster. No atomics:
// the forward is bitwise reproducible. Head dims d <= 64, 128 and 256 each get
// their own instantiation. Shared memory a block: 104,448 B at DMAX 64, 202,752
// B at 128, 199,680 B at 256, so one block an SM, and a thread may hold 255
// registers: it takes 168 at DMAX 64, 208 at 128 and 230 at 256 (bf16 167, 188,
// 228; nvcc -Xptxas -v, sm_90a, CUDA 12.8), with no spills. Two blocks an SM at
// 16-key tiles and <= 128 registers spilled and were slower
// (tools/flash_fwd_ablation.py times the kernel against copies with one of
// its parts undone).
//
// Backward (the TPU kernel has none), FA2-style, two launches: D =
// rowsum(dO o O) by a small kernel, then one fused kernel. A block per (b,
// kv head, key tile) holds its K and V tiles and loops over the G query
// heads of that kv head and the query tiles the band reaches. For each
// query tile it computes s^T = K.Q^T and dP^T = V.dO^T once, then P =
// exp(s - lse) and dS = P o (dP - D), and three more products: dV +=
// P^T.dO and dK += dS^T.Q in registers, and dQ = dS.K, which it adds into
// an f32 buffer dq_acc (B, T, H, d) with 16-byte red.global.add.v4.f32
// (scalar atomics when d % 4 != 0). That is 5 products of length d a
// (t, u) pair, the function's own count. dK and dV are deterministic; dQ
// is not: the key tiles' atomic adds land in whatever order the blocks
// run, so dQ may differ in its last bits from run to run (as
// scaled_dot_product_attention's own backward may).
//
// The products of both directions run on the tensor cores by 3xTF32
// (CUTLASS's OpMultiplyAddFastF32): each f32 operand x is split as big +
// small, big rounded to TF32 and small = x - big read as TF32, and a.b =
// big_a.big_b + big_a.small_b + small_a.big_b, three mma.sync m16n8k8 into
// one f32 accumulator. big carries x's top 11 significant bits and small
// the next 11, so each product keeps about 21 bits (small_a.small_b,
// dropped, is below 2^-21 of it), where one TF32 pass would keep 11: the
// sums stay near f32 accuracy. The tiles stay in shared memory as f32 with
// a row stride of DMAX + 4 (and 64 + 4 for the backward's P^T and dS^T), 4
// mod 32: the A and B fragments that read along a row (lane -> row lane /
// 4, column lane % 4 and + 4) hit 32 distinct banks; in the backward the
// transposed operands (Q, dO and K as the right operand of dK, dV and dQ,
// dS as the left of dQ) are read by index from those tiles, not copied,
// with at most 2-way conflicts (an order of columns that avoids them
// compiled to a slower kernel). The loops over the head dim and over the
// tiles are unrolled in full. The backward stages rows with 16-byte loads
// where d % 4 == 0 (every width the paths use), a scalar loop otherwise;
// bf16 is widened to f32 as it is staged. Its shared memory a block:
// 104,960 B at DMAX 64, 170,496 B at 128 and 217,600 B at 256 (32-key
// tiles), so one block an SM; a next q/dO tile double-buffered beside them
// would need 238,080 B at DMAX 128, more than the 232,448 a block may use,
// so its loads are not overlapped with the products. Its block has 16
// warps, 4 to a scheduler, so one warp's load -> split -> MMA chain waits
// while others issue; with 8 warps and twice the registers each it is
// slower (scripts/flash_bwd_ablation.py). So a thread may hold 128
// registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): it takes 119 at DMAX 64,
// 123 at 128 and 118 at 256, f32 and bf16 alike, with no spills.
//
// Bounds on the H100 at the zamba2 path's shape (B 8, T = S = 512, H = KV
// = 32, d 112, causal): 131,328 (t, u) pairs in the causal band per (b,
// h). Both directions compute on the tensor cores by 3xTF32, three TF32
// products for each f32 one, so their bound is those products at the
// card's 495 TFLOP/s of TF32, or their bytes at 3.35 TB/s if more
// (chip_smoke.py's bound_ms). Forward, 2 d multiply-adds a pair (q.k and
// p.v): 15.06 GFLOP, 3 x 15.06 GFLOP at 495 TFLOP/s is 0.0913 ms, against
// 0.070 ms for the 235 MB of q, k, v and o, so it is bound by operations.
// But mma.sync reaches about 310 TFLOP/s of TF32 on this card (the loop in
// scripts/flash_bwd_ablation.py), and the forward computes whole 128 x 64
// tiles on the causal diagonal (18.8 GFLOP for its two products, +24.8
// %), so its own floor is 3 x 18.8 GFLOP at 310 TFLOP/s, 0.182 ms; at T =
// 4096 the bound is 0.729 ms and the floor 1.20 ms. It takes 0.476 ms at
// the path's shape and 2.663 ms at T = 4096, 5.2x and 3.7x its bound and
// 0.92x and 0.83x the time of scaled_dot_product_attention, whose f32
// route on this card is CUTLASS's memory-efficient attention
// (fmha_cutlassF_f32_aligned_64x128_rf_sm80); chip_smoke.py's phase_flash
// on an H100 80GB HBM3 at 700 W. Backward, 5 d multiply-adds a pair: 37.65
// GFLOP, 3 x 37.65 GFLOP at 495 TFLOP/s is 0.228 ms against 0.14 ms of
// bytes, so it is bound by operations (1.823 ms at T = 4096); with the
// causal diagonal's 64 x 64 tiles whole (42.3 GFLOP a product set) its own
// floor is 3 x 42.3 GFLOP at 310 TFLOP/s, 0.41 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the D kernel's block: 8 warps, a row each
constexpr int kWarps = kThreads / 32;
constexpr int kFwdWarps = 8;   // the forward's warps a block, 16 rows each
constexpr int kFwdBT = 16 * kFwdWarps;  // the forward's query rows per tile
constexpr int kBwdWarps = 16;  // the fused backward's warps a block
constexpr int kBT = 64;              // the backward's query rows per tile
constexpr float kNoKey = -INFINITY;  // the score of a column u >= S
constexpr float kMinus = -1e30f;  // a masked score; the max before a key

template <int DMAX>
struct Tiles {
  static constexpr int kBS = DMAX > 128 ? 32 : 64;  // keys per tile
  // forward: keys per tile; q [FwdBT][LdB] and two buffers of k, v
  // [FwdBS][LdB], the next key tile loading while the block computes on one
  static constexpr int kFwdBS = DMAX > 128 ? 16 : 64;
  static constexpr size_t kFwdSmem =
      sizeof(float) * (size_t)(kFwdBT + 4 * kFwdBS) * (DMAX + 4);
  // row strides of both directions, 4 mod 32: an mma fragment's 32 lanes
  // (rows lane / 4, columns lane % 4) read 32 distinct banks
  static constexpr int kLdB = DMAX + 4;
  static constexpr int kLdTB = kBT + 4;
  // backward: k, v [BS][LdB], q, dO [BT][LdB], P^T, dS^T [BS][LdTB], lse, D
  static constexpr size_t kBwdSmem =
      sizeof(float) * ((size_t)(2 * kBS + 2 * kBT) * kLdB + 2 * kBS * kLdTB +
                       2 * kBT);
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a scaled score under a logit softcap c: c tanh(s / c), as the reference
// writes it (the accurate tanhf and an IEEE division)
__device__ __forceinline__ float softcap(float s, float cap) {
  return cap * tanhf(s / cap);
}

__device__ __forceinline__ bool in_band(int t, int u, int T, int S,
                                        int causal, int window) {
  return u < S && t < T && (!causal || u <= t) &&
         (window <= 0 || u > t - window);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const auto* two = reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 lo = __bfloat1622float2(two[0]), hi = __bfloat1622float2(two[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage `rows` rows of one head of a (B, L, heads, d) tensor as f32
// [rows][ld], zero beyond the sequence's `n` rows and beyond d columns; four
// columns a thread (16 bytes of f32) where d allows it.
template <typename T, int ROWS, int DMAX, int LD, int THREADS>
__device__ void load_tile(const T* __restrict__ src, float* dst, int b,
                          int r0, int n, int heads, int head, int d) {
  static_assert(LD % 4 == 0, "16-byte aligned rows");
  const bool aligned = reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  if (d % 4 == 0 && aligned) {
    constexpr int Q4 = DMAX / 4;
    for (int i = threadIdx.x; i < ROWS * Q4; i += THREADS) {
      const int r = i / Q4, c = 4 * (i % Q4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n && c < d)
        val = load4(src + (((size_t)b * n + r0 + r) * heads + head) * d + c);
      *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
    return;
  }
  for (int i = threadIdx.x; i < ROWS * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    float val = 0.f;
    if (r0 + r < n && c < d)
      val = to_f(src[(((size_t)b * n + r0 + r) * heads + head) * d + c]);
    dst[r * LD + c] = val;
  }
}

// One row-vector per query row of the tile, (B, H, T) layout.
__device__ void load_rows(const float* __restrict__ src, float* dst,
                          size_t bh, int t0, int T) {
  if (threadIdx.x < kBT) {
    const int t = t0 + threadIdx.x;
    dst[threadIdx.x] = t < T ? src[bh * T + t] : 0.f;
  }
}

// The first query row with no key in its band: t >= S + window - 1 when
// window > 0 (u <= t never empties a row, u > t - window does once
// t - window + 1 > S - 1); none without a window.
__device__ __forceinline__ int first_keyless_row(int S, int window) {
  return window > 0 ? S + window - 1 : 0x7fffffff;
}

// The key range [lo, hi) that the band of query rows [t0, t0 + rows)
// reaches; all S keys when a row of the tile has none in its band.
__device__ __forceinline__ void key_range(int t0, int rows, int S, int causal,
                                          int window, int* lo, int* hi) {
  if (t0 + rows - 1 >= first_keyless_row(S, window)) {
    *lo = 0;
    *hi = S;
    return;
  }
  *lo = window > 0 ? max(0, t0 - window + 1) : 0;
  *hi = causal ? min(S, t0 + rows) : S;
}

// ---------------------------------------------------------------------------
// the products of both directions: mma.sync m16n8k8 on TF32, three a product
// ---------------------------------------------------------------------------
//
// Fragments of D[16][8] += A[16][8] . B[8][8] (PTX ISA, mma.m16n8k8 .tf32),
// with g = lane / 4 and i = lane % 4: a0 (g, i), a1 (g + 8, i), a2 (g, i + 4),
// a3 (g + 8, i + 4); b0 (k i, n g), b1 (k i + 4, n g); c0, c1 (g, 2i and
// 2i + 1), c2, c3 (g + 8, the same columns).

// x = big + small: big is x rounded to TF32's 10-bit mantissa (add half of
// its last place, clear the 13 bits below), small = x - big exactly, passed
// as f32 bits, of which the tensor core reads the top 19 (TF32). big carries
// x's top 11 significant bits and small the next 11, so what the core sees
// is x to about 2^-21. That is two integer and one f32 instruction a value:
// every fragment is split where it is loaded, so the splits are a large
// share of the kernel's instructions, and cvt.rna.tf32.f32 for both parts
// costs more.
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

// A fragment of A = x^T: A[m][k] = x[k][m]
template <int LD>
__device__ __forceinline__ Split<4> frag_at(const float* x, int m0, int k0,
                                            int lane) {
  const float* p = x + (k0 + (lane & 3)) * LD + m0 + (lane >> 2);
  const float v[4] = {p[0], p[8], p[4 * LD], p[4 * LD + 8]};
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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// B fragment of a row-major x[k][n] whose k order in each 8-row slice is
// (0, 2, 4, 6, 1, 3, 5, 7): b0 from row 2i and b1 from row 2i + 1. An A
// fragment in that order is a C fragment as it stands, {c0, c2, c1, c3}:
// the P of q.k^T feeds P.V from the registers that hold it.
template <int LD>
__device__ __forceinline__ Split<2> frag_b_pairs(const float* x, int n0,
                                                 int k0, int lane) {
  const float* p = x + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  const float v[2] = {p[0], p[LD]};
  return split(v);
}

// The max and the sum over a quad, the 4 lanes that hold one row of a C
// fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// load_tile's tile, by 16-byte cp.async (zero-filled beyond n rows and d
// columns; the caller commits and waits) where the rows are f32 with d %
// 4 == 0 from a 16-byte aligned base, and by load_tile otherwise.
template <typename T, int ROWS, int DMAX, int LD, int THREADS>
__device__ void stage_tile(const T* __restrict__ src, float* dst, int b,
                           int r0, int n, int heads, int head, int d) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (d % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      constexpr int Q4 = DMAX / 4;
      static_assert(ROWS * Q4 % THREADS == 0, "whole rounds of the block");
#pragma unroll
      for (int n4 = 0; n4 < ROWS * Q4 / THREADS; ++n4) {
        const int i = n4 * THREADS + threadIdx.x;
        const int r = i / Q4, c = 4 * (i % Q4);
        const bool ok = r0 + r < n && c < d;
        cp_async16(dst + r * LD + c,
                   ok ? reinterpret_cast<const float*>(src) +
                            (((size_t)b * n + r0 + r) * heads + head) * d + c
                      : reinterpret_cast<const float*>(src),
                   ok);
      }
      return;
    }
  }
  load_tile<T, ROWS, DMAX, LD, THREADS>(src, dst, b, r0, n, heads, head, d);
}

// o and lse for one query tile of one head. Warp w owns query rows 16 w ..
// 16 w + 15 of the tile, and each thread rows gr and gr + 8 of the warp's
// C fragments, so a row's max and sum are quad shuffles. For each key tile
// the band reaches, with the next one loading meanwhile: s = q.k^T (16 x
// BS a warp), the online softmax in registers, acc += P.V with P where
// the softmax left it.
template <int DMAX, typename T, bool CAPPED>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int Tq, int S, int H,
                           int KV, int d, int causal, int window,
                           float scale, float cap) {
  using C = Tiles<DMAX>;
  constexpr int BT = kFwdBT, BS = C::kFwdBS, LD = C::kLdB;
  constexpr int NTH = 32 * kFwdWarps;
  constexpr int NS = BS / 8;    // 8-key slices of a key tile
  constexpr int ND = DMAX / 8;  // head-dim n-tiles of acc
  extern __shared__ float sm[];
  float* qs = sm;              // [BT][LD]
  float* kvs = qs + BT * LD;   // 2 x {k [BS][LD], v [BS][LD]}

  // the last query tile first: under a causal mask it has the most keys
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BT, h = blockIdx.y,
            b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, gc = 2 * (lane & 3);  // accumulator row, column
  const int m0 = 16 * warp;
  const int tw = t0 + m0, last = min(tw + 15, Tq - 1);  // the warp's rows

  int lo, hi;
  key_range(t0, BT, S, causal, window, &lo, &hi);
  const int first = (lo / BS) * BS;
  auto stage_kv = [&](int s0, int buf) {
    float* ks = kvs + buf * 2 * BS * LD;
    stage_tile<T, BS, DMAX, LD, NTH>(k, ks, b, s0, S, KV, kvh, d);
    stage_tile<T, BS, DMAX, LD, NTH>(v, ks + BS * LD, b, s0, S, KV, kvh, d);
  };
  stage_tile<T, BT, DMAX, LD, NTH>(q, qs, b, t0, Tq, H, h, d);
  if (first < hi) stage_kv(first, 0);
  cp_async_commit();

  // the running max and sum of rows gr and gr + 8
  float m[2] = {kMinus, kMinus}, l[2] = {0.f, 0.f};
  float acc[ND][4] = {};

  for (int s0 = first, buf = 0; s0 < hi; s0 += BS, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last
    if (s0 + BS < hi) stage_kv(s0 + BS, buf ^ 1);
    cp_async_commit();
    const float* ks = kvs + buf * 2 * BS * LD;
    const float* vs = ks + BS * LD;

    // s[t][u] = q_t . k_u; the zero columns beyond d add nothing
    float sc[NS][4] = {};
#pragma unroll
    for (int i0 = 0; i0 < DMAX; i0 += 8) {
      if (i0 >= d) break;
      const Split<4> aq = frag_a<LD>(qs, m0, i0, lane);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma3(sc[j], aq, frag_bt<LD>(ks, 8 * j, i0, lane));
    }

    // under a softcap the scores are scaled and capped here, and the
    // passes below leave them as they are; with none they scale them
    if constexpr (CAPPED) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = softcap(sc[j][e] * scale, cap);
      }
    }
    const float sscale = CAPPED ? 1.f : scale;
    // the online softmax of rows gr and gr + 8 over this tile; the scores
    // are masked unless the tile lies inside the band of every row
    const bool inner = last - tw == 15 && s0 + BS <= S &&
                       (!causal || s0 + BS - 1 <= tw) &&
                       (window <= 0 || s0 > last - window);
    float mx[2] = {kMinus, kMinus};
    if (inner) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= sscale;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tw + gr + 4 * (e & 2), u = s0 + 8 * j + gc + (e & 1);
          sc[j][e] = in_band(t, u, Tq, S, causal, window) ? sc[j][e] * sscale
                     : u < S                              ? kMinus
                                                          : kNoKey;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);  // 0 for u >= S
        sum[e >> 1] += sc[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }

    // acc[t][c] += sum_u P[t][u] v[u][c], P from the registers of s. All
    // DMAX / 8 n-tiles, also those beyond d (zero columns of v, never
    // written): a product under a runtime condition is a branch, and the
    // compiler interleaves no MMA chains across branches
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float pv[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
      const Split<4> ap = split(pv);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma3(acc[n], ap, frag_b_pairs<LD>(vs, 8 * n, 8 * j, lane));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + gr + 8 * r;
    if (t >= Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + (((size_t)b * Tq + t) * H + h) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + gc;
      if (c < d) orow[c] = from_f<T>(acc[n][2 * r] / den);
      if (c + 1 < d) orow[c + 1] = from_f<T>(acc[n][2 * r + 1] / den);
    }
    if ((lane & 3) == 0) lse[((size_t)b * H + h) * Tq + t] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D[b][h][t] = sum_c dO[b][t][h][c] O[b][t][h][c]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dot_kernel(const T* __restrict__ o,
                               const T* __restrict__ dout,
                               float* __restrict__ Dv, int rows, int Tq,
                               int H, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(a[c]), to_f(g[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, bt = row / H;  // row = (b * T + t) * H + h
    const int t = bt % Tq, b = bt / Tq;
    Dv[((size_t)b * H + h) * Tq + t] = acc;
  }
}

// dq_acc[row][c .. c + 3] += v, one 16-byte reduction
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c,
                                         float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// dK, dV and dQ for one key tile of one kv head: rows are keys, the loop
// runs over the G query heads and the query tiles the band reaches. For each
// query tile, s^T = K.Q^T and dP^T = V.dO^T once; then P, dS; dV += P^T.dO
// and dK += dS^T.Q in registers; and dQ = dS.K added into dq_acc with f32
// atomics. Warp layouts (kBwdWarps = 16): s^T, dP^T and dK, dV as BS / 16
// warps of 16 key rows by 16 / (BS / 16) parts of the columns; dQ as 4
// warps of 16 query rows by 4 parts of the head dim.
template <int DMAX, typename T>
__global__ void __launch_bounds__(32 * kBwdWarps, 1)
flash_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ Dv,
                           float* __restrict__ dq_acc, T* __restrict__ dk,
                           T* __restrict__ dv, int Tq, int S, int H, int KV,
                           int d, int causal, int window, float scale,
                           float cap) {
  using C = Tiles<DMAX>;
  constexpr int BS = C::kBS, LD = C::kLdB, LDT = C::kLdTB;
  constexpr int WM = BS / 16, WN = kBwdWarps / WM;  // s^T, dK, dV warps
  constexpr int WQ = kBwdWarps / 4;  // dQ: 4 warps of 16 rows by WQ parts
  constexpr int NT_S = kBT / WN / 8;             // s^T n-tiles a warp
  constexpr int NT_D = DMAX / WN / 8;            // dK, dV n-tiles a warp
  constexpr int NT_Q = DMAX / WQ / 8;            // dQ n-tiles a warp
  extern __shared__ float sm[];
  float* ks = sm;                // [BS][LD]
  float* vs = ks + BS * LD;      // [BS][LD]
  float* qs = vs + BS * LD;      // [BT][LD]
  float* dos = qs + kBT * LD;    // [BT][LD]
  float* pt = dos + kBT * LD;    // [BS][LDT]  P^T
  float* dst = pt + BS * LDT;    // [BS][LDT]  dS^T
  float* ls = dst + BS * LDT;    // [BT]
  float* ds_ = ls + kBT;         // [BT]       D

  const int s0 = blockIdx.x * BS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, gc = 2 * (lane & 3);  // accumulator row, column
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = 16 * wm;                   // key rows of s^T, dK, dV
  const int n0s = wn * NT_S * 8;            // query columns of s^T
  const int nt = (d + 7) / 8;               // head-dim n-tiles in all
  const int nt_d = (nt + WN - 1) / WN, nt_q = (nt + WQ - 1) / WQ;
  const int n0d = wn * nt_d * 8;            // head-dim columns of dK, dV
  const int mq = 16 * (warp & 3);           // query rows of dQ
  const int n0q = (warp >> 2) * nt_q * 8;   // head-dim columns of dQ

  constexpr int NTH = 32 * kBwdWarps;
  load_tile<T, BS, DMAX, LD, NTH>(k, ks, b, s0, S, KV, kvh, d);
  load_tile<T, BS, DMAX, LD, NTH>(v, vs, b, s0, S, KV, kvh, d);

  float dka[NT_D][4] = {}, dva[NT_D][4] = {};
  // the query rows whose band reaches keys [s0, s0 + BS), and those with
  // no key in their band, whose P is 1/S on every key (and dS = 0: the
  // mask holds their scores constant)
  const int keyless = first_keyless_row(S, window);
  const float inv_s = 1.0f / (float)S;
  const int qlo = causal ? s0 : 0;
  const int qhi = keyless < Tq ? Tq
                  : window > 0 ? min(Tq, s0 + BS - 1 + window)
                               : Tq;
  const int un = min(BS, S - s0);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t bh = (size_t)b * H + h;
    for (int t0 = (qlo / kBT) * kBT; t0 < qhi; t0 += kBT) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<T, kBT, DMAX, LD, NTH>(q, qs, b, t0, Tq, H, h, d);
      load_tile<T, kBT, DMAX, LD, NTH>(dout, dos, b, t0, Tq, H, h, d);
      load_rows(lse, ls, bh, t0, Tq);
      load_rows(Dv, ds_, bh, t0, Tq);
      __syncthreads();

      // s^T[u][t] = k_u . q_t and dP^T[u][t] = v_u . dO_t
      float st[NT_S][4] = {}, dpt[NT_S][4] = {};
#pragma unroll
      for (int i0 = 0; i0 < DMAX; i0 += 8) {
        if (i0 >= d) break;
        const Split<4> ak = frag_a<LD>(ks, m0, i0, lane);
        const Split<4> av = frag_a<LD>(vs, m0, i0, lane);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          mma3(st[j], ak, frag_bt<LD>(qs, n0s + 8 * j, i0, lane));
          mma3(dpt[j], av, frag_bt<LD>(dos, n0s + 8 * j, i0, lane));
        }
      }
      // P = exp(s scale - lse) in the band, 1/S on a row with no key;
      // dS = P (dP - D) in the band; under a softcap s scale is capped
      // first, and dS is times the cap's derivative 1 - (capped / c)^2
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ul = m0 + gr + 8 * (e >> 1), u = s0 + ul;
          const int tl = n0s + 8 * j + gc + (e & 1), t = t0 + tl;
          const bool band = in_band(t, u, Tq, S, causal, window);
          // s scale - lse as one fma with no cap, as the kernel always
          // rounded it
          float arg = fmaf(st[j][e], scale, -ls[tl]), dcap = 1.f;
          if (cap > 0.f) {
            const float sv = softcap(st[j][e] * scale, cap);
            const float r = sv / cap;
            arg = sv - ls[tl];
            dcap = 1.f - r * r;
          }
          const float p = band ? expf(arg)
                          : (t >= keyless && t < Tq && u < S) ? inv_s
                                                              : 0.f;
          pt[ul * LDT + tl] = p;
          dst[ul * LDT + tl] = band ? p * (dpt[j][e] - ds_[tl]) * dcap : 0.f;
        }
      }
      __syncthreads();  // P^T and dS^T are whole

      // dV[u][c] += sum_t P^T[u][t] dO[t][c];
      // dK[u][c] += sum_t dS^T[u][t] q[t][c]
      const int tn = min(kBT, Tq - t0);
#pragma unroll
      for (int k0 = 0; k0 < kBT; k0 += 8) {
        if (k0 >= tn) break;
        const Split<4> ap = frag_a<LDT>(pt, m0, k0, lane);
        const Split<4> as = frag_a<LDT>(dst, m0, k0, lane);
#pragma unroll
        for (int j = 0; j < NT_D; ++j) {
          if (j < nt_d) {
            mma3(dva[j], ap, frag_b<LD>(dos, n0d + 8 * j, k0, lane));
            mma3(dka[j], as, frag_b<LD>(qs, n0d + 8 * j, k0, lane));
          }
        }
      }

      // dQ[t][c] += scale sum_u dS^T[u][t] k[u][c], into dq_acc
      float dqa[NT_Q][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < BS; k0 += 8) {
        if (k0 >= un) break;
        const Split<4> as = frag_at<LDT>(dst, mq, k0, lane);
#pragma unroll
        for (int j = 0; j < NT_Q; ++j)
          if (j < nt_q) mma3(dqa[j], as, frag_b<LD>(ks, n0q + 8 * j, k0, lane));
      }
      // lanes 2i and 2i + 1 trade halves: the even one adds row gr, columns
      // gc .. gc + 3, the odd one row gr + 8, columns gc - 2 .. gc + 1
      const bool odd = lane & 1;
      const int t = t0 + mq + gr + (odd ? 8 : 0);
      float* row = dq_acc + (((size_t)b * Tq + t) * H + h) * d;
#pragma unroll
      for (int j = 0; j < NT_Q; ++j) {
        const float x0 =
            __shfl_xor_sync(0xffffffffu, odd ? dqa[j][0] : dqa[j][2], 1);
        const float x1 =
            __shfl_xor_sync(0xffffffffu, odd ? dqa[j][1] : dqa[j][3], 1);
        const float w[4] = {odd ? x0 : dqa[j][0], odd ? x1 : dqa[j][1],
                            odd ? dqa[j][2] : x0, odd ? dqa[j][3] : x1};
        const int c = n0q + 8 * j + (gc & ~3);
        if (j >= nt_q || t >= Tq) continue;
        if ((d & 3) == 0) {
          if (c < d)
            red_add4(row + c, w[0] * scale, w[1] * scale, w[2] * scale,
                     w[3] * scale);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < d) atomicAdd(row + c + e, w[e] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT_D; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = s0 + m0 + gr + 8 * (e >> 1);
      const int c = n0d + 8 * j + gc + (e & 1);
      if (j < nt_d && u < S && c < d) {
        const size_t at = (((size_t)b * S + u) * KV + kvh) * d + c;
        dk[at] = from_f<T>(dka[j][e] * scale);
        dv[at] = from_f<T>(dva[j][e]);
      }
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DMAX, typename T, bool CAPPED>
int launch_fwd_as(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Tq, int S, int H, int KV, int d,
                  int causal, int window, float cap, cudaStream_t stream) {
  using C = Tiles<DMAX>;
  static const int attr = set_smem(
      (const void*)flash_attention_fwd_kernel<DMAX, T, CAPPED>, C::kFwdSmem);
  if (attr) return attr;
  const dim3 grid((Tq + kFwdBT - 1) / kFwdBT, H, B);
  flash_attention_fwd_kernel<DMAX, T, CAPPED>
      <<<grid, 32 * kFwdWarps, C::kFwdSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Tq, S, H, KV, d,
      causal, window, 1.0f / sqrtf((float)d), cap);
  return (int)cudaGetLastError();
}

// the forward with a softcap, or the one without (the cap a template flag:
// see the header)
template <int DMAX, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Tq, int S, int H, int KV, int d,
               int causal, int window, float cap, cudaStream_t stream) {
  return cap > 0.f
             ? launch_fwd_as<DMAX, T, true>(q, k, v, o, lse, B, Tq, S, H, KV,
                                            d, causal, window, cap, stream)
             : launch_fwd_as<DMAX, T, false>(q, k, v, o, lse, B, Tq, S, H,
                                             KV, d, causal, window, 0.f,
                                             stream);
}

template <int DMAX, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, float* Dv, float* dq_acc,
               void* dk, void* dv, int B, int Tq, int S, int H, int KV, int d,
               int causal, int window, float cap, cudaStream_t stream) {
  using C = Tiles<DMAX>;
  static const int attr = set_smem(
      (const void*)flash_attention_bwd_kernel<DMAX, T>, C::kBwdSmem);
  if (attr) return attr;
  const float scale = 1.0f / sqrtf((float)d);
  const int rows = B * Tq * H;
  flash_attention_bwd_dot_kernel<T>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          (const T*)o, (const T*)dout, Dv, rows, Tq, H, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_attention_bwd_kernel<DMAX, T>
      <<<dim3((S + C::kBS - 1) / C::kBS, KV, B), 32 * kBwdWarps, C::kBwdSmem,
         stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                   lse, Dv, dq_acc, (T*)dk, (T*)dv, Tq, S, H, KV, d, causal,
                   window, scale, cap);
  return (int)cudaGetLastError();
}

// cudaErrorInvalidValue for a head dim or type the kernels do not take
constexpr int kBadArgs = (int)cudaErrorInvalidValue;

}  // namespace

extern "C" int flash_attention_max_d() { return 256; }

// The forward's tile at head dim d: *rows query rows a block, *keys keys a
// key tile.
extern "C" void flash_attention_fwd_tile(int d, int* rows, int* keys) {
  *rows = kFwdBT;
  *keys = d <= 64    ? Tiles<64>::kFwdBS
          : d <= 128 ? Tiles<128>::kFwdBS
                     : Tiles<256>::kFwdBS;
}

// Forward: q (B,T,H,d), k, v (B,S,KV,d), contiguous, dtype 0 = f32,
// 1 = bf16 -> o (B,T,H,d) in q's type and lse (B,H,T) f32; cap > 0 caps the
// scaled scores to cap tanh(s / cap). Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int Tq, int S, int H, int KV, int d,
                                   int causal, int window, float cap,
                                   void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || d <= 0 || d > 256 || S <= 0) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_FWD(DM, TY) \
  launch_fwd<DM, TY>(q, k, v, o, lse, B, Tq, S, H, KV, d, causal, window, \
                     cap, st)
  if (dtype == 0)
    return d <= 64 ? FA_FWD(64, float) : d <= 128 ? FA_FWD(128, float)
                                                  : FA_FWD(256, float);
  if (dtype == 1)
    return d <= 64    ? FA_FWD(64, __nv_bfloat16)
           : d <= 128 ? FA_FWD(128, __nv_bfloat16)
                      : FA_FWD(256, __nv_bfloat16);
#undef FA_FWD
  return kBadArgs;
}

// Backward: the forward's inputs (the same cap), its o and lse, and dO
// (B,T,H,d) -> dk, dv in the inputs' type and dQ added into dq_acc
// (B,T,H,d) f32, which the caller zeroes; `Dv` is (B,H,T) f32 scratch. Two
// launches: D = rowsum(dO o O), then the fused dK/dV/dQ kernel.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   float* Dv, float* dq_acc, void* dk,
                                   void* dv,
                                   int B, int Tq, int S, int H, int KV, int d,
                                   int causal, int window, float cap,
                                   void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV || d <= 0 || d > 256 || S <= 0) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_BWD(DM, TY)                                                  \
  launch_bwd<DM, TY>(q, k, v, o, lse, dout, Dv, dq_acc, dk, dv, B, Tq, S, H, \
                     KV, d, causal, window, cap, st)
  if (dtype == 0)
    return d <= 64 ? FA_BWD(64, float) : d <= 128 ? FA_BWD(128, float)
                                                  : FA_BWD(256, float);
  if (dtype == 1)
    return d <= 64    ? FA_BWD(64, __nv_bfloat16)
           : d <= 128 ? FA_BWD(128, __nv_bfloat16)
                      : FA_BWD(256, __nv_bfloat16);
#undef FA_BWD
  return kBadArgs;
}
