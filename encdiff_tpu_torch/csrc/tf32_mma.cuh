// 3xTF32 and asynchronous-copy helpers shared by the tensor-core kernels
// (attention_core.cu, flash_attention.cu, fused_attention.cu).
//
// 3xTF32: an fp32 product on the tensor cores in fp32-equivalent precision.
// Each fp32 operand a is split into two tf32 operands, hi and lo (split()),
// and a product a b accumulates lo_a hi_b, hi_a lo_b, then hi_a hi_b on
// mma.sync.m16n8k8 (tf32 inputs, fp32 accumulators). hi holds a's leading
// 11 significant bits and lo the next 11, so what is dropped (lo lo and
// lo's rounding) is about 2^-22 of each product: the error of an fp32 sum.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// a = hi + lo with hi and lo tf32 operands: hi = cvt.rna.tf32(a) and
// lo = cvt.rna.tf32(a - hi). The rounding (to nearest, ties away from zero)
// is done on the bits: add half a tf32 ulp (0x1000) and drop the low 13
// bits. On every finite value that equals cvt.rna.tf32.f32, which the
// compiler expands to four instructions (with an Inf/NaN guard; no input
// here is infinite). The tensor cores read only a tf32 operand's top 19
// bits, so the operands go in unmasked and hi is masked only to form lo:
// four instructions per split instead of nine.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) + 0x1000u;
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// A cheaper split for operands that enter a sum linearly (the flash
// backward's P and dS): hi is a itself, which the tensor cores truncate to
// tf32, and lo = a - trunc(a), truncated in turn: two instructions where
// split() takes four. What is lost is at most 2^-20 of a (lo's
// truncation), always towards zero, against 2^-22 for split(); not for the
// scores, whose error the exponential amplifies.
__device__ __forceinline__ void split_trunc(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a);
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
}

// d += a b on one m16n8k8 tile: a the A fragment (rows g, g + 8 at k-slots
// t, t + 4 of lane 4 g + t), (b0, b1) the B fragment (k-slots t, t + 4 of
// column g).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b + c on one m16n8k8 tile (c in other registers: a chain's first
// term can start from a bias instead of zeros).
__device__ __forceinline__ void mma_tf32_c(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// 2^x on the SFU, denormal results flushed to zero (ex2.approx.ftz): one
// instruction, where exp2f and expf add a range fix-up around it.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A operand of one k-step, split: rows g and g + 8 of a 16-row tile at
// k-slots t and t + 4 (lane = 4 g + t).
__device__ __forceinline__ void split_a(float g_t, float g8_t, float g_t4,
                                        float g8_t4, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(g_t, hi[0], lo[0]);
  split(g8_t, hi[1], lo[1]);
  split(g_t4, hi[2], lo[2]);
  split(g8_t4, hi[3], lo[3]);
}

// split_a with split_trunc.
__device__ __forceinline__ void split_a_trunc(float g_t, float g8_t, float g_t4,
                                              float g8_t4, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_trunc(g_t, hi[0], lo[0]);
  split_trunc(g8_t, hi[1], lo[1]);
  split_trunc(g_t4, hi[2], lo[2]);
  split_trunc(g8_t4, hi[3], lo[3]);
}

// One 16-byte asynchronous copy into shared memory (zeros where !pred);
// src and dst on 16 bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// One 4-byte asynchronous copy into shared memory (zero where !pred).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(saddr), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- 3xTF32 products of the attention backward kernels (flash_attention.cu,
// attention_core.cu): the A operand of a warp's m16 tiles, the B operands
// read from a tile split once into hi and lo in shared memory, and the
// per-tile partial sums.

// Rows row0 + 16 mt (+ 8) of a row-strided (N, DH) tensor, times mul, as
// split A operands in the natural order: k-step c holds dims 8c + t (slot t)
// and 8c + t + 4 (slot t + 4). Rows past N are zeros.
template <int DH, int MT>
__device__ __forceinline__ void load_a(const float* x, long long rs, int row0, int N,
                                       int t, float mul, uint32_t (&hi)[MT][DH / 8][4],
                                       uint32_t (&lo)[MT][DH / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      float f[2][2];  // [row g, g + 8][dim 8c + t, 8c + t + 4]
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * mt + 8 * r;
#pragma unroll
        for (int s = 0; s < 2; ++s)
          f[r][s] = row < N ? x[(long long)row * rs + 8 * c + t + 4 * s] * mul : 0.f;
      }
      split_a(f[0][0], f[1][0], f[0][1], f[1][1], hi[mt][c], lo[mt][c]);
    }
}

// The B operand of a k-step over dh (S = q k^T, dP = dO v^T and their
// transposes) from a split tile: row 8 j + g at dims 8c + t and 8c + t + 4.
__device__ __forceinline__ void row_b(const uint32_t* hi, const uint32_t* lo, int off,
                                      uint32_t (&h)[2], uint32_t (&l)[2]) {
  h[0] = hi[off];
  h[1] = hi[off + 4];
  l[0] = lo[off];
  l[1] = lo[off + 4];
}

// The B operand of a k-step over one 8-row group of a split tile (dq += dS
// k, dv += P^T dO, dk += dS^T q): rows 2t (slot t) and 2t + 1 (slot t + 4)
// at column g of an 8-column group, the order in which the S accumulator
// holds the group's columns.
template <int LD>
__device__ __forceinline__ void col_b(const uint32_t* hi, const uint32_t* lo, int off,
                                      uint32_t (&h)[2], uint32_t (&l)[2]) {
  h[0] = hi[off];
  h[1] = hi[off + LD];
  l[0] = lo[off];
  l[1] = lo[off + LD];
}

// acc[m][j] += a[m][j] b[j] over MT x G tiles as 3xTF32: the lo-hi, hi-lo,
// then hi-hi terms, each over all the tiles before the next, so that MT x G
// mma chains overlap.
template <int MT, int G>
__device__ __forceinline__ void mma3(float (&acc)[MT][G][4], const uint32_t (&ahi)[MT][G][4],
                                     const uint32_t (&alo)[MT][G][4],
                                     const uint32_t (&bhi)[G][2], const uint32_t (&blo)[G][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[m][j], alo[m][j], bhi[j][0], bhi[j][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[m][j], ahi[m][j], blo[j][0], blo[j][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[m][j], ahi[m][j], bhi[j][0], bhi[j][1]);
}

// The A operand of k-step c of a warp's m16 tiles, from registers that hold
// every k-step split once.
template <int MT, int KS>
__device__ __forceinline__ void frag_regs(const uint32_t (&h)[MT][KS][4],
                                          const uint32_t (&l)[MT][KS][4], int c,
                                          uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[m][e] = h[m][c][e];
      lo[m][e] = l[m][c][e];
    }
}

// acc (+)= a b for one k-step of S = q k^T - lse, dP = dO v^T - delta or
// their transposes, over MT x G tiles, with one A operand per m-tile shared
// by the G column groups. On the first k-step the sums start from init(m,
// j) (-lse or -delta, or zeros) instead of acc, so the subtraction rides on
// an mma. The hi-hi term goes first, where it meets the bias it mostly
// cancels (scores near lse are the ones that matter), and the lo terms
// follow into a small sum: the tensor cores align a sum to its largest
// addend, so small terms added to a sum near -lse (up to 43 in log2 units
// at logits of 30) would each lose an ulp of 43.
template <int MT, int G, class Init>
__device__ __forceinline__ void mma3_step(float (&acc)[MT][G][4], Init init, bool first,
                                          const uint32_t (&ahi)[MT][4],
                                          const uint32_t (&alo)[MT][4],
                                          const uint32_t (&bhi)[G][2],
                                          const uint32_t (&blo)[G][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (first)
        mma_tf32_c(acc[m][j], ahi[m], bhi[j][0], bhi[j][1], init(m, j));
      else
        mma_tf32(acc[m][j], ahi[m], bhi[j][0], bhi[j][1]);
    }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[m][j], alo[m], bhi[j][0], bhi[j][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(acc[m][j], ahi[m], blo[j][0], blo[j][1]);
}

// mma3_step with the A operand of k-step c from registers (the flash
// backward's q, dO, k and v).
template <int MT, int G, int KS, class Init>
__device__ __forceinline__ void mma3_rows(float (&acc)[MT][G][4], Init init,
                                          const uint32_t (&ahi)[MT][KS][4],
                                          const uint32_t (&alo)[MT][KS][4], int c,
                                          const uint32_t (&bhi)[G][2],
                                          const uint32_t (&blo)[G][2]) {
  uint32_t h[MT][4], l[MT][4];
  frag_regs<MT, KS>(ahi, alo, c, h, l);
  mma3_step<MT, G>(acc, init, c == 0, h, l, bhi, blo);
}

// The A operands of 8-column groups left in the accumulator layout: lane t
// holds columns 2t and 2t + 1, which become k-slots t and t + 4. P and dS
// enter the sums linearly, so they take the two-instruction split_trunc.
template <int MT, int G>
__device__ __forceinline__ void split_acc(const float (&x)[MT][G][4], uint32_t (&hi)[MT][G][4],
                                          uint32_t (&lo)[MT][G][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < G; ++j)
      split_a_trunc(x[m][j][0], x[m][j][2], x[m][j][1], x[m][j][3], hi[m][j], lo[m][j]);
}

template <int D, int M, int G>
__device__ __forceinline__ void zero(float (&x)[D][M][G][4]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[d][m][j][e] = 0.f;
}

// total += the G partial sums of one tile, in order. The tensor cores
// truncate each mma's sum, a bias of up to an ulp of the sum per mma: run
// over all of N (768 mma a sum at N = 4096), it took dk at logits of 30
// past the 1e-4 gate against an fp32 reference. A tile's sums take 12 mma
// from zero, and the totals one round-to-nearest add a tile.
template <int D, int M, int G>
__device__ __forceinline__ void add_tile(float (&total)[D][M][4],
                                         const float (&part)[D][M][G][4]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[d][m][e] += part[d][m][j][e];
}

}  // namespace tf32
