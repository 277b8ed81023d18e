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

}  // namespace tf32
