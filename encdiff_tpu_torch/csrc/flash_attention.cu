// Flash self-attention, fp32: the forward (o and the logsumexp) and the two
// backward kernels (dq, and dk with dv) that read the saved logsumexp.
//
// Replaces the TPU kernels of encdiff_tpu/nn/pallas/flash_attention.py:
// _flash_fwd_impl (_fwd_kernel), and _flash_core_bwd's dq call (_dq_kernel)
// and dk/dv call (_dkv_kernel). The JAX package routes self-attention there
// when N == M >= 1024 and N % 512 == 0: the UNet's 64x64 and 32x32 levels
// (dh 8 and 16) and the VQ encoder's mid AttnBlock (dh 128, forward only) of
// the faces configuration.
//
// The arithmetic is the TPU kernels': the scale is folded into q, so the
// logsumexp lse = m + log(l) is in units of the scaled scores, and
//   o  = softmax(q k^T * scale) v,
//   P  = exp(q k^T * scale - lse),  dP = dO v^T,
//   dS = P o (dP - delta),          delta = rowsum(dO o o)  (from the caller),
//   dq = dS k * scale,  dk = dS^T (q * scale),  dv = P^T dO.
// Inside the kernels the scores are carried in log2 units (the scale times
// log2(e) is folded into q, or into k) so that every exponential is one
// base-2 exponential; lse crosses device memory in natural-log units, as the
// TPU's does.
//
// What is not carried over from the TPU: the wrapper there pads dh to 128
// lanes, broadcasts lse to 8 lanes and uses blocks of 512 (256 backward).
// Here dh stays 8, 16 or 128, lse is (B * H, N) fp32, and any N is taken.
// Every tensor is addressed through its own batch, head and row strides with
// the last dimension contiguous, so the callers' (B, N, H, dh) projections
// are read in place and o, dq, dk, dv are written into (B, N, H, dh)-backed
// buffers: merging the heads costs no copy. batch * head is gridDim.x (no
// 65,535 limit); the row tiles are gridDim.y.
//
// Forward: the products on the tensor cores in fp32-equivalent precision
// (3xTF32 on mma.sync).
// - Tiling: a block of 8 warps takes 128 query rows of one (batch, head);
//   each warp owns 16 of them. K and V stream through a 3-stage shared ring
//   of 64 keys (32 at dh 128) by cp.async, 16 bytes a thread, so that two
//   tiles load while one is used; 128 rows a block halve the K/V traffic
//   from L2 of 64. A ragged last tile is zero-filled and its keys past N are
//   masked to -inf; rows past N run on zeros and store nothing. q, k and v
//   rows must start on 16 bytes (the wrapper checks). q (times scale *
//   log2 e) sits in registers as split tf32 A operands at dh 8 and 16; at
//   dh 128, where that would take 128 registers a thread beside the 64 of
//   the output sum, it sits in shared memory and is split where it is used.
// - Products: S = q k^T and O += P v on mma.sync.m16n8k8 (tf32 inputs, fp32
//   accumulators). Each fp32 operand a is split into hi = cvt.rna.tf32(a)
//   and lo = cvt.rna.tf32(a - hi) (computed on the bits, see split()), and
//   a product accumulates lo*hi, hi*lo, then hi*hi (small terms first). hi
//   holds a's leading 11 significant bits and lo the next 11, so what is
//   dropped (lo*lo and lo's rounding) is about 2^-22 of each product: the
//   error of an fp32 sum over dh, where one tf32 pass (2^-11) would miss the
//   1e-4 gate at dh 128 with logits of order 10. Each term runs over four
//   accumulators before the next (four key groups of S; key and output
//   groups of O, with 4 or 2 partial sums of O at dh 8 and 16), so that
//   four mma chains overlap instead of one waiting on the last.
// - Layouts: the sum over dh runs in a permuted order, chosen so that a
//   lane's B values of a k-step (of two k-steps at dh >= 16) are neighbours
//   in a K row: one 8- or 16-byte shared read; q is read in the same order.
//   The S accumulator gives lane t of a quad keys 2t and 2t + 1 of each
//   8-key group, where the A operand of P v wants k-slots t and t + 4: P
//   stays where it is (key 2t is slot t, key 2t + 1 is slot t + 4) and V's
//   rows are read in that permuted order (row 2t for slot t, row 2t + 1 for
//   slot t + 4), a permutation of V's rows in place of a shuffle of P. K
//   rows are padded to 8, 16 or 144 floats, V rows to dh + 4 and q rows to
//   dh + 16, so that every fragment read is free of bank conflicts.
// - Softmax: online, in log2 units, on the accumulator registers: the row
//   maximum by two quad shuffles per tile, the row sum kept per lane and
//   reduced once at the end; each exponential one ex2.approx.ftz; lse =
//   (m + log2 l) ln 2.
// - Bound on the H100: at dh 128 the tensor cores, 4 N^2 dh flops per
//   (batch, head), three times over, at 495 TFLOP/s of dense TF32; at dh 8
//   the N^2 exponentials at 16 per SM and clock (the SFU) come first and
//   the products second. The kernel stays well above both: at dh 128 it
//   averages one m16n8k8 per 12.9 cycles of an SM sub-partition (splits and
//   softmax included), and at dh 8 its loop runs some 550 instructions per
//   64-key tile (half of them the splits of k, P and v). Whether mma.sync's
//   own TF32 rate is the limit is not measured.
//
// Backward (dq, dk/dv): fp32 on the CUDA cores.
// - dq: query-parallel, one thread per row holding q, dO, its lse and delta
//   and the dq sum; K and V tiles in shared memory. The row statistics are
//   read, not recomputed.
// - dk/dv: key-parallel, one thread per key holding k, v and the two sums;
//   it loops over every query tile (q, dO, lse and delta in shared memory).
//   No atomics and a fixed summation order: a run repeats bit for bit.
// - Bound: operations. Per score 4 dh (dk/dv) or 3 dh (dq) multiply-adds
//   and one exponential, fp32 on the CUDA cores (67 TFLOP/s).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kThreads = 128;      // backward: threads per block
constexpr int kTileFloats = 4096;  // backward: one K (or q) tile and one V (or dO) tile, 16 KB each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- forward
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kFwdWarps;  // query rows per block, 16 per warp
constexpr int kFwdStages = 3;             // K/V tiles in the shared ring

template <int DH>
struct Fwd {
  static constexpr int kKeys = DH == 128 ? 32 : 64;      // keys per tile
  static constexpr int kVec = DH == 8 ? 2 : 4;            // floats per fragment read
  static constexpr int kChunks = DH / (4 * kVec);         // fragment reads per row
  static constexpr int kLdk = DH == 128 ? DH + 16 : DH;   // 8 (dh 8) or 16 mod 32
  static constexpr int kLdv = DH + 4;                     // 4 or 12 mod 16
  // q: split in registers at dh 8 and 16; at dh 128 (64 more registers a
  // thread) scaled in shared memory, split where it is used
  static constexpr bool kQShared = DH == 128;
  static constexpr int kLdq = DH + 16;                    // 16 mod 32
  static constexpr int kQFloats = kQShared ? kFwdRows * kLdq : 0;
  static constexpr int kStage = kKeys * (kLdk + kLdv);    // floats per stage
  static constexpr int kSmem = (kQFloats + kFwdStages * kStage) * 4;  // bytes
  // P v runs over kJG key groups x kDG output groups at a time: four
  // independent accumulators, so that the mma chains overlap (at dh 8 and 16
  // the key groups go to kJG partial sums of o)
  static constexpr int kJG = DH == 8 ? 4 : DH == 16 ? 2 : 1;
  static constexpr int kDG = 4 / kJG;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

template <int DH>
__global__ void __launch_bounds__(kFwdThreads, DH == 128 ? 1 : 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int N,
                 int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                 int vsb, int vsh, int vsn, int osb, int osh, int osn,
                 float scale) {
  using F = Fwd<DH>;
  constexpr int KT = F::kKeys, VEC = F::kVec, NCH = F::kChunks, KS = VEC / 2;
  constexpr int LDK = F::kLdk, LDV = F::kLdv, LDQ = F::kLdq;
  constexpr int NT = KT / 8;  // 8-key groups of a tile
  constexpr int DT = DH / 8;  // 8-column groups of the output
  constexpr int JG = F::kJG, DG = F::kDG;
  constexpr int CPR = DH / 4;  // 16-byte copies per K or V row
  static_assert(NT % 4 == 0 && NT % JG == 0 && DT % DG == 0, "whole groups");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // F::kQFloats
  float* ring = smem + F::kQFloats;  // kFwdStages K/V tiles

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kFwdRows + warp * 16 + g;  // and row0 + 8

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float qscale = scale * kLog2e;  // scores in log2 units

  // q in the permuted order: read c of a row holds dims c * 4 VEC + VEC t
  // + i, and (i = 2p, 2p + 1) are slots (t, t + 4) of the read's k-step p
  uint32_t qhi[KS][4], qlo[KS][4];  // dh 8 and 16: NCH == 1
  if constexpr (F::kQShared) {
    for (int e = threadIdx.x; e < kFwdRows * DH / 4; e += kFwdThreads) {
      const int r = e / (DH / 4), c = 4 * (e % (DH / 4));
      const int row = blockIdx.y * kFwdRows + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < N) x = *reinterpret_cast<const float4*>(qb + (long long)row * qsn + c);
      *reinterpret_cast<float4*>(qs + r * LDQ + c) =
          make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
    }  // the first tile's barrier publishes it
  } else {
    float qf[2][VEC];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < N) {
        load_vec<VEC>(qb + (long long)row * qsn + VEC * t, qf[r]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) qf[r][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[r][i] *= qscale;
    }
#pragma unroll
    for (int p = 0; p < KS; ++p)
      split_a(qf[0][2 * p], qf[1][2 * p], qf[0][2 * p + 1], qf[1][2 * p + 1],
              qhi[p], qlo[p]);
  }

  float oacc[JG][DT][4];
#pragma unroll
  for (int a = 0; a < JG; ++a)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[a][d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int ntiles = (N + KT - 1) / KT;
  auto load_tile = [&](int tile) {
    float* ks = ring + (tile % kFwdStages) * F::kStage;
    float* vs = ks + KT * LDK;
#pragma unroll
    for (int i = 0; i < (KT * CPR + kFwdThreads - 1) / kFwdThreads; ++i) {
      const int e = threadIdx.x + i * kFwdThreads;
      if (KT * CPR % kFwdThreads != 0 && e >= KT * CPR) break;
      const int r = e / CPR, c = e % CPR;
      const int key = tile * KT + r;
      const bool ok = key < N;
      const long long kr = ok ? key : 0;
      cp_async16(ks + r * LDK + 4 * c, kb + kr * ksn + 4 * c, ok);
      cp_async16(vs + r * LDV + 4 * c, vb + kr * vsn + 4 * c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kFwdStages - 2>();  // this thread's copies of the tile landed
    __syncthreads();                  // everyone's; and tile - 1 is consumed
    if (tile + kFwdStages - 1 < ntiles) load_tile(tile + kFwdStages - 1);
    cp_async_commit();
    const float* ks = ring + (tile % kFwdStages) * F::kStage;
    const float* vs = ks + KT * LDK;

    // S = q k^T: rows g, g + 8; keys 8 j + 2t, 8 j + 2t + 1 of the tile.
    // Four key groups at a time, each product term over the four before the
    // next term, so that four accumulator chains overlap.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      uint32_t ahi[KS][4], alo[KS][4];
      if constexpr (F::kQShared) {
        const float* qr = qs + (warp * 16 + g) * LDQ + c * 4 * VEC + VEC * t;
        float x0[VEC], x1[VEC];
        load_vec<VEC>(qr, x0);
        load_vec<VEC>(qr + 8 * LDQ, x1);
#pragma unroll
        for (int p = 0; p < KS; ++p)
          split_a(x0[2 * p], x1[2 * p], x0[2 * p + 1], x1[2 * p + 1], ahi[p], alo[p]);
      } else {
#pragma unroll
        for (int p = 0; p < KS; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[p][e] = qhi[p][e];
            alo[p][e] = qlo[p][e];
          }
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += 4) {
        uint32_t bhi[4][VEC], blo[4][VEC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float kv[VEC];
          load_vec<VEC>(ks + ((j0 + jj) * 8 + g) * LDK + c * 4 * VEC + VEC * t, kv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) split(kv[i], bhi[jj][i], blo[jj][i]);
        }
#pragma unroll
        for (int p = 0; p < KS; ++p) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            mma_tf32(s[j0 + jj], alo[p], bhi[jj][2 * p], bhi[jj][2 * p + 1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            mma_tf32(s[j0 + jj], ahi[p], blo[jj][2 * p], blo[jj][2 * p + 1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            mma_tf32(s[j0 + jj], ahi[p], bhi[jj][2 * p], bhi[jj][2 * p + 1]);
        }
      }
    }
    const int key0 = tile * KT;
    if (key0 + KT > N) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
    }

    // online softmax; every tile holds a key below N, so mx is finite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_sfu(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int a = 0; a < JG; ++a)
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        oacc[a][d][0] *= corr[0];
        oacc[a][d][1] *= corr[0];
        oacc[a][d][2] *= corr[1];
        oacc[a][d][3] *= corr[1];
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2_sfu(s[j][0] - m[0]);
      s[j][1] = exp2_sfu(s[j][1] - m[0]);
      s[j][2] = exp2_sfu(s[j][2] - m[1]);
      s[j][3] = exp2_sfu(s[j][3] - m[1]);
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
    }

    // O += P v: the 8 keys of group j are one k-step, key 2t in slot t and
    // key 2t + 1 in slot t + 4, so V's rows are read in that order: row
    // 2t for slot t and row 2t + 1 for slot t + 4
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += JG) {
      uint32_t phi[JG][4], plo[JG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
        split_a(s[j0 + jj][0], s[j0 + jj][2], s[j0 + jj][1], s[j0 + jj][3],
                phi[jj], plo[jj]);
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += DG) {
        uint32_t vhi[JG][DG][2], vlo[JG][DG][2];
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          const float* v0 = vs + ((j0 + jj) * 8 + 2 * t) * LDV + g;
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) {
            split(v0[(d0 + dd) * 8], vhi[jj][dd][0], vlo[jj][dd][0]);
            split(v0[LDV + (d0 + dd) * 8], vhi[jj][dd][1], vlo[jj][dd][1]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
#pragma unroll
          for (int dd = 0; dd < DG; ++dd)
            mma_tf32(oacc[jj][d0 + dd], plo[jj], vhi[jj][dd][0], vhi[jj][dd][1]);
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
#pragma unroll
          for (int dd = 0; dd < DG; ++dd)
            mma_tf32(oacc[jj][d0 + dd], phi[jj], vlo[jj][dd][0], vlo[jj][dd][1]);
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
#pragma unroll
          for (int dd = 0; dd < DG; ++dd)
            mma_tf32(oacc[jj][d0 + dd], phi[jj], vhi[jj][dd][0], vhi[jj][dd][1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = o + (long long)b * osb + (long long)h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < N) {
      const float inv = 1.f / l[r];
      float* orow = ob + (long long)row * osn + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        float o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int a = 0; a < JG; ++a) {
          o0 += oacc[a][d][2 * r];
          o1 += oacc[a][d][2 * r + 1];
        }
        *reinterpret_cast<float2*>(orow + d * 8) = make_float2(o0 * inv, o1 * inv);
      }
      if (t == 0) lse[(long long)bh * N + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int N,
                int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                int dsb, int dsh, int dsn, float scale) {
  constexpr int KT = kTileFloats / DH;  // keys per tile
  __shared__ float ks[KT * DH];
  __shared__ float vs[KT * DH];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int row = blockIdx.y * kThreads + threadIdx.x;
  const bool active = row < N;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;

  const float qscale = scale * kLog2e;
  float qr[DH], gr[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = active ? qb[(long long)row * qsn + i] * qscale : 0.f;
    gr[i] = active ? gb[(long long)row * gsn + i] : 0.f;
    acc[i] = 0.f;
  }
  const float L = active ? lse[(long long)bh * N + row] * kLog2e : 0.f;
  const float dl = active ? delta[(long long)bh * N + row] : 0.f;

  for (int t0 = 0; t0 < N; t0 += KT) {
    const int kt = min(KT, N - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < kt * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      ks[e] = kb[(long long)(t0 + j) * ksn + d];
      vs[e] = vb[(long long)(t0 + j) * vsn + d];
    }
    __syncthreads();
    for (int j = 0; j < kt; ++j) {
      const float* kj = ks + j * DH;
      const float* vj = vs + j * DH;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        sc += qr[i] * kj[i];
        dp += gr[i] * vj[i];
      }
      const float ds = exp2f(sc - L) * (dp - dl);
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] += ds * kj[i];
    }
  }
  if (active) {
    float* db = dq + (long long)b * dsb + (long long)h * dsh + (long long)row * dsn;
#pragma unroll
    for (int i = 0; i < DH; ++i) db[i] = acc[i] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int N,
                  int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                  int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                  int dksb, int dksh, int dksn, int dvsb, int dvsh, int dvsn,
                  float scale) {
  constexpr int QT = kTileFloats / DH;  // query rows per tile
  __shared__ float qs[QT * DH];         // q * scale
  __shared__ float gs[QT * DH];         // dO
  __shared__ float ls[QT];              // lse in log2 units
  __shared__ float dls[QT];             // delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int key = blockIdx.y * kThreads + threadIdx.x;
  const bool active = key < N;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;
  const float* lb = lse + (long long)bh * N;
  const float* db = delta + (long long)bh * N;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    kr[i] = active ? kb[(long long)key * ksn + i] * kLog2e : 0.f;
    vr[i] = active ? vb[(long long)key * vsn + i] : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }

  for (int t0 = 0; t0 < N; t0 += QT) {
    const int nt = min(QT, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * DH; e += kThreads) {
      const int r = e / DH;
      const int d = e % DH;
      qs[e] = qb[(long long)(t0 + r) * qsn + d] * scale;
      gs[e] = gb[(long long)(t0 + r) * gsn + d];
    }
    for (int r = threadIdx.x; r < nt; r += kThreads) {
      ls[r] = lb[t0 + r] * kLog2e;
      dls[r] = db[t0 + r];
    }
    __syncthreads();
    for (int r = 0; r < nt; ++r) {
      const float* qi = qs + r * DH;
      const float* gi = gs + r * DH;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        sc += qi[i] * kr[i];
        dp += gi[i] * vr[i];
      }
      const float p = exp2f(sc - ls[r]);
      const float ds = p * (dp - dls[r]);
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        dvr[i] += p * gi[i];
        dkr[i] += ds * qi[i];
      }
    }
  }
  if (active) {
    float* dkb = dk + (long long)b * dksb + (long long)h * dksh + (long long)key * dksn;
    float* dvb = dv + (long long)b * dvsb + (long long)h * dvsh + (long long)key * dvsn;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dkb[i] = dkr[i];
      dvb[i] = dvr[i];
    }
  }
}


bool bad_shape(int B, int H, int N, int rows_per_block) {
  if (B <= 0 || H <= 0 || N <= 0) return true;
  if ((long long)B * H > 2147483647LL) return true;
  return (N + rows_per_block - 1) / rows_per_block > 65535;
}

// cp.async and the vector reads of q need every q, k, v row on 16 bytes.
bool rows_aligned(const void* p, const int* s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s[0] % 4 == 0 &&
         s[1] % 4 == 0 && s[2] % 4 == 0;
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
               int B, int H, int N, const int* s, float scale, cudaStream_t st) {
  if (bad_shape(B, H, N, kFwdRows)) return (int)cudaErrorInvalidValue;
  if (!rows_aligned(q, s) || !rows_aligned(k, s + 3) || !rows_aligned(v, s + 6) ||
      (reinterpret_cast<uintptr_t>(o) & 7) != 0 || s[9] % 2 || s[10] % 2 || s[11] % 2)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Fwd<DH>::kSmem;
  if (smem > 48 * 1024) {
    // per device, under a lock: ctypes drops the GIL, so threads may launch
    // at once
    constexpr int kDevices = 64;
    static std::mutex lock;
    static bool opted_in[kDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidValue;
    std::lock_guard<std::mutex> hold(lock);
    if (!opted_in[dev]) {
      err = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      opted_in[dev] = true;
    }
  }
  const dim3 grid(B * H, (N + kFwdRows - 1) / kFwdRows);
  flash_fwd_kernel<DH><<<grid, kFwdThreads, smem, st>>>(
      q, k, v, o, lse, H, N, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11], scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v, const float* g,
              const float* lse, const float* delta, float* dq, int B, int H, int N,
              const int* s, float scale, cudaStream_t st) {
  if (bad_shape(B, H, N, kThreads)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (N + kThreads - 1) / kThreads);
  flash_dq_kernel<DH><<<grid, kThreads, 0, st>>>(
      q, k, v, g, lse, delta, dq, H, N, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14], scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkdv(const float* q, const float* k, const float* v, const float* g,
                const float* lse, const float* delta, float* dk, float* dv, int B,
                int H, int N, const int* s, float scale, cudaStream_t st) {
  if (bad_shape(B, H, N, kThreads)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (N + kThreads - 1) / kThreads);
  flash_dkdv_kernel<DH><<<grid, kThreads, 0, st>>>(
      q, k, v, g, lse, delta, dk, dv, H, N, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15], s[16],
      s[17], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Every function below runs on `stream`, allocates nothing and returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue for a head size
// or shape it does not take). Strides are in elements, (batch, head, row)
// for each tensor in argument order; the last dimension of every tensor has
// stride 1. lse and delta are contiguous (B * H, N) fp32. The forward also
// needs q, k and v on 16 bytes with strides that are multiples of 4, and o
// on 8 bytes with even strides.

// q, k, v (B, H, N, DH) -> o (B, H, N, DH) and lse; strides of q, k, v, o.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int N, int DH,
                                   const int* strides, float scale, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  float* lf = (float*)lse;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8: return launch_fwd<8>(qf, kf, vf, of, lf, B, H, N, strides, scale, st);
    case 16: return launch_fwd<16>(qf, kf, vf, of, lf, B, H, N, strides, scale, st);
    case 128: return launch_fwd<128>(qf, kf, vf, of, lf, B, H, N, strides, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq (B, H, N, DH); strides of q, k, v, dO, dq.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse, const void* delta,
                                  void* dq, int B, int H, int N, int DH,
                                  const int* strides, float scale, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* gf = (const float*)dO;
  const float* lf = (const float*)lse;
  const float* df = (const float*)delta;
  float* dqf = (float*)dq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8: return launch_dq<8>(qf, kf, vf, gf, lf, df, dqf, B, H, N, strides, scale, st);
    case 16: return launch_dq<16>(qf, kf, vf, gf, lf, df, dqf, B, H, N, strides, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv (B, H, N, DH); strides of q, k, v, dO, dk, dv.
extern "C" int flash_attention_dkdv(const void* q, const void* k, const void* v,
                                    const void* dO, const void* lse,
                                    const void* delta, void* dk, void* dv, int B,
                                    int H, int N, int DH, const int* strides,
                                    float scale, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* gf = (const float*)dO;
  const float* lf = (const float*)lse;
  const float* df = (const float*)delta;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8:
      return launch_dkdv<8>(qf, kf, vf, gf, lf, df, dkf, dvf, B, H, N, strides, scale, st);
    case 16:
      return launch_dkdv<16>(qf, kf, vf, gf, lf, df, dkf, dvf, B, H, N, strides, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
