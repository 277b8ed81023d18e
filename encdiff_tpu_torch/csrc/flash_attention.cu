// Flash self-attention, fp32: the forward (o and the logsumexp) and the two
// backward kernels (dq, and dk with dv) that read the saved logsumexp.
//
// Replaces the TPU kernels of encdiff_tpu/nn/pallas/flash_attention.py:
// _flash_fwd_impl (_fwd_kernel), and _flash_core_bwd's dq call (_dq_kernel)
// and dk/dv call (_dkv_kernel). The JAX package routes self-attention there
// when N == M >= 1024 and N % 512 == 0: the UNet's 64x64 and 32x32 levels
// (dh 8 and 16) and the VQ encoder's mid AttnBlock (dh 128, forward only) of
// the faces configuration, whose VQ-GAN first stage trains it (dh 128,
// both directions).
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
//   groups of O), so that four mma chains overlap instead of one waiting on
//   the last. Every sum starts from zero a tile: a score at most 4 k-steps
//   at a time, and each tile's P v per group of output columns, then added
//   in fp32 to the running sum: a running sum fed by every mma over 4,096
//   keys drifted by about 1e-4 of its size (the truncation of add_tile).
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
// Backward (dq, dk/dv): the products on the tensor cores, 3xTF32 on
// mma.sync.m16n8k8 as in the forward, from the saved lse and delta (read,
// not recomputed). Two launches, as on the TPU; no atomics and a fixed order
// of summation, so a second run repeats bit for bit.
// - dq, query-parallel: a block of 4 warps takes 128 query rows, a warp 32
//   (two m16 tiles, so that each B operand read serves both). q (times
//   scale * log2 e) and dO sit in registers as split A operands. K and V
//   stream through a 3-stage cp.async ring of 64 keys. Per 8-key group (two
//   at dh 8, one at dh 16, each with its own accumulators): S - lse = q k^T
//   - lse and dP - delta = dO v^T - delta on the tensor cores (the first mma
//   starts from -lse or -delta), P = exp2(S - lse) and dS = P (dP - delta)
//   on the accumulator registers, dq += dS k with dS left in the S layout
//   and K's rows read in the permuted order (keys 2t, 2t + 1 as k-slots t,
//   t + 4: the forward's P v trick, no shuffle). Keys past N are masked to
//   -inf, so their P and dS are exact zeros against K's zero-filled rows.
// - dk/dv, key-parallel, the same shape of block over keys: k (times scale
//   * log2 e) and v sit in registers; q, dO and their rows' lse and delta
//   stream through the ring (64 query rows a tile). S^T = k q^T and dP^T =
//   v dO^T put P^T and dS^T in the accumulator layout, where they are the A
//   operands of dv += P^T dO and dk += dS^T q, with dO's and q's rows read
//   permuted; lse and delta vary along the columns and come from the tile.
//   Query rows past N are zero-filled with lse and delta 0: their P^T is 1
//   and their dS^T 0, against zero rows of dO and q, so they add exact
//   zeros. dk is scaled once at the end.
// - The split tile: once a tile has landed, the block splits it once into
//   hi and lo arrays in shared memory (and, for dk/dv, writes -lse log2 e
//   and -delta as ready C operands), where split in every warp repeated it
//   four times over and made most of the loop's instructions. Its rows have
//   DH + 4 entries, so that both ways a warp reads it (8 rows g at dims t,
//   t + 4; rows 2t, 2t + 1 at column g) are free of bank conflicts; the sum
//   over dh runs in the natural order (k-step c holds dims 8c + t and 8c +
//   t + 4). P and dS, which enter the sums linearly, take the two-
//   instruction split_trunc; the scores' operands the rounded split, since
//   the exponential amplifies their error.
// - q, k, v and dO rows must start on 16 bytes (the wrapper checks); rows
//   past N store nothing.
// - At dh 128 (the VQ's mid blocks: one head of 128 over 4,096 latents) the
//   registers cannot hold the rows a warp owns as split A operands (256 a
//   thread an m16 tile), nor a warp's 16 x 128 output sums beside their
//   per-tile partial sums (dk and dv: 128 registers each). So one kernel
//   template (flash_bwd128_kernel) takes both directions with another
//   plan: a block of 8 warps owns 64 fixed rows (queries for dq, keys for
//   dk/dv), held raw in shared memory (the first tensor times scale log2 e);
//   the other two tensors stream through a 3-stage cp.async ring of 32 rows
//   at pitch 132 (4 mod 32: every fragment read, along a row or down a
//   column, is free of bank conflicts), and every operand is split where it
//   is read. The warps pair up on 16 fixed rows: one computes S - lse, the
//   other dP - delta (each 12 mma a chunk of 4 k-steps, summed from zero and
//   added, since a sum over all of dh near -lse would drift), they swap them
//   through shared memory, and each forms P and dS and takes half of the
//   output columns (dq += dS k; dk += dS^T q and dv += P^T dO), summing each
//   tile into fresh registers as above. That keeps 32 (dq) or 64 (dk/dv)
//   output registers a thread, and no product is computed twice. 186 KB of
//   shared memory: one block of 8 warps an SM.
// - Bound on the H100: the tensor cores, three tf32 passes of 3 (dq) or 4
//   (dk/dv) products of 2 N^2 dh flops per (batch, head) at 495 TFLOP/s; the
//   N^2 exponentials at 16 per SM and clock come second (dq at dh 8: 0.31
//   against 0.26 ms at (8, 8, 4096, 8)). mma.sync itself reaches 6.03 cycles
//   an m16n8k8 per SM sub-partition (355 TFLOP/s, chip_smoke's mma-rate
//   phase), which puts the loops' 144 (dq) and 192 (dk/dv) mma a tile near
//   their issue count: the kernels run at about half that pipe's rate,
//   held back by the mma chains' 24-cycle latency at 12 warps an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "launch.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tf32;

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
  // independent accumulators, so that the mma chains overlap
  static constexpr int kJG = DH == 8 ? 4 : DH == 16 ? 2 : 1;
  static constexpr int kDG = 4 / kJG;
  // Every sum starts from zero a tile: a score sums at most 4 k-steps (12
  // mma), and each output group a tile's P v over its kJG key groups; both
  // are then added in fp32 (the tensor cores truncate each mma's sum: a
  // running sum fed by 1,536 mma over 4,096 keys drifts by about 1e-4 of
  // its size, see add_tile). At dh 8 and 16 a score is one chunk, summed
  // into s itself, and o's rescaling by the softmax's correction is the
  // same FMA that adds a tile
  static constexpr int kScoreChunks = kChunks < 2 ? kChunks : 2;  // fragment reads
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

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
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
    constexpr int SCH = F::kScoreChunks;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < NCH; c0 += SCH) {
      float sc[NT][4];
      float (&acc)[NT][4] = c0 == 0 ? s : sc;  // the first chunk sums into s
      if (c0 > 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
#pragma unroll
      for (int c = c0; c < c0 + SCH; ++c) {
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
              mma_tf32(acc[j0 + jj], alo[p], bhi[jj][2 * p], bhi[jj][2 * p + 1]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              mma_tf32(acc[j0 + jj], ahi[p], blo[jj][2 * p], blo[jj][2 * p + 1]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              mma_tf32(acc[j0 + jj], ahi[p], bhi[jj][2 * p], bhi[jj][2 * p + 1]);
          }
        }
      }
      if (c0 > 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += sc[j][e];
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
    // 2t for slot t and row 2t + 1 for slot t + 4. Every key group's P is
    // split first; then each DG output groups sum the tile from zero over
    // JG key groups at a time (JG x DG chains), and o's running sum takes
    // them as o corr + the tile's sum
    uint32_t phi[NT][4], plo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      split_a(s[j][0], s[j][2], s[j][1], s[j][3], phi[j], plo[j]);
#pragma unroll
    for (int d0 = 0; d0 < DT; d0 += DG) {
      float f[JG][DG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int dd = 0; dd < DG; ++dd)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[jj][dd][e] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += JG) {
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
            mma_tf32(f[jj][dd], plo[j0 + jj], vhi[jj][dd][0], vhi[jj][dd][1]);
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
#pragma unroll
          for (int dd = 0; dd < DG; ++dd)
            mma_tf32(f[jj][dd], phi[j0 + jj], vlo[jj][dd][0], vlo[jj][dd][1]);
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
#pragma unroll
          for (int dd = 0; dd < DG; ++dd)
            mma_tf32(f[jj][dd], phi[j0 + jj], vhi[jj][dd][0], vhi[jj][dd][1]);
      }
#pragma unroll
      for (int dd = 0; dd < DG; ++dd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float tile_sum = f[0][dd][e];
#pragma unroll
          for (int jj = 1; jj < JG; ++jj) tile_sum += f[jj][dd][e];
          oacc[d0 + dd][e] = fmaf(oacc[d0 + dd][e], corr[e >> 1], tile_sum);
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
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(orow + d * 8) =
            make_float2(oacc[d][2 * r] * inv, oacc[d][2 * r + 1] * inv);
      if (t == 0) lse[(long long)bh * N + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ---- backward: dq (query-parallel) and dk/dv (key-parallel)
constexpr int kBwdRows = 128;   // query rows (dq) or keys (dk/dv) a block owns
constexpr int kBwdTile = 64;    // keys (dq) or query rows (dk/dv) a streamed tile holds
constexpr int kBwdStages = 3;   // tiles in the shared ring

template <int DH>
struct Bwd {
  // m16 tiles (16 rows each) a warp owns: each B operand read from the
  // split tile serves both (faster than one at both faces shapes)
  static constexpr int kTiles = 2;
  static constexpr int kWarps = kBwdRows / (16 * kTiles);
  static constexpr int kThreads = 32 * kWarps;
  // blocks an SM the registers must allow: 3 at dh 8 (at most 170
  // registers a thread); 2 at dh 16, whose k and v fragments and the
  // two-level sums do not fit 170 without spills (its 512 blocks take two
  // rounds of the card at either count)
  static constexpr int kMinBlocks = DH == 8 ? 3 : 2;
  // 8-column groups of a tile taken at a time: kTiles * kGroups independent
  // accumulators per product (4 at dh 8, 2 at dh 16)
  static constexpr int kGroups = DH == 8 ? 2 : 1;
  // a ring stage as copied: the rows of two tensors at pitch DH, then (dk/dv)
  // those rows' lse and delta
  static constexpr int kStage = 2 * kBwdTile * DH + 2 * kBwdTile;
  // the split tile: hi and lo of both tensors at pitch DH + 4 (4 or 12 mod
  // 16, so that a warp's reads are free of bank conflicts both along a row,
  // 8 rows g at columns t and t + 4, and down a column, rows 2t and 2t + 1
  // at column g), then (dk/dv) the C quads of the column statistics
  static constexpr int kLd = DH + 4;
  static constexpr int kSplit = 4 * kBwdTile * kLd + 4 * kBwdTile;
  static constexpr int kSmem = (kBwdStages * kStage + kSplit) * 4;  // bytes
  static_assert(kSmem <= 48 * 1024, "static shared memory");
};

// Rows [r0, r0 + kBwdTile) of two row-strided (N, DH) tensors a and b into
// one ring stage at pitch DH, 16 bytes a copy, rows past N zero-filled; with
// lse and delta (already offset to the (batch, head)), those rows' entries
// behind them, 4 bytes a copy, zeros past N.
template <int DH, int THREADS>
__device__ __forceinline__ void load_rows(float* stage, const float* a, long long a_rs,
                                          const float* b, long long b_rs,
                                          const float* lse, const float* delta,
                                          int r0, int N) {
  constexpr int CPR = DH / 4, COPIES = kBwdTile * CPR;
#pragma unroll
  for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (COPIES % THREADS != 0 && e >= COPIES) break;
    const int r = e / CPR, c = e % CPR;
    const int row = r0 + r;
    const bool ok = row < N;
    const long long rr = ok ? row : 0;
    cp_async16(stage + r * DH + 4 * c, a + rr * a_rs + 4 * c, ok);
    cp_async16(stage + (kBwdTile + r) * DH + 4 * c, b + rr * b_rs + 4 * c, ok);
  }
  if (lse != nullptr && threadIdx.x < kBwdTile) {
    const int row = r0 + threadIdx.x;
    const bool ok = row < N;
    const int rr = ok ? row : 0;
    float* stats = stage + 2 * kBwdTile * DH;
    cp_async4(stats + threadIdx.x, lse + rr, ok);
    cp_async4(stats + kBwdTile + threadIdx.x, delta + rr, ok);
  }
}

// Split a landed stage once for the whole block: hi and lo of every value
// of both tensors (the rounded split()), and with stats the
// C operands where the transposed scores start: for query pair p of the
// tile, (-lse log2 e) of rows 2p, 2p + 1, twice (the accumulator layout of
// one m16 tile's two rows), and the same of -delta.
template <int DH, int THREADS>
__device__ __forceinline__ void split_stage(const float* stage, uint32_t* sp, bool stats) {
  constexpr int LD = DH + 4, CPR = DH / 4, CHUNKS = 2 * kBwdTile * CPR;
  static_assert(CHUNKS % THREADS == 0, "whole rounds");
  uint32_t* hi = sp;
  uint32_t* lo = sp + 2 * kBwdTile * LD;
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CPR, c = e % CPR;  // r: row of both tensors, 0..2 kBwdTile
    const float4 x = *reinterpret_cast<const float4*>(stage + r * DH + 4 * c);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * LD + 4 * c) = h;
    *reinterpret_cast<uint4*>(lo + r * LD + 4 * c) = l;
  }
  if (stats && threadIdx.x < kBwdTile / 2) {
    const int p = threadIdx.x;
    const float* st = stage + 2 * kBwdTile * DH;
    const float2 l2 = *reinterpret_cast<const float2*>(st + 2 * p);
    const float2 d2 = *reinterpret_cast<const float2*>(st + kBwdTile + 2 * p);
    float* quads = reinterpret_cast<float*>(sp + 4 * kBwdTile * LD);
    const float a = l2.x * -kLog2e, b = l2.y * -kLog2e;
    *reinterpret_cast<float4*>(quads + 4 * p) = make_float4(a, b, a, b);
    *reinterpret_cast<float4*>(quads + 2 * kBwdTile + 4 * p) =
        make_float4(-d2.x, -d2.y, -d2.x, -d2.y);
  }
}

template <int DH>
__global__ void __launch_bounds__(Bwd<DH>::kThreads, Bwd<DH>::kMinBlocks)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int N,
                int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                int dsb, int dsh, int dsn, float scale) {
  using C = Bwd<DH>;
  constexpr int KT = kBwdTile, LD = C::kLd, KS = DH / 8, DT = DH / 8, MT = C::kTiles;
  constexpr int NT = KT / 8, GB = C::kGroups;
  static_assert(NT % GB == 0, "whole groups");
  __shared__ __align__(16) float ring[kBwdStages * C::kStage];
  __shared__ __align__(16) uint32_t sp[C::kSplit];
  const uint32_t* khi = sp;                 // the split K and V tiles
  const uint32_t* vhi = sp + KT * LD;
  const uint32_t* klo = sp + 2 * KT * LD;
  const uint32_t* vlo = sp + 3 * KT * LD;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBwdRows + warp * 16 * MT + g;  // + 16 mt + 8 r

  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;

  // q (times scale log2 e: scores in log2 units) and dO as split A
  // operands; where S and dP start: -lse log2 e and -delta of rows g, g + 8
  uint32_t qhi[MT][KS][4], qlo[MT][KS][4], ghi[MT][KS][4], glo[MT][KS][4];
  load_a<DH, MT>(q + (long long)b * qsb + (long long)h * qsh, qsn, row0, N, t,
                 scale * kLog2e, qhi, qlo);
  load_a<DH, MT>(dO + (long long)b * gsb + (long long)h * gsh, gsn, row0, N, t, 1.f,
                 ghi, glo);
  float s0[MT][4], dp0[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mt + 8 * r;
      s0[mt][2 * r] = s0[mt][2 * r + 1] =
          row < N ? lse[(long long)bh * N + row] * -kLog2e : 0.f;
      dp0[mt][2 * r] = dp0[mt][2 * r + 1] = row < N ? -delta[(long long)bh * N + row] : 0.f;
    }
  auto s_init = [&](int m, int) -> const float (&)[4] { return s0[m]; };
  auto dp_init = [&](int m, int) -> const float (&)[4] { return dp0[m]; };

  // dq: the sum over the tiles so far (see add_tile)
  float acc[DT][MT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][mt][e] = 0.f;

  const int ntiles = (N + KT - 1) / KT;
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < ntiles)
      load_rows<DH, C::kThreads>(ring + s * C::kStage, kb, ksn, vb, vsn, nullptr,
                                 nullptr, s * KT, N);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kBwdStages - 2>();  // this thread's copies of the tile landed
    __syncthreads();                  // everyone's; and the split tile - 1 is consumed
    const int next = tile + kBwdStages - 1;
    if (next < ntiles)
      load_rows<DH, C::kThreads>(ring + (next % kBwdStages) * C::kStage, kb, ksn, vb,
                                 vsn, nullptr, nullptr, next * KT, N);
    cp_async_commit();
    split_stage<DH, C::kThreads>(ring + (tile % kBwdStages) * C::kStage, sp, false);
    __syncthreads();
    const int key0 = tile * KT;
    float tacc[DT][MT][GB][4];  // this tile's dq, one partial sum per key group of a pass
    zero(tacc);

#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += GB) {
      // S - lse = q k^T - lse and dP - delta = dO v^T - delta: rows g,
      // g + 8; keys 8 j + 2t, 8 j + 2t + 1
      float s[MT][GB][4], dp[MT][GB][4];
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        uint32_t kh[GB][2], kl[GB][2], vh[GB][2], vl[GB][2];
#pragma unroll
        for (int j = 0; j < GB; ++j) {
          const int off = ((j0 + j) * 8 + g) * LD + 8 * c + t;
          row_b(khi, klo, off, kh[j], kl[j]);
          row_b(vhi, vlo, off, vh[j], vl[j]);
        }
        mma3_rows<MT, GB, KS>(s, s_init, qhi, qlo, c, kh, kl);
        mma3_rows<MT, GB, KS>(dp, dp_init, ghi, glo, c, vh, vl);
      }
      if (key0 + (j0 + GB) * 8 > N) {  // keys past N (the ragged last tile): P = 0
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < GB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (key0 + (j0 + j) * 8 + 2 * t + (e & 1) >= N) s[mt][j][e] = -INFINITY;
      }
      // P = exp2(S - lse log2 e) and dS = P (dP - delta), in place
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < GB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = exp2_sfu(s[mt][j][e]) * dp[mt][j][e];

      // dq += dS k: the 8 keys of group j are one k-step (key 2t in slot t,
      // 2t + 1 in slot t + 4), so K's rows are read in that order
      uint32_t shi[MT][GB][4], slo[MT][GB][4];
      split_acc<MT, GB>(s, shi, slo);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bh2[GB][2], bl2[GB][2];
#pragma unroll
        for (int j = 0; j < GB; ++j)
          col_b<LD>(khi, klo, ((j0 + j) * 8 + 2 * t) * LD + 8 * d + g, bh2[j], bl2[j]);
        mma3<MT, GB>(tacc[d], shi, slo, bh2, bl2);
      }
    }
    add_tile(acc, tacc);
  }

  float* db = dq + (long long)b * dsb + (long long)h * dsh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mt + 8 * r;
      if (row >= N) continue;
      float* out = db + (long long)row * dsn + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(out + 8 * d) =
            make_float2(acc[d][mt][2 * r] * scale, acc[d][mt][2 * r + 1] * scale);
    }
}

template <int DH>
__global__ void __launch_bounds__(Bwd<DH>::kThreads, Bwd<DH>::kMinBlocks)
flash_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int N,
                  int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                  int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                  int dksb, int dksh, int dksn, int dvsb, int dvsh, int dvsn,
                  float scale) {
  using C = Bwd<DH>;
  constexpr int QT = kBwdTile, LD = C::kLd, KS = DH / 8, DT = DH / 8, MT = C::kTiles;
  constexpr int NT = QT / 8, GB = C::kGroups;
  static_assert(NT % GB == 0, "whole groups");
  __shared__ __align__(16) float ring[kBwdStages * C::kStage];
  __shared__ __align__(16) uint32_t sp[C::kSplit];
  const uint32_t* qhi = sp;                 // the split q and dO tiles
  const uint32_t* ghi = sp + QT * LD;
  const uint32_t* qlo = sp + 2 * QT * LD;
  const uint32_t* glo = sp + 3 * QT * LD;
  const float* quads = reinterpret_cast<const float*>(sp + 4 * QT * LD);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.y * kBwdRows + warp * 16 * MT + g;  // + 16 mt + 8 r

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;
  const float* lb = lse + (long long)bh * N;
  const float* db = delta + (long long)bh * N;

  // k (times scale log2 e) and v as split A operands
  uint32_t khi[MT][KS][4], klo[MT][KS][4], vhi[MT][KS][4], vlo[MT][KS][4];
  load_a<DH, MT>(k + (long long)b * ksb + (long long)h * ksh, ksn, key0, N, t,
                 scale * kLog2e, khi, klo);
  load_a<DH, MT>(v + (long long)b * vsb + (long long)h * vsh, vsn, key0, N, t, 1.f,
                 vhi, vlo);

  // dk and dv: the sums over the tiles so far (see add_tile)
  float dka[DT][MT][4], dva[DT][MT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[d][mt][e] = dva[d][mt][e] = 0.f;

  const int ntiles = (N + QT - 1) / QT;
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < ntiles)
      load_rows<DH, C::kThreads>(ring + s * C::kStage, qb, qsn, gb, gsn, lb, db, s * QT, N);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();
    const int next = tile + kBwdStages - 1;
    if (next < ntiles)
      load_rows<DH, C::kThreads>(ring + (next % kBwdStages) * C::kStage, qb, qsn, gb,
                                 gsn, lb, db, next * QT, N);
    cp_async_commit();
    split_stage<DH, C::kThreads>(ring + (tile % kBwdStages) * C::kStage, sp, true);
    __syncthreads();
    // this tile's dk and dv, one partial sum per query group of a pass
    float tka[DT][MT][GB][4], tva[DT][MT][GB][4];
    zero(tka);
    zero(tva);

#pragma unroll
    for (int i0 = 0; i0 < NT; i0 += GB) {
      // S^T - lse = k q^T - lse and dP^T - delta = v dO^T - delta: keys g,
      // g + 8; queries 8 i + 2t, 8 i + 2t + 1, whose -lse log2 e and -delta
      // (the split tile's quads) vary along the columns. Query rows past N
      // are zeros with lse and delta 0: their P^T is 1 and their dS^T 0,
      // against zero rows of dO and q.
      float st0[GB][4], dpt0[GB][4];
#pragma unroll
      for (int j = 0; j < GB; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(quads + 4 * (4 * (i0 + j) + t));
        const float4 c = *reinterpret_cast<const float4*>(quads + 2 * QT + 4 * (4 * (i0 + j) + t));
        st0[j][0] = a.x; st0[j][1] = a.y; st0[j][2] = a.z; st0[j][3] = a.w;
        dpt0[j][0] = c.x; dpt0[j][1] = c.y; dpt0[j][2] = c.z; dpt0[j][3] = c.w;
      }
      auto st_init = [&](int, int j) -> const float (&)[4] { return st0[j]; };
      auto dpt_init = [&](int, int j) -> const float (&)[4] { return dpt0[j]; };
      float st[MT][GB][4], dpt[MT][GB][4];
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        uint32_t qh[GB][2], ql[GB][2], gh[GB][2], gl[GB][2];
#pragma unroll
        for (int j = 0; j < GB; ++j) {
          const int off = ((i0 + j) * 8 + g) * LD + 8 * c + t;
          row_b(qhi, qlo, off, qh[j], ql[j]);
          row_b(ghi, glo, off, gh[j], gl[j]);
        }
        mma3_rows<MT, GB, KS>(st, st_init, khi, klo, c, qh, ql);
        mma3_rows<MT, GB, KS>(dpt, dpt_init, vhi, vlo, c, gh, gl);
      }
      // P^T = exp2(S^T - lse log2 e) and dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < GB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[mt][j][e] = exp2_sfu(st[mt][j][e]);
            dpt[mt][j][e] *= st[mt][j][e];
          }

      // dv += P^T dO, then dk += dS^T q: the 8 queries of group i are one
      // k-step (query 2t in slot t, 2t + 1 in slot t + 4), so dO's and q's
      // rows are read in that order
      {
        uint32_t phi[MT][GB][4], plo[MT][GB][4];
        split_acc<MT, GB>(st, phi, plo);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          uint32_t bh2[GB][2], bl2[GB][2];
#pragma unroll
          for (int j = 0; j < GB; ++j)
            col_b<LD>(ghi, glo, ((i0 + j) * 8 + 2 * t) * LD + 8 * d + g, bh2[j], bl2[j]);
          mma3<MT, GB>(tva[d], phi, plo, bh2, bl2);
        }
      }
      {
        uint32_t shi[MT][GB][4], slo[MT][GB][4];
        split_acc<MT, GB>(dpt, shi, slo);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          uint32_t bh2[GB][2], bl2[GB][2];
#pragma unroll
          for (int j = 0; j < GB; ++j)
            col_b<LD>(qhi, qlo, ((i0 + j) * 8 + 2 * t) * LD + 8 * d + g, bh2[j], bl2[j]);
          mma3<MT, GB>(tka[d], shi, slo, bh2, bl2);
        }
      }
    }
    add_tile(dka, tka);
    add_tile(dva, tva);
  }

  float* dkb = dk + (long long)b * dksb + (long long)h * dksh;
  float* dvb = dv + (long long)b * dvsb + (long long)h * dvsh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 16 * mt + 8 * r;
      if (key >= N) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = 8 * d + 2 * t;
        *reinterpret_cast<float2*>(dkb + (long long)key * dksn + col) =
            make_float2(dka[d][mt][2 * r] * scale, dka[d][mt][2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dvb + (long long)key * dvsn + col) =
            make_float2(dva[d][mt][2 * r], dva[d][mt][2 * r + 1]);
      }
    }
}

// ---- backward at dh 128: dq and dk/dv from one kernel template (see the
// head of this file)

// A (B, H, N, 128) tensor: its base and its batch, head and row strides.
struct Rows {
  const float* p;
  int sb, sh, sn;
};
struct OutRows {
  float* p;
  int sb, sh, sn;
};

namespace b128 {
constexpr int kDH = 128;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps / 2;  // fixed rows a block owns, 16 a warp pair
constexpr int kTile = 32;               // streamed rows a tile
constexpr int kStages = 3;              // tiles in the shared ring
constexpr int kLd = kDH + 4;            // row pitch, 4 mod 32: no bank conflicts
constexpr int kGroups = kTile / 8;      // 8-row groups of a tile
constexpr int kChunk = 4;               // k-steps over dh a score sum takes from zero
constexpr int kHalf = kDH / 16;         // 8-column groups of a warp's half of an output
// floats: the fixed rows of both tensors; a ring stage (the streamed rows of
// both tensors, then their lse and delta); a warp's scores in the
// accumulator layout
constexpr int kFixed = 2 * kRows * kLd;
constexpr int kStage = 2 * kTile * kLd + 2 * kTile;
constexpr int kSwapWarp = kGroups * 4 * 32;
constexpr int kSmem = (kFixed + kStages * kStage + kWarps * kSwapWarp) * 4;  // bytes
static_assert(kSmem <= 227 * 1024, "one block an SM");
}  // namespace b128

// x += (a warp's 16 fixed rows) (the tile's kTile streamed rows)^T over all
// 128 dims: rows g, g + 8; streamed rows 8 j + 2t, 8 j + 2t + 1. Both
// operands are split where they are read (the rounded split). The sum runs
// over dh in chunks of kChunk k-steps, each from zero (12 mma a chunk) and
// then added in fp32: the tensor cores truncate each mma's sum, and 48 mma
// into one accumulator near -lse (up to 43 in log2 units at logits of 30)
// would drift by ulps of it (see add_tile).
__device__ __forceinline__ void bwd128_scores(float (&x)[b128::kGroups][4],
                                              const float* fixed, const float* rows,
                                              int g, int t) {
  using namespace b128;
#pragma unroll
  for (int c0 = 0; c0 < kDH / 8; c0 += kChunk) {
    float s[kGroups][4];
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = c0; c < c0 + kChunk; ++c) {
      const float* a = fixed + g * kLd + 8 * c + t;
      uint32_t ahi[4], alo[4];
      split_a(a[0], a[8 * kLd], a[4], a[8 * kLd + 4], ahi, alo);
      uint32_t bh[kGroups][2], bl[kGroups][2];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const float* r = rows + (8 * j + g) * kLd + 8 * c + t;
        split(r[0], bh[j][0], bl[j][0]);
        split(r[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kGroups; ++j) mma_tf32(s[j], alo, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) mma_tf32(s[j], ahi, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) mma_tf32(s[j], ahi, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] += s[j][e];
  }
}

// acc += a (the tile's streamed rows) over the warp's half of the output
// columns, [col0, col0 + 64): a (ahi, alo) is P or dS in the accumulator
// layout, whose k-step j holds streamed row 8 j + 2t in slot t and 8 j + 2t
// + 1 in slot t + 4, so the rows are read in that order (as the dh 8 and 16
// kernels read their split tiles) and split here. Each 8-column group sums
// the tile into fresh registers (12 mma), then into acc.
__device__ __forceinline__ void bwd128_out(float (&acc)[b128::kHalf][4],
                                           const uint32_t (&ahi)[b128::kGroups][4],
                                           const uint32_t (&alo)[b128::kGroups][4],
                                           const float* rows, int col0, int g, int t) {
  using namespace b128;
#pragma unroll
  for (int d0 = 0; d0 < kHalf; d0 += 4) {
    float f[4][4];
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[dd][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float* r = rows + (8 * j + 2 * t) * kLd + col0 + 8 * (d0 + dd) + g;
        split(r[0], bh[dd][0], bl[dd][0]);
        split(r[kLd], bh[dd][1], bl[dd][1]);
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) mma_tf32(f[dd], alo[j], bh[dd][0], bh[dd][1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) mma_tf32(f[dd], ahi[j], bl[dd][0], bl[dd][1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) mma_tf32(f[dd], ahi[j], bh[dd][0], bh[dd][1]);
    }
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + dd][e] += f[dd][e];
  }
}

// The warp's half of an output's rows of the pair, times mul; rows past N
// store nothing.
__device__ __forceinline__ void bwd128_store(const OutRows& o, int b, int h, int row0,
                                             int N, int col0, int g, int t,
                                             const float (&acc)[b128::kHalf][4],
                                             float mul) {
  float* base = o.p + (long long)b * o.sb + (long long)h * o.sh + col0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= N) continue;
    float* out = base + (long long)row * o.sn;
#pragma unroll
    for (int d = 0; d < b128::kHalf; ++d)
      *reinterpret_cast<float2*>(out + 8 * d) =
          make_float2(acc[d][2 * r] * mul, acc[d][2 * r + 1] * mul);
  }
}

// dq (DKDV false): fixed rows q (times scale log2 e) and dO, streamed rows
// k and v, out dq. dk/dv (DKDV true): fixed rows k (times scale log2 e) and
// v, streamed rows q and dO with their lse and delta, out dk and dv.
template <bool DKDV>
__global__ void __launch_bounds__(b128::kThreads, 1)
flash_bwd128_kernel(Rows fa, Rows fb, Rows sa, Rows sb, const float* __restrict__ lse,
                    const float* __restrict__ delta, OutRows oa, OutRows ob, int H,
                    int N, float scale) {
  using namespace b128;
  extern __shared__ __align__(16) float smem[];
  float* fixed = smem;                 // [2][kRows][kLd]
  float* ring = smem + kFixed;         // kStages stages
  float* swap = ring + kStages * kStage;  // [kWarps][kSwapWarp]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, role = warp & 1;
  const int row0 = blockIdx.y * kRows;
  const long long stat0 = (long long)bh * N;  // this (batch, head)'s lse and delta
  const float* sap = sa.p + (long long)b * sa.sb + (long long)h * sa.sh;
  const float* sbp = sb.p + (long long)b * sb.sb + (long long)h * sb.sh;

  // the fixed rows: A times scale log2 e (the scores in log2 units), B as
  // it is; rows past N are zeros
  {
    const float* fap = fa.p + (long long)b * fa.sb + (long long)h * fa.sh;
    const float* fbp = fb.p + (long long)b * fb.sb + (long long)h * fb.sh;
    const float mul = scale * kLog2e;
    constexpr int CPR = kDH / 4;
    for (int e = threadIdx.x; e < 2 * kRows * CPR; e += kThreads) {
      const int which = e / (kRows * CPR), r = (e / CPR) % kRows, c = 4 * (e % CPR);
      const int row = row0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < N)
        x = *reinterpret_cast<const float4*>(
            which ? fbp + (long long)row * fb.sn + c : fap + (long long)row * fa.sn + c);
      const float m = which ? 1.f : mul;
      *reinterpret_cast<float4*>(fixed + (which * kRows + r) * kLd + c) =
          make_float4(x.x * m, x.y * m, x.z * m, x.w * m);
    }
  }  // the first tile's barrier publishes them

  // rows [tile kTile, + kTile) of both streamed tensors into their stage,
  // 16 bytes a copy, rows past N zero-filled; for dk/dv those rows' lse and
  // delta behind them, zeros past N
  auto load = [&](int tile) {
    constexpr int CPR = kDH / 4, COPIES = 2 * kTile * CPR;
    static_assert(COPIES % kThreads == 0, "whole rounds");
    float* st = ring + (tile % kStages) * kStage;
#pragma unroll
    for (int i = 0; i < COPIES / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int which = e / (kTile * CPR), r = (e / CPR) % kTile, c = e % CPR;
      const int row = tile * kTile + r;
      const bool ok = row < N;
      const long long rr = ok ? row : 0;
      const float* src = which ? sbp + rr * sb.sn : sap + rr * sa.sn;
      cp_async16(st + (which * kTile + r) * kLd + 4 * c, src + 4 * c, ok);
    }
    if (DKDV && threadIdx.x < 2 * kTile) {
      const int row = tile * kTile + threadIdx.x % kTile;
      const bool ok = row < N;
      const float* src = (threadIdx.x < kTile ? lse : delta) + stat0 + (ok ? row : 0);
      cp_async4(st + 2 * kTile * kLd + threadIdx.x, src, ok);
    }
  };

  // dq: where each row's scores start, for rows g and g + 8 of the pair:
  // -lse log2 e (role 0) or -delta (role 1)
  float bias[2] = {0.f, 0.f};
  if (!DKDV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * pair + g + 8 * r;
      if (row < N) bias[r] = role ? -delta[stat0 + row] : lse[stat0 + row] * -kLog2e;
    }
  }

  // the warp's half of the output columns: dq or dk, and dv
  float acc[kHalf][4], acc2[kHalf][4];
#pragma unroll
  for (int d = 0; d < kHalf; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = acc2[d][e] = 0.f;
  const float* mine = fixed + (role * kRows + 16 * pair) * kLd;
  float* swap_mine = swap + warp * kSwapWarp;
  const float* swap_s = swap + (warp & ~1) * kSwapWarp;  // role 0's: S - lse
  const float* swap_d = swap_s + kSwapWarp;              // role 1's: dP - delta
  const int col0 = (kDH / 2) * role;

  const int ntiles = (N + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of the tile landed
    __syncthreads();               // everyone's; and tile - 1 and its scores are consumed
    if (tile + kStages - 1 < ntiles) load(tile + kStages - 1);
    cp_async_commit();
    const float* st = ring + (tile % kStages) * kStage;

    // role 0: S - lse log2 e = (fixed A) (streamed A)^T - lse log2 e; role
    // 1: dP - delta = (fixed B) (streamed B)^T - delta. For dk/dv lse and
    // delta are the streamed rows', varying along the columns.
    float x[kGroups][4];
    if (DKDV) {
      const float* stat = st + 2 * kTile * kLd + role * kTile;
      const float m = role ? -1.f : -kLog2e;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * t);
        x[j][0] = x[j][2] = v.x * m;
        x[j][1] = x[j][3] = v.y * m;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        x[j][0] = x[j][1] = bias[0];
        x[j][2] = x[j][3] = bias[1];
      }
    }
    bwd128_scores(x, mine, st + role * kTile * kLd, g, t);
    // the pair swaps its halves of the work: both warps need P and dS
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) swap_mine[(4 * j + e) * 32 + lane] = x[j][e];
    __syncthreads();

    // P = exp2(S - lse log2 e), dS = P (dP - delta); for dq, keys past N
    // (the ragged last tile) get P = 0 against K's zero-filled rows. For
    // dk/dv, query rows past N are zeros with lse and delta 0: their P is 1
    // and their dS 0, against zero rows of dO and q.
    float p[kGroups][4], ds[kGroups][4];
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = swap_s[(4 * j + e) * 32 + lane];
        if (!DKDV && tile * kTile + 8 * j + 2 * t + (e & 1) >= N) s = -INFINITY;
        p[j][e] = exp2_sfu(s);
        ds[j][e] = p[j][e] * swap_d[(4 * j + e) * 32 + lane];
      }
    // P and dS enter the sums linearly: split_trunc (see split_acc)
    uint32_t hi[kGroups][4], lo[kGroups][4];
    if (DKDV) {  // dv += P^T dO
#pragma unroll
      for (int j = 0; j < kGroups; ++j)
        split_a_trunc(p[j][0], p[j][2], p[j][1], p[j][3], hi[j], lo[j]);
      bwd128_out(acc2, hi, lo, st + kTile * kLd, col0, g, t);
    }
    // dq += dS k, or dk += dS^T q
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      split_a_trunc(ds[j][0], ds[j][2], ds[j][1], ds[j][3], hi[j], lo[j]);
    bwd128_out(acc, hi, lo, st, col0, g, t);
  }

  bwd128_store(oa, b, h, row0 + 16 * pair, N, col0, g, t, acc, scale);
  if (DKDV) bwd128_store(ob, b, h, row0 + 16 * pair, N, col0, g, t, acc2, 1.f);
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

// The backward's streamed and register operands (q, k, v, dO) need rows on
// 16 bytes; its outputs are stored 8 bytes at a time.
bool bwd_aligned(const float* q, const float* k, const float* v, const float* g,
                 const int* s) {
  return rows_aligned(q, s) && rows_aligned(k, s + 3) && rows_aligned(v, s + 6) &&
         rows_aligned(g, s + 9);
}

bool out_aligned(const float* o, const int* s) {
  return (reinterpret_cast<uintptr_t>(o) & 7) == 0 && s[0] % 2 == 0 && s[1] % 2 == 0 &&
         s[2] % 2 == 0;
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v, const float* g,
              const float* lse, const float* delta, float* dq, int B, int H, int N,
              const int* s, float scale, cudaStream_t st) {
  if (bad_shape(B, H, N, kBwdRows)) return (int)cudaErrorInvalidValue;
  if (!bwd_aligned(q, k, v, g, s) || !out_aligned(dq, s + 12))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (N + kBwdRows - 1) / kBwdRows);
  flash_dq_kernel<DH><<<grid, Bwd<DH>::kThreads, 0, st>>>(
      q, k, v, g, lse, delta, dq, H, N, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14], scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkdv(const float* q, const float* k, const float* v, const float* g,
                const float* lse, const float* delta, float* dk, float* dv, int B,
                int H, int N, const int* s, float scale, cudaStream_t st) {
  if (bad_shape(B, H, N, kBwdRows)) return (int)cudaErrorInvalidValue;
  if (!bwd_aligned(q, k, v, g, s) || !out_aligned(dk, s + 12) || !out_aligned(dv, s + 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (N + kBwdRows - 1) / kBwdRows);
  flash_dkdv_kernel<DH><<<grid, Bwd<DH>::kThreads, 0, st>>>(
      q, k, v, g, lse, delta, dk, dv, H, N, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15], s[16],
      s[17], scale);
  return (int)cudaGetLastError();
}

// The dh 128 backward: q, k, v, dO with strides s[0..11], dq or dk (s[12..14])
// and dv (s[15..17]).
template <bool DKDV>
int launch_bwd128(const float* q, const float* k, const float* v, const float* g,
                  const float* lse, const float* delta, float* o1, float* o2, int B,
                  int H, int N, const int* s, float scale, cudaStream_t st) {
  if (bad_shape(B, H, N, b128::kRows)) return (int)cudaErrorInvalidValue;
  if (!bwd_aligned(q, k, v, g, s) || !out_aligned(o1, s + 12) ||
      (DKDV && !out_aligned(o2, s + 15)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  long long optin = 0;
  int err = kernel_launch::device_optin(&dev, &optin);
  if (err != 0) return err;
  if (optin < b128::kSmem) return (int)cudaErrorInvalidValue;
  err = kernel_launch::opt_in<flash_bwd128_kernel<DKDV>>(dev, b128::kSmem);
  if (err != 0) return err;
  const Rows rq{q, s[0], s[1], s[2]}, rk{k, s[3], s[4], s[5]}, rv{v, s[6], s[7], s[8]},
      rg{g, s[9], s[10], s[11]};
  const OutRows out1{o1, s[12], s[13], s[14]};
  const OutRows out2 = DKDV ? OutRows{o2, s[15], s[16], s[17]} : OutRows{nullptr, 0, 0, 0};
  const dim3 grid(B * H, (N + b128::kRows - 1) / b128::kRows);
  if constexpr (DKDV)
    flash_bwd128_kernel<true><<<grid, b128::kThreads, b128::kSmem, st>>>(
        rk, rv, rq, rg, lse, delta, out1, out2, H, N, scale);
  else
    flash_bwd128_kernel<false><<<grid, b128::kThreads, b128::kSmem, st>>>(
        rq, rg, rk, rv, lse, delta, out1, out2, H, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Every function below runs on `stream`, allocates nothing and returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue for a head size
// or shape it does not take). Strides are in elements, (batch, head, row)
// for each tensor in argument order; the last dimension of every tensor has
// stride 1. lse and delta are contiguous (B * H, N) fp32. Every kernel
// needs its inputs q, k, v (and dO) on 16 bytes with strides that are
// multiples of 4, and its outputs on 8 bytes with even strides.

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
    case 128:
      return launch_bwd128<false>(qf, kf, vf, gf, lf, df, dqf, nullptr, B, H, N, strides,
                                  scale, st);
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
    case 128:
      return launch_bwd128<true>(qf, kf, vf, gf, lf, df, dkf, dvf, B, H, N, strides, scale,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
