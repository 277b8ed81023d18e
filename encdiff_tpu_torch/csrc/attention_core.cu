// softmax(q k^T * scale) v, forward and backward, fp32.
//
// Replaces the TPU kernel encdiff_tpu/nn/pallas/attention.py,
// _attn_core_fwd_call (_attn_core_kernel), the score / softmax / value chain
// of every SpatialTransformer attention that the flash kernels and
// fused_attention do not take, and of the VQ first stage's AttnBlock below
// 1,024 positions. The q / k / v / out projections around it stay in
// PyTorch.
//
// Shapes: q (B, H, N, DH), k and v (B, H, M, DH), out (B, H, N, DH), DH one
// of 8, 16, 32, 64, 128. Each tensor is addressed through its own batch,
// head and row strides, with the last dimension contiguous, so the callers'
// (B, N, H, DH) projections are read in place without a transpose copy.
// The serving and train paths run N and M of 4, 16, 20, 64 and 256; any N
// and M are taken.
//
// Forward: the two products on the tensor cores in fp32-equivalent
// precision (3xTF32 on mma.sync.m16n8k8, the scheme of flash_attention.cu;
// helpers in tf32_mma.cuh). No N x M score tensor is written to device
// memory.
// - Work split. A warp owns 16 query rows of one (batch, head) slice. A
//   block of S x T warps takes S slices and T row tiles of each: T =
//   min(8, ceil(N / 16)) row tiles, and where N is short (one or two row
//   tiles, the flagship's 4x4 and 2x2 levels) S = 4 / T slices share a
//   block, so that a 4-row slice does not get a block of its own. At DH 64
//   and 128 S = 1. Slices are gridDim.x (any B * H that fits an int), row
//   tile groups gridDim.y. The rule depends on the shape alone (plan()).
// - K and V stream through a ring of shared-memory stages by cp.async (3
//   stages; 2 at DH 64 and 128, beside q), each stage one tile of KT keys
//   of every slice of the block: KT = 64 keys, or M rounded up to 8 where
//   that is less (M = 4, 16, 20: one tile, one stage). Keys past M in a tile
//   are zero-filled and their scores masked to -inf before the running
//   maximum; every tile holds a key below M, so the maximum is finite after
//   the first tile and no -inf - (-inf) arises. Rows past N, and slices past
//   B * H in the last block, run on zeros and store nothing.
// - Copies are 16 bytes a thread where every q, k, v row starts on 16 bytes
//   (the callers' layouts), 4 bytes otherwise; out is the wrapper's own
//   buffer and is written 8 bytes at a time.
// - q (times scale * log2 e) sits in registers as split tf32 A operands at
//   DH <= 32, loaded while the first K/V tiles are in flight; at DH 64 and
//   128, where that would take 64 or 128 registers a thread beside the
//   output sum, it is copied into shared memory with the first tile and
//   scaled and split where it is used (the cure of the flash forward's
//   spills).
// - Products, layouts and softmax as in the flash forward: each 3xTF32 term
//   over four independent accumulators; the sum over DH in a permuted order
//   so that a lane's B values of a k-step are neighbours (8- or 16-byte
//   shared reads); V's rows read in the order of the S accumulator's keys
//   (row 2t for k-slot t, 2t + 1 for t + 4); K rows padded to 8, 16, 48, 80
//   or 144 floats, V rows to DH + 4, q rows to DH + 16, so that fragment
//   reads are free of bank conflicts; the online softmax in log2 units,
//   each exponential one ex2.approx.ftz.
// - Bound on the H100: the largest of bytes (q, k, v, out once at 3.35
//   TB/s), three tf32 passes of 4 B H N M DH FLOPs at 495 TFLOP/s and B H N
//   M exponentials at 16 per SM and clock. At the VQ mid block (B 160, H 1,
//   N = M = 256, DH 128) the tensor cores bind (0.033 ms); at M = 20 and at
//   N = M = 4 the bytes do, and there a launch of a few microseconds is
//   most of the time. At the VQ mid block one 215 KB block of 8 warps fits
//   an SM and 320 blocks take 2.42 waves: 0.159 ms on an H100 80GB HBM3 at
//   700 W, where SDPA's 64-row tiles take 0.138 (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxWarps = 8;  // S x T

template <int DH>
struct Core {
  static constexpr int kKeys = 64;                        // keys per tile, at most
  static constexpr int kVec = DH == 8 ? 2 : 4;            // floats per fragment read
  static constexpr int kChunks = DH / (4 * kVec);         // fragment reads per row
  static constexpr int kLdk = DH % 32 == 8 || DH % 32 == 16 ? DH : DH + 16;  // 8 or 16 mod 32
  static constexpr int kLdv = DH + 4;                     // 4 or 12 mod 16
  static constexpr bool kQShared = DH >= 64;
  static constexpr int kLdq = DH + 16;                    // 16 mod 32
  // P v runs over kJG key groups x kDG output groups at a time: four
  // independent accumulators (at DH 8 and 16 the key groups go to kJG
  // partial sums of o)
  static constexpr int kJG = DH == 8 ? 4 : DH == 16 ? 2 : 1;
  static constexpr int kDG = 4 / kJG;
  static constexpr int kMinBlocks = DH <= 16 ? 2 : 1;
  // the most K/V tiles in the ring: 2 beside q in shared memory
  static constexpr int kStages = kQShared ? 2 : 3;
};

// VEC floats from p: one 16- or 8-byte read where `vec` (p on 4 VEC
// bytes), else VEC 4-byte reads.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, bool vec, float (&out)[VEC]) {
  if (!vec) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = p[i];
  } else if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

// Shared-memory fragment reads: always aligned.
template <int VEC>
__device__ __forceinline__ void read_vec(const float* p, float (&out)[VEC]) {
  load_vec<VEC>(p, true, out);
}

// What one launch does: S slices x T row tiles a block, kt keys a tile,
// `stages` tiles in the ring; smem in bytes.
struct Plan {
  int S, T, kt, stages;
  long long smem;
};

template <int DH>
Plan plan(int N, int M, long long optin) {
  using C = Core<DH>;
  Plan p;
  const int row_tiles = (N + 15) / 16;
  p.T = row_tiles < kMaxWarps ? row_tiles : kMaxWarps;
  p.S = C::kQShared || p.T >= 4 ? 1 : 4 / p.T;
  const int m8 = (M + 7) / 8 * 8;
  p.kt = m8 < C::kKeys ? m8 : C::kKeys;
  const int ntiles = (M + p.kt - 1) / p.kt;
  p.stages = ntiles < C::kStages ? ntiles : C::kStages;
  for (;;) {
    const long long q = C::kQShared ? 16LL * p.S * p.T * C::kLdq : 0;
    p.smem = 4 * (q + (long long)p.stages * p.S * p.kt * (C::kLdk + C::kLdv));
    if (p.smem <= optin || p.S == 1) break;
    p.S /= 2;
  }
  return p;
}

template <int DH>
__global__ void __launch_bounds__(32 * kMaxWarps, Core<DH>::kMinBlocks)
attn_core_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int BH, int H, int N, int M, int S, int T, int KTr, bool vec,
                     int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                     int vsb, int vsh, int vsn, int osb, int osh, int osn,
                     float scale) {
  using C = Core<DH>;
  constexpr int KT = C::kKeys, VEC = C::kVec, NCH = C::kChunks, KS = VEC / 2;
  constexpr int LDK = C::kLdk, LDV = C::kLdv, LDQ = C::kLdq;
  constexpr int NT = KT / 8;  // 8-key groups of a full tile
  constexpr int DT = DH / 8;  // 8-column groups of the output
  constexpr int JG = C::kJG, DG = C::kDG;
  constexpr int CPR = DH / 4;  // 16-byte copies per K or V row
  constexpr int kStages = C::kStages;
  static_assert(NT % 4 == 0 && NT % JG == 0 && DT % DG == 0, "whole groups");
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int qfloats = C::kQShared ? 16 * warps * LDQ : 0;
  float* qs = smem;
  float* ring = smem + qfloats;
  const int k_floats = S * KTr * LDK;  // a stage: K rows, then V rows
  const int stage_floats = k_floats + S * KTr * LDV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ws = warp / T;                           // the warp's slice in the block
  const int slice = blockIdx.x * S + ws;
  const bool live = slice < BH;
  const int b = live ? slice / H : 0;
  const int h = live ? slice % H : 0;
  const int rt = blockIdx.y * T + warp % T;           // the warp's row tile
  const int row0 = rt * 16 + g;                       // and row0 + 8
  const int ntr = KTr / 8;                            // 8-key groups of a tile

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float qscale = scale * kLog2e;  // scores in log2 units

  const int ntiles = (M + KTr - 1) / KTr;
  // tile `tile` of every slice of the block into its ring stage: K rows
  // then V rows, slice by slice
  auto load_tile = [&](int tile) {
    float* ks = ring + (tile % kStages) * stage_floats;
    float* vs = ks + k_floats;
    const int per_slice = KTr * CPR;
    for (int e = threadIdx.x; e < S * per_slice; e += nthreads) {
      const int sl = e / per_slice;
      const int rem = e - sl * per_slice;
      const int r = rem / CPR, c = 4 * (rem % CPR);
      const int s_idx = blockIdx.x * S + sl;
      const int key = tile * KTr + r;
      const bool ok = s_idx < BH && key < M;
      const int sb = ok ? s_idx / H : 0, sh = ok ? s_idx % H : 0;
      const long long kr = ok ? key : 0;
      const float* ksrc = k + (long long)sb * ksb + (long long)sh * ksh + kr * ksn + c;
      const float* vsrc = v + (long long)sb * vsb + (long long)sh * vsh + kr * vsn + c;
      float* kd = ks + (sl * KTr + r) * LDK + c;
      float* vd = vs + (sl * KTr + r) * LDV + c;
      if (vec) {
        cp_async16(kd, ksrc, ok);
        cp_async16(vd, vsrc, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cp_async4(kd + i, ksrc + i, ok);
          cp_async4(vd + i, vsrc + i, ok);
        }
      }
    }
  };
  if constexpr (C::kQShared) {  // S == 1: the block's rows are one run
    // q rows by cp.async with the first tile (scaled where they are split)
    const int rows = 16 * warps;
    for (int e = threadIdx.x; e < rows * (DH / 4); e += nthreads) {
      const int r = e / (DH / 4), c = 4 * (e % (DH / 4));
      const int row = blockIdx.y * rows + r;
      const bool ok = live && row < N;
      const float* src = qb + (ok ? (long long)row * qsn + c : 0);
      if (vec) {
        cp_async16(qs + r * LDQ + c, src, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) cp_async4(qs + r * LDQ + c + i, src + i, ok);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  // q in the permuted order: read c of a row holds dims c * 4 VEC + VEC t
  // + i, and (i = 2p, 2p + 1) are slots (t, t + 4) of the read's k-step p.
  // In registers at DH <= 32, loaded while the first tiles are in flight.
  uint32_t qhi[C::kQShared ? 1 : NCH][KS][4], qlo[C::kQShared ? 1 : NCH][KS][4];
  if constexpr (!C::kQShared) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float qf[2][VEC];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (live && row < N) {
          load_vec<VEC>(qb + (long long)row * qsn + c * 4 * VEC + VEC * t, vec, qf[r]);
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
                qhi[c][p], qlo[c][p]);
    }
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

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of the tile landed
    __syncthreads();               // everyone's; and tile - 1 is consumed
    if (tile + kStages - 1 < ntiles) load_tile(tile + kStages - 1);
    cp_async_commit();
    const float* stage = ring + (tile % kStages) * stage_floats;
    const float* ks = stage + ws * KTr * LDK;
    const float* vs = stage + k_floats + ws * KTr * LDV;

    // S = q k^T: rows g, g + 8; keys 8 j + 2t, 8 j + 2t + 1 of the tile.
    // Four key groups at a time, each product term over the four before the
    // next term. Groups past the tile's ntr (M below a full tile) are not
    // computed; the mask below sets them to -inf.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      uint32_t ahi[KS][4], alo[KS][4];
      if constexpr (C::kQShared) {
        const float* qr = qs + (warp * 16 + g) * LDQ + c * 4 * VEC + VEC * t;
        float x0[VEC], x1[VEC];
        read_vec<VEC>(qr, x0);
        read_vec<VEC>(qr + 8 * LDQ, x1);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          x0[i] *= qscale;
          x1[i] *= qscale;
        }
#pragma unroll
        for (int p = 0; p < KS; ++p)
          split_a(x0[2 * p], x1[2 * p], x0[2 * p + 1], x1[2 * p + 1], ahi[p], alo[p]);
      } else {
#pragma unroll
        for (int p = 0; p < KS; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[p][e] = qhi[c][p][e];
            alo[p][e] = qlo[c][p][e];
          }
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += 4) {
        if (j0 < ntr) {
          uint32_t bhi[4][VEC], blo[4][VEC];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float kv[VEC];
            if (j0 + jj < ntr) {
              read_vec<VEC>(ks + ((j0 + jj) * 8 + g) * LDK + c * 4 * VEC + VEC * t, kv);
            } else {
#pragma unroll
              for (int i = 0; i < VEC; ++i) kv[i] = 0.f;
            }
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
    }
    const int key0 = tile * KTr;
    if (key0 + KT > M) {  // a ragged or short tile: keys past M, groups past ntr
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j >= ntr || key0 + j * 8 + 2 * t + (e & 1) >= M) s[j][e] = -INFINITY;
    }

    // online softmax; every tile holds a key below M, so mx is finite
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
    // key 2t + 1 in slot t + 4, so V's rows are read in that order
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += JG) {
      if (j0 < ntr) {
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
            const bool in = j0 + jj < ntr;
            const float* v0 = vs + ((j0 + jj) * 8 + 2 * t) * LDV + g;
#pragma unroll
            for (int dd = 0; dd < DG; ++dd) {
              split(in ? v0[(d0 + dd) * 8] : 0.f, vhi[jj][dd][0], vlo[jj][dd][0]);
              split(in ? v0[LDV + (d0 + dd) * 8] : 0.f, vhi[jj][dd][1], vlo[jj][dd][1]);
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
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!live) return;
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
    }
  }
}

bool aligned16(const void* p, const int* s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s[0] % 4 == 0 &&
         s[1] % 4 == 0 && s[2] % 4 == 0;
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H,
           int N, int M, const int* s, float scale, cudaStream_t stream) {
  int dev = 0;
  long long optin = 0;
  int err = kernel_launch::device_optin(&dev, &optin);
  if (err != 0) return err;
  const Plan p = plan<DH>(N, M, optin);
  if (p.smem > optin) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    err = kernel_launch::opt_in<attn_core_mma_kernel<DH>>(dev, optin);
    if (err != 0) return err;
  }
  const bool vec = aligned16(q, s) && aligned16(k, s + 3) && aligned16(v, s + 6);
  const int BH = B * H;
  const int row_tiles = (N + 15) / 16;
  const dim3 grid((BH + p.S - 1) / p.S, (row_tiles + p.T - 1) / p.T);
  attn_core_mma_kernel<DH><<<grid, 32 * p.S * p.T, (size_t)p.smem, stream>>>(
      q, k, v, o, BH, H, N, M, p.S, p.T, p.kt, vec, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements; the last dimension of every tensor has stride 1,
// and o starts on 8 bytes with even strides (q, k and v may start anywhere:
// rows off 16 bytes take 4-byte copies). Runs on `stream`, allocates
// nothing and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a head size or shape it does not take).
extern "C" int attention_core_fwd(const void* q, const void* k, const void* v, void* o,
                                  int B, int H, int N, int M, int DH,
                                  int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                                  int vsb, int vsh, int vsn, int osb, int osh, int osn,
                                  float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || (long long)B * H > 2147483647LL ||
      (N + 15) / 16 > 65535 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(o) & 7) != 0 || osb % 2 || osh % 2 || osn % 2)
    return (int)cudaErrorInvalidValue;
  const int s[12] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, osb, osh, osn};
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8: return launch<8>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 16: return launch<16>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 32: return launch<32>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 128: return launch<128>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward, fp32: dq, dk, dv from q, k, v and dO.
//
// Replaces the TPU kernel encdiff_tpu/nn/pallas/attention.py,
// _attn_core_bwd_call (_attn_core_bwd_kernel), the recompute-P backward:
// P = softmax(q k^T * scale), dv = P^T dO, dP = dO v^T,
// dS = P o (dP - rowsum(dP o P)) * scale, dq = dS k, dk = dS^T q.
//
// The TPU kernel runs one program per (batch, head) in order, with all keys
// at once. Here blocks run in parallel and nothing carries over between
// them, and dk and dv sum over every query row, so the backward is two
// launches (three where dk/dv splits its query rows), none of which writes
// an N x M tensor. Every product runs on the tensor cores as 3xTF32 on
// mma.sync.m16n8k8, the flash backward's scheme (flash_attention.cu; the
// helpers are in tf32_mma.cuh): a block splits each streamed tile once into
// hi and lo in shared memory; P and dS, linear in the sums, take the
// two-instruction split; each tile sums into fresh accumulators that are
// then added to the totals, since the tensor cores truncate each mma's sum.
//
// 1. attn_bwd_dq_kernel, query-parallel: a warp owns 32 query rows (two m16
//    tiles) at dh 8 and 16, 16 at dh 32 to 128; a block of up to 4 warps
//    takes 16 to 128 rows of one (batch, head), fewer warps where N is
//    short (the flagship's 4x4 and 2x2 levels: one warp). K and V stream
//    through a ring of cp.async stages (3 stages of 64 keys at dh 8 and 16,
//    2 of 64 at dh 32 and of 32 at dh 64 and 128; M rounded up to 8 or 16
//    where that is less). The forward saves no logsumexp, and the autograd
//    Function saves only q, k and v, as the JAX VJP's residuals are; so a
//    first pass over the keys computes S = q k^T and dP = dO v^T on the
//    tensor cores and, per lane, a running maximum, the sum of exp2(S - m)
//    and of exp2(S - m) dP, combined over the quad at the end into the
//    logsumexp L (log2 units) and delta = rowsum(dP o P). The second pass
//    recomputes S - L and dP - delta with -L and -delta riding on the first
//    mma's C operand (hi*hi first), then P = exp2(S - L), dS = P (dP -
//    delta) and dq += dS k. Where M fits one tile (the cross-attention's
//    M = 20, and M <= 64 at dh <= 32) both passes run on one split tile,
//    loaded once. L and delta go to a (2, B * H, N) scratch.
// 2. attn_bwd_dkdv_kernel, key-parallel, on the transposed scores: a warp
//    owns 32 (or 16) keys as A operands, and q, dO and their L and delta
//    stream through the ring (the C operands of S^T - L and dP^T - delta
//    vary along the columns: the split tile carries them as quads). Where
//    M is short a block's warps do not all get keys of their own: the
//    block's 4 warps split each streamed tile's 8-row groups between them
//    (the cross-attention's M = 20 is one warp's keys, and 4 warps share
//    every tile), and add their partial dk and dv in shared memory, warp by
//    warp. Where B * H times the key blocks is below 528 blocks (4 an SM),
//    the query tiles also split over blocks (gridDim.y): the faces' (8, 8,
//    4096, 20, 8) runs 64 x 8 blocks of 512 query rows each instead of 64.
//    Those partial sums go to a (2, B * H, splits, M, dh) scratch, and
// 3. attn_bwd_sum_kernel adds them in split order. No float atomics: a
//    second run repeats bit for bit.
// Keys past M are zero rows whose scores the dq kernel masks to -inf (the
// running maximum starts at -1e30, so a lane whose keys are all masked, as
// at M = 4, adds nothing and makes no NaN); rows past N are zero rows with
// L = delta = 0, whose dS^T is 0.
//
// Layout: every tensor is addressed through its own batch, head and row
// strides with the last dimension contiguous: dO arrives as the gradient of
// the forward's (B, N, H, DH)-backed view, and dq, dk, dv are written into
// (B, L, H, DH)-backed buffers so that the callers' head merge costs no
// copy. q, k, v and dO rows must start on 16 bytes (the cp.async copies;
// the wrapper checks, and this file returns cudaErrorInvalidValue). Head
// sizes 8, 16, 32 (the UNet's) and 64, 128 (the VQ mid block's); at 64 and
// 128 a warp's A rows sit in shared memory and are split where they are
// used, and at 128 dv and dk run as two launches of the dk/dv kernel (S^T
// alone for dv, then S^T, dP^T and dk), since both sums and their per-tile
// parts would take 256 registers. B * H is gridDim.x (any B * H that fits
// an int).
//
// Bound on the H100 (chip_smoke.py's attn_bwd_work and design_bounds): five
// N x M x dh products (q k^T, dO v^T, P^T dO, dS k, dS^T q), three tf32
// passes each at 495 TFLOP/s; N M exponentials at 16 per SM and clock;
// q, k, v, dO read and dq, dk, dv written once at 3.35 TB/s. At the
// flagship's (128, 8, 256, 256, 8) the tensor cores bind (0.033 ms; bytes
// 0.018, exponentials 0.016 at 1,980 MHz); at M = 20 the bytes do. In fp32
// on the CUDA cores (67 TFLOP/s) the same products take 10 N M dh FLOPs:
// the bound of the first design, which ran them there. This design runs
// nine products, not five (the first pass recomputes S and dP, and the
// dk/dv kernel S^T and dP^T) and three exponentials a score: the price of
// saving only q, k and v.

namespace {

using namespace tf32;

constexpr int kBwdWarps = 4;                    // warps a block, at most
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdTargetBlocks = 4 * 132;       // dk/dv splits N below this
constexpr float kNoScore = -1e30f;              // the running maximum's start

template <int DH>
struct Bwd {
  static constexpr int kTiles = DH <= 16 ? 2 : 1;   // m16 tiles a warp
  static constexpr int kRows = 16 * kTiles;          // rows (or keys) a warp owns
  static constexpr int kGroups = DH == 8 ? 2 : 1;    // 8-column groups taken at a time
  static constexpr int kTile = DH >= 64 ? 32 : 64;   // rows of a streamed tile, at most
  static constexpr int kStages = DH <= 16 ? 3 : 2;   // tiles in the ring
  static constexpr bool kASmem = DH >= 64;           // A rows in shared memory
  static constexpr int kLd = DH + 4;                 // pitch of split tiles and A rows
  // blocks an SM the registers must allow: 4 at dh 8 (128 registers a
  // thread; faster than 3 at the train shapes), 2 at 16 and 32
  static constexpr int kMinBlocks = DH == 8 ? 4 : DH <= 32 ? 2 : 1;
};

// What one backward launch does: `warps` a block; streamed tiles of kt rows,
// ntiles of them; for dk/dv, kw key groups x qw query parts of the warps and
// the query tiles split over `splits` blocks of per_split tiles; blocks_y
// on gridDim.y; smem in bytes.
struct BwdPlan {
  int warps, kt, ntiles, kw, qw, splits, per_split, blocks_y;
  long long smem;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int DH>
long long ring_floats(int kt) {  // the stages, then the split tile
  return Bwd<DH>::kStages * (2LL * kt * DH + 2 * kt) + 4LL * kt * Bwd<DH>::kLd + 4 * kt;
}

template <int DH>
BwdPlan plan_dq(int N, int M) {
  using C = Bwd<DH>;
  BwdPlan p{};
  const int tiles = (N + C::kRows - 1) / C::kRows;
  p.warps = tiles < kBwdWarps ? tiles : kBwdWarps;
  const int m = round_up(M, 8 * C::kGroups);
  p.kt = m < C::kTile ? m : C::kTile;
  p.ntiles = (M + p.kt - 1) / p.kt;
  p.kw = p.qw = p.splits = 1;
  p.per_split = p.ntiles;
  p.blocks_y = (N + C::kRows * p.warps - 1) / (C::kRows * p.warps);
  const long long a = C::kASmem ? 2LL * p.warps * C::kRows * C::kLd : 0;
  p.smem = 4 * (ring_floats<DH>(p.kt) + a);
  return p;
}

template <int DH>
BwdPlan plan_dkdv(long long BH, int N, int M, int outputs) {
  using C = Bwd<DH>;
  BwdPlan p{};
  const int key_tiles = (M + C::kRows - 1) / C::kRows;
  p.kw = key_tiles < kBwdWarps ? key_tiles : kBwdWarps;
  const int n = round_up(N, 8 * C::kGroups);
  p.kt = n < C::kTile ? n : C::kTile;
  const int chunks = p.kt / (8 * C::kGroups);
  p.qw = kBwdWarps / p.kw < chunks ? kBwdWarps / p.kw : chunks;
  p.warps = p.kw * p.qw;
  p.ntiles = (N + p.kt - 1) / p.kt;
  const int key_blocks = (M + C::kRows * p.kw - 1) / (C::kRows * p.kw);
  const long long blocks = BH * key_blocks;
  p.splits = 1;
  if (blocks < kBwdTargetBlocks) {
    const long long want = (kBwdTargetBlocks + blocks - 1) / blocks;
    p.splits = want < p.ntiles ? (int)want : p.ntiles;
  }
  p.per_split = (p.ntiles + p.splits - 1) / p.splits;
  p.splits = (p.ntiles + p.per_split - 1) / p.per_split;
  p.blocks_y = key_blocks * p.splits;
  const long long a = C::kASmem ? 2LL * p.kw * C::kRows * C::kLd : 0;
  // the qw warps' sums, added in shared memory after the streaming loop
  const long long sums = p.qw > 1 ? 32LL * p.warps * outputs * (DH / 8) * C::kTiles * 4 : 0;
  const long long main = ring_floats<DH>(p.kt) + a;
  p.smem = 4 * (main > sums ? main : sums);
  return p;
}

// Floats of the scratch a call needs: L and delta (2, B * H, N), then, on
// 16 bytes, the dk/dv partial sums (2, B * H, splits, M, DH) where the query
// rows split over blocks.
template <int DH>
long long scratch_floats(long long BH, int N, int M) {
  const BwdPlan p = plan_dkdv<DH>(BH, N, M, 2);
  const long long stats = (2 * BH * N + 3) / 4 * 4;
  return stats + (p.splits > 1 ? 2 * BH * p.splits * M * DH : 0);
}

// Rows [r0, r0 + kt) of two row-strided (L, DH) tensors a and b into one
// ring stage at pitch DH, 16 bytes a copy, rows past L zero-filled; with
// l2 and dl (L and delta of the (batch, head)), those rows' entries behind
// them, 4 bytes a copy, zeros past L.
template <int DH>
__device__ __forceinline__ void bwd_load(float* stage, const float* a, long long a_rs,
                                         const float* b, long long b_rs, const float* l2,
                                         const float* dl, int r0, int L, int kt) {
  constexpr int CPR = DH / 4;
  for (int e = threadIdx.x; e < kt * CPR; e += blockDim.x) {
    const int r = e / CPR, c = 4 * (e % CPR);
    const int row = r0 + r;
    const bool ok = row < L;
    const long long rr = ok ? row : 0;
    cp_async16(stage + r * DH + c, a + rr * a_rs + c, ok);
    cp_async16(stage + (kt + r) * DH + c, b + rr * b_rs + c, ok);
  }
  if (l2 != nullptr) {
    float* st = stage + 2 * kt * DH;
    for (int r = threadIdx.x; r < kt; r += blockDim.x) {
      const int row = r0 + r;
      const bool ok = row < L;
      const int rr = ok ? row : 0;
      cp_async4(st + r, l2 + rr, ok);
      cp_async4(st + kt + r, dl + rr, ok);
    }
  }
}

// A landed stage split once for the block: hi of a, hi of b, lo of a, lo of
// b (kt rows each at pitch DH + 4: 4 or 12 mod 16, so that a warp's reads
// are free of bank conflicts along a row and down a column); with stats,
// the C operands where the transposed scores start: for query pair p of the
// tile, -L of rows 2p, 2p + 1, twice (an m16 tile's two rows), and the same
// of -delta.
template <int DH>
__device__ __forceinline__ void bwd_split(const float* stage, uint32_t* sp, int kt, bool stats) {
  constexpr int LD = DH + 4, CPR = DH / 4;
  uint32_t* hi = sp;
  uint32_t* lo = sp + 2 * kt * LD;
  for (int e = threadIdx.x; e < 2 * kt * CPR; e += blockDim.x) {
    const int r = e / CPR, c = 4 * (e % CPR);  // r: row of both tensors, 0..2 kt
    const float4 x = *reinterpret_cast<const float4*>(stage + r * DH + c);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * LD + c) = h;
    *reinterpret_cast<uint4*>(lo + r * LD + c) = l;
  }
  if (stats) {
    const float* st = stage + 2 * kt * DH;
    float* quads = reinterpret_cast<float*>(sp + 4 * kt * LD);
    for (int p = threadIdx.x; p < kt / 2; p += blockDim.x) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 2 * p);
      const float2 d2 = *reinterpret_cast<const float2*>(st + kt + 2 * p);
      *reinterpret_cast<float4*>(quads + 4 * p) = make_float4(-l2.x, -l2.y, -l2.x, -l2.y);
      *reinterpret_cast<float4*>(quads + 2 * kt + 4 * p) =
          make_float4(-d2.x, -d2.y, -d2.x, -d2.y);
    }
  }
}

// Rows [r0, r0 + rows) of two row-strided (L, DH) tensors into shared memory
// at pitch DH + 4, by cp.async, zeros past L: the A rows at dh 64 and 128.
template <int DH>
__device__ __forceinline__ void load_a_rows(float* dst, const float* a, long long a_rs,
                                            const float* b, long long b_rs, int r0, int rows,
                                            int L) {
  constexpr int CPR = DH / 4, LD = DH + 4;
  for (int e = threadIdx.x; e < 2 * rows * CPR; e += blockDim.x) {
    const int r = e / CPR, c = 4 * (e % CPR);
    const int which = r / rows, row = r0 + r % rows;
    const bool ok = row < L;
    const long long rr = ok ? row : 0;
    cp_async16(dst + r * LD + c, (which ? b + rr * b_rs : a + rr * a_rs) + c, ok);
  }
}

// The A operand of k-step c of a warp's m16 tiles from rows in shared
// memory at pitch DH + 4, times mul, split here (lane 4 g + t reads rows g,
// g + 8 at dims 8c + t, 8c + t + 4); frag_regs (tf32_mma.cuh) takes it from
// registers split once.
template <int DH, int MT>
__device__ __forceinline__ void frag_smem(const float* rows, int c, int g, int t, float mul,
                                          uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4]) {
  constexpr int LD = DH + 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* a = rows + (16 * m + g) * LD + 8 * c + t;
    split_a(a[0] * mul, a[8 * LD] * mul, a[4] * mul, a[8 * LD + 4] * mul, hi[m], lo[m]);
  }
}

// Tile `step` of the dq kernel's sequence (the key tiles twice over, or one
// tile once) from the ring into the split buffer, with the next tile but
// kStages - 1 set loading.
template <int DH>
__device__ __forceinline__ void dq_advance(float* ring, uint32_t* sp, int stage_floats,
                                           int step, int steps, int ntiles, int kt,
                                           const float* kb, long long ksn, const float* vb,
                                           long long vsn, int M) {
  constexpr int kStages = Bwd<DH>::kStages;
  cp_async_wait<kStages - 2>();  // this thread's copies of the tile landed
  __syncthreads();               // everyone's; and the split tile before is consumed
  const int next = step + kStages - 1;
  if (next < steps)
    bwd_load<DH>(ring + (next % kStages) * stage_floats, kb, ksn, vb, vsn, nullptr, nullptr,
                 (next % ntiles) * kt, M, kt);
  cp_async_commit();
  bwd_split<DH>(ring + (step % kStages) * stage_floats, sp, kt, false);
  __syncthreads();
}

// S (log2 units) and dP of key groups j0 .. j0 + GB of the split K/V tile
// sp, from s_init and dp_init (zeros, or -L and -delta); q's and dO's A
// operands from registers (qhi .. glo) or, at dh 64 and 128, from the
// warp's rows in shared memory (qrows, grows); keys past M masked to -inf.
template <int DH, int AR, int AK, class SInit, class DInit>
__device__ __forceinline__ void dq_scores(
    float (&s)[Bwd<DH>::kTiles][Bwd<DH>::kGroups][4],
    float (&dp)[Bwd<DH>::kTiles][Bwd<DH>::kGroups][4], SInit s_init, DInit dp_init,
    const uint32_t (&qhi)[AR][AK][4], const uint32_t (&qlo)[AR][AK][4],
    const uint32_t (&ghi)[AR][AK][4], const uint32_t (&glo)[AR][AK][4],
    const float* qrows, const float* grows, float qscale, const uint32_t* sp, int kt,
    int j0, int key0, int M, int g, int t) {
  using C = Bwd<DH>;
  constexpr int LD = C::kLd, KS = DH / 8, MT = C::kTiles, GB = C::kGroups;
  const uint32_t* khi = sp;
  const uint32_t* vhi = sp + kt * LD;
  const uint32_t* klo = sp + 2 * kt * LD;
  const uint32_t* vlo = sp + 3 * kt * LD;
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    uint32_t ah[MT][4], al[MT][4], gh[MT][4], gl[MT][4];
    if constexpr (C::kASmem) {
      frag_smem<DH, MT>(qrows, c, g, t, qscale, ah, al);
      frag_smem<DH, MT>(grows, c, g, t, 1.f, gh, gl);
    } else {
      frag_regs<MT, KS>(qhi, qlo, c, ah, al);
      frag_regs<MT, KS>(ghi, glo, c, gh, gl);
    }
    uint32_t kh[GB][2], kl[GB][2], vh[GB][2], vl[GB][2];
#pragma unroll
    for (int j = 0; j < GB; ++j) {
      const int off = ((j0 + j) * 8 + g) * LD + 8 * c + t;
      row_b(khi, klo, off, kh[j], kl[j]);
      row_b(vhi, vlo, off, vh[j], vl[j]);
    }
    mma3_step<MT, GB>(s, s_init, c == 0, ah, al, kh, kl);
    mma3_step<MT, GB>(dp, dp_init, c == 0, gh, gl, vh, vl);
  }
  if (key0 + (j0 + GB) * 8 > M) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < GB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + (j0 + j) * 8 + 2 * t + (e & 1) >= M) s[mt][j][e] = -INFINITY;
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads, Bwd<DH>::kMinBlocks)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   float* __restrict__ stats, float* __restrict__ dq, int BH, int H,
                   int N, int M, int kt, int qsb, int qsh, int qsn, int ksb, int ksh,
                   int ksn, int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                   int dsb, int dsh, int dsn, float scale) {
  using C = Bwd<DH>;
  constexpr int LD = C::kLd, KS = DH / 8, DT = DH / 8, MT = C::kTiles, GB = C::kGroups;
  constexpr int NT = C::kTile / 8, ROWS = C::kRows, kStages = C::kStages;
  constexpr int AR = C::kASmem ? 1 : MT, AK = C::kASmem ? 1 : KS;  // register A, if any
  extern __shared__ __align__(16) float smem[];
  const int stage_floats = 2 * kt * DH + 2 * kt;
  float* ring = smem;
  uint32_t* sp = reinterpret_cast<uint32_t*>(smem + kStages * stage_floats);
  const uint32_t* khi = sp;  // the split K and V tiles
  const uint32_t* vhi = sp + kt * LD;
  const uint32_t* klo = sp + 2 * kt * LD;
  const uint32_t* vlo = sp + 3 * kt * LD;
  float* arows = smem + kStages * stage_floats + 4 * kt * LD + 4 * kt;  // q, then dO

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int block_row0 = blockIdx.y * ROWS * warps;
  const int row0 = block_row0 + warp * ROWS + g;  // + 16 mt + 8 r
  const float qscale = scale * kLog2e;            // scores in log2 units

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;
  const float* qrows = arows + warp * ROWS * LD;
  const float* grows = arows + (warps + warp) * ROWS * LD;

  // q (times scale log2 e) and dO as A operands: split in registers, or
  // (dh 64, 128) the block's rows copied with the first tile. The first
  // tiles' copies go out before the register loads, so that their latencies
  // overlap.
  uint32_t qhi[AR][AK][4], qlo[AR][AK][4], ghi[AR][AK][4], glo[AR][AK][4];
  if constexpr (C::kASmem)
    load_a_rows<DH>(arows, qb, qsn, gb, gsn, block_row0, ROWS * warps, N);
  const int ntiles = (M + kt - 1) / kt;
  const int steps = ntiles == 1 ? 1 : 2 * ntiles;  // pass 1, then pass 2, over the tiles
  const int ntr = kt / 8;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      bwd_load<DH>(ring + s * stage_floats, kb, ksn, vb, vsn, nullptr, nullptr,
                   (s % ntiles) * kt, M, kt);
    cp_async_commit();
  }
  if constexpr (!C::kASmem) {
    load_a<DH, MT>(qb, qsn, row0, N, t, qscale, qhi, qlo);
    load_a<DH, MT>(gb, gsn, row0, N, t, 1.f, ghi, glo);
  }
  // pass 1: per lane and row (g, g + 8 of each m16 tile), the running
  // maximum of its scores, and the sums of exp2(S - max) and exp2(S - max) dP
  float zeros[4] = {0.f, 0.f, 0.f, 0.f};
  auto z_init = [&](int, int) -> const float (&)[4] { return zeros; };
  float mx[MT][2], sl[MT][2], sd[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[mt][r] = kNoScore;
      sl[mt][r] = sd[mt][r] = 0.f;
    }
  for (int step = 0; step < ntiles; ++step) {
    dq_advance<DH>(ring, sp, stage_floats, step, steps, ntiles, kt, kb, ksn, vb, vsn, M);
    const int key0 = step * kt;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += GB) {
      if (j0 < ntr) {
        float s[MT][GB][4], dp[MT][GB][4];
        dq_scores<DH, AR, AK>(s, dp, z_init, z_init, qhi, qlo, ghi, glo, qrows, grows,
                              qscale, sp, kt, j0, key0, M, g, t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float m = mx[mt][r];
#pragma unroll
            for (int j = 0; j < GB; ++j)
              m = fmaxf(m, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
            const float corr = exp2_sfu(mx[mt][r] - m);
            float l = sl[mt][r] * corr, d = sd[mt][r] * corr;
#pragma unroll
            for (int j = 0; j < GB; ++j)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                const float p = exp2_sfu(s[mt][j][e] - m);
                l += p;
                d += p * dp[mt][j][e];
              }
            mx[mt][r] = m;
            sl[mt][r] = l;
            sd[mt][r] = d;
          }
      }
    }
  }
  // L = max + log2(sum) and delta over the quad; where pass 2 starts
  float s0[MT][4], dp0[MT][4];
  float* lb = stats + (long long)bh * N;
  float* db = stats + (long long)BH * N + (long long)bh * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = mx[mt][r];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float f = exp2_sfu(mx[mt][r] - m);
      float l = sl[mt][r] * f, d = sd[mt][r] * f;
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const float L2 = m + log2f(l), delta = d / l;
      s0[mt][2 * r] = s0[mt][2 * r + 1] = -L2;
      dp0[mt][2 * r] = dp0[mt][2 * r + 1] = -delta;
      const int row = row0 + 16 * mt + 8 * r;
      if (t == 0 && row < N) {
        lb[row] = L2;
        db[row] = delta;
      }
    }
  auto s_init = [&](int m, int) -> const float (&)[4] { return s0[m]; };
  auto dp_init = [&](int m, int) -> const float (&)[4] { return dp0[m]; };

  // pass 2: dq = sum over the tiles of dS k (see add_tile)
  float acc[DT][MT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][mt][e] = 0.f;
  for (int step = ntiles == 1 ? 0 : ntiles; step < steps; ++step) {
    if (ntiles > 1)  // one tile: still split from pass 1
      dq_advance<DH>(ring, sp, stage_floats, step, steps, ntiles, kt, kb, ksn, vb, vsn, M);
    const int key0 = (step % ntiles) * kt;
    float tacc[DT][MT][GB][4];
    zero(tacc);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += GB) {
      if (j0 < ntr) {
        float s[MT][GB][4], dp[MT][GB][4];
        dq_scores<DH, AR, AK>(s, dp, s_init, dp_init, qhi, qlo, ghi, glo, qrows, grows,
                              qscale, sp, kt, j0, key0, M, g, t);
        // dS / scale = P (dP - delta), in place
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < GB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][j][e] = exp2_sfu(s[mt][j][e]) * dp[mt][j][e];
        // dq += dS k: the 8 keys of group j are one k-step (key 2t in slot
        // t, 2t + 1 in slot t + 4), so K's rows are read in that order
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
    }
    add_tile(acc, tacc);
  }

  float* dqb = dq + (long long)b * dsb + (long long)h * dsh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mt + 8 * r;
      if (row >= N) continue;
      float* out = dqb + (long long)row * dsn + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(out + 8 * d) =
            make_float2(acc[d][mt][2 * r] * scale, acc[d][mt][2 * r + 1] * scale);
    }
}

// DV: dv = P^T dO; DK: dk = dS^T q * scale. Both in one launch at dh 8 to
// 64; at dh 128 one launch each.
template <int DH, bool DV, bool DK>
__global__ void __launch_bounds__(kBwdThreads, Bwd<DH>::kMinBlocks)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ stats, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ part, int BH, int H,
                     int N, int M, int kt, int qw, int splits, int per_split,
                     int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                     int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                     int dksb, int dksh, int dksn, int dvsb, int dvsh, int dvsn,
                     float scale) {
  using C = Bwd<DH>;
  constexpr int LD = C::kLd, KS = DH / 8, DT = DH / 8, MT = C::kTiles, GB = C::kGroups;
  constexpr int NT = C::kTile / 8, ROWS = C::kRows, kStages = C::kStages;
  constexpr int AR = C::kASmem ? 1 : MT, AK = C::kASmem ? 1 : KS;
  extern __shared__ __align__(16) float smem[];
  const int stage_floats = 2 * kt * DH + 2 * kt;
  float* ring = smem;
  uint32_t* sp = reinterpret_cast<uint32_t*>(smem + kStages * stage_floats);
  const uint32_t* qhi = sp;  // the split q and dO tiles
  const uint32_t* ghi = sp + kt * LD;
  const uint32_t* qlo = sp + 2 * kt * LD;
  const uint32_t* glo = sp + 3 * kt * LD;
  const float* quads = reinterpret_cast<const float*>(sp + 4 * kt * LD);
  float* arows = smem + kStages * stage_floats + 4 * kt * LD + 4 * kt;  // k, then v

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int split = blockIdx.y % splits;
  const int warps = blockDim.x >> 5;
  const int kw = warps / qw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kwi = warp / qw, qwi = warp % qw;  // the warp's keys, its part of a tile
  const int g = lane >> 2, t = lane & 3;
  const int block_key0 = blockIdx.y / splits * ROWS * kw;
  const int key0 = block_key0 + kwi * ROWS + g;  // + 16 mt + 8 r
  const float kscale = scale * kLog2e;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;
  const float* lb = stats + (long long)bh * N;
  const float* db = stats + (long long)BH * N + (long long)bh * N;
  const float* krows = arows + kwi * ROWS * LD;
  const float* vrows = arows + (kw + kwi) * ROWS * LD;

  // k (times scale log2 e) and v as A operands, as in the dq kernel
  uint32_t khi[AR][AK][4], klo[AR][AK][4], vhi[AR][AK][4], vlo[AR][AK][4];
  if constexpr (C::kASmem)
    load_a_rows<DH>(arows, kb, ksn, vb, vsn, block_key0, ROWS * kw, M);

  // dk and dv: the sums over the tiles so far (see add_tile)
  float dka[DT][MT][4], dva[DT][MT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[d][mt][e] = dva[d][mt][e] = 0.f;

  const int ntiles = (N + kt - 1) / kt;
  const int first = split * per_split;
  const int last = first + per_split < ntiles ? first + per_split : ntiles;
  const int ntr = kt / 8;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (first + s < last)
      bwd_load<DH>(ring + s * stage_floats, qb, qsn, gb, gsn, lb, db, (first + s) * kt, N, kt);
    cp_async_commit();
  }
  if constexpr (!C::kASmem) {
    load_a<DH, MT>(kb, ksn, key0, M, t, kscale, khi, klo);
    if constexpr (DK) load_a<DH, MT>(vb, vsn, key0, M, t, 1.f, vhi, vlo);
  }
  for (int step = 0; first + step < last; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = step + kStages - 1;
    if (first + next < last)
      bwd_load<DH>(ring + (next % kStages) * stage_floats, qb, qsn, gb, gsn, lb, db,
                   (first + next) * kt, N, kt);
    cp_async_commit();
    bwd_split<DH>(ring + (step % kStages) * stage_floats, sp, kt, true);
    __syncthreads();
    // this tile's dk and dv, one partial sum per query group of a chunk
    float tka[DT][MT][GB][4], tva[DT][MT][GB][4];
    zero(tka);
    zero(tva);
#pragma unroll
    for (int i0 = 0; i0 < NT; i0 += GB) {
      if (i0 < ntr && (i0 / GB) % qw == qwi) {
        // S^T - L = k q^T - L and dP^T - delta = v dO^T - delta: keys g,
        // g + 8; queries 8 i + 2t, 8 i + 2t + 1, whose -L and -delta (the
        // split tile's quads) vary along the columns
        float st0[GB][4], dpt0[GB][4];
#pragma unroll
        for (int j = 0; j < GB; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(quads + 4 * (4 * (i0 + j) + t));
          const float4 c = *reinterpret_cast<const float4*>(quads + 2 * kt + 4 * (4 * (i0 + j) + t));
          st0[j][0] = a.x; st0[j][1] = a.y; st0[j][2] = a.z; st0[j][3] = a.w;
          dpt0[j][0] = c.x; dpt0[j][1] = c.y; dpt0[j][2] = c.z; dpt0[j][3] = c.w;
        }
        auto st_init = [&](int, int j) -> const float (&)[4] { return st0[j]; };
        auto dpt_init = [&](int, int j) -> const float (&)[4] { return dpt0[j]; };
        float st[MT][GB][4], dpt[MT][GB][4];
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          uint32_t ah[MT][4], al[MT][4];
          if constexpr (C::kASmem)
            frag_smem<DH, MT>(krows, c, g, t, kscale, ah, al);
          else
            frag_regs<MT, KS>(khi, klo, c, ah, al);
          uint32_t qh[GB][2], ql[GB][2];
#pragma unroll
          for (int j = 0; j < GB; ++j)
            row_b(qhi, qlo, ((i0 + j) * 8 + g) * LD + 8 * c + t, qh[j], ql[j]);
          mma3_step<MT, GB>(st, st_init, c == 0, ah, al, qh, ql);
          if constexpr (DK) {
            if constexpr (C::kASmem)
              frag_smem<DH, MT>(vrows, c, g, t, 1.f, ah, al);
            else
              frag_regs<MT, KS>(vhi, vlo, c, ah, al);
            uint32_t gh[GB][2], gl[GB][2];
#pragma unroll
            for (int j = 0; j < GB; ++j)
              row_b(ghi, glo, ((i0 + j) * 8 + g) * LD + 8 * c + t, gh[j], gl[j]);
            mma3_step<MT, GB>(dpt, dpt_init, c == 0, ah, al, gh, gl);
          }
        }
        // P^T = exp2(S^T - L) and dS^T / scale = P^T (dP^T - delta)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < GB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              st[mt][j][e] = exp2_sfu(st[mt][j][e]);
              if constexpr (DK) dpt[mt][j][e] *= st[mt][j][e];
            }
        // dv += P^T dO, dk += dS^T q: the 8 queries of group i are one
        // k-step (query 2t in slot t, 2t + 1 in slot t + 4), so dO's and
        // q's rows are read in that order
        if constexpr (DV) {
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
        if constexpr (DK) {
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
    }
    if constexpr (DK) add_tile(dka, tka);
    if constexpr (DV) add_tile(dva, tva);
  }

  // the qw warps of a key group add their sums in shared memory, in warp
  // order; the first of them stores
  constexpr int NV = DT * MT * 4, OUTS = (DK ? 1 : 0) + (DV ? 1 : 0);
  if (qw > 1) {
    cp_async_wait<0>();
    __syncthreads();  // the ring and the split tile are free
    // [warp][dk, dv][value][lane]
    float* sums = smem + lane;
    const int wstride = OUTS * NV * 32;
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ((d * MT + mt) * 4 + e) * 32;
          if constexpr (DK) sums[warp * wstride + i] = dka[d][mt][e];
          if constexpr (DV) sums[warp * wstride + (OUTS - 1) * NV * 32 + i] = dva[d][mt][e];
        }
    __syncthreads();
    if (qwi != 0) return;
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ((d * MT + mt) * 4 + e) * 32;
          float sk = 0.f, sv = 0.f;
          for (int w = warp; w < warp + qw; ++w) {
            if constexpr (DK) sk += sums[w * wstride + i];
            if constexpr (DV) sv += sums[w * wstride + (OUTS - 1) * NV * 32 + i];
          }
          dka[d][mt][e] = sk;
          dva[d][mt][e] = sv;
        }
  }

  // the key's rows: into dk and dv, or (query rows split over blocks) into
  // this split's partial sums
  const bool whole = splits == 1;
  float* dkb = whole ? dk + (long long)b * dksb + (long long)h * dksh
                     : part + ((long long)bh * splits + split) * M * DH;
  float* dvb = whole ? dv + (long long)b * dvsb + (long long)h * dvsh
                     : part + (((long long)BH + bh) * splits + split) * M * DH;
  const long long krs = whole ? dksn : DH, vrs = whole ? dvsn : DH;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 16 * mt + 8 * r;
      if (key >= M) continue;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int col = 8 * d + 2 * t;
        if constexpr (DK)
          *reinterpret_cast<float2*>(dkb + key * krs + col) =
              make_float2(dka[d][mt][2 * r] * scale, dka[d][mt][2 * r + 1] * scale);
        if constexpr (DV)
          *reinterpret_cast<float2*>(dvb + key * vrs + col) =
              make_float2(dva[d][mt][2 * r], dva[d][mt][2 * r + 1]);
      }
    }
}

// dk and dv from the dk/dv kernel's partial sums, added in split order; one
// thread per two values of both.
__global__ void attn_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dk,
                                    float* __restrict__ dv, int BH, int H, int M, int DH,
                                    int splits, int dksb, int dksh, int dksn, int dvsb,
                                    int dvsh, int dvsn) {
  const long long pairs = (long long)BH * M * (DH / 2);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pairs) return;
  const int col = 2 * (int)(e % (DH / 2));
  const int key = (int)(e / (DH / 2) % M);
  const int bh = (int)(e / ((long long)(DH / 2) * M));
  const int b = bh / H, h = bh % H;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const long long off = (long long)s * M * DH + (long long)key * DH + col;
    const float2 a = *reinterpret_cast<const float2*>(part + (long long)bh * splits * M * DH + off);
    const float2 c = *reinterpret_cast<const float2*>(
        part + ((long long)BH + bh) * splits * M * DH + off);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += c.x;
    sv.y += c.y;
  }
  *reinterpret_cast<float2*>(dk + (long long)b * dksb + (long long)h * dksh +
                             (long long)key * dksn + col) = sk;
  *reinterpret_cast<float2*>(dv + (long long)b * dvsb + (long long)h * dvsh +
                             (long long)key * dvsn + col) = sv;
}

// The kernel's opt-in to more than 48 KB of shared memory where the plan
// needs it.
template <auto Kernel>
int smem_opt_in(long long smem, int dev, long long optin) {
  if (smem > optin) return (int)cudaErrorInvalidValue;
  return smem > 48 * 1024 ? kernel_launch::opt_in<Kernel>(dev, optin) : 0;
}

template <int DH, bool DV, bool DK>
int launch_dkdv(const float* q, const float* k, const float* v, const float* g,
                const float* stats, float* dk, float* dv, float* part, int BH, int H,
                int N, int M, const int* s, float scale, int dev, long long optin,
                cudaStream_t st) {
  const BwdPlan p = plan_dkdv<DH>(BH, N, M, DV && DK ? 2 : 1);
  const int err = smem_opt_in<attn_bwd_dkdv_kernel<DH, DV, DK>>(p.smem, dev, optin);
  if (err != 0) return err;
  if (p.blocks_y > 65535) return (int)cudaErrorInvalidValue;
  attn_bwd_dkdv_kernel<DH, DV, DK><<<dim3(BH, p.blocks_y), 32 * p.warps, (size_t)p.smem, st>>>(
      q, k, v, g, stats, dk, dv, part, BH, H, N, M, p.kt, p.qw, p.splits, p.per_split,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[15], s[16], s[17], s[18], s[19], s[20], scale);
  return (int)cudaGetLastError();
}

// cp.async needs every q, k, v, dO row on 16 bytes; the outputs are stored
// 8 bytes at a time.
bool bwd_aligned(const void* const* inputs, const void* const* outputs, const int* s) {
  for (int i = 0; i < 4; ++i)
    if ((reinterpret_cast<uintptr_t>(inputs[i]) & 15) != 0 || s[3 * i] % 4 ||
        s[3 * i + 1] % 4 || s[3 * i + 2] % 4)
      return false;
  for (int i = 0; i < 3; ++i)
    if ((reinterpret_cast<uintptr_t>(outputs[i]) & 7) != 0 || s[12 + 3 * i] % 2 ||
        s[13 + 3 * i] % 2 || s[14 + 3 * i] % 2)
      return false;
  return true;
}

template <int DH>
int launch_bwd(const float* q, const float* k, const float* v, const float* g, float* dq,
               float* dk, float* dv, float* scratch, long long scratch_size, int B, int H,
               int N, int M, const int* s, float scale, cudaStream_t st) {
  const int BH = B * H;
  if (scratch_size < scratch_floats<DH>(BH, N, M)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  long long optin = 0;
  int err = kernel_launch::device_optin(&dev, &optin);
  if (err != 0) return err;
  const BwdPlan p = plan_dq<DH>(N, M);
  err = smem_opt_in<attn_bwd_dq_kernel<DH>>(p.smem, dev, optin);
  if (err != 0) return err;
  if (p.blocks_y > 65535) return (int)cudaErrorInvalidValue;
  attn_bwd_dq_kernel<DH><<<dim3(BH, p.blocks_y), 32 * p.warps, (size_t)p.smem, st>>>(
      q, k, v, g, scratch, dq, BH, H, N, M, p.kt, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], s[9], s[10], s[11], s[12], s[13], s[14], scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  float* part = scratch + (2LL * BH * N + 3) / 4 * 4;
  if constexpr (DH >= 128) {  // dv, then dk
    err = launch_dkdv<DH, true, false>(q, k, v, g, scratch, dk, dv, part, BH, H, N, M, s,
                                       scale, dev, optin, st);
    if (err == 0)
      err = launch_dkdv<DH, false, true>(q, k, v, g, scratch, dk, dv, part, BH, H, N, M, s,
                                         scale, dev, optin, st);
  } else {
    err = launch_dkdv<DH, true, true>(q, k, v, g, scratch, dk, dv, part, BH, H, N, M, s,
                                      scale, dev, optin, st);
  }
  if (err != 0 || plan_dkdv<DH>(BH, N, M, 2).splits == 1) return err;
  const long long pairs = (long long)BH * M * (DH / 2);
  attn_bwd_sum_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
      part, dk, dv, BH, H, M, DH, plan_dkdv<DH>(BH, N, M, 2).splits, s[15], s[16], s[17],
      s[18], s[19], s[20]);
  return (int)cudaGetLastError();
}

bool bwd_shape_ok(int B, int H, int N, int M) {
  return B > 0 && H > 0 && N > 0 && M > 0 && (long long)B * H <= 2147483647LL;
}

}  // namespace

// Floats of the scratch attention_core_bwd needs at a shape; -1 for a head
// size or shape it does not take.
extern "C" long long attention_core_bwd_scratch(int B, int H, int N, int M, int DH) {
  if (!bwd_shape_ok(B, H, N, M)) return -1;
  const long long BH = (long long)B * H;
  switch (DH) {
    case 8: return scratch_floats<8>(BH, N, M);
    case 16: return scratch_floats<16>(BH, N, M);
    case 32: return scratch_floats<32>(BH, N, M);
    case 64: return scratch_floats<64>(BH, N, M);
    case 128: return scratch_floats<128>(BH, N, M);
    default: return -1;
  }
}

// Strides are in elements, in the order q, k, v, dO, dq, dk, dv (batch,
// head, row each); the last dimension of every tensor has stride 1; q, k, v
// and dO rows start on 16 bytes, dq, dk and dv on 8 with even strides.
// scratch holds attention_core_bwd_scratch() floats (scratch_size), on 16
// bytes. Runs two to four kernels on `stream`, allocates nothing and returns
// the first launch error (cudaErrorInvalidValue for a head size, shape or
// layout it does not take).
extern "C" int attention_core_bwd(const void* q, const void* k, const void* v,
                                  const void* dO, void* dq, void* dk, void* dv,
                                  void* scratch, long long scratch_size, int B, int H,
                                  int N, int M, int DH, const int* strides, float scale,
                                  void* stream) {
  if (!bwd_shape_ok(B, H, N, M)) return (int)cudaErrorInvalidValue;
  const void* inputs[4] = {q, k, v, dO};
  const void* outputs[3] = {dq, dk, dv};
  if (!bwd_aligned(inputs, outputs, strides) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* gf = (const float*)dO;
  float* dqf = (float*)dq;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  float* sf = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8:
      return launch_bwd<8>(qf, kf, vf, gf, dqf, dkf, dvf, sf, scratch_size, B, H, N, M,
                           strides, scale, st);
    case 16:
      return launch_bwd<16>(qf, kf, vf, gf, dqf, dkf, dvf, sf, scratch_size, B, H, N, M,
                            strides, scale, st);
    case 32:
      return launch_bwd<32>(qf, kf, vf, gf, dqf, dkf, dvf, sf, scratch_size, B, H, N, M,
                            strides, scale, st);
    case 64:
      return launch_bwd<64>(qf, kf, vf, gf, dqf, dkf, dvf, sf, scratch_size, B, H, N, M,
                            strides, scale, st);
    case 128:
      return launch_bwd<128>(qf, kf, vf, gf, dqf, dkf, dvf, sf, scratch_size, B, H, N, M,
                             strides, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
