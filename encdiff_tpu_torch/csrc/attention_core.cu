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
// Work split. The TPU kernel runs one program per (batch, head) in order;
// here blocks run in parallel and nothing carries over between them, and dk
// and dv sum over every query row. So the backward is two launches, neither
// of which writes an N x M tensor:
//
// 1. attn_bwd_dq_kernel, row-parallel (one thread per query row, K and V
//    tiles in shared memory): a first pass over the keys
//    finds the row's logsumexp L and delta = rowsum(dP o P) with an online
//    rescale; a second pass recomputes P = exp(s - L) and sums dq. It writes
//    L and delta to a (B * H, N) scratch.
// 2. attn_bwd_dkdv_kernel, key-parallel: S consecutive lanes share one key
//    and split the query rows between them (S = 128 / next_pow2(M), at most
//    32, so that M = 20 still fills a block); Q, dO, L and delta are staged
//    in shared memory tile by tile, and the S partial sums of dk and dv are
//    added with warp shuffles, in a fixed order, before one lane writes them.
//
// Every tensor is addressed through its own batch, head and row strides with
// the last dimension contiguous: dO arrives as the gradient of the
// forward's (B, N, H, DH)-backed view, and dq, dk, dv are written into
// (B, L, H, DH)-backed buffers so that the callers' head merge costs no copy.
// Head sizes 8, 16 and 32 (the UNet's at every level), one thread per row.
//
// Bound on the H100: the five N x M x DH products (two recomputes of
// q k^T, dO v^T twice, and the dq, dk, dv sums) and the exps are fp32 on the
// CUDA cores; at N = M = 256 operations bind, at M = 20 bytes. Only tensor
// cores, as in the forward, would lift the first (a later change). Both
// kernels put B * H on gridDim.x (any B * H that fits an int) and the row or
// key tiles on gridDim.y.

namespace {

constexpr int kTileFloats = 4096;  // one K (or q) tile and one V (or dO) tile: 16 KB each
constexpr int kBwdThreads = 128;

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   float* __restrict__ dq, float* __restrict__ lse,
                   float* __restrict__ delta, int H, int N, int M,
                   int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                   int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                   int dsb, int dsh, int dsn, float scale) {
  constexpr int KT = kTileFloats / DH;  // keys per tile
  __shared__ float ks[KT * DH];
  __shared__ float vs[KT * DH];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = row < N;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;
  float* db = dq + (long long)b * dsb + (long long)h * dsh;

  float qr[DH], gr[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = active ? qb[(long long)row * qsn + i] : 0.f;
    gr[i] = active ? gb[(long long)row * gsn + i] : 0.f;
    acc[i] = 0.f;
  }

  const int ntiles = (M + KT - 1) / KT;
  float m = -INFINITY, l = 0.f, dsum = 0.f;
  float L = 0.f, dl = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = t * KT;
      const int kt = min(KT, M - t0);
      if (pass == 0 || ntiles > 1) {  // one tile stays resident for pass 1
        __syncthreads();
        for (int e = threadIdx.x; e < kt * DH; e += blockDim.x) {
          const int j = e / DH;
          const int d = e % DH;
          ks[e] = kb[(long long)(t0 + j) * ksn + d];
          vs[e] = vb[(long long)(t0 + j) * vsn + d];
        }
        __syncthreads();
      }
      for (int j = 0; j < kt; ++j) {
        const float* kj = ks + j * DH;
        const float* vj = vs + j * DH;
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          sc += qr[i] * kj[i];
          dp += gr[i] * vj[i];
        }
        sc *= scale;
        if (pass == 0) {
          if (sc > m) {
            const float corr = expf(m - sc);
            l *= corr;
            dsum *= corr;
            m = sc;
          }
          const float p = expf(sc - m);
          l += p;
          dsum += p * dp;
        } else {
          const float p = expf(sc - L);
          const float ds = p * (dp - dl) * scale;
#pragma unroll
          for (int i = 0; i < DH; ++i) acc[i] += ds * kj[i];
        }
      }
    }
    if (pass == 0) {
      L = m + logf(l);
      dl = dsum / l;
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < DH; ++i) db[(long long)row * dsn + i] = acc[i];
    lse[(long long)bh * N + row] = L;
    delta[(long long)bh * N + row] = dl;
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int H, int N, int M, int S,
                     int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                     int vsb, int vsh, int vsn, int gsb, int gsh, int gsn,
                     int dksb, int dksh, int dksn, int dvsb, int dvsh, int dvsn,
                     float scale) {
  constexpr int QT = kTileFloats / DH;  // query rows per tile
  __shared__ float qs[QT * DH];
  __shared__ float gs[QT * DH];
  __shared__ float ls[QT];
  __shared__ float dls[QT];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int keys_per_block = blockDim.x / S;
  const int sub = threadIdx.x % S;
  const int key = blockIdx.y * keys_per_block + threadIdx.x / S;
  const bool active = key < M;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  const float* gb = dO + (long long)b * gsb + (long long)h * gsh;
  const float* lb = lse + (long long)bh * N;
  const float* db = delta + (long long)bh * N;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    kr[i] = active ? kb[(long long)key * ksn + i] : 0.f;
    vr[i] = active ? vb[(long long)key * vsn + i] : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }

  for (int t0 = 0; t0 < N; t0 += QT) {
    const int nt = min(QT, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nt * DH; e += blockDim.x) {
      const int r = e / DH;
      const int d = e % DH;
      qs[e] = qb[(long long)(t0 + r) * qsn + d];
      gs[e] = gb[(long long)(t0 + r) * gsn + d];
    }
    for (int r = threadIdx.x; r < nt; r += blockDim.x) {
      ls[r] = lb[t0 + r];
      dls[r] = db[t0 + r];
    }
    __syncthreads();
    for (int r = sub; r < nt; r += S) {
      const float* qi = qs + r * DH;
      const float* gi = gs + r * DH;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        sc += qi[i] * kr[i];
        dp += gi[i] * vr[i];
      }
      const float p = expf(sc * scale - ls[r]);
      const float ds = p * (dp - dls[r]) * scale;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        dvr[i] += p * gi[i];
        dkr[i] += ds * qi[i];
      }
    }
  }
  // add the S partial sums of each key; S consecutive lanes of one warp
  for (int off = S / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dkr[i] += __shfl_xor_sync(0xffffffffu, dkr[i], off);
      dvr[i] += __shfl_xor_sync(0xffffffffu, dvr[i], off);
    }
  }
  if (active && sub == 0) {
    float* dkb = dk + (long long)b * dksb + (long long)h * dksh + (long long)key * dksn;
    float* dvb = dv + (long long)b * dvsb + (long long)h * dvsh + (long long)key * dvsn;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dkb[i] = dkr[i];
      dvb[i] = dvr[i];
    }
  }
}

template <int DH>
int launch_bwd(const float* q, const float* k, const float* v, const float* g,
               float* dq, float* dk, float* dv, float* lse, float* delta,
               int B, int H, int N, int M, const int* s, float scale,
               cudaStream_t stream) {
  int threads = ((N + 31) / 32) * 32;
  if (threads > kBwdThreads) threads = kBwdThreads;
  int keys = 4;  // keys per dk/dv block: the power of two that covers M, 4..128
  while (keys < M && keys < kBwdThreads) keys <<= 1;
  const int row_tiles = (N + threads - 1) / threads, key_tiles = (M + keys - 1) / keys;
  if (row_tiles > 65535 || key_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid_q(B * H, row_tiles);
  attn_bwd_dq_kernel<DH><<<grid_q, threads, 0, stream>>>(
      q, k, v, g, dq, lse, delta, H, N, M,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[12], s[13], s[14], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int S = kBwdThreads / keys;  // lanes per key, 1..32
  const dim3 grid_k(B * H, key_tiles);
  attn_bwd_dkdv_kernel<DH><<<grid_k, kBwdThreads, 0, stream>>>(
      q, k, v, g, lse, delta, dk, dv, H, N, M, S,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[15], s[16], s[17], s[18], s[19], s[20], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, in the order q, k, v, dO, dq, dk, dv (batch,
// head, row each); the last dimension of every tensor has stride 1. lse and
// delta are (B * H, N) fp32 scratch the caller allocates. Runs two kernels
// on `stream`, allocates nothing and returns the first launch error
// (cudaErrorInvalidValue for a head size it does not take).
extern "C" int attention_core_bwd(const void* q, const void* k, const void* v,
                                  const void* dO, void* dq, void* dk, void* dv,
                                  void* lse, void* delta, int B, int H, int N,
                                  int M, int DH, const int* strides, float scale,
                                  void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* gf = (const float*)dO;
  float* dqf = (float*)dq;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
  float* lf = (float*)lse;
  float* df = (float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8:
      return launch_bwd<8>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, B, H, N, M, strides, scale, st);
    case 16:
      return launch_bwd<16>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, B, H, N, M, strides, scale, st);
    case 32:
      return launch_bwd<32>(qf, kf, vf, gf, dqf, dkf, dvf, lf, df, B, H, N, M, strides, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
