// softmax(q k^T * scale) v, forward, fp32.
//
// Replaces the TPU kernel encdiff_tpu/nn/pallas/attention.py,
// _attn_core_fwd_call (_attn_core_kernel), the score / softmax / value chain
// of every SpatialTransformer attention and of the VQ decoder's AttnBlock.
// The q / k / v / out projections around it stay in PyTorch.
//
// Shapes: q (B, H, N, DH), k and v (B, H, M, DH), out (B, H, N, DH). Each
// tensor is addressed through its own batch, head and row strides, with the
// last dimension contiguous, so the callers' (B, N, H, DH) projections are
// read in place without a transpose copy.
//
// Work split: one block per (batch * head, tile of query rows). TPR threads
// own one query row (TPR = 1 for DH <= 32, DH / 32 above), each holding
// DH / TPR of its dimensions, interleaved so that neighbouring lanes read
// neighbouring shared-memory words. K and V are staged through shared memory
// in tiles of 4096 / DH keys that every row of the block reuses. The softmax
// is the online form in fp32: a running maximum, a running sum and an
// accumulator rescaled when the maximum grows. No N x M score tensor is
// written to device memory.
//
// Bound on the H100: at M = 20 (cross-attention against the concept tokens)
// bytes bind: q, k, v and out cross device memory once. At N = M = 256 the
// 4 * N * M * DH fp32 operations on the CUDA cores (67 TFLOP/s) take longer
// than the bytes (3.35 TB/s): the product is then bound by operations, and
// only tensor cores (mma / wgmma, a later change) would lift it. The design
// keeps every intermediate in registers and shared memory, so the bytes are
// the least they can be.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileFloats = 4096;  // one K tile and one V tile: 16 KB each
constexpr int kMaxThreads = 128;

template <int DH, int TPR>
__global__ void __launch_bounds__(kMaxThreads)
attn_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int H, int N, int M,
                 int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                 int vsb, int vsh, int vsn, int osb, int osh, int osn,
                 float scale) {
  constexpr int DPT = DH / TPR;          // dimensions per thread
  constexpr int KT = kTileFloats / DH;   // keys per tile
  __shared__ float ks[KT * DH];
  __shared__ float vs[KT * DH];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int rows_per_block = blockDim.x / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / TPR;
  const bool active = row < N;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;
  float* ob = o + (long long)b * osb + (long long)h * osh;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = active ? qb[(long long)row * qsn + i * TPR + lane] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int t0 = 0; t0 < M; t0 += KT) {
    const int kt = min(KT, M - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kt * DH; e += blockDim.x) {
      const int j = e / DH;
      const int d = e % DH;
      ks[e] = kb[(long long)(t0 + j) * ksn + d];
      vs[e] = vb[(long long)(t0 + j) * vsn + d];
    }
    __syncthreads();
    // Rows past N run the loop on zeros and store nothing, so that every
    // lane reaches the shuffles below.
    for (int j = 0; j < kt; ++j) {
      const float* kj = ks + j * DH;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) s += qr[i] * kj[i * TPR + lane];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] *= corr;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      const float* vj = vs + j * DH;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vj[i * TPR + lane];
    }
  }
  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[(long long)row * osn + i * TPR + lane] = acc[i] * inv;
  }
}

template <int DH, int TPR>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H,
           int N, int M, const int* s, float scale, cudaStream_t stream) {
  int threads = ((N * TPR + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int rows = threads / TPR;
  const dim3 grid((N + rows - 1) / rows, B * H);
  attn_core_kernel<DH, TPR><<<grid, threads, 0, stream>>>(
      q, k, v, o, H, N, M, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
      s[9], s[10], s[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements; the last dimension of every tensor has stride 1.
// Runs on `stream`, allocates nothing and returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for a head size it does not take).
extern "C" int attention_core_fwd(const void* q, const void* k, const void* v, void* o,
                                  int B, int H, int N, int M, int DH,
                                  int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                                  int vsb, int vsh, int vsn, int osb, int osh, int osn,
                                  float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int s[12] = {qsb, qsh, qsn, ksb, ksh, ksn, vsb, vsh, vsn, osb, osh, osn};
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (DH) {
    case 8: return launch<8, 1>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 16: return launch<16, 1>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 32: return launch<32, 1>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 64: return launch<64, 2>(qf, kf, vf, of, B, H, N, M, s, scale, st);
    case 128: return launch<128, 4>(qf, kf, vf, of, B, H, N, M, s, scale, st);
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
//    tiles in shared memory, as the forward): a first pass over the keys
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
// CUDA cores; at N = M = 256 operations bind, at M = 20 bytes. As in the
// forward, only tensor cores would lift the first (a later change).

namespace {

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

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
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

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int keys_per_block = blockDim.x / S;
  const int sub = threadIdx.x % S;
  const int key = blockIdx.x * keys_per_block + threadIdx.x / S;
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
  const dim3 grid_q((N + threads - 1) / threads, B * H);
  attn_bwd_dq_kernel<DH><<<grid_q, threads, 0, stream>>>(
      q, k, v, g, dq, lse, delta, H, N, M,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[12], s[13], s[14], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int keys = 4;  // keys per block: the power of two that covers M, 4..128
  while (keys < M && keys < kBwdThreads) keys <<= 1;
  const int S = kBwdThreads / keys;  // lanes per key, 1..32
  const dim3 grid_k((M + keys - 1) / keys, B * H);
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
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || B * H > 65535)
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
