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
// exp2f; lse crosses device memory in natural-log units, as the TPU's does.
//
// What is not carried over from the TPU: the wrapper there pads dh to 128
// lanes, broadcasts lse to 8 lanes and uses blocks of 512 (256 backward).
// Here dh stays 8, 16 or 128, lse is (B * H, N) fp32, and any N is taken.
//
// Work split (blocks run in parallel, in no order, and nothing carries over
// between them):
// - forward: one block per (batch * head, tile of query rows). TPR threads
//   own one query row (TPR = 1 for dh 8 and 16, 4 for dh 128, each holding
//   dh / TPR dimensions). K and V go through shared memory in tiles of
//   4096 / dh keys (32 KB for the pair, static); the softmax is the online
//   form, rescaled once per chunk of 16 keys rather than per key.
// - dq: query-parallel, one thread per row holding q, dO, its lse and delta
//   and the dq sum; K and V tiles in shared memory. The row statistics are
//   read, not recomputed.
// - dk/dv: key-parallel, one thread per key holding k, v and the two sums;
//   it loops over every query tile (q, dO, lse and delta in shared memory).
//   No atomics and a fixed summation order: a run repeats bit for bit.
// Every tensor is addressed through its own batch, head and row strides with
// the last dimension contiguous, so the callers' (B, N, H, dh) projections
// are read in place and o, dq, dk, dv are written into (B, N, H, dh)-backed
// buffers: merging the heads costs no copy. batch * head is gridDim.x (no
// 65,535 limit); the row tiles are gridDim.y.
//
// Bound on the H100: operations. Per score the forward does 2 dh multiply-
// adds and one exponential, the backward 4 dh (dk/dv) or 3 dh (dq) and one
// exponential, all fp32 on the CUDA cores (67 TFLOP/s); q, k, v, o and the
// gradients cross device memory once, O(N dh) bytes against O(N^2 dh)
// operations. Only tensor cores (a later change, and then not in fp32)
// would lift the bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileFloats = 4096;  // one K (or q) tile and one V (or dO) tile: 16 KB each
constexpr int kChunk = 16;         // keys per online-softmax rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH, int TPR>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int N,
                 int qsb, int qsh, int qsn, int ksb, int ksh, int ksn,
                 int vsb, int vsh, int vsn, int osb, int osh, int osn,
                 float scale) {
  constexpr int DPT = DH / TPR;         // dimensions per thread
  constexpr int KT = kTileFloats / DH;  // keys per tile, a multiple of kChunk
  static_assert(KT % kChunk == 0, "tile must hold whole chunks");
  __shared__ float ks[KT * DH];
  __shared__ float vs[KT * DH];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int rows_per_block = kThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.y * rows_per_block + threadIdx.x / TPR;
  const bool active = row < N;

  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  const float* kb = k + (long long)b * ksb + (long long)h * ksh;
  const float* vb = v + (long long)b * vsb + (long long)h * vsh;

  const float qscale = scale * kLog2e;  // scores in log2 units
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = active ? qb[(long long)row * qsn + i * TPR + lane] * qscale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int t0 = 0; t0 < N; t0 += KT) {
    const int kt = min(KT, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kt * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      ks[e] = kb[(long long)(t0 + j) * ksn + d];
      vs[e] = vb[(long long)(t0 + j) * vsn + d];
    }
    __syncthreads();
    // Rows past N run on zeros and store nothing, so that every lane
    // reaches the shuffles.
    for (int j0 = 0; j0 < kt; j0 += kChunk) {
      float s[kChunk];
      float mc = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float sc = -INFINITY;
        if (j < kt) {  // uniform over the block
          const float* kj = ks + j * DH;
          sc = 0.f;
#pragma unroll
          for (int i = 0; i < DPT; ++i) sc += qr[i] * kj[i * TPR + lane];
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
        }
        s[c] = sc;
        mc = fmaxf(mc, sc);
      }
      if (mc > m) {
        const float corr = exp2f(m - mc);  // 0 on the first chunk
        l *= corr;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] *= corr;
        m = mc;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j < kt) {
          const float p = exp2f(s[c] - m);
          l += p;
          const float* vj = vs + j * DH;
#pragma unroll
          for (int i = 0; i < DPT; ++i) acc[i] += p * vj[i * TPR + lane];
        }
      }
    }
  }
  if (active) {
    float* ob = o + (long long)b * osb + (long long)h * osh + (long long)row * osn;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[i * TPR + lane] = acc[i] * inv;
    if (lane == 0) lse[(long long)bh * N + row] = (m + log2f(l)) * kLn2;
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

template <int DH, int TPR>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
               int B, int H, int N, const int* s, float scale, cudaStream_t st) {
  constexpr int rows = kThreads / TPR;
  if (bad_shape(B, H, N, rows)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (N + rows - 1) / rows);
  flash_fwd_kernel<DH, TPR><<<grid, kThreads, 0, st>>>(
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
// stride 1. lse and delta are contiguous (B * H, N) fp32.

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
    case 8: return launch_fwd<8, 1>(qf, kf, vf, of, lf, B, H, N, strides, scale, st);
    case 16: return launch_fwd<16, 1>(qf, kf, vf, of, lf, B, H, N, strides, scale, st);
    case 128: return launch_fwd<128, 4>(qf, kf, vf, of, lf, B, H, N, strides, scale, st);
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
