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
