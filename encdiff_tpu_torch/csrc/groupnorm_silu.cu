// GroupNorm (+ optional FiLM) + SiLU, forward, fp32, NCHW.
//
// Replaces the TPU kernel encdiff_tpu/nn/pallas/groupnorm_silu.py,
// groupnorm_silu (_gn_silu_kernel): per sample, GroupNorm over G contiguous
// channel groups with fp32 statistics, then the affine, then the optional
// FiLM y * (1 + scale[b, c]) + shift[b, c], then SiLU.
//
// Layout: x is NCHW and contiguous, so the cg = C / G channels of one group
// are one contiguous run of cg * H * W floats. One block of 256 threads
// takes one (sample, group) pair; the grid is (G, B).
//
// Statistics: two passes over the group, mean first and then the mean of
// squared deviations, in fp32, as the JAX reference_groupnorm_silu does.
// The Pallas kernel uses E[x^2] - E[x]^2 instead; the two-pass form loses no
// digits to cancellation. A third pass normalises and writes.
//
// Bound on the H100: bytes. Each element is read once and written once
// (8 bytes) for about ten fp32 operations, far below the card's
// 67 TFLOP/s / 3.35 TB/s = 20 operations per byte. A group is at most
// 32 KB on the flagship's path (64 x 64 x 2 channels in the VQ decoder), so
// the second and third passes hit L1 / L2 and device memory sees about one
// read and one write of x. No shared-memory staging, no vector loads and no
// tuning yet: a later change can make it faster.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float t = lane < kThreads / 32 ? red[lane] : 0.f;
  return warp_sum(t);
}

__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out,
               int C, int HW, int G, float eps) {
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = C / G;
  const long long n = (long long)cg * HW;
  const long long base = ((long long)b * C + (long long)g * cg) * HW;
  const float* xg = x + base;
  float* og = out + base;

  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += kThreads) s += xg[i];
  const float mean = block_sum(s, red) / (float)n;

  float s2 = 0.f;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const float d = xg[i] - mean;
    s2 += d * d;
  }
  const float var = block_sum(s2, red) / (float)n;
  const float rstd = rsqrtf(var + eps);

  const long long film = (long long)b * C;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int c = g * cg + (int)(i / HW);
    float y = (xg[i] - mean) * rstd * gamma[c] + beta[c];
    if (scale != nullptr) y = y * (1.f + scale[film + c]) + shift[film + c];
    og[i] = y / (1.f + expf(-y));
  }
}

}  // namespace

// x, out: (B, C, H*W) fp32 contiguous; gamma, beta: (C,); scale, shift:
// (B, C) or both null for no FiLM. Runs on `stream`, allocates nothing and
// returns cudaGetLastError() of the launch.
extern "C" int gn_silu_fwd(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, void* out,
                           int B, int C, int HW, int G, float eps, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((scale == nullptr) != (shift == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid(G, B);
  gn_silu_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gamma, (const float*)beta,
      (const float*)scale, (const float*)shift, (float*)out, C, HW, G, eps);
  return (int)cudaGetLastError();
}
