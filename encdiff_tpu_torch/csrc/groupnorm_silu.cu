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

// ---------------------------------------------------------------------------
// Backward, fp32, NCHW: dx, dgamma, dbeta and the FiLM rows' dscale, dshift.
//
// The TPU path has no Pallas kernel for this: encdiff_tpu/nn/pallas/
// groupnorm_silu.py (_gn_silu_bwd, :113) recomputes through the jnp reference
// and lets XLA differentiate it. Here it is one kernel, so that a train step
// does not spend about fifteen elementwise launches per GN-SiLU site.
//
// One block of 256 threads per (sample, group), a contiguous NCHW run, as in
// the forward. The block recomputes the two-pass mean and rstd, then, per
// channel of the group, z = (xn * gamma + beta) (1 + scale) + shift and
// dz = g sigma(z) (1 + z (1 - sigma(z))), and writes
//   dshift[b, c] = sum dz,  dscale[b, c] = sum dz * y,
//   dbeta_part[b, c] = sum dy,  dgamma_part[b, c] = sum dy * xn,
// with y = xn * gamma + beta and dy = dz (1 + scale). A last pass writes
//   dx = rstd (dxn - mean_g(dxn) - xn mean_g(dxn * xn)),  dxn = dy * gamma.
// A second small launch sums the (B, C) partials of dgamma and dbeta over
// the batch, one thread per channel in batch order: no atomics, so a run
// repeats bit for bit.
//
// Bound on the H100: bytes, as the forward: x and g read, dx written once
// (12 bytes an element) for about thirty fp32 operations. The group is read
// three times more (statistics, per-channel sums, dx); a group is at most
// 32 KB on the train path, so the re-reads hit L1 / L2.

namespace {

template <int K>
__device__ void block_sum_k(float (&v)[K], float* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = warp_sum(lane < kWarps ? red[i * kWarps + lane] : 0.f);
}

__device__ __forceinline__ float silu_grad(float z, float g) {
  const float sig = 1.f / (1.f + expf(-z));
  return g * sig * (1.f + z * (1.f - sig));
}

__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ scale,
                   const float* __restrict__ shift, const float* __restrict__ gout,
                   float* __restrict__ dx, float* __restrict__ dscale,
                   float* __restrict__ dshift, float* __restrict__ dgamma_part,
                   float* __restrict__ dbeta_part, int C, int HW, int G, float eps) {
  __shared__ float red[4 * (kThreads / 32)];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = C / G;
  const long long n = (long long)cg * HW;
  const long long base = ((long long)b * C + (long long)g * cg) * HW;
  const float* xg = x + base;
  const float* gg = gout + base;
  float* dxg = dx + base;
  const bool film = scale != nullptr;

  float s[1] = {0.f};
  for (long long i = threadIdx.x; i < n; i += kThreads) s[0] += xg[i];
  block_sum_k<1>(s, red);
  const float mean = s[0] / (float)n;
  float s2[1] = {0.f};
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const float d = xg[i] - mean;
    s2[0] += d * d;
  }
  block_sum_k<1>(s2, red);
  const float rstd = rsqrtf(s2[0] / (float)n + eps);

  float gsum[2] = {0.f, 0.f};  // sum dxn, sum dxn * xn over the group
  for (int ci = 0; ci < cg; ++ci) {
    const int c = g * cg + ci;
    const long long bc = (long long)b * C + c;
    const float ga = gamma[c];
    const float be = beta[c];
    const float sc1 = film ? 1.f + scale[bc] : 1.f;
    const float sh = film ? shift[bc] : 0.f;
    float cs[4] = {0.f, 0.f, 0.f, 0.f};  // dz, dz * y, dy, dy * xn
    for (int p = threadIdx.x; p < HW; p += kThreads) {
      const long long i = (long long)ci * HW + p;
      const float xn = (xg[i] - mean) * rstd;
      const float y = xn * ga + be;
      const float dz = silu_grad(y * sc1 + sh, gg[i]);
      const float dy = dz * sc1;
      cs[0] += dz;
      cs[1] += dz * y;
      cs[2] += dy;
      cs[3] += dy * xn;
      const float dxn = dy * ga;
      gsum[0] += dxn;
      gsum[1] += dxn * xn;
    }
    block_sum_k<4>(cs, red);
    if (threadIdx.x == 0) {
      if (film) {
        dshift[bc] = cs[0];
        dscale[bc] = cs[1];
      }
      dbeta_part[bc] = cs[2];
      dgamma_part[bc] = cs[3];
    }
  }
  block_sum_k<2>(gsum, red);
  const float m1 = gsum[0] / (float)n;
  const float m2 = gsum[1] / (float)n;

  const long long film_row = (long long)b * C;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int c = g * cg + (int)(i / HW);
    const float ga = gamma[c];
    const float sc1 = film ? 1.f + scale[film_row + c] : 1.f;
    const float sh = film ? shift[film_row + c] : 0.f;
    const float xn = (xg[i] - mean) * rstd;
    const float y = xn * ga + beta[c];
    const float dxn = silu_grad(y * sc1 + sh, gg[i]) * sc1 * ga;
    dxg[i] = rstd * (dxn - m1 - xn * m2);
  }
}

// dgamma[c] = sum_b dgamma_part[b, c], dbeta likewise, in batch order.
__global__ void gn_param_grad_kernel(const float* __restrict__ dgamma_part,
                                     const float* __restrict__ dbeta_part,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < B; ++b) {
    sg += dgamma_part[(long long)b * C + c];
    sb += dbeta_part[(long long)b * C + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

}  // namespace

// x, gout, dx: (B, C, H*W) fp32 contiguous; gamma, beta, dgamma, dbeta:
// (C,); scale, shift, dscale, dshift: (B, C), all four null for no FiLM;
// dgamma_part, dbeta_part: (B, C) scratch the caller allocates. Runs two
// kernels on `stream`, allocates nothing and returns the first launch error.
extern "C" int gn_silu_bwd(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, const void* gout,
                           void* dx, void* dgamma, void* dbeta, void* dscale,
                           void* dshift, void* dgamma_part, void* dbeta_part,
                           int B, int C, int HW, int G, float eps, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bool film = scale != nullptr;
  if ((shift != nullptr) != film || (dscale != nullptr) != film || (dshift != nullptr) != film)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gn_silu_bwd_kernel<<<dim3(G, B), kThreads, 0, st>>>(
      (const float*)x, (const float*)gamma, (const float*)beta, (const float*)scale,
      (const float*)shift, (const float*)gout, (float*)dx, (float*)dscale,
      (float*)dshift, (float*)dgamma_part, (float*)dbeta_part, C, HW, G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_param_grad_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)dgamma_part, (const float*)dbeta_part, (float*)dgamma,
      (float*)dbeta, B, C);
  return (int)cudaGetLastError();
}
