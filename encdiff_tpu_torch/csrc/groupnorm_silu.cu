// GroupNorm (+ optional FiLM) + SiLU, forward and backward, fp32, NCHW.
//
// Replaces the TPU kernel encdiff_tpu/nn/pallas/groupnorm_silu.py,
// groupnorm_silu (_gn_silu_kernel): per sample, GroupNorm over G contiguous
// channel groups with fp32 statistics, then the affine, then the optional
// FiLM y * (1 + scale[b, c]) + shift[b, c], then SiLU.
//
// Layout: x is NCHW and contiguous, so the cg = C / G channels of one group
// are one contiguous run of n = cg * H * W floats, and group i = b * G + g
// starts at i * n.
//
// Forward: each element of x is read from device memory once and written
// once.
// - A group is staged in dynamic shared memory (cp.async, 16 bytes a thread
//   where n is a multiple of 4 and x starts on 16 bytes, 4 bytes
//   otherwise); the mean, then the mean of squared deviations, are taken
//   from there in fp32 (the two-pass statistics of the JAX
//   reference_groupnorm_silu; the Pallas kernel's E[x^2] - E[x]^2 would lose
//   digits to cancellation); then each element is normalised and written.
// - The affine and the FiLM fold into y = a_c (x - mean) + b_c per channel,
//   a_c = rstd gamma_c (1 + scale_bc) and b_c = beta_c (1 + scale_bc) +
//   shift_bc, computed once per channel into shared memory. A thread walks
//   its elements with the channel index carried along: no division per
//   element.
// - Small groups share a block: a team of 32, 64, 128 or 256 threads (the
//   fewest that give each thread at most 16 floats) takes a group, and a
//   block of 256 threads takes 256 / team groups. The flagship's 2x2 to
//   16x16 levels (groups of 32 to 1,024 floats) run 4 to 8 groups a block.
// - A group larger than a block's shared memory (the faces decoder's 256x256
//   level: 65,536 floats, 256 KB, against 227 KB) is split over a thread-
//   block cluster of 2, 4 or 8 blocks, the fewest whose slices fit. Each
//   block stages its slice; the blocks' partial sums are exchanged through
//   distributed shared memory (cluster.map_shared_rank) with a cluster.sync()
//   after each statistics pass, every block adding them in rank order, so
//   all see the same mean and variance; each block writes its own slice.
// - The plan (team, cluster, slice, shared memory) depends on the shape and
//   the device's opt-in shared memory alone: gn_silu_fwd_plan() below, and
//   its copy gn_silu_plan() in nn/kernels/groupnorm_silu.py that the CPU
//   tests hold and the card tests compare with this one.
// - Grid: (B * G / groups per block) x cluster blocks on gridDim.x: any B
//   whose groups fit an int.
// Bound on the H100: bytes. Each element is read once and written once (8
// bytes) for about ten fp32 operations, far below the card's 67 TFLOP/s /
// 3.35 TB/s = 20 operations per byte. The staging keeps the two statistics
// passes and the normalising pass off device memory; what stays exposed is
// the serial load -> statistics -> store of one block where a group is large
// (one 128 KB block an SM at the faces decoder's 128x128 level).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "launch.cuh"
#include "tf32_mma.cuh"

namespace {

using tf32::cp_async16;
using tf32::cp_async4;
using tf32::cp_async_commit;
using tf32::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kFloatsPerThread = 16;
constexpr int kExtraFloats = kThreads / 32 + 8;  // team sums, cluster partials

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the thread's team of TEAM threads, in a fixed order; every
// thread of the team gets it. Every thread of the block calls it together.
template <int TEAM>
__device__ float team_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (TEAM == 32) {
    return v;
  } else {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // red may still be read by the previous call
    if (lane == 0) red[warp] = v;
    __syncthreads();
    const int first = (threadIdx.x / TEAM) * (TEAM / 32);
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < TEAM / 32; ++w) t += red[first + w];
    return t;
  }
}

// The sum over the cluster's blocks of each block's `mine`, through `slot`
// in each block's shared memory, added in rank order; every thread gets it.
__device__ float cluster_sum(float mine, float* slot, int csize) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = mine;
  cluster.sync();
  float t = 0.f;
  for (int r = 0; r < csize; ++r) t += *cluster.map_shared_rank(slot, r);
  return t;
}

__device__ __forceinline__ float gn_silu(float x, float mean, float a, float b) {
  const float y = fmaf(a, x - mean, b);
  return __fdividef(y, 1.f + __expf(-y));
}

// One (sample, group), or a slice of it, per team: see the note above.
// groups = B * G; slice: floats of a group per block (n, or n / cluster
// rounded up to 4); vec: 16-byte copies.
template <int TEAM>
__global__ void __launch_bounds__(kThreads)
gn_silu_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out,
                   int C, int HW, int G, long long groups, int csize, int slice,
                   float eps, bool vec) {
  constexpr int GPB = kThreads / TEAM;  // groups per block
  extern __shared__ __align__(16) float smem[];
  const int team = threadIdx.x / TEAM, tid = threadIdx.x % TEAM;
  const int rank = blockIdx.x % csize;  // the block's rank in its cluster
  const long long gi = (long long)(blockIdx.x / csize) * GPB + team;
  const bool live = gi < groups;
  const int cg = C / G;
  const long long n = (long long)cg * HW;
  const long long start = (long long)rank * slice;  // the block's part of the group
  const long long rest = live && n > start ? n - start : 0;
  const int len = (int)(rest < slice ? rest : slice);
  float* xs = smem + team * slice;
  float* ab = smem + GPB * slice + team * 2 * cg;  // (a_c, b_c) per channel
  float* red = smem + GPB * (slice + 2 * cg);      // kThreads / 32 team sums
  float* part = red + kThreads / 32;               // the cluster's partials
  const float* xg = x + gi * n + start;
  float* og = out + gi * n + start;

  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) cp_async16(xs + 4 * i, xg + 4 * i, true);
  } else {
    for (int i = tid; i < len; i += TEAM) cp_async4(xs + i, xg + i, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float s = 0.f;
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      const float4 v = reinterpret_cast<const float4*>(xs)[i];
      s += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int i = tid; i < len; i += TEAM) s += xs[i];
  }
  s = team_sum<TEAM>(s, red);
  if (csize > 1) s = cluster_sum(s, part, csize);
  const float mean = s / (float)n;

  float q = 0.f;
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      const float4 v = reinterpret_cast<const float4*>(xs)[i];
      const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
      q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  } else {
    for (int i = tid; i < len; i += TEAM) {
      const float d = xs[i] - mean;
      q += d * d;
    }
  }
  q = team_sum<TEAM>(q, red);
  if (csize > 1) q = cluster_sum(q, part + 1, csize);
  const float rstd = rsqrtf(q / (float)n + eps);

  const long long b = live ? gi / G : 0;
  const int c0 = live ? (int)(gi % G) * cg : 0;
  for (int ci = tid; ci < cg; ci += TEAM) {
    const int c = c0 + ci;
    float a = rstd * gamma[c];
    float bb = beta[c];
    if (scale != nullptr) {
      const float s1 = 1.f + scale[b * C + c];
      a *= s1;
      bb = bb * s1 + shift[b * C + c];
    }
    ab[2 * ci] = a;
    ab[2 * ci + 1] = bb;
  }
  __syncthreads();

  // the channel ci and position p of the thread's first element, carried
  // along by its stride of `step` elements
  const int step = vec ? 4 * TEAM : TEAM;
  const long long e0 = start + (long long)(vec ? 4 * tid : tid);
  int ci = (int)(e0 / HW), p = (int)(e0 % HW);
  const int step_c = step / HW, step_p = step % HW;
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      const float4 v = reinterpret_cast<const float4*>(xs)[i];
      float4 r;
      if (p + 3 < HW) {  // the four elements lie in one channel
        const float a = ab[2 * ci], bb = ab[2 * ci + 1];
        r = make_float4(gn_silu(v.x, mean, a, bb), gn_silu(v.y, mean, a, bb),
                        gn_silu(v.z, mean, a, bb), gn_silu(v.w, mean, a, bb));
      } else {
        float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ci + (p + j) / HW;
          y[j] = gn_silu(y[j], mean, ab[2 * c], ab[2 * c + 1]);
        }
        r = make_float4(y[0], y[1], y[2], y[3]);
      }
      reinterpret_cast<float4*>(og)[i] = r;
      ci += step_c;
      p += step_p;
      if (p >= HW) {
        p -= HW;
        ++ci;
      }
    }
  } else {
    for (int i = tid; i < len; i += TEAM) {
      og[i] = gn_silu(xs[i], mean, ab[2 * ci], ab[2 * ci + 1]);
      ci += step_c;
      p += step_p;
      if (p >= HW) {
        p -= HW;
        ++ci;
      }
    }
  }
  if (csize > 1) cooperative_groups::this_cluster().sync();  // partials read
}

// The forward's launch plan for one shape: team threads a group, groups a
// block, blocks a group (the cluster), floats a block stages of a group,
// and dynamic shared memory in bytes. 0, or cudaErrorInvalidValue where no
// cluster of kMaxCluster blocks fits a group in `limit` bytes a block.
struct GnPlan {
  long long team, per_block, cluster, slice, smem;
};

int plan_fwd(int C, int HW, int G, long long limit, GnPlan* p) {
  const long long cg = C / G;
  const long long n = cg * HW;
  p->team = 32;
  while (p->team < kThreads && p->team * kFloatsPerThread < n) p->team *= 2;
  p->per_block = kThreads / p->team;
  for (p->cluster = 1; p->cluster <= kMaxCluster; p->cluster *= 2) {
    p->slice = ((n + p->cluster - 1) / p->cluster + 3) / 4 * 4;
    p->smem = 4 * (p->per_block * (p->slice + 2 * cg) + kExtraFloats);
    if (p->smem <= limit) return 0;
  }
  return (int)cudaErrorInvalidValue;
}

template <int TEAM>
int launch_fwd(const float* x, const float* gamma, const float* beta,
               const float* scale, const float* shift, float* out, int B, int C,
               int HW, int G, float eps, const GnPlan& p, int dev, long long optin,
               cudaStream_t st) {
  auto kernel = gn_silu_fwd_kernel<TEAM>;
  if (p.smem > 48 * 1024) {
    const int err = kernel_launch::opt_in<gn_silu_fwd_kernel<TEAM>>(dev, optin);
    if (err != 0) return err;
  }
  const long long groups = (long long)B * G;
  const long long blocks = (groups + p.per_block - 1) / p.per_block * p.cluster;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                   ((long long)(C / G) * HW) % 4 == 0;
  const int csize = (int)p.cluster, slice = (int)p.slice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (csize > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // whether one cluster fits the card, asked once per device, cluster size
    // and shared memory (the plan gives a few), under a lock
    static std::mutex lock;
    static long long fits[kernel_launch::kDevices][kMaxCluster + 1];  // smem checked, 0: none
    std::lock_guard<std::mutex> hold(lock);
    if (fits[dev][csize] != p.smem) {
      int clusters = 0;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
      fits[dev][csize] = p.smem;
    }
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, scale, shift,
                                             out, C, HW, G, groups, csize, slice, eps, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The forward's plan at a shape for `limit` bytes of shared memory a block:
// out[0..4] = threads a group, groups a block, blocks a group (cluster),
// floats a block stages, dynamic shared memory in bytes. Returns 0, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int gn_silu_fwd_plan(int C, int HW, int G, long long limit, long long* out) {
  if (C <= 0 || HW <= 0 || G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  GnPlan p;
  const int err = plan_fwd(C, HW, G, limit, &p);
  out[0] = p.team;
  out[1] = p.per_block;
  out[2] = p.cluster;
  out[3] = p.slice;
  out[4] = p.smem;
  return err;
}

// x, out: (B, C, H*W) fp32 contiguous; gamma, beta: (C,); scale, shift:
// (B, C) or both null for no FiLM. Runs on `stream`, allocates nothing and
// returns cudaGetLastError() of the launch (cudaErrorInvalidValue for a
// shape it does not take, cudaErrorLaunchOutOfResources where the card
// cannot hold one cluster of the plan).
extern "C" int gn_silu_fwd(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, void* out,
                           int B, int C, int HW, int G, float eps, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  if ((scale == nullptr) != (shift == nullptr)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  long long optin = 0;
  int err = kernel_launch::device_optin(&dev, &optin);
  if (err != 0) return err;
  GnPlan p;
  err = plan_fwd(C, HW, G, optin, &p);
  if (err != 0) return err;
  const float* xf = (const float*)x;
  const float* gf = (const float*)gamma;
  const float* bf = (const float*)beta;
  const float* sc = (const float*)scale;
  const float* sh = (const float*)shift;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.team) {
    case 32: return launch_fwd<32>(xf, gf, bf, sc, sh, of, B, C, HW, G, eps, p, dev, optin, st);
    case 64: return launch_fwd<64>(xf, gf, bf, sc, sh, of, B, C, HW, G, eps, p, dev, optin, st);
    case 128: return launch_fwd<128>(xf, gf, bf, sc, sh, of, B, C, HW, G, eps, p, dev, optin, st);
    default: return launch_fwd<256>(xf, gf, bf, sc, sh, of, B, C, HW, G, eps, p, dev, optin, st);
  }
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
// the forward; samples on gridDim.x (any B), groups on gridDim.y. The block
// recomputes the two-pass mean and rstd, then, per channel of the group, z = (xn * gamma + beta) (1 + scale) + shift and
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
// 32 KB on the flagship's train path and 64 KB on the faces one (the UNet's
// 64 x 64 level, 4 channels a group), so the re-reads hit L1 / L2.

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
  const int b = blockIdx.x;
  const int g = blockIdx.y;
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
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const bool film = scale != nullptr;
  if ((shift != nullptr) != film || (dscale != nullptr) != film || (dshift != nullptr) != film)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gn_silu_bwd_kernel<<<dim3(B, G), kThreads, 0, st>>>(
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
