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

// The sums over the thread's team of TEAM threads of each of the K values
// v, in a fixed order; every thread of the team gets them. Every thread of
// the block calls it together; red holds kThreads / 32 * K floats.
template <int TEAM, int K>
__device__ void team_sums(float (&v)[K], float* red) {
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = warp_sum(v[i]);
  if constexpr (TEAM > 32) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // red may still be read by the previous call
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) red[warp * K + i] = v[i];
    }
    __syncthreads();
    const int first = (threadIdx.x / TEAM) * (TEAM / 32);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < TEAM / 32; ++w) t += red[(first + w) * K + i];
      v[i] = t;
    }
  }
}

// team_sums of one value.
template <int TEAM>
__device__ float team_sum(float v, float* red) {
  float a[1] = {v};
  team_sums<TEAM, 1>(a, red);
  return a[0];
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

// The launch plan of a kernel for one shape: team threads a group, groups a
// block, blocks a group (the cluster), floats a block stages of a group (of
// each array it stages), and dynamic shared memory in bytes. 0, or
// cudaErrorInvalidValue where no cluster of kMaxCluster blocks fits a group
// in `limit` bytes a block. The forward (staged = 0) stages x beside its
// per-channel affine (2 floats a channel) and kExtraFloats; the backward
// (staged = 2) stages x and the gradient, the double backward (staged = 3)
// x, the gradient and the cotangent of dx, beside kBwdExtraFloats.
struct GnPlan {
  long long team, per_block, cluster, slice, smem;
};

constexpr int kBwdExtraFloats = kThreads + 66;  // team sums, the cluster's slots

// The backward kernels take the smallest cluster whose blocks fit two an SM
// (half the limit), and only where none does, the smallest that fits: a
// block that holds an SM alone serialises its copy, passes and stores (the
// VQ decoder's 512 KB groups: clusters of 8 blocks of 64 KB, not 4 of 128).
int plan(int C, int HW, int G, long long limit, int staged, GnPlan* p) {
  const long long cg = C / G;
  const long long n = cg * HW;
  p->team = 32;
  while (p->team < kThreads && p->team * kFloatsPerThread < n) p->team *= 2;
  p->per_block = kThreads / p->team;
  for (long long target : {staged ? limit / 2 : limit, limit}) {
    for (p->cluster = 1; p->cluster <= kMaxCluster; p->cluster *= 2) {
      p->slice = ((n + p->cluster - 1) / p->cluster + 3) / 4 * 4;
      p->smem = staged ? 4 * (p->per_block * staged * p->slice + kBwdExtraFloats)
                       : 4 * (p->per_block * (p->slice + 2 * cg) + kExtraFloats);
      if (p->smem <= target) return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Launches Kernel on the plan's blocks for `groups` groups (kThreads
// threads, p.smem bytes), on thread-block clusters of p.cluster blocks
// where that is above 1.
template <auto Kernel, class... Args>
int launch_planned(const GnPlan& p, long long groups, int dev, long long optin,
                   cudaStream_t st, Args... args) {
  if (p.smem > 48 * 1024) {
    const int err = kernel_launch::opt_in<Kernel>(dev, optin);
    if (err != 0) return err;
  }
  const long long blocks = (groups + p.per_block - 1) / p.per_block * p.cluster;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  const int csize = (int)p.cluster;
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
      const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, Kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
      fits[dev][csize] = p.smem;
    }
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int TEAM>
int launch_fwd(const float* x, const float* gamma, const float* beta,
               const float* scale, const float* shift, float* out, int B, int C,
               int HW, int G, float eps, const GnPlan& p, int dev, long long optin,
               cudaStream_t st) {
  const long long groups = (long long)B * G;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                   ((long long)(C / G) * HW) % 4 == 0;
  return launch_planned<gn_silu_fwd_kernel<TEAM>>(p, groups, dev, optin, st, x, gamma, beta,
                                                  scale, shift, out, C, HW, G, groups,
                                                  (int)p.cluster, (int)p.slice, eps, vec);
}

int plan_out(int C, int HW, int G, long long limit, int staged, long long* out) {
  if (C <= 0 || HW <= 0 || G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  GnPlan p;
  const int err = plan(C, HW, G, limit, staged, &p);
  out[0] = p.team;
  out[1] = p.per_block;
  out[2] = p.cluster;
  out[3] = p.slice;
  out[4] = p.smem;
  return err;
}

}  // namespace

// The forward's (gn_silu_fwd_plan), the backward's (gn_silu_bwd_plan) or the
// double backward's (gn_silu_bwd_bwd_plan) plan at a shape for `limit` bytes of shared memory a block: out[0..4] =
// threads a group, groups a block, blocks a group (cluster), floats a block
// stages (of each array), dynamic shared memory in bytes. Returns 0, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int gn_silu_fwd_plan(int C, int HW, int G, long long limit, long long* out) {
  return plan_out(C, HW, G, limit, 0, out);
}

extern "C" int gn_silu_bwd_plan(int C, int HW, int G, long long limit, long long* out) {
  return plan_out(C, HW, G, limit, 2, out);
}

extern "C" int gn_silu_bwd_bwd_plan(int C, int HW, int G, long long limit, long long* out) {
  return plan_out(C, HW, G, limit, 3, out);
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
  err = plan(C, HW, G, optin, 0, &p);
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
// does not spend about fifteen elementwise launches per GN-SiLU site, and a
// second small one for dgamma and dbeta.
//
// Per (sample, group), with the forward's two-pass statistics: xn = (x -
// mean) rstd, y = xn gamma + beta, z = y (1 + scale) + shift (or y), dz = g
// sigma(z) (1 + z (1 - sigma(z))), dy = dz (1 + scale); per channel
//   dshift[b, c] = sum dz,  dscale[b, c] = sum dz y,
//   dbeta_part[b, c] = sum dy,  dgamma_part[b, c] = sum dy xn;
// and dx = rstd (dxn - mean(dxn) - xn mean(dxn xn)), dxn = dy gamma, whose
// two group means follow from the channel sums: sum dxn = sum_c gamma_c
// (sum dy)_c and sum dxn xn = sum_c gamma_c (sum dy xn)_c.
//
// Bound on the H100: bytes. x and g are read and dx written once (12 bytes
// an element) for about thirty fp32 operations and one exponential. The
// design reads each once:
// - The forward's plan with two staged arrays (gn_silu_bwd_plan; its copy
//   gn_silu_bwd_plan() in nn/kernels/groupnorm_silu.py): a team of 32 to 256
//   threads (at most 16 floats of a group a thread) takes a group, small
//   groups share a block of 256 threads (8 groups a block at the
//   flagship's 2x2 to 16x16 levels), and x and g of a group are staged
//   once in dynamic shared memory by cp.async. Where x + g exceed half the
//   227 KB a block may hold, the group splits over a thread-block cluster
//   of 2, 4 or 8 blocks, the fewest whose blocks fit two an SM (only where
//   none do, the fewest that fit at all), so that one block's copy overlaps
//   another's passes: the VQ decoder's 256x256 level (65,536 floats a
//   group, 512 KB of x + g) runs clusters of 8 blocks of 64 KB, three an
//   SM, not 4 of 128 KB, one an SM (PERF.md gives both times).
// - Everything after the copy reads shared memory: the mean, the variance,
//   then one pass that forms dz and dy, adds the channel sums and leaves
//   dxn = dy gamma in g's place, then one pass that writes dx. A thread
//   takes the same elements in every pass (element i of a group belongs to
//   thread i mod team, in 16-byte chunks where rows allow), so no barrier
//   sits between the last two.
// - The channel sums: every configured shape has at most 8 channels a
//   group (C / G = 2, 4 or 8 in the UNet, 1 to 4 in the VQ), so a thread
//   carries its partial sums of 8 channels (4 sums each with FiLM, 2
//   without) in registers, in channel loops unrolled 8 deep, and the team
//   adds all of them at once: warp shuffles, then one barrier pair over the
//   team's warps. Groups of more channels take 8 at a time. A cluster adds
//   its blocks' sums through distributed shared memory in rank order, every
//   block alike.
// - Every sum runs in a fixed order with no atomics, and dgamma and dbeta
//   add their (B, C) per-sample parts over the batch in a fixed order
//   (gn_param_grad_kernel): a run repeats bit for bit.
// What stays exposed is what the forward shows: one block's copy, then its
// passes, in series, where a group is large (one 128 KB block an SM).

namespace {

// The sums over the cluster's blocks of each block's K values v (one group
// a block), added in rank order through the blocks' `slots` (2 K floats of
// shared memory each); every thread gets them. Where cluster_sum has every
// thread read each block's one value, here K threads read and share: the
// last cluster.sync() keeps the slots from being written again, or the
// block from exiting, while another block reads them.
template <int K>
__device__ void cluster_sums(float (&v)[K], float* slots, int csize) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) slots[i] = v[i];
  }
  cluster.sync();
  if (threadIdx.x < K) {
    float t = 0.f;
    for (int r = 0; r < csize; ++r) t += cluster.map_shared_rank(slots, r)[threadIdx.x];
    slots[K + threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = slots[K + i];
  cluster.sync();
}

__device__ __forceinline__ float silu_grad(float z, float g) {
  const float sig = __fdividef(1.f, 1.f + __expf(-z));
  return g * sig * (1.f + z * (1.f - sig));
}

// One (sample, group), or a slice of it, per team: see the note above.
// groups = B * G; slice: floats of a group per block; vec: 16-byte chunks
// (H * W a multiple of 4, x, g and dx on 16 bytes).
template <int TEAM, bool FILM>
__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ scale,
                   const float* __restrict__ shift, const float* __restrict__ gout,
                   float* __restrict__ dx, float* __restrict__ dscale,
                   float* __restrict__ dshift, float* __restrict__ dgamma_part,
                   float* __restrict__ dbeta_part, int C, int HW, int G,
                   long long groups, int csize, int slice, float eps, bool vec) {
  constexpr int GPB = kThreads / TEAM;  // groups per block
  constexpr int K = FILM ? 4 : 2;       // sums a channel: [dz, dz y,] dy, dy xn
  constexpr int CH = 8;                 // channels a register pass
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
  float* gs = smem + (GPB + team) * slice;  // g, then dxn
  float* red = smem + 2 * GPB * slice;      // kThreads floats
  float* slots = red + kThreads;            // mean, variance, then 2 CH K
  const float* xg = x + gi * n + start;
  const float* gg = gout + gi * n + start;
  float* dxg = dx + gi * n + start;

  // element i of the slice belongs to thread i mod TEAM (chunk i / 4 to
  // thread (i / 4) mod TEAM where vec), in every pass
  const int w = vec ? 4 : 1;
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      cp_async16(xs + 4 * i, xg + 4 * i, true);
      cp_async16(gs + 4 * i, gg + 4 * i, true);
    }
  } else {
    for (int i = tid; i < len; i += TEAM) {
      cp_async4(xs + i, xg + i, true);
      cp_async4(gs + i, gg + i, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  // each thread reads back only what it copied until the sums below
  // (whose barriers order the rest)

  float s = 0.f;
  for (int i = w * tid; i < len; i += w * TEAM)
    for (int j = 0; j < w; ++j) s += xs[i + j];
  s = team_sum<TEAM>(s, red);
  if (csize > 1) s = cluster_sum(s, slots, csize);
  const float mean = s / (float)n;
  float q = 0.f;
  for (int i = w * tid; i < len; i += w * TEAM)
    for (int j = 0; j < w; ++j) {
      const float d = xs[i + j] - mean;
      q += d * d;
    }
  q = team_sum<TEAM>(q, red);
  if (csize > 1) q = cluster_sum(q, slots + 1, csize);
  const float rstd = rsqrtf(q / (float)n + eps);

  const long long b = live ? gi / G : 0;
  const int c0 = live ? (int)(gi % G) * cg : 0;
  float m1 = 0.f, m2 = 0.f;  // sum_c gamma_c (sum dy)_c, sum_c gamma_c (sum dy xn)_c
  for (int cb = 0; cb < cg; cb += CH) {
    float cs[CH * K];
#pragma unroll
    for (int i = 0; i < CH * K; ++i) cs[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int ci = cb + cc;
      if (ci < cg) {
        // the channel's elements in the slice: [lo, hi)
        const long long from = (long long)ci * HW - start;
        const int lo = from > 0 ? (int)from : 0;
        const int hi = from + HW < len ? (int)(from + HW) : len;
        const int c = c0 + ci;
        const float ga = gamma[c], be = beta[c];
        const float sc1 = FILM ? 1.f + scale[b * C + c] : 1.f;
        const float sh = FILM ? shift[b * C + c] : 0.f;
        // the thread's first element of the channel: i = tid mod TEAM
        const int lo_w = lo / w;
        for (int i = w * (lo_w + ((tid - lo_w) & (TEAM - 1))); i < hi; i += w * TEAM) {
#pragma unroll 4
          for (int j = 0; j < w; ++j) {
            const float xn = (xs[i + j] - mean) * rstd;
            const float y = fmaf(xn, ga, be);
            const float dz = silu_grad(FILM ? fmaf(y, sc1, sh) : y, gs[i + j]);
            const float dy = FILM ? dz * sc1 : dz;
            if constexpr (FILM) {
              cs[cc * K] += dz;
              cs[cc * K + 1] += dz * y;
            }
            cs[cc * K + K - 2] += dy;
            cs[cc * K + K - 1] += dy * xn;
            gs[i + j] = dy * ga;
          }
        }
      }
    }
    team_sums<TEAM, CH * K>(cs, red);
    if (csize > 1) cluster_sums<CH * K>(cs, slots + 2, csize);
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int ci = cb + cc;
      if (ci < cg) {
        const int c = c0 + ci;
        const float ga = gamma[c];
        m1 += ga * cs[cc * K + K - 2];
        m2 += ga * cs[cc * K + K - 1];
        if (live && rank == 0 && tid == 0) {
          const long long bc = b * C + c;
          if constexpr (FILM) {
            dshift[bc] = cs[cc * K];
            dscale[bc] = cs[cc * K + 1];
          }
          dbeta_part[bc] = cs[cc * K + K - 2];
          dgamma_part[bc] = cs[cc * K + K - 1];
        }
      }
    }
  }
  m1 /= (float)n;
  m2 /= (float)n;

  // dx, from the thread's own elements
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      const float4 xv = reinterpret_cast<const float4*>(xs)[i];
      const float4 dv = reinterpret_cast<const float4*>(gs)[i];
      reinterpret_cast<float4*>(dxg)[i] =
          make_float4(rstd * (dv.x - m1 - (xv.x - mean) * rstd * m2),
                      rstd * (dv.y - m1 - (xv.y - mean) * rstd * m2),
                      rstd * (dv.z - m1 - (xv.z - mean) * rstd * m2),
                      rstd * (dv.w - m1 - (xv.w - mean) * rstd * m2));
    }
  } else {
    for (int i = tid; i < len; i += TEAM)
      dxg[i] = rstd * (gs[i] - m1 - (xs[i] - mean) * rstd * m2);
  }
}

// dgamma[c] = sum_b dgamma_part[b, c], dbeta likewise, in a fixed order: a
// block takes 32 channels (threadIdx.x, consecutive addresses) and its 8
// rows of threads (threadIdx.y) the samples b = y, y + 8, ... in order; the
// 8 partial sums are then added in row order.
constexpr int kParamRows = 8;

__global__ void __launch_bounds__(32 * kParamRows)
gn_param_grad_kernel(const float* __restrict__ dgamma_part,
                     const float* __restrict__ dbeta_part, float* __restrict__ dgamma,
                     float* __restrict__ dbeta, int B, int C) {
  __shared__ float red[2][kParamRows][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sg = 0.f, sb = 0.f;
  if (c < C) {
#pragma unroll 8  // the loads of eight samples in flight; the adds in order
    for (int b = threadIdx.y; b < B; b += kParamRows) {
      sg += dgamma_part[(long long)b * C + c];
      sb += dbeta_part[(long long)b * C + c];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = sg;
  red[1][threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  sg = sb = 0.f;
#pragma unroll
  for (int r = 0; r < kParamRows; ++r) {
    sg += red[0][r][threadIdx.x];
    sb += red[1][r][threadIdx.x];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

template <int TEAM, bool FILM>
int launch_bwd(const float* x, const float* gamma, const float* beta, const float* scale,
               const float* shift, const float* gout, float* dx, float* dscale,
               float* dshift, float* dgamma_part, float* dbeta_part, int B, int C, int HW,
               int G, float eps, const GnPlan& p, int dev, long long optin,
               cudaStream_t st) {
  const long long groups = (long long)B * G;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gout) |
                     reinterpret_cast<uintptr_t>(dx)) & 15) == 0 && HW % 4 == 0;
  return launch_planned<gn_silu_bwd_kernel<TEAM, FILM>>(
      p, groups, dev, optin, st, x, gamma, beta, scale, shift, gout, dx, dscale, dshift,
      dgamma_part, dbeta_part, C, HW, G, groups, (int)p.cluster, (int)p.slice, eps, vec);
}

template <bool FILM>
int launch_bwd_team(const float* x, const float* gamma, const float* beta,
                    const float* scale, const float* shift, const float* gout, float* dx,
                    float* dscale, float* dshift, float* dgamma_part, float* dbeta_part,
                    int B, int C, int HW, int G, float eps, const GnPlan& p, int dev,
                    long long optin, cudaStream_t st) {
  switch (p.team) {
    case 32:
      return launch_bwd<32, FILM>(x, gamma, beta, scale, shift, gout, dx, dscale, dshift,
                                  dgamma_part, dbeta_part, B, C, HW, G, eps, p, dev, optin, st);
    case 64:
      return launch_bwd<64, FILM>(x, gamma, beta, scale, shift, gout, dx, dscale, dshift,
                                  dgamma_part, dbeta_part, B, C, HW, G, eps, p, dev, optin, st);
    case 128:
      return launch_bwd<128, FILM>(x, gamma, beta, scale, shift, gout, dx, dscale, dshift,
                                   dgamma_part, dbeta_part, B, C, HW, G, eps, p, dev, optin, st);
    default:
      return launch_bwd<256, FILM>(x, gamma, beta, scale, shift, gout, dx, dscale, dshift,
                                   dgamma_part, dbeta_part, B, C, HW, G, eps, p, dev, optin, st);
  }
}

}  // namespace

// x, gout, dx: (B, C, H*W) fp32 contiguous; gamma, beta, dgamma, dbeta:
// (C,); scale, shift, dscale, dshift: (B, C), all four null for no FiLM;
// dgamma_part, dbeta_part: (B, C) scratch the caller allocates. Runs two
// kernels on `stream`, allocates nothing and returns the first launch error
// (cudaErrorInvalidValue for a shape it does not take,
// cudaErrorLaunchOutOfResources where the card cannot hold one cluster of
// the plan).
extern "C" int gn_silu_bwd(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, const void* gout,
                           void* dx, void* dgamma, void* dbeta, void* dscale,
                           void* dshift, void* dgamma_part, void* dbeta_part,
                           int B, int C, int HW, int G, float eps, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  const bool film = scale != nullptr;
  if ((shift != nullptr) != film || (dscale != nullptr) != film || (dshift != nullptr) != film)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  long long optin = 0;
  int err = kernel_launch::device_optin(&dev, &optin);
  if (err != 0) return err;
  GnPlan p;
  err = plan(C, HW, G, optin, 2, &p);
  if (err != 0) return err;
  const float* xf = (const float*)x;
  const float* gf = (const float*)gamma;
  const float* bf = (const float*)beta;
  const float* sc = (const float*)scale;
  const float* sh = (const float*)shift;
  const float* go = (const float*)gout;
  float* dxf = (float*)dx;
  float* dsc = (float*)dscale;
  float* dsh = (float*)dshift;
  float* dgp = (float*)dgamma_part;
  float* dbp = (float*)dbeta_part;
  cudaStream_t st = (cudaStream_t)stream;
  err = film ? launch_bwd_team<true>(xf, gf, bf, sc, sh, go, dxf, dsc, dsh, dgp, dbp, B, C,
                                     HW, G, eps, p, dev, optin, st)
             : launch_bwd_team<false>(xf, gf, bf, sc, sh, go, dxf, dsc, dsh, dgp, dbp, B, C,
                                      HW, G, eps, p, dev, optin, st);
  if (err != 0) return err;
  gn_param_grad_kernel<<<(C + 31) / 32, dim3(32, kParamRows), 0, st>>>(
      dgp, dbp, (float*)dgamma, (float*)dbeta, B, C);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Double backward, fp32, NCHW, without FiLM: the gradients of the backward's
// (dx, dgamma, dbeta) with respect to its inputs (g, x, gamma, beta), for the
// cotangents u of dx and, where given, gb of dgamma and bb of dbeta.
//
// Replaces no TPU kernel: the JAX package differentiates its GN-SiLU VJP
// (encdiff_tpu/nn/pallas/groupnorm_silu.py:113) a second time through XLA's
// autodiff, which the MCL losses ask for (a gradient of the frozen decoder
// with respect to z, itself trained through). Here the backward that autograd
// records under create_graph is one Function whose own backward is this
// kernel, so that the second-order pass through the decoder's 23 GN-SiLU
// sites costs one launch (and one small one for gamma and beta) each.
//
// Per (sample, group), with the forward's two-pass statistics mean and r =
// rstd, xn = (x - mean) r, a = xn gamma + beta, s1 = silu'(a) = sig (1 + a
// (1 - sig)), s2 = silu''(a) = sig (1 - sig) (2 + a (1 - 2 sig)), the
// backward is dy = g s1, dxn = gamma dy, dx = r (dxn - M1 - xn M2) with M1 =
// mean(dxn), M2 = mean(dxn xn), dgamma = sum dy xn, dbeta = sum dy. With
// ubar = mean(u), A = mean(u xn) and ut = r (u - ubar - xn A), its scalar
// <u, dx> + <gb, dgamma> + <bb, dbeta> is sum dxn ut + sum dy (gb xn + bb),
// and with h = gamma ut + gb xn + bb and e = g s2 h:
//   dg = s1 h;
//   dbeta' = sum_channel e,  dgamma' = sum_channel (e xn + dy ut);
//   dx' = r (Gx - mean(Gx) - xn (mean(Gx xn) + r T)), where
//   Gx = gamma e - r (u M2 + A dxn) + gb dy is the gradient with respect to
//   xn at fixed r, and T = mean(dxn u) - ubar M1 - A M2 = <u, dx> / (n r) that
//   with respect to r (dr/dx = -r^2 xn / n).
// So a group needs, after the statistics, five sums in one pass (u, u xn,
// dxn, dxn xn, dxn u), then a pass that writes dg's values and Gx over g and
// u in shared memory and adds Gx and Gx xn (and the channel sums), then the
// pass that writes dx' and dg.
//
// Bound on the H100: bytes. x, g and u are read and dg and dx' written once
// (20 bytes an element) for about sixty fp32 operations and one
// exponential. The design is the backward's: the same plan with three staged
// arrays (gn_silu_bwd_bwd_plan; its copy gn_silu_bwd_bwd_plan() in
// nn/kernels/groupnorm_silu.py), each array read from device memory once by
// cp.async, every pass after it on shared memory, each thread on the same
// elements in every pass, clusters of 2, 4 or 8 blocks where a group's three
// slices do not fit half of 227 KB (the VQ decoder's 64x64 level, 8,192
// floats a group: one block of 97 KB, two an SM; its faces counterpart at
// 256x256 on clusters of 8), the channel sums in registers 8 channels at a
// time and the batch sum of dgamma' and dbeta' in gn_param_grad_kernel, all
// in a fixed order: a run repeats bit for bit.

namespace {

// The thread's elements of channel ci in its block's slice [start, start +
// len) of a group: from `first` (element i = tid mod TEAM, in chunks of w)
// up to `hi`.
template <int TEAM>
__device__ __forceinline__ void channel_range(int ci, int HW, long long start, int len,
                                              int w, int tid, int* first, int* hi) {
  const long long from = (long long)ci * HW - start;
  const int lo = from > 0 ? (int)from : 0;
  *hi = from + HW < len ? (int)(from + HW) : len;
  const int lo_w = lo / w;
  *first = w * (lo_w + ((tid - lo_w) & (TEAM - 1)));
}

template <int TEAM, bool PARAMS>
__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ gout,
                       const float* __restrict__ du, const float* __restrict__ dgamma_bar,
                       const float* __restrict__ dbeta_bar, float* __restrict__ dg,
                       float* __restrict__ dx, float* __restrict__ dgamma_part,
                       float* __restrict__ dbeta_part, int C, int HW, int G,
                       long long groups, int csize, int slice, float eps, bool vec) {
  constexpr int GPB = kThreads / TEAM;  // groups per block
  constexpr int CH = 8;                 // channels a register pass
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
  float* gs = smem + (GPB + team) * slice;      // g, then dg
  float* us = smem + (2 * GPB + team) * slice;  // u, then Gx
  float* red = smem + 3 * GPB * slice;          // kThreads floats
  float* slots = red + kThreads;                // mean, variance, then 2 CH 2
  const long long off = gi * n + start;

  // element i of the slice belongs to thread i mod TEAM (chunk i / 4 to
  // thread (i / 4) mod TEAM where vec), in every pass
  const int w = vec ? 4 : 1;
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      cp_async16(xs + 4 * i, x + off + 4 * i, true);
      cp_async16(gs + 4 * i, gout + off + 4 * i, true);
      cp_async16(us + 4 * i, du + off + 4 * i, true);
    }
  } else {
    for (int i = tid; i < len; i += TEAM) {
      cp_async4(xs + i, x + off + i, true);
      cp_async4(gs + i, gout + off + i, true);
      cp_async4(us + i, du + off + i, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();

  float s = 0.f;
  for (int i = w * tid; i < len; i += w * TEAM)
    for (int j = 0; j < w; ++j) s += xs[i + j];
  s = team_sum<TEAM>(s, red);
  if (csize > 1) s = cluster_sum(s, slots, csize);
  const float mean = s / (float)n;
  float q = 0.f;
  for (int i = w * tid; i < len; i += w * TEAM)
    for (int j = 0; j < w; ++j) {
      const float d = xs[i + j] - mean;
      q += d * d;
    }
  q = team_sum<TEAM>(q, red);
  if (csize > 1) q = cluster_sum(q, slots + 1, csize);
  const float rstd = rsqrtf(q / (float)n + eps);

  const int c0 = live ? (int)(gi % G) * cg : 0;
  const long long b = live ? gi / G : 0;

  // pass 2: sum u, u xn, dxn, dxn xn, dxn u
  float m[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ci = 0; ci < cg; ++ci) {
    int first, hi;
    channel_range<TEAM>(ci, HW, start, len, w, tid, &first, &hi);
    const float ga = gamma[c0 + ci], be = beta[c0 + ci];
    for (int i = first; i < hi; i += w * TEAM) {
#pragma unroll 4
      for (int j = 0; j < w; ++j) {
        const float xn = (xs[i + j] - mean) * rstd;
        const float a = fmaf(xn, ga, be);
        const float sig = __fdividef(1.f, 1.f + __expf(-a));
        const float dxn = ga * gs[i + j] * sig * (1.f + a * (1.f - sig));
        const float u = us[i + j];
        m[0] += u;
        m[1] += u * xn;
        m[2] += dxn;
        m[3] += dxn * xn;
        m[4] += dxn * u;
      }
    }
  }
  team_sums<TEAM, 5>(m, red);
  if (csize > 1) cluster_sums<5>(m, slots + 2, csize);
  const float inv_n = 1.f / (float)n;
  const float ubar = m[0] * inv_n, A = m[1] * inv_n;
  const float M1 = m[2] * inv_n, M2 = m[3] * inv_n;
  const float T = m[4] * inv_n - ubar * M1 - A * M2;

  // pass 3: dg over g, Gx over u; the sums of Gx and Gx xn, and per channel
  // of e and e xn + dy ut
  float sg = 0.f, sgx = 0.f;
  for (int cb = 0; cb < cg; cb += CH) {
    float cs[2 * CH];
#pragma unroll
    for (int i = 0; i < 2 * CH; ++i) cs[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int ci = cb + cc;
      if (ci < cg) {
        int first, hi;
        channel_range<TEAM>(ci, HW, start, len, w, tid, &first, &hi);
        const int c = c0 + ci;
        const float ga = gamma[c], be = beta[c];
        const float gb = dgamma_bar != nullptr ? dgamma_bar[c] : 0.f;
        const float bb = dbeta_bar != nullptr ? dbeta_bar[c] : 0.f;
        for (int i = first; i < hi; i += w * TEAM) {
#pragma unroll 4
          for (int j = 0; j < w; ++j) {
            const float xn = (xs[i + j] - mean) * rstd;
            const float a = fmaf(xn, ga, be);
            const float sig = __fdividef(1.f, 1.f + __expf(-a));
            const float s1 = sig * (1.f + a * (1.f - sig));
            const float s2 = sig * (1.f - sig) * (2.f + a * (1.f - 2.f * sig));
            const float gv = gs[i + j], u = us[i + j];
            const float dy = gv * s1;
            const float ut = rstd * (u - ubar - xn * A);
            const float h = fmaf(ga, ut, fmaf(gb, xn, bb));
            const float e = gv * s2 * h;
            const float gx = ga * e - rstd * (u * M2 + A * ga * dy) + gb * dy;
            gs[i + j] = s1 * h;
            us[i + j] = gx;
            sg += gx;
            sgx += gx * xn;
            if constexpr (PARAMS) {
              cs[2 * cc] += e;
              cs[2 * cc + 1] += fmaf(e, xn, dy * ut);
            }
          }
        }
      }
    }
    if constexpr (PARAMS) {
      team_sums<TEAM, 2 * CH>(cs, red);
      if (csize > 1) cluster_sums<2 * CH>(cs, slots + 2, csize);
#pragma unroll
      for (int cc = 0; cc < CH; ++cc) {
        const int ci = cb + cc;
        if (ci < cg && live && rank == 0 && tid == 0) {
          const long long bc = b * C + c0 + ci;
          dbeta_part[bc] = cs[2 * cc];
          dgamma_part[bc] = cs[2 * cc + 1];
        }
      }
    }
  }
  float gsum[2] = {sg, sgx};
  team_sums<TEAM, 2>(gsum, red);
  if (csize > 1) cluster_sums<2>(gsum, slots + 2, csize);
  const float mg = gsum[0] * inv_n;
  const float mgx = fmaf(rstd, T, gsum[1] * inv_n);

  // pass 4: dx' and dg, from the thread's own elements
  if (vec) {
    for (int i = tid; i < len / 4; i += TEAM) {
      const float4 xv = reinterpret_cast<const float4*>(xs)[i];
      const float4 gx = reinterpret_cast<const float4*>(us)[i];
      reinterpret_cast<float4*>(dx + off)[i] =
          make_float4(rstd * (gx.x - mg - (xv.x - mean) * rstd * mgx),
                      rstd * (gx.y - mg - (xv.y - mean) * rstd * mgx),
                      rstd * (gx.z - mg - (xv.z - mean) * rstd * mgx),
                      rstd * (gx.w - mg - (xv.w - mean) * rstd * mgx));
      reinterpret_cast<float4*>(dg + off)[i] = reinterpret_cast<const float4*>(gs)[i];
    }
  } else {
    for (int i = tid; i < len; i += TEAM) {
      dx[off + i] = rstd * (us[i] - mg - (xs[i] - mean) * rstd * mgx);
      dg[off + i] = gs[i];
    }
  }
}

template <int TEAM, bool PARAMS>
int launch_bwd_bwd(const float* x, const float* gamma, const float* beta, const float* gout,
                   const float* du, const float* dgamma_bar, const float* dbeta_bar,
                   float* dg, float* dx, float* dgamma_part, float* dbeta_part, int B,
                   int C, int HW, int G, float eps, const GnPlan& p, int dev,
                   long long optin, cudaStream_t st) {
  const long long groups = (long long)B * G;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gout) |
                     reinterpret_cast<uintptr_t>(du) | reinterpret_cast<uintptr_t>(dg) |
                     reinterpret_cast<uintptr_t>(dx)) & 15) == 0 && HW % 4 == 0;
  return launch_planned<gn_silu_bwd_bwd_kernel<TEAM, PARAMS>>(
      p, groups, dev, optin, st, x, gamma, beta, gout, du, dgamma_bar, dbeta_bar, dg, dx,
      dgamma_part, dbeta_part, C, HW, G, groups, (int)p.cluster, (int)p.slice, eps, vec);
}

template <bool PARAMS>
int launch_bwd_bwd_team(const float* x, const float* gamma, const float* beta,
                        const float* gout, const float* du, const float* dgamma_bar,
                        const float* dbeta_bar, float* dg, float* dx, float* dgamma_part,
                        float* dbeta_part, int B, int C, int HW, int G, float eps,
                        const GnPlan& p, int dev, long long optin, cudaStream_t st) {
  switch (p.team) {
    case 32:
      return launch_bwd_bwd<32, PARAMS>(x, gamma, beta, gout, du, dgamma_bar, dbeta_bar, dg,
                                        dx, dgamma_part, dbeta_part, B, C, HW, G, eps, p,
                                        dev, optin, st);
    case 64:
      return launch_bwd_bwd<64, PARAMS>(x, gamma, beta, gout, du, dgamma_bar, dbeta_bar, dg,
                                        dx, dgamma_part, dbeta_part, B, C, HW, G, eps, p,
                                        dev, optin, st);
    case 128:
      return launch_bwd_bwd<128, PARAMS>(x, gamma, beta, gout, du, dgamma_bar, dbeta_bar, dg,
                                         dx, dgamma_part, dbeta_part, B, C, HW, G, eps, p,
                                         dev, optin, st);
    default:
      return launch_bwd_bwd<256, PARAMS>(x, gamma, beta, gout, du, dgamma_bar, dbeta_bar, dg,
                                         dx, dgamma_part, dbeta_part, B, C, HW, G, eps, p,
                                         dev, optin, st);
  }
}

}  // namespace

// x, gout (the backward's g), du (the cotangent of dx), dg, dx: (B, C, H*W)
// fp32 contiguous; gamma, beta: (C,); dgamma_bar, dbeta_bar (the cotangents
// of dgamma and dbeta): (C,) or null for zero; dgamma, dbeta: (C,) outputs,
// both null when not wanted, and then dgamma_part, dbeta_part ((B, C)
// scratch the caller allocates) may be null too. Runs one kernel, and a
// second for dgamma and dbeta, on `stream`; allocates nothing and returns
// the first launch error (cudaErrorInvalidValue for a shape it does not
// take, cudaErrorLaunchOutOfResources where the card cannot hold one
// cluster of the plan).
extern "C" int gn_silu_bwd_bwd(const void* x, const void* gamma, const void* beta,
                               const void* gout, const void* du, const void* dgamma_bar,
                               const void* dbeta_bar, void* dg, void* dx, void* dgamma,
                               void* dbeta, void* dgamma_part, void* dbeta_part, int B,
                               int C, int HW, int G, float eps, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  const bool params = dgamma != nullptr;
  if ((dbeta != nullptr) != params ||
      (params && (dgamma_part == nullptr || dbeta_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  long long optin = 0;
  int err = kernel_launch::device_optin(&dev, &optin);
  if (err != 0) return err;
  GnPlan p;
  err = plan(C, HW, G, optin, 3, &p);
  if (err != 0) return err;
  const float* xf = (const float*)x;
  const float* gf = (const float*)gamma;
  const float* bf = (const float*)beta;
  const float* go = (const float*)gout;
  const float* uf = (const float*)du;
  const float* gb = (const float*)dgamma_bar;
  const float* bb = (const float*)dbeta_bar;
  float* dgf = (float*)dg;
  float* dxf = (float*)dx;
  float* dgp = (float*)dgamma_part;
  float* dbp = (float*)dbeta_part;
  cudaStream_t st = (cudaStream_t)stream;
  err = params ? launch_bwd_bwd_team<true>(xf, gf, bf, go, uf, gb, bb, dgf, dxf, dgp, dbp, B,
                                           C, HW, G, eps, p, dev, optin, st)
               : launch_bwd_bwd_team<false>(xf, gf, bf, go, uf, gb, bb, dgf, dxf, dgp, dbp, B,
                                            C, HW, G, eps, p, dev, optin, st);
  if (err != 0 || !params) return err;
  gn_param_grad_kernel<<<(C + 31) / 32, dim3(32, kParamRows), 0, st>>>(
      dgp, dbp, (float*)dgamma, (float*)dbeta, B, C);
  return (int)cudaGetLastError();
}
