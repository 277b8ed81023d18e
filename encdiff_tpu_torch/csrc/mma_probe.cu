// The rate of mma.sync.m16n8k8 with tf32 inputs and fp32 accumulators on
// this card: the instruction every 3xTF32 kernel of the port is built on
// (tf32_mma.cuh). Not a kernel of any path; chip_smoke.py's mma-rate phase
// runs it to set what "bound" means for those kernels.
//
// Each warp runs `chains` independent accumulator chains of `iters` mma
// each on register operands (no memory traffic in the loop), so that with
// enough chains and warps the tensor pipe of each SM sub-partition is the
// limit. A block records the SM clocks (clock64) between two barriers
// around the loop; the caller divides by the mma a sub-partition issued.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

template <int CHAINS>
__global__ void tf32_mma_probe_kernel(int iters, long long* __restrict__ cycles,
                                      float* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.f + 1e-3f * (lane + i));
  const uint32_t b0 = __float_as_uint(0.5f + 1e-3f * lane);
  const uint32_t b1 = __float_as_uint(-0.25f);
  float acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) tf32::mma_tf32(acc[c], a, b0, b1);
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  sink[(long long)blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the chains live
}

template <int CHAINS>
int launch(int blocks, int threads, int iters, long long* cycles, float* sink,
           cudaStream_t st) {
  tf32_mma_probe_kernel<CHAINS><<<blocks, threads, 0, st>>>(iters, cycles, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks x threads (a multiple of 32, at most 1024) threads, each warp
// `chains` (1, 2, 4 or 8) chains of `iters` mma; cycles: (blocks,) int64,
// sink: (blocks * threads,) fp32, both on the device. Returns the launch's
// error (cudaErrorInvalidValue for arguments it does not take).
extern "C" int tf32_mma_probe(int blocks, int threads, int chains, int iters,
                              void* cycles, void* sink, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || threads % 32 || iters <= 0)
    return (int)cudaErrorInvalidValue;
  long long* c = (long long*)cycles;
  float* s = (float*)sink;
  cudaStream_t st = (cudaStream_t)stream;
  switch (chains) {
    case 1: return launch<1>(blocks, threads, iters, c, s, st);
    case 2: return launch<2>(blocks, threads, iters, c, s, st);
    case 4: return launch<4>(blocks, threads, iters, c, s, st);
    case 8: return launch<8>(blocks, threads, iters, c, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
