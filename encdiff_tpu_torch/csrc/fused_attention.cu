// Fused multi-head attention with its projections, forward only, fp32:
//
//   q = x wq,  k = ctx wk,  v = ctx wv                      (per batch row)
//   o_h = softmax(q_h k_h^T * scale) v_h                    (per head h)
//   y = concat_h(o_h) wo + bo
//
// Replaces the TPU kernel encdiff_tpu/nn/pallas/attention.py, fused_attention
// (_attn_kernel): the whole CrossAttention forward of a SpatialTransformer.
// The port runs it at every cross-attention site of the serving paths, where
// each query attends to the 20 concept tokens (M = 20, context width 16).
//
// Shapes: x (B, N, C), ctx (B, M, D), wq (C, HD), wk and wv (D, HD),
// wo (HD, COUT), bo (COUT), y (B, N, COUT), HD = H * DH <= 256 and DH one of
// 8, 16, 32 (the UNet's head sizes; others are refused). x, ctx and y
// are addressed through their batch and row strides with the last dimension
// contiguous; each weight through its own two strides, so the callers'
// nn.Linear weights (out, in) are read in place as (in, out) views.
//
// What is not carried over from the TPU: the TPU kernel holds one batch
// row's x and ctx and all four weight matrices in VMEM. A Hopper block has at
// most 227 KB of shared memory, and at C = 256 wq alone is 256 KB. Here:
// - one block of 256 threads (8 warps) per (batch row, tile of 64 query
//   rows); the batch row is gridDim.x, so any B up to 2^31 - 1 is taken, and
//   the row tiles are gridDim.y;
// - the block projects k and v of its batch row into shared memory
//   (M x HD each, 40 KB at M = 20, HD = 256) and keeps them there; the
//   launch is refused where they do not fit (the wrapper raises first);
// - the three products with weights (ctx wk / ctx wv, x wq, o wo) are one
//   block-level routine: the weights stream through shared memory in tiles
//   of 16 rows, the next tile's loads in flight in registers while the
//   current one is used; each warp owns 8 of the 64 rows and each lane CPT
//   columns 32 apart (CPT = 1, 2, 4 or 8, by HD), with the sums in
//   registers; the left operand (x, ctx, o) sits in shared memory and is
//   read 4 values at a time as a warp-wide broadcast;
// - attention: one thread per (head, query row) keeps q and its output sum
//   in registers (DH of each, a template parameter) and takes the softmax in
//   its online form (fp32, a running maximum subtracted), reading k and v
//   rows as broadcasts. o overwrites q.
// Nothing but x, ctx, the weights and y crosses device memory.
//
// Bound on the H100: operations. 2 B N C HD + 4 B M D HD + 4 B N M HD +
// 2 B N HD COUT fp32 FLOPs on the CUDA cores (67 TFLOP/s) against bytes of
// 4 (B N C + B M D + B N COUT) plus the weights at 3.35 TB/s: at the faces
// 64x64 level (B 32, N 4096, C = HD = 64) 2.8 GFLOP, about 42 us, against
// 67 MB, about 20 us. The design keeps every intermediate on chip, so the
// bytes are the least they can be; it reaches the operations only as far as
// shared-memory reads allow (per 4 k: 8 float4 broadcasts and 4 CPT column
// loads for 32 CPT multiply-adds), and every block repeats the k and v
// projections. Tensor cores (a later change, and then not in fp32) would
// lift the bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 16;  // weight rows per shared tile
constexpr int kStages = 3;  // weight tiles in shared memory: 2 in flight
constexpr int kMaxHD = 256;

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// Query rows a thread sums per column (a block takes 8 times as many): 8,
// or 4 where a lane holds 8 columns, so that the sums stay in registers.
__host__ __device__ constexpr int rows_per_thread(int cpt) {
  return cpt == 8 ? 4 : 8;
}

// A 2-d operand in device memory: element (i, j) at p[i * si + j * sj].
struct Mat {
  const float* p;
  long long si, sj;
};

// Where each buffer lies in a block's shared memory (offsets in floats, each
// a multiple of 4 so that float4 reads are aligned) and its row strides.
struct Layout {
  long long ldx, ldc, ldq, ldk;
  long long ks, vs, qs, xs, cs, wbuf, total;
};

// k and v (M rows of ldk), q / o (R x ldq), the x tile (R x ldx), ctx
// (M x ldc) and the weight tiles (R = 8 rows_per_thread(cpt) query rows per
// block). The left operands of the products (x, ctx, q / o) are zero-padded
// to a whole number of weight tiles; q / o's rows are 4 floats longer than
// that, so that neighbouring rows start 4 banks apart. k and v rows are read
// as float4 broadcasts (ldk a multiple of 4).
__host__ __device__ inline Layout make_layout(int M, int C, int D, int H,
                                              int dh, int cpt) {
  Layout L;
  const long long hd = (long long)H * dh;
  const long long R = kWarps * rows_per_thread(cpt);
  L.ldx = round_up(C, kTileK);
  L.ldc = round_up(D, kTileK);
  L.ldq = round_up(hd, kTileK) + 4;
  L.ldk = round_up(hd, 4);
  const long long kv = round_up(M * L.ldk, 4);
  L.ks = 0;
  L.vs = kv;
  L.qs = 2 * kv;
  L.xs = L.qs + R * L.ldq;
  L.cs = L.xs + R * L.ldx;
  L.wbuf = L.cs + round_up(M * L.ldc, 4);
  L.total = L.wbuf + kStages * kTileK * (32LL * cpt + 1);
  return L;
}

int cols_per_lane(long long hd) {
  return hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : hd <= kMaxHD ? 8 : 0;
}

bool takes_head_size(int dh) { return dh == 8 || dh == 16 || dh == 32; }

// Stage a (rows x cols) block of device memory (row stride ld_src, columns
// contiguous) into shared memory with row stride ld_dst, zero-filling the
// columns past cols. Unrolled so that a thread's loads are in flight
// together.
__device__ void stage_rows(const float* __restrict__ src, long long ld_src,
                           int rows, int cols, float* dst, int ld_dst) {
  const int n = rows * ld_dst;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / ld_dst, c = e - r * ld_dst;
    dst[e] = c < cols ? src[r * ld_src + c] : 0.f;
  }
}

// The (k, j) of the t-th weight value a thread stages: neighbouring threads
// take neighbouring addresses in device memory, columns where the weight's
// rows are contiguous, rows where its columns are (a transposed nn.Linear
// weight).
template <int TN>
__device__ inline void tile_index(int t, bool rowmajor, int& kk, int& jj) {
  const int e = threadIdx.x + t * kThreads;
  if (rowmajor) {
    kk = e / TN;
    jj = e % TN;
  } else {
    jj = e / kTileK;
    kk = e % kTileK;
  }
}

// One 4-byte asynchronous copy into shared memory (zeros where !pred).
__device__ inline void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(saddr), "l"(src), "r"(pred ? 4 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying weight rows k0 .. k0 + kTileK - 1, columns j0 .. j0 + tn - 1
// of w into one shared tile (kTileK rows of 32 CPT + 1), zeros past the
// matrix.
template <int CPT>
__device__ inline void fetch_tile(Mat w, int k0, int kdim, int j0, int tn,
                                  bool rowmajor, float* tile) {
  constexpr int TN = 32 * CPT;
  constexpr int PER = kTileK * TN / kThreads;  // weight values per thread
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    int kk, jj;
    tile_index<TN>(t, rowmajor, kk, jj);
    const long long k = k0 + kk;
    const bool ok = jj < tn && k < kdim;
    cp_async4(tile + kk * (TN + 1) + jj,
              ok ? w.p + k * w.si + (long long)(j0 + jj) * w.sj : w.p, ok);
  }
}

// dst[r * ldd + j] = sum_k a[r * lda + k] * w(k, j) (+ bias[j]) for r < rows
// (<= 8 RPT) and j < cols. a lies in shared memory, zero-padded to a whole
// number of tiles (lda a multiple of 4); w streams through kStages shared
// tiles (kTileK rows of 32 CPT + 1 floats) by asynchronous copies, two
// tiles in flight while one is used, in column chunks of 32 CPT. Warp w
// owns rows w, w + 8, ... and lane l columns l, l + 32, ...; each step
// reads 4 values of a row as one broadcast float4. Callers sync after
// writing a and before reading dst.
template <int CPT, int RPT>
__device__ void block_gemm(const float* a, int lda, int rows, int kdim, Mat w,
                           int cols, const float* __restrict__ bias,
                           float* wbuf, float* dst, long long ldd) {
  constexpr int TN = 32 * CPT;
  constexpr int LDW = TN + 1;
  constexpr int TILE = kTileK * LDW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool rowmajor = w.sj == 1;
  const int ntiles = (kdim + kTileK - 1) / kTileK;
  for (int j0 = 0; j0 < cols; j0 += TN) {
    const int tn = min(TN, cols - j0);
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    __syncthreads();  // a is written; the tiles' last readers are done
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < ntiles)
        fetch_tile<CPT>(w, st * kTileK, kdim, j0, tn, rowmajor, wbuf + st * TILE);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
      __syncthreads();               // everyone's; and tile t - 1 is consumed
      const int nt = t + kStages - 1;
      if (nt < ntiles)
        fetch_tile<CPT>(w, nt * kTileK, kdim, j0, tn, rowmajor,
                        wbuf + (nt % kStages) * TILE);
      cp_async_commit();
      const float* wt = wbuf + (t % kStages) * TILE;
      const int k0 = t * kTileK;
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 4) {
        float4 av[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = warp + kWarps * i;
          av[i] = r < rows ? *reinterpret_cast<const float4*>(a + r * lda + k0 + kk)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wr[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) wr[c] = wt[(kk + q) * LDW + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            if (warp + kWarps * i < rows) {
              const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y
                             : q == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ai, wr[c], acc[i][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + kWarps * i;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = lane + 32 * c;
          if (j < tn)
            dst[r * ldd + j0 + j] = acc[i][c] + (bias ? bias[j0 + j] : 0.f);
        }
      }
    }
  }
}

// Attention: one thread per (head, row) pair, q and the output sum in
// registers, the softmax in its online form (a running maximum and sum, the
// sum rescaled when the maximum grows). Pairs run head-major, so a warp
// shares its head and reads each k and v row as a broadcast. o overwrites
// the pair's own q.
template <int DH>
__device__ void attend_per_head(const float* ks, const float* vs, int ldk,
                                float* qs, int ldq, int rows, int H, int M,
                                float scale) {
  for (int p = threadIdx.x; p < rows * H; p += kThreads) {
    const int h = p / rows, r = p - h * rows;
    float* qr = qs + r * ldq + h * DH;
    float q[DH], acc[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(qr + d);
      q[d] = t.x;
      q[d + 1] = t.y;
      q[d + 2] = t.z;
      q[d + 3] = t.w;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    float mx = -INFINITY, l = 0.f;
    for (int m = 0; m < M; ++m) {
      const float* km = ks + m * ldk + h * DH;
      const float* vm = vs + m * ldk + h * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(km + d);
        s = fmaf(q[d], t.x, s);
        s = fmaf(q[d + 1], t.y, s);
        s = fmaf(q[d + 2], t.z, s);
        s = fmaf(q[d + 3], t.w, s);
      }
      s *= scale;
      if (s > mx) {  // on the first key exp(-inf) = 0 clears l and acc
        const float corr = expf(mx - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= corr;
        mx = s;
      }
      const float pm = expf(s - mx);
      l += pm;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(vm + d);
        acc[d] = fmaf(pm, t.x, acc[d]);
        acc[d + 1] = fmaf(pm, t.y, acc[d + 1]);
        acc[d + 2] = fmaf(pm, t.z, acc[d + 2]);
        acc[d + 3] = fmaf(pm, t.w, acc[d + 3]);
      }
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; d += 4)
      *reinterpret_cast<float4*>(qr + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

template <int CPT, int DH>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
                       Mat wq, Mat wk, Mat wv, Mat wo,
                       const float* __restrict__ bo, float* __restrict__ y,
                       int N, int M, int C, int D, int H, int COUT,
                       long long xsb, long long xsn, long long csb,
                       long long csm, long long ysb, long long ysn,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(M, C, D, H, DH, CPT);
  const int HD = H * DH;
  const int ldx = (int)L.ldx, ldc = (int)L.ldc, ldq = (int)L.ldq;
  const int ldk = (int)L.ldk;
  float* ks = smem + L.ks;
  float* vs = smem + L.vs;
  float* qs = smem + L.qs;
  float* xs = smem + L.xs;
  float* cs = smem + L.cs;
  float* wbuf = smem + L.wbuf;

  constexpr int RPT = rows_per_thread(CPT);
  constexpr int R = kWarps * RPT;
  const long long b = blockIdx.x;
  const int n0 = blockIdx.y * R;
  const int rows = min(R, N - n0);
  stage_rows(x + b * xsb + (long long)n0 * xsn, xsn, rows, C, xs, ldx);
  stage_rows(ctx + b * csb, csm, M, D, cs, ldc);
  for (int e = threadIdx.x; e < rows * ldq; e += kThreads) qs[e] = 0.f;
  // block_gemm syncs before it first reads its left operand
  for (int m0 = 0; m0 < M; m0 += R) {
    const int mr = min(R, M - m0);
    block_gemm<CPT, RPT>(cs + m0 * ldc, ldc, mr, D, wk, HD, nullptr, wbuf,
                         ks + m0 * ldk, ldk);
    block_gemm<CPT, RPT>(cs + m0 * ldc, ldc, mr, D, wv, HD, nullptr, wbuf,
                         vs + m0 * ldk, ldk);
  }
  block_gemm<CPT, RPT>(xs, ldx, rows, C, wq, HD, nullptr, wbuf, qs, ldq);
  __syncthreads();
  attend_per_head<DH>(ks, vs, ldk, qs, ldq, rows, H, M, scale);
  __syncthreads();
  block_gemm<CPT, RPT>(qs, ldq, rows, HD, wo, COUT, bo, wbuf,
                       y + b * ysb + (long long)n0 * ysn, ysn);
}

template <int CPT, int DH>
int launch(const float* x, const float* ctx, Mat wq, Mat wk, Mat wv, Mat wo,
           const float* bo, float* y, int B, int N, int M, int C, int D, int H,
           int COUT, const long long* s, float scale, size_t smem,
           cudaStream_t stream) {
  static size_t opted_in = 0;  // the largest size set so far (one device)
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_attention_kernel<CPT, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  constexpr int R = kWarps * rows_per_thread(CPT);
  const dim3 grid(B, (N + R - 1) / R);
  fused_attention_kernel<CPT, DH><<<grid, kThreads, smem, stream>>>(
      x, ctx, wq, wk, wv, wo, bo, y, N, M, C, D, H, COUT, s[0], s[1], s[2],
      s[3], s[4], s[5], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory one block needs (bytes) and the most a block may
// opt into on the current device; 0 on success, else a CUDA error (or
// cudaErrorInvalidValue where H * DH exceeds 256 or DH is not 8, 16 or 32).
extern "C" int fused_attention_smem(int M, int C, int D, int H, int DH,
                                    long long* need, long long* limit) {
  const int cpt = cols_per_lane((long long)H * DH);
  if (cpt == 0 || !takes_head_size(DH) || M <= 0 || C <= 0 || D <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  *need = 4 * make_layout(M, C, D, H, DH, cpt).total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = optin;
  return (int)err;
}

// strides (elements): x batch, x row, ctx batch, ctx row, y batch, y row,
// then (row, column) of wq, wk, wv and wo. Runs on `stream`, allocates
// nothing and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for shapes it does not take).
extern "C" int fused_attention_fwd(const void* x, const void* ctx, const void* wq,
                                   const void* wk, const void* wv, const void* wo,
                                   const void* bo, void* y, int B, int N, int M,
                                   int C, int D, int H, int DH, int COUT,
                                   const long long* strides, float scale,
                                   void* stream) {
  const int cpt = cols_per_lane((long long)H * DH);
  const int rows = kWarps * rows_per_thread(cpt);
  if (cpt == 0 || B <= 0 || N <= 0 || M <= 0 || C <= 0 || D <= 0 || COUT <= 0
      || (N + rows - 1) / rows > 65535)
    return (int)cudaErrorInvalidValue;
  long long need = 0, limit = 0;
  int err = fused_attention_smem(M, C, D, H, DH, &need, &limit);
  if (err != 0) return err;
  if (need > limit) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Mat mq{(const float*)wq, s[6], s[7]}, mk{(const float*)wk, s[8], s[9]};
  const Mat mv{(const float*)wv, s[10], s[11]}, mo{(const float*)wo, s[12], s[13]};
  const float* xf = (const float*)x;
  const float* cf = (const float*)ctx;
  const float* bf = (const float*)bo;
  float* yf = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)need;
#define FUSED_LAUNCH(CPT, DHT)                                                  \
  launch<CPT, DHT>(xf, cf, mq, mk, mv, mo, bf, yf, B, N, M, C, D, H, COUT,     \
                   s, scale, smem, st)
#define FUSED_BY_DH(CPT)                      \
  (DH == 8    ? FUSED_LAUNCH(CPT, 8)          \
   : DH == 16 ? FUSED_LAUNCH(CPT, 16)         \
              : FUSED_LAUNCH(CPT, 32))
  switch (cpt) {
    case 1: return FUSED_BY_DH(1);
    case 2: return FUSED_BY_DH(2);
    case 4: return FUSED_BY_DH(4);
    default: return FUSED_BY_DH(8);
  }
#undef FUSED_BY_DH
#undef FUSED_LAUNCH
}
