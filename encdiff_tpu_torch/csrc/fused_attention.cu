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
// 8, 16, 32 (the UNet's head sizes; others are refused). x, ctx and y are
// addressed through their batch and row strides with the last dimension
// contiguous. Each weight is an (in, out) view whose `in` index is
// contiguous, as the callers' nn.Linear weights (out, in) are read in place;
// the wrapper copies a weight that comes in another layout.
//
// What is not carried over from the TPU: the TPU kernel holds one batch
// row's x and ctx and all four weight matrices in VMEM. A Hopper block has at
// most 227 KB of shared memory, and at C = 256 wq alone is 256 KB. Here:
// - Tiles: the B * N query rows are cut into tiles of up to 64 rows (32 or
//   16 where 64 would give fewer tiles than the card has SMs). Where N is
//   below the tile size, one tile packs the rows of several batch rows (as
//   many as their k and v fit in shared memory), since the weight products
//   share the weights; the attention stays per batch row. A persistent grid
//   (blocks up to the card's occupancy) walks the tiles, each block a
//   contiguous run of them in batch-row order, and projects k and v only
//   when its batch row changes: once per batch row a block serves.
// - Weight products (ctx wk, ctx wv, x wq, o wo): 3xTF32 on mma.sync
//   m16n8k8 (tf32 inputs, fp32 accumulators). Each fp32 operand a is split
//   into hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi) (computed on
//   the bits, see split()), and a product accumulates lo*hi, hi*lo, then
//   hi*hi (small terms first), four n-tiles at a time so that four mma
//   chains overlap: hi holds a's leading 11 significant bits and lo the
//   next 11, so what is dropped is about 2^-22 of each product, the error
//   of an fp32 sum. The weights
//   stream through a 2-stage shared ring of 16-column slices (all output
//   columns, up to 256, per pass) by cp.async, 16 bytes a thread where the
//   rows are 16-byte aligned (4 bytes otherwise); the left operand (the x
//   tile, ctx, o) sits in shared memory, zero-padded to whole slices, so C
//   and D need not be multiples of 8. The 8 warps split a tile as 4 m-tiles
//   of 16 rows x 2 column halves (2 x 4 or 1 x 8 for smaller tiles). The
//   summed dimension runs in a permuted order so that a lane's values for
//   two k-steps are neighbours: one 16-byte shared read for A (rows g and
//   g + 8) and one for B; row strides of 16 mod 32 floats keep these reads
//   free of bank conflicts. q overwrites the x tile in shared memory; y is
//   written from the accumulators with the bias added.
// - Attention: on the CUDA cores (4 B N M HD flops against 4 B N C HD in
//   the two weight products, where C = HD in the UNet): one thread per
//   (head, query row) keeps q and its output sum in registers (DH of each,
//   a template parameter) and takes the softmax in its online form (fp32,
//   in log2 units, a running maximum subtracted, each exponential one
//   ex2.approx.ftz), reading its batch row's k and v rows from shared
//   memory as broadcasts; o overwrites q. No permutation of v is needed
//   here: P never enters a tensor-core product.
// - Launch: the device's SM count and shared-memory limits are read once,
//   and the occupancy query is repeated only when the shared memory changes
//   (the serving path launches thousands of times a request). The
//   256-wide instances (180 registers) run one block an SM; where tiles
//   outnumber the SMs and a second block fits, an instance held to 128
//   registers runs two.
// Nothing but x, ctx, the weights and y crosses device memory.
//
// Bound on the H100: the largest of bytes, 4 (B N C + B M D + B N COUT)
// plus the weights at 3.35 TB/s; the two weight products and the k, v
// projections three times over at 495 TFLOP/s of dense TF32; the attention
// (4 B N M HD + 4 B H N M) on the CUDA cores at 67 TFLOP/s; the B H N M
// exponentials at 16 per SM and clock. At the faces 64x64 level (B 32,
// N 4096, C = HD = 64) bytes bind: 67 MB, 20 us. mma.sync reaches only part
// of the TF32 peak, every block splits each weight value again for each of
// its m-tiles, and the attention's serial chain of M keys per thread, the
// exposed latency of each tile's x load and weight ring prologue (one or
// two blocks an SM) and the per-slice barriers keep the kernel above it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // rows of a product's m-tile group: 4 x 16
constexpr int kKc = 16;       // summed-dimension columns per ring stage
constexpr int kStages = 2;    // weight slices in shared memory: the next in flight
constexpr int kMaxHD = 256;

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// A row stride for 16-byte fragment reads: whole slices, 16 mod 32 floats.
__host__ __device__ constexpr long long frag_ld(long long cols) {
  return round_up(cols, 16) % 32 ? round_up(cols, 16) : round_up(cols, 16) + 16;
}

// Rows of shared memory a product reads for `n` rows of its left operand:
// whole m-tile groups (16, 32 or 64 rows).
__host__ __device__ constexpr long long mrows(long long n) {
  return n <= 32 ? round_up(n, 16) : round_up(n, kMaxRows);
}

// Weight n-tiles (8 output columns) a warp holds in the widest split (4
// m-tiles x 2 halves): a pass covers 16 NTW output columns.
int tiles_per_warp(int hd) { return hd <= 64 ? 4 : hd <= 128 ? 8 : 16; }

bool takes_head_size(int dh) { return dh == 8 || dh == 16 || dh == 32; }

// A weight as its transpose: output column j, summed index k at
// p[j * ld + k].
struct Mat {
  const float* p;
  long long ld;
};

// Where each buffer lies in a block's shared memory (offsets in floats, each
// a multiple of 4) and its row stride: the x / q / o tile (rows x ldxo), ctx
// of `pack` batch rows (pack M x ldc), their k and v (pack M x ldk each) and
// the weight ring.
struct Layout {
  long long ldxo, ldc, ldk;
  long long xo, cs, ks, vs, ring, total;
};

__host__ __device__ inline Layout make_layout(int rows, int pack, int M, int C,
                                              int D, int HD, int ntw) {
  Layout L;
  L.ldxo = frag_ld(C > HD ? C : HD);
  L.ldc = frag_ld(D);
  L.ldk = round_up(HD, 4);
  L.xo = 0;
  L.cs = L.xo + mrows(rows) * L.ldxo;
  L.ks = L.cs + mrows((long long)pack * M) * L.ldc;
  L.vs = L.ks + (long long)pack * M * L.ldk;
  L.ring = L.vs + (long long)pack * M * L.ldk;
  L.total = L.ring + kStages * 16LL * ntw * kKc;
  return L;
}

// Start copying `nrows` rows of `width` floats (a multiple of 4) into
// shared memory (row stride ld): row r from row_ptr(r), its first `cols`
// floats, zeros past them and for rows where row_ptr gives nullptr. vec:
// every source row starts on 16 bytes and cols % 4 == 0 (16-byte copies),
// else 4-byte copies. `any` is a valid address for the copies that read
// nothing.
template <class RowPtr>
__device__ void stage(float* dst, int ld, int nrows, int width, int cols,
                      bool vec, const float* any, RowPtr row_ptr) {
  const int per_row = width / 4;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int r = e / per_row, c = 4 * (e - r * per_row);
    const float* src = row_ptr(r);
    float* d = dst + r * ld + c;
    if (vec) {
      const bool ok = src != nullptr && c < cols;
      cp_async16(d, ok ? src + c : any, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = src != nullptr && c + i < cols;
        cp_async4(d + i, ok ? src + c + i : any, ok);
      }
    }
  }
}

// acc[i] += A B_i over one 16-column slice of the summed dimension: A is 16
// rows at a (stride lda), B_i the rows 8 i .. 8 i + 7 of a weight slice at b
// (stride ldb), i < cnt. The slice's 16 columns are two k-steps taken in a
// permuted order: lane t of a quad reads columns 4t .. 4t + 3 of its rows,
// (4t, 4t + 1) are k-step 0's slots (t, t + 4) and (4t + 2, 4t + 3) k-step
// 1's, the same for A and B. The 3xTF32 terms (lo*hi, hi*lo, hi*hi) run
// over four n-tiles at a time, so that four accumulator chains overlap.
template <int NTW>
__device__ __forceinline__ void mma_slice(float (&acc)[NTW][4], const float* a,
                                          int lda, const float* b, int ldb,
                                          int cnt, int g, int t) {
  const float4 x0 = *reinterpret_cast<const float4*>(a + g * lda + 4 * t);
  const float4 x1 = *reinterpret_cast<const float4*>(a + (g + 8) * lda + 4 * t);
  uint32_t ahi[2][4], alo[2][4];
  split_a(x0.x, x1.x, x0.y, x1.y, ahi[0], alo[0]);
  split_a(x0.z, x1.z, x0.w, x1.w, ahi[1], alo[1]);
#pragma unroll
  for (int i0 = 0; i0 < NTW; i0 += 4) {
    if (i0 < cnt) {
      const int n = cnt - i0 < 4 ? cnt - i0 : 4;  // 1, 2 or 4
      uint32_t bhi[4][4], blo[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        if (ii < n) {
          const float4 w = *reinterpret_cast<const float4*>(
              b + ((i0 + ii) * 8 + g) * ldb + 4 * t);
          split(w.x, bhi[ii][0], blo[ii][0]);
          split(w.y, bhi[ii][1], blo[ii][1]);
          split(w.z, bhi[ii][2], blo[ii][2]);
          split(w.w, bhi[ii][3], blo[ii][3]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          if (ii < n) mma_tf32(acc[i0 + ii], alo[p], bhi[ii][2 * p], bhi[ii][2 * p + 1]);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          if (ii < n) mma_tf32(acc[i0 + ii], ahi[p], blo[ii][2 * p], blo[ii][2 * p + 1]);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          if (ii < n) mma_tf32(acc[i0 + ii], ahi[p], bhi[ii][2 * p], bhi[ii][2 * p + 1]);
      }
    }
  }
}

// out(r, j) = sum_k a[r * lda + k] w(j, k) for r < rows, j < nout, handed
// to store(r, j, value, value of j + 1) for even j. a lies in shared
// memory, zero-padded to whole 16-column slices and to mrows(rows) rows;
// w streams through the ring in passes of 16 NTW output columns. With
// alias, store writes over a: every warp finishes reading first. Callers
// sync after writing a and before reading what store wrote.
template <int NTW, class Store>
__device__ void block_gemm(const float* a, int lda, int rows, int kdim, Mat w,
                           int nout, bool wvec, float* ring, bool alias,
                           Store store) {
  constexpr int PW = 16 * NTW;  // weight rows (output columns) per pass
  constexpr int STAGE = PW * kKc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (kdim + kKc - 1) / kKc;
  for (int r0 = 0; r0 < rows; r0 += kMaxRows) {
    const int rr = min(kMaxRows, rows - r0);
    const int mt = rr <= 16 ? 1 : rr <= 32 ? 2 : 4;  // m-tiles of 16 rows
    const int parts = kWarps / mt;
    const int cnt = 2 * NTW / parts;  // n-tiles per warp per pass
    const int mtile = warp % mt, part = warp / mt;
    const float* aw = a + (r0 + 16 * mtile) * lda;
    for (int j0 = 0; j0 < nout; j0 += PW) {
      float acc[NTW][4];
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      auto fetch = [&](int kc) {
        const int k0 = kc * kKc;
        stage(ring + (kc % kStages) * STAGE, kKc, PW, kKc, min(kKc, kdim - k0),
              wvec, w.p, [&](int r) -> const float* {
                return j0 + r < nout ? w.p + (long long)(j0 + r) * w.ld + k0
                                     : nullptr;
              });
      };
      __syncthreads();  // a is written; the ring's last readers are done
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk) fetch(s);
        cp_async_commit();
      }
      for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait<kStages - 2>();  // this thread's copies of slice kc landed
        __syncthreads();               // everyone's; and slice kc - 1 is consumed
        if (kc + kStages - 1 < nk) fetch(kc + kStages - 1);
        cp_async_commit();
        mma_slice<NTW>(acc, aw + kc * kKc, lda,
                       ring + (kc % kStages) * STAGE + part * cnt * 8 * kKc, kKc,
                       cnt, g, t);
      }
      if (alias) __syncthreads();
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        if (i < cnt) {
          const int col = j0 + (part * cnt + i) * 8 + 2 * t;
          const int row = r0 + 16 * mtile + g;
          store(row, col, acc[i][0], acc[i][1]);
          store(row + 8, col, acc[i][2], acc[i][3]);
        }
      }
    }
  }
}

// Attention: one thread per (head, row) pair, q and the output sum in
// registers, the softmax in its online form (a running maximum and sum, the
// sum rescaled when the maximum grows). Pairs run head-major, so a warp
// mostly shares its head and reads each k and v row as a broadcast. Row r
// of the tile is query n0 + r of the tile's first batch row's run, so its
// batch row's k and v are slot (n0 + r) / N. o overwrites the pair's own q.
template <int DH>
__device__ void attend_per_head(const float* ks, const float* vs, int ldk,
                                float* qs, int ldq, int rows, int n0, int N,
                                int H, int M, float scale) {
  for (int p = threadIdx.x; p < rows * H; p += kThreads) {
    const int h = p / rows, r = p - h * rows;
    const long long slot = (n0 + r) / N;
    const float* kb = ks + slot * M * ldk + h * DH;
    const float* vb = vs + slot * M * ldk + h * DH;
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
      const float* km = kb + m * ldk;
      const float* vm = vb + m * ldk;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 t = *reinterpret_cast<const float4*>(km + d);
        s = fmaf(q[d], t.x, s);
        s = fmaf(q[d + 1], t.y, s);
        s = fmaf(q[d + 2], t.z, s);
        s = fmaf(q[d + 3], t.w, s);
      }
      s *= scale;  // in log2 units: the caller folds log2 e in
      if (s > mx) {  // on the first key 2^-inf = 0 clears l and acc
        const float corr = exp2_sfu(mx - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= corr;
        mx = s;
      }
      const float pm = exp2_sfu(s - mx);
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

// Which inputs take 16-byte copies (bits of Launch::vec).
enum : int { kVecX = 1, kVecCtx = 2, kVecWq = 4, kVecWk = 8, kVecWv = 16, kVecWo = 32 };

// The tiling of one call: tiles of `rows` query rows within a batch row
// (pack == 1), or of the N rows of `pack` batch rows each.
struct Launch {
  int rows, pack, vec;
  long long tiles;
};

// MINB: blocks an SM the registers must allow (2 holds a thread to 128).
template <int NTW, int DH, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
fused_attention_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
                       Mat wq, Mat wk, Mat wv, Mat wo,
                       const float* __restrict__ bo, float* __restrict__ y,
                       int B, int N, int M, int C, int D, int H, int COUT,
                       long long xsb, long long xsn, long long csb,
                       long long csm, long long ysb, long long ysn,
                       float scale, Launch plan) {
  extern __shared__ __align__(16) float smem[];
  const int HD = H * DH;
  const int pack = plan.pack;
  const int alloc_rows = pack > 1 ? pack * N : min(plan.rows, N);
  const Layout L = make_layout(alloc_rows, pack, M, C, D, HD, NTW);
  const int ldxo = (int)L.ldxo, ldc = (int)L.ldc, ldk = (int)L.ldk;
  float* xo = smem + L.xo;
  float* cs = smem + L.cs;
  float* ks = smem + L.ks;
  float* vs = smem + L.vs;
  float* ring = smem + L.ring;
  const int xwidth = (int)round_up(C > HD ? C : HD, kKc);
  const int cwidth = (int)round_up(D, kKc);

  const long long t_begin = plan.tiles * blockIdx.x / gridDim.x;
  const long long t_end = plan.tiles * (blockIdx.x + 1) / gridDim.x;
  const long long tiles_per_b = (N + plan.rows - 1) / plan.rows;  // pack == 1
  long long cached = -1;  // the batch row whose k and v are in ks, vs
  for (long long tile = t_begin; tile < t_end; ++tile) {
    long long b0;
    int n0, rows, nb;
    if (pack == 1) {
      b0 = tile / tiles_per_b;
      n0 = (int)(tile - b0 * tiles_per_b) * plan.rows;
      rows = min(plan.rows, N - n0);
      nb = 1;
    } else {
      b0 = tile * pack;
      n0 = 0;
      nb = (int)min((long long)pack, B - b0);
      rows = nb * N;
    }
    const bool new_kv = b0 != cached || pack > 1;
    __syncthreads();  // the last tile's readers of xo, ks and vs are done
    stage(xo, ldxo, (int)mrows(rows), xwidth, C, plan.vec & kVecX, x,
          [&](int r) -> const float* {
            if (r >= rows) return nullptr;
            const int f = n0 + r;
            return x + (b0 + f / N) * xsb + (long long)(f % N) * xsn;
          });
    if (new_kv)
      stage(cs, ldc, (int)mrows((long long)nb * M), cwidth, D,
            plan.vec & kVecCtx, ctx, [&](int r) -> const float* {
              return r < nb * M ? ctx + (b0 + r / M) * csb + (long long)(r % M) * csm
                                : nullptr;
            });
    cp_async_commit();
    cp_async_wait<0>();  // block_gemm syncs before it reads them
    if (new_kv) {
      const int kv_rows = nb * M;
      block_gemm<NTW>(cs, ldc, kv_rows, D, wk, HD, plan.vec & kVecWk, ring, false,
                      [&](int r, int j, float a0, float a1) {
                        if (r < kv_rows && j < HD) {
                          ks[r * ldk + j] = a0;
                          if (j + 1 < HD) ks[r * ldk + j + 1] = a1;
                        }
                      });
      block_gemm<NTW>(cs, ldc, kv_rows, D, wv, HD, plan.vec & kVecWv, ring, false,
                      [&](int r, int j, float a0, float a1) {
                        if (r < kv_rows && j < HD) {
                          vs[r * ldk + j] = a0;
                          if (j + 1 < HD) vs[r * ldk + j + 1] = a1;
                        }
                      });
      cached = b0;
    }
    // q = x wq over the x tile (HD <= 16 NTW: one pass)
    block_gemm<NTW>(xo, ldxo, rows, C, wq, HD, plan.vec & kVecWq, ring, true,
                    [&](int r, int j, float a0, float a1) {
                      if (j < HD) {
                        xo[r * ldxo + j] = a0;
                        xo[r * ldxo + j + 1] = a1;
                      }
                    });
    __syncthreads();
    attend_per_head<DH>(ks, vs, ldk, xo, ldxo, rows, n0, N, H, M,
                        scale * 1.4426950408889634f);
    // y = o wo + bo (block_gemm syncs before it reads o)
    block_gemm<NTW>(xo, ldxo, rows, HD, wo, COUT, plan.vec & kVecWo, ring, false,
                    [&](int r, int j, float a0, float a1) {
                      if (r < rows && j < COUT) {
                        const int f = n0 + r;  // < 64 N
                        float* yr = y + (b0 + f / N) * ysb + (long long)(f % N) * ysn;
                        yr[j] = a0 + bo[j];
                        if (j + 1 < COUT) yr[j + 1] = a1 + bo[j + 1];
                      }
                    });
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The most devices the per-device caches below hold.
constexpr int kDevices = 64;

// What a kernel instance has set up on one device: the dynamic shared
// memory it is opted into (the largest size so far) and its blocks per SM
// at the last size queried.
struct Setup {
  size_t opted_in, occupancy_smem;
  int per_sm;
};

template <int NTW, int DH, int MINB>
int launch(const float* x, const float* ctx, Mat wq, Mat wk, Mat wv, Mat wo,
           const float* bo, float* y, int B, int N, int M, int C, int D, int H,
           int COUT, const long long* s, float scale, Launch plan, size_t smem,
           int sms, cudaStream_t stream) {
  auto kernel = fused_attention_kernel<NTW, DH, MINB>;
  // per device, under a lock: ctypes drops the GIL, so threads may launch
  // at once
  static std::mutex lock;
  static Setup setup[kDevices];  // zeros: nothing set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    Setup& su = setup[dev];
    if (smem > su.opted_in) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      su.opted_in = smem;
    }
    if (smem != su.occupancy_smem) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&su.per_sm, kernel,
                                                          kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      su.occupancy_smem = smem;
    }
    per_sm = su.per_sm;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long grid = plan.tiles < (long long)per_sm * sms
                             ? plan.tiles : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      x, ctx, wq, wk, wv, wo, bo, y, B, N, M, C, D, H, COUT, s[0], s[1], s[2],
      s[3], s[4], s[5], scale, plan);
  return (int)cudaGetLastError();
}

// The current device's SM count, opt-in shared memory per block and shared
// memory per SM, read once per device (the serving path launches thousands
// of times).
int device_limits(int* sms, int* optin, int* per_sm) {
  static std::mutex lock;
  static int cached[kDevices][3];  // zeros: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(lock);
  if (cached[dev][0] == 0) {
    int s = 0, o = 0, p = 0;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&p, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return (int)err;
    cached[dev][1] = o;
    cached[dev][2] = p;
    cached[dev][0] = s;
  }
  *sms = cached[dev][0];
  *optin = cached[dev][1];
  *per_sm = cached[dev][2];
  return 0;
}

long long smem_bytes(int rows, int pack, int N, int M, int C, int D, int HD) {
  const int alloc_rows = pack > 1 ? pack * N : (rows < N ? rows : N);
  return 4 * make_layout(alloc_rows, pack, M, C, D, HD, tiles_per_warp(HD)).total;
}

// The tiling: the largest tile of 64, 32 or 16 rows that still gives at
// least one tile per SM (16 if none does), packing as many batch rows as fit
// where N is below it. rows = 0 where even 16 rows of one batch row do not
// fit in `limit` bytes.
Launch plan_tiles(int B, int N, int M, int C, int D, int HD, long long limit,
                  int sms) {
  for (int rows = kMaxRows; rows >= 16; rows /= 2) {
    int pack = N < rows ? rows / N : 1;
    while (pack > 1 && smem_bytes(rows, pack, N, M, C, D, HD) > limit) --pack;
    const long long tiles = pack > 1 ? (B + pack - 1) / pack
                                     : (long long)B * ((N + rows - 1) / rows);
    if ((tiles >= sms || rows == 16) &&
        smem_bytes(rows, pack, N, M, C, D, HD) <= limit)
      return Launch{rows, pack, 0, tiles};
  }
  return Launch{0, 0, 0, 0};
}

}  // namespace

// The dynamic shared memory one block needs at the least (bytes: a tile of
// 16 rows of one batch row) and the most a block may opt into on the
// current device; 0 on success, else a CUDA error (or cudaErrorInvalidValue
// where H * DH exceeds 256 or DH is not 8, 16 or 32).
extern "C" int fused_attention_smem(int M, int C, int D, int H, int DH,
                                    long long* need, long long* limit) {
  const long long hd = (long long)H * DH;
  if (hd > kMaxHD || !takes_head_size(DH) || M <= 0 || C <= 0 || D <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  *need = smem_bytes(16, 1, 16, M, C, D, (int)hd);
  int sms = 0, optin = 0, per_sm = 0;
  const int err = device_limits(&sms, &optin, &per_sm);
  *limit = optin;
  return err;
}

// strides (elements): x batch, x row, ctx batch, ctx row, y batch, y row,
// then (row, column) of wq, wk, wv and wo as (in, out) views, whose row
// stride must be 1. Runs on `stream`, allocates nothing and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for shapes or
// layouts it does not take).
extern "C" int fused_attention_fwd(const void* x, const void* ctx, const void* wq,
                                   const void* wk, const void* wv, const void* wo,
                                   const void* bo, void* y, int B, int N, int M,
                                   int C, int D, int H, int DH, int COUT,
                                   const long long* strides, float scale,
                                   void* stream) {
  const long long* s = strides;
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || D <= 0 || COUT <= 0 ||
      s[6] != 1 || s[8] != 1 || s[10] != 1 || s[12] != 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)H * DH > kMaxHD || !takes_head_size(DH) || H <= 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0, per_sm = 0;
  const int err = device_limits(&sms, &optin, &per_sm);
  if (err != 0) return err;
  const long long limit = optin;
  const int HD = H * DH;
  Launch plan = plan_tiles(B, N, M, C, D, HD, limit, sms);
  if (plan.rows == 0) return (int)cudaErrorInvalidValue;
  const Mat mq{(const float*)wq, s[7]}, mk{(const float*)wk, s[9]};
  const Mat mv{(const float*)wv, s[11]}, mo{(const float*)wo, s[13]};
  auto rows16 = [](const void* p, long long ld, int cols) {
    return aligned16(p) && ld % 4 == 0 && cols % 4 == 0;
  };
  plan.vec = (aligned16(x) && s[0] % 4 == 0 && s[1] % 4 == 0 && C % 4 == 0 ? kVecX : 0) |
             (aligned16(ctx) && s[2] % 4 == 0 && s[3] % 4 == 0 && D % 4 == 0 ? kVecCtx : 0) |
             (rows16(wq, s[7], C) ? kVecWq : 0) | (rows16(wk, s[9], D) ? kVecWk : 0) |
             (rows16(wv, s[11], D) ? kVecWv : 0) | (rows16(wo, s[13], HD) ? kVecWo : 0);
  const size_t smem = (size_t)smem_bytes(plan.rows, plan.pack, N, M, C, D, HD);
  const float* xf = (const float*)x;
  const float* cf = (const float*)ctx;
  const float* bf = (const float*)bo;
  float* yf = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  // At 16 n-tiles a warp (HD above 128) a thread takes about 180
  // registers: one block an SM. Where a second block fits in shared memory
  // and the tiles outnumber the SMs, the instance held to 128 registers
  // (a few spilled) runs two an SM instead; elsewhere its spills only cost.
  const bool two_blocks = plan.tiles > sms && 2 * ((long long)smem + 1024) <= per_sm;
#define FUSED_LAUNCH(NTW, DHT, MINB)                                            \
  launch<NTW, DHT, MINB>(xf, cf, mq, mk, mv, mo, bf, yf, B, N, M, C, D, H,     \
                         COUT, s, scale, plan, smem, sms, st)
#define FUSED_BY_DH(NTW, MINB)                      \
  (DH == 8    ? FUSED_LAUNCH(NTW, 8, MINB)          \
   : DH == 16 ? FUSED_LAUNCH(NTW, 16, MINB)         \
              : FUSED_LAUNCH(NTW, 32, MINB))
  switch (tiles_per_warp(HD)) {
    case 4: return FUSED_BY_DH(4, 2);
    case 8: return FUSED_BY_DH(8, 2);
    default: return two_blocks ? FUSED_BY_DH(16, 2) : FUSED_BY_DH(16, 1);
  }
#undef FUSED_BY_DH
#undef FUSED_LAUNCH
}
