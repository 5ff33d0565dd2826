// PointNetSeg training kernels for Hopper (sm_90a): the fused layer
// chain, the classifier + cross-entropy, dropout, and the BN + ReLU +
// first-max pool that only tests reach.
//
// Entries (plain C interface, loaded with ctypes; each returns
// cudaGetLastError() after its launches; pointers and the stream are
// passed as void*):
//
//   pcseg_fused_block_fwd / _bwd   replace pcseg_tpu/ops/pallas/
//       fused_block.py fused_block (_fwd_pallas, pallas_call at :239;
//       _bwd_pallas at :451): y = bf16(dropout(relu((x - mu) * inv *
//       gamma + beta))) @ W + b [+ row_bias], stats s1/s2 of the f32 y.
//   (fused_global.py fused_global_pool_block, the same layer with the
//   first-max pool, is pointnet_wgmma.cu's, on wgmma.)
//   pcseg_seg4_ce_fwd / _bwd       replace fused_ce.py fused_seg4_ce
//       (:264, :294): seg3-BN prologue, the Cin x C classifier and the
//       weighted CE sums (num, den, correct), logits never stored.
//   pcseg_dropout                  replaces dropout.py pallas_dropout
//       (:52, forward and backward): keep iff bits >= threshold.
//   pcseg_fused_pool_fwd / _bwd    replace fused_pool.py fused_global_pool
//       (_fwd_pallas, pallas_call at :107; _bwd_pallas at :146): per group
//       of rows and channel, the max of relu(((y - mu) * inv) * gamma +
//       beta) and the first row attaining it; the backward writes dy = val
//       at each winner row and zeros elsewhere.
//
// Rounding points are the TPU kernels' (see the Python modules): the
// prologue in f32 (no FMA contraction), rounded to bf16 before the
// product; products of bf16 values summed in f32; bias, then the row
// bias, added in f32; stats from the f32 y; y stored bf16 (or f32 for a
// logits layer); in the backward the cotangent (dy + ds1) + 2 y ds2 is
// rounded to bf16 for both products, dW/db and the gamma/beta-like sums
// stay f32.
//
// What bounds them on an H100: at B64 x 2048 points (N = 131,072 rows)
// every layer left here is bound by bytes, the widest, 128->1024, too
// (0.3 GB of traffic / 3.35 TB/s = 0.09 ms against 0.034 TFLOP / 989
// TFLOP/s = 0.035 ms as a bf16 tensor-core GEMM), and so is dropout. Every product runs on the tensor cores through WMMA
// (bf16 16x16x16, f32 accumulators): a block of 8 warps owns a 128 x 128
// output tile (each warp 64 x 32), K is staged 32 deep in shared memory
// with 16-byte loads (8 elements; one at a time where a width is not a
// multiple of 8), and the next K tile is loaded into registers while the
// tensor cores work on this one. The prologue is applied while the A
// tile is staged (so normalized activations never reach device memory),
// and the column statistics and gamma/beta-like sums are reduced per
// thread over its rows of the tile and added with atomics.
// The backward runs three kernels: the effective cotangent (bf16 scratch
// + db), dx (dY @ W^T with the prologue recomputed in the epilogue for
// the ReLU/dropout masks and the gamma/beta-like sums) and dW (X^T @ dY,
// split over the rows, atomics).
// Dropout bits are a hash of (seed, element index) (ops/dropout.py), so
// the masks do not depend on tiling and the backward regenerates them.
// The pool is bound by bytes: one read of y forward, one write of dy
// backward (268 MB each at B64 x 2048 x 1024 bf16, 0.080 ms at 3.35
// TB/s). A thread loads 8 bf16 (4 f32) channels of a row in 16 bytes and
// keeps their running maxima and rows in registers; a block folds its
// threads' (value, row) keys in shared memory and adds one 64-bit
// atomicMax a channel (the key of pointnet_wgmma.cu's pool), so the TPU's
// sequential accumulation over row tiles needs no order between blocks.
// The keys start at (0, row 0), so a group with no positive value pools
// to 0 with row 0, as the TPU kernel's zero-initialised accumulator does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "pool_keys.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kGemmThreads = 256;        // 8 warps, 2 (m) x 4 (n)
constexpr int WM = 64, WN = 32;          // one warp's tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int LDK = BK + 8;              // tiles stored [m|n][k]
constexpr int LDMN = BM + 8;             // tiles stored [k][m|n]
constexpr int LDC = BN + 4;              // f32 output tile [m][n]
constexpr int kTileElems = BM * LDK > BK * LDMN ? BM * LDK : BK * LDMN;
constexpr int kCsBytes = BM * LDC * 4;
constexpr int kAbBytes = 2 * kTileElems * 2;
constexpr int kSmemBytes = kCsBytes > kAbBytes ? kCsBytes : kAbBytes;
constexpr int kRowsPerBlock = 64;         // cotangent kernel
constexpr int kCeRows = 128;              // CE kernels: one row a thread

// --------------------------------------------------------------------------
// shared pieces
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// ops/dropout.py hash_bits: key = mix32(seed ^ 0x9E3779B9) (host side)
__device__ __forceinline__ uint32_t drop_bits(uint32_t key, uint64_t idx) {
  return mix32(mix32((uint32_t)idx ^ key) ^ (uint32_t)(idx >> 32));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Prologue {
  const float* mu;      // null: no normalize (conv1)
  const float* inv;
  const float* gamma;
  const float* beta;
  int relu;
  int drop;
  uint32_t key;
  uint32_t thr;
  float scale;
};

struct Pre {  // the prologue at one element, kept for the backward
  float x_hat, z, a, dmul;
};

__device__ __forceinline__ Pre prologue(float xf, int k, uint64_t idx,
                                        const Prologue& p) {
  Pre r;
  if (p.mu != nullptr) {
    r.x_hat = __fmul_rn(__fsub_rn(xf, p.mu[k]), p.inv[k]);
    r.z = __fadd_rn(__fmul_rn(r.x_hat, p.gamma[k]), p.beta[k]);
  } else {
    r.x_hat = r.z = xf;
  }
  float a = p.relu ? fmaxf(r.z, 0.f) : r.z;
  r.dmul = 1.f;
  if (p.drop) {
    const bool keep = drop_bits(p.key, idx) >= p.thr;
    r.dmul = keep ? p.scale : 0.f;
    a = keep ? __fmul_rn(a, p.scale) : 0.f;
  }
  r.a = a;
  return r;
}

template <bool COL>
using FragA = wmma::fragment<
    wmma::matrix_a, 16, 16, 16, bf16,
    typename std::conditional<COL, wmma::col_major, wmma::row_major>::type>;
template <bool COL>
using FragB = wmma::fragment<
    wmma::matrix_b, 16, 16, 16, bf16,
    typename std::conditional<COL, wmma::col_major, wmma::row_major>::type>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// element j (0..7) of 8 packed bf16 values, as a float
__device__ __forceinline__ float unpack_bf16(const uint4& v, int j) {
  const uint32_t w = (&v.x)[j >> 1];
  return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// Stages a ROWS x COLS tile whose COLS run contiguously in device memory
// (row stride ld, nrows x ncols valid) into shared memory [ROWS][COLS + 8]
// through registers: load() issues the reads, store() writes them, so a
// caller loads tile k+1 before it multiplies tile k. VEC: 16-byte reads
// of 8 elements (ncols % 8 == 0, aligned pointers), else one element at a
// time. PRO: the prologue is applied with (point, channel) = (row, col),
// element index row * ld + col, and out-of-range elements stay 0.
template <int ROWS, int COLS, bool VEC, bool PRO>
struct Stager {
  static constexpr int kGroups = COLS / 8;
  static constexpr int kPer = ROWS * COLS / 8 / kGemmThreads;
  uint4 r[kPer];

  __device__ __forceinline__ void load(const bf16* __restrict__ src,
                                       long long ld, long long row0,
                                       long long col0, long long nrows,
                                       long long ncols) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int chunk = threadIdx.x + i * kGemmThreads;
      const long long row = row0 + chunk / kGroups;
      const long long col = col0 + (chunk % kGroups) * 8;
      if (VEC) {
        r[i] = (row < nrows && col < ncols)
                   ? *reinterpret_cast<const uint4*>(s + row * ld + col)
                   : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t lo = 0u, hi = 0u;
          if (row < nrows && col + 2 * h < ncols) lo = s[row * ld + col + 2 * h];
          if (row < nrows && col + 2 * h + 1 < ncols)
            hi = s[row * ld + col + 2 * h + 1];
          w[h] = lo | (hi << 16);
        }
        r[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  __device__ __forceinline__ void store(bf16* dst, long long ld,
                                        long long row0, long long col0,
                                        long long nrows, long long ncols,
                                        const Prologue& pro) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int chunk = threadIdx.x + i * kGemmThreads;
      const int rr = chunk / kGroups, cc = (chunk % kGroups) * 8;
      uint4 v = r[i];
      if (PRO) {
        const long long row = row0 + rr, col = col0 + cc;
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          a[j] = 0.f;
          if (row < nrows && col + j < ncols)
            a[j] = prologue(unpack_bf16(v, j), (int)(col + j),
                            (uint64_t)(row * ld + col + j), pro).a;
        }
        v = make_uint4(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]),
                       pack_bf16x2(a[4], a[5]), pack_bf16x2(a[6], a[7]));
      }
      *reinterpret_cast<uint4*>(dst + rr * (COLS + 8) + cc) = v;
    }
  }
};

// A tile: A_COL ? As[k][m] (ld LDMN) : As[m][k] (ld LDK);
// B tile: B_COL ? Bs[n][k] (ld LDK) : Bs[k][n] (ld LDMN).
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void mma_tile(const bf16* As, const bf16* Bs,
                                         FragC (&acc)[FM][FN], int wm,
                                         int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA<A_COL> a[FM];
    FragB<B_COL> b[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int m = wm * WM + i * 16;
      if (A_COL)
        wmma::load_matrix_sync(a[i], As + kk * LDMN + m, LDMN);
      else
        wmma::load_matrix_sync(a[i], As + m * LDK + kk, LDK);
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int n = wn * WN + j * 16;
      if (B_COL)
        wmma::load_matrix_sync(b[j], Bs + n * LDK + kk, LDK);
      else
        wmma::load_matrix_sync(b[j], Bs + kk * LDMN + n, LDMN);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_acc(FragC (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// accumulators -> Cs[m][n] (f32); the caller syncs before and after
__device__ __forceinline__ void store_acc(float* Cs, FragC (&acc)[FM][FN],
                                          int wm, int wn) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
}

// --------------------------------------------------------------------------
// forward: Y = prologue(X) @ W + b [+ row_bias]; stats
// --------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(kGemmThreads, 2) fwd_kernel(
    const bf16* __restrict__ x, Prologue pro, const bf16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ row_bias,
    long long rpb, void* __restrict__ y, int out_f32, float* __restrict__ s1,
    float* __restrict__ s2, long long n, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kTileElems;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Stager<BM, BK, VEC, true> sa;     // prologue(x): points x channels
  Stager<BK, BN, VEC, false> sb;    // W: channels in x channels out
  FragC acc[FM][FN];
  zero_acc(acc);
  sa.load(x, cin, m0, 0, n, cin);
  sb.load(w, cout, 0, n0, cin, cout);
  for (int k0 = 0; k0 < cin; k0 += BK) {
    __syncthreads();
    sa.store(As, cin, m0, k0, n, cin, pro);
    sb.store(Bs, cout, k0, n0, cin, cout, pro);
    __syncthreads();
    if (k0 + BK < cin) {
      sa.load(x, cin, m0, k0 + BK, n, cin);
      sb.load(w, cout, k0 + BK, n0, cin, cout);
    }
    mma_tile<false, false>(As, Bs, acc, wm, wn);
  }
  __syncthreads();
  store_acc(Cs, acc, wm, wn);
  __syncthreads();

  // epilogue: a thread takes one column and every other row of the tile
  const int c = tid % BN;
  const int cc = n0 + c;
  if (cc >= cout) return;
  const float bc = bias[cc];
  float a1 = 0.f, a2 = 0.f;
  for (int m = tid / BN; m < BM; m += kGemmThreads / BN) {
    const long long row = m0 + m;
    if (row >= n) break;
    float v = Cs[m * LDC + c] + bc;
    if (row_bias != nullptr) v += row_bias[(row / rpb) * cout + cc];
    const size_t o = (size_t)row * cout + cc;
    if (out_f32)
      reinterpret_cast<float*>(y)[o] = v;
    else
      reinterpret_cast<bf16*>(y)[o] = __float2bfloat16_rn(v);
    a1 += v;
    a2 += v * v;
  }
  if (s1 != nullptr) {
    atomicAdd(&s1[cc], a1);
    atomicAdd(&s2[cc], a2);
  }
}

// --------------------------------------------------------------------------
// backward 1: the effective cotangent of y, d = (dy + ds1) + 2 y ds2 (stats
// terms optional), rounded to bf16, and its column sums (db) and
// per-batch-row column sums (d row_bias)
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(256) cotangent_kernel(
    const void* __restrict__ dy, int dy_f32, const bf16* __restrict__ y,
    const float* __restrict__ ds1, const float* __restrict__ ds2,
    bf16* __restrict__ dyb, float* __restrict__ db, float* __restrict__ drb,
    long long rpb, long long n, int cout, int cw) {
  const int lanes = blockDim.x / cw, lane = threadIdx.x / cw;
  if (lane >= lanes) return;
  const int c = blockIdx.y * cw + threadIdx.x % cw;
  if (c >= cout) return;
  const long long r0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long r1 = r0 + kRowsPerBlock < n ? r0 + kRowsPerBlock : n;
  const bool stats = ds1 != nullptr;
  const float d1 = stats ? ds1[c] : 0.f, d2 = stats ? ds2[c] : 0.f;
  float acc = 0.f, acc_b = 0.f;
  long long cur_b = -1;
  for (long long row = r0 + lane; row < r1; row += lanes) {
    const size_t o = (size_t)row * cout + c;
    const long long b = row / rpb;
    float d = dy_f32 ? reinterpret_cast<const float*>(dy)[o]
                     : __bfloat162float(reinterpret_cast<const bf16*>(dy)[o]);
    if (stats)
      d = __fadd_rn(__fadd_rn(d, d1),
                    __fmul_rn(__fmul_rn(2.f, __bfloat162float(y[o])), d2));
    dyb[o] = __float2bfloat16_rn(d);
    acc += d;
    if (drb != nullptr) {
      if (b != cur_b) {
        if (cur_b >= 0) atomicAdd(&drb[cur_b * cout + c], acc_b);
        cur_b = b;
        acc_b = 0.f;
      }
      acc_b += d;
    }
  }
  atomicAdd(&db[c], acc);
  if (drb != nullptr && cur_b >= 0) atomicAdd(&drb[cur_b * cout + c], acc_b);
}

// --------------------------------------------------------------------------
// backward 2: dA = dY @ W^T, then through dropout/ReLU to dz; dx =
// dz * gamma * inv, and the gamma/beta-like column sums
// --------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(kGemmThreads, 2) dx_kernel(
    const bf16* __restrict__ dyb, const bf16* __restrict__ w,
    const bf16* __restrict__ x, Prologue pro, bf16* __restrict__ dx,
    float* __restrict__ dg, float* __restrict__ dbeta, long long n, int cin,
    int cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kTileElems;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;  // over cin

  Stager<BM, BK, VEC, false> sa;    // dY: points x channels out
  Stager<BN, BK, VEC, false> sb;    // W: channels in x channels out
  FragC acc[FM][FN];
  zero_acc(acc);
  sa.load(dyb, cout, m0, 0, n, cout);
  sb.load(w, cout, n0, 0, cin, cout);
  for (int k0 = 0; k0 < cout; k0 += BK) {
    __syncthreads();
    sa.store(As, cout, m0, k0, n, cout, pro);
    sb.store(Bs, cout, n0, k0, cin, cout, pro);
    __syncthreads();
    if (k0 + BK < cout) {
      sa.load(dyb, cout, m0, k0 + BK, n, cout);
      sb.load(w, cout, n0, k0 + BK, cin, cout);
    }
    mma_tile<false, true>(As, Bs, acc, wm, wn);
  }
  __syncthreads();
  store_acc(Cs, acc, wm, wn);
  __syncthreads();

  // epilogue: a thread takes one input channel and every other row
  const int j = tid % BN;
  const int jc = n0 + j;
  if (jc >= cin) return;
  const bool norm = pro.mu != nullptr;
  float sg = 0.f, sb2 = 0.f;
  for (int m = tid / BN; m < BM; m += kGemmThreads / BN) {
    const long long row = m0 + m;
    if (row >= n) break;
    const uint64_t i = (uint64_t)row * cin + jc;
    const Pre pr = prologue(__bfloat162float(x[i]), jc, i, pro);
    float dz = Cs[m * LDC + j];
    if (pro.drop) dz = __fmul_rn(dz, pr.dmul);
    if (pro.relu) dz = __fmul_rn(dz, pr.z > 0.f ? 1.f : 0.f);
    const float g =
        norm ? __fmul_rn(__fmul_rn(dz, pro.gamma[jc]), pro.inv[jc]) : dz;
    dx[i] = __float2bfloat16_rn(g);
    sg += __fmul_rn(dz, pr.x_hat);
    sb2 += dz;
  }
  if (norm) {
    atomicAdd(&dg[jc], sg);
    atomicAdd(&dbeta[jc], sb2);
  }
}

// --------------------------------------------------------------------------
// backward 3: dW += prologue(X)^T @ dY over a slice of the rows
// --------------------------------------------------------------------------

// No two-blocks-per-SM bound here, unlike fwd_kernel and dx_kernel: the
// column-major A staging needs ~250 registers, and held to 128 it spilled
// ~500 bytes a thread and ran far slower; fwd_kernel and dx_kernel, in
// turn, ran slower without the bound (chip_smoke.py, phase 4).
template <bool VEC>
__global__ void __launch_bounds__(kGemmThreads) dw_kernel(
    const bf16* __restrict__ x, Prologue pro, const bf16* __restrict__ dyb,
    float* __restrict__ dw, long long n, int cin, int cout,
    long long chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kTileElems;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM;   // over cin
  const int n0 = blockIdx.y * BN;   // over cout
  const long long r0 = (long long)blockIdx.z * chunk;
  const long long r1 = r0 + chunk < n ? r0 + chunk : n;

  Stager<BK, BM, VEC, true> sa;     // prologue(x): points x channels in
  Stager<BK, BN, VEC, false> sb;    // dY: points x channels out
  FragC acc[FM][FN];
  zero_acc(acc);
  sa.load(x, cin, r0, m0, r1, cin);
  sb.load(dyb, cout, r0, n0, r1, cout);
  for (long long k0 = r0; k0 < r1; k0 += BK) {
    __syncthreads();
    sa.store(As, cin, k0, m0, r1, cin, pro);
    sb.store(Bs, cout, k0, n0, r1, cout, pro);
    __syncthreads();
    if (k0 + BK < r1) {
      sa.load(x, cin, k0 + BK, m0, r1, cin);
      sb.load(dyb, cout, k0 + BK, n0, r1, cout);
    }
    mma_tile<true, false>(As, Bs, acc, wm, wn);
  }
  __syncthreads();
  store_acc(Cs, acc, wm, wn);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kGemmThreads) {
    const int m = e / BN, c = e % BN;
    const int jc = m0 + m, cc = n0 + c;
    if (jc < cin && cc < cout)
      atomicAdd(&dw[(size_t)jc * cout + cc], Cs[m * LDC + c]);
  }
}

// --------------------------------------------------------------------------
// classifier + weighted CE: one thread a row
// --------------------------------------------------------------------------

// Stages kCeRows rows of bf16(relu(bn(x))) as As[r][cin + 2] and W as
// f32 Ws[k][MAXC] (zero beyond C) in dynamic shared memory.
template <int MAXC>
__device__ __forceinline__ void ce_stage(const bf16* __restrict__ x,
                                         const Prologue& pro,
                                         const bf16* __restrict__ w,
                                         float* Ws, bf16* As, long long r0,
                                         long long n, int cin, int C) {
  for (int e = threadIdx.x; e < cin * MAXC; e += blockDim.x) {
    const int k = e / MAXC, c = e % MAXC;
    Ws[e] = c < C ? __bfloat162float(w[k * C + c]) : 0.f;
  }
  const int lda = cin + 2;
  for (int e = threadIdx.x; e < kCeRows * cin; e += blockDim.x) {
    const int r = e / cin, k = e % cin;
    const long long row = r0 + r;
    float v = 0.f;
    if (row < n) {
      const uint64_t i = (uint64_t)row * cin + k;
      v = prologue(__bfloat162float(x[i]), k, i, pro).a;
    }
    As[r * lda + k] = __float2bfloat16_rn(v);
  }
  __syncthreads();
}

template <int MAXC>
__device__ __forceinline__ void ce_logits(const float* Ws, const bf16* As,
                                          const float* __restrict__ bias,
                                          int cin, int C, float (&lg)[MAXC]) {
  const bf16* a = As + threadIdx.x * (cin + 2);
#pragma unroll
  for (int c = 0; c < MAXC; ++c) lg[c] = 0.f;
  for (int k = 0; k < cin; ++k) {
    const float av = __bfloat162float(a[k]);
    const float* wr = Ws + k * MAXC;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) lg[c] = fmaf(av, wr[c], lg[c]);
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) lg[c] += bias[c];
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

template <int MAXC>
__global__ void __launch_bounds__(kCeRows) ce_fwd_kernel(
    const bf16* __restrict__ x, Prologue pro, const bf16* __restrict__ w,
    const float* __restrict__ bias, const long long* __restrict__ labels,
    const float* __restrict__ cw, float* __restrict__ acc, long long n,
    int cin, int C) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float* Ws = reinterpret_cast<float*>(dsm);
  bf16* As = reinterpret_cast<bf16*>(Ws + cin * MAXC);
  __shared__ float red[kCeRows / 32];
  const long long r0 = (long long)blockIdx.x * kCeRows;
  ce_stage<MAXC>(x, pro, w, Ws, As, r0, n, cin, C);

  const long long row = r0 + threadIdx.x;
  float num = 0.f, den = 0.f, cor = 0.f;
  if (row < n) {
    float lg[MAXC];
    ce_logits<MAXC>(Ws, As, bias, cin, C, lg);
    float mx = lg[0];
#pragma unroll
    for (int c = 1; c < MAXC; ++c)
      if (c < C) mx = fmaxf(mx, lg[c]);
    int pred = -1;
    float se = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        se += expf(lg[c] - mx);
        if (pred < 0 && lg[c] == mx) pred = c;
      }
    }
    const long long lab = labels[row];
    if (lab >= 0 && lab < C) {
      float tl = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c == lab) tl = lg[c];
      const float wr = cw[lab];
      num = wr * ((logf(se) + mx) - tl);
      den = wr;
      cor = pred == lab ? 1.f : 0.f;
    }
  }
  num = block_sum(num, red);
  den = block_sum(den, red);
  cor = block_sum(cor, red);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], num);
    atomicAdd(&acc[1], den);
    atomicAdd(&acc[2], cor);
  }
}

// dlogits = (ct * w[y]) * (softmax - onehot), rounded to bf16, and db
template <int MAXC>
__global__ void __launch_bounds__(kCeRows) ce_dlogits_kernel(
    const bf16* __restrict__ x, Prologue pro, const bf16* __restrict__ w,
    const float* __restrict__ bias, const long long* __restrict__ labels,
    const float* __restrict__ cw, const float* __restrict__ ct,
    bf16* __restrict__ dl, float* __restrict__ db, long long n, int cin,
    int C) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float* Ws = reinterpret_cast<float*>(dsm);
  bf16* As = reinterpret_cast<bf16*>(Ws + cin * MAXC);
  __shared__ float dbs[MAXC];
  if (threadIdx.x < MAXC) dbs[threadIdx.x] = 0.f;
  const long long r0 = (long long)blockIdx.x * kCeRows;
  ce_stage<MAXC>(x, pro, w, Ws, As, r0, n, cin, C);

  const long long row = r0 + threadIdx.x;
  if (row < n) {
    float lg[MAXC];
    ce_logits<MAXC>(Ws, As, bias, cin, C, lg);
    float mx = lg[0];
#pragma unroll
    for (int c = 1; c < MAXC; ++c)
      if (c < C) mx = fmaxf(mx, lg[c]);
    float se = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        lg[c] = expf(lg[c] - mx);
        se += lg[c];
      }
    }
    const long long lab = labels[row];
    const float wr = (lab >= 0 && lab < C) ? cw[lab] : 0.f;
    const float s = __fmul_rn(ct[0], wr);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        const float d =
            __fmul_rn(s, __fsub_rn(__fdiv_rn(lg[c], se), c == lab ? 1.f : 0.f));
        dl[(size_t)row * C + c] = __float2bfloat16_rn(d);
        atomicAdd(&dbs[c], d);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < C) atomicAdd(&db[threadIdx.x], dbs[threadIdx.x]);
}

// --------------------------------------------------------------------------
// dropout
// --------------------------------------------------------------------------

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                               long long n, uint32_t key, uint32_t thr,
                               float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool keep = drop_bits(key, (uint64_t)i) >= thr;
    if constexpr (std::is_same<T, float>::value) {
      out[i] = keep ? __fmul_rn(x[i], scale) : 0.f;
    } else {
      const float s = round_bf16(scale);  // the scale in the input's dtype
      out[i] = __float2bfloat16_rn(
          keep ? __fmul_rn(__bfloat162float(x[i]), s) : 0.f);
    }
  }
}

// --------------------------------------------------------------------------
// BN-apply + ReLU + first-max global pool, and its write-only backward
// --------------------------------------------------------------------------

constexpr int kPoolThreads = 256;
constexpr int kPoolRows = 256;   // rows of one group that a block reduces

// V consecutive channels of one row as floats: one 16-byte load where
// V * sizeof(T) == 16, else one element
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* __restrict__ p,
                                          float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value)
      v[0] = p[0];
    else
      v[0] = __bfloat162float(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "f32 vectors are 4 wide");
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vals(T* __restrict__ p,
                                           const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value)
      p[0] = v[0];
    else
      p[0] = __float2bfloat16_rn(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

__global__ void pool_init_kernel(unsigned long long* __restrict__ keys,
                                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) keys[i] = pool_key(0.f, 0);
}

// grid (row tiles of a group, groups, channel slabs); a thread takes V
// channels of every rl-th row of the tile (cw threads across the slab,
// rl = 256 / cw down the rows), keeps the largest relu(z) of each and the
// first row reaching it, and the slab's lane 0 threads fold the rl lanes
// in shared memory and add one atomicMax key per channel.
template <typename T, int V>
__global__ void __launch_bounds__(kPoolThreads, 3) pool_fwd_kernel(
    const T* __restrict__ y, const float* __restrict__ mu,
    const float* __restrict__ inv, const float* __restrict__ gamma,
    const float* __restrict__ beta, unsigned long long* __restrict__ keys,
    long long rpb, int c, int cw) {
  __shared__ unsigned long long sk[kPoolThreads * V];
  const int tid = threadIdx.x, rl = kPoolThreads / cw;
  const int cl = tid % cw, lane = tid / cw;
  const int c0 = (blockIdx.z * cw + cl) * V;
  const long long b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * kPoolRows;
  const long long r1 = r0 + kPoolRows < rpb ? r0 + kPoolRows : rpb;
  float best[V];
  int row[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    best[j] = 0.f;
    row[j] = -1;
  }
  if (c0 < c) {
    float m[V], s[V], g[V], t[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mu[c0 + j];
      s[j] = inv[c0 + j];
      g[j] = gamma[c0 + j];
      t[j] = beta[c0 + j];
    }
    const T* base = y + (b * rpb) * c + c0;
#pragma unroll 4
    for (long long r = r0 + lane; r < r1; r += rl) {
      float v[V];
      load_vals<T, V>(base + r * c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // ((y - mu) * inv) * gamma + beta, each step rounded (no FMA)
        const float z = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[j], m[j]), s[j]), g[j]), t[j]);
        if (z > best[j]) {   // relu(z) > best >= 0; rows ascend: first wins
          best[j] = z;
          row[j] = (int)r;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    sk[(lane * cw + cl) * V + j] = row[j] < 0 ? 0ull : pool_key(best[j], row[j]);
  __syncthreads();
  if (lane != 0 || c0 >= c) return;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    unsigned long long k = sk[cl * V + j];
    for (int l = 1; l < rl; ++l) {
      const unsigned long long o = sk[(l * cw + cl) * V + j];
      k = o > k ? o : k;
    }
    if (k != 0ull) atomicMax(&keys[b * c + c0 + j], k);
  }
}

// dy[row, c] = val[b, c] at the winner row idx[b, c] of its group, else 0,
// in y's dtype; the forward's grid and thread layout, so a thread loads
// its V channels' winners and values once and writes its rows of the tile
template <typename T, int V>
__global__ void __launch_bounds__(kPoolThreads) pool_bwd_kernel(
    const int* __restrict__ idx, const float* __restrict__ val,
    T* __restrict__ dy, long long rpb, int c, int cw) {
  const int tid = threadIdx.x, rl = kPoolThreads / cw;
  const int cl = tid % cw, lane = tid / cw;
  const int c0 = (blockIdx.z * cw + cl) * V;
  if (c0 >= c) return;
  const long long b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * kPoolRows;
  const long long r1 = r0 + kPoolRows < rpb ? r0 + kPoolRows : rpb;
  int id[V];
  float vl[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    id[j] = idx[b * c + c0 + j];
    vl[j] = val[b * c + c0 + j];
  }
  T* base = dy + (b * rpb) * c + c0;
#pragma unroll 4
  for (long long r = r0 + lane; r < r1; r += rl) {
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = id[j] == (int)r ? vl[j] : 0.f;
    store_vals<T, V>(base + r * c, out);
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

Prologue make_prologue(const void* mu, const void* inv, const void* gamma,
                       const void* beta, int relu, int drop, uint32_t key,
                       uint32_t thr, float scale) {
  Prologue p;
  p.mu = static_cast<const float*>(mu);
  p.inv = static_cast<const float*>(inv);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.relu = relu;
  p.drop = drop;
  p.key = key;
  p.thr = thr;
  p.scale = scale;
  return p;
}

int cdiv_int(long long a, long long b) { return (int)((a + b - 1) / b); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the 16-byte staging path: both widths multiples of 8, aligned operands
bool use_vec(int cin, int cout, const void* a, const void* b) {
  return cin % 8 == 0 && cout % 8 == 0 && aligned16(a) && aligned16(b);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

template <bool VEC>
cudaError_t launch_fwd(const void* x, const Prologue& pro, const void* w,
                       const void* b, const void* row_bias, long long rpb,
                       void* y, int out_f32, void* s1, void* s2, long long n,
                       int cin, int cout, cudaStream_t s) {
  cudaError_t err = allow_smem(fwd_kernel<VEC>);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv_int(n, BM), cdiv_int(cout, BN));
  fwd_kernel<VEC><<<grid, kGemmThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), pro, static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(row_bias), rpb,
      y, out_f32, static_cast<float*>(s1), static_cast<float*>(s2), n, cin,
      cout);
  return cudaGetLastError();
}

cudaError_t forward(const void* x, const Prologue& pro, const void* w,
                    const void* b, const void* row_bias, long long rpb,
                    void* y, int out_f32, void* s1, void* s2, long long n,
                    int cin, int cout, cudaStream_t s) {
  if (use_vec(cin, cout, x, w))
    return launch_fwd<true>(x, pro, w, b, row_bias, rpb, y, out_f32, s1, s2,
                            n, cin, cout, s);
  return launch_fwd<false>(x, pro, w, b, row_bias, rpb, y, out_f32, s1, s2,
                           n, cin, cout, s);
}

template <bool VEC>
cudaError_t launch_backward(const void* x, const Prologue& pro,
                            const void* w, const bf16* dyb, void* dx,
                            void* dg, void* dbeta, void* dw, long long n,
                            int cin, int cout, cudaStream_t s) {
  cudaError_t err = allow_smem(dx_kernel<VEC>);
  if (err == cudaSuccess) err = allow_smem(dw_kernel<VEC>);
  if (err != cudaSuccess) return err;
  const dim3 gx(cdiv_int(n, BM), cdiv_int(cin, BN));
  dx_kernel<VEC><<<gx, kGemmThreads, kSmemBytes, s>>>(
      dyb, static_cast<const bf16*>(w), static_cast<const bf16*>(x), pro,
      static_cast<bf16*>(dx), static_cast<float*>(dg),
      static_cast<float*>(dbeta), n, cin, cout);
  // split the rows so that about three blocks per SM are in flight
  const long long tiles = (long long)cdiv_int(cin, BM) * cdiv_int(cout, BN);
  long long splits = (3 * 132 + tiles - 1) / tiles;
  const long long ktiles = (n + BK - 1) / BK;
  if (splits > ktiles) splits = ktiles;
  if (splits < 1) splits = 1;
  const long long chunk = ((ktiles + splits - 1) / splits) * BK;
  const dim3 gw(cdiv_int(cin, BM), cdiv_int(cout, BN), cdiv_int(n, chunk));
  dw_kernel<VEC><<<gw, kGemmThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), pro, dyb, static_cast<float*>(dw), n, cin,
      cout, chunk);
  return cudaGetLastError();
}

// dx and dW of one layer from the bf16 cotangent in dyb
cudaError_t layer_backward(const void* x, const Prologue& pro, const void* w,
                           const bf16* dyb, void* dx, void* dg, void* dbeta,
                           void* dw, long long n, int cin, int cout,
                           cudaStream_t s) {
  if (use_vec(cin, cout, x, w) && aligned16(dyb))
    return launch_backward<true>(x, pro, w, dyb, dx, dg, dbeta, dw, n, cin,
                                 cout, s);
  return launch_backward<false>(x, pro, w, dyb, dx, dg, dbeta, dw, n, cin,
                                cout, s);
}

void cotangent_grid(long long n, int cout, dim3* grid, int* cw) {
  *cw = cout < 256 ? cout : 256;
  *grid = dim3(cdiv_int(n, kRowsPerBlock), cdiv_int(cout, *cw));
}

template <int MAXC>
int ce_smem(int cin) {
  return cin * MAXC * 4 + kCeRows * (cin + 2) * 2;
}

template <int MAXC>
cudaError_t ce_launch(bool fwd, const void* x, const Prologue& pro,
                      const void* w, const void* b, const void* labels,
                      const void* cw, const void* ct, void* acc, void* dl,
                      void* db, long long n, int cin, int C,
                      cudaStream_t s) {
  const int smem = ce_smem<MAXC>(cin);
  cudaError_t err;
  if (fwd)
    err = cudaFuncSetAttribute(ce_fwd_kernel<MAXC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  else
    err = cudaFuncSetAttribute(ce_dlogits_kernel<MAXC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const int grid = cdiv_int(n, kCeRows);
  if (fwd)
    ce_fwd_kernel<MAXC><<<grid, kCeRows, smem, s>>>(
        static_cast<const bf16*>(x), pro, static_cast<const bf16*>(w),
        static_cast<const float*>(b), static_cast<const long long*>(labels),
        static_cast<const float*>(cw), static_cast<float*>(acc), n, cin, C);
  else
    ce_dlogits_kernel<MAXC><<<grid, kCeRows, smem, s>>>(
        static_cast<const bf16*>(x), pro, static_cast<const bf16*>(w),
        static_cast<const float*>(b), static_cast<const long long*>(labels),
        static_cast<const float*>(cw), static_cast<const float*>(ct),
        static_cast<bf16*>(dl), static_cast<float*>(db), n, cin, C);
  return cudaGetLastError();
}

cudaError_t ce_dispatch(bool fwd, const void* x, const Prologue& pro,
                        const void* w, const void* b, const void* labels,
                        const void* cw, const void* ct, void* acc, void* dl,
                        void* db, long long n, int cin, int C,
                        cudaStream_t s) {
  if (C <= 4)
    return ce_launch<4>(fwd, x, pro, w, b, labels, cw, ct, acc, dl, db, n,
                        cin, C, s);
  if (C <= 8)
    return ce_launch<8>(fwd, x, pro, w, b, labels, cw, ct, acc, dl, db, n,
                        cin, C, s);
  if (C <= 16)
    return ce_launch<16>(fwd, x, pro, w, b, labels, cw, ct, acc, dl, db, n,
                         cin, C, s);
  return ce_launch<32>(fwd, x, pro, w, b, labels, cw, ct, acc, dl, db, n,
                       cin, C, s);
}

// the pool kernels' grid: (row tiles of a group, groups, channel slabs of
// cw threads, a power of 2 <= 32, each taking V channels)
dim3 pool_grid(long long n, int c, long long rpb, int v, int* cw) {
  const int chunks = c / v;
  *cw = 1;
  while (*cw < chunks && *cw < 32) *cw <<= 1;
  return dim3(cdiv_int(rpb, kPoolRows), (unsigned)(n / rpb),
              cdiv_int(chunks, *cw));
}

template <typename T, int V>
cudaError_t launch_pool_fwd(const void* y, const void* mu, const void* inv,
                            const void* gamma, const void* beta, void* keys,
                            long long n, int c, long long rpb,
                            cudaStream_t s) {
  int cw;
  const dim3 grid = pool_grid(n, c, rpb, V, &cw);
  pool_fwd_kernel<T, V><<<grid, kPoolThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(mu),
      static_cast<const float*>(inv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta),
      static_cast<unsigned long long*>(keys), rpb, c, cw);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_pool_bwd(const void* idx, const void* val, void* dy,
                            long long n, int c, long long rpb,
                            cudaStream_t s) {
  int cw;
  const dim3 grid = pool_grid(n, c, rpb, V, &cw);
  pool_bwd_kernel<T, V><<<grid, kPoolThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val),
      static_cast<T*>(dy), rpb, c, cw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pcseg_dropout(const void* x, void* out, long long n, uint32_t key,
                  uint32_t thr, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (is_bf16)
    dropout_kernel<bf16><<<(int)blocks, 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), n, key, thr,
        scale);
  else
    dropout_kernel<float><<<(int)blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, key, thr,
        scale);
  return (int)cudaGetLastError();
}

int pcseg_fused_block_fwd(const void* x, const void* mu, const void* inv,
                          const void* gamma, const void* beta, const void* w,
                          const void* b, const void* row_bias, void* y,
                          void* s1, void* s2, long long n, int cin, int cout,
                          long long rpb, int relu, uint32_t key, uint32_t thr,
                          float scale, int drop, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Prologue pro =
      make_prologue(mu, inv, gamma, beta, relu, drop, key, thr, scale);
  return (int)forward(x, pro, w, b, row_bias, rpb, y, out_f32, s1, s2, n,
                      cin, cout, s);
}

int pcseg_fused_block_bwd(const void* x, const void* mu, const void* inv,
                          const void* gamma, const void* beta, const void* w,
                          const void* y, const void* dy, const void* ds1,
                          const void* ds2, void* dx, void* dw, void* db,
                          void* dg, void* dbeta, void* drb, void* scratch,
                          int dy_f32, long long n, int cin, int cout,
                          long long rpb, int relu, uint32_t key, uint32_t thr,
                          float scale, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Prologue pro =
      make_prologue(mu, inv, gamma, beta, relu, drop, key, thr, scale);
  dim3 grid;
  int cw;
  cotangent_grid(n, cout, &grid, &cw);
  bf16* dyb = static_cast<bf16*>(scratch);
  cotangent_kernel<<<grid, 256, 0, s>>>(
      dy, dy_f32, static_cast<const bf16*>(y), static_cast<const float*>(ds1),
      static_cast<const float*>(ds2), dyb,
      static_cast<float*>(db), static_cast<float*>(drb), rpb, n, cout, cw);
  return (int)layer_backward(x, pro, w, dyb, dx, dg, dbeta, dw, n, cin, cout,
                             s);
}

int pcseg_seg4_ce_fwd(const void* x, const void* mu, const void* inv,
                      const void* gamma, const void* beta, const void* w,
                      const void* b, const void* labels, const void* cw,
                      void* acc, long long n, int cin, int C, void* stream) {
  const Prologue pro = make_prologue(mu, inv, gamma, beta, 1, 0, 0, 0, 1.f);
  return (int)ce_dispatch(true, x, pro, w, b, labels, cw, nullptr, acc,
                          nullptr, nullptr, n, cin, C,
                          static_cast<cudaStream_t>(stream));
}

int pcseg_seg4_ce_bwd(const void* x, const void* mu, const void* inv,
                      const void* gamma, const void* beta, const void* w,
                      const void* b, const void* labels, const void* cw,
                      const void* ct, void* dx, void* dw, void* db, void* dg,
                      void* dbeta, void* scratch, long long n, int cin, int C,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Prologue pro = make_prologue(mu, inv, gamma, beta, 1, 0, 0, 0, 1.f);
  const cudaError_t err =
      ce_dispatch(false, x, pro, w, b, labels, cw, ct, nullptr, scratch, db,
                  n, cin, C, s);
  if (err != cudaSuccess) return (int)err;
  return (int)layer_backward(x, pro, w, static_cast<const bf16*>(scratch), dx,
                             dg, dbeta, dw, n, cin, C, s);
}

// y (N, C) bf16 (y_f32 0) or f32, N = B * rpb rows in contiguous groups;
// mu / inv / gamma / beta (C,) f32; keys (B, C) int64 scratch; g (B, C)
// f32 = max over the group of relu(((y - mu) * inv) * gamma + beta), idx
// (B, C) int32 = the first row of the group attaining it (0 where g = 0).
int pcseg_fused_pool_fwd(const void* y, int y_f32, const void* mu,
                         const void* inv, const void* gamma, const void* beta,
                         void* keys, void* g, void* idx, long long n, int c,
                         long long rpb, void* stream) {
  if (n <= 0 || c <= 0 || rpb <= 0 || n % rpb || n / rpb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (n / rpb) * c;
  pool_init_kernel<<<cdiv_int(total, 256), 256, 0, s>>>(
      static_cast<unsigned long long*>(keys), total);
  const bool vec = aligned16(y) && c % (y_f32 ? 4 : 8) == 0;
  cudaError_t err;
  if (y_f32)
    err = vec ? launch_pool_fwd<float, 4>(y, mu, inv, gamma, beta, keys, n,
                                          c, rpb, s)
              : launch_pool_fwd<float, 1>(y, mu, inv, gamma, beta, keys, n,
                                          c, rpb, s);
  else
    err = vec ? launch_pool_fwd<bf16, 8>(y, mu, inv, gamma, beta, keys, n, c,
                                         rpb, s)
              : launch_pool_fwd<bf16, 1>(y, mu, inv, gamma, beta, keys, n, c,
                                         rpb, s);
  if (err != cudaSuccess) return (int)err;
  pool_finalize_kernel<<<cdiv_int(total, 256), 256, 0, s>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(g),
      static_cast<int*>(idx), total);
  return (int)cudaGetLastError();
}

// idx (B, C) int32 winner rows, val (B, C) f32; dy (N, C) bf16 (dy_f32 0)
// or f32, written whole: val at each winner row, zeros elsewhere.
int pcseg_fused_pool_bwd(const void* idx, const void* val, void* dy,
                         int dy_f32, long long n, int c, long long rpb,
                         void* stream) {
  if (n <= 0 || c <= 0 || rpb <= 0 || n % rpb || n / rpb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(dy) && c % (dy_f32 ? 4 : 8) == 0;
  if (dy_f32)
    return (int)(vec ? launch_pool_bwd<float, 4>(idx, val, dy, n, c, rpb, s)
                     : launch_pool_bwd<float, 1>(idx, val, dy, n, c, rpb, s));
  return (int)(vec ? launch_pool_bwd<bf16, 8>(idx, val, dy, n, c, rpb, s)
                   : launch_pool_bwd<bf16, 1>(idx, val, dy, n, c, rpb, s));
}

}  // extern "C"
