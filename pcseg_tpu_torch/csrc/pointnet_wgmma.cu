// PointNet's global layer on Hopper (sm_90a): TMA + wgmma kernels for
// row 16 of PERF.md's table, forward and backward.
//
// Entries (plain C interface, loaded with ctypes; each returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue before
// any launch for a shape it does not take):
//
//   pcseg_gp_fwd / pcseg_gp_bwd   replace pcseg_tpu/ops/pallas/
//       fused_global.py fused_global_pool_block (_fwd_kernel, pallas_call
//       at :176; _bwd_kernel, pallas_call at :224): y = bf16(relu((x - mu)
//       * inv * gamma + beta)) @ W + b, the column sums s1, s2 of the f32
//       y, and per (batch row, channel) the max of sign * bf16(y) with its
//       first row; backward d = bf16((ds1 + 2 y ds2) + [row == idx] pval),
//       then dx, dW, db and the gamma/beta-like column sums.
//
// Shapes: x (N, Cin) bf16 and W (Cin, Cout) with Cin and Cout multiples of
// 64 (the wrapper raises ValueError for any other width before a launch);
// any N (partial tiles are masked: TMA fills rows past N with zeros, the
// epilogues skip them); rows_per_batch any divisor of N.
//
// Rounding points are the TPU kernel's: the prologue in f32 without FMA
// contraction (__fsub_rn / __fmul_rn / __fadd_rn), rounded to bf16 before
// the product; f32 accumulation; the bias added in f32; s1, s2 from the
// f32 y; the pool compares bf16(y) * sign, first row on ties (keys start
// at 0, so a sign-0 channel pools to row 0); the backward's d rounded to
// bf16 for both products, dW, db, dgamma, dbeta in f32.
//
// What bounds it on an H100 (B64 x 2048 points, N = 131,072 rows, 1024 ->
// 1024): operations, 2.75e11 flop forward (0.278 ms at 989 TFLOP/s)
// against 0.54 GB of traffic (0.16 ms), 5.5e11 backward (0.556 ms). Every
// product is therefore wgmma m64n256k16 (bf16, f32 accumulators in
// registers) on a tile of 128 rows x 256 columns a block: two consumer
// warpgroups of 64 rows each, and a producer warpgroup whose first thread
// keeps a ring of shared-memory stages full by TMA (K steps 64 deep,
// 128-byte swizzle, a "full" and an "empty" mbarrier a stage; hopper.cuh).
//   forward   ring of 4 stages (x tile, W tile, the step's 64 channels'
//             mu / inv / gamma / beta). A consumer ldmatrix's its x rows,
//             applies the prologue in registers and runs wgmma with A in
//             registers (RS) and W in shared memory (MN-major: the
//             transpose bit), building the next step's fragments while
//             this step's four wgmmas run. Epilogue: the accumulators to
//             an f32 tile over the ring, then a thread walks two columns
//             over its warpgroup's 64 rows: bias, y stored straight to
//             device memory (128 bytes a warp and row), s1 / s2, and the
//             first max of bf16(y) * sign per run of one batch row,
//             flushed as one 64-bit atomicMax key per (batch row,
//             column); then pool_finalize_kernel decodes the keys
//             (pool_keys.cuh).
//   backward  gp_cotangent_kernel, bound by bytes: reads y, writes d in
//             bf16 and db, 16 bytes a thread and 4 rows in flight.
//             gp_wgmma_dx_kernel, dx = d @ W^T, both operands in shared
//             memory (SS, ring of 3 stages), the block's x tile loaded by
//             TMA once the ring's first fill is out; its epilogue walks
//             the rows as the forward's does: the prologue again for the
//             ReLU mask and x_hat, dx = dz * gamma * inv and a = relu(z)
//             (the forward's A, in bf16) to device memory, dgamma / dbeta
//             summed. gp_wgmma_dw_kernel, dW = a^T @ d, SS with both
//             operands MN-major (the transpose bits), the rows (K) split
//             so that the blocks fill the SMs once, the split partials
//             added into dW with f32 atomics (red): their order changes
//             from run to run. Rows past N are zero in a (TMA's fill),
//             not relu(beta - mu * inv * gamma): they add nothing to dW.
// What holds them above their bound on the card (PERF.md, row 16;
// profile_row16.py times each phase of a tile): the forward's prologue in
// the consumers and each tile's epilogue and first TMA wait; dx's
// epilogue and first wait.

#include "hopper.cuh"
#include "pool_keys.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // K step: one 128-byte swizzled row of bf16
constexpr int kBM = 128;         // tile rows: two consumer warpgroups of 64
constexpr int kBN = 256;         // tile columns: one m64n256k16 wgmma
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = 384;    // + the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBarConsumers = 1;  // named barrier of the consumer threads

// forward ring stage: x [128 rows][64 k], W [64 k][256 n] (four boxes,
// MN-major), and the 64 channels' mu, inv, gamma and beta
constexpr int kFwdStages = 4;
constexpr int kFwdX = kBM * kBK * 2;
constexpr int kFwdW = kBN * kBK * 2;
constexpr int kFwdStage = kFwdX + kFwdW + 4 * kBK * 4;
constexpr int kFwdRing = kFwdStages * kFwdStage;
constexpr int kFwdSmem = 1024 + kFwdRing + 2 * kFwdStages * 8;

// epilogues: the f32 accumulator tile [128][kLdF] over the ring (the row
// pad makes the accumulator stores conflict-free)
constexpr int kLdF = kBN + 8;
constexpr int kFtileBytes = kBM * kLdF * 4;

// dx ring stage: d [128 rows][64 k], W [256 cin][64 k]; then the block's
// x tile [128 rows][256 cin] (four boxes)
constexpr int kDxStages = 3;
constexpr int kDxA = kBM * kBK * 2;
constexpr int kDxStage = kDxA + kBN * kBK * 2;
constexpr int kDxRing = kDxStages * kDxStage;
constexpr int kDxX = kBM * kBN * 2;
constexpr int kDxSmem = 1024 + kDxRing + kDxX + (2 * kDxStages + 1) * 8;
static_assert(kFtileBytes <= kFwdRing, "forward epilogue");
static_assert(kFtileBytes <= kDxRing, "dx epilogue");

// dW ring stage: a [64 rows][128 cin] (two boxes), d [64 rows][256 cout]
// (four boxes)
constexpr int kDwStages = 4;
constexpr int kDwA = kBK * kBM * 2;
constexpr int kDwStage = kDwA + kBK * kBN * 2;
constexpr int kDwSmem = 1024 + kDwStages * kDwStage + 2 * kDwStages * 8;

constexpr int kCotRows = 512;  // rows of a cotangent block

// the prologue at one element: relu(((x - mu) * inv) * gamma + beta)
__device__ __forceinline__ float pro1(float x, float mu, float inv, float g,
                                      float b) {
  const float xh = __fmul_rn(__fsub_rn(x, mu), inv);
  return fmaxf(__fadd_rn(__fmul_rn(xh, g), b), 0.f);
}

// the accumulators of consumer warpgroup wg to an f32 tile [128][kLdF]:
// acc[4 j + 2 h + e] is row 64 wg + 16 warp + g + 8 h, column 8 j + 2 t + e
__device__ __forceinline__ void store_acc(float* tile, const float (&acc)[128],
                                          int wg, int warp, int lane) {
  const int r = 64 * wg + 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r + 8 * h) * kLdF + 8 * j + c) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// one forward K step of a consumer warpgroup: wait for the stage, build the
// four A fragments (ldmatrix of the x tile, the prologue with the stage's
// vectors, bf16), issue the four wgmmas as one group, then release the
// previous step's stage once its group has completed
__device__ __forceinline__ void fwd_step(float (&acc)[128], uint32_t (&f)[4][4],
                                         uint8_t* smem, uint64_t* full,
                                         uint64_t* empty, int ks, int wg,
                                         int warp, int lane) {
  const int s = ks % kFwdStages;
  mbar_wait(&full[s], (ks / kFwdStages) & 1);
  const uint8_t* st = smem + s * kFwdStage;
  const float* v = reinterpret_cast<const float*>(st + kFwdX + kFwdW);
  // ldmatrix: lanes 0-7 / 8-15 address rows 0-7 / 8-15 of the warp's 16
  // at the slice's first 8 columns, lanes 16-31 at its last 8: r[0..3]
  // are then the A fragment of m64n256k16
  const int arow = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t xrow = smem_u32(st) + arow * 128;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t r[4];
    ldsm_x4(r, xrow + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // r[0], r[1]: columns c, c + 1
      const int c = 16 * kk + 2 * (lane & 3) + 8 * hh;
      const float2 mu = *reinterpret_cast<const float2*>(v + c);
      const float2 iv = *reinterpret_cast<const float2*>(v + kBK + c);
      const float2 ga = *reinterpret_cast<const float2*>(v + 2 * kBK + c);
      const float2 be = *reinterpret_cast<const float2*>(v + 3 * kBK + c);
#pragma unroll
      for (int i = 2 * hh; i < 2 * hh + 2; ++i)
        f[kk][i] = pack_bf16x2(pro1(bf16_lo(r[i]), mu.x, iv.x, ga.x, be.x),
                               pro1(bf16_hi(r[i]), mu.y, iv.y, ga.y, be.y));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<1>(acc, f[kk],
                desc_sw128(st + kFwdX + kk * 2048, kBK * 128, 1024),
                (ks | kk) != 0);
  wgmma_commit();
  wgmma_wait<1>();
  if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % kFwdStages]);
}

// the forward epilogue of two adjacent columns over a run of rows: the
// bias, y in bf16 to device memory, s1 and s2, and the first max of sign
// * bf16(y) within the current batch row
struct FwdWalk {
  float2 bias, sign, a1, a2, best;
  int2 best_r;

  __device__ __forceinline__ FwdWalk(float2 b, float2 s, int rin)
      : bias(b), sign(s), a1({0.f, 0.f}), a2({0.f, 0.f}) {
    open(rin);
  }

  // a new batch row starting at its row rin: -inf at rin, so the first row
  // wins every tie, -inf included
  __device__ __forceinline__ void open(int rin) {
    best = make_float2(-INFINITY, -INFINITY);
    best_r = make_int2(rin, rin);
  }

  __device__ __forceinline__ void row(float2 acc, int rin, bf16* y) {
    const float vx = acc.x + bias.x, vy = acc.y + bias.y;
    a1.x += vx;
    a1.y += vy;
    a2.x += vx * vx;
    a2.y += vy * vy;
    const uint32_t yb = pack_bf16x2(vx, vy);
    *reinterpret_cast<uint32_t*>(y) = yb;
    const float sx = bf16_lo(yb) * sign.x, sy = bf16_hi(yb) * sign.y;
    const bool tx = sx > best.x, ty = sy > best.y;  // selects, no branches
    best.x = tx ? sx : best.x;
    best_r.x = tx ? rin : best_r.x;
    best.y = ty ? sy : best.y;
    best_r.y = ty ? rin : best_r.y;
  }

  __device__ __forceinline__ void flush(unsigned long long* keys) const {
    atomicMax(keys, pool_key(best.x, best_r.x));
    atomicMax(keys + 1, pool_key(best.y, best_r.y));
  }
};

struct FwdArgs {
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* bias;
  const float* sign;
  bf16* y;
  float* s1;
  float* s2;
  unsigned long long* keys;
  long long rpb;
  long long n;
  int cin;
  int cout;
  int col_tiles;
};

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) gp_wgmma_fwd_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w, const FwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFwdRing);
  uint64_t* empty = full + kFwdStages;

  const int tid = threadIdx.x;
  const long long m0 = (long long)(blockIdx.x / p.col_tiles) * kBM;
  const int n0 = (blockIdx.x % p.col_tiles) * kBN;
  const int ksteps = p.cin / kBK;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % kFwdStages;
        if (ks >= kFwdStages) mbar_wait(&empty[s], (ks / kFwdStages - 1) & 1);
        uint8_t* st = smem + s * kFwdStage;
        float* v = reinterpret_cast<float*>(st + kFwdX + kFwdW);
        const int k0 = ks * kBK;
        mbar_expect_tx(&full[s], kFwdStage);
        tma_load(st, &map_x, &full[s], k0, (int)m0);
        for (int i = 0; i < kBN / 64; ++i)
          tma_load(st + kFwdX + i * kBK * 128, &map_w, &full[s], n0 + 64 * i,
                   k0);
        bulk_load(v, p.mu + k0, kBK * 4, &full[s]);
        bulk_load(v + kBK, p.inv + k0, kBK * 4, &full[s]);
        bulk_load(v + 2 * kBK, p.gamma + k0, kBK * 4, &full[s]);
        bulk_load(v + 3 * kBK, p.beta + k0, kBK * 4, &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[128];  // the first wgmma starts the sum (scale_d = 0)

  // two sets of a K step's four A fragments: the next step's are built
  // while the wgmmas of this one run (every path writes fa, then fb: a
  // path that rewrote a set whose wgmmas may be in flight would make
  // ptxas serialize them, C7513)
  uint32_t fa[4][4], fb[4][4];
  int ks = 0;
  for (; ks + 1 < ksteps; ks += 2) {
    fwd_step(acc, fa, smem, full, empty, ks, wg, warp, lane);
    fwd_step(acc, fb, smem, full, empty, ks + 1, wg, warp, lane);
  }
  if (ks < ksteps) fwd_step(acc, fa, smem, full, empty, ks, wg, warp, lane);
  wgmma_wait<0>();
  fence_acc(acc);
  bar_sync(kBarConsumers, kConsumers);  // the ring is free for the epilogue

  // ---- epilogue: the accumulators to an f32 tile over the ring; then a
  // thread walks two adjacent columns over its warpgroup's 64 rows (rolled
  // loops: an epilogue unrolled over a thread's 128 accumulators overflows
  // the instruction cache), storing y straight to device memory (a warp
  // writes 64 adjacent columns of a row: 128 bytes)
  float* ftile = reinterpret_cast<float*>(smem);
  store_acc(ftile, acc, wg, warp, lane);
  bar_sync(2 + wg, 128);  // the warpgroup's 64 rows are in the tile
  const int c = 2 * (tid & 127), col = n0 + c;
  const long long r0 = m0 + 64 * wg;  // the warpgroup's first row
  const int rows = (int)(p.n - r0 < 64 ? p.n - r0 : 64);
  if (col >= p.cout || rows <= 0) return;  // past the last column or row
  long long b = r0 / p.rpb;
  int rin = (int)(r0 - b * p.rpb);  // the row's place in its batch row
  FwdWalk w(*reinterpret_cast<const float2*>(p.bias + col),
            *reinterpret_cast<const float2*>(p.sign + col), rin);
  const float* src = ftile + 64 * wg * kLdF + c;
  bf16* dst = p.y + r0 * p.cout + col;
  for (int r = 0; r < rows; r += 8) {
    if (r + 8 <= rows && rin + 8 <= p.rpb) {
      // 8 rows of one batch row: the loads ahead of the stores
      float2 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = *reinterpret_cast<const float2*>(src + (r + u) * kLdF);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        w.row(a[u], rin + u, dst + (long long)(r + u) * p.cout);
      rin += 8;
    } else {  // a batch boundary or the tile's last rows: row by row
      for (int u = r; u < r + 8 && u < rows; ++u, ++rin) {
        if (rin == p.rpb) {
          w.flush(p.keys + b * p.cout + col);
          ++b;
          rin = 0;
          w.open(0);
        }
        w.row(*reinterpret_cast<const float2*>(src + u * kLdF), rin,
              dst + (long long)u * p.cout);
      }
    }
  }
  w.flush(p.keys + b * p.cout + col);
  atomicAdd(&p.s1[col], w.a1.x);
  atomicAdd(&p.s1[col + 1], w.a1.y);
  atomicAdd(&p.s2[col], w.a2.x);
  atomicAdd(&p.s2[col + 1], w.a2.y);
}

// --------------------------------------------------------------------------
// backward 1: d = bf16((ds1 + 2 y ds2) + [row == idx] pval) and db
// --------------------------------------------------------------------------

// 256 threads: 32 groups of 8 channels x 8 row lanes, kCotRows rows
__global__ void __launch_bounds__(256) gp_cotangent_kernel(
    const bf16* __restrict__ y, const float* __restrict__ ds1,
    const float* __restrict__ ds2, const float* __restrict__ pval,
    const int* __restrict__ idx, bf16* __restrict__ d, float* __restrict__ db,
    long long rpb, long long n, int cout) {
  __shared__ float red[8][256];
  const int tid = threadIdx.x, cg = tid & 31, rl = tid >> 5;
  const int c0 = blockIdx.y * 256 + cg * 8;
  const long long r0 = (long long)blockIdx.x * kCotRows;
  const long long r1 = r0 + kCotRows < n ? r0 + kCotRows : n;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (c0 < cout) {
    float d1[8], d2[8], pv[8];
    int id[8];
    *reinterpret_cast<float4*>(d1) = *reinterpret_cast<const float4*>(ds1 + c0);
    *reinterpret_cast<float4*>(d1 + 4) =
        *reinterpret_cast<const float4*>(ds1 + c0 + 4);
    *reinterpret_cast<float4*>(d2) = *reinterpret_cast<const float4*>(ds2 + c0);
    *reinterpret_cast<float4*>(d2 + 4) =
        *reinterpret_cast<const float4*>(ds2 + c0 + 4);
    long long b = -1, bstart = 0, bend = 0;
    // 4 rows a trip (a warp's rows are one row: uniform branches), their
    // loads ahead of the arithmetic, so that 4 are in flight
    for (long long r = r0 + rl; r < r1; r += 32) {
      uint4 yv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long ru = r + 8 * u;
        yv[u] = ru < r1 ? *reinterpret_cast<const uint4*>(
                              y + (size_t)ru * cout + c0)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long ru = r + 8 * u;
        if (ru >= r1) break;
        if (ru >= bend) {  // a new batch row: its winners and values
          b = ru / rpb;
          bstart = b * rpb;
          bend = bstart + rpb;
          const size_t o = (size_t)b * cout + c0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            id[i] = idx[o + i];
            pv[i] = pval[o + i];
          }
        }
        const int rr = (int)(ru - bstart);
        const uint32_t* yw = &yv[u].x;
        uint32_t out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[2] = {bf16_lo(yw[i]), bf16_hi(yw[i])};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * i + e;
            float dv =
                __fadd_rn(d1[k], __fmul_rn(__fmul_rn(2.f, v[e]), d2[k]));
            dv = __fadd_rn(dv, id[k] == rr ? pv[k] : 0.f);
            acc[k] += dv;
            v[e] = dv;
          }
          out[i] = pack_bf16x2(v[0], v[1]);
        }
        *reinterpret_cast<uint4*>(d + (size_t)ru * cout + c0) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rl][cg * 8 + i] = acc[i];
  __syncthreads();
  const int c = blockIdx.y * 256 + tid;
  if (c < cout) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += red[i][tid];
    atomicAdd(&db[c], s);
  }
}

// --------------------------------------------------------------------------
// backward 2: dx = (d @ W^T) * relu'(z) * gamma * inv; dgamma, dbeta
// --------------------------------------------------------------------------

// the dx epilogue of two adjacent input channels: the prologue of x again
// for the ReLU mask and x_hat; dx = dz * gamma * inv and a = relu(z) (the
// forward's A, for dW) in bf16 to device memory; the dgamma / dbeta sums
struct DxWalk {
  float2 mu, inv, gamma, beta, sg, sb;

  __device__ __forceinline__ DxWalk(float2 m, float2 i, float2 g, float2 b)
      : mu(m), inv(i), gamma(g), beta(b), sg({0.f, 0.f}), sb({0.f, 0.f}) {}

  // dx of one element; a = relu(z), the forward's prologue output
  __device__ __forceinline__ float one(float x, float da, float m, float i,
                                       float g, float b, float& s_g,
                                       float& s_b, float& a) const {
    const float xh = __fmul_rn(__fsub_rn(x, m), i);
    const float z = __fadd_rn(__fmul_rn(xh, g), b);
    const float dz = __fmul_rn(da, z > 0.f ? 1.f : 0.f);
    s_g += __fmul_rn(dz, xh);
    s_b += dz;
    a = fmaxf(z, 0.f);
    return __fmul_rn(__fmul_rn(dz, g), i);
  }

  __device__ __forceinline__ void row(uint32_t x, float2 da, bf16* dx,
                                      bf16* a) {
    float a_lo, a_hi;
    const float lo = one(bf16_lo(x), da.x, mu.x, inv.x, gamma.x, beta.x,
                         sg.x, sb.x, a_lo);
    const float hi = one(bf16_hi(x), da.y, mu.y, inv.y, gamma.y, beta.y,
                         sg.y, sb.y, a_hi);
    *reinterpret_cast<uint32_t*>(dx) = pack_bf16x2(lo, hi);
    *reinterpret_cast<uint32_t*>(a) = pack_bf16x2(a_lo, a_hi);
  }
};

struct BwdArgs {
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  bf16* dx;
  bf16* a;  // (N, Cin): the forward's prologue output, for dW
  float* dg;
  float* dbeta;
  float* dw;
  long long n;
  int cin;
  int cout;
  int col_tiles;
  int row_tiles;
  int ksteps;  // dW: K steps of one split
};

__global__ void __launch_bounds__(kThreads, 1) gp_wgmma_dx_kernel(
    const __grid_constant__ CUtensorMap map_d,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_x, const BwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* xtile = smem + kDxRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(xtile + kDxX);
  uint64_t* empty = full + kDxStages;
  uint64_t* xbar = empty + kDxStages;

  const int tid = threadIdx.x;
  const long long m0 = (long long)(blockIdx.x / p.col_tiles) * kBM;
  const int n0 = (blockIdx.x % p.col_tiles) * kBN;  // over Cin
  const int ksteps = p.cout / kBK;

  if (tid == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(xbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % kDxStages;
        if (ks == kDxStages || (ks == ksteps - 1 && ks < kDxStages)) {
          // the x tile of the epilogue, once the ring's first fill is out
          mbar_expect_tx(xbar, kDxX);
          for (int i = 0; i < kBN / 64; ++i)
            tma_load(xtile + i * kBM * 128, &map_x, xbar, n0 + 64 * i,
                     (int)m0);
        }
        if (ks >= kDxStages) mbar_wait(&empty[s], (ks / kDxStages - 1) & 1);
        uint8_t* st = smem + s * kDxStage;
        mbar_expect_tx(&full[s], kDxStage);
        tma_load(st, &map_d, &full[s], ks * kBK, (int)m0);
        tma_load(st + kDxA, &map_w, &full[s], ks * kBK, n0);
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[128];  // the first wgmma starts the sum (scale_d = 0)
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % kDxStages;
    mbar_wait(&full[s], (ks / kDxStages) & 1);
    const uint8_t* st = smem + s * kDxStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss<0, 0>(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                  desc_sw128(st + kDxA + kk * 32, 16, 1024), (ks | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % kDxStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  bar_sync(kBarConsumers, kConsumers);  // the ring is free for the epilogue

  // epilogue: dL/da to an f32 tile over the ring; then a thread walks two
  // adjacent input channels over its warpgroup's 64 rows: the prologue
  // again for the ReLU mask, dx = dz * gamma * inv straight to device
  // memory (128 bytes a warp and row), dgamma and dbeta summed
  float* ftile = reinterpret_cast<float*>(smem);
  store_acc(ftile, acc, wg, warp, lane);
  mbar_wait(xbar, 0);
  bar_sync(2 + wg, 128);  // the warpgroup's 64 rows are in the tile
  const int c = 2 * (tid & 127), col = n0 + c;
  const long long r0 = m0 + 64 * wg;
  const int rows = (int)(p.n - r0 < 64 ? p.n - r0 : 64);
  if (col >= p.cin || rows <= 0) return;  // past the last channel or row
  DxWalk w(*reinterpret_cast<const float2*>(p.mu + col),
           *reinterpret_cast<const float2*>(p.inv + col),
           *reinterpret_cast<const float2*>(p.gamma + col),
           *reinterpret_cast<const float2*>(p.beta + col));
  const float* src = ftile + 64 * wg * kLdF + c;
  // x (r, c .. c + 1) of the swizzled tile: row r's 16-byte chunk of c is
  // chunk ^ (r & 7), and the warpgroup's rows start at a multiple of 8
  const uint8_t* xs = xtile + (c >> 6) * kBM * 128 + 64 * wg * 128 + (c & 7) * 2;
  const int chunk = (c >> 3) & 7;
  bf16* dst = p.dx + r0 * p.cin + col;
  bf16* adst = p.a + r0 * p.cin + col;
  for (int r = 0; r < rows; r += 8) {
    if (r + 8 <= rows) {  // the loads of 8 rows ahead of their stores
      uint32_t xv[8];
      float2 da[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        xv[u] = *reinterpret_cast<const uint32_t*>(xs + (r + u) * 128 +
                                                   ((chunk ^ u) << 4));
        da[u] = *reinterpret_cast<const float2*>(src + (r + u) * kLdF);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        w.row(xv[u], da[u], dst + (long long)(r + u) * p.cin,
              adst + (long long)(r + u) * p.cin);
    } else {
      for (int u = r; u < rows; ++u)
        w.row(*reinterpret_cast<const uint32_t*>(xs + u * 128 +
                                                 ((chunk ^ (u & 7)) << 4)),
              *reinterpret_cast<const float2*>(src + u * kLdF),
              dst + (long long)u * p.cin, adst + (long long)u * p.cin);
    }
  }
  atomicAdd(&p.dg[col], w.sg.x);
  atomicAdd(&p.dg[col + 1], w.sg.y);
  atomicAdd(&p.dbeta[col], w.sb.x);
  atomicAdd(&p.dbeta[col + 1], w.sb.y);
}

// --------------------------------------------------------------------------
// backward 3: dW += prologue(x)^T @ d over one split of the rows
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) gp_wgmma_dw_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_d, const BwdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStage);
  uint64_t* empty = full + kDwStages;

  const int tid = threadIdx.x;
  const int tiles = p.row_tiles * p.col_tiles;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = (tile / p.col_tiles) * kBM;  // over Cin
  const int n0 = (tile % p.col_tiles) * kBN;  // over Cout
  const long long total = (p.n + kBK - 1) / kBK;
  const long long k_begin = (long long)split * p.ksteps;
  const long long k_end =
      k_begin + p.ksteps < total ? k_begin + p.ksteps : total;
  const int ksteps = (int)(k_end - k_begin);

  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int s = ks % kDwStages;
        if (ks >= kDwStages) mbar_wait(&empty[s], (ks / kDwStages - 1) & 1);
        uint8_t* st = smem + s * kDwStage;
        const int r = (int)((k_begin + ks) * kBK);
        mbar_expect_tx(&full[s], kDwStage);
        for (int i = 0; i < kBM / 64; ++i)
          tma_load(st + i * kBK * 128, &map_a, &full[s], m0 + 64 * i, r);
        for (int i = 0; i < kBN / 64; ++i)
          tma_load(st + kDwA + i * kBK * 128, &map_d, &full[s], n0 + 64 * i, r);
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[128];  // the first wgmma starts the sum (scale_d = 0)
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % kDwStages;
    mbar_wait(&full[s], (ks / kDwStages) & 1);
    const uint8_t* st = smem + s * kDwStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss<1, 1>(
          acc, desc_sw128(st + wg * kBK * 128 + kk * 2048, kBK * 128, 1024),
          desc_sw128(st + kDwA + kk * 2048, kBK * 128, 1024), (ks | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % kDwStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (ksteps <= 0) return;
  // acc[4 j + 2 h + e]: input channel 16 warp + g + 8 h of the warpgroup's
  // 64, output channel 8 j + 2 t + e
  const int ch0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = ch0 + 8 * h, c = c0 + 8 * j;
      if (ch < p.cin && c < p.cout) {
        float* o = p.dw + (size_t)ch * p.cout + c;
        atomicAdd(o, acc[4 * j + 2 * h]);
        atomicAdd(o + 1, acc[4 * j + 2 * h + 1]);
      }
    }
}

int cdiv_int(long long a, long long b) { return (int)((a + b - 1) / b); }

bool widths_ok(long long n, int cin, int cout, long long rpb) {
  return n > 0 && cin > 0 && cout > 0 && cin % 64 == 0 && cout % 64 == 0 &&
         rpb > 0 && n % rpb == 0 && n < (1ll << 31);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// x (N, Cin) bf16; mu, inv, gamma, beta (Cin,) f32; w (Cin, Cout) bf16;
// b, sign (Cout,) f32; y
// (N, Cout) bf16; s1, s2 (Cout,) f32 and keys (B, Cout) int64, zeroed by
// the caller; best (B, Cout) f32, idx (B, Cout) int32.
int pcseg_gp_fwd(const void* x, const void* mu, const void* inv,
                 const void* gamma, const void* beta, const void* w,
                 const void* b, const void* sign, void* y, void* s1, void* s2,
                 void* keys, void* best, void* idx, long long n, int cin,
                 int cout, long long rpb, void* stream) {
  if (!widths_ok(n, cin, cout, rpb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mw;
  if (!hopper_host::map_bf16(&mx, x, n, cin, kBM) ||
      !hopper_host::map_bf16(&mw, w, cin, cout, kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gp_wgmma_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.mu = static_cast<const float*>(mu);
  a.inv = static_cast<const float*>(inv);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.bias = static_cast<const float*>(b);
  a.sign = static_cast<const float*>(sign);
  a.y = static_cast<bf16*>(y);
  a.s1 = static_cast<float*>(s1);
  a.s2 = static_cast<float*>(s2);
  a.keys = static_cast<unsigned long long*>(keys);
  a.rpb = rpb;
  a.n = n;
  a.cin = cin;
  a.cout = cout;
  a.col_tiles = cdiv_int(cout, kBN);
  const int grid = a.col_tiles * cdiv_int(n, kBM);
  gp_wgmma_fwd_kernel<<<grid, kThreads, kFwdSmem, s>>>(mx, mw, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (n / rpb) * cout;
  pool_finalize_kernel<<<cdiv_int(total, 256), 256, 0, s>>>(
      static_cast<const unsigned long long*>(keys), static_cast<float*>(best),
      static_cast<int*>(idx), total);
  return (int)cudaGetLastError();
}

// w (Cin, Cout) bf16; y (N, Cout) bf16; ds1, ds2 (Cout,) f32; pval (B,
// Cout) f32; idx (B, Cout) int32; dx (N, Cin) bf16; dw (Cin, Cout), db
// (Cout,), dg and dbeta (Cin,) f32, zeroed by the caller; scratch (N,
// Cout) bf16 for d and a_scratch (N, Cin) bf16 for the prologue output a.
int pcseg_gp_bwd(const void* x, const void* mu, const void* inv,
                 const void* gamma, const void* beta, const void* w,
                 const void* y, const void* ds1, const void* ds2,
                 const void* pval, const void* idx, void* dx, void* dw,
                 void* db, void* dg, void* dbeta, void* scratch,
                 void* a_scratch, long long n, int cin, int cout,
                 long long rpb, void* stream) {
  if (!widths_ok(n, cin, cout, rpb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap md, mw, mx, ma, md2;
  if (!hopper_host::map_bf16(&md, scratch, n, cout, kBM) ||
      !hopper_host::map_bf16(&mw, w, cin, cout, kBN) ||
      !hopper_host::map_bf16(&mx, x, n, cin, kBM) ||
      !hopper_host::map_bf16(&ma, a_scratch, n, cin, kBK) ||
      !hopper_host::map_bf16(&md2, scratch, n, cout, kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gp_wgmma_dx_kernel, kDxSmem);
  if (err == cudaSuccess) err = allow_smem(gp_wgmma_dw_kernel, kDwSmem);
  if (err != cudaSuccess) return (int)err;

  gp_cotangent_kernel<<<dim3(cdiv_int(n, kCotRows), cdiv_int(cout, 256)), 256,
                        0, s>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(ds1),
      static_cast<const float*>(ds2), static_cast<const float*>(pval),
      static_cast<const int*>(idx), static_cast<bf16*>(scratch),
      static_cast<float*>(db), rpb, n, cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  BwdArgs a;
  a.mu = static_cast<const float*>(mu);
  a.inv = static_cast<const float*>(inv);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.dx = static_cast<bf16*>(dx);
  a.a = static_cast<bf16*>(a_scratch);
  a.dg = static_cast<float*>(dg);
  a.dbeta = static_cast<float*>(dbeta);
  a.dw = static_cast<float*>(dw);
  a.n = n;
  a.cin = cin;
  a.cout = cout;
  a.col_tiles = cdiv_int(cin, kBN);
  a.row_tiles = cdiv_int(n, kBM);
  a.ksteps = 0;
  gp_wgmma_dx_kernel<<<a.col_tiles * a.row_tiles, kThreads, kDxSmem, s>>>(
      md, mw, mx, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // dW: (Cin / 128) x (Cout / 256) tiles, the rows split so that the
  // blocks fill the SMs once (at most one block an SM fits)
  a.row_tiles = cdiv_int(cin, kBM);
  a.col_tiles = cdiv_int(cout, kBN);
  const int tiles = a.row_tiles * a.col_tiles;
  const long long total = (n + kBK - 1) / kBK;
  long long splits = hopper_host::sm_count() / tiles;
  if (splits < 1) splits = 1;
  if (splits > total) splits = total;
  a.ksteps = (int)((total + splits - 1) / splits);
  splits = (total + a.ksteps - 1) / a.ksteps;
  gp_wgmma_dw_kernel<<<(int)(tiles * splits), kThreads, kDwSmem, s>>>(ma, md2,
                                                                     a);
  return (int)cudaGetLastError();
}

}  // extern "C"
