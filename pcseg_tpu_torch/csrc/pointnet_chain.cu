// PointNet's chain layers and its classifier + cross-entropy on Hopper
// (sm_90a): rows 15 and 17 of PERF.md's table, forward and backward.
//
// Entries (plain C interface, loaded with ctypes; each returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue before
// any launch for a shape it does not take):
//
//   pcseg_chain_fwd / pcseg_chain_bwd   replace pcseg_tpu/ops/pallas/
//       fused_block.py fused_block (_fwd_pallas, pallas_call at :239;
//       _bwd_pallas at :451): y = bf16(dropout(relu((x - mu) * inv *
//       gamma + beta))) @ W + b [+ row_bias], s1 / s2 of the f32 y; the
//       backward d = bf16((dy + ds1) + 2 y ds2), dx, dW, db, the gamma /
//       beta-like sums and d(row_bias).
//   pcseg_seg4_ce_fwd / _bwd            replace fused_ce.py fused_seg4_ce
//       (:264, :294): seg3's prologue, the 128 x C classifier and the
//       weighted CE sums (num, den, correct); the backward's dlogits =
//       bf16(ct w[y] (softmax - onehot)), then dx, dW, db, dgamma, dbeta.
//       The logits are never stored, and no (N, C) scratch is written.
//
// Rounding points are the TPU kernels': the prologue in f32 without FMA
// contraction (__fsub_rn / __fmul_rn / __fadd_rn), rounded to bf16 before
// the product; products summed in f32; the bias, then the row bias, added
// in f32; s1, s2 from the f32 y; the backward's cotangent (dy + ds1) + 2 y
// ds2 rounded to bf16 for both products; dW, db and the gamma / beta-like
// sums in f32. Dropout bits are ops/dropout.py's hash of (seed, row * Cin
// + column), regenerated in the backward.
//
// Three routes, by width (ops/fused_block.py route_of, the same rule):
//
// wgmma (Cin, Cout multiples of 64, at most 512 and 1024): at B64 x 2048
// points (N = 131,072) every layer is bound by bytes (conv5, 128 -> 1024,
// does ~114 flop a byte; the H100 needs ~295), so the kernels move each
// byte once where they can and let the tensor cores keep up: blocks of
// three warpgroups, two consumers of 64 rows each and a producer whose
// first thread keeps a ring of stages full by TMA (128-byte swizzle,
// "full" / "empty" mbarriers; hopper.cuh), persistent (a block walks many
// tiles, so that the next tile's loads overlap this one's epilogue).
//   W         chain_wprep_{fwd,bwd}_kernel: W (f32) rounded to bf16, each
//             group of 32 columns (forward) or rows (dx) permuted so that
//             a thread's accumulators hold 8 adjacent outputs (16-byte
//             stores); the same launch clears the op's f32 sums. It takes
//             the place of the cast a wrapper would launch.
//   forward   tile 128 rows x BN columns (BN = 64 or 128; 256 where Cin >
//             128), K steps of 64; stages of the x slab and the W slab (4,
//             3 at BN 256), one block an SM. A consumer ldmatrix's its x
//             rows, applies the prologue in registers (mu / inv / gamma /
//             beta staged once a block) and runs wgmma with A in registers
//             (RS) and W MN-major in shared memory. Where Cin <= 128 the
//             fragments of the row tile stay in registers for all its N
//             tiles (the prologue runs once an element, x is loaded once).
//             The epilogue works from the
//             accumulators: bias, row bias (per row: batch rows change
//             inside a tile), y in 16-byte stores, s1 / s2 folded over a
//             warp's rows by a reduce-scatter of shuffles into the warp's
//             own row of shared memory (no atomics: a float atomic on
//             shared memory is a compare-and-swap loop), added to device
//             memory once a block. Whether a layer has dropout is a
//             template parameter here and in dx: the hash's code, even in
//             a branch never taken, slowed the other layers' fragment
//             builds (profile_row15.py). 2 launches an op (W, forward).
//   backward  where a block's dW partial fits in its registers and was
//             measured faster (conv2/3, conv4; the rule and the measured
//             choice are at sweep_cfg), one sweep, chain_wgmma_bwd_kernel: a
//             tile's dy and y arrive by TMA in row chunks, d is formed in
//             shared memory (never in device memory), dx = d @ W^T (SS)
//             with the split dx kernel's epilogue, which also writes a =
//             prologue(x) to shared memory, then dW = a^T @ d (SS), whose
//             partial stays in the accumulators across the block's tiles;
//             it reads dy, y and x once and writes dx once, as the bound
//             reckons. 2 launches an op (W, the sweep). Elsewhere (conv5, seg1,
//             seg2, seg3; dy in f32 or a row bias) the split kernels:
//             chain_cotangent_kernel (bound by bytes: reads dy and y,
//             writes d in bf16, db and d(row_bias); two blocks an SM);
//             chain_wgmma_dx_kernel, dx = d @ W^T, SS (d and W K-major),
//             two blocks an SM so that one block's epilogue overlaps the
//             other's loads: tile 128 rows x 64 input channels, 3 stages,
//             the x tile by TMA beside the ring, a block fixed to one
//             column tile; its epilogue recomputes the prologue for the
//             ReLU / dropout masks and x_hat, stores dx and a =
//             prologue(x) (the forward's A, for dW) in 16 bytes, and sums
//             dgamma / dbeta as the forward sums s1; chain_wgmma_dw_kernel,
//             dW = a^T @ d, SS with both operands MN-major, tile 64 or 128
//             (Cin) x 64-256 (Cout), 4 stages, the rows split so that the
//             blocks fill the SMs once, partials added with float2 atomics
//             (their order changes from run to run). Rows past N are zero
//             in a and d (TMA's fill), not relu(beta - mu inv gamma): they
//             add nothing to dW. 4 launches an op (W, cotangent, dx, dW);
//             d crosses kernels (written once, read twice: 2 x N x Cout x
//             2 bytes beyond the bound, 0.54 GB at conv5) and so does a (2
//             x N x Cin x 2).
// simt-K (Cin <= 16, Cout 64, 128 or 256: conv1, K = input_dim): rows of
//             8 bytes, below TMA's 16-byte stride, and 4 FMAs an output;
//             the CUDA cores, 8 output columns a thread, 16-byte stores,
//             one block an SM. Backward in one kernel: d, db, dx, dW.
// narrow (Cin 128, Cout 1..32: the logits layer, and row 17): a product
//             too narrow for wgmma's 64 rows to pay. 16 lanes a row (32
//             above 8 classes), each 8 (4) channels in one 16-byte (8-byte)
//             load, three rows' loads in flight; W and the lane's prologue
//             vectors in registers; the logits by FMAs and shuffles, the
//             softmax one class a lane. Forward and backward one pass each,
//             one block an SM: the backward forms dlogits in registers
//             (from dy, or from the CE), dA = dlogits @ W^T, the ReLU mask,
//             dx, and dW / db / dgamma / dbeta summed in registers across
//             rows, added once a block. 1 launch an op (+ a memset of the
//             sums).
//
// The bound (chip_smoke.py phase 4) counts each input read once and each
// output written once; PERF.md section 6 gives each layer's time beside
// it.

#include <initializer_list>
#include <utility>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // K step: one 128-byte swizzled row of bf16
constexpr int kBM = 128;         // tile rows: two consumer warpgroups of 64
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = 384;    // + the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBarConsumers = 1;  // named barrier of the consumer threads
constexpr int kMaxCin = 512;      // Cin of the wgmma route
constexpr int kMaxCout = 1024;    // Cout of the wgmma route
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- prologue

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// ops/dropout.py hash_bits: key = mix32(seed ^ 0x9E3779B9) (host side).
// PCSEG_CHAIN_CHEAP_HASH: one multiply instead (the same keep share, other
// masks), a variant that profile_row15.py times and nothing else builds
__device__ __forceinline__ uint32_t drop_bits(uint32_t key, uint64_t idx) {
#ifdef PCSEG_CHAIN_CHEAP_HASH
  return (uint32_t)idx * 2654435761u;
#else
  return mix32(mix32((uint32_t)idx ^ key) ^ (uint32_t)(idx >> 32));
#endif
}

struct Pro {
  int norm;  // the normalize step (mu, inv, gamma, beta)
  int relu;
  int drop;
  uint32_t key;
  uint32_t thr;
  float scale;
};

// one element of the prologue: x_hat, z, the output a (before its bf16
// rounding) and the dropout mask
struct Elem {
  float xh, z, a;
  bool keep;
};

__device__ __forceinline__ Elem pro_elem(float x, float mu, float inv, float g,
                                         float b, uint64_t idx, const Pro& p) {
  Elem e;
  if (p.norm) {
    e.xh = __fmul_rn(__fsub_rn(x, mu), inv);
    e.z = __fadd_rn(__fmul_rn(e.xh, g), b);
  } else {
    e.xh = e.z = x;
  }
  float a = p.relu ? fmaxf(e.z, 0.f) : e.z;
  e.keep = true;
  if (p.drop) {
    e.keep = drop_bits(p.key, idx) >= p.thr;
    a = e.keep ? __fmul_rn(a, p.scale) : 0.f;
  }
  e.a = a;
  return e;
}

// dz of one element from dL/da: through dropout, then the ReLU
__device__ __forceinline__ float pro_dz(float da, const Elem& e,
                                        const Pro& p) {
  float dz = da;
  if (p.drop) dz = __fmul_rn(dz, e.keep ? p.scale : 0.f);
  if (p.relu) dz = __fmul_rn(dz, e.z > 0.f ? 1.f : 0.f);
  return dz;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// element i of W, f32 (w_f32) or bf16
__device__ __forceinline__ float w_at(const void* w, int w_f32, size_t i) {
  return w_f32 ? static_cast<const float*>(w)[i]
               : __bfloat162float(static_cast<const bf16*>(w)[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&v)[8]) {
  const uint32_t* w = &q.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// 8 values to y (bf16 in 16 bytes, or f32 in 32)
__device__ __forceinline__ void store8(void* y, size_t off, int out_f32,
                                       const float (&v)[8]) {
  if (out_f32) {
    float* o = static_cast<float*>(y) + off;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(static_cast<bf16*>(y) + off) = pack8(v);
  }
}

// the accumulator slot of 8 adjacent real columns: with the columns of an
// operand permuted in groups of 32 (slot 8 r + 2 t + e holds column 8 t +
// 2 r + e), acc[4 (4 q + r) + 2 h + e] of thread t is row g + 8 h, column
// 32 q + 8 t + 2 r + e
template <int R>
__device__ __forceinline__ void acc8(const float (&acc)[R], int q, int h,
                                     float (&v)[8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e) v[2 * r + e] = acc[4 * (4 * q + r) + 2 * h + e];
}

// the four prologue vectors of a block, [4][c] in shared memory
__device__ __forceinline__ void stage_vectors(float* vec, const float* mu,
                                              const float* inv,
                                              const float* gamma,
                                              const float* beta, int c,
                                              int tid, int nthreads) {
  for (int i = tid; i < c; i += nthreads) {
    vec[i] = mu[i];
    vec[c + i] = inv[i];
    vec[2 * c + i] = gamma[i];
    vec[3 * c + i] = beta[i];
  }
}

// v[16] summed over the 8 lanes of a warp that share lane & 3 (lane bits
// 2-4) by halving exchanges; lane g = lane >> 2 gets the sums of v[2 g]
// and v[2 g + 1]
__device__ __forceinline__ float2 reduce_scatter8(float (&v)[16], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = b4 ? v[i] : v[i + 8], keep = b4 ? v[i + 8] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b3 ? v[i] : v[i + 4], keep = b3 ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b2 ? v[i] : v[i + 2], keep = b2 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  return make_float2(v[0], v[1]);
}

// Column sums of a block in shared memory, a row [2][c + 1] for each
// consumer warp (the pad puts a warp's 32 adds in 32 banks): a thread's 16
// sums of 8 columns (v[0..7] the first sum, v[8..15] the second) are
// folded over the warp's rows by reduce_scatter8, then added to the warp's
// row by plain stores (no other warp writes it, so no atomics); sum_flush
// folds the 8 rows into device memory
__host__ __device__ __forceinline__ int sum_stride(int c) { return 2 * c + 2; }

__device__ __forceinline__ void sum_add(float* sums, int c, int warp8,
                                        int lane, int col,
                                        float (&v)[16]) {
  const float2 r = reduce_scatter8(v, lane);
  const int g = lane >> 2;
  float* dst = sums + warp8 * sum_stride(c) + (g >> 2) * (c + 1) + col +
               2 * (g & 3);
  dst[0] += r.x;
  dst[1] += r.y;
}

__device__ __forceinline__ void sum_flush(const float* sums, int c, float* a,
                                          float* b, int tid, int nthreads) {
  for (int i = tid; i < c; i += nthreads) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      x += sums[w * sum_stride(c) + i];
      y += sums[w * sum_stride(c) + c + 1 + i];
    }
    atomicAdd(&a[i], x);
    atomicAdd(&b[i], y);
  }
}

// --------------------------------------------------------------------------
// wgmma forward: y = prologue(x) @ W + b [+ row bias]; s1, s2
// --------------------------------------------------------------------------

struct FwdArgs {
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* bias;
  const float* row_bias;
  void* y;
  float* s1;
  float* s2;
  long long n;
  long long rpb;
  int cin;
  int cout;
  int out_f32;
  int tiles;
  Pro pro;
};

template <int BN>
struct FwdCfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kX = kBM * kBK * 2;  // x slab [128 rows][64 k]
  static constexpr int kW = kBK * BN * 2;   // W slab [64 k][BN], MN-major
  static constexpr int kStage = kX + kW;
  static constexpr int kRing = kStages * kStage;
  // after the ring: vec [4][cin], bias [cout], the s1 / s2 copies, then
  // the barriers
  __host__ __device__ static int floats(int cin, int cout) {
    return 4 * cin + cout + kConsumerWarps * sum_stride(cout);
  }
  static int smem(int cin, int cout) {
    return 1024 + kRing + floats(cin, cout) * 4 + 8 + 2 * kStages * 8;
  }
};

// the pieces of a forward K step of a consumer warpgroup: wait for stage
// it; make the four A fragments of K step ks (ldmatrix of the x slab, the
// prologue, bf16); issue the four wgmmas on the stage's W slab as one
// group; release stages to the producer
template <int BN>
__device__ __forceinline__ const uint8_t* fwd_wait(uint8_t* smem,
                                                   uint64_t* full, int it) {
  using C = FwdCfg<BN>;
  const int s = it % C::kStages;
  mbar_wait(&full[s], (it / C::kStages) & 1);
  return smem + s * C::kStage;
}

__device__ __forceinline__ void fwd_build(uint32_t (&f)[4][4],
                                          const uint8_t* st, int ks,
                                          const float* vec, const Pro& pro,
                                          long long rwarp, int cin, int wg,
                                          int warp, int lane) {
  // ldmatrix: lanes 0-7 / 8-15 address rows 0-7 / 8-15 of the warp's 16 at
  // the slice's first 8 columns, lanes 16-31 at its last 8: r[0..3] are
  // then the A fragment (r[i]: row g + 8 (i & 1), column 2 t + 8 (i >> 1))
  const int arow = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t xrow = smem_u32(st) + arow * 128;
  const long long row0 = rwarp + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t r[4];
    ldsm_x4(r, xrow + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = ks * kBK + 16 * kk + 2 * (lane & 3) + 8 * hh;
      const float2 mu = *reinterpret_cast<const float2*>(vec + c);
      const float2 iv = *reinterpret_cast<const float2*>(vec + cin + c);
      const float2 ga = *reinterpret_cast<const float2*>(vec + 2 * cin + c);
      const float2 be = *reinterpret_cast<const float2*>(vec + 3 * cin + c);
#pragma unroll
      for (int i = 2 * hh; i < 2 * hh + 2; ++i) {
        const uint64_t idx = (uint64_t)(row0 + 8 * (i & 1)) * (uint64_t)cin + c;
        const float lo =
            pro_elem(bf16_lo(r[i]), mu.x, iv.x, ga.x, be.x, idx, pro).a;
        const float hi =
            pro_elem(bf16_hi(r[i]), mu.y, iv.y, ga.y, be.y, idx + 1, pro).a;
        f[kk][i] = pack_bf16x2(lo, hi);
      }
    }
  }
}

template <int BN>
__device__ __forceinline__ void fwd_issue(float (&acc)[BN / 2],
                                          const uint32_t (&f)[4][4],
                                          const uint8_t* st, int ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs_n<BN, 1>(acc, f[kk],
                      desc_sw128(st + FwdCfg<BN>::kX + kk * 2048, kBK * 128,
                                 1024),
                      (ks | kk) != 0);
  wgmma_commit();
}

template <int BN>
__device__ __forceinline__ void fwd_release(uint64_t* empty, int it, int n,
                                            int lane) {
  if (lane == 0)
    for (int j = 0; j < n; ++j)
      mbar_arrive(&empty[(it + j) % FwdCfg<BN>::kStages]);
}

// one K step that streams its x slab: build, issue, then release the
// previous stage once its group has completed
template <int BN>
__device__ __forceinline__ void fwd_step(float (&acc)[BN / 2],
                                         uint32_t (&f)[4][4], uint8_t* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int it, int ks, const float* vec,
                                         const Pro& pro, long long rwarp,
                                         int cin, int wg, int warp, int lane) {
  const uint8_t* st = fwd_wait<BN>(smem, full, it);
  fwd_build(f, st, ks, vec, pro, rwarp, cin, wg, warp, lane);
  fwd_issue<BN>(acc, f, st, ks);
  wgmma_wait<1>();
  if (ks > 0) fwd_release<BN>(empty, it - 1, 1, lane);
}

// the forward epilogue of one N tile from the accumulators: bias, row
// bias, y in 16-byte stores, s1 / s2 into the block's sums (a thread's
// two rows folded first)
// a thread's two rows of a row tile, g and g + 8 of its warp's 16: whether
// each is below N and its row of the row bias (one division a row tile)
struct FwdRows {
  const float* rb[2];
  bool ok[2];

  __device__ __forceinline__ FwdRows(const FwdArgs& p, long long rwarp,
                                     int lane) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = rwarp + (lane >> 2) + 8 * h;
      ok[h] = row < p.n;
      rb[h] = p.row_bias != nullptr && ok[h]
                  ? p.row_bias + (row / p.rpb) * p.cout
                  : nullptr;
    }
  }
};

template <int BN>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[BN / 2],
                                             const FwdArgs& p,
                                             const float* bias, float* ssum,
                                             long long rwarp,
                                             const FwdRows& rows, int n0,
                                             int warp8, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* const* rb = rows.rb;
  const bool* ok = rows.ok;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
    const int col = n0 + 32 * q + 8 * t;
    float b8[8];
    load8(bias + col, b8);
    float sums[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sums[i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
      acc8(acc, q, h, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b8[i];
      if (ok[h]) {
        if (rb[h] != nullptr) {
          float r8[8];
          load8(rb[h] + col, r8);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += r8[i];
        }
#ifdef PCSEG_CHAIN_NO_Y_STORE  // profile_row15.py's variant: no y stores
        if (v[0] == 1234.5f)
#endif
          store8(p.y, (size_t)(rwarp + g + 8 * h) * p.cout + col, p.out_f32,
                 v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sums[i] += v[i];
          sums[8 + i] += v[i] * v[i];
        }
      }
    }
    if (p.s1 != nullptr) sum_add(ssum, p.cout, warp8, lane, col, sums);
  }
}

// DROP: the layer has dropout (a compile-time flag: the hash's code, even
// behind a branch that is never taken, slows the other layers' fragments)
template <int BN, int KREG, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) chain_wgmma_fwd_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w, const FwdArgs p) {
  using C = FwdCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* vec = reinterpret_cast<float*>(smem + C::kRing);
  float* bias = vec + 4 * p.cin;
  float* ssum = bias + p.cout;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + ((C::kRing + C::floats(p.cin, p.cout) * 4 + 7) & ~7));
  uint64_t* empty = full + C::kStages;

  const int tid = threadIdx.x;
  const int ksteps = p.cin / kBK, ntiles = p.cout / BN;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  if (p.pro.norm)
    stage_vectors(vec, p.mu, p.inv, p.gamma, p.beta, p.cin, tid, kThreads);
  for (int i = tid; i < p.cout; i += kThreads) bias[i] = p.bias[i];
  for (int i = tid; i < kConsumerWarps * sum_stride(p.cout); i += kThreads)
    ssum[i] = 0.f;
  __syncthreads();

  if (tid >= kConsumers) {  // producer
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int nt = 0; nt < ntiles; ++nt) {
          for (int ks = 0; ks < ksteps; ++ks, ++it) {
            const int s = it % C::kStages;
            if (it >= C::kStages)
              mbar_wait(&empty[s], ((it / C::kStages) - 1) & 1);
            uint8_t* st = smem + s * C::kStage;
            // with the fragments kept in registers, x only for the first
            // N tile of a row tile
            const bool want_x = KREG == 0 || nt == 0;
            mbar_expect_tx(&full[s], (want_x ? C::kX : 0) + C::kW);
            if (want_x) tma_load(st, &map_x, &full[s], ks * kBK, tile * kBM);
            for (int i = 0; i < BN / 64; ++i)
              tma_load(st + C::kX + i * kBK * 128, &map_w, &full[s],
                       nt * BN + 64 * i, ks * kBK);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile
  reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  Pro pro = p.pro;
  pro.drop = DROP;
  // KREG > 0: Cin = 64 KREG, every K step's fragments kept for all N
  // tiles of a row tile; else two sets, the next step's built while this
  // one's wgmmas run (every path writes f[0], then f[1]: a path that
  // rewrote a set whose wgmmas may be in flight would make ptxas serialize
  // them, C7513)
  constexpr int NF = KREG > 0 ? KREG : 2;
  uint32_t f[NF][4][4];
  const int warp8 = 4 * wg + warp;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long rwarp = (long long)tile * kBM + 64 * wg + 16 * warp;
    const FwdRows rows(p, rwarp, lane);
    if constexpr (KREG > 0) {
      for (int nt = 0; nt < ntiles; ++nt) {
        float acc[BN / 2];  // the first wgmma starts the sum (scale_d = 0)
#pragma unroll
        for (int ks = 0; ks < KREG; ++ks) {  // N tile 0 builds the fragments
          const uint8_t* st = fwd_wait<BN>(smem, full, it + ks);
          if (nt == 0)
            fwd_build(f[ks], st, ks, vec, pro, rwarp, p.cin, wg, warp, lane);
          fwd_issue<BN>(acc, f[ks], st, ks);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        fwd_release<BN>(empty, it, KREG, lane);
        it += KREG;
        fwd_epilogue<BN>(acc, p, bias, ssum, rwarp, rows, nt * BN, warp8,
                         lane);
      }
    } else {
      for (int nt = 0; nt < ntiles; ++nt) {
        float acc[BN / 2];  // the first wgmma starts the sum (scale_d = 0)
        int ks = 0;
        for (; ks + 1 < ksteps; ks += 2) {
          fwd_step<BN>(acc, f[0], smem, full, empty, it + ks, ks, vec, pro,
                       rwarp, p.cin, wg, warp, lane);
          fwd_step<BN>(acc, f[1], smem, full, empty, it + ks + 1, ks + 1, vec,
                       pro, rwarp, p.cin, wg, warp, lane);
        }
        if (ks < ksteps)
          fwd_step<BN>(acc, f[0], smem, full, empty, it + ks, ks, vec, pro,
                       rwarp, p.cin, wg, warp, lane);
        it += ksteps;
        wgmma_wait<0>();
        fence_acc(acc);
        fwd_release<BN>(empty, it - 1, 1, lane);
        fwd_epilogue<BN>(acc, p, bias, ssum, rwarp, rows, nt * BN, warp8,
                         lane);
      }
    }
  }
  if (p.s1 == nullptr) return;
  bar_sync(kBarConsumers, kConsumers);  // the block's sums are complete
  sum_flush(ssum, p.cout, p.s1, p.s2, tid, kConsumers);
}

// --------------------------------------------------------------------------
// wgmma backward 1: d = bf16((dy + ds1) + 2 y ds2) (the stats terms where
// there are stats), db and d(row_bias)
// --------------------------------------------------------------------------

constexpr int kCotRows = 512;  // rows of a cotangent block

// 256 threads: cw groups of 8 channels across, 256 / cw row lanes down;
// 4 rows a trip with their loads ahead of the arithmetic, two blocks an SM
__global__ void __launch_bounds__(256, 2) chain_cotangent_kernel(
    const void* __restrict__ dy, int dy_f32, const bf16* __restrict__ y,
    const float* __restrict__ ds1, const float* __restrict__ ds2,
    bf16* __restrict__ d, float* __restrict__ db, float* __restrict__ drb,
    long long rpb, long long n, int cout, int cw) {
  __shared__ float red[256 * 8];
  const int tid = threadIdx.x, cg = tid % cw, rl = tid / cw, lanes = 256 / cw;
  const int c0 = blockIdx.y * cw * 8 + cg * 8;
  const long long r0 = (long long)blockIdx.x * kCotRows;
  const long long r1 = r0 + kCotRows < n ? r0 + kCotRows : n;
  const bool stats = ds1 != nullptr;
  float acc[8], accb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = accb[i] = 0.f;
  if (c0 < cout) {
    float d1[8], d2[8];
    if (stats) {
      load8(ds1 + c0, d1);
      load8(ds2 + c0, d2);
    }
    long long b = -1, bend = 0;
    for (long long r = r0 + rl; r < r1; r += 4 * lanes) {
      float v[4][8], yv[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long ru = r + u * lanes;
        if (ru >= r1) continue;
        const size_t o = (size_t)ru * cout + c0;
        if (dy_f32)
          load8(static_cast<const float*>(dy) + o, v[u]);
        else
          unpack8(*reinterpret_cast<const uint4*>(
                      static_cast<const bf16*>(dy) + o), v[u]);
        if (stats) unpack8(*reinterpret_cast<const uint4*>(y + o), yv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long ru = r + u * lanes;
        if (ru >= r1) break;
        if (stats) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[u][i] = __fadd_rn(__fadd_rn(v[u][i], d1[i]),
                                __fmul_rn(__fmul_rn(2.f, yv[u][i]), d2[i]));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += v[u][i];
        if (drb != nullptr) {
          if (ru >= bend) {  // a new batch row: flush the last one's sums
            if (b >= 0)
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                atomicAdd(&drb[b * cout + c0 + i], accb[i]);
                accb[i] = 0.f;
              }
            b = ru / rpb;
            bend = (b + 1) * rpb;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) accb[i] += v[u][i];
        }
        *reinterpret_cast<uint4*>(d + (size_t)ru * cout + c0) = pack8(v[u]);
      }
    }
    if (drb != nullptr && b >= 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) atomicAdd(&drb[b * cout + c0 + i], accb[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rl * cw * 8 + cg * 8 + i] = acc[i];
  __syncthreads();
  const int c = blockIdx.y * cw * 8 + tid;
  if (tid < cw * 8 && c < cout) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[l * cw * 8 + tid];
    atomicAdd(&db[c], s);
  }
}

// --------------------------------------------------------------------------
// wgmma backward 2: dx = (d @ W^T) through the dropout / ReLU masks, times
// gamma * inv; a = prologue(x) for dW; dgamma, dbeta
// --------------------------------------------------------------------------

struct DxArgs {
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  bf16* dx;
  bf16* a;
  float* dg;
  float* dbeta;
  long long n;
  int cin;
  int cout;
  int col_tiles;
  Pro pro;
};

// Two blocks an SM, so that one block's epilogue runs beside the other's
// loads and products: tile 128 rows x 64 input channels, 3 stages of the d
// slab [128 rows][64 k] and the W slab [64][64 k], the x tile [128][64]
// beside the ring. A block keeps one column tile (its vectors and sums
// are those 64 channels') and walks row tiles.
constexpr int kDxBN = 64;
constexpr int kDxStages = 3;
constexpr int kDxA = kBM * kBK * 2;
constexpr int kDxStage = kDxA + kDxBN * kBK * 2;
constexpr int kDxX = kDxStages * kDxStage;
constexpr int kDxVec = kDxX + kBM * kDxBN * 2;
constexpr int kDxSum = kDxVec + 4 * kDxBN * 4;  // vec [4][64]
constexpr int kDxBar = kDxSum + kConsumerWarps * (2 * kDxBN + 2) * 4;
constexpr int kDxSmem = 1024 + kDxBar + (2 * kDxStages + 2) * 8;
constexpr int kDxConsumerRegs = 104, kDxProducerRegs = 24;

template <bool DROP>  // as the forward's
__global__ void __launch_bounds__(kThreads, 2) chain_wgmma_dx_kernel(
    const __grid_constant__ CUtensorMap map_d,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_x, const DxArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* xtile = smem + kDxX;
  float* vec = reinterpret_cast<float*>(smem + kDxVec);
  float* gsum = reinterpret_cast<float*>(smem + kDxSum);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDxBar);
  uint64_t* empty = full + kDxStages;
  uint64_t* xfull = empty + kDxStages;
  uint64_t* xempty = xfull + 1;

  const int tid = threadIdx.x;
  const int ksteps = p.cout / kBK;
  const int ct = blockIdx.x % p.col_tiles, n0 = ct * kDxBN;  // over Cin
  const int rstep = gridDim.x / p.col_tiles;
  const int row_tiles = (int)((p.n + kBM - 1) / kBM);
  if (tid == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, kConsumerWarps);
    fence_barrier_init();
  }
  if (p.pro.norm && tid < kDxBN) {
    vec[tid] = p.mu[n0 + tid];
    vec[kDxBN + tid] = p.inv[n0 + tid];
    vec[2 * kDxBN + tid] = p.gamma[n0 + tid];
    vec[3 * kDxBN + tid] = p.beta[n0 + tid];
  }
  for (int i = tid; i < kConsumerWarps * sum_stride(kDxBN); i += kThreads)
    gsum[i] = 0.f;
  __syncthreads();

  if (tid >= kConsumers) {  // producer
    reg_dealloc<kDxProducerRegs>();
    if (tid == kConsumers) {
      int it = 0, xi = 0;
      const int xat = (ksteps < kDxStages ? ksteps : kDxStages) - 1;
      for (int rt = blockIdx.x / p.col_tiles; rt < row_tiles;
           rt += rstep, ++xi) {
        const int m0 = rt * kBM;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % kDxStages;
          if (it >= kDxStages)
            mbar_wait(&empty[s], ((it / kDxStages) - 1) & 1);
          uint8_t* st = smem + s * kDxStage;
          mbar_expect_tx(&full[s], kDxStage);
          tma_load(st, &map_d, &full[s], ks * kBK, m0);
          tma_load(st + kDxA, &map_w, &full[s], ks * kBK, n0);
          if (ks == xat) {
            // the x tile of the epilogue, once the ring's first fill is out
            // and the last tile's epilogue has read the buffer
            if (xi > 0) mbar_wait(xempty, (xi - 1) & 1);
            mbar_expect_tx(xfull, kBM * kDxBN * 2);
            tma_load(xtile, &map_x, xfull, n0, m0);
          }
        }
      }
    }
    return;
  }

  reg_alloc<kDxConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  Pro pro = p.pro;
  pro.drop = DROP;
  int it = 0, xi = 0;
  for (int rt = blockIdx.x / p.col_tiles; rt < row_tiles; rt += rstep, ++xi) {
    const long long m0 = (long long)rt * kBM;
    float acc[kDxBN / 2];  // the first wgmma starts the sum (scale_d = 0)
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % kDxStages;
      mbar_wait(&full[s], (it / kDxStages) & 1);
      const uint8_t* st = smem + s * kDxStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_n<kDxBN, 0, 0>(
            acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
            desc_sw128(st + kDxA + kk * 32, 16, 1024), (ks | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kDxStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kDxStages]);
    mbar_wait(xfull, xi & 1);

    // epilogue from the accumulators (W's rows permuted: a thread holds 8
    // adjacent input channels of a row)
    const int rtile = 64 * wg + 16 * warp + g;  // the row in the tile, + 8 h
#pragma unroll
    for (int q = 0; q < kDxBN / 32; ++q) {
      const int cl = 32 * q + 8 * t, col = n0 + cl;
      float sums[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sums[i] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rtile + 8 * h;
        const long long row = m0 + r;
        float da[8], xv[8], dxv[8], av[8];
        acc8(acc, q, h, da);
        // x (r, cl .. cl + 7) of the swizzled tile: 16-byte chunk cl / 8
        // sits at chunk ^ (r & 7)
        unpack8(*reinterpret_cast<const uint4*>(
                    xtile + r * 128 + (((cl >> 3) ^ (r & 7)) << 4)),
                xv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = cl + i;
          const Elem e = pro_elem(xv[i], vec[c], vec[kDxBN + c],
                                  vec[2 * kDxBN + c], vec[3 * kDxBN + c],
                                  (uint64_t)row * p.cin + n0 + c, pro);
          const float dz = pro_dz(da[i], e, pro);
          dxv[i] = p.pro.norm ? __fmul_rn(__fmul_rn(dz, vec[2 * kDxBN + c]),
                                          vec[kDxBN + c])
                              : dz;
          av[i] = e.a;
          if (row < p.n) {
            sums[i] += __fmul_rn(dz, e.xh);
            sums[8 + i] += dz;
          }
        }
        if (row < p.n) {
          const size_t o = (size_t)row * p.cin + col;
          *reinterpret_cast<uint4*>(p.dx + o) = pack8(dxv);
          *reinterpret_cast<uint4*>(p.a + o) = pack8(av);
        }
      }
      if (p.pro.norm) sum_add(gsum, kDxBN, 4 * wg + warp, lane, cl, sums);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty);  // this warp has read the x tile
  }
  if (!p.pro.norm) return;
  bar_sync(kBarConsumers, kConsumers);
  sum_flush(gsum, kDxBN, p.dg + n0, p.dbeta + n0, tid, kConsumers);
}

// --------------------------------------------------------------------------
// wgmma backward 3: dW += a^T @ d over one split of the rows
// --------------------------------------------------------------------------

struct DwArgs {
  float* dw;
  long long n;
  int cin;
  int cout;
  int row_tiles;  // over Cin
  int col_tiles;  // over Cout
  int ksteps;     // K steps of one split
};

// tile 64 WGM (Cin) x BN (Cout); WGM = 1: the two consumer warpgroups take
// the two halves of each stage's 64 rows and both add their partials
template <int BN, int WGM>
struct DwCfg {
  static constexpr int kStages = 4;
  static constexpr int kA = kBK * 64 * WGM * 2;  // a [64 rows][64 WGM cin]
  static constexpr int kStage = kA + kBK * BN * 2;  // + d [64 rows][BN]
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
};

template <int BN, int WGM>
__global__ void __launch_bounds__(kThreads, 1) chain_wgmma_dw_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_d, const DwArgs p) {
  using C = DwCfg<BN, WGM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStage);
  uint64_t* empty = full + C::kStages;

  const int tid = threadIdx.x;
  const int tiles = p.row_tiles * p.col_tiles;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = (tile / p.col_tiles) * 64 * WGM;  // over Cin
  const int n0 = (tile % p.col_tiles) * BN;        // over Cout
  const long long total = (p.n + kBK - 1) / kBK;
  const long long k_begin = (long long)split * p.ksteps;
  const long long k_end =
      k_begin + p.ksteps < total ? k_begin + p.ksteps : total;
  const int ksteps = (int)(k_end - k_begin);

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
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
        const int s = ks % C::kStages;
        if (ks >= C::kStages)
          mbar_wait(&empty[s], (ks / C::kStages - 1) & 1);
        uint8_t* st = smem + s * C::kStage;
        const int r = (int)((k_begin + ks) * kBK);
        mbar_expect_tx(&full[s], C::kStage);
        for (int i = 0; i < WGM; ++i)
          tma_load(st + i * kBK * 128, &map_a, &full[s], m0 + 64 * i, r);
        for (int i = 0; i < BN / 64; ++i)
          tma_load(st + C::kA + i * kBK * 128, &map_d, &full[s], n0 + 64 * i,
                   r);
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  constexpr int KK = WGM == 2 ? 4 : 2;  // the k16 slices a warpgroup takes
  const int k0 = WGM == 2 ? 0 : 2 * wg;
  const int mslab = WGM == 2 ? wg : 0;
  float acc[BN / 2];  // the first wgmma starts the sum (scale_d = 0)
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % C::kStages;
    mbar_wait(&full[s], (ks / C::kStages) & 1);
    const uint8_t* st = smem + s * C::kStage;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const int kk = k0 + j;
      wgmma_ss_n<BN, 1, 1>(
          acc,
          desc_sw128(st + mslab * kBK * 128 + kk * 2048, kBK * 128, 1024),
          desc_sw128(st + C::kA + kk * 2048, kBK * 128, 1024),
          (ks | j) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % C::kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (ksteps <= 0) return;
  // acc[4 j + 2 h + e]: input channel 16 warp + g + 8 h of the slab's 64,
  // output channel 8 j + 2 t + e
  const int ch0 = m0 + 64 * mslab + 16 * warp + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = p.dw + (size_t)(ch0 + 8 * h) * p.cout + c0 + 8 * j;
      // one vector atomic for the two adjacent columns (sm_90)
      atomicAdd(reinterpret_cast<float2*>(o),
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
}

// --------------------------------------------------------------------------
// wgmma backward in one sweep, where a block's dW partial fits in its
// registers: d, db, dW, dx, dgamma and dbeta from one read of dy, y and x
// --------------------------------------------------------------------------

struct SweepArgs {
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* ds1;  // null without stats (no y)
  const float* ds2;
  bf16* dx;
  float* dw;
  float* db;
  float* dg;
  float* dbeta;
  long long n;
  int cin;
  int cout;
  int rc;       // rows of a dy / y chunk
  int stages;   // chunk stages of the ring
  int xstages;  // x tile buffers
  int tiles;
  Pro pro;
};

// Shared memory (bytes from the 1024-aligned base): the d tile [Cout /
// 64 slabs][128 rows][64] (both products' operand), the a tile [cin /
// 64][128 rows][64] (dW's A), the x tiles [cin / 64][128 rows][64], W
// [Cout / 64][cin][64] (dx's B, loaded once), the ring of dy and y chunks
// [Cout / 64][rc rows][64] each, then mu / inv / gamma / beta, the dgamma
// / dbeta rows of the consumer warps and the barriers
struct SweepLayout {
  int a, x, w, ring, vec, gsum, bar, total;
  __host__ __device__ SweepLayout(int cin, int cout, int rc, int stages,
                                  int xstages) {
    a = kBM * cout * 2;
    x = a + kBM * cin * 2;
    w = x + xstages * kBM * cin * 2;
    ring = w + cin * cout * 2;
    vec = ring + stages * rc * cout * 4;
    gsum = vec + 4 * cin * 4;
    bar = (gsum + kConsumerWarps * sum_stride(cin) * 4 + 7) & ~7;
    total = bar + (2 * stages + 2 * xstages + 1) * 8;
  }
};

// One block an SM walks row tiles of 128. Its producer warpgroup has two
// threads at work: one loads W once and the x tiles, the other the dy and
// y chunks of each tile into a ring. A tile's consumers (two warpgroups):
//  1. form d = bf16((dy + ds1) + 2 y ds2) chunk by chunk into the d tile
//     (a thread keeps one group of 8 columns, so db sums in registers);
//     rows past N get d = 0, so that the prologue of TMA's zero rows,
//     relu(beta - mu inv gamma), adds nothing to dW, dgamma or dbeta;
//  2. dx = d @ W^T by 64-channel chunks (SS; W's rows permuted as the
//     split dx kernel's), its epilogue as there: the prologue from x for
//     the masks and x_hat, dx in 16-byte stores, dgamma / dbeta rows, and
//     a = prologue(x) into the a tile (the prologue and its dropout hash
//     run once an element, as in the split);
//  3. dW += a^T @ d, SS with both operands MN-major (the a tile and the d
//     tile); the block's dW partial stays in the accumulators across its
//     tiles: warpgroup wg takes its 64 channels (where Cin = 128), else
//     the N half NW wg (Cout = 2 NW), else (KSPLIT, 64 x 64) its own
//     64 rows of the whole dW. They complete while the x tile is released
//     and are waited for when the next tile begins (its d overwrites their
//     operand).
// At the end dW, db, dgamma and dbeta are added to device memory once a
// block. 2 launches an op (W, this).
template <int NW, bool KSPLIT, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) chain_wgmma_bwd_kernel(
    const __grid_constant__ CUtensorMap map_dy,
    const __grid_constant__ CUtensorMap map_y,
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w, const SweepArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int cin = p.cin;
  const SweepLayout L(cin, p.cout, p.rc, p.stages, p.xstages);
  uint8_t* dtile = smem;
  uint8_t* atile = smem + L.a;
  uint8_t* xbuf = smem + L.x;
  uint8_t* wsm = smem + L.w;
  uint8_t* ring = smem + L.ring;
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* gsum = reinterpret_cast<float*>(smem + L.gsum);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + p.stages;
  uint64_t* xfull = empty + p.stages;
  uint64_t* xempty = xfull + p.xstages;
  uint64_t* wfull = xempty + p.xstages;

  const int tid = threadIdx.x;
  const bool stats = p.ds1 != nullptr;
  const int chunks = kBM / p.rc;
  const int half = p.rc * p.cout * 2;  // the dy (or y) part of a stage
  const int xbytes = kBM * cin * 2;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < p.xstages; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], kConsumerWarps);
    }
    mbar_init(wfull, 1);
    fence_barrier_init();
  }
  if (p.pro.norm)
    stage_vectors(vec, p.mu, p.inv, p.gamma, p.beta, cin, tid, kThreads);
  for (int i = tid; i < kConsumerWarps * sum_stride(cin); i += kThreads)
    gsum[i] = 0.f;
  __syncthreads();

  if (tid >= kConsumers) {  // producers
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers) {  // W once, then the x tiles
      mbar_expect_tx(wfull, cin * p.cout * 2);
      for (int kb = 0; kb < p.cout / 64; ++kb)
        for (int cb = 0; cb < cin / 64; ++cb)
          tma_load(wsm + kb * cin * 128 + cb * 64 * 128, &map_w, wfull,
                   kb * 64, cb * 64);
      int xi = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++xi) {
        const int s = xi % p.xstages;
        if (xi >= p.xstages)
          mbar_wait(&xempty[s], ((xi / p.xstages) - 1) & 1);
        mbar_expect_tx(&xfull[s], xbytes);
        for (int cb = 0; cb < cin / 64; ++cb)
          tma_load(xbuf + s * xbytes + cb * kBM * 128, &map_x, &xfull[s],
                   cb * 64, tile * kBM);
      }
    } else if (tid == kConsumers + 32) {  // the dy and y chunks
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % p.stages;
          if (it >= p.stages)
            mbar_wait(&empty[s], ((it / p.stages) - 1) & 1);
          uint8_t* st = ring + s * 2 * half;
          mbar_expect_tx(&full[s], stats ? 2 * half : half);
          const int r = tile * kBM + c * p.rc;
          for (int kb = 0; kb < p.cout / 64; ++kb) {
            tma_load(st + kb * p.rc * 128, &map_dy, &full[s], kb * 64, r);
            if (stats)
              tma_load(st + half + kb * p.rc * 128, &map_y, &full[s], kb * 64,
                       r);
          }
        }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, warp8 = 4 * wg + warp;
  Pro pro = p.pro;
  pro.drop = DROP;
  // step 1's thread: 8 columns (chunk j8 of slab kb), rows rl, rl + rstep..
  const int cchunks = p.cout / 8, rstep = kConsumers / cchunks;
  const int cc = tid % cchunks, rl = tid / cchunks;
  const int kb = cc >> 3, j8 = cc & 7;
  const bool former = rl < rstep;
  float dbs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dbs[i] = 0.f;
  // step 2's share of dW
  const bool msplit = cin == 128;
  const int m_tile = msplit ? wg : 0;
  const int n_begin = msplit || KSPLIT ? 0 : wg * NW;
  constexpr int KS = KSPLIT ? 4 : 8;  // k16 steps over the tile's rows
  const int ks0 = KSPLIT ? 4 * wg : 0;
  float dwacc[NW / 2];  // the first wgmma starts the sum (scale_d = 0)
  bool first = true;
  int it = 0, xi = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++xi) {
    const long long m0 = (long long)tile * kBM;
    // the last tile's dW wgmmas have completed: the d and a tiles may be
    // rewritten
    wgmma_wait<0>();
    bar_sync(kBarConsumers, kConsumers);
    // 1. d into the d tile, db
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const uint8_t* st = ring + s * 2 * half + kb * p.rc * 128;
      if (former) {
        float d1[8], d2[8];
        if (stats) {
          load8(p.ds1 + cc * 8, d1);
          load8(p.ds2 + cc * 8, d2);
        }
        for (int r = rl; r < p.rc; r += rstep) {
          const int sw = (j8 ^ (r & 7)) << 4;  // c * rc is a multiple of 8
          float v[8];
          unpack8(*reinterpret_cast<const uint4*>(st + r * 128 + sw), v);
          const int rt = c * p.rc + r;
          if (m0 + rt < p.n) {
            if (stats) {
              float yv[8];
              unpack8(*reinterpret_cast<const uint4*>(st + half + r * 128 +
                                                      sw),
                      yv);
#pragma unroll
              for (int i = 0; i < 8; ++i)
                v[i] = __fadd_rn(__fadd_rn(v[i], d1[i]),
                                 __fmul_rn(__fmul_rn(2.f, yv[i]), d2[i]));
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) dbs[i] += v[i];
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = 0.f;
          }
          *reinterpret_cast<uint4*>(dtile + kb * kBM * 128 + rt * 128 + sw) =
              pack8(v);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_proxy_async();  // the d tile's stores, before the wgmmas read it
    bar_sync(kBarConsumers, kConsumers);

    // 2. dx by chunks of 64 input channels, and its epilogue
    const int xs = xi % p.xstages;
    mbar_wait(&xfull[xs], (xi / p.xstages) & 1);
    const uint8_t* xt = xbuf + xs * xbytes;
    if (xi == 0) mbar_wait(wfull, 0);
    const int rtile = 64 * wg + 16 * warp + g;  // the row in the tile, + 8 h
    for (int nc = 0; nc < cin / 64; ++nc) {
      float acc[32];  // the first wgmma starts the sum (scale_d = 0)
      wgmma_fence();
      for (int kb2 = 0; kb2 < p.cout / 64; ++kb2)
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss_n<64, 0, 0>(
              acc,
              desc_sw128(dtile + kb2 * kBM * 128 + wg * 64 * 128 + kk * 32, 16,
                         1024),
              desc_sw128(wsm + kb2 * cin * 128 + nc * 64 * 128 + kk * 32, 16,
                         1024),
              (kb2 | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cl = 32 * q + 8 * t, col = nc * 64 + cl;
        float sums[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sums[i] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rtile + 8 * h;
          const long long row = m0 + r;
          float da[8], xv[8], dxv[8], av[8];
          acc8(acc, q, h, da);
          // x and a (r, cl .. cl + 7): 16-byte chunk cl / 8 of the row
          // sits at chunk ^ (r & 7)
          const int sw =
              nc * kBM * 128 + r * 128 + (((cl >> 3) ^ (r & 7)) << 4);
          unpack8(*reinterpret_cast<const uint4*>(xt + sw), xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = col + i;
            const Elem e = pro_elem(xv[i], vec[c], vec[cin + c],
                                    vec[2 * cin + c], vec[3 * cin + c],
                                    (uint64_t)row * cin + c, pro);
            const float dz = pro_dz(da[i], e, pro);
            dxv[i] = p.pro.norm
                         ? __fmul_rn(__fmul_rn(dz, vec[2 * cin + c]),
                                     vec[cin + c])
                         : dz;
            av[i] = e.a;
            if (row < p.n) {
              sums[i] += __fmul_rn(dz, e.xh);
              sums[8 + i] += dz;
            }
          }
          if (row < p.n)
            *reinterpret_cast<uint4*>(p.dx + (size_t)row * cin + col) =
                pack8(dxv);
          *reinterpret_cast<uint4*>(atile + sw) = pack8(av);
        }
        if (p.pro.norm) sum_add(gsum, cin, warp8, lane, col, sums);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&xempty[xs]);  // this warp has read the x tile
    fence_proxy_async();  // the a tile's stores, before the wgmmas read it
    bar_sync(kBarConsumers, kConsumers);

    // 3. dW += a^T @ d, left in flight
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int r0 = (ks0 + j) * 16;
      wgmma_ss_n<NW, 1, 1>(
          dwacc,
          desc_sw128(atile + m_tile * kBM * 128 + r0 * 128, kBM * 128, 1024),
          desc_sw128(dtile + (n_begin / 64) * kBM * 128 + r0 * 128, kBM * 128,
                     1024),
          first && j == 0 ? 0 : 1);
    }
    wgmma_commit();
    first = false;
  }

  // the block's dW partial (acc[4 j + 2 h + e]: input channel 16 warp + g +
  // 8 h of the M tile, output channel 8 j + 2 t + e of the N range), one
  // vector atomic a pair
  wgmma_wait<0>();
  fence_acc(dwacc);
  const int ch0 = m_tile * 64 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      atomicAdd(reinterpret_cast<float2*>(p.dw + (size_t)(ch0 + 8 * h) *
                                                     p.cout +
                                          n_begin + 8 * j + 2 * t),
                make_float2(dwacc[4 * j + 2 * h], dwacc[4 * j + 2 * h + 1]));
  // every warp's dgamma / dbeta rows are complete, every wgmma too
  bar_sync(kBarConsumers, kConsumers);
  if (p.pro.norm) sum_flush(gsum, cin, p.dg, p.dbeta, tid, kConsumers);
  // db: the rstep threads of a column group fold their sums in the d
  // tile's memory, one atomic a column
  float* red = reinterpret_cast<float*>(dtile);
  if (former)
#pragma unroll
    for (int i = 0; i < 8; ++i) red[rl * p.cout + cc * 8 + i] = dbs[i];
  bar_sync(kBarConsumers, kConsumers);
  for (int c = tid; c < p.cout; c += kConsumers) {
    float s = 0.f;
    for (int l = 0; l < rstep; ++l) s += red[l * p.cout + c];
    atomicAdd(&p.db[c], s);
  }
}

// --------------------------------------------------------------------------
// simt-K (conv1): Cin <= KP <= 16, Cout = 8 CW; a thread takes 8 adjacent
// output columns of a row, CW threads a row, blockDim / CW rows a pass
// --------------------------------------------------------------------------

struct SimtArgs {
  const bf16* x;
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const void* w;  // f32 (w_f32) or bf16, rounded to bf16 as it is staged
  int w_f32;
  const float* bias;
  void* y;
  float* s1;
  float* s2;
  const void* dy;
  const bf16* yin;
  const float* ds1;
  const float* ds2;
  bf16* dx;
  float* dw;
  float* db;
  float* dg;
  float* dbeta;
  long long n;
  int cin;
  int cout;
  int out_f32;
  int dy_f32;
  Pro pro;
};

// W as f32 [KP][cout] (zero rows past Cin) and the prologue vectors
template <int KP>
__device__ __forceinline__ void simt_stage(const SimtArgs& p, float* ws,
                                           float* vec) {
  for (int i = threadIdx.x; i < KP * p.cout; i += blockDim.x) {
    const int k = i / p.cout;
    ws[i] = k < p.cin ? round_bf16(w_at(p.w, p.w_f32, i)) : 0.f;
  }
  if (threadIdx.x < p.cin && p.pro.norm) {
    const int k = threadIdx.x;
    vec[k] = p.mu[k];
    vec[16 + k] = p.inv[k];
    vec[32 + k] = p.gamma[k];
    vec[48 + k] = p.beta[k];
  }
}

template <int KP>
__device__ __forceinline__ Elem simt_elem(const SimtArgs& p, const float* vec,
                                          long long r, int k) {
  const uint64_t i = (uint64_t)r * p.cin + k;
  return pro_elem(__bfloat162float(p.x[i]), vec[k], vec[16 + k], vec[32 + k],
                  vec[48 + k], i, p.pro);
}

template <int KP, int CW>
__global__ void chain_simt_fwd_kernel(
    const SimtArgs p) {
  const int kLanes = blockDim.x / CW;
  __shared__ __align__(16) float ws[KP * 8 * CW];
  __shared__ float vec[64];
  __shared__ float ss[2][8 * CW];
  const int tid = threadIdx.x, c0 = (tid % CW) * 8, rl = tid / CW;
  simt_stage<KP>(p, ws, vec);
  for (int i = tid; i < 2 * 8 * CW; i += blockDim.x) (&ss[0][0])[i] = 0.f;
  __syncthreads();
  float b8[8], s1a[8], s2a[8];
  load8(p.bias + c0, b8);
#pragma unroll
  for (int j = 0; j < 8; ++j) s1a[j] = s2a[j] = 0.f;
  for (long long r = (long long)blockIdx.x * kLanes + rl; r < p.n;
       r += (long long)gridDim.x * kLanes) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k >= p.cin) break;
      const float a = round_bf16(simt_elem<KP>(p, vec, r, k).a);
      float w8[8];
      load8(ws + k * p.cout + c0, w8);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaf(a, w8[j], v[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] += b8[j];
      s1a[j] += v[j];
      s2a[j] += v[j] * v[j];
    }
    store8(p.y, (size_t)r * p.cout + c0, p.out_f32, v);
  }
  if (p.s1 == nullptr) return;
  // fold the rows of a warp, then the warps add in turn (plain stores: a
  // float atomic on shared memory is a compare-and-swap loop)
#pragma unroll
  for (int o = CW; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1a[j] += __shfl_xor_sync(kFull, s1a[j], o);
      s2a[j] += __shfl_xor_sync(kFull, s2a[j], o);
    }
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
    if (tid / 32 == w && (tid & 31) < CW)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ss[0][c0 + j] += s1a[j];
        ss[1][c0 + j] += s2a[j];
      }
    __syncthreads();
  }
  for (int i = tid; i < p.cout; i += blockDim.x) {
    atomicAdd(&p.s1[i], ss[0][i]);
    atomicAdd(&p.s2[i], ss[1][i]);
  }
}

// one pass: d = bf16((dy + ds1) + 2 y ds2), db, dA = d @ W^T summed over
// the CW lanes of a row, dx (the row's first lane), dW, dgamma, dbeta
template <int KP, int CW>
__global__ void chain_simt_bwd_kernel(
    const SimtArgs p) {
  const int kLanes = blockDim.x / CW;
  __shared__ __align__(16) float ws[KP * 8 * CW];
  __shared__ float vec[64];
  __shared__ float red[KP * 8 * CW + 8 * CW + 2 * KP];
  const int tid = threadIdx.x, cg = tid % CW, c0 = cg * 8, rl = tid / CW;
  simt_stage<KP>(p, ws, vec);
  for (int i = tid; i < KP * 8 * CW + 8 * CW + 2 * KP; i += blockDim.x) red[i] = 0.f;
  __syncthreads();
  const bool stats = p.ds1 != nullptr;
  float d1[8], d2[8];
  if (stats) {
    load8(p.ds1 + c0, d1);
    load8(p.ds2 + c0, d2);
  }
  float dba[8], dwa[KP][8], dga[KP], dbt[KP];
#pragma unroll
  for (int j = 0; j < 8; ++j) dba[j] = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    dga[k] = dbt[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) dwa[k][j] = 0.f;
  }
  // warp-uniform trips: the shuffles below need every lane
  for (long long base = (long long)blockIdx.x * kLanes; base < p.n;
       base += (long long)gridDim.x * kLanes) {
    const long long r = base + rl;
    const bool valid = r < p.n;
    float dv[8], dl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dv[j] = 0.f;
    if (valid) {
      const size_t o = (size_t)r * p.cout + c0;
      if (p.dy_f32)
        load8(static_cast<const float*>(p.dy) + o, dv);
      else
        unpack8(*reinterpret_cast<const uint4*>(
                    static_cast<const bf16*>(p.dy) + o), dv);
      if (stats) {
        float yv[8];
        unpack8(*reinterpret_cast<const uint4*>(p.yin + o), yv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dv[j] = __fadd_rn(__fadd_rn(dv[j], d1[j]),
                            __fmul_rn(__fmul_rn(2.f, yv[j]), d2[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dba[j] += dv[j];
      dl[j] = round_bf16(dv[j]);
    }
    float da[KP];
    Elem e[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      da[k] = 0.f;
      e[k] = Elem{0.f, 0.f, 0.f, true};
      if (k < p.cin && valid) {
        e[k] = simt_elem<KP>(p, vec, r, k);
        const float a = round_bf16(e[k].a);
        float w8[8];
        load8(ws + k * p.cout + c0, w8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          da[k] = fmaf(dl[j], w8[j], da[k]);
          dwa[k][j] = fmaf(a, dl[j], dwa[k][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int o = CW / 2; o > 0; o >>= 1)
        da[k] += __shfl_xor_sync(kFull, da[k], o);
    if (cg == 0 && valid) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k >= p.cin) break;
        const float dz = pro_dz(da[k], e[k], p.pro);
        p.dx[(size_t)r * p.cin + k] = __float2bfloat16_rn(
            p.pro.norm ? __fmul_rn(__fmul_rn(dz, vec[32 + k]), vec[16 + k])
                       : dz);
        dga[k] += __fmul_rn(dz, e[k].xh);
        dbt[k] += dz;
      }
    }
  }
  float* rdw = red;
  float* rdb = red + KP * 8 * CW;
  float* rdg = rdb + 8 * CW;
  // fold the rows of a warp, then the warps add in turn (plain stores: a
  // float atomic on shared memory is a compare-and-swap loop)
#pragma unroll
  for (int o = CW; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dba[j] += __shfl_xor_sync(kFull, dba[j], o);
#pragma unroll
      for (int k = 0; k < KP; ++k)
        dwa[k][j] += __shfl_xor_sync(kFull, dwa[k][j], o);
    }
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      dga[k] += __shfl_xor_sync(kFull, dga[k], o);
      dbt[k] += __shfl_xor_sync(kFull, dbt[k], o);
    }
  }
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
    if (tid / 32 == w && (tid & 31) < CW) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k >= p.cin) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) rdw[k * p.cout + c0 + j] += dwa[k][j];
        if (cg == 0) {
          rdg[k] += dga[k];
          rdg[KP + k] += dbt[k];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) rdb[c0 + j] += dba[j];
    }
    __syncthreads();
  }
  for (int i = tid; i < p.cin * p.cout; i += blockDim.x) atomicAdd(&p.dw[i], rdw[i]);
  for (int i = tid; i < p.cout; i += blockDim.x) atomicAdd(&p.db[i], rdb[i]);
  if (p.pro.norm && tid < p.cin) {
    atomicAdd(&p.dg[tid], rdg[tid]);
    atomicAdd(&p.dbeta[tid], rdg[KP + tid]);
  }
}

// --------------------------------------------------------------------------
// narrow: Cin 128, C <= MAXC classes; LPR lanes a row, each CPL channels
// --------------------------------------------------------------------------

constexpr int kNarrowCin = 128;

struct NarrowArgs {
  const bf16* x;
  const float* mu;
  const float* inv;
  const float* gamma;
  const float* beta;
  const void* w;  // f32 (w_f32) or bf16, rounded to bf16 as it is staged
  int w_f32;
  const float* bias;
  void* y;  // the logits layer's forward
  float* s1;
  float* s2;
  int out_f32;
  const long long* labels;  // row 17
  const float* cw;
  float* acc;
  const float* ct;
  const void* dy;  // the logits layer's backward
  int dy_f32;
  const bf16* yin;
  const float* ds1;
  const float* ds2;
  bf16* dx;
  float* dw;
  float* db;
  float* dg;
  float* dbeta;
  long long n;
  int c;
  Pro pro;
};

enum { kModeY = 0, kModeCE = 1, kModeDy = 2, kModeCEBwd = 3 };

// a lane's CPL channels of row r (zeros past N), in one 16-byte (8-byte)
// load
template <int CPL>
__device__ __forceinline__ uint4 narrow_load(const NarrowArgs& p, long long r,
                                             int k0) {
  if (r >= p.n) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* src = p.x + r * kNarrowCin + k0;
  if constexpr (CPL == 8) return *reinterpret_cast<const uint4*>(src);
  const uint2 q = *reinterpret_cast<const uint2*>(src);
  return make_uint4(q.x, q.y, 0u, 0u);
}

// row r's label for the CE modes (-1 past N and in the others)
template <int MODE>
__device__ __forceinline__ long long narrow_label(const NarrowArgs& p,
                                                  long long r) {
  if constexpr (MODE == kModeCE || MODE == kModeCEBwd)
    return r < p.n ? p.labels[r] : -1;
  return -1;
}

template <int MAXC, int LPR, int MODE>
__device__ __forceinline__ void narrow_body(const NarrowArgs& p) {
  constexpr int CPL = kNarrowCin / LPR;  // channels a lane: 8 or 4
  constexpr int GPW = 32 / LPR;          // rows a warp takes at once
  constexpr bool kBwd = MODE >= kModeDy;
  constexpr int kRed = kNarrowCin * MAXC + 2 * kNarrowCin + 2 * MAXC + 3;
  // W as f32 [i][lane][c] (channel k = lane * CPL + i): the lanes of a row
  // read adjacent 16-byte runs
  __shared__ __align__(16) float ws[kNarrowCin * MAXC];
  __shared__ float vec[4 * kNarrowCin];
  __shared__ float bias[MAXC], cwt[MAXC];
  __shared__ float red[kRed];
  const int tid = threadIdx.x, lane = tid & 31, l = lane % LPR;
  const int C = p.c;
  for (int e = tid; e < kNarrowCin * MAXC; e += blockDim.x) {
    const int c = e % MAXC, kk = e / MAXC;
    const int k = (kk % LPR) * CPL + kk / LPR;
    ws[e] = c < C ? round_bf16(w_at(p.w, p.w_f32, (size_t)k * C + c)) : 0.f;
  }
  if (p.pro.norm)
    for (int k = tid; k < kNarrowCin; k += blockDim.x) {
      vec[k] = p.mu[k];
      vec[kNarrowCin + k] = p.inv[k];
      vec[2 * kNarrowCin + k] = p.gamma[k];
      vec[3 * kNarrowCin + k] = p.beta[k];
    }
  if (tid < MAXC) {
    bias[tid] = tid < C && p.bias != nullptr ? p.bias[tid] : 0.f;
    cwt[tid] = tid < C && p.cw != nullptr ? p.cw[tid] : 0.f;
  }
  for (int i = tid; i < kRed; i += blockDim.x) red[i] = 0.f;
  __syncthreads();

  // the lane's prologue vectors and, where it fits in registers, its W
  // slice, read once for all its rows
  const float* wl = ws + l * MAXC;
  const int k0 = l * CPL;
  constexpr bool kWReg = CPL * MAXC <= 64;
  float wr[kWReg ? CPL : 1][kWReg ? MAXC : 1];
  if constexpr (kWReg)
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int c = 0; c < MAXC; ++c) wr[i][c] = wl[i * LPR * MAXC + c];
  auto wv = [&](int i, int c) -> float {
    if constexpr (kWReg) return wr[i][c];
    return wl[i * LPR * MAXC + c];
  };
  float vm[CPL], vi[CPL], vg[CPL], vb[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    vm[i] = vec[k0 + i];
    vi[i] = vec[kNarrowCin + k0 + i];
    vg[i] = vec[2 * kNarrowCin + k0 + i];
    vb[i] = vec[3 * kNarrowCin + k0 + i];
  }
  float s1a = 0.f, s2a = 0.f, num = 0.f, den = 0.f, cor = 0.f, dba = 0.f;
  float dwa[kBwd ? CPL : 1][kBwd ? MAXC : 1], dga[CPL], dbt[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    dga[i] = dbt[i] = 0.f;
    if constexpr (kBwd)
#pragma unroll
      for (int c = 0; c < MAXC; ++c) dwa[i][c] = 0.f;
  }
  const int nwarps = blockDim.x / 32;
  const float ct = MODE == kModeCEBwd ? p.ct[0] : 0.f;
  // row 17's prologue is always normalize + ReLU without dropout: constant
  // flags there let the compiler drop their branches
  Pro pro = p.pro;
  if constexpr (MODE == kModeCE || MODE == kModeCEBwd) {
    pro.norm = 1;
    pro.relu = 1;
    pro.drop = 0;
  }
  // warp-uniform trips (the shuffles need every lane); the x slices and
  // labels of the next three trips' rows are in flight while one is worked
  const long long step = (long long)gridDim.x * nwarps * GPW;
  const long long first = ((long long)blockIdx.x * nwarps + tid / 32) * GPW;
  const int lr = lane / LPR;
  uint4 q0 = narrow_load<CPL>(p, first + lr, k0),
        q1 = narrow_load<CPL>(p, first + step + lr, k0),
        q2 = narrow_load<CPL>(p, first + 2 * step + lr, k0);
  long long l0 = narrow_label<MODE>(p, first + lr),
            l1 = narrow_label<MODE>(p, first + step + lr),
            l2 = narrow_label<MODE>(p, first + 2 * step + lr);
#pragma unroll 1
  for (long long wr = first; wr < p.n; wr += step) {
    const long long r = wr + lr;
    const bool valid = r < p.n;
    const uint4 qx = q0;
    const long long lab0 = l0;
    q0 = q1;
    q1 = q2;
    q2 = narrow_load<CPL>(p, wr + 3 * step + lr, k0);
    l0 = l1;
    l1 = l2;
    l2 = narrow_label<MODE>(p, wr + 3 * step + lr);
    float xv[CPL];
    {
      const uint32_t* w32 = &qx.x;
#pragma unroll
      for (int i = 0; i < CPL / 2; ++i) {
        xv[2 * i] = bf16_lo(w32[i]);
        xv[2 * i + 1] = bf16_hi(w32[i]);
      }
    }
    Elem e[CPL];
    float a[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      e[i] = pro_elem(xv[i], vm[i], vi[i], vg[i], vb[i],
                      (uint64_t)r * kNarrowCin + k0 + i, pro);
      a[i] = round_bf16(e[i].a);
    }
    float lg[MAXC];
    if constexpr (MODE != kModeDy) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) lg[c] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int c = 0; c < MAXC; ++c) lg[c] = fmaf(a[i], wv(i, c), lg[c]);
      if constexpr (MAXC == 4 && LPR == 16) {
        // 4 classes over 16 lanes: a reduce-scatter leaves class 4 b3 / 8
        // + b2 / 4 (lane bits 3, 2) summed in each quad of lanes, then the
        // row's lanes gather the four (9 shuffles instead of 16)
        const bool b3 = lane & 8, b2 = lane & 4;
        const float v0 = (b3 ? lg[2] : lg[0]) +
                         __shfl_xor_sync(kFull, b3 ? lg[0] : lg[2], 8);
        const float v1 = (b3 ? lg[3] : lg[1]) +
                         __shfl_xor_sync(kFull, b3 ? lg[1] : lg[3], 8);
        float v = (b2 ? v1 : v0) + __shfl_xor_sync(kFull, b2 ? v0 : v1, 4);
        v += __shfl_xor_sync(kFull, v, 2);
        v += __shfl_xor_sync(kFull, v, 1);
        v += bias[(lane >> 2) & 3];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          lg[c] = __shfl_sync(kFull, v, (lane & 16) + 4 * c);
      } else {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
          for (int c = 0; c < MAXC; ++c)
            lg[c] += __shfl_xor_sync(kFull, lg[c], o);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) lg[c] += bias[c];
      }
    }
    if constexpr (MODE == kModeY) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) v = c == l ? lg[c] : v;
      if (valid && l < C) {
        if (p.out_f32)
          static_cast<float*>(p.y)[r * C + l] = v;
        else
          static_cast<bf16*>(p.y)[r * C + l] = __float2bfloat16_rn(v);
        s1a += v;
        s2a += v * v;
      }
    }
    const long long lab = lab0;
    // the softmax: lane l of a row takes class l's exponential, and the
    // row's lanes sum them by a butterfly
    float mx = 0.f, se = 0.f, exl = 0.f;
    if constexpr (MODE == kModeCE || MODE == kModeCEBwd) {
      mx = lg[0];
      float lgl = lg[0];
#pragma unroll
      for (int c = 1; c < MAXC; ++c) {
        if (c < C) mx = fmaxf(mx, lg[c]);
        lgl = c == l ? lg[c] : lgl;
      }
      exl = l < C ? expf(lgl - mx) : 0.f;
      se = exl;
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) se += __shfl_xor_sync(kFull, se, o);
    }
    if constexpr (MODE == kModeCE) {
      if (l == 0 && lab >= 0 && lab < C) {
        int pred = -1;
        float tl = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < C && pred < 0 && lg[c] == mx) pred = c;
          if (c == lab) tl = lg[c];
        }
        const float wr = cwt[lab];
        num += wr * ((logf(se) + mx) - tl);
        den += wr;
        cor += pred == lab ? 1.f : 0.f;
      }
    }
    if constexpr (kBwd) {
      float dl[MAXC];
      if constexpr (MODE == kModeCEBwd) {
        // lane l's dlogit of class l, then every lane gets the row's
        const float wr = (lab >= 0 && lab < C) ? cwt[lab] : 0.f;
        const float s = __fmul_rn(ct, wr);
        const float dll =
            l < C ? __fmul_rn(s, __fsub_rn(__fdiv_rn(exl, se),
                                           l == lab ? 1.f : 0.f))
                  : 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          dl[c] = __shfl_sync(kFull, dll, (lane & ~(LPR - 1)) + c);
      } else {
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          float d = 0.f;
          if (valid && c < C) {
            const long long o = r * C + c;
            d = p.dy_f32 ? static_cast<const float*>(p.dy)[o]
                         : __bfloat162float(static_cast<const bf16*>(p.dy)[o]);
            if (p.ds1 != nullptr)
              d = __fadd_rn(__fadd_rn(d, p.ds1[c]),
                            __fmul_rn(__fmul_rn(2.f, __bfloat162float(
                                                         p.yin[o])),
                                      p.ds2[c]));
          }
          dl[c] = d;
        }
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        dba += c == l ? dl[c] : 0.f;
        dl[c] = round_bf16(dl[c]);
      }
      float dxv[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float da = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) da = fmaf(dl[c], wv(i, c), da);
        const float dz = pro_dz(da, e[i], pro);
        dxv[i] = pro.norm ? __fmul_rn(__fmul_rn(dz, vg[i]), vi[i]) : dz;
        if (valid) {
          dga[i] += __fmul_rn(dz, e[i].xh);
          dbt[i] += dz;
#pragma unroll
          for (int c = 0; c < MAXC; ++c) dwa[i][c] = fmaf(a[i], dl[c], dwa[i][c]);
        }
      }
      if (valid) {
        bf16* dst = p.dx + r * kNarrowCin + k0;
        if constexpr (CPL == 8) {
          *reinterpret_cast<uint4*>(dst) = pack8(dxv);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(
              pack_bf16x2(dxv[0], dxv[1]), pack_bf16x2(dxv[2], dxv[3]));
        }
      }
    }
  }

  // the block's sums (the row groups of a warp folded first), then one
  // atomic a value and block
  if constexpr (LPR < 32) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      dga[i] += __shfl_xor_sync(kFull, dga[i], 16);
      dbt[i] += __shfl_xor_sync(kFull, dbt[i], 16);
      if constexpr (kBwd)
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          dwa[i][c] += __shfl_xor_sync(kFull, dwa[i][c], 16);
    }
    s1a += __shfl_xor_sync(kFull, s1a, 16);
    s2a += __shfl_xor_sync(kFull, s2a, 16);
    dba += __shfl_xor_sync(kFull, dba, 16);
  }
  const bool lead = lane < LPR;  // one row group of the warp adds
  float* rdw = red;
  float* rdg = red + kNarrowCin * MAXC;
  float* rc = rdg + 2 * kNarrowCin;  // [2][MAXC], then num, den, correct
  if constexpr (MODE == kModeCE) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      num += __shfl_xor_sync(kFull, num, o);
      den += __shfl_xor_sync(kFull, den, o);
      cor += __shfl_xor_sync(kFull, cor, o);
    }
  }
  // the warps add in turn, with plain stores (a float atomic on shared
  // memory is a compare-and-swap loop)
  for (int w = 0; w < nwarps; ++w) {
    if (tid / 32 == w && lead) {
      if constexpr (MODE == kModeY) {
        if (l < C) {
          rc[l] += s1a;
          rc[MAXC + l] += s2a;
        }
      } else if constexpr (MODE == kModeCE) {
        if (lane == 0) {
          rc[2 * MAXC] += num;
          rc[2 * MAXC + 1] += den;
          rc[2 * MAXC + 2] += cor;
        }
      } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int k = k0 + i;
#pragma unroll
          for (int c = 0; c < MAXC; ++c) rdw[k * MAXC + c] += dwa[i][c];
          rdg[k] += dga[i];
          rdg[kNarrowCin + k] += dbt[i];
        }
        if (l < C) rc[l] += dba;
      }
    }
    __syncthreads();
  }
  if constexpr (MODE == kModeY) {
    if (p.s1 != nullptr && tid < C) {
      atomicAdd(&p.s1[tid], rc[tid]);
      atomicAdd(&p.s2[tid], rc[MAXC + tid]);
    }
  } else if constexpr (MODE == kModeCE) {
    if (tid < 3) atomicAdd(&p.acc[tid], rc[2 * MAXC + tid]);
  } else {
    for (int i = tid; i < kNarrowCin * C; i += blockDim.x)
      atomicAdd(&p.dw[i], rdw[(i / C) * MAXC + i % C]);
    if (p.pro.norm)
      for (int k = tid; k < kNarrowCin; k += blockDim.x) {
        atomicAdd(&p.dg[k], rdg[k]);
        atomicAdd(&p.dbeta[k], rdg[kNarrowCin + k]);
      }
    if (tid < C) atomicAdd(&p.db[tid], rc[tid]);
  }
}

// --------------------------------------------------------------------------
// row 17's backward at up to 8 classes on the tensor cores: a warp takes 16
// rows, mma.sync m16n8k16 (bf16, f32 sums) runs the logits, dlogits @ W^T
// and a^T @ dlogits; the prologue, softmax and ReLU mask work in the
// fragments' layouts, so no value is moved between lanes but dlogits'
// 8 x 8 blocks (movmatrix). Above 8 classes (to the op's 32) the FMA
// narrow_body pass runs instead: here a thread would hold dW's 128 x C
// partial in 4 C registers (128 at 32 classes) beside dgamma / dbeta's 64
// and the 64 of x and a, which spills
// --------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8 x 8 b16 matrix held one 32-bit pair a lane
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y)
               : "r"(x));
  return y;
}

constexpr int kCeMmaThreads = 256;

// Thread (g = lane / 4, t = lane % 4) of a warp's 16-row tile holds rows g
// and g + 8 at channels 16 s + 8 hh + 2 t + e (s < 8, hh, e < 2): the A
// fragments of the logits product, and the C fragments of dA, the same
// 64 elements.
__global__ void __launch_bounds__(kCeMmaThreads) ce_seg4_bwd_mma_kernel(
    const NarrowArgs p) {
  // B fragments, bf16 pairs, a lane's: the logits' (slice s: W rows 16 s +
  // 2 t (+1) and + 8, class g) and dA's (slice j: classes 2 t (+1), channel
  // 8 j + g)
  __shared__ uint32_t wlog[8][32][2];
  __shared__ uint32_t wda[16][32];
  __shared__ __align__(8) float vec[4][kNarrowCin];
  __shared__ float bias[8], cwt[8];
  __shared__ float red[kNarrowCin * 8 + 2 * kNarrowCin + 8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the four vectors at a channel pair (ch, ch + 1), one 8-byte load each
  auto vec2 = [&](int v, int ch) -> float2 {
    return *reinterpret_cast<const float2*>(&vec[v][ch]);
  };
  const int g = lane >> 2, t = lane & 3;
  const int C = p.c;
  auto wb = [&](int k, int c) -> float {  // bf16-rounded W[k][c], 0 past C
    return c < C ? round_bf16(w_at(p.w, p.w_f32, (size_t)k * C + c)) : 0.f;
  };
  for (int i = tid; i < 8 * 32; i += blockDim.x) {
    const int ss = i / 32, l = i % 32, gg = l >> 2, tt = l & 3;
    const int k = 16 * ss + 2 * tt;
    wlog[ss][l][0] = pack_bf16x2(wb(k, gg), wb(k + 1, gg));
    wlog[ss][l][1] = pack_bf16x2(wb(k + 8, gg), wb(k + 9, gg));
  }
  for (int i = tid; i < 16 * 32; i += blockDim.x) {
    const int j = i / 32, l = i % 32, gg = l >> 2, tt = l & 3;
    wda[j][l] = pack_bf16x2(wb(8 * j + gg, 2 * tt), wb(8 * j + gg, 2 * tt + 1));
  }
  for (int k = tid; k < kNarrowCin; k += blockDim.x) {
    vec[0][k] = p.mu[k];
    vec[1][k] = p.inv[k];
    vec[2][k] = p.gamma[k];
    vec[3][k] = p.beta[k];
  }
  if (tid < 8) {
    bias[tid] = tid < C ? p.bias[tid] : 0.f;
    cwt[tid] = tid < C ? p.cw[tid] : 0.f;
  }
  for (int i = tid; i < kNarrowCin * 8 + 2 * kNarrowCin + 8; i += blockDim.x)
    red[i] = 0.f;
  __syncthreads();

  const float ct = p.ct[0];
  const int c0 = 2 * t, c1 = 2 * t + 1;  // the lane's classes in C fragments
  float dwacc[8][4], dga[16][2], dbt[16][2], db0 = 0.f, db1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dwacc[i][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) dga[j][0] = dga[j][1] = dbt[j][0] = dbt[j][1] = 0.f;
  const int nwarps = blockDim.x / 32;
  for (long long tile = (long long)blockIdx.x * nwarps + warp;
       tile * 16 < p.n; tile += (long long)gridDim.x * nwarps) {
    const long long ra = tile * 16 + g, rb = ra + 8;
    const bool va = ra < p.n, vb = rb < p.n;
    // x in the A fragments' layout: xr[s][q], q = (row b) + 2 hh
    uint32_t xr[8][4];
#pragma unroll
    for (int s8 = 0; s8 < 8; ++s8)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool v = (q & 1) ? vb : va;
        const long long r = (q & 1) ? rb : ra;
        xr[s8][q] = v ? *reinterpret_cast<const uint32_t*>(
                            p.x + r * kNarrowCin + 16 * s8 + 8 * (q >> 1) + c0)
                      : 0u;
      }
    // the prologue: a (bf16, the A fragments) and the ReLU mask bits;
    // rows a and b (q, q + 1) share a channel pair's vectors
    uint32_t af[8][4], mask[2] = {0u, 0u};
#pragma unroll
    for (int s8 = 0; s8 < 8; ++s8)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ch = 16 * s8 + 8 * hh + c0;
        const float2 mu = vec2(0, ch), iv = vec2(1, ch), ga = vec2(2, ch),
                     be = vec2(3, ch);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = h + 2 * hh;
          const float z0 = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(bf16_lo(xr[s8][q]), mu.x), iv.x),
                        ga.x),
              be.x);
          const float z1 = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(bf16_hi(xr[s8][q]), mu.y), iv.y),
                        ga.y),
              be.y);
          af[s8][q] = pack_bf16x2(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
          const int bit = (s8 * 4 + q) * 2;
          mask[bit >> 5] |= ((z0 > 0.f ? 1u : 0u) | (z1 > 0.f ? 2u : 0u))
                            << (bit & 31);
        }
      }
    // logits: C fragment (row a: classes c0, c1; row b: c0, c1)
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s8 = 0; s8 < 8; ++s8)
      mma16816(lg, af[s8], wlog[s8][lane][0], wlog[s8][lane][1]);
    lg[0] += bias[c0];
    lg[1] += bias[c1];
    lg[2] += bias[c0];
    lg[3] += bias[c1];
    // softmax and dlogits of rows a (lg[0..1]) and b (lg[2..3]); a row's 8
    // classes sit in the 4 lanes of its quad
    float dl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l0 = lg[2 * h], l1 = lg[2 * h + 1];
      float mx = fmaxf(c0 < C ? l0 : -INFINITY, c1 < C ? l1 : -INFINITY);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float e0 = c0 < C ? expf(l0 - mx) : 0.f;
      const float e1 = c1 < C ? expf(l1 - mx) : 0.f;
      float se = e0 + e1;
      se += __shfl_xor_sync(kFull, se, 1);
      se += __shfl_xor_sync(kFull, se, 2);
      const bool v = h ? vb : va;
      const long long lab = v ? p.labels[h ? rb : ra] : -1;
      const float wr = (lab >= 0 && lab < C) ? cwt[lab] : 0.f;
      const float sc = __fmul_rn(ct, wr);
      dl[2 * h] = c0 < C ? __fmul_rn(sc, __fsub_rn(__fdiv_rn(e0, se),
                                                   c0 == lab ? 1.f : 0.f))
                         : 0.f;
      dl[2 * h + 1] = c1 < C ? __fmul_rn(sc, __fsub_rn(__fdiv_rn(e1, se),
                                                       c1 == lab ? 1.f : 0.f))
                             : 0.f;
    }
    db0 += dl[0] + dl[2];
    db1 += dl[1] + dl[3];
    // dlogits in bf16, the A fragment of dA (classes 8-15 zero)
    const uint32_t adl[4] = {pack_bf16x2(dl[0], dl[1]),
                             pack_bf16x2(dl[2], dl[3]), 0u, 0u};
    // dW += a^T @ dl: A = a^T (blocks transposed and swapped), B = dl^T
    const uint32_t bdl0 = movtrans(adl[0]), bdl1 = movtrans(adl[1]);
#pragma unroll
    for (int s8 = 0; s8 < 8; ++s8) {
      const uint32_t at[4] = {movtrans(af[s8][0]), movtrans(af[s8][2]),
                              movtrans(af[s8][1]), movtrans(af[s8][3])};
      mma16816(dwacc[s8], at, bdl0, bdl1);
    }
    // dA = dl @ W^T, 8 channels a slice; then the mask, dx, dgamma, dbeta
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float da[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(da, adl, wda[j][lane], 0u);
      const int s8 = j >> 1, hh = j & 1, ch = 8 * j + c0;
      const float2 mu = vec2(0, ch), iv = vec2(1, ch), ga = vec2(2, ch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = h + 2 * hh;
        float dxo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = (s8 * 4 + q) * 2 + e;
          const bool on = (mask[bit >> 5] >> (bit & 31)) & 1u;
          const float xv = e ? bf16_hi(xr[s8][q]) : bf16_lo(xr[s8][q]);
          const float xh = __fmul_rn(__fsub_rn(xv, e ? mu.y : mu.x),
                                     e ? iv.y : iv.x);
          const float dz = __fmul_rn(da[2 * h + e], on ? 1.f : 0.f);
          dxo[e] = __fmul_rn(__fmul_rn(dz, e ? ga.y : ga.x), e ? iv.y : iv.x);
          dga[j][e] += __fmul_rn(dz, xh);
          dbt[j][e] += dz;
        }
        if (h ? vb : va)
          *reinterpret_cast<uint32_t*>(p.dx + (h ? rb : ra) * kNarrowCin +
                                       ch) = pack_bf16x2(dxo[0], dxo[1]);
      }
    }
  }

  // the block's sums: fold the 8 lane groups of a warp, then the warps add
  // in turn (plain stores: a float atomic on shared memory is a
  // compare-and-swap loop)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dga[j][e] += __shfl_xor_sync(kFull, dga[j][e], o);
        dbt[j][e] += __shfl_xor_sync(kFull, dbt[j][e], o);
      }
    db0 += __shfl_xor_sync(kFull, db0, o);
    db1 += __shfl_xor_sync(kFull, db1, o);
  }
  float* rdw = red;                        // [128][8]
  float* rdg = red + kNarrowCin * 8;       // [2][128]
  float* rdb = rdg + 2 * kNarrowCin;       // [8]
  for (int w = 0; w < nwarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int s8 = 0; s8 < 8; ++s8) {   // (channel 16 s + g (+8), c0, c1)
        const int ch = 16 * s8 + g;
        rdw[ch * 8 + c0] += dwacc[s8][0];
        rdw[ch * 8 + c1] += dwacc[s8][1];
        rdw[(ch + 8) * 8 + c0] += dwacc[s8][2];
        rdw[(ch + 8) * 8 + c1] += dwacc[s8][3];
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rdg[8 * j + c0 + e] += dga[j][e];
            rdg[kNarrowCin + 8 * j + c0 + e] += dbt[j][e];
          }
        rdb[c0] += db0;
        rdb[c1] += db1;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < kNarrowCin * C; i += blockDim.x)
    atomicAdd(&p.dw[i], rdw[(i / C) * 8 + i % C]);
  for (int k = tid; k < kNarrowCin; k += blockDim.x) {
    atomicAdd(&p.dg[k], rdg[k]);
    atomicAdd(&p.dbeta[k], rdg[kNarrowCin + k]);
  }
  if (tid < C) atomicAdd(&p.db[tid], rdb[tid]);
}

// the logits layer (row 15 at Cout <= 32) and row 17, by name for the
// profilers' stages
template <int MAXC, int LPR>
__global__ void chain_narrow_fwd_kernel(
    const NarrowArgs p) {
  narrow_body<MAXC, LPR, kModeY>(p);
}

template <int MAXC, int LPR>
__global__ void chain_narrow_bwd_kernel(
    const NarrowArgs p) {
  narrow_body<MAXC, LPR, kModeDy>(p);
}

template <int MAXC, int LPR>
__global__ void ce_seg4_fwd_kernel(
    const NarrowArgs p) {
  narrow_body<MAXC, LPR, kModeCE>(p);
}

template <int MAXC, int LPR>
__global__ void ce_seg4_bwd_kernel(
    const NarrowArgs p) {
  narrow_body<MAXC, LPR, kModeCEBwd>(p);
}

// --------------------------------------------------------------------------
// W for the wgmma kernels: f32 (or bf16) -> bf16 in the accumulators' order
// --------------------------------------------------------------------------

// index 32 q + 8 r + 2 t + e of the kernels' operand holds W's 32 q + 8 t
// + 2 r + e (ops/fused_block.py perm32, the same map)
__device__ __forceinline__ int perm32i(int j) {
  return (j & ~31) | (((j >> 1) & 3) << 3) | (((j >> 3) & 3) << 1) | (j & 1);
}

// f32 sums that a launch's kernels add into, cleared by its first kernel
struct Zeros {
  float* p[5];
  long long n[5];
};

__device__ __forceinline__ void clear(const Zeros& z) {
#pragma unroll
  for (int j = 0; j < 5; ++j)
    if (z.p[j] != nullptr)
      for (long long i = blockIdx.x * 256ll + threadIdx.x; i < z.n[j];
           i += gridDim.x * 256ll)
        z.p[j][i] = 0.f;
}

// the forward's W: each group of 32 columns permuted
__global__ void __launch_bounds__(256) chain_wprep_fwd_kernel(
    const void* __restrict__ w, int w_f32, bf16* __restrict__ out, int cin,
    int cout, const Zeros z) {
  clear(z);
  const int total = cin * cout;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total;
       i += gridDim.x * 256) {
    const int r = i / cout, c = i - r * cout;
    out[i] = __float2bfloat16_rn(w_at(w, w_f32, (size_t)r * cout + perm32i(c)));
  }
}

// dx's W: each group of 32 rows permuted
__global__ void __launch_bounds__(256) chain_wprep_bwd_kernel(
    const void* __restrict__ w, int w_f32, bf16* __restrict__ out, int cin,
    int cout, const Zeros z) {
  clear(z);
  const int total = cin * cout;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total;
       i += gridDim.x * 256) {
    const int r = i / cout, c = i - r * cout;
    out[i] = __float2bfloat16_rn(w_at(w, w_f32, (size_t)perm32i(r) * cout + c));
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

enum Route { kInvalid = 0, kWgmma = 1, kSimt = 2, kNarrow = 3 };

// the same rule as ops/fused_block.py route_of
Route route_of(int cin, int cout) {
  if (cin >= 1 && cin <= 16 && (cout == 64 || cout == 128 || cout == 256))
    return kSimt;
  if (cin == kNarrowCin && cout >= 1 && cout <= 32) return kNarrow;
  if (cin > 0 && cout > 0 && cin % 64 == 0 && cout % 64 == 0 &&
      cin <= kMaxCin && cout <= kMaxCout)
    return kWgmma;
  return kInvalid;
}

int cdiv_int(long long a, long long b) { return (int)((a + b - 1) / b); }

// the sums a launch adds into start at zero: cleared here, on the stream,
// so that the wrapper allocates them without a fill of its own; ranges that
// follow each other in memory (the wrappers' one allocation) take one
// memset
cudaError_t zero(std::initializer_list<std::pair<void*, long long>> ranges,
                 cudaStream_t s) {
  char* begin = nullptr;
  char* end = nullptr;
  for (const auto& r : ranges) {
    if (r.first == nullptr || r.second <= 0) continue;
    char* b = static_cast<char*>(r.first);
    if (b != end) {
      if (begin != nullptr) {
        const cudaError_t err = cudaMemsetAsync(begin, 0, end - begin, s);
        if (err != cudaSuccess) return err;
      }
      begin = b;
    }
    end = b + r.second * 4;
  }
  return begin != nullptr ? cudaMemsetAsync(begin, 0, end - begin, s)
                          : cudaSuccess;
}

// the opt-in maximum of dynamic shared memory, set once a kernel (each
// launch function below is its own template instance)
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  done = err == cudaSuccess;
  return err;
}

Pro make_pro(const void* mu, int relu, uint32_t key, uint32_t thr,
             float scale, int drop) {
  Pro p;
  p.norm = mu != nullptr;
  p.relu = relu;
  p.drop = drop;
  p.key = key;
  p.thr = thr;
  p.scale = scale;
  return p;
}

// One block an SM, as many threads as the kernel's registers allow (at
// most 1024): the blocks' sums then reach each address of device memory
// once an SM (a grid of ~1,000 small blocks adding into a few addresses
// serialized on those atomics)
template <typename Kernel>
int wide_threads(Kernel kernel) {
  cudaFuncAttributes attr;
  int t = 256;
  if (cudaFuncGetAttributes(&attr, kernel) == cudaSuccess)
    t = attr.maxThreadsPerBlock < 1024 ? attr.maxThreadsPerBlock : 1024;
  return t / 64 * 64;
}

// ---- wgmma route

template <int BN, int KREG, bool DROP>
cudaError_t launch_wgmma_fwd_k(const CUtensorMap& mx, const CUtensorMap& mw,
                               const FwdArgs& a, cudaStream_t s) {
  auto kernel = chain_wgmma_fwd_kernel<BN, KREG, DROP>;
  const int smem = FwdCfg<BN>::smem(a.cin, a.cout);
  static bool done = false;
  cudaError_t err = allow_smem_once(kernel, done);
  if (err != cudaSuccess) return err;
  const int grid =
      a.tiles < hopper_host::sm_count() ? a.tiles : hopper_host::sm_count();
  kernel<<<grid, kThreads, smem, s>>>(mx, mw, a);
  return cudaGetLastError();
}

template <int BN, int KREG>
cudaError_t launch_wgmma_fwd(const CUtensorMap& mx, const CUtensorMap& mw,
                             const FwdArgs& a, cudaStream_t s) {
  return a.pro.drop ? launch_wgmma_fwd_k<BN, KREG, true>(mx, mw, a, s)
                    : launch_wgmma_fwd_k<BN, KREG, false>(mx, mw, a, s);
}

// N tile of the forward: 256 only where Cin > 128 (the fragments are
// rebuilt each K step), else 128 or 64; KREG: Cin / 64 where Cin <= 128
int fwd_bn(int cin, int cout) {
  if (cin > 128 && cout % 256 == 0) return 256;
  return cout % 128 == 0 ? 128 : 64;
}

cudaError_t wgmma_fwd(const void* x, const void* w, FwdArgs& a,
                      cudaStream_t s) {
  const int bn = fwd_bn(a.cin, a.cout);
  CUtensorMap mx, mw;
  if (!hopper_host::map_bf16(&mx, x, a.n, a.cin, kBM) ||
      !hopper_host::map_bf16(&mw, w, a.cin, a.cout, kBK))
    return cudaErrorInvalidValue;
  a.tiles = cdiv_int(a.n, kBM);
  const int kreg = a.cin <= 128 ? a.cin / 64 : 0;
  if (bn == 256) return launch_wgmma_fwd<256, 0>(mx, mw, a, s);
  if (bn == 128) {
    if (kreg == 1) return launch_wgmma_fwd<128, 1>(mx, mw, a, s);
    if (kreg == 2) return launch_wgmma_fwd<128, 2>(mx, mw, a, s);
    return launch_wgmma_fwd<128, 0>(mx, mw, a, s);
  }
  if (kreg == 1) return launch_wgmma_fwd<64, 1>(mx, mw, a, s);
  if (kreg == 2) return launch_wgmma_fwd<64, 2>(mx, mw, a, s);
  return launch_wgmma_fwd<64, 0>(mx, mw, a, s);
}

cudaError_t launch_dx(const void* d, const void* wt, const void* x,
                      DxArgs& a, cudaStream_t s) {
  CUtensorMap md, mw, mx;
  if (!hopper_host::map_bf16(&md, d, a.n, a.cout, kBM) ||
      !hopper_host::map_bf16(&mw, wt, a.cin, a.cout, kDxBN) ||
      !hopper_host::map_bf16(&mx, x, a.n, a.cin, kBM))
    return cudaErrorInvalidValue;
  static bool done[2] = {false, false};
  auto kernel = a.pro.drop ? chain_wgmma_dx_kernel<true>
                           : chain_wgmma_dx_kernel<false>;
  cudaError_t err = allow_smem_once(kernel, done[a.pro.drop ? 1 : 0]);
  if (err != cudaSuccess) return err;
  a.col_tiles = a.cin / kDxBN;
  // two blocks an SM, a whole number of them on each column tile, each
  // walking the row tiles
  const int row_tiles = cdiv_int(a.n, kBM);
  int per_ct = 2 * hopper_host::sm_count() / a.col_tiles;
  if (per_ct < 1) per_ct = 1;
  if (per_ct > row_tiles) per_ct = row_tiles;
  kernel<<<per_ct * a.col_tiles, kThreads, kDxSmem, s>>>(md, mw, mx, a);
  return cudaGetLastError();
}

template <int BN, int WGM>
cudaError_t launch_dw(const void* a_scr, const void* d, DwArgs& a,
                      cudaStream_t s) {
  CUtensorMap ma, md;
  if (!hopper_host::map_bf16(&ma, a_scr, a.n, a.cin, kBK) ||
      !hopper_host::map_bf16(&md, d, a.n, a.cout, kBK))
    return cudaErrorInvalidValue;
  auto kernel = chain_wgmma_dw_kernel<BN, WGM>;
  static bool done = false;
  cudaError_t err = allow_smem_once(kernel, done);
  if (err != cudaSuccess) return err;
  a.row_tiles = a.cin / (64 * WGM);
  a.col_tiles = a.cout / BN;
  const int tiles = a.row_tiles * a.col_tiles;
  const long long total = (a.n + kBK - 1) / kBK;
  long long splits = hopper_host::sm_count() / tiles;
  if (splits < 1) splits = 1;
  if (splits > total) splits = total;
  a.ksteps = (int)((total + splits - 1) / splits);
  splits = (total + a.ksteps - 1) / a.ksteps;
  kernel<<<(int)(tiles * splits), kThreads, DwCfg<BN, WGM>::kSmem, s>>>(ma, md,
                                                                       a);
  return cudaGetLastError();
}

template <int WGM>
cudaError_t dw_by_width(const void* a_scr, const void* d, DwArgs& a,
                        cudaStream_t s) {
  if (a.cout % 256 == 0) return launch_dw<256, WGM>(a_scr, d, a, s);
  if (a.cout % 128 == 0) return launch_dw<128, WGM>(a_scr, d, a, s);
  return launch_dw<64, WGM>(a_scr, d, a, s);
}

// The one-sweep backward's shape: where a block's dW partial fits in 32
// or 64 registers a thread (64 x 64: KSPLIT; 64 x 128 / 256: the N
// halves; 128 x 64 / 128: the M halves) and its tiles fit in shared
// memory; else the split kernels: conv5 and seg2 (dW 128 x 1024 and 512 x
// 256 would be 512 registers a thread; ptxas holds these kernels to 168),
// seg1 (its dy and y tiles, 128 x 512 each, do not fit beside d and W),
// and seg3 (256 x 128, 128 registers a thread, spills; as two blocks a row
// tile, each with half of Cin and forming the whole d, it ran 0.203-0.234
// ms against the split's 0.177-0.196: profile_row15.py). Building with
// -DPCSEG_CHAIN_SWEEP=0 sends every layer to the split (profile_row15.py
// times the two against each other).
#ifndef PCSEG_CHAIN_SWEEP
#define PCSEG_CHAIN_SWEEP 1
#endif

struct SweepCfg {
  int nw;
  bool ksplit;
  int rc, stages, xstages, smem;
};

constexpr int kMaxSmem = 232448;  // the opt-in maximum a block

bool sweep_cfg(int cin, int cout, SweepCfg& c) {
  if (!PCSEG_CHAIN_SWEEP) return false;
  c.ksplit = cin == 64 && cout == 64;
  if (c.ksplit)
    c.nw = 64;
  else if (cin == 64 && (cout == 128 || cout == 256))
    c.nw = cout / 2;
  else if (cin == 128 && (cout == 64 || cout == 128))
    c.nw = cout;
  else
    return false;
  // two x buffers, then the deepest chunks, that fit
  c.stages = 2;
  for (c.xstages = 2; c.xstages >= 1; --c.xstages)
    for (c.rc = 8192 / cout; c.rc >= 16; c.rc /= 2) {
      c.smem = 1024 + SweepLayout(cin, cout, c.rc, c.stages, c.xstages).total;
      if (c.smem <= kMaxSmem) return true;
    }
  return false;
}

template <int NW, bool KSPLIT, bool DROP>
cudaError_t launch_sweep_k(const CUtensorMap (&m)[4], const SweepArgs& a,
                           int smem, cudaStream_t s) {
  auto kernel = chain_wgmma_bwd_kernel<NW, KSPLIT, DROP>;
  static bool done = false;
  cudaError_t err = allow_smem_once(kernel, done);
  if (err != cudaSuccess) return err;
  const int grid =
      a.tiles < hopper_host::sm_count() ? a.tiles : hopper_host::sm_count();
  kernel<<<grid, kThreads, smem, s>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <int NW, bool KSPLIT>
cudaError_t launch_sweep(const CUtensorMap (&m)[4], const SweepArgs& a,
                         int smem, cudaStream_t s) {
  return a.pro.drop ? launch_sweep_k<NW, KSPLIT, true>(m, a, smem, s)
                    : launch_sweep_k<NW, KSPLIT, false>(m, a, smem, s);
}

cudaError_t sweep(const void* dy, const void* y, const void* x,
                  const void* wq, SweepArgs& a, const SweepCfg& c,
                  cudaStream_t s) {
  CUtensorMap m[4];
  if (!hopper_host::map_bf16(&m[0], dy, a.n, a.cout, c.rc) ||
      (y != nullptr && !hopper_host::map_bf16(&m[1], y, a.n, a.cout, c.rc)) ||
      !hopper_host::map_bf16(&m[2], x, a.n, a.cin, kBM) ||
      !hopper_host::map_bf16(&m[3], wq, a.cin, a.cout, 64))
    return cudaErrorInvalidValue;
  if (y == nullptr) m[1] = m[0];  // not read without stats
  a.rc = c.rc;
  a.stages = c.stages;
  a.xstages = c.xstages;
  a.tiles = cdiv_int(a.n, kBM);
  if (c.ksplit) return launch_sweep<64, true>(m, a, c.smem, s);
  if (c.nw == 128) return launch_sweep<128, false>(m, a, c.smem, s);
  return launch_sweep<64, false>(m, a, c.smem, s);
}

// ---- simt-K route

template <typename Kernel, typename Args>
cudaError_t launch_wide(Kernel kernel, const Args& a, cudaStream_t s) {
  kernel<<<hopper_host::sm_count(), wide_threads(kernel), 0, s>>>(a);
  return cudaGetLastError();
}

template <int KP, int CW>
cudaError_t launch_simt(bool fwd, const SimtArgs& a, cudaStream_t s) {
  return fwd ? launch_wide(chain_simt_fwd_kernel<KP, CW>, a, s)
             : launch_wide(chain_simt_bwd_kernel<KP, CW>, a, s);
}

template <int KP>
cudaError_t simt_by_width(bool fwd, const SimtArgs& a, cudaStream_t s) {
  if (a.cout == 64) return launch_simt<KP, 8>(fwd, a, s);
  if (a.cout == 128) return launch_simt<KP, 16>(fwd, a, s);
  return launch_simt<KP, 32>(fwd, a, s);
}

cudaError_t simt(bool fwd, const SimtArgs& a, cudaStream_t s) {
  if (a.cin <= 4) return simt_by_width<4>(fwd, a, s);
  if (a.cin <= 8) return simt_by_width<8>(fwd, a, s);
  return simt_by_width<16>(fwd, a, s);
}

// ---- narrow route

template <int MAXC, int LPR>
cudaError_t launch_narrow(int mode, const NarrowArgs& a, cudaStream_t s) {
  switch (mode) {
    case kModeY:
      return launch_wide(chain_narrow_fwd_kernel<MAXC, LPR>, a, s);
    case kModeDy:
      return launch_wide(chain_narrow_bwd_kernel<MAXC, LPR>, a, s);
    case kModeCE:
      return launch_wide(ce_seg4_fwd_kernel<MAXC, LPR>, a, s);
    default:  // row 17's backward: up to 8 classes, ce_seg4_bwd_mma_kernel
      if constexpr (MAXC > 8)
        return launch_wide(ce_seg4_bwd_kernel<MAXC, LPR>, a, s);
      return cudaErrorInvalidValue;
  }
}

cudaError_t narrow(int mode, const NarrowArgs& a, cudaStream_t s) {
  if (mode == kModeCEBwd && a.c <= 8) {
    ce_seg4_bwd_mma_kernel<<<hopper_host::sm_count(), kCeMmaThreads, 0, s>>>(
        a);
    return cudaGetLastError();
  }
  if (a.c <= 4) return launch_narrow<4, 16>(mode, a, s);
  if (a.c <= 8) return launch_narrow<8, 16>(mode, a, s);
  if (a.c <= 16) return launch_narrow<16, 32>(mode, a, s);
  return launch_narrow<32, 32>(mode, a, s);
}

NarrowArgs narrow_args(const void* x, const void* mu, const void* inv,
                       const void* gamma, const void* beta, const void* w,
                       int w_f32, const void* b, long long n, int c,
                       const Pro& pro) {
  NarrowArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.mu = static_cast<const float*>(mu);
  a.inv = static_cast<const float*>(inv);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.w = w;
  a.w_f32 = w_f32;
  a.bias = static_cast<const float*>(b);
  a.n = n;
  a.c = c;
  a.pro = pro;
  return a;
}

}  // namespace

extern "C" {

// x (N, Cin) bf16; mu, inv, gamma, beta (Cin,) f32, or null (no normalize
// step); w (Cin, Cout) f32 (w_f32) or bf16, rounded to bf16 here; wq
// (Cin, Cout) bf16 scratch of the wgmma route (W rounded, each group of 32
// columns in the kernel's order, ops/fused_block.py perm32); b (Cout,)
// f32; row_bias (N / rpb, Cout) f32 or null (wgmma route only); y (N,
// Cout) bf16 or f32 (out_f32); s1, s2 (Cout,) f32 (zeroed here), or
// null.
int pcseg_chain_fwd(const void* x, const void* mu, const void* inv,
                    const void* gamma, const void* beta, const void* w,
                    void* wq, const void* b, const void* row_bias, void* y,
                    void* s1, void* s2, long long n, int cin, int cout,
                    long long rpb, int relu, uint32_t key, uint32_t thr,
                    float scale, int drop, int w_f32, int out_f32,
                    void* stream) {
  const Route route = route_of(cin, cout);
  if (route == kInvalid || n <= 0 || n >= (1ll << 31) ||
      (row_bias != nullptr && (route != kWgmma || rpb <= 0 || n % rpb)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pro pro = make_pro(mu, relu, key, thr, scale, drop);
  cudaError_t err;
  if (route == kWgmma) {
    FwdArgs a;
    a.mu = static_cast<const float*>(mu);
    a.inv = static_cast<const float*>(inv);
    a.gamma = static_cast<const float*>(gamma);
    a.beta = static_cast<const float*>(beta);
    a.bias = static_cast<const float*>(b);
    a.row_bias = static_cast<const float*>(row_bias);
    a.y = y;
    a.s1 = static_cast<float*>(s1);
    a.s2 = static_cast<float*>(s2);
    a.n = n;
    a.rpb = rpb > 0 ? rpb : 1;
    a.cin = cin;
    a.cout = cout;
    a.out_f32 = out_f32;
    a.tiles = 0;
    a.pro = pro;
    const Zeros z = {{static_cast<float*>(s1), static_cast<float*>(s2),
                      nullptr, nullptr, nullptr},
                     {cout, cout, 0, 0, 0}};
    chain_wprep_fwd_kernel<<<cdiv_int((long long)cin * cout, 256), 256, 0,
                             s>>>(w, w_f32, static_cast<bf16*>(wq), cin, cout,
                                  z);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)wgmma_fwd(x, wq, a, s);
  }
  err = zero({{s1, cout}, {s2, cout}}, s);
  if (err != cudaSuccess) return (int)err;
  if (route == kSimt) {
    SimtArgs a = {};
    a.x = static_cast<const bf16*>(x);
    a.mu = static_cast<const float*>(mu);
    a.inv = static_cast<const float*>(inv);
    a.gamma = static_cast<const float*>(gamma);
    a.beta = static_cast<const float*>(beta);
    a.w = w;
    a.w_f32 = w_f32;
    a.bias = static_cast<const float*>(b);
    a.y = y;
    a.s1 = static_cast<float*>(s1);
    a.s2 = static_cast<float*>(s2);
    a.n = n;
    a.cin = cin;
    a.cout = cout;
    a.out_f32 = out_f32;
    a.pro = pro;
    return (int)simt(true, a, s);
  }
  NarrowArgs a =
      narrow_args(x, mu, inv, gamma, beta, w, w_f32, b, n, cout, pro);
  a.y = y;
  a.s1 = static_cast<float*>(s1);
  a.s2 = static_cast<float*>(s2);
  a.out_f32 = out_f32;
  return (int)narrow(kModeY, a, s);
}

// w (Cin, Cout) f32 (w_f32) or bf16; wq (Cin, Cout) bf16 scratch of the
// wgmma route (W rounded, each group of 32 rows in the kernel's order);
// y (N, Cout) bf16
// or null (no stats: ds1, ds2 null); dy (N, Cout) bf16 or f32 (dy_f32);
// dx (N, Cin) bf16; dw (Cin, Cout), db (Cout,), dg and dbeta (Cin,) and
// drb (N / rpb, Cout) f32, zeroed here (dg, dbeta null without a
// normalize step, drb without a row bias); d_scr (N, Cout) and a_scr (N,
// Cin) bf16 scratch of the wgmma route's split kernels (null on the other
// routes and where the one sweep runs: ops/fused_block.py one_sweep, the
// same rule as sweep_cfg).
int pcseg_chain_bwd(const void* x, const void* mu, const void* inv,
                    const void* gamma, const void* beta, const void* w,
                    void* wq, const void* y, const void* dy, const void* ds1,
                    const void* ds2, void* dx, void* dw, void* db, void* dg,
                    void* dbeta, void* drb, void* d_scr, void* a_scr,
                    int w_f32, int dy_f32, long long n, int cin, int cout,
                    long long rpb, int relu, uint32_t key, uint32_t thr,
                    float scale, int drop, void* stream) {
  const Route route = route_of(cin, cout);
  if (route == kInvalid || n <= 0 || n >= (1ll << 31) ||
      (drb != nullptr && (route != kWgmma || rpb <= 0 || n % rpb)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pro pro = make_pro(mu, relu, key, thr, scale, drop);
  cudaError_t err;
  if (route == kWgmma) {
    const Zeros z = {{static_cast<float*>(dw), static_cast<float*>(db),
                      static_cast<float*>(dg), static_cast<float*>(dbeta),
                      static_cast<float*>(drb)},
                     {(long long)cin * cout, cout, cin, cin,
                      drb != nullptr ? (n / rpb) * cout : 0}};
    SweepCfg cfg;
    const bool one_sweep =
        !dy_f32 && drb == nullptr && sweep_cfg(cin, cout, cfg);
    if (!one_sweep && (d_scr == nullptr || a_scr == nullptr))
      return (int)cudaErrorInvalidValue;
    chain_wprep_bwd_kernel<<<cdiv_int((long long)cin * cout, 256), 256, 0,
                             s>>>(w, w_f32, static_cast<bf16*>(wq), cin, cout,
                                  z);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (one_sweep) {
      SweepArgs a;
      a.mu = static_cast<const float*>(mu);
      a.inv = static_cast<const float*>(inv);
      a.gamma = static_cast<const float*>(gamma);
      a.beta = static_cast<const float*>(beta);
      a.ds1 = static_cast<const float*>(ds1);
      a.ds2 = static_cast<const float*>(ds2);
      a.dx = static_cast<bf16*>(dx);
      a.dw = static_cast<float*>(dw);
      a.db = static_cast<float*>(db);
      a.dg = static_cast<float*>(dg);
      a.dbeta = static_cast<float*>(dbeta);
      a.n = n;
      a.cin = cin;
      a.cout = cout;
      a.pro = pro;
      return (int)sweep(dy, ds1 != nullptr ? y : nullptr, x, wq, a, cfg, s);
    }
    const int cw = cout / 8 < 32 ? cout / 8 : 32;
    chain_cotangent_kernel<<<dim3(cdiv_int(n, kCotRows),
                                  cdiv_int(cout, cw * 8)),
                             256, 0, s>>>(
        dy, dy_f32, static_cast<const bf16*>(y),
        static_cast<const float*>(ds1), static_cast<const float*>(ds2),
        static_cast<bf16*>(d_scr), static_cast<float*>(db),
        static_cast<float*>(drb), rpb > 0 ? rpb : 1, n, cout, cw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    DxArgs a;
    a.mu = static_cast<const float*>(mu);
    a.inv = static_cast<const float*>(inv);
    a.gamma = static_cast<const float*>(gamma);
    a.beta = static_cast<const float*>(beta);
    a.dx = static_cast<bf16*>(dx);
    a.a = static_cast<bf16*>(a_scr);
    a.dg = static_cast<float*>(dg);
    a.dbeta = static_cast<float*>(dbeta);
    a.n = n;
    a.cin = cin;
    a.cout = cout;
    a.pro = pro;
    err = launch_dx(d_scr, wq, x, a, s);
    if (err != cudaSuccess) return (int)err;
    DwArgs wa;
    wa.dw = static_cast<float*>(dw);
    wa.n = n;
    wa.cin = cin;
    wa.cout = cout;
    return (int)(cin % 128 == 0 ? dw_by_width<2>(a_scr, d_scr, wa, s)
                                : dw_by_width<1>(a_scr, d_scr, wa, s));
  }
  err = zero({{dw, (long long)cin * cout}, {db, cout}, {dg, cin},
              {dbeta, cin}},
             s);
  if (err != cudaSuccess) return (int)err;
  if (route == kSimt) {
    SimtArgs a = {};
    a.x = static_cast<const bf16*>(x);
    a.mu = static_cast<const float*>(mu);
    a.inv = static_cast<const float*>(inv);
    a.gamma = static_cast<const float*>(gamma);
    a.beta = static_cast<const float*>(beta);
    a.w = w;
    a.w_f32 = w_f32;
    a.dy = dy;
    a.dy_f32 = dy_f32;
    a.yin = static_cast<const bf16*>(y);
    a.ds1 = static_cast<const float*>(ds1);
    a.ds2 = static_cast<const float*>(ds2);
    a.dx = static_cast<bf16*>(dx);
    a.dw = static_cast<float*>(dw);
    a.db = static_cast<float*>(db);
    a.dg = static_cast<float*>(dg);
    a.dbeta = static_cast<float*>(dbeta);
    a.n = n;
    a.cin = cin;
    a.cout = cout;
    a.pro = pro;
    return (int)simt(false, a, s);
  }
  NarrowArgs a =
      narrow_args(x, mu, inv, gamma, beta, w, w_f32, nullptr, n, cout, pro);
  a.dy = dy;
  a.dy_f32 = dy_f32;
  a.yin = static_cast<const bf16*>(y);
  a.ds1 = static_cast<const float*>(ds1);
  a.ds2 = static_cast<const float*>(ds2);
  a.dx = static_cast<bf16*>(dx);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.dg = static_cast<float*>(dg);
  a.dbeta = static_cast<float*>(dbeta);
  return (int)narrow(kModeDy, a, s);
}

// 1 where pcseg_chain_bwd runs the split kernels at this width (they need
// its d_scr and a_scr), 0 where it runs the one sweep or another route
int pcseg_chain_bwd_split(int cin, int cout, int dy_f32, int row_bias) {
  SweepCfg cfg;
  return route_of(cin, cout) == kWgmma &&
         (dy_f32 || row_bias || !sweep_cfg(cin, cout, cfg));
}

// x (N, 128) bf16; mu, inv, gamma, beta (128,) f32; w (128, C) f32
// (w_f32) or bf16, C <= 32; b, cw (C,) f32; labels (N,) int64, -1 at padding; acc (3,) f32
// (zeroed here): num, den, correct.
int pcseg_seg4_ce_fwd(const void* x, const void* mu, const void* inv,
                      const void* gamma, const void* beta, const void* w,
                      const void* b, const void* labels, const void* cw,
                      void* acc, int w_f32, long long n, int cin, int c,
                      void* stream) {
  if (cin != kNarrowCin || c < 1 || c > 32 || n <= 0 || n >= (1ll << 31) ||
      mu == nullptr)
    return (int)cudaErrorInvalidValue;
  NarrowArgs a = narrow_args(x, mu, inv, gamma, beta, w, w_f32, b, n, c,
                             make_pro(mu, 1, 0, 0, 1.f, 0));
  a.labels = static_cast<const long long*>(labels);
  a.cw = static_cast<const float*>(cw);
  a.acc = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = zero({{acc, 3}}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)narrow(kModeCE, a, s);
}

// ct (1,) f32, the cotangent of num; dx (N, 128) bf16; dw (128, C), db
// (C,), dg and dbeta (128,) f32, zeroed here.
int pcseg_seg4_ce_bwd(const void* x, const void* mu, const void* inv,
                      const void* gamma, const void* beta, const void* w,
                      const void* b, const void* labels, const void* cw,
                      const void* ct, void* dx, void* dw, void* db, void* dg,
                      void* dbeta, int w_f32, long long n, int cin, int c,
                      void* stream) {
  if (cin != kNarrowCin || c < 1 || c > 32 || n <= 0 || n >= (1ll << 31) ||
      mu == nullptr)
    return (int)cudaErrorInvalidValue;
  NarrowArgs a = narrow_args(x, mu, inv, gamma, beta, w, w_f32, b, n, c,
                             make_pro(mu, 1, 0, 0, 1.f, 0));
  a.labels = static_cast<const long long*>(labels);
  a.cw = static_cast<const float*>(cw);
  a.ct = static_cast<const float*>(ct);
  a.dx = static_cast<bf16*>(dx);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.dg = static_cast<float*>(dg);
  a.dbeta = static_cast<float*>(dbeta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      zero({{dw, (long long)cin * c}, {db, c}, {dg, cin}, {dbeta, cin}}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)narrow(kModeCEBwd, a, s);
}

}  // extern "C"
