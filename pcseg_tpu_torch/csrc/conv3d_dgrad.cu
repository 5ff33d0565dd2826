// The voxel U-Net's 3^3 SAME conv, forward, dgrad and wgrad, on Hopper's
// tensor cores (sm_90a): implicit GEMMs on one ring of planes with
// fixed-order sums.
//
//   pcseg_conv3x3_mma  replaces pcseg_tpu/ops/pallas/conv3d_block.py
//       fused_conv3x3_p / fused_conv3x3_add_p (_kernel, pallas_call at
//       :429): a = bf16(relu(x scale + shift)) computed in f32 without FMA
//       contraction (x itself without the activation), zeros outside the
//       grid (the padding of the activated input), v = conv(a, W) + bias
//       (+ accum) with bf16 W and f32 sums, y = bf16(v) and, with the
//       stats, the per-(batch, channel) (sum v, sum v^2) of the f32 v.
//   pcseg_conv3x3_dgrad_mma  replaces _dgrad_pallas (_dgrad_kernel,
//       pallas_call at :546): g' = bf16(gy + (gs1 + 2 gs2 y)) (gy itself
//       without the stats cotangent), da = conv(g', flip(W)^T) with zero
//       padding, dx = bf16([pre > 0] da scale) with pre = x scale + shift,
//       dscale = sum dam x and dshift = sum dam per (batch, channel), and,
//       with gadj, the bf16 g' of every voxel (the add variant's accum
//       gradient). Without the activation dx = bf16(da) and there are no
//       sums.
//   pcseg_conv3x3_wgrad_mma  replaces _wgrad_pallas (_wgrad_kernel,
//       pallas_call at :648): dW[t][ci][co] = sum over voxels v of a[v +
//       delta_t][ci] g'[v][co] with the forward's a (zero padding) and the
//       dgrad's g', and dbias = sum g', bf16 products, f32 sums, dW as (3,
//       3, 3, Cin, Cout).
//
// A 3^3 dgrad is a 3^3 SAME conv of g' with the taps flipped and the
// weights' input and output axes swapped, so forward and dgrad run one
// kernel template (ring_gemm<C, FWD>). For each voxel (a row of M) the
// GEMM has K = 27 C (the taps' input channels) and N = C. The two differ
// in three places: how a ring plane is formed (the forward's prologue, or
// g'), the packed weights the wrapper hands over (ops/conv3d_block.py
// pack_conv_w, row t = W[t]^T; pack_dgrad_w, row t = W[26 - t]; both
// [tap][n][k], bf16), and the epilogue (+ bias (+ accum) and the stats, or
// the activation's gradient and dscale / dshift). The wgrad is the third
// GEMM on the same ring: for each tap, M = Cin, N = Cout and K = the
// voxels, both operands voxel-major in shared memory (the ring at the
// tap's shift, the tile's own g'), so both are read by ldmatrix.trans.
// What bounds them on an H100: bytes. At B8 64^3 x 16 the forward moves
// x and y once (134 MB, 0.040 ms at 3.35 TB/s), the dgrad gy, y, x and dx
// (268 MB, 0.080 ms) and the wgrad x, gy and y (201 MB, 0.060 ms), each
// for 29 GFLOP (0.029 ms at 989 TFLOP/s); 32^3 x 32 and 16^3 x 64 move 4x
// and 16x fewer bytes for the same FLOPs. The design keeps every input
// element staged about 1.5 times and every product on mma.sync:
//
// - walking depth: a block owns one batch element, a plane tile of TH rows
//   x TW columns (TH TW = 256 voxels, 128 at 64 channels; TW = W up to
//   kWmax, 64 (32 at 64 channels), else column tiles of kWmax) and a range
//   of depth planes. It keeps a ring of three input planes in shared
//   memory (Ring), each (TH + 2) x (TW + 2) voxels x C bf16 with a halo
//   read from the neighbouring rows and columns, zeros only outside the
//   grid, so a wider grid costs no more shared memory or halo a voxel than
//   W = kWmax: output plane d reads
//   planes d - 1, d, d + 1 (the TPU kernel's rolling 3-plane window) while
//   plane d + 2's source is in flight in registers, loaded before plane
//   d's products and stored after them into the slot that plane d - 1
//   leaves; the depth ranges are as many as keep the grid in one wave of
//   resident blocks (two an SM at up to 16 channels);
// - a ring element is formed once on its way into shared memory: the
//   forward's (and the wgrad's) bf16(relu(x scale + shift)) or the
//   dgrad's bf16(gy + (gs1 + 2 gs2 y)), zeros outside the grid; with gadj
//   the dgrad's same step writes the g' of the block's own voxels, each
//   exactly once;
// - the taps: a voxel's C channels are whole 16-byte units, so each of
//   the 27 taps is the ring read at a shifted voxel by ldmatrix; the units
//   are swizzled by bits of their voxel (swl) so that the 8 voxels of an
//   ldmatrix matrix meet 8 distinct bank groups at any shift. A warp's
//   m16 tiles are stacked along H, so one A fragment (a ring row at one
//   kx shift) serves the three ky taps of up to two tiles: the A
//   traffic, which bounds the sweep on shared memory at 16 channels (N =
//   16: two n8 tiles an A fragment), is (MW + 2) / 3 MW of a tap-by-tap
//   walk;
// - W is staged once a block as [tap][n][k] bf16, straight from the
//   wrapper's packing; at 64 channels a block takes 32 of the N columns
//   (grid z), so that W and the ring fit;
// - the epilogue reads its own voxels' input (the forward's accum, the
//   dgrad's x: TH segments of TW voxels at a stride of W) from a tile that
//   cp.async brought a plane ahead, writes the output over it in place
//   (each element by the thread that read it) and stores the tile in
//   16-byte units; the sums stay in registers;
// - the wgrad keeps dW in its warps' accumulators over the block's whole
//   depth range (WgCfg: a warp holds up to 4 taps' Cin x Cout, 128 f32 a
//   thread at most; at 64 channels one tap a warp and four tap groups as
//   grid z); the tile's own gy and y come a plane ahead by cp.async and
//   each thread forms g' in place on what it copied, adding it to its
//   dbias sums; the per-tap addresses are set once a plane, so the K loop
//   runs little besides ldmatrix and mma;
// - no float atomics: each block writes its sums as one row of a partial
//   table (the wgrad: its taps' slice of its K range's row, no larger in
//   all than the x and gy it reduces) and fixed_sum_kernel adds the rows
//   in a fixed order, so two calls on the same inputs give the same bits.
//
// Shapes: Cin = Cout = C in {8, 16, 32, 64} (the JAX fused core's widths,
// m16n8k8 at 8 for the forward and dgrad; the wgrad stacks two taps in an
// m16 tile there) and H a multiple of the tile's rows TH; W in {16, 32,
// 64} (16, 32 at 64 channels: TW = W) or any multiple of kWmax (column
// tiles: W 128 and 256 at up to 32 channels, 64 and 128 at 64), one rule
// for the forward, the dgrad and the wgrad; ops/conv3d_block.py
// _conv_route states it, and every other shape keeps conv3d_block.cu's
// conv_kernel and wgrad_kernel.
//
// Plain C interface (loaded with ctypes): every entry returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue before
// any launch for a shape it does not take.

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using namespace mma_sync;
using hopper::bf16_hi;
using hopper::bf16_lo;
using hopper::pack_bf16x2;
using hopper::smem_u32;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 227 * 1024;

// Byte offset of 16-byte unit u of a tile whose voxels hold U units: the
// unit's index within its voxel XOR bits of the voxel (u >> 3 is the
// voxel's index over 8 / U), so that one unit of any 8 consecutive voxels
// falls in 8 distinct bank groups.
__device__ __forceinline__ uint32_t swl(int u, int U) {
  return (uint32_t)(u ^ ((u >> 3) & (U - 1))) * 16u;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

struct RingArgs {
  const __nv_bfloat16* src;   // the ring's planes (B, D, H, W, C): x or gy
  const __nv_bfloat16* y;     // dgrad: the forward's y (with gstats only)
  const float* gstats;        // dgrad: (B, 2, C) or null
  const __nv_bfloat16* tile;  // the epilogue's own voxels (B, D, H, W, C):
                              // accum (forward) or x (dgrad), or null
  const __nv_bfloat16* w;     // (27, C, C) bf16 [tap][n][k], packed
  const float* scale;         // (B, C), or null: no activation
  const float* shift;
  const float* bias;          // forward: (C,)
  __nv_bfloat16* out;         // y or dx (B, D, H, W, C)
  __nv_bfloat16* gadj;        // dgrad: bf16 g' (B, D, H, W, C) or null
  float* part;                // (B, gridDim.x, 2, C) block sums, or null
  int D, H, W, TH, TW, DD;    // TH rows, TW columns and DD planes a block
};

template <int C>
struct RingCfg {
  static constexpr int NS = C == 64 ? 32 : C;   // N columns a block
  // m16 tiles a warp, stacked along H, so that one A fragment (a ring
  // row at one kx shift) serves up to three of them (the three ky taps)
  static constexpr int MW = C == 64 ? 1 : 2;
  static constexpr int M = kWarps * MW * 16;    // voxels a plane tile
  static constexpr int U = C / 8;               // ring units a voxel
  static constexpr int UX = NS / 8;             // epilogue units a voxel
  static constexpr int NW = NS / 8;             // n8 tiles a warp
  static constexpr int KS = C >= 16 ? C / 16 : 1;   // k-steps a tap
  static constexpr int kW = 27 * NS * C * 2;    // W slice [27][NS][C]
  static constexpr int kX = M * NS * 2;         // epilogue tile of a plane
  static constexpr int kVec = (2 * NS + 2 * C) * 4;
  // the widest tile (TW = W up to it, column tiles of it above): a ring
  // slot's voxels at it are the most of any W
  static constexpr int kWmax = C == 64 ? 32 : 64;
  static constexpr int kSlotMax = (M / kWmax + 2) * (kWmax + 2);
  static constexpr int RPT = (kSlotMax * U + kThreads - 1) / kThreads;
  static constexpr int kBlocks = C <= 16 ? 2 : 1;
};

// The ring of three input planes a block keeps in shared memory, each
// (TH + 2) x (TW + 2) voxels x C bf16: rows h0 - 1 .. h0 + TH and columns
// w0 - 1 .. w0 + TW, the halo read from the grid's neighbouring rows and
// columns, zeros outside the grid; and the plane in flight to it.
// fetch(pd) loads plane pd's source (and the dgrad's y) into registers,
// unit e = tid + 256 i of a slot, zeros outside the grid;
// put(pd, own) forms each element once on its way into the slot of plane
// pd: the forward's bf16(relu(x scale + shift)) (x itself without the
// activation), or the dgrad's g' = bf16(gy + (gs1 + 2 gs2 y)) (gy itself
// without the stats cotangent), and with ``own`` writes the g' of the
// block's own voxels (not the halo) to gadj. The forward, the dgrad and the
// wgrad (whose ring is the forward's) all fill their ring through it.
template <int C, bool FWD>
struct Ring {
  static constexpr int U = C / 8, RPT = RingCfg<C>::RPT;
  const __nv_bfloat16* src;
  const __nv_bfloat16* y;
  __nv_bfloat16* gadj;
  const float* k1;   // forward: scale; dgrad: gs1
  const float* k2;   // forward: shift; dgrad: 2 gs2
  uint8_t* base;
  int D, H, W, TH, TW, b, h0, w0, PW, PV, slot_bytes, tid;
  bool form;         // forward: the activation; dgrad: the stats term
  uint4 rsrc[RPT], ryv[RPT];
  uint32_t inside = 0;   // bit i: unit i is in the grid

  __device__ __forceinline__ Ring(const RingArgs& p, const float* k1_,
                                  const float* k2_, uint8_t* base_, int b_,
                                  int h0_, int w0_, int tid_, bool form_)
      : src(p.src), y(p.y), gadj(p.gadj), k1(k1_), k2(k2_), base(base_),
        D(p.D), H(p.H), W(p.W), TH(p.TH), TW(p.TW), b(b_), h0(h0_),
        w0(w0_), PW(p.TW + 2), PV((p.TH + 2) * (p.TW + 2)),
        slot_bytes(PV * C * 2), tid(tid_), form(form_) {}

  __device__ __forceinline__ uint8_t* slot_ptr(int pd) const {
    return base + ((pd % 3 + 3) % 3) * slot_bytes;
  }
  __device__ __forceinline__ uint32_t slot(int pd) const {
    return smem_u32(slot_ptr(pd));
  }

  __device__ __forceinline__ void fetch(int pd) {
    const bool pin = pd >= 0 && pd < D;
    inside = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int e = tid + i * kThreads;
      const int v = e / U, cu = e % U;
      const int hh = h0 - 1 + v / PW, ww = w0 - 1 + v % PW;
      const bool ok = e < PV * U && pin && hh >= 0 && hh < H && ww >= 0 &&
                      ww < W;
      rsrc[i] = ryv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        const size_t off =
            ((((size_t)b * D + pd) * H + hh) * W + ww) * C + cu * 8;
        rsrc[i] = *reinterpret_cast<const uint4*>(src + off);
        if (!FWD && form) ryv[i] = *reinterpret_cast<const uint4*>(y + off);
        inside |= 1u << i;
      }
    }
  }

  __device__ __forceinline__ void put(int pd, bool own) {
    uint8_t* s = slot_ptr(pd);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int e = tid + i * kThreads;
      if (e >= PV * U) break;
      uint4 q = rsrc[i];
      if (form && (inside >> i & 1)) {
        const int cu = e % U;
        float f[8];
        unpack8(q, f);
        if constexpr (FWD) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = cu * 8 + j;
            f[j] = fmaxf(__fadd_rn(__fmul_rn(f[j], k1[c]), k2[c]), 0.f);
          }
          q = pack8(f);
        } else {
          float yv[8];
          unpack8(ryv[i], yv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = cu * 8 + j;
            f[j] = __fadd_rn(f[j], __fadd_rn(k1[c], __fmul_rn(k2[c], yv[j])));
          }
          q = pack8(f);
          const int v = e / U, r = v / PW, cc = v % PW;
          if (own && r >= 1 && r <= TH && cc >= 1 && cc <= TW)
            *reinterpret_cast<uint4*>(
                gadj + ((((size_t)b * D + pd) * H + h0 - 1 + r) * W + w0 -
                        1 + cc) * C + cu * 8) = q;
        }
      }
      *reinterpret_cast<uint4*>(s + swl(e, U)) = q;
    }
  }
};

// One block: batch element blockIdx.y, N columns [z NS, (z + 1) NS) (z =
// blockIdx.z), rows [h0, h0 + TH), columns [w0, w0 + TW) and planes [d0,
// d1) by blockIdx.x (the plane tiles of a depth range row by row, then the
// depth ranges: at TW = W exactly the rows' order). Warp w takes the 16
// voxels at column group w % (TW / 16) of MW consecutive rows of each
// output plane, against the slice's NS columns. FWD: the forward conv;
// else the dgrad.
template <int C, bool FWD>
__device__ __forceinline__ void ring_gemm(const RingArgs& p) {
  using Cfg = RingCfg<C>;
  constexpr int NS = Cfg::NS, MW = Cfg::MW, U = Cfg::U, UX = Cfg::UX;
  constexpr int NW = Cfg::NW, KS = Cfg::KS, M = Cfg::M;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sw = smem;                            // W slice
  // the epilogue's per-column vectors (forward: bias; dgrad: scale,
  // shift) and the ring's per-channel ones (forward: scale, shift;
  // dgrad: gs1, 2 gs2 (exact))
  float* vn1 = reinterpret_cast<float*>(sw + Cfg::kW);
  float* vn2 = vn1 + NS;
  float* vk1 = vn2 + NS;
  float* vk2 = vk1 + C;
  uint8_t* sxt = reinterpret_cast<uint8_t*>(vk2 + C);   // 2 tiles
  uint8_t* ring = sxt + 2 * Cfg::kX;             // 3 slots
  const int W = p.W, H = p.H, D = p.D, TH = p.TH, TW = p.TW;
  const int PW = TW + 2;                         // a ring row's voxels
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nwt = W / TW, tiles = H / TH * nwt;
  const int tile = blockIdx.x % tiles;
  const int h0 = tile / nwt * TH, w0 = tile % nwt * TW;
  const int d0 = (blockIdx.x / tiles) * p.DD;
  const int d1 = min(D, d0 + p.DD);
  const int b = blockIdx.y, z = blockIdx.z;
  const bool stats = p.gstats != nullptr, act = p.scale != nullptr;
  const bool has_tile = p.tile != nullptr;
  // voxel v of a plane tile (row v / TW, column v % TW) in a (B, D, H, W,
  // C) grid, at plane pd
  auto grid_off = [&](int pd, int v) {
    return ((((size_t)b * D + pd) * H + h0 + v / TW) * W + w0 + v % TW) * C;
  };

  // W slice: row (tap, n) is the packed row tap, column z NS + n
  for (int e = tid; e < 27 * NS * U; e += kThreads) {
    const int tap = e / (NS * U), n = (e / U) % NS, ku = e % U;
    *reinterpret_cast<uint4*>(sw + swl(e, U)) =
        *reinterpret_cast<const uint4*>(
            p.w + ((size_t)tap * C + z * NS + n) * C + ku * 8);
  }
  for (int e = tid; e < NS; e += kThreads) {
    if constexpr (FWD) {
      vn1[e] = p.bias[z * NS + e];
      vn2[e] = 0.f;
    } else {
      vn1[e] = act ? p.scale[(size_t)b * C + z * NS + e] : 0.f;
      vn2[e] = act ? p.shift[(size_t)b * C + z * NS + e] : 0.f;
    }
  }
  for (int e = tid; e < C; e += kThreads) {
    if constexpr (FWD) {
      vk1[e] = act ? p.scale[(size_t)b * C + e] : 0.f;
      vk2[e] = act ? p.shift[(size_t)b * C + e] : 0.f;
    } else {
      vk1[e] = stats ? p.gstats[(size_t)b * 2 * C + e] : 0.f;
      vk2[e] = stats ? 2.f * p.gstats[(size_t)b * 2 * C + C + e] : 0.f;
    }
  }

  Ring<C, FWD> rs(p, vk1, vk2, ring, b, h0, w0, tid,
                  FWD ? act : stats);
  // the epilogue's input of plane pd's tile (the slice's channels) into
  // tile pd & 1
  auto load_tile = [&](int pd) {
    if (!has_tile) return;
    const uint32_t xs = smem_u32(sxt + (pd & 1) * Cfg::kX);
    for (int e = tid; e < M * UX; e += kThreads) {
      cp16(xs + swl(e, UX), p.tile + grid_off(pd, e / UX) + z * NS +
                                (e % UX) * 8, true);
    }
  };

  // with gadj, the dgrad's put writes the g' of the block's own voxels
  const bool gadj = !FWD && p.gadj != nullptr && z == 0;
  __syncthreads();   // the vectors (put reads them)
  for (int pd = d0 - 1; pd <= d0 + 1; ++pd) {
    rs.fetch(pd);
    rs.put(pd, gadj && pd >= d0 && pd < d1);
  }
  load_tile(d0);
  cp_commit();
  __syncthreads();

  // this warp's tiles: column group cg, rows rg MW .. rg MW + MW - 1;
  // vring: the lane's ldmatrix row in a ring slot at ring row rg MW, no
  // shift; vtile: its first tile's first voxel in the epilogue tile
  const int cgs = TW / 16, cg = warp % cgs, rg = warp / cgs;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vring = rg * MW * PW + cg * 16 + lrow;
  const int vtile = rg * MW * TW + cg * 16;
  float ds1[NW][2] = {}, ds2[NW][2] = {};
  const uint32_t sw_u = smem_u32(sw);

  for (int d = d0; d < d1; ++d) {
    const bool next = d + 2 <= d1;   // plane d + 2 is read at d + 1
    if (next) rs.fetch(d + 2);
    if (d + 1 < d1) load_tile(d + 1);
    cp_commit();

    float acc[MW][NW][4] = {};
    for (int kz = 0; kz < 3; ++kz) {
      const int pd = d + kz - 1;
      if (pd < 0 || pd >= D) continue;   // zero padding: no products
      const uint32_t slot_u = rs.slot(pd);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if constexpr (C == 8) {
            // m16n8k8: one n8 tile, one k8 step a tap
            uint32_t bq[3];
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
              ldsm1(bq[ky], sw_u + swl(((kz * 3 + ky) * 3 + kx) * NS +
                                           (lane & 7), U));
#pragma unroll
            for (int sr = 0; sr < MW + 2; ++sr) {
              uint32_t a[2];
              ldsm2(a, slot_u + swl(vring + sr * PW + kx, U));
#pragma unroll
              for (int mw = 0; mw < MW; ++mw)
                if (sr - mw >= 0 && sr - mw < 3)
                  mma_k8(acc[mw][0], a, bq[sr - mw]);
            }
          } else {
            uint32_t bf[3][NW][2];
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int np = 0; np < NW / 2; ++np) {
                uint32_t bb[4];
                ldsm4(bb, sw_u + swl((((kz * 3 + ky) * 3 + kx) * NS +
                                      16 * np + (lane & 7) +
                                      (lane >> 4) * 8) * U + 2 * ks +
                                         ((lane >> 3) & 1),
                                     U));
                bf[ky][2 * np][0] = bb[0];
                bf[ky][2 * np][1] = bb[1];
                bf[ky][2 * np + 1][0] = bb[2];
                bf[ky][2 * np + 1][1] = bb[3];
              }
#pragma unroll
            for (int sr = 0; sr < MW + 2; ++sr) {
              uint32_t a[4];
              ldsm4(a, slot_u + swl((vring + sr * PW + kx) * U + 2 * ks +
                                        (lane >> 4),
                                    U));
#pragma unroll
              for (int mw = 0; mw < MW; ++mw)
                if (sr - mw >= 0 && sr - mw < 3)
#pragma unroll
                  for (int nt = 0; nt < NW; ++nt)
                    mma(acc[mw][nt], a, bf[sr - mw][nt][0],
                        bf[sr - mw][nt][1]);
            }
          }
        }
    }
    cp_wait<1>();
    __syncthreads();   // tile d is in; the ring slot of d - 1 is free

    // epilogue over the tile in place. Forward: v = (acc + bias) (+
    // accum), y = bf16(v), (sum v, sum v^2). Dgrad: dam = [x scale +
    // shift > 0] da, dx = bf16(dam scale) (bf16(da) without the
    // activation), (sum dam x, sum dam).
    uint8_t* xs = sxt + (d & 1) * Cfg::kX;
#pragma unroll
    for (int mw = 0; mw < MW; ++mw)
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const int c = 8 * nt + 2 * t;
        const float n1[2] = {vn1[c], vn1[c + 1]}, n2[2] = {vn2[c], vn2[c + 1]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* px = reinterpret_cast<uint32_t*>(
              xs + swl((vtile + mw * TW + g + 8 * h) * UX + nt, UX) + 4 * t);
          float o[2];
          if constexpr (FWD) {
            o[0] = acc[mw][nt][2 * h] + n1[0];
            o[1] = acc[mw][nt][2 * h + 1] + n1[1];
            if (has_tile) {
              const uint32_t ap = *px;
              o[0] += bf16_lo(ap);
              o[1] += bf16_hi(ap);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              ds1[nt][j] += o[j];
              ds2[nt][j] += o[j] * o[j];
            }
          } else if (act) {
            const uint32_t xp = *px;
            const float xv[2] = {bf16_lo(xp), bf16_hi(xp)};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float pre = __fadd_rn(__fmul_rn(xv[j], n1[j]), n2[j]);
              const float dam = pre > 0.f ? acc[mw][nt][2 * h + j] : 0.f;
              o[j] = __fmul_rn(dam, n1[j]);
              ds1[nt][j] += dam * xv[j];
              ds2[nt][j] += dam;
            }
          } else {
            o[0] = acc[mw][nt][2 * h];
            o[1] = acc[mw][nt][2 * h + 1];
          }
          *px = pack_bf16x2(o[0], o[1]);
        }
      }
    __syncthreads();
    // the tile to the grid, plane d + 2 into the freed ring slot
    for (int e = tid; e < M * UX; e += kThreads)
      *reinterpret_cast<uint4*>(p.out + grid_off(d, e / UX) + z * NS +
                                (e % UX) * 8) =
          *reinterpret_cast<const uint4*>(xs + swl(e, UX));
    if (next) rs.put(d + 2, gadj && d + 2 < d1);
    __syncthreads();
  }
  if (p.part == nullptr) return;

  // the block's row of the partial table: the 8 row lanes of each warp,
  // then the warps, in a fixed order
  float* red = reinterpret_cast<float*>(ring);   // [8 warps][2][NS]
#pragma unroll
  for (int nt = 0; nt < NW; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a = group_sum(ds1[nt][j]), c = group_sum(ds2[nt][j]);
      if (g == 0) {
        red[warp * 2 * NS + 8 * nt + 2 * t + j] = a;
        red[warp * 2 * NS + NS + 8 * nt + 2 * t + j] = c;
      }
    }
  __syncthreads();
  for (int e = tid; e < 2 * NS; e += kThreads) {
    float v = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w * 2 * NS + e];
    p.part[(((size_t)b * gridDim.x + blockIdx.x) * 2 + e / NS) * C + z * NS +
           e % NS] = v;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, (RingCfg<C>::kBlocks))
    conv3x3_mma_kernel(const RingArgs p) {
  ring_gemm<C, true>(p);
}

template <int C>
__global__ void __launch_bounds__(kThreads, (RingCfg<C>::kBlocks))
    dgrad_mma_kernel(const RingArgs p) {
  ring_gemm<C, false>(p);
}

// ---------------------------------------------------------------- wgrad

// The wgrad's split of its 27 products dW[t] = A_t^T G' (Cin x Cout, K =
// the voxels, A_t the ring read at tap t's shift): a fragment is one tap's
// Cin x Cout (MT m16 x NT n8 tiles) or, at 8 channels, two taps' 8 x 8
// stacked in one m16 tile (taps 2f and 2f + 1; tap 27 is none). Warp w of
// tap group z (grid z) keeps fragments z FG + w + 8 j, j < TPW, in its
// accumulators for the block's whole depth range (at most 128 f32 a
// thread); a row of the partial table is one K range's dW and dbias.
template <int C>
struct WgCfg {
  static constexpr int NF = C == 8 ? 14 : 27;       // fragments
  static constexpr int TPW = C == 64 ? 1 : C == 8 ? 2 : 4;   // a warp
  static constexpr int MT = C == 8 ? 1 : C / 16;    // m16 tiles a fragment
  static constexpr int NT = C / 8;                  // n8 tiles a fragment
  static constexpr int FG = kWarps * TPW;           // fragments a block
  static constexpr int Z = (NF + FG - 1) / FG;      // tap groups (grid z)
  static constexpr int L = 27 * C * C + C;          // a table row
  static constexpr int kG = RingCfg<C>::M * C * 2;  // a g' tile
  static constexpr int kVec = 4 * C * 4;
  static constexpr int kBlocks = C <= 16 ? 2 : 1;
};

// One block: batch element blockIdx.y, tap group blockIdx.z, rows [h0, h0
// + TH), columns [w0, w0 + TW) and planes [d0, d1) by blockIdx.x, in
// ring_gemm's order (at TW = W the rows' order), walked as the forward
// walks them. COLS: column tiles; else whole rows, with TW = W and w0 = 0
// known at compile time, which keeps a register free in the K loop
// (without it the whole-row launches ran 2.7-3.5 % slower on an H100 80GB
// HBM3 at 700 W, profile_ring.py). The ring holds the activated input a
// of planes d - 1, d, d + 1 (the forward's prologue, through Ring); gy
// and y of the block's own voxels of plane d + 1 come by cp.async while
// plane d's products run, and each thread forms g' = bf16(gy + (gs1 + 2
// gs2 y)) in place on the units it copied, adding it to its dbias sums.
// For each 16 own voxels of a row (a K step) a warp reads g' (voxels x
// Cout) by ldmatrix.trans once and, for each of its taps, the ring at the
// tap's shift (voxels x Cin) by ldmatrix.trans, the swizzle keeping both
// conflict-free. At the end the block writes its dW fragments (and, tap
// group 0, dbias: its threads' sums in thread order) to row b gridDim.x +
// blockIdx.x of the table.
template <int C, bool COLS>
__global__ void __launch_bounds__(kThreads, (WgCfg<C>::kBlocks))
    wgrad_mma_kernel(const RingArgs p) {
  using Cfg = RingCfg<C>;
  using Wg = WgCfg<C>;
  constexpr int U = Cfg::U, M = Cfg::M, MT = Wg::MT, NT = Wg::NT;
  constexpr int TPW = Wg::TPW;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sg = smem;                     // 2 g' tiles [M][C]
  uint8_t* sy = sg + 2 * Wg::kG;          // y of the tile in flight
  float* vk1 = reinterpret_cast<float*>(sy + Wg::kG);   // scale
  float* vk2 = vk1 + C;                   // shift
  float* vg1 = vk2 + C;                   // gs1
  float* vg2 = vg1 + C;                   // 2 gs2 (exact)
  uint8_t* ring = reinterpret_cast<uint8_t*>(vg2 + C);  // 3 slots
  const int W = p.W, H = p.H, D = p.D, TH = p.TH;
  const int TW = COLS ? p.TW : W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nwt = COLS ? W / TW : 1, tiles = H / TH * nwt;
  const int tile = blockIdx.x % tiles;
  const int h0 = tile / nwt * TH, w0 = COLS ? tile % nwt * TW : 0;
  const int d0 = (blockIdx.x / tiles) * p.DD;
  const int d1 = min(D, d0 + p.DD);
  const int b = blockIdx.y, z = blockIdx.z;
  const bool stats = p.gstats != nullptr, act = p.scale != nullptr;

  for (int e = tid; e < C; e += kThreads) {
    vk1[e] = act ? p.scale[(size_t)b * C + e] : 0.f;
    vk2[e] = act ? p.shift[(size_t)b * C + e] : 0.f;
    vg1[e] = stats ? p.gstats[(size_t)b * 2 * C + e] : 0.f;
    vg2[e] = stats ? 2.f * p.gstats[(size_t)b * 2 * C + C + e] : 0.f;
  }
  Ring<C, true> rs(p, vk1, vk2, ring, b, h0, w0, tid, act);

  // gy (and y) of plane pd's own voxels (TH segments of TW at a stride of
  // W) into g' tile pd & 1 (and sy)
  auto load_g = [&](int pd) {
    const uint32_t gs = smem_u32(sg + (pd & 1) * Wg::kG), ys = smem_u32(sy);
    for (int e = tid; e < M * U; e += kThreads) {
      const int v = e / U;
      const size_t off =
          ((((size_t)b * D + pd) * H + h0 + v / TW) * W + w0 + v % TW) * C +
          (e % U) * 8;
      cp16(gs + swl(e, U), p.tile + off, true);
      if (stats) cp16(ys + swl(e, U), p.y + off, true);
    }
  };
  // g' of tile pd & 1 in place, each unit by the thread that copied it
  // (channels c0 .. c0 + 7, the same for all its units), into its sums
  float bsum[8] = {};
  const int c0 = (tid % U) * 8;
  auto form_g = [&](int pd) {
    uint8_t* gt = sg + (pd & 1) * Wg::kG;
    for (int e = tid; e < M * U; e += kThreads) {
      uint4* q = reinterpret_cast<uint4*>(gt + swl(e, U));
      float f[8];
      unpack8(*q, f);
      if (stats) {
        float yv[8];
        unpack8(*reinterpret_cast<const uint4*>(sy + swl(e, U)), yv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = __fadd_rn(f[j], __fadd_rn(vg1[c0 + j],
                                           __fmul_rn(vg2[c0 + j], yv[j])));
        const uint4 r = pack8(f);
        *q = r;
        unpack8(r, f);   // dbias sums the bf16 g'
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) bsum[j] += f[j];
    }
  };

  __syncthreads();   // the vectors (put and form_g read them)
  for (int pd = d0 - 1; pd <= d0 + 1; ++pd) {
    rs.fetch(pd);
    rs.put(pd, false);
  }
  load_g(d0);
  cp_commit();
  cp_wait<0>();
  form_g(d0);
  __syncthreads();

  // the lane's ldmatrix rows: A (ring, .trans) voxel lv of a K step's 16
  // and 8-row half lh (matrices: voxels 0-7 | 8-15 x half 0 | 1); B (g',
  // .trans) voxel bv (matrices: voxels 0-7 | 8-15 x n8 tile)
  const int lh = (lane >> 3) & 1;
  const int lv = (lane & 7) + (lane >> 4) * 8;
  const int bv = (lane & 7) + lh * 8;
  float acc[TPW][MT][NT][4] = {};

  for (int d = d0; d < d1; ++d) {
    const bool next = d + 2 <= d1;   // plane d + 2 is read at d + 1
    if (next) rs.fetch(d + 2);
    if (d + 1 < d1) load_g(d + 1);
    cp_commit();

    // this plane's A operand of each fragment: the ring slot of its tap's
    // plane (0: none, the fragment is empty or its plane outside the grid:
    // zero padding, no products; at 8 channels the slot of a plane outside
    // the grid holds zeros) and the lane's ring voxel at row 0, column 0
    // of the tile; tap 27 (8 channels) reads tap 26's and is dropped
    uint32_t a_slot[TPW];
    int a_off[TPW];
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int f = z * Wg::FG + warp + 8 * j;
      const int tap = C == 8 ? min(2 * f + lh, 26) : f;
      const int dz = tap / 9 - 1, dy = tap / 3 % 3 - 1, dx = tap % 3 - 1;
      const bool live =
          f < Wg::NF && (C == 8 || (d + dz >= 0 && d + dz < D));
      a_slot[j] = live ? rs.slot(d + dz) : 0u;
      a_off[j] = (1 + dy) * (TW + 2) + 1 + dx + lv;
    }
    const uint32_t g_u = smem_u32(sg + (d & 1) * Wg::kG);
    for (int r = 0; r < TH; ++r)
      for (int cc = 0; cc < TW; cc += 16) {
        const int vb = r * TW + cc + bv, vr = r * (TW + 2) + cc;
        uint32_t bf[NT][2];
        if constexpr (NT == 1) {
          uint32_t bb[2];
          ldsm2t(bb, g_u + swl(vb * U, U));
          bf[0][0] = bb[0];
          bf[0][1] = bb[1];
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bb[4];
            ldsm4t(bb, g_u + swl(vb * U + 2 * np + (lane >> 4), U));
            bf[2 * np][0] = bb[0];
            bf[2 * np][1] = bb[1];
            bf[2 * np + 1][0] = bb[2];
            bf[2 * np + 1][1] = bb[3];
          }
        }
#pragma unroll
        for (int j = 0; j < TPW; ++j) {
          if (a_slot[j] == 0u) continue;
          const int va = vr + a_off[j];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            ldsm4t(a, a_slot[j] +
                          swl(va * U + (C == 8 ? 0 : 2 * mt + lh), U));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma(acc[j][mt][nt], a, bf[nt][0], bf[nt][1]);
          }
        }
      }
    cp_wait<0>();
    __syncthreads();   // the ring slot of d - 1 and g' tile d are free
    if (next) rs.put(d + 2, false);
    if (d + 1 < d1) form_g(d + 1);
    __syncthreads();
  }

  // the block's row of the partial table: row g + 8 h of an m16 tile is
  // input channel 16 mt + g + 8 h of the fragment's tap (at 8 channels
  // channel g of tap 2f + h), column 8 nt + 2 t (+ 1) output channel
  float* row = p.part + ((size_t)b * gridDim.x + blockIdx.x) * Wg::L;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int f = z * Wg::FG + warp + 8 * j;
    if (f >= Wg::NF) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tap = C == 8 ? 2 * f + h : f;
        const int ci = C == 8 ? g : 16 * mt + g + 8 * h;
        if (tap >= 27) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(row + ((size_t)tap * C + ci) * C +
                                     8 * nt + 2 * t) =
              make_float2(acc[j][mt][nt][2 * h], acc[j][mt][nt][2 * h + 1]);
      }
  }
  if (z != 0) return;
  // dbias: channel c is held by the threads with tid % U == c / 8, summed
  // in thread order (the ring is no longer read)
  float* red = reinterpret_cast<float*>(ring);   // [256][8]
#pragma unroll
  for (int j = 0; j < 8; ++j) red[tid * 8 + j] = bsum[j];
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float v = 0.f;
    for (int th = c / 8; th < kThreads; th += U) v += red[th * 8 + c % 8];
    row[27 * C * C + c] = v;
  }
}

// ---------------------------------------------------------------- host

enum Kind { kDgrad = 0, kFwd = 1, kWgrad = 2 };

// The kernel of a launch; the wgrad's by its tiles (cols: column tiles).
template <int C, int K>
auto ring_kernel(bool cols) {
  if constexpr (K == kFwd)
    return conv3x3_mma_kernel<C>;
  else if constexpr (K == kDgrad)
    return dgrad_mma_kernel<C>;
  else
    return cols ? wgrad_mma_kernel<C, true> : wgrad_mma_kernel<C, false>;
}

// The columns TW of a launch's plane tile at grid width W (0 for a W the
// kernel does not take): W itself, a multiple of 16 up to kWmax that
// divides M; else column tiles of kWmax where kWmax divides W. The same
// for the forward, the dgrad and the wgrad.
template <int C>
int ring_tw(int W) {
  using Cfg = RingCfg<C>;
  if (W % 16) return 0;
  if (W <= Cfg::kWmax && Cfg::M % W == 0) return W;
  return W % Cfg::kWmax == 0 ? Cfg::kWmax : 0;
}

// Shared memory of a launch with tiles TW columns wide: the forward's and
// the dgrad's W slice, vectors, epilogue tiles and ring; the wgrad's g'
// tiles, y stage, vectors and ring.
template <int C, int K>
size_t ring_smem(int TW) {
  using Cfg = RingCfg<C>;
  const size_t slot = (size_t)(Cfg::M / TW + 2) * (TW + 2) * C * 2;
  if constexpr (K == kWgrad)
    return 3 * WgCfg<C>::kG + WgCfg<C>::kVec + 3 * slot;
  else
    return Cfg::kW + Cfg::kVec + 2 * Cfg::kX + 3 * slot;
}

// The launch of one forward, dgrad or wgrad: blocks a (batch element,
// slice or tap group), with the rows (TH), columns (TW) and planes (DD) a
// block takes; false for a shape the kernel does not take. The depth
// ranges are as many as keep the whole grid in one wave of the resident
// blocks, and for the wgrad no more than keep its partial table (a row of
// 27 C^2 + C floats a (batch element, blockIdx.x)) within the bytes of the
// x and gy it reduces.
struct Plan {
  int gx, TH, TW, DD;
  size_t smem;
};

template <int C, int K>
bool ring_plan(int B, int D, int H, int W, Plan& pl) {
  using Cfg = RingCfg<C>;
  pl.TW = ring_tw<C>(W);
  if (pl.TW == 0) return false;
  pl.smem = ring_smem<C, K>(pl.TW);
  if (pl.smem > (size_t)kSmemMax) return false;
  pl.TH = Cfg::M / pl.TW;
  if (H % pl.TH) return false;
  const auto kernel = ring_kernel<C, K>(pl.TW != W);
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem) != cudaSuccess)
    return false;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, pl.smem) != cudaSuccess ||
      per_sm < 1)
    return false;
  const int tiles = H / pl.TH * (W / pl.TW);
  const int S = K == kWgrad ? WgCfg<C>::Z : C / Cfg::NS;
  long long nd = per_sm * hopper_host::sm_count() / (B * S * tiles);
  if (K == kWgrad) {
    const long long most =
        (long long)D * H * W * C / ((long long)WgCfg<C>::L * tiles);
    nd = nd < most ? nd : most;
  }
  nd = nd < 1 ? 1 : nd > D ? D : nd;
  pl.DD = (int)((D + nd - 1) / nd);
  pl.gx = tiles * ((D + pl.DD - 1) / pl.DD);
  return true;
}

template <int C, int K>
int ring_grid(int B, int D, int H, int W) {
  Plan pl;
  return ring_plan<C, K>(B, D, H, W, pl) ? pl.gx : 0;
}

template <int C>
int ring_grid_of(int kind, int B, int D, int H, int W) {
  switch (kind) {
    case kDgrad: return ring_grid<C, kDgrad>(B, D, H, W);
    case kFwd: return ring_grid<C, kFwd>(B, D, H, W);
    case kWgrad: return ring_grid<C, kWgrad>(B, D, H, W);
    default: return 0;
  }
}

// One launch and its fixed-order sum: the forward's and the dgrad's
// (B, gx, 2, C) table into sums (B, 2, C), the wgrad's (B gx, 27 C^2 + C)
// table into sums (27 C^2 + C): dW as (3, 3, 3, Cin, Cout), then dbias.
template <int C, int K>
int ring_launch(RingArgs a, float* sums, int B, int gx, cudaStream_t st) {
  Plan pl;
  if (!ring_plan<C, K>(B, a.D, a.H, a.W, pl) || pl.gx != gx)
    return (int)cudaErrorInvalidValue;
  a.TH = pl.TH;
  a.TW = pl.TW;
  a.DD = pl.DD;
  if constexpr (K == kWgrad) {
    const dim3 grid(gx, B, WgCfg<C>::Z);
    if (pl.TW != a.W)
      wgrad_mma_kernel<C, true><<<grid, kThreads, pl.smem, st>>>(a);
    else
      wgrad_mma_kernel<C, false><<<grid, kThreads, pl.smem, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    constexpr long long L = WgCfg<C>::L;
    fixed_sum_kernel<<<dim3((int)((L + 31) / 32), 1), 256, 0, st>>>(
        a.part, sums, B * gx, L);
    return (int)cudaGetLastError();
  }
  const dim3 grid(gx, B, C / RingCfg<C>::NS);
  if constexpr (K == kFwd)
    conv3x3_mma_kernel<C><<<grid, kThreads, pl.smem, st>>>(a);
  else
    dgrad_mma_kernel<C><<<grid, kThreads, pl.smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.part == nullptr) return (int)err;
  fixed_sum_kernel<<<dim3((2 * C + 31) / 32, B), 256, 0, st>>>(a.part, sums,
                                                              gx, 2 * C);
  return (int)cudaGetLastError();
}

template <int K>
int ring_dispatch(const RingArgs& a, float* sums, int B, int C, int gx,
                  cudaStream_t st) {
  switch (C) {
    case 8: return ring_launch<8, K>(a, sums, B, gx, st);
    case 16: return ring_launch<16, K>(a, sums, B, gx, st);
    case 32: return ring_launch<32, K>(a, sums, B, gx, st);
    case 64: return ring_launch<64, K>(a, sums, B, gx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The x blocks of a launch of kind 1 (the forward), 0 (the dgrad) or 2
// (the wgrad) of a (B, D, H, W, C) grid at Cin = Cout = C: the forward's
// and the dgrad's partial tables have B times that many rows a (batch
// element, N slice), the wgrad's B times that many in all; 0 for a shape
// the kernel does not take.
int pcseg_ring_grid(int kind, int B, int C, int D, int H, int W) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0) return 0;
  switch (C) {
    case 8: return ring_grid_of<8>(kind, B, D, H, W);
    case 16: return ring_grid_of<16>(kind, B, D, H, W);
    case 32: return ring_grid_of<32>(kind, B, D, H, W);
    case 64: return ring_grid_of<64>(kind, B, D, H, W);
    default: return 0;
  }
}

// The forward: x (B, D, H, W, C) bf16; w (27, C, C) bf16, pack_conv_w's
// [tap][Cout][Cin]; bias (C,) f32; scale/shift (B, C) f32, or both null
// (no activation: the ring holds x itself); accum (B, D, H, W, C) bf16 or
// null. Writes y (B, D, H, W, C) bf16 and, if stats is not null, stats (B,
// 2, C) = (sum v, sum v^2) through part, (B, gx, 2, C) f32 scratch. All
// grids 16-byte aligned; gx from pcseg_ring_grid(1, ...).
int pcseg_conv3x3_mma(const void* x, const void* w, const void* bias,
                      const void* scale, const void* shift, const void* accum,
                      void* y, void* stats, void* part, int B, int D, int H,
                      int W, int C, int gx, void* stream) {
  if (B <= 0 || gx <= 0 || bias == nullptr || (scale == nullptr) !=
      (shift == nullptr) || (stats == nullptr) != (part == nullptr))
    return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.src = (const __nv_bfloat16*)x;
  a.tile = (const __nv_bfloat16*)accum;
  a.w = (const __nv_bfloat16*)w;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.bias = (const float*)bias;
  a.out = (__nv_bfloat16*)y;
  a.part = (float*)part;
  a.D = D; a.H = H; a.W = W;
  return ring_dispatch<kFwd>(a, (float*)stats, B, C, gx,
                             (cudaStream_t)stream);
}

// The dgrad: gy (B, D, H, W, C) bf16; y the forward's output and gstats
// (B, 2, C), or both null; x (B, D, H, W, C) bf16 the forward's input; w
// (27, C, C) bf16, pack_dgrad_w's [tap][Cin][Cout]; scale/shift (B, C)
// f32, null without the activation. Writes dx (B, D, H, W, C) bf16,
// dstats (B, 2, C) = (dscale, dshift) through part, (B, gx, 2, C) f32
// scratch (both null without the activation), and, if gadj is not null,
// the bf16 g'. All grids 16-byte aligned; gx from pcseg_ring_grid(0, ...).
int pcseg_conv3x3_dgrad_mma(const void* gy, const void* y, const void* gstats,
                            const void* x, const void* w, const void* scale,
                            const void* shift, void* dx, void* dstats,
                            void* gadj, void* part, int B, int D, int H,
                            int W, int C, int gx, void* stream) {
  if (B <= 0 || gx <= 0 || (scale == nullptr) != (part == nullptr))
    return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.src = (const __nv_bfloat16*)gy;
  a.y = (const __nv_bfloat16*)y;
  a.gstats = (const float*)gstats;
  a.tile = scale != nullptr ? (const __nv_bfloat16*)x : nullptr;
  a.w = (const __nv_bfloat16*)w;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.out = (__nv_bfloat16*)dx;
  a.gadj = (__nv_bfloat16*)gadj;
  a.part = (float*)part;
  a.D = D; a.H = H; a.W = W;
  return ring_dispatch<kDgrad>(a, (float*)dstats, B, C, gx,
                               (cudaStream_t)stream);
}

// The wgrad: x (B, D, H, W, C) bf16 the forward's input; scale/shift (B,
// C) f32, or both null (no activation); gy (B, D, H, W, C) bf16; y the
// forward's output and gstats (B, 2, C), or both null. Writes out (27 C^2
// + C) f32, dW as (3, 3, 3, Cin, Cout) then dbias, through part, (B gx,
// 27 C^2 + C) f32 scratch. All grids 16-byte aligned; gx from
// pcseg_ring_grid(2, ...).
int pcseg_conv3x3_wgrad_mma(const void* x, const void* scale,
                            const void* shift, const void* gy, const void* y,
                            const void* gstats, void* out, void* part, int B,
                            int D, int H, int W, int C, int gx,
                            void* stream) {
  if (B <= 0 || gx <= 0 || out == nullptr || part == nullptr ||
      (scale == nullptr) != (shift == nullptr) ||
      (y == nullptr) != (gstats == nullptr))
    return (int)cudaErrorInvalidValue;
  RingArgs a{};
  a.src = (const __nv_bfloat16*)x;
  a.tile = (const __nv_bfloat16*)gy;
  a.y = (const __nv_bfloat16*)y;
  a.gstats = (const float*)gstats;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.part = (float*)part;
  a.D = D; a.H = H; a.W = W;
  return ring_dispatch<kWgrad>(a, (float*)out, B, C, gx,
                               (cudaStream_t)stream);
}

}  // extern "C"
