// Block-sparse submanifold 3^3 convolution for Hopper (sm_90a): forward,
// dgrad and wgrad.
//
//   pcseg_block_conv        replaces pcseg_tpu/ops/pallas/block_conv.py
//                           block_conv (_fwd_kernel, pallas_call at :382):
//                           the raw conv over the occupied t^3 tiles of
//                           each event,
//     out[b, n, v, o] = sum_{d, i} halo_{b,n}(v + delta_d)[i] W[d, i, o]
//                           with f32 sums rounded once to the feature type,
//                           no bias and no active mask (the fused LN kernel
//                           applies both).
//   pcseg_block_conv_dgrad  the backward's dgrad (_block_conv_bwd, :657):
//                           the same kernel body over the same slot table,
//                           on the cotangent with the flipped, channel-
//                           transposed taps of _flip_w2 (tap d takes
//                           W[-d]^T = W[26 - d]^T), read in place from the
//                           forward's taps. For kept tiles slot_G(d) = H
//                           iff slot_H(-d) = G, so this is the exact
//                           adjoint; a separate entry only so that a
//                           profile tells its launches apart.
//   pcseg_block_wgrad       the backward's wgrad (_wgrad_call, pallas_call
//                           at :555 and :574):
//     dW[d, i, o] = sum over the real tiles' voxels v of
//                   halo(v + delta_d)[i] g(v)[o],
//                           f32 sums rounded once to the weights' type.
//
// Layout: feats (B, NT, t^3, Cin), intra-tile voxel order (z * t + y) * t
// + x; slots (B, NT, 27) int32, the slot of the neighbour tile at tile
// delta d = (dz+1)*9 + (dy+1)*3 + (dx+1) (d = 13 is the tile itself), -1
// where there is none; w2 (27 * Cin, Cout), the (27, Cin, Cout) taps of
// subm_conv_init in the same d order. A neighbour voxel outside the tile
// is read from the tile in slots[d] at the wrapped position; slot -1 reads
// zero. A capacity-padding row has every slot -1: the conv writes zeros
// there and computes nothing, the wgrad skips it.
//
// The TPU kernels decompose the conv into lane-legal 2D matmuls (x-banded
// weights, face/edge/corner tables, one-hot placement matmuls, and for the
// wgrad banded M-matrices reduced by _extract_band), all of which work
// around Mosaic. Here a block stages a tile's halo in shared memory,
// gathered through the slot table, and keeps f32 sums in registers. Forms,
// chosen before the launch by block_route (the wrapper asks the same
// function, pcseg_block_route, which launches it counts):
// - conv and dgrad, bf16 at t = 8 with an output width a multiple of 32 up
//   to 128: a tensor-core implicit GEMM of half a tile by every output
//   channel, each tap's A operand read from the one staged halo at the
//   tap's row offset, the weights streamed through a ring of taps. At 64
//   and 128 outputs (every conv of the sparse U-Net, the stem's 2 input
//   channels zero-filled to a k16 step) conv_wgmma_body, on warpgroup
//   products (wgmma) reading both operands by descriptor; at 32 and 96
//   conv_mma_body, on mma.sync m16n8k16 with ldmatrix.
// - conv and dgrad, otherwise (f32, other t up to 16, other widths):
//   conv_body, f32 FMAs on the CUDA cores, each of the 256 threads keeping
//   the sums of two voxels by 16 or 32 outputs (a masked tail where Cout is
//   not a multiple of 16). A tile of more than 512 voxels (t > 8) is cut
//   into z-slabs of at most 512 voxels, one block each, whose halo has two
//   planes more than the slab: at t = 16, 4 x 18 x 18 voxels a channel.
// - wgrad, bf16 at t = 8 with Cout a multiple of 32 (every conv of the
//   sparse U-Net): a tensor-core GEMM over the voxels by tap group, each
//   tile's halo planes staged once per tap group and read by every tap of
//   the group at its row offset, slabs of the tiles pipelined by
//   cp.async: block_wgrad_wgmma_kernel (wgmma) for slices of 64 input by
//   64 output channels (Cin > 32, Cout a multiple of 64: levels 0 and 1),
//   block_wgrad_mma_kernel (mma.sync) for narrower ones (the stem).
// - wgrad, otherwise (f32, other t, other Cout): block_wgrad_kernel, each
//   thread one (input, output) channel pair with the f32 sums of its 27
//   taps.
// A wgrad block walks a share of the tiles and writes its sums as one row
// of a (rows, 27 * Cin, Cout) f32 partial table; wgrad_reduce_kernel adds
// the rows in a fixed order and rounds once, so two calls give the same
// bits. bf16 products are exact in f32, so every form gives the f32 sums
// of the TPU's MXU, rounded once.
//
// What bounds them: operations. 2 * 27 * Cin * Cout flops a voxel of a
// real tile against ~200 bytes of features; at the sparse U-Net's level-1
// 128 -> 128 conv that is 1.8e4 flops a byte, far above the card's ratio
// of ~295. The tensor-core forms stage every operand with 16-byte cp.async
// a stage or two ahead of the products and keep the sums in registers;
// the mma.sync forms read shared memory by ldmatrix in swizzled rows
// (hswz: conflict-free), the wgmma forms by descriptor in the core-matrix
// layouts the descriptors name.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue before
// any launch for arguments it does not take.

#include <initializer_list>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kThreads = 256;
constexpr int kCI = 8;                       // input channels a pass
constexpr int kMaxT = 16;                    // largest tile edge
constexpr int kVox = 2;                      // voxels a thread
constexpr int kSlabVox = kThreads * kVox;    // voxels a block at most
// the largest slab halo, (slab + 2) (t + 2)^2 over t <= 16: t = 16, slab 2
constexpr int kHaloMax = 4 * (kMaxT + 2) * (kMaxT + 2);
constexpr int kWCO = 32;                     // wgrad outputs a block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// z planes of a block's slab: the whole tile up to 512 voxels
__host__ __device__ __forceinline__ int slab_planes(int t) {
  const int s = kSlabVox / (t * t);
  return s < t ? s : t;
}

// one output row of CO values, 16-byte stores
template <int CO>
__device__ __forceinline__ void store_row(float* o, const float* a) {
#pragma unroll
  for (int q = 0; q < CO / 4; ++q)
    reinterpret_cast<float4*>(o)[q] =
        make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

template <int CO>
__device__ __forceinline__ void store_row(__nv_bfloat16* o, const float* a) {
#pragma unroll
  for (int q = 0; q < CO / 8; ++q) {
    uint4 u;
    __nv_bfloat162 p0 = __floats2bfloat162_rn(a[8 * q], a[8 * q + 1]);
    __nv_bfloat162 p1 = __floats2bfloat162_rn(a[8 * q + 2], a[8 * q + 3]);
    __nv_bfloat162 p2 = __floats2bfloat162_rn(a[8 * q + 4], a[8 * q + 5]);
    __nv_bfloat162 p3 = __floats2bfloat162_rn(a[8 * q + 6], a[8 * q + 7]);
    u.x = *reinterpret_cast<uint32_t*>(&p0);
    u.y = *reinterpret_cast<uint32_t*>(&p1);
    u.z = *reinterpret_cast<uint32_t*>(&p2);
    u.w = *reinterpret_cast<uint32_t*>(&p3);
    reinterpret_cast<uint4*>(o)[q] = u;
  }
}

// the first ``cw`` of a row's CO values: 16-byte stores where every chunk
// of the row is whole (``vec``), else one value at a time
template <int CO, typename T>
__device__ __forceinline__ void store_part(T* o, const float* a, int cw,
                                           bool vec) {
  if (vec) {
    store_row<CO>(o, a);
    return;
  }
#pragma unroll
  for (int k = 0; k < CO; ++k)
    if (k < cw) o[k] = from_float<T>(a[k]);
}

// the tile delta (-1, 0, 1) of a halo coordinate h along an axis whose
// tile coordinate is g = h - 1 (+ the slab's first plane)
__device__ __forceinline__ int delta_of(int g, int t) {
  return g < 0 ? -1 : (g >= t ? 1 : 0);
}

// 16 bytes global -> shared without holding the thread (cp.async, L2
// only); ``valid`` false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bf16 channels of a halo row into shared memory: the first ``n`` of
// ``row`` (n <= 0: zeros); asynchronous where the row is whole and 16-byte
// aligned (``vec``), else element by element
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* row, int n,
                                       bool vec, const void* any) {
  if (vec) {
    cp_async16(dst, n > 0 ? (const void*)row : any, n > 0);
    return;
  }
  __align__(16) __nv_bfloat16 e[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    e[q] = q < n ? row[q] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(e);
}

template <int CO>
constexpr int smem_bytes() {
  return (kCI * kHaloMax + 27 * kCI * CO) * (int)sizeof(float);
}

// The CUDA-core conv: block (tile, Cout chunk of CO, z-slab); DGRAD reads
// the forward's taps flipped and transposed in place.
template <typename T, int CO, bool DGRAD>
__device__ __forceinline__ void conv_body(
    const T* __restrict__ feats, const int* __restrict__ slots,
    const T* __restrict__ w2, T* __restrict__ out, int nt, int t, int cin,
    int cout, float* smem, int* nb) {
  float* halo = smem;                        // [kCI][hs]
  float* ws = smem + kCI * kHaloMax;         // [27][kCI][CO]

  const long long tile = blockIdx.x;         // b * NT + n
  const long long b = tile / nt;
  const int co0 = blockIdx.y * CO;
  const int t2 = t * t, t3 = t2 * t;
  const int slab = slab_planes(t);
  const int z0 = blockIdx.z * slab;
  const int zs = min(slab, t - z0);
  const int nv = zs * t2;                    // voxels of this slab
  const int tp = t + 2;
  const int hs = (zs + 2) * tp * tp;
  const int cw = min(CO, cout - co0);
  const bool vec = cout % CO == 0;
  if (threadIdx.x < 27) nb[threadIdx.x] = slots[tile * 27 + threadIdx.x];
  __syncthreads();

  T* o = out + (tile * t3 + (long long)z0 * t2) * cout + co0;
  float acc[kVox][CO];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;

  if (nb[13] < 0) {                          // capacity padding: zeros
    for (int v = threadIdx.x; v < nv; v += kThreads)
      store_part<CO>(o + (long long)v * cout, acc[0], cw, vec);
    return;
  }

  // each thread's voxels and their centre in the slab's halo; a thread
  // past the slab computes on the centre of voxel 0 and stores nothing
  int hb[kVox];
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int v = threadIdx.x + j * kThreads;
    const int vv = v < nv ? v : 0;
    const int z = vv / t2, y = (vv / t) % t, x = vv % t;
    hb[j] = ((z + 1) * tp + (y + 1)) * tp + (x + 1);
  }
  const T* fb = feats + b * nt * t3 * cin;

  for (int c0 = 0; c0 < cin; c0 += kCI) {
    const int cc = min(kCI, cin - c0);
    // the halo of channels c0 .. c0 + cc, gathered through the slot table
    for (int i = threadIdx.x; i < hs * kCI; i += kThreads) {
      const int h = i / kCI, ci = i % kCI;
      float val = 0.f;
      if (ci < cc) {
        const int gz = z0 + h / (tp * tp) - 1, gy = (h / tp) % tp - 1,
                  gx = h % tp - 1;
        const int dz = delta_of(gz, t), dy = delta_of(gy, t),
                  dx = delta_of(gx, t);
        const int s = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
        if (s >= 0) {
          const int sz = gz - dz * t, sy = gy - dy * t, sx = gx - dx * t;
          val = to_float(fb[((long long)s * t3 + (sz * t + sy) * t + sx) * cin
                            + c0 + ci]);
        }
      }
      halo[ci * hs + h] = val;
    }
    // tap d's rows: W[d] of w2 (27 cin, cout), or the dgrad's W[26 - d]^T
    // read in place from the forward's (27 cout, cin) taps
    for (int i = threadIdx.x; i < 27 * kCI * CO; i += kThreads) {
      const int k = i % CO, ci = (i / CO) % kCI, d = i / (CO * kCI);
      float v = 0.f;
      if (ci < cc && k < cw)
        v = to_float(DGRAD ? w2[((long long)(26 - d) * cout + co0 + k) * cin
                                + c0 + ci]
                           : w2[((long long)d * cin + c0 + ci) * cout + co0
                                + k]);
      ws[i] = v;
    }
    __syncthreads();

    for (int d = 0; d < 27; ++d) {
      const int off = (d / 9 - 1) * tp * tp + ((d / 3) % 3 - 1) * tp
                      + (d % 3 - 1);
#pragma unroll
      for (int ci = 0; ci < kCI; ++ci) {
        if (ci >= cc) break;
        const float* hrow = halo + ci * hs + off;
        float hv[kVox];
#pragma unroll
        for (int j = 0; j < kVox; ++j) hv[j] = hrow[hb[j]];
        const float4* wr =
            reinterpret_cast<const float4*>(ws + (d * kCI + ci) * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 w = wr[q];
#pragma unroll
          for (int j = 0; j < kVox; ++j) {
            acc[j][4 * q] = fmaf(hv[j], w.x, acc[j][4 * q]);
            acc[j][4 * q + 1] = fmaf(hv[j], w.y, acc[j][4 * q + 1]);
            acc[j][4 * q + 2] = fmaf(hv[j], w.z, acc[j][4 * q + 2]);
            acc[j][4 * q + 3] = fmaf(hv[j], w.w, acc[j][4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int v = threadIdx.x + j * kThreads;
    if (v < nv) store_part<CO>(o + (long long)v * cout, acc[j], cw, vec);
  }
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads) block_conv_kernel(
    const T* __restrict__ feats, const int* __restrict__ slots,
    const T* __restrict__ w2, T* __restrict__ out, int nt, int t, int cin,
    int cout) {
  extern __shared__ float smem[];
  __shared__ int nb[27];
  conv_body<T, CO, false>(feats, slots, w2, out, nt, t, cin, cout, smem, nb);
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads) block_dgrad_kernel(
    const T* __restrict__ feats, const int* __restrict__ slots,
    const T* __restrict__ w2, T* __restrict__ out, int nt, int t, int cin,
    int cout) {
  extern __shared__ float smem[];
  __shared__ int nb[27];
  conv_body<T, CO, true>(feats, slots, w2, out, nt, t, cin, cout, smem, nb);
}

// ---------------------------------------------------------------------------
// bf16, t = 8: the conv and its dgrad as tensor-core implicit GEMMs
// ---------------------------------------------------------------------------
//
// One block per (event, tile, half tile): the kPZ = 4 z planes (M = 256
// voxels) of one half of the tile against every output channel (N = Cout
// up to kNMax), so that the half tile's halo is gathered once per K chunk
// of kKC input channels. Per chunk the block stages the (kPZ + 2) x 10 x 10
// halo rows of its planes through the slot table (16-byte cp.async,
// zero-filled for slot -1; element by element where Cin is not a multiple
// of 8), double-buffered across chunks, and streams the dense weights
// through a ring of kNST stages of one tap each. Each of the 27 taps reads
// its A operand from the one halo copy at a row offset of dz 100 + dy 10 +
// dx: the 16 rows of an m16 tile (two x-lines of a plane) are two runs of 8
// consecutive halo rows 10 rows apart, one ldmatrix row address per lane.
// Halo rows are kHU = 4 units of 16 bytes, swizzled (hswz) so that one
// unit of any 8 consecutive rows meets 8 distinct bank groups. Warp w takes
// plane w % 4 of the half tile (4 m16 tiles) by the N half w / 4 (NW n8
// tiles), keeps the f32 sums in registers (16 NW a thread) and, at the end,
// rounds them once and writes 16-byte stores after a transpose within each
// quad of lanes (quad_store). The forward reads B = W[d] (K-major rows of
// N, padded by 16 bytes a row so that ldmatrix.trans is conflict-free); the
// dgrad, the same body, reads W[26 - d]^T in place, N-major rows of K
// (swizzled as the halo), by plain ldmatrix: the forward's taps serve it
// without a flipped copy. Capacity padding writes its zeros and stages
// nothing.

constexpr int kT = 8;                        // tile edge of this path
constexpr int kT3 = kT * kT * kT;
constexpr int kPZ = 4;                       // z planes a block
constexpr int kMmaM = kPZ * kT * kT;         // voxels a block
constexpr int kHRows = (kPZ + 2) * 100;      // halo rows a block
constexpr int kKC = 32;                      // input channels a K chunk
constexpr int kHU = kKC / 8;                 // 16-byte units a halo row
constexpr int kHaloBytes = kHRows * kKC * 2; // one halo buffer
constexpr int kNST = 4;                      // weight ring stages (taps)
constexpr int kNMax = 128;                   // output channels at most

// unit offset (in 16-byte units) of unit u of row r of a tile whose rows
// hold U units (U a power of two): the unit XOR bits of the row, so that
// unit u of any 8 consecutive rows falls in 8 distinct 16-byte bank groups
__host__ __device__ __forceinline__ int hswz(int r, int u, int U) {
  return r * U + (u ^ (U >= 8 ? (r & 7) : ((r * U >> 3) & (U - 1))));
}

// bytes of one weight stage at N outputs: the forward's kKC rows of N
// (+ 16 bytes of padding each) or the dgrad's N rows of kKC
__host__ __device__ constexpr int wstage_bytes(int n) {
  return kKC * (2 * n + 16);
}

__host__ __device__ constexpr int conv_mma_smem(int n) {
  return 2 * kHaloBytes + kNST * wstage_bytes(n);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t sel4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Rows g and g + 8 of two n8 accumulator tiles (lane (g, t) holds columns
// 2t, 2t + 1 of each) as 16-byte stores: lane t of a quad gathers segment
// t (row g + 8 (t >> 1), n8 tile t & 1) from the quad by three shuffles
// and writes its 8 columns at row0 + (g + 8 (t >> 1)) ld + 8 (t & 1).
__device__ __forceinline__ void quad_store(__nv_bfloat16* row0, int ld,
                                           const float (&c0)[4],
                                           const float (&c1)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t v[4] = {pack2(c0[0], c0[1]), pack2(c1[0], c1[1]),
                         pack2(c0[2], c0[3]), pack2(c1[2], c1[3])};
  uint32_t r[4];
  r[0] = sel4(v, t);
#pragma unroll
  for (int k = 1; k < 4; ++k)
    r[k] = __shfl_xor_sync(0xffffffffu, sel4(v, t ^ k), k);
  // the word of lane u of the quad is r[t ^ u]
  const uint4 q = make_uint4(sel4(r, t), sel4(r, t ^ 1), sel4(r, t ^ 2),
                             sel4(r, t ^ 3));
  *reinterpret_cast<uint4*>(row0 + (long long)(g + 8 * (t >> 1)) * ld +
                            8 * (t & 1)) = q;
}

// x (B, NT, 512, K) the input (the features, or the dgrad's cotangent),
// w2 the forward's taps: (27 K, N) for the forward, (27 N, K) for the
// dgrad; out (B, NT, 512, N). NW = N / 16 n8 tiles a warp.
template <int NW, bool DGRAD>
__device__ __forceinline__ void conv_mma_body(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int nt, int K, uint8_t* smem, int* nb) {
  constexpr int N = NW * 16;
  constexpr int WST = wstage_bytes(N);
  const long long tile = blockIdx.x;
  const long long b = tile / nt;
  const int zh = blockIdx.y;                 // planes zh kPZ .. + kPZ - 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 27) nb[tid] = slots[tile * 27 + tid];
  __syncthreads();
  __nv_bfloat16* o = out + (tile * kT3 + zh * kMmaM) * N;
  if (nb[13] < 0) {                          // capacity padding: zeros
    for (int e = tid; e < kMmaM * N / 8; e += kThreads)
      reinterpret_cast<uint4*>(o)[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  uint8_t* halo = smem;                      // 2 x [kHRows][kKC]
  uint8_t* wring = smem + 2 * kHaloBytes;    // kNST x one tap
  const __nv_bfloat16* fb = x + b * nt * kT3 * K;
  const int nchunks = (K + kKC - 1) / kKC;
  const int S = 27 * nchunks;                // (chunk, tap) steps
  const bool vec = K % 8 == 0;

  // the halo rows of chunk c, the units its k16 steps read
  auto stage_halo = [&](int c, uint8_t* buf) {
    const int c0 = c * kKC, cc = min(kKC, K - c0);
    const int units = (cc + 15) / 16 * 2;
    for (int e = tid; e < kHRows * units; e += kThreads) {
      const int h = e / units, u = e % units;
      const int gz = zh * kPZ + h / 100 - 1, gy = (h / 10) % 10 - 1,
                gx = h % 10 - 1;
      const int dz = delta_of(gz, kT), dy = delta_of(gy, kT),
                dx = delta_of(gx, kT);
      const int s = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
      const int src = ((gz - dz * kT) * kT + (gy - dy * kT)) * kT +
                      (gx - dx * kT);
      const int n = s >= 0 ? min(8, cc - u * 8) : 0;
      stage8(reinterpret_cast<__nv_bfloat16*>(buf + hswz(h, u, kHU) * 16),
             fb + ((long long)max(s, 0) * kT3 + src) * K + c0 + u * 8, n,
             vec, fb);
    }
  };
  // the weights of step s (chunk s / 27, tap s % 27), the k16 rows its
  // products read; rows past the chunk's channels are zeros
  auto stage_w = [&](int s, uint8_t* dst) {
    const int c = s / 27, d = s - c * 27;
    const int c0 = c * kKC, cc = min(kKC, K - c0);
    const int kr = (cc + 15) / 16 * 16;
    if constexpr (!DGRAD) {
      for (int e = tid; e < kr * (N / 8); e += kThreads) {
        const int k = e / (N / 8), u = e % (N / 8);
        const bool ok = k < cc;
        cp_async16(dst + k * (2 * N + 16) + u * 16,
                   w2 + ((long long)d * K + c0 + (ok ? k : 0)) * N + u * 8,
                   ok);
      }
    } else {
      for (int e = tid; e < N * (kr / 8); e += kThreads) {
        const int n = e / (kr / 8), u = e % (kr / 8);
        const bool ok = u * 8 < cc;
        cp_async16(dst + hswz(n, u, kHU) * 16,
                   w2 + ((long long)(26 - d) * N + n) * K + c0 +
                       (ok ? u * 8 : 0),
                   ok);
      }
    }
  };

  stage_halo(0, halo);
  stage_w(0, wring);
  cp_commit();
#pragma unroll
  for (int s = 1; s < kNST - 1; ++s) {
    if (s < S) stage_w(s, wring + s * WST);
    cp_commit();
  }

  // the lane's ldmatrix row of an m16 tile (two x-lines of plane warp %
  // 4: voxel (y = 2j + lr / 8, x = lr % 8) of tile j) and its halo row at
  // tap 13, tile 0; the warp's first output column
  const int pz = warp & 3, n0 = (warp >> 2) * (N / 2);
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int hb = ((pz + 1) * 10 + (lr >> 3) + 1) * 10 + (lr & 7) + 1;
  float acc[4][NW][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][q][i] = 0.f;

  for (int s = 0; s < S; ++s) {
    cp_wait<kNST - 2>();
    __syncthreads();   // step s's weights (and its chunk's halo) are in
    const int c = s / 27, d = s - c * 27;
    if (s + kNST - 1 < S)
      stage_w(s + kNST - 1, wring + ((s + kNST - 1) % kNST) * WST);
    if (d == 0 && c + 1 < nchunks)
      stage_halo(c + 1, halo + ((c + 1) & 1) * kHaloBytes);
    cp_commit();

    const int ksn = (min(kKC, K - c * kKC) + 15) / 16;
    const uint32_t hbuf = smem_addr(halo + (c & 1) * kHaloBytes);
    const uint32_t wb = smem_addr(wring + (s % kNST) * WST);
    const int off = (d / 9 - 1) * 100 + ((d / 3) % 3 - 1) * 10 + (d % 3 - 1);
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if (ks >= ksn) break;
      uint32_t bf[NW][2];
#pragma unroll
      for (int np = 0; np < NW / 2; ++np) {
        uint32_t bb[4];
        if constexpr (DGRAD)
          ldsm4(bb, wb + hswz(n0 + 16 * np + (lane & 7) + (lane >> 4) * 8,
                              2 * ks + ((lane >> 3) & 1), kHU) * 16);
        else
          ldsm4t(bb, wb + (16 * ks + lr) * (2 * N + 16) +
                         (n0 / 8 + 2 * np + (lane >> 4)) * 16);
        bf[2 * np][0] = bb[0];
        bf[2 * np][1] = bb[1];
        bf[2 * np + 1][0] = bb[2];
        bf[2 * np + 1][1] = bb[3];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];
        ldsm4(a, hbuf + hswz(hb + 20 * j + off, 2 * ks + (lane >> 4), kHU) *
                            16);
#pragma unroll
        for (int q = 0; q < NW; ++q) mma(acc[j][q], a, bf[q][0], bf[q][1]);
      }
    }
  }
  cp_wait<0>();

  // round once; m16 tile j of plane pz is voxels pz 64 + 16 j + (0..15)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int np = 0; np < NW / 2; ++np)
      quad_store(o + (long long)(pz * 64 + 16 * j) * N + n0 + 16 * np, N,
                 acc[j][2 * np], acc[j][2 * np + 1], lane);
}

template <int NW>
__global__ void __launch_bounds__(kThreads, NW <= 4 ? 2 : 1)
    block_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const int* __restrict__ slots,
                          const __nv_bfloat16* __restrict__ w2,
                          __nv_bfloat16* __restrict__ out, int nt, int K) {
  extern __shared__ __align__(128) uint8_t smem_mma[];
  __shared__ int nb[27];
  conv_mma_body<NW, false>(x, slots, w2, out, nt, K, smem_mma, nb);
}

template <int NW>
__global__ void __launch_bounds__(kThreads, NW <= 4 ? 2 : 1)
    block_dgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const int* __restrict__ slots,
                           const __nv_bfloat16* __restrict__ w2,
                           __nv_bfloat16* __restrict__ out, int nt, int K) {
  extern __shared__ __align__(128) uint8_t smem_mma[];
  __shared__ int nb[27];
  conv_mma_body<NW, true>(x, slots, w2, out, nt, K, smem_mma, nb);
}

// The same implicit GEMM on warpgroup products (wgmma m64nNk16, N = 64 or
// 128): the block's two warpgroups take two planes each, one m64 tile a
// plane, and read both operands from shared memory by descriptor, so the
// products issue no ldmatrix. The halo is staged K-major without swizzle,
// unit-major ([kHU units][kHRows rows] of 16 bytes): the 8 rows of an
// x-line under a tap are one 128-byte core matrix at any row, the plane's
// 8 lines core matrices 160 bytes apart (SBO) and a k16 step's two units
// kHRows 16 bytes apart (LBO), so each tap is the same descriptor at
// another start row. The forward's weights are staged MN-major ([N / 64
// column blocks][kKC rows][64] with the 128-byte swizzle, as TMA would
// write them); the dgrad's W[26 - d]^T K-major without swizzle ([k units]
// [N rows]). A stage holds kTPS = 3 taps (dx = -1..1 of one (dz, dy)), so
// a step issues 3 x 2 planes x 2 k16 steps wgmmas a warpgroup between two
// barriers. The ring keeps the wgmmas of one step in flight while the
// next one's operands are checked in: a stage is refilled two steps after
// the products that read it were issued (wgmma.wait_group 1), the halo
// buffer of the next chunk once every product of the one before
// completed. At 64 outputs the ring has 3 stages (loaded one step ahead)
// so that two blocks share an SM; at 128, 4 (two steps ahead), one block.
constexpr int kTPS = 3;                      // taps a weight stage

__host__ __device__ constexpr int wgmma_stage(int n) {
  return kTPS * kKC * n * 2;
}

// weight stages of the warpgroup form: 3 at 64 outputs (one step ahead,
// two blocks an SM), 4 at 128 (two steps ahead, one block an SM)
__host__ __device__ constexpr int wgmma_nst(int n) { return n <= 64 ? 3 : 4; }

__host__ __device__ constexpr int conv_wgmma_smem(int n) {
  return 1024 + wgmma_nst(n) * wgmma_stage(n) + 2 * kHaloBytes;
}

// no-swizzle (interleaved) shared-memory matrix descriptor: start address,
// leading (K) and stride (M / N) byte offsets between core matrices
__device__ __forceinline__ uint64_t desc_none(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

template <int N, bool DGRAD, int KS>
__device__ __forceinline__ void conv_wgmma_body(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int nt, int K, uint8_t* smem_raw, int* nb) {
  const long long tile = blockIdx.x;
  const long long b = tile / nt;
  const int zh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 27) nb[tid] = slots[tile * 27 + tid];
  __syncthreads();
  __nv_bfloat16* o = out + (tile * kT3 + zh * kMmaM) * N;
  if (nb[13] < 0) {                          // capacity padding: zeros
    for (int e = tid; e < kMmaM * N / 8; e += kThreads)
      reinterpret_cast<uint4*>(o)[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // 1024-byte aligned: the swizzled weight stages' atoms
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  constexpr int WST = wgmma_stage(N), TAP = kKC * N * 2;
  constexpr int NSTG = wgmma_nst(N);
  uint8_t* wring = smem;                     // NSTG x kTPS taps
  uint8_t* halo = smem + NSTG * WST;         // 2 x [kHU][kHRows]
  const __nv_bfloat16* fb = x + b * nt * kT3 * K;
  const int nchunks = (K + kKC - 1) / kKC;
  const int S = 27 / kTPS * nchunks;         // (chunk, tap triple) steps
  const bool vec = K % 8 == 0;
  constexpr int kAhead = NSTG - 2;           // stages in flight ahead

  // every chunk runs KS k16 steps (no branch between the wgmmas, which
  // ptxas would serialize): units and rows past its channels are zeros
  auto stage_halo = [&](int c, uint8_t* buf) {
    const int c0 = c * kKC, cc = min(kKC, K - c0);
    for (int e = tid; e < kHRows * 2 * KS; e += kThreads) {
      const int h = e % kHRows, u = e / kHRows;
      const int gz = zh * kPZ + h / 100 - 1, gy = (h / 10) % 10 - 1,
                gx = h % 10 - 1;
      const int dz = delta_of(gz, kT), dy = delta_of(gy, kT),
                dx = delta_of(gx, kT);
      const int s = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
      const int src = ((gz - dz * kT) * kT + (gy - dy * kT)) * kT +
                      (gx - dx * kT);
      const int n = s >= 0 ? min(8, cc - u * 8) : 0;
      stage8(reinterpret_cast<__nv_bfloat16*>(buf + (u * kHRows + h) * 16),
             fb + ((long long)max(s, 0) * kT3 + src) * K + c0 + u * 8, n,
             vec, fb);
    }
  };
  // the weights of step s: taps 3 (s % 9) + j, j < kTPS, of chunk s / 9,
  // tap j at dst + j TAP
  auto stage_w = [&](int s, uint8_t* dst) {
    const int c = s / 9, d0 = kTPS * (s - c * 9);
    const int c0 = c * kKC, cc = min(kKC, K - c0);
    constexpr int kr = 16 * KS;
    if constexpr (!DGRAD) {
      // row k, 16-byte chunk q of column block nb: [nb][k][64], swizzled
      for (int e = tid; e < kTPS * kr * (N / 8); e += kThreads) {
        const int j = e / (kr * (N / 8)), k = e / (N / 8) % kr,
                  u = e % (N / 8);
        const bool ok = k < cc;
        cp_async16(dst + j * TAP + (u >> 3) * (kKC * 128) + k * 128 +
                       (((u & 7) ^ (k & 7)) * 16),
                   w2 + ((long long)(d0 + j) * K + c0 + (ok ? k : 0)) * N +
                       u * 8,
                   ok);
      }
    } else {
      // unit u of row n: [u][n]
      for (int e = tid; e < kTPS * N * (kr / 8); e += kThreads) {
        const int j = e / (N * (kr / 8)), n = e % N, u = e / N % (kr / 8);
        const bool ok = u * 8 < cc;
        cp_async16(dst + j * TAP + (u * N + n) * 16,
                   w2 + ((long long)(26 - d0 - j) * N + n) * K + c0 +
                       (ok ? u * 8 : 0),
                   ok);
      }
    }
  };

  stage_halo(0, halo);
  stage_w(0, wring);
  cp_commit();
#pragma unroll
  for (int s = 1; s < kAhead; ++s) {
    if (s < S) stage_w(s, wring + s * WST);
    cp_commit();
  }

  const int wg = warp >> 2;                  // planes 2 wg, 2 wg + 1
  float acc[2][N / 2];   // the first wgmma starts the sum (scale_d = 0)

  for (int s = 0; s < S; ++s) {
    const int c = s / 9, g = s - c * 9;      // taps 3 g .. 3 g + 2
    // the stage refilled below is free once the products of step s - 2
    // that read it completed; the halo buffer of chunk c + 1, refilled at
    // the chunk's second step, once chunk c - 1's last products did
    hopper::wgmma_wait<1>();
    cp_wait<kAhead - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (s + kAhead < S)
      stage_w(s + kAhead, wring + ((s + kAhead) % NSTG) * WST);
    if (g == 1 && c + 1 < nchunks)
      stage_halo(c + 1, halo + ((c + 1) & 1) * kHaloBytes);
    cp_commit();

    const uint32_t hbuf = smem_addr(halo + (c & 1) * kHaloBytes);
    const uint32_t wb = smem_addr(wring + (s % NSTG) * WST);
    const int dz = g / 3 - 1, dy = g % 3 - 1;
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTPS; ++j)           // dx = j - 1
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t wt = wb + j * TAP;
        const uint64_t db =
            DGRAD ? desc_none(wt + 2 * ks * N * 16, N * 16, 128)
                  : desc_none(wt + ks * 2048, kKC * 128, 1024) | (1ull << 62);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // the tap's row of voxel (z, 0, 0) of plane 2 wg + p
          const int h0 = ((2 * wg + p + 1 + dz) * 10 + 1 + dy) * 10 + j;
          const uint64_t da =
              desc_none(hbuf + (2 * ks * kHRows + h0) * 16, kHRows * 16, 160);
          hopper::wgmma_ss_n<N, 0, DGRAD ? 0 : 1>(acc[p], da, db,
                                                  (s | j | ks) != 0);
        }
      }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < 2; ++p) hopper::fence_acc(acc[p]);
  cp_wait<0>();

  // round once: warp w % 4 of the warpgroup holds rows 16 (w % 4) .. + 15
  // of each m64 tile, n8 block j in registers 4 j .. 4 j + 3
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp)
      quad_store(o + (long long)((2 * wg + p) * 64 + 16 * (warp & 3)) * N +
                     16 * jp,
                 N, *reinterpret_cast<const float(*)[4]>(&acc[p][8 * jp]),
                 *reinterpret_cast<const float(*)[4]>(&acc[p][8 * jp + 4]),
                 lane);
}

template <int N, int KS>
__global__ void __launch_bounds__(kThreads, N <= 64 ? 2 : 1)
    block_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                            const int* __restrict__ slots,
                            const __nv_bfloat16* __restrict__ w2,
                            __nv_bfloat16* __restrict__ out, int nt, int K) {
  extern __shared__ __align__(128) uint8_t smem_mma[];
  __shared__ int nb[27];
  conv_wgmma_body<N, false, KS>(x, slots, w2, out, nt, K, smem_mma, nb);
}

template <int N, int KS>
__global__ void __launch_bounds__(kThreads, N <= 64 ? 2 : 1)
    block_dgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                             const int* __restrict__ slots,
                             const __nv_bfloat16* __restrict__ w2,
                             __nv_bfloat16* __restrict__ out, int nt, int K) {
  extern __shared__ __align__(128) uint8_t smem_mma[];
  __shared__ int nb[27];
  conv_wgmma_body<N, true, KS>(x, slots, w2, out, nt, K, smem_mma, nb);
}
// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// The CUDA-core wgrad: block (group of tiles, kCI input channels, kWCO
// outputs); thread (ci = tid / 32, co = tid % 32) keeps the f32 sums of its
// 27 taps. Per tile and z-slab the block stages the slab's halo (f32,
// channel-major) and the slab's cotangent rows (f32, [voxel][kWCO]); the
// warp's lanes share ci, so their halo reads are broadcasts.
template <typename T>
__global__ void __launch_bounds__(kThreads) block_wgrad_kernel(
    const T* __restrict__ feats, const int* __restrict__ slots,
    const T* __restrict__ g, float* __restrict__ partial, long long tiles,
    int nt, int t, int cin, int cout) {
  extern __shared__ float smem[];
  float* halo = smem;                        // [kCI][hs]
  float* gs = smem + kCI * kHaloMax;         // [nv][kWCO]
  __shared__ int nb[27];
  const int c0 = blockIdx.y * kCI, co0 = blockIdx.z * kWCO;
  const int ci = threadIdx.x / kWCO, co = threadIdx.x % kWCO;
  const int cc = min(kCI, cin - c0), cw = min(kWCO, cout - co0);
  const int t2 = t * t, t3 = t2 * t, tp = t + 2;
  const int slab = slab_planes(t);
  float acc[27];
#pragma unroll
  for (int d = 0; d < 27; ++d) acc[d] = 0.f;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();
    if (threadIdx.x < 27) nb[threadIdx.x] = slots[tile * 27 + threadIdx.x];
    __syncthreads();
    if (nb[13] < 0) continue;                // capacity padding
    const T* fb = feats + (tile / nt) * nt * t3 * cin;
    for (int z0 = 0; z0 < t; z0 += slab) {
      const int zs = min(slab, t - z0);
      const int nv = zs * t2;
      const int hs = (zs + 2) * tp * tp;
      __syncthreads();
      for (int j = threadIdx.x; j < hs * kCI; j += kThreads) {
        const int h = j / kCI, c = j % kCI;
        float val = 0.f;
        if (c < cc) {
          const int gz = z0 + h / (tp * tp) - 1, gy = (h / tp) % tp - 1,
                    gx = h % tp - 1;
          const int dz = delta_of(gz, t), dy = delta_of(gy, t),
                    dx = delta_of(gx, t);
          const int s = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
          if (s >= 0) {
            const int sz = gz - dz * t, sy = gy - dy * t, sx = gx - dx * t;
            val = to_float(fb[((long long)s * t3 + (sz * t + sy) * t + sx)
                              * cin + c0 + c]);
          }
        }
        halo[c * hs + h] = val;
      }
      const T* gb = g + (tile * t3 + (long long)z0 * t2) * cout + co0;
      for (int j = threadIdx.x; j < nv * kWCO; j += kThreads) {
        const int v = j / kWCO, k = j % kWCO;
        gs[j] = k < cw ? to_float(gb[(long long)v * cout + k]) : 0.f;
      }
      __syncthreads();
      const float* hrow = halo + ci * hs;
      for (int v = 0; v < nv; ++v) {
        const int z = v / t2, y = (v / t) % t, x = v % t;
        const int hb = ((z + 1) * tp + (y + 1)) * tp + (x + 1);
        const float gv = gs[v * kWCO + co];
#pragma unroll
        for (int d = 0; d < 27; ++d) {
          const int off = (d / 9 - 1) * tp * tp + ((d / 3) % 3 - 1) * tp
                          + (d % 3 - 1);
          acc[d] = fmaf(hrow[hb + off], gv, acc[d]);
        }
      }
    }
  }
  if (ci < cc && co < cw) {
    float* p = partial + (long long)blockIdx.x * 27 * cin * cout;
#pragma unroll
    for (int d = 0; d < 27; ++d)
      p[((long long)d * cin + c0 + ci) * cout + co0 + co] = acc[d];
  }
}

// bf16, t = 8, Cout a multiple of 32: the wgrad on the tensor cores. For
// tap d, dW[d] (Cin x Cout) = sum over the real tiles' voxels v of halo(v
// + delta_d)^T g(v): M = Cin, N = Cout, K = the voxels. A block of 9 warps
// takes one tap group (the 9 taps of one dz, warp w tap (dy, dx) = (w / 3
// - 1, w % 3 - 1)), one slice of CS = 16 MT input channels and one of NS =
// 8 NT output channels, and walks its share of the real tiles: the block
// of x index r of R takes the real tiles of rank r, r + R, ... (ranked by
// one ballot pass over the slot table), so that the real tiles spread
// evenly whatever the padding. A tile is taken in kWgSlabs slabs of kWgSZ
// z planes; a stage holds, for its slab, the kWgSZ halo planes the tap
// group reads (plane z + dz of each plane z, 10 x 10 rows of CS channels,
// through the slot table) and the slab's cotangent rows (NS channels), and
// a ring of kWgNST stages keeps the next slabs in flight by cp.async while
// one is multiplied. Each halo plane of a tile is thus staged once per
// tap group (3 times in all, against the former 3 shifted copies of the
// whole tile per Cout slice of 32) and each cotangent row once per Cin
// slice and tap group. For each 16 voxels (two x-lines) a warp reads g
// (voxels x NS) by ldmatrix.trans as B and its tap's halo rows (voxels x
// CS, the same runs of 8 consecutive rows 10 rows apart as the forward's)
// by ldmatrix.trans as A, from the one halo copy; both swizzled by hswz.
// dW stays in the accumulators (4 MT NT f32 a thread) across the block's
// tiles; the block writes them to row r of a (R, 27 Cin, Cout) partial
// table, which wgrad_reduce_kernel sums in row order: no float atomics,
// and two calls give the same bits.
constexpr int kWgWarps = 9;                  // one tap of a tap group each
constexpr int kWgThreads = kWgWarps * 32;
constexpr int kWgSZ = 2;                     // z planes a stage
constexpr int kWgSlabs = kT / kWgSZ;         // stages a tile
constexpr int kWgNST = 3;                    // stages in the ring
constexpr int kWgList = 1024;                // a block's tiles at most

__host__ __device__ constexpr int wg_halo_bytes(int cs) {
  return kWgSZ * 100 * cs * 2;
}
__host__ __device__ constexpr int wg_stage_bytes(int cs, int ns) {
  return wg_halo_bytes(cs) + kWgSZ * 64 * ns * 2;
}
__host__ __device__ constexpr int wg_mma_smem(int cs, int ns) {
  return kWgNST * wg_stage_bytes(cs, ns);
}

// feats (B, NT, 512, Cin), g (B, NT, 512, Cout) bf16; partial (R, 27 Cin,
// Cout) f32 with R = gridDim.x; blockIdx.y = (tap group dz + 1) + 3 (Cin
// slice + slices of Cin * Cout slice).
template <int MT, int NT>
__global__ void __launch_bounds__(kWgThreads, 1) block_wgrad_mma_kernel(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ g, float* __restrict__ partial,
    long long tiles, int nt, int cin, int cout) {
  constexpr int CS = 16 * MT, NS = 8 * NT;
  constexpr int HU = CS / 8, GU = NS / 8;
  constexpr int HB = wg_halo_bytes(CS), SB = wg_stage_bytes(CS, NS);
  extern __shared__ __align__(128) uint8_t smem_wg[];
  __shared__ int list[kWgList];
  __shared__ int wcount[kWgWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = gridDim.x, r = blockIdx.x;
  const int nci = (cin + CS - 1) / CS;
  const int dz = blockIdx.y % 3 - 1;
  const int c0 = (blockIdx.y / 3) % nci * CS;
  const int o0 = blockIdx.y / (3 * nci) * NS;
  const bool vec = cin % 8 == 0;

  // this block's real tiles, in rank order
  int total = 0;
  for (long long base = 0; base < tiles; base += kWgThreads) {
    const long long tile = base + tid;
    const bool real = tile < tiles && slots[tile * 27 + 13] >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, real);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int before = total;
    for (int w = 0; w < kWgWarps; ++w) {
      if (w < warp) before += wcount[w];
      total += wcount[w];
    }
    const int rank = before + __popc(m & ((1u << lane) - 1u));
    if (real && rank % R == r) list[rank / R] = (int)tile;
    __syncthreads();
  }
  const int S = (total > r ? (total - r + R - 1) / R : 0) * kWgSlabs;

  // stage s: slab s % kWgSlabs of the block's tile s / kWgSlabs
  auto stage = [&](int s, uint8_t* buf) {
    const long long tile = list[s / kWgSlabs];
    const int z0 = s % kWgSlabs * kWgSZ;
    const int* sl = slots + tile * 27;
    const __nv_bfloat16* fb = feats + (tile / nt) * nt * kT3 * cin;
    for (int e = tid; e < kWgSZ * 100 * HU; e += kWgThreads) {
      const int h = e / HU, u = e % HU;
      const int gz = z0 + dz + h / 100, gy = (h / 10) % 10 - 1,
                gx = h % 10 - 1;
      const int ddz = delta_of(gz, kT), ddy = delta_of(gy, kT),
                ddx = delta_of(gx, kT);
      const int sn = __ldg(sl + (ddz + 1) * 9 + (ddy + 1) * 3 + (ddx + 1));
      const int src = ((gz - ddz * kT) * kT + (gy - ddy * kT)) * kT +
                      (gx - ddx * kT);
      const int n = sn >= 0 ? min(8, cin - c0 - u * 8) : 0;
      stage8(reinterpret_cast<__nv_bfloat16*>(buf + hswz(h, u, HU) * 16),
             fb + ((long long)max(sn, 0) * kT3 + src) * cin + c0 + u * 8, n,
             vec, fb);
    }
    const __nv_bfloat16* gb = g + (tile * kT3 + z0 * 64) * cout + o0;
    for (int e = tid; e < kWgSZ * 64 * GU; e += kWgThreads) {
      const int v = e / GU, u = e % GU;
      cp_async16(buf + HB + hswz(v, u, GU) * 16,
                 gb + (long long)v * cout + u * 8, true);
    }
  };

#pragma unroll
  for (int s = 0; s < kWgNST - 1; ++s) {
    if (s < S) stage(s, smem_wg + s * SB);
    cp_commit();
  }

  // the lane's ldmatrix rows: A (halo, .trans) voxel lv of a K step's 16
  // (line lv / 8, x = lv % 8) at the warp's tap and channel half lh; B (g,
  // .trans) voxel bv
  const int dy = warp / 3 - 1, dx = warp % 3 - 1;
  const int lh = (lane >> 3) & 1;
  const int lv = (lane & 7) + (lane >> 4) * 8;
  const int bv = (lane & 7) + lh * 8;
  const int ha = ((lv >> 3) + 1 + dy) * 10 + (lv & 7) + 1 + dx;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][q][i] = 0.f;

  for (int s = 0; s < S; ++s) {
    cp_wait<kWgNST - 2>();
    __syncthreads();   // stage s is in; stage s - 1's buffer is free
    if (s + kWgNST - 1 < S)
      stage(s + kWgNST - 1, smem_wg + ((s + kWgNST - 1) % kWgNST) * SB);
    cp_commit();
    const uint32_t hs = smem_addr(smem_wg + (s % kWgNST) * SB);
    const uint32_t gs = hs + HB;
#pragma unroll
    for (int kq = 0; kq < kWgSZ * 4; ++kq) {
      // voxels (i, y .. y + 1, 0..7) of the slab, i = kq / 4, y = 2 (kq % 4)
      const int v0 = kq * 16;
      const int h0 = (kq / 4) * 100 + (kq % 4) * 20;
      uint32_t bf[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm4t(bb, gs + hswz(v0 + bv, 2 * np + (lane >> 4), GU) * 16);
        bf[2 * np][0] = bb[0];
        bf[2 * np][1] = bb[1];
        bf[2 * np + 1][0] = bb[2];
        bf[2 * np + 1][1] = bb[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldsm4t(a, hs + hswz(h0 + ha, 2 * m + lh, HU) * 16);
#pragma unroll
        for (int q = 0; q < NT; ++q) mma(acc[m][q], a, bf[q][0], bf[q][1]);
      }
    }
  }
  cp_wait<0>();

  // row r of the table: row g + 8 h of m16 tile m is input channel c0 +
  // 16 m + g + 8 h of tap d, column 8 q + 2 t (+ 1) output o0 + 8 q + 2 t
  const int d = (dz + 1) * 9 + warp;
  const int gq = lane >> 2, t = lane & 3;
  float* p = partial + (long long)r * 27 * cin * cout;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = c0 + 16 * m + gq + 8 * h;
      if (ci >= cin) continue;
#pragma unroll
      for (int q = 0; q < NT; ++q)
        *reinterpret_cast<float2*>(
            p + ((long long)d * cin + ci) * cout + o0 + 8 * q + 2 * t) =
            make_float2(acc[m][q][2 * h], acc[m][q][2 * h + 1]);
    }
}

// The same wgrad on warpgroup products where the slices are 64 x 64
// (Cin > 32, Cout a multiple of 64): M = 64 input channels, N = 64 output
// channels, K = the voxels. Three warpgroups, each the three taps (dz, dy,
// dx = -1..1) of one dy of the block's tap group, so that one wgmma
// m64n64k16 a tap and K step reads the step's cotangent rows (B) and the
// tap's halo rows (A), both from shared memory by descriptor. A is
// MN-major without swizzle: the slab's halo staged unit-major ([8 units]
// [kWgSZ 100 rows] of 16 bytes), so that the 8 voxels of an x-line under
// a tap are one 128-byte core matrix (8 K rows of 8 channels) at any row,
// the two lines of a K step 160 bytes apart and the 8 channel units a
// unit apart; B is MN-major with the 128-byte swizzle (the slab's rows of
// 64 channels). Each thread keeps 3 x 32 f32 sums; a stage is refilled
// two stages after the products that read it were issued.
constexpr int kWgmmaWgThreads = 3 * 128;
constexpr int kWgmmaHalo = kWgSZ * 100 * 64 * 2;   // A of one stage
constexpr int kWgmmaG = kWgSZ * 64 * 64 * 2;       // B of one stage
constexpr int kWgmmaWgNST = 4;

__host__ __device__ constexpr int wg_wgmma_smem() {
  return 1024 + kWgmmaWgNST * (kWgmmaG + kWgmmaHalo);
}

__global__ void __launch_bounds__(kWgmmaWgThreads, 1)
    block_wgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ feats,
                             const int* __restrict__ slots,
                             const __nv_bfloat16* __restrict__ g,
                             float* __restrict__ partial, long long tiles,
                             int nt, int cin, int cout) {
  constexpr int SB = kWgmmaG + kWgmmaHalo;
  constexpr int kAhead = kWgmmaWgNST - 2;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ int list[kWgList];
  __shared__ int wcount[kWgmmaWgThreads / 32];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = gridDim.x, r = blockIdx.x;
  const int nci = (cin + 63) / 64;
  const int dz = blockIdx.y % 3 - 1;
  const int c0 = (blockIdx.y / 3) % nci * 64;
  const int o0 = blockIdx.y / (3 * nci) * 64;
  const bool vec = cin % 8 == 0;

  int total = 0;
  for (long long base = 0; base < tiles; base += kWgmmaWgThreads) {
    const long long tile = base + tid;
    const bool real = tile < tiles && slots[tile * 27 + 13] >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, real);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int before = total;
    for (int w = 0; w < kWgmmaWgThreads / 32; ++w) {
      if (w < warp) before += wcount[w];
      total += wcount[w];
    }
    const int rank = before + __popc(m & ((1u << lane) - 1u));
    if (real && rank % R == r) list[rank / R] = (int)tile;
    __syncthreads();
  }
  const int S = (total > r ? (total - r + R - 1) / R : 0) * kWgSlabs;

  // stage s: slab s % kWgSlabs of the block's tile s / kWgSlabs; g rows
  // first ([128 rows][64], swizzled), then the halo ([8][kWgSZ 100])
  auto stage = [&](int s, uint8_t* buf) {
    const long long tile = list[s / kWgSlabs];
    const int z0 = s % kWgSlabs * kWgSZ;
    const int* sl = slots + tile * 27;
    const __nv_bfloat16* fb = feats + (tile / nt) * nt * kT3 * cin;
    const __nv_bfloat16* gb = g + (tile * kT3 + z0 * 64) * cout + o0;
    for (int e = tid; e < kWgSZ * 64 * 8; e += kWgmmaWgThreads) {
      const int v = e / 8, u = e % 8;
      cp_async16(buf + v * 128 + ((u ^ (v & 7)) * 16),
                 gb + (long long)v * cout + u * 8, true);
    }
    uint8_t* hb = buf + kWgmmaG;
    for (int e = tid; e < kWgSZ * 100 * 8; e += kWgmmaWgThreads) {
      const int h = e % (kWgSZ * 100), u = e / (kWgSZ * 100);
      const int gz = z0 + dz + h / 100, gy = (h / 10) % 10 - 1,
                gx = h % 10 - 1;
      const int ddz = delta_of(gz, kT), ddy = delta_of(gy, kT),
                ddx = delta_of(gx, kT);
      const int sn = __ldg(sl + (ddz + 1) * 9 + (ddy + 1) * 3 + (ddx + 1));
      const int src = ((gz - ddz * kT) * kT + (gy - ddy * kT)) * kT +
                      (gx - ddx * kT);
      const int n = sn >= 0 ? min(8, cin - c0 - u * 8) : 0;
      stage8(reinterpret_cast<__nv_bfloat16*>(hb + (u * kWgSZ * 100 + h) *
                                              16),
             fb + ((long long)max(sn, 0) * kT3 + src) * cin + c0 + u * 8, n,
             vec, fb);
    }
  };

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < S) stage(s, smem + s * SB);
    cp_commit();
  }

  const int dy = warp / 4 - 1;               // this warpgroup's taps
  float acc[3][32];   // the first wgmma starts the sum (scale_d = 0)
  for (int s = 0; s < S; ++s) {
    hopper::wgmma_wait<1>();
    cp_wait<kAhead - 1>();
    hopper::fence_proxy_async();
    __syncthreads();   // stage s is in; stage s - 2's products completed
    if (s + kAhead < S)
      stage(s + kAhead, smem + ((s + kAhead) % kWgmmaWgNST) * SB);
    cp_commit();
    const uint32_t gs = smem_addr(smem + (s % kWgmmaWgNST) * SB);
    const uint32_t hs = gs + kWgmmaG;
    hopper::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kWgSZ * 4; ++kq) {
      // voxels (i, y .. y + 1, 0..7) of the slab, i = kq / 4, y = 2 (kq %
      // 4): 16 cotangent rows from kq 16, and for tap (dz, dy, dx) the
      // halo rows of (i, y + 1 + dy, 1 + dx) and the next line
      const uint64_t db =
          desc_none(gs + kq * 2048, 8192, 1024) | (1ull << 62);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int h0 = (kq / 4) * 100 + ((kq % 4) * 2 + 1 + dy) * 10 + j;
        // MN-major without swizzle: LBO the K step between core
        // matrices (the next x-line), SBO the M step (the next 8 channels)
        const uint64_t da =
            desc_none(hs + h0 * 16, 160, kWgSZ * 100 * 16);
        hopper::wgmma_ss_n<64, 1, 1>(acc[j], da, db, (s | kq) != 0);
      }
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 3; ++j) hopper::fence_acc(acc[j]);
  cp_wait<0>();

  // row r of the table: row 16 (warp % 4) + gq (+ 8) of tap j's m64 tile
  // is input channel c0 + that row, n8 block q columns o0 + 8 q + 2 t (+ 1)
  const int gq = lane >> 2, t = lane & 3;
  float* p = partial + (long long)r * 27 * cin * cout;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int d = (dz + 1) * 9 + (dy + 1) * 3 + j;
    if (S == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = c0 + 16 * (warp & 3) + gq + 8 * h;
      if (ci >= cin) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<float2*>(
            p + ((long long)d * cin + ci) * cout + o0 + 8 * q + 2 * t) =
            make_float2(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
    }
  }
}

// dw[e] = the sum of the partial table's ``groups`` rows, in row order,
// rounded once to the weights' type
template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_reduce_kernel(
    const float* __restrict__ partial, int groups, long long n,
    T* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
#pragma unroll 8
  for (int r = 0; r < groups; ++r) acc += partial[(long long)r * n + e];
  dw[e] = from_float<T>(acc);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDgrad = 1, kWgrad = 2 };

// The route of a launch, decided before it and shared by the wrapper
// (pcseg_block_route) and the entries: 1 for the tensor-core kernels, 0
// for the CUDA-core ones. k and n are the GEMM's input and output
// channels: the forward's Cin and Cout, the dgrad's Cout and Cin (the
// forward's), the wgrad's Cin and Cout. All three take bf16 at t = 8 with
// 16-byte aligned tensors; the forward and the dgrad an output width n a
// multiple of 32 up to kNMax (the dgrad also k a multiple of 8: its
// weight rows are read in 16-byte units), the wgrad any Cin and Cout a
// multiple of 32.
int block_route(int kind, int t, int k, int n, int is_bf16, int aligned) {
  if (!is_bf16 || t != kT || !aligned || k < 1 || n < 1 || n % 32)
    return 0;
  if (kind == kWgrad) return 1;
  if (n > kNMax) return 0;
  return kind == kFwd || k % 8 == 0;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <int NW>
int launch_mma_nw(const void* x, const void* slots, const void* w2,
                  void* out, int B, int NT, int k, bool dgrad,
                  cudaStream_t stream) {
  auto kern = dgrad ? block_dgrad_mma_kernel<NW> : block_conv_mma_kernel<NW>;
  constexpr int smem = conv_mma_smem(NW * 16);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * NT), kT / kPZ);
  kern<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const int*)slots, (const __nv_bfloat16*)w2,
      (__nv_bfloat16*)out, NT, k);
  return (int)cudaGetLastError();
}

// KS k16 steps a chunk: 1 where the input is at most 16 channels wide
// (the stem), else 2
template <int N, int KS>
int launch_wgmma(const void* x, const void* slots, const void* w2, void* out,
                 int B, int NT, int k, bool dgrad, cudaStream_t stream) {
  auto kern = dgrad ? block_dgrad_wgmma_kernel<N, KS>
                    : block_conv_wgmma_kernel<N, KS>;
  constexpr int smem = conv_wgmma_smem(N);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * NT), kT / kPZ);
  kern<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const int*)slots, (const __nv_bfloat16*)w2,
      (__nv_bfloat16*)out, NT, k);
  return (int)cudaGetLastError();
}

// the tensor-core forward or dgrad of output width n: warpgroup products
// at 64 and 128, mma.sync at 32 and 96
int launch_mma(const void* x, const void* slots, const void* w2, void* out,
               int B, int NT, int k, int n, bool dgrad, cudaStream_t s) {
  switch (n) {
    case 32: return launch_mma_nw<2>(x, slots, w2, out, B, NT, k, dgrad, s);
    case 64:
      return k <= 16 ? launch_wgmma<64, 1>(x, slots, w2, out, B, NT, k, dgrad, s)
                     : launch_wgmma<64, 2>(x, slots, w2, out, B, NT, k, dgrad, s);
    case 96: return launch_mma_nw<6>(x, slots, w2, out, B, NT, k, dgrad, s);
    case 128:
      return k <= 16
                 ? launch_wgmma<128, 1>(x, slots, w2, out, B, NT, k, dgrad, s)
                 : launch_wgmma<128, 2>(x, slots, w2, out, B, NT, k, dgrad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int CO>
int launch(const void* feats, const void* slots, const void* w2, void* out,
           int B, int NT, int t, int cin, int cout, bool dgrad,
           cudaStream_t stream) {
  auto kern = dgrad ? block_dgrad_kernel<T, CO> : block_conv_kernel<T, CO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<CO>());
  if (err != cudaSuccess) return (int)err;
  const int slab = slab_planes(t);
  dim3 grid((unsigned)(B * NT), (unsigned)((cout + CO - 1) / CO),
            (unsigned)((t + slab - 1) / slab));
  kern<<<grid, kThreads, smem_bytes<CO>(), stream>>>(
      (const T*)feats, (const int*)slots, (const T*)w2, (T*)out, NT, t, cin,
      cout);
  return (int)cudaGetLastError();
}

// One forward (dgrad false: x the features, w2 (27 cin, cout)) or dgrad
// (x the cotangent with cin = the forward's Cout channels, w2 the
// forward's (27 cout, cin) taps, read flipped in place) into out (B, NT,
// t^3, cout).
int conv(const void* x, const void* slots, const void* w2, void* out,
         int B, int NT, int t, int cin, int cout, int is_bf16, bool dgrad,
         void* stream) {
  if (B <= 0 || NT <= 0 || t <= 0 || t > kMaxT || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (block_route(dgrad ? kDgrad : kFwd, t, cin, cout, is_bf16,
                  aligned16({x, slots, w2, out})))
    return launch_mma(x, slots, w2, out, B, NT, cin, cout, dgrad, s);
  const bool wide = cout % 32 == 0;
  if (is_bf16)
    return wide ? launch<__nv_bfloat16, 32>(x, slots, w2, out, B, NT, t,
                                            cin, cout, dgrad, s)
                : launch<__nv_bfloat16, 16>(x, slots, w2, out, B, NT, t,
                                            cin, cout, dgrad, s);
  return wide ? launch<float, 32>(x, slots, w2, out, B, NT, t, cin, cout,
                                  dgrad, s)
              : launch<float, 16>(x, slots, w2, out, B, NT, t, cin, cout,
                                  dgrad, s);
}

constexpr int wgrad_smem_bytes() {
  return (kCI * kHaloMax + kSlabVox * kWCO) * (int)sizeof(float);
}

// The tensor-core wgrad's slices: CS input channels (16, 32 or 64,
// zero-filled past Cin) and NS output channels (64 where Cout allows, else
// 32) a block.
void wg_slices(int cin, int cout, int* cs, int* ns) {
  *cs = cin <= 16 ? 16 : cin <= 32 ? 32 : 64;
  *ns = cout % 64 == 0 ? 64 : 32;
}

void* wg_mma_kernel(int cs, int ns) {
  const int mt = cs / 16;
  if (ns == 64)
    return mt == 1 ? (void*)block_wgrad_mma_kernel<1, 8>
           : mt == 2 ? (void*)block_wgrad_mma_kernel<2, 8>
                     : (void*)block_wgrad_mma_kernel<4, 8>;
  return mt == 1 ? (void*)block_wgrad_mma_kernel<1, 4>
         : mt == 2 ? (void*)block_wgrad_mma_kernel<2, 4>
                   : (void*)block_wgrad_mma_kernel<4, 4>;
}

// A wgrad launch: its kernel, block size, dynamic shared memory, the
// channel slices a tile range is split over (blocks a row of the partial
// table) and the rows, R. R fills one wave of resident blocks, stays
// within the tiles, within the bytes of the features and cotangent the
// table reduces (as conv3d_dgrad.cu's wgrad does), and is large enough
// for a block's list of tiles (kWgList).
struct WgPlan {
  void* kern;
  int threads, smem, chunks, rows;
};

WgPlan wgrad_plan(long long tiles, int t, int cin, int cout, int is_bf16,
                  bool mma) {
  WgPlan pl;
  if (mma) {
    int cs, ns;
    wg_slices(cin, cout, &cs, &ns);
    const bool wg = cs == 64 && ns == 64;    // 64 x 64 slices: wgmma
    pl.kern = wg ? (void*)block_wgrad_wgmma_kernel : wg_mma_kernel(cs, ns);
    pl.threads = wg ? kWgmmaWgThreads : kWgThreads;
    pl.smem = wg ? wg_wgmma_smem() : wg_mma_smem(cs, ns);
    pl.chunks = 3 * ((cin + cs - 1) / cs) * (cout / ns);
  } else {
    pl.kern = is_bf16 ? (void*)block_wgrad_kernel<__nv_bfloat16>
                      : (void*)block_wgrad_kernel<float>;
    pl.threads = kThreads;
    pl.smem = wgrad_smem_bytes();
    pl.chunks = ((cin + kCI - 1) / kCI) * ((cout + kWCO - 1) / kWCO);
  }
  cudaFuncSetAttribute(pl.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pl.smem);
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kern, pl.threads,
                                                pl.smem);
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1)
                          * (sms > 0 ? sms : 1);
  long long rows = slots / pl.chunks;
  if (mma) {
    const long long most = tiles * t * t * t * (cin + cout) * 2
                           / (27LL * cin * cout * 4);
    rows = rows < most ? rows : most;
    const long long least = (tiles + kWgList - 1) / kWgList;
    rows = rows > least ? rows : least;
  }
  pl.rows = (int)(rows < 1 ? 1 : (rows > tiles ? tiles : rows));
  return pl;
}

}  // namespace

extern "C" {

// 1 where a launch of ``kind`` (0 forward, 1 dgrad, 2 wgrad) of GEMM
// input and output channels k and n takes the tensor-core kernels (the
// wrappers count those launches apart), 0 where it takes the CUDA-core
// ones; ``aligned`` 1 where every tensor is 16-byte aligned.
int pcseg_block_route(int kind, int t, int k, int n, int is_bf16,
                      int aligned) {
  return block_route(kind, t, k, n, is_bf16, aligned);
}

// feats (B, NT, t^3, Cin) bf16 (is_bf16 = 1) or f32; slots (B, NT, 27)
// int32; w2 (27 * Cin, Cout) in the feature type; out (B, NT, t^3, Cout)
// in the feature type. 1 <= t <= 16, Cin >= 1, Cout >= 1.
int pcseg_block_conv(const void* feats, const void* slots, const void* w2,
                     void* out, int B, int NT, int t, int Cin, int Cout,
                     int is_bf16, void* stream) {
  return conv(feats, slots, w2, out, B, NT, t, Cin, Cout, is_bf16, false,
              stream);
}

// The conv's dgrad: g (B, NT, t^3, Cout) the cotangent in the feature
// type; w2 (27 * Cin, Cout) the forward's taps, read flipped and
// transposed in place (tap d takes W[26 - d]^T, _flip_w2's); dx (B, NT,
// t^3, Cin). The forward's body over the same slot table.
int pcseg_block_conv_dgrad(const void* g, const void* slots, const void* w2,
                           void* dx, int B, int NT, int t, int Cout, int Cin,
                           int is_bf16, void* stream) {
  return conv(g, slots, w2, dx, B, NT, t, Cout, Cin, is_bf16, true, stream);
}

// Rows of the wgrad's partial table: the wrapper allocates rows * 27 *
// Cin * Cout f32 of scratch for pcseg_block_wgrad, ``aligned`` as for
// pcseg_block_route.
int pcseg_block_wgrad_groups(int B, int NT, int t, int Cin, int Cout,
                             int is_bf16, int aligned) {
  if (B <= 0 || NT <= 0 || t <= 0 || t > kMaxT || Cin <= 0 || Cout <= 0)
    return 0;
  const bool mma = block_route(kWgrad, t, Cin, Cout, is_bf16, aligned);
  return wgrad_plan((long long)B * NT, t, Cin, Cout, is_bf16, mma).rows;
}

// feats (B, NT, t^3, Cin) and g (B, NT, t^3, Cout), both bf16 (is_bf16 =
// 1) or f32; slots (B, NT, 27) int32; partial scratch of ``groups`` *
// 27 * Cin * Cout f32, groups from pcseg_block_wgrad_groups; dw (27 *
// Cin, Cout) bf16 (dw_bf16 = 1) or f32. 1 <= t <= 16.
int pcseg_block_wgrad(const void* feats, const void* slots, const void* g,
                      void* partial, void* dw, int B, int NT, int t, int Cin,
                      int Cout, int is_bf16, int dw_bf16, int groups,
                      void* stream) {
  if (B <= 0 || NT <= 0 || t <= 0 || t > kMaxT || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (long long)B * NT;
  const bool mma = block_route(kWgrad, t, Cin, Cout, is_bf16,
                               aligned16({feats, slots, g}));
  const WgPlan pl = wgrad_plan(tiles, t, Cin, Cout, is_bf16, mma);
  if (pl.rows != groups) return (int)cudaErrorInvalidValue;
  float* part = (float*)partial;
  if (mma) {
    dim3 grid((unsigned)groups, (unsigned)pl.chunks);
    void* args[] = {(void*)&feats, (void*)&slots, (void*)&g, (void*)&part,
                    (void*)&tiles, (void*)&NT, (void*)&Cin, (void*)&Cout};
    cudaError_t err = cudaLaunchKernel(pl.kern, grid, dim3(pl.threads),
                                       args, (size_t)pl.smem, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    dim3 grid((unsigned)groups, (unsigned)((Cin + kCI - 1) / kCI),
              (unsigned)((Cout + kWCO - 1) / kWCO));
    if (is_bf16)
      block_wgrad_kernel<__nv_bfloat16><<<grid, kThreads, wgrad_smem_bytes(),
                                          s>>>(
          (const __nv_bfloat16*)feats, (const int*)slots,
          (const __nv_bfloat16*)g, part, tiles, NT, t, Cin, Cout);
    else
      block_wgrad_kernel<float><<<grid, kThreads, wgrad_smem_bytes(), s>>>(
          (const float*)feats, (const int*)slots, (const float*)g, part,
          tiles, NT, t, Cin, Cout);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = 27LL * Cin * Cout;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (dw_bf16)
    wgrad_reduce_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        part, groups, n, (__nv_bfloat16*)dw);
  else
    wgrad_reduce_kernel<float><<<blocks, kThreads, 0, s>>>(part, groups, n,
                                                           (float*)dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
