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
//                           W[-d]^T), which the caller passes. For kept
//                           tiles slot_G(d) = H iff slot_H(-d) = G, so this
//                           is the exact adjoint; a separate entry only so
//                           that a profile tells its launches apart.
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
// around Mosaic. Here a block stages a tile's halo for a pass of input
// channels in shared memory, gathered through the slot table, and keeps
// f32 sums in registers. Forms:
// - conv, bf16 at t = 8 with Cout a multiple of 32 (every serving shape of
//   the sparse U-Net but the stem): conv_wmma_body, the tap products as
//   WMMA m8n32k16 tensor-core products of x-lines of the halo.
// - conv, otherwise (f32, the stem, other t up to 16, any Cout):
//   conv_body, f32 FMAs on the CUDA cores, each of the 256 threads keeping
//   the sums of two voxels by 16 or 32 outputs (a masked tail where Cout is
//   not a multiple of 16). A tile of more than 512 voxels (t > 8) is cut
//   into z-slabs of at most 512 voxels, one block each, whose halo has two
//   planes more than the slab: at t = 16, 4 x 18 x 18 voxels a channel.
// - wgrad, bf16 at t = 8 with Cout % 32 == 0 (every conv of the sparse
//   U-Net, the stem's 2 input channels padded to a 16-channel pass):
//   block_wgrad_wmma_kernel, an implicit GEMM over the voxels, K = 16
//   voxels (two x-lines) a WMMA m16n16k16 product. The halo is staged three
//   times, shifted by dx = -1, 0, +1 and cut to x-lines of 8 voxels, so
//   that the 16 voxels of two neighbouring x-lines of any tap are 16
//   consecutive rows.
// - wgrad, otherwise (f32, other t, Cout not a multiple of 32):
//   block_wgrad_kernel, each thread one (input, output) channel pair with
//   the f32 sums of its 27 taps.
// A wgrad block walks a group of tiles (every groups-th, so that each
// event's real tiles spread over the groups; one wave of blocks) and
// writes its sums as one row of a (groups, 27 * Cin, Cout) f32 partial
// table; wgrad_reduce_kernel adds the rows in a fixed order and rounds
// once. bf16 products are exact in f32,
// so every form gives the f32 sums of the TPU's MXU, rounded once.
//
// What bounds them: operations. 2 * 27 * Cin * Cout flops a voxel of a
// real tile against ~200 bytes of features; at the sparse U-Net's level-1
// 128 -> 128 conv that is 1.8e4 flops a byte, far above the card's ratio.
// The WMMA forms stage their operands with cp.async (16 bytes a thread, no
// register round trip, all loads of a pass in flight at once) but without
// a pipeline: staging and products alternate, and two blocks an SM hide
// part of it; a wgmma form with TMA staging is the next step.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
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

// The CUDA-core conv: block (tile, Cout chunk of CO, z-slab).
template <typename T, int CO>
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
    for (int i = threadIdx.x; i < 27 * kCI * CO; i += kThreads) {
      const int k = i % CO, ci = (i / CO) % kCI, d = i / (CO * kCI);
      ws[i] = ci < cc && k < cw
                  ? to_float(w2[((long long)d * cin + c0 + ci) * cout + co0
                                + k])
                  : 0.f;
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
  conv_body<T, CO>(feats, slots, w2, out, nt, t, cin, cout, smem, nb);
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads) block_dgrad_kernel(
    const T* __restrict__ feats, const int* __restrict__ slots,
    const T* __restrict__ w2, T* __restrict__ out, int nt, int t, int cin,
    int cout) {
  extern __shared__ float smem[];
  __shared__ int nb[27];
  conv_body<T, CO>(feats, slots, w2, out, nt, t, cin, cout, smem, nb);
}

// ---------------------------------------------------------------------------
// bf16, t = 8, Cout a multiple of 32: the same conv on the tensor cores
// ---------------------------------------------------------------------------
//
// One block per (event, tile, 32 output channels), one warp per z plane of
// the tile. Per pass of kKC = 16 input channels the block stages the
// 10^3-voxel halo as bf16 rows of 16 channels (32 bytes, channel-minor, so
// that 8 voxels along x form an 8 x 16 WMMA A tile with a leading dimension
// of 16) and the 27 x 16 x 32 weights; each warp keeps the f32 sums of its
// 8 x-lines x 32 outputs in 8 m8n32k16 accumulators and adds, for each tap,
// the product of each line's shifted 8 x 16 halo rows with the tap's
// 16 x 32 weights. bf16 products are exact in the f32 sums; the sums round
// once, at the store, through a per-warp f32 scratch tile.

namespace wmma = nvcuda::wmma;

constexpr int kKC = 16;                      // input channels a pass
constexpr int kCOW = 32;                     // output channels a block
constexpr int kT = 8;                        // tile edge of this path
constexpr int kTp = kT + 2;
constexpr int kHalo = kTp * kTp * kTp;
constexpr int kWarps = kThreads / 32;        // == kT: one z plane each

constexpr int wmma_smem_bytes() {
  return kHalo * kKC * 2 + 27 * kKC * kCOW * 2 + kWarps * kT * kCOW * 4;
}

__device__ __forceinline__ void conv_wmma_body(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int nt, int cin, int cout, unsigned char* smem_raw, int* nb) {
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = halo + kHalo * kKC;                // [27][kKC][kCOW]
  float* scratch = reinterpret_cast<float*>(ws + 27 * kKC * kCOW);

  constexpr int t3 = kT * kT * kT;
  const long long tile = blockIdx.x;
  const long long b = tile / nt;
  const int co0 = blockIdx.y * kCOW;
  if (threadIdx.x < 27) nb[threadIdx.x] = slots[tile * 27 + threadIdx.x];
  __syncthreads();
  __nv_bfloat16* o = out + tile * t3 * cout + co0;
  if (nb[13] < 0) {                          // capacity padding: zeros
    float zero[kCOW] = {};
    for (int v = threadIdx.x; v < t3; v += kThreads)
      store_row<kCOW>(o + (long long)v * cout, zero);
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 8, 32, 16, float> acc[kT];
#pragma unroll
  for (int l = 0; l < kT; ++l) wmma::fill_fragment(acc[l], 0.f);
  const __nv_bfloat16* fb = feats + b * nt * t3 * cin;
  const bool vec = cin % 8 == 0;

  for (int c0 = 0; c0 < cin; c0 += kKC) {
    const int cc = min(kKC, cin - c0);
    // the halo, 8 channels (16 bytes) a step, through the slot table
    for (int i = threadIdx.x; i < kHalo * 2; i += kThreads) {
      const int h = i / 2, part = i % 2;
      const int hz = h / (kTp * kTp), hy = (h / kTp) % kTp, hx = h % kTp;
      const int dz = hz == 0 ? -1 : (hz == kTp - 1 ? 1 : 0);
      const int dy = hy == 0 ? -1 : (hy == kTp - 1 ? 1 : 0);
      const int dx = hx == 0 ? -1 : (hx == kTp - 1 ? 1 : 0);
      const int s = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
      const int src = ((hz - 1 - dz * kT) * kT + (hy - 1 - dy * kT)) * kT
                      + (hx - 1 - dx * kT);
      const int n = s >= 0 ? min(8, cc - part * 8) : 0;
      stage8(halo + h * kKC + part * 8,
             fb + ((long long)max(s, 0) * t3 + src) * cin + c0 + part * 8, n,
             vec, fb);
    }
    // the weights of this pass: 8 outputs (16 bytes) a step
    for (int i = threadIdx.x; i < 27 * kKC * (kCOW / 8); i += kThreads) {
      const int q = i % (kCOW / 8), k = (i / (kCOW / 8)) % kKC,
                d = i / (kKC * (kCOW / 8));
      cp_async16(ws + (d * kKC + k) * kCOW + q * 8,
                 w2 + ((long long)d * cin + c0 + min(k, cc - 1)) * cout + co0
                     + q * 8,
                 k < cc);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int d = 0; d < 27; ++d) {
      const int off = (d / 9 - 1) * kTp * kTp + ((d / 3) % 3 - 1) * kTp
                      + (d % 3 - 1);
      wmma::fragment<wmma::matrix_b, 8, 32, 16, __nv_bfloat16,
                     wmma::row_major> bw;
      wmma::load_matrix_sync(bw, ws + d * kKC * kCOW, kCOW);
#pragma unroll
      for (int l = 0; l < kT; ++l) {
        // x-line (z = warp, y = l): halo rows from (z+1, y+1, 1) + off
        const int h0 = ((warp + 1) * kTp + (l + 1)) * kTp + 1 + off;
        wmma::fragment<wmma::matrix_a, 8, 32, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, halo + h0 * kKC, kKC);
        wmma::mma_sync(acc[l], a, bw, acc[l]);
      }
    }
    __syncthreads();
  }

  // round once: each line's 8 x 32 sums through the warp's scratch tile
  float* sc = scratch + warp * kT * kCOW;
  const int r = lane / 4, q = lane % 4;
#pragma unroll
  for (int l = 0; l < kT; ++l) {
    wmma::store_matrix_sync(sc, acc[l], kCOW, wmma::mem_row_major);
    __syncwarp();
    const int v = (warp * kT + l) * kT + r;
    store_row<8>(o + (long long)v * cout + q * 8, sc + r * kCOW + q * 8);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads) block_conv_wmma_kernel(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int nt, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int nb[27];
  conv_wmma_body(feats, slots, w2, out, nt, cin, cout, smem_raw, nb);
}

__global__ void __launch_bounds__(kThreads) block_dgrad_wmma_kernel(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int nt, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int nb[27];
  conv_wmma_body(feats, slots, w2, out, nt, cin, cout, smem_raw, nb);
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

// bf16, t = 8, Cout % 32 == 0: the wgrad on the tensor cores. Block
// (group of tiles, kKC input channels, zero-filled past Cin, kCOW
// outputs); warp w
// owns the taps w, w + 8, w + 16, w + 24 (< 27), two m16n16k16 f32
// accumulators (16 channels x 32 outputs) each, for the whole group. Per
// tile: sx[s][row][16] holds the halo shifted by dx = s - 1 and cut to
// x-lines, row = (hz * 10 + hy) * 8 + x <- halo (hz, hy, x + s); gs the
// tile's 512 cotangent rows of 32 outputs. The 16 voxels of the x-lines
// (z, y) and (z, y + 1) under tap (dz, dy, dx) are then the 16 rows of sx
// from ((z + 1 + dz) * 10 + y + 1 + dy) * 8 on: a 16 x 16 col-major A tile
// (channels x voxels, leading dimension 16), against the 16 x 32 row-major
// B tile of the same voxels' cotangents.
constexpr int kSxRows = kTp * kTp * kT;      // 800 rows a shift

constexpr int wgrad_wmma_smem_bytes() {
  return 3 * kSxRows * kKC * 2 + kT * kT * kT * kCOW * 2;
}

__global__ void __launch_bounds__(kThreads) block_wgrad_wmma_kernel(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ g, float* __restrict__ partial,
    long long tiles, int nt, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = sx + 3 * kSxRows * kKC;            // [512][kCOW]
  float* scratch = reinterpret_cast<float*>(smem_raw);   // after the loop
  __shared__ int nb[27];
  constexpr int t3 = kT * kT * kT;
  const int c0 = blockIdx.y * kKC, co0 = blockIdx.z * kCOW;
  const int cc = min(kKC, cin - c0);
  const bool vec = cin % 8 == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc[j][0], 0.f);
    wmma::fill_fragment(acc[j][1], 0.f);
  }

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();
    if (threadIdx.x < 27) nb[threadIdx.x] = slots[tile * 27 + threadIdx.x];
    __syncthreads();
    if (nb[13] < 0) continue;                // capacity padding
    const __nv_bfloat16* fb = feats + (tile / nt) * nt * t3 * cin;
    // the three shifted halos, 8 channels (16 bytes) a step
    for (int j = threadIdx.x; j < 3 * kSxRows * 2; j += kThreads) {
      const int part = j % 2, row = (j / 2) % kSxRows, s = j / (2 * kSxRows);
      const int hz = row / (kTp * kT), hy = (row / kT) % kTp,
                hx = row % kT + s;
      const int dz = hz == 0 ? -1 : (hz == kTp - 1 ? 1 : 0);
      const int dy = hy == 0 ? -1 : (hy == kTp - 1 ? 1 : 0);
      const int dx = hx == 0 ? -1 : (hx == kTp - 1 ? 1 : 0);
      const int sl = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
      const int src = ((hz - 1 - dz * kT) * kT + (hy - 1 - dy * kT)) * kT
                      + (hx - 1 - dx * kT);
      const int n = sl >= 0 ? min(8, cc - part * 8) : 0;
      stage8(sx + (s * kSxRows + row) * kKC + part * 8,
             fb + ((long long)max(sl, 0) * t3 + src) * cin + c0 + part * 8,
             n, vec, fb);
    }
    // the tile's cotangent rows, 8 outputs (16 bytes) a step
    const __nv_bfloat16* gb = g + tile * t3 * cout + co0;
    for (int j = threadIdx.x; j < t3 * (kCOW / 8); j += kThreads) {
      const int q = j % (kCOW / 8), v = j / (kCOW / 8);
      cp_async16(gs + v * kCOW + q * 8, gb + (long long)v * cout + q * 8,
                 true);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int kb = 0; kb < t3 / 16; ++kb) {
      const int z = kb / (kT / 2), y = (kb % (kT / 2)) * 2;
      const int v0 = (z * kT + y) * kT;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b0, b1;
      wmma::load_matrix_sync(b0, gs + v0 * kCOW, kCOW);
      wmma::load_matrix_sync(b1, gs + v0 * kCOW + 16, kCOW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = warp + 8 * j;
        if (d < 27) {
          const int dz = d / 9 - 1, dy = (d / 3) % 3 - 1, dx = d % 3 - 1;
          const int r0 = (dx + 1) * kSxRows
                         + ((z + 1 + dz) * kTp + (y + 1 + dy)) * kT;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> a;
          wmma::load_matrix_sync(a, sx + r0 * kKC, kKC);
          wmma::mma_sync(acc[j][0], a, b0, acc[j][0]);
          wmma::mma_sync(acc[j][1], a, b1, acc[j][1]);
        }
      }
    }
  }

  __syncthreads();                           // sx is the scratch now
  float* sc = scratch + warp * kKC * kCOW;
  float* p = partial + (long long)blockIdx.x * 27 * cin * cout;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = warp + 8 * j;
    if (d < 27) {
      wmma::store_matrix_sync(sc, acc[j][0], kCOW, wmma::mem_row_major);
      wmma::store_matrix_sync(sc + 16, acc[j][1], kCOW, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < cc * kCOW; e += 32) {
        const int m = e / kCOW, n = e % kCOW;
        p[((long long)d * cin + c0 + m) * cout + co0 + n] = sc[e];
      }
      __syncwarp();
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

int launch_wmma(const void* feats, const void* slots, const void* w2,
                void* out, int B, int NT, int cin, int cout, bool dgrad,
                cudaStream_t stream) {
  auto kern = dgrad ? block_dgrad_wmma_kernel : block_conv_wmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, wmma_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * NT), (unsigned)(cout / kCOW));
  kern<<<grid, kThreads, wmma_smem_bytes(), stream>>>(
      (const __nv_bfloat16*)feats, (const int*)slots,
      (const __nv_bfloat16*)w2, (__nv_bfloat16*)out, NT, cin, cout);
  return (int)cudaGetLastError();
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

int conv(const void* feats, const void* slots, const void* w2, void* out,
         int B, int NT, int t, int cin, int cout, int is_bf16, bool dgrad,
         void* stream) {
  if (B <= 0 || NT <= 0 || t <= 0 || t > kMaxT || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = cout % 32 == 0;
  if (is_bf16 && wide && t == kT)
    return launch_wmma(feats, slots, w2, out, B, NT, cin, cout, dgrad, s);
  if (is_bf16)
    return wide ? launch<__nv_bfloat16, 32>(feats, slots, w2, out, B, NT, t,
                                            cin, cout, dgrad, s)
                : launch<__nv_bfloat16, 16>(feats, slots, w2, out, B, NT, t,
                                            cin, cout, dgrad, s);
  return wide ? launch<float, 32>(feats, slots, w2, out, B, NT, t, cin, cout,
                                  dgrad, s)
              : launch<float, 16>(feats, slots, w2, out, B, NT, t, cin, cout,
                                  dgrad, s);
}

bool wgrad_wmma(int t, int cout, int is_bf16) {
  return is_bf16 && t == kT && cout % kCOW == 0;
}

constexpr int wgrad_smem_bytes() {
  return (kCI * kHaloMax + kSlabVox * kWCO) * (int)sizeof(float);
}

// The wgrad kernel of a shape, its dynamic shared memory set.
template <typename T>
void* wgrad_kernel(bool wmma, int* smem) {
  void* kern;
  if (wmma) {
    kern = (void*)block_wgrad_wmma_kernel;
    *smem = wgrad_wmma_smem_bytes();
  } else {
    kern = (void*)block_wgrad_kernel<T>;
    *smem = wgrad_smem_bytes();
  }
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       *smem);
  return kern;
}

// Tile groups of a wgrad launch, the rows of its partial table: as many
// (group, channel chunk) blocks as the card holds at once, one wave, so
// that no tail wave of a few blocks doubles the time. A group takes the
// tiles g, g + groups, ..., spreading each event's real tiles (the first
// slots) and its padding over all groups.
int wgrad_groups(long long tiles, int t, int cin, int cout, int is_bf16) {
  const bool wmma = wgrad_wmma(t, cout, is_bf16);
  const int kc = wmma ? kKC : kCI;
  const long long chunks = (long long)((cin + kc - 1) / kc)
                           * ((cout + kWCO - 1) / kWCO);
  int smem, per_sm = 0, sms = 0, dev = 0;
  void* kern = is_bf16 ? wgrad_kernel<__nv_bfloat16>(wmma, &smem)
                       : wgrad_kernel<float>(wmma, &smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                smem);
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1)
                          * (sms > 0 ? sms : 1);
  const long long groups = slots / chunks;
  return (int)(groups < 1 ? 1 : (groups > tiles ? tiles : groups));
}

}  // namespace

extern "C" {

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
// type; w2f (27 * Cout, Cin), _flip_w2 of the forward's taps; dx (B, NT,
// t^3, Cin). The forward's body over the same slot table.
int pcseg_block_conv_dgrad(const void* g, const void* slots, const void* w2f,
                           void* dx, int B, int NT, int t, int Cout, int Cin,
                           int is_bf16, void* stream) {
  return conv(g, slots, w2f, dx, B, NT, t, Cout, Cin, is_bf16, true, stream);
}

// Rows of the wgrad's partial table: the wrapper allocates
// groups * 27 * Cin * Cout f32 of scratch for pcseg_block_wgrad.
int pcseg_block_wgrad_groups(int B, int NT, int t, int Cin, int Cout,
                             int is_bf16) {
  if (B <= 0 || NT <= 0 || t <= 0 || Cin <= 0 || Cout <= 0) return 0;
  return wgrad_groups((long long)B * NT, t, Cin, Cout, is_bf16);
}

// feats (B, NT, t^3, Cin) and g (B, NT, t^3, Cout), both bf16 (is_bf16 =
// 1) or f32; slots (B, NT, 27) int32; partial scratch of
// pcseg_block_wgrad_groups(...) * 27 * Cin * Cout f32; dw (27 * Cin, Cout)
// bf16 (dw_bf16 = 1) or f32. 1 <= t <= 16.
int pcseg_block_wgrad(const void* feats, const void* slots, const void* g,
                      void* partial, void* dw, int B, int NT, int t, int Cin,
                      int Cout, int is_bf16, int dw_bf16, void* stream) {
  if (B <= 0 || NT <= 0 || t <= 0 || t > kMaxT || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (long long)B * NT;
  const int groups = wgrad_groups(tiles, t, Cin, Cout, is_bf16);
  const bool wmma = wgrad_wmma(t, Cout, is_bf16);
  float* part = (float*)partial;
  cudaError_t err;
  if (wmma) {
    dim3 grid((unsigned)groups, (unsigned)((Cin + kKC - 1) / kKC),
              (unsigned)(Cout / kCOW));
    block_wgrad_wmma_kernel<<<grid, kThreads, wgrad_wmma_smem_bytes(), s>>>(
        (const __nv_bfloat16*)feats, (const int*)slots,
        (const __nv_bfloat16*)g, part, tiles, NT, Cin, Cout);
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
  err = cudaGetLastError();
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
