// Block-sparse submanifold 3^3 convolution for Hopper (sm_90a), forward.
//
//   pcseg_block_conv  replaces pcseg_tpu/ops/pallas/block_conv.py block_conv
//                     (_fwd_kernel, pallas_call at :382): the raw conv over
//                     the occupied t^3 tiles of each event,
//     out[b, n, v, o] = sum_{d, i} halo_{b,n}(v + delta_d)[i] W[d, i, o]
//                     with f32 sums rounded once to the feature type, no
//                     bias and no active mask (the fused LN kernel applies
//                     both).
//
// Layout: feats (B, NT, t^3, Cin), intra-tile voxel order (z * t + y) * t
// + x; slots (B, NT, 27) int32, the slot of the neighbour tile at tile
// delta d = (dz+1)*9 + (dy+1)*3 + (dx+1) (d = 13 is the tile itself), -1
// where there is none; w2 (27 * Cin, Cout), the (27, Cin, Cout) taps of
// subm_conv_init in the same d order. A neighbour voxel outside the tile
// is read from the tile in slots[d] at the wrapped position; slot -1 reads
// zero. A capacity-padding row has every slot -1 and zero features, so its
// output is exactly zero: the block writes zeros and computes nothing.
//
// The TPU kernel decomposes the conv into lane-legal 2D matmuls (x-banded
// weights, face/edge/corner tables, one-hot placement matmuls), all of
// which work around Mosaic. Here one block takes one (event, tile, Cout
// chunk), stages the tile's (t+2)^3 halo for a pass of input channels in
// shared memory, gathered through the slot table, with the weights of
// those channels beside it, and keeps the f32 sums in registers. Two
// forms:
// - bf16 at t = 8 with Cout a multiple of 32 (every serving shape of the
//   sparse U-Net): block_conv_wmma_kernel, the tap products as WMMA
//   m8n32k16 tensor-core products of x-lines of the halo (below).
// - otherwise (f32, t < 8, Cout = 16 mod 32): block_conv_kernel, f32 FMAs
//   on the CUDA cores, each of the 256 threads keeping the CO sums of two
//   voxels (v and v + 256); the halo is f32 and channel-major, so the
//   threads of a warp, which take neighbouring voxels, read neighbouring
//   words.
// bf16 products are exact in f32, so both forms give the f32 sums of the
// TPU's MXU, rounded once, at the store.
//
// What bounds it: operations. 2 * 27 * Cin * Cout flops a voxel of a real
// tile against ~200 bytes of features; at the sparse U-Net's level-1
// 128 -> 128 conv that is 1.8e4 flops a byte, far above the card's ratio.
// The WMMA form reads its A tiles from shared memory without a pipeline
// (staging and products alternate, two blocks an SM hide part of it); a
// wgmma form with TMA staging is the next step.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCI = 8;                       // input channels a pass
constexpr int kMaxT = 8;                     // largest tile edge
constexpr int kHaloMax = (kMaxT + 2) * (kMaxT + 2) * (kMaxT + 2);
constexpr int kVox = 2;                      // voxels a thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <int CO>
constexpr int smem_bytes() {
  return (kCI * kHaloMax + 27 * kCI * CO) * (int)sizeof(float);
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads) block_conv_kernel(
    const T* __restrict__ feats, const int* __restrict__ slots,
    const T* __restrict__ w2, T* __restrict__ out, int nt, int t, int cin,
    int cout) {
  extern __shared__ float smem[];
  float* halo = smem;                        // [kCI][(t+2)^3]
  float* ws = smem + kCI * kHaloMax;         // [27][kCI][CO]
  __shared__ int nb[27];

  const long long tile = blockIdx.x;         // b * NT + n
  const long long b = tile / nt;
  const int co0 = blockIdx.y * CO;
  const int t3 = t * t * t;
  const int tp = t + 2;
  const int hs = tp * tp * tp;
  if (threadIdx.x < 27) nb[threadIdx.x] = slots[tile * 27 + threadIdx.x];
  __syncthreads();

  T* o = out + tile * t3 * cout + co0;
  float acc[kVox][CO];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;

  if (nb[13] < 0) {                          // capacity padding: zeros
    for (int v = threadIdx.x; v < t3; v += kThreads)
      store_row<CO>(o + (long long)v * cout, acc[0]);
    return;
  }

  // each thread's voxels and their centre in the halo; a thread past t^3
  // (t < 8) computes on the centre of voxel 0 and stores nothing
  int hb[kVox];
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int v = threadIdx.x + j * kThreads;
    const int vv = v < t3 ? v : 0;
    const int z = vv / (t * t), y = (vv / t) % t, x = vv % t;
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
        const int hz = h / (tp * tp), hy = (h / tp) % tp, hx = h % tp;
        const int dz = hz == 0 ? -1 : (hz == tp - 1 ? 1 : 0);
        const int dy = hy == 0 ? -1 : (hy == tp - 1 ? 1 : 0);
        const int dx = hx == 0 ? -1 : (hx == tp - 1 ? 1 : 0);
        const int s = nb[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)];
        if (s >= 0) {
          const int sz = hz - 1 - dz * t, sy = hy - 1 - dy * t,
                    sx = hx - 1 - dx * t;
          val = to_float(fb[((long long)s * t3 + (sz * t + sy) * t + sx) * cin
                            + c0 + ci]);
        }
      }
      halo[ci * hs + h] = val;
    }
    for (int i = threadIdx.x; i < 27 * kCI * CO; i += kThreads) {
      const int k = i % CO, ci = (i / CO) % kCI, d = i / (CO * kCI);
      ws[i] = ci < cc ? to_float(w2[((long long)d * cin + c0 + ci) * cout
                                    + co0 + k])
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
    if (v < t3) store_row<CO>(o + (long long)v * cout, acc[j]);
  }
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

__global__ void __launch_bounds__(kThreads) block_conv_wmma_kernel(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ slots,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int nt, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = halo + kHalo * kKC;                // [27][kKC][kCOW]
  float* scratch = reinterpret_cast<float*>(ws + 27 * kKC * kCOW);
  __shared__ int nb[27];

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
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

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
      uint4 val = zero4;
      if (s >= 0 && part * 8 < cc) {
        const int src = ((hz - 1 - dz * kT) * kT + (hy - 1 - dy * kT)) * kT
                        + (hx - 1 - dx * kT);
        const __nv_bfloat16* row =
            fb + ((long long)s * t3 + src) * cin + c0 + part * 8;
        if (vec) {
          val = *reinterpret_cast<const uint4*>(row);
        } else {
          __align__(16) __nv_bfloat16 e[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            e[q] = part * 8 + q < cc ? row[q] : __float2bfloat16_rn(0.f);
          val = *reinterpret_cast<uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(halo + h * kKC + part * 8) = val;
    }
    // the weights of this pass: 8 outputs (16 bytes) a step
    for (int i = threadIdx.x; i < 27 * kKC * (kCOW / 8); i += kThreads) {
      const int q = i % (kCOW / 8), k = (i / (kCOW / 8)) % kKC,
                d = i / (kKC * (kCOW / 8));
      uint4 val = zero4;
      if (k < cc)
        val = *reinterpret_cast<const uint4*>(
            w2 + ((long long)d * cin + c0 + k) * cout + co0 + q * 8);
      *reinterpret_cast<uint4*>(ws + (d * kKC + k) * kCOW + q * 8) = val;
    }
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

int launch_wmma(const void* feats, const void* slots, const void* w2,
                void* out, int B, int NT, int cin, int cout,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_conv_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wmma_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * NT), (unsigned)(cout / kCOW));
  block_conv_wmma_kernel<<<grid, kThreads, wmma_smem_bytes(), stream>>>(
      (const __nv_bfloat16*)feats, (const int*)slots,
      (const __nv_bfloat16*)w2, (__nv_bfloat16*)out, NT, cin, cout);
  return (int)cudaGetLastError();
}

template <typename T, int CO>
int launch(const void* feats, const void* slots, const void* w2, void* out,
           int B, int NT, int t, int cin, int cout, cudaStream_t stream) {
  auto kern = block_conv_kernel<T, CO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<CO>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * NT), (unsigned)(cout / CO));
  kern<<<grid, kThreads, smem_bytes<CO>(), stream>>>(
      (const T*)feats, (const int*)slots, (const T*)w2, (T*)out, NT, t, cin,
      cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feats (B, NT, t^3, Cin) bf16 (is_bf16 = 1) or f32; slots (B, NT, 27)
// int32; w2 (27 * Cin, Cout) in the feature type; out (B, NT, t^3, Cout)
// in the feature type. 1 <= t <= 8, Cin >= 1, Cout a multiple of 16.
int pcseg_block_conv(const void* feats, const void* slots, const void* w2,
                     void* out, int B, int NT, int t, int Cin, int Cout,
                     int is_bf16, void* stream) {
  if (B <= 0 || NT <= 0 || t <= 0 || t > kMaxT || Cin <= 0 || Cout <= 0 ||
      Cout % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = Cout % 32 == 0;
  if (is_bf16 && wide && t == kT)
    return launch_wmma(feats, slots, w2, out, B, NT, Cin, Cout, s);
  if (is_bf16)
    return wide ? launch<__nv_bfloat16, 32>(feats, slots, w2, out, B, NT, t,
                                            Cin, Cout, s)
                : launch<__nv_bfloat16, 16>(feats, slots, w2, out, B, NT, t,
                                            Cin, Cout, s);
  return wide ? launch<float, 32>(feats, slots, w2, out, B, NT, t, Cin, Cout,
                                  s)
              : launch<float, 16>(feats, slots, w2, out, B, NT, t, Cin, Cout,
                                  s);
}

}  // extern "C"
