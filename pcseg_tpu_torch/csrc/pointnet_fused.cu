// PointNetSeg kernels for Hopper (sm_90a) beside the chain's: dropout,
// and the BN + ReLU + first-max pool that only tests reach. (The chain
// layers and the classifier + CE are pointnet_chain.cu's; the global layer
// with its pool is pointnet_wgmma.cu's.)
//
// Entries (plain C interface, loaded with ctypes; each returns
// cudaGetLastError() after its launches; pointers and the stream are
// passed as void*):
//
//   pcseg_dropout                  replaces dropout.py pallas_dropout
//       (:52, forward and backward): keep iff bits >= threshold.
//   pcseg_fused_pool_fwd / _bwd    replace fused_pool.py fused_global_pool
//       (_fwd_pallas, pallas_call at :107; _bwd_pallas at :146): per group
//       of rows and channel, the max of relu(((y - mu) * inv) * gamma +
//       beta) and the first row attaining it; the backward writes dy = val
//       at each winner row and zeros elsewhere.
//
// Both are bound by bytes on an H100. Dropout bits are a hash of (seed,
// element index) (ops/dropout.py), so the masks do not depend on tiling
// and a backward regenerates them; the kept values are scaled in the
// input's dtype. The pool reads y once forward and writes dy once
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
#include <stdint.h>

#include <type_traits>

#include "pool_keys.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

int cdiv_int(long long a, long long b) { return (int)((a + b - 1) / b); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
