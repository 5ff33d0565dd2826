// One-hot plane kernels of voxelize / devoxelize for Hopper (sm_90a).
//
//   pcseg_voxelize_contract  replaces pcseg_tpu/ops/pallas/onehot_contract.py
//                            voxelize_contract (_vox_contract_kernel,
//                            pallas_call at :191): the matmul voxelizer's
//                            sums[b, v, k] = sum_p [flat_p == v] bf16(ext[p, k]).
//   pcseg_trilinear_scatter  replaces trilinear_scatter (_tri_scatter_kernel,
//                            pallas_call at :245): the devoxelize backward's
//                            grid cotangent
//                            dgrid[b, zy, x, k] = sum_p A[p, zy] Wx[p, x] go[p, k].
//   pcseg_trilinear_gather   replaces trilinear_gather (_tri_gather_kernel,
//                            pallas_call at :376): the matmul devoxelize
//                            forward out[p, k] = mask_p sum_x Wx[p, x]
//                            sum_zy A[p, zy] g2[zy, x, k].
//   pcseg_rowcol_scatter     replaces rowcol_scatter (_rowcol_scatter_kernel,
//                            pallas_call at :309): the block-sparse
//                            readout's backward
//                            out[b, row_p, col_p * C + k] += bf16(vals[p, k]),
//                            a row >= nrows (the sentinel) adding nothing.
//   pcseg_segment_scatter    replaces pcseg_tpu/ops/pallas/voxel_scatter.py
//                            pallas_segment_scatter (pallas_call at :67):
//                            out[b, id_p, k] += feats[p, k] for ids in
//                            [0, nseg); the spill id nseg, and any other
//                            id outside the range, adds nothing.
//
// The TPU kernels build one-hot planes of a chunk of points in VMEM and
// contract the point axis on the MXU, because the MXU is the TPU's fast
// path and a scatter or a gather is not. On the card a point touches at
// most 8 voxels (1 for voxelize), so none of them is a product.
//
// voxelize (row 10) is bound by the table it writes (25.2 MB of f32 at B8
// x R64 with C1 3, against 1.3 MB of int64 ids and rows) and, where many
// points share a voxel (2,000 consecutive points of one event at the
// default call site), by that voxel's atomics. It is one cooperative
// launch of a resident grid. A warp takes 32 consecutive points; it loads
// its first chunk, groups the lanes of one (event, voxel) and sums their
// bf16-rounded rows in lane order before the fill, while the memory
// system is still idle; the grid writes the table's zeros with 16-byte
// stores; one grid barrier; then each group's lowest lane adds its sums
// with vector reductions (a hot voxel's 2,000 adds a channel become ~64).
// The caller allocates the table uninitialized and passes int32 or int64
// ids as they are. Sums that several warps add land in atomic order, so
// two calls may differ in their last bits.
// rowcol_scatter adds a point's C values into its (row, col) cell, the
// points of a warp that share a cell summed first in lane order
// (consecutive track points share cells: about 30 a cell at R64), one
// vector reduction for 4 channels by the group's leader, bound by its
// point rows and the f32 table (8.4 MB at B8 x NT64 x 512 x 4).
//
// trilinear_scatter (row 11, _tri_scatter_kernel) is bound by the grid it
// writes: at B8 x R64 x C4 33.5 MB of f32 (16.8 MB of bf16, the step's
// form) against 1.8 MB of point rows. A thread a point adding 8 x C float
// atomics into a grid the caller zeroed moves the grid three times (the
// zero fill, the atomics, the caller's bf16 cast) and gives other bits on
// every call. Here each grid tile is written once, by its owner, with no
// global atomics, in three kernels:
//   - binning (trilinear_scatter_bin_kernel): a block of kBinThreads
//     points sorts its points, stably, by the bin of their base row q =
//     z0 * R + y0 (bins of h zy rows, at most kMaxBins an event): warp
//     counts by __match_any_sync, one scan over (bin, warp), then entries
//     {u, point, bf16 cotangents} in (bin, point) order and each bin's
//     start. Points whose cotangent row is zero (masked points) are
//     dropped.
//   - tiles (trilinear_scatter_tile_kernel): a tile is `band` zy rows (at
//     most kTileBytes of f32) and a warp owns one. A point's taps land on
//     rows q, q + 1, q + R, q + R + 1, so the tile of rows [r0, r1) reads
//     the bins of q in [r0 - R - 1, r1 - 1 - R] and [r0 - 1, r1 - 1] of
//     every binning block: its list, 32 entries a chunk, a lane an entry,
//     summed in shared memory. Each tap's owners write their lane to the
//     cell's one-byte tag and read it back: a tap with no cell twice adds
//     with plain shared-memory adds. Where a cell repeats (tracks put many
//     points in a voxel) the chunk's lanes are sorted by base cell
//     (bitonic, stable), each run of one cell is summed by a segmented
//     scan and its last lane adds the sum; runs of one cell apart
//     (clipped taps) go through __match_any_sync groups first. The tile
//     is then written once, coalesced, zeros included, in f32 or bf16
//     (each f32 sum rounded once), so the caller allocates the grid
//     uninitialized and casts nothing.
//   - long tiles (trilinear_scatter_long_kernel): a tile whose list is
//     longer than kLongChunks chunks (track events put 100-2,300 points
//     in a bin) is left by its warp on a list that persistent blocks of
//     kLongWarps warps take one tile at a time: chunk k goes to warp k %
//     wl, each warp sums into its own copy of the tile, and the copies
//     are added in warp order.
//   Every order of every sum is fixed by the data, so two calls give the
//   same bits. What bounds it is latency, not bytes: each tile waits on
//   two dependent loads (its bins' starts, then its entries), so the
//   tiles run at 2-3x the time of the write alone (PERF.md section 7).
//   Above kChunkC channels the binning runs once and the tile and
//   long-tile kernels run per column chunk of kChunkC channels (grid y;
//   a last, narrower chunk in a launch of its own), so a tile's shared
//   row stays one chunk wide; each channel's sums keep their order, so
//   the bits at C <= kChunkC are those of one chunk.
//
// trilinear_gather (row 13, _tri_gather_kernel) reads a point's <= 8
// bf16 rows of C values and writes C f32s: 0.6 us of bytes at B8 x M8192
// x C4, so it is bound by the instructions and latency of a thread a
// point. Each width the models use is its own instantiation (C 1-8, 16,
// 32; other widths take the next one with masked lanes), so the loops
// are unrolled at their real width; a thread issues its 8 tap loads (8
// bytes a tap at C4) before any sum and writes its C outputs with one
// vector store. Above kChunkC channels a thread takes one column chunk
// of its point (grid y), the rows read at the grid's row stride.
//
// The segment scatter keeps its whole grid in VMEM on the TPU and adds
// the points one after another; here a thread takes one (point, channel)
// value, so the point rows are read coalesced and the float atomics of
// neighbouring channels land on one cache line. It is bound by the f32
// grid it writes (33.6 MB at B8 x R64^3 x C4, zero-filled by the caller)
// and, where many points share a segment, by that segment's atomics.
//
// Rounding points (onehot_contract.py _axis_taps, _zy_plane,
// _xline_weights and the three kernels): per axis the two taps floor(u)
// and floor(u) + 1 are clipped to [0, R-1], with weights 1 - frac and frac;
// the zy weight is wz * wy in f32, duplicate clipped taps summed in f32 in
// the kernels' loop order (z outer), rounded to bf16 once. The x weights'
// duplicates are summed in f32; the scatter rounds them to bf16 and its
// operand is bf16(wx * go) of bf16 values, the gather keeps them f32 and
// takes, for each x tap, the zy sum of A * bf16(g2) first, then multiplies
// by the x weight and sums over x, all in f32. voxelize rounds each ext
// value to bf16 and sums in f32 (counts, a column of ones, are exact).
// Points whose cotangent row is zero (masked points) add nothing to the
// scatter and are skipped; voxelize skips the sentinel id R^3 of masked
// points; the gather writes 0 for masked points.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkC = 32;   // channels a column chunk (rows 11 and 13)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void axis_taps(float u, int r, int idx[2],
                                          float w[2]) {
  const float f = floorf(u);
  const float frac = __fsub_rn(u, f);
  const int i0 = (int)f;
  idx[0] = min(max(i0, 0), r - 1);
  idx[1] = min(max(i0 + 1, 0), r - 1);
  w[0] = __fsub_rn(1.f, frac);
  w[1] = frac;
}

// The four zy taps of a point in the TPU kernels' loop order (z outer):
// zi their flat z * R + y ids; first[t] marks the first copy of each
// distinct id, whose a[t] is the bf16-rounded f32 sum of the weights
// wz * wy of all its copies (later copies: first false, a 0).
__device__ __forceinline__ void zy_taps(float uz, float uy, int r, int zi[4],
                                        float a[4], bool first[4]) {
  int iz[2], iy[2];
  float wz[2], wy[2], zw[4];
  axis_taps(uz, r, iz, wz);
  axis_taps(uy, r, iy, wy);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      zi[2 * i + e] = iz[i] * r + iy[e];
      zw[2 * i + e] = __fmul_rn(wz[i], wy[e]);
    }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    first[t] = true;
    for (int s = 0; s < t; ++s) first[t] &= zi[s] != zi[t];
    float sum = 0.f;
    for (int s = 0; s < 4; ++s)
      if (zi[s] == zi[t]) sum = __fadd_rn(sum, zw[s]);
    a[t] = first[t] ? round_bf16(sum) : 0.f;
  }
}

// The x taps of a point: a duplicate (clipped edge) folds its weight into
// the first, summed in f32. Returns the number of distinct taps (1 or 2).
__device__ __forceinline__ int x_taps(float ux, int r, int ix[2],
                                      float xw[2]) {
  axis_taps(ux, r, ix, xw);
  if (ix[0] != ix[1]) return 2;
  xw[0] = __fadd_rn(xw[0], xw[1]);
  xw[1] = 0.f;
  return 1;
}

// ---------------------------------------------------------------------------
// rows of C values: bf16 / f32 loads and f32 stores at a compile-time width
// CW; EXACT: the row is CW wide and loaded by the widest vector its bytes
// allow (the wrappers hand over 16-byte aligned bases), else c < CW values
// one by one with the lanes past c zero
// ---------------------------------------------------------------------------

constexpr unsigned kAll = 0xffffffffu;

template <int Bytes>
struct Vec;
template <>
struct Vec<16> { using T = uint4; };
template <>
struct Vec<8> { using T = uint2; };
template <>
struct Vec<4> { using T = unsigned; };
template <>
struct Vec<2> { using T = unsigned short; };

__host__ __device__ constexpr int granule(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

// CW bf16 values at p as f32
template <int CW, bool EXACT>
__device__ __forceinline__ void load_bf16_row(const __nv_bfloat16* p, int c,
                                              float (&v)[CW]) {
  if constexpr (EXACT) {
    constexpr int kG = granule(2 * CW);
    using T = typename Vec<kG>::T;
    constexpr int kWords = kG / 2 >= 2 ? kG / 4 : 1;  // 32-bit words a load
    const T* q = reinterpret_cast<const T*>(p);
#pragma unroll
    for (int i = 0; i < 2 * CW / kG; ++i) {
      const T x = q[i];
      if constexpr (kG == 2) {
        v[i] = __uint_as_float((unsigned)x << 16);
      } else {
        const unsigned* w = reinterpret_cast<const unsigned*>(&x);
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          v[i * kG / 2 + 2 * j] = __uint_as_float(w[j] << 16);
          v[i * kG / 2 + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k)
      v[k] = k < c ? __bfloat162float(p[k]) : 0.f;
  }
}

// CW f32 values at p
template <int CW, bool EXACT>
__device__ __forceinline__ void load_f32_row(const float* p, int c,
                                             float (&v)[CW]) {
  if constexpr (EXACT) {
    constexpr int kG = granule(4 * CW) < 4 ? 4 : granule(4 * CW);
    using T = typename Vec<kG>::T;
    const T* q = reinterpret_cast<const T*>(p);
#pragma unroll
    for (int i = 0; i < 4 * CW / kG; ++i) {
      const T x = q[i];
      const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
      for (int j = 0; j < kG / 4; ++j) v[i * kG / 4 + j] = f[j];
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k) v[k] = k < c ? p[k] : 0.f;
  }
}

template <int CW, bool EXACT>
__device__ __forceinline__ void store_f32_row(float* p, int c,
                                              const float (&v)[CW]) {
  if constexpr (EXACT) {
    constexpr int kG = granule(4 * CW) < 4 ? 4 : granule(4 * CW);
    using T = typename Vec<kG>::T;
    T* q = reinterpret_cast<T*>(p);
#pragma unroll
    for (int i = 0; i < 4 * CW / kG; ++i) {
      T x;
      float* f = reinterpret_cast<float*>(&x);
#pragma unroll
      for (int j = 0; j < kG / 4; ++j) f[j] = v[i * kG / 4 + j];
      q[i] = x;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k)
      if (k < c) p[k] = v[k];
  }
}

// ---------------------------------------------------------------------------
// row 11: the trilinear scatter, each grid tile written once by its owner
// ---------------------------------------------------------------------------

// The plan's constants. A tile is `band` zy rows of at most kTileBytes of
// f32 (one row at least). A tile block has up to kWarps warps, each
// owning a tile; a tile whose list is longer than kLongChunks chunks of
// 32 entries goes to a block of up to kLongWarps warps that take its
// chunks in turn, each into its own copy of the tile. A binning block
// takes kBinThreads points and sorts them into at
// most kMaxBins bins of h zy rows an event
// (tests/test_torch_devox_layout.py reads these and emulates the plan).
struct ScatterCfg {
  static constexpr int kWarps = 8;
  static constexpr int kLongWarps = 16;
  static constexpr int kTileBytes = 4096;
  static constexpr int kLongChunks = 2;
  static constexpr int kBinThreads = 512;
  static constexpr int kMaxBins = 2048;
  static constexpr int kSmemMax = 231424;  // of 232,448, less static
  static constexpr int kBinWarps = kBinThreads / 32;
  static constexpr int kBinSmem =
      kBinWarps * kMaxBins * 2 + kMaxBins * 4 + (kBinWarps + 1) * 4;
};
static_assert(ScatterCfg::kMaxBins == 4 * ScatterCfg::kBinThreads,
              "a binning thread scans four bins");

struct ScatterPlan {
  int rows;    // R^2 zy rows of an event
  int full;    // column chunks of kChunkC channels: C / kChunkC
  int tail;    // channels of the last, narrower chunk: C % kChunkC
  int band;    // zy rows a tile
  int w;       // warps a tile block
  int bands;   // tiles an event
  int h;       // zy rows a bin
  int bins;    // bins an event
  int chunks;  // binning blocks an event
  int ent;     // 16-byte units an entry: {u, point}, then C bf16 of go
  int smem;    // dynamic shared bytes of a tile block: w tiles of one
               // column chunk and w x 8 one-byte tags a cell of a tile
  int wl;      // warps a long-tile block
  int smem_l;  // its shared bytes: wl copies of a tile and their tags
};

// false where no plan fits: B past 65,535, more than 65,535 column
// chunks, or one zy row of a column chunk in f32 past the shared memory
// of a block
bool scatter_plan(int B, int M, int R, int C, ScatterPlan* p) {
  if (B <= 0 || B > 65535 || M <= 0 || R <= 0 || C <= 0 ||
      C / kChunkC > 65535)
    return false;
  const long long rows = (long long)R * R;
  const int cw = C < kChunkC ? C : kChunkC;
  const long long row_bytes = (long long)R * cw * 4;
  if (rows > (1LL << 30)) return false;
  long long band = ScatterCfg::kTileBytes / row_bytes;
  band = band < 1 ? 1 : band > rows ? rows : band;
  int w = ScatterCfg::kWarps;
  auto smem = [&](int nw) { return nw * band * (row_bytes + R * 8LL); };
  while (w > 1 && smem(w) > ScatterCfg::kSmemMax) w /= 2;
  if (smem(w) > ScatterCfg::kSmemMax) return false;
  p->rows = (int)rows;
  p->full = C / kChunkC;
  p->tail = C % kChunkC;
  p->band = (int)band;
  p->w = w;
  p->bands = (int)((rows + band - 1) / band);
  if ((long long)B * p->bands > 0x7fffffffLL) return false;
  p->h = (int)((rows + ScatterCfg::kMaxBins - 1) / ScatterCfg::kMaxBins);
  p->bins = (int)((rows + p->h - 1) / p->h);
  p->chunks = (M + ScatterCfg::kBinThreads - 1) / ScatterCfg::kBinThreads;
  p->ent = 1 + (C + 7) / 8;
  p->smem = (int)smem(w);
  int wl = ScatterCfg::kLongWarps;
  while (wl > 1 && smem(wl) > ScatterCfg::kSmemMax) wl /= 2;
  p->wl = wl;
  p->smem_l = (int)smem(wl);
  return true;
}

// the scratch of a call in 16-byte units: B M entries, then the offsets,
// then the long tiles' count, the cursors of the full chunks' and the
// last chunk's long-tile kernels, and the long tiles' list
long long scatter_scratch(int B, int M, const ScatterPlan& p) {
  const long long ints =
      (long long)B * p.chunks * (p.bins + 1) + 3 + (long long)B * p.bands;
  return (long long)B * M * p.ent + (ints + 3) / 4;
}

// the point's base zy row: clipped floor(uz) * R + clipped floor(uy),
// zy_taps' zi[0]; its taps land on rows q, q + 1, q + R, q + R + 1 only
__device__ __forceinline__ int base_row(float uz, float uy, int r) {
  const int iz = min(max((int)floorf(uz), 0), r - 1);
  const int iy = min(max((int)floorf(uy), 0), r - 1);
  return iz * r + iy;
}

// A binning block's stable counting sort (row 11): kBinThreads
// threads, a key each (its bin, < bins <= kMaxBins; -1: none). Warp
// counts by __match_any_sync, one scan over (bin, warp); off[0..bins]
// gets the start of each bin among the block's keyed threads and their
// count. Returns the thread's place in (bin, thread) order (-1: none).
__device__ int bin_place(int key, int bins, int* __restrict__ off,
                         unsigned char* smem) {
  constexpr int kW = ScatterCfg::kBinWarps;
  constexpr int kBins = ScatterCfg::kMaxBins;
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem);
  int* start = reinterpret_cast<int*>(smem + kW * kBins * 2);
  int* wsum = start + kBins;  // kW warp sums, then the block's count
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  uint4* z = reinterpret_cast<uint4*>(cnt);
  for (int i = tid; i < kW * kBins * 2 / 16; i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const unsigned grp = __match_any_sync(kAll, key);
  const int rank = __popc(grp & ((1u << lane) - 1u));
  if (key >= 0 && rank == 0)
    cnt[warp * kBins + key] = (unsigned short)__popc(grp);
  __syncthreads();

  // bins 4 tid .. 4 tid + 3: the prefix over the warps in place, then the
  // block's exclusive scan of the bins' totals
  unsigned long long* c64 = reinterpret_cast<unsigned long long*>(cnt);
  int run[4] = {0, 0, 0, 0};
  for (int w = 0; w < kW; ++w) {
    const unsigned long long v = c64[w * (kBins / 4) + tid];
    unsigned long long pre = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pre |= (unsigned long long)run[s] << (16 * s);
      run[s] += (int)((v >> (16 * s)) & 0xffffu);
    }
    c64[w * (kBins / 4) + tid] = pre;
  }
  const int mine = run[0] + run[1] + run[2] + run[3];
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kW ? wsum[lane] : 0;
    int s = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kW) wsum[lane] = s - v;
    if (lane == kW - 1) wsum[kW] = s;
  }
  __syncthreads();
  int at = wsum[warp] + incl - mine;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    start[4 * tid + s] = at;
    at += run[s];
  }
  __syncthreads();
  for (int k = tid; k <= bins; k += blockDim.x)
    off[k] = k < kBins ? start[k] : wsum[kW];
  return key >= 0 ? start[key] + cnt[warp * kBins + key] + rank : -1;
}

// Block (chunk j, event b): the event's points j * kBinThreads + [0,
// kBinThreads), a thread each. Entry i of the chunk (ent 16-byte units at
// entries + (b M + j kBinThreads + i) ent) is its i-th binned point in
// (bin, point) order: {u0, u1, u2, point index in the event}, then its C
// cotangents rounded to bf16, 8 a unit; offs[(b chunks + j)(bins + 1) +
// k]: the start of bin k in the chunk, offs[... + bins] the chunk's count.
// Block (0, 0) also clears the long-tile count and cursors (longs).
__global__ void __launch_bounds__(ScatterCfg::kBinThreads)
    trilinear_scatter_bin_kernel(const float* __restrict__ u,
                                 const float* __restrict__ go,
                                 uint4* __restrict__ entries,
                                 int* __restrict__ offs,
                                 int* __restrict__ longs, int m, int r, int c,
                                 int h, int bins, int chunks, int ent) {
  extern __shared__ __align__(16) unsigned char bin_smem[];
  const int b = blockIdx.y, j = blockIdx.x, tid = threadIdx.x;
  const int mi = j * ScatterCfg::kBinThreads + tid;
  const long long pt = (long long)b * m + mi;
  const float* g = go + pt * c;
  int key = -1;
  float u0 = 0.f, u1 = 0.f, u2 = 0.f;
  if (mi < m) {
    bool any = false;
    for (int k = 0; k < c; ++k) any |= g[k] != 0.f;
    if (any) {
      u0 = u[pt * 3 + 0];
      u1 = u[pt * 3 + 1];
      u2 = u[pt * 3 + 2];
      key = base_row(u0, u1, r) / h;
    }
  }
  const int pos = bin_place(
      key, bins, offs + ((long long)b * chunks + j) * (bins + 1), bin_smem);
  if (b == 0 && j == 0 && tid < 3) longs[tid] = 0;
  if (key >= 0) {
    uint4* e = entries +
               ((long long)b * m + (long long)j * ScatterCfg::kBinThreads +
                pos) * ent;
    e[0] = make_uint4(__float_as_uint(u0), __float_as_uint(u1),
                      __float_as_uint(u2), (unsigned)mi);
    for (int i = 1; i < ent; ++i) {
      unsigned w4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 8 * (i - 1) + 2 * q;
        const __nv_bfloat162 two = __floats2bfloat162_rn(
            k < c ? g[k] : 0.f, k + 1 < c ? g[k + 1] : 0.f);
        w4[q] = *reinterpret_cast<const unsigned*>(&two);
      }
      e[i] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  }
}

struct ScatterArgs {
  const uint4* entries;
  const int* offs;
  int* longs;  // the long tiles: count, two cursors, then their indices
  void* out;
  int m, r, c, rows, band, w, h, bins, chunks, ent, tiles;
  int bf16;  // out is bf16 (each f32 sum rounded once), else f32
  int cs;    // C, the output's row stride (c: the launch's chunk width)
  int k0;    // the launch's first channel (chunk y: k0 + kChunkC y)
  int nk;    // the launch's column chunks
};

// the bins a tile of rows [r0, r1) reads: q in [r0 - R - 1, r1 - 1 - R]
// and [r0 - 1, r1 - 1], as one or two bin ranges (merged where they meet,
// so no entry is read twice)
struct BinRanges {
  int n, lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ BinRanges bin_ranges(const ScatterArgs& a, int r0,
                                                int r1) {
  BinRanges br;
  const int blo = max(r0 - 1, 0) / a.h, bhi = (r1 - 1) / a.h;
  const int top = r1 - 1 - a.r;
  br.n = 1;
  br.lo0 = br.lo1 = blo;
  br.hi0 = br.hi1 = bhi;
  if (top >= 0) {
    const int alo = max(r0 - a.r - 1, 0) / a.h, ahi = top / a.h;
    br.lo0 = alo;
    if (ahi < blo - 1) {
      br.n = 2;
      br.hi0 = ahi;
    }
  }
  return br;
}

// segment s of a tile's list (range s / chunks, binning block s %
// chunks): its first entry and its length
__device__ __forceinline__ void segment(const ScatterArgs& a, int b,
                                        const BinRanges& br, int s,
                                        long long& beg, int& len) {
  beg = 0;
  len = 0;
  if (s >= br.n * a.chunks) return;
  const int ri = s >= a.chunks, j = s - ri * a.chunks;
  const int* off = a.offs + ((long long)b * a.chunks + j) * (a.bins + 1);
  const int s0 = off[ri ? br.lo1 : br.lo0];
  const int s1 = off[(ri ? br.hi1 : br.hi0) + 1];
  beg = (long long)b * a.m + (long long)j * ScatterCfg::kBinThreads + s0;
  len = s1 - s0;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// the lane of the k-th (from 0) set bit of g
__device__ __forceinline__ int nth_bit(unsigned g, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int n = __popc(g & ((1u << w) - 1u));
    if (k >= n) {
      k -= n;
      g >>= w;
      pos += w;
    }
  }
  return pos;
}

// The owners (own) of one tap whose cells repeat apart from each other:
// the owners of each cell (a __match_any_sync group) summed into the
// lowest of them in a tree fixed by their lanes; only the lowest keeps
// own.
template <int CW>
__device__ __forceinline__ bool group_sum(bool own, int cell,
                                          float (&v)[CW]) {
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(kAll, own ? cell : -1 - lane);
  const int n = own ? __popc(grp) : 1;
  const int rank = __popc(grp & ((1u << lane) - 1u));
  const int most = (int)__reduce_max_sync(kAll, (unsigned)n);
  for (int d = 1; d < most; d <<= 1) {
    const bool take = (rank & (2 * d - 1)) == 0 && rank + d < n;
    const int src = take ? nth_bit(grp, rank + d) : lane;
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const float y = __shfl_sync(kAll, v[k], src);
      if (take) v[k] = __fadd_rn(v[k], y);
    }
  }
  return own && rank == 0;
}

// An entry as loaded: {u, point}, then the cotangents' bf16 units.
template <int CW>
struct Entry {
  uint4 head;
  uint4 body[(CW + 7) / 8];
};

// (the cotangents of channels kc.. of the entry: kc a multiple of 8)
template <int CW>
__device__ __forceinline__ Entry<CW> load_entry(const ScatterArgs& a,
                                                bool valid, long long e,
                                                int kc) {
  Entry<CW> x;
  const uint4* ep = a.entries + (valid ? e : 0) * a.ent;
  x.head = ep[0];
  const int u0 = 1 + kc / 8;
#pragma unroll
  for (int i = 0; i < (CW + 7) / 8; ++i)
    x.body[i] = u0 + i < a.ent ? ep[u0 + i] : make_uint4(0u, 0u, 0u, 0u);
  return x;
}

// The source lane of each lane's place when the warp's keys are sorted
// ascending, ties by lane (a bitonic network over the 32 lanes).
__device__ __forceinline__ int sort_src(unsigned key) {
  const int lane = threadIdx.x & 31;
  int src = lane;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const unsigned pk = __shfl_xor_sync(kAll, key, j);
      const int ps = __shfl_xor_sync(kAll, src, j);
      const bool less = pk < key || (pk == key && ps < src);
      if (((lane & size) == 0) == ((lane & j) == 0) ? less : !less) {
        key = pk;
        src = ps;
      }
    }
  return src;
}

// An entry's 8 taps (t, x) in the tile's rows [r0, r1): which exist
// (own), their cells (row - r0) R + x, and their values
// aw[t] bf16(xw[x] bf16(go)).
template <int CW>
struct Taps {
  bool own[8];
  int cell[8];
  float aw[4], xw[2], gb[CW];
  __device__ __forceinline__ Taps(const ScatterArgs& a, bool valid,
                                  const Entry<CW>& en, int r0, int r1) {
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const unsigned w2 = (&en.body[k / 8].x)[(k % 8) / 2];
      gb[k] = __uint_as_float(k % 2 ? w2 & 0xffff0000u : w2 << 16);
    }
    int zi[4], ix[2];
    bool first[4];
    zy_taps(__uint_as_float(en.head.x), __uint_as_float(en.head.y), a.r, zi,
            aw, first);
    const int nx = x_taps(__uint_as_float(en.head.z), a.r, ix, xw);
    xw[0] = round_bf16(xw[0]);
    xw[1] = round_bf16(xw[1]);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int t = s / 2, x = s % 2;
      own[s] = valid && first[t] && zi[t] >= r0 && zi[t] < r1 && x < nx;
      cell[s] = (zi[t] - r0) * a.r + ix[x];
    }
  }
  __device__ __forceinline__ void value(int s, float (&v)[CW]) const {
#pragma unroll
    for (int k = 0; k < CW; ++k)
      v[k] = own[s] ? __fmul_rn(aw[s / 2], round_bf16(__fmul_rn(xw[s % 2],
                                                                gb[k])))
                    : 0.f;
  }
};

template <int CW, bool EXACT>
__device__ __forceinline__ void add_cell(float* o, const float (&v)[CW],
                                         int c) {
  if constexpr (EXACT && CW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < CW; k += 4) {
      float4 y = *reinterpret_cast<float4*>(o + k);
      y.x = __fadd_rn(y.x, v[k]);
      y.y = __fadd_rn(y.y, v[k + 1]);
      y.z = __fadd_rn(y.z, v[k + 2]);
      y.w = __fadd_rn(y.w, v[k + 3]);
      *reinterpret_cast<float4*>(o + k) = y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k)
      if (k < c) o[k] = __fadd_rn(o[k], v[k]);
  }
}

// The lanes that hold tap s of one cell (owners, sorted by cell so that
// they are neighbours) summed into the last of each run, in a segmented
// scan fixed by their lanes; returns whether this lane holds a run's sum.
template <int CW>
__device__ __forceinline__ bool run_sum(bool own, int cell, float (&v)[CW]) {
  const int lane = threadIdx.x & 31;
  const int pc = __shfl_up_sync(kAll, cell, 1);
  const bool po = __shfl_up_sync(kAll, own, 1);
  const int nc = __shfl_down_sync(kAll, cell, 1);
  const bool no = __shfl_down_sync(kAll, own, 1);
  const bool head = !(lane > 0 && po && pc == cell);
  int hp = head ? lane : 0;  // the run's first lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, hp, d);
    if (lane >= d) hp = max(hp, y);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const float y = __shfl_up_sync(kAll, v[k], d);
      if (lane - d >= hp) v[k] = __fadd_rn(y, v[k]);
    }
  return own && !(lane < 31 && no && nc == cell);
}

// One 32-entry chunk of a list, a lane's entry each (valid: the lane has
// one): the 8 taps (t, x) of each that land in the tile's rows [r0, r1)
// are added to dst (row r0 at dst), tap by tap. Each owner first writes
// its lane to its cell's tag of that tap (tags: 8 x (r1 - r0) R bytes); a
// tap whose owners all read back their own lane has no cell twice and
// each owner adds its value with a plain shared-memory add. Where some
// tap has a cell twice, the lanes are first sorted by their entry's base
// cell (stably, so points keep their order), which puts the owners of one
// cell of a tap side by side: each run is summed by run_sum and its last
// lane adds the sum; runs of one cell apart from each other (clipped taps
// at the grid's faces) are summed by group_sum first.
template <int CW, bool EXACT>
__device__ __forceinline__ void scatter_chunk(const ScatterArgs& a,
                                              bool valid, Entry<CW> en,
                                              int r0, int r1, float* dst,
                                              uint8_t* tags) {
  const int lane = threadIdx.x & 31;
  const int ncell = (r1 - r0) * a.r;
  Taps<CW> tp(a, valid, en, r0, r1);
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (tp.own[s]) tags[s * ncell + tp.cell[s]] = (uint8_t)lane;
  __syncwarp();
  unsigned dup = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (tp.own[s] && tags[s * ncell + tp.cell[s]] != lane) dup |= 1u << s;
  dup = __reduce_or_sync(kAll, dup);
  __syncwarp();
  const unsigned key = valid ? (unsigned)(tp.cell[0] + r0 * a.r) : ~0u;
  if (dup && !__all_sync(kAll, key == __shfl_sync(kAll, key, 0))) {
    const int src = sort_src(key);
    valid = __shfl_sync(kAll, valid, src);
    en.head.x = __shfl_sync(kAll, en.head.x, src);
    en.head.y = __shfl_sync(kAll, en.head.y, src);
    en.head.z = __shfl_sync(kAll, en.head.z, src);
#pragma unroll
    for (int i = 0; i < (CW + 7) / 8; ++i) {
      en.body[i].x = __shfl_sync(kAll, en.body[i].x, src);
      en.body[i].y = __shfl_sync(kAll, en.body[i].y, src);
      en.body[i].z = __shfl_sync(kAll, en.body[i].z, src);
      en.body[i].w = __shfl_sync(kAll, en.body[i].w, src);
    }
    tp = Taps<CW>(a, valid, en, r0, r1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (!__any_sync(kAll, tp.own[s])) continue;
    float v[CW];
    tp.value(s, v);
    bool add = tp.own[s];
    if ((dup >> s) & 1u) {
      add = run_sum<CW>(add, tp.cell[s], v);
      uint8_t* tg = tags + s * ncell;
      if (add) tg[tp.cell[s]] = (uint8_t)lane;
      __syncwarp();
      if (__any_sync(kAll, add && tg[tp.cell[s]] != lane))
        add = group_sum<CW>(add, tp.cell[s], v);
    }
    if (add) add_cell<CW, EXACT>(dst + tp.cell[s] * a.c, v, a.c);
    __syncwarp();
  }
}

// The list of the tile of rows [r0, r1), into dst (row r0 at dst; tags
// the warp's tags) for the channels kc..: the chunks numbered k over the
// whole list with k % stride == first, in order, each chunk's entries
// loaded while the one before is summed. Segments go 32 at a time, lane i
// holding segment s0 + i; (beg0, len0) is this lane's segment of the
// first 32.
template <int CW, bool EXACT>
__device__ void scatter_walk(const ScatterArgs& a, int b, int r0, int r1,
                             float* dst, uint8_t* tags, int first,
                             int stride, long long beg0, int len0, int kc) {
  const int lane = threadIdx.x & 31;
  const BinRanges br = bin_ranges(a, r0, r1);
  const int nseg = br.n * a.chunks;
  int k0 = 0;  // chunks of the groups before this one
  for (int s0 = 0; s0 < nseg; s0 += 32) {
    long long beg = beg0;
    int len = len0;
    if (s0) segment(a, b, br, s0 + lane, beg, len);
    const int incl = warp_incl_scan(len);
    const int excl = incl - len;
    const int total = __shfl_sync(kAll, incl, 31);
    const int nk = (total + 31) / 32;
    int k = ((first - k0) % stride + stride) % stride;
    k0 += nk;
    // entry of chunk kk's lane (the first lane whose segments reach past
    // the lane's list position holds its segment)
    auto locate = [&](int kk, bool& valid) {
      const int p = kk * 32 + lane;
      int seg = 0;
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(kAll, incl, seg + step - 1) <= p) seg += step;
      const long long sb = __shfl_sync(kAll, beg, seg);
      const int se = __shfl_sync(kAll, excl, seg);
      valid = p < total;
      return sb + (p - se);
    };
    if (k >= nk) continue;
    bool valid;
    const long long e = locate(k, valid);
    Entry<CW> cur = load_entry<CW>(a, valid, e, kc);
    for (; k < nk; k += stride) {
      bool nvalid = false;
      Entry<CW> nxt = cur;
      if (k + stride < nk) {
        const long long ne = locate(k + stride, nvalid);
        nxt = load_entry<CW>(a, nvalid, ne, kc);
      }
      scatter_chunk<CW, EXACT>(a, valid, cur, r0, r1, dst, tags);
      cur = nxt;
      valid = nvalid;
    }
  }
}

// The length of the list of the tile of rows [r0, r1), and this lane's
// segment of its first 32 (scatter_walk's beg0, len0).
__device__ __forceinline__ int scatter_list_len(const ScatterArgs& a, int b,
                                                int r0, int r1,
                                                long long& beg0, int& len0) {
  const int lane = threadIdx.x & 31;
  const BinRanges br = bin_ranges(a, r0, r1);
  const int nseg = br.n * a.chunks;
  segment(a, b, br, lane, beg0, len0);
  int n = __shfl_sync(kAll, warp_incl_scan(len0), 31);
  for (int s0 = 32; s0 < nseg; s0 += 32) {
    long long beg;
    int len;
    segment(a, b, br, s0 + lane, beg, len);
    n += __shfl_sync(kAll, warp_incl_scan(len), 31);
  }
  return n;
}

// Tile `tile` (event tile / bands, rows row0 + [0, nrows)) of channels
// kc..kc + c written once from the w0 copies at src (stride floats apart;
// threads i0 + k step), added in copy order, in f32 or bf16: one span
// where the tile holds whole output rows (c == C), else a run of c
// values an output row.
__device__ __forceinline__ void write_tile(const ScatterArgs& a, int tile,
                                           int kc, const float* src,
                                           int copies, int stride, int i0,
                                           int step) {
  const int bands = (a.rows + a.band - 1) / a.band;
  const int b = tile / bands, row0 = (tile - b * bands) * a.band;
  const int cells = min(a.band, a.rows - row0) * a.r;
  const long long cell0 = ((long long)b * a.rows + row0) * a.r;
  const int len = cells * a.c;
  // float4s where the copies and the output rows fall in whole float4s
  const bool span = a.c == a.cs;
  const bool vec = (stride & 3) == 0 &&
                   (span ? ((cell0 * a.c) & 3) == 0 && (len & 3) == 0
                         : (a.c & 3) == 0 && (a.cs & 3) == 0);
  auto sum4 = [&](int i) {
    float4 s = reinterpret_cast<const float4*>(src)[i];
    for (int v = 1; v < copies; ++v) {
      const float4 y = reinterpret_cast<const float4*>(src + v * stride)[i];
      s.x = __fadd_rn(s.x, y.x);
      s.y = __fadd_rn(s.y, y.y);
      s.z = __fadd_rn(s.z, y.z);
      s.w = __fadd_rn(s.w, y.w);
    }
    return s;
  };
  if (vec) {
    const int q = a.c / 4;  // float4s a cell
    for (int i = i0; i < len / 4; i += step) {
      const float4 s = sum4(i);
      const long long o = span ? cell0 * a.c + 4LL * i
                               : (cell0 + i / q) * a.cs + kc + 4 * (i % q);
      if (a.bf16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
        uint2 y;
        y.x = *reinterpret_cast<const unsigned*>(&lo);
        y.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) =
            y;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = s;
      }
    }
  } else {
    for (int i = i0; i < len; i += step) {
      float s = src[i];
      for (int v = 1; v < copies; ++v) s = __fadd_rn(s, src[v * stride + i]);
      const long long o = span ? cell0 * a.c + i
                               : (cell0 + i / a.c) * a.cs + kc + i % a.c;
      if (a.bf16)
        static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(s);
      else
        static_cast<float*>(a.out)[o] = s;
    }
  }
}

// Warp w of block (X, y) owns tile X w' + w (w' warps a block) in column
// chunk y of the launch: its list is summed into the warp's tile in
// shared memory and the tile written once, zeros included. A tile whose
// list is longer than kLongChunks chunks is left to
// trilinear_scatter_long_kernel: chunk 0 of the first launch adds its
// index to the long list.
// (above 8 channels a chunk, two blocks an SM: the 64 registers of four
// spilled the lane's tap values)
template <int CW, bool EXACT>
__global__ void __launch_bounds__(ScatterCfg::kWarps * 32, CW > 8 ? 2 : 4)
    trilinear_scatter_tile_kernel(const ScatterArgs a) {
  extern __shared__ __align__(16) float tile_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * a.w + warp;
  const int kc = a.k0 + kChunkC * blockIdx.y;
  if (tile >= a.tiles) return;
  const int bands = (a.rows + a.band - 1) / a.band;
  const int b = tile / bands, row0 = (tile - b * bands) * a.band;
  const int nrows = min(a.band, a.rows - row0);
  const int stride = a.band * a.r * a.c;
  float* buf = tile_smem + warp * stride;
  uint8_t* tags = reinterpret_cast<uint8_t*>(tile_smem + a.w * stride) +
                  warp * 8 * a.band * a.r;
  long long beg0;
  int len0;
  const int n = scatter_list_len(a, b, row0, row0 + nrows, beg0, len0);
  if (n > ScatterCfg::kLongChunks * 32) {
    if (lane == 0 && kc == 0) a.longs[3 + atomicAdd(a.longs, 1)] = tile;
    return;
  }
  for (int i = lane; i < nrows * a.r * a.c; i += 32) buf[i] = 0.f;
  __syncwarp();
  if (n) scatter_walk<CW, EXACT>(a, b, row0, row0 + nrows, buf, tags, 0, 1,
                                 beg0, len0, kc);
  __syncwarp();
  write_tile(a, tile, kc, buf, 1, stride, lane, 32);
}

// The long tiles of the launch's column chunks, one (tile, chunk) at a
// time a block (taken from the launch's cursor: the full chunks' or the
// last chunk's): warp w sums the chunks k % wl == w of the tile's list
// into its own copy, and the wl copies are added in warp order as the
// tile is written.
template <int CW, bool EXACT>
__global__ void __launch_bounds__(ScatterCfg::kLongWarps * 32, CW > 8 ? 1 : 2)
    trilinear_scatter_long_kernel(const ScatterArgs a) {
  extern __shared__ __align__(16) float tile_smem[];
  __shared__ int next;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wl = blockDim.x >> 5;
  const int bands = (a.rows + a.band - 1) / a.band;
  const int stride = a.band * a.r * a.c;
  float* copy = tile_smem + warp * stride;
  uint8_t* tags = reinterpret_cast<uint8_t*>(tile_smem + wl * stride) +
                  warp * 8 * a.band * a.r;
  const int count = a.longs[0];
  int* cursor = a.longs + (a.k0 ? 2 : 1);
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(cursor, 1);
    __syncthreads();
    const int idx = next;
    if (idx >= count * a.nk) return;
    const int tile = a.longs[3 + idx / a.nk];
    const int kc = a.k0 + kChunkC * (idx % a.nk);
    const int b = tile / bands, row0 = (tile - b * bands) * a.band;
    const int nrows = min(a.band, a.rows - row0);
    for (int i = lane; i < nrows * a.r * a.c; i += 32) copy[i] = 0.f;
    __syncwarp();
    long long beg0;
    int len0;
    segment(a, b, bin_ranges(a, row0, row0 + nrows), lane, beg0, len0);
    scatter_walk<CW, EXACT>(a, b, row0, row0 + nrows, copy, tags, warp, wl,
                            beg0, len0, kc);
    __syncthreads();
    write_tile(a, tile, kc, tile_smem, wl, stride, threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// row 10: the voxelizer, one persistent launch
// ---------------------------------------------------------------------------

// out[0..3] += v with one vector reduction (sm_90; out 16-byte aligned)
__device__ __forceinline__ void red_add_v4(float* out, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(out),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// out[0..1] += (x, y) with one vector reduction (out 8-byte aligned)
__device__ __forceinline__ void red_add_v2(float* out, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(out), "f"(x),
               "f"(y)
               : "memory");
}

// Variant hooks of profile_devox.py --variants (the package builds none
// of them). PCSEG_VOX_FILL: 0 the table in rounds of a block's 512
// float4s, block i writing the i-th of each round (the package's); 1 a
// contiguous slab a block, 16-byte stores; 2 the slab by TMA bulk stores
// of a zeroed shared buffer. PCSEG_VOX_SLAB_FLAGS (with slabs): a ready
// flag a slab, released after its fill and acquired before the first add
// into it, in place of the grid barrier. PCSEG_VOX_FILL_ONLY: 1 stops
// after the barrier (the fill and barrier's time), 2 after the fill (the
// fill's alone). PCSEG_VOX_MIN_BLOCKS: the blocks an SM (at most).
#ifndef PCSEG_VOX_FILL
#define PCSEG_VOX_FILL 0
#endif
#ifndef PCSEG_VOX_SLAB_FLAGS
#define PCSEG_VOX_SLAB_FLAGS 0
#endif
#ifndef PCSEG_VOX_FILL_ONLY
#define PCSEG_VOX_FILL_ONLY 0
#endif
#ifndef PCSEG_VOX_MIN_BLOCKS
#define PCSEG_VOX_MIN_BLOCKS 2
#endif
#if PCSEG_VOX_SLAB_FLAGS && PCSEG_VOX_FILL == 0
#error "slab flags need the slab fill"
#endif

constexpr int kVoxThreads = 512;
constexpr int kVoxMinBlocks = PCSEG_VOX_MIN_BLOCKS;
constexpr int kVoxWarps = kVoxThreads / 32;
constexpr int kVoxMaxBlocks = 4096;     // the grid's cap (slab flags)
constexpr int kVoxZeroBytes = 8192;     // the TMA fill's shared buffer

template <typename Id>
struct VoxArgs {
  const Id* flat;     // (B, M) voxel ids, R^3 for masked points
  const float* ext;   // (B, M, C1) point rows
  float* out;         // (B, R^3, C1), 16-byte aligned, not initialized
  long long n;        // points, B * M
  long long len;      // floats of the table, B R^3 C1
  long long slab;     // slab fills: floats a block zeroes, a multiple of 4
  int m, r3, c1;
  int vec;            // rows read as float4 (C1 % 4 == 0, ext aligned)
  unsigned epoch;     // slab flags: the value this call's fills release
};

#if PCSEG_VOX_SLAB_FLAGS
__device__ unsigned g_vox_ready[kVoxMaxBlocks];
#endif

// A lane's point: key b R^3 + id (-1 for a masked point or a lane past
// the end), its index and its first 4 channels, unrounded.
struct VoxPoint {
  long long key, pt;
  float x[4];
};

// channels k0 .. k0 + 3 of a row (0 past c1)
__device__ __forceinline__ void vox_load4(const float* e, int k0, int c1,
                                          bool vec, float (&x)[4]) {
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(e + k0));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = k0 + j < c1 ? __ldg(e + k0 + j) : 0.f;
  }
}

// Point chunk * 32 + lane; its id and row loads are independent, so both
// are in flight together.
template <typename Id>
__device__ __forceinline__ VoxPoint vox_point(const VoxArgs<Id>& a,
                                              long long chunk, int lane) {
  VoxPoint p{-1, chunk * 32 + lane, {0.f, 0.f, 0.f, 0.f}};
  if (p.pt < a.n) {
    const long long f = (long long)__ldg(a.flat + p.pt);
    vox_load4(a.ext + p.pt * a.c1, 0, a.c1, a.vec, p.x);
    if (f >= 0 && f < a.r3) p.key = p.pt / a.m * a.r3 + f;
  }
  return p;
}

// Phase A: the table's zeros. The package's form writes its float4s in
// rounds of a block's 512, block i taking the i-th of each round, so the
// grid's stores move through the table together (the slab form, with
// the same 16-byte stores, read 0.0002-0.0004 ms slower at both call
// sites and on uniform ids: PERF.md section 6); block 0 writes the floats
// past the last float4. The slab forms: block i
// zeroes floats [i slab, (i + 1) slab).
template <typename Id>
__device__ __forceinline__ void vox_fill(const VoxArgs<Id>& a) {
#if PCSEG_VOX_FILL == 0
  float4* o = reinterpret_cast<float4*>(a.out);
  const long long n4 = a.len >> 2;
  for (long long i = (long long)blockIdx.x * kVoxThreads + threadIdx.x;
       i < n4; i += (long long)gridDim.x * kVoxThreads)
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0 && threadIdx.x < (a.len & 3))
    a.out[(n4 << 2) + threadIdx.x] = 0.f;
#else
  const long long beg = (long long)blockIdx.x * a.slab;
  const long long end = min(beg + a.slab, a.len);
  if (beg >= end) return;                  // block-uniform
  const long long vend = beg + ((end - beg) & ~3LL);
#if PCSEG_VOX_FILL == 2
  __shared__ __align__(128) float4 zero[kVoxZeroBytes / 16];
  for (int i = threadIdx.x; i < kVoxZeroBytes / 16; i += kVoxThreads)
    zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned src = (unsigned)__cvta_generic_to_shared(zero);
  if (lane == 0) {
    constexpr long long kPiece = kVoxZeroBytes / 4;   // floats
    for (long long o = beg + warp * kPiece; o < vend;
         o += kVoxWarps * kPiece) {
      const unsigned bytes = (unsigned)(min(kPiece, vend - o) * 4);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              a.out + o),
          "r"(src), "r"(bytes)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
#else
  float4* o = reinterpret_cast<float4*>(a.out + beg);
  const long long n4 = (vend - beg) >> 2;
  for (long long i = threadIdx.x; i < n4; i += kVoxThreads)
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#endif
  for (long long i = vend + threadIdx.x; i < end; i += kVoxThreads)
    a.out[i] = 0.f;
#endif
}

#if PCSEG_VOX_SLAB_FLAGS
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
#endif

// Phase B: no add before the zeros it lands on.
template <typename Id>
__device__ __forceinline__ void vox_barrier(const VoxArgs<Id>& a) {
#if PCSEG_VOX_SLAB_FLAGS
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(
                     g_vox_ready + blockIdx.x),
                 "r"(a.epoch)
                 : "memory");
  }
#else
  cooperative_groups::this_grid().sync();
#endif
}

// The slab-flag variant's wait for the slabs of floats [off, off + w).
template <typename Id>
__device__ __forceinline__ void vox_wait(const VoxArgs<Id>& a, long long off,
                                         int w) {
#if PCSEG_VOX_SLAB_FLAGS
  for (long long s = off / a.slab; s <= (off + w - 1) / a.slab; ++s)
    while (ld_acquire(g_vox_ready + s) != a.epoch) __nanosleep(32);
#endif
}

// A warp chunk's groups: the lanes of one (event, voxel) key
// (__match_any_sync), a masked point in none; ``most`` is the largest group (0: nothing to add), ``lead`` its
// lowest lane.
struct VoxGroup {
  unsigned grp;
  int size, most;
  bool lead;
};

template <typename Id>
__device__ __forceinline__ VoxGroup vox_group(const VoxArgs<Id>& a,
                                              const VoxPoint& p, int lane) {
  VoxGroup g;
  g.grp = __match_any_sync(kAll, (unsigned long long)p.key);
  g.size = p.key >= 0 ? __popc(g.grp) : 0;
  g.most = (int)__reduce_max_sync(kAll, (unsigned)g.size);
  g.lead = p.key >= 0 && __ffs(g.grp) - 1 == lane;
  return g;
}

// The group's sums of 4 channels x (unrounded; rounded to bf16 here), its
// lanes in ascending order: step i reads the lane of the i-th set bit of
// the group's mask.
__device__ __forceinline__ void vox_sum4(const VoxGroup& g, int lane,
                                         const float (&x)[4],
                                         float (&sum)[4]) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = round_bf16(x[j]);
    sum[j] = 0.f;
  }
  unsigned rest = g.grp;
  for (int i = 0; i < g.most; ++i) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float y = __shfl_sync(kAll, v[j], src);
      if (i < g.size) sum[j] += y;
    }
  }
}

// The leader's add of channels k0 .. k0 + 3 (those below c1) at float g of
// the table, each by the widest reduction its address allows (v4 at 16
// bytes, v2 at 8, else scalar).
template <typename Id>
__device__ __forceinline__ void vox_red4(const VoxArgs<Id>& a, long long g,
                                         int k0, const float (&sum)[4]) {
  const int w = min(4, a.c1 - k0);
  float* o = a.out + g;
  int next = 0;                            // channels added
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < next || j >= w) continue;
    if (j == 0 && w == 4 && (g & 3) == 0) {
      red_add_v4(o, sum);
      next = 4;
    } else if (j < 3 && j + 2 <= w && ((g + j) & 1) == 0) {
      red_add_v2(o + j, sum[j], sum[j + 1]);
      next = j + 2;
    } else {
      atomicAdd(o + j, sum[j]);
      next = j + 1;
    }
  }
}

// Phase C for one warp chunk whose groups ``g`` and first 4 channels'
// sums ``s`` are known: the leaders add them, then channels 4.. of the
// row, loaded, summed and added 4 at a time.
template <typename Id>
__device__ __forceinline__ void vox_add(const VoxArgs<Id>& a,
                                        const VoxPoint& p, const VoxGroup& g,
                                        const float (&s)[4], int lane) {
  if (g.most == 0) return;                 // warp-uniform
  const long long row = p.key >= 0 ? p.key * a.c1 : 0;
  if (g.lead) {
    vox_wait(a, row, a.c1);
    vox_red4(a, row, 0, s);
  }
  const float* e = a.ext + (p.key >= 0 ? p.pt * a.c1 : 0);
  for (int k0 = 4; k0 < a.c1; k0 += 4) {
    float x[4] = {0.f, 0.f, 0.f, 0.f}, sum[4];
    if (p.key >= 0) vox_load4(e, k0, a.c1, a.vec, x);
    vox_sum4(g, lane, x, sum);
    if (g.lead) vox_red4(a, row + k0, k0, sum);
  }
}

// One cooperative launch of a co-resident grid. A warp takes chunks of 32
// consecutive points, chunk w G + b for warp w of block b in a grid of G,
// then grid-stride. Before the fill it loads its first chunk and forms its
// groups and their sums of the first 4 channels (a warp without points
// goes straight to the fill); the grid zeroes the table; it waits at one
// barrier; the leaders add. Each later chunk's loads are issued before
// the adds of the one before.
template <typename Id>
__global__ void __launch_bounds__(kVoxThreads, kVoxMinBlocks)
    voxelize_contract_kernel(const VoxArgs<Id> a) {
  const int lane = threadIdx.x & 31;
  const long long chunks = (a.n + 31) >> 5;
  const long long step = (long long)gridDim.x * kVoxWarps;
  long long chunk = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  VoxPoint p = vox_point(a, chunk, lane);
  VoxGroup g = vox_group(a, p, lane);
  float s[4];
  vox_sum4(g, lane, p.x, s);
  vox_fill(a);
  if (PCSEG_VOX_FILL_ONLY == 2) return;
  vox_barrier(a);
  if (PCSEG_VOX_FILL_ONLY) return;
  for (; chunk < chunks; chunk += step) {
    const VoxPoint next = vox_point(a, chunk + step, lane);
    vox_add(a, p, g, s, lane);
    p = next;
    g = vox_group(a, p, lane);
    vox_sum4(g, lane, p.x, s);
  }
}

// ---------------------------------------------------------------------------
// row 13: the trilinear gather at a compile-time width
// ---------------------------------------------------------------------------

// A thread a point and column chunk (channels k0 + kChunkC y + [0, c) of
// rows cs wide, grid y): its <= 8 tap rows loaded before any sum (per x
// tap above 8 channels, to bound the registers), the sums in the plain
// version's order, one vector store.
template <int CW, bool EXACT>
__global__ void __launch_bounds__(kThreads) trilinear_gather_kernel(
    const float* __restrict__ u, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ g2, float* __restrict__ out,
    long long n, int m, int r, int c, int cs, int k0) {
  const long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= n) return;
  const int kc = k0 + kChunkC * blockIdx.y;
  float* o = out + pt * cs + kc;
  float acc[CW];
#pragma unroll
  for (int k = 0; k < CW; ++k) acc[k] = 0.f;
  if (!mask[pt]) {
    store_f32_row<CW, EXACT>(o, c, acc);
    return;
  }
  const long long b = pt / m;
  int zi[4], ix[2];
  float a[4], xw[2];
  bool first[4];
  zy_taps(u[pt * 3 + 0], u[pt * 3 + 1], r, zi, a, first);
  const int nx = x_taps(u[pt * 3 + 2], r, ix, xw);
  const __nv_bfloat16* grid = g2 + b * (long long)r * r * r * cs + kc;
  constexpr int kX = CW <= 8 ? 2 : 1;  // x taps whose rows load together
#pragma unroll
  for (int e0 = 0; e0 < 2; e0 += kX) {
    float v[kX][4][CW];
#pragma unroll
    for (int x = 0; x < kX; ++x)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        load_bf16_row<CW, EXACT>(
            grid + ((long long)zi[t] * r + ix[e0 + x]) * cs, c, v[x][t]);
#pragma unroll
    for (int x = 0; x < kX; ++x) {
      float s[CW];
#pragma unroll
      for (int k = 0; k < CW; ++k) s[k] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < CW; ++k)
          if (first[t]) s[k] = __fadd_rn(s[k], __fmul_rn(a[t], v[x][t][k]));
      if (e0 + x < nx)
#pragma unroll
        for (int k = 0; k < CW; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(xw[e0 + x], s[k]));
    }
  }
  store_f32_row<CW, EXACT>(o, c, acc);
}

// rows / cols (B, M) int32, vals (B, M, C) f32 rounded to bf16 here; out
// (B, nrows, ncols * C) f32 zeroed by the caller. A thread a point reads
// its values 4 channels at a time (one 16-byte load where C % 4 == 0, a
// scalar tail otherwise). The lanes of a warp whose points fall in one
// (b, row, col) cell (__match_any_sync) sum their values in lane order,
// and the group's lowest lane adds the sum: one red.global.add.v4.f32 for
// 4 channels where C % 4 == 0, else a scalar atomic a channel. A point
// outside the table (the sentinel row) joins no group, and a zero sum (a
// masked point's cotangent) is not added.
__global__ void __launch_bounds__(kThreads) rowcol_scatter_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const float* __restrict__ vals, float* __restrict__ out, long long n,
    int m, int nrows, int ncols, int c) {
  const long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool vec = (c & 3) == 0;
  long long cell = -1;   // (b nrows + row) ncols + col, or -1: none
  if (pt < n) {
    const int r = rows[pt], col = cols[pt];
    if (r >= 0 && r < nrows && col >= 0 && col < ncols)
      cell = (pt / m * nrows + r) * ncols + col;
  }
  const unsigned grp = __match_any_sync(kAll, (unsigned long long)cell);
  const int size = cell >= 0 ? __popc(grp) : 0;
  const int most = (int)__reduce_max_sync(kAll, (unsigned)size);
  const bool lead = cell >= 0 && __ffs(grp) - 1 == lane;
  const float* v = vals + (cell >= 0 ? pt * c : 0);
  float* o = out + (cell >= 0 ? cell * c : 0);
  for (int k0 = 0; k0 < c; k0 += 4) {
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell >= 0) {
      if (vec) {
        const float4 q = *reinterpret_cast<const float4*>(v + k0);
        x[0] = q.x;
        x[1] = q.y;
        x[2] = q.z;
        x[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + j < c) x[j] = v[k0 + j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = round_bf16(x[j]);
    }
    // the group's sum, its lanes in ascending order: step i reads the
    // lane of the i-th set bit of the group's mask
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    unsigned rest = grp;
    for (int i = 0; i < most; ++i) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      rest &= rest - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = __shfl_sync(kAll, x[j], src);
        if (i < size) sum[j] += y;
      }
    }
    if (!lead) continue;
    if (vec) {
      if (sum[0] != 0.f || sum[1] != 0.f || sum[2] != 0.f || sum[3] != 0.f)
        red_add_v4(o + k0, sum);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < c && sum[j] != 0.f) atomicAdd(o + k0 + j, sum[j]);
    }
  }
}

// ids (B, M) int32, feats (B, M, C) f32; out (B, nseg, C) f32 zeroed by
// the caller. A thread per (point, channel).
__global__ void __launch_bounds__(kThreads) segment_scatter_kernel(
    const int* __restrict__ ids, const float* __restrict__ feats,
    float* __restrict__ out, long long total, int m, int nseg, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long pt = i / c;
  const int id = ids[pt];
  if (id < 0 || id >= nseg) return;          // the spill id, or worse
  const long long b = pt / m;
  atomicAdd(out + (b * nseg + id) * c + (i - pt * c), feats[i]);
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

constexpr int kMaxDevices = 64;

// Row 10's cooperative launch: blocks = SMs x the blocks an SM holds (the
// occupancy API, once a device), so that the whole grid is resident and
// its barrier cannot wait on a block that never starts; a refused launch
// returns its error.
template <typename Id>
int voxelize_launch(const void* flat, const void* ext, void* out, int B,
                    int M, int R, int C1, cudaStream_t st) {
  static int grid_on[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid_on[dev] == 0) {
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, voxelize_contract_kernel<Id>, kVoxThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorLaunchOutOfResources;
    per = per < kVoxMinBlocks ? per : kVoxMinBlocks;
    grid_on[dev] = sms * per < kVoxMaxBlocks ? sms * per : kVoxMaxBlocks;
  }
  const int grid = grid_on[dev];
  const long long r3 = (long long)R * R * R;
  const long long len = B * r3 * C1;
  const long long slab = ((len + grid - 1) / grid + 3) & ~3LL;
  static unsigned epoch = 0;
  if (++epoch == 0) epoch = 1;
  const bool vec = C1 % 4 == 0 && ((uintptr_t)ext & 15) == 0;
  VoxArgs<Id> a{(const Id*)flat, (const float*)ext, (float*)out,
                (long long)B * M, len, slab, M, (int)r3, C1, vec ? 1 : 0,
                epoch};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)voxelize_contract_kernel<Id>,
                                  dim3(grid), dim3(kVoxThreads), args, 0, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The tiles of a call: trilinear_scatter_tile_kernel, a tile a warp, then
// trilinear_scatter_long_kernel on the long list, two blocks an SM.
template <int CW, bool EXACT>
int launch_tile(const ScatterArgs& a, const ScatterPlan& p, cudaStream_t st) {
  static int sms = 0;
  if (!sms) {
    for (const void* k : {(const void*)trilinear_scatter_tile_kernel<CW, EXACT>,
                          (const void*)trilinear_scatter_long_kernel<CW, EXACT>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          ScatterCfg::kSmemMax);
      if (e != cudaSuccess) return (int)e;
    }
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) return (int)cudaErrorInvalidValue;
  }
  trilinear_scatter_tile_kernel<CW, EXACT>
      <<<dim3((a.tiles + a.w - 1) / a.w, a.nk), 32 * a.w, p.smem, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  trilinear_scatter_long_kernel<CW, EXACT>
      <<<(int)min(2LL * sms, (long long)a.tiles * a.nk), 32 * p.wl,
         p.smem_l, st>>>(a);
  return (int)cudaGetLastError();
}

// The tile kernels of one launch: nk column chunks of width c from
// channel k0 (the full chunks at kChunkC, or the last chunk at its
// width); a width with an instantiation of its own is exact.
int launch_tiles(ScatterArgs a, const ScatterPlan& p, int k0, int c, int nk,
                 cudaStream_t st) {
  a.k0 = k0;
  a.c = c;
  a.nk = nk;
  switch (c) {
#define PCSEG_TILE(CW, EXACT) return launch_tile<CW, EXACT>(a, p, st)
    case 1: PCSEG_TILE(1, true);
    case 2: PCSEG_TILE(2, true);
    case 3: PCSEG_TILE(3, true);
    case 4: PCSEG_TILE(4, true);
    case 5: PCSEG_TILE(5, true);
    case 6: PCSEG_TILE(6, true);
    case 7: PCSEG_TILE(7, true);
    case 8: PCSEG_TILE(8, true);
    case 16: PCSEG_TILE(16, true);
    case 32: PCSEG_TILE(32, true);
    default:
      if (c < 16) PCSEG_TILE(16, false);
      PCSEG_TILE(32, false);
#undef PCSEG_TILE
  }
}

struct Gather {
  const float* u;
  const uint8_t* mask;
  const __nv_bfloat16* g2;
  float* out;
  long long n;
  int m, r, cs;
  cudaStream_t st;
};

template <int CW, bool EXACT>
int launch_gather(const Gather& g, int k0, int c, int nk) {
  trilinear_gather_kernel<CW, EXACT>
      <<<dim3(blocks_for(g.n), nk), kThreads, 0, g.st>>>(
          g.u, g.mask, g.g2, g.out, g.n, g.m, g.r, c, g.cs, k0);
  return (int)cudaGetLastError();
}

// nk column chunks of width c from channel k0; exact (vector loads and
// stores) at a width with an instantiation of its own where the rows
// allow it (``aligned``: C <= kChunkC, or C a multiple of 8)
int gather_chunks(const Gather& g, int k0, int c, int nk, bool aligned) {
  if (aligned) {
    switch (c) {
      case 1: return launch_gather<1, true>(g, k0, c, nk);
      case 2: return launch_gather<2, true>(g, k0, c, nk);
      case 3: return launch_gather<3, true>(g, k0, c, nk);
      case 4: return launch_gather<4, true>(g, k0, c, nk);
      case 5: return launch_gather<5, true>(g, k0, c, nk);
      case 6: return launch_gather<6, true>(g, k0, c, nk);
      case 7: return launch_gather<7, true>(g, k0, c, nk);
      case 8: return launch_gather<8, true>(g, k0, c, nk);
      case 16: return launch_gather<16, true>(g, k0, c, nk);
      case 32: return launch_gather<32, true>(g, k0, c, nk);
      default: break;
    }
  }
  return c <= 16 ? launch_gather<16, false>(g, k0, c, nk)
                 : launch_gather<32, false>(g, k0, c, nk);
}

}  // namespace

extern "C" {

// flat (B, M) voxel ids of id_bytes 4 (int32) or 8 (int64), R^3 for
// masked points; ext (B, M, C1) f32 point rows; out (B, R^3, C1) f32,
// 16-byte aligned, every value written (zeros included) by the one launch.
int pcseg_voxelize_contract(const void* flat, int id_bytes, const void* ext,
                            void* out, int B, int M, int R, int C1,
                            void* stream) {
  if (B <= 0 || M <= 0 || R <= 0 || C1 <= 0 ||
      (long long)R * R * R > 0x7fffffffLL || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (id_bytes == 4)
    return voxelize_launch<int>(flat, ext, out, B, M, R, C1, st);
  if (id_bytes == 8)
    return voxelize_launch<long long>(flat, ext, out, B, M, R, C1, st);
  return (int)cudaErrorInvalidValue;
}

// The scratch pcseg_trilinear_scatter needs at (B, M, R, C), in 16-byte
// units, or -1 where it takes no such call (B past 65,535, more than
// 65,535 column chunks, one zy row of a column chunk in f32 past a
// block's shared memory, or a scratch past 2^31 units).
int pcseg_trilinear_scatter_scratch(int B, int M, int R, int C) {
  ScatterPlan p;
  if (!scatter_plan(B, M, R, C, &p)) return -1;
  const long long n = scatter_scratch(B, M, p);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// u (B, M, 3) f32 continuous voxel coords (masked points finite); go
// (B, M, C) f32 point cotangents, masked rows zero; out (B, R^3, C), f32
// or (out_bf16) bf16, NDHWC order (z * R + y) * R * C + x * C + k, every
// value written; scratch pcseg_trilinear_scatter_scratch 16-byte units,
// 16-byte aligned, as is out. Binning once, then the tile kernels of the
// full column chunks (one launch, grid y) and of the last, narrower one.
int pcseg_trilinear_scatter(const void* u, const void* go, void* out,
                            void* scratch, int B, int M, int R, int C,
                            int out_bf16, void* stream) {
  ScatterPlan p;
  if (!scatter_plan(B, M, R, C, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static bool bin_ready = false;
  if (!bin_ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        trilinear_scatter_bin_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ScatterCfg::kBinSmem);
    if (e != cudaSuccess) return (int)e;
    bin_ready = true;
  }
  uint4* entries = (uint4*)scratch;
  int* offs = (int*)(entries + (long long)B * M * p.ent);
  int* longs = offs + (long long)B * p.chunks * (p.bins + 1);
  trilinear_scatter_bin_kernel<<<dim3(p.chunks, B), ScatterCfg::kBinThreads,
                                 ScatterCfg::kBinSmem, st>>>(
      (const float*)u, (const float*)go, entries, offs, longs, M, R, C, p.h,
      p.bins, p.chunks, p.ent);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ScatterArgs a{entries, offs, longs, out, M, R, C, p.rows, p.band, p.w,
                p.h, p.bins, p.chunks, p.ent, B * p.bands,
                out_bf16 ? 1 : 0, C, 0, 1};
  if (p.full) {
    const int rc = launch_tiles(a, p, 0, kChunkC, p.full, st);
    if (rc) return rc;
  }
  return p.tail ? launch_tiles(a, p, p.full * kChunkC, p.tail, 1, st) : 0;
}

// u (B, M, 3) f32 continuous voxel coords; mask (B, M) bool (one byte a
// point); g2 (B, R^3, C) bf16 in the same NDHWC order, 16-byte aligned;
// out (B, M, C) f32, 16-byte aligned. Above kChunkC channels: the full
// column chunks in one launch (grid y), the last, narrower one in a
// second.
int pcseg_trilinear_gather(const void* u, const void* mask, const void* g2,
                           void* out, int B, int M, int R, int C,
                           void* stream) {
  if (B <= 0 || M <= 0 || R <= 0 || C <= 0 || C / kChunkC > 65535)
    return (int)cudaErrorInvalidValue;
  const Gather g{(const float*)u, (const uint8_t*)mask,
                 (const __nv_bfloat16*)g2, (float*)out, (long long)B * M, M,
                 R, C, (cudaStream_t)stream};
  const bool aligned = C <= kChunkC || C % 8 == 0;
  const int full = C / kChunkC, tail = C % kChunkC;
  if (full) {
    const int rc = gather_chunks(g, 0, kChunkC, full, aligned);
    if (rc) return rc;
  }
  return tail ? gather_chunks(g, full * kChunkC, tail, 1, aligned) : 0;
}

// rows / cols (B, M) int32 (a row >= nrows adds nothing); vals (B, M, C)
// f32; out (B, nrows, ncols * C) f32, zeroed by the caller.
int pcseg_rowcol_scatter(const void* rows, const void* cols, const void* vals,
                         void* out, int B, int M, int nrows, int ncols, int C,
                         void* stream) {
  if (B <= 0 || M <= 0 || nrows <= 0 || ncols <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M;
  rowcol_scatter_kernel<<<blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)cols, (const float*)vals, (float*)out, n,
      M, nrows, ncols, C);
  return (int)cudaGetLastError();
}

// ids (B, M) int32 (nseg is the spill id; any id outside [0, nseg) adds
// nothing); feats (B, M, C) f32; out (B, nseg, C) f32, zeroed by the
// caller.
int pcseg_segment_scatter(const void* ids, const void* feats, void* out,
                          int B, int M, int nseg, int C, void* stream) {
  if (B <= 0 || M <= 0 || nseg <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * M * C;
  segment_scatter_kernel<<<blocks_for(total), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)ids, (const float*)feats, (float*)out, total, M, nseg, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
