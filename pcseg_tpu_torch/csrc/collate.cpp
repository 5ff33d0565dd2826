// Native host-side batch packer (after pcseg_tpu/native/collate.cpp).
//
// The ragged->static collation (zero-pad points, -1-pad labels, build
// masks — the reference's collate_fn, point_cloud_segmentation.py:44-63)
// is the per-batch host hot path: it touches every byte of every batch.
// The reference hides this cost in 32 DataLoader worker processes; here a
// single C++ pass memsets + memcpys the padded buffers directly into
// numpy-owned memory with no Python per-event overhead.
//
// Built at first use by pcseg_tpu_torch/ops/_build.py (build_host: g++
// -O3 -std=c++17 -shared -fPIC) and bound by pcseg_tpu_torch/data/native.py.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Pack up to n_events ragged events into a (batch_size, max_points, ...)
// dense batch. Rows beyond n_events stay fully padded (mask 0, labels -1).
// Event i's n_points[i] * feat_dim floats lie at pts_base + pts_off[i] and
// its n_points[i] int64 labels at lab_base + lab_off[i] (byte offsets):
// the concatenation of in-memory events (pts_off the prefix sums), or two
// mapped HDF5 files (data/hdf5.py), so no per-event copy precedes the
// pass. (The JAX package's pack_batch takes the concatenation only.)
//
// out_points  : (batch_size * max_points * feat_dim) float32, overwritten
// out_labels  : (batch_size * max_points) int64, overwritten
// out_masks   : (batch_size * max_points) uint8 (bool), overwritten
//
// Returns 0 on success, -1 if any event exceeds max_points or
// n_events > batch_size.
int32_t pack_gather(const uint8_t* pts_base,
                    const uint8_t* lab_base,
                    const int64_t* pts_off,
                    const int64_t* lab_off,
                    const int32_t* n_points,
                    int32_t n_events,
                    int32_t batch_size,
                    int32_t max_points,
                    int32_t feat_dim,
                    float* out_points,
                    int64_t* out_labels,
                    uint8_t* out_masks) {
  if (n_events > batch_size) return -1;
  for (int32_t i = 0; i < n_events; ++i) {
    if (n_points[i] > max_points) return -1;
  }

  const int64_t row_pts = static_cast<int64_t>(max_points) * feat_dim;
  std::memset(out_points, 0,
              sizeof(float) * static_cast<int64_t>(batch_size) * row_pts);
  std::memset(out_masks, 0,
              static_cast<int64_t>(batch_size) * max_points);
  std::fill(out_labels,
            out_labels + static_cast<int64_t>(batch_size) * max_points,
            static_cast<int64_t>(-1));

  for (int32_t i = 0; i < n_events; ++i) {
    const int32_t n = n_points[i];
    if (n == 0) continue;
    std::memcpy(out_points + i * row_pts, pts_base + pts_off[i],
                sizeof(float) * static_cast<int64_t>(n) * feat_dim);
    std::memcpy(out_labels + static_cast<int64_t>(i) * max_points,
                lab_base + lab_off[i], sizeof(int64_t) * n);
    std::memset(out_masks + static_cast<int64_t>(i) * max_points, 1, n);
  }
  return 0;
}

// Length-bucketed epoch plan: given per-event point counts and a shuffled
// order, sort each window of `window` indices by length (stable) in place.
// This is BucketBatcher._epoch_order's inner loop without Python.
void bucket_sort_windows(int64_t* order,
                         const int32_t* lengths,
                         int64_t n,
                         int64_t window) {
  for (int64_t s = 0; s < n; s += window) {
    int64_t e = std::min(s + window, n);
    std::stable_sort(order + s, order + e,
                     [lengths](int64_t a, int64_t b) {
                       return lengths[a] < lengths[b];
                     });
  }
}

}  // extern "C"
