// Host-side window gatherer of the port's data pipeline: the port's copy
// of mixstage_tpu/native/batcher.cpp, the same three C functions on
// contiguous buffers (strided window gather, fused ZNorm + joint mask,
// plain ZNorm), loaded through ctypes by mixstage_tpu_torch/data/native.py.
//
// Built at first use by g++ with the JAX package's native/Makefile flags
// into build/torch_kernels/libbatcher_<hash>.so.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Gather strided windows from one interval's modality array.
//   data:    (rows, cols) row-major
//   starts:  n window start rows
//   out:     (n, steps, cols) with out[b, t, :] = data[starts[b] + t*stride, :]
void gather_windows(const double* data, int64_t rows, int64_t cols,
                    const int64_t* starts, int64_t n,
                    int64_t steps, int64_t stride, double* out) {
  for (int64_t b = 0; b < n; ++b) {
    const int64_t s0 = starts[b];
    double* dst = out + b * steps * cols;
    for (int64_t t = 0; t < steps; ++t) {
      const int64_t row = s0 + t * stride;
      const double* src = data + (row < rows ? row : rows - 1) * cols;
      std::memcpy(dst + t * cols, src, sizeof(double) * cols);
    }
  }
}

// Fused ZNorm + joint masking on a pose batch.
//   x:     (n, t, 2*joints)  row-major
//   mean/var: broadcast stats of length 2*joints (num_dims=2 reduction)
//   keep:  indices (within [0, joints)) of the joints kept, length n_keep
//   out:   (n, t, 2*n_keep): znormed x gathered at [keep, joints + keep]
// Matches ZNorm.znorm (transform.py:221-226: std = sqrt(max(var,0)),
// std==0 -> eps) followed by RemoveJoints (transform.py:497-507).
void znorm_mask(const double* x, int64_t n, int64_t t, int64_t feats,
                const double* mean, const double* var,
                const int64_t* keep, int64_t n_keep,
                double eps, float* out) {
  const int64_t joints = feats / 2;
  // precompute scale/shift per feature
  double* inv_std = new double[feats];
  for (int64_t f = 0; f < feats; ++f) {
    double v = var[f] >= 0 ? var[f] : 0.0;
    double s = std::sqrt(v);
    inv_std[f] = 1.0 / (s == 0.0 ? eps : s);
  }
  const int64_t out_feats = 2 * n_keep;
  for (int64_t b = 0; b < n; ++b) {
    for (int64_t ti = 0; ti < t; ++ti) {
      const double* row = x + (b * t + ti) * feats;
      float* dst = out + (b * t + ti) * out_feats;
      for (int64_t k = 0; k < n_keep; ++k) {
        const int64_t jx = keep[k];            // x coordinate plane
        const int64_t jy = joints + keep[k];   // y coordinate plane
        dst[k] = (float)((row[jx] - mean[jx]) * inv_std[jx]);
        dst[n_keep + k] = (float)((row[jy] - mean[jy]) * inv_std[jy]);
      }
    }
  }
  delete[] inv_std;
}

// Plain ZNorm to float32 (non-pose modalities, e.g. log-mel windows).
void znorm_f32(const double* x, int64_t n_elems_outer, int64_t feats,
               const double* mean, const double* var,
               double eps, float* out) {
  double* inv_std = new double[feats];
  for (int64_t f = 0; f < feats; ++f) {
    double v = var[f] >= 0 ? var[f] : 0.0;
    double s = std::sqrt(v);
    inv_std[f] = 1.0 / (s == 0.0 ? eps : s);
  }
  for (int64_t i = 0; i < n_elems_outer; ++i) {
    const double* row = x + i * feats;
    float* dst = out + i * feats;
    for (int64_t f = 0; f < feats; ++f)
      dst[f] = (float)((row[f] - mean[f]) * inv_std[f]);
  }
  delete[] inv_std;
}

}  // extern "C"
