// Launch helpers shared by the decoder kernels (fused_decoder_wgmma.cu,
// decoder_int8.cu, train_decoder.cu): the card query and the time-tile
// rule.  Host code only.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace mixstage {

// The tensor-core rule of K1 and K2 (both modes).  Each CTA of K1 streams its
// group's whole weight set through shared memory once (a fixed cost per
// CTA) and runs each layer's rows in passes of `quantum` rows (8: the
// step of wgmma's N): a CTA of `tile` frames costs about
//   weight_rows + sum over the n_layers k=3 layers of
//                 ceil(rows_l / quantum) * quantum
// row-passes, rows_l = tile + 2 * (halo - l) - 2, and the grid runs in
// ceil(CTAs / sm_count) waves.  Of the tiles 8, 16, ..., max_tile that
// `fits` (shared memory, the kernel's rows per layer) and that half of
// which does not already cover T, the one with the least estimated time
// (waves x CTA cost) wins; ties go to the smaller tile (more CTAs to
// spread over the SMs).  0 when no tile fits.  `weight_rows` is the weight
// staging's cost in row-passes; the rule picked the fastest tile at every
// shape chip_smoke.py launches (tools/profile_k1.py --sweep, PERF.md).
template <class Fits>
int cost_tile(int max_tile, int B, int T, int G, int halo, int n_layers,
              int quantum, int weight_rows, int sm_count, Fits fits) {
  int best = 0;
  long long best_cost = 0;
  for (int tile = 8; tile <= max_tile; tile *= 2) {
    if (!fits(tile) || (tile > 8 && tile / 2 >= T)) continue;
    long long rows = weight_rows;
    for (int l = 0; l < n_layers; ++l)
      rows += (tile + 2 * (halo - l) - 2 + quantum - 1) / quantum * quantum;
    const long long ctas = (long long)G * B * ((T + tile - 1) / tile);
    const long long cost = (ctas + sm_count - 1) / sm_count * rows;
    if (best == 0 || cost < best_cost) {
      best = tile;
      best_cost = cost;
    }
  }
  return best;
}

// The current card's SM count and opt-in shared memory per CTA.
inline cudaError_t card(int* sms, int* smem_limit) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

}  // namespace mixstage
