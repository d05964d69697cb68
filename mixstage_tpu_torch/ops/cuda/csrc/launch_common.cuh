// Launch helpers shared by the decoder kernels (fused_decoder.cu,
// decoder_int8.cu): the card query and the time-tile rule.  Host code only.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace mixstage {

inline int round4(int n) { return (n + 3) & ~3; }

// Output frames per CTA: `max_tile`, halved (down to 8) while half the tile
// still covers T, while the grid of G * B * ceil(T / tile) CTAs would leave
// over an eighth of the card's `sm_count` SMs idle, or while the CTA's
// `smem_bytes(tile)` overflows `smem_limit`; 0 when not even the 8-frame
// tile fits.  A smaller tile recomputes more halo frames per output frame.
template <class SmemBytes>
int pick_tile(int max_tile, int B, int T, int G, int sm_count,
              size_t smem_limit, SmemBytes smem_bytes) {
  int tile = max_tile;
  while (tile > 8 && tile / 2 >= T) tile /= 2;
  while (tile > 8 && ((long long)G * B * ((T + tile - 1) / tile) <
                          sm_count * 7 / 8 ||
                      smem_bytes(tile) > smem_limit))
    tile /= 2;
  return smem_bytes(tile) > smem_limit ? 0 : tile;
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
