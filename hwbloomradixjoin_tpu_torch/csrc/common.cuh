// Helpers shared by the streaming kernels of csrc/*.cu.
#pragma once

#include <cuda_runtime.h>

namespace hbrj {

// Grid of a grid-stride loop over n items at `threads` per block: one block
// per `threads` items, capped at 8 blocks per SM (enough to hide memory
// latency; the loop covers the rest).
inline unsigned grid_for(long long n, int threads) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long want = (n + threads - 1) / threads;
  const long long cap = (long long)sms * 8;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace hbrj
