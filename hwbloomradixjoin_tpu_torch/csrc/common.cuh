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

// The reference's seeded hashes (src/hash.c), bit-exact with the plain
// PyTorch twins of ops/hashes.py.
//
// CRC-32C (_mm_crc32_u32: reflected polynomial 0x82F63B78, no final
// inversion) a byte at a time: the 32 bitwise steps are linear over GF(2), so
// eight steps of x equal (x >> 8) ^ T[x & 0xFF] with T[i] = eight steps of i.
// T lives in shared memory (1 KiB); every thread of the block calls
// crc32c_table_init, then the block synchronises before the first crc32c.
constexpr unsigned kCrc32cPoly = 0x82F63B78u;

__device__ __forceinline__ void crc32c_table_init(unsigned* table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = (unsigned)i;
#pragma unroll
    for (int s = 0; s < 8; ++s) c = (c >> 1) ^ (kCrc32cPoly & (0u - (c & 1u)));
    table[i] = c;
  }
}

__device__ __forceinline__ unsigned crc32c(const unsigned* table, unsigned seed,
                                           int key) {
  unsigned x = seed ^ (unsigned)key;
#pragma unroll
  for (int b = 0; b < 4; ++b) x = (x >> 8) ^ table[x & 0xFFu];
  return x;
}

// CrapWow reduced to one 4-byte key: two cwmixb rounds, each taking the
// 64-bit product of its input and 0x5052ACDB (low word into h, high word
// into k).
__device__ __forceinline__ unsigned crapwow(unsigned seed, int key) {
  const unsigned n = 0x5052ACDBu;
  unsigned h = 4u, k = 4u + seed + n;
  unsigned in = (unsigned)key;
  h ^= in * n;
  k ^= __umulhi(in, n);
  in = h ^ (k + n);
  h ^= in * n;
  k ^= __umulhi(in, n);
  return k ^ h;
}

}  // namespace hbrj
