// Exact-bitmap build and probe of the PRO radix join (Hopper, sm_90a).
//
// Replaces the Pallas kernels of hwbloomradixjoin_tpu/ops/bitmap_join.py:
//   hbrj_bitmap_build  <- bitmap_build_pallas (_build_kernel_for, bitmap_join.py:345)
//   hbrj_bitmap_probe  <- bitmap_probe_count  (_probe_kernel_for, bitmap_join.py:223)
//
// Bitmap layout (shared with the JAX package): bucket b = norm >> shift of
// norm = key - lo owns sl_words = sl_rows*128 int32 words starting at word
// b*sl_words; bit (norm & 31) of word (norm & (2^shift-1)) >> 5 is the key.
//
// Build: one bit per R key in [lo, hi], set with atomicOr.  The TPU had no
// scatter and deposited bits with one-hot bf16 matmuls (ADD == OR for unique
// keys); here the deposit is the scatter itself, and OR is exact for any key
// multiset.  The bitmap is zeroed first, so every word (empty slices and the
// 8-row slice padding included) is written.  Bound: one atomic per key on an
// L2-resident bitmap (2 MiB for a 16M key range); R arrives partitioned, so
// neighbouring keys hit neighbouring words of one slice.
//
// Probe: streams the partitioned S flat, 16 bytes per thread and load, and
// counts keys whose ARITHMETIC bucket (the TPU kernel's test) lies in [0, F)
// and whose bit is set; PAD and out-of-range keys never do.  Each key is read
// exactly once, so no window or ownership descriptors are needed (they existed
// because a TPU grid step stages fixed DMA windows).  Bound: the S stream from
// device memory plus one L2 gather per in-range key; the count accumulates in
// 64 bits per thread, then per block, then one atomicAdd per block.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void deposit(int key, unsigned* __restrict__ bm, int lo,
                                        int hi, int shift, long long sl_words) {
  if (key < lo || key > hi) return;
  const unsigned norm = (unsigned)key - (unsigned)lo;
  const unsigned local = norm & ((1u << shift) - 1u);
  atomicOr(bm + (long long)(norm >> shift) * sl_words + (local >> 5), 1u << (norm & 31u));
}

__global__ void bitmap_build_kernel(const int4* __restrict__ r, long long n4,
                                    unsigned* __restrict__ bm, int lo, int hi,
                                    int shift, long long sl_words) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 v = r[i];
    deposit(v.x, bm, lo, hi, shift, sl_words);
    deposit(v.y, bm, lo, hi, shift, sl_words);
    deposit(v.z, bm, lo, hi, shift, sl_words);
    deposit(v.w, bm, lo, hi, shift, sl_words);
  }
}

__device__ __forceinline__ unsigned hit(int key, const unsigned* __restrict__ bm,
                                        int lo, int shift, int F, long long sl_words) {
  const int norm = (int)((unsigned)key - (unsigned)lo);   // int32 wrap, as on the TPU
  const int b = norm >> shift;                            // arithmetic shift
  if (b < 0 || b >= F) return 0u;
  const unsigned local = (unsigned)norm & ((1u << shift) - 1u);
  return (__ldg(bm + (long long)b * sl_words + (local >> 5)) >> (norm & 31)) & 1u;
}

__global__ void bitmap_probe_kernel(const unsigned* __restrict__ bm,
                                    const int4* __restrict__ s, long long n4,
                                    unsigned long long* __restrict__ out, int lo,
                                    int shift, int F, long long sl_words) {
  unsigned long long c = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 v = s[i];
    c += hit(v.x, bm, lo, shift, F, sl_words) + hit(v.y, bm, lo, shift, F, sl_words)
       + hit(v.z, bm, lo, shift, F, sl_words) + hit(v.w, bm, lo, shift, F, sl_words);
  }
  using Reduce = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename Reduce::TempStorage temp;
  const unsigned long long total = Reduce(temp).Sum(c);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

}  // namespace

extern "C" {

// r: n int32 keys (n % 4 == 0, 16-byte aligned); bm: nwords int32, overwritten.
int hbrj_bitmap_build(const int* r, long long n, int* bm, long long nwords, int lo,
                      int hi, int shift, long long sl_words, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(bm, 0, (size_t)nwords * sizeof(int), stream);
  if (err) return (int)err;
  const long long n4 = n / 4;
  if (n4) {
    bitmap_build_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(r), n4, reinterpret_cast<unsigned*>(bm), lo, hi,
        shift, sl_words);
  }
  return (int)cudaGetLastError();
}

// s: n int32 keys (n % 4 == 0, 16-byte aligned); out: one uint64, overwritten.
int hbrj_bitmap_probe(const int* bm, const int* s, long long n,
                      unsigned long long* out, int lo, int shift, int F,
                      long long sl_words, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (err) return (int)err;
  const long long n4 = n / 4;
  if (n4) {
    bitmap_probe_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
        reinterpret_cast<const unsigned*>(bm), reinterpret_cast<const int4*>(s), n4,
        out, lo, shift, F, sl_words);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
