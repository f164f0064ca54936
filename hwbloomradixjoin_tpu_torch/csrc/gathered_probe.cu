// General radix count join probe over co-partitioned R and S (Hopper, sm_90a).
//
// Replaces the Pallas kernel of hwbloomradixjoin_tpu/ops/radix.py:
//   hbrj_gathered_probe  <- gathered_probe_count (_probe_kernel_for/_probe_body,
//                           radix.py:577-654)
//
// Contract: R and S are partitioned by kernel 1 with one geometry (the
// reference's low-bit radix: bucket = key & (F - 1), PAD in the pad category
// F); starts[c][b] is the offset of bucket b's run in chunk c.  The result is
// the number of (r, s) pairs with equal keys, each S key counting its key's
// multiplicity in R.  A bucket whose R holds more than r_cap keys is not
// probed and sets the overflow word, as the JAX package returned its
// overflow flag when a bucket's R exceeded its R_SEGS gather segments.
//
// Design: one CTA per bucket.  The TPU gathered 8-row segments of every run
// through descriptors built on the host, sorted R and S together by a
// composite (valid, key >> bits, side) code in VMEM with its split network,
// and counted with a segmented scan.  Here the CTA reads each chunk's run
// bounds from starts directly (no descriptors):
//   1. stage: tiles of blockDim chunks; a block scan of the run lengths
//      gives each run's offset, and warps copy runs into shared memory
//      (r_cap int32 keys: 160 KiB at the default 40,960);
//   2. sort the staged keys with a bitonic network in the all-ascending
//      form (flip, then half-cleaners), whose comparators always put the
//      smaller key at the lower index, so the missing keys past n act as
//      +inf that never move and comparators reaching them are skipped;
//   3. probe: each warp takes S chunks in turn, its lanes the run's keys;
//      a key's matches are upper_bound - lower_bound by binary search.
//      Counts are 64-bit, block-reduced, one atomic per block.
// Bound: the function reads the R and S streams once (bytes bind); the sort's
// comparisons and the two binary searches of every S key are this design's
// own cost beyond it.  Shared memory caps a CTA per SM at r_cap (the
// wrapper's R_CAP); sizing it to the largest bucket is the known next step.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;

__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* a, int lo, int n, int key) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void order(int* keys, int a, int b, int n) {
  if (b < n) {
    const int x = keys[a], y = keys[b];
    if (x > y) { keys[a] = y; keys[b] = x; }
  }
}

// Ascending bitonic sort of keys[0, n) in shared memory (n <= npow, a power
// of two); the block must call it uniformly.
__device__ void bitonic_sort(int* keys, int n) {
  int npow = 1;
  while (npow < n) npow <<= 1;
  for (int k = 2; k <= npow; k <<= 1) {
    const int half = k >> 1;
    for (int p = threadIdx.x; p < npow / 2; p += kThreads) {   // flip
      const int a = ((p & ~(half - 1)) << 1) | (p & (half - 1));
      order(keys, a, a ^ (k - 1), n);
    }
    __syncthreads();
    for (int j = half >> 1; j > 0; j >>= 1) {                  // half-cleaners
      for (int p = threadIdx.x; p < npow / 2; p += kThreads) {
        const int a = ((p & ~(j - 1)) << 1) | (p & (j - 1));   // bit j clear
        order(keys, a, a + j, n);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gathered_probe_kernel(const int* __restrict__ r, const int* __restrict__ r_starts,
                      long long r_nchunks, const int* __restrict__ s,
                      const int* __restrict__ s_starts, long long s_nchunks,
                      int chunk_elems, int cat_words, int r_cap,
                      unsigned long long* __restrict__ out) {
  extern __shared__ int keys[];                 // r_cap staged R keys
  __shared__ int t_start[kThreads], t_off[kThreads], t_len[kThreads];
  using Scan = cub::BlockScan<int, kThreads>;
  using Reduce = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ typename Reduce::TempStorage red_tmp;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  // 1. stage bucket b's R runs; n counts every key, writes stop at r_cap
  long long n = 0;
  for (long long base = 0; base < r_nchunks; base += kThreads) {
    const long long c = base + threadIdx.x;
    int len = 0, start = 0;
    if (c < r_nchunks) {
      const int* st = r_starts + c * cat_words;
      start = st[b];
      len = st[b + 1] - st[b];
    }
    int off, agg;                               // a tile's runs: < 2^31 keys
    Scan(scan_tmp).ExclusiveSum(len, off, agg);
    t_start[threadIdx.x] = start;
    t_off[threadIdx.x] = (int)min(n + off, (long long)r_cap);
    t_len[threadIdx.x] = len;
    __syncthreads();
    const int ntile = (int)min((long long)kThreads, r_nchunks - base);
    for (int i = warp; i < ntile; i += kWarps) {
      const int o = t_off[i], len_i = t_len[i];
      const int* src = r + (base + i) * chunk_elems + t_start[i];
      for (int e = lane; e < len_i && o + e < r_cap; e += kWarp) keys[o + e] = src[e];
    }
    n += agg;
    __syncthreads();
  }
  if (n > r_cap) {                              // uniform: n is the block's sum
    if (threadIdx.x == 0) atomicExch(out + 1, 1ull);
    return;
  }
  if (n == 0) return;

  // 2. sort
  bitonic_sort(keys, (int)n);

  // 3. probe bucket b's S runs
  unsigned long long count = 0;
  for (long long c = warp; c < s_nchunks; c += kWarps) {
    const int* st = s_starts + c * cat_words;
    const int lo = st[b], hi = st[b + 1];
    const int* src = s + c * chunk_elems;
    for (int i = lo + lane; i < hi; i += kWarp) {
      const int key = src[i];
      const int first = lower_bound(keys, (int)n, key);
      if (first < n && keys[first] == key)
        count += upper_bound(keys, first, (int)n, key) - first;
    }
  }
  const unsigned long long total = Reduce(red_tmp).Sum(count);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

}  // namespace

extern "C" {

// r, s: r_nchunks / s_nchunks chunks of chunk_elems int32 keys partitioned
// by kernel 1 with F = 2^part_bits buckets and the pad category; r_starts,
// s_starts: their starts tables, cat_words int32 a chunk; out: two uint64
// words (count, overflow 0/1), overwritten.  Shared memory: r_cap * 4 bytes.
int hbrj_gathered_probe(const int* r, const int* r_starts, long long r_nchunks,
                        const int* s, const int* s_starts, long long s_nchunks,
                        int chunk_elems, int cat_words, int part_bits, int r_cap,
                        unsigned long long* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), stream);
  if (err) return (int)err;
  const int smem = r_cap * (int)sizeof(int);
  if ((err = cudaFuncSetAttribute(gathered_probe_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return (int)err;
  gathered_probe_kernel<<<1u << part_bits, kThreads, smem, stream>>>(
      r, r_starts, r_nchunks, s, s_starts, s_nchunks, chunk_elems, cat_words, r_cap,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
