// Two-pass radix partitioning, pass 2 (Hopper, sm_90a).
//
// Replaces the Pallas kernel of hwbloomradixjoin_tpu/ops/multipass.py:
//   hbrj_pass2_partition <- pass2_partition (_pass2_kernel_for, multipass.py:69)
//
// Contract (identical to the TPU kernel's, checked against the plain PyTorch
// twin ops/multipass.py pass2_partition_plain on the card):
//   * the input is pass 1's output: nchunks chunks, each bucket-major by the
//     high b1 bits, with starts1 (suffix-filled, cat_words1 words a chunk);
//   * for each pass-1 bucket b, the keys of b are taken chunk by chunk in
//     chunk order and, within a chunk, in order, and split stably by the
//     sub-category of the next b2 bits into region b of cap_elems keys:
//     live keys first, PAD after;
//       range mode: a key is b's when ((key - lo) >> shift1) == b, an
//       ARITHMETIC shift of the wrapped difference, taken over the window the
//       TPU kernel gathers (c1_rows rows from row min(starts1[t][b] >> 7,
//       chunk_rows - c1_rows) of chunk t), so keys above hi inside b's bucket
//       and in its window count as the TPU kernel counts them; sub-category
//       ((key - lo) >>> shift2) & (F2 - 1);
//       hash mode: a key is b's when its block crc32c(seed, key) & hmask has
//       top bits b (exactly b's pass-1 run, so the run is read, not the
//       window); sub-category (block >> (hash_bits - b1 - b2)) & (F2 - 1);
//     PAD is never live;
//   * starts2[b][j] = live keys of b with sub-category < j for j <= F2, and
//     the TPU gather buffer's size nchunks * c1_rows * 128 past F2 (what the
//     TPU kernel's suffix fill over its buffer gives);
//   * region b holds min(live, cap_elems) keys, then PAD.
//
// What bounds it here: a stream over device memory (pass-1 output read
// twice, regions written once).  The TPU gathered every chunk's window into
// VMEM and ran its split network over the buffer; Hopper reads the runs in
// place.  The design is the partition kernel's (radix.cu) with segments in
// place of tiles: one warp per (bucket, chunk) segment counts its
// sub-categories (hist[b][cat][t]), one CTA per bucket scans its counts in
// (cat, chunk) order, and the warps replay their segments with
// __match_any_sync ranks into the scanned offsets, which keeps the order
// stable without atomics on the output.

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kPadKey = INT32_MIN;
constexpr int kWarp = 32;
constexpr int kSegWarps = 4;        // warps (= segments) per CTA
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kCrcWords = 256;

struct P2Params {
  const int* s1;                   // pass-1 keys
  const int* starts1;              // pass-1 starts, cat_words1 a chunk
  int nchunks, chunk_rows, c1_rows, cat_words1;
  int F1, F2;
  int hash;                        // hash mode: seed, hmask, hshift1, hshift2
  unsigned seed, hmask;
  int hshift1, hshift2;            // hash_bits - b1, hash_bits - b1 - b2
  int lo, shift1, shift2;          // range mode
};

// [begin, end) of segment (b, t) in the flat pass-1 keys.
__device__ __forceinline__ void segment(const P2Params& p, int b, int t,
                                        long long& begin, long long& end) {
  const int* st = p.starts1 + (long long)t * p.cat_words1;
  const long long base = (long long)t * p.chunk_rows * 128;
  if (p.hash) {
    begin = base + st[b];
    end = base + st[b + 1];
  } else {
    const int r0 = min(st[b] >> 7, p.chunk_rows - p.c1_rows);
    begin = base + (long long)r0 * 128;
    end = begin + (long long)p.c1_rows * 128;
  }
}

// Sub-category of a key in region b, or -1 when it is not a live key of b.
__device__ __forceinline__ int subcat(int key, int b, const P2Params& p,
                                      const unsigned* crc_table) {
  if (key == kPadKey) return -1;
  if (p.hash) {
    const unsigned block = hbrj::crc32c(crc_table, p.seed, key) & p.hmask;
    if ((int)(block >> p.hshift1) != b) return -1;
    return (int)((block >> p.hshift2) & (unsigned)(p.F2 - 1));
  }
  const int norm = (int)((unsigned)key - (unsigned)p.lo);
  if ((norm >> p.shift1) != b) return -1;
  return (int)(((unsigned)norm >> p.shift2) & (unsigned)(p.F2 - 1));
}

// Per-segment sub-category histogram, written hist[b][cat][t].
__global__ void pass2_hist(P2Params p, int* __restrict__ hist) {
  extern __shared__ int smem[];
  unsigned* crc_table = reinterpret_cast<unsigned*>(smem);
  if (p.hash) {                    // uniform over the block
    hbrj::crc32c_table_init(crc_table);
    __syncthreads();
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long gw = (long long)blockIdx.x * kSegWarps + warp;
  if (gw >= (long long)p.F1 * p.nchunks) return;
  const int b = (int)(gw / p.nchunks), t = (int)(gw % p.nchunks);
  int* cnt = smem + kCrcWords + warp * p.F2;
  for (int i = lane; i < p.F2; i += kWarp) cnt[i] = 0;
  __syncwarp();
  long long begin, end;
  segment(p, b, t, begin, end);
  for (long long base = begin; base < end; base += 4 * kWarp) {
    int k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = base + j * kWarp + lane;
      k[j] = i < end ? __ldg(p.s1 + i) : kPadKey;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = subcat(k[j], b, p, crc_table);
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      if (c >= 0 && lane == __ffs(peers) - 1) cnt[c] += __popc(peers);
      __syncwarp();
    }
  }
  int* h = hist + (long long)b * p.F2 * p.nchunks + t;
  for (int i = lane; i < p.F2; i += kWarp) h[(long long)i * p.nchunks] = cnt[i];
}

// One CTA per region: exclusive scan of hist[b] in (cat, chunk) order, in
// place; then starts2[b] and the PAD tail of the region.
__global__ void pass2_scan(int* __restrict__ hist, int* __restrict__ starts2,
                           int* __restrict__ out, int F2, int nchunks,
                           int cat2_words, long long cap_elems, int gbuf_elems) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage temp;
  const long long b = blockIdx.x;
  int* h = hist + b * F2 * (long long)nchunks;
  const int total = F2 * nchunks;
  int carry = 0;
  for (int base = 0; base < total; base += kScanThreads * kScanItems) {
    int v[kScanItems];
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int idx = base + threadIdx.x * kScanItems + j;
      v[j] = idx < total ? h[idx] : 0;
    }
    int agg;
    Scan(temp).ExclusiveSum(v, v, agg);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int idx = base + threadIdx.x * kScanItems + j;
      if (idx < total) h[idx] = v[j] + carry;
    }
    carry += agg;
    __syncthreads();
  }
  int* st = starts2 + b * cat2_words;
  for (int j = threadIdx.x; j < cat2_words; j += kScanThreads)
    st[j] = j < F2 ? h[(long long)j * nchunks] : (j == F2 ? carry : gbuf_elems);
  int* region = out + b * cap_elems;
  for (long long q = min((long long)carry, cap_elems) + threadIdx.x; q < cap_elems;
       q += kScanThreads)
    region[q] = kPadKey;
}

// Stable scatter: each warp replays its segment as pass2_hist did, starting
// every sub-category at the scanned offset of (cat, chunk).
__global__ void pass2_scatter(P2Params p, const int* __restrict__ offs,
                              int* __restrict__ out, long long cap_elems) {
  extern __shared__ int smem[];
  unsigned* crc_table = reinterpret_cast<unsigned*>(smem);
  if (p.hash) {                    // uniform over the block
    hbrj::crc32c_table_init(crc_table);
    __syncthreads();
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long gw = (long long)blockIdx.x * kSegWarps + warp;
  if (gw >= (long long)p.F1 * p.nchunks) return;
  const int b = (int)(gw / p.nchunks), t = (int)(gw % p.nchunks);
  int* cnt = smem + kCrcWords + warp * p.F2;
  const int* o = offs + (long long)b * p.F2 * p.nchunks + t;
  for (int i = lane; i < p.F2; i += kWarp) cnt[i] = o[(long long)i * p.nchunks];
  __syncwarp();
  int* region = out + (long long)b * cap_elems;
  const unsigned earlier = (1u << lane) - 1u;
  long long begin, end;
  segment(p, b, t, begin, end);
  for (long long base = begin; base < end; base += 4 * kWarp) {
    int k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = base + j * kWarp + lane;
      k[j] = i < end ? __ldg(p.s1 + i) : kPadKey;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = subcat(k[j], b, p, crc_table);
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      const int pos = c >= 0 ? cnt[c] + __popc(peers & earlier) : 0;
      __syncwarp();
      if (c >= 0 && lane == __ffs(peers) - 1) cnt[c] += __popc(peers);
      __syncwarp();
      if (c >= 0 && pos < cap_elems) region[pos] = k[j];
    }
  }
}

}  // namespace

extern "C" {

// s1: pass-1 keys, nchunks * chunk_rows * 128; starts1: nchunks * cat_words1;
// out: F1 * cap_elems; starts2: F1 * cat2_words; hist: F1 * F2 * nchunks
// int32 scratch.  hash != 0 selects hash mode (seed, hash_bits), else range
// mode (lo, shift1, shift2).
int hbrj_pass2_partition(const int* s1, const int* starts1, int* out, int* starts2,
                         int* hist, int nchunks, int chunk_rows, int c1_rows,
                         int cat_words1, int b1, int b2, long long cap_elems,
                         int cat2_words, int hash, unsigned seed, int hash_bits,
                         int lo, int shift1, int shift2, cudaStream_t stream) {
  const int F1 = 1 << b1, F2 = 1 << b2;
  if (nchunks == 0) return 0;
  const unsigned hmask = hash_bits >= 32 ? 0xFFFFFFFFu : (1u << hash_bits) - 1u;
  const P2Params p{s1, starts1, nchunks, chunk_rows, c1_rows, cat_words1, F1, F2,
                   hash, seed, hmask, hash_bits - b1, hash_bits - b1 - b2,
                   lo, shift1, shift2};
  const int smem = (kCrcWords + kSegWarps * F2) * (int)sizeof(int);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(pass2_hist,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return (int)err;
  if ((err = cudaFuncSetAttribute(pass2_scatter,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return (int)err;
  const long long nseg = (long long)F1 * nchunks;
  const unsigned grid = (unsigned)((nseg + kSegWarps - 1) / kSegWarps);
  pass2_hist<<<grid, kSegWarps * kWarp, smem, stream>>>(p, hist);
  if ((err = cudaGetLastError())) return (int)err;
  pass2_scan<<<(unsigned)F1, kScanThreads, 0, stream>>>(
      hist, starts2, out, F2, nchunks, cat2_words, cap_elems,
      nchunks * c1_rows * 128);
  if ((err = cudaGetLastError())) return (int)err;
  pass2_scatter<<<grid, kSegWarps * kWarp, smem, stream>>>(p, hist, out, cap_elems);
  return (int)cudaGetLastError();
}

}  // extern "C"
