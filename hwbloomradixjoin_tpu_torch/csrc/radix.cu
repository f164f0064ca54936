// Radix partition and survivor compaction of int32 key columns (Hopper, sm_90a).
//
// Replaces the Pallas kernels of hwbloomradixjoin_tpu/ops/radix.py:
//   hbrj_partition  <- partition_pass    (_partition_kernel_for, radix.py:428)
//                      partition_pass_kv (the same body with a payload, radix.py:519)
//                      hash mode         (the bloom filter's block, radix.py:435-443)
//   hbrj_compact    <- compact_pass      (_compact_kernel_for,   radix.py:281)
//
// Contract (identical to the TPU kernels, checked bit-for-bit against the
// plain PyTorch twins in ops/radix.py):
//   * keys arrive as nchunks chunks of chunk_elems int32 each;
//   * category: range mode ((key - lo) >>> shift) & (F - 1), PAD and keys
//     outside [lo, hi] to F when the pad category is kept; hash mode the top
//     part_bits of the block index crc32c(seed, key) & (2^hash_bits - 1), PAD
//     to F;
//   * partition: each chunk is reordered by category, stably (elements of one
//     category keep their input order), and starts[c][j] = number of elements
//     of chunk c whose category is < j, for every j < cat_words; an optional
//     payload column moves by the same permutation (pays_out[pos] = pays[i]
//     beside out[pos] = keys[i]), which adds one read and one write stream;
//   * compact: each chunk's keys in [lo, hi] move to its head, stably, the rest
//     of its first cap_elems slots is PAD, and all 8*128 count words of the
//     chunk hold its live count.
//
// What bounds them here: both are streams over device memory (partition reads
// the keys twice and writes them once; compaction reads once and writes the
// survivors).  The TPU needed a log-shift split network per category bit
// because its vector unit has no scatter; Hopper scatters directly, so the
// partition is the classic histogram / scan / scatter.  Stability is kept
// without atomics on the output: each warp owns one contiguous tile of a chunk
// and walks it in order, 32 keys at a time, ranking equal categories inside a
// step with __match_any_sync; the per-tile histograms are scanned in
// (category, tile) order, so the tile order is the input order.  Many warps
// per chunk (one per 4096-key tile at the default chunk of 2^19 keys) keep all
// SMs busy even for the 32 chunks of a 16M-key build side.
//
// Hash mode costs a crc32c a key in both the histogram and the scatter: four
// dependent lookups in a 1 KiB shared-memory table.
//
// Compaction runs one CTA per chunk that streams its chunk in order with a
// block-wide scan.  It only ever runs on the probe side (hundreds of chunks),
// so one CTA per chunk fills the card.

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kPadKey = INT32_MIN;
constexpr int kWarp = 32;
constexpr int kTileWarps = 4;       // warps (= tiles) per partition CTA
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kCompactThreads = 512;
constexpr int kCompactItems = 8;    // two int4 loads per thread and step

constexpr int kCrcWords = 256;      // shared crc32c table ahead of the counters

struct CatParams {
  int lo, hi, has_hi, shift, F, pad_cat;
  int hash;                        // hash mode: the fields below
  unsigned seed, hmask;            // crc32c seed, 2^hash_bits - 1
  int hshift;                      // hash_bits - part_bits
};

// bucket-of-key of the geometry (radix.py geom_cat_fn).  Range mode: a
// LOGICAL shift of the wrapped key - lo; PAD and out-of-range keys take
// category F when the pad category is kept.  Hash mode: the top bits of the
// filter block, PAD to F.
__device__ __forceinline__ int category(int key, const CatParams p,
                                        const unsigned* crc_table) {
  if (p.hash) {
    if (key == kPadKey) return p.F;
    return (int)((hbrj::crc32c(crc_table, p.seed, key) & p.hmask) >> p.hshift);
  }
  unsigned norm = (unsigned)key - (unsigned)p.lo;
  int bucket = (int)((norm >> p.shift) & (unsigned)(p.F - 1));
  if (!p.pad_cat) return bucket;
  bool valid = key != kPadKey;
  if (p.has_hi) valid = valid && key >= p.lo && key <= p.hi;
  return valid ? bucket : p.F;
}

// Per-tile category histogram, written category-major: hist[c][cat][t].
__global__ void partition_hist(const int* __restrict__ keys, int* __restrict__ hist,
                               long long ntiles_total, int ntiles, int tile,
                               int ncats, CatParams p) {
  extern __shared__ int smem[];
  unsigned* crc_table = reinterpret_cast<unsigned*>(smem);
  if (p.hash) {                    // uniform over the block
    hbrj::crc32c_table_init(crc_table);
    __syncthreads();
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long gt = (long long)blockIdx.x * kTileWarps + warp;
  if (gt >= ntiles_total) return;
  int* cnt = smem + kCrcWords + warp * ncats;
  for (int i = lane; i < ncats; i += kWarp) cnt[i] = 0;
  __syncwarp();
  const int* src = keys + gt * tile;
  for (int base = 0; base < tile; base += 4 * kWarp) {
    int k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = src[base + j * kWarp + lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cat = category(k[j], p, crc_table);
      const unsigned peers = __match_any_sync(0xffffffffu, cat);
      if (lane == __ffs(peers) - 1) cnt[cat] += __popc(peers);
      __syncwarp();
    }
  }
  const long long c = gt / ntiles;
  const int t = (int)(gt % ntiles);
  int* h = hist + c * (long long)ncats * ntiles + t;
  for (int i = lane; i < ncats; i += kWarp) h[(long long)i * ntiles] = cnt[i];
}

// One CTA per chunk: exclusive scan of hist[c] in (category, tile) order, in
// place, then the chunk's starts table.
__global__ void partition_scan(int* __restrict__ hist, int* __restrict__ starts,
                               int ncats, int ntiles, int chunk_elems, int cat_words) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage temp;
  const long long c = blockIdx.x;
  int* h = hist + c * (long long)ncats * ntiles;
  const int total = ncats * ntiles;
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
  int* st = starts + c * (long long)cat_words;
  for (int j = threadIdx.x; j < cat_words; j += kScanThreads)
    st[j] = j < ncats ? h[(long long)j * ntiles] : chunk_elems;
}

// Stable scatter: each warp replays its tile in the same order as
// partition_hist, starting every category at the tile's scanned offset.
__global__ void partition_scatter(const int* __restrict__ keys,
                                  const int* __restrict__ pays,
                                  const int* __restrict__ offs, int* __restrict__ out,
                                  int* __restrict__ pays_out,
                                  long long ntiles_total, int ntiles, int tile,
                                  int ncats, int chunk_elems, CatParams p) {
  extern __shared__ int smem[];
  unsigned* crc_table = reinterpret_cast<unsigned*>(smem);
  if (p.hash) {                    // uniform over the block
    hbrj::crc32c_table_init(crc_table);
    __syncthreads();
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long gt = (long long)blockIdx.x * kTileWarps + warp;
  if (gt >= ntiles_total) return;
  const long long c = gt / ntiles;
  const int t = (int)(gt % ntiles);
  int* cnt = smem + kCrcWords + warp * ncats;
  const int* o = offs + c * (long long)ncats * ntiles + t;
  for (int i = lane; i < ncats; i += kWarp) cnt[i] = o[(long long)i * ntiles];
  __syncwarp();
  const int* src = keys + gt * tile;
  int* dst = out + c * chunk_elems;
  const int* psrc = pays ? pays + gt * tile : nullptr;
  int* pdst = pays ? pays_out + c * chunk_elems : nullptr;
  const unsigned earlier = (1u << lane) - 1u;
  for (int base = 0; base < tile; base += 4 * kWarp) {
    int k[4], v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = src[base + j * kWarp + lane];
    if (psrc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = psrc[base + j * kWarp + lane];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cat = category(k[j], p, crc_table);
      const unsigned peers = __match_any_sync(0xffffffffu, cat);
      const int pos = cnt[cat] + __popc(peers & earlier);
      __syncwarp();
      if (lane == __ffs(peers) - 1) cnt[cat] += __popc(peers);
      __syncwarp();
      dst[pos] = k[j];
      if (pdst) pdst[pos] = v[j];
    }
  }
}

__global__ void compact_kernel(const int* __restrict__ keys, int* __restrict__ out,
                               int* __restrict__ counts, int chunk_elems,
                               int cap_elems, int lo, int hi) {
  using Scan = cub::BlockScan<int, kCompactThreads>;
  __shared__ typename Scan::TempStorage temp;
  const long long c = blockIdx.x;
  const int* src = keys + c * chunk_elems;
  int* dst = out + c * cap_elems;
  int carry = 0;
  for (int base = 0; base < chunk_elems; base += kCompactThreads * kCompactItems) {
    const int idx = base + threadIdx.x * kCompactItems;
    int key[kCompactItems], live[kCompactItems], pos[kCompactItems];
    // chunk_elems is a multiple of 128, so a thread's items are all in or all out
    const bool in = idx < chunk_elems;
#pragma unroll
    for (int q = 0; q < kCompactItems / 4; ++q) {
      int4 v = in ? *reinterpret_cast<const int4*>(src + idx + 4 * q)
                  : make_int4(kPadKey, kPadKey, kPadKey, kPadKey);
      key[4 * q] = v.x; key[4 * q + 1] = v.y; key[4 * q + 2] = v.z; key[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j)
      live[j] = in && key[j] >= lo && key[j] <= hi;
    int agg;
    Scan(temp).ExclusiveSum(live, pos, agg);
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      const int q = carry + pos[j];
      if (live[j] && q < cap_elems) dst[q] = key[j];
    }
    carry += agg;
    __syncthreads();
  }
  for (int q = carry + threadIdx.x; q < cap_elems; q += kCompactThreads) dst[q] = kPadKey;
  int* cnt = counts + c * 8 * 128;
  for (int i = threadIdx.x; i < 8 * 128; i += kCompactThreads) cnt[i] = carry;
}

}  // namespace

extern "C" {

const char* hbrj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys: nchunks*chunk_elems int32; out: same size; starts: nchunks*cat_words;
// hist: nchunks * ncats * (chunk_elems / tile) int32 scratch.
// pays, pays_out: a payload column moved with the keys (same size), or both
// null.  tile must divide chunk_elems and be a multiple of 128.  hash != 0
// selects hash mode (seed, hash_bits; lo, hi, has_hi and shift unused).
int hbrj_partition(const int* keys, const int* pays, int* out, int* pays_out,
                   int* starts, int* hist,
                   long long nchunks, int chunk_elems, int tile, int lo, int hi,
                   int has_hi, int shift, int part_bits, int pad_cat, int cat_words,
                   int hash, unsigned seed, int hash_bits, cudaStream_t stream) {
  if (nchunks == 0) return 0;
  const unsigned hmask = hash_bits >= 32 ? 0xFFFFFFFFu : (1u << hash_bits) - 1u;
  const CatParams p{lo, hi, has_hi, shift, 1 << part_bits, pad_cat,
                    hash, seed, hmask, hash_bits - part_bits};
  const int ncats = p.F + (pad_cat ? 1 : 0);
  const int ntiles = chunk_elems / tile;
  const long long ntiles_total = nchunks * ntiles;
  const int smem = (kCrcWords + kTileWarps * ncats) * (int)sizeof(int);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(partition_hist,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return (int)err;
  if ((err = cudaFuncSetAttribute(partition_scatter,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return (int)err;
  const unsigned grid = (unsigned)((ntiles_total + kTileWarps - 1) / kTileWarps);
  partition_hist<<<grid, kTileWarps * kWarp, smem, stream>>>(
      keys, hist, ntiles_total, ntiles, tile, ncats, p);
  if ((err = cudaGetLastError())) return (int)err;
  partition_scan<<<(unsigned)nchunks, kScanThreads, 0, stream>>>(
      hist, starts, ncats, ntiles, chunk_elems, cat_words);
  if ((err = cudaGetLastError())) return (int)err;
  partition_scatter<<<grid, kTileWarps * kWarp, smem, stream>>>(
      keys, pays, hist, out, pays_out, ntiles_total, ntiles, tile, ncats, chunk_elems,
      p);
  return (int)cudaGetLastError();
}

// keys: nchunks*chunk_elems int32 (16-byte aligned); out: nchunks*cap_elems;
// counts: nchunks*8*128.
int hbrj_compact(const int* keys, int* out, int* counts, long long nchunks,
                 int chunk_elems, int cap_elems, int lo, int hi, cudaStream_t stream) {
  if (nchunks == 0) return 0;
  compact_kernel<<<(unsigned)nchunks, kCompactThreads, 0, stream>>>(
      keys, out, counts, chunk_elems, cap_elems, lo, hi);
  return (int)cudaGetLastError();
}

}  // extern "C"
