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
// What bounds it here: in principle bytes (pass-1 output read twice, the
// regions written once); in practice the ranking's instructions, as in the
// partition (radix.cu).  The TPU gathered every chunk's window into VMEM and
// ran its split network over the buffer; here the design is the partition's
// three steps with a region in place of a chunk:
//   * region b's input is its segment (range: window; hash: run) in every
//     chunk, in chunk order: one stream of keys.  A CTA owns a span of it,
//     the segments of `group` consecutive chunks (about kSpanKeys keys:
//     group from the window length, or in hash mode from the mean run
//     chunk_elems / F1), and reads it in 4,096-key tiles.  Warp 0 builds the
//     span's table of segment starts and offsets from starts1 (a warp scan
//     of the lengths); a thread's first item of a tile finds its segment by
//     a binary search of that table in shared memory, its later items step
//     forward from there, so tiles cross segment boundaries and only a
//     span's last tile is partial;
//   * pass2_hist counts each span's sub-categories with shared-memory
//     atomics (hist[b][cat][span]); pass2_scan, one CTA a region, scans them
//     in (sub-category, span) order, in place, and writes starts2;
//   * pass2_scatter replays its span tile by tile: rejected keys (PAD, other
//     buckets' keys in a window) take the reject digit F2, ranked beside the
//     others and dropped; the tile is ranked stably by tile_rank.cuh (shared
//     with the partition: one ballot a digit bit, b2 + 1 bits), staged in
//     shared memory in digit order beside each key's region slot, and
//     written out run by run, only slots below cap_elems; the region's
//     CTAs share its PAD tail (16-byte stores: one CTA a region, 64 at 4d,
//     would leave most of the card idle).  Each
//     sub-category's next slot is carried from tile to tile in a register
//     of the thread that scans it, so the span's order is input order.
// Hash mode computes the crc32c of each key once in each of the two kernels
// (a 1 KiB shared-memory table), over the run, never a window.

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "tile_rank.cuh"

namespace {

using hbrj::kTile;
using hbrj::kTileItems;
using hbrj::kTileThreads;
using hbrj::kTileWarps;
using hbrj::kWarp;
using hbrj::kWarpKeys;

constexpr int kPadKey = INT32_MIN;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kCrcWords = 256;
constexpr int kMaxGroup = kWarp;        // chunks a span (one warp builds its table)
constexpr int kSpanKeys = 10 * kTile;   // keys a span, aimed at
constexpr int kMaxB2 = 10;              // widest sub-category (F2 + 1 <= 1,025 digits)

struct P2Params {
  const int* s1;                   // pass-1 keys
  const int* starts1;              // pass-1 starts, cat_words1 a chunk
  int nchunks, chunk_rows, c1_rows, cat_words1;
  int F1, F2;
  int group, ngroups;              // chunks a span, spans a region
  int hash;                        // hash mode: seed, hmask, hshift1, hshift2
  unsigned seed, hmask;
  int hshift1, hshift2;            // hash_bits - b1, hash_bits - b1 - b2
  int lo, shift1, shift2;          // range mode
};

// A CTA's span of region b: the segments of chunks [g * group, ...).
struct Span {
  int off[kMaxGroup + 1];          // span position of each segment's first key;
                                   // the span's length after the last, INT_MAX past
  long long begin[kMaxGroup];      // each segment's first key in the pass-1 keys
  int len;                         // keys of the span
  int steps;                       // binary-search steps over off
};

// Warp 0 fills the span table of (b, g); the block then synchronises.
__device__ __forceinline__ void load_span(const P2Params& p, int b, int g, Span& sp) {
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    const int nseg = min(p.group, p.nchunks - g * p.group);   // >= 1
    long long begin = 0;
    int len = 0;
    if (lane < nseg) {
      const long long t = (long long)g * p.group + lane;
      const int* st = p.starts1 + t * p.cat_words1;
      const long long base = t * p.chunk_rows * 128;
      if (p.hash) {
        const int first = __ldg(st + b);
        begin = base + first;
        len = __ldg(st + b + 1) - first;
      } else {
        const int r0 = min(__ldg(st + b) >> 7, p.chunk_rows - p.c1_rows);
        begin = base + (long long)r0 * 128;
        len = p.c1_rows * 128;
      }
    }
    int incl = len;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    sp.begin[lane] = begin;
    sp.off[lane + 1] = lane < nseg ? incl : INT_MAX;
    if (lane == 0) {
      int steps = 0;
      while ((1 << steps) < nseg) ++steps;
      sp.off[0] = 0;
      sp.steps = steps;
    }
    if (lane == nseg - 1) sp.len = incl;
  }
  __syncthreads();
}

// The tile at span position s0, warp-major (tile_rank.cuh's layout); PAD
// past the span's end.  A thread's items ascend, so its first one finds its
// segment by a binary search of the span table (the last segment whose
// offset is <= v: empty segments share their successor's offset) and the
// others step forward from there.
__device__ __forceinline__ void load_tile(const P2Params& p, const Span& sp, int s0,
                                          int (&key)[kTileItems]) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int v0 = s0 + warp * kWarpKeys + lane;
  int k = 0;
  if (v0 < sp.len)
    for (int step = (1 << sp.steps) >> 1; step > 0; step >>= 1)
      if (sp.off[k + step] <= v0) k += step;
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int v = v0 + j * kWarp;
    key[j] = kPadKey;
    if (v < sp.len) {
      while (sp.off[k + 1] <= v) ++k;
      key[j] = __ldg(p.s1 + sp.begin[k] + (v - sp.off[k]));
    }
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

// Per-span sub-category histogram, written hist[b][cat][g].
__global__ void __launch_bounds__(kTileThreads)
pass2_hist(P2Params p, int* __restrict__ hist) {
  extern __shared__ int smem[];
  __shared__ Span span;
  unsigned* crc_table = reinterpret_cast<unsigned*>(smem);
  int* cnt = smem + kCrcWords;
  const int b = blockIdx.x / p.ngroups, g = blockIdx.x % p.ngroups;
  if (p.hash) hbrj::crc32c_table_init(crc_table);   // uniform over the block
  for (int d = threadIdx.x; d < p.F2; d += kTileThreads) cnt[d] = 0;
  load_span(p, b, g, span);
  for (int s0 = 0; s0 < span.len; s0 += kTile) {
    int key[kTileItems];
    load_tile(p, span, s0, key);
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      const int c = subcat(key[j], b, p, crc_table);
      if (c >= 0) atomicAdd(cnt + c, 1);
    }
  }
  __syncthreads();
  int* h = hist + (long long)b * p.F2 * p.ngroups + g;
  for (int d = threadIdx.x; d < p.F2; d += kTileThreads) h[(long long)d * p.ngroups] = cnt[d];
}

// One CTA per region: exclusive scan of hist[b] in (cat, span) order, in
// place; then starts2[b].
__global__ void pass2_scan(int* __restrict__ hist, int* __restrict__ starts2, int F2,
                           int ngroups, int cat2_words, int gbuf_elems) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage temp;
  const long long b = blockIdx.x;
  int* h = hist + b * F2 * (long long)ngroups;
  const int total = F2 * ngroups;
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
    st[j] = j < F2 ? h[(long long)j * ngroups] : (j == F2 ? carry : gbuf_elems);
}

// CTA g of region b's share of the region's PAD tail [min(live, cap_elems),
// cap_elems): a scalar head up to a 16-byte boundary (CTA 0), then ngroups
// shares of 16-byte stores (cap_elems is a multiple of 128).
__device__ __forceinline__ void pad_tail(int* region, long long live, long long cap_elems,
                                         int g, int ngroups) {
  const long long tail = min(live, cap_elems);
  const long long aligned = min((tail + 3) & ~3LL, cap_elems);
  if (g == 0)
    for (long long q = tail + threadIdx.x; q < aligned; q += kTileThreads) region[q] = kPadKey;
  const long long n4 = (cap_elems - aligned) / 4;
  const long long share = (n4 + ngroups - 1) / ngroups;
  int4* r4 = reinterpret_cast<int4*>(region + aligned);
  const int4 pad = make_int4(kPadKey, kPadKey, kPadKey, kPadKey);
  for (long long q = g * share + threadIdx.x; q < min(n4, (g + 1) * share); q += kTileThreads)
    r4[q] = pad;
}

// Stable scatter of a span, tile by tile, from the scanned offsets of
// (cat, span).  NBITS: bits of the reject digit F2 (b2 + 1); DPT: digits a
// thread scans (F2 <= kTileThreads * DPT).
template <int NBITS, int DPT>
__global__ void __launch_bounds__(kTileThreads, hbrj::kScatterBlocks)
pass2_scatter(P2Params p, const int* __restrict__ offs, const int* __restrict__ starts2,
              int cat2_words, int* __restrict__ out, long long cap_elems) {
  extern __shared__ int smem[];
  __shared__ Span span;
  const int F2 = p.F2;
  unsigned* crc_table = reinterpret_cast<unsigned*>(smem);
  int* wcnt = smem + kCrcWords;                  // [kTileWarps][F2 + 1]
  int* delta = wcnt + kTileWarps * (F2 + 1);     // [F2]
  int* skey = delta + F2;                        // [kTile] live keys, digit order
  int* sslot = skey + kTile;                     // [kTile] their region slots
  const int b = blockIdx.x / p.ngroups, g = blockIdx.x % p.ngroups;
  if (p.hash) hbrj::crc32c_table_init(crc_table);   // uniform over the block
  // the next region slot of this thread's sub-categories, carried over tiles
  const int* o = offs + (long long)b * F2 * p.ngroups + g;
  int next[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int d = threadIdx.x * DPT + k;
    next[k] = d < F2 ? __ldg(o + (long long)d * p.ngroups) : 0;
  }
  load_span(p, b, g, span);
  int* region = out + (long long)b * cap_elems;
  pad_tail(region, __ldg(starts2 + (long long)b * cat2_words + F2), cap_elems, g, p.ngroups);
  const int warp = threadIdx.x / kWarp;
  int* cnt = wcnt + warp * (F2 + 1);
  for (int s0 = 0; s0 < span.len; s0 += kTile) {
    int key[kTileItems], dig[kTileItems], rank[kTileItems];
    hbrj::clear_counts(wcnt, F2 + 1);
    load_tile(p, span, s0, key);
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      const int c = subcat(key[j], b, p, crc_table);
      dig[j] = c < 0 ? F2 : c;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) rank[j] = hbrj::warp_rank<NBITS>(dig[j], cnt);
    __syncthreads();
    const int nlive = hbrj::scan_digits<DPT, true>(wcnt, F2 + 1, F2, next, delta);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTileItems; ++j) {
      if (dig[j] == F2) continue;
      const int pos = cnt[dig[j]] + rank[j];
      skey[pos] = key[j];
      sslot[pos] = delta[dig[j]] + pos;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nlive; i += kTileThreads) {
      const int q = sslot[i];
      if (q < cap_elems) region[q] = skey[i];
    }
    __syncthreads();
  }
}

template <int NBITS, int DPT>
cudaError_t launch_scatter(const P2Params& p, const int* offs, const int* starts2,
                           int cat2_words, int* out, long long cap_elems, int smem,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pass2_scatter<NBITS, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  pass2_scatter<NBITS, DPT><<<(unsigned)((long long)p.F1 * p.ngroups), kTileThreads, smem,
                              stream>>>(p, offs, starts2, cat2_words, out, cap_elems);
  return cudaGetLastError();
}

using ScatterLaunch = cudaError_t (*)(const P2Params&, const int*, const int*, int, int*,
                                      long long, int, cudaStream_t);
// by b2: the digits 0..F2 take b2 + 1 bits; F2 = 1,024 scans 2 digits a thread
constexpr ScatterLaunch kScatter[kMaxB2 + 1] = {
    launch_scatter<1, 1>, launch_scatter<2, 1>, launch_scatter<3, 1>,
    launch_scatter<4, 1>, launch_scatter<5, 1>, launch_scatter<6, 1>,
    launch_scatter<7, 1>, launch_scatter<8, 1>, launch_scatter<9, 1>,
    launch_scatter<10, 1>, launch_scatter<11, 2>};

}  // namespace

extern "C" {

// s1: pass-1 keys, nchunks * chunk_rows * 128; starts1: nchunks * cat_words1;
// out: F1 * cap_elems; starts2: F1 * cat2_words; hist: F1 * F2 * nchunks
// int32 scratch (a span holds at least one chunk).  hash != 0 selects hash
// mode (seed, hash_bits), else range mode (lo, shift1, shift2).  b2 <= 10.
int hbrj_pass2_partition(const int* s1, const int* starts1, int* out, int* starts2,
                         int* hist, int nchunks, int chunk_rows, int c1_rows,
                         int cat_words1, int b1, int b2, long long cap_elems,
                         int cat2_words, int hash, unsigned seed, int hash_bits,
                         int lo, int shift1, int shift2, cudaStream_t stream) {
  if (nchunks == 0) return 0;
  if (b2 < 0 || b2 > kMaxB2) return (int)cudaErrorInvalidValue;
  const int F1 = 1 << b1, F2 = 1 << b2;
  // chunks a span: about kSpanKeys keys of segments of the window's length
  // or, in hash mode, of the mean run
  const long long seg = hash ? (long long)chunk_rows * 128 / F1 : (long long)c1_rows * 128;
  long long group = kSpanKeys / (seg > 0 ? seg : 1);
  if (group > kMaxGroup) group = kMaxGroup;
  if (group > nchunks) group = nchunks;
  if (group < 1) group = 1;
  const int ngroups = (int)((nchunks + group - 1) / group);
  if ((long long)F1 * ngroups > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned hmask = hash_bits >= 32 ? 0xFFFFFFFFu : (1u << hash_bits) - 1u;
  const P2Params p{s1, starts1, nchunks, chunk_rows, c1_rows, cat_words1, F1, F2,
                   (int)group, ngroups, hash, seed, hmask, hash_bits - b1,
                   hash_bits - b1 - b2, lo, shift1, shift2};
  const int hist_smem = (kCrcWords + F2) * (int)sizeof(int);
  const int scatter_smem =
      (kCrcWords + kTileWarps * (F2 + 1) + F2 + 2 * kTile) * (int)sizeof(int);
  const unsigned grid = (unsigned)(F1 * ngroups);
  cudaError_t err;
  pass2_hist<<<grid, kTileThreads, hist_smem, stream>>>(p, hist);
  if ((err = cudaGetLastError())) return (int)err;
  pass2_scan<<<(unsigned)F1, kScanThreads, 0, stream>>>(
      hist, starts2, F2, ngroups, cat2_words, nchunks * c1_rows * 128);
  if ((err = cudaGetLastError())) return (int)err;
  return (int)kScatter[b2](p, hist, starts2, cat2_words, out, cap_elems, scatter_smem,
                           stream);
}

}  // extern "C"
