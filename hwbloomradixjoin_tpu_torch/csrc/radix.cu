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
// What bounds the partition here: in principle bytes (it must read the keys,
// and payloads, once and write them once); in practice instructions (below).
// Keys stored one by one from registers would leave partial 32-byte
// sectors: at 10-13 bits a 4,096-key tile holds a few keys, or under one,
// of each category.  Counters per warp and category would cap the width.
// The design:
//   * a CTA owns a 4,096-key tile of one chunk.  tile_hist counts the tile's
//     digits with 16-byte loads and shared-memory atomics and writes one
//     histogram of at most 257 words; chunk_scan scans the chunk's
//     histograms in (digit, tile) order, so tile order is input order (a
//     separate scan rather than a decoupled look-back: no CTA waits on
//     another, and one sweep reads the keys twice either way, once for the
//     chunk's counts); tile_scatter ranks the tile stably (tile_rank.cuh,
//     shared with pass 2 of multipass.cu: per-warp ranks from one
//     __ballot_sync a digit bit, which issues fewer instructions here than
//     __match_any_sync, a per-digit sum over the warps and a block scan),
//     stages it in shared memory in digit order beside each key's
//     slot, and writes it out with consecutive threads on consecutive slots
//     of one digit's run, so runs leave as whole sectors;
//   * up to kOneSweepMaxBits bits (at most 257 categories with the pad
//     category) the digit is the category: one sweep, and chunk_scan's
//     offsets of tile 0 are the starts;
//   * wider, the category is sorted by least-significant-digit passes of at
//     most kDigitBits bits, ping-ponging through a scratch buffer of the
//     input's size; stable passes compose, so the result is the same stable
//     partition.  The starts then come from the sorted output: the first
//     position of each category present is marked, and a per-chunk suffix
//     minimum fills the rest (starts_mark, starts_suffix_min);
//   * hash mode computes each key's category once (hash_cats: crc32c through
//     a 1 KiB shared-memory table) and carries it through the passes in a
//     category column; range mode recomputes its few integer operations.
// Scratch: one <= 257-word histogram a tile (128 KiB a 2^19-key chunk) and,
// past one sweep, a key (and payload) column, whatever the width.
// Measured on the H100 (PERF.md): the stores are not the limit (a build
// that skips them is as fast); the ranking's instructions are, about a
// hundred a key a pass, so a pass takes 1.1-1.4 ms per 128M keys and digit
// passes multiply it.
//
// Compaction runs one CTA per chunk that streams its chunk in order with a
// block-wide scan.  It only ever runs on the probe side (hundreds of chunks),
// so one CTA per chunk fills the card.

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
constexpr int kOneSweepMaxBits = 8;   // widest fan-out sorted in one sweep
constexpr int kDigitBits = 8;         // widest digit of the passes past it
constexpr int kMaxDigits = (1 << 8) + 1;   // 2^8 buckets + the pad category
constexpr int kMaxPasses = 4;
constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kStreamThreads = 256;
constexpr int kCompactThreads = 512;
constexpr int kCompactItems = 8;    // two int4 loads per thread and step

struct CatParams {
  int lo, hi, has_hi, shift, F, pad_cat;
  unsigned seed, hmask;            // hash mode: crc32c seed, 2^hash_bits - 1
  int hshift;                      // hash_bits - part_bits
};

// Range-mode bucket-of-key (radix.py geom_cat_fn): a LOGICAL shift of the
// wrapped key - lo; PAD and out-of-range keys take category F when the pad
// category is kept.
__device__ __forceinline__ int range_category(int key, const CatParams& p) {
  const unsigned norm = (unsigned)key - (unsigned)p.lo;
  const int bucket = (int)((norm >> p.shift) & (unsigned)(p.F - 1));
  if (!p.pad_cat) return bucket;
  bool valid = key != kPadKey;
  if (p.has_hi) valid = valid && key >= p.lo && key <= p.hi;
  return valid ? bucket : p.F;
}

// One digit pass over all chunks: the digit of a category is
// (cat >> dshift) & dmask, in [0, ndigits).  cats null: the range category
// of the key; cats_out null: the categories are not written.
struct Pass {
  const int* keys;
  const int* pays;
  const int* cats;
  int* keys_out;
  int* pays_out;
  int* cats_out;
  int dshift;
  unsigned dmask;
  int ndigits;
};

__device__ __forceinline__ int digit_of(int cat, const Pass& s) {
  return (int)(((unsigned)cat >> s.dshift) & s.dmask);
}

// Bits of the largest digit of a pass.
int digit_bits(int ndigits) {
  int nbits = 0;
  while ((1 << nbits) < ndigits) ++nbits;
  return nbits;
}

// Hash-mode category: the top bits of the filter block, PAD to F.
__device__ __forceinline__ int hash_category(int key, const CatParams& p,
                                             const unsigned* crc_table) {
  if (key == kPadKey) return p.F;
  return (int)((hbrj::crc32c(crc_table, p.seed, key) & p.hmask) >> p.hshift);
}

// Hash mode: every key's category, once (crc32c through a shared table).
__global__ void hash_cats(const int4* __restrict__ keys, int4* __restrict__ cats,
                          long long n4, CatParams p) {
  __shared__ unsigned crc_table[256];
  hbrj::crc32c_table_init(crc_table);
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int4 k = keys[i];
    cats[i] = make_int4(hash_category(k.x, p, crc_table), hash_category(k.y, p, crc_table),
                        hash_category(k.z, p, crc_table), hash_category(k.w, p, crc_table));
  }
}

// One histogram of digits per CTA tile, written digit-major: hist[c][d][t].
// 16-byte loads; the counts are shared-memory atomics.
__global__ void __launch_bounds__(kTileThreads)
tile_hist(Pass s, int* __restrict__ hist, int chunk_elems, int ntiles, CatParams p) {
  __shared__ int cnt[kMaxDigits];
  const int c = blockIdx.x / ntiles, t = blockIdx.x % ntiles;
  for (int d = threadIdx.x; d < s.ndigits; d += kTileThreads) cnt[d] = 0;
  __syncthreads();
  const long long base = (long long)c * chunk_elems + (long long)t * kTile;
  const int nvalid = min(kTile, chunk_elems - t * kTile);
  const int4* src = reinterpret_cast<const int4*>(s.cats ? s.cats : s.keys) + base / 4;
  int4 v[kTileItems / 4];
#pragma unroll
  for (int j = 0; j < kTileItems / 4; ++j) {
    const int i4 = j * kTileThreads + threadIdx.x;
    v[j] = 4 * i4 < nvalid ? __ldg(src + i4) : make_int4(-1, -1, -1, -1);
  }
#pragma unroll
  for (int j = 0; j < kTileItems / 4; ++j) {
    if (4 * (j * kTileThreads + threadIdx.x) >= nvalid) continue;
    const int w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      atomicAdd(cnt + digit_of(s.cats ? w[q] : range_category(w[q], p), s), 1);
  }
  __syncthreads();
  int* h = hist + (long long)c * s.ndigits * ntiles + t;
  for (int d = threadIdx.x; d < s.ndigits; d += kTileThreads)
    h[(long long)d * ntiles] = cnt[d];
}

// One CTA per chunk: exclusive scan of hist[c] in (digit, tile) order, in
// place; with starts set (one sweep: the digit is the category), the
// chunk's starts table.
__global__ void __launch_bounds__(kScanThreads)
chunk_scan(int* __restrict__ hist, int* __restrict__ starts, int ndigits, int ntiles,
           int chunk_elems, int cat_words) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage temp;
  const long long c = blockIdx.x;
  int* h = hist + c * (long long)ndigits * ntiles;
  const int total = ndigits * ntiles;
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
  if (!starts) return;
  int* st = starts + c * (long long)cat_words;
  for (int j = threadIdx.x; j < cat_words; j += kScanThreads)
    st[j] = j < ndigits ? h[(long long)j * ntiles] : chunk_elems;
}

// Stable scatter of one tile: the tile ranked by digit (tile_rank.cuh's
// steps), staged in shared memory in digit order beside each key's slot in
// the chunk, then written out with consecutive threads on consecutive slots
// of one digit's run.  NBITS: bits of the largest digit.
template <int NBITS>
__global__ void __launch_bounds__(kTileThreads, hbrj::kScatterBlocks)
tile_scatter(Pass s, const int* __restrict__ offs, int chunk_elems, int ntiles,
             CatParams p) {
  extern __shared__ int smem[];
  const int D = s.ndigits;
  int* wcnt = smem;                               // [kTileWarps][D]
  int* gdelta = wcnt + kTileWarps * kMaxDigits;   // [D]
  int* skey = gdelta + kMaxDigits;                // [kTile] keys, digit order
  int* spay = skey + kTile;                       // [kTile] payloads
  // [kTile] each key's slot in the chunk or, when the categories move with
  // the keys, its category (the slot is then found from it)
  int* sslot = spay + (s.pays ? kTile : 0);
  const int c = blockIdx.x / ntiles, t = blockIdx.x % ntiles;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  hbrj::clear_counts(wcnt, D);
  // digit threadIdx.x's offset in the chunk, fetched ahead of the keys
  int off[1] = {threadIdx.x < D ? __ldg(offs + ((long long)c * D + threadIdx.x) * ntiles + t)
                                : 0};
  const long long base = (long long)c * chunk_elems + (long long)t * kTile;
  const int nvalid = min(kTile, chunk_elems - t * kTile);
  int key[kTileItems], pay[kTileItems], cat[kTileItems], rank[kTileItems];
  // nvalid is a multiple of 128, so a warp's 32 keys of a step are all in
  // the tile or all past it (cat -1)
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const int i = warp * kWarpKeys + j * kWarp + lane;
    key[j] = kPadKey;
    pay[j] = 0;
    cat[j] = -1;
    if (i < nvalid) {
      key[j] = __ldg(s.keys + base + i);
      if (s.pays) pay[j] = __ldg(s.pays + base + i);
      cat[j] = s.cats ? __ldg(s.cats + base + i) : range_category(key[j], p);
    }
  }
  __syncthreads();
  int* cnt = wcnt + warp * D;
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    rank[j] = 0;
    if (cat[j] < 0) continue;
    rank[j] = hbrj::warp_rank<NBITS>(digit_of(cat[j], s), cnt);
  }
  __syncthreads();
  hbrj::scan_digits<1, false>(wcnt, D, D, off, gdelta);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (cat[j] < 0) continue;
    const int dj = digit_of(cat[j], s);
    const int pos = cnt[dj] + rank[j];
    skey[pos] = key[j];
    sslot[pos] = s.cats_out ? cat[j] : gdelta[dj] + pos;
    if (s.pays) spay[pos] = pay[j];
  }
  __syncthreads();
  const long long cbase = (long long)c * chunk_elems;
  for (int i = threadIdx.x; i < nvalid; i += kTileThreads) {
    const int v = sslot[i];
    const long long g = cbase + (s.cats_out ? gdelta[digit_of(v, s)] + i : v);
    s.keys_out[g] = skey[i];
    if (s.pays) s.pays_out[g] = spay[i];
    if (s.cats_out) s.cats_out[g] = v;
  }
}

template <int NBITS>
cudaError_t launch_scatter(const Pass& s, const int* offs, long long ngrid,
                           int chunk_elems, int ntiles, const CatParams& p, int smem,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_scatter<NBITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  tile_scatter<NBITS><<<(unsigned)ngrid, kTileThreads, smem, stream>>>(
      s, offs, chunk_elems, ntiles, p);
  return cudaGetLastError();
}

using ScatterLaunch = cudaError_t (*)(const Pass&, const int*, long long, int, int,
                                      const CatParams&, int, cudaStream_t);
// by the bits of the largest digit: up to 9 (one sweep over 2^8 + 1)
constexpr ScatterLaunch kScatter[] = {
    launch_scatter<0>, launch_scatter<1>, launch_scatter<2>, launch_scatter<3>,
    launch_scatter<4>, launch_scatter<5>, launch_scatter<6>, launch_scatter<7>,
    launch_scatter<8>, launch_scatter<9>};

__global__ void fill_kernel(int* __restrict__ out, long long n, int value) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = value;
}

// starts[c][cat] = the first position of each category present in sorted
// chunk c (the rest keep chunk_elems, written by fill_kernel); 16 bytes a
// thread and step, which never straddle a chunk.
__global__ void starts_mark(const int* __restrict__ keys, const int* __restrict__ cats,
                            int* __restrict__ starts, long long n4, int chunk_elems,
                            int cat_words, CatParams p) {
  const int* src = cats ? cats : keys;
  for (long long i4 = (long long)blockIdx.x * blockDim.x + threadIdx.x; i4 < n4;
       i4 += (long long)gridDim.x * blockDim.x) {
    const long long c = 4 * i4 / chunk_elems;
    const int r = (int)(4 * i4 - c * chunk_elems);
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + i4);
    const int w[4] = {v.x, v.y, v.z, v.w};
    int prev = -1;
    if (r) {
      const int x = __ldg(src + 4 * i4 - 1);
      prev = cats ? x : range_category(x, p);
    }
    int* st = starts + c * cat_words;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cur = cats ? w[q] : range_category(w[q], p);
      if (cur != prev) st[cur] = r + q;
      prev = cur;
    }
  }
}

struct MinOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return b < a ? b : a; }
};

// One CTA per chunk: starts[j] = min(starts[j..cat_words)), so a category
// absent from the chunk starts where the next present one does.
__global__ void __launch_bounds__(kScanThreads)
starts_suffix_min(int* __restrict__ starts, int cat_words) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage temp;
  int* st = starts + blockIdx.x * (long long)cat_words;
  int carry = INT_MAX;
  for (int base = 0; base < cat_words; base += kScanThreads * kScanItems) {
    int v[kScanItems];
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int k = base + threadIdx.x * kScanItems + j;
      v[j] = k < cat_words ? st[cat_words - 1 - k] : INT_MAX;
    }
    int agg;
    Scan(temp).InclusiveScan(v, v, MinOp(), agg);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int k = base + threadIdx.x * kScanItems + j;
      if (k < cat_words) st[cat_words - 1 - k] = min(v[j], carry);
    }
    carry = min(carry, agg);
    __syncthreads();
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

// The digit passes of a fan-out: one sweep over the category up to
// kOneSweepMaxBits, else least-significant-digit passes of near-equal
// widths, each at most kDigitBits, over the category's bits.
struct Plan {
  int npasses;
  int dshift[kMaxPasses], dbits[kMaxPasses];
  int max_digits;   // the widest pass's digit count (histogram words a tile)
};

Plan plan_passes(int part_bits, int pad_cat) {
  Plan pl{};
  const int ncats = (1 << part_bits) + (pad_cat ? 1 : 0);
  if (part_bits <= kOneSweepMaxBits) {
    pl.npasses = 1;
    pl.max_digits = ncats;
    return pl;
  }
  int nb = 0;
  while ((1 << nb) < ncats) ++nb;   // bits of the largest category
  pl.npasses = (nb + kDigitBits - 1) / kDigitBits;
  int shift = 0;
  for (int k = 0; k < pl.npasses; ++k) {
    const int w = (nb - shift) / (pl.npasses - k);   // remaining bits, evenly
    pl.dshift[k] = shift;
    pl.dbits[k] = w;
    if ((1 << w) > pl.max_digits) pl.max_digits = 1 << w;
    shift += w;
  }
  return pl;
}

long long round4(long long words) { return (words + 3) & ~3LL; }

struct Scratch {
  int *hist, *keys, *pays, *cat_a, *cat_b;
};

Scratch carve(int* base, const Plan& pl, long long nchunks, int chunk_elems, int hash,
              int kv, long long* words) {
  const long long n = nchunks * chunk_elems;
  const long long ntiles = (chunk_elems + kTile - 1) / kTile;
  const bool multi = pl.npasses > 1;
  long long off = 0;
  auto take = [&](long long w) {
    int* q = base ? base + off : nullptr;
    off += round4(w);
    return q;
  };
  Scratch s;
  s.hist = take(nchunks * pl.max_digits * ntiles);
  s.keys = multi ? take(n) : nullptr;
  s.pays = multi && kv ? take(n) : nullptr;
  s.cat_a = hash ? take(n) : nullptr;
  s.cat_b = hash && multi ? take(n) : nullptr;
  if (words) *words = off;
  return s;
}

}  // namespace

extern "C" {

const char* hbrj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int32 words of scratch hbrj_partition needs for this geometry.
long long hbrj_partition_scratch(long long nchunks, int chunk_elems, int part_bits,
                                 int pad_cat, int hash, int kv) {
  long long words = 0;
  carve(nullptr, plan_passes(part_bits, pad_cat), nchunks, chunk_elems, hash, kv,
        &words);
  return words;
}

// keys: nchunks*chunk_elems int32 (16-byte aligned; chunk_elems a multiple of
// 128); out: same size; starts: nchunks*cat_words; scratch:
// hbrj_partition_scratch(...) int32 words, 16-byte aligned.  pays, pays_out:
// a payload column moved with the keys (same size), or both null.  hash != 0
// selects hash mode (seed, hash_bits; lo, hi, has_hi and shift unused).
int hbrj_partition(const int* keys, const int* pays, int* out, int* pays_out,
                   int* starts, int* scratch, long long nchunks, int chunk_elems,
                   int lo, int hi, int has_hi, int shift, int part_bits, int pad_cat,
                   int cat_words, int hash, unsigned seed, int hash_bits,
                   cudaStream_t stream) {
  if (nchunks == 0) return 0;
  const unsigned hmask = hash_bits >= 32 ? 0xFFFFFFFFu : (1u << hash_bits) - 1u;
  const CatParams p{lo, hi, has_hi, shift, 1 << part_bits, pad_cat,
                    seed, hmask, hash_bits - part_bits};
  const Plan pl = plan_passes(part_bits, pad_cat);
  const Scratch sc = carve(scratch, pl, nchunks, chunk_elems, hash, pays != nullptr,
                           nullptr);
  const long long n = nchunks * chunk_elems;
  const int ntiles = (chunk_elems + kTile - 1) / kTile;
  const long long ngrid = nchunks * ntiles;
  if (ngrid > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (hash) {
    hash_cats<<<hbrj::grid_for(n / 4, kStreamThreads), kStreamThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(keys), reinterpret_cast<int4*>(sc.cat_a), n / 4,
        p);
    if ((err = cudaGetLastError())) return (int)err;
  }
  // ping-pong so that the last pass lands in out
  const int* kin = keys;
  const int* pin = pays;
  const int* cin = sc.cat_a;
  for (int k = 0; k < pl.npasses; ++k) {
    const bool to_out = (pl.npasses - 1 - k) % 2 == 0;
    int* cout = nullptr;
    if (hash && pl.npasses > 1) cout = k % 2 == 0 ? sc.cat_b : sc.cat_a;
    Pass s{kin, pin, cin, to_out ? out : sc.keys,
           pays ? (to_out ? pays_out : sc.pays) : nullptr, cout, 0, 0xFFFFFFFFu,
           pl.max_digits};
    if (pl.npasses > 1) {
      s.dshift = pl.dshift[k];
      s.dmask = (1u << pl.dbits[k]) - 1u;
      s.ndigits = 1 << pl.dbits[k];
    }
    tile_hist<<<(unsigned)ngrid, kTileThreads, 0, stream>>>(s, sc.hist, chunk_elems,
                                                            ntiles, p);
    if ((err = cudaGetLastError())) return (int)err;
    chunk_scan<<<(unsigned)nchunks, kScanThreads, 0, stream>>>(
        sc.hist, pl.npasses == 1 ? starts : nullptr, s.ndigits, ntiles, chunk_elems,
        cat_words);
    if ((err = cudaGetLastError())) return (int)err;
    const int staged = pays ? 3 : 2;   // kTile columns
    const int smem = (kTileWarps * kMaxDigits + kMaxDigits + staged * kTile) *
                     (int)sizeof(int);
    if ((err = kScatter[digit_bits(s.ndigits)](s, sc.hist, ngrid, chunk_elems, ntiles, p,
                                               smem, stream)))
      return (int)err;
    kin = s.keys_out;
    pin = s.pays_out;
    cin = s.cats_out;
  }
  if (pl.npasses > 1) {
    const long long nst = nchunks * cat_words;
    fill_kernel<<<hbrj::grid_for(nst, kStreamThreads), kStreamThreads, 0, stream>>>(
        starts, nst, chunk_elems);
    if ((err = cudaGetLastError())) return (int)err;
    starts_mark<<<hbrj::grid_for(n / 4, kStreamThreads), kStreamThreads, 0, stream>>>(
        out, cin, starts, n / 4, chunk_elems, cat_words, p);
    if ((err = cudaGetLastError())) return (int)err;
    starts_suffix_min<<<(unsigned)nchunks, kScanThreads, 0, stream>>>(starts,
                                                                      cat_words);
  }
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
