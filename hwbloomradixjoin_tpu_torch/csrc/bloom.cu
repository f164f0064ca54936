// Bloom filter build, and the blocked filter's probe with fused pruning
// (Hopper, sm_90a).
//
// Replaces the Pallas kernel of hwbloomradixjoin_tpu/ops/bloom_pallas.py:
//   hbrj_bloom_probe <- bloom_probe_prune (_probe_kernel_for, bloom_pallas.py:93)
// and adds the filter build, hbrj_bloom_build, which replaces no Pallas
// kernel: the JAX package builds its filter in XLA
// (hwbloomradixjoin_tpu/ops/bloom.py:97 build_bitmap_xla, a sort of every
// probe position and a segment sum); its twin is ops/bloom.py
// build_bitmap_plain.  The build's note is above its kernel, bloom_build.
//
// Contract (checked against the plain PyTorch twin
// ops/bloom_pallas.py bloom_probe_prune_plain on the card): for each of the n
// input keys, out[i] = key when the key is not PAD and the filter holds all k
// of its bits, else PAD; *count += the number of keys kept.  A key's bits are
// the reference's blocked probes (bloom_filter.c:125-141): block =
// crc32c(seed, key) & (nblocks - 1), h = crapwow(seed, key) & (B - 1),
// y = (key + seed) & (B - 1), then k positions block * B + h, stepping
// h += y; y += i + 1 (mod B).  The filter is m/32 words, bit j of word w
// being filter bit 32w + j: the JAX package's slice layout read flat.
//
// What bounds it: the key stream, read once and written once, and about
// 38 integer operations a key at k = 1; the two bounds are about equal.  A
// flat stream loses to neither: each key reads its filter word through a
// 32-byte L2 sector, and its crc32c takes 4 dependent lookups into one
// 256-word table at random banks.  So the staged class walks S through its
// hash partition's starts (csrc/run_walk.cuh): S is partitioned by the top
// bits of the block index, so bucket j's keys probe only filter words
// [j * W, (j + 1) * W), W = m / 32 / 2^part_bits.  A CTA owns a range of
// buckets and a span of segments (partition chunks, or pass-2 regions whose
// bucket j of region r is r * F2 + j), stages the range's filter slices in
// shared memory with one TMA copy, and probes every key of the range's
// merged run in each segment there.  Its crc32c takes four independent
// lookups into slice-by-4 tables (4 KiB) in place of four dependent ones
// (measured against a bank-conflict-free copy of the byte table for each
// lane, 32 KiB: python -m hwbloomradixjoin_tpu_torch.flat_split).  A key
// whose block lies outside the range (none, for
// a consistent partition) probes the filter in device memory.  Each
// segment's pad run (PAD only: the hash partition's pad category, chunk
// padding, a region's tail) is written as PAD unread, shared among the
// span's CTAs, so every output slot is written exactly once and nothing is
// cleared first.  The TPU staged each bucket's 2^17-bit slice in VMEM and
// read its runs through window and ownership descriptors.
//
// The flat class, chosen on the host where there are no starts (S as it
// comes) or one bucket's slice exceeds the staging budget: a grid-stride
// stream, 16 bytes a thread, the filter in device memory and one 256-word
// crc32c table a block.  Survivors are summed per thread in 64 bits,
// reduced per block, and added with one atomic per block.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"
#include "run_walk.cuh"

namespace {

constexpr int kPadKey = INT32_MIN;
constexpr int kThreads = 256;

struct ProbeParams {
  unsigned seed;
  unsigned block_mask;             // nblocks - 1
  unsigned B;                      // block bits, a power of two
  int k;
};

// The k probes of a key whose block starts at bit `base` of the filter in
// device memory.
__device__ __forceinline__ bool probe_block(const unsigned* __restrict__ filter,
                                            unsigned long long base, int key,
                                            const ProbeParams& p) {
  const unsigned mask = p.B - 1u;
  unsigned h = hbrj::crapwow(p.seed, key) & mask;
  unsigned y = ((unsigned)key + p.seed) & mask;
  for (int i = 0; i < p.k; ++i) {
    const unsigned long long pos = base + h;
    if (!((__ldg(filter + (pos >> 5)) >> (unsigned)(pos & 31u)) & 1u)) return false;
    h = (h + y) & mask;
    y = (y + (unsigned)i + 1u) & mask;
  }
  return true;
}

__device__ __forceinline__ bool contains(int key, const unsigned* __restrict__ filter,
                                         const ProbeParams& p,
                                         const unsigned* crc_table) {
  if (key == kPadKey) return false;
  const unsigned long long base =
      (unsigned long long)(hbrj::crc32c(crc_table, p.seed, key) & p.block_mask) * p.B;
  return probe_block(filter, base, key, p);
}

__global__ void bloom_probe(const int4* __restrict__ keys, long long n4,
                            const unsigned* __restrict__ filter, int4* __restrict__ out,
                            unsigned long long* __restrict__ count, ProbeParams p) {
  __shared__ unsigned crc_table[256];
  using Reduce = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename Reduce::TempStorage temp;
  hbrj::crc32c_table_init(crc_table);
  __syncthreads();
  unsigned long long kept = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    int4 v = keys[i];
    const bool a = contains(v.x, filter, p, crc_table);
    const bool b = contains(v.y, filter, p, crc_table);
    const bool c = contains(v.z, filter, p, crc_table);
    const bool d = contains(v.w, filter, p, crc_table);
    kept += (unsigned long long)a + b + c + d;
    out[i] = make_int4(a ? v.x : kPadKey, b ? v.y : kPadKey, c ? v.z : kPadKey,
                       d ? v.w : kPadKey);
  }
  const unsigned long long total = Reduce(temp).Sum(kept);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

constexpr int kRunThreads = 512;     // 3 CTAs an SM: at most 42 registers a thread
constexpr int kQuads = 2;             // 16-byte loads a lane issues before it probes any
constexpr int kCrcTableWords = 4 * 256;

// Slice-by-4 tables of crc32c: T0 (words 0-255) the byte table, T_j[i] =
// (T_{j-1}[i] >> 8) ^ T0[T_{j-1}[i] & 0xFF] at words 256 j + i.  Every
// thread of the block calls it (it synchronises the block inside).
__device__ __forceinline__ void crc32c_slice4_init(unsigned* t) {
  hbrj::crc32c_table_init(t);
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = t[i];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      c = (c >> 8) ^ t[c & 0xFFu];
      t[j * 256 + i] = c;
    }
  }
}

// hbrj::crc32c, bit for bit: the four byte steps of one 32-bit word are
// linear, so they fold into four independent lookups.
__device__ __forceinline__ unsigned crc32c_slice4(const unsigned* t, unsigned seed,
                                                  int key) {
  const unsigned x = seed ^ (unsigned)key;
  return t[768 + (x & 0xFFu)] ^ t[512 + ((x >> 8) & 0xFFu)] ^ t[256 + ((x >> 16) & 0xFFu)]
       ^ t[x >> 24];
}

// The k probes of a key at bit `base` of the staged slices: probe_block's
// positions, 32-bit (a CTA stages at most 2^20 bits); kOne: k is 1.
template <bool kOne>
__device__ __forceinline__ bool probe_staged(const unsigned* slices, unsigned base, int key,
                                             const ProbeParams& p) {
  const unsigned mask = p.B - 1u;
  const int k = kOne ? 1 : p.k;
  unsigned h = hbrj::crapwow(p.seed, key) & mask;
  unsigned y = ((unsigned)key + p.seed) & mask;
  for (int i = 0; i < k;) {
    const unsigned pos = base + h;
    if (!((slices[pos >> 5] >> (pos & 31u)) & 1u)) return false;
    if (++i == k) break;
    h = (h + y) & mask;
    y = (y + (unsigned)i) & mask;
  }
  return true;
}

// The staged class: a CTA a bucket range and a span of segments; its
// filter slices (nb * W words) and the slice-by-4 crc32c tables in dynamic
// shared memory.  kOne (k == 1, the main paths' filters) drops the probe
// loop's bookkeeping.
template <bool kOne>
__global__ void __launch_bounds__(kRunThreads, 3)
bloom_probe_runs(const int* __restrict__ keys, const int* __restrict__ starts,
                 hbrj::RunGrid g, const unsigned* __restrict__ filter,
                 int* __restrict__ out, unsigned long long* __restrict__ count,
                 ProbeParams p, long long W) {
  extern __shared__ int4 smem4[];
  unsigned* slices = reinterpret_cast<unsigned*>(smem4);
  unsigned* crc_table = slices + g.nb * W;
  __shared__ unsigned long long bar;
  const hbrj::CtaWork w = hbrj::cta_work(g);
  const int nbk = w.j1 - w.j0;
  hbrj::stage_slices(slices, filter, w.gb0, nbk, W, (int)W, &bar);
  crc32c_slice4_init(crc_table);
  __syncthreads();                               // the crc32c tables are in place
  const unsigned bucket_blocks = (unsigned)(W * 32 / p.B);
  const unsigned first = (unsigned)w.gb0 * bucket_blocks;   // the range's first block
  const unsigned blocks = (unsigned)nbk * bucket_blocks;
  auto keep = [&](int key) -> bool {
    if (key == kPadKey) return false;
    const unsigned block = crc32c_slice4(crc_table, p.seed, key) & p.block_mask;
    return block - first < blocks
        ? probe_staged<kOne>(slices, (block - first) * p.B, key, p)
        : probe_block(filter, (unsigned long long)block * p.B, key, p);
  };
  unsigned long long kept = 0;
  hbrj::walk_runs<kQuads>(
      keys, starts, g, w, &bar,
      [&](long long base, int p0, int p1, int glane) {  // PAD over the pad share
        int* o = out + base;                               // 16-byte aligned
        const int head = min(p1, (p0 + 3) & ~3);
        const int body = max(head, p1 & ~3);
        for (int i = p0 + glane; i < head; i += g.group) o[i] = kPadKey;
        int4* o4 = reinterpret_cast<int4*>(o);
        for (int i = head / 4 + glane; i < body / 4; i += g.group)
          o4[i] = make_int4(kPadKey, kPadKey, kPadKey, kPadKey);
        for (int i = body + glane; i < p1; i += g.group) o[i] = kPadKey;
      },
      [&](long long i, int key) {
        const bool k = keep(key);
        out[i] = k ? key : kPadKey;
        kept += k;
      },
      [&](long long i, int4 v) {
        const bool a = keep(v.x), b = keep(v.y), c = keep(v.z), d = keep(v.w);
        kept += (unsigned long long)a + b + c + d;
        *reinterpret_cast<int4*>(out + i) =
            make_int4(a ? v.x : kPadKey, b ? v.y : kPadKey, c ? v.z : kPadKey,
                      d ? v.w : kPadKey);
      });
  using Reduce = cub::BlockReduce<unsigned long long, kRunThreads>;
  __shared__ typename Reduce::TempStorage temp;
  const unsigned long long total = Reduce(temp).Sum(kept);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

// The filter build.  Contract (checked against ops/bloom.py
// build_bitmap_plain on the card): every probe position p of every key, PAD
// included, sets bit p & 31 of word p >> 5 of the m/32 words, which the
// wrapper zeroes first.  The basic variant probes the whole m-bit space; the
// blocked variant the B bits of block crc32c(seed, key) & (nblocks - 1).
// The positions are the probe's (h = crapwow(seed, key), y = key + seed,
// both mod the probed size, then h += y; y += i), kept in 64 bits, since m
// and B may pass 2^32.  atomicOr is idempotent and order-free, so any
// multiset of keys, in any order and any interleaving of threads, gives the
// same words.
//
// What bounds it: at the flagship (128M keys, m = 2^30, B = 512, k = 1) the
// filter is 128 MiB, 2.7x the 50 MB L2, and each key's bit lands in a random
// 32-byte sector of it.  Built flat, a key costs a sector read and a sector
// written back: 8.2 GB, ~2.45 ms at 3.35 TB/s (7.64 ms measured on an H100),
// where streaming the keys and zeroing the words take ~0.19 ms.  So the
// build runs in sections: the words are cut into S equal ranges (S a power
// of two, the fewest whose range fits a third of the card's L2, read from
// the device: 8 ranges of 16 MiB at the flagship), and launch s streams
// every key but sets only the bits in range s.  A section's words stay in
// the L2 while its launch runs, so the atomics hit the L2 and each word
// reaches device memory about once; the price is S reads and hashings of
// the keys, ~0.27 ms a launch over 128M keys, bound by the crc32c's
// shared-memory lookups and the other integer work.  Measured at the
// flagship with the zero fill: 7.64 ms flat, 6.01, 3.45, 2.60, 4.73 and
// 8.53 ms at 2, 4, 8, 16 and 32 sections.  In a launch: 16-byte key loads
// in a grid-stride loop, marked evict-first (__ldcs) so the keys pass
// through the L2 without displacing the section's words; every key hashed
// in full (its crc32c through the slice-by-4 tables) and each probe in the
// section set by a predicated atomicOr whose result is unused, a reduction
// (RED) that does not hold the thread.  Skipping the rest of a key whose
// block lies outside the section was slower (3.06 against 2.87 ms): the
// branch splits the warps and the four keys' chains no longer overlap.  No
// bool map, no int64 temporaries, no pack pass.  A key count that is not a
// multiple of 4, or keys that start between 16-byte boundaries, leave up to
// 3 keys at each end to the first threads, one key each.
struct BuildParams {
  unsigned seed;
  unsigned long long block_mask;   // nblocks - 1 (blocked)
  unsigned long long B;            // bits a block (blocked)
  unsigned long long mask;         // the probed size - 1: B - 1 or m - 1
  int k;
  int section_shift;               // a block's (blocked) or a bit's section: >> this
};

template <bool kBlocked, bool kOne>
__device__ __forceinline__ void build_add(unsigned* __restrict__ words, int key,
                                          const BuildParams& p, const unsigned* crc_table,
                                          unsigned long long section) {
  const unsigned long long block =
      kBlocked ? (unsigned long long)crc32c_slice4(crc_table, p.seed, key) & p.block_mask : 0ull;
  const bool in_section = block >> p.section_shift == section;
  const unsigned long long base = block * p.B;
  const int k = kOne ? 1 : p.k;
  unsigned long long h = (unsigned long long)hbrj::crapwow(p.seed, key) & p.mask;
  unsigned long long y = ((unsigned long long)(unsigned)key + p.seed) & p.mask;
  for (int i = 0; i < k;) {
    const unsigned long long pos = base + h;
    if (kBlocked ? in_section : pos >> p.section_shift == section)
      atomicOr(words + (pos >> 5), 1u << (unsigned)(pos & 31u));
    if (++i == k) break;
    h = (h + y) & p.mask;
    y = (y + (unsigned)i) & p.mask;
  }
}

// One section's launch.  keys[0, head) lie before the first 16-byte
// boundary (head <= 3); the 16-byte body follows, then fewer than 4 keys of
// tail.  kOne (k == 1, the main paths' filters) drops the probe loop.
template <bool kBlocked, bool kOne>
__global__ void __launch_bounds__(kThreads)
bloom_build(const int* __restrict__ keys, long long n, int head, unsigned* __restrict__ words,
            BuildParams p, unsigned long long section) {
  __shared__ unsigned crc_table[kCrcTableWords];
  if (kBlocked) {
    crc32c_slice4_init(crc_table);
    __syncthreads();
  }
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = (n - head) / 4;
  const int4* keys4 = reinterpret_cast<const int4*>(keys + head);
  for (long long i = t; i < n4; i += (long long)gridDim.x * kThreads) {
    const int4 v = __ldcs(keys4 + i);
    build_add<kBlocked, kOne>(words, v.x, p, crc_table, section);
    build_add<kBlocked, kOne>(words, v.y, p, crc_table, section);
    build_add<kBlocked, kOne>(words, v.z, p, crc_table, section);
    build_add<kBlocked, kOne>(words, v.w, p, crc_table, section);
  }
  const long long tail0 = head + 4 * n4;
  if (t < head)
    build_add<kBlocked, kOne>(words, keys[t], p, crc_table, section);
  else if (t - head < n - tail0)
    build_add<kBlocked, kOne>(words, keys[tail0 + t - head], p, crc_table, section);
}

int log2_of(unsigned long long x) { return 63 - __builtin_clzll(x); }

}  // namespace

extern "C" {

// keys: n int32, any 4-byte alignment; words: m/32 words, zeroed; blocked:
// 0 for the basic variant (B unread), 1 for the blocked; m and B powers of
// two, m >= 32, B <= m.
int hbrj_bloom_build(const int* keys, long long n, int* words, long long m, long long B,
                     int blocked, unsigned seed, int k, cudaStream_t stream) {
  if (m < 32 || (m & (m - 1)) || k < 0
      || (blocked && (B <= 0 || (B & (B - 1)) || B > m)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  static int l2 = 0;
  if (!l2) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (l2 <= 0) l2 = 1;
  }
  // the sections: the fewest whose m / 8 / sections bytes fit a third of
  // the L2, at most one a block (blocked) or a bit (basic)
  const long long units = blocked ? m / B : m;
  long long sections = 1;
  while (m / 8 / sections > l2 / 3 && sections < units) sections *= 2;
  const BuildParams p{seed, blocked ? (unsigned long long)units - 1ull : 0ull,
                      (unsigned long long)B, (unsigned long long)(blocked ? B : m) - 1ull, k,
                      log2_of(units) - log2_of(sections)};
  const long long head = ((16 - ((unsigned long long)keys & 15ull)) & 15ull) / 4;
  const int h = (int)(head < n ? head : n);
  const unsigned grid = hbrj::grid_for((n - h) / 4, kThreads);
  unsigned* w = reinterpret_cast<unsigned*>(words);
  const auto kernel = blocked ? (k == 1 ? bloom_build<true, true> : bloom_build<true, false>)
                              : (k == 1 ? bloom_build<false, true> : bloom_build<false, false>);
  for (long long s = 0; s < sections; ++s) {
    kernel<<<grid, kThreads, 0, stream>>>(keys, n, h, w, p, s);
    const cudaError_t err = cudaGetLastError();
    if (err) return (int)err;
  }
  return 0;
}

// keys: n int32 (n a multiple of 4, 16-byte aligned); filter: m/32 words;
// out: n int32 (16-byte aligned); count: one zeroed 64-bit word.  nb == 0:
// the flat class (starts unread).  Else keys are hash-partitioned into nseg
// segments of seg_elems keys with their starts (cat_words a segment,
// seg_buckets buckets; regions: bucket j of segment r is r * seg_buckets +
// j), bucket b's keys probing filter words [b * W, (b + 1) * W); nb, span,
// group: the host's split (ops/run_split.py).
int hbrj_bloom_probe(const int* keys, long long n, const int* starts, const int* filter,
                     int* out, long long* count, unsigned seed, unsigned nblocks,
                     unsigned B, int k, int nseg, int seg_elems, int cat_words,
                     int seg_buckets, int regions, int nb, int span, int group,
                     long long W, cudaStream_t stream) {
  if (n == 0) return 0;
  const ProbeParams p{seed, nblocks - 1u, B, k};
  if (nb == 0) {
    const long long n4 = n / 4;
    bloom_probe<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(keys), n4,
        reinterpret_cast<const unsigned*>(filter), reinterpret_cast<int4*>(out),
        reinterpret_cast<unsigned long long*>(count), p);
    return (int)cudaGetLastError();
  }
  const hbrj::RunGrid g{nseg, seg_elems, cat_words, seg_buckets, regions, nb, span, group};
  if (nseg <= 0 || (long long)nseg * seg_elems != n || seg_elems % 4 || W % 4 || W <= 0
      || group <= 0 || group > kRunThreads || kRunThreads % group || span <= 0
      || (regions && span != 1))
    return (int)cudaErrorInvalidValue;
  const long long smem = ((long long)nb * W + kCrcTableWords) * (long long)sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const auto kernel = k == 1 ? bloom_probe_runs<true> : bloom_probe_runs<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return (int)err;
  const long long grid = (long long)g.nranges() * g.nspans();
  kernel<<<(unsigned)grid, kRunThreads, (int)smem, stream>>>(
      keys, starts, g, reinterpret_cast<const unsigned*>(filter), out,
      reinterpret_cast<unsigned long long*>(count), p, W);
  return (int)cudaGetLastError();
}

// Resident CTAs an SM of the class a split picks: the staged class at nb
// buckets of W words and k probes, the flat class at nb == 0; a CUDA error
// negated.
int hbrj_bloom_probe_per_sm(int nb, long long W, int k) {
  int n = 0;
  cudaError_t err;
  if (nb == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bloom_probe, kThreads, 0);
  } else {
    const auto kernel = k == 1 ? bloom_probe_runs<true> : bloom_probe_runs<false>;
    const int smem = (int)(((long long)nb * W + kCrcTableWords) * (long long)sizeof(int));
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kRunThreads, smem);
  }
  return err ? -(int)err : n;
}

}  // extern "C"
