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
// The TPU gathered 8-row segments of every run through descriptors built on
// the host, sorted R and S together by a composite (valid, key >> bits,
// side) code in VMEM with its split network, and counted with a segmented
// scan.  Here each bucket's R goes into a hash table of (key, multiplicity)
// and each S key of the bucket looks its key up; the runs are read in place
// through the starts tables (no descriptors).  Bound: bytes, R's and S's
// keys read once (plus the starts); the design's own cost is latency, which
// it hides by keeping many CTAs and many keys in flight:
//   1. gp_classify, a thread a bucket: R's keys of bucket b (the sum of its
//      run lengths), the overflow word when they pass r_cap, and b appended
//      to the list of the smallest capacity class whose table holds them at
//      a load of at most 0.7 (no list for an empty bucket).  No host read:
//      every class is launched, and its CTAs read their list on the device;
//   2. gp_probe, one launch a class: persistent CTAs of kThreads threads,
//      each taking the list's buckets in turn.  The table is sized to the
//      class, not to r_cap: 8-byte slots (the key in the high word, its
//      multiplicity in the low), in shared memory for the three smaller
//      classes (16, 48 and 216 KiB, so 4, 4 and 1 CTAs an SM beside the
//      walk's 4 KiB table of run bounds), and for the largest (up to r_cap keys, more
//      than shared memory holds) in a slice of device memory per CTA.  R's
//      runs are inserted by linear probing with atomicCAS (a duplicate adds
//      to its slot's multiplicity); then every S key adds the multiplicity
//      its lookup finds (0 at an empty slot).  Both walks read the bucket's
//      runs of 512 chunks at a time as one stream of keys (walk_runs), so a
//      CTA has 4,096 keys in flight whatever the runs' lengths.  Counts are
//      64-bit, block-reduced, one atomic per CTA.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kPiece = kThreads;        // chunks a piece of a walk, a thread each
constexpr int kItems = 8;               // keys a thread loads before it uses any
constexpr int kClassifyThreads = 256;
constexpr int kPadKey = INT32_MIN;
// an empty slot: key PAD (never in a bucket's run), multiplicity 0
constexpr unsigned long long kEmpty = (unsigned long long)0x80000000u << 32;
constexpr int kClasses = 4;
// slots of the shared-memory classes (8 bytes each); the last class's
// table, in device memory, holds r_cap keys
constexpr int kSmemSlots[kClasses - 1] = {2048, 6144, 27648};
constexpr int kGlobalCtas = 16;         // CTAs of the device-memory class

// Slots of class k for r_cap: a load of at most 0.7 at its largest bucket
// (even, for 16-byte clears).
long long class_slots(int k, int r_cap) {
  if (k < kClasses - 1) return kSmemSlots[k];
  const long long slots = ((long long)r_cap * 10 + 6) / 7;
  return (slots + 1) & ~1LL;
}

// The largest bucket (R keys) class k takes.
long long class_max_keys(int k, int r_cap) {
  return k < kClasses - 1 ? (long long)kSmemSlots[k] * 7 / 10 : r_cap;
}

long long round4(long long words) { return (words + 3) & ~3LL; }

struct Classes {
  int max_keys[kClasses];
};

struct Runs;
using ProbeKernel = void (*)(const int*, const int*, Runs, Runs, unsigned,
                             unsigned long long*, unsigned long long*);

struct Runs {
  const int* keys;
  const int* starts;
  long long nchunks;
  int chunk_elems, cat_words;
};

// R's keys of each bucket; overflow past r_cap; each bucket with keys into
// its class's list (lists[k * F + i], counts[k] entries).
__global__ void gp_classify(const int* __restrict__ r_starts, long long r_nchunks,
                            int cat_words, int F, int r_cap, Classes cls,
                            int* __restrict__ counts, int* __restrict__ lists,
                            unsigned long long* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= F) return;
  long long n = 0;
#pragma unroll 4
  for (long long c = 0; c < r_nchunks; ++c) {
    const int* st = r_starts + c * cat_words + b;
    n += __ldg(st + 1) - __ldg(st);
  }
  if (n == 0) return;
  if (n > r_cap) {
    atomicExch(out + 1, 1ull);
    return;
  }
  int k = 0;
  while (k < kClasses - 1 && n > cls.max_keys[k]) ++k;
  lists[k * F + atomicAdd(counts + k, 1)] = b;
}

// A piece of the walk: up to kPiece consecutive chunks, each run's first
// key in its chunk and its offset in the piece's stream of keys.
struct Piece {
  int off[kPiece + 1];
  int first[kPiece];
};
using PieceScan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;

// Visits every key of bucket b's runs, kPiece chunks at a time: a thread a
// chunk reads its run's bounds (all at once), a block scan turns the
// lengths into offsets, and the piece's runs are read as one stream of
// keys, kItems a thread (warp-major: item j of lane l of warp w at stream
// position w * 32 * kItems + j * 32 + l, so lanes read consecutive keys),
// all loaded before any is visited.  A thread's first item finds its run by
// a binary search of the offsets; its later items step forward from there.
// Called by the whole block; ends with a barrier.
template <typename Visit>
__device__ __forceinline__ void walk_runs(const Runs& w, int b, Piece& pc,
                                          PieceScan::TempStorage& scan_tmp, Visit visit) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (long long c0 = 0; c0 < w.nchunks; c0 += kPiece) {
    const long long c = c0 + threadIdx.x;
    int first = 0, len = 0;
    if (c < w.nchunks) {
      const int* st = w.starts + c * w.cat_words + b;
      first = __ldg(st);
      len = __ldg(st + 1) - first;
    }
    int off, total;
    PieceScan(scan_tmp).ExclusiveSum(len, off, total);
    pc.first[threadIdx.x] = first;
    pc.off[threadIdx.x] = off;
    if (threadIdx.x == 0) pc.off[kPiece] = total;
    __syncthreads();
    for (int base = 0; base < total; base += kThreads * kItems) {
      const int v0 = base + warp * kWarp * kItems + lane;
      int k = 0;
      if (v0 < total)
        for (int step = kPiece / 2; step > 0; step >>= 1)
          if (pc.off[k + step] <= v0) k += step;
      int key[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int v = v0 + j * kWarp;
        key[j] = kPadKey;
        if (v < total) {
          while (pc.off[k + 1] <= v) ++k;
          key[j] = __ldg(w.keys + (c0 + k) * w.chunk_elems + pc.first[k] + (v - pc.off[k]));
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (v0 + j * kWarp < total) visit(key[j]);
    }
    __syncthreads();
  }
}

// A key's home slot: the high bits of a multiplicative hash, scaled to the
// table (the keys of a bucket share their low bits).
__device__ __forceinline__ unsigned home(int key, unsigned slots) {
  return __umulhi((unsigned)key * 0x9E3779B1u, slots);
}

__device__ __forceinline__ void insert(unsigned long long* tab, unsigned slots, int key) {
  const unsigned long long mine = (unsigned long long)(unsigned)key << 32;
  unsigned i = home(key, slots);
  while (true) {
    unsigned long long cur = tab[i];
    if (cur == kEmpty) {
      cur = atomicCAS(tab + i, kEmpty, mine | 1ull);
      if (cur == kEmpty) return;
    }
    if ((cur >> 32) == (mine >> 32)) {   // keys never change once set
      atomicAdd(tab + i, 1ull);
      return;
    }
    if (++i == slots) i = 0;
  }
}

// Multiplicity of key in the table, 0 when absent.
__device__ __forceinline__ unsigned lookup(const unsigned long long* tab, unsigned slots,
                                           int key) {
  unsigned i = home(key, slots);
  while (true) {
    const unsigned long long cur = tab[i];
    if ((int)(cur >> 32) == key) return (unsigned)cur;
    if (cur == kEmpty) return 0;
    if (++i == slots) i = 0;
  }
}

// The buckets of one class: table in shared memory, or (kGlobal) in
// gtab's slice of this CTA.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
gp_probe(const int* __restrict__ list, const int* __restrict__ count_in, Runs r, Runs s,
         unsigned slots, unsigned long long* __restrict__ gtab,
         unsigned long long* __restrict__ out) {
  extern __shared__ int4 stab[];
  unsigned long long* tab = kGlobal ? gtab + (long long)blockIdx.x * slots
                                    : reinterpret_cast<unsigned long long*>(stab);
  int4* tab4 = reinterpret_cast<int4*>(tab);
  const int4 empty = make_int4(0, kPadKey, 0, kPadKey);   // two kEmpty slots
  __shared__ Piece piece;
  __shared__ PieceScan::TempStorage scan_tmp;
  const int nb = __ldg(count_in);
  unsigned long long count = 0;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    const int b = __ldg(list + i);
    for (unsigned q = threadIdx.x; q < slots / 2; q += kThreads) tab4[q] = empty;
    __syncthreads();
    walk_runs(r, b, piece, scan_tmp, [&](int key) { insert(tab, slots, key); });
    walk_runs(s, b, piece, scan_tmp, [&](int key) { count += lookup(tab, slots, key); });
  }
  using Reduce = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename Reduce::TempStorage red_tmp;
  const unsigned long long total = Reduce(red_tmp).Sum(count);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

// Scratch layout (int32 words): counts[kClasses], lists[kClasses][F], then
// kGlobalCtas device-memory tables.
struct Scratch {
  int* counts;
  int* lists;
  unsigned long long* gtab;
  long long words;
};

Scratch carve(int* base, int F, int r_cap) {
  Scratch sc;
  long long off = 0;
  sc.counts = base;
  off += round4(kClasses);
  sc.lists = base ? base + off : nullptr;
  off += round4((long long)kClasses * F);
  sc.gtab = base ? reinterpret_cast<unsigned long long*>(base + off) : nullptr;
  off += 2 * kGlobalCtas * class_slots(kClasses - 1, r_cap);
  sc.words = off;
  return sc;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// Kernel, dynamic shared memory and CTAs an SM of class k (none depends on
// r_cap); set up once a process, so a call spends no host time on them.
struct ClassLaunch {
  ProbeKernel kernel;
  int smem, per_sm;
};

cudaError_t class_launch(int k, ClassLaunch* cl) {
  static ClassLaunch cache[kClasses];
  static bool ready[kClasses];
  if (!ready[k]) {
    const bool global = k == kClasses - 1;
    ClassLaunch c{global ? gp_probe<true> : gp_probe<false>,
                  global ? 0 : (int)class_slots(k, 0) * 8, 0};
    cudaError_t err = cudaFuncSetAttribute(
        c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (err) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, c.kernel, kThreads,
                                                        c.smem);
    if (err) return err;
    cache[k] = c;
    ready[k] = true;
  }
  *cl = cache[k];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// int32 words of scratch hbrj_gathered_probe needs.
long long hbrj_gathered_probe_scratch(int part_bits, int r_cap) {
  return carve(nullptr, 1 << part_bits, r_cap).words;
}

// The capacity class a bucket of n R keys takes (-1 past r_cap), its table
// slots and its CTAs an SM on this card.
int hbrj_gathered_probe_class(long long n, int r_cap, int* slots, int* per_sm) {
  if (n > r_cap) return -1;
  int k = 0;
  while (k < kClasses - 1 && n > class_max_keys(k, r_cap)) ++k;
  ClassLaunch cl;
  if (class_launch(k, &cl)) return -2;
  *per_sm = cl.per_sm;
  *slots = (int)class_slots(k, r_cap);
  return k;
}

// r, s: r_nchunks / s_nchunks chunks of chunk_elems int32 keys partitioned
// by kernel 1 with F = 2^part_bits buckets and the pad category; r_starts,
// s_starts: their starts tables, cat_words int32 a chunk; scratch:
// hbrj_gathered_probe_scratch(part_bits, r_cap) int32 words, 16-byte
// aligned; out: two uint64 words (count, overflow 0/1), overwritten.
int hbrj_gathered_probe(const int* r, const int* r_starts, long long r_nchunks,
                        const int* s, const int* s_starts, long long s_nchunks,
                        int chunk_elems, int cat_words, int part_bits, int r_cap,
                        int* scratch, unsigned long long* out, cudaStream_t stream) {
  const int F = 1 << part_bits;
  const Scratch sc = carve(scratch, F, r_cap);
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), stream);
  if (err) return (int)err;
  if ((err = cudaMemsetAsync(sc.counts, 0, kClasses * sizeof(int), stream))) return (int)err;
  Classes cls;
  for (int k = 0; k < kClasses; ++k) cls.max_keys[k] = (int)class_max_keys(k, r_cap);
  gp_classify<<<(unsigned)((F + kClassifyThreads - 1) / kClassifyThreads),
                kClassifyThreads, 0, stream>>>(r_starts, r_nchunks, cat_words, F, r_cap,
                                               cls, sc.counts, sc.lists, out);
  if ((err = cudaGetLastError())) return (int)err;
  const Runs rr{r, r_starts, r_nchunks, chunk_elems, cat_words};
  const Runs sr{s, s_starts, s_nchunks, chunk_elems, cat_words};
  for (int k = 0; k < kClasses; ++k) {
    ClassLaunch cl;
    if ((err = class_launch(k, &cl))) return (int)err;
    const int want = k == kClasses - 1 ? kGlobalCtas : cl.per_sm * sm_count();
    const int grid = want < F ? want : F;
    cl.kernel<<<(unsigned)(grid > 0 ? grid : 1), kThreads, cl.smem, stream>>>(
        sc.lists + (long long)k * F, sc.counts + k, rr, sr,
        (unsigned)class_slots(k, r_cap), sc.gtab, out);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return 0;
}

}  // extern "C"
