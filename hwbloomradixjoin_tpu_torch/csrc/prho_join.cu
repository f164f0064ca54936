// Count/payload-sum table build, probe and materialization of the
// count-table engines (PRHO, PRH, NPO, PRO over a non-unique build side;
// Hopper, sm_90a).
//
// Replaces the Pallas kernels of hwbloomradixjoin_tpu/ops/prho_join.py:
//   hbrj_table_build  <- build_tables_pallas (_build_kernel_for, prho_join.py:81)
//   hbrj_table_probe  <- probe_count_sums    (_probe_kernel_for, prho_join.py:252)
//   hbrj_materialize  <- materialize_pairs   (_materialize_kernel_for, prho_join.py:647)
//
// Table layout (shared with the JAX package): bucket b = norm >> shift of
// norm = key - lo owns sl_words = slice_rows*128 int32 slots starting at slot
// b*sl_words; slot (norm & (2^shift-1)) of the slice is the key.  Two tables
// of that layout: the key's multiplicity in R and the sum of its R payloads
// mod 2^32.  Slice tails (sl_words > 2^shift) stay zero.
//
// Build: the TPU kernel's order, per bucket.  One CTA owns bucket b and
// keeps its two slices (count and payload sum, sl_words int32 each, at most
// 2 x 64 KiB at slice_rows 128) in dynamic shared memory, zeroed there.  Its
// warps walk b's run in every chunk of partitioned R, found through the
// partition's starts table (run [starts[c][b], starts[c][b+1]) of chunk c;
// a warp a run, or fewer lanes when runs are short), and deposit each key in [lo, hi] of bucket b with shared-memory atomicAdds
// (exact for any multiplicity; the sum wraps mod 2^32 like the reference's
// unsigned checksum).  Then it writes both slices, tails included, with
// 16-byte stores: every table word is written exactly once, so there is no
// memset and no global atomic.  The TPU had no scatter and deposited through
// the MXU in four 8-bit payload limbs.  Bound: bytes, one read of R's two
// columns and one write of the two tables.  One CTA a bucket, not two CTAs
// each owning half a slice: halves would read each run twice, and at
// 128 KiB a CTA one CTA an SM still keeps its 32 warps' loads in flight.
// Global atomics instead would each be a sector read-modify-write in
// tables 20 times the L2.
//
// Probe and materialize: the build's shape applied to S.  One CTA owns a
// bucket range [b0, b1) whose count and sum slices fit 128 KiB of dynamic
// shared memory together (one bucket at slice_rows 128, 2^14 slots; 16 at
// slice_rows 8).  Thread 0 copies both slice ranges there with two
// cp.async.bulk (TMA) copies against an mbarrier; meanwhile the threads
// read the S partition's starts and their first keys.  The runs of
// consecutive buckets are contiguous in a chunk, so the CTA walks one merged
// run [starts[c][b0], starts[c][b1]) a chunk, a lane group sized to the mean
// run taking kBatch keys a lane at a time (all loaded before any is looked
// up) and fetching the next chunk's bounds ahead.  Every lookup is then a
// shared-memory read: each table slot is read once from device memory, not
// once a key through a 32-byte sector.  A key keeps the flat design's
// ARITHMETIC bucket test, (int32-wrapped key - lo) >> shift in [b0, b1);
// one that fails it contributes nothing (the run of a consistent S
// partition holds none).  The pad category's run [starts[c][F], chunk end)
// is never probed: its keys are PAD, below lo or above hi; the flat test
// admits only those in (hi, lo + F * 2^shift) (or wrapping past 2^31 onto
// the same slots), and those slots are zero, since the build deposits only
// keys <= hi and slice tails stay zero.  Bound: bytes, S's columns and the
// two slots of each distinct key S touches; the design reads S's columns
// and both tables whole, once each.
//
// Probe: each thread accumulates count += c (64-bit), r_sum += p and s_sum
// += s_pay * c (both uint32, wrapping); without S payloads (PRH) it reads
// keys only.  Each block reduces, then adds once into the 3-word output:
// word 0 the count, the low halves of words 1 and 2 the two sums (32-bit
// atomics, so they wrap).
//
// Materialize (unique R: every count slot 0 or 1, so the payload-sum slot is
// the R payload): three int32 images congruent with partitioned S, slot i =
// (r_pay, s_pay, key) of S key i where its count slot is > 0 and PAD
// elsewhere, each written at the key's own position, plus the match count
// (block-reduced, one 64-bit atomic per block).  A second kernel writes PAD
// over every chunk's pad run, spread over CTAs of 8,192 slots (at q = 0.01
// that run is ~99 % of S), so every image slot is written exactly once and
// nothing is cleared first.  The TPU kernel staged each chunk's run window
// into VMEM and emitted a staged-order image with window slack; order is not
// part of the contract: the pair multiset and the count are.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "run_walk.cuh"

namespace {

constexpr int kWarp = 32;

// One CTA a bucket: its two slices in shared memory, filled from the bucket's
// run in every chunk, then written out whole.  A group of `group` lanes
// walks one chunk's run (a warp for runs of dozens of keys, a few lanes for
// runs of a few), so short runs of many chunks are read side by side.
__global__ void table_build_kernel(const int* __restrict__ rk, const int* __restrict__ rp,
                                   const int* __restrict__ starts, int nchunks,
                                   int chunk_elems, int cat_words, int* __restrict__ cnt,
                                   int* __restrict__ sums, int lo, int hi, int shift,
                                   int sl_words, int group) {
  extern __shared__ int4 slices[];
  int* scnt = reinterpret_cast<int*>(slices);
  unsigned* ssum = reinterpret_cast<unsigned*>(scnt + sl_words);
  const int b = blockIdx.x;
  const int q = sl_words / 4;          // int4 words a slice
  for (int i = threadIdx.x; i < 2 * q; i += blockDim.x) slices[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int lane = threadIdx.x % group;
  const int ngroups = blockDim.x / group;
  const unsigned local = (1u << shift) - 1u;
  for (int c = threadIdx.x / group; c < nchunks; c += ngroups) {
    const int* st = starts + (long long)c * cat_words + b;
    const int begin = __ldg(st), end = __ldg(st + 1);
    const long long base = (long long)c * chunk_elems;
    for (int i = begin + lane; i < end; i += group) {
      const int key = __ldg(rk + base + i);
      const unsigned norm = (unsigned)key - (unsigned)lo;
      if (key < lo || key > hi || (int)(norm >> shift) != b) continue;
      atomicAdd(scnt + (norm & local), 1);
      atomicAdd(ssum + (norm & local), (unsigned)__ldg(rp + base + i));
    }
  }
  __syncthreads();
  int4* c4 = reinterpret_cast<int4*>(cnt + (long long)b * sl_words);
  int4* s4 = reinterpret_cast<int4*>(sums + (long long)b * sl_words);
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    c4[i] = slices[i];
    s4[i] = slices[q + i];
  }
}

// A CTA's bucket range: one launch geometry for the probe and materialize.
constexpr int kRangeThreads = 1024;
constexpr int kRangeWords = 16384;   // slots a CTA's slices hold, a table (64 KiB)
constexpr int kBatch = 4;            // keys a lane loads before it looks any up

struct Range {
  int nb;      // buckets a CTA
  int group;   // lanes a chunk's merged run
  int smem;    // bytes of both tables' slices
};

Range plan_range(int F, int sl_words, int chunk_elems) {
  Range r;
  r.nb = kRangeWords / sl_words > 1 ? kRangeWords / sl_words : 1;
  if (r.nb > F) r.nb = F;
  r.smem = 2 * r.nb * sl_words * (int)sizeof(int);
  // lanes a run: the power of two at or above the mean run over kBatch,
  // at most a warp
  const long long mean_run = (long long)chunk_elems * r.nb / F;
  r.group = 1;
  while (r.group < kWarp && (long long)r.group * kBatch < mean_run) r.group *= 2;
  return r;
}

// Thread 0 starts the copy of both tables' slices of buckets [b0, b1) into
// shared memory (counts at 0, sums at nb * sl_words): two bulk copies that
// complete a transaction count on *bar.  The other threads do not wait here.
__device__ __forceinline__ void load_slices(int* slices, const int* __restrict__ cnt,
                                            const int* __restrict__ sums, int b0, int b1,
                                            int nb, int sl_words,
                                            unsigned long long* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     hbrj::smem_addr(bar)),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned bytes = (unsigned)(b1 - b0) * (unsigned)sl_words * 4u;
    const long long first = (long long)b0 * sl_words;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     hbrj::smem_addr(bar)),
                 "r"(2u * bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(hbrj::smem_addr(slices)),
        "l"(cnt + first), "r"(bytes), "r"(hbrj::smem_addr(bar))
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(hbrj::smem_addr(slices + nb * sl_words)),
        "l"(sums + first), "r"(bytes), "r"(hbrj::smem_addr(bar))
        : "memory");
  }
}

// Walks the merged run [starts[c][b0], starts[c][b1]) of every chunk c: a
// group of `group` lanes a chunk, kBatch keys (and payloads with kPays) a
// lane loaded before the first slice lookup waits for the slices; the next
// chunk's bounds are fetched ahead.  visit(slot of S, key, payload) runs for
// every key of the runs.  Every thread waits for the slices before it
// returns, so no CTA retires while its copy is in flight.
template <bool kPays, typename Visit>
__device__ __forceinline__ void walk_runs(const int* __restrict__ s,
                                          const int* __restrict__ sp,
                                          const int* __restrict__ starts, int nchunks,
                                          int chunk_elems, int cat_words, int b0, int b1,
                                          int group, unsigned long long* bar,
                                          Visit visit) {
  const int lane = threadIdx.x % group;
  const int ngroups = blockDim.x / group;
  int c = threadIdx.x / group;
  int begin = 0, end = 0;
  if (c < nchunks) {
    const int* st = starts + (long long)c * cat_words;
    begin = __ldg(st + b0);
    end = __ldg(st + b1);
  }
  bool ready = false;
  while (c < nchunks) {
    const int next = c + ngroups;
    int next_begin = 0, next_end = 0;
    if (next < nchunks) {
      const int* st = starts + (long long)next * cat_words;
      next_begin = __ldg(st + b0);
      next_end = __ldg(st + b1);
    }
    const long long base = (long long)c * chunk_elems;
    for (int i = begin + lane; i < end; i += kBatch * group) {
      int key[kBatch], pay[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = i + j * group;
        key[j] = idx < end ? __ldg(s + base + idx) : 0;
        pay[j] = kPays && idx < end ? __ldg(sp + base + idx) : 0;
      }
      if (!ready) {
        hbrj::wait_slices(bar);
        ready = true;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int idx = i + j * group;
        if (idx < end) visit(base + idx, key[j], pay[j]);
      }
    }
    c = next;
    begin = next_begin;
    end = next_end;
  }
  if (!ready) hbrj::wait_slices(bar);
}

// The shared-memory slot of `key` in the CTA's slices, or -1 when its
// arithmetic bucket (int32-wrapped key - lo) >> shift is outside [b0, b1).
__device__ __forceinline__ int slice_slot(int key, int lo, int shift, int b0, int b1,
                                          int sl_words) {
  const int norm = (int)((unsigned)key - (unsigned)lo);   // int32 wrap, as on the TPU
  const int b = norm >> shift;                            // arithmetic shift
  if (b < b0 || b >= b1) return -1;
  return (b - b0) * sl_words + (int)((unsigned)norm & ((1u << shift) - 1u));
}

template <bool kWithSpay>
__global__ void __launch_bounds__(kRangeThreads, 1)
table_probe_kernel(const int* __restrict__ cnt, const int* __restrict__ sums,
                   const int* __restrict__ s, const int* __restrict__ sp,
                   const int* __restrict__ starts, int nchunks, int chunk_elems,
                   int cat_words, unsigned long long* __restrict__ out, int lo, int shift,
                   int F, int sl_words, int nb, int group) {
  extern __shared__ int4 slices[];
  __shared__ unsigned long long bar;
  int* scnt = reinterpret_cast<int*>(slices);
  const unsigned* ssum = reinterpret_cast<const unsigned*>(scnt + nb * sl_words);
  const int b0 = blockIdx.x * nb;
  const int b1 = min(b0 + nb, F);
  load_slices(scnt, cnt, sums, b0, b1, nb, sl_words, &bar);
  unsigned long long count = 0;
  unsigned r_sum = 0, s_sum = 0;
  walk_runs<kWithSpay>(s, sp, starts, nchunks, chunk_elems, cat_words, b0, b1, group,
                       &bar, [&](long long, int key, int pay) {
                         const int slot = slice_slot(key, lo, shift, b0, b1, sl_words);
                         if (slot < 0) return;
                         const unsigned c = (unsigned)scnt[slot];
                         count += c;
                         r_sum += ssum[slot];
                         s_sum += (unsigned)pay * c;
                       });
  using Reduce64 = cub::BlockReduce<unsigned long long, kRangeThreads>;
  using Reduce32 = cub::BlockReduce<unsigned, kRangeThreads>;
  __shared__ typename Reduce64::TempStorage t_count;
  __shared__ typename Reduce32::TempStorage t_r, t_s;
  const unsigned long long total = Reduce64(t_count).Sum(count);
  const unsigned r_total = Reduce32(t_r).Sum(r_sum);
  const unsigned s_total = Reduce32(t_s).Sum(s_sum);
  if (threadIdx.x == 0) {
    if (total) atomicAdd(out, total);
    // little-endian: the low half of a zeroed 64-bit word, so the sum wraps
    if (r_total) atomicAdd(reinterpret_cast<unsigned*>(out + 1), r_total);
    if (s_total) atomicAdd(reinterpret_cast<unsigned*>(out + 2), s_total);
  }
}

constexpr int kPadKey = INT32_MIN;

__global__ void __launch_bounds__(kRangeThreads, 1)
materialize_kernel(const int* __restrict__ cnt, const int* __restrict__ sums,
                   const int* __restrict__ s, const int* __restrict__ sp,
                   const int* __restrict__ starts, int nchunks, int chunk_elems,
                   int cat_words, int* __restrict__ out_r, int* __restrict__ out_s,
                   int* __restrict__ out_k, unsigned long long* __restrict__ out_count,
                   int lo, int shift, int F, int sl_words, int nb, int group) {
  extern __shared__ int4 slices[];
  __shared__ unsigned long long bar;
  int* scnt = reinterpret_cast<int*>(slices);
  const int* ssum = scnt + nb * sl_words;
  const int b0 = blockIdx.x * nb;
  const int b1 = min(b0 + nb, F);
  load_slices(scnt, cnt, sums, b0, b1, nb, sl_words, &bar);
  unsigned long long count = 0;
  walk_runs<true>(s, sp, starts, nchunks, chunk_elems, cat_words, b0, b1, group, &bar,
                  [&](long long g, int key, int pay) {
                    const int slot = slice_slot(key, lo, shift, b0, b1, sl_words);
                    int r = kPadKey, sv = kPadKey, kv = kPadKey;
                    if (slot >= 0 && scnt[slot] > 0) {
                      r = ssum[slot];
                      sv = pay;
                      kv = key;
                      ++count;
                    }
                    out_r[g] = r;
                    out_s[g] = sv;
                    out_k[g] = kv;
                  });
  using Reduce64 = cub::BlockReduce<unsigned long long, kRangeThreads>;
  __shared__ typename Reduce64::TempStorage t_count;
  const unsigned long long total = Reduce64(t_count).Sum(count);
  if (threadIdx.x == 0 && total) atomicAdd(out_count, total);
}

constexpr int kFillThreads = 256;
constexpr int kFillSpan = 8192;   // slots of a chunk a fill CTA covers

// PAD into the three images over each chunk's pad run [starts[c][F],
// chunk_elems): CTA (c, part) covers the run's share of slots [part *
// kFillSpan, (part + 1) * kFillSpan), scalar stores up to a 16-byte
// boundary, then 16-byte stores.
__global__ void pad_fill_kernel(const int* __restrict__ starts, int chunk_elems,
                                int cat_words, int F, int parts, int* __restrict__ out_r,
                                int* __restrict__ out_s, int* __restrict__ out_k) {
  const long long c = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int begin = max(__ldg(starts + c * cat_words + F), part * kFillSpan);
  const int end = min(chunk_elems, (part + 1) * kFillSpan);
  if (begin >= end) return;
  const long long base = c * chunk_elems;
  const int head = min(end, (begin + 3) & ~3);
  for (int i = begin + threadIdx.x; i < head; i += kFillThreads) {
    out_r[base + i] = kPadKey;
    out_s[base + i] = kPadKey;
    out_k[base + i] = kPadKey;
  }
  // base and end are multiples of 4 (chunk_elems of 128)
  const int4 pad = make_int4(kPadKey, kPadKey, kPadKey, kPadKey);
  int4* r4 = reinterpret_cast<int4*>(out_r + base);
  int4* s4 = reinterpret_cast<int4*>(out_s + base);
  int4* k4 = reinterpret_cast<int4*>(out_k + base);
  for (int i = head / 4 + threadIdx.x; i < end / 4; i += kFillThreads) {
    r4[i] = pad;
    s4[i] = pad;
    k4[i] = pad;
  }
}

}  // namespace

extern "C" {

// rk, rp: R's keys and payloads partitioned by bucket (range mode over lo
// and shift: nchunks chunks of chunk_elems); starts: the partition's starts,
// cat_words >= F + 1 a chunk; cnt, sums: F * sl_words int32 each (16-byte
// aligned, sl_words a multiple of 4 and >= 2^shift), overwritten.
int hbrj_table_build(const int* rk, const int* rp, const int* starts, int nchunks,
                     int chunk_elems, int cat_words, int* cnt, int* sums, int F, int lo,
                     int hi, int shift, int sl_words, cudaStream_t stream) {
  const int smem = 2 * sl_words * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      table_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  const int threads = sl_words >= 8192 ? 1024 : 256;
  // lanes a run: the power of two at or above the mean run, at most a warp
  const int mean_run = chunk_elems / F;
  int group = 1;
  while (group < kWarp && group < mean_run) group *= 2;
  table_build_kernel<<<(unsigned)F, threads, smem, stream>>>(
      rk, rp, starts, nchunks, chunk_elems, cat_words, cnt, sums, lo, hi, shift, sl_words,
      group);
  return (int)cudaGetLastError();
}

// cnt, sums: the tables (F * sl_words int32 each, 16-byte aligned, sl_words
// a multiple of 4, >= 2^shift and <= kRangeWords); s, sp: partitioned S's
// keys and payloads (sp null: keys only), nchunks chunks of chunk_elems (a
// multiple of 128); starts: the S partition's starts, cat_words >= F + 1 a
// chunk; out: three uint64 words (count, r_sum, s_sum; the sums < 2^32),
// overwritten.
int hbrj_table_probe(const int* cnt, const int* sums, const int* s, const int* sp,
                     const int* starts, int nchunks, int chunk_elems, int cat_words,
                     unsigned long long* out, int lo, int shift, int F, int sl_words,
                     cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, 3 * sizeof(unsigned long long), stream);
  if (err) return (int)err;
  if (sl_words > kRangeWords) return (int)cudaErrorInvalidValue;
  const Range r = plan_range(F, sl_words, chunk_elems);
  const auto kernel = sp ? table_probe_kernel<true> : table_probe_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
  if (err) return (int)err;
  kernel<<<(unsigned)((F + r.nb - 1) / r.nb), kRangeThreads, r.smem, stream>>>(
      cnt, sums, s, sp, starts, nchunks, chunk_elems, cat_words, out, lo, shift, F,
      sl_words, r.nb, r.group);
  return (int)cudaGetLastError();
}

// As hbrj_table_probe, with S's payloads required; out_r, out_s, out_k:
// nchunks * chunk_elems int32 each (16-byte aligned), every slot written;
// count: one uint64, overwritten.
int hbrj_materialize(const int* cnt, const int* sums, const int* s, const int* sp,
                     const int* starts, int nchunks, int chunk_elems, int cat_words,
                     int* out_r, int* out_s, int* out_k, unsigned long long* count,
                     int lo, int shift, int F, int sl_words, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), stream);
  if (err) return (int)err;
  if (sl_words > kRangeWords) return (int)cudaErrorInvalidValue;
  const int parts = (chunk_elems + kFillSpan - 1) / kFillSpan;
  const long long fill_grid = (long long)nchunks * parts;
  if (fill_grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (fill_grid) {
    pad_fill_kernel<<<(unsigned)fill_grid, kFillThreads, 0, stream>>>(
        starts, chunk_elems, cat_words, F, parts, out_r, out_s, out_k);
    if ((err = cudaGetLastError())) return (int)err;
  }
  const Range r = plan_range(F, sl_words, chunk_elems);
  err = cudaFuncSetAttribute(materialize_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
  if (err) return (int)err;
  materialize_kernel<<<(unsigned)((F + r.nb - 1) / r.nb), kRangeThreads, r.smem, stream>>>(
      cnt, sums, s, sp, starts, nchunks, chunk_elems, cat_words, out_r, out_s, out_k, count,
      lo, shift, F, sl_words, r.nb, r.group);
  return (int)cudaGetLastError();
}

}  // extern "C"
