// Count/payload-sum table build and probe of the count-table engines
// (PRHO, PRH, NPO, PRO over a non-unique build side; Hopper, sm_90a).
//
// Replaces the Pallas kernels of hwbloomradixjoin_tpu/ops/prho_join.py:
//   hbrj_table_build  <- build_tables_pallas (_build_kernel_for, prho_join.py:81)
//   hbrj_table_probe  <- probe_count_sums    (_probe_kernel_for, prho_join.py:252)
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
// Probe: streams partitioned S flat (and its payloads when given), 16 bytes
// per thread and load.  A key counts when its ARITHMETIC bucket (int32-wrapped
// key - lo) >> shift lies in [0, F), the TPU kernel's bucket test; its count c
// and payload sum p are gathered, and the thread accumulates count += c
// (64-bit), r_sum += p and s_sum += s_pay * c (both uint32, wrapping).  PAD,
// keys below lo and keys above hi in the last bucket read zero slots or fail
// the test, so no DMA window or ownership descriptor is needed.  Each block
// reduces, then adds once into the 3-word output: word 0 the count, the low
// halves of words 1 and 2 the two sums (32-bit atomics, so they wrap).
// Bound: the S stream plus one gather of two 4-byte slots per in-range key.
//
//   hbrj_materialize  <- materialize_pairs (_materialize_kernel_for, prho_join.py:647)
//
// Materialize (unique R: every count slot 0 or 1, so the payload-sum slot is
// the R payload): the probe's flat stream and bucket test, writing three
// int32 images congruent with partitioned S, slot i = (r_pay, s_pay, key) of
// S key i where its count slot is > 0 and PAD elsewhere, plus the match count
// (block-reduced, one 64-bit atomic per block).  The TPU kernel staged each
// chunk's run window into VMEM and emitted a staged-order image with window
// slack; the flat image has no slack and no descriptors.  Order is not part
// of the contract: the pair multiset and the count are.  Bound: bytes, the
// S stream in (keys, payloads), the three images out, and one gather of two
// 4-byte slots per in-range key.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
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

struct Sums {
  unsigned long long count;
  unsigned r_sum, s_sum;
};

__device__ __forceinline__ void probe_one(int key, int s_pay, const int* __restrict__ cnt,
                                          const unsigned* __restrict__ sums, int lo,
                                          int shift, int F, long long sl_words, Sums& acc) {
  const int norm = (int)((unsigned)key - (unsigned)lo);   // int32 wrap, as on the TPU
  const int b = norm >> shift;                            // arithmetic shift
  if (b < 0 || b >= F) return;
  const long long slot =
      (long long)b * sl_words + ((unsigned)norm & ((1u << shift) - 1u));
  const unsigned c = (unsigned)__ldg(cnt + slot);
  acc.count += c;
  acc.r_sum += __ldg(sums + slot);
  acc.s_sum += (unsigned)s_pay * c;
}

template <bool kWithSpay>
__global__ void table_probe_kernel(const int* __restrict__ cnt,
                                   const unsigned* __restrict__ sums,
                                   const int4* __restrict__ s, const int4* __restrict__ sp,
                                   long long n4, unsigned long long* __restrict__ out,
                                   int lo, int shift, int F, long long sl_words) {
  Sums acc{0ull, 0u, 0u};
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 k = s[i];
    const int4 p = kWithSpay ? sp[i] : make_int4(0, 0, 0, 0);
    probe_one(k.x, p.x, cnt, sums, lo, shift, F, sl_words, acc);
    probe_one(k.y, p.y, cnt, sums, lo, shift, F, sl_words, acc);
    probe_one(k.z, p.z, cnt, sums, lo, shift, F, sl_words, acc);
    probe_one(k.w, p.w, cnt, sums, lo, shift, F, sl_words, acc);
  }
  using Reduce64 = cub::BlockReduce<unsigned long long, kThreads>;
  using Reduce32 = cub::BlockReduce<unsigned, kThreads>;
  __shared__ typename Reduce64::TempStorage t_count;
  __shared__ typename Reduce32::TempStorage t_r, t_s;
  const unsigned long long count = Reduce64(t_count).Sum(acc.count);
  const unsigned r_sum = Reduce32(t_r).Sum(acc.r_sum);
  const unsigned s_sum = Reduce32(t_s).Sum(acc.s_sum);
  if (threadIdx.x == 0) {
    if (count) atomicAdd(out, count);
    // little-endian: the low half of a zeroed 64-bit word, so the sum wraps
    if (r_sum) atomicAdd(reinterpret_cast<unsigned*>(out + 1), r_sum);
    if (s_sum) atomicAdd(reinterpret_cast<unsigned*>(out + 2), s_sum);
  }
}

constexpr int kPadKey = INT32_MIN;

struct Pair {
  int r, s, k;
};

__device__ __forceinline__ Pair emit(int key, int s_pay, const int* __restrict__ cnt,
                                     const int* __restrict__ sums, int lo, int shift,
                                     int F, long long sl_words,
                                     unsigned long long& count) {
  const int norm = (int)((unsigned)key - (unsigned)lo);   // int32 wrap, as on the TPU
  const int b = norm >> shift;                            // arithmetic shift
  if (b < 0 || b >= F) return {kPadKey, kPadKey, kPadKey};
  const long long slot =
      (long long)b * sl_words + ((unsigned)norm & ((1u << shift) - 1u));
  if (__ldg(cnt + slot) <= 0) return {kPadKey, kPadKey, kPadKey};
  ++count;
  return {__ldg(sums + slot), s_pay, key};
}

// Flat stream over partitioned S, 16 bytes of keys and of payloads a thread
// and step; three int4 stores of the pair image, PAD where no match.
__global__ void materialize_kernel(const int* __restrict__ cnt,
                                   const int* __restrict__ sums,
                                   const int4* __restrict__ s, const int4* __restrict__ sp,
                                   long long n4, int4* __restrict__ out_r,
                                   int4* __restrict__ out_s, int4* __restrict__ out_k,
                                   unsigned long long* __restrict__ out_count, int lo,
                                   int shift, int F, long long sl_words) {
  unsigned long long count = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 k = s[i];
    const int4 p = sp[i];
    const Pair x = emit(k.x, p.x, cnt, sums, lo, shift, F, sl_words, count);
    const Pair y = emit(k.y, p.y, cnt, sums, lo, shift, F, sl_words, count);
    const Pair z = emit(k.z, p.z, cnt, sums, lo, shift, F, sl_words, count);
    const Pair w = emit(k.w, p.w, cnt, sums, lo, shift, F, sl_words, count);
    out_r[i] = make_int4(x.r, y.r, z.r, w.r);
    out_s[i] = make_int4(x.s, y.s, z.s, w.s);
    out_k[i] = make_int4(x.k, y.k, z.k, w.k);
  }
  using Reduce64 = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename Reduce64::TempStorage t_count;
  const unsigned long long total = Reduce64(t_count).Sum(count);
  if (threadIdx.x == 0 && total) atomicAdd(out_count, total);
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

// s: n int32 keys (n % 4 == 0, 16-byte aligned); sp: their payloads or null;
// out: three uint64 words (count, r_sum, s_sum; the sums < 2^32), overwritten.
int hbrj_table_probe(const int* cnt, const int* sums, const int* s, const int* sp,
                     long long n, unsigned long long* out, int lo, int shift, int F,
                     long long sl_words, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, 3 * sizeof(unsigned long long), stream);
  if (err) return (int)err;
  const long long n4 = n / 4;
  if (n4) {
    const unsigned grid = hbrj::grid_for(n4, kThreads);
    const auto* tbl = reinterpret_cast<const unsigned*>(sums);
    const auto* s4 = reinterpret_cast<const int4*>(s);
    if (sp) {
      table_probe_kernel<true><<<grid, kThreads, 0, stream>>>(
          cnt, tbl, s4, reinterpret_cast<const int4*>(sp), n4, out, lo, shift, F,
          sl_words);
    } else {
      table_probe_kernel<false><<<grid, kThreads, 0, stream>>>(
          cnt, tbl, s4, nullptr, n4, out, lo, shift, F, sl_words);
    }
  }
  return (int)cudaGetLastError();
}

// s, sp: n int32 keys and payloads (n % 4 == 0, 16-byte aligned); out_r,
// out_s, out_k: n int32 each, overwritten; count: one uint64, overwritten.
int hbrj_materialize(const int* cnt, const int* sums, const int* s, const int* sp,
                     long long n, int* out_r, int* out_s, int* out_k,
                     unsigned long long* count, int lo, int shift, int F,
                     long long sl_words, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), stream);
  if (err) return (int)err;
  const long long n4 = n / 4;
  if (n4) {
    materialize_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
        cnt, sums, reinterpret_cast<const int4*>(s), reinterpret_cast<const int4*>(sp),
        n4, reinterpret_cast<int4*>(out_r), reinterpret_cast<int4*>(out_s),
        reinterpret_cast<int4*>(out_k), count, lo, shift, F, sl_words);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
