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
// Build: one thread per element of partitioned R (16-byte loads of keys and
// payloads); a key in [lo, hi] adds 1 to its count slot and its payload to
// its sum slot with atomicAdd.  The TPU had no scatter and deposited both
// through the MXU, the payload in four 8-bit limbs so each f32 sum stayed
// exact; atomics are exact for any multiplicity and wrap the sum mod 2^32
// like the reference's unsigned checksums.  The tables are zeroed first.
// Bound: one read of R's two columns and one write of the two tables, but
// the atomics land on random 4-byte slots of tables far larger than L2 (1 GiB
// at workload B), so each costs a sector read-modify-write; keeping a
// bucket's two slices in shared memory, driven by the partition's starts,
// is the known next step.
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

__device__ __forceinline__ void deposit(int key, int pay, int* __restrict__ cnt,
                                        unsigned* __restrict__ sums, int lo, int hi,
                                        int shift, long long sl_words) {
  if (key < lo || key > hi) return;
  const unsigned norm = (unsigned)key - (unsigned)lo;
  const long long slot =
      (long long)(norm >> shift) * sl_words + (norm & ((1u << shift) - 1u));
  atomicAdd(cnt + slot, 1);
  atomicAdd(sums + slot, (unsigned)pay);
}

__global__ void table_build_kernel(const int4* __restrict__ rk,
                                   const int4* __restrict__ rp, long long n4,
                                   int* __restrict__ cnt, unsigned* __restrict__ sums,
                                   int lo, int hi, int shift, long long sl_words) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 k = rk[i];
    const int4 p = rp[i];
    deposit(k.x, p.x, cnt, sums, lo, hi, shift, sl_words);
    deposit(k.y, p.y, cnt, sums, lo, hi, shift, sl_words);
    deposit(k.z, p.z, cnt, sums, lo, hi, shift, sl_words);
    deposit(k.w, p.w, cnt, sums, lo, hi, shift, sl_words);
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

// rk, rp: n int32 keys and payloads (n % 4 == 0, 16-byte aligned);
// cnt, sums: nslots int32 each, overwritten.
int hbrj_table_build(const int* rk, const int* rp, long long n, int* cnt, int* sums,
                     long long nslots, int lo, int hi, int shift, long long sl_words,
                     cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)nslots * sizeof(int), stream);
  if (err) return (int)err;
  if ((err = cudaMemsetAsync(sums, 0, (size_t)nslots * sizeof(int), stream)))
    return (int)err;
  const long long n4 = n / 4;
  if (n4) {
    table_build_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(rk), reinterpret_cast<const int4*>(rp), n4, cnt,
        reinterpret_cast<unsigned*>(sums), lo, hi, shift, sl_words);
  }
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
