// Exact-bitmap build and probe of the PRO radix join (Hopper, sm_90a).
//
// Replaces the Pallas kernels of hwbloomradixjoin_tpu/ops/bitmap_join.py:
//   hbrj_bitmap_build  <- bitmap_build_pallas (_build_kernel_for, bitmap_join.py:345)
//   hbrj_bitmap_probe  <- bitmap_probe_count  (_probe_kernel_for, bitmap_join.py:223)
//
// Bitmap layout (shared with the JAX package): bucket b = norm >> shift of
// norm = key - lo owns sl_words = sl_rows*128 int32 words starting at word
// b*sl_words; bit (norm & 31) of word (norm & (2^shift-1)) >> 5 is the key.
//
// Build: one bit per R key in [lo, hi], set with atomicOr.  The TPU had no
// scatter and deposited bits with one-hot bf16 matmuls (ADD == OR for unique
// keys); here the deposit is the scatter itself, and OR is exact for any key
// multiset.  The bitmap is zeroed first, so every word (empty slices and the
// 8-row slice padding included) is written.  Bound: one atomic per key on an
// L2-resident bitmap (2 MiB for a 16M key range); R arrives partitioned, so
// neighbouring keys hit neighbouring words of one slice.
//
// Probe: counts the keys of partitioned S whose ARITHMETIC bucket
// (int32-wrapped key - lo) >> shift (the TPU kernel's test) lies in [0, F)
// and whose bit is set; PAD and out-of-range keys never count.  A flat
// stream would read each key's word through a 32-byte L2 sector, and the
// slices of the buckets its resident CTAs sit in overflow L1 (64 of 32 KiB
// at PRO 16M x 128M): locality, not bytes, bound it.  So the probe walks S
// through its partition's starts (csrc/run_walk.cuh): a CTA owns a range of
// buckets and a span of segments (partition chunks, or pass-2 regions whose
// bucket j of region r is r * F2 + j), stages the range's live slice words
// (the first 2^shift bits of each slice; the 8-row padding past them is
// never addressed) in shared memory with TMA, and tests every key of the
// range's merged run in each segment there.  A key of a walked run whose
// bucket lies outside the range (none, for a consistent partition) and the
// keys of each segment's pad run (PAD, chunk padding, keys outside [lo, hi],
// shared among the span's CTAs) are tested against the bitmap in device
// memory, so the count equals the flat test's for any bitmap.  Bound: bytes,
// one read of S (and its starts); each slice is copied once a span, from
// L2.  The host picks the flat class instead (ops/bitmap_join.py) where one
// slice exceeds the staging budget (a shift past 20), where live slices are
// small enough to stay in L1 (4d's 512 bytes), and where S is small against
// the bitmap (a skewed S at q = 0.01 would leave one CTA the hot bucket's
// runs): a grid-stride stream, 16 bytes a thread and load, with the bitmap
// in device memory.  The count accumulates in 64 bits per thread, then per
// block, then one atomicAdd per block.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"
#include "run_walk.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void deposit(int key, unsigned* __restrict__ bm, int lo,
                                        int hi, int shift, long long sl_words) {
  if (key < lo || key > hi) return;
  const unsigned norm = (unsigned)key - (unsigned)lo;
  const unsigned local = norm & ((1u << shift) - 1u);
  atomicOr(bm + (long long)(norm >> shift) * sl_words + (local >> 5), 1u << (norm & 31u));
}

__global__ void bitmap_build_kernel(const int4* __restrict__ r, long long n4,
                                    unsigned* __restrict__ bm, int lo, int hi,
                                    int shift, long long sl_words) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 v = r[i];
    deposit(v.x, bm, lo, hi, shift, sl_words);
    deposit(v.y, bm, lo, hi, shift, sl_words);
    deposit(v.z, bm, lo, hi, shift, sl_words);
    deposit(v.w, bm, lo, hi, shift, sl_words);
  }
}

__device__ __forceinline__ unsigned hit(int key, const unsigned* __restrict__ bm,
                                        int lo, int shift, int F, long long sl_words) {
  const int norm = (int)((unsigned)key - (unsigned)lo);   // int32 wrap, as on the TPU
  const int b = norm >> shift;                            // arithmetic shift
  if (b < 0 || b >= F) return 0u;
  const unsigned local = (unsigned)norm & ((1u << shift) - 1u);
  return (__ldg(bm + (long long)b * sl_words + (local >> 5)) >> (norm & 31)) & 1u;
}

template <int kBlock>
__device__ __forceinline__ void add_block_total(unsigned long long c,
                                                unsigned long long* __restrict__ out) {
  using Reduce = cub::BlockReduce<unsigned long long, kBlock>;
  __shared__ typename Reduce::TempStorage temp;
  const unsigned long long total = Reduce(temp).Sum(c);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

// The flat class: a grid-stride stream of S, the bitmap in device memory.
__global__ void bitmap_probe_kernel(const unsigned* __restrict__ bm,
                                    const int4* __restrict__ s, long long n4,
                                    unsigned long long* __restrict__ out, int lo,
                                    int shift, int F, long long sl_words) {
  unsigned long long c = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 v = s[i];
    c += hit(v.x, bm, lo, shift, F, sl_words) + hit(v.y, bm, lo, shift, F, sl_words)
       + hit(v.z, bm, lo, shift, F, sl_words) + hit(v.w, bm, lo, shift, F, sl_words);
  }
  add_block_total<kThreads>(c, out);
}

constexpr int kRunThreads = 256;
constexpr int kQuads = 4;   // 16-byte loads a lane issues before it tests any

// The staged class: a CTA a bucket range and span of segments; `live`
// words of each slice in dynamic shared memory.
__global__ void __launch_bounds__(kRunThreads)
bitmap_probe_runs(const unsigned* __restrict__ bm, const int* __restrict__ s,
                  const int* __restrict__ starts, hbrj::RunGrid g,
                  unsigned long long* __restrict__ out, int lo, int shift, int F,
                  long long sl_words, int live) {
  extern __shared__ int4 smem4[];
  unsigned* slices = reinterpret_cast<unsigned*>(smem4);
  __shared__ unsigned long long bar;
  const hbrj::CtaWork w = hbrj::cta_work(g);
  const long long gb1 = w.gb0 + (w.j1 - w.j0);
  hbrj::stage_slices(slices, bm, w.gb0, w.j1 - w.j0, sl_words, live, &bar);
  const unsigned local_mask = (1u << shift) - 1u;
  auto test = [&](int key) -> unsigned {
    const int norm = (int)((unsigned)key - (unsigned)lo);
    const int b = norm >> shift;
    if (b < 0 || b >= F) return 0u;
    const unsigned word = ((unsigned)norm & local_mask) >> 5;
    const unsigned bits = b >= w.gb0 && b < gb1
        ? slices[(b - w.gb0) * live + word]
        : __ldg(bm + (long long)b * sl_words + word);
    return (bits >> (norm & 31)) & 1u;
  };
  unsigned long long c = 0;
  hbrj::walk_runs<kQuads>(
      s, starts, g, w, &bar,
      [&](long long base, int p0, int p1, int lane) {   // the pad share
        for (int i = p0 + lane; i < p1; i += g.group)
          c += hit(__ldg(s + base + i), bm, lo, shift, F, sl_words);
      },
      [&](long long, int key) { c += test(key); },
      [&](long long, int4 v) { c += test(v.x) + test(v.y) + test(v.z) + test(v.w); });
  add_block_total<kRunThreads>(c, out);
}

}  // namespace

extern "C" {

// r: n int32 keys (n % 4 == 0, 16-byte aligned); bm: nwords int32, overwritten.
int hbrj_bitmap_build(const int* r, long long n, int* bm, long long nwords, int lo,
                      int hi, int shift, long long sl_words, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(bm, 0, (size_t)nwords * sizeof(int), stream);
  if (err) return (int)err;
  const long long n4 = n / 4;
  if (n4) {
    bitmap_build_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(r), n4, reinterpret_cast<unsigned*>(bm), lo, hi,
        shift, sl_words);
  }
  return (int)cudaGetLastError();
}

// s: n int32 keys (n % 4 == 0, 16-byte aligned), partitioned into nseg
// segments of seg_elems keys (range mode over lo and shift) with their
// starts (cat_words a segment, seg_buckets buckets; regions: bucket j of
// segment r is r * seg_buckets + j); nb, span, group: the host's split
// (ops/run_split.py), nb == 0 for the flat class (starts unread); live: the
// words of a slice that keys address (a multiple of 4, <= sl_words); out:
// one uint64, overwritten.
int hbrj_bitmap_probe(const int* bm, const int* s, long long n, const int* starts,
                      unsigned long long* out, int lo, int shift, int F,
                      long long sl_words, int nseg, int seg_elems, int cat_words,
                      int seg_buckets, int regions, int nb, int span, int group,
                      int live, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (err) return (int)err;
  if (nb == 0) {
    const long long n4 = n / 4;
    if (n4) {
      bitmap_probe_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
          reinterpret_cast<const unsigned*>(bm), reinterpret_cast<const int4*>(s), n4,
          out, lo, shift, F, sl_words);
    }
    return (int)cudaGetLastError();
  }
  const hbrj::RunGrid g{nseg, seg_elems, cat_words, seg_buckets, regions, nb, span, group};
  if (nseg <= 0 || (long long)nseg * seg_elems != n || live % 4 || live > sl_words
      || group <= 0 || group > kRunThreads || kRunThreads % group || span <= 0
      || (regions && span != 1))
    return (int)cudaErrorInvalidValue;
  const int smem = nb * live * (int)sizeof(int);
  err = cudaFuncSetAttribute(bitmap_probe_runs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err) return (int)err;
  const long long grid = (long long)g.nranges() * g.nspans();
  bitmap_probe_runs<<<(unsigned)grid, kRunThreads, smem, stream>>>(
      reinterpret_cast<const unsigned*>(bm), s, starts, g, out, lo, shift, F, sl_words,
      live);
  return (int)cudaGetLastError();
}

// Resident CTAs an SM of the class a split picks: the staged class at nb
// buckets of `live` words, the flat class at nb == 0; a CUDA error negated.
int hbrj_bitmap_probe_per_sm(int nb, int live) {
  int n = 0;
  cudaError_t err;
  if (nb == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bitmap_probe_kernel, kThreads,
                                                        0);
  } else {
    const int smem = nb * live * (int)sizeof(int);
    err = cudaFuncSetAttribute(bitmap_probe_runs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bitmap_probe_runs,
                                                          kRunThreads, smem);
  }
  return err ? -(int)err : n;
}

}  // extern "C"
