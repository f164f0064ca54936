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
// Build: one bit per R key in [lo, hi]; every word of the bitmap (empty
// slices and each slice's 8-row padding included) is written once.  A flat
// stream of atomicOr into a bitmap zeroed first spread each warp's keys over
// 32 words of a 32 KiB slice (R's runs are shuffled within a bucket): one
// scattered 4-byte L2 transaction a key, atomic or not (a plain store of the
// bit is no faster), held it at ~10x its bound.  So the build walks R
// through its partition's starts (csrc/run_walk.cuh walk_share): a cluster
// of `share` CTAs owns a range of nb buckets; each CTA zero-fills the
// range's live slice words (the first 2^shift bits of each slice) in shared
// memory, walks its even part of the range's runs (and of each chunk's pad
// run) and sets each in-range key's bit with a shared atomicOr; then, after
// a cluster barrier, each CTA ORs its part of the range's words over the
// cluster's shared memory (DSMEM) and stores them, zeros past the live
// words, 16 bytes a store.  No memset, no second pass; the bound is bytes,
// one read of R (and its starts) and one write of the bitmap.  A key of a
// walked run whose bucket lies outside the CTA's range (none, for a
// partition at this geometry) raises a flag; the last CTA to finish (a
// ticket counter) then ORs every in-range key of R into the bitmap with
// global atomics, after every CTA's stores, so the bitmap equals the flat
// build's for any runs.  The host (ops/bitmap_join.py) picks the flat
// class, the grid-stride atomicOr stream over a zeroed bitmap, only where
// one bucket's live slice exceeds the staging budget (a shift past 20).
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"
#include "run_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void deposit_global(int key, unsigned* __restrict__ bm,
                                               int lo, int hi, int shift,
                                               long long sl_words) {
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
    deposit_global(v.x, bm, lo, hi, shift, sl_words);
    deposit_global(v.y, bm, lo, hi, shift, sl_words);
    deposit_global(v.z, bm, lo, hi, shift, sl_words);
    deposit_global(v.w, bm, lo, hi, shift, sl_words);
  }
}

constexpr int kBuildThreads = 256;
constexpr int kBuildCtasPerSm = 5;  // the host's split counts on it (ops/run_split.py)
constexpr int kBuildQuads = 4;    // 16-byte loads a lane issues before it visits any

// The staged class: a cluster a bucket range, each CTA an even part of the
// range's runs; `live` words of each slice in dynamic shared memory, the
// walk's table (ShareGrid::table_bytes) after them.  sync: {ticket counter,
// foreign flag}, zeroed by the host.
__global__ void __launch_bounds__(kBuildThreads, kBuildCtasPerSm)
bitmap_build_runs(const int* __restrict__ r, long long n, const int* __restrict__ starts,
                  hbrj::ShareGrid g, unsigned* __restrict__ bm, unsigned* __restrict__ sync,
                  int lo, int hi, int shift, long long sl_words, int live) {
  extern __shared__ int4 smem4[];
  unsigned* slices = reinterpret_cast<unsigned*>(smem4);
  long long* off = reinterpret_cast<long long*>(smem4 + g.nb * live / 4);
  int4* seg = reinterpret_cast<int4*>(off + ((g.nseg + 2) & ~1));
  __shared__ unsigned last;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int range = (int)(blockIdx.x / g.share);
  const int j0 = range * g.nb, j1 = min(j0 + g.nb, g.seg_buckets), nbk = j1 - j0;
  const int live4 = live / 4;
  for (int i = threadIdx.x; i < nbk * live4; i += kBuildThreads) smem4[i] = make_int4(0, 0, 0, 0);
  hbrj::share_table<kBuildThreads>(starts, g, range, j0, j1, off, seg);

  const long long T = off[g.nseg];
  const long long c0 = T * rank / g.share, c1 = T * (rank + 1) / g.share;
  constexpr int kWarps = kBuildThreads / 32;
  const int warp = (int)threadIdx.x / 32;
  const unsigned local_mask = (1u << shift) - 1u;
  bool foreign = false;
  auto deposit = [&](int key) {
    if (key < lo || key > hi) return;
    const unsigned norm = (unsigned)key - (unsigned)lo;
    const unsigned b = (norm >> shift) - (unsigned)j0;
    if (b < (unsigned)nbk)
      atomicOr(slices + b * live + ((norm & local_mask) >> 5), 1u << (norm & 31u));
    else
      foreign = true;
  };
  hbrj::walk_share<kBuildQuads>(r, g, off, seg, c0 + (c1 - c0) * warp / kWarps,
                                c0 + (c1 - c0) * (warp + 1) / kWarps, deposit);
  cluster.sync();

  // this CTA's part of the range's words: the OR over the cluster's slices
  // where a word is live, 0 past it
  const int qs_bits = __ffsll(sl_words) - 1 - 2;   // quads a slice: sl_words / 4, a power of 2
  const int qslice = 1 << qs_bits;
  const int nq = nbk << qs_bits;
  int4* out = reinterpret_cast<int4*>(bm) + ((long long)j0 << qs_bits);
  const int q1 = (int)((long long)nq * (rank + 1) / g.share);
  for (int q = (int)((long long)nq * rank / g.share) + (int)threadIdx.x; q < q1;
       q += kBuildThreads) {
    const int o = q & (qslice - 1);
    int4 v = make_int4(0, 0, 0, 0);
    if (o < live4) {
      const int at = (q >> qs_bits) * live4 + o;
#pragma unroll 8
      for (int c = 0; c < g.share; ++c) {
        const int4 x = cluster.map_shared_rank(smem4, c)[at];
        v.x |= x.x;
        v.y |= x.y;
        v.z |= x.z;
        v.w |= x.w;
      }
    }
    out[q] = v;
  }
  cluster.sync();   // no CTA leaves while another reads its slices

  if (foreign) *(volatile unsigned*)(sync + 1) = 1u;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sync, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (!*(volatile unsigned*)(sync + 1)) return;
  for (long long i = threadIdx.x; i < n; i += kBuildThreads)
    deposit_global(__ldg(r + i), bm, lo, hi, shift, sl_words);
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

// r: n int32 keys (n % 4 == 0, 16-byte aligned), partitioned into nseg
// segments of seg_elems keys at this geometry (seg_buckets = the bitmap's F
// buckets) with their starts (cat_words a segment); bm: nwords int32,
// overwritten; sync: 2 words of scratch; nb, share: the host's split
// (ops/run_split.py plan_share_split), nb == 0 for the flat class (starts
// and sync unread); live: the words of a slice that keys address (a
// multiple of 4, <= sl_words).
int hbrj_bitmap_build(const int* r, long long n, const int* starts, int* bm,
                      long long nwords, unsigned* sync, int lo, int hi, int shift,
                      long long sl_words, int nseg, int seg_elems, int cat_words,
                      int seg_buckets, int nb, int share, int live,
                      cudaStream_t stream) {
  cudaError_t err;
  if (nb == 0) {
    err = cudaMemsetAsync(bm, 0, (size_t)nwords * sizeof(int), stream);
    if (err) return (int)err;
    const long long n4 = n / 4;
    if (n4) {
      bitmap_build_kernel<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
          reinterpret_cast<const int4*>(r), n4, reinterpret_cast<unsigned*>(bm), lo, hi,
          shift, sl_words);
    }
    return (int)cudaGetLastError();
  }
  const hbrj::ShareGrid g{nseg, seg_elems, cat_words, seg_buckets, nb, share};
  if (nseg <= 0 || (long long)nseg * seg_elems != n || seg_elems % 4 || live % 4
      || live > sl_words || (sl_words & (sl_words - 1)) || share <= 0 || share > 8
      || (long long)seg_buckets * sl_words != nwords)
    return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(sync, 0, 2 * sizeof(unsigned), stream);
  if (err) return (int)err;
  const int smem = nb * live * (int)sizeof(int) + g.table_bytes();
  err = cudaFuncSetAttribute(bitmap_build_runs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.nranges() * share));
  cfg.blockDim = dim3(kBuildThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)share;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bitmap_build_runs, r, n, starts, g,
                           reinterpret_cast<unsigned*>(bm), sync, lo, hi, shift, sl_words,
                           live);
  if (err) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs an SM of the build's staged class at nb buckets of `live`
// words over nseg segments, of its flat class at nb == 0; a CUDA error
// negated.
int hbrj_bitmap_build_per_sm(int nb, int live, int nseg) {
  int n = 0;
  cudaError_t err;
  if (nb == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bitmap_build_kernel, kThreads, 0);
  } else {
    const hbrj::ShareGrid g{nseg, 0, 0, 0, nb, 1};
    const int smem = nb * live * (int)sizeof(int) + g.table_bytes();
    err = cudaFuncSetAttribute(bitmap_build_runs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bitmap_build_runs,
                                                          kBuildThreads, smem);
  }
  return err ? -(int)err : n;
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
