// The bucket-range walks over a partition's runs (Hopper, sm_90a): the
// probes' (walk_runs: the bitmap probe of csrc/bitmap_join.cu and the bloom
// probe of csrc/bloom.cu) and the bitmap build's (walk_share, at the end).
//
// Input: keys partitioned into nseg segments of seg_elems keys, each with a
// starts row of cat_words words (entry j = the segment's keys of bucket < j,
// suffix-filled): partition chunks, where bucket j of every chunk is bucket
// j, or pass-2 regions, where bucket j of region r is bucket
// r * seg_buckets + j.  A CTA owns a range of nb buckets of a segment's
// seg_buckets and a span of `span` segments (1 for regions, whose buckets
// exist in one segment only): blockIdx.x = span index * nranges + range
// index.  Thread 0 stages the range's slices in shared memory with TMA bulk
// copies against an mbarrier; meanwhile the threads read their first
// segment's bounds.  Then a group of `group` lanes a segment (the whole CTA
// when runs are long) takes, in every segment of the span, its share of
// the pad run [starts[s][seg_buckets], seg_elems) (split evenly over the
// span's nranges CTAs) and the merged run [starts[s][j0], starts[s][j1]),
// 16 bytes a load, the next segment's bounds fetched ahead.  Every bound is
// clamped to the segment, so a truncated region is read only where it was
// written.  Each key of a segment is visited once by exactly one CTA: the
// host's split (ops/run_split.py) mirrors cta_work and the pad shares.
#pragma once

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace hbrj {

struct RunGrid {
  int nseg;          // segments: partition chunks or pass-2 regions
  int seg_elems;     // keys a segment
  int cat_words;     // starts words a segment
  int seg_buckets;   // buckets a segment (its pad category is seg_buckets)
  int regions;       // 1: bucket j of segment s is s * seg_buckets + j
  int nb;            // buckets a CTA
  int span;          // segments a CTA
  int group;         // lanes a merged run (a power of two <= blockDim.x)

  __host__ __device__ int nranges() const { return (seg_buckets + nb - 1) / nb; }
  __host__ __device__ int nspans() const { return (nseg + span - 1) / span; }
};

struct CtaWork {
  int range;       // range index, of nranges
  int j0, j1;      // the CTA's buckets of each segment
  int s0, s1;      // its segments
  long long gb0;   // global index of bucket j0 (of segment s0 for regions)
};

__device__ __forceinline__ CtaWork cta_work(const RunGrid& g) {
  CtaWork w;
  const int nr = g.nranges();
  w.range = (int)(blockIdx.x % nr);
  const int sp = (int)(blockIdx.x / nr);
  w.j0 = w.range * g.nb;
  w.j1 = min(w.j0 + g.nb, g.seg_buckets);
  w.s0 = sp * g.span;
  w.s1 = min(w.s0 + g.span, g.nseg);
  w.gb0 = g.regions ? (long long)w.s0 * g.seg_buckets + w.j0 : (long long)w.j0;
  return w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Starts the copy of nbk slices into dst: slice b (global bucket gb0 + b) is
// `live` words at word (gb0 + b) * stride of src and lands at word b * live
// of dst.  One bulk copy when live == stride (contiguous slices), else one a
// slice spread over warp 0's lanes; all complete a transaction count on
// *bar, which thread 0 initialises and arms first.  live and stride are
// multiples of 4 words; src and dst 16-byte aligned.  Every thread passes
// the block barrier inside; none waits for the data here.
__device__ __forceinline__ void stage_slices(unsigned* dst,
                                             const unsigned* __restrict__ src,
                                             long long gb0, int nbk, long long stride,
                                             int live, unsigned long long* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const unsigned bytes = (unsigned)live * 4u;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_addr(bar)),
                 "r"((unsigned)nbk * bytes)
                 : "memory");
  }
  __syncwarp();
  const bool whole = live == stride;
  const int copies = whole ? 1 : nbk;
  const unsigned size = whole ? (unsigned)nbk * bytes : bytes;
  for (int b = (int)threadIdx.x; b < copies; b += 32) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_addr(dst + (long long)b * live)),
        "l"(src + (gb0 + b) * stride), "r"(size), "r"(smem_addr(bar))
        : "memory");
  }
}

// Blocks until the slices have landed (phase 0 of *bar has completed).
__device__ __forceinline__ void wait_slices(unsigned long long* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// A segment's bounds for the CTA: its merged run [run0, run1) and its share
// [pad0, pad1) of the pad run [starts[s][seg_buckets], seg_elems), the pad
// run split evenly over the span's nranges CTAs; all clamped to the segment.
struct SegBounds {
  int run0, run1, pad0, pad1;
};

__device__ __forceinline__ SegBounds seg_bounds(const int* __restrict__ starts,
                                                const RunGrid& g, const CtaWork& w, int s) {
  const int* st = starts + (long long)s * g.cat_words;
  SegBounds b;
  b.run0 = min(__ldg(st + w.j0), g.seg_elems);
  b.run1 = min(__ldg(st + w.j1), g.seg_elems);
  const int p0 = min(__ldg(st + g.seg_buckets), g.seg_elems);
  const long long len = g.seg_elems - p0;
  const int nr = g.nranges();
  b.pad0 = p0 + (int)(len * w.range / nr);
  b.pad1 = p0 + (int)(len * (w.range + 1) / nr);
  return b;
}

// Walks the CTA's part of every segment s of its span, a group of `group`
// lanes a segment, the next segment's bounds fetched ahead:
// - pad(base, pad0, pad1, lane): the segment's pad share (keys at flat
//   indices base + [pad0, pad1)), before the slices are awaited;
// - the merged run [run0, run1): its 16-byte-aligned body a quad of keys at
//   a time, kQuads quads a lane loaded before the first is visited,
//   visit4(flat index of the quad's first key, quad); its at most 3 + 3 keys
//   before and after the body, visit(flat index, key).
// Every visit comes after the slices have landed; every thread waits for
// them before it returns, so no CTA retires while its copy is in flight.
// keys is 16-byte aligned and seg_elems a multiple of 4.
template <int kQuads, typename Pad, typename Visit, typename Visit4>
__device__ __forceinline__ void walk_runs(const int* __restrict__ keys,
                                          const int* __restrict__ starts, const RunGrid& g,
                                          const CtaWork& w, unsigned long long* bar,
                                          Pad pad, Visit visit, Visit4 visit4) {
  const int lane = (int)threadIdx.x % g.group;
  const int ngroups = (int)blockDim.x / g.group;
  const int4* quads = reinterpret_cast<const int4*>(keys);
  int s = w.s0 + (int)threadIdx.x / g.group;
  SegBounds cur{0, 0, 0, 0};
  if (s < w.s1) cur = seg_bounds(starts, g, w, s);
  bool ready = false;
  while (s < w.s1) {
    const int next = s + ngroups;
    SegBounds nxt{0, 0, 0, 0};
    if (next < w.s1) nxt = seg_bounds(starts, g, w, next);
    const long long base = (long long)s * g.seg_elems;
    pad(base, cur.pad0, cur.pad1, lane);
    const int q0 = (cur.run0 + 3) >> 2;                 // the body: quads [q0, q1)
    const int q1 = max(q0, cur.run1 >> 2);
    const int head1 = min(cur.run1, q0 << 2);
    const int tail0 = max(q1 << 2, head1);
    const long long qbase = base >> 2;
    for (int q = q0 + lane; q < q1; q += kQuads * g.group) {
      int4 v[kQuads];
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const int qi = q + j * g.group;
        v[j] = qi < q1 ? __ldg(quads + qbase + qi) : make_int4(0, 0, 0, 0);
      }
      if (!ready) {
        wait_slices(bar);
        ready = true;
      }
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const int qi = q + j * g.group;
        if (qi < q1) visit4((qbase + qi) << 2, v[j]);
      }
    }
    const int nhead = head1 - cur.run0, nedge = nhead + max(0, cur.run1 - tail0);
    for (int e = lane; e < nedge; e += g.group) {
      const int idx = e < nhead ? cur.run0 + e : tail0 + (e - nhead);
      const int key = __ldg(keys + base + idx);
      if (!ready) {
        wait_slices(bar);
        ready = true;
      }
      visit(base + idx, key);
    }
    s = next;
    cur = nxt;
  }
  if (!ready) wait_slices(bar);
}

// The build's walk: a range's runs shared evenly by the CTAs of a cluster.
//
// A range of nb buckets belongs to a cluster of `share` CTAs.  The range's
// pieces, in segment order, are each segment's merged run [starts[s][j0],
// starts[s][j1]) and the range's share of the segment's pad run (split
// evenly over the nranges ranges, as seg_bounds splits it).  Their
// concatenation is split evenly over the cluster's CTAs, and a CTA's part
// evenly over its warps; a warp walks its part 16 bytes a lane.  So every
// CTA and warp of a range walks as many keys as any other, however the keys
// fall among the segments: a bucket holding a chunk's padding (PAD in a
// junk bucket, where the geometry has no pad category) is walked by its
// whole cluster.  Every bound is clamped to its segment.  The host's split
// (ops/run_split.py plan_share_split, share_pieces) mirrors this walk.
struct ShareGrid {
  int nseg;          // segments (partition chunks)
  int seg_elems;     // keys a segment
  int cat_words;     // starts words a segment
  int seg_buckets;   // buckets a segment (its pad category is seg_buckets)
  int nb;            // buckets a range
  int share;         // CTAs a range: the cluster's size (cluster c owns range c)

  __host__ __device__ int nranges() const { return (seg_buckets + nb - 1) / nb; }
  // Shared-memory bytes of the table share_table fills: nseg + 1 offsets
  // (rounded up to 16 bytes) and nseg int4 bounds.
  __host__ __device__ int table_bytes() const {
    return ((nseg + 2) & ~1) * 8 + nseg * 16;
  }
};

// Segment s's pieces for range `range` (buckets [j0, j1)): {run0, run1,
// pad0, pad1}, clamped to [0, seg_elems] with run1 >= run0.
__device__ __forceinline__ int4 share_bounds(const int* __restrict__ starts,
                                             const ShareGrid& g, int range, int j0,
                                             int j1, int s) {
  const int* st = starts + (long long)s * g.cat_words;
  const int run0 = min(max(__ldg(st + j0), 0), g.seg_elems);
  const int run1 = max(run0, min(__ldg(st + j1), g.seg_elems));
  const int p0 = min(max(__ldg(st + g.seg_buckets), 0), g.seg_elems);
  const long long len = g.seg_elems - p0;
  const int nr = g.nranges();
  return make_int4(run0, run1, p0 + (int)(len * range / nr),
                   p0 + (int)(len * (range + 1) / nr));
}

// Fills off[0..nseg] (off[s]: the concatenation's position of segment s's
// first piece; off[nseg]: its length) and seg[0..nseg) (share_bounds) in
// shared memory, a block-wide scan a batch of kThreads segments.  Every
// thread calls it; it ends with a block barrier.
template <int kThreads>
__device__ __forceinline__ void share_table(const int* __restrict__ starts,
                                            const ShareGrid& g, int range, int j0,
                                            int j1, long long* off, int4* seg) {
  using Scan = cub::BlockScan<long long, kThreads>;
  __shared__ typename Scan::TempStorage temp;
  long long carry = 0;
  for (int b0 = 0; b0 < g.nseg; b0 += kThreads) {
    const int s = b0 + (int)threadIdx.x;
    long long len = 0;
    if (s < g.nseg) {
      const int4 b = share_bounds(starts, g, range, j0, j1, s);
      seg[s] = b;
      len = (long long)(b.y - b.x) + (b.w - b.z);
    }
    long long excl, total;
    Scan(temp).ExclusiveSum(len, excl, total);
    if (s < g.nseg) off[s] = carry + excl;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) off[g.nseg] = carry;
  __syncthreads();
}

// A warp's walk of keys [i0, i1) of the segment at flat index base (a
// multiple of 4): the 16-byte-aligned body kQuads quads a lane loaded before
// any is visited, then the at most 3 + 3 keys before and after it.
template <int kQuads, typename Visit>
__device__ __forceinline__ void walk_interval(const int* __restrict__ keys,
                                              long long base, int i0, int i1,
                                              int lane, Visit& visit) {
  const int4* quads = reinterpret_cast<const int4*>(keys) + (base >> 2);
  const int q0 = (i0 + 3) >> 2, q1 = max(q0, i1 >> 2);
  for (int q = q0 + lane; q < q1; q += kQuads * 32) {
    int4 v[kQuads];
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int qi = q + j * 32;
      v[j] = qi < q1 ? __ldg(quads + qi) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      if (q + j * 32 < q1) {
        visit(v[j].x);
        visit(v[j].y);
        visit(v[j].z);
        visit(v[j].w);
      }
    }
  }
  const int head1 = min(i1, q0 << 2), tail0 = max(q1 << 2, head1);
  const int nhead = head1 - i0, nedge = nhead + max(0, i1 - tail0);
  if (lane < nedge)
    visit(__ldg(keys + base + (lane < nhead ? i0 + lane : tail0 + (lane - nhead))));
}

// A warp walks positions [v0, v1) of the concatenation share_table laid
// out, visit(key) for each key (every lane of the warp calls it).
template <int kQuads, typename Visit>
__device__ __forceinline__ void walk_share(const int* __restrict__ keys, const ShareGrid& g,
                                           const long long* off, const int4* seg,
                                           long long v0, long long v1, Visit visit) {
  if (v0 >= v1) return;
  const int lane = (int)threadIdx.x & 31;
  int s = 0, hi = g.nseg;          // off[s] <= v0 < off[hi]
  while (hi - s > 1) {
    const int mid = (s + hi) >> 1;
    if (off[mid] <= v0) s = mid; else hi = mid;
  }
  long long pos = v0;
  while (pos < v1) {
    while (off[s + 1] <= pos) ++s;
    const long long o = off[s];
    const int x0 = (int)(pos - o), x1 = (int)(min(v1, off[s + 1]) - o);
    const int4 b = seg[s];
    const int rl = b.y - b.x;
    const long long base = (long long)s * g.seg_elems;
    if (x0 < rl) walk_interval<kQuads>(keys, base, b.x + x0, b.x + min(x1, rl), lane, visit);
    if (x1 > rl)
      walk_interval<kQuads>(keys, base, b.z + max(x0 - rl, 0), b.z + (x1 - rl), lane, visit);
    pos = o + x1;
  }
}

}  // namespace hbrj
