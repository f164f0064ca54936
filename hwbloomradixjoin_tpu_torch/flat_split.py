"""Split the flat kernels' time on the card: what bounds a grid-stride probe
or build.

    python -m hwbloomradixjoin_tpu_torch.flat_split

Builds variants of the flat bitmap probe and the flat bloom probe (the
grid-stride design that ``csrc/bitmap_join.cu`` and ``csrc/bloom.cu`` keep
as their flat classes), one ``nvcc`` for each, all started together, into
the package's git-ignored build directory, and times each over the main
paths' inputs: PRO 16M ⋈ 128M's S partition at q = 1 (6 bits, 64 bitmap
slices of 32 KiB) and 4e's hash-partitioned S (BPRO 16M ⋈ 128M at q = 0.01,
10 of 18 block bits, a 16 MiB filter; ``chip_smoke.py``'s phases 4 and 4e).
Variants:

- ``base``: 256 threads, at most 8 CTAs an SM (the flat design);
- ``ctas4``: at most 4 CTAs an SM of 256 threads, so fewer slices share an
  SM's L1;
- ``ctas32``: at most 32 CTAs an SM of 64 threads, all resident;
- ``no_load``: the bitmap or filter word replaced by a value computed from
  the key (no memory read beside the key stream);
- bloom only, ``no_crc``: crc32c replaced by seed ^ key (no table reads);
  ``crc_lane``: a copy of the byte table a lane (32 KiB, conflict-free);
  ``crc_slice4``: four byte tables read independently (slice-by-4).

The base, ctas and crc variants must equal the port's plain twins bit for
bit; the no_load and no_crc variants compute something else and are only
timed.  Beside them, the port's own kernels through their wrappers at the
same inputs (the staged classes, and the bloom probe's flat class).

Then the bitmap build, over three R partitions as the plans make them:
PRO 16M ⋈ 128M's (6 bits, 64 slices of 32 KiB), 4d's (the same R at 12
bits, 4,096 slices of 512 live bytes) and the flagship's (128M keys, 9
bits, 512 slices of 32 KiB; a shuffled dense key range like the
generator's), from ``BUILD_SOURCE`` (one ``nvcc``, beside the others):

- ``flat_atomic``: the flat build, a zeroed bitmap and one atomicOr a key;
- ``flat_store``: the same with a plain store of the key's bit in place of
  the atomicOr (another result, only timed);
- ``memset``: the zeroing alone;
- ``flat_warp_or``: the atomicOr of a key's bit ORed first over the lanes of
  its warp that hit the same word (``__match_any_sync``), one atomic a word;
- ``staged_atomic_merge``: the port's staged walk and split, without the
  cluster: each CTA ORs its non-zero slice words into a zeroed bitmap with
  global atomics (``staged_atomic_q8``: 8 loads a lane in flight, not 4);

and the port's kernel through its wrapper at the planned split; both
staged builds with 1, 2, 4 and 8 CTAs a range, the port's also at 2 and 4
times the planned buckets a range.  Each build variant is
timed twice: by ``time_usec`` (a call's span, host launch included, as
``chip_smoke.py`` times the kernels) and by its device time in a
``torch.profiler`` trace (``_device``: kernels and memsets a call).  Every variant but ``flat_store`` and
``memset`` must equal the twin bit for bit.  Prints the card line, then one
JSON line.  Runs on the GPU only.
"""

from __future__ import annotations

import ctypes
import json

SOURCE = r"""
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <limits.h>

#ifndef THREADS
#define THREADS 256
#endif
#ifndef CTAS_PER_SM
#define CTAS_PER_SM 8
#endif

namespace {

constexpr unsigned kPoly = 0x82F63B78u;
constexpr int kPad = INT_MIN;

__device__ __forceinline__ unsigned crc_byte(unsigned c) {
  for (int s = 0; s < 8; ++s) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
  return c;
}

#if defined(CRC_LANE)
constexpr int kTableWords = 256 * 32;
#elif defined(CRC_SLICE4)
constexpr int kTableWords = 4 * 256;
#else
constexpr int kTableWords = 256;
#endif

__device__ void table_init(unsigned* t) {
#if defined(CRC_LANE)
  for (int w = threadIdx.x; w < kTableWords; w += blockDim.x) t[w] = crc_byte(w >> 5);
#elif defined(CRC_SLICE4)
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t[i] = crc_byte(i);
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = t[i];
    for (int j = 1; j < 4; ++j) {
      c = (c >> 8) ^ t[c & 0xFFu];
      t[j * 256 + i] = c;
    }
  }
#else
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t[i] = crc_byte(i);
#endif
}

__device__ __forceinline__ unsigned crc32c(const unsigned* t, unsigned seed, int key) {
  unsigned x = seed ^ (unsigned)key;
#if defined(NO_CRC)
  return x;
#elif defined(CRC_LANE)
  const unsigned lane = threadIdx.x & 31u;
  for (int b = 0; b < 4; ++b) x = (x >> 8) ^ t[((x & 0xFFu) << 5) | lane];
  return x;
#elif defined(CRC_SLICE4)
  return t[768 + (x & 0xFFu)] ^ t[512 + ((x >> 8) & 0xFFu)] ^ t[256 + ((x >> 16) & 0xFFu)]
       ^ t[x >> 24];
#else
  for (int b = 0; b < 4; ++b) x = (x >> 8) ^ t[x & 0xFFu];
  return x;
#endif
}

__device__ __forceinline__ unsigned crapwow(unsigned seed, int key) {
  const unsigned n = 0x5052ACDBu;
  unsigned h = 4u, k = 4u + seed + n;
  unsigned in = (unsigned)key;
  h ^= in * n;
  k ^= __umulhi(in, n);
  in = h ^ (k + n);
  h ^= in * n;
  k ^= __umulhi(in, n);
  return k ^ h;
}

__device__ __forceinline__ unsigned word_at(const unsigned* __restrict__ a, long long i) {
#if defined(NO_LOAD)
  return (unsigned)i * 0x9E3779B9u;
#else
  return __ldg(a + i);
#endif
}

__device__ __forceinline__ unsigned hit(int key, const unsigned* __restrict__ bm, int lo,
                                        int shift, int F, long long sl_words) {
  const int norm = (int)((unsigned)key - (unsigned)lo);
  const int b = norm >> shift;
  if (b < 0 || b >= F) return 0u;
  const unsigned local = (unsigned)norm & ((1u << shift) - 1u);
  return (word_at(bm, (long long)b * sl_words + (local >> 5)) >> (norm & 31)) & 1u;
}

__global__ void bitmap_probe(const unsigned* __restrict__ bm, const int4* __restrict__ s,
                             long long n4, unsigned long long* __restrict__ out, int lo,
                             int shift, int F, long long sl_words) {
  unsigned long long c = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const int4 v = s[i];
    c += hit(v.x, bm, lo, shift, F, sl_words) + hit(v.y, bm, lo, shift, F, sl_words)
       + hit(v.z, bm, lo, shift, F, sl_words) + hit(v.w, bm, lo, shift, F, sl_words);
  }
  using Reduce = cub::BlockReduce<unsigned long long, THREADS>;
  __shared__ typename Reduce::TempStorage temp;
  const unsigned long long total = Reduce(temp).Sum(c);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

struct Params {
  unsigned seed, block_mask, B;
  int k;
};

__device__ __forceinline__ bool contains(int key, const unsigned* __restrict__ f,
                                         const Params& p, const unsigned* t) {
  if (key == kPad) return false;
  const unsigned long long base =
      (unsigned long long)(crc32c(t, p.seed, key) & p.block_mask) * p.B;
  const unsigned mask = p.B - 1u;
  unsigned h = crapwow(p.seed, key) & mask;
  unsigned y = ((unsigned)key + p.seed) & mask;
  for (int i = 0; i < p.k; ++i) {
    const unsigned long long pos = base + h;
    if (!((word_at(f, (long long)(pos >> 5)) >> (unsigned)(pos & 31u)) & 1u)) return false;
    h = (h + y) & mask;
    y = (y + (unsigned)i + 1u) & mask;
  }
  return true;
}

__global__ void bloom_probe(const int4* __restrict__ keys, long long n4,
                            const unsigned* __restrict__ f, int4* __restrict__ out,
                            unsigned long long* __restrict__ count, Params p) {
  extern __shared__ unsigned table[];
  using Reduce = cub::BlockReduce<unsigned long long, THREADS>;
  __shared__ typename Reduce::TempStorage temp;
  table_init(table);
  __syncthreads();
  unsigned long long kept = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const int4 v = keys[i];
    const bool a = contains(v.x, f, p, table), b = contains(v.y, f, p, table);
    const bool c = contains(v.z, f, p, table), d = contains(v.w, f, p, table);
    kept += (unsigned long long)a + b + c + d;
    out[i] = make_int4(a ? v.x : kPad, b ? v.y : kPad, c ? v.z : kPad, d ? v.w : kPad);
  }
  const unsigned long long total = Reduce(temp).Sum(kept);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

unsigned grid(long long n4, int sms) {
  const long long want = (n4 + THREADS - 1) / THREADS, cap = (long long)sms * CTAS_PER_SM;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

extern "C" {

int split_bitmap(const int* bm, const int* s, long long n, unsigned long long* out, int lo,
                 int shift, int F, long long sl_words, int sms, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), stream);
  if (err) return (int)err;
  bitmap_probe<<<grid(n / 4, sms), THREADS, 0, stream>>>(
      reinterpret_cast<const unsigned*>(bm), reinterpret_cast<const int4*>(s), n / 4, out,
      lo, shift, F, sl_words);
  return (int)cudaGetLastError();
}

int split_bloom(const int* keys, long long n, const int* f, int* out,
                unsigned long long* count, unsigned seed, unsigned nblocks, unsigned B,
                int k, int sms, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), stream);
  if (err) return (int)err;
  const int smem = kTableWords * (int)sizeof(unsigned);
  err = cudaFuncSetAttribute(bloom_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  bloom_probe<<<grid(n / 4, sms), THREADS, smem, stream>>>(
      reinterpret_cast<const int4*>(keys), n / 4, reinterpret_cast<const unsigned*>(f),
      reinterpret_cast<int4*>(out), count, Params{seed, nblocks - 1u, B, k});
  return (int)cudaGetLastError();
}

}  // extern "C"
"""

BUILD_SOURCE = r"""
#include <cuda_runtime.h>

#include "run_walk.cuh"

namespace {

constexpr int kThreads = 256;

// mode 0: atomicOr; 1: a plain store of the bit; 3: atomicOr of the bits
// of the warp's lanes that hit one word, by one lane
template <int kMode>
__device__ __forceinline__ void deposit(int key, unsigned* __restrict__ bm, int lo,
                                        int hi, int shift, long long sl_words) {
  const bool ok = key >= lo && key <= hi;
  const unsigned norm = (unsigned)key - (unsigned)lo;
  const long long w = (long long)(norm >> shift) * sl_words
                      + ((norm & ((1u << shift) - 1u)) >> 5);
  const unsigned bit = 1u << (norm & 31u);
  if (kMode == 0) {
    if (ok) atomicOr(bm + w, bit);
  } else if (kMode == 1) {
    if (ok) bm[w] = bit;
  } else {
    const unsigned long long addr = ok ? (unsigned long long)w : ~0ull;
    const unsigned peers = __match_any_sync(__activemask(), addr);
    const unsigned bits = __reduce_or_sync(peers, ok ? bit : 0u);
    if (ok && __ffs(peers) - 1 == (int)(threadIdx.x & 31)) atomicOr(bm + w, bits);
  }
}

template <int kMode>
__global__ void flat_build(const int4* __restrict__ r, long long n4, unsigned* bm,
                           int lo, int hi, int shift, long long sl_words) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int4 v = r[i];
    deposit<kMode>(v.x, bm, lo, hi, shift, sl_words);
    deposit<kMode>(v.y, bm, lo, hi, shift, sl_words);
    deposit<kMode>(v.z, bm, lo, hi, shift, sl_words);
    deposit<kMode>(v.w, bm, lo, hi, shift, sl_words);
  }
}

// The port's staged walk (csrc/bitmap_join.cu bitmap_build_runs) with the
// cluster's merge replaced by global atomics into a zeroed bitmap; kQ
// 16-byte loads a lane in flight.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
staged_atomic(const int* __restrict__ r, const int* __restrict__ starts, hbrj::ShareGrid g,
              unsigned* __restrict__ bm, int lo, int hi, int shift, long long sl_words,
              int live) {
  extern __shared__ int4 smem4[];
  unsigned* slices = reinterpret_cast<unsigned*>(smem4);
  long long* off = reinterpret_cast<long long*>(smem4 + g.nb * live / 4);
  int4* seg = reinterpret_cast<int4*>(off + ((g.nseg + 2) & ~1));
  const int rank = (int)(blockIdx.x % g.share);
  const int range = (int)(blockIdx.x / g.share);
  const int j0 = range * g.nb, j1 = min(j0 + g.nb, g.seg_buckets), nbk = j1 - j0;
  for (int i = threadIdx.x; i < nbk * live / 4; i += kThreads) smem4[i] = make_int4(0, 0, 0, 0);
  hbrj::share_table<kThreads>(starts, g, range, j0, j1, off, seg);
  const long long T = off[g.nseg];
  const long long c0 = T * rank / g.share, c1 = T * (rank + 1) / g.share;
  const int warp = (int)threadIdx.x / 32, nw = kThreads / 32;
  const unsigned mask = (1u << shift) - 1u;
  hbrj::walk_share<kQ>(r, g, off, seg, c0 + (c1 - c0) * warp / nw,
                      c0 + (c1 - c0) * (warp + 1) / nw, [&](int key) {
    if (key < lo || key > hi) return;
    const unsigned norm = (unsigned)key - (unsigned)lo;
    const unsigned b = (norm >> shift) - (unsigned)j0;
    if (b < (unsigned)nbk) atomicOr(slices + b * live + ((norm & mask) >> 5), 1u << (norm & 31u));
  });
  __syncthreads();
  for (int i = threadIdx.x; i < nbk * live; i += kThreads) {
    const unsigned v = slices[i];
    if (v) atomicOr(bm + (long long)(j0 + i / live) * sl_words + i % live, v);
  }
}

unsigned grid(long long n4, int sms) {
  const long long want = (n4 + kThreads - 1) / kThreads, cap = (long long)sms * 8;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

extern "C" {

// mode: 0 flat_atomic, 1 flat_store, 2 memset, 3 flat_warp_or
int split_build_flat(const int* r, long long n, int* bm, long long nwords, int lo, int hi,
                     int shift, long long sl_words, int mode, int sms, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(bm, 0, (size_t)nwords * sizeof(int), stream);
  if (err || mode == 2) return (int)err;
  const int4* r4 = reinterpret_cast<const int4*>(r);
  unsigned* b = reinterpret_cast<unsigned*>(bm);
  const unsigned gr = grid(n / 4, sms);
  if (mode == 0) flat_build<0><<<gr, kThreads, 0, stream>>>(r4, n / 4, b, lo, hi, shift, sl_words);
  if (mode == 1) flat_build<1><<<gr, kThreads, 0, stream>>>(r4, n / 4, b, lo, hi, shift, sl_words);
  if (mode == 3) flat_build<3><<<gr, kThreads, 0, stream>>>(r4, n / 4, b, lo, hi, shift, sl_words);
  return (int)cudaGetLastError();
}

int split_build_staged_atomic(const int* r, const int* starts, int* bm, long long nwords,
                              int lo, int hi, int shift, long long sl_words, int nseg,
                              int seg_elems, int cat_words, int seg_buckets, int nb,
                              int share, int live, int quads,
                              cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(bm, 0, (size_t)nwords * sizeof(int), stream);
  if (err) return (int)err;
  const hbrj::ShareGrid g{nseg, seg_elems, cat_words, seg_buckets, nb, share};
  const int smem = nb * live * 4 + g.table_bytes();
  auto kernel = quads == 8 ? staged_atomic<8> : staged_atomic<4>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  kernel<<<g.nranges() * share, kThreads, smem, stream>>>(
      r, starts, g, reinterpret_cast<unsigned*>(bm), lo, hi, shift, sl_words, live);
  return (int)cudaGetLastError();
}

}  // extern "C"
"""

BUILD_FLAT = {"flat_atomic": 0, "flat_store": 1, "memset": 2,
              "flat_warp_or": 3}
BUILD_SHARES = (1, 2, 4, 8)
BUILD_NB = (1, 2, 4)           # the planned buckets a range, times these

VARIANTS = {   # name -> (nvcc -D flags, checked against the twin)
    "base": ((), True),
    "ctas4": (("CTAS_PER_SM=4",), True),
    "ctas32": (("CTAS_PER_SM=32", "THREADS=64"), True),
    "no_load": (("NO_LOAD",), False),
    "no_crc": (("NO_CRC",), False),
    "crc_lane": (("CRC_LANE",), True),
    "crc_slice4": (("CRC_SLICE4",), True),
}
BITMAP_VARIANTS = ("base", "ctas4", "ctas32", "no_load")


def build_variants() -> dict:
    """name -> the loaded library of each variant, and "build" -> the build
    variants' library (built in parallel)."""
    from hwbloomradixjoin_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "flat_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flat_split.cu"
    src.write_text(SOURCE)
    build_src = out_dir / "build_split.cu"
    build_src.write_text(BUILD_SOURCE)
    libs = {name: out_dir / f"{name}.so" for name in VARIANTS}
    build_lib = out_dir / "build.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      *(f"-D{d}" for d in VARIANTS[name][0]), "-o", str(lib),
                      str(src)] for name, lib in libs.items()]
                    + [[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        f"-I{_build.CSRC_DIR}", "-o", str(build_lib),
                        str(build_src)]])
    vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_uint
    loaded = {}
    for name, path in libs.items():
        dll = ctypes.CDLL(str(path))
        dll.split_bitmap.argtypes = [vp, vp, ll, vp, i, i, i, ll, i, vp]
        dll.split_bloom.argtypes = [vp, ll, vp, vp, vp, u, u, u, i, i, vp]
        dll.split_bitmap.restype = dll.split_bloom.restype = ctypes.c_int
        loaded[name] = dll
    dll = ctypes.CDLL(str(build_lib))
    dll.split_build_flat.argtypes = [vp, ll, vp, ll, i, i, i, ll, i, i, vp]
    dll.split_build_staged_atomic.argtypes = [vp, vp, vp, ll, i, i, i, ll,
                                              *[i] * 8, vp]
    dll.split_build_flat.restype = ctypes.c_int
    dll.split_build_staged_atomic.restype = ctypes.c_int
    loaded["build"] = dll
    return loaded


def device_ms(fn, calls: int = 10) -> float:
    """Device time a call of fn (kernels and memsets, torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False))
    return busy / calls / 1e3


def time_builds(dll, r_part, r_starts, lo, hi, part_bits, shift, sl_rows,
                sms, stream) -> dict:
    """variant -> ms of the build variants over one R partition; each exact
    variant's bitmap must equal the twin's."""
    import dataclasses

    import torch
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    dev = r_part.device
    args = (r_part, lo, hi, part_bits, shift, sl_rows)
    want = B.build_bitmap(*args)
    bm = torch.empty_like(want)
    sync = torch.empty(2, dtype=torch.int32, device=dev)
    planned = B.build_split(r_part, r_starts, shift, part_bits, sms)
    live = B.live_words(shift)
    out = {}

    def check(name, rc, exact=True):
        if rc:
            raise RuntimeError(f"flat_split: {name}: CUDA error {rc}")
        if exact and not torch.equal(bm, want):
            raise AssertionError(f"build {name} differs from the twin")

    def flat(mode):
        return dll.split_build_flat(r_part.data_ptr(), r_part.numel(),
                                    bm.data_ptr(), bm.numel(), lo, hi, shift,
                                    sl_rows * 128, mode, sms, stream)

    def staged_atomic(split, quads=4):
        return dll.split_build_staged_atomic(
            r_part.data_ptr(), r_starts.data_ptr(), bm.data_ptr(), bm.numel(),
            lo, hi, shift, sl_rows * 128, *split.args(), live, quads, stream)

    def port(split):
        _build.launch("bitmap_build", "hbrj_bitmap_build", dev,
                      r_part.data_ptr(), r_part.numel(), r_starts.data_ptr(),
                      bm.data_ptr(), bm.numel(), sync.data_ptr(), lo, hi,
                      shift, sl_rows * 128, *split.args(), live)
        return 0

    runs = {name: (lambda m=mode: flat(m), name in ("flat_atomic",
                                                    "flat_warp_or"))
            for name, mode in BUILD_FLAT.items()}
    runs["staged_atomic_merge"] = (lambda: staged_atomic(planned), True)
    runs["staged_atomic_q8"] = (lambda: staged_atomic(planned, 8), True)
    runs["port_planned"] = (lambda: port(planned), True)
    for share in BUILD_SHARES:
        split = dataclasses.replace(planned, share=share)
        runs[f"atomic_share{share}"] = (lambda sp=split: staged_atomic(sp),
                                         True)
        for times in BUILD_NB:
            nb = planned.nb * times
            if nb > planned.seg_buckets or nb * 4 * live > B.BUILD_MAX_STAGE:
                continue
            split = dataclasses.replace(planned, share=share, nb=nb)
            runs[f"port_nb{nb}_share{share}"] = (lambda sp=split: port(sp),
                                                 True)
    for name, (fn, exact) in runs.items():
        out[name] = time_usec(fn, dev) / 1e3
        check(name, fn(), exact)
        out[f"{name}_device"] = device_ms(fn)
    out["split"] = dataclasses.asdict(planned)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flat_split: torch.cuda.is_available() is false")
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as BP
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.ops import run_split
    from hwbloomradixjoin_tpu_torch.utils.roofline import card_line
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = build_variants()
    sms = run_split.card_sms(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc:
            raise RuntimeError(f"flat_split: CUDA error {rc}")

    # PRO 16M x 128M at q = 1: the S partition and the bitmap
    rk, _, sk, _ = G.build_workload(G.WorkloadParams(
        r_size=16_000_000, s_size=128_000_000, nthreads=8, selectivity=1.0))
    plan = B.plan_radix_join(rk, sk, 1, 16_000_000, device=dev)
    m = plan._intermediates()
    bm, (s_part, s_starts) = m["bitmap"], m["s_part"]
    g = plan.sgeom
    probe = (bm, s_part, 1, g.shift, g.part_bits, plan.sl_rows)
    want_bm = int(B.bitmap_probe_count_plain(*probe))
    count = torch.empty((), dtype=torch.int64, device=dev)
    result = {"card": card, "bitmap": {}, "bloom": {}}
    for name in BITMAP_VARIANTS:
        dll = libs[name]

        def run(dll=dll):
            check(dll.split_bitmap(bm.data_ptr(), s_part.data_ptr(),
                                   s_part.numel(), count.data_ptr(), 1,
                                   g.shift, 1 << g.part_bits,
                                   plan.sl_rows * 128, sms, stream))
        ms = time_usec(run, dev) / 1e3
        run()
        if VARIANTS[name][1] and int(count) != want_bm:
            raise AssertionError(f"bitmap {name}: {int(count)} != {want_bm}")
        result["bitmap"][name] = ms
    result["bitmap"]["port_staged"] = time_usec(
        lambda: B.bitmap_probe_count(*probe, s_starts), dev) / 1e3
    rg = plan.rgeom
    result["build"] = {"pro": time_builds(
        libs["build"], m["r_part"], m["r_starts"], 1, 16_000_000,
        rg.part_bits, rg.shift, plan.r_sl_rows, sms, stream)}
    print(json.dumps(result["build"]["pro"]), flush=True)
    # 4d's build: the same R at 12 bits (4,096 slices of 512 live bytes)
    r4, st4 = X.partition_pass(plan.rk_in, X.RadixGeom(
        chunk_rows=rg.chunk_rows, part_bits=12, lo=1, hi=16_000_000,
        shift=12, pad_cat=rg.pad_cat))
    result["build"]["4d"] = time_builds(libs["build"], r4, st4, 1,
                                        16_000_000, 12, 12, 8, sms, stream)
    print(json.dumps(result["build"]["4d"]), flush=True)
    del plan, m, bm, s_part, s_starts, probe, r4, st4
    # the flagship's R: 128M keys, a shuffled dense range, at its build
    # geometry as plan_radix_join plans it
    hi = 128_000_000
    pb, shift, slr = B.plan_geometry(1, hi)
    rb, rshift, rslr = B.plan_build_geometry(1, hi, pb, shift, slr)
    rk = torch.randperm(hi, device=dev, dtype=torch.int64)
    rk_in, rgeom = B.plan_bitmap_build((rk + 1).to(torch.int32), 1, hi, rb,
                                       rshift, rslr, device=dev)
    del rk
    r_part, r_starts = X.partition_pass(rk_in, rgeom)
    del rk_in
    result["build"]["flagship"] = time_builds(
        libs["build"], r_part, r_starts, 1, hi, rb, rshift, rslr, sms, stream)
    print(json.dumps(result["build"]["flagship"]), flush=True)
    del r_part, r_starts
    torch.cuda.empty_cache()

    # 4e: S at q = 0.01 hash-partitioned by 10 of 18 block bits, m = 2^27
    rk, _, sk, _ = G.build_workload(G.WorkloadParams(
        r_size=16_000_000, s_size=128_000_000, nthreads=8, selectivity=0.01))
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 27, k=1, B=512)
    prune = BP.plan_bloom_prune(rk, sk, args, device=dev)
    words, (hashed, h_starts) = prune.build(), prune.partition()
    keys = hashed.reshape(-1)
    want, want_n = BP.bloom_probe_prune_plain(words, keys, args)
    out = torch.empty_like(keys)
    for name, (_, exact) in VARIANTS.items():
        dll = libs[name]

        def run(dll=dll):
            check(dll.split_bloom(keys.data_ptr(), keys.numel(),
                                  words.data_ptr(), out.data_ptr(),
                                  count.data_ptr(), args.seed & 0xFFFFFFFF,
                                  args.nblocks, args.B, args.k, sms, stream))
        ms = time_usec(run, dev) / 1e3
        run()
        if exact and not (torch.equal(out, want) and int(count) == int(want_n)):
            raise AssertionError(f"bloom {name} differs from the twin")
        result["bloom"][name] = ms
    result["bloom"]["port_staged"] = time_usec(
        lambda: BP.bloom_probe_prune(words, keys, args, starts=h_starts,
                                     part_bits=prune.pgeom.part_bits),
        dev) / 1e3
    result["bloom"]["port_flat"] = time_usec(
        lambda: BP.bloom_probe_prune(words, keys, args), dev) / 1e3
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
