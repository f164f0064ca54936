"""Split the flat probes' time on the card: what bounds a grid-stride probe.

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
same inputs (the staged classes, and the bloom probe's flat class).  Prints
the card line, then one JSON line.  Runs on the GPU only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

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
    """name -> the loaded library of each variant (built in parallel)."""
    from hwbloomradixjoin_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "flat_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flat_split.cu"
    src.write_text(SOURCE)
    libs = {name: out_dir / f"{name}.so" for name in VARIANTS}
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      *(f"-D{d}" for d in VARIANTS[name][0]), "-o", str(lib),
                      str(src)] for name, lib in libs.items()])
    vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_uint
    loaded = {}
    for name, path in libs.items():
        dll = ctypes.CDLL(str(path))
        dll.split_bitmap.argtypes = [vp, vp, ll, vp, i, i, i, ll, i, vp]
        dll.split_bloom.argtypes = [vp, ll, vp, vp, vp, u, u, u, i, i, vp]
        dll.split_bitmap.restype = dll.split_bloom.restype = ctypes.c_int
        loaded[name] = dll
    return loaded


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flat_split: torch.cuda.is_available() is false")
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as BP
    from hwbloomradixjoin_tpu_torch.ops import run_split
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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
    del plan, m, bm, s_part, s_starts, probe

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
