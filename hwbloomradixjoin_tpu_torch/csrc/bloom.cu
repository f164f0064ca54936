// Blocked bloom filter probe with fused pruning (Hopper, sm_90a).
//
// Replaces the Pallas kernel of hwbloomradixjoin_tpu/ops/bloom_pallas.py:
//   hbrj_bloom_probe <- bloom_probe_prune (_probe_kernel_for, bloom_pallas.py:93)
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
// What bounds it here: the key stream (read once, written once) and, per
// live key, one 32-byte sector of the filter.  The TPU staged each hash
// bucket's 2^17-bit filter slice in VMEM and tested it with a 128-lane
// gather ladder, with ownership descriptors so each staged key was emitted
// once.  Here every key is read once in place: the input is partitioned by
// the block's top bits, so neighbouring keys probe the same slice and its
// sectors stay in L1/L2.  Survivors are summed per thread in 64 bits,
// reduced per block, and added with one atomic per block.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kPadKey = INT32_MIN;
constexpr int kThreads = 256;

struct ProbeParams {
  unsigned seed;
  unsigned block_mask;             // nblocks - 1
  unsigned B;                      // block bits, a power of two
  int k;
};

__device__ __forceinline__ bool contains(int key, const unsigned* __restrict__ filter,
                                         const ProbeParams& p,
                                         const unsigned* crc_table) {
  if (key == kPadKey) return false;
  const unsigned long long base =
      (unsigned long long)(hbrj::crc32c(crc_table, p.seed, key) & p.block_mask) * p.B;
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

}  // namespace

extern "C" {

// keys: n int32 (n a multiple of 4, 16-byte aligned); filter: m/32 words;
// out: n int32; count: one zeroed 64-bit word.
int hbrj_bloom_probe(const int* keys, long long n, const int* filter, int* out,
                     long long* count, unsigned seed, unsigned nblocks, unsigned B,
                     int k, cudaStream_t stream) {
  if (n == 0) return 0;
  const ProbeParams p{seed, nblocks - 1u, B, k};
  const long long n4 = n / 4;
  bloom_probe<<<hbrj::grid_for(n4, kThreads), kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(keys), n4,
      reinterpret_cast<const unsigned*>(filter), reinterpret_cast<int4*>(out),
      reinterpret_cast<unsigned long long*>(count), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
