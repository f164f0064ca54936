// Dense-PK count join: one stream over S (Hopper, sm_90a).
//
// Replaces the Pallas kernel of hwbloomradixjoin_tpu/ops/dense_join.py:
//   hbrj_dense_count  <- dense_count_join (_make_kernel, dense_join.py:32)
//
// Contract: over n int32 keys and their payloads, the number of keys in
// [lo, hi] (64-bit) and the sum of their payloads mod 2^32 (the reference's
// unsigned checksum; int32 wraparound on the TPU).
//
// Bound: bytes.  Each key and payload is read once and nothing else is
// touched, so the kernel is a grid-stride stream of 16-byte loads (the
// wrapper requires 16-byte-aligned starts; the last n % 4 elements take
// scalar loads).  The TPU carried its two sums across the sequential grid in
// SMEM scratch; here every thread accumulates in registers, each block
// reduces with cub, and thread 0 adds once into the 2-word output: word 0 the
// count, the low half of word 1 the sum (a 32-bit atomic, so it wraps).

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Acc {
  unsigned long long count;
  unsigned sum;
};

__device__ __forceinline__ void take(int key, int pay, int lo, int hi, Acc& acc) {
  const bool hit = key >= lo && key <= hi;
  acc.count += hit;
  acc.sum += hit ? (unsigned)pay : 0u;
}

__global__ void dense_count_kernel(const int* __restrict__ keys,
                                   const int* __restrict__ pays, long long n,
                                   unsigned long long* __restrict__ out, int lo,
                                   int hi) {
  Acc acc{0ull, 0u};
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  const int4* p4 = reinterpret_cast<const int4*>(pays);
  for (long long i = first; i < n4; i += stride) {
    const int4 k = k4[i];
    const int4 p = p4[i];
    take(k.x, p.x, lo, hi, acc);
    take(k.y, p.y, lo, hi, acc);
    take(k.z, p.z, lo, hi, acc);
    take(k.w, p.w, lo, hi, acc);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) take(keys[i], pays[i], lo, hi, acc);
  using Reduce64 = cub::BlockReduce<unsigned long long, kThreads>;
  using Reduce32 = cub::BlockReduce<unsigned, kThreads>;
  __shared__ typename Reduce64::TempStorage t_count;
  __shared__ typename Reduce32::TempStorage t_sum;
  const unsigned long long count = Reduce64(t_count).Sum(acc.count);
  const unsigned sum = Reduce32(t_sum).Sum(acc.sum);
  if (threadIdx.x == 0) {
    if (count) atomicAdd(out, count);
    // little-endian: the low half of a zeroed 64-bit word, so the sum wraps
    if (sum) atomicAdd(reinterpret_cast<unsigned*>(out + 1), sum);
  }
}

}  // namespace

extern "C" {

// keys, pays: n int32 each (16-byte-aligned starts); out: two uint64 words
// (count, payload sum < 2^32), overwritten.
int hbrj_dense_count(const int* keys, const int* pays, long long n,
                     unsigned long long* out, int lo, int hi, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), stream);
  if (err) return (int)err;
  if (n) {
    dense_count_kernel<<<hbrj::grid_for((n + 3) / 4, kThreads), kThreads, 0, stream>>>(
        keys, pays, n, out, lo, hi);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
