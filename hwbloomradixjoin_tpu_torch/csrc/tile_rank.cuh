// The stable tile ranking shared by the partition (radix.cu tile_scatter)
// and two-pass partitioning's pass 2 (multipass.cu pass2_scatter).
//
// A CTA of kTileThreads threads holds a tile of up to kTile keys, kTileItems
// a thread, warp-major: item j of lane l of warp w is tile element
// w * kWarpKeys + j * 32 + l, so tile order is (warp, item, lane).  Each
// element carries a digit, and gets its slot in the tile's digit order
// (digits ascending, tile order within a digit): per-warp ranks from one
// __ballot_sync a digit bit (fewer instructions on this card than
// __match_any_sync), a per-digit sum over the warps and a block scan of the
// digits' totals.  The steps are separate functions: each kernel keeps its
// own loads and stores between them, so its registers stay as few as its
// own loop needs (one function taking the loads and stores as callbacks
// spilled more registers and ran the partition slower on the H100).
#pragma once

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace hbrj {

constexpr int kWarp = 32;
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / kWarp;
constexpr int kTileItems = 8;                       // keys a thread
constexpr int kTile = kTileThreads * kTileItems;    // 4,096 keys a CTA tile
constexpr int kWarpKeys = kWarp * kTileItems;       // a warp's contiguous share
constexpr int kScatterBlocks = 3;                   // scatter CTAs an SM

// The lanes of the warp whose label equals this lane's (labels below
// 2^NBITS): one ballot a label bit, unrolled.
template <int NBITS>
__device__ __forceinline__ unsigned match_label(int label) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < NBITS; ++b) {
    const unsigned ones = __ballot_sync(0xffffffffu, label & (1 << b));
    peers &= (label & (1 << b)) ? ones : ~ones;
  }
  return peers;
}

// Ranking a tile is three steps around the caller's loads and stores:
//   clear_counts(wcnt, ncnt) before the tile is loaded (wcnt: shared,
//     kTileWarps * ncnt ints, a row of per-digit counters a warp), then a
//     barrier;
//   rank[j] = warp_rank<NBITS>(d, wcnt + warp * ncnt) for each item j in
//     order, by every lane of the warp together: the item's rank among its
//     warp's items of digit d so far (an item past the tile's end skips
//     this, uniformly over its warp), then a barrier;
//   scan_digits(...), then a barrier: each item's tile slot is then
//     wcnt[warp * ncnt + d] + rank[j].
__device__ __forceinline__ void clear_counts(int* wcnt, int ncnt) {
  for (int i = threadIdx.x; i < kTileWarps * ncnt; i += kTileThreads) wcnt[i] = 0;
}

template <int NBITS>
__device__ __forceinline__ int warp_rank(int d, int* cnt) {
  const int lane = threadIdx.x % kWarp;
  const unsigned peers = match_label<NBITS>(d);
  const int rank = cnt[d] + __popc(peers & ((1u << lane) - 1u));
  __syncwarp();
  if (peers >> lane == 1u) cnt[d] = rank + 1;   // the group's last lane
  __syncwarp();
  return rank;
}

// For this thread's digits d = threadIdx.x * DPT + k below nscan (nscan <=
// kTileThreads * DPT; digits in [nscan, ncnt) were ranked and are dropped):
// their totals over the warps, their first tile slots (a block scan) and
// each warp's counter rebased to its first slot of d; delta[d] (shared) =
// next[k] - d's first tile slot, so the item at tile slot p goes to output
// slot delta[d] + p; next[k] (the output slot of d's next item) advanced
// past the tile.  Returns the tile's items of digits below nscan when
// kCount, else 0.
template <int DPT, bool kCount>
__device__ __forceinline__ int scan_digits(int* wcnt, int ncnt, int nscan,
                                           int (&next)[DPT], int* delta) {
  using Scan = cub::BlockScan<int, kTileThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  int total[DPT], tstart[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int d = threadIdx.x * DPT + k;
    total[k] = 0;
    if (d < nscan)
      for (int w = 0; w < kTileWarps; ++w) total[k] += wcnt[w * ncnt + d];
  }
  int agg = 0;
  if constexpr (!kCount && DPT == 1)
    Scan(scan_tmp).ExclusiveSum(total[0], tstart[0]);
  else
    Scan(scan_tmp).ExclusiveSum(total, tstart, agg);
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int d = threadIdx.x * DPT + k;
    if (d >= nscan) continue;
    int run = tstart[k];
    for (int w = 0; w < kTileWarps; ++w) {
      const int v = wcnt[w * ncnt + d];
      wcnt[w * ncnt + d] = run;
      run += v;
    }
    delta[d] = next[k] - tstart[k];
    next[k] += total[k];
  }
  return agg;
}

}  // namespace hbrj
