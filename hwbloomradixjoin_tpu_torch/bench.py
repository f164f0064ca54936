"""Benchmark of the port: prints ONE JSON line with the headline metric.

Twin of the repository's root ``bench.py``, on the GPU:

    python -m hwbloomradixjoin_tpu_torch.bench

Headline metric: PRO join throughput in S-rows/s on one card, every repeat the
WHOLE join (R partition + bitmap build, [S survivor compaction,] S partition,
bitmap probe) timed with CUDA events; the semantics of the reference's
TOTAL-TIME-USECS (build + both partitions + join,
parallel_radix_join_bloom.c:1509-1547).  The same environment variables as
the root bench: BENCH_R, BENCH_S, BENCH_Q, BENCH_BITS, BENCH_INNER,
BENCH_REPEATS, BENCH_ALGO, BENCH_DENSE.  Logs go to stderr.

Columnar projection: the radix tier's count query reads only the key
column, so S's payload column is never allocated on the card; with
BENCH_DENSE=1 the planner takes the dense fast path, which sums S's
payloads, so they go to the card too.

Baseline: the reference's best full-scale CPU number, PRO 128M⋈1.024B at
2.98 ns/tuple (isengard, BASELINE.md).  vs_baseline = ours / reference.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_ROWS_PER_S = 1e9 / 2.98  # PRO 128M⋈1.024B, 14 thr (BASELINE.md)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_bench(device, r_size: int, s_size: int, selectivity: float = 1.0,
              bits=None, algo: str = "PRO", repeats: int = 2, inner: int = 8,
              allow_dense: bool = False) -> dict:
    """Generate the uniform workload, run the join `repeats` times on
    `device`, check the exact count; returns the JSON record."""
    import torch

    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join
    from hwbloomradixjoin_tpu_torch.types import PAD_KEY, Relation

    t0 = time.perf_counter()
    params = G.WorkloadParams(r_size=r_size, s_size=s_size, nthreads=8,
                              selectivity=selectivity)
    rk, rp, sk, sp = G.build_workload(params)
    log(f"datagen: {time.perf_counter() - t0:.1f}s")

    # pad S to the partition chunk multiple on the host (one copy on device)
    pad = (-len(sk)) % (bitmap_join.CHUNK_ROWS * 128)
    if pad:
        sk = np.concatenate([sk, np.full(pad, PAD_KEY, np.int32)])
        sp = np.concatenate([sp, np.zeros(pad, np.int32)])
    R = Relation.from_numpy(rk, rp, device=device,
                            stats=G.r_key_stats(params))
    # key-column projection: the radix tier's count never reads S.payload
    S = Relation(key=torch.from_numpy(sk).to(device),
                 payload=torch.from_numpy(sp).to(device) if allow_dense
                 else torch.zeros(1, dtype=torch.int32, device=device))
    del sk, sp
    want_tier = "dense" if allow_dense else "cuda_radix"
    cfg = EngineConfig(radix=RadixConfig(num_radix_bits=bits),
                       allow_dense=allow_dense)

    best = None
    for i in range(repeats):
        result, stats, _ = run_join(algo, R, S, cfg, None, inner_repeats=inner)
        # the placeholder payload is only valid on the count-only radix tier
        if stats.tier != want_tier:
            raise RuntimeError(
                f"bench workload fell off the kernel tier to {stats.tier}")
        log(f"run {i}: tier={stats.tier} {stats.total_usec / 1e6:.6f}s "
            f"({stats.total_usec * 1e3 / s_size:.4f} ns/tuple) "
            + " ".join(f"{k}={v / 1e3:.4f}ms"
                       for k, v in stats.phases.items())
            + f" results={result.count()}")
        if best is None or stats.total_usec < best.total_usec:
            best = stats
    expect = G.expected_uniform_match_count(s_size, selectivity)
    if result.count() != expect:
        log(f"VALIDATION FAILED: {result.count()} != {expect}")
        value = 0.0
    else:
        value = s_size / (best.total_usec / 1e6)
    return {
        "metric": f"{algo} join throughput ({r_size // 10**6}M⋈"
                  f"{s_size // 10**6}M, 1 chip, tier={best.tier}, build incl)",
        "value": round(value, 0),
        "unit": "rows/s",
        "vs_baseline": round(value / BASELINE_ROWS_PER_S, 4),
    }


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the benchmark runs on the GPU")
    r_size = int(os.environ.get("BENCH_R", 16_000_000))
    s_size = int(os.environ.get("BENCH_S", 128_000_000))
    bits = os.environ.get("BENCH_BITS")
    log(f"bench: {os.environ.get('BENCH_ALGO', 'PRO')} {r_size}⋈{s_size} on "
        f"{torch.cuda.get_device_name(0)}")
    record = run_bench(
        torch.device("cuda"), r_size, s_size,
        selectivity=float(os.environ.get("BENCH_Q", 1.0)),
        bits=int(bits) if bits else None,
        algo=os.environ.get("BENCH_ALGO", "PRO"),
        repeats=int(os.environ.get("BENCH_REPEATS", 2)),
        inner=int(os.environ.get("BENCH_INNER", 8)),
        allow_dense=os.environ.get("BENCH_DENSE", "0") == "1")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
