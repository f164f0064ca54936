"""The blocked-bloom join at k > 1, on the card.

Counterpart of the repository's ``tools/validate_bloom_tpu.py``: BPRO 16M x
128M at q = 0.01 behind a blocked filter (m = 2^30, B = 512) at k = 1, 2
and 4, beside PRO without a filter, over the uniform PK/FK workload.

    python -m hwbloomradixjoin_tpu_torch.tools.validate_bloom
    python -m hwbloomradixjoin_tpu_torch.tools.validate_bloom \\
        --r 4096 --s 40000 --m 4194304 --engine-backend cpu

Each count must be exact, S-tuples after filter the plain prune's on the
same device, and the survivor share within 20 % of p + (1 - p) fpr(m, k,
|R|), p = expected / |S| (``validate_fullrange.validate_join``).  Prints one
line a join and exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import sys
import time

KS = (1, 2, 4)          # bits a key sets in its block, as the JAX tool


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--r", type=int, default=16_000_000)
    p.add_argument("--s", type=int, default=128_000_000)
    p.add_argument("--q", type=float, default=0.01)
    p.add_argument("--m", type=int, default=1 << 30)
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    import torch

    from hwbloomradixjoin_tpu_torch.cli import device_of
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.tools.validate_fullrange import (
        blocked, validate_join)
    from hwbloomradixjoin_tpu_torch.types import Relation

    dev = device_of(a.engine_backend)
    t0 = time.perf_counter()
    params = G.WorkloadParams(r_size=a.r, s_size=a.s, nthreads=8,
                              selectivity=a.q)
    rk, rp, sk, _ = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation(key=torch.from_numpy(sk).to(dev),
                 payload=torch.zeros(1, dtype=torch.int32, device=dev))
    del rk, rp, sk
    want = G.expected_uniform_match_count(a.s, a.q)
    print(f"bloom: {a.r} x {a.s} q={a.q} m={a.m} on {dev}, data "
          f"{time.perf_counter() - t0:.1f}s, expect={want}", flush=True)
    cfg = EngineConfig(allow_dense=False)
    all_ok = True
    for label, args in [("PRO, no filter", None)] + [
            (f"BPRO blocked m={a.m} k={k} B=512", blocked(a.m, k))
            for k in KS]:
        ok, _, line = validate_join(label, R, S, a.s, want, cfg, args)
        all_ok &= ok
        print(line, flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
