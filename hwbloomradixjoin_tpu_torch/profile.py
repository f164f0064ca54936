"""Device-time profile of one planned join on the card.

    python -m hwbloomradixjoin_tpu_torch.profile PRHO --r 128000000 --s 128000000
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --non-unique
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --passes 2 --bits 12
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --radix-count
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 128000000 \
        --s 1024000000 --q 0.01 --bloom blocked --m 1073741824 --k 1 --B 512

Generates the workload as ``chip_smoke.py`` does (uniform PK/FK at q, or the
non-unique generators; S's keys only where the tier reads no S payload),
plans the join with the planner of the tier ``run_join`` picks for it
(``allow_dense=False``; with ``--bloom`` behind the filter, with
``--passes 2`` two-pass where the planner accepts; with ``--radix-count``
``radix_join_count``'s kernels instead, both partitions and the gathered
probe, at its 12 low bits), warms the whole join,
then traces JOINS back-to-back whole joins with ``torch.profiler``.  Prints
one JSON line: the card, the tier, the plan, the device time of each kernel
per join (ms, summed by kernel name; plain torch work is summed under the
names of its ATen kernels), and the device's busy share: the union of
kernel intervals over the span from the first kernel's start to the last
one's end.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

JOINS = 5          # whole joins traced, back to back, after 3 warm ones


def _plan(algo: str, R, S, cfg, bloom_args):
    """The plan of the kernel tier run_join picks."""
    from hwbloomradixjoin_tpu_torch.models import registry

    if registry.ALGORITHMS[algo].family == "npo":
        bloom_args = None          # as run_join: NPO ignores the filter
    ranges = registry.key_ranges(R)
    tier = registry.select_tier(registry.ALGORITHMS[algo], R, cfg, *ranges)
    if tier not in registry.KERNEL_TIERS:
        raise SystemExit(f"profile: tier {tier} has no kernel plan")
    plan = registry.plan_kernel_join(tier, R, S, cfg, *ranges, bloom_args)
    if plan is None:
        raise SystemExit("profile: the planner declined (multiplicity guard)")
    return plan, tier


def _short(name: str) -> str:
    """Kernel name without return type, namespaces, template arguments or
    parameters."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"<.*", "", base).split("::")[-1].split()[-1]


class _RadixCount:
    """radix_join_count's kernels as a plan: both partitions and the
    gathered probe, the result left on the card."""

    def __init__(self, R, S, dev):
        from hwbloomradixjoin_tpu_torch.ops import radix as X
        self.X, self.geom = X, X.RadixGeom()
        chunk = self.geom.chunk_rows * 128
        self.r_in = X._chunk_pad(R.key, chunk, dev)
        self.s_in = X._chunk_pad(S.key, chunk, dev)

    def full(self):
        X, geom = self.X, self.geom
        return X.gathered_probe_count(*X.partition_pass(self.r_in, geom),
                                      *X.partition_pass(self.s_in, geom), geom)


def profile_join(algo: str, r_size: int, s_size: int, selectivity: float,
                 nonunique: bool, bloom_args=None, passes: int = 1,
                 bits=None, radix_count: bool = False) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.types import Relation

    dev = torch.device("cuda")
    params = G.WorkloadParams(r_size=r_size, s_size=s_size, nthreads=8,
                              selectivity=selectivity,
                              nonunique_keys=nonunique)
    rk, rp, sk, sp = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    cfg = EngineConfig(radix=RadixConfig(num_radix_bits=bits, passes=passes),
                       allow_dense=False)
    if algo in ("PRO", "RJ") and not nonunique:
        # key-column projection: the count-only radix tier reads no payload
        S = Relation(key=torch.from_numpy(sk).to(dev),
                     payload=torch.zeros(1, dtype=torch.int32, device=dev))
    else:
        S = Relation.from_numpy(sk, sp, device=dev)
    del rk, rp, sk, sp
    if radix_count:
        plan, tier = _RadixCount(R, S, dev), "radix_join_count"
    else:
        plan, tier = _plan(algo, R, S, cfg, bloom_args)
    for _ in range(3):
        plan.full()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(JOINS):
            plan.full()
        torch.cuda.synchronize()
    kernels, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = _short(ev.name)
        kernels[name] = kernels.get(name, 0.0) + ev.time_range.elapsed_us()
        spans.append((ev.time_range.start, ev.time_range.end))
    if not spans:
        raise SystemExit("profile: the trace holds no device activity")
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"card": card, "algo": algo, "tier": tier, "r_size": r_size,
            "s_size": s_size, "selectivity": selectivity,
            "nonunique": nonunique, "passes": passes, "bits": bits,
            "bloom": None if bloom_args is None else {
                "variant": bloom_args.variant.value, "m": bloom_args.m,
                "k": bloom_args.k, "B": bloom_args.B},
            "plan": type(getattr(plan, "join", plan)).__name__,
            "s_after_filter": getattr(plan, "s_after", None),
            "joins": JOINS,
            "ms_per_join": (end - spans[0][0]) / JOINS / 1e3,
            "busy_share": busy / (end - spans[0][0]),
            "kernel_ms_per_join": {k: v / JOINS / 1e3 for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])}}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device; the profile runs on the GPU")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("algo", choices=["PRO", "RJ", "PRH", "PRHO", "NPO",
                                     "NPO_st"])
    ap.add_argument("--r", type=int, default=128_000_000)
    ap.add_argument("--s", type=int, default=128_000_000)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--non-unique", action="store_true")
    ap.add_argument("--bits", type=int, default=None)
    ap.add_argument("--passes", type=int, choices=[1, 2], default=1)
    ap.add_argument("--bloom", choices=["basic", "blocked"], default=None)
    ap.add_argument("--m", type=int, default=256 << 20)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--radix-count", action="store_true")
    a = ap.parse_args()
    bloom_args = None
    if a.bloom is not None:
        from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
        bloom_args = BloomArgs(variant=BloomVariant(a.bloom), m=a.m, k=a.k,
                               B=a.B)
    print(json.dumps(profile_join(a.algo, a.r, a.s, a.q, a.non_unique,
                                  bloom_args, a.passes, a.bits,
                                  a.radix_count)))


if __name__ == "__main__":
    main()
