"""Device-time profile of one planned join on the card.

    python -m hwbloomradixjoin_tpu_torch.profile PRHO --r 128000000 --s 128000000
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --non-unique
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --passes 2 --bits 12
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --radix-count
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 128000000 \
        --s 1024000000 --q 0.01 --bloom blocked --m 1073741824 --k 1 --B 512
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --dense
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --materialize
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16777216 \
        --s 268435456 --key8b
    python -m hwbloomradixjoin_tpu_torch.profile PRO --r 16000000 --zipf 1.0 \
        --trace-dir chiprun_out/traces

Generates the workload as ``chip_smoke.py`` does (uniform PK/FK at q, the
non-unique generators, 16-byte tuples with ``--key8b``, or a Zipf S over R's
keys with ``--zipf Z``; S's keys only where the tier reads no S payload),
plans the join with ``registry.plan_join``, the plan ``run_join`` times
(``allow_dense=False``; with ``--bloom`` behind the filter, with
``--passes 2`` two-pass where the planner accepts; with ``--dense``
``EngineConfig()``'s dense stream over S; with ``--materialize``
cuda_materialize; with ``--key8b`` cuda_key8b, the radix join over the low
key words; with ``--radix-count`` ``radix_join_count``'s kernels instead,
both partitions and the gathered probe, at its 12 low bits), warms the
whole join, then traces JOINS back-to-back whole joins with
``torch.profiler``.  Prints one JSON line: the card, the tier, the plan,
the device time of each kernel per join (ms, summed by kernel name; plain
torch work is summed under the names of its ATen kernels), and the
device's busy share: the union of kernel intervals over the span from the
first kernel's start to the last one's end.  With ``--trace-dir DIR`` it also writes the profiler's Chrome
trace and the JSON line into DIR (keep it under the git-ignored
chiprun_out/).  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import re

JOINS = 5          # whole joins traced, back to back, after 3 warm ones


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
                 bits=None, radix_count: bool = False, dense: bool = False,
                 materialize: bool = False, key8b: bool = False,
                 zipf: float = 0.0, trace_dir=None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.models import registry
    from hwbloomradixjoin_tpu_torch.types import Relation
    from hwbloomradixjoin_tpu_torch.utils.roofline import card_line

    dev = torch.device("cuda")
    params = G.WorkloadParams(r_size=r_size, s_size=s_size, nthreads=8,
                              selectivity=selectivity,
                              nonunique_keys=nonunique, key8b=key8b,
                              skew=zipf)
    rk, rp, sk, sp = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params),
                            key8b=key8b)
    cfg = EngineConfig(radix=RadixConfig(num_radix_bits=bits, passes=passes),
                       allow_dense=dense, materialize=materialize)
    if algo in ("PRO", "RJ") and not (nonunique or dense or materialize
                                      or key8b):
        # key-column projection: the count-only radix tier reads no payload
        S = Relation(key=torch.from_numpy(sk).to(dev),
                     payload=torch.zeros(1, dtype=torch.int32, device=dev))
    else:
        S = Relation.from_numpy(sk, sp, device=dev, key8b=key8b)
    del rk, rp, sk, sp
    if radix_count:
        plan, tier = _RadixCount(R, S, dev), "radix_join_count"
    else:
        plan, tier = registry.plan_join(algo, R, S, cfg, bloom_args)
        if plan is None:
            raise SystemExit(f"profile: run_join takes the plain-torch tier "
                             f"{tier} here, which has no kernel plan")
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
        # the program's spans also mark the device timeline: no kernels
        if ev.device_type != DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
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
    card = card_line()
    trace = None
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        bloom = "" if bloom_args is None else \
            f"-{bloom_args.variant.value}-m{bloom_args.m}-k{bloom_args.k}"
        trace = os.path.join(trace_dir, f"{algo}-{tier}-{r_size}x{s_size}"
                             f"-q{selectivity}-z{zipf}-b{bits}-p{passes}"
                             f"{bloom}.json")
        prof.export_chrome_trace(trace)
    return {"card": card, "algo": algo, "tier": tier, "r_size": r_size,
            "s_size": s_size, "selectivity": selectivity,
            "nonunique": nonunique, "passes": passes, "bits": bits,
            "zipf": zipf, "trace": trace,
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
    ap.add_argument("--dense", action="store_true",
                    help="EngineConfig()'s dense tier (4g)")
    ap.add_argument("--materialize", action="store_true",
                    help="cuda_materialize (4h)")
    ap.add_argument("--key8b", action="store_true",
                    help="16-byte tuples: cuda_key8b (4k)")
    ap.add_argument("--zipf", type=float, default=0.0, metavar="Z",
                    help="S Zipf over R's keys at z (4l)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write the Chrome trace and the JSON line here")
    a = ap.parse_args()
    bloom_args = None
    if a.bloom is not None:
        from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
        bloom_args = BloomArgs(variant=BloomVariant(a.bloom), m=a.m, k=a.k,
                               B=a.B)
    line = json.dumps(profile_join(
        a.algo, a.r, a.s, a.q, a.non_unique, bloom_args, a.passes, a.bits,
        a.radix_count, a.dense, a.materialize, a.key8b, a.zipf,
        a.trace_dir))
    print(line)
    if a.trace_dir is not None:
        with open(os.path.join(a.trace_dir, "profile.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
