"""The join over the full int32 key span, on the card.

Counterpart of the repository's ``tools/validate_fullrange.py``: a sparse
unique R over [1, 2^31) and an S whose non-matching keys lie inside R's span,
so range pruning drops nothing and only the bitmap decides.  The span plans
(13, 18, 64): 8,192 buckets of 2^18 keys over a 256 MiB bitmap, with R's PAD
category (``radix.pad_cat_safe`` is false there).

    python -m hwbloomradixjoin_tpu_torch.tools.validate_fullrange
    python -m hwbloomradixjoin_tpu_torch.tools.validate_fullrange \\
        --r 4000 --s 40000 --engine-backend cpu

Runs PRO, then PRO behind a blocked filter (BPRO, B = 512) at each m and k,
and checks for each: the tier (cuda_radix on the card and on the CPU's
twins), the plan's geometry, the count against the host's membership count,
S-tuples after filter against the plain prune (``models.bloom_join
.bloom_prune``) on the same device, and the survivor share against p + (1 -
p) fpr(m, k, |R|) within 20 %, where p = expected / |S| is the real match
share: the q drawn from R plus R's accidental members among the uniform
keys (|R| / 2^31 of them, 0.745 % at 16M).  Prints one line a join and exits
non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

FULL_SPAN_GEOMETRY = (13, 18, 64)     # plan_geometry(1, 2^31 - 1)
SURVIVOR_TOLERANCE = 0.2              # relative, as the JAX tools
# BPRO's blocked filters (B = 512): m in {2^27, 2^30} x k in {1, 4}
FILTERS = tuple((1 << mb, k) for mb in (27, 30) for k in (1, 4))


def build_inrange_workload(n_r=16_000_000, n_s=128_000_000, q=0.01, seed=9):
    """(R keys, S keys): the JAX tool's arrays, from numpy's default_rng."""
    rng = np.random.default_rng(seed)
    # unique sparse keys over [1, 2^31): oversample + dedupe (a full-space
    # arange would be 17 GB)
    cand = rng.integers(1, (1 << 31) - 1, int(n_r * 1.05), dtype=np.int64)
    rk = np.unique(cand)[:n_r]
    assert rk.shape[0] == n_r
    rng.shuffle(rk)
    rk = rk.astype(np.int32)
    n_match = int(n_s * q)
    sk = np.concatenate([
        rng.choice(rk, n_match),
        rng.integers(1, (1 << 31) - 1, n_s - n_match).astype(np.int32),
    ]).astype(np.int32)
    rng.shuffle(sk)
    return rk, sk


def host_count(rk: np.ndarray, sk: np.ndarray) -> int:
    """The S keys that R holds (R unique): sorted S searched in sorted R
    (in S's own order the search takes minutes at 128M keys)."""
    rs, ss = np.sort(rk), np.sort(sk)
    at = np.minimum(np.searchsorted(rs, ss), len(rs) - 1)
    return int(np.count_nonzero(rs[at] == ss))


def survivor_theory(expected: int, n_s: int, m: int, k: int,
                    n_r: int) -> float:
    """The share of S a filter keeps: the matches, p = expected / |S|, and
    a false positive among the rest, p + (1 - p) fpr(m, k, |R|)."""
    from hwbloomradixjoin_tpu_torch.ops import bloom

    p = expected / n_s
    return p + (1 - p) * bloom.theoretical_fpr(m, k, n_r)


def relations(rk: np.ndarray, sk: np.ndarray, device):
    """R with its payloads and stats (unique keys over its own min and max)
    and S's keys alone (the count-only radix tier reads no S payload), on
    the device."""
    import torch

    from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation

    stats = KeyStats(min_key=int(rk.min()), max_key=int(rk.max()),
                     is_unique=True)
    R = Relation.from_numpy(rk, np.arange(len(rk), dtype=np.int32),
                            device=device, stats=stats)
    S = Relation(key=torch.from_numpy(sk).to(device),
                 payload=torch.zeros(1, dtype=torch.int32, device=device))
    return R, S


def validate_join(label: str, R, S, n_s: int, expected: int, cfg,
                  bloom_args=None, geometry=None, inner_repeats: int = 3,
                  on_joined=None):
    """run_join("PRO") of R and S (the first n_s keys of S real), held to
    the expected count, the tier cuda_radix, the geometry of the timed
    plan if given, and,
    behind a filter, the plain prune's S-tuples after filter and the
    survivor theory.  on_joined, if given, is called as run_join returns,
    before the checks run anything on the device.  Returns (ok, stats,
    line)."""
    from hwbloomradixjoin_tpu_torch.models import bloom_join, run_join

    res, st, _ = run_join("PRO", R, S, cfg, bloom_args,
                          inner_repeats=inner_repeats)
    if on_joined is not None:
        on_joined()
    fails = []
    if st.tier != "cuda_radix":
        fails.append(f"tier {st.tier}")
    if res.count() != expected:
        fails.append(f"count {res.count()} != {expected}")
    line = (f"{label}: tier={st.tier} total={st.total_usec / 1e3:.4f}ms "
            f"({st.total_usec * 1e3 / n_s:.5f} ns/S-tuple) "
            f"build={st.build_usec / 1e3:.4f}ms "
            f"part={st.part_usec / 1e3:.4f}ms "
            f"probe={st.probe_usec / 1e3:.4f}ms count={res.count()} "
            f"expect={expected}")
    if geometry is not None:
        got, pad_cat = st.geometry[:3], st.geometry[3]
        line += f" plan={got} pad_cat={pad_cat}"
        if got != geometry:
            fails.append(f"plan {got} != {geometry}")
    if bloom_args is not None:
        _, n_plain = bloom_join.bloom_prune(R.key, S.key[:n_s], bloom_args)
        share = res.s_after_filter / n_s
        theory = survivor_theory(expected, n_s, bloom_args.m, bloom_args.k,
                                 R.key.numel())
        line += (f" | s_after={res.s_after_filter} plain={int(n_plain)} "
                 f"survivors {share * 100:.4f}% (theory {theory * 100:.4f}%"
                 f", p={expected / n_s * 100:.4f}%)")
        if res.s_after_filter != int(n_plain):
            fails.append(f"s_after {res.s_after_filter} != plain "
                         f"{int(n_plain)}")
        if abs(share - theory) > SURVIVOR_TOLERANCE * theory:
            fails.append(f"survivors {share:.6f} off theory {theory:.6f}")
    ok = not fails
    return ok, st, line + (" -> OK" if ok else f" -> FAIL: {fails}")


def blocked(m: int, k: int):
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    return BloomArgs(variant=BloomVariant.BLOCKED, m=m, k=k, B=512)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--r", type=int, default=16_000_000)
    p.add_argument("--s", type=int, default=128_000_000)
    p.add_argument("--q", type=float, default=0.01)
    p.add_argument("--bits", type=int, default=None,
                   help="RadixConfig.num_radix_bits (default: the planner's)")
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of
    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig

    dev = device_of(a.engine_backend)
    print(f"full-range: {a.r} x {a.s} q={a.q} on {dev}", flush=True)
    t0 = time.perf_counter()
    rk, sk = build_inrange_workload(a.r, a.s, a.q)
    want = host_count(rk, sk)
    print(f"datagen + host count: {time.perf_counter() - t0:.1f}s "
          f"expect={want}", flush=True)
    R, S = relations(rk, sk, dev)
    del rk, sk
    cfg = EngineConfig(radix=RadixConfig(num_radix_bits=a.bits),
                       allow_dense=False)
    geometry = FULL_SPAN_GEOMETRY if a.bits is None else None
    runs = [("PRO", None)] + [
        (f"BPRO blocked m=2^{m.bit_length() - 1} k={k} B=512", blocked(m, k))
        for m, k in FILTERS]
    all_ok = True
    for label, args in runs:
        ok, _, line = validate_join(label, R, S, a.s, want, cfg, args,
                                    geometry)
        all_ok &= ok
        print(line, flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
