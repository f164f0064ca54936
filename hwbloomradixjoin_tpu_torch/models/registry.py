"""Algorithm registry, the tier planner and run_join.

Counterpart of ``hwbloomradixjoin_tpu/models/registry.py`` (lines 82-173,
344-529, 632-791).  ``select_tier`` is ported whole; the kernel tiers are
``cuda_radix`` (the JAX package's ``pallas_radix``: PRO/RJ over a unique
build side) and ``cuda_prho``/``cuda_prh``/``cuda_npo`` (its ``pallas_prho``
/``pallas_prh``/``pallas_npo``: the count-table engines).  A tier runs its
CUDA kernels on tensors on the card and their plain twins on CPU tensors, so
CPU tests walk the same planner path as the card.  Tiers whose code is not
ported yet raise NotImplementedError naming their ROADMAP slice.

Timing: every phase and the whole join are timed on the device (CUDA events
on the card) after warming until steady; ``total_usec`` is the best repeat of
``inner_repeats`` whole joins issued back to back, divided by the count.
"""

from __future__ import annotations

import dataclasses
import time

from hwbloomradixjoin_tpu_torch.config import EngineConfig
from hwbloomradixjoin_tpu_torch.ops import (bitmap_join, ht_join, prho_join,
                                            xla_join)
from hwbloomradixjoin_tpu_torch.types import JoinResult, Relation
from hwbloomradixjoin_tpu_torch.utils.timing import JoinStats, time_usec

# Key-range budget for the count-table tier: slots * 8B (count + paysum).
HT_MAX_SLOTS = 1 << 28

# The bitmap radix engine spends 1 BIT per key-range slot, so it can serve
# the full int32 key space; lo >= 0 keeps normalized keys in int32.
BITMAP_MAX_SPAN = 1 << 31

# Tiers select_tier can pick whose engines are not ported yet.
UNPORTED_TIERS = {
    "materialize": "materialization, ROADMAP slice 4",
    "key8b": "KEY_8B (16-byte tuples), ROADMAP slice 6",
    "materialize8b": "KEY_8B materialization, ROADMAP slices 4 and 6",
    "dense": "the dense fast path, ROADMAP slice 7",
}


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    name: str
    family: str            # "radix" | "npo"
    uses_bloom: bool       # whether the bloom twin actually filters
    single_device: bool    # RJ / NPO_st: pinned single-chip execution


ALGORITHMS = {
    "PRO": AlgoSpec("PRO", "radix", True, False),
    "RJ": AlgoSpec("RJ", "radix", True, True),
    "PRH": AlgoSpec("PRH", "radix", True, False),
    "PRHO": AlgoSpec("PRHO", "radix", True, False),
    "NPO": AlgoSpec("NPO", "npo", False, False),
    "NPO_st": AlgoSpec("NPO_st", "npo", False, True),
}


def _key_range(R: Relation, max_span: int = HT_MAX_SLOTS,
               require_nonneg: bool = False):
    """Static key range for the table/bitmap tiers; None if unusable.

    Uses declared stats when present; otherwise a plan-time min/max.
    """
    if R.stats is not None:
        lo, hi = int(R.stats.min_key), int(R.stats.max_key)
    else:
        lo, hi = int(R.key.min()), int(R.key.max())
    if hi - lo + 1 > max_span or lo < -(1 << 30):
        return None
    if require_nonneg and lo < 0:
        return None
    return lo, hi


def select_tier(spec: AlgoSpec, R: Relation, cfg: EngineConfig,
                key_range, wide_range=None) -> str:
    """Pick the execution tier for this (algorithm, workload, config).

    key_range is gated at HT_MAX_SLOTS (word-granular tables); wide_range at
    BITMAP_MAX_SPAN (the bit-granular bitmap engine).
    """
    if wide_range is None:
        wide_range = key_range
    if R.key_hi is not None:
        return "materialize8b" if cfg.materialize else "key8b"
    dense_ok = (R.stats is not None and R.stats.is_dense_pk
                and not cfg.materialize and cfg.allow_dense
                and spec.family == "radix"
                and R.key.device.type == "cuda")
    if dense_ok:
        return "dense"
    if cfg.materialize:
        return "materialize"
    kernels = cfg.radix.use_kernels
    table_range = key_range is not None \
        and key_range[1] - key_range[0] < HT_MAX_SLOTS
    if spec.name in ("PRO", "RJ") and kernels and wide_range is not None \
            and R.stats is not None and R.stats.is_unique:
        return "cuda_radix"
    if spec.name in ("PRO", "RJ") and kernels and key_range is not None:
        # non-unique build side: the exact bitmap cannot carry multiplicity
        return "cuda_prho"
    if spec.name == "PRHO" and kernels and table_range:
        return "cuda_prho"
    if spec.name == "PRH" and kernels and table_range:
        return "cuda_prh"
    if spec.family == "npo" and kernels and table_range:
        return "cuda_npo"
    if spec.name == "PRH" or key_range is None:
        return "sortscan"
    return "ht"


def key_ranges(R: Relation):
    """(key_range, wide_range) of R for select_tier: the count tables' range
    (None past HT_MAX_SLOTS) and the bitmap engine's."""
    key_range = _key_range(R) if R.key_hi is None else None
    wide_range = key_range
    if wide_range is None and R.key_hi is None:
        wide_range = _key_range(R, BITMAP_MAX_SPAN, require_nonneg=True)
    return key_range, wide_range


def plan_kernel_join(tier: str, R: Relation, S: Relation, cfg: EngineConfig,
                     key_range, wide_range):
    """The plan of a kernel tier over R and S, on S's device.

    cuda_radix plans the bitmap join over wide_range; the count-table tiers
    plan over key_range and return None when the multiplicity guard
    declines.
    """
    bits = cfg.radix.num_radix_bits
    if tier == "cuda_radix":
        return bitmap_join.plan_radix_join(R.key, S.key, *wide_range,
                                           device=S.device,
                                           num_radix_bits=bits)
    if tier == "cuda_prh":
        return prho_join.plan_prh_join(R.key, R.payload, S.key, *key_range,
                                       device=S.device, num_radix_bits=bits)
    return prho_join.plan_prho_join(R.key, R.payload, S.key, S.payload,
                                    *key_range, device=S.device,
                                    num_radix_bits=bits)


def _run_cuda_radix(R: Relation, S: Relation, cfg: EngineConfig,
                    inner_repeats: int, wide_range):
    """PRO/RJ on the radix engine: partition + exact-bitmap probe."""
    t0 = time.perf_counter()
    plan = plan_kernel_join("cuda_radix", R, S, cfg, None, wide_range)
    compile_usec = (time.perf_counter() - t0) * 1e6
    phases = {name: time_usec(fn, plan.device)
              for name, fn in plan.phase_fns().items()}

    reps = max(1, inner_repeats)
    total_usec = time_usec(plan.full, plan.device, calls=reps)
    cnt = plan.full_count()
    stats = JoinStats(
        total_usec=total_usec,
        build_usec=phases["r_partition"] + phases["build"],
        part_usec=phases.get("compact", 0.0) + phases["s_partition"],
        probe_usec=phases["probe"],
        result=cnt, num_s_tuples=S.capacity, compile_usec=compile_usec,
        tier="cuda_radix", raw_total_usec=total_usec, floor_usec=0.0,
        phases=phases)
    return JoinResult(total_results=cnt), stats, (0, 0)


def _run_cuda_prho(tier: str, R: Relation, S: Relation, cfg: EngineConfig,
                   inner_repeats: int, key_range):
    """PRHO/PRH/NPO (and PRO/RJ over a non-unique R) on the count-table
    engine: partition with payloads, table build, S partition, table probe.

    NPO's phase attribution follows its two-phase contract: the S partition
    counts as probe work and no partition time is reported (JAX
    registry.py:518-520).  Returns None when the planner's multiplicity
    guard declines, and the caller falls back as the JAX package does.
    """
    t0 = time.perf_counter()
    plan = plan_kernel_join(tier, R, S, cfg, key_range, None)
    if plan is None:
        return None
    compile_usec = (time.perf_counter() - t0) * 1e6
    phases = {name: time_usec(fn, plan.device)
              for name, fn in plan.phase_fns().items()}
    total_usec = time_usec(plan.full, plan.device,
                           calls=max(1, inner_repeats))
    cnt, r_sum, s_sum = plan.full_sums()
    part_usec, probe_usec = phases["s_partition"], phases["probe"]
    if tier == "cuda_npo":
        part_usec, probe_usec = 0.0, probe_usec + part_usec
    stats = JoinStats(
        total_usec=total_usec,
        build_usec=phases["r_partition"] + phases["build"],
        part_usec=part_usec, probe_usec=probe_usec, result=cnt,
        num_s_tuples=S.capacity, compile_usec=compile_usec, tier=tier,
        raw_total_usec=total_usec, floor_usec=0.0, phases=phases)
    return JoinResult(total_results=cnt), stats, (r_sum, s_sum)


def _run_portable(tier: str, R: Relation, S: Relation, inner_repeats: int,
                  key_range):
    """The plain-torch tiers: ht (count table) or sortscan (sort + scan)."""
    dev = S.device
    if tier == "ht":
        lo, hi = key_range

        def first():
            return ht_join.build_tables(R.key, R.payload, lo, hi)

        def second(tables):
            return ht_join.probe_tables(*tables, S.key, S.payload, lo, hi)
        names = ("build", "probe")
    else:
        def first():
            return xla_join.sort_rows(R.key, R.payload, S.key, S.payload)

        def second(carry):
            return xla_join.scan_sorted_count(*carry)
        names = ("part", "probe")

    carry = first()
    phases = {names[0]: time_usec(first, dev),
              names[1]: time_usec(lambda: second(carry), dev)}
    total_usec = time_usec(lambda: second(first()), dev,
                           calls=max(1, inner_repeats))
    c, sr, ss = second(first())
    cnt = int(c)
    stats = JoinStats(
        total_usec=total_usec, build_usec=phases.get("build", 0.0),
        part_usec=phases.get("part", 0.0), probe_usec=phases["probe"],
        result=cnt, num_s_tuples=S.capacity, tier=tier,
        raw_total_usec=total_usec, phases=phases)
    return JoinResult(total_results=cnt), stats, (int(sr), int(ss))


def run_join(name: str, R: Relation, S: Relation,
             cfg: EngineConfig = EngineConfig(), bloom_args=None,
             inner_repeats: int = 1):
    """Execute a named join algorithm; returns (JoinResult, JoinStats, sums).

    sums are the (R, S) payload checksums mod 2^32 on the count-table and
    portable tiers (S's is 0 on cuda_prh) and (0, 0) on the count-only radix
    tier, as in the JAX package.
    """
    spec = ALGORITHMS[name]
    if spec.family == "npo":
        bloom_args = None  # B_NPO wrappers ignore the filter (main.c:296-312)
    if bloom_args is not None:
        raise NotImplementedError("bloom pre-filter: ROADMAP slice 5")
    key_range, wide_range = key_ranges(R)
    tier = select_tier(spec, R, cfg, key_range, wide_range)
    if tier in UNPORTED_TIERS:
        raise NotImplementedError(f"tier {tier}: {UNPORTED_TIERS[tier]}")
    if tier == "cuda_radix":
        return _run_cuda_radix(R, S, cfg, inner_repeats, wide_range)
    if tier in ("cuda_prho", "cuda_prh", "cuda_npo"):
        out = _run_cuda_prho(tier, R, S, cfg, inner_repeats, key_range)
        if out is not None:
            return out
        tier = "sortscan" if tier == "cuda_prh" else "ht"
    return _run_portable(tier, R, S, inner_repeats, key_range)
