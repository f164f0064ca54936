"""Algorithm registry, the tier planner and run_join.

Counterpart of ``hwbloomradixjoin_tpu/models/registry.py`` (lines 82-229,
230-252, 344-569, 572-791).  ``select_tier`` is ported whole; the kernel
tiers are ``cuda_radix`` (the JAX package's ``pallas_radix``: PRO/RJ over a
unique build side, one or two partition passes), ``cuda_prho``/``cuda_prh``/
``cuda_npo`` (its ``pallas_prho``/``pallas_prh``/``pallas_npo``: the
count-table engines), ``cuda_materialize`` (its ``pallas_materialize``: the
pairs of a unique R), ``dense`` (a declared dense primary key, one stream
over S) and ``cuda_key8b`` (its ``pallas_key8b``: 16-byte tuples whose high
key words are all zero, joined on their low words by ``cuda_radix``).  A
tier runs its CUDA kernels on tensors on the card and their plain twins on
CPU tensors, so CPU tests walk the same planner path as the card.  The
portable tiers are ``ht``, ``sortscan`` and ``materialize``, and for 16-byte
tuples ``key8b`` and ``materialize8b`` (plain torch).  ``plan_join`` gives
the plan that ``run_join`` times on a device tier, which ``profile.py``
traces.

A bloom filter (``bloom_args``) prunes S ahead of the join, as the JAX
package's ``_bloom_prologue`` does: the kernel prune (hash partition and
filter probe, ``ops/bloom_pallas.py``) where the tier accepts any S order,
the plain order-preserving prune (``models/bloom_join.py``) otherwise; the
portable tiers prune inside their first phase; NPO ignores the filter.

Timing: every phase and the whole join are timed on the device (CUDA events
on the card) after warming until steady; ``total_usec`` is the best repeat of
``inner_repeats`` whole joins issued back to back, divided by the count.
Unlike the JAX package, which built the filter at plan time and added one
timing of the prune to each repeat, the timed join here runs the filter
build and the prune every time, as the reference's TOTAL-TIME-USECS does.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from hwbloomradixjoin_tpu_torch.config import BloomArgs, EngineConfig
from hwbloomradixjoin_tpu_torch.models import bloom_join
from hwbloomradixjoin_tpu_torch.ops import (bitmap_join, bloom_pallas,
                                            dense_join, ht_join, multipass,
                                            prho_join, xla_join)
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.ops.radix import LANES
from hwbloomradixjoin_tpu_torch.types import PAD_KEY, JoinResult, Relation
from hwbloomradixjoin_tpu_torch.utils.profiling import host_read, span
from hwbloomradixjoin_tpu_torch.utils.timing import (JoinStats,
                                                    print_sync_stats,
                                                    time_usec)

MASK64 = (1 << 64) - 1

# Key-range budget for the count-table tier: slots * 8B (count + paysum).
HT_MAX_SLOTS = 1 << 28

# The bitmap radix engine spends 1 BIT per key-range slot, so it can serve
# the full int32 key space; lo >= 0 keeps normalized keys in int32.
BITMAP_MAX_SPAN = 1 << 31

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
        with span("hbrj.plan.key_range"):
            lo, hi = host_read(R.key.min()), host_read(R.key.max())
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


KERNEL_TIERS = ("cuda_radix", "cuda_prho", "cuda_prh", "cuda_npo",
                "cuda_materialize")


def _bloom_prologue(R: Relation, S: Relation, bloom_args, allow_kernel=True):
    """The prune ahead of a kernel tier (run once here), or None without a
    filter.

    Prefers the kernel prune (bloom_pallas.plan_bloom_prune: output in
    hash-partitioned order), which takes every blocked filter; the plain
    order-preserving prune serves the basic variant, which has no kernel,
    and callers whose S payloads must stay beside the keys
    (allow_kernel=False).  Both plans write into a chunk-padded buffer,
    `out`, that the join is planned over.
    """
    if bloom_args is None:
        return None
    prune = None
    if allow_kernel:
        prune = bloom_pallas.plan_bloom_prune(R.key, S.key, bloom_args,
                                              device=S.device)
    if prune is None:
        prune = bloom_join.plan_prune(R.key, S.key, bloom_args,
                                      bitmap_join.CHUNK_ROWS * LANES)
    return prune


@dataclasses.dataclass
class FilteredPlan:
    """A kernel-tier join behind the bloom filter.

    full() rebuilds the filter and prunes S into the join plan's S buffer
    (in place), then runs the join, so the timed join covers filter build,
    prune, R build, partitions and probe, all in one ``hbrj.full`` span.
    s_after is the survivor count.
    """

    prune: object        # bloom_pallas.BloomPrunePlan | bloom_join.PrunePlan
    join: object         # RadixJoinPlan | TwoPassPlan | PrhoPlan

    def __post_init__(self):
        if self.join.sk_in.data_ptr() != self.prune.out.data_ptr():
            raise AssertionError("the join is not planned over the pruned "
                                 "S buffer")

    @property
    def device(self) -> torch.device:
        return self.join.device

    @property
    def s_after(self) -> int:
        return self.prune.s_after

    def full(self) -> torch.Tensor:
        with span("hbrj.full"):
            self.prune.prune()
            return self.join.run()

    def full_count(self) -> int:
        return host_read(self.full())

    def full_sums(self):
        return tuple(host_read(self.full()).tolist())

    def phase_fns(self) -> dict:
        return {**self.prune.phase_fns(), **self.join.phase_fns()}


def plan_kernel_join(tier: str, R: Relation, S: Relation, cfg: EngineConfig,
                     key_range, wide_range, bloom_args=None):
    """The plan of a kernel tier over R and S, on S's device.

    cuda_radix plans the bitmap join over wide_range (two passes when
    cfg.radix.passes == 2 and the two-pass planner accepts, else one); the
    count-table tiers and cuda_materialize plan over key_range and return
    None when the multiplicity guard declines (for cuda_materialize: any
    repeated R key).  With a filter the plan is a FilteredPlan; PRHO, PRO
    over a non-unique R (cuda_prho) and cuda_materialize take the
    order-preserving prune.
    """
    prune = _bloom_prologue(R, S, bloom_args,
                            allow_kernel=tier in ("cuda_radix", "cuda_prh"))
    s_key = S.key if prune is None else prune.out
    bits = cfg.radix.num_radix_bits
    if tier == "cuda_radix":
        plan = None
        if cfg.radix.passes == 2:
            plan = multipass.plan_radix_join_2pass(
                R.key, s_key, *wide_range, device=S.device,
                num_radix_bits=bits)
        if plan is None:
            plan = bitmap_join.plan_radix_join(R.key, s_key, *wide_range,
                                               device=S.device,
                                               num_radix_bits=bits)
    elif tier == "cuda_prh":
        plan = prho_join.plan_prh_join(R.key, R.payload, s_key, *key_range,
                                       device=S.device, num_radix_bits=bits)
    else:
        # the plain prune's buffer is S chunk-padded: pad S's payloads alike
        s_pay = S.payload
        if prune is not None:
            with span("hbrj.plan.pad_s"):
                s_pay = radix_ops._chunk_pad(S.payload, prune.out.numel(),
                                             S.device)
        plan_fn = prho_join.plan_materialize_join \
            if tier == "cuda_materialize" else prho_join.plan_prho_join
        plan = plan_fn(R.key, R.payload, s_key, s_pay, *key_range,
                       device=S.device, num_radix_bits=bits)
    if plan is None or prune is None:
        return plan
    return FilteredPlan(prune=prune, join=plan)


def _phase_sum(phases: dict, names) -> float:
    total = 0.0
    for name in names:
        total += phases.get(name, 0.0)
    return total


@dataclasses.dataclass
class DensePlan:
    """The dense tier: R is a declared dense primary key over [lo, hi], so
    the join is one stream over S (ops/dense_join.py), behind the
    order-preserving prune with a filter (S's payloads stay beside the
    keys).  full() returns (count, S checksum) on the device."""

    prune: object        # bloom_join.PrunePlan, or None without a filter
    s_key: torch.Tensor
    s_pay: torch.Tensor
    lo: int
    hi: int

    @classmethod
    def of(cls, R: Relation, S: Relation, bloom_args, key_range):
        prune = _bloom_prologue(R, S, bloom_args, allow_kernel=False)
        if prune is None:
            return cls(None, S.key, S.payload, *key_range)
        with span("hbrj.plan.pad_s"):
            s_pay = radix_ops._chunk_pad(S.payload, prune.out.numel(),
                                         S.device)
        return cls(prune, prune.out, s_pay, *key_range)

    @property
    def device(self) -> torch.device:
        return self.s_key.device

    @property
    def s_after(self):
        return None if self.prune is None else self.prune.s_after

    def probe(self) -> torch.Tensor:
        with span("hbrj.probe"):
            return dense_join.dense_count_join(self.s_key, self.s_pay,
                                               self.lo, self.hi)

    def full(self) -> torch.Tensor:
        with span("hbrj.full"):
            if self.prune is not None:
                self.prune.prune()
            return self.probe()

    def phase_fns(self) -> dict:
        fns = {} if self.prune is None else self.prune.phase_fns()
        return {**fns, "probe": self.probe}


def _key8b_low_words(spec: AlgoSpec, R: Relation, S: Relation,
                     cfg: EngineConfig):
    """KEY_8B on the radix engine: (R, S, wide_range) over the low key
    words, or None where it does not apply.

    The reference's --enable-key8B widens tuples to int64 keys and payloads
    (types.h:22-28), but its generators still draw key values from [1,
    INT_MAX] (workload A, rerun-experiments.sh:52-60), so every high word
    is zero.  When the plan-time check confirms that, the join runs
    ``cuda_radix`` over the low-word columns: count only, sums (0, 0), as
    the JAX package's ``_run_pallas_key8b`` (registry.py:532-569).  A
    filter prunes on the low words, as the reference's uint32 filter API
    truncates int64 keys.
    """
    if spec.family != "radix" or not cfg.radix.use_kernels \
            or cfg.materialize:
        return None
    if R.stats is None or not R.stats.is_unique:
        return None
    if not high_words_zero(R, S):
        return None
    R32 = Relation(key=R.key, payload=R.payload, stats=R.stats)
    S32 = Relation(key=S.key, payload=S.payload)
    wide_range = _key_range(R32, BITMAP_MAX_SPAN, require_nonneg=True)
    if wide_range is None:
        return None
    return R32, S32, wide_range


def plan_join(name: str, R: Relation, S: Relation,
              cfg: EngineConfig = EngineConfig(),
              bloom_args: BloomArgs | None = None):
    """The plan run_join times for this join, as (plan, tier).

    For the kernel tiers, cuda_key8b (cuda_radix over the low key words)
    and dense, plan.full() is the whole timed join and plan.phase_fns() its
    phases.  Where run_join takes a plain-torch tier, plan is None and tier
    names that tier: a count-table tier whose multiplicity guard declines
    falls back to ht (cuda_prh to sortscan), materialize without its kernel
    tier stays materialize, and a KEY_8B join off the radix engine is
    key8b.  NPO ignores the filter, as the reference's B_NPO wrappers do
    (main.c:296-312).  Planning runs in the span ``hbrj.plan_join``.
    """
    with span("hbrj.plan_join"):
        return _plan_join(name, R, S, cfg, bloom_args)


def _plan_join(name, R, S, cfg, bloom_args):
    spec = ALGORITHMS[name]
    if spec.family == "npo":
        bloom_args = None
    key_range, wide_range = key_ranges(R)
    tier = select_tier(spec, R, cfg, key_range, wide_range)
    if tier == "key8b":
        low = _key8b_low_words(spec, R, S, cfg)
        if low is None:
            return None, tier
        R32, S32, wide = low
        return plan_kernel_join("cuda_radix", R32, S32, cfg, None, wide,
                                bloom_args), "cuda_key8b"
    if tier == "dense":
        # the dense path needs no table, so the count-table size cap
        # (HT_MAX_SLOTS) must not gate it: read the range off the stats
        return DensePlan.of(R, S, bloom_args, (int(R.stats.min_key),
                                               int(R.stats.max_key))), tier
    kernel, fallback = tier, "sortscan" if tier == "cuda_prh" else "ht"
    if tier == "materialize":
        if key_range is None or not cfg.radix.use_kernels:
            return None, tier
        kernel, fallback = "cuda_materialize", tier
    elif tier not in KERNEL_TIERS:
        return None, tier
    plan = plan_kernel_join(kernel, R, S, cfg, key_range, wide_range,
                            bloom_args)
    return (None, fallback) if plan is None else (plan, kernel)


def radix_geometry(plan) -> tuple:
    """(part_bits, shift, sl_rows, pad_cat) of a cuda_radix plan's probe
    (behind a filter, its join's): the bucket bits, the key shift, the
    bitmap slice rows and whether R takes the PAD category."""
    join = getattr(plan, "join", plan)
    g = getattr(join, "sgeom", join)        # TwoPassPlan holds its own
    return g.part_bits, g.shift, join.sl_rows, join.rgeom.pad_cat


def _run_plan(plan, tier: str, S: Relation, inner_repeats: int,
              compile_usec: float = 0.0):
    """Time plan_join's plan: PRO/RJ on the radix engine (count only), the
    count-table engines (count and both checksums), the materialization
    (count and the matched pairs, compacted after timing by the key image:
    a payload may equal PAD) or the dense stream (count and S's checksum).

    NPO's phase attribution follows its two-phase contract: the S partition
    counts as probe work and no partition time is reported (JAX
    registry.py:518-520).  The filter build counts as build time and the
    prune as partition time.
    """
    phases = {name: time_usec(fn, plan.device)
              for name, fn in plan.phase_fns().items()}
    total_usec = time_usec(plan.full, plan.device,
                           calls=max(1, inner_repeats))
    pairs, geometry = {}, None
    if tier in ("cuda_radix", "cuda_key8b"):
        cnt, sums = plan.full_count(), (0, 0)
        geometry = radix_geometry(plan)
    elif tier == "cuda_materialize":
        out_r, out_s, out_k, count = plan.full()
        keep = out_k != PAD_KEY
        cnt, sums = int(count), (0, 0)
        pairs = dict(r_payload=out_r[keep], s_payload=out_s[keep])
    elif tier == "dense":
        cnt, s_sum = plan.full().tolist()
        sums = (0, s_sum)
    else:
        cnt, r_sum, s_sum = plan.full_sums()
        sums = (r_sum, s_sum)
    part_usec = _phase_sum(phases, ("bloom_partition", "bloom_probe",
                                    "compact", "s_partition", "s_pass2"))
    probe_usec = phases["materialize" if tier == "cuda_materialize"
                        else "probe"]
    if tier == "cuda_npo":
        part_usec, probe_usec = 0.0, probe_usec + part_usec
    s_after = getattr(plan, "s_after", None)
    stats = JoinStats(
        total_usec=total_usec,
        build_usec=_phase_sum(phases, ("bloom_build", "r_partition",
                                       "build")),
        part_usec=part_usec, probe_usec=probe_usec, result=cnt,
        num_s_tuples=S.capacity, s_after_filter=s_after,
        compile_usec=compile_usec, tier=tier, phases=phases,
        geometry=geometry)
    return (JoinResult(total_results=cnt, s_after_filter=s_after, **pairs),
            stats, sums)


def _run_materialize(R: Relation, S: Relation, bloom_args,
                     inner_repeats: int):
    """The portable materialize tier (plain torch): the sort-based pairs of
    a unique R, or, for any other R, all pairs, the output sized by a
    pre-count over S with PAD mapped to PAD + 1 (JAX registry.py:691-701).
    The filter's prune runs inside the timed join."""
    cap = None
    if not (R.stats is not None and R.stats.is_unique):
        s_pre = torch.where(S.key == PAD_KEY, PAD_KEY + 1, S.key)
        cap = max(int(xla_join.sort_scan_count(R.key, R.payload, s_pre,
                                               S.payload)[0]), 1)

    def full():
        s_key, n = S.key, None
        if bloom_args is not None:
            mask, n = bloom_join.bloom_prune(R.key, S.key, bloom_args)
            s_key = torch.where(mask, S.key, PAD_KEY)
        if cap is None:
            out = xla_join.sort_scan_materialize(R.key, R.payload, s_key,
                                                 S.payload)
        else:
            out = xla_join.sort_scan_materialize_multi(R.key, R.payload,
                                                       s_key, S.payload, cap)
        return out, n

    total_usec = time_usec(full, S.device, calls=max(1, inner_repeats))
    (count, out_r, out_s, _), n = full()
    cnt = int(count)
    s_after = None if n is None else int(n)
    stats = JoinStats(
        total_usec=total_usec, probe_usec=total_usec, result=cnt,
        num_s_tuples=S.capacity, s_after_filter=s_after, tier="materialize",
        phases={"probe": total_usec})
    return (JoinResult(total_results=cnt, s_after_filter=s_after,
                       r_payload=out_r[:cnt], s_payload=out_s[:cnt]),
            stats, (0, 0))


def _run_portable(tier: str, R: Relation, S: Relation, bloom_args,
                  inner_repeats: int, key_range):
    """The plain-torch tiers: ht (count table) or sortscan (sort + scan),
    the filter's prune inside the first phase."""
    dev = S.device

    def prune():
        if bloom_args is None:
            return S.key, None
        mask, n = bloom_join.bloom_prune(R.key, S.key, bloom_args)
        return torch.where(mask, S.key, PAD_KEY), n

    if tier == "ht":
        lo, hi = key_range

        def first():
            sk, n = prune()
            return ht_join.build_tables(R.key, R.payload, lo, hi), sk, n

        def second(carry):
            tables, sk, n = carry
            return ht_join.probe_tables(*tables, sk, S.payload, lo, hi), n
        names = ("build", "probe")
    else:
        def first():
            sk, n = prune()
            return xla_join.sort_rows(R.key, R.payload, sk, S.payload), n

        def second(carry):
            rows, n = carry
            return xla_join.scan_sorted_count(*rows), n
        names = ("part", "probe")

    carry = first()
    phases = {names[0]: time_usec(first, dev),
              names[1]: time_usec(lambda: second(carry), dev)}
    total_usec = time_usec(lambda: second(first()), dev,
                           calls=max(1, inner_repeats))
    (c, sr, ss), n = second(first())
    cnt = int(c)
    s_after = None if n is None else int(n)
    stats = JoinStats(
        total_usec=total_usec, build_usec=phases.get("build", 0.0),
        part_usec=phases.get("part", 0.0), probe_usec=phases["probe"],
        result=cnt, num_s_tuples=S.capacity, s_after_filter=s_after,
        tier=tier, phases=phases)
    return (JoinResult(total_results=cnt, s_after_filter=s_after), stats,
            (int(sr), int(ss)))


def high_words_zero(R: Relation, S: Relation) -> bool:
    """Whether every high key word of R and S is zero: a reduction of each
    on the device and one host read, at plan time (JAX
    registry.py:547-550)."""
    with span("hbrj.plan.high_words"):
        return not host_read(torch.logical_or((R.key_hi != 0).any(),
                                              (S.key_hi != 0).any()))


def _run_wide(tier: str, R: Relation, S: Relation, bloom_args,
              inner_repeats: int):
    """The plain-torch KEY_8B tiers over (hi, lo) column pairs (JAX
    registry.py:195-229, 745-768): ``key8b`` counts, with 64-bit checksums
    whenever R carries payload high words (``Relation.from_numpy(...,
    key8b=True)`` always sets them; S's default to zero), else mod 2^32;
    ``materialize8b`` returns the matched pairs as int64 payload tensors.
    A filter prunes on the low key words (the reference's uint32 filter
    API), and every S row whose low word is PAD becomes the (PAD, PAD)
    pair, which no relation may hold, as in the JAX package.

    ``materialize8b`` over an R declared unique takes the JAX package's
    function; over any other R it emits every (R, S) pair, one a copy of
    each R key, as the reference does, the output sized by a pre-count over
    the unfiltered S that runs before the timed join and is not in its
    time, as the 32-bit tier's.  (The JAX package's tier emits no pair for
    a key that repeats in R, ROADMAP §3.)
    """
    def hi_or_zero(hi, lo):
        return torch.zeros_like(lo) if hi is None else hi

    r_phi = hi_or_zero(R.payload_hi, R.payload)
    s_phi = hi_or_zero(S.payload_hi, S.payload)
    cap = None
    if tier == "materialize8b" and not (R.stats is not None
                                        and R.stats.is_unique):
        s_hi = torch.where(S.key == PAD_KEY, PAD_KEY, S.key_hi)
        cap = max(int(xla_join.sort_scan_count_wide(
            R.key_hi, R.key, R.payload, s_hi, S.key, S.payload)[0]), 1)

    def full():
        s_lo, n = S.key, None
        if bloom_args is not None:
            mask, n = bloom_join.bloom_prune(R.key, S.key, bloom_args)
            s_lo = torch.where(mask, S.key, PAD_KEY)
        s_hi = torch.where(s_lo == PAD_KEY, PAD_KEY, S.key_hi)
        if tier == "materialize8b" and cap is None:
            out = xla_join.sort_scan_materialize_wide(
                R.key_hi, R.key, r_phi, R.payload, s_hi, s_lo, s_phi,
                S.payload)
        elif tier == "materialize8b":
            out = xla_join.sort_scan_materialize_wide_multi(
                R.key_hi, R.key, r_phi, R.payload, s_hi, s_lo, s_phi,
                S.payload, cap)
        elif R.payload_hi is None:
            out = xla_join.sort_scan_count_wide(R.key_hi, R.key, R.payload,
                                                s_hi, s_lo, S.payload)
        else:
            out = xla_join.sort_scan_count_wide64(
                R.key_hi, R.key, r_phi, R.payload, s_hi, s_lo, s_phi,
                S.payload)
        return out, n

    total_usec = time_usec(full, S.device, calls=max(1, inner_repeats))
    out, n = full()
    cnt = int(out[0])
    s_after = None if n is None else int(n)
    pairs, sums = {}, (0, 0)
    if tier == "materialize8b":
        pairs = dict(r_payload=out[1][:cnt], s_payload=out[2][:cnt])
    elif R.payload_hi is None:
        sums = (int(out[1]), int(out[2]))
    else:
        sums = (int(out[1]) & MASK64, int(out[2]) & MASK64)
    stats = JoinStats(
        total_usec=total_usec, probe_usec=total_usec, result=cnt,
        num_s_tuples=S.capacity, s_after_filter=s_after, tier=tier,
        phases={"probe": total_usec})
    return (JoinResult(total_results=cnt, s_after_filter=s_after, **pairs),
            stats, sums)


def run_join(name: str, R: Relation, S: Relation,
             cfg: EngineConfig = EngineConfig(),
             bloom_args: BloomArgs | None = None, inner_repeats: int = 1):
    """Execute a named join algorithm; returns (JoinResult, JoinStats, sums).

    sums are the (R, S) payload checksums mod 2^32 on the count-table and
    portable count tiers (S's is 0 on cuda_prh), mod 2^64 on the key8b tier
    with 64-bit payloads, (0, S's) on the dense tier and (0, 0) on the
    count-only radix tiers (cuda_radix, cuda_key8b) and the materializing
    tiers, as in the JAX package.  With cfg.materialize,
    JoinResult.r_payload and .s_payload hold the matched pairs (device
    tensors, any order; int64 for 16-byte tuples).  With bloom_args, S is
    pruned by R's filter first and JoinResult/JoinStats.s_after_filter hold
    the survivor count (NPO ignores the filter, as the reference's B_NPO
    wrappers do).  With cfg.sync_stats the phase table is printed
    (utils/timing.py).
    """
    out = _run_join(name, R, S, cfg, bloom_args, inner_repeats)
    if cfg.sync_stats:
        print_sync_stats(out[1], out[1].phases)
    return out


def _run_join(name, R, S, cfg, bloom_args, inner_repeats):
    if ALGORITHMS[name].family == "npo":
        bloom_args = None  # B_NPO wrappers ignore the filter (main.c:296-312)
    t0 = time.perf_counter()
    plan, tier = plan_join(name, R, S, cfg, bloom_args)
    if plan is not None:
        return _run_plan(plan, tier, S, inner_repeats,
                         (time.perf_counter() - t0) * 1e6)
    if tier in ("key8b", "materialize8b"):
        return _run_wide(tier, R, S, bloom_args, inner_repeats)
    if tier == "materialize":
        return _run_materialize(R, S, bloom_args, inner_repeats)
    return _run_portable(tier, R, S, bloom_args, inner_repeats,
                         key_ranges(R)[0])
