"""BPRO / BPRH / BPRHO / BRJ: bloom-filtered radix joins, the filter built
by ``bloom.build_bitmap`` (the kernel on the card) and probed in plain
torch.

Counterpart of ``hwbloomradixjoin_tpu/models/bloom_join.py``.  The reference
fuses the filter build into R's pass 1 and the probe into S's pass 1,
dropping S tuples the filter rules out before they move
(parallel_radix_join_bloom.c:758-852), and reports the survivors as
"S-tuples after filter" (:1253).  Here the filter is built from R and S is
pruned before the join; pruned slots hold PAD_KEY, which no relation
contains, so the join drops them.  ``bloom_prune`` keeps S's order: the
count-table engines (their S payloads stay beside the keys), the basic
variant and the geometries the kernel prune declines use it
(``PrunePlan``); ``ops/bloom_pallas.py`` is the kernel path.
"""

from __future__ import annotations

import dataclasses

import torch

from hwbloomradixjoin_tpu_torch.config import BloomArgs
from hwbloomradixjoin_tpu_torch.ops import bloom, xla_join
from hwbloomradixjoin_tpu_torch.types import PAD_KEY
from hwbloomradixjoin_tpu_torch.utils.profiling import host_read, span


def bloom_prune(r_key: torch.Tensor, s_key: torch.Tensor, args: BloomArgs):
    """Build the filter from R; return S's survival mask and its count."""
    words = bloom.build_bitmap(r_key, args)
    mask = bloom.probe_bitmap(words, s_key, args)
    return mask, mask.sum()


def bloom_radix_count(r_key, r_pay, s_key, s_pay, args: BloomArgs,
                      variant: str = "BPRO"):
    """Bloom-pruned join: (count, sum_rpay, sum_spay, s_after), the sums
    mod 2^32; pruned S slots are masked to PAD rather than compacted."""
    del variant
    mask, s_after = bloom_prune(r_key, s_key, args)
    s_key_f = torch.where(mask, s_key, PAD_KEY)
    cnt, sr, ss = xla_join.sort_scan_count(r_key, r_pay, s_key_f, s_pay)
    return cnt, sr, ss, s_after


@dataclasses.dataclass
class PrunePlan:
    """The order-preserving prune as a plan, beside
    bloom_pallas.BloomPrunePlan: prune() rebuilds the filter and writes S's
    keys where the filter contains them, PAD elsewhere, into the first
    |S| words of `out` IN PLACE (the rest stays PAD), returning (out,
    survivor count).  phase_fns() gives bloom_build and bloom_probe, each
    run in its span (``hbrj.bloom_build``, ``hbrj.bloom_probe``)."""

    r_key: torch.Tensor
    s_key: torch.Tensor
    args: BloomArgs
    out: torch.Tensor
    s_after: int = -1
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def build(self) -> torch.Tensor:
        with span("hbrj.bloom_build"):
            return bloom.build_bitmap(self.r_key, self.args)

    def probe(self, words: torch.Tensor):
        keys = self.s_key.reshape(-1)
        with span("hbrj.bloom_probe"):
            mask = bloom.probe_bitmap(words, keys, self.args)
            torch.where(mask, keys, keys.new_tensor(PAD_KEY),
                        out=self.out[:keys.numel()])
            return self.out, mask.sum()

    def prune(self):
        return self.probe(self.build())

    def phase_fns(self) -> dict:
        if not self._cache:
            self._cache["words"] = self.build()
        return {"bloom_build": self.build,
                "bloom_probe": lambda: self.probe(self._cache["words"])}


def plan_prune(r_key: torch.Tensor, s_key: torch.Tensor, args: BloomArgs,
               chunk: int) -> PrunePlan:
    """Plan the order-preserving prune on S's device, `out` padded with PAD
    to whole chunks of `chunk` keys, and run it once (s_after)."""
    n = s_key.numel()
    with span("hbrj.plan.prune_out"):
        out = torch.full((max(-(-n // chunk), 1) * chunk,), PAD_KEY,
                         dtype=torch.int32, device=s_key.device)
    plan = PrunePlan(r_key=r_key.to(s_key.device), s_key=s_key, args=args,
                     out=out)
    with span("hbrj.plan.prune"):
        plan.s_after = host_read(plan.prune()[1])
    return plan
