"""Runtime configuration (counterpart of ``hwbloomradixjoin_tpu/config.py``).

The JAX package's ``interpret`` flag is gone: a wrapper launches its CUDA
kernel for a tensor on the card and runs its plain PyTorch twin for a tensor
on the CPU, so the device of the input tensors decides.  There is no
``key8b`` field: a relation built with ``Relation.from_numpy(...,
key8b=True)`` carries high words, and they alone pick the KEY_8B tiers.  Nor
is there a ``skew_handling`` field, which nothing in the JAX package reads:
the distributed join takes it as an argument (``parallel/dist_join.py``).
"""

from __future__ import annotations

import dataclasses
import enum


class BloomVariant(enum.Enum):
    BASIC = "basic"
    BLOCKED = "blocked"


@dataclasses.dataclass(frozen=True)
class BloomArgs:
    """Bloom filter geometry (the reference's bloom_filter_args_t).

    m and B must be powers of two and m a multiple of B (assert_args,
    src/bloom_filter.c:25-34).  Defaults are the reference CLI's m = 256 Mb,
    k = 8, B = 1024 (src/main.c:388-394) and its filter seed 42
    (parallel_radix_join_bloom.c:1583).
    """

    variant: BloomVariant = BloomVariant.BASIC
    m: int = 256 << 20  # filter size in bits
    k: int = 8          # probes per key
    B: int = 1024       # block size in bits (blocked variant)
    seed: int = 42      # filter hash seed

    def __post_init__(self):
        if self.m & (self.m - 1):
            raise ValueError("m must be a power of 2")
        if self.variant == BloomVariant.BLOCKED:
            if self.B & (self.B - 1):
                raise ValueError("B must be a power of 2")
            if self.m % self.B:
                raise ValueError("m must be a multiple of B")

    @property
    def nblocks(self) -> int:
        return self.m // self.B


@dataclasses.dataclass(frozen=True)
class RadixConfig:
    """Radix partitioning geometry.

    num_radix_bits: total partition bits (2^bits partitions); None lets the
    engine derive the fan-out from the key range (ops/bitmap_join.
    plan_geometry), an explicit value sweeps it like the reference's
    NUM_RADIX_BITS.  passes: the reference's NUM_PASSES (prj_params.h:20-22);
    2 partitions S by the high half of the bits, then regroups each pass-1
    bucket into one contiguous region split by the rest
    (ops/multipass.py).  use_kernels selects the radix engine's tier (the
    JAX package's use_pallas); False sends joins to the portable tiers.
    """

    num_radix_bits: int | None = None
    passes: int = 1
    use_kernels: bool = True

    def split_bits(self, total_bits: int) -> tuple[int, int]:
        """(pass-1 bits, pass-2 bits): the high half first, like the
        reference's NUM_RADIX_BITS/NUM_PASSES split
        (parallel_radix_join.c:1516-1533)."""
        b2 = total_bits // 2
        return total_bits - b2, b2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration."""

    radix: RadixConfig = dataclasses.field(default_factory=RadixConfig)
    materialize: bool = False      # JOIN_RESULT_MATERIALIZE equivalent
    sync_stats: bool = False       # per-phase timing stats (SYNCSTATS analog)
    allow_dense: bool = True       # planner may take the dense-PK fast path
