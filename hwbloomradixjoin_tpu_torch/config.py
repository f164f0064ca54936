"""Runtime configuration (counterpart of ``hwbloomradixjoin_tpu/config.py``).

The JAX package's ``interpret`` flag is gone: a wrapper launches its CUDA
kernel for a tensor on the card and runs its plain PyTorch twin for a tensor
on the CPU, so the device of the input tensors decides.  Fields that only the
unported tiers read (two-pass partitioning, KEY_8B, sync stats, distributed
skew handling) arrive with their ROADMAP slices.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RadixConfig:
    """Radix partitioning geometry.

    num_radix_bits: total partition bits (2^bits partitions); None lets the
    engine derive the fan-out from the key range (ops/bitmap_join.
    plan_geometry), an explicit value sweeps it like the reference's
    NUM_RADIX_BITS.  use_kernels selects the radix engine's tier (the JAX
    package's use_pallas); False sends joins to the portable tiers.
    """

    num_radix_bits: int | None = None
    use_kernels: bool = True


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration."""

    radix: RadixConfig = dataclasses.field(default_factory=RadixConfig)
    materialize: bool = False      # JOIN_RESULT_MATERIALIZE equivalent
    allow_dense: bool = True       # planner may take the dense-PK fast path
