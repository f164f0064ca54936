"""hwbloomradixjoin_tpu_torch — the PyTorch + CUDA port of hwbloomradixjoin_tpu.

The JAX package beside it stays the reference.  This package mirrors its
module names and array layouts; every Pallas kernel on a ported path is a
hand-written CUDA kernel for Hopper (``csrc/``), built with ``nvcc`` at first
use (``kernels/_build.py``), with a plain PyTorch twin that runs on CPU
tensors.  Importing the package builds and loads nothing.

Ported so far: the PRO bitmap radix join (unique build side, count only, one
or two partition passes), the count-table engines (PRHO, PRH, NPO, and PRO
over a non-unique build side, with both payload checksums), the bloom
pre-filter, the dense fast path, materialization, the general radix count
join (``ops.radix.radix_join_count``), KEY_8B (16-byte tuples), the
portable ``ht``/``sortscan``/``materialize`` tiers, the reference's
command line (``cli``, ``confrun``, ``unittests``), the standalone operators
(``ops.sort``, ``ops.aggregate``) and the distributed join on
``torch.distributed`` (``parallel``: one process a device, the bitmap
kernels or a sort-scan as each device's local join), and the measurement
harness (``measurements.run``, the sweeps over the CLI;
``tools.validate_fullrange`` and ``tools.validate_bloom``).  Entry points
run on the card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"

from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                               EngineConfig, RadixConfig)
from hwbloomradixjoin_tpu_torch.types import (JoinResult, KeyStats, Relation,
                                              key_dtype)

__all__ = [
    "Relation",
    "JoinResult",
    "KeyStats",
    "key_dtype",
    "BloomArgs",
    "BloomVariant",
    "RadixConfig",
    "EngineConfig",
]
