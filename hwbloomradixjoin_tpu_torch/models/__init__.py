"""Join algorithm registry and run_join (counterpart of hwbloomradixjoin_tpu.models)."""

from hwbloomradixjoin_tpu_torch.models.registry import ALGORITHMS, run_join

__all__ = ["ALGORITHMS", "run_join"]
