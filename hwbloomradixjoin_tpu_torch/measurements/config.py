"""One join configuration of the sweep harness, as command-line arguments.

Counterpart of the repository's ``measurements/config.py`` (``JoinConfig``,
itself the reference's measurements/config.py:14-87): the same fields and
the same arguments, for the port's command line
(``python -m hwbloomradixjoin_tpu_torch.cli``).  ``backend`` is passed as
``--engine-backend``: ``auto`` and ``cuda`` run on the card, ``cpu`` on the
plain twins.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Optional

CLI_MODULE = "hwbloomradixjoin_tpu_torch.cli"


@dataclasses.dataclass
class JoinConfig:
    algorithm: str = "PRO"
    threads: int = 8
    r_size: int = 1_000_000
    s_size: int = 8_000_000
    r_seed: int = 12345
    s_seed: int = 54321
    selectivity: float = 1.0
    skew: float = 0.0
    bloom_filter: str = "no"          # no | basic | blocked
    bloom_size: int = 1 << 30         # m bits
    bloom_hashes: int = 1             # k
    bloom_block_size: int = 512       # B bits
    non_unique: bool = False
    full_range: bool = False
    radix_bits: Optional[int] = None
    use_pallas: bool = True           # False: the portable tiers only
    no_dense: bool = False            # disable the dense-PK planner shortcut
    backend: str = "auto"             # auto | cuda | cpu
    repeats: int = 1
    inner: int = 1                    # back-to-back joins a timing
    devices: int = 0                  # distributed ranks (0 = local engine)
    local_join: str = "sortscan"      # distributed local join (pallas|sortscan)
    passes: int = 1                   # radix passes (--engine-passes)

    def to_args(self) -> list[str]:
        args = [
            "-a", self.algorithm,
            "-n", str(self.threads),
            "-r", str(self.r_size),
            "-s", str(self.s_size),
            "-x", str(self.r_seed),
            "-y", str(self.s_seed),
            "-q", str(self.selectivity),
            "-z", str(self.skew),
        ]
        if self.bloom_filter != "no":
            args += ["-b", self.bloom_filter, "-m", str(self.bloom_size),
                     "-k", str(self.bloom_hashes),
                     "-B", str(self.bloom_block_size)]
        if self.non_unique:
            args.append("--non-unique")
        if self.full_range:
            args.append("--full-range")
        if self.radix_bits is not None:
            args += ["--engine-radix-bits", str(self.radix_bits)]
        if not self.use_pallas:
            args.append("--engine-no-pallas")
        if self.no_dense:
            args.append("--engine-no-dense")
        if self.devices >= 1:
            args += ["--engine-devices", str(self.devices)]
            if self.local_join != "sortscan":
                args += ["--engine-local-join", self.local_join]
        if self.passes != 1:
            args += ["--engine-passes", str(self.passes)]
        if self.backend != "auto":
            args += ["--engine-backend", self.backend]
        if self.repeats > 1:
            args += ["--engine-repeats", str(self.repeats)]
        if self.inner > 1:
            args += ["--engine-inner", str(self.inner)]
        return args

    def cmdline(self) -> str:
        return shlex.join(["python", "-m", CLI_MODULE] + self.to_args())
