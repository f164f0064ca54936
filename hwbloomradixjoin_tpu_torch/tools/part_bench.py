"""One partition pass (kernel 1) timed on the card.

Counterpart of the repository's ``tools/part_bench.py``: n uniform keys
over [0, 2^(part_bits + shift)), chunk-padded, partitioned by
``radix.partition_pass`` in range mode at (part_bits, shift):

    python -m hwbloomradixjoin_tpu_torch.tools.part_bench [n part_bits shift reps]
    python -m hwbloomradixjoin_tpu_torch.tools.part_bench 16000000 --widths
    python -m hwbloomradixjoin_tpu_torch.tools.part_bench 3000 5 7 1 \\
        --engine-backend cpu

Defaults 128M keys, 5 bits, shift 19, 4 calls a measurement.  A pass is
timed with CUDA events over reps back-to-back calls after warm-up
(``utils/timing.time_usec``, best of 3) and printed in ms, ns a key and
GB/s (keys read and written once).  With --widths it prints that line for
part_bits 1..13 over the same keys (shift = part_bits + shift - width) and
the slope of ns a key per split bit fitted over them, over 1..13 and over
the widths one sweep covers (1..8), beside the constant the planners keep
(``bitmap_join.SPLIT_NS_PER_BIT``, the JAX planner's).  Before timing, the
first chunk's keys and starts are held against the plain twin; a mismatch
exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hwbloomradixjoin_tpu_torch.ops import bitmap_join
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops

CHUNK_ROWS = bitmap_join.CHUNK_ROWS     # the planner's chunk
WIDTHS = range(1, 14)
ONE_SWEEP_WIDTHS = range(1, 9)          # csrc/radix.cu's one-sweep fan-out


def first_chunk_matches(keys: torch.Tensor,
                        geom: radix_ops.RadixGeom) -> bool:
    """True iff partition_pass over keys gives the plain twin's keys and
    starts on the first chunk."""
    out, starts = radix_ops.partition_pass(keys, geom)
    want, want_starts = radix_ops.partition_pass_plain(
        keys[:geom.chunk_rows * radix_ops.LANES], geom)
    return torch.equal(out[:geom.chunk_rows], want) \
        and torch.equal(starts[:geom.cat_rows], want_starts)


def bench(keys: torch.Tensor, n: int, part_bits: int, shift: int,
          reps: int):
    """(ns a key, a line) of one pass over keys (n keys chunk-padded, on
    their device) at (part_bits, shift); raises if the first chunk's
    output differs from the twin's."""
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    hi = (1 << (part_bits + shift)) - 1
    geom = radix_ops.RadixGeom(chunk_rows=CHUNK_ROWS, part_bits=part_bits,
                               lo=0, hi=hi, shift=shift)
    if not first_chunk_matches(keys, geom):
        raise AssertionError(f"partition at ({part_bits}, {shift}): the "
                             "first chunk differs from the twin's")
    us = time_usec(lambda: radix_ops.partition_pass(keys, geom), keys.device,
                   calls=reps)
    ns = us * 1e3 / n
    return ns, (f"partition {n} keys bits={part_bits} shift={shift}: "
                f"{us / 1e3:.4f} ms/pass = {ns:.5f} ns/key "
                f"({2 * 4 * n / us / 1e3:.1f} GB/s)")


def slope(widths, ns) -> float:
    """The least-squares slope of ns a key against part_bits."""
    return float(np.polyfit(np.asarray(widths, float), np.asarray(ns), 1)[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=lambda v: int(float(v)),
                   default=128_000_000)
    p.add_argument("part_bits", nargs="?", type=int, default=5)
    p.add_argument("shift", nargs="?", type=int, default=19)
    p.add_argument("reps", nargs="?", type=int, default=4)
    p.add_argument("--widths", action="store_true",
                   help="each width 1..13 over the same keys, and the slope")
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of

    bits = a.part_bits + a.shift
    if a.widths and bits < WIDTHS[-1]:
        p.error(f"--widths needs part_bits + shift >= {WIDTHS[-1]}")
    dev = device_of(a.engine_backend)
    rng = np.random.default_rng(0)
    sk = rng.integers(0, 1 << bits, a.n).astype(np.int32)
    keys = radix_ops._chunk_pad(sk, CHUNK_ROWS * radix_ops.LANES, dev)
    del sk
    widths = list(WIDTHS) if a.widths else [a.part_bits]
    ns = []
    for w in widths:
        got, line = bench(keys, a.n, w, bits - w, a.reps)
        ns.append(got)
        print(line, flush=True)
    if a.widths:
        one = [x for w, x in zip(widths, ns) if w in ONE_SWEEP_WIDTHS]
        print(f"slope: {slope(widths, ns):.5f} ns/key per split bit over "
              f"{widths[0]}-{widths[-1]} bits, "
              f"{slope(list(ONE_SWEEP_WIDTHS), one):.5f} over "
              f"{ONE_SWEEP_WIDTHS[0]}-{ONE_SWEEP_WIDTHS[-1]} (one sweep); "
              f"the planners keep SPLIT_NS_PER_BIT = "
              f"{bitmap_join.SPLIT_NS_PER_BIT} (the JAX planner's constant)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
