"""The control of the check that decides ``correct``: the reference put in
the program's place with the join's key equality weakened to 16 bits.

    python -m joinbench.control --workload workload_b.pro --seeds 1 2 3

The configurations state an exact join on 32-bit keys and no precision of
their own, so the control breaks that guarantee the way a faster join
would be tempted to: it matches keys by a 16-bit fingerprint (the key's
CrapWow hash cut to 16 bits), as a hash table holding 16-bit tags and never
comparing the keys themselves does.  Its answers are compared with the
exact reference's as the program's are, and have to come out not correct.
For each seed it makes the cell's relations on the device at the cell's
own size and prints one JSON line: the seed, each number compared with its
limit, and whether the control passed.  Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from joinbench import datagen, filterhash, reference

FINGERPRINT_SEED = 0


def fingerprint16(keys: torch.Tensor) -> torch.Tensor:
    """The key as the control compares it: 16 bits of its CrapWow hash
    (a CRC, being linear, would keep small keys apart)."""
    return filterhash.crapwow(FINGERPRINT_SEED, keys) & 0xFFFF


def readings(rel, config: dict, traffic: dict) -> dict:
    """The control's numbers against the exact reference: {name_gap:
    {value, limit}} and whether it passed."""
    want = reference.answers(rel, config, traffic)
    got = reference.answers(rel, config, traffic, keys_of=fingerprint16)
    widest, failed = reference.compare([got], want)
    return {"checks": {f"{n}_gap": {"value": widest[n],
                                    "limit": reference.LIMITS[n]}
                       for n in want},
            "correct": failed == 0}


def main(argv=None) -> int:
    from joinbench.run import resolve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    _, config, traffic, _ = resolve(args.workload)
    for seed in args.seeds:
        rel = datagen.make(config, seed, "cuda")
        line = {"workload": args.workload, "seed": seed,
                **readings(rel, config, traffic)}
        del rel
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
