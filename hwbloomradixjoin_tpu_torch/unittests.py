"""`unittests`-compatible test driver (reference src/unit_tests.c:303-344).

Counterpart of ``hwbloomradixjoin_tpu/unittests.py``: three test programs
selected by argv, with the reference binary's positional arguments and
defaults, over the port's ``ops/hashes.py`` and ``ops/bloom.py``:

    python -m hwbloomradixjoin_tpu_torch.unittests <test_idx> [seed]
        [n_samples] [n_insertions] [m] [k_max] [--engine-backend cpu]

* test 0, ``test_hash`` (unit_tests.c:39-116): per-hash-function time and
  collision count over the exact glibc rand() stream the reference draws;
  collisions are counted exactly (distinct-output deficit, corrected for
  repeated inputs).  The same CSV header and rows.
* test 1, ``test_enhanced_double_hashing`` (unit_tests.c:118-151): the
  final (h, y) of the k-probe recurrence, in closed form (bit-exact, see
  ``_edh_final``), then the time of the recurrence over a vector on the
  device.  Cycles are that time times the card's SM clock, read at run
  time (``nvidia-smi --query-gpu=clocks.max.sm``, else the device
  properties); on the CPU they use a nominal 1 GHz, so the cycles field
  equals the ns field there.
* test 2, ``test_bloom_fpr`` (unit_tests.c:191-283): empirical vs
  theoretical FPR per (variant, k) over disjoint key ranges, as an ASCII
  table (a stand-in for libfort).  Key populations are bit-exact through
  the native selection-sampling generator (random_unique_gen_range,
  unit_tests.c:156-178).

Runs on the card unless ``--engine-backend cpu`` is given; without a card
any other backend raises.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

INT32_MAX = 2147483647
EDH_M = 2 << 20   # unit_tests.c:124
EDH_K = 100       # unit_tests.c:125
NOMINAL_CPU_GHZ = 1.0


# ---------------------------------------------------------------------------
# ASCII table (libfort stand-in: same basic box style, content-compatible)
# ---------------------------------------------------------------------------

def format_table(rows: list[list[str]], header_rows: int = 1) -> str:
    ncol = max(len(r) for r in rows)
    rows = [list(r) + [""] * (ncol - len(r)) for r in rows]
    w = [max(len(r[c]) for r in rows) for c in range(ncol)]
    sep = "+" + "+".join("-" * (wc + 2) for wc in w) + "+"
    out = [sep]
    for i, r in enumerate(rows):
        out.append("|" + "|".join(f" {v:<{wc}} " for v, wc in zip(r, w)) + "|")
        if i == header_rows - 1:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)


def sm_clock_ghz(dev: torch.device) -> float:
    """The card's maximum SM clock in GHz (NOMINAL_CPU_GHZ on the CPU)."""
    if dev.type != "cuda":
        return NOMINAL_CPU_GHZ
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True).stdout
        return float(out.split()[0]) / 1e3
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        khz = torch.cuda.get_device_properties(dev).clock_rate
        return khz / 1e6


# ---------------------------------------------------------------------------
# test 0: hash speed + collisions
# ---------------------------------------------------------------------------

# evaluation order and display names from unit_tests.c:50-60
_HASH_ORDER = [
    ("crc", "crc"), ("FNV", "FNV"), ("crapwow", "crapwow"),
    ("Coffin", "Coffin"), ("MurmurOAAT", "MurmurOAAT_32"),
    ("JenkinsOAAT", "JenkinsOAAT_32"), ("Spooky", "SpookyHash"),
    ("KR_v2", "KR_v2"), ("DJB2", "DJB2"), ("x17", "x17"),
]


def test_hash(seed: int, n_samples: int, dev: torch.device) -> None:
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.ops import hashes
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    inputs = native.rand_stream(seed, n_samples)
    in_collisions = n_samples - np.unique(inputs).size
    dev_in = torch.from_numpy(inputs).to(dev)

    print("algorithm;time_total_ms;time_single_ns;collisions;collisions_pct")
    for key, display in _HASH_ORDER:
        fn = hashes.HASH_FUNCTIONS[key]
        diff_us = time_usec(lambda fn=fn: fn(seed, dev_in), dev)
        out = fn(seed, dev_in)
        collisions = int(n_samples - torch.unique(out).numel()
                         - in_collisions)
        print(f"{display};{diff_us / 1000.0:.2f};"
              f"{diff_us / float(n_samples) * 1000:.2f};{collisions};"
              f"{collisions / float(n_samples) * 100:.2f}")


# ---------------------------------------------------------------------------
# test 1: enhanced double hashing recurrence
# ---------------------------------------------------------------------------

def _edh_final(h0: int, y0: int, n: int, k: int = EDH_K, m: int = EDH_M):
    """Bit-exact final (h, y) of the reference recurrence without iterating.

    Per outer iteration j (unit_tests.c:131-139): h,y are masked to m's low
    bits, then k inner steps do h += y; y += i+1.  Masking commutes with
    uint32 addition on the low bits, so after n-1 iterations
      y_{n-1} = y0 + (n-1)*T          with T = k(k+1)/2
      h_{n-1} = h0 + k*sum_j y_j + (n-1)*W   with W = (k^3 - k)/6
    (mod m); the final iteration is simulated literally because the reference
    prints h unmasked after the last inner loop.
    """
    if n == 0:
        return h0 & 0xFFFFFFFF, y0 & 0xFFFFFFFF
    T = k * (k + 1) // 2
    W = (k**3 - k) // 6
    j = n - 1
    sum_y = j * y0 + T * (j * (j - 1) // 2)
    h = (h0 + k * sum_y + j * W) & (m - 1)
    y = (y0 + j * T) & (m - 1)
    for i in range(k):
        h = (h + y) & 0xFFFFFFFF
        y = (y + i + 1) & 0xFFFFFFFF
    return h, y


def test_enhanced_double_hashing(seed: int, n_samples: int,
                                 dev: torch.device) -> None:
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    h0, y0 = (int(v) & 0xFFFFFFFF for v in native.rand_stream(seed, 2))
    h, y = _edh_final(h0, y0, n_samples)
    print(f"h: {np.int32(np.uint32(h))}, y: {np.int32(np.uint32(y))}")

    # throughput: the k-probe recurrence over a device vector, the shape
    # the engine executes (ops/bloom.probe_positions)
    lanes = min(max(n_samples, 1), 1 << 24)
    hv = torch.arange(lanes, dtype=torch.int64, device=dev)
    yv = (hv * 2654435761) & 0xFFFFFFFF
    mask = EDH_M - 1

    def recur():
        h, y = hv & mask, yv & mask
        acc = torch.zeros_like(h)
        for i in range(EDH_K):
            h = (h + y) & mask
            y = (y + i + 1) & 0xFFFFFFFF
            acc ^= h
        return h, y, acc

    diff_us = time_usec(recur, dev)
    ns_per_hash = diff_us * 1000.0 / lanes / EDH_K
    print(f"ns_per_hash;{ns_per_hash:.4f};cycles_per_hash;"
          f"{ns_per_hash * sm_clock_ghz(dev):.4f}", end="")
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# test 2: bloom filter FPR
# ---------------------------------------------------------------------------

def _fpr_populations(seed: int, n_insertions: int, n_samples: int):
    """R/S key sets exactly as test_bloom_fpr_wrapper builds them.

    srand(seed+1); R = unique keys in [0, threshold); S continues the same
    rand() stream in [threshold+1, INT32_MAX) (unit_tests.c:242-270).
    """
    from hwbloomradixjoin_tpu_torch.data import native

    threshold = int(INT32_MAX
                    * (n_insertions / float(n_insertions + n_samples)))
    r_keys, consumed = native.unique_gen_range(seed + 1, 0, n_insertions,
                                               0, threshold)
    s_keys, _ = native.unique_gen_range(seed + 1, consumed, n_samples,
                                        threshold + 1, INT32_MAX)
    return r_keys, s_keys


def _device_filter_counts(r_keys, s_keys, args, dev: torch.device,
                          chunk: int = 1 << 26):
    """(positives, add_usec, contains_usec): the filter built on the device
    from R, S probed in chunks."""
    from hwbloomradixjoin_tpu_torch.ops import bloom
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    r = torch.from_numpy(r_keys).to(dev)
    add_usec = time_usec(lambda: bloom.build_bitmap(r, args), dev)
    words = bloom.build_bitmap(r, args)
    pos = 0
    contains_usec = 0.0
    for i in range(0, len(s_keys), chunk):
        part = torch.from_numpy(s_keys[i:i + chunk]).to(dev)
        contains_usec += time_usec(
            lambda: bloom.probe_bitmap(words, part, args), dev)
        pos += int(bloom.probe_bitmap(words, part, args).sum())
    return pos, add_usec, contains_usec


def test_bloom_fpr_wrapper(seed: int, m: int, k_max: int, n_samples: int,
                           n_insertions: int, dev: torch.device) -> None:
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.ops.bloom import theoretical_fpr

    r_keys, s_keys = _fpr_populations(seed, n_insertions, n_samples)
    # filter seed: srand(seed); bloom_filter_create(&args, rand())
    # (test_bloom_fpr, unit_tests.c:195-203), the same for every k
    filter_seed = int(native.rand_stream(seed, 1)[0])

    rows = [["bloom-size", "r-size", "s-size", "bloom-filter", "bloom-hashes",
             "fpr_emp", "fpr_theo", "time (us) add per k",
             "time (us) contains total"]]
    for variant in (BloomVariant.BLOCKED, BloomVariant.BASIC):
        rows.append([str(m), str(n_insertions), str(n_samples),
                     variant.value, "", "", "", "", ""])
        for k in range(1, k_max + 1):
            args = BloomArgs(variant=variant, m=m, k=k, B=512,
                             seed=filter_seed)
            pos, add_us, cont_us = _device_filter_counts(r_keys, s_keys,
                                                         args, dev)
            fpr = pos / float(n_samples)  # selectivity 0: all hits are false
            theo = theoretical_fpr(m, k, n_insertions)
            rows.append(["", "", "", "", str(k), f"{fpr * 100:.3f}%",
                         f"{theo * 100:.3f}%",
                         f"{add_us / n_insertions / k:.4f}",
                         f"{cont_us:.4f}"])
    print(format_table(rows))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    backend = "auto"
    if "--engine-backend" in argv:
        i = argv.index("--engine-backend")
        backend = argv[i + 1]
        del argv[i:i + 2]
    from hwbloomradixjoin_tpu_torch.cli import device_of
    dev = device_of(backend)
    # defaults from unit_tests.c main (:303-344)
    test_idx = int(argv[0]) if len(argv) > 0 else 0
    seed = int(argv[1]) if len(argv) > 1 else 19201
    n_samples = int(argv[2]) if len(argv) > 2 else 100_000_000
    n_insertions = int(argv[3]) if len(argv) > 3 else 0
    m = int(argv[4]) if len(argv) > 4 else 1024
    k_max = int(argv[5]) if len(argv) > 5 else 1
    if test_idx == 0:
        test_hash(seed, n_samples, dev)
    elif test_idx == 1:
        test_enhanced_double_hashing(seed, n_samples, dev)
    elif test_idx == 2:
        test_bloom_fpr_wrapper(seed, m, k_max, n_samples, n_insertions, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
