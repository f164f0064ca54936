"""The least time a query could take on the card, from its sizes alone.

A join has to read its input columns once and write its result once,
whatever implements it: R's and S's key columns, and both payload columns
when the result sums payloads.  Its least time is those bytes at the
card's peak bandwidth; it performs no arithmetic that bounds it sooner
(a compare a key), so the bound is "bytes".  Peaks: NVIDIA's data sheet
for the H100 SXM (80 GB HBM3), at its 700 W power limit.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

RESULT_BYTES = {"count": 8, "sums": 24}     # int64 count [, two checksums]


def query_bytes(config: dict, traffic: dict) -> int:
    """Bytes a query reads and writes at the least: the key columns of R
    and S (4 bytes a key), both payload columns for a payload result, and
    the result."""
    cols = 2 if traffic["result"] == "sums" else 1
    return (4 * cols * (config["r_size"] + config["s_size"])
            + RESULT_BYTES[traffic["result"]])


def least_seconds(config: dict, traffic: dict,
                  card: str = DEFAULT_CARD) -> float:
    """The query's bytes at the card's peak bandwidth (the bound is bytes);
    a card missing from PEAKS is held to the H100's."""
    peak = PEAKS.get(card, PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]
    return query_bytes(config, traffic) / peak
