""".tbl text-table IO, format-compatible with the reference.

The port's own copy of ``hwbloomradixjoin_tpu/data/tblio.py``.
write_relation (generator.c:250-263) emits a "#KEY, VAL" header then
"%d %d" rows; read_relation (generator.c:685-741) detects space, comma and
pipe separators and tolerates key-only rows.  These files are the
cross-validation interface with the reference binary (PERSIST_RELATIONS)
and the Wisconsin engine's pipe-delimited tables.
"""

from __future__ import annotations

import numpy as np


def write_relation(path: str, keys: np.ndarray, payloads: np.ndarray) -> None:
    """Write (key, payload) rows under the reference's header."""
    with open(path, "w") as f:
        f.write("#KEY, VAL\n")
        np.savetxt(f, np.column_stack([np.asarray(keys),
                                       np.asarray(payloads)]), fmt="%d")


def read_relation(path: str, num_tuples: int | None = None):
    """(keys, payloads) as int32 from a .tbl file of 'k v', 'k,v' or 'k|v'
    rows (payloads 0 for key-only rows), at most num_tuples of them."""
    with open(path) as f:
        first = f.readline()
        if not first.startswith("#"):
            f.seek(0)
        pos = f.tell()
        sample = f.readline()
        f.seek(pos)
        delim = "," if "," in sample else "|" if "|" in sample else None
        data = np.loadtxt(f, delimiter=delim, dtype=np.int64, ndmin=2,
                          max_rows=num_tuples)
    keys = data[:, 0].astype(np.int32)
    if data.shape[1] > 1:
        return keys, data[:, 1].astype(np.int32)
    return keys, np.zeros(len(keys), dtype=np.int32)
