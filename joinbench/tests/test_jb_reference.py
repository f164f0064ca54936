"""The plain reference against a brute-force join, and its frozen filter
hashes against pure-Python ones and the program's."""

import random

import pytest
import torch

from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
from hwbloomradixjoin_tpu_torch.ops import bloom, hashes
from joinbench import filterhash, reference

M32 = 0xFFFFFFFF


def crc32c_py(seed, key):
    x = (key ^ seed) & M32
    for _ in range(32):
        x = (x >> 1) ^ (0x82F63B78 if x & 1 else 0)
    return x


def crapwow_py(seed, key):
    m = 0x5052ACDB
    p = (key & M32) * m
    h, k = (p & M32) ^ 4, (p >> 32) ^ ((seed + 4 + m) & M32)
    p = (h ^ ((k + m) & M32)) * m
    return (k ^ (p >> 32)) ^ (h ^ (p & M32))


def positions_py(key, filt):
    """Bit positions of one key, the reference's add_generic loop."""
    seed, k = filt["seed"], filt["k"]
    size = filt["m"] if filt["variant"] == "basic" else filt["B"]
    base = 0 if filt["variant"] == "basic" else \
        (crc32c_py(seed, key) % (filt["m"] // filt["B"])) * filt["B"]
    h, y = crapwow_py(seed, key) % size, ((key & M32) + seed) % size
    out = [h]
    for i in range(1, k):
        h, y = (h + y) % size, (y + i) % size
        out.append(h)
    return [base + p for p in out]


def brute(r_key, r_pay, s_key, s_pay, filt):
    count = r_sum = s_sum = 0
    for sk, sp in zip(s_key, s_pay):
        for rk, rp in zip(r_key, r_pay):
            if rk == sk:
                count += 1
                r_sum += rp & M32
                s_sum += sp & M32
    bits = {p for rk in r_key for p in positions_py(rk, filt)}
    kept = sum(all(p in bits for p in positions_py(sk, filt))
               for sk in s_key)
    return {"count": count, "r_sum": r_sum & M32, "s_sum": s_sum & M32,
            "s_after": kept}


FILTERS = [{"variant": "blocked", "m": 1 << 14, "k": 1, "B": 512,
            "seed": 42},
           {"variant": "blocked", "m": 1 << 13, "k": 3, "B": 256,
            "seed": 7},
           {"variant": "basic", "m": 1 << 12, "k": 2, "B": 512,
            "seed": 42}]


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("unique", [True, False])
def test_reference_equals_brute_force(filt, unique):
    rnd = random.Random(f"{filt}{unique}")
    nr, ns = 300, 2000
    if unique:
        r_key = rnd.sample(range(-50, 1000), nr)
    else:
        r_key = [rnd.randrange(-50, 400) for _ in range(nr)]
    r_key[0] = 2**31 - 1
    s_key = [rnd.randrange(-80, 1200) for _ in range(ns)] + [2**31 - 1,
                                                             -2**31]
    r_pay = [rnd.randrange(-2**31, 2**31) for _ in r_key]
    s_pay = [rnd.randrange(-2**31, 2**31) for _ in s_key]
    want = brute(r_key, r_pay, s_key, s_pay, filt)
    t = [torch.tensor(x, dtype=torch.int32)
         for x in (r_key, r_pay, s_key, s_pay)]
    got = reference.join(*t)
    got["s_after"] = reference.survivors(t[0], t[2], filt)
    assert got == want


def test_frozen_hashes_equal_python_and_the_program():
    keys = torch.tensor([0, 1, -1, 2**31 - 1, -2**31, 123456789, 42]
                        + list(range(-3000, 3000, 7)), dtype=torch.int32)
    for seed in (0, 42, 0xDEADBEEF):
        crc = filterhash.crc32c(seed, keys).tolist()
        cw = filterhash.crapwow(seed, keys).tolist()
        assert crc == [crc32c_py(seed, k) for k in keys.tolist()]
        assert cw == [crapwow_py(seed, k) for k in keys.tolist()]
        assert crc == hashes.hash_crc(seed, keys).tolist()
        assert cw == hashes.hash_crapwow(seed, keys).tolist()
    for filt in FILTERS:
        args = BloomArgs(variant=BloomVariant(filt["variant"]), m=filt["m"],
                         k=filt["k"], B=filt["B"], seed=filt["seed"])
        for ours, theirs in zip(filterhash.positions(keys, filt),
                                bloom.global_positions(keys, args)):
            assert torch.equal(ours, theirs)


def test_gaps():
    assert reference.gap("count", 5, 7) == 2
    assert reference.gap("r_sum", 1, M32) == 2
    assert reference.gap("s_sum", M32, 1) == 2
    want = {"count": 10, "s_after": 4}
    widest, failed = reference.compare(
        [{"count": 10, "s_after": 4}, {"count": 11, "s_after": 4},
         {"count": 10, "s_after": 1}], want)
    assert widest == {"count": 1, "s_after": 3} and failed == 2
