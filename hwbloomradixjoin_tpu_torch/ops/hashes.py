"""The reference's ten seeded hash functions on torch tensors.

Counterpart of ``hwbloomradixjoin_tpu/ops/hashes.py``: bit-exact copies of
src/hash.c / src/spooky.c (crc, FNV, crapwow, Coffin, MurmurOAAT,
JenkinsOAAT, Spooky, KR_v2, DJB2, x17).  Each takes (seed, key[, key_hi])
with int32 (or int64) key tensors and an int seed or seed tensor (broadcast
against the keys), and returns an int64 tensor of uint32 values
(``ops/u32.py``).  Byte-at-a-time functions keep the reference's
signed-char semantics: bytes >= 0x80 enter sign-extended.

The filter needs two of them: ``hash_crapwow`` (the probe sequence base,
src/bloom_filter.c:73-76) and ``hash_crc`` (the blocked filter's block,
src/bloom_filter.c:125-127).  The CUDA kernels carry their own copies
(``csrc/common.cuh``); these are the twins they are checked against.
"""

from __future__ import annotations

import numpy as np
import torch

from hwbloomradixjoin_tpu_torch.ops import u32 as U

CRC32C_POLY_REFLECTED = 0x82F63B78


def _crc32c_table(bits: int) -> np.ndarray:
    """T[i] = `bits` reflected CRC-32C steps of i, for i < 2^bits."""
    t = np.arange(1 << bits, dtype=np.uint32)
    for _ in range(bits):
        t = (t >> 1) ^ (np.uint32(CRC32C_POLY_REFLECTED) * (t & 1))
    return t.astype(np.int64)


CRC32C_TABLE = _crc32c_table(16)      # 2 lookups a key; 512 KiB
_PINNED: list = []                    # CRC32C_TABLE in pinned host memory


def _crc_table(device: torch.device) -> torch.Tensor:
    """CRC32C_TABLE on `device`.  A card takes it from one pinned host
    copy without waiting: a copy from pageable memory waits for the
    device's queue."""
    host = torch.from_numpy(CRC32C_TABLE)
    if device.type != "cuda":
        return host.to(device)
    if not _PINNED:
        _PINNED.append(host.pin_memory())
    return _PINNED[0].to(device, non_blocking=True)


def _key_bytes(key, key_hi=None):
    """Bytes of the key, LSB first: 4 for int32 keys, 8 with KEY_8B."""
    k = U.u32(key)
    out = [(k >> (8 * i)) & 0xFF for i in range(4)]
    if key_hi is not None:
        kh = U.u32(key_hi)
        out += [(kh >> (8 * i)) & 0xFF for i in range(4)]
    return out


def hash_crc(seed, key, key_hi=None):
    """CRC-32C update of `seed` with the key's 4 bytes (_mm_crc32_u32:
    reflected polynomial 0x82F63B78, no final inversion).

    Computed 16 bits at a time through a 65,536-entry table: 16 bitwise
    steps of x equal (x >> 16) ^ T[x & 0xFFFF], because the steps are
    linear over GF(2) and the high bits shift through the first 16
    unchanged (the CUDA kernels take the same shortcut a byte at a time).
    key_hi is ignored: the reference truncates KEY_8B keys to their low
    word here.
    """
    del key_hi
    x = U.u32(key) ^ U.u32(seed)
    table = _crc_table(x.device)
    for _ in range(2):
        x = (x >> 16) ^ table[x & 0xFFFF]
    return x


def hash_FNV(seed, key, key_hi=None):
    h = U.u32(key) * 0 + (U.u32(seed) ^ 2166136261)
    for b in _key_bytes(key, key_hi):
        h = U.mul_lo(h ^ U.sign_extend_byte(b), 16777619)
    return h


def hash_crapwow(seed, key, key_hi=None):
    """CrapWow reduced to one int key (the bloom probe sequence base).

    cwfold casts its first operand to uint32, so under KEY_8B only the
    key's low word is mixed; key_hi only sets the byte count.
    """
    nbytes = 4 if key_hi is None else 8
    n = 0x5052ACDB                 # < 2^31: a uint32 times n fits int64
    p = U.u32(key) * n             # cwmixb: low word into h, high into k
    h = (p & U.MASK32) ^ nbytes
    k = (p >> 32) ^ ((U.u32(seed) + nbytes + n) & U.MASK32)
    p = (h ^ ((k + n) & U.MASK32)) * n
    return (k ^ (p >> 32)) ^ (h ^ (p & U.MASK32))


def hash_Coffin(seed, key, key_hi=None):
    res = U.u32(key) * 0 + 0x55555555
    for b in _key_bytes(key, key_hi):
        res = U.rotl32(res ^ U.sign_extend_byte(b), 5)
    return res


def hash_MurmurOAAT_32(seed, key, key_hi=None):
    h = U.u32(key) * 0 + U.u32(seed)
    for b in _key_bytes(key, key_hi):
        h = U.mul_lo(h ^ U.sign_extend_byte(b), 0x5BD1E995)
        h = h ^ (h >> 15)
    return h


def hash_JenkinsOAAT_32(seed, key, key_hi=None):
    h = U.u32(key) * 0 + U.u32(seed)
    for b in _key_bytes(key, key_hi):
        h = (h + U.sign_extend_byte(b)) & U.MASK32
        h = (h + (h << 10)) & U.MASK32
        h = h ^ (h >> 6)
    h = (h + (h << 3)) & U.MASK32
    h = h ^ (h >> 11)
    return (h + (h << 15)) & U.MASK32


def hash_Spooky(seed, key, key_hi=None):
    """SpookyHash short-message variant on one int key (src/spooky.c).

    uint64 state as (hi, lo) pairs; the int32 key is sign-extended into the
    64-bit message as `sc_const + message` does.
    """
    nbytes = 4 if key_hi is None else 8
    zero = U.u32(key) * 0
    s = zero + U.u32(seed)
    if key_hi is None:
        msg_l = U.u32(key)
        msg_h = torch.where(msg_l >> 31 != 0, U.MASK32, 0) + zero
    else:
        msg_l, msg_h = U.u32(key), U.u32(key_hi)
    h = [[zero, s], [zero, s],
         list(U.u64_add(zero + 0xDEADBEEF, zero + 0xDEADBEEF, msg_h, msg_l)),
         [zero + (nbytes << 24), zero]]
    # ShortEnd (spooky.h): h[a] ^= h[b]; h[b] = rot(h[b], r); h[a] += h[b]
    sched = [(3, 2, 15), (0, 3, 52), (1, 0, 26), (2, 1, 51),
             (3, 2, 28), (0, 3, 9), (1, 0, 47), (2, 1, 54),
             (3, 2, 32), (0, 3, 25), (1, 0, 63)]
    for a, b, r in sched:
        h[a] = list(U.u64_xor(*h[a], *h[b]))
        h[b] = list(U.u64_rotl(*h[b], r))
        h[a] = list(U.u64_add(*h[a], *h[b]))
    return h[0][1]


def hash_KR_v2(seed, key, key_hi=None):
    h = U.u32(key) * 0 + U.u32(seed)
    for b in _key_bytes(key, key_hi):
        h = (U.sign_extend_byte(b) + U.mul_lo(h, 31)) & U.MASK32
    return h


def hash_DJB2(seed, key, key_hi=None):
    del seed        # unused by the reference (src/hash.c DJB2)
    h = U.u32(key) * 0 + 5381
    for b in _key_bytes(key, key_hi):
        h = ((h << 5) + h + U.sign_extend_byte(b)) & U.MASK32
    return h


def hash_x17(seed, key, key_hi=None):
    h = U.u32(key) * 0 + U.u32(seed)
    for b in _key_bytes(key, key_hi):
        h = (U.mul_lo(h, 17) + U.sign_extend_byte(b) - 32) & U.MASK32
    return h ^ (h >> 16)


# the reference's evaluation order (src/unit_tests.c test_hash)
HASH_FUNCTIONS = {
    "crc": hash_crc,
    "FNV": hash_FNV,
    "crapwow": hash_crapwow,
    "Coffin": hash_Coffin,
    "MurmurOAAT": hash_MurmurOAAT_32,
    "JenkinsOAAT": hash_JenkinsOAAT_32,
    "Spooky": hash_Spooky,
    "KR_v2": hash_KR_v2,
    "DJB2": hash_DJB2,
    "x17": hash_x17,
}
