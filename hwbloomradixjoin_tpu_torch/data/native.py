"""ctypes binding to the native host generators and the ground-truth join.

The port's own copy of ``hwbloomradixjoin_tpu/data/native.py`` (lines
29-144), cut to what the port needs: the glibc-rand() stream, the
rand()-driven Zipf, non-unique, full-range and selection-sampled generators, and
the two ground truths, ``ref_join`` and the reference's scalar bloom filter
``ref_bloom``.  The library is compiled from the
repository's ``native/hbrj_native.cpp`` with ``g++`` (the flags of
``native/Makefile``) at first use, into the package's git-ignored ``build/``
directory under a name that hashes the source and flags; nothing is written
into ``native/``.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "hbrj_native.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-Wextra",
             "-shared")

_lock = threading.Lock()
_lib = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def build() -> Path:
    """Compile the native library into BUILD_DIR (no-op when up to date)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libhbrj_native_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            dll.hbrj_rand_stream.argtypes = [
                ctypes.c_uint32, ctypes.c_int64, _i32p]
            dll.hbrj_ref_bloom.argtypes = [
                ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint32, _i32p, ctypes.c_int64,
                _i32p, ctypes.c_int64, _u8p, ctypes.c_void_p]
            dll.hbrj_unique_gen_range.argtypes = [
                ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, _i32p]
            dll.hbrj_unique_gen_range.restype = ctypes.c_int64
            dll.hbrj_gen_zipf.argtypes = [
                ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, _i32p]
            dll.hbrj_random_gen.argtypes = [
                ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _i32p]
            dll.hbrj_nonunique_from_pk.argtypes = [
                ctypes.c_uint32, _i32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double, _i32p]
            dll.hbrj_fk_from_pk.argtypes = [
                ctypes.c_uint32, _i32p, _i32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double, _i32p, _i32p]
            dll.hbrj_ref_join.argtypes = [
                _i32p, _i32p, ctypes.c_int64, _i32p, _i32p, ctypes.c_int64,
                _u64p]
            for fn in (dll.hbrj_gen_zipf, dll.hbrj_random_gen,
                       dll.hbrj_nonunique_from_pk,
                       dll.hbrj_fk_from_pk, dll.hbrj_ref_join,
                       dll.hbrj_rand_stream, dll.hbrj_ref_bloom):
                fn.restype = None
            _lib = dll
        return _lib


def gen_zipf(seed: int, stream_size: int, alphabet_size: int,
             zipf_factor: float) -> np.ndarray:
    """stream_size keys Zipf-distributed (factor zipf_factor) over a
    rand()-permuted alphabet 1..alphabet_size (the ETH genzipf)."""
    out = np.empty(stream_size, dtype=np.int32)
    lib().hbrj_gen_zipf(seed & 0xFFFFFFFF, stream_size, alphabet_size,
                        zipf_factor, out)
    return out


def random_gen(seed: int, n: int, minid: int, maxid: int) -> np.ndarray:
    """n keys uniform in [minid, maxid) from glibc rand() seeded `seed`."""
    out = np.empty(n, dtype=np.int32)
    lib().hbrj_random_gen(seed & 0xFFFFFFFF, n, minid, maxid, out)
    return out


def nonunique_from_pk(seed: int, pk_keys: np.ndarray, n: int, threshold: int,
                      selectivity: float) -> np.ndarray:
    """n keys: a (1 - selectivity) share above threshold, the rest drawn from
    pk_keys, then shuffled (the reference's nonunique_from_pk)."""
    out = np.empty(n, dtype=np.int32)
    pk = np.ascontiguousarray(pk_keys, dtype=np.int32)
    lib().hbrj_nonunique_from_pk(seed & 0xFFFFFFFF, pk, len(pk), n, threshold,
                                 selectivity, out)
    return out


def fk_from_pk(seed: int, pk_keys: np.ndarray, pk_pays: np.ndarray, n: int,
               threshold: int, selectivity: float):
    """(keys, payloads): pk tuples tiled below, uniform keys above the
    threshold, keys shuffled (the reference's --full-range FK side)."""
    ok = np.empty(n, dtype=np.int32)
    op = np.empty(n, dtype=np.int32)
    pk = np.ascontiguousarray(pk_keys, dtype=np.int32)
    pp = np.ascontiguousarray(pk_pays, dtype=np.int32)
    lib().hbrj_fk_from_pk(seed & 0xFFFFFFFF, pk, pp, len(pk), n, threshold,
                          selectivity, ok, op)
    return ok, op


def ref_join(r_keys, r_pay, s_keys, s_pay):
    """Ground-truth join: (count, sum of matched R payloads, sum of matched
    S payloads * multiplicity), the sums in uint64 (not reduced)."""
    out = np.zeros(3, dtype=np.uint64)
    rk = np.ascontiguousarray(r_keys, np.int32)
    sk = np.ascontiguousarray(s_keys, np.int32)
    rp = np.ascontiguousarray(r_pay, np.int32)
    sp = np.ascontiguousarray(s_pay, np.int32)
    lib().hbrj_ref_join(rk, rp, len(rk), sk, sp, len(sk), out)
    return int(out[0]), int(out[1]), int(out[2])


def rand_stream(seed: int, n: int) -> np.ndarray:
    """The first n values of glibc rand() seeded `seed`."""
    out = np.empty(n, dtype=np.int32)
    lib().hbrj_rand_stream(seed & 0xFFFFFFFF, n, out)
    return out


def ref_bloom(variant: str, m: int, k: int, B: int, seed: int,
              add_keys, query_keys, want_bitmap: bool = False):
    """Ground-truth bloom filter (the reference's scalar add/contains):
    the contains mask of the queries, and the filter's m/8 bytes with
    want_bitmap."""
    v = {"basic": 0, "blocked": 1}[variant]
    ak = np.ascontiguousarray(add_keys, np.int32)
    qk = np.ascontiguousarray(query_keys, np.int32)
    out = np.empty(len(qk), dtype=np.uint8)
    bitmap = np.zeros(m // 8, dtype=np.uint8) if want_bitmap else None
    ptr = bitmap.ctypes.data_as(ctypes.c_void_p) if want_bitmap else None
    lib().hbrj_ref_bloom(v, m, k, B, seed & 0xFFFFFFFF, ak, len(ak), qk,
                         len(qk), out, ptr)
    return (out.astype(bool), bitmap) if want_bitmap else out.astype(bool)


def unique_gen_range(seed: int, skip: int, n: int, minv: int, maxv: int):
    """n unique keys selection-sampled from [minv, maxv) by rand() seeded
    `seed` after `skip` draws; returns (keys, draws consumed)."""
    out = np.empty(n, dtype=np.int32)
    consumed = lib().hbrj_unique_gen_range(seed & 0xFFFFFFFF, skip, n, minv,
                                           maxv, out)
    return out, int(consumed)
