"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``hwbloomradixjoin_tpu_torch/csrc/*.cu`` are compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all started
together, and linked into ONE shared library with a plain C interface, at
first use, and loaded with ``ctypes``.  Nothing is built or loaded when the
package is imported, so it imports on machines without a GPU.  The library
lands in ``hwbloomradixjoin_tpu_torch/build/`` under a name that hashes the
sources, headers and flags, so an edited source is rebuilt and an unchanged
one is reused.

Every C entry point takes raw device pointers and the CUDA stream as
``c_void_p``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and counts the
launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# One count per kernel wrapper: +1 each time the wrapper launches its kernel
# on the card (the CPU twins never count).  Reset with reset_launches().
# The hash modes of the partition and of pass 2 count as "partition_hash"
# and "pass2_partition_hash", apart from their range modes, so a run shows
# which of the two it launched.
LAUNCHES = {"partition": 0, "compact": 0, "bitmap_build": 0,
            "bitmap_probe": 0, "partition_kv": 0, "table_build": 0,
            "table_probe": 0, "partition_hash": 0, "pass2_partition": 0,
            "pass2_partition_hash": 0, "bloom_probe": 0, "dense_count": 0,
            "materialize": 0, "gathered_probe": 0, "bloom_build": 0}

_vp, _i, _u, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong
_SIGNATURES = {
    "hbrj_partition": [_vp, _vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _i, _i, _i,
                       _i, _i, _i, _i, _u, _i, _vp],
    "hbrj_pass2_partition": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                             _ll, _i, _i, _u, _i, _i, _i, _i, _vp],
    "hbrj_bloom_probe": [_vp, _ll, _vp, _vp, _vp, _vp, _u, _u, _u, _i, _i, _i,
                         _i, _i, _i, _i, _i, _i, _ll, _vp],
    "hbrj_bloom_build": [_vp, _ll, _vp, _ll, _ll, _i, _u, _i, _vp],
    "hbrj_compact": [_vp, _vp, _vp, _ll, _i, _i, _i, _i, _vp],
    "hbrj_bitmap_build": [_vp, _ll, _vp, _vp, _ll, _vp, _i, _i, _i, _ll, _i,
                          _i, _i, _i, _i, _i, _i, _vp],
    "hbrj_bitmap_probe": [_vp, _vp, _ll, _vp, _vp, _i, _i, _i, _ll, _i, _i,
                          _i, _i, _i, _i, _i, _i, _i, _vp],
    "hbrj_table_build": [_vp, _vp, _vp, _i, _i, _i, _vp, _vp, _i, _i, _i, _i,
                         _i, _vp],
    "hbrj_table_probe": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp, _i, _i,
                         _i, _i, _vp],
    "hbrj_materialize": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp, _vp, _vp,
                         _vp, _i, _i, _i, _i, _vp],
    "hbrj_dense_count": [_vp, _vp, _ll, _vp, _i, _i, _vp],
    "hbrj_gathered_probe": [_vp, _vp, _ll, _vp, _vp, _ll, _i, _i, _i, _i, _vp,
                            _vp, _vp],
}

# Host-side queries: name -> (argument types, result type); no stream.
_QUERIES = {"hbrj_partition_scratch": ([_ll, _i, _i, _i, _i, _i], _ll),
            "hbrj_gathered_probe_scratch": ([_i, _i], _ll),
            "hbrj_gathered_probe_class": ([_ll, _i, _vp, _vp], _i),
            "hbrj_bitmap_probe_per_sm": ([_i, _i], _i),
            "hbrj_bitmap_build_per_sm": ([_i, _i, _i], _i),
            "hbrj_bloom_probe_per_sm": ([_i, _ll, _i], _i)}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}      # path, seconds (0.0 when reused), compiler log


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return path


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; wait for all, raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(cmd, proc.returncode, log)
              for cmd, proc, log in zip(cmds, procs, logs) if proc.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(cmd)} -> {rc}\n{log}" for cmd, rc, log in failed))
    return "".join(logs)


def build() -> Path:
    """Compile csrc/*.cu into the build directory (no-op when up to date)."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libhbrj_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, log="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(srcs, objs)])
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0, log=log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in _QUERIES.items():
                fn = getattr(dll, name)
                fn.argtypes, fn.restype = argtypes, restype
            dll.hbrj_error_string.argtypes = [ctypes.c_int]
            dll.hbrj_error_string.restype = ctypes.c_char_p
            _lib = dll
        return _lib


def is_loaded() -> bool:
    return _lib is not None


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 tensor on one CUDA card
    with a 16-byte-aligned start (the kernels load 16 bytes at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel given a tensor on {t.device}")
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"need contiguous int32, got {t.dtype}, "
                             f"contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError("tensor start is not 16-byte aligned")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` on `device`'s current stream; count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        dll = lib()
        rc = getattr(dll, entry)(*args, stream)
    if rc != 0:
        msg = dll.hbrj_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES[name] += 1
