"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Builds run on first use,
all sources at once (one ``nvcc`` process each), into ``build/aztec_tpu_torch``
at the root of the checkout; a library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build" / "aztec_tpu_torch"
SOURCES = ("field_ops", "group_ops", "rake", "bucket", "microbench")
HEADERS = ("field.cuh", "field_lazy.cuh", "group.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    "field_ops": {
        "fk_mont_mul": [_I, _P, _P, _P, _LL, _P],
        "fk_add_mod": [_I, _P, _P, _P, _LL, _P],
        "fk_sub_mod": [_I, _P, _P, _P, _LL, _P],
        "fk_butterfly": [_I, _P, _P, _P, _P, _P, _LL, _P],
        "fk_mul_add": [_I, _P, _P, _P, _P, _LL, _P],
    },
    "group_ops": {
        "gk_mixed_add": [_I] + [_P] * 8 + [_LL, _P],
        "gk_add_unsafe": [_I] + [_P] * 9 + [_LL, _P],
        "gk_proj_add": [_I] + [_P] * 10 + [_LL, _P],
        "gk_proj_dbl": [_I] + [_P] * 7 + [_LL, _P],
        "gk_proj_dbl_n": [_I] + [_P] * 7 + [_I, _LL, _P],
        "gk_j2c": [_I] + [_P] * 6 + [_LL, _P],
        "gk_c2j": [_I] + [_P] * 6 + [_LL, _P],
    },
    "rake": {
        "rk_rake_packed": [_I, _P, _P, _P, _P, _P, _I, _LL, _P],
        "rk_rake": [_I] + [_P] * 6 + [_I, _LL, _P],
    },
    "bucket": {
        "bk_bucket_phase": [_I] + [_P] * 11 + [_I, _I, _P],
    },
    "microbench": {
        "mb_vpu": [_I, _I, _P, _P, _P, _LL, _I, _P],
        "mb_dissect": [_I, _P, _P, _P, _LL, _P],
    },
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every library in ``names`` that is missing, one nvcc process
    per source, all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    if not library_path(name).exists():
        build()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {rc}")
