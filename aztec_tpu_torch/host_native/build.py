"""Build and ctypes-load the host C++ libraries (``src/``).

Each library compiles with ``g++ -O3 -std=c++17 -fPIC -shared`` on first
use (or all at once, ``build_all``) into ``build/aztec_tpu_torch/`` at the
root of the checkout, under a file name that carries a hash of its sources
and flags: an edited source is rebuilt, an unchanged one reused.  The
compiler writes a temporary file that is renamed into place, so several
processes may build at once.  Nothing here runs at import time.
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

SRC = Path(__file__).resolve().parent / "src"
BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "aztec_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# library -> (its translation unit, the headers it includes)
LIBRARIES = {
    "composer_core": ("composer_core.cpp", ("fr.hpp",)),
    "aztec_cbind": ("c_bind.cpp", ("field256.hpp", "grumpkin.hpp",
                                   "hashes.hpp")),
}


def library_path(name: str) -> Path:
    src, headers = LIBRARIES[name]
    h = hashlib.sha256()
    for f in (src,) + headers:
        h.update((SRC / f).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names=tuple(LIBRARIES)) -> float:
    """Compile every library in ``names`` that is missing, one g++ process
    each, all started together.  Returns the wall seconds spent.  Raises
    without g++."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host C++ core builds only "
                           "where a C++ compiler is installed")
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [gxx, *FLAGS, "-o", str(tmp), str(SRC / LIBRARIES[name][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"g++ {LIBRARIES[name][0]} failed "
                          f"({p.returncode}):\n" + log.decode(errors="replace"))
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build(name: str) -> Path:
    """The library's path, compiled first if it is missing."""
    build_all((name,))
    return library_path(name)


@functools.lru_cache(maxsize=None)
def load_composer_core() -> ctypes.CDLL:
    """The composer core (``src/composer_core.cpp``): variables, copy
    classes, gates, sigma mappings and the witness behind a C ABI."""
    lib = ctypes.CDLL(str(build("composer_core")))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp, u32, u64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
    sigs = {
        "cc_new": (vp, [u32]),
        "cc_free": (None, [vp]),
        "cc_add_variable": (u32, [vp, u64p]),
        "cc_get_variable": (None, [vp, u32, u64p]),
        "cc_set_public": (None, [vp, u32]),
        "cc_assert_equal": (ctypes.c_int, [vp, u32, u32]),
        "cc_failed": (ctypes.c_int, [vp]),
        "cc_gate": (None, [vp, u32, u32p, u64p]),
        "cc_num_gates": (u64, [vp]),
        "cc_num_public": (u64, [vp]),
        "cc_num_vars": (u64, [vp]),
        "cc_export_selector": (None, [vp, u32, u64, u64p]),
        "cc_export_witness": (None, [vp, u32, u64, u64p]),
        "cc_sigma_mappings": (None, [vp, u32, u64, i32p, u8p]),
    }
    for fn, (restype, argtypes) in sigs.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib
