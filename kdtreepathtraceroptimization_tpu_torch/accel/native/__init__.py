"""ctypes binding for the native KD builder (``kdbuild.cpp``).

The shared library is compiled with ``g++`` at its first use into
``build/native/`` at the repository root (never into the package), under
a file name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library never loads. ``load_native``
returns None when no compiler is available; ``accel.kdtree`` then takes
the numpy builder unless the caller asked for the native one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().with_name("kdbuild.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
# No fused multiply-adds: the builder's float arithmetic must round as
# numpy's does.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libkdbuild-{h.hexdigest()[:12]}.so"


def _compile(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library, compiling it first if needed; None if it cannot
    be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.kd_build.restype = ctypes.c_void_p
        lib.kd_build.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float]
        lib.kd_node_count.restype = ctypes.c_int64
        lib.kd_node_count.argtypes = [ctypes.c_void_p]
        lib.kd_tri_count.restype = ctypes.c_int64
        lib.kd_tri_count.argtypes = [ctypes.c_void_p]
        lib.kd_max_depth.restype = ctypes.c_int32
        lib.kd_max_depth.argtypes = [ctypes.c_void_p]
        lib.kd_export.restype = None
        lib.kd_export.argtypes = [ctypes.c_void_p, i32p, f32p, f32p, f32p, i32p, i32p, i32p,
                                  i32p, i32p, i32p, i64p, f32p, f32p]
        lib.kd_free.restype = None
        lib.kd_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
