"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, sizes, the
stream) and compiles with ``nvcc`` alone into its own shared library under
``build/kernels/`` at the repository root, loaded with ``ctypes``. The
library's file name carries a hash of its source, every ``csrc/*.cuh``
header and the flags, so an edited source or header is rebuilt and a
stale library never loads. Nothing is built when
a module is imported: the first launch builds every source at once, one
``nvcc`` per source, started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("slab_cull", "walk", "gather_cols", "scatter_cols", "pair_extract", "pair_runs",
           "mxu_bf")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Dynamic shared memory one thread block may use on sm_90 (bytes): the
# wrappers refuse a tile or block whose staging needs more.
MAX_SMEM = 232448


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: compiler output}`` for the sources compiled (with
    ``-Xptxas -v`` the output lists each kernel's registers and shared
    memory). Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[name] for name in failed))
    return logs


class CudaKernel:
    """One kernel's C entry point and its launch count.

    ``launches`` rises by one each time ``launch`` starts the kernel, and
    nowhere else, so a run can show that it went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        self.launches = 0
        self._fn = None
        self._lib = None

    def _function(self):
        if self._fn is None:
            path = library_path(self.source)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise if CUDA refuses."""
        fn = self._function()
        with torch.cuda.device(device):  # the launch uses the current context
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(
                f"{self.symbol} kernel launch failed: "
                f"{self._lib.error_string(err).decode()} (CUDA error {err})")
        self.launches += 1

    def call_int(self, symbol: str) -> int:
        """Read an ``int f(void)`` constant the library exports."""
        self._function()
        fn = getattr(self._lib, symbol)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        return int(fn())


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what the kernels' raw pointers assume)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
