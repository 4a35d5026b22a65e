"""Failure diagnosis for render jobs on a CUDA card.

The JAX package's ``utils/fault.py`` for this stack. The reference's own
failure story is cudaDeviceSynchronize + checkCUDAError aborts
(pathtrace.cu). A long render job on a card fails in a few known ways
(device memory exhausted, a kernel fault that poisons the CUDA context, a
kernel that does not build, a collective that waits for a rank that
never comes, no card at all, or a hang), and a caller that runs jobs may
want each failure named and explained rather than only its exit status:

- :func:`classify_failure` maps a (returncode, stderr) pair to a known
  failure kind with advice;
- :func:`run_isolated` runs a command in a child process with a timeout
  and returns its outcome with that classification.

This is a library for callers who ask for it. The port's own entry points
and ``chip_smoke.py`` never use it to carry on after a failure: a failure
there ends the run.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Optional

# Signature table: (substring of stderr, kind, advice). First match wins.
# The texts are what PyTorch, the CUDA runtime, NCCL, the port's kernel
# build (utils/cuda_build.py) and its device check (utils/device.py) print.
_SIGNATURES = (
    ("torch.OutOfMemoryError", "oom",
     "Device memory exhausted. Lower the resolution, render fewer pixels "
     "a process (a slab, parallel/sharding.py) or free cached tensors."),
    ("CUDA out of memory", "oom",
     "Device memory exhausted. Lower the resolution, render fewer pixels "
     "a process (a slab, parallel/sharding.py) or free cached tensors."),
    ("an illegal memory access", "kernel-fault",
     "A kernel read or wrote outside its buffers. The CUDA context is "
     "lost: rerun in a fresh process, and check the kernel's wrapper "
     "(check_tensor) for the shapes it was handed."),
    ("device-side assert", "kernel-fault",
     "A device-side assert fired (an index out of range, as a rule). The "
     "CUDA context is lost: rerun in a fresh process with "
     "CUDA_LAUNCH_BLOCKING=1 to find the operation."),
    ("nvcc failed for", "kernel-compile",
     "A CUDA kernel did not build. This is a code or toolkit fault, not "
     "the environment's: the nvcc log follows the message."),
    ("nvcc not found", "kernel-compile",
     "No CUDA toolkit: the kernels are built with nvcc at first use."),
    ("NCCL", "collective-stall",
     "A NCCL collective failed or waited on a missing rank. Check that "
     "every rank entered the same step and that the process group's "
     "address and world size agree."),
    ("Watchdog caught collective operation timeout", "collective-stall",
     "A collective timed out. Check that every rank entered the same "
     "step."),
    ("rendezvous", "collective-stall",
     "The process group's rendezvous did not complete: a rank is "
     "missing or the address is wrong."),
    ("no CUDA device is available", "no-device",
     "No CUDA device. Run on a machine with a card, or pass "
     "device='cpu' (--device cpu) to run the kernels' plain versions."),
)


def classify_failure(returncode: int, stderr: str, timed_out: bool = False) -> dict:
    """Map a failed run to {kind, advice, detail}."""
    if timed_out:
        return {
            "kind": "hang",
            "advice": "No exit before the timeout: a kernel that does not "
                      "end, a collective waiting on a missing rank, or a "
                      "job too large for the time given.",
            "detail": (stderr or "").strip().splitlines()[-3:],
        }
    text = stderr or ""
    for needle, kind, advice in _SIGNATURES:
        if needle in text:
            return {"kind": kind, "advice": advice,
                    "detail": [line for line in text.splitlines() if needle in line][:3]}
    return {"kind": "unknown", "advice": "Unrecognized failure; see detail.",
            "detail": text.strip().splitlines()[-5:]}


def run_isolated(argv, timeout: Optional[float] = None, python: bool = True) -> dict:
    """Run ``argv`` in a child process; never raises on its failure.

    Returns {ok, returncode, stdout, stderr, failure}, where ``failure`` is
    the :func:`classify_failure` result (None when ok). ``python``
    prefixes the current interpreter. A child past ``timeout`` seconds is
    killed."""
    cmd = ([sys.executable] + list(argv)) if python else list(argv)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        def text(b):
            return b.decode(errors="replace") if isinstance(b, bytes) else (b or "")

        return {
            "ok": False, "returncode": None,
            "stdout": text(e.stdout), "stderr": text(e.stderr),
            "failure": classify_failure(-1, text(e.stderr), timed_out=True),
        }
    ok = proc.returncode == 0
    return {
        "ok": ok, "returncode": proc.returncode,
        "stdout": proc.stdout, "stderr": proc.stderr,
        "failure": None if ok else classify_failure(proc.returncode, proc.stderr),
    }
