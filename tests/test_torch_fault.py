"""The port's failure table (utils/fault.py): each signature of this
stack maps to its kind, and the child-process runner reports success, a
crash and a timeout."""

import pytest

from kdtreepathtraceroptimization_tpu_torch.utils.fault import classify_failure, run_isolated


@pytest.mark.parametrize("stderr, kind", [
    ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 1024.00 GiB", "oom"),
    ("RuntimeError: CUDA out of memory.", "oom"),
    ("RuntimeError: CUDA error: an illegal memory access was encountered", "kernel-fault"),
    ("RuntimeError: CUDA error: device-side assert triggered", "kernel-fault"),
    ("RuntimeError: nvcc failed for walk:\nwalk.cu(12): error", "kernel-compile"),
    ("RuntimeError: nvcc not found: the CUDA kernels cannot be built", "kernel-compile"),
    ("torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL.cpp:1", "collective-stall"),
    ("[Rank 0] Watchdog caught collective operation timeout: WorkNCCL", "collective-stall"),
    ("torch.distributed.DistNetworkError: rendezvous failed", "collective-stall"),
    ("RuntimeError: no CUDA device is available; pass device='cpu'", "no-device"),
    ("something else", "unknown"),
])
def test_classify_signatures(stderr, kind):
    got = classify_failure(1, stderr)
    assert got["kind"] == kind and got["advice"]
    if kind != "unknown":
        assert got["detail"] and all(line in stderr for line in got["detail"])


def test_classify_timeout_is_hang():
    assert classify_failure(-1, "", timed_out=True)["kind"] == "hang"


def test_run_isolated_success_and_crash():
    ok = run_isolated(["-c", "print('fine')"], timeout=60)
    assert ok["ok"] and ok["failure"] is None and "fine" in ok["stdout"]
    bad = run_isolated(["-c", "import sys; print('RuntimeError: CUDA error: an illegal memory "
                              "access was encountered', file=sys.stderr); sys.exit(3)"],
                       timeout=60)
    assert not bad["ok"] and bad["returncode"] == 3
    assert bad["failure"]["kind"] == "kernel-fault"


def test_run_isolated_timeout():
    out = run_isolated(["-c", "import sys, time; print('waiting', flush=True); "
                              "time.sleep(30)"], timeout=2)
    assert not out["ok"] and out["returncode"] is None
    assert out["failure"]["kind"] == "hang"
