"""Under pytest-xdist each worker gives torch its share of the cores.

torch's CPU kernels start one intra-op thread per core in every process,
so N xdist workers run N times as many threads as there are cores, and
the port's small renders (many short parallel regions) then slow down a
hundredfold: the four ``mesh_pairs_48`` golden tests took 471 s in four
workers on an 8-core machine, and 37 s with one torch thread per worker.
Every worker collects every test module before it runs a test, so this
module, imported at collection, sets the share for all of them. A run in
one process keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
SHARE = max(1, (os.cpu_count() or 1) // WORKERS)
if WORKERS > 1:
    torch.set_num_threads(SHARE)


def test_torch_threads_share_the_cores():
    if WORKERS > 1:
        assert torch.get_num_threads() == SHARE
    else:
        assert torch.get_num_threads() >= 1
