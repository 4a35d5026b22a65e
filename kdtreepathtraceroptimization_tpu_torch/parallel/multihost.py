"""Multi-process rendering: one process a card, joined by
``torch.distributed``.

The JAX package's ``parallel/multihost.py`` in PyTorch. Each process calls
:func:`initialize` and renders its own slab of the film
(``parallel/sharding.py``); the forward pass needs no communication, and
:func:`render_distributed` gathers the image once, at the end. The
backend is NCCL for a CUDA device and gloo only for ``device="cpu"``:
nothing swaps one for the other.

Environment (the JAX module's names, or torch's standard ones):

  COORDINATOR_ADDRESS (or JAX_COORDINATOR) host:port of process 0, else
      MASTER_ADDR and MASTER_PORT
  NUM_PROCESSES (or NPROC, or WORLD_SIZE)   the number of processes
  PROCESS_ID (or PROC_ID, or RANK)          this process's rank
  LOCAL_RANK                                its card on the host (else
      the rank modulo the host's cards)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.parallel.sharding import (
    all_gather_rows,
    device_film,
    grouped,
    make_sharded_render_fn,
    rank_world,
)
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device


def _env(*names) -> Optional[str]:
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, timeout_s: float = 120.0) -> bool:
    """Idempotent ``init_process_group``.

    Returns True when a process group was (or already is) initialised,
    False when no coordinator is configured (one process: callers run the
    same code either way). The backend is NCCL for a CUDA ``device`` (by
    default the card ``LOCAL_RANK`` names), gloo for ``device="cpu"``."""
    if grouped():
        return True
    address = coordinator_address or _env("COORDINATOR_ADDRESS", "JAX_COORDINATOR")
    if address is None and _env("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{_env('MASTER_PORT') or '29500'}"
    if address is None:
        return False
    world = num_processes or int(_env("NUM_PROCESSES", "NPROC", "WORLD_SIZE") or 0)
    if world < 1:
        raise ValueError("initialize: the number of processes is not set "
                         "(num_processes, NUM_PROCESSES or WORLD_SIZE)")
    rank = process_id if process_id is not None else int(
        _env("PROCESS_ID", "PROC_ID", "RANK") or 0)
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", int(_env("LOCAL_RANK") or rank)
                              % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: no backend for device {device}")
    dist.init_process_group(
        backend, init_method=address if "://" in address else f"tcp://{address}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def render_distributed(scene, config, spp: int, seed: int = 0, device=None,
                       group=None) -> torch.Tensor:
    """Render ``spp`` iterations over every rank of the group and return
    the averaged image [H, W, 3] on every rank (on ``device``). Each rank
    renders its slab; one ``all_gather`` assembles the image. Call
    :func:`initialize` first on each process; one process without a group
    renders the whole film."""
    res_x = int(scene.camera.resolution[0])
    res_y = int(scene.camera.resolution[1])
    n = res_x * res_y
    rank, world = rank_world(group)
    if n % world:
        raise ValueError(f"pixel count {n} must divide the world size {world}")
    device = resolve_device(device)
    step = make_sharded_render_fn(scene, config, group=group, device=device, seed=seed)
    film = device_film(n, group=group, device=device)
    key = prng_key(seed)
    for it in range(1, spp + 1):
        film = step(film, key, it)
    img = film / spp
    if world > 1:
        img = all_gather_rows(img, world, group)
    return img.reshape(res_y, res_x, 3)
