"""Ray-axis split of the render across ranks, with ``torch.distributed``.

The JAX package's ``parallel/sharding.py`` shards the film over a device
mesh and lets GSPMD partition one program. Here each rank is a process
with one card, and it holds only its own contiguous slab of the film's
pixel rows (``slab``):

- **The forward pass issues no collective.** A rank generates and traces
  only its slab's rays (``make_render_fn(..., pixels=)``). The random
  streams are keyed by pixel and the intersectors are exact per ray, so a
  slab equals the same rows of the full film bit for bit.
- **Scene tables replicate**: every rank loads the whole scene.
- **Training** (``make_sharded_train_step``): each rank takes the loss on
  its own slab as sum / (3N) over the whole film's N pixels, then the loss
  and every parameter's gradient are ``all_reduce``d (SUM, one buffer)
  before Adam and the clamps, so every rank keeps the same materials: the
  JAX package's GSPMD ``psum``.

The JAX package's ``parallel/ctx.py`` pins the intersectors' row-local
intermediates with sharding constraints, so that GSPMD does not gather
them inside its loop bodies. It has no counterpart here: a rank holds
only its own rows, so nothing can leave them. ``binned_shards`` keeps its
meaning inside one rank's calls (row-local sorts on a [S, n / S] view).

Every collective a step issues adds one to ``COLLECTIVES`` (the scaling
tool reports them, as the JAX tool reports its compiled module's).
Without a process group a process is rank 0 of a world of 1; any slab
renders on its own through ``make_render_fn(..., pixels=slab(r, w, n))``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.models.inverse import make_train_step
from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device

# Collectives issued so far, by kind.
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def pad_to_devices(n: int, n_dev: int) -> int:
    return (n + n_dev - 1) // n_dev * n_dev


def slab(rank: int, world: int, n: int) -> Tuple[int, int]:
    """Pixels [lo, hi) of rank ``rank`` of ``world``: contiguous slabs of
    ceil(n / world) pixels, the last ones short (or empty) where world
    does not divide n."""
    per = pad_to_devices(n, world) // world
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def grouped() -> bool:
    """Whether a process group is initialised (collectives can run)."""
    return dist.is_available() and dist.is_initialized()


def rank_world(group=None) -> Tuple[int, int]:
    """(rank, world size) in the process group, else (0, 1)."""
    if grouped():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM ``t`` over the group's ranks in place (counted)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t


def all_gather_rows(t: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` stacked along rows, in rank order
    (counted)."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts)


def _pixels(scene) -> int:
    return int(scene.camera.resolution[0]) * int(scene.camera.resolution[1])


def make_sharded_render_fn(scene, config: RenderConfig, group=None, device=None,
                           seed: int = 0) -> Callable:
    """A ``(film, base_key, iteration) -> film`` step that adds this rank's
    slab of one iteration to its slab of the film ([hi - lo, 3], updated
    in place; ``device_film``). It issues no collective. ``seed`` is
    ``make_render_fn``'s (the ray cache's)."""
    pixels = slab(*rank_world(group), _pixels(scene))
    return make_render_fn(scene, config, seed=seed, device=device, pixels=pixels)


def device_film(n_pixels: int, group=None, device=None) -> torch.Tensor:
    """This rank's zeroed slab of an ``n_pixels`` film on ``device``."""
    lo, hi = slab(*rank_world(group), n_pixels)
    return torch.zeros((hi - lo, 3), dtype=torch.float32, device=resolve_device(device))


def _all_reduce_loss_and_grads(loss: torch.Tensor, materials, group=None) -> torch.Tensor:
    """SUM the loss and every material's gradient over the group in one
    buffer (one collective); the summed gradients replace the rank's and
    the summed loss is returned."""
    params = list(materials)
    flat = torch.cat([loss.detach().reshape(1)] + [
        (torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1) for p in params])
    all_reduce_(flat, group)
    off = 1
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).clone()
        off += p.numel()
    return flat[0]


def make_sharded_train_step(scene, config: RenderConfig, target, learning_rate: float = 5e-3,
                            group=None, device=None):
    """``make_train_step`` over the ray-axis split: ``(init_state,
    step(state, base_key, iteration) -> (state, loss))``.

    ``target`` is the whole film's [N, 3] target (or this rank's slab of
    it). A step renders this rank's slab, takes its loss as sum / (3N)
    (the slab's mean times its share of the film, so one rank's loss and
    gradients are ``make_train_step``'s bit for bit), and with a process
    group ``all_reduce``s the loss and every gradient in one buffer (one
    collective a step) before Adam and the clamps."""
    pixels = slab(*rank_world(group), _pixels(scene))
    reduce = partial(_all_reduce_loss_and_grads, group=group) if grouped() else None
    return make_train_step(scene, config, target, learning_rate, device, pixels=pixels,
                           reduce=reduce)
