"""Inverse rendering: the differentiable render and its training step.

The JAX package's ``models/inverse.py`` in PyTorch. The "model" is the
material table: a step renders one iteration with the current materials,
takes the image MSE against a target, back-propagates through the
wavefront integrator and takes an Adam step, then applies the physical
clamps (albedo, specular and transmittance in [0, 1], emittance >= 0).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.convert import materials_to_torch, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops.rng import Key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import _check_supported, trace_iteration
from kdtreepathtraceroptimization_tpu_torch.scene.structs import MaterialSoA
from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device, to_tensor, use_full_f32


class TrainState(NamedTuple):
    materials: MaterialSoA  # tensors that require grad: the parameters
    optimizer: torch.optim.Adam  # holds the moments
    step: int


def render_loss(materials: MaterialSoA, scene, config: RenderConfig,
                base_key: Key, iteration: int, target: torch.Tensor) -> torch.Tensor:
    """MSE between a one-iteration render and the target radiance [N, 3].

    ``scene`` is the port's scene with its tables on ``target``'s device;
    the render runs there."""
    radiance = trace_iteration(scene.geoms, materials, scene.mesh, scene.camera,
                               config, base_key, iteration, cmesh=scene.cmesh,
                               device=target.device)
    return torch.mean((radiance - target) ** 2)


def make_train_step(scene, config: RenderConfig, target, learning_rate: float = 5e-3,
                    device=None) -> Tuple[Callable[[], TrainState], Callable]:
    """Build ``(init_state, step(state, base_key, iteration) -> (state,
    loss))`` on ``device`` (the CUDA device by default).

    Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), as the JAX package's ``optax.adam``. The optimizer
    updates the state's material tensors in place."""
    device = resolve_device(device)
    use_full_f32()
    _check_supported(scene, config)
    scene = scene_from_numpy(scene, device)
    target = to_tensor(target, device).to(torch.float32)

    def init_state() -> TrainState:
        materials = materials_to_torch(scene.materials, device, requires_grad=True)
        optimizer = torch.optim.Adam(list(materials), lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        return TrainState(materials=materials, optimizer=optimizer, step=0)

    def train_step(state: TrainState, base_key: Key,
                   iteration: int) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = render_loss(state.materials, scene, config, base_key, iteration, target)
        loss.backward()
        state.optimizer.step()
        m = state.materials
        with torch.no_grad():
            m.color.clamp_(0.0, 1.0)
            m.specular_color.clamp_(0.0, 1.0)
            m.emittance.clamp_min_(0.0)
            m.transmittance.clamp_(0.0, 1.0)
        return state._replace(step=state.step + 1), loss.detach()

    return init_state, train_step
