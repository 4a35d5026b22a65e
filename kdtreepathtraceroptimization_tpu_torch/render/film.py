"""Film accumulation, tonemap, and checkpoint/resume.

The JAX package's ``render/film.py`` (reference: the ``dev_image``
accumulation and sendImageToPBO, src/pathtrace.cu:69-89). The film is a
value, (radiance sum, iteration, seed), saved as a ``.npz`` with the
keys ``accum``, ``iteration`` and ``seed``: the JAX package's format, so a
checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device


class Film(NamedTuple):
    accum: torch.Tensor  # [N, 3] radiance sum
    iteration: int
    seed: int

    @staticmethod
    def create(n_pixels: int, seed: int = 0, device=None) -> "Film":
        """An empty film on ``device`` (the CUDA device by default)."""
        return Film(accum=torch.zeros((n_pixels, 3), dtype=torch.float32,
                                      device=resolve_device(device)),
                    iteration=0, seed=seed)

    def image(self, height: int, width: int) -> np.ndarray:
        """The averaged float image [H, W, 3] on the host (reference:
        main.cpp:1092-1098 divides by the samples)."""
        it = max(self.iteration, 1)
        return _host(self.accum).reshape(height, width, 3) / it


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def tonemap_srgb_u8(img) -> np.ndarray:
    """Clamp + 8-bit quantize an [H, W, 3] image (tensor or array) on the
    host (reference: pathtrace.cu:80-87 does clamp(mean*255) with no
    gamma; same here for parity)."""
    return np.clip(_host(img) * 255.0, 0, 255).astype(np.uint8)


def save_checkpoint(path: str, film: Film) -> None:
    """Write the film, its iteration and its seed (``np.savez``: ``.npz``
    is appended to a path without it)."""
    np.savez(path, accum=_host(film.accum), iteration=film.iteration, seed=film.seed)


def load_checkpoint(path: str, device=None) -> Film:
    """A film saved by either package, its sum on ``device`` (the CUDA
    device by default)."""
    data = np.load(path)
    return Film(accum=torch.tensor(data["accum"], device=resolve_device(device)),
                iteration=int(data["iteration"]), seed=int(data["seed"]))
