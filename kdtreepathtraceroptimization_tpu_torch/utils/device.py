"""Where the port runs: the CUDA device unless the caller names another."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device. Without CUDA that raises: the
    port never falls back to the CPU unless the caller asks for it with
    ``device="cpu"``.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def use_full_f32() -> None:
    """Turn TF32 off for float32 matrix products and convolutions.

    The Moller-Trumbore products decide accept/reject at triangle edges;
    inputs rounded to TF32's 10 mantissa bits flip those decisions for
    rays leaving the mesh, so every product runs in true float32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tensor(a, device: torch.device) -> torch.Tensor:
    """A copy of numpy array ``a`` (or tensor ``a``, moved) on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.tensor(np.asarray(a), device=device)
