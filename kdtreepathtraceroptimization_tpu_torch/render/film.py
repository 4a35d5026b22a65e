"""Film tonemap (reference: pathtrace.cu:69-89 sendImageToPBO)."""

from __future__ import annotations

import numpy as np
import torch


def tonemap_srgb_u8(img) -> np.ndarray:
    """Clamp + 8-bit quantize an [H, W, 3] image (tensor or array) on the
    host (reference: pathtrace.cu:80-87 does clamp(mean*255) with no
    gamma; same here for parity)."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
