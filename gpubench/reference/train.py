"""The plain reference of the inverse-rendering step.

The step renders one iteration of the whole film with the current
material table, takes the mean squared error against the target, and
moves the table by Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square
root) followed by the physical clamps (colour in [0, 1], emittance >= 0).
The film is traced in blocks of pixels, each block's share of the loss
back-propagated on its own, so the graph of one block is held at a time.

A diffuse path's radiance is a product of the colours it meets and the
emittance of the light that ends it, and no choice of direction depends
on the table; so the colour and the emittance are the fields the loss
reaches, and the other fields' gradients are zero.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.render import exact, trace

LEARNED = ("color", "emittance")


def steps(sc, table: dict, target: torch.Tensor, base_key, iterations, depth: int,
          antialias: bool, jitter: float, lr: float, quant=exact, block: int = 1 << 18,
          fault: str = ""):
    """Run one step per iteration from ``table`` (field -> numpy array);
    {"losses": [...], "grad": first step's gradient per field,
    "change": each field's change after the last step}.

    ``fault`` plants a fault of a training step, for the calibration of
    the limits: "half_batch" leaves out the second half of the film and
    takes the mean over the rest; "double_grad" doubles the gradient
    Adam is given."""
    dev = target.device
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev).clone()
              for k, v in table.items()}
    start = {k: v.clone() for k, v in params.items()}
    for k in LEARNED:
        params[k].requires_grad_(True)
    m1 = {k: torch.zeros_like(params[k]) for k in LEARNED}
    m2 = {k: torch.zeros_like(params[k]) for k in LEARNED}
    n_film = target.shape[0]
    n = n_film // 2 if fault == "half_batch" else n_film
    losses, first = [], None
    for s, it in enumerate(iterations, 1):
        for k in LEARNED:
            params[k].grad = None
        total = 0.0
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            pix = torch.arange(lo, hi, device=dev)
            rad = trace(sc, params, pix, base_key, it, depth, antialias, jitter, quant)
            part = torch.sum((rad.to(torch.float64) - target[lo:hi].to(torch.float64)) ** 2) / (3 * n)
            part.backward()
            total += float(part.detach())
        losses.append(total)
        grads = {k: params[k].grad.detach().clone() * (2 if fault == "double_grad" else 1)
                 for k in LEARNED}
        if first is None:
            first = {k: (grads[k].cpu().numpy() if k in grads else np.zeros_like(np.asarray(v)))
                     for k, v in table.items()}
        with torch.no_grad():
            for k in LEARNED:
                g = grads[k]
                m1[k].mul_(0.9).add_(0.1 * g)
                m2[k].mul_(0.999).add_(0.001 * g * g)
                mhat = m1[k] / (1 - 0.9 ** s)
                vhat = m2[k] / (1 - 0.999 ** s)
                params[k] -= lr * mhat / (torch.sqrt(vhat) + 1e-8)
            params["color"].clamp_(0.0, 1.0)
            params["emittance"].clamp_min_(0.0)
    change = {k: (params[k].detach() - start[k]).cpu().numpy() for k in table}
    return {"losses": losses, "grad": first, "change": change}
