"""The comparisons that decide ``correct``.

Render: a sampled pixel is off when any channel of what the program's
frame added differs from the reference's radiance by more than
``ATOL + RTOL * |reference|``. A path that both sides follow agrees to
float32 rounding (about 1e-6 of the value); one that takes another
surface differs by the order of the value itself. The number compared is
the share of sampled pixels off.

Training: each of the checked steps' losses, the first gradient of each
material field (as Adam holds it after one step: ``exp_avg / (1 - b1)``)
and each field's change over the checked steps. A gap is between the two
sides' norms, over the larger of the reference's norm of that field and
the median field's; the worst field counts. The change leaves out fields
whose reference gradient is under 1e-3 of the median nonzero field's:
Adam moves those by round-off alone.
"""

from __future__ import annotations

import numpy as np
import torch

ATOL = 1e-4
RTOL = 1e-3
LEAF_FLOOR = 1e-3


def pixels_off_share(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of rows of [n, 3] ``prog`` off ``ref`` (non-finite rows are off)."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    off = ~torch.isfinite(prog).all(1) | ((prog - ref).abs() > ATOL + RTOL * ref.abs()).any(1)
    return float(off.to(torch.float64).mean())


def _norms(d: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in d.items()}


def _gap(prog: dict, ref: dict, names) -> float:
    pn, rn = _norms(prog), _norms(ref)
    nonzero = [rn.get(k, 0.0) for k in names if rn.get(k, 0.0) > 0]
    med = float(np.median(nonzero)) if nonzero else 0.0
    worst = 0.0
    for k in names:
        den = max(rn.get(k, 0.0), med)
        g = abs(pn.get(k, 0.0) - rn.get(k, 0.0))
        if not np.isfinite(g):
            return float("inf")
        worst = max(worst, g / den if den > 0 else (0.0 if g == 0 else float("inf")))
    return worst


def counted_fields(ref_grad: dict) -> list:
    """Fields whose reference gradient is at least LEAF_FLOOR of the median
    nonzero field's."""
    rn = _norms(ref_grad)
    nonzero = [v for v in rn.values() if v > 0]
    if not nonzero:
        return []
    med = float(np.median(nonzero))
    return sorted(k for k, v in rn.items() if v >= LEAF_FLOOR * med)


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grad": {field: array},
    "change": {field: array}} -> {"loss_gap", "grad_gap", "change_gap"}. A
    field one side lacks counts as zero there."""
    lp, lr = np.asarray(prog["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    if lp.shape != lr.shape or not np.isfinite(lp).all():
        loss_gap = float("inf")
    else:
        loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    fields = sorted(set(ref["grad"]) | set(prog["grad"]))
    grad_gap = _gap(prog["grad"], ref["grad"], fields)
    change_gap = _gap(prog["change"], ref["change"], counted_fields(ref["grad"]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
