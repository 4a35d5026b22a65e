"""Stage spans and named counters inside the port, off unless a caller
turns them on.

``span(name)`` marks a stage of the frame or of the training step as a
``torch.profiler.record_function`` range, so that a profiler trace names
the stage the host was in beside each launch. ``add(name, value, slot)``
sums a tensor into a 0-d device tensor without reading it on the host;
``counters()`` reads every sum once, at the end of a traced stretch.
Nothing here writes a tensor the program computes with, so the program's
numbers are the same with tracing on and off.

Tracing is process-wide, as the profiler is. Off (the default), ``span``
returns one shared null context and ``add`` returns at once: one test of a
module-level bool each. ``enable(True)`` turns it on; the callers that do
are the span stretch of ``gpubench/spans.py`` and ``cli.py --profile``.

The spans (fixed names, so that a trace's names form a closed set):
``kdpt.frame`` (one iteration of a film step) and ``kdpt.train_step``
(``kdpt.forward``, ``kdpt.backward``, ``kdpt.optimizer``); inside an
iteration ``kdpt.camera``, ``kdpt.bounce`` and ``kdpt.gather``; inside a
bounce ``kdpt.geoms``, ``kdpt.intersect.<route>``, ``kdpt.hit_expand``,
``kdpt.scatter``, ``kdpt.shade`` and ``kdpt.reorder``; inside the
intersectors ``kdpt.pairs.pass1`` .. ``pass3``, ``kdpt.cluster.rounds``,
``kdpt.cluster.sweep`` and ``kdpt.kd.round``. The counter ``live_lanes``
sums, for each bounce slot, the wavefront lanes that still carry a path;
``geoms_kernel_lanes`` and ``geoms_plain_lanes`` (slot 0) the lanes of
every ``ops.intersect.intersect_geoms`` call that took its CUDA kernel or
its plain version; ``pairs_mesh_active``, ``pairs_unproven`` and
``pairs_walk_rays`` (slot 0) the rays of every
``ops.pairs.intersect_mesh_pairs`` call that have a feasible block (pass
1 takes them), that pass 1 leaves unproven (pass 2 takes them) and that
pass 3's exhaustive walk takes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

_on = False
_NULL = contextlib.nullcontext()
_sums: Dict[str, List[torch.Tensor]] = {}


def enable(on: bool) -> None:
    """Turn tracing on or off for the whole process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A ``record_function(name)`` range while tracing is on, else a shared
    null context."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(name)


def add(name: str, value: torch.Tensor, slot: int = 0) -> None:
    """Add the sum of ``value`` into slot ``slot`` of counter ``name``, on
    ``value``'s device, with no host read; nothing while tracing is off
    (the sum too is taken only while it is on)."""
    if not _on:
        return
    total = value.detach().sum()
    slots = _sums.setdefault(name, [])
    while len(slots) <= slot:
        slots.append(torch.zeros((), dtype=total.dtype, device=total.device))
    slots[slot].add_(total)


def counters() -> Dict[str, List[float]]:
    """Every counter's slots since the last ``reset``, read to the host
    once; empty when nothing was added."""
    return {name: torch.stack(slots).cpu().tolist() for name, slots in _sums.items() if slots}


def reset() -> None:
    """Drop every counter."""
    _sums.clear()
