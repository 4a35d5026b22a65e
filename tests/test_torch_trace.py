"""The port's stage spans and its live-lane counter (``utils/trace.py``).

A tiny Cornell film with an icosphere on the pair list, cluster rounds and
the KD walk: the film, the training step's loss, gradients and parameters
are bit-identical with tracing on and off; off, ``span`` is one shared
null context and nothing is counted; under a CPU ``torch.profiler`` the
spans nest as the integrator places them; ``live_lanes`` counts every
pixel at the first bounce and never grows.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.models.inverse import make_train_step
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn, mesh_route
from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution
from kdtreepathtraceroptimization_tpu_torch.utils import trace
from tests.test_torch_render import CORNELL, _mesh_obj

RES = 12
DEPTH = 3
CONFIGS = {
    "pairs": RenderConfig(trace_depth=DEPTH, antialias=True, cluster=True, cluster_tile=64),
    "cluster": RenderConfig(trace_depth=DEPTH, antialias=True, cluster=True,
                            cluster_pairs=False, cluster_tile=64),
    "kd": RenderConfig(trace_depth=DEPTH, antialias=True),
}
INNER = {"pairs": ["kdpt.pairs.pass1", "kdpt.pairs.pass2", "kdpt.pairs.pass3"],
         "cluster": ["kdpt.cluster.rounds", "kdpt.cluster.sweep"],
         "kd": ["kdpt.kd.round"]}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    obj = _mesh_obj(tmp_path_factory.mktemp("trace"), 2, 2.0)
    return with_resolution(load_scene(CORNELL, obj_path=obj, device="cpu"), RES, RES)


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@contextlib.contextmanager
def traced():
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)


def _frames(scene, config, n=2):
    step = make_render_fn(scene, config, seed=3, device="cpu")
    film = torch.zeros((RES * RES, 3))
    for it in range(1, n + 1):
        step(film, prng_key(3), it)
    return film


def _spans(prof):
    """[(name, start, end, parent index or None)] of the kdpt.* ranges."""
    ev = sorted(((e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("kdpt.")), key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, s, t in ev:
        while stack and out[stack[-1]][2] < t:
            stack.pop()
        out.append((name, s, t, stack[-1] if stack else None))
        stack.append(len(out) - 1)
    return out


def _children(spans, i):
    return [j for j, sp in enumerate(spans) if sp[3] == i]


def test_off_is_one_shared_null_context():
    assert not trace.enabled()
    assert trace.span("kdpt.frame") is trace.span("kdpt.bounce")
    assert isinstance(trace.span("kdpt.frame"), contextlib.nullcontext)
    trace.add("live_lanes", torch.ones(4, dtype=torch.bool))
    assert trace.counters() == {}
    with traced():
        assert not isinstance(trace.span("kdpt.frame"), contextlib.nullcontext)
        trace.add("live_lanes", torch.ones(4, dtype=torch.bool), 1)
        trace.add("live_lanes", torch.ones(3, dtype=torch.bool), 1)
    assert trace.counters() == {"live_lanes": [0, 7]}


@pytest.mark.parametrize("route", sorted(CONFIGS))
def test_film_bit_identical_with_tracing(scene, route):
    config = CONFIGS[route]
    assert mesh_route(scene.mesh, scene.cmesh, config, scene.kd) == route
    off = _frames(scene, config)
    with traced():
        on = _frames(scene, config)
    with traced(), profile(activities=[ProfilerActivity.CPU]):
        profiled = _frames(scene, config)
    assert off.abs().sum() > 0
    assert torch.equal(off, on) and torch.equal(off, profiled)


@pytest.mark.parametrize("route", sorted(CONFIGS))
def test_spans_nest_and_lanes_count(scene, route):
    config = CONFIGS[route]
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(scene, config, n=1)
    spans = _spans(prof)
    frames = [i for i, sp in enumerate(spans) if sp[0] == "kdpt.frame"]
    assert len(frames) == 1 and spans[frames[0]][3] is None
    top = Counter(spans[j][0] for j in _children(spans, frames[0]))
    # the camera, the bounces, the gather of the path colours and the film's +=
    assert top == {"kdpt.camera": 1, "kdpt.bounce": DEPTH, "kdpt.gather": 2}
    for b in (j for j in _children(spans, frames[0]) if spans[j][0] == "kdpt.bounce"):
        kids = Counter(spans[j][0] for j in _children(spans, b))
        assert kids == {"kdpt.geoms": 1, f"kdpt.intersect.{route}": 1, "kdpt.hit_expand": 1,
                        "kdpt.scatter": 1, "kdpt.shade": 1}
        isect, = (j for j in _children(spans, b) if spans[j][0] == f"kdpt.intersect.{route}")
        inner = Counter(spans[j][0] for j in _children(spans, isect))
        assert set(inner) == set(INNER[route])
        if route != "kd":
            assert all(v == 1 for v in inner.values())
    names = {sp[0] for sp in spans}
    assert names <= {"kdpt.frame", "kdpt.camera", "kdpt.bounce", "kdpt.gather", "kdpt.geoms",
                     f"kdpt.intersect.{route}", "kdpt.hit_expand", "kdpt.scatter",
                     "kdpt.shade", *INNER[route]}

    lanes = trace.counters()["live_lanes"]
    assert len(lanes) == DEPTH and lanes[0] == RES * RES
    assert all(a >= b for a, b in zip(lanes, lanes[1:]))
    assert sum(lanes) <= RES * RES * DEPTH


def test_reorder_span_only_when_configured(scene):
    config = dataclasses.replace(CONFIGS["kd"], compaction=True)
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(scene, config, n=1)
    assert Counter(sp[0] for sp in _spans(prof))["kdpt.reorder"] == DEPTH
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(scene, CONFIGS["kd"], n=1)
    assert "kdpt.reorder" not in {sp[0] for sp in _spans(prof)}


def _train(scene, config, steps=2):
    target = torch.rand((RES * RES, 3), generator=torch.Generator().manual_seed(5)) * 0.5
    init_state, train_step = make_train_step(scene, config, target, learning_rate=1e-2,
                                             device="cpu")
    state = init_state()
    losses = []
    for s in range(1, steps + 1):
        state, loss = train_step(state, prng_key(7), s)
        losses.append(loss)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in state.materials]
    params = [p.detach().clone() for p in state.materials]
    return losses, grads, params


@pytest.mark.parametrize("route", ["pairs", "kd"])
def test_train_step_bit_identical_and_spans(scene, route):
    config = CONFIGS[route]
    off = _train(scene, config)
    with traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _train(scene, config)
    for a, b in zip(off, on):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(g.abs().sum() > 0 for g in off[1])

    spans = _spans(prof)
    steps = [i for i, sp in enumerate(spans) if sp[0] == "kdpt.train_step"]
    assert len(steps) == 2
    for i in steps:
        kids = [spans[j][0] for j in _children(spans, i)]
        assert kids == ["kdpt.forward", "kdpt.backward", "kdpt.optimizer"]
        fwd = _children(spans, i)[0]
        inner = Counter(spans[j][0] for j in _children(spans, fwd))
        assert inner == {"kdpt.camera": 1, "kdpt.bounce": DEPTH, "kdpt.gather": 1}
    # two steps of DEPTH bounces, every lane alive at the first bounce
    lanes = trace.counters()["live_lanes"]
    assert len(lanes) == DEPTH and lanes[0] == 2 * RES * RES
