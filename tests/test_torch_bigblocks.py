"""The pair route on the cluster tables of meshes past the block-id cap's
halves: blocks of 512 triangles (past 1,048,576 triangles, as
``cornell-ico1310k``'s 1,310,720) and of 1,024 (past 2,097,152).

The cap is lowered, as ``tests/test_torch_scene.py``'s fallback test
lowers it, so that a 1,280-triangle icosphere takes each table. One frame
of ``make_render_fn`` through the pair route against the benchmark's plain
reference (``gpubench/reference/render.py``) at seeded pixels, within the
render cells' limit, and every mesh call of the frame against the brute
force over the same table's triangles (ids exactly, t within 2e-4, the
pair tests' brute-force bound). The pair list's counters
(``pairs_mesh_active``, ``pairs_unproven``, ``pairs_walk_rays``) against
``collect_stats``; and the benchmark's ``render_spans`` kind, whose span
stretch the readers of the intersector's device ms and the pass shares
read.
"""

import time

import numpy as np
import pytest
import torch

from gpubench import checks, harness, meshgen, spans
from gpubench.kinds import render as render_kind
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops import mesh as tmesh
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.render import integrator
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils import trace

CELL = "ico1310k.pairs.render"
SEED = 2**31 + 47
FILM = (24, 24)
DEPTH = 4
# icosphere(3): 1,280 triangles. With the cap at 8 the build takes blocks
# of 512 (past 4 x 256 triangles), at 4 blocks of 1,024 (past 2 x 512).
SMALL = {"mesh": {"generator": "icosphere", "args": {"subdiv": 3, "radius": 2.5,
                                                     "center": [0.0, 3.0, 0.0]}}}
TABLES = [(8, 512), (4, 1024)]


def _cell(tmp_path):
    cell = harness.load_cell(CELL)
    cell.traffic.update({"film": list(FILM), "depth": DEPTH})
    cell.config.update(SMALL)
    return cell, tmp_path / "inputs"


def _scene(cell, work_dir, monkeypatch, cap):
    monkeypatch.setattr(tparser, "MAX_CLUSTER_BLOCKS", cap)
    scene_path, obj_path = meshgen.write_inputs(cell.config, work_dir)
    scene = tparser.load_scene(str(scene_path), obj_path=str(obj_path), device="cpu")
    return tparser.with_resolution(scene, *FILM)


def _frame(scene, config, iteration=1):
    film = torch.zeros((FILM[0] * FILM[1], 3), dtype=torch.float32)
    integrator.make_render_fn(scene, config, seed=SEED, device="cpu")(
        film, prng_key(SEED), iteration)
    return film


def _watch_pairs(monkeypatch, cmesh):
    """Wrap the integrator's pair call: each call's stats, and its hits
    held against the brute force over the table's own triangles (padding
    slots are degenerate and never hit)."""
    real = tpairs.intersect_mesh_pairs
    seen = []

    def watched(origin, direction, cm, config, t_init=None, active=None):
        hit, stats = real(origin, direction, cm, config, t_init=t_init, active=active,
                          collect_stats=True)
        brute = tmesh.intersect_mesh_brute(origin, direction, cmesh.tris, use_bbox=False,
                                           t_max=t_init)
        want = torch.where(active, brute.tri, -1) if active is not None else brute.tri
        assert torch.equal(hit.tri, want)
        hits = hit.tri >= 0
        torch.testing.assert_close(hit.t[hits], brute.t[hits], rtol=2e-4, atol=2e-4)
        seen.append((stats, int(hits.sum())))
        return hit

    monkeypatch.setattr(integrator, "intersect_mesh_pairs", watched)
    return seen


@pytest.mark.parametrize("cap, block", TABLES)
def test_pair_frame_on_big_blocks_matches_reference_and_brute(tmp_path, monkeypatch, cap,
                                                              block):
    cell, work_dir = _cell(tmp_path)
    scene = _scene(cell, work_dir, monkeypatch, cap)
    config = RenderConfig(trace_depth=DEPTH, antialias=True)
    assert scene.cmesh.block == block
    assert integrator.mesh_route(scene.mesh, scene.cmesh, config, scene.kd) == "pairs"
    seen = _watch_pairs(monkeypatch, scene.cmesh)
    film = _frame(scene, config)
    assert len(seen) == DEPTH and sum(h for _, h in seen) > 50

    idx, _ = render_kind.check_plan(cell.traffic, SEED, torch.device("cpu"))
    want = render_kind.reference_radiance(cell, SEED, torch.device("cpu"), work_dir, 1, idx)
    off = checks.pixels_off_share(film.index_select(0, idx), want)
    assert off <= cell.limits["pixels_off_share"], off
    assert float(want.mean()) > 0.05


@pytest.mark.parametrize("cap, block", TABLES)
@pytest.mark.parametrize("slots", [3, 1])
def test_pair_counters_match_collect_stats(tmp_path, monkeypatch, cap, block, slots):
    """The counters of one traced frame equal the sums of its calls'
    ``collect_stats``; the film is the same with tracing on and off. One
    slot leaves rays to passes 2 and 3."""
    cell, work_dir = _cell(tmp_path)
    scene = _scene(cell, work_dir, monkeypatch, cap)
    config = RenderConfig(trace_depth=DEPTH, antialias=True, pair_slots=slots)
    assert scene.cmesh.block == block
    plain = _frame(scene, config)
    seen = _watch_pairs(monkeypatch, scene.cmesh)
    trace.reset()
    trace.enable(True)
    try:
        traced = _frame(scene, config)
        got = trace.counters()
    finally:
        trace.enable(False)
        trace.reset()
    assert torch.equal(plain, traced)
    want = {name: sum(s[key] for s, _ in seen) for name, key in (
        ("pairs_mesh_active", "mesh_active"), ("pairs_unproven", "unproven_after_pass1"),
        ("pairs_walk_rays", "pass3_rays"))}
    assert {name: got[name] for name in want} == {name: [v] for name, v in want.items()}
    assert want["pairs_mesh_active"] > 0
    if slots == 1:
        assert want["pairs_unproven"] > 0


READERS = ("intersect_device_ms_per_iter.render", "pair_pass2_share.render",
           "pair_pass3_share.render")


def _reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "gpubench_metric_" + name.replace(".", "_"))


def _cpu_rows_as_kernels(monkeypatch):
    """The CPU trace has no device rows: let its operator rows stand for
    kernels in the span stretch."""
    real = spans.records_from_profiler

    def with_ops(prof):
        host, ops, stretch, links = real(prof)
        ops += [spans.DeviceOp("kernel", e.start_ns(), e.end_ns(), e.start_ns(), e.name())
                for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
        return host, ops, stretch, links

    monkeypatch.setattr(spans, "records_from_profiler", with_ops)


def test_render_spans_kind_sets_spans_and_its_readers_read_them(tmp_path, monkeypatch):
    """The ``render_spans`` kind on a shrunk cell: ``run.spans`` is the
    span stretch's, and the three readers return numbers from it. Without
    a span stretch (a ``render`` cell, or the program before the counters)
    the readers return None."""
    cell, work_dir = _cell(tmp_path)
    _cpu_rows_as_kernels(monkeypatch)
    kind = harness.load_module(harness.BENCH_DIR / "kinds" / "render_spans.py",
                               "gpubench_kind_render_spans")
    plain_units = harness.profile_units
    run = kind.run(cell, seed=SEED, seconds=0, trace=True, device="cpu",
                   start_epoch=time.time(), work_dir=work_dir)
    assert harness.profile_units is plain_units and not trace.enabled()
    assert run.kind == "render" and run.checks["pixels_off_share"]["value"] <= 0.01
    assert isinstance(run.spans, spans.SpanProfile) and run.spans.units == 2
    values = {name: _reader(name).read(run) for name in READERS}
    assert all(isinstance(v, float) and np.isfinite(v) for v in values.values()), values
    assert values["intersect_device_ms_per_iter.render"] > 0
    assert 0 <= values["pair_pass3_share.render"] <= values["pair_pass2_share.render"] <= 1
    assert run.spans.counters["pairs_mesh_active"][0] > 0

    run.spans = None
    assert all(_reader(name).read(run) is None for name in READERS)
    assert all(_reader(name).read(harness.Run(kind="render")) is None for name in READERS)


def test_render_spans_cell_prints_its_readers(monkeypatch):
    """The cell through ``harness.run_cell``, shrunk by its overrides on
    the CPU: the traced result line holds the three readers beside the
    scene load's, and the untraced one none of them (the kind's own
    profile finds no device rows on the CPU, so its readers read
    nothing)."""
    _cpu_rows_as_kernels(monkeypatch)
    shrunk = ({"film": list(FILM), "depth": DEPTH}, SMALL)
    traced = harness.run_cell(CELL, SEED, 0, True, "cpu", *shrunk)
    assert traced["correct"], traced["checks"]
    got = {name: m["value"] for name, m in traced["metrics"].items()}
    assert all(np.isfinite(got[name]) for name in READERS), got
    assert got["scene_load_s"] > 0 and got["pair_pass2_share.render"] <= 1
    plain = harness.run_cell(CELL, SEED, 0, False, "cpu", *shrunk)
    assert plain["correct"] and not set(READERS) & set(plain["metrics"])


def _spans_kind():
    return harness.load_module(harness.BENCH_DIR / "kinds" / "render_spans.py",
                               "gpubench_kind_render_spans")


def _hard_run(tmp_path, monkeypatch, cap):
    cell, work_dir = _cell(tmp_path)
    cell.traffic["render_config"] = {"pair_slots": 1}  # leaves rays to pass 2
    monkeypatch.setattr(tparser, "MAX_CLUSTER_BLOCKS", cap)
    run = _spans_kind().run(cell, seed=SEED, seconds=0, trace=False, device="cpu",
                            start_epoch=time.time(), work_dir=work_dir)
    return run, cell.limits["hard_rays_off_share"]


@pytest.mark.parametrize("cap, block", TABLES)
def test_hard_ray_check_holds_pass_two_to_the_reference(tmp_path, monkeypatch, cap, block):
    """The ``render_spans`` kind's second check on the tables of blocks of
    512 and 1,024: the warm-up frame's rays that pass 1 left unproven are
    kept and the reference's brute force finds the program's t on every
    one; the reference in TF32 reads above the limit on them."""
    run, limit = _hard_run(tmp_path, monkeypatch, cap)
    assert run.hard_rays["rays"][2] > 20
    assert run.checks["hard_rays_off_share"]["value"] == 0.0
    assert run.hard_rays["tf32"] > limit


def test_hard_ray_check_sees_a_blind_pass_two(tmp_path, monkeypatch):
    """A pass 2 that finds nothing (its pair tests all miss) leaves pass 1's
    answer on the rays it should correct: the check reads above its limit."""
    real = tpairs._pair_pass

    def blind(ids, *args, **kwargs):
        t, tri = real(ids, *args, **kwargs)
        if ids.shape[1] == tpairs.F2 - 1:  # pass 2's window at one slot
            return torch.full_like(t, tpairs.BIG), torch.full_like(tri, -1)
        return t, tri

    monkeypatch.setattr(tpairs, "_pair_pass", blind)
    run, limit = _hard_run(tmp_path, monkeypatch, 8)
    assert run.checks["hard_rays_off_share"]["value"] > limit
