"""Render traffic with the port's stage spans: ``kinds/render.py``'s run,
unchanged, and with ``--trace 1`` a span stretch after its profiled frames.

The span stretch (``spans.profile_spans``) runs as many frames again under
``torch.profiler`` with the port's tracing on (``utils/trace.py``: the
``kdpt.*`` spans and the counters), as ``spans.run_cell_with_spans`` does,
and leaves its ``SpanProfile`` in ``run.spans`` (None where the stretch
read nothing), which the readers of the intersector's device ms and of the
pair list's pass shares read. The window, the profiled frames and the
pixel check are ``render.run``'s, so the cell's other numbers mean what
they mean in a ``render`` cell; the log also names the cluster table the
scene load built (blocks, their size, the real ones).

A second check, ``hard_rays_off_share``, holds the pair list's passes 2
and 3 to the plain reference's brute force, which the pixel check cannot
see (they take a few percent of the mesh rays). During the warm-up frame,
before the window, each pair call's rays that pass 1 leaves unproven (a
seeded sample of ``HARD_SAMPLE`` a call) and every ray that pass 3's walk
takes are kept with the program's nearest t, read from the pair list's
set compactions (``ops/pairs._compact_all``: the mesh-active rays, the
unproven ones, the walk's, in that order). After the run the reference's
``_mesh`` and ``_tri_hit`` find each kept ray's nearest triangle below the
same bound; a ray is off where one hits and the other does not, or the
two t differ by more than ``T_ATOL + T_RTOL |t|``. The log gives the rays
held of each pass and the share the reference in TF32 reads against
itself on them; ``run.hard_rays`` keeps those numbers (None where no
pair call left a ray to passes 2 and 3).
"""

from __future__ import annotations

import torch

from gpubench import harness, meshgen, spans
from gpubench.kinds import render
from gpubench.reference import render as ref_render
from gpubench.reference import scene as ref_scene

control = render.control

HARD_SAMPLE = 4096
# the pair list reports t truncated by its packed key (< 2^-13 relative)
T_RTOL = 2.0 ** -12
T_ATOL = 1e-5


def _keep_hard_rays(pairs, real_call, seed: int, kept: list):
    """``real_call`` (the integrator's pair call) wrapped: each call's
    pass-2 rays (a sample of HARD_SAMPLE, drawn from ``seed``) and pass-3
    rays go into ``kept`` as host tensors (origin, direction, bound, the
    program's t, the pass: 2 or 3)."""
    gen = torch.Generator().manual_seed(seed % 2**63)

    def call(origin, direction, cm, config, t_init=None, active=None):
        todo = []
        compact = pairs._compact_all

        def spy(mask, *args, **kwargs):
            todo.append(mask.reshape(-1).cpu())
            return compact(mask, *args, **kwargs)

        pairs._compact_all = spy
        try:
            hit = real_call(origin, direction, cm, config, t_init=t_init, active=active)
        finally:
            pairs._compact_all = compact
        n = hit.t.shape[0]
        rest = todo[1:]  # after the mesh-active rays: pass 2's (where it runs), pass 3's
        sets = {2: rest.pop(0) if int(config.pair_slots) < pairs.F2 and rest else None,
                3: rest.pop(0) if rest else None}
        for p, mask in sets.items():
            if mask is None:
                continue
            idx = torch.nonzero(mask[:n])[:, 0]
            if p == 2 and idx.numel() > HARD_SAMPLE:
                idx = idx[torch.randperm(idx.numel(), generator=gen)[:HARD_SAMPLE]]
            if idx.numel():
                dev_idx = idx.to(hit.t.device)
                bound = (t_init if t_init is not None
                         else torch.full((n,), ref_render.BIG, device=hit.t.device))
                kept.append(tuple(a.index_select(0, dev_idx).float().cpu() for a in (
                    origin, direction, bound, hit.t)) + (torch.full((idx.numel(),), p),))
        return hit

    return call


def hard_rays_off(cell, kept: list, dev, work_dir) -> dict:
    """The reference's brute force on the kept rays: {pass: rays}, the
    share off, and the share the reference in TF32 reads against it."""
    o, d, bound, t_prog, which = (torch.cat(c) for c in zip(*kept))
    scene_path, obj_path = meshgen.write_inputs(cell.config, work_dir)
    ref = ref_scene.load(scene_path, obj_path, tuple(cell.traffic["film"]))
    prep = ref_render.prepare(ref, dev)
    ov = ref_render.V(*o.to(dev).unbind(1))
    dv = ref_render.V(*d.to(dev).unbind(1))
    t_max = bound.to(dev)

    def nearest(q):
        with torch.no_grad():
            tri = ref_render._mesh(prep, ov, dv, t_max, q)
            return ref_render._tri_hit(prep, ov, dv, tri, q)[0].cpu()

    def off(t, want):
        hit, hit_w = t < ref_render.BIG, want < ref_render.BIG
        far = (t - want).abs() > T_ATOL + T_RTOL * want.abs()
        return float(((hit != hit_w) | (hit & hit_w & far)).float().mean())

    want = nearest(ref_render.exact)
    return dict(rays={p: int((which == p).sum()) for p in (2, 3)},
                share=off(t_prog, want), tf32=off(nearest(ref_render.tf32), want))


def run(cell, seed: int, seconds: float, trace: bool, device: str, start_epoch: float,
        work_dir) -> harness.Run:
    got = {}
    plain = harness.profile_units

    def then_spans(run_unit, units, sync):
        out = plain(run_unit, units, sync)
        sp, err = spans.profile_spans(run_unit, units, sync)
        if sp is None:
            harness.log(f"span stretch not measured: {err}")
        else:
            spans.log_tables(sp, cell.name)
        got["spans"] = sp
        return out

    from kdtreepathtraceroptimization_tpu_torch.ops import pairs
    from kdtreepathtraceroptimization_tpu_torch.render import integrator

    make = integrator.make_render_fn
    pair_call = integrator.intersect_mesh_pairs
    kept = []

    def make_logged(scene, *args, **kwargs):
        cm = scene.cmesh
        if cm is not None:
            harness.log(f"{cell.name}: cluster table of {cm.n_blocks} blocks of {cm.block} "
                        f"triangles, {cm.n_real_blocks} of them real")
        step = make(scene, *args, **kwargs)
        first = [True]

        def step_keeping(*a, **k):
            if not first[0]:
                return step(*a, **k)
            first[0] = False  # the warm-up frame
            integrator.intersect_mesh_pairs = _keep_hard_rays(pairs, pair_call, seed, kept)
            try:
                return step(*a, **k)
            finally:
                integrator.intersect_mesh_pairs = pair_call

        return step_keeping

    harness.profile_units = then_spans
    integrator.make_render_fn = make_logged
    try:
        out = render.run(cell, seed, seconds, trace, device, start_epoch, work_dir)
    finally:
        harness.profile_units = plain
        integrator.make_render_fn = make
        integrator.intersect_mesh_pairs = pair_call
    out.spans = got.get("spans")

    share = 0.0
    out.hard_rays = h = hard_rays_off(cell, kept, torch.device(device), work_dir) if kept else None
    if h is not None:
        share = h["share"]
        harness.log(f"hard rays of the warm-up frame against the reference: pass 2 "
                    f"{h['rays'][2]} (sampled), pass 3 {h['rays'][3]}; off {share:.6g}; the "
                    f"reference in TF32 against it {h['tf32']:.6g}")
    else:
        harness.log("hard rays: the warm-up frame's pair calls left no ray to passes 2 and 3")
    out.checks["hard_rays_off_share"] = {"value": share,
                                         "limit": cell.limits["hard_rays_off_share"]}
    return out
