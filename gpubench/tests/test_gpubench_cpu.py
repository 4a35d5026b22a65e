"""The benchmark on the CPU at a tiny size: the plain reference against the
port, the control and each planted fault against the checks, the import
rule, and the files ``BENCHMARK.json`` names.

    python -m pytest gpubench/tests -q

The test marked ``gpu`` runs a cell on the card and skips without one.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import checks, harness  # noqa: E402

MESH4 = {"mesh": {"generator": "icosphere", "args": {"subdiv": 4, "radius": 2.5,
                                                     "center": [0.0, 3.0, 0.0]}}}
TINY = {
    "ico82k.pairs.render": ({"film": [24, 24], "depth": 4}, MESH4),
    "ico82k.cluster.render": ({"film": [24, 24], "depth": 4}, MESH4),
    "ico320.kd.render": ({"film": [24, 24], "depth": 8}, {}),
    "ico82k.pairs.train": ({"film": [20, 20], "depth": 4}, MESH4),
}


def tiny_run(cell, seed=2**31 + 11):
    traffic, config = TINY[cell]
    return harness.run_cell(cell, seed, 0.05, False, device="cpu", traffic_overrides=traffic,
                            config_overrides=config)


def tiny_cell(cell):
    c = harness.load_cell(cell)
    traffic, config = TINY[cell]
    c.traffic.update(traffic)
    c.config.update(config)
    return c


def kind_module(cell):
    kind = harness.load_cell(cell).traffic["kind"]
    return harness.load_module(harness.BENCH_DIR / "kinds" / f"{kind}.py",
                               f"gpubench_kind_{kind}")


@pytest.mark.parametrize("cell", sorted(TINY))
def test_port_matches_reference(cell):
    r = tiny_run(cell)
    assert r["correct"], r["checks"]
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    assert r["attempted"] >= 1


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails(cell):
    c = tiny_cell(cell)
    got = kind_module(cell).control(c, 2**31 + 11, "cpu", harness.WORK_DIR / c.config["name"])["tf32"]
    assert any(v > c.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("fault", ["half_batch", "double_grad"])
def test_train_reference_faults_fail(fault):
    cell = "ico82k.pairs.train"
    c = tiny_cell(cell)
    got = kind_module(cell).control(c, 5, "cpu", harness.WORK_DIR / c.config["name"], (fault,))[fault]
    assert any(v > c.limits[k] for k, v in got.items()), got


def _render_fault(monkeypatch, fault):
    from kdtreepathtraceroptimization_tpu_torch.render import integrator

    real_make, real_trace = integrator.make_render_fn, integrator.trace_iteration
    if fault == "unchanged":
        monkeypatch.setattr(integrator, "make_render_fn",
                            lambda *a, **k: (lambda film, key, it: film))
    elif fault == "half_batch":
        def half(*a, **k):
            out = real_trace(*a, **k)
            n = out.shape[0] // 2
            return torch.cat([out[:n], torch.zeros_like(out[n:])])
        monkeypatch.setattr(integrator, "trace_iteration", half)
    else:  # answers altered where they are produced: every 16th pixel's radiance
        def altered(*a, **k):
            out = real_trace(*a, **k).clone()
            out[::16] += 0.25
            return out
        monkeypatch.setattr(integrator, "trace_iteration", altered)
    return real_make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["ico82k.pairs.render", "ico320.kd.render"])
def test_render_faults_fail(monkeypatch, cell, fault):
    _render_fault(monkeypatch, fault)
    r = tiny_run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_train_faults_fail(monkeypatch, fault):
    from kdtreepathtraceroptimization_tpu_torch.models import inverse

    real_loss = inverse.render_loss
    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        def half(materials, scene, config, base_key, iteration, target, pixels=None):
            n_film = target.shape[0]
            n = n_film // 2
            return real_loss(materials, scene, config, base_key, iteration, target[:n],
                             (0, n)) * (n_film / n)
        monkeypatch.setattr(inverse, "render_loss", half)
    else:
        monkeypatch.setattr(inverse, "render_loss", lambda *a, **k: real_loss(*a, **k) * 1.01)
    r = tiny_run("ico82k.pairs.train")
    assert not r["correct"], r["checks"]


def test_pixels_off_share():
    ref = torch.tensor([[1.0, 0.5, 0.0], [0.2, 0.2, 0.2], [3.0, 3.0, 3.0], [0.0, 0.0, 0.0]])
    prog = ref.clone()
    assert checks.pixels_off_share(prog, ref) == 0.0
    prog[0, 0] += 1e-6  # rounding: not off
    prog[1, 2] = 0.25
    prog[3, 0] = float("nan")
    assert checks.pixels_off_share(prog, ref) == 0.5


def test_train_gaps_by_worst_field():
    ref = {"losses": [1.0, 0.9], "grad": {"color": np.ones((3, 3)), "emittance": np.ones(3) * 2,
                                          "transmittance": np.zeros((3, 3))},
           "change": {"color": np.ones((3, 3)) * 0.01, "emittance": np.ones(3) * 0.01,
                      "transmittance": np.zeros((3, 3))}}
    same = checks.train_gaps(ref, ref)
    assert same == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    frozen = dict(ref, change={k: np.zeros_like(v) for k, v in ref["change"].items()})
    assert checks.train_gaps(frozen, ref)["change_gap"] == pytest.approx(1.0)
    stray = dict(ref, grad=dict(ref["grad"], transmittance=np.ones((3, 3))))
    assert checks.train_gaps(stray, ref)["grad_gap"] > 0.5
    nan = dict(ref, grad=dict(ref["grad"], color=np.full((3, 3), np.nan)))
    assert math.isinf(checks.train_gaps(nan, ref)["grad_gap"])
    assert checks.counted_fields(ref["grad"]) == ["color", "emittance"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program_or_jax():
    mods = _loaded(
        "import json, sys; sys.path.insert(0, '.')\n"
        "import gpubench.reference.render, gpubench.reference.train, gpubench.reference.scene\n"
        "import gpubench.checks\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & {"jax", "jaxlib", "flax", "kdtreepathtraceroptimization_tpu",
                            "kdtreepathtraceroptimization_tpu_torch"}


def test_harness_loads_no_jax():
    mods = _loaded(
        "import json, sys; sys.path.insert(0, '.')\n"
        "from gpubench import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "for w in b['workloads']:\n"
        "    c = harness.load_cell(w['name'])\n"
        "    harness.load_module(harness.BENCH_DIR / 'kinds' / (c.traffic['kind'] + '.py'), 'd')\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    harness.load_module(harness.BENCH_DIR / 'metrics' / (m['name'] + '.py'), 'm')\n"
        "import kdtreepathtraceroptimization_tpu_torch.render.integrator\n"
        "import kdtreepathtraceroptimization_tpu_torch.models.inverse\n"
        "import kdtreepathtraceroptimization_tpu_torch.scene.parser\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "kdtreepathtraceroptimization_tpu_torch" in mods
    assert not set(mods) & set(harness.FORBIDDEN)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_its_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
        cell = harness.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


@pytest.mark.gpu
def test_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "ico320.kd.render",
                          "--seed", "3", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
