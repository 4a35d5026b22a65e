"""The port's tools against the JAX package's.

``write_scene`` writes the JAX writer's text for every scene file;
``render_svg`` the JAX chart of the same sweep JSON; ``goldens.CASES``
holds the JAX cases field for field, and ``main`` refuses the frozen
goldens. The benchmark sweep and the scaling tool run at 16x16 on the CPU
(gloo ranks for the scaling rows): their records have every row and
field, and the scaling tool's forward step issues no collective.
"""

import dataclasses
import glob
import io
import json
import os

import numpy as np
import pytest

from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu.tools import charts as jcharts
from kdtreepathtraceroptimization_tpu.tools import goldens as jgoldens
from kdtreepathtraceroptimization_tpu.tools import scene_writer as jwriter
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.tools import benchmarks, charts, goldens, scaling
from kdtreepathtraceroptimization_tpu_torch.tools import scene_writer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(glob.glob(os.path.join(REPO, "scenes", "*.txt")))


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(p) for p in SCENES])
def test_write_scene_matches_jax(path, tmp_path):
    want, got = io.StringIO(), io.StringIO()
    jwriter.write_scene(jparser.load_scene(path, build_kd=False), want)
    scene_writer.write_scene(tparser.load_scene(path, build_kd=False, device="cpu"), got)
    assert got.getvalue() == want.getvalue()
    out = tmp_path / "out.txt"
    assert scene_writer.main([path, str(out)]) == 0
    assert out.read_text() == want.getvalue()


def test_render_svg_matches_jax():
    rng = np.random.default_rng(0)
    rows = [{"tris": 20 * 4 ** s, "ms": {m: (None if (m, s) == ("bbox", 5) else
                                            float(rng.uniform(1, 900)))
                                        for m in benchmarks.MODES}}
            for s in (1, 2, 3, 4, 5)]
    modes = list(benchmarks.MODES)
    assert charts.render_svg(rows, modes, "t") == jcharts.render_svg(rows, modes, "t")


def test_golden_cases_match_jax():
    assert list(goldens.CASES) == list(jgoldens.CASES)
    for name, (make_scene, config, spp) in goldens.CASES.items():
        jmake_scene, jconfig, jspp = jgoldens.CASES[name]
        assert spp == jspp
        jfields = dataclasses.asdict(jconfig)
        assert {k: jfields[k] for k in dataclasses.asdict(config)} == dataclasses.asdict(config)
        tscene, jscene = make_scene("cpu"), jmake_scene()
        for f in ("resolution", "position", "look_at", "fov", "pixel_length"):
            np.testing.assert_array_equal(np.asarray(getattr(tscene.camera, f)),
                                          np.asarray(getattr(jscene.camera, f)))
        assert (tscene.mesh is None) == (jscene.mesh is None)
        if tscene.mesh is not None:
            np.testing.assert_array_equal(tscene.mesh.v0.numpy(), np.asarray(jscene.mesh.v0))


def test_goldens_main_refuses_the_frozen_goldens(tmp_path):
    with pytest.raises(ValueError, match="frozen"):
        goldens.main(goldens.GOLDEN_DIR, "cpu")
    with pytest.raises(ValueError, match="frozen"):
        goldens.main(os.path.join(REPO, "tests", "..", "tests", "goldens"), "cpu")


def test_benchmarks_sweep_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    assert benchmarks.main(["--res", "16", "--depth", "2", "--subdiv", "1", "--iters", "1",
                            "--repeats", "1", "--json", str(out), "--device", "cpu"]) == 0
    data = json.loads(out.read_text())
    assert data["res"] == 16 and data["device"] == "cpu" and len(data["rows"]) == 1
    row = data["rows"][0]
    assert row["tris"] == 80 and set(row["ms"]) == set(benchmarks.MODES)
    assert row["routes"] == benchmarks.ROUTES
    assert all(v > 0 for v in row["ms"].values())
    assert charts.main([str(out), "-o", str(tmp_path / "sweep.svg")]) == 0
    assert (tmp_path / "sweep.svg").read_text().startswith("<svg")
    assert "wrote" in capsys.readouterr().out


@pytest.mark.parametrize("mode", list(benchmarks.MODES))
def test_benchmark_mode_takes_its_own_intersector(mode):
    """At cluster_min_tris triangles or more (a 1,280-triangle sphere),
    where cluster_auto would send the reference modes to the pair list."""
    scene, n_tris, _ = benchmarks._scene(16, 3, "cpu")
    assert n_tris >= benchmarks.mode_config(mode, 1).cluster_min_tris
    assert benchmarks.mode_route(scene, mode) == benchmarks.ROUTES[mode]


def test_scaling_on_cpu():
    rec = scaling.run(res=16, subdiv=2, depth=2, worlds=(1, 2), shards=(1, 2, 4), device="cpu")
    assert rec["platform"] == "cpu" and "FLOPs" in rec["note"]
    assert [r["devices"] for r in rec["rows"]] == [1, 2]
    for r in rec["rows"]:
        assert r["ms_per_iter"] > 0 and r["rays_per_sec"] > 0
        assert r["collectives"]["forward_step"] == {"all_reduce": 0, "all_gather": 0}
        assert r["collectives"]["train_step"] == {"all_reduce": 1, "all_gather": 0}
    work = rec["measured_work"]
    assert [w["devices"] for w in work] == [1, 2, 4]
    assert work[0]["measured_work_efficiency"] == 1.0
    assert all(w["per_device_pair_rows"] > 0 and w["n1_rounds"] >= 1 for w in work)
