"""The ray-axis split (parallel/) and binned_shards against S = 1, the full
film and the JAX package.

- Slabs: the slabs of world 1, 2 and 4 (a 1,280-triangle sphere, the pair
  list, 24x24, depth 3), each rendered on its own, concatenate to
  ``make_render_fn``'s film bit for bit (streams keyed by pixel, exact
  per-ray intersectors).
- The JAX package's ``make_sharded_render_fn`` on the conftest's 8
  virtual devices against the port's 8 slabs, within the JAX test's rtol
  1e-5, atol 1e-6.
- ``binned_shards`` S in {2, 4}: the pair, walk and binned intersectors
  equal S = 1 bit for bit on the CPU, and the JAX package at the same S
  (ids exactly, t within 1e-6 relative, the intersector tests' bound).
- Two gloo processes (subprocesses, as tests/test_sharding.py runs its
  two JAX processes): ``render_distributed`` and the sharded training
  step against one process within rtol 1e-5 (a rank's slab goes through
  other BLAS blockings than the whole film on the CPU).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import binned as jbinned
from kdtreepathtraceroptimization_tpu.ops import pairs as jpairs
from kdtreepathtraceroptimization_tpu.ops import walk as jwalk
from kdtreepathtraceroptimization_tpu.parallel.sharding import (
    device_film as jdevice_film,
    make_mesh,
    make_sharded_render_fn as jmake_sharded_render_fn,
)
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.models.inverse import make_train_step
from kdtreepathtraceroptimization_tpu_torch.ops import binned as tbinned
from kdtreepathtraceroptimization_tpu_torch.ops import pairs as tpairs
from kdtreepathtraceroptimization_tpu_torch.ops import walk as twalk
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.parallel import multihost
from kdtreepathtraceroptimization_tpu_torch.parallel import sharding as tsh
from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn, render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from tests.test_cluster import _rays
from tests.test_torch_pairs import _grazing_rays, _t, _tables
from tests.test_torch_render import CORNELL, _mesh_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = dict(cluster=True, cluster_pairs=True)
WALK = dict(cluster=True, cluster_walk=True, cluster_pairs=False)
BINNED = dict(cluster=True, cluster_pairs=False, cluster_binned=True, binned_rounds=4)


def _film(step, n):
    return step(torch.zeros((n, 3)), prng_key(0), 1)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_slabs_concatenate_to_the_full_film(tmp_path, world):
    scene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=_mesh_obj(tmp_path, 3, 2.0), device="cpu"), 24, 24)
    cfg = TCfg(trace_depth=3, antialias=True, cluster_tile=64)
    full = _film(make_render_fn(scene, cfg, device="cpu"), 576)
    parts = []
    for r in range(world):
        lo, hi = tsh.slab(r, world, 576)
        parts.append(make_render_fn(scene, cfg, device="cpu", pixels=(lo, hi))(
            torch.zeros((hi - lo, 3)), prng_key(0), 1))
    assert full.max() > 0 and torch.equal(torch.cat(parts), full)
    assert tsh.COLLECTIVES == {"all_reduce": 0, "all_gather": 0}


def test_slab_helpers(monkeypatch):
    assert tsh.pad_to_devices(10, 4) == 12
    assert [tsh.slab(r, 4, 10) for r in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert tsh.rank_world() == (0, 1)  # no process group: rank 0 of 1
    small = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 3, 3)
    film = tsh.make_sharded_render_fn(small, TCfg(trace_depth=1), device="cpu")(
        tsh.device_film(9, device="cpu"), prng_key(0), 1)
    assert torch.equal(film, _film(make_render_fn(small, TCfg(trace_depth=1), device="cpu"), 9))
    for name in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert not multihost.initialize()  # no coordinator configured
    # 9 pixels over a world of 2: refused before any rendering, as JAX does
    monkeypatch.setattr(multihost, "rank_world", lambda group=None: (0, 2))
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 3, 3)
    with pytest.raises(ValueError, match="world size"):
        multihost.render_distributed(scene, TCfg(trace_depth=1), 1, device="cpu")


def test_sharded_film_matches_jax_on_eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL), 32, 32)
    mesh = make_mesh(devs[:8])
    jfilm = jmake_sharded_render_fn(jscene, JCfg(trace_depth=3), mesh)(
        jdevice_film(1024, mesh), jax.random.PRNGKey(0), jnp.int32(1))
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 32, 32)
    parts = [make_render_fn(scene, TCfg(trace_depth=3), device="cpu",
                            pixels=tsh.slab(r, 8, 1024))(torch.zeros((128, 3)), prng_key(0), 1)
             for r in range(8)]
    np.testing.assert_allclose(torch.cat(parts).numpy(), np.asarray(jfilm), rtol=1e-5,
                               atol=1e-6)


def _ray_set():
    o, d = _rays(2048, seed=3)
    go, gd = _grazing_rays(2048, 4)
    o, d = np.concatenate([o, go]), np.concatenate([d, gd])
    act = np.arange(o.shape[0]) % 7 != 0
    t0 = np.linspace(0.5, 30.0, o.shape[0]).astype(np.float32)
    return o, d, act, t0


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("route", ["pairs", "walk", "binned"])
def test_binned_shards_match_s1_and_jax(route, shards):
    _, jcm, tcm = _tables(3)
    o, d, act, t0 = _ray_set()
    kw = {"pairs": dict(pair_slots=2, **PAIRS), "walk": WALK, "binned": BINNED}[route]
    fn = {"pairs": tpairs.intersect_mesh_pairs, "walk": twalk.intersect_mesh_walk,
          "binned": tbinned.intersect_mesh_binned}[route]
    jfn = {"pairs": jpairs.intersect_mesh_pairs, "walk": jwalk.intersect_mesh_walk,
           "binned": jbinned.intersect_mesh_binned}[route]
    args = (_t(o), _t(d), tcm)
    base = fn(*args, TCfg(cluster_tile=256, **kw), t_init=_t(t0), active=_t(act))
    hit = fn(*args, TCfg(cluster_tile=256, binned_shards=shards, **kw), t_init=_t(t0),
             active=_t(act))
    assert (hit.tri >= 0).sum() > 500
    assert torch.equal(hit.tri, base.tri) and torch.equal(hit.t, base.t)
    jcfg = JCfg(cluster_tile=256, binned_shards=shards, **kw)
    hj = jax.jit(lambda o_, d_, t_, a_: jfn(o_, d_, jcm, jcfg, t_init=t_, active=a_))(
        o, d, t0, act)
    np.testing.assert_array_equal(np.asarray(hj.tri), hit.tri.numpy())
    np.testing.assert_allclose(np.asarray(hj.t), hit.t.numpy(), rtol=1e-6)


def test_pairs_shard_stats_are_a_rows_work():
    _, _, tcm = _tables(3)
    o, d, act, t0 = _ray_set()
    stats = [tpairs.intersect_mesh_pairs(_t(o), _t(d), tcm,
                                         TCfg(cluster_tile=256, pair_slots=2,
                                              binned_shards=s, **PAIRS),
                                         t_init=_t(t0), active=_t(act), collect_stats=True)[1]
             for s in (1, 4)]
    assert stats[0]["shards"] == 1 and stats[1]["shards"] == 4
    assert stats[0]["mesh_active"] == stats[1]["mesh_active"]
    assert stats[1]["m1"] <= stats[0]["m1"] // 4 * 2 and stats[1]["m2"] <= stats[0]["m2"]


_WORKER = """
import json, sys
import numpy as np
import torch
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig
from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
from kdtreepathtraceroptimization_tpu_torch.parallel import multihost, sharding
from kdtreepathtraceroptimization_tpu_torch.scene.parser import load_scene, with_resolution

pid = int(sys.argv[1])
assert multihost.initialize("localhost:{port}", 2, pid, device="cpu", timeout_s=60.0)
import torch.distributed as dist
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
scene = with_resolution(load_scene({cornell!r}, obj_path={obj!r}, device="cpu"), 16, 16)
cfg = RenderConfig(trace_depth=2, antialias=True)
img = multihost.render_distributed(scene, cfg, 2, seed=0, device="cpu")
init, step = sharding.make_sharded_train_step(scene, cfg, np.load({target!r}), learning_rate=2e-2,
                                              device="cpu")
state = init()
losses = []
for it in (1, 2):
    state, loss = step(state, prng_key(0), it)
    losses.append(float(loss))
out = {{"img": img.numpy().tolist(), "losses": losses,
        "color": state.materials.color.detach().numpy().tolist(),
        "collectives": sharding.COLLECTIVES}}
with open({out!r}.format(pid), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def test_two_gloo_processes_match_one(tmp_path):
    obj = _mesh_obj(tmp_path, 3, 2.0)
    scene = tparser.with_resolution(tparser.load_scene(CORNELL, obj_path=obj, device="cpu"),
                                    16, 16)
    cfg = TCfg(trace_depth=2, antialias=True)
    target = render(scene, cfg, 1, seed=1, device="cpu").reshape(256, 3).numpy()
    np.save(tmp_path / "target.npy", target)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(port=port, cornell=CORNELL, obj=obj,
                                     target=str(tmp_path / "target.npy"),
                                     out=str(tmp_path / "out{}.json")))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(worker), str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    got = [json.loads((tmp_path / f"out{i}.json").read_text()) for i in range(2)]

    img = render(scene, cfg, 2, seed=0, device="cpu").numpy()
    init, step = make_train_step(scene, cfg, target, learning_rate=2e-2, device="cpu")
    state, losses = init(), []
    for it in (1, 2):
        state, loss = step(state, prng_key(0), it)
        losses.append(float(loss))
    for g in got:
        np.testing.assert_allclose(np.array(g["img"]), img, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(np.array(g["color"]), state.materials.color.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        # one all_gather (the image), one all_reduce a training step
        assert g["collectives"] == {"all_reduce": 2, "all_gather": 1}
    np.testing.assert_array_equal(np.array(got[0]["color"]), np.array(got[1]["color"]))
