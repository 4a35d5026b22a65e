"""The wavefront extras and the front-end modules against the JAX package:
compaction and the material sort, the ray cache, the KD view, the film
checkpoints, the image files, the terminal preview and ``print_tree``.

Inputs come from numpy seeds. Tolerances: the reorderings' permutations
and fields, the image files' bytes, the preview's text, the tree dump and
the checkpoints' arrays exactly; the port's renders with and without a
reordering bit for bit (the streams are keyed by pixel); the port's
renders against the JAX package's at the golden tests' atol 2e-3 a pixel
(tests/test_golden.py), a film of k iterations at k times that; the KD
view within 1e-6.
"""

import re
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kdtreepathtraceroptimization_tpu.accel import kdtools as jkdtools
from kdtreepathtraceroptimization_tpu.accel import kdtree as jkd
from kdtreepathtraceroptimization_tpu.config import RenderConfig as JCfg
from kdtreepathtraceroptimization_tpu.ops import compaction as jcomp
from kdtreepathtraceroptimization_tpu.ops import vecmath as jvm
from kdtreepathtraceroptimization_tpu.ops.camera import RaySoA as JRays
from kdtreepathtraceroptimization_tpu.ops.camera import generate_rays as jgenerate_rays
from kdtreepathtraceroptimization_tpu.ops.kdviz import render_kd_boxes as jrender_kd_boxes
from kdtreepathtraceroptimization_tpu.ops.rng import bounce_key as jbounce_key
from kdtreepathtraceroptimization_tpu.render import film as jfilm
from kdtreepathtraceroptimization_tpu.render.integrator import make_render_fn as jmake_render_fn
from kdtreepathtraceroptimization_tpu.render.integrator import render as jrender
from kdtreepathtraceroptimization_tpu.scene import parser as jparser
from kdtreepathtraceroptimization_tpu.utils import image as jimage
from kdtreepathtraceroptimization_tpu.utils import termview as jtermview
from kdtreepathtraceroptimization_tpu_torch.accel import kdtools as tkdtools
from kdtreepathtraceroptimization_tpu_torch.accel import kdtree as tkd
from kdtreepathtraceroptimization_tpu_torch.config import RenderConfig as TCfg
from kdtreepathtraceroptimization_tpu_torch.convert import kd_to_device, scene_from_numpy
from kdtreepathtraceroptimization_tpu_torch.ops import compaction as tcomp
from kdtreepathtraceroptimization_tpu_torch.ops.camera import RaySoA as TRays
from kdtreepathtraceroptimization_tpu_torch.ops.camera import generate_rays
from kdtreepathtraceroptimization_tpu_torch.ops.kdviz import node_depths, render_kd_boxes
from kdtreepathtraceroptimization_tpu_torch.ops.rng import bounce_key, prng_key
from kdtreepathtraceroptimization_tpu_torch.ops.vecmath import V3
from kdtreepathtraceroptimization_tpu_torch.render import film as tfilm
from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn, render
from kdtreepathtraceroptimization_tpu_torch.scene import parser as tparser
from kdtreepathtraceroptimization_tpu_torch.utils import image as timage
from kdtreepathtraceroptimization_tpu_torch.utils import termview as ttermview
from tests.test_torch_render import CORNELL, _mesh_obj

ATOL = 2e-3


def _ray_fields(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        origin=rng.normal(size=(n, 3)).astype(np.float32),
        direction=rng.normal(size=(n, 3)).astype(np.float32),
        color=rng.uniform(size=(n, 3)).astype(np.float32),
        is_inside=rng.uniform(size=n) < 0.3,
        sdepth=rng.uniform(size=n).astype(np.float32),
        pixel_index=rng.permutation(n).astype(np.int32),
        remaining_bounces=np.where(rng.uniform(size=n) < 0.3, 0,
                                   rng.integers(1, 8, n)).astype(np.int32),
    )


def _trays(fields):
    return TRays(**{k: V3(*torch.from_numpy(a).unbind(1)) if a.ndim == 2 else torch.from_numpy(a)
                    for k, a in fields.items()})


def _jrays(fields):
    return JRays(**{k: jvm.v3_from_rows(jnp.asarray(a)) if a.ndim == 2 else jnp.asarray(a)
                    for k, a in fields.items()})


def _rows(rays):
    out = {}
    for k, a in rays._asdict().items():
        if isinstance(a, tuple):
            a = np.stack([np.asarray(c) for c in a], 1)
        out[k] = np.asarray(a)
    return out


@pytest.mark.parametrize("kind", ["compact", "material", "octant"])
def test_reorderings_match_jax(kind):
    """compact_rays, sort_rays_by_material (with tied and dead lanes) and
    sort_rays_by_octant permute a 512-ray wavefront as the JAX package's
    stable sorts do: every field equal, the permutation and the live count
    too."""
    f = _ray_fields(512, seed=2)
    trays, jrays = _trays(f), _jrays(f)
    mat = np.random.default_rng(3).integers(0, 5, 512).astype(np.int32)
    if kind == "compact":
        (got, g2), (want, w2) = tcomp.compact_rays(trays), jcomp.compact_rays(jrays)
    elif kind == "material":
        (got, g2), (want, w2) = (tcomp.sort_rays_by_material(trays, torch.from_numpy(mat)),
                                 jcomp.sort_rays_by_material(jrays, jnp.asarray(mat)))
    else:
        got, want = tcomp.sort_rays_by_octant(trays), jcomp.sort_rays_by_octant(jrays)
        g2, w2 = 0, 0
    np.testing.assert_array_equal(np.asarray(g2), np.asarray(w2))
    for k, a in _rows(want).items():
        np.testing.assert_array_equal(_rows(got)[k], a, err_msg=k)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The Cornell box at 16x16 alone, with an 80-triangle sphere (the KD
    route) and with a 1,280-triangle one (the pair list)."""
    path = tmp_path_factory.mktemp("extras")
    out = {"analytic": tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 16, 16)}
    for name, subdiv in (("kd", 1), ("pairs", 3)):
        out[name] = tparser.with_resolution(
            tparser.load_scene(CORNELL, obj_path=_mesh_obj(path, subdiv, 2.0), device="cpu"),
            16, 16)
    return out


@pytest.mark.parametrize("route", ["analytic", "kd", "pairs"])
def test_compaction_and_sort_match_baseline(scenes, route):
    """tests/test_integrator.py:70 for the port, on three routes: the
    streams are keyed by pixel, so compaction and the material sort
    render the default image bit for bit (depth 4, 2 spp, AA on)."""
    scene = scenes[route]
    base = render(scene, TCfg(trace_depth=4, antialias=True, cluster_tile=64), spp=2,
                  device="cpu")
    assert base.max() > 0
    for kw in (dict(compaction=True), dict(material_sort=True),
               dict(compaction=True, material_sort=True)):
        img = render(scene, TCfg(trace_depth=4, antialias=True, cluster_tile=64, **kw), spp=2,
                     device="cpu")
        assert torch.equal(img, base), kw


def test_partial_gather_compaction_matches_jax():
    """The CLI's key F: compaction with ``partial_gather`` (paths alive at
    the last bounce dropped, the rest scattered to their pixels) against
    the JAX package's render, 32x32, depth 3, 2 spp, at the golden atol."""
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL), 32, 32)
    tscene = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 32, 32)
    cfg = dict(trace_depth=3, compaction=True, partial_gather=True)
    img_j = np.asarray(jrender(jscene, JCfg(**cfg), spp=2, seed=1))
    img_t = render(tscene, TCfg(**cfg), spp=2, seed=1, device="cpu").numpy()
    assert img_t.max() > 0
    np.testing.assert_allclose(img_t, img_j, atol=ATOL)


def test_ray_cache_seed_and_resume(tmp_path):
    """tests/test_film.py:70 for the port: with ``ray_cache`` the cached
    camera rays come from the seed (seeds 0 and 3 differ); a checkpoint
    after 2 iterations resumed to 4 equals the uninterrupted film bit for
    bit; that film equals the JAX package's within 4 x atol."""
    tscene = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 32, 32)
    cfg = dict(trace_depth=2, antialias=True, ray_cache=True)
    n = 32 * 32

    def run(seed, start, stop, film=None):
        step = make_render_fn(tscene, TCfg(**cfg), seed=seed, device="cpu")
        film = torch.zeros((n, 3)) if film is None else film
        for it in range(start, stop):
            film = step(film, prng_key(seed), it)
        return film

    assert (run(0, 1, 3) - run(3, 1, 3)).abs().max() > 0
    path = str(tmp_path / "ckpt.npz")
    tfilm.save_checkpoint(path, tfilm.Film(accum=run(3, 1, 3), iteration=2, seed=3))
    loaded = tfilm.load_checkpoint(path, device="cpu")
    resumed = run(loaded.seed, loaded.iteration + 1, 5, loaded.accum)
    straight = run(3, 1, 5)
    assert torch.equal(resumed, straight)

    jscene = jparser.with_resolution(jparser.load_scene(CORNELL), 32, 32)
    step = jmake_render_fn(jscene, JCfg(**cfg), seed=3)
    film = jnp.zeros((n, 3), jnp.float32)
    for it in range(1, 5):
        film = step(film, jax.random.PRNGKey(3), jnp.int32(it))
    np.testing.assert_allclose(straight.numpy(), np.asarray(film), atol=4 * ATOL)


def test_checkpoints_cross_package(tmp_path):
    """A checkpoint written by either package loads in the other with the
    same arrays, iteration and seed; a JAX film of 2 iterations resumed by
    the port to 4 agrees with the JAX package's 4-iteration film."""
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL), 16, 16)
    tscene = tparser.with_resolution(tparser.load_scene(CORNELL, device="cpu"), 16, 16)
    cfg = dict(trace_depth=3, antialias=True)
    step_j = jmake_render_fn(jscene, JCfg(**cfg), seed=5)
    film_j, films = jnp.zeros((256, 3), jnp.float32), [None]
    for it in range(1, 5):
        film_j = step_j(film_j, jax.random.PRNGKey(5), jnp.int32(it))  # donates its input
        films.append(np.asarray(film_j).copy())
    jpath = str(tmp_path / "jax.npz")
    jfilm.save_checkpoint(jpath, jfilm.Film(accum=films[2], iteration=2, seed=5))
    loaded = tfilm.load_checkpoint(jpath, device="cpu")
    assert (loaded.iteration, loaded.seed) == (2, 5)
    np.testing.assert_array_equal(loaded.accum.numpy(), np.asarray(films[2]))
    step_t = make_render_fn(tscene, TCfg(**cfg), seed=loaded.seed, device="cpu")
    accum = loaded.accum
    for it in range(3, 5):
        accum = step_t(accum, prng_key(loaded.seed), it)
    np.testing.assert_allclose(accum.numpy(), np.asarray(films[4]), atol=4 * ATOL)

    tpath = str(tmp_path / "port")  # np.savez appends .npz
    film = tfilm.Film(accum=accum, iteration=4, seed=5)
    tfilm.save_checkpoint(tpath, film)
    back = jfilm.load_checkpoint(tpath + ".npz")
    assert (back.iteration, back.seed) == (4, 5)
    np.testing.assert_array_equal(np.asarray(back.accum), accum.numpy())
    np.testing.assert_array_equal(film.image(16, 16), jfilm.Film(*back).image(16, 16))
    np.testing.assert_array_equal(tfilm.tonemap_srgb_u8(film.image(16, 16)),
                                  jfilm.tonemap_srgb_u8(back.image(16, 16)))
    empty = tfilm.Film.create(256, seed=2, device="cpu")
    assert empty.accum.shape == (256, 3) and not empty.accum.any() and empty.iteration == 0


@pytest.mark.parametrize("leaves_only, chunk", [(True, 256), (True, 64), (False, 100)])
def test_render_kd_boxes_matches_jax(tmp_path, leaves_only, chunk):
    """The KD view of an icosphere-3 tree (leaves of 8) from the Cornell
    camera at 32x32 equals the JAX package's within 1e-6; the node depths
    are the tree's."""
    obj = _mesh_obj(tmp_path, 3, 2.0)
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL, obj_path=obj, leaf_size=8),
                                     32, 32)
    tscene = tparser.with_resolution(
        tparser.load_scene(CORNELL, obj_path=obj, leaf_size=8, device="cpu"), 32, 32)
    jr = jgenerate_rays(jscene.camera, JCfg(), jbounce_key(jax.random.PRNGKey(0), 1, 0), 1)
    want = np.asarray(jax.jit(lambda o, d: jrender_kd_boxes(
        o, d, jscene.kd, max_nodes_per_chunk=chunk, leaves_only=leaves_only))(
            jvm.v3_to_rows(jr.origin), jvm.v3_to_rows(jr.direction)))
    tr = generate_rays(tscene.camera, TCfg(), bounce_key(prng_key(0), 1, 0), 1, "cpu")
    got = render_kd_boxes(tr.origin, tr.direction, tscene.kd, max_nodes_per_chunk=chunk,
                          leaves_only=leaves_only).numpy()
    assert (want.max(-1) > 0).sum() > 20
    np.testing.assert_allclose(got, want, atol=1e-6)
    parent = tscene.kd.nodes.parent.numpy()
    depth = node_depths(tscene.kd).numpy()
    assert depth[0] == 0 and (depth[1:] == depth[parent[1:]] + 1).all()


def _png(rows, color_type, w):
    """A PNG of ``rows`` (each a filter byte and its filtered scanline)."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    hdr = struct.pack(">IIBBBBB", w, len(rows), 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type, channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_read_png_matches_jax(tmp_path, color_type, channels):
    """read_png decodes PNGs of every colour type whose scanlines use all
    five filters (random filtered bytes are a valid stream) as the JAX
    package's reader does; a PNG the port writes reads back as written."""
    rng = np.random.default_rng(color_type)
    w, h = 7, 10
    rows = [bytes([r % 5]) + rng.integers(0, 256, w * channels, dtype=np.uint8).tobytes()
            for r in range(h)]
    path = tmp_path / "f.png"
    path.write_bytes(_png(rows, color_type, w))
    got = timage.read_png(str(path))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jimage.read_png(str(path)))
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    timage.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(timage.read_png(str(tmp_path / "w.png")), img)


def test_image_files_match_jax(tmp_path):
    """write_png and write_hdr write the JAX package's bytes (the HDR from
    an image with black, tiny and bright pixels); render_filename has its
    form."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 3, (12, 9, 3)).astype(np.float32)
    img[0, :3] = 0.0
    img[1, 0] = 1e-35
    for mod, name in ((timage, "port"), (jimage, "jax")):
        mod.write_png(str(tmp_path / f"{name}.png"), tfilm.tonemap_srgb_u8(img))
        mod.write_hdr(str(tmp_path / f"{name}.hdr"), img)
    for ext in ("png", "hdr"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    form = r"cornell\.\d{4}-\d\d-\d\d_\d\d-\d\d-\d\dz\.5samp\.hdr"
    assert re.fullmatch(form, timage.render_filename("cornell", 5, "hdr"))
    assert re.fullmatch(form, jimage.render_filename("cornell", 5, "hdr"))


def test_termview_matches_jax():
    """ansi_preview and live_frame give the JAX package's text: the JAX
    termview test's two-colour image (its 8 rows and escapes) and a random
    film, first frame and later ones."""
    img = np.zeros((32, 64, 3), np.float32)
    img[:16] = [1.0, 0.0, 0.0]
    img[16:] = [0.0, 1.0, 0.0]
    art = ttermview.ansi_preview(img, cols=32)
    assert art == jtermview.ansi_preview(img, cols=32) and len(art.splitlines()) == 8
    assert "38;2;255;0;0" in art.splitlines()[0]
    film = np.random.default_rng(1).uniform(0, 4, (30 * 50, 3)).astype(np.float32)
    for it, first in ((1, True), (4, False)):
        frame = ttermview.live_frame(film, it, 30, 50, cols=20, first=first)
        assert frame == jtermview.live_frame(film, it, 30, 50, cols=20, first=first)
        assert f"iter {it}" in frame
        assert (re.match(r"\x1b\[\d+F", frame) is None) == first  # later frames rewind
    assert ttermview.ansi_preview(img[:1], cols=64) == ""


@pytest.mark.parametrize("max_nodes", [16, 10_000])
def test_print_tree_matches_jax(max_nodes):
    """print_tree (tests/test_kdtools.py:62) gives the JAX package's dump
    of the same tree, from the host tables and from the tables on a
    device; it also writes the text to ``file``."""
    rng = np.random.default_rng(4)
    c = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    v = tuple(c + rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32) for _ in range(3))
    kd = tkd.build_kdtree(*v, leaf_size=4)
    want = jkdtools.print_tree(jkd.build_kdtree(*v, leaf_size=4), max_nodes=max_nodes)
    assert tkdtools.print_tree(kd, max_nodes=max_nodes) == want
    assert tkdtools.print_tree(kd_to_device(kd, "cpu"), max_nodes=max_nodes) == want
    assert want.splitlines()[0].startswith(("node#0", "leaf#0"))
    assert len(want.splitlines()) <= min(max_nodes, kd.nodes.count) + 1

    class Sink:
        text = ""

        def write(self, s):
            Sink.text += s

    tkdtools.print_tree(kd, max_nodes=max_nodes, file=Sink())
    assert Sink.text == want
    assert tkdtools.tree_stats(kd_to_device(kd, "cpu")) == tkdtools.tree_stats(kd)


def test_jax_scene_carries_into_render_kd_boxes(tmp_path):
    """A JAX scene's KD table carried into the port (scene_from_numpy)
    draws the same view as the port's own build."""
    obj = _mesh_obj(tmp_path, 2, 2.0)
    jscene = jparser.with_resolution(jparser.load_scene(CORNELL, obj_path=obj), 16, 16)
    carried = scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    own = tparser.with_resolution(tparser.load_scene(CORNELL, obj_path=obj, device="cpu"), 16, 16)
    rays = generate_rays(own.camera, TCfg(), bounce_key(prng_key(0), 1, 0), 1, "cpu")
    a = render_kd_boxes(rays.origin, rays.direction, carried.kd)
    b = render_kd_boxes(rays.origin, rays.direction, own.kd)
    assert torch.equal(a, b) and a.max() > 0
