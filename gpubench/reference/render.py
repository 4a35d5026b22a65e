"""The plain reference path tracer.

Plain PyTorch, from the raw triangles: camera rays with antialiasing
jitter, the analytic cubes of the scene text, a brute-force Moller-
Trumbore test against every triangle, diffuse scattering and the
throughput shading of the reference renderer (src/pathtrace.cu,
src/interactions.h, src/intersections.h). It traces any set of pixels of
one iteration, each path on its own, and draws the same random numbers as
the program (``rng.py``), so a path it follows and the program's agree to
rounding.

Vectors are kept as three [N] channels and every expression is written in
the order the renderer evaluates it, so that rounding matches as far as
the arithmetic allows. The only structure it builds is a bounding box per
run of ``CHUNK`` consecutive triangles, a cull that drops no hit: no pair
list, cluster table or KD tree.

``quant`` rounds the operands of the intersection tests (the control:
``tf32`` keeps 10 mantissa bits, as TF32 products would). The surfaces it
covers are diffuse ones and lights; a path that meets any other raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpubench.reference.rng import bounce_key, uniform_cols

BIG = 1e30
AA_JITTER = 0.002  # the antialiasing jitter's scale (pathtrace.cu:338)
CHUNK = 1024
SQRT_ONE_THIRD = 0.5773502691896258
TWO_PI = 6.283185307179586


def exact(x):
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even."""
    if not isinstance(x, torch.Tensor):
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


QUANT = {"exact": exact, "tf32": tf32}


class V(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def add(a, b):
    return V(a.x + b.x, a.y + b.y, a.z + b.z)


def sub(a, b):
    return V(a.x - b.x, a.y - b.y, a.z - b.z)


def mul(a, s):
    if isinstance(s, V):
        return V(a.x * s.x, a.y * s.y, a.z * s.z)
    return V(a.x * s, a.y * s, a.z * s)


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a, b):
    return V(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def normalize(a):
    n = torch.sqrt(torch.clamp_min(dot(a, a), 1e-12))
    return V(a.x / n, a.y / n, a.z / n)


def where(c, a, b):
    return V(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y), torch.where(c, a.z, b.z))


def pick(a, idx):
    return V(a.x[idx], a.y[idx], a.z[idx])


def _xpoint(m, p, q):
    return V(*(q(m[r][0]) * q(p.x) + q(m[r][1]) * q(p.y) + q(m[r][2]) * q(p.z) + m[r][3]
               for r in range(3)))


def _xvector(m, v, q):
    return V(*(q(m[r][0]) * q(v.x) + q(m[r][1]) * q(v.y) + q(m[r][2]) * q(v.z)
               for r in range(3)))


class Prepared(NamedTuple):
    """The scene as tensors on one device."""

    geoms: list  # (kind, material, transform, inverse) as lists
    tris: dict  # [T, 3] tensors, material [T]
    boxes: list  # (lo, hi) of each run of ``chunk`` triangles, padded, as lists
    camera: object
    chunk: int


def prepare(scene, device, chunk: int = CHUNK) -> Prepared:
    """The scene's tables on ``device``; ``chunk`` triangles share a box.
    Matrix products run in true float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    geoms = [(g.kind, g.material, g.transform.tolist(), g.inverse.tolist())
             for g in scene.geoms]
    tris, boxes = None, None
    if scene.tris is not None:
        tris = {k: torch.as_tensor(v, device=device) for k, v in scene.tris.items()}
        t = tris["v0"].shape[0]
        pad = (-t) % chunk
        corners = torch.stack([tris["v0"], tris["v1"], tris["v2"]], 1)  # [T, 3, 3]
        corners = torch.cat([corners, corners[-1:].expand(pad, 3, 3)])
        corners = corners.reshape(-1, chunk * 3, 3)
        lo, hi = corners.amin(1), corners.amax(1)
        slack = 1e-4 * (hi - lo).amax(1, keepdim=True) + 1e-4
        boxes = list(zip((lo - slack).tolist(), (hi + slack).tolist()))
    return Prepared(geoms, tris, boxes, scene.camera, chunk)


def camera_rays(cam, pixels: torch.Tensor, key, antialias: bool, jitter: float):
    """(origin, direction) of the camera rays of ``pixels`` (x + y W)."""
    dev = pixels.device
    w, h = cam.resolution
    idx = pixels.to(torch.int32)
    x = (idx % w).to(torch.float32)
    y = (idx // w).to(torch.float32)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    view, up, right = (V(*f(a)) for a in (cam.view, cam.up, cam.right))
    px, py = f(cam.pixel_length)
    sx = px * (x - w * 0.5)
    sy = py * (y - h * 0.5)
    d = normalize(sub(add(view, mul(right, sx)), mul(up, sy)))
    if antialias:
        u = uniform_cols(key, pixels, 3)
        d = normalize(add(d, mul(normalize(V(u[0], u[1], u[2])), jitter)))
    n = pixels.shape[0]
    o = V(*(p.expand(n) for p in f(cam.position)))
    return o, d


def _box(qo, qd, tr, q):
    """Slab test against the unit cube at the origin (intersections.h:107-149)."""
    ta, tb, ns = [], [], []
    for o_a, d_a in ((qo.x, qd.x), (qo.y, qd.y), (qo.z, qd.z)):
        par = torch.abs(d_a) < 1e-12
        inv_d = 1.0 / torch.where(par, 1.0, d_a)
        t1 = q(-0.5 - o_a) * q(inv_d)
        t2 = q(0.5 - o_a) * q(inv_d)
        inside = (o_a >= -0.5) & (o_a <= 0.5)
        ta.append(torch.where(par, torch.where(inside, -BIG, BIG), torch.minimum(t1, t2)))
        tb.append(torch.where(par, torch.where(inside, BIG, -BIG), torch.maximum(t1, t2)))
        ns.append(torch.where(t2 < t1, 1.0, -1.0))
    tav = [torch.where(t > 0, t, -BIG) for t in ta]
    tmin = torch.maximum(torch.maximum(tav[0], tav[1]), tav[2])
    en_x = (tav[0] >= tav[1]) & (tav[0] >= tav[2])
    en_y = ~en_x & (tav[1] >= tav[2])
    en_z = ~en_x & ~en_y
    tmax = torch.minimum(torch.minimum(tb[0], tb[1]), tb[2])
    ex_x = (tb[0] <= tb[1]) & (tb[0] <= tb[2])
    ex_y = ~ex_x & (tb[1] <= tb[2])
    ex_z = ~ex_x & ~ex_y
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(hit, torch.where(inside, tmax, tmin), 0.0)
    oh_x = torch.where(inside, ex_x, en_x)
    oh_y = torch.where(inside, ex_y, en_y)
    oh_z = torch.where(inside, ex_z, en_z)
    sign = torch.where(oh_x, ns[0], torch.where(oh_y, ns[1], ns[2]))
    n_obj = V(torch.where(oh_x, sign, 0.0), torch.where(oh_y, sign, 0.0),
              torch.where(oh_z, sign, 0.0))
    p_obj = add(qo, mul(qd, q(t_obj)))
    return hit, _xpoint(tr, p_obj, q), normalize(_xvector(tr, n_obj, q))


def _geoms(sc: Prepared, o, d, q):
    """Nearest analytic hit: (t, point, normal, material)."""
    n = o.x.shape[0]
    z = torch.zeros(n, device=o.x.device)
    t = torch.full((n,), BIG, device=o.x.device)
    point, normal = V(z, z, z), V(z, z, z)
    mat = torch.full((n,), -1, dtype=torch.int64, device=o.x.device)
    for kind, material, tr, inv in sc.geoms:
        if kind != "cube":
            raise NotImplementedError("the reference covers cubes, the scenes' only geoms")
        qo = _xpoint(inv, o, q)
        qd = normalize(_xvector(inv, d, q))
        hit, p, nrm = _box(qo, qd, tr, q)
        pd = sub(p, o)
        t_g = torch.where(hit, torch.sqrt(dot(pd, pd) + 1e-12), BIG)
        hf = hit.to(torch.float32)
        upd = t_g < t
        t = torch.where(upd, t_g, t)
        point = where(upd, mul(p, hf), point)
        normal = where(upd, mul(nrm, hf), normal)
        mat = torch.where(upd, material, mat)
    return t, point, normal, mat


def _tri_features(v0, v1, v2, q):
    """Per-triangle rows of the test's four products (see ``_mt``)."""
    e1, e2 = v1 - v0, v2 - v0
    cr = lambda a, b: torch.linalg.cross(a, b, dim=1)  # noqa: E731
    e2v0, v0e1 = cr(e2, v0), cr(v0, e1)
    return [q(m.T.contiguous()) for m in (
        cr(e2, e1),                                               # a
        torch.cat([e2, -e2v0], 1),                                # u a
        torch.cat([-e1, -v0e1], 1),                               # v a
        torch.cat([cr(e1, e2), -(e2 * v0e1).sum(1, keepdim=True)], 1))]  # t a


def _mt(o, d, feats, q):
    """Moller-Trumbore of [n] rays against [T] triangles, back faces
    culled: t [n, T] with BIG for a miss. With s = o - v0, the three
    triple products are expanded so that each is one product of a ray row
    and a triangle column: a = d.(e2 x e1), u a = (o x d).e2 - d.(e2 x v0),
    v a = -(o x d).e1 - d.(v0 x e1), t a = o.(e1 x e2) - e2.(v0 x e1)."""
    fa, fu, fv, ft = feats
    rd = torch.stack([d.x, d.y, d.z], 1)
    ro = torch.stack([o.x, o.y, o.z], 1)
    od = torch.linalg.cross(ro, rd, dim=1)
    r6 = q(torch.cat([od, rd], 1))
    a = q(rd) @ fa
    valid = a > 1.19e-7
    f = 1.0 / torch.where(valid, a, 1.0)
    u = f * (r6 @ fu)
    v = f * (r6 @ fv)
    t = f * (q(torch.cat([ro, torch.ones_like(ro[:, :1])], 1)) @ ft)
    ok = valid & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return torch.where(ok, t, BIG)


def _box_entry(o, d, lo, hi):
    """Entry distance of each ray into box (lo, hi); BIG where it misses."""
    tn = torch.full_like(o.x, -BIG)
    tf = torch.full_like(o.x, BIG)
    for oa, da, l, h in zip(o, d, lo, hi):
        par = torch.abs(da) < 1e-12
        inv = 1.0 / torch.where(par, 1.0, da)
        t1, t2 = (l - oa) * inv, (h - oa) * inv
        inside = (oa >= l) & (oa <= h)
        tn = torch.maximum(tn, torch.where(par, torch.where(inside, -BIG, BIG),
                                           torch.minimum(t1, t2)))
        tf = torch.minimum(tf, torch.where(par, torch.where(inside, BIG, -BIG),
                                           torch.maximum(t1, t2)))
    return torch.where((tf >= tn) & (tf >= 0), tn, BIG)


def _mesh(sc: Prepared, o, d, t_max, q, elems: int = 1 << 27):
    """Nearest triangle closer than ``t_max``: its index, -1 for none.
    Runs of triangles are taken in index order, strict ``<`` across runs
    and the first minimum within one: the lowest index wins a tie."""
    best_t = t_max.clone()
    best_i = torch.full(best_t.shape, -1, dtype=torch.int64, device=best_t.device)
    T, size = sc.tris["v0"].shape[0], sc.chunk
    for c, (lo, hi) in enumerate(sc.boxes):
        entry = _box_entry(o, d, lo, hi)
        cand = torch.nonzero(entry <= best_t * (1 + 1e-5) + 1e-5)[:, 0]
        if cand.numel() == 0:
            continue
        s = slice(c * size, min(T, (c + 1) * size))
        feats = _tri_features(sc.tris["v0"][s], sc.tris["v1"][s], sc.tris["v2"][s], q)
        rows = max(1, elems // size)
        for r in range(0, cand.numel(), rows):
            idx = cand[r:r + rows]
            t = _mt(pick(o, idx), pick(d, idx), feats, q)
            loc = torch.argmin(t, dim=1)
            tmin = t.gather(1, loc[:, None])[:, 0]
            better = tmin < best_t[idx]
            best_t[idx] = torch.where(better, tmin, best_t[idx])
            best_i[idx] = torch.where(better, c * size + loc, best_i[idx])
    return best_i


def _tri_hit(sc: Prepared, o, d, tri, q):
    """(t, point, normal, material) of the chosen triangles (t recomputed
    with |det| clamped at 1e-6, the normal interpolated, the point lifted
    by 1e-4 along it: pathtrace.cu:981-1007)."""
    is_hit = tri >= 0
    k = torch.clamp_min(tri, 0)
    g = {n: V(*sc.tris[n][k].unbind(1)) for n in ("v0", "v1", "v2", "n0", "n1", "n2")}
    e1 = sub(g["v1"], g["v0"])
    e2 = sub(g["v2"], g["v0"])
    qv = lambda a: V(q(a.x), q(a.y), q(a.z))  # noqa: E731
    p = cross(qv(d), qv(e2))
    a = dot(qv(e1), qv(p))
    safe = torch.abs(a) > 1e-12
    a_cl = torch.where(a >= 0, 1.0, -1.0) * torch.clamp_min(torch.abs(a), 1e-6)
    f = 1.0 / torch.where(safe, a_cl, 1.0)
    s = sub(o, g["v0"])
    u = f * dot(qv(s), qv(p))
    qq = cross(qv(s), qv(e1))
    v = f * dot(qv(d), qv(qq))
    t = f * dot(qv(e2), qv(qq))
    t = torch.where(is_hit, t, BIG)
    w = 1.0 - u - v
    normal = normalize(add(add(mul(g["n0"], w), mul(g["n1"], u)), mul(g["n2"], v)))
    point = add(add(o, mul(d, q(t))), mul(normal, 1e-4))
    z = torch.zeros_like(t)
    zv = V(z, z, z)
    mat = torch.where(is_hit, sc.tris["material"][k], -1)
    return t, where(is_hit, point, zv), where(is_hit, normal, zv), mat


def _hemisphere(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` (interactions.h:9-41)."""
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
    around = u2 * TWO_PI
    use_x = torch.abs(normal.x) < SQRT_ONE_THIRD
    use_y = ~use_x & (torch.abs(normal.y) < SQRT_ONE_THIRD)
    one, zero = torch.ones_like(normal.x), torch.zeros_like(normal.x)
    not_normal = V(torch.where(use_x, one, zero), torch.where(use_y, one, zero),
                   torch.where(use_x | use_y, zero, one))
    p1 = normalize(cross(normal, not_normal))
    p2 = normalize(cross(normal, p1))
    return add(add(mul(normal, up), mul(p1, torch.cos(around) * over)),
               mul(p2, torch.sin(around) * over))


def trace(sc: Prepared, materials: dict, pixels: torch.Tensor, base_key, iteration: int,
          depth: int, antialias: bool, jitter: float, quant: Callable = exact):
    """Radiance [n, 3] that one iteration adds at ``pixels``.

    ``materials``: field -> tensor over material ids on the device (the
    colour and emittance may require grad). A path ends at a light, on a
    miss, or after ``depth`` surfaces; a path that ends without reaching a
    light keeps its throughput, as the reference renderer's final gather
    does."""
    n = pixels.shape[0]
    dev = pixels.device
    o, d = camera_rays(sc.camera, pixels, bounce_key(base_key, iteration, 0), antialias, jitter)
    one = torch.ones(n, device=dev)
    color = [one, one, one]
    live = torch.arange(n, device=dev)
    for b in range(depth):
        if live.numel() == 0:
            break
        lo, ld = pick(o, live), pick(d, live)
        t, point, normal, mat = _geoms(sc, lo, ld, quant)
        if sc.tris is not None:
            with torch.no_grad():
                tri = _mesh(sc, lo, ld, t, quant)
            mt, mpoint, mnormal, mmat = _tri_hit(sc, lo, ld, tri, quant)
            take_g = t <= mt
            t = torch.where(take_g, t, mt)
            point = where(take_g, point, mpoint)
            normal = where(take_g, normal, mnormal)
            mat = torch.where(take_g, mat, mmat)
        hit = t < BIG
        m = torch.clamp_min(mat, 0)
        emit = materials["emittance"][m]
        plain = ((materials["has_reflective"][m] == 0) & (materials["has_refractive"][m] == 0)
                 & (materials["transmittance"][m] == 0).all(1))
        if not bool((plain | ~hit).all()):
            raise NotImplementedError("the reference covers diffuse surfaces and lights only")
        rgb = materials["color"][m]
        light = emit > 0.0
        for c in range(3):
            cur = color[c][live]
            new = torch.where(hit, torch.where(light, cur * rgb[:, c] * emit, cur * rgb[:, c]),
                              torch.zeros_like(cur))
            color[c] = color[c].index_put((live,), new)
        u = uniform_cols(bounce_key(base_key, iteration, b + 1), pixels[live], 3)
        nn = normalize(normal)
        nd = _hemisphere(nn, u[1], u[2])
        no = add(point, mul(nn, 1e-5))
        cont = hit & ~light
        o = V(*(a.index_put((live,), torch.where(cont, b_, a[live])) for a, b_ in zip(o, no)))
        d = V(*(a.index_put((live,), torch.where(cont, b_, a[live])) for a, b_ in zip(d, nd)))
        live = live[cont]
    return torch.stack(color, dim=1)
