"""Interactive render loop: the reference renderer's keyboard controller.

The JAX package's ``render/interactive.py`` in PyTorch (reference:
src/main.cpp:1110-1343, the GLFW callbacks and the camera controller of
runCuda): keyboard orbit, pan and zoom that restart the film, the
run-time feature toggles, and a live ANSI preview in place of the GL
window. ``apply_key`` is a pure state machine, so the camera-change ->
film-reset transition is testable; ``run_interactive`` owns the terminal
and the stdin plumbing.

Key bindings (reference: README.md:14-40, main.cpp:1187-1343):

  arrows / hjkl   orbit (phi/theta)            mouse-drag analog
  + / -           zoom in / out                scroll analog
  w a s d         pan (view plane)             right-drag analog
  [ / ]           focal length down / up
  , / .           depth-of-field blur down / up
  A C X F M K L B toggles: antialias, ray cache, SSS, compaction,
                  material sort, KD on/off, short-stack, bbox cull
  S               save PNG now
  q / Esc         save and quit

As in the reference, a camera change restarts accumulation from
iteration 0 (camchanged -> iteration = 0, main.cpp:1111-1137), while a
feature toggle rebuilds the step and keeps accumulating into the running
film (the reference flips its globals mid-render without clearing
dev_image). The film is a tensor on the render device; the step is
rebuilt with the caller's seed, so the ray cache (key C) caches that
seed's camera rays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

ORBIT_STEP = 0.12        # radians per keypress (arrow-key mouse analog)
ZOOM_STEP = 0.4
PAN_STEP = 0.25
FOCAL_STEP = 0.5
DOF_STEP = 0.05

_TOGGLES = {
    "a": "antialias",
    "c": "ray_cache",
    "x": "enable_sss",
    "f": "compaction",
    "m": "material_sort",
    "K": "enable_kd",
    "L": "short_stack",
    "b": "use_bbox",
}

_ORBIT = {
    "LEFT": (-ORBIT_STEP, 0.0, 0.0), "RIGHT": (ORBIT_STEP, 0.0, 0.0),
    "UP": (0.0, -ORBIT_STEP, 0.0), "DOWN": (0.0, ORBIT_STEP, 0.0),
    "h": (-ORBIT_STEP, 0.0, 0.0), "l": (ORBIT_STEP, 0.0, 0.0),
    "k": (0.0, -ORBIT_STEP, 0.0), "j": (0.0, ORBIT_STEP, 0.0),
    "+": (0.0, 0.0, -ZOOM_STEP), "=": (0.0, 0.0, -ZOOM_STEP),
    "-": (0.0, 0.0, ZOOM_STEP),
}

_PAN = {
    "a": (-PAN_STEP, 0.0), "d": (PAN_STEP, 0.0),
    "w": (0.0, PAN_STEP), "s": (0.0, -PAN_STEP),
}


class KeyResult(NamedTuple):
    camera: object            # scene Camera (possibly replaced)
    config: object            # RenderConfig (possibly replaced)
    reset_film: bool          # camera changed -> restart accumulation
    recompile: bool           # config changed -> rebuild the step
    action: str               # "", "save", "quit", or a description


def apply_key(key: str, camera, config, device=None) -> KeyResult:
    """Pure controller step: one key -> (camera, config, transitions).

    Mirrors keyCallback and the runCuda camera rebuild (main.cpp:1187-1343,
    1110-1137). A moved camera is built on ``device`` (the CUDA device by
    default). Unknown keys change nothing."""
    from kdtreepathtraceroptimization_tpu_torch.ops.camera import orbit_camera, pan_camera

    # camera motion: the film restarts (camchanged)
    if key in _ORBIT:
        d_phi, d_theta, d_zoom = _ORBIT[key]
        cam = orbit_camera(camera, d_phi=d_phi, d_theta=d_theta, d_zoom=d_zoom,
                           device=device)
        return KeyResult(cam, config, True, False, f"orbit {key}")
    if key in _PAN:
        dx, dy = _PAN[key]
        return KeyResult(pan_camera(camera, dx=dx, dy=dy, device=device), config, True, False,
                         f"pan {key}")

    # lens parameters live in the config: rebuild the step, restart
    if key in ("[", "]"):
        f = max(0.5, config.focal_length + (FOCAL_STEP if key == "]" else -FOCAL_STEP))
        return KeyResult(camera, dataclasses.replace(config, focal_length=f), True, True,
                         f"focal={f:g}")
    if key in (",", "."):
        d = max(0.0, config.dof_angle + (DOF_STEP if key == "." else -DOF_STEP))
        return KeyResult(camera, dataclasses.replace(config, dof_angle=d), True, True,
                         f"dof={d:g}")

    # feature toggles keep accumulating (the reference's behaviour); K and
    # L are upper case only, so that hjkl stay orbit keys
    tk = key if key in _TOGGLES else key.lower()
    if key in ("A", "C", "X", "F", "M", "B"):
        tk = key.lower()
    if tk in _TOGGLES and (key in ("K", "L") or key not in ("k", "l")):
        field = _TOGGLES[tk]
        cfg = dataclasses.replace(config, **{field: not getattr(config, field)})
        return KeyResult(camera, cfg, False, True, f"{field}={getattr(cfg, field)}")

    if key == "S":
        return KeyResult(camera, config, False, False, "save")
    if key in ("q", "Q", "ESC"):
        return KeyResult(camera, config, False, False, "quit")
    return KeyResult(camera, config, False, False, "")


def _read_key(timeout_s: float) -> Optional[str]:
    """One key from stdin (arrow escape sequences decoded), None when none
    arrives within ``timeout_s``; end of input reads as Esc."""
    import os
    import select
    import sys

    r, _, _ = select.select([sys.stdin], [], [], timeout_s)
    if not r:
        return None
    ch = os.read(sys.stdin.fileno(), 1).decode(errors="replace")
    if ch == "\x1b":  # an escape sequence (arrows) or a bare Esc
        r, _, _ = select.select([sys.stdin], [], [], 0.01)
        if not r:
            return "ESC"
        seq = os.read(sys.stdin.fileno(), 2).decode(errors="replace")
        return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT"}.get(seq, "")
    if ch in ("", "\x04"):
        return "ESC"
    return ch


def run_interactive(scene, config, seed: int, save_fn, cols: int = 64,
                    max_iters: int = 0, device=None) -> Tuple[object, int]:
    """Render iterations continuously on ``device`` (the CUDA device by
    default), polling stdin for a key between iterations and redrawing the
    ANSI preview after each. Returns (the accumulated film [N, 3], its
    iteration count).

    ``save_fn(image_np, iteration)`` writes the averaged film ([N, 3]
    numpy). A tty is put in cbreak mode; other stdin (a pipe) is read as
    it comes, which scripts a run. ``max_iters`` > 0 saves and stops
    after that many iterations."""
    import sys
    import termios
    import tty

    import torch

    from kdtreepathtraceroptimization_tpu_torch.ops.rng import prng_key
    from kdtreepathtraceroptimization_tpu_torch.render.integrator import make_render_fn
    from kdtreepathtraceroptimization_tpu_torch.scene.parser import replace_camera
    from kdtreepathtraceroptimization_tpu_torch.utils.device import resolve_device
    from kdtreepathtraceroptimization_tpu_torch.utils.termview import live_frame

    device = resolve_device(device)
    res_x, res_y = int(scene.camera.resolution[0]), int(scene.camera.resolution[1])
    n = res_x * res_y
    camera = scene.camera
    key0 = prng_key(seed)

    def build():
        return make_render_fn(replace_camera(scene, camera), config, seed=seed, device=device)

    def save(accum, it):
        save_fn(accum.cpu().numpy() / it, it)

    is_tty = sys.stdin.isatty()
    old_attrs = None
    if is_tty:
        old_attrs = termios.tcgetattr(sys.stdin)
        tty.setcbreak(sys.stdin.fileno())
    print("interactive: arrows/hjkl orbit, +/- zoom, wasd pan, "
          "A C X F M K L B toggles, S save, q quit", flush=True)
    try:
        step = build()
        accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
        it = 0
        first = True
        while True:
            it += 1
            accum = step(accum, key0, it)
            print(live_frame(accum.cpu().numpy(), it, res_y, res_x, cols=cols, first=first),
                  end="", flush=True)
            first = False
            if max_iters and it >= max_iters:
                save(accum, it)
                return accum, it
            k = _read_key(0.0 if is_tty else 0.001)
            if not k:
                continue
            camera2, config2, reset, recompile, action = apply_key(k, camera, config, device)
            if action == "quit":
                save(accum, it)
                return accum, it
            if action == "save":
                save(accum, it)
                continue
            camera, config = camera2, config2
            if recompile or reset:
                step = build()
            if reset:
                accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
                it = 0
                first = True
            if action:
                print(f"\n[{action}]", flush=True)
    finally:
        if old_attrs is not None:
            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, old_attrs)
