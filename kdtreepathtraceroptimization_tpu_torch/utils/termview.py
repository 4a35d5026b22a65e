"""In-terminal live render preview (ANSI truecolor half-blocks).

The port's copy of the JAX package's ``utils/termview.py``. The reference
shows convergence in a GL window updated every iteration (sendImageToPBO +
the GLFW loop, pathtrace.cu:69-89, main.cpp). A headless machine has no
display, but a terminal renders 24-bit colour: this module draws the
accumulating film as half-block characters (U+2580, foreground = upper
pixel row, background = lower pixel row — 2 image rows per text row), the
same "watch it converge" loop (``cli.py --live N``) with no dependency.
The film comes in as a host array.
"""

from __future__ import annotations

import numpy as np


def ansi_preview(img: np.ndarray, cols: int = 64) -> str:
    """[H, W, 3] float image (linear, will be gamma-mapped) -> ANSI art.

    Downsamples by integer box-filter to at most ``cols`` columns (and
    an even row count), then emits one text row per two image rows
    using truecolor escapes. Ends with a reset escape; caller positions
    the cursor.
    """
    h, w = img.shape[0], img.shape[1]
    fx = max(1, int(np.ceil(w / cols)))
    # trim to multiples of the box size, then box-filter
    hh = (h // (2 * fx)) * 2 * fx
    ww = (w // fx) * fx
    if hh == 0 or ww == 0:
        return ""
    small = (
        np.asarray(img[:hh, :ww], np.float32)
        .reshape(hh // fx, fx, ww // fx, fx, 3)
        .mean(axis=(1, 3))
    )
    if small.shape[0] % 2:
        small = small[:-1]
    # sRGB-ish tonemap to u8 (matches film.tonemap_srgb_u8's gamma)
    u8 = (np.clip(small, 0.0, 1.0) ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)
    lines = []
    for r in range(0, u8.shape[0], 2):
        top, bot = u8[r], u8[r + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def live_frame(accum: np.ndarray, iteration: int, res_y: int, res_x: int,
               cols: int = 64, first: bool = False) -> str:
    """One in-place live-view frame: the averaged film as ANSI art plus
    a status line, prefixed with a cursor-up escape so successive
    frames overdraw (``first`` skips the rewind)."""
    img = (np.asarray(accum, np.float32) / max(iteration, 1)).reshape(
        res_y, res_x, 3
    )
    art = ansi_preview(img, cols=cols)
    n_lines = art.count("\n") + 2
    rewind = "" if first else f"\x1b[{n_lines}F"
    return f"{rewind}{art}\n\x1b[2Kiter {iteration}\n"
