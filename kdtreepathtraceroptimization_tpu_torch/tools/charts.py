"""Benchmark chart generation (reference parity: presentation/*.py).

The reference turned its hand-pasted timing matrices into matplotlib
charts (presentation/benchmarks.py:383-420). This tool renders the
live sweep JSON from tools/benchmarks.py as a dependency-free SVG:
ms/iteration vs mesh size, one line per traversal mode, log-log. It is
the JAX package's ``tools/charts.py``: the same SVG from the same JSON.

Design notes (dataviz method): line chart (change over magnitude);
categorical palette in fixed slot order (validated reference palette,
adjacent-pairlist safe for lines); one axis; thin 2px lines with 8px
markers; recessive grid; text in ink tokens, identity carried by the
mark; legend + direct labels at line ends.

Usage:
    python -m kdtreepathtraceroptimization_tpu_torch.tools.charts sweep.json \
        [-o sweep.svg] [--title "..."]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

# Validated reference categorical palette, fixed slot order (light mode).
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
           "#008300", "#4a3aa7", "#e34948"]
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"
GRID = "#e4e3df"

W, H = 760, 460
ML, MR, MT, MB = 70, 150, 48, 56


def _ticks_log(lo: float, hi: float):
    out = []
    d = 10 ** math.floor(math.log10(lo))
    while d <= hi * 1.001:
        for m in (1, 2, 5):
            v = d * m
            if lo * 0.999 <= v <= hi * 1.001:
                out.append(v)
        d *= 10
    return out


def _fmt(v: float) -> str:
    if v >= 1e6:
        return f"{v/1e6:g}M"
    if v >= 1e3:
        return f"{v/1e3:g}k"
    return f"{v:g}"


def render_svg(rows, modes, title: str) -> str:
    """rows: [{tris, ms: {mode: ms|None}}]; modes in palette slot order."""
    xs = [r["tris"] for r in rows]
    ys = [v for r in rows for v in r["ms"].values() if v]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys) * 0.8, max(ys) * 1.25
    if x0 == x1:
        x0, x1 = x0 * 0.8, x1 * 1.25

    def px(v):
        return ML + (math.log10(v) - math.log10(x0)) / (
            math.log10(x1) - math.log10(x0)) * (W - ML - MR)

    def py(v):
        return H - MB - (math.log10(v) - math.log10(y0)) / (
            math.log10(y1) - math.log10(y0)) * (H - MT - MB)

    s = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
         f'viewBox="0 0 {W} {H}" font-family="system-ui, sans-serif">',
         f'<rect width="{W}" height="{H}" fill="{SURFACE}"/>',
         f'<text x="{ML}" y="26" fill="{INK}" font-size="16" '
         f'font-weight="600">{title}</text>']

    # grid + axis labels (recessive)
    for v in _ticks_log(y0, y1):
        y = py(v)
        s.append(f'<line x1="{ML}" y1="{y:.1f}" x2="{W-MR}" y2="{y:.1f}" '
                 f'stroke="{GRID}" stroke-width="1"/>')
        s.append(f'<text x="{ML-8}" y="{y+4:.1f}" fill="{INK2}" '
                 f'font-size="11" text-anchor="end">{_fmt(v)}</text>')
    for v in _ticks_log(x0, x1):
        x = px(v)
        s.append(f'<line x1="{x:.1f}" y1="{MT}" x2="{x:.1f}" y2="{H-MB}" '
                 f'stroke="{GRID}" stroke-width="1"/>')
        s.append(f'<text x="{x:.1f}" y="{H-MB+16}" fill="{INK2}" '
                 f'font-size="11" text-anchor="middle">{_fmt(v)}</text>')
    s.append(f'<text x="{(ML+W-MR)//2}" y="{H-14}" fill="{INK2}" '
             f'font-size="12" text-anchor="middle">triangles</text>')
    s.append(f'<text x="16" y="{(MT+H-MB)//2}" fill="{INK2}" font-size="12" '
             f'transform="rotate(-90 16 {(MT+H-MB)//2})" '
             f'text-anchor="middle">ms / iteration</text>')

    for i, mode in enumerate(modes):
        color = PALETTE[i % len(PALETTE)]
        pts = [(px(r["tris"]), py(r["ms"][mode]))
               for r in rows if r["ms"].get(mode)]
        if not pts:
            continue
        path = "M" + " L".join(f"{x:.1f},{y:.1f}" for x, y in pts)
        s.append(f'<path d="{path}" fill="none" stroke="{color}" '
                 f'stroke-width="2" stroke-linejoin="round"/>')
        for x, y in pts:
            s.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" '
                     f'fill="{color}" stroke="{SURFACE}" stroke-width="2"/>')
        # direct label at the line end + legend swatch
        ex, ey = pts[-1]
        s.append(f'<text x="{ex+10:.1f}" y="{ey+4:.1f}" fill="{INK}" '
                 f'font-size="12">{mode}</text>')
        ly = MT + 8 + i * 20
        s.append(f'<rect x="{W-MR+34}" y="{ly}" width="12" height="12" rx="3" '
                 f'fill="{color}"/>')
        s.append(f'<text x="{W-MR+52}" y="{ly+10}" fill="{INK}" '
                 f'font-size="12">{mode}</text>')

    s.append("</svg>")
    return "\n".join(s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sweep", help="JSON from tools/benchmarks.py --json")
    p.add_argument("-o", "--out", default=None, help="output .svg path")
    p.add_argument("--title", default="Traversal modes: ms/iteration vs mesh size")
    args = p.parse_args(argv)

    with open(args.sweep) as f:
        data = json.load(f)
    rows = data["rows"]
    modes = [m for m in rows[0]["ms"].keys()]
    svg = render_svg(rows, modes, args.title)
    out = args.out or args.sweep.rsplit(".", 1)[0] + ".svg"
    with open(out, "w") as f:
        f.write(svg)
    # table fallback (identity never color-alone)
    widths = [18] + [10] * len(modes)
    print("  ".join(h.rjust(w) for h, w in zip(["tris"] + modes, widths)))
    for r in rows:
        cells = [str(r["tris"])] + [
            f"{r['ms'][m]:.1f}" if r["ms"].get(m) else "-" for m in modes
        ]
        print("  ".join(c.rjust(w) for c, w in zip(cells, widths)))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
