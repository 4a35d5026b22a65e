"""PNG output — a dependency-free writer (reference: src/image.cpp:22-45).

The port's copy of ``write_png`` from the JAX package's ``utils/image.py``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk) & 0xFFFFFFFF
    )


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as a PNG."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_png expects [H, W, 3] uint8")
    h, w = img.shape[:2]
    # Filter type 0 per scanline.
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
