"""PNG and HDR image files without an imaging library (reference:
src/image.cpp:22-45, stb_image_write).

The port's copy of the JAX package's ``utils/image.py``: an 8-bit RGB PNG
writer and reader (zlib + struct), an uncompressed Radiance RGBE ``.hdr``
writer, and the reference's output file name. The files are byte for byte
the JAX package's.
"""

from __future__ import annotations

import struct
import time
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


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG into [H, W, 3] uint8 (alpha dropped).

    A minimal decoder: bit depth 8, color types 0, 2, 4 and 6,
    non-interlaced, all five scanline filters.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = []
    w = h = None
    channels = bit_depth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if bit_depth != 8 or interlace != 0:
                raise ValueError("unsupported PNG (need 8-bit non-interlaced)")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat.append(chunk)
        elif tag == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    stride = w * channels
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(h):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride], np.uint8).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        else:  # sub/average/paeth need the running left pixel
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                if ftype == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (line[x] + ((a + b) >> 1)) & 0xFF
                elif ftype == 4:
                    c = prev[x - channels] if x >= channels else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[x] = (line[x] + pred) & 0xFF
                else:
                    raise ValueError(f"bad filter {ftype}")
        img[y] = cur.astype(np.uint8)
        prev = cur
    out = img.reshape(h, w, channels)
    if channels == 1:
        out = np.repeat(out, 3, axis=2)
    elif channels == 2:
        out = np.repeat(out[..., :1], 3, axis=2)
    elif channels == 4:
        out = out[..., :3]
    return out


def write_hdr(path: str, rgb_f32: np.ndarray) -> None:
    """Write an [H, W, 3] float image as uncompressed Radiance RGBE
    (reference saves HDR via stbi_write_hdr, image.cpp:41-45)."""
    img = np.asarray(rgb_f32, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=2)
    valid = maxc > 1e-32
    exp = np.zeros(maxc.shape, np.int32)
    mant = np.zeros(maxc.shape, np.float32)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    exp = np.where(valid, e, 0)
    scale = np.where(valid, m * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., 0] = np.clip(img[..., 0] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 1] = np.clip(img[..., 1] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 2] = np.clip(img[..., 2] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def render_filename(image_name: str, samples: int, ext: str = "png") -> str:
    """Reference-compatible output name:
    ``<FILE>.<UTC timestamp>.<N>samp.png`` (main.cpp:1100-1106)."""
    ts = time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())
    return f"{image_name}.{ts}.{samples}samp.{ext}"
