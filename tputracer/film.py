"""Film / image output (SURVEY.md §2 row 12: Camera & film).

The reference accumulates into a CPU film buffer and writes BMP.  Here the
film is just the (H,W,3) mean over the spp axis computed on-device (see
integrators.pt.render_pt); this module handles host-side tonemapping and
writes PNG, BMP or PPM with the standard library alone (zlib, struct).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb(img, exposure=1.0):
    """Linear HDR -> clamped sRGB uint8."""
    x = np.asarray(img, np.float32) * exposure
    x = np.clip(x, 0.0, 1.0)
    srgb = np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag, data):
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(rgb):
    """(H,W,3) uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)    # leading filter byte = 0
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def encode_bmp(rgb):
    """(H,W,3) uint8 -> 24-bit BMP bytes (bottom-up rows, BGR, 4-byte pad)."""
    h, w, _ = rgb.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                       2835, 2835, 0, 0)
    return header + info + rows.tobytes()


def encode_ppm(rgb):
    """(H,W,3) uint8 -> binary PPM (P6) bytes."""
    h, w, _ = rgb.shape
    return f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes()


_ENCODERS = {".png": encode_png, ".bmp": encode_bmp, ".ppm": encode_ppm}


def save_image(img, path, exposure=1.0):
    """Tonemap and write by extension: .png, .bmp or .ppm."""
    ext = str(path)[str(path).rfind("."):].lower()
    if ext not in _ENCODERS:
        raise ValueError(f"unsupported image extension {ext!r} "
                         f"(one of {sorted(_ENCODERS)})")
    with open(path, "wb") as fh:
        fh.write(_ENCODERS[ext](to_srgb(img, exposure)))
    return path
