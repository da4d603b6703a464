"""Image writers: PPM, BMP and PNG decoded back with the standard library
(no Pillow), and the package importable without flax or Pillow."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from tputracer.film import save_image, to_srgb

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _img():
    return np.random.default_rng(0).uniform(0, 1.2, (8, 6, 3)).astype("f4")


def _decode_bmp(raw):
    assert raw[:2] == b"BM"
    off = struct.unpack("<I", raw[10:14])[0]
    w, h = struct.unpack("<ii", raw[18:26])
    assert struct.unpack("<H", raw[28:30])[0] == 24
    stride = (3 * w + 3) & ~3
    rows = np.frombuffer(raw[off:off + stride * h], np.uint8)
    rows = rows.reshape(h, stride)[:, :3 * w].reshape(h, w, 3)
    return rows[::-1, :, ::-1]                 # bottom-up BGR -> RGB


def _decode_png(raw):
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(raw):
        n = struct.unpack(">I", raw[pos:pos + 4])[0]
        tag, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + data
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()             # filter type 0 everywhere
    return rows[:, 1:].reshape(h, w, 3)


def test_ppm_and_bmp_output(tmp_path):
    """Reference-class writers (PPM/BMP), decoded with the stdlib."""
    img = _img()
    p = save_image(img, str(tmp_path / "o.ppm"))
    raw = open(p, "rb").read()
    assert raw.startswith(b"P6\n6 8\n255\n")
    body = raw.split(b"255\n", 1)[1]
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(8, 6, 3), to_srgb(img))

    b = save_image(img, str(tmp_path / "o.bmp"))
    np.testing.assert_array_equal(_decode_bmp(open(b, "rb").read()),
                                  to_srgb(img))


@pytest.mark.parametrize("shape", [(8, 6, 3), (1, 1, 3), (5, 17, 3)])
def test_png_roundtrip_stdlib(tmp_path, shape):
    """The stdlib PNG writer: chunks, CRCs, header and every pixel."""
    img = np.random.default_rng(1).uniform(0, 1.0, shape).astype("f4")
    p = save_image(img, str(tmp_path / "o.png"), exposure=1.5)
    np.testing.assert_array_equal(_decode_png(open(p, "rb").read()),
                                  to_srgb(img, 1.5))


def test_unknown_extension_refused(tmp_path):
    with pytest.raises(ValueError, match="unsupported image extension"):
        save_image(_img(), str(tmp_path / "o.jpg"))


def test_import_and_cli_without_flax_or_pillow(tmp_path):
    """``import tputracer`` and a CLI render work where flax and Pillow
    are not installed (both are blocked from import here)."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "PIL"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import tputracer
from tputracer.cli import main
main(["--scene", "spheres", "--size", "8", "--spp", "1", "--bounces", "1",
      "--out", {str(tmp_path / "o.png")!r}])
assert "flax" not in sys.modules and "PIL" not in sys.modules
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"mean"' in out.stdout
    assert _decode_png(open(tmp_path / "o.png", "rb").read()).shape == \
        (8, 8, 3)
