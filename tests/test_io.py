"""Image IO without Pillow: PGM/PPM read/write, the stdlib PNG writer, and
the TUM frame lookup the fused driver uses."""

import struct
import sys
import zlib

import numpy as np
import pytest

from cube_slam_wu_tpu.utils import io as uio


@pytest.mark.parametrize("shape", [(7, 5), (4, 6, 3)], ids=["pgm", "ppm"])
def test_pnm_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / ("a.pgm" if len(shape) == 2 else "a.ppm")
    uio.write_pnm(path, img)
    np.testing.assert_array_equal(uio.read_pnm(path), img)


def test_pnm_header_comments_and_rejects_16bit(tmp_path):
    path = tmp_path / "d.pgm"
    path.write_bytes(b"P5\n# made by hand\n2 1\n255\n\x07\xfe")
    np.testing.assert_array_equal(uio.read_pnm(path), [[7, 254]])
    path.write_bytes(b"P5\n2 1\n65535\n" + bytes(4))
    with pytest.raises(ValueError, match="8-bit"):
        uio.read_pnm(path)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's own output (8-bit, filter 0)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert depth == 8
    ch = 1 if ctype == 0 else 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape((h, w) if ch == 1 else (h, w, 3))


@pytest.mark.parametrize("shape", [(9, 11), (5, 3, 3)], ids=["gray", "rgb"])
def test_png_writer_decodes(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    uio.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(_decode_png((tmp_path / "a.png").read_bytes()), img)


def test_load_image_gray_without_pillow(tmp_path, monkeypatch):
    """PGM/PPM frames load with Pillow absent; other formats raise a clear
    ImportError instead of failing deep inside."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    gray = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    uio.write_pnm(tmp_path / "g.pgm", gray)
    np.testing.assert_array_equal(uio.load_image_gray(tmp_path / "g.pgm"), gray)
    rgb = np.stack([gray, gray // 2, 255 - gray], axis=-1)
    uio.write_pnm(tmp_path / "c.ppm", rgb)
    expect = np.floor(rgb.astype(np.float64) @ [0.299, 0.587, 0.114] + 0.5)
    np.testing.assert_array_equal(uio.load_image_gray(tmp_path / "c.ppm"), expect)
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ImportError, match="Pillow"):
        uio.load_image_gray(tmp_path / "x.jpg")


def test_frame_image_path_finds_each_format(tmp_path):
    (tmp_path / "raw_imgs").mkdir()
    assert uio.frame_image_path(tmp_path, 3).name == "0003_rgb_raw.jpg"
    uio.write_pnm(tmp_path / "raw_imgs" / "0003_rgb_raw.pgm", np.zeros((2, 2), np.uint8))
    assert uio.frame_image_path(tmp_path, 3).name == "0003_rgb_raw.pgm"
    uio.write_png(tmp_path / "raw_imgs" / "0003_rgb_raw.png", np.zeros((2, 2), np.uint8))
    assert uio.frame_image_path(tmp_path, 3).name == "0003_rgb_raw.png"


def test_cli_imports_without_pillow():
    """The CLI and the fused driver import in a process where PIL cannot."""
    import subprocess

    code = (
        "import sys; sys.modules['PIL'] = None; "
        "import cube_slam_wu_tpu.cli, cube_slam_wu_tpu.slam.online, "
        "cube_slam_wu_tpu.utils.synth; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
