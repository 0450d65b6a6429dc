"""Dataset IO: images, whitespace-separated txt tables, TUM pose files.

Covers the reference's file contracts (read_all_number_txt,
matrix_utils.cpp:209-245; the TUM-format trajectory txts and the
`x y w h prob` YOLO txts under object_slam/data/).  All readers return numpy;
conversion to device arrays happens at the pipeline boundary.
"""

from __future__ import annotations

import pathlib
import re
import struct
import zlib

import numpy as np


_PNM_TOKEN = re.compile(rb"(?:\s|#[^\n]*\n)*(\S+)")


def read_number_txt(path, min_cols: int | None = None) -> np.ndarray:
    """Whitespace table -> (rows, cols) float array; skips '#' comments and
    blank lines (read_all_number_txt semantics)."""
    rows = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append([float(tok) for tok in line.split()])
    if not rows:
        return np.zeros((0, min_cols or 0))
    width = max(len(r) for r in rows)
    out = np.zeros((len(rows), width))
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def read_pnm(path) -> np.ndarray:
    """8-bit binary PGM (P5) or PPM (P6) -> (H, W) or (H, W, 3) uint8."""
    data = pathlib.Path(path).read_bytes()
    fields, pos = [], 0
    for _ in range(4):  # magic, width, height, maxval
        m = _PNM_TOKEN.match(data, pos)
        if m is None:
            raise ValueError(f"{path}: truncated PGM/PPM header")
        fields.append(m.group(1))
        pos = m.end()
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic not in (b"P5", b"P6") or maxval > 255:
        raise ValueError(
            f"{path}: not an 8-bit binary PGM/PPM ({magic!r}, maxval {maxval})"
        )
    shape = (h, w) if magic == b"P5" else (h, w, 3)
    pixels = np.frombuffer(data, np.uint8, count=int(np.prod(shape)), offset=pos + 1)
    return pixels.reshape(shape).copy()


def write_pnm(path, img: np.ndarray) -> None:
    """(H, W) uint8 -> binary PGM; (H, W, 3) uint8 -> binary PPM."""
    img = np.ascontiguousarray(img, np.uint8)
    magic = b"P5" if img.ndim == 2 else b"P6"
    header = b"%s\n%d %d\n255\n" % (magic, img.shape[1], img.shape[0])
    pathlib.Path(path).write_bytes(header + img.tobytes())


def write_png(path, img: np.ndarray) -> None:
    """(H, W) or (H, W, 3) uint8 -> PNG, with the standard library only."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag, body):
        return (
            struct.pack(">I", len(body))
            + tag
            + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    pathlib.Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def load_image_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 of any image file: PGM/PPM with numpy, other formats
    through Pillow (an optional dependency)."""
    path = pathlib.Path(path)
    if path.suffix.lower() in (".pgm", ".ppm"):
        img = read_pnm(path)
        return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path.suffix} images needs Pillow (the optional "
            "'images' extra); PGM/PPM need nothing"
        ) from e
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def load_image_gray(path) -> np.ndarray:
    """Load an image as the rounded BT.601 grayscale float array the proposal
    engine expects (see ops.image.rgb_to_gray).  A PGM is already gray."""
    if pathlib.Path(path).suffix.lower() == ".pgm":
        img = read_pnm(path)
        if img.ndim == 2:
            return img.astype(np.float64)
    gray = load_image_rgb(path).astype(np.float64) @ np.asarray([0.299, 0.587, 0.114])
    return np.floor(gray + 0.5)


def frame_image_path(base, i: int) -> pathlib.Path:
    """raw_imgs/%04d_rgb_raw.{jpg,png,pgm} of frame i in the TUM layout
    (the first that exists; the .jpg name when none does)."""
    stem = pathlib.Path(base) / "raw_imgs" / f"{i:04d}_rgb_raw"
    for ext in (".jpg", ".png", ".pgm"):
        if stem.with_suffix(ext).exists():
            return stem.with_suffix(ext)
    return stem.with_suffix(".jpg")


def write_tum_trajectory(path, timestamps, poses_xyzq) -> None:
    """Write TUM rows `t x y z qx qy qz qw` (same schema as the reference's
    output_cam_poses.txt, main_obj.cpp:305-336)."""
    arr = np.concatenate(
        [np.asarray(timestamps)[:, None], np.asarray(poses_xyzq)], axis=1
    )
    header = "timestamp tx ty tz qx qy qz qw"
    np.savetxt(path, arr, fmt="%.6f", header=header)


def read_detections_txt(path, n_max: int | None = None):
    """Read a per-frame 2D detection file (yolo-style rows `x y w h conf`,
    the reference's filter_2d_obj_txts layout consumed by main_obj.cpp's
    online branch).

    Empty files (detector dropout — e.g. frame 20 of the bundled sequence)
    yield zero valid rows.  Returns (boxes (N, 4) float64 corners
    [x1 y1 x2 y2], conf (N,), mask (N,) bool); with `n_max` the arrays are
    padded/truncated to exactly n_max rows for fixed-shape pipelines.
    """
    rows = read_number_txt(path)
    rows = rows.reshape(-1, 5) if rows.size else np.zeros((0, 5))
    boxes = np.column_stack(
        [
            rows[:, 0],
            rows[:, 1],
            rows[:, 0] + rows[:, 2],
            rows[:, 1] + rows[:, 3],
        ]
    )
    conf = rows[:, 4]
    mask = np.ones(len(rows), bool)
    if n_max is not None:
        n = len(rows)
        if n >= n_max:
            order = np.argsort(-conf)[:n_max]  # keep highest-confidence
            boxes, conf, mask = boxes[order], conf[order], mask[order]
        else:
            pad = n_max - n
            boxes = np.vstack([boxes, np.zeros((pad, 4))])
            conf = np.concatenate([conf, np.zeros(pad)])
            mask = np.concatenate([mask, np.zeros(pad, bool)])
    return boxes, conf, mask
