"""KITTI odometry dataset support.

The reference evaluates CubeSLAM on KITTI odometry (paper; README.md:3-4) but
bundles no KITTI code — detections arrive via the same `x y w h prob` txt
contract as TUM (SURVEY.md section 2.6).  This module provides the dataset
plumbing: calibration / ground-truth parsing, the axis conversion from
KITTI's camera-forward frame to the z-up world the proposal engine assumes,
and frame enumeration for the online pipeline.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np

# KITTI cam0: x right, y down, z forward.  Proposal engine world: z up.
# R maps kitti-world vectors into the z-up world.
KITTI_TO_ZUP = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]])
CAMERA_HEIGHT_M = 1.65  # nominal cam0 height above ground (KITTI setup)


class KittiSequence(NamedTuple):
    seq_dir: pathlib.Path
    K: np.ndarray  # (3, 3) left-gray intrinsics
    poses_T_wc: np.ndarray | None  # (N, 4, 4) camera-to-world (z-up), or None
    image_paths: list
    timestamps: np.ndarray  # (N,) seconds


def parse_calib(calib_path) -> np.ndarray:
    """Extract K of P0 from KITTI calib.txt (rows 'P0: <12 floats>')."""
    for line in pathlib.Path(calib_path).read_text().splitlines():
        if line.startswith("P0:"):
            vals = np.array([float(v) for v in line.split()[1:]]).reshape(3, 4)
            return vals[:, :3].copy()
    raise ValueError(f"no P0 row in {calib_path}")


def parse_poses(poses_path) -> np.ndarray:
    """KITTI ground-truth poses (N rows of 12 floats = 3x4 T_w_cam0, world =
    first camera frame) -> (N, 4, 4) camera-to-world in the z-up world with
    the camera CAMERA_HEIGHT_M above ground."""
    rows = np.loadtxt(poses_path)
    if rows.ndim == 1:
        rows = rows[None]
    n = rows.shape[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :4] = rows.reshape(n, 3, 4)
    # rotate the kitti world into z-up and lift by camera height
    R = np.eye(4)
    R[:3, :3] = KITTI_TO_ZUP
    T = R[None] @ T
    T[:, 2, 3] += CAMERA_HEIGHT_M
    return T


def load_sequence(seq_dir, poses_path=None) -> KittiSequence:
    """Load a KITTI odometry sequence directory (image_0/, times.txt,
    calib.txt; poses optionally from the odometry ground-truth file)."""
    seq_dir = pathlib.Path(seq_dir)
    K = parse_calib(seq_dir / "calib.txt")
    img_dir = seq_dir / "image_0"
    image_paths = (
        sorted([*img_dir.glob("*.png"), *img_dir.glob("*.pgm")])
        if img_dir.exists()
        else []
    )
    times_file = seq_dir / "times.txt"
    if times_file.exists():
        timestamps = np.loadtxt(times_file)
    else:
        timestamps = np.arange(len(image_paths), dtype=float) * 0.1
    poses = parse_poses(poses_path) if poses_path else None
    return KittiSequence(seq_dir, K, poses, image_paths, timestamps)


def detection_txt_path(detections_dir, frame_idx: int) -> pathlib.Path:
    """Per-frame detection txt (same `x y w h prob` contract as the TUM
    dataset's filter_2d_obj_txts)."""
    return pathlib.Path(detections_dir) / f"{frame_idx:06d}.txt"
