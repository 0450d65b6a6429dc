"""Camera model and projective-geometry helpers.

Batched replacement for the reference's cached camera structure
`cam_pose_infos` (detect_3d_cuboid/include/detect_3d_cuboid/detect_3d_cuboid.h:59-71,
filled in box_proposal_detail.cpp:45-56) and the ray/plane utilities in
detect_3d_cuboid/src/object_3d_util.cpp:841-925.  Everything is batched and
differentiable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from cube_slam_wu_tpu.core import rotations as rot
from cube_slam_wu_tpu.core.precision import einsum, matmul


class CameraPose(NamedTuple):
    """Cached camera pose/calibration products for proposal generation.

    Mirrors the fields of the reference `cam_pose_infos`
    (detect_3d_cuboid.h:59-71).  All members broadcast over leading batch
    dims so a whole (roll, pitch) sample grid can be represented at once.
    """

    K: jnp.ndarray  # (..., 3, 3)
    K_inv: jnp.ndarray  # (..., 3, 3)
    T_wc: jnp.ndarray  # (..., 4, 4) camera-to-world
    R_wc: jnp.ndarray  # (..., 3, 3)
    R_cw: jnp.ndarray  # (..., 3, 3) = R_wc^-1
    KinvR: jnp.ndarray  # (..., 3, 3) = K @ R_wc^-1
    euler: jnp.ndarray  # (..., 3) roll, pitch, yaw of R_wc
    projection: jnp.ndarray  # (..., 3, 4) = K @ [R|t]_cw

    @property
    def camera_yaw(self) -> jnp.ndarray:
        return self.euler[..., 2]


def make_camera_pose(K: jnp.ndarray, T_wc: jnp.ndarray) -> CameraPose:
    """Build the cached products from intrinsics + camera-to-world transform
    (reference set_cam_pose, box_proposal_detail.cpp:45-56)."""
    R_wc = T_wc[..., :3, :3]
    R_cw = jnp.swapaxes(R_wc, -1, -2)
    t_wc = T_wc[..., :3, 3]
    roll, pitch, yaw = rot.rot_to_euler_zyx(R_wc)
    K_inv = jnp.linalg.inv(K)
    # T_cw = [R_cw | -R_cw t]
    t_cw = -einsum("...ij,...j->...i", R_cw, t_wc)
    Rt_cw = jnp.concatenate([R_cw, t_cw[..., :, None]], axis=-1)
    return CameraPose(
        K=K,
        K_inv=K_inv,
        T_wc=T_wc,
        R_wc=R_wc,
        R_cw=R_cw,
        KinvR=matmul(K, R_cw),
        euler=jnp.stack([roll, pitch, yaw], axis=-1),
        projection=matmul(K, Rt_cw),
    )


def homo_to_real(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., d+1, n) -> (..., d, n) perspective division."""
    return pts[..., :-1, :] / pts[..., -1:, :]


def real_to_homo(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., d, n) -> (..., d+1, n) append ones row."""
    ones = jnp.ones_like(pts[..., :1, :])
    return jnp.concatenate([pts, ones], axis=-2)


def ray_plane_intersect(rays: jnp.ndarray, plane: jnp.ndarray) -> jnp.ndarray:
    """Intersect origin rays (..., 3, n) with plane (..., 4): returns (..., 3, n)
    (object_3d_util.cpp:841-847)."""
    denom = einsum("...i,...in->...n", plane[..., :3], rays)
    frac = -plane[..., 3:4] / denom
    return frac[..., None, :] * rays


def plane_hits_3d(
    T_wc: jnp.ndarray,
    K_inv: jnp.ndarray,
    plane_sensor: jnp.ndarray,
    pixels: jnp.ndarray,
) -> jnp.ndarray:
    """Unproject pixels (..., 2, n) onto a camera-frame plane; return world
    points (..., 3, n) (object_3d_util.cpp:853-906)."""
    pix_h = real_to_homo(pixels)
    rays = matmul(K_inv, pix_h)
    pts_sensor = ray_plane_intersect(rays, plane_sensor)
    return homo_to_real(matmul(T_wc, real_to_homo(pts_sensor)))


def wall_plane_equation(gnd_pt1: jnp.ndarray, gnd_pt2: jnp.ndarray) -> jnp.ndarray:
    """World-frame vertical plane through two ground points, normal pointing
    to the camera side (dist >= 0) (object_3d_util.cpp:909-925)."""
    up = jnp.zeros_like(gnd_pt1).at[..., 2].set(1.0)
    normal = jnp.cross(gnd_pt1 - gnd_pt2, up)
    normal = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    dist = -jnp.sum(normal * gnd_pt1, axis=-1, keepdims=True)
    plane = jnp.concatenate([normal, dist], axis=-1)
    return jnp.where(dist < 0, -plane, plane)


def ground_plane_sensor_frame(T_wc: jnp.ndarray) -> jnp.ndarray:
    """World ground plane (0,0,1,0) expressed in the sensor frame:
    g_s = T_wc^T g_w (box_proposal_detail.cpp:130-131)."""
    g_w = jnp.asarray([0.0, 0.0, 1.0, 0.0], dtype=T_wc.dtype)
    return einsum("...ji,j->...i", T_wc, g_w)
