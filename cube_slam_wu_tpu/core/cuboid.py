"""9-DoF cuboid landmark: SE(3) pose + per-axis half-extents.

Re-designs the reference back-end cuboid state `g2o::cuboid`
(object_slam/include/object_slam/g2o_Object.h:23-199) as a batched JAX
pytree.  The update rule, error definitions (including the 4-way yaw
disambiguation of `min_log_error`, g2o_Object.h:76-101) and the corner /
projection geometry match the reference's semantics; the implementation is
branch-free so it can be vmapped over landmarks and jitted inside the bundle
adjuster.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from cube_slam_wu_tpu.core import rotations as rot
from cube_slam_wu_tpu.core.precision import matmul
from cube_slam_wu_tpu.core.se3 import SE3

# Unit-cube corner table, columns are corners 1..8 (g2o_Object.h:169-171).
# Kept as a host constant: a module-level jnp.asarray would initialise the
# XLA backend at import time, which breaks jax.distributed.initialize's
# initialize-before-any-JAX-call requirement in multi-process workers
# (parallel/multihost.py).
import numpy as _np

_CORNERS_BODY = _np.asarray(
    [
        [1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0],
        [1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0],
        [-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0],
    ]
)


class Cuboid(NamedTuple):
    """Cuboid(s): object-to-world pose + half-extents [l, w, h] (..., 3)."""

    pose: SE3
    scale: jnp.ndarray

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_minimal(v: jnp.ndarray) -> "Cuboid":
        """From [x y z roll pitch yaw l w h] (g2o_Object.h:37-42)."""
        q = rot.euler_zyx_to_quat(v[..., 3], v[..., 4], v[..., 5])
        return Cuboid(SE3(q, v[..., :3]), v[..., 6:9])

    def to_minimal(self) -> jnp.ndarray:
        roll, pitch, yaw = rot.quat_to_euler_zyx(self.pose.quat)
        return jnp.concatenate(
            [self.pose.trans, jnp.stack([roll, pitch, yaw], axis=-1), self.scale],
            axis=-1,
        )

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Cuboid":
        return Cuboid(
            SE3.identity(batch_shape, dtype), jnp.zeros(batch_shape + (3,), dtype)
        )

    # -- state update & errors ---------------------------------------------
    def exp_update(self, update: jnp.ndarray) -> "Cuboid":
        """Right-multiplicative SE3 update + additive scale (g2o_Object.h:57-63)."""
        return Cuboid(
            self.pose.compose(SE3.exp(update[..., :6])),
            self.scale + update[..., 6:9],
        )

    def log_error(self, other: "Cuboid") -> jnp.ndarray:
        """9-d error [se3 log of other^-1*self, self.scale - other.scale]
        (g2o_Object.h:66-73)."""
        pose_diff = other.pose.inverse().compose(self.pose)
        return jnp.concatenate([pose_diff.log(), self.scale - other.scale], axis=-1)

    def rotate(self, yaw_angle: float) -> "Cuboid":
        """Re-pick the front face by rotating about body z; +-90deg swaps l/w
        (g2o_Object.h:104-114).  `yaw_angle` is a static python float."""
        q = rot.quat_from_yaw(jnp.asarray(yaw_angle, dtype=self.scale.dtype))
        new_pose = SE3(
            rot.quat_normalize(rot.quat_multiply(self.pose.quat, jnp.broadcast_to(q, self.pose.quat.shape))),
            self.pose.trans,
        )
        swap = abs(abs(float(yaw_angle)) - jnp.pi / 2) < 1e-9 or abs(float(yaw_angle) - 3 * jnp.pi / 2) < 1e-9
        scale = self.scale[..., jnp.asarray([1, 0, 2])] if swap else self.scale
        return Cuboid(new_pose, scale)

    def min_log_error(self, other: "Cuboid") -> jnp.ndarray:
        """Min-norm 9-d error over 4 front-face choices of `other`
        (rotations -90/0/90/180 deg about z; g2o_Object.h:76-101)."""
        angles = (-jnp.pi / 2, 0.0, jnp.pi / 2, jnp.pi)
        errs = jnp.stack([self.log_error(other.rotate(a)) for a in angles], axis=-2)
        norms = jnp.linalg.norm(errs, axis=-1)
        best = jnp.argmin(norms, axis=-1)
        return jnp.take_along_axis(errs, best[..., None, None].repeat(9, axis=-1), axis=-2)[..., 0, :]

    # -- frame changes ------------------------------------------------------
    def transform_from(self, Twc: SE3) -> "Cuboid":
        """Camera-frame cuboid -> world-frame, Twc = camera-to-world."""
        pose = Twc.compose(self.pose)
        scale = jnp.broadcast_to(self.scale, pose.batch_shape + (3,))
        return Cuboid(pose, scale)

    def transform_to(self, Twc: SE3) -> "Cuboid":
        """World-frame cuboid -> camera-frame."""
        pose = Twc.inverse().compose(self.pose)
        scale = jnp.broadcast_to(self.scale, pose.batch_shape + (3,))
        return Cuboid(pose, scale)

    # -- geometry -----------------------------------------------------------
    def corners_3d(self) -> jnp.ndarray:
        """World-frame corners (..., 3, 8) (g2o_Object.h:165-178)."""
        body = jnp.asarray(_CORNERS_BODY, self.scale.dtype)
        scaled = self.scale[..., :, None] * body  # (..., 3, 8)
        R = self.pose.rotation_matrix()
        return matmul(R, scaled) + self.pose.trans[..., :, None]

    def project_bbox(self, Tcw: SE3, K: jnp.ndarray) -> jnp.ndarray:
        """Project corners with world-to-camera pose Tcw and intrinsics K,
        return [cx, cy, w, h] of the bounding rectangle (g2o_Object.h:181-197)."""
        corners_w = self.corners_3d()  # (..., 3, 8)
        corners_c = (
            matmul(Tcw.rotation_matrix(), corners_w) + Tcw.trans[..., :, None]
        )
        uvw = matmul(K, corners_c)
        uv = uvw[..., :2, :] / uvw[..., 2:3, :]
        top_left = jnp.min(uv, axis=-1)
        bottom_right = jnp.max(uv, axis=-1)
        center = 0.5 * (top_left + bottom_right)
        wh = bottom_right - top_left
        return jnp.concatenate([center, wh], axis=-1)

    def astype(self, dtype) -> "Cuboid":
        return Cuboid(self.pose.astype(dtype), self.scale.astype(dtype))
