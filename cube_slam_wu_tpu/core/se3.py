"""SE(3) Lie group as a batched JAX pytree.

Conventions follow the reference's bundled g2o `SE3Quat`
(object_slam/Thirdparty/g2o/g2o/types/se3quat.h):

- storage: unit quaternion (wxyz) + translation,
- tangent vectors are ordered **[omega(3), upsilon(3)]** (rotation first),
- ``exp`` maps tangent -> group with the V-matrix coupling translation to
  rotation (se3quat.h:275+), ``log`` is its inverse (se3quat.h:230-266).

All ops broadcast over leading batch dimensions and are differentiable, so
bundle-adjustment residuals can be autodiffed instead of g2o's numeric
Jacobians.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from cube_slam_wu_tpu.core import rotations as rot
from cube_slam_wu_tpu.core.precision import einsum, matmul

_EPS_THETA = 1e-8


class SE3(NamedTuple):
    """Rigid transform(s): rotation quaternion wxyz (..., 4) + translation (..., 3)."""

    quat: jnp.ndarray
    trans: jnp.ndarray

    # -- constructors -------------------------------------------------------
    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "SE3":
        q = jnp.broadcast_to(
            jnp.asarray([1.0, 0.0, 0.0, 0.0], dtype=dtype), batch_shape + (4,)
        )
        t = jnp.zeros(batch_shape + (3,), dtype=dtype)
        return SE3(q, t)

    @staticmethod
    def from_xyzq(v: jnp.ndarray) -> "SE3":
        """From TUM-format rows [x y z qx qy qz qw] (se3quat.h `fromVector`)."""
        q = jnp.stack([v[..., 6], v[..., 3], v[..., 4], v[..., 5]], axis=-1)
        return SE3(rot.quat_normalize(q), v[..., :3])

    def to_xyzq(self) -> jnp.ndarray:
        """To [x y z qx qy qz qw] rows."""
        q = self.quat
        return jnp.concatenate(
            [self.trans, jnp.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], axis=-1)],
            axis=-1,
        )

    @staticmethod
    def from_rot_trans(R: jnp.ndarray, t: jnp.ndarray) -> "SE3":
        return SE3(rot.rot_to_quat(R), t)

    @staticmethod
    def from_matrix(T: jnp.ndarray) -> "SE3":
        return SE3.from_rot_trans(T[..., :3, :3], T[..., :3, 3])

    def matrix(self) -> jnp.ndarray:
        """Homogeneous 4x4 matrix (..., 4, 4)."""
        R = rot.quat_to_rot(self.quat)
        top = jnp.concatenate([R, self.trans[..., :, None]], axis=-1)
        bottom = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), top.shape[:-2] + (1, 4)
        )
        return jnp.concatenate([top, bottom], axis=-2)

    # -- group ops ----------------------------------------------------------
    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def compose(self, other: "SE3") -> "SE3":
        """this * other (se3quat.h operator*)."""
        q = rot.quat_normalize(rot.quat_multiply(self.quat, other.quat))
        t = self.trans + rot.quat_rotate(self.quat, other.trans)
        return SE3(q, t)

    def inverse(self) -> "SE3":
        qinv = rot.quat_conjugate(self.quat)
        return SE3(qinv, -rot.quat_rotate(qinv, self.trans))

    def apply(self, pts: jnp.ndarray) -> jnp.ndarray:
        """Transform points (..., 3)."""
        return rot.quat_rotate(self.quat, pts) + self.trans

    def rotation_matrix(self) -> jnp.ndarray:
        return rot.quat_to_rot(self.quat)

    # -- Lie algebra --------------------------------------------------------
    @staticmethod
    def exp(tangent: jnp.ndarray) -> "SE3":
        """Exponential map, tangent = [omega(3), upsilon(3)] (se3quat.h:275+)."""
        omega = tangent[..., :3]
        upsilon = tangent[..., 3:6]
        dtype = tangent.dtype

        theta_sq = jnp.sum(omega * omega, axis=-1)
        theta = jnp.sqrt(theta_sq)
        small = theta < jnp.asarray(_EPS_THETA, dtype) ** 0.5
        # safe theta avoids 0/0 in both value and gradient
        th = jnp.where(small, jnp.ones_like(theta), theta)

        Om = rot.skew(omega)
        Om2 = matmul(Om, Om)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Om.shape)

        sin_t, cos_t = jnp.sin(th), jnp.cos(th)
        a = jnp.where(small, 1.0 - theta_sq / 6.0, sin_t / th)[..., None, None]
        b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - cos_t) / (th * th))[..., None, None]
        c = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (th - sin_t) / (th**3))[..., None, None]

        R = eye + a * Om + b * Om2
        V = eye + b * Om + c * Om2
        t = einsum("...ij,...j->...i", V, upsilon)
        return SE3(rot.rot_to_quat(R), t)

    def log(self) -> jnp.ndarray:
        """Logarithm map -> [omega(3), upsilon(3)] (se3quat.h:230-266)."""
        R = rot.quat_to_rot(self.quat)
        dtype = R.dtype
        d = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
        dR = jnp.stack(
            [
                R[..., 2, 1] - R[..., 1, 2],
                R[..., 0, 2] - R[..., 2, 0],
                R[..., 1, 0] - R[..., 0, 1],
            ],
            axis=-1,
        )
        near_id = d > 0.99999
        d_clip = jnp.clip(d, -1.0 + 1e-12, 1.0 - 1e-12)
        theta = jnp.arccos(d_clip)
        # omega scale: theta / (2 sin(theta)); near identity ~ 1/2
        denom = 2.0 * jnp.sqrt(jnp.clip(1.0 - d_clip * d_clip, 1e-24, None))
        scale = jnp.where(near_id, 0.5 + (1.0 - d) / 6.0, theta / denom)
        omega = scale[..., None] * dR

        Om = rot.skew(omega)
        Om2 = matmul(Om, Om)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Om.shape)
        th_safe = jnp.where(near_id, jnp.ones_like(theta), theta)
        coef = jnp.where(
            near_id,
            1.0 / 12.0,
            (1.0 - th_safe / (2.0 * jnp.tan(th_safe / 2.0))) / (th_safe * th_safe),
        )[..., None, None]
        V_inv = eye - 0.5 * Om + coef * Om2
        upsilon = einsum("...ij,...j->...i", V_inv, self.trans)
        return jnp.concatenate([omega, upsilon], axis=-1)

    # -- misc ---------------------------------------------------------------
    def astype(self, dtype) -> "SE3":
        return SE3(self.quat.astype(dtype), self.trans.astype(dtype))

    @property
    def batch_shape(self):
        return self.quat.shape[:-1]

    def __getitem__(self, idx) -> "SE3":
        return SE3(self.quat[idx], self.trans[idx])
