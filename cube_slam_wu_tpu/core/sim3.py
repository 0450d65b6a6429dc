"""Sim(3) similarity transforms (rotation + translation + scale).

Covers the reference's bundled g2o Sim3 type
(object_slam/Thirdparty/g2o/g2o/types/sim3.h) used by ORB-SLAM-style loop
closing: batched JAX pytree with exp/log in the [omega(3), upsilon(3),
sigma(1)] tangent ordering, composition, inverse and point action
p -> s R p + t.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from cube_slam_wu_tpu.core import rotations as rot
from cube_slam_wu_tpu.core.precision import einsum, matmul

_EPS = 1e-7


def _sim3_W(omega: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The W matrix coupling translation to (rotation, scale) in Sim3 exp:
    t = W upsilon (Strasdat; g2o sim3.h constructor).  Batched with
    small-theta / small-sigma series guards."""
    dtype = omega.dtype
    s = jnp.exp(sigma)
    # squared-norm guard: norm() has a NaN derivative at omega == 0, which
    # poisons jacfwd at the zero tangent (the LM linearisation point);
    # sqrt of the where-guarded square is smooth on both branches
    theta2 = jnp.sum(omega * omega, axis=-1)
    small_t = theta2 < _EPS * _EPS
    small_s = jnp.abs(sigma) < _EPS
    th = jnp.sqrt(jnp.where(small_t, 1.0, theta2))
    sg = jnp.where(small_s, 1.0, sigma)

    Om = rot.skew(omega)
    Om2 = matmul(Om, Om)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Om.shape)

    C = jnp.where(small_s, 1.0, (s - 1.0) / sg)
    A_ss = jnp.where(small_t, 0.5, (1.0 - jnp.cos(th)) / th**2)
    # general case (Strasdat's closed form): A = (a*sigma + (1-b)*theta) /
    # (theta*(sigma^2+theta^2)) with a = s*sin(theta), b = s*cos(theta);
    # validated against a brute-force 4x4 matrix exponential in
    # tests/test_sim3.py (an earlier version swapped sigma/theta in the
    # numerator, which diverges as theta -> 0 and made exp()'s translation
    # wrong for every sigma != 0)
    A_gs = (s * jnp.sin(th) * sg + (1.0 - s * jnp.cos(th)) * th) / (
        th * (sg**2 + th**2)
    )
    A_gt = ((sg - 1.0) * s + 1.0) / sg**2
    A = jnp.where(small_s, A_ss, jnp.where(small_t, A_gt, A_gs))

    B_ss = jnp.where(small_t, 1.0 / 6.0, (th - jnp.sin(th)) / th**3)
    B_gs = (
        C - ((s * jnp.cos(th) - 1.0) * sg + s * jnp.sin(th) * th) / (sg**2 + th**2)
    ) / th**2
    B_gt = (s * (0.5 * sg**2 - sg + 1.0) - 1.0) / sg**3
    B = jnp.where(small_s, B_ss, jnp.where(small_t, B_gt, B_gs))

    return (
        C[..., None, None] * eye
        + A[..., None, None] * Om
        + B[..., None, None] * Om2
    )


class Sim3(NamedTuple):
    quat: jnp.ndarray  # (..., 4) wxyz
    trans: jnp.ndarray  # (..., 3)
    scale: jnp.ndarray  # (...,)

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "Sim3":
        q = jnp.broadcast_to(
            jnp.asarray([1.0, 0, 0, 0], dtype=dtype), batch_shape + (4,)
        )
        return Sim3(
            q, jnp.zeros(batch_shape + (3,), dtype), jnp.ones(batch_shape, dtype)
        )

    def apply(self, pts: jnp.ndarray) -> jnp.ndarray:
        return self.scale[..., None] * rot.quat_rotate(self.quat, pts) + self.trans

    def compose(self, other: "Sim3") -> "Sim3":
        q = rot.quat_normalize(rot.quat_multiply(self.quat, other.quat))
        t = self.scale[..., None] * rot.quat_rotate(self.quat, other.trans) + self.trans
        return Sim3(q, t, self.scale * other.scale)

    def inverse(self) -> "Sim3":
        qinv = rot.quat_conjugate(self.quat)
        s_inv = 1.0 / self.scale
        t = -s_inv[..., None] * rot.quat_rotate(qinv, self.trans)
        return Sim3(qinv, t, s_inv)

    @staticmethod
    def exp(tangent: jnp.ndarray) -> "Sim3":
        """tangent = [omega(3), upsilon(3), sigma(1)]; sigma = log scale."""
        omega = tangent[..., :3]
        upsilon = tangent[..., 3:6]
        sigma = tangent[..., 6]
        dtype = tangent.dtype

        # squared-norm guard (see _sim3_W): keeps jacfwd finite at omega == 0
        theta2 = jnp.sum(omega * omega, axis=-1)
        small_t = theta2 < _EPS * _EPS
        th = jnp.sqrt(jnp.where(small_t, 1.0, theta2))
        Om = rot.skew(omega)
        Om2 = matmul(Om, Om)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Om.shape)
        a = jnp.where(small_t, 1.0 - theta2 / 6.0, jnp.sin(th) / th)
        b = jnp.where(small_t, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(th)) / th**2)
        R = eye + a[..., None, None] * Om + b[..., None, None] * Om2

        W = _sim3_W(omega, sigma)
        t = einsum("...ij,...j->...i", W, upsilon)
        return Sim3(rot.rot_to_quat(R), t, jnp.exp(sigma))

    def log(self) -> jnp.ndarray:
        sigma = jnp.log(self.scale)
        R = rot.quat_to_rot(self.quat)
        d = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
        dR = jnp.stack(
            [
                R[..., 2, 1] - R[..., 1, 2],
                R[..., 0, 2] - R[..., 2, 0],
                R[..., 1, 0] - R[..., 0, 1],
            ],
            axis=-1,
        )
        near = d > 0.99999
        d_c = jnp.clip(d, -1 + 1e-12, 1 - 1e-12)
        theta = jnp.arccos(d_c)
        denom = 2.0 * jnp.sqrt(jnp.clip(1 - d_c * d_c, 1e-24, None))
        omega = jnp.where(near, 0.5 + (1 - d) / 6.0, theta / denom)[..., None] * dR
        W = _sim3_W(omega, sigma)
        upsilon = jnp.linalg.solve(W, self.trans[..., :, None])[..., 0]
        return jnp.concatenate([omega, upsilon, sigma[..., None]], axis=-1)
