"""Joint camera-object-point bundle adjustment with Schur complement.

Covers the reference's point-landmark machinery: g2o's SBA point vertices and
mono projection edges (Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:145-175,
types_sba.{h,cpp}) and the Schur-complement block solver
(g2o/core/block_solver.h) — re-designed as dense batched tensor algebra:

- observations live in a dense (F frames x P points) raster with a mask
  (variable-count observations become fixed-shape + mask, as everywhere in
  this framework),
- per-observation 2x6 pose and 2x3 point Jacobians come from vmapped
  forward-mode autodiff of the single-projection residual (exact, replaces
  g2o's numeric differentiation),
- the normal equations are reduced over points with the classic Schur
  complement, assembled as batched einsums:
      H_red = H_cc - sum_p W_p Hpp_p^-1 W_p^T,
  then a dense Cholesky solve for cameras and batched 3x3 back-substitution
  for points,
- the LM damping schedule matches slam.ba.optimize.

The camera-object edges of the cuboid graph are folded into the same reduced
system, so this is the full CubeSLAM objective: odometry + cuboid + point
reprojection.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.precision import einsum, matmul
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam.ba import BAResult, _apply_increments, _residual_vector
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph


class PointFactors(NamedTuple):
    """Point landmarks + dense observation raster.

    points: (P, 3) world positions; obs_uv: (F, P, 2) pixel observations;
    obs_mask: (F, P) validity; obs_weight: (F, P) sqrt-information.

    Stereo (g2o EdgeStereoSE3ProjectXYZ, types_six_dof_expmap.h:217-270):
    obs_ur (F, P) right-camera u observations with stereo_mask; `baseline`
    is fx*b in pixels.  Stereo rows add a third residual
    u_r_pred = u - baseline/z.
    """

    points: jnp.ndarray
    point_mask: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_mask: jnp.ndarray
    obs_weight: jnp.ndarray
    obs_ur: jnp.ndarray | None = None  # (F, P) right-image u
    stereo_mask: jnp.ndarray | None = None  # (F, P)
    baseline: float = 0.0  # fx * b (pixels)

    @staticmethod
    def empty(n_frames: int, n_points: int, dtype=jnp.float64) -> "PointFactors":
        return PointFactors(
            points=jnp.zeros((n_points, 3), dtype),
            point_mask=jnp.zeros((n_points,), bool),
            obs_uv=jnp.zeros((n_frames, n_points, 2), dtype),
            obs_mask=jnp.zeros((n_frames, n_points), bool),
            obs_weight=jnp.ones((n_frames, n_points), dtype),
        )


def project_point(Tcw: SE3, X: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """World point -> pixel (EdgeSE3ProjectXYZ cam_project semantics)."""
    pc = Tcw.apply(X)
    z = jnp.maximum(pc[..., 2], 1e-9)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return jnp.stack([u, v], axis=-1)


def project_point_stereo(
    Tcw: SE3, X: jnp.ndarray, K: jnp.ndarray, baseline: float
) -> jnp.ndarray:
    """World point -> (u, v, u_right) (EdgeStereoSE3ProjectXYZ cam_project,
    types_six_dof_expmap.h:217-270); baseline = fx*b in pixels."""
    pc = Tcw.apply(X)
    z = jnp.maximum(pc[..., 2], 1e-9)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return jnp.stack([u, v, u - baseline / z], axis=-1)


def _obs_residual(d_pose, d_point, Tcw0: SE3, X0, uv, K):
    """Residual of one observation as a function of local increments
    (left-multiplicative pose update, additive point update)."""
    Tcw = SE3.exp(d_pose).compose(Tcw0)
    X = X0 + d_point
    return uv - project_point(Tcw, X, K)


def _obs_residual_stereo(d_pose, d_point, Tcw0: SE3, X0, uvr, K, baseline):
    Tcw = SE3.exp(d_pose).compose(Tcw0)
    X = X0 + d_point
    return uvr - project_point_stereo(Tcw, X, K, baseline)


@jax.jit
def triangulate_points(
    cam_Tcw: SE3, obs_uv: jnp.ndarray, obs_mask: jnp.ndarray, K: jnp.ndarray
):
    """Batched DLT triangulation.

    cam_Tcw (F,), obs_uv (F, P, 2), obs_mask (F, P) -> (points (P, 3),
    ok (P,)).  Classic homogeneous linear system u*(p3.X) - p1.X = 0 per
    observation; smallest eigenvector of the masked normal matrix.  Validity:
    >= 2 observations and positive depth in every observing frame."""
    F = obs_uv.shape[0]
    R = cam_Tcw.rotation_matrix()  # (F, 3, 3)
    t = cam_Tcw.trans  # (F, 3)
    P = matmul(K, jnp.concatenate([R, t[..., None]], axis=-1))  # (F, 3, 4)

    u = obs_uv[..., 0]
    v = obs_uv[..., 1]
    # rows: u * P3 - P1, v * P3 - P2  -> (F, P_pts, 2, 4)
    rows = jnp.stack(
        [
            u[..., None] * P[:, None, 2, :] - P[:, None, 0, :],
            v[..., None] * P[:, None, 2, :] - P[:, None, 1, :],
        ],
        axis=2,
    )
    rows = jnp.where(obs_mask[..., None, None], rows, 0.0)
    A = rows.transpose(1, 0, 2, 3).reshape(-1, F * 2, 4)  # (P_pts, 2F, 4)
    N = einsum("pij,pik->pjk", A, A)  # (P_pts, 4, 4)
    _, vecs = jnp.linalg.eigh(N)
    X_h = vecs[..., 0]  # smallest eigenvector
    w = X_h[..., 3]
    w_safe = jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
    X = X_h[..., :3] / w_safe[..., None]

    # positive depth in all observing frames
    pc_z = einsum("fj,pj->fp", R[:, 2, :], X) + t[:, 2][:, None]
    depth_ok = jnp.all(jnp.where(obs_mask, pc_z > 0.1, True), axis=0)
    n_obs = jnp.sum(obs_mask, axis=0)
    ok = (n_obs >= 2) & depth_ok & jnp.all(jnp.isfinite(X), axis=-1)
    return X, ok


class PointBAResult(NamedTuple):
    cam_Tcw: SE3
    cube: Cuboid
    points: jnp.ndarray
    chi2: jnp.ndarray
    lambda_final: jnp.ndarray


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "fix_first", "robust_delta", "point_huber"),
)
def optimize(
    graph: CameraObjectGraph,
    pts: PointFactors,
    K: jnp.ndarray,
    iterations: int = 5,
    fix_first: bool = True,
    robust_delta: float | None = None,
    prior=None,
    point_huber: float | None = None,
) -> PointBAResult:
    """LM over cameras + cuboid + points with Schur reduction over points.

    `robust_delta` / `prior` apply to the graph part exactly as in
    slam.ba.optimize (Huber on odometry/cuboid/bbox edges; sliding-window
    CubePrior on the landmarks), so this solver can serve as the windowed
    incremental back-end.  `point_huber` (pixels) puts a Huber kernel on
    each point reprojection residual (g2o RobustKernelHuber semantics,
    differentiated through like slam.ba._huber_scale)."""
    F = graph.capacity
    P = pts.points.shape[0]
    dtype = graph.cam_Tcw.trans.dtype
    n_c = F * 6 + graph.n_objects * 9  # camera + cuboid block size
    eye9 = jnp.eye(3, dtype=dtype)

    zeros6 = jnp.zeros((6,), dtype)
    zeros3 = jnp.zeros((3,), dtype)

    stereo = pts.obs_ur is not None
    if stereo:
        obs_ur = pts.obs_ur
        stereo_mask = pts.stereo_mask
        if stereo_mask is None:
            stereo_mask = jnp.ones(obs_ur.shape, bool)
    else:
        obs_ur = jnp.zeros(pts.obs_mask.shape, dtype)
        stereo_mask = jnp.zeros(pts.obs_mask.shape, bool)

    def point_terms(cam_Tcw: SE3, points: jnp.ndarray):
        """Per-observation residuals + Jacobians, masked.

        Mono: r (F, P, 2); stereo: r (F, P, 3) with the third row (right-u)
        gated by stereo_mask.  A: pose Jacobians, B: point Jacobians."""

        def per_obs(Tcw_f, X_p, uv, ur, w, m, sm):
            if stereo:
                uvr = jnp.concatenate([uv, ur[None]])
                raw_fn = lambda dp, dx: _obs_residual_stereo(
                    dp, dx, Tcw_f, X_p, uvr, K, pts.baseline
                )
                row_mask = jnp.stack([m, m, m & sm])
            else:
                raw_fn = lambda dp, dx: _obs_residual(dp, dx, Tcw_f, X_p, uv, K)
                row_mask = jnp.stack([m, m])
            if point_huber is not None:
                from cube_slam_wu_tpu.slam.ba import _huber_scale

                res_fn = lambda dp, dx: _huber_scale(
                    raw_fn(dp, dx), point_huber
                )
            else:
                res_fn = raw_fn
            r = res_fn(zeros6, zeros3)
            A = jax.jacfwd(lambda d: res_fn(d, zeros3))(zeros6)
            B = jax.jacfwd(lambda d: res_fn(zeros6, d))(zeros3)
            scale = jnp.where(row_mask, w, 0.0)
            return r * scale, A * scale[:, None], B * scale[:, None]

        per_point = jax.vmap(per_obs, in_axes=(None, 0, 0, 0, 0, 0, 0))
        per_frame = jax.vmap(per_point, in_axes=(0, None, 0, 0, 0, 0, 0))
        return per_frame(
            cam_Tcw, points, pts.obs_uv, obs_ur, pts.obs_weight, pts.obs_mask, stereo_mask
        )

    frame_gate = graph.frame_mask.astype(dtype)
    if fix_first:
        frame_gate = frame_gate * (jnp.arange(F) != 0)
    point_gate = pts.point_mask.astype(dtype)

    def build_system(g: CameraObjectGraph, points: jnp.ndarray):
        # --- graph part (odometry + cuboid + bbox + prior): dense autodiff --
        zero_c = jnp.zeros((n_c,), dtype)
        r_g = _residual_vector(g, zero_c, fix_first, robust_delta, prior)
        J_g = jax.jacfwd(
            lambda dx: _residual_vector(g, dx, fix_first, robust_delta, prior)
        )(zero_c)
        H_cc = matmul(J_g.T, J_g)
        g_c = matmul(J_g.T, r_g)
        chi2 = jnp.sum(r_g * r_g)

        # --- point part -----------------------------------------------------
        r, A, B = point_terms(g.cam_Tcw, points)
        A = A * frame_gate[:, None, None, None]
        B = B * point_gate[None, :, None, None]
        chi2 = chi2 + jnp.sum(r * r)

        # camera-block contributions (block-diagonal over frames)
        H_cc_pts = einsum("fpki,fpkj->fij", A, A)  # (F, 6, 6)
        idx = jnp.arange(F * 6).reshape(F, 6)
        H_cc = H_cc.at[idx[:, :, None], idx[:, None, :]].add(H_cc_pts)
        g_c = g_c.at[idx.reshape(-1)].add(
            einsum("fpki,fpk->fi", A, r).reshape(-1)
        )

        # point blocks
        H_pp = einsum("fpki,fpkj->pij", B, B) + 1e-12 * eye9  # (P, 3, 3)
        g_p = einsum("fpki,fpk->pi", B, r)  # (P, 3)
        W = einsum("fpki,fpkj->pfij", A, B)  # (P, F, 6, 3)
        return H_cc, g_c, H_pp, g_p, W, chi2

    def chi2_of(g: CameraObjectGraph, points: jnp.ndarray):
        zero_c = jnp.zeros((n_c,), dtype)
        r_g = _residual_vector(g, zero_c, fix_first, robust_delta, prior)
        r, _, _ = point_terms(g.cam_Tcw, points)
        return jnp.sum(r_g * r_g) + jnp.sum(r * r)

    def solve(H_cc, g_c, H_pp, g_p, W, lam):
        # damp
        H_cc_d = H_cc + lam * jnp.eye(n_c, dtype=dtype)
        H_pp_d = H_pp + lam * eye9[None]
        Hpp_inv = jnp.linalg.inv(H_pp_d)  # (P, 3, 3) batched
        # Schur: H_red = H_cc - sum_p W_p Hpp^-1 W_p^T over the camera rows
        WHi = einsum("pfij,pjk->pfik", W, Hpp_inv)  # (P, F, 6, 3)
        red = einsum("pfik,pgjk->figj", WHi, W).reshape(F * 6, F * 6)
        H_red = H_cc_d.at[: F * 6, : F * 6].add(-red)
        g_red = g_c.at[: F * 6].add(
            -einsum("pfik,pk->fi", WHi, g_p).reshape(-1)
        )
        dx_c = -jnp.linalg.solve(H_red, g_red)
        # back-substitute points: dx_p = -Hpp^-1 (g_p + W^T dx_c)
        dxc_cam = dx_c[: F * 6].reshape(F, 6)
        Wt_dx = einsum("pfij,fi->pj", W, dxc_cam)
        dx_p = -einsum("pij,pj->pi", Hpp_inv, g_p + Wt_dx)
        return dx_c, dx_p

    def apply(g: CameraObjectGraph, points, dx_c, dx_p):
        cam_new, cube_new = _apply_increments(g, dx_c, fix_first)
        pts_new = points + dx_p * point_gate[:, None]
        return g._replace(cam_Tcw=cam_new, cube=cube_new), pts_new

    chi2_0 = chi2_of(graph, pts.points)
    H_cc0, *_ = build_system(graph, pts.points)
    lam0 = jnp.maximum(1e-5 * jnp.max(jnp.abs(jnp.diag(H_cc0))), 1e-12)

    def step(state, _):
        g, points, lam, ni, chi2 = state
        H_cc, g_c, H_pp, g_p, W, chi2_cur = build_system(g, points)
        dx_c, dx_p = solve(H_cc, g_c, H_pp, g_p, W, lam)
        g_new, pts_new = apply(g, points, dx_c, dx_p)
        chi2_new = chi2_of(g_new, pts_new)
        pred = matmul(dx_c, lam * dx_c - g_c) + jnp.sum(dx_p * (lam * dx_p - g_p))
        rho = (chi2_cur - chi2_new) / jnp.maximum(jnp.abs(pred), 1e-30)
        accept = (rho > 0) & jnp.isfinite(chi2_new)
        lam_next = jnp.where(
            accept,
            lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            lam * ni,
        )
        ni_next = jnp.where(accept, 2.0, ni * 2.0)
        g_out = jax.tree.map(lambda a, b: jnp.where(accept, a, b), g_new, g)
        pts_out = jnp.where(accept, pts_new, points)
        return (g_out, pts_out, lam_next, ni_next, jnp.where(accept, chi2_new, chi2_cur)), None

    init = (graph, pts.points, lam0, jnp.asarray(2.0, dtype), chi2_0)
    (g_fin, pts_fin, lam_fin, _, chi2_fin), _ = jax.lax.scan(
        step, init, None, length=iterations
    )
    return PointBAResult(
        cam_Tcw=g_fin.cam_Tcw,
        cube=g_fin.cube,
        points=pts_fin,
        chi2=chi2_fin,
        lambda_final=lam_fin,
    )
