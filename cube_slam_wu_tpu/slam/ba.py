"""Levenberg-Marquardt bundle adjustment over the camera-object graph.

Replaces the bundled g2o optimizer stack (SparseOptimizer + BlockSolverX +
LinearSolverDense + OptimizationAlgorithmLevenberg,
object_slam/src/main_obj.cpp:510-519 and Thirdparty/g2o core) with a dense
JAX LM solver:

- Jacobians come from forward-mode autodiff of the residuals with respect to
  tangent-space increments evaluated at zero (g2o numerically differentiates
  the same local parameterisation, base_binary_edge.h);
- the normal equations are dense and solved by one Cholesky — the
  problem size (F*6+9 for F frames) is tiny per chip, and the multi-chip
  path (parallel/sharded_ba.py) reduces per-block Hessians with psum;
- the damping schedule mirrors g2o's Levenberg implementation
  (optimization_algorithm_levenberg.cpp): lambda_0 = 1e-5 * max diag(H),
  accept -> lambda *= max(1/3, 1-(2*rho-1)^3), reject -> lambda *= 2.

Everything is fixed-shape and jit-compatible; masked-out frames contribute
zero residuals and zero Jacobian columns (their increments stay zero because
the damped system is then block-diagonal lambda*I).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.precision import matmul
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph, graph_residuals


class BAResult(NamedTuple):
    cam_Tcw: SE3
    cube: Cuboid
    chi2: jnp.ndarray
    lambda_final: jnp.ndarray


def _apply_increments(graph: CameraObjectGraph, dx: jnp.ndarray, fix_first: bool):
    """Map a stacked tangent increment onto (poses, cubes).

    Layout: dx = [cam increments (F, 6) | cube increments (O, 9)].
    Camera: left-multiplicative (VertexSE3Expmap::oplusImpl), cuboid:
    right-multiplicative + additive scale (VertexCuboid::oplusImpl).
    """
    F = graph.capacity
    O = graph.n_objects
    d_cam = dx[: F * 6].reshape(F, 6)
    d_cube = dx[F * 6 :].reshape(O, 9)
    gate = graph.frame_mask.astype(dx.dtype)
    if fix_first:
        gate = gate * (jnp.arange(F) != 0)
    d_cam = d_cam * gate[:, None]
    cam_new = SE3.exp(d_cam).compose(graph.cam_Tcw)
    cube_gate = graph.cube_valid.astype(dx.dtype)[:, None]
    cube_new = graph.cube.exp_update(d_cube * cube_gate)
    return cam_new, cube_new


def _huber_scale(res: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS square-root Huber weight per edge (last axis = residual dims),
    matching g2o's RobustKernelHuber (robust_kernel_impl.cpp): residual
    blocks with norm > delta are scaled by sqrt(delta/norm)."""
    # safe sqrt: jnp.linalg.norm's derivative is NaN at exactly-zero rows
    # (masked edges are identically zero), which would poison the Jacobian
    norm = jnp.sqrt(jnp.sum(res * res, axis=-1, keepdims=True) + 1e-24)
    w = jnp.sqrt(jnp.minimum(1.0, delta / norm))
    return res * w


def _residual_vector(
    graph: CameraObjectGraph,
    dx: jnp.ndarray,
    fix_first: bool,
    robust_delta: float | None = None,
    prior=None,
):
    cam, cube = _apply_increments(graph, dx, fix_first)
    odom_res, cube_res, bbox_res = graph_residuals(graph, cam, cube)
    if robust_delta is not None:
        # the reference ships robust kernels unused (g2o robust_kernel_impl);
        # here they are an optional cap on any single edge's influence
        odom_res = _huber_scale(odom_res, robust_delta)
        cube_res = _huber_scale(cube_res, robust_delta)
        bbox_res = _huber_scale(bbox_res, robust_delta)
    parts = [odom_res.reshape(-1), cube_res.reshape(-1), bbox_res.reshape(-1)]
    if prior is not None:
        # sliding-window marginalisation prior on the cuboids (slam.window);
        # never robust-scaled: it is already a Gaussian summary
        from cube_slam_wu_tpu.slam.window import prior_residuals

        parts.append(prior_residuals(prior, cube).reshape(-1))
    return jnp.concatenate(parts)


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "fix_first", "robust_delta", "algorithm"),
)
def optimize(
    graph: CameraObjectGraph,
    iterations: int = 5,
    fix_first: bool = True,
    robust_delta: float | None = None,
    prior=None,
    algorithm: str = "lm",
) -> BAResult:
    """Run `iterations` outer iterations (graph.optimize(k) analogue,
    main_obj.cpp:802-803) and return updated estimates.

    `robust_delta` enables a Huber kernel on every edge (norm cap in the
    residual metric); None mirrors the reference's plain least squares.
    `prior` (slam.window.CubePrior) adds the sliding-window marginalisation
    prior on the cuboid landmarks.

    `algorithm` selects the step rule, covering the bundled g2o's three
    OptimizationAlgorithm implementations (its driver only ever uses LM,
    main_obj.cpp:517-519; GN/Dogleg ship unused):
    - "lm": Levenberg-Marquardt with the g2o damping schedule (default);
    - "gn": plain Gauss-Newton (optimization_algorithm_gauss_newton.cpp) —
      unconditional damped-free steps, tiny diagonal regularisation only
      for the gauge/masked block;
    - "dogleg": Powell's dogleg trust region
      (optimization_algorithm_dogleg.cpp): blend of the Gauss-Newton and
      Cauchy steepest-descent steps inside an adaptive radius."""
    F = graph.capacity
    dtype = graph.cam_Tcw.trans.dtype
    n = F * 6 + graph.n_objects * 9
    if algorithm not in ("lm", "gn", "dogleg"):
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def chi2_of(g: CameraObjectGraph):
        zero = jnp.zeros((n,), dtype)
        r = _residual_vector(g, zero, fix_first, robust_delta, prior)
        return jnp.sum(r * r)

    def linearize(g: CameraObjectGraph):
        zero = jnp.zeros((n,), dtype)
        r0 = _residual_vector(g, zero, fix_first, robust_delta, prior)
        J = jax.jacfwd(
            lambda dx: _residual_vector(g, dx, fix_first, robust_delta, prior)
        )(zero)
        H = matmul(J.T, J)
        grad = matmul(J.T, r0)
        chi2 = jnp.sum(r0 * r0)
        return H, grad, chi2

    def solve_reg(H, grad, reg_scale):
        """Damped solve; the tiny floor also regularises the gauge/masked
        columns (zeroed by _apply_increments) that make H singular."""
        reg = reg_scale * jnp.maximum(jnp.max(jnp.abs(jnp.diag(H))), 1.0)
        return -jnp.linalg.solve(H + reg * jnp.eye(n, dtype=dtype), grad)

    if algorithm == "gn":
        def gn_step(g, _):
            H, grad, _ = linearize(g)
            dx = solve_reg(H, grad, 1e-10)
            cam_new, cube_new = _apply_increments(g, dx, fix_first)
            return g._replace(cam_Tcw=cam_new, cube=cube_new), None

        g_fin, _ = jax.lax.scan(gn_step, graph, None, length=iterations)
        return BAResult(
            cam_Tcw=g_fin.cam_Tcw,
            cube=g_fin.cube,
            chi2=chi2_of(g_fin),
            lambda_final=jnp.asarray(0.0, dtype),
        )

    if algorithm == "dogleg":
        def dl_step(state, _):
            g, Delta, chi2 = state
            H, grad, chi2_cur = linearize(g)
            h_gn = solve_reg(H, grad, 1e-10)
            gg = matmul(grad, grad)
            gBg = matmul(grad, matmul(H, grad))
            alpha = gg / jnp.maximum(gBg, 1e-30)
            h_sd = -alpha * grad
            n_gn = jnp.linalg.norm(h_gn)
            n_sd = jnp.linalg.norm(h_sd)
            d = h_gn - h_sd
            c = matmul(h_sd, d)
            dd = jnp.maximum(matmul(d, d), 1e-30)
            disc = jnp.sqrt(
                jnp.maximum(c * c + dd * (Delta**2 - n_sd**2), 0.0)
            )
            beta = jnp.where(
                c <= 0,
                (-c + disc) / dd,
                (Delta**2 - n_sd**2) / jnp.maximum(c + disc, 1e-30),
            )
            h_blend = h_sd + jnp.clip(beta, 0.0, 1.0) * d
            h = jnp.where(
                n_gn <= Delta,
                h_gn,
                jnp.where(
                    n_sd >= Delta,
                    (Delta / jnp.maximum(n_sd, 1e-30)) * h_sd,
                    h_blend,
                ),
            )
            cam_new, cube_new = _apply_increments(g, h, fix_first)
            g_new = g._replace(cam_Tcw=cam_new, cube=cube_new)
            chi2_new = chi2_of(g_new)
            pred = -(matmul(grad, h) + 0.5 * matmul(h, matmul(H, h)))
            rho = (chi2_cur - chi2_new) / jnp.maximum(pred, 1e-30)
            accept = (rho > 0) & jnp.isfinite(chi2_new)
            h_norm = jnp.linalg.norm(h)
            Delta_next = jnp.where(
                rho > 0.75,
                jnp.maximum(Delta, 3.0 * h_norm),
                jnp.where(rho < 0.25, 0.5 * Delta, Delta),
            )
            out = jax.tree.map(lambda a, b: jnp.where(accept, a, b), g_new, g)
            chi2_next = jnp.where(accept, chi2_new, chi2_cur)
            return (out, Delta_next, chi2_next), None

        init_dl = (graph, jnp.asarray(1e4, dtype), chi2_of(graph))
        (g_fin, Delta_fin, chi2_fin), _ = jax.lax.scan(
            dl_step, init_dl, None, length=iterations
        )
        return BAResult(
            cam_Tcw=g_fin.cam_Tcw,
            cube=g_fin.cube,
            chi2=chi2_fin,
            lambda_final=Delta_fin,
        )

    H0, g0, chi2_0 = linearize(graph)
    lam0 = 1e-5 * jnp.max(jnp.abs(jnp.diag(H0)))
    lam0 = jnp.maximum(lam0, jnp.asarray(1e-12, dtype))

    def step(state, _):
        g, lam, ni, chi2 = state
        H, grad, chi2_cur = linearize(g)
        A = H + lam * jnp.eye(n, dtype=dtype)
        dx = -jnp.linalg.solve(A, grad)
        cam_new, cube_new = _apply_increments(g, dx, fix_first)
        g_new = g._replace(cam_Tcw=cam_new, cube=cube_new)
        chi2_new = chi2_of(g_new)

        # gain ratio rho = (F0 - F1) / (0.5 * dx^T (lam*dx - grad))
        denom = jnp.maximum(jnp.abs(matmul(dx, lam * dx - grad)), 1e-30)
        rho = (chi2_cur - chi2_new) / denom
        accept = (rho > 0) & jnp.isfinite(chi2_new)

        scale = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_acc = lam * scale
        lam_rej = lam * ni
        lam_next = jnp.where(accept, lam_acc, lam_rej)
        ni_next = jnp.where(accept, 2.0, ni * 2.0)
        out = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), g_new, g
        )
        chi2_next = jnp.where(accept, chi2_new, chi2_cur)
        return (out, lam_next, ni_next, chi2_next), chi2_next

    init = (graph, lam0, jnp.asarray(2.0, dtype), chi2_0)
    (g_fin, lam_fin, _, chi2_fin), _ = jax.lax.scan(
        step, init, None, length=iterations
    )
    return BAResult(
        cam_Tcw=g_fin.cam_Tcw, cube=g_fin.cube, chi2=chi2_fin, lambda_final=lam_fin
    )


class MarginalCovariance(NamedTuple):
    cam: jnp.ndarray  # (F, 6, 6) per-camera tangent-space covariance blocks
    cube: jnp.ndarray  # (O, 9, 9) per-cuboid covariance blocks
    cam_valid: jnp.ndarray  # (F,) bool: block is estimable (active, not gauge)
    cube_valid: jnp.ndarray  # (O,) bool


@functools.partial(jax.jit, static_argnames=("fix_first", "robust_delta"))
def marginal_covariance(
    graph: CameraObjectGraph,
    fix_first: bool = True,
    robust_delta: float | None = None,
) -> MarginalCovariance:
    """Per-vertex marginal covariance blocks of the current estimate.

    Linearizes at the current estimate and inverts the Gauss-Newton
    information matrix H = J^T J — the same quantity g2o's
    SparseOptimizer::computeMarginals extracts via a sparse partial inverse
    (Thirdparty/g2o g2o/core/sparse_optimizer.h; the reference driver never
    calls it, but it is part of the optimizer's API surface).  Because the
    residuals are pre-scaled by sqrt-information (cube_meas_weight), H is
    the information matrix and its inverse the covariance.

    Gauge/inactive parameters (the fixed first camera, masked frames,
    uninitialised cuboids) have zero Jacobian columns; their rows/columns
    are replaced by identity before the inverse and their blocks reported
    as zero with `*_valid` False.

    With `fix_first=False` the global gauge is unconstrained and H is
    singular along it — the returned blocks are then numerically meaningless
    (~1e14 pseudo-variances).  Keep the gauge fixed when extracting
    covariances, exactly as g2o requires a fixed vertex for computeMarginals.
    """
    F = graph.capacity
    O = graph.n_objects
    dtype = graph.cam_Tcw.trans.dtype
    n = F * 6 + O * 9

    zero = jnp.zeros((n,), dtype)
    J = jax.jacfwd(lambda dx: _residual_vector(graph, dx, fix_first, robust_delta))(
        zero
    )
    H = matmul(J.T, J)

    cam_active = graph.frame_mask
    if fix_first:
        cam_active = cam_active & (jnp.arange(F) != 0)
    active = jnp.concatenate(
        [
            jnp.repeat(cam_active, 6),
            jnp.repeat(graph.cube_valid, 9),
        ]
    )
    # identity on the inactive complement keeps H nonsingular without
    # perturbing the active sub-block's inverse (block-diagonal split)
    a = active.astype(dtype)
    H_reg = H * (a[:, None] * a[None, :]) + jnp.diag(1.0 - a)
    sigma = jnp.linalg.inv(H_reg) * (a[:, None] * a[None, :])

    cam_blocks = jnp.stack(
        [sigma[i * 6 : (i + 1) * 6, i * 6 : (i + 1) * 6] for i in range(F)]
    )
    base = F * 6
    cube_blocks = jnp.stack(
        [
            sigma[base + i * 9 : base + (i + 1) * 9, base + i * 9 : base + (i + 1) * 9]
            for i in range(O)
        ]
    )
    return MarginalCovariance(
        cam=cam_blocks,
        cube=cube_blocks,
        cam_valid=cam_active,
        cube_valid=graph.cube_valid,
    )
