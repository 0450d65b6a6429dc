"""Sim(3) 7-DoF pose-graph optimization (loop-closure scale correction).

Covers the reference's bundled g2o seven-DoF types
(object_slam/Thirdparty/g2o/g2o/types/types_seven_dof_expmap.{h,cpp}:
VertexSim3Expmap + EdgeSim3), the machinery ORB-SLAM-style monocular
systems use to correct accumulated scale drift at loop closure — shipped
by the reference but unused by its driver.  Design: the whole
graph is fixed-shape (padded pose/edge arrays + masks), residuals are
batched over edges, Jacobians come from forward-mode autodiff of the
tangent increments at zero, and the dense damped normal equations solve
inside one jitted lax.scan (same LM schedule as slam/ba.py).

Conventions (matching the g2o types):
- vertex estimate S_iw : world -> frame i similarity (VertexSim3Expmap);
- edge (i, j) measurement S_ji : frame i -> frame j relative similarity;
- error = log(S_ji_meas * S_iw * S_jw^-1)  (EdgeSim3::computeError,
  types_seven_dof_expmap.h);
- vertex update: left-multiplicative S_iw <- exp(delta) * S_iw
  (VertexSim3Expmap::oplusImpl), delta in the [omega, upsilon, sigma]
  tangent ordering of core/sim3.Sim3.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.precision import matmul
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.core.sim3 import Sim3


def sim3_from_se3(T: SE3, scale: jnp.ndarray | float = 1.0) -> Sim3:
    """Embed an SE3 (batched ok) as a Sim3 with the given scale."""
    s = jnp.broadcast_to(
        jnp.asarray(scale, T.trans.dtype), T.trans.shape[:-1]
    )
    return Sim3(T.quat, T.trans, s)


def _take(s: Sim3, idx: jnp.ndarray) -> Sim3:
    return Sim3(s.quat[idx], s.trans[idx], s.scale[idx])


class Sim3PoseGraph(NamedTuple):
    """Padded, fixed-shape 7-DoF pose graph.

    poses: (N,) batched Sim3 vertex estimates S_iw.
    edge_i/edge_j: (E,) int32 endpoint indices (i = from, j = to).
    meas: (E,) batched Sim3 measurements S_ji.
    weight: (E,) scalar information weight per edge (info = w * I_7).
    edge_mask: (E,) bool — inactive edges contribute nothing.
    pose_mask: (N,) bool — inactive vertices receive no increments.
    """

    poses: Sim3
    edge_i: jnp.ndarray
    edge_j: jnp.ndarray
    meas: Sim3
    weight: jnp.ndarray
    edge_mask: jnp.ndarray
    pose_mask: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.poses.scale.shape[0]


def edge_residuals(graph: Sim3PoseGraph, poses: Sim3) -> jnp.ndarray:
    """(E, 7) weighted tangent-space residuals
    sqrt(w) * log(S_ji * S_iw * S_jw^-1) for every (masked) edge.

    Masked-out edges may carry arbitrary padding in `meas` (all-zero is the
    natural fill, and a zero-scale similarity would send log() to NaN, which
    NaN*0 cannot remove).  So masked edges first have their measurement
    substituted with the exactly-consistent S_jw * S_iw^-1 built from the
    current poses — the relative term becomes the identity for EVERY pose
    perturbation, giving an identically-zero, NaN-free residual and Jacobian
    regardless of the padding contents."""
    Si = _take(poses, graph.edge_i)
    Sj = _take(poses, graph.edge_j)
    m = graph.edge_mask
    consistent = Sj.compose(Si.inverse())
    meas = jax.tree.map(
        lambda a, b: jnp.where(
            m.reshape(m.shape + (1,) * (a.ndim - 1)), a, b
        ),
        graph.meas,
        consistent,
    )
    err = meas.compose(Si.compose(Sj.inverse())).log()
    w = jnp.sqrt(graph.weight) * m.astype(err.dtype)
    return err * w[:, None]


def _apply_increments(
    graph: Sim3PoseGraph, dx: jnp.ndarray, fix_first: bool
) -> Sim3:
    N = graph.capacity
    gate = graph.pose_mask.astype(dx.dtype)
    if fix_first:
        gate = gate * (jnp.arange(N) != 0)
    d = dx.reshape(N, 7) * gate[:, None]
    return Sim3.exp(d).compose(graph.poses)


def _residual_vector(
    graph: Sim3PoseGraph, dx: jnp.ndarray, fix_first: bool
) -> jnp.ndarray:
    poses = _apply_increments(graph, dx, fix_first)
    return edge_residuals(graph, poses).reshape(-1)


class PoseGraphResult(NamedTuple):
    poses: Sim3
    chi2: jnp.ndarray
    lambda_final: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("iterations", "fix_first"))
def optimize(
    graph: Sim3PoseGraph,
    iterations: int = 10,
    fix_first: bool = True,
) -> PoseGraphResult:
    """LM over the 7-DoF pose graph.

    Damping: where g2o retries an iteration serially with escalating lambda
    (optimization_algorithm_levenberg.cpp, maxTrialsAfterFailure), here each
    iteration solves a small BATCH of candidate dampings lam * [0.1, 1, 10,
    100] at once (one vmapped Cholesky — the system is tiny) and
    keeps the best accepted step.  Same fixed-shape cost per iteration, no
    wasted outer iterations on rejected trials.

    The first vertex is fixed by default (gauge freedom: a global Sim3 —
    including global scale — is unobservable from relative edges alone)."""
    N = graph.capacity
    dtype = graph.poses.trans.dtype
    n = N * 7
    lam_mults = jnp.asarray([0.1, 1.0, 10.0, 100.0], dtype)

    def chi2_of(g: Sim3PoseGraph):
        r = edge_residuals(g, g.poses).reshape(-1)
        return jnp.sum(r * r)

    def linearize(g: Sim3PoseGraph):
        zero = jnp.zeros((n,), dtype)
        r0 = _residual_vector(g, zero, fix_first)
        J = jax.jacfwd(lambda dx: _residual_vector(g, dx, fix_first))(zero)
        return matmul(J.T, J), matmul(J.T, r0), jnp.sum(r0 * r0)

    H0, _, chi2_0 = linearize(graph)
    lam0 = 1e-5 * jnp.max(jnp.abs(jnp.diag(H0)))
    lam0 = jnp.maximum(lam0, jnp.asarray(1e-12, dtype))

    def step(state, _):
        g, lam, chi2 = state
        H, grad, chi2_cur = linearize(g)
        lams = lam * lam_mults

        def try_lam(lam_t):
            A = H + lam_t * jnp.eye(n, dtype=dtype)
            dx = -jnp.linalg.solve(A, grad)
            poses_t = _apply_increments(g, dx, fix_first)
            c = chi2_of(g._replace(poses=poses_t))
            c = jnp.where(jnp.isfinite(c), c, jnp.inf)
            return poses_t, c

        poses_c, chi2_c = jax.vmap(try_lam)(lams)  # (4, ...) candidates
        k = jnp.argmin(chi2_c)
        chi2_best = chi2_c[k]
        accept = chi2_best < chi2_cur
        poses_next = jax.tree.map(
            lambda cand, cur: jnp.where(accept, cand[k], cur),
            poses_c,
            g.poses,
        )
        # accepted: adopt the winning damping (decaying when the lightest
        # candidate wins); rejected: escalate past the heaviest candidate
        lam_next = jnp.where(accept, lams[k], lam * 1e3)
        chi2_next = jnp.where(accept, chi2_best, chi2_cur)
        return (g._replace(poses=poses_next), lam_next, chi2_next), chi2_next

    init = (graph, lam0, chi2_0)
    (g_fin, lam_fin, chi2_fin), _ = jax.lax.scan(
        step, init, None, length=iterations
    )
    return PoseGraphResult(
        poses=g_fin.poses, chi2=chi2_fin, lambda_final=lam_fin
    )


def chain_odometry(meas: Sim3, start: Sim3 | None = None) -> Sim3:
    """Integrate relative measurements S_{i+1,i} (shape (N-1,)) into vertex
    estimates S_iw, frame 0 at `start` (identity by default) — the
    initialisation a monocular front-end provides before loop closure."""
    n = meas.scale.shape[0] + 1
    dtype = meas.trans.dtype
    s0 = start if start is not None else Sim3.identity(dtype=dtype)

    def step(prev, m):
        cur = m.compose(prev)
        return cur, cur

    _, rest = jax.lax.scan(step, s0, meas)
    return jax.tree.map(
        lambda a, b: jnp.concatenate([a[None], b]), s0, rest
    )


def correct_scale_drift(
    poses_se3: SE3,
    drift_scales: jnp.ndarray,
    loop_from: int,
    loop_to: int,
    loop_meas: Sim3,
    odom_weight: float = 1.0,
    loop_weight: float = 100.0,
    iterations: int = 15,
) -> PoseGraphResult:
    """Build and solve the canonical monocular loop-closure problem: a
    drifted SE3 trajectory + per-vertex accumulated scale estimates, one
    Sim3 loop edge carrying the true relative similarity.

    poses_se3: (N,) drifted camera poses T_iw; drift_scales: (N,) the
    front-end's accumulated scale per vertex (1.0 if unknown); the odometry
    edges are formed CONSISTENTLY from consecutive drifted vertices (zero
    initial residual), so all correction pressure comes from the loop edge
    — mirroring how ORB-SLAM builds its essential graph for EdgeSim3."""
    poses = sim3_from_se3(poses_se3, drift_scales)
    n = poses.scale.shape[0]
    idx = jnp.arange(n - 1)
    Si = _take(poses, idx)
    Sj = _take(poses, idx + 1)
    odo = Sj.compose(Si.inverse())  # S_{i+1,i}: exactly consistent

    edge_i = jnp.concatenate([idx, jnp.asarray([loop_from])]).astype(jnp.int32)
    edge_j = jnp.concatenate([idx + 1, jnp.asarray([loop_to])]).astype(
        jnp.int32
    )
    meas = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b[None]]), odo, loop_meas
    )
    E = n
    weight = jnp.concatenate(
        [
            jnp.full((n - 1,), odom_weight, poses.trans.dtype),
            jnp.asarray([loop_weight], poses.trans.dtype),
        ]
    )
    graph = Sim3PoseGraph(
        poses=poses,
        edge_i=edge_i,
        edge_j=edge_j,
        meas=meas,
        weight=weight,
        edge_mask=jnp.ones((E,), bool),
        pose_mask=jnp.ones((n,), bool),
    )
    return optimize(graph, iterations=iterations)
