"""Distributed bundle adjustment: factor-sharded Hessian reduction.

The reference has no distributed compute at all (SURVEY.md section 2.9); this
is the scale-out design for the back-end:

- the (small) state vector — camera poses + cuboid — is replicated,
- the FACTORS (odometry edges, camera-object edges) are sharded across the
  mesh's `kf` (keyframe) axis with `shard_map`,
- each device linearizes only its local block of factors and forms partial
  normal equations H_k = J_k^T J_k, g_k = J_k^T r_k,
- `psum` reduces the blocks; the damped solve is replicated
  (deterministic, so all devices stay in lockstep),
- the LM accept/reject loop runs on the reduced scalars.

This is the "sequence parallel" analogue for SLAM: the keyframe axis is the
sequence axis (SURVEY.md section 5.7).  For per-device factor counts that
dwarf the state size this is bandwidth-optimal: the only communication is
the (n x n) Hessian allreduce per iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.precision import matmul
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam.ba import BAResult, _apply_increments
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph, graph_residuals


def _local_residual_vector(
    graph_rep: CameraObjectGraph, dx: jnp.ndarray, fix_first: bool, axis: str
):
    """Residuals of this device's factor block, given the replicated state and
    a replicated increment vector.  Select-by-shard keeps the math identical
    to the single-chip path; each device zeroes the rows it doesn't own."""
    F = graph_rep.capacity
    dev = jax.lax.axis_index(axis)
    n_dev = jax.lax.axis_size(axis)
    block = F // n_dev
    owned = (jnp.arange(F) >= dev * block) & (jnp.arange(F) < (dev + 1) * block)
    # remainder frames go to the last device
    owned = owned | ((jnp.arange(F) >= n_dev * block) & (dev == n_dev - 1))

    cam, cube = _apply_increments(graph_rep, dx, fix_first)
    odom_res, cube_res, bbox_res = graph_residuals(graph_rep, cam, cube)
    odom_res = jnp.where(owned[:, None], odom_res, 0.0)
    cube_res = jnp.where(owned[:, None, None], cube_res, 0.0)
    bbox_res = jnp.where(owned[:, None, None], bbox_res, 0.0)
    return jnp.concatenate(
        [odom_res.reshape(-1), cube_res.reshape(-1), bbox_res.reshape(-1)]
    )


def make_sharded_optimize(
    mesh: Mesh,
    axis: str = "kf",
    iterations: int = 5,
    fix_first: bool = True,
):
    """Build a jittable distributed `optimize(graph) -> BAResult` over `mesh`.

    The graph pytree is replicated; factor ownership is derived from the
    device index, so no resharding of the (tiny) state is needed and the
    collective traffic is exactly one (n^2 + n + 1)-element psum per
    linearization.
    """

    def linearize(graph: CameraObjectGraph):
        def block(graph_rep):
            F = graph_rep.capacity
            n = F * 6 + graph_rep.n_objects * 9
            dtype = graph_rep.cam_Tcw.trans.dtype
            zero = jnp.zeros((n,), dtype)
            r = _local_residual_vector(graph_rep, zero, fix_first, axis)
            J = jax.jacfwd(
                lambda dx: _local_residual_vector(graph_rep, dx, fix_first, axis)
            )(zero)
            H = jax.lax.psum(matmul(J.T, J), axis)
            g = jax.lax.psum(matmul(J.T, r), axis)
            chi2 = jax.lax.psum(jnp.sum(r * r), axis)
            return H, g, chi2

        rep = P()
        return jax.shard_map(
            block,
            mesh=mesh,
            in_specs=(jax.tree.map(lambda _: rep, graph),),
            out_specs=(rep, rep, rep),
        )(graph)

    @jax.jit
    def optimize(graph: CameraObjectGraph) -> BAResult:
        F = graph.capacity
        n = F * 6 + graph.n_objects * 9
        dtype = graph.cam_Tcw.trans.dtype

        def chi2_of(g):
            zero = jnp.zeros((n,), dtype)
            # chi2 is cheap; evaluate unsharded
            from cube_slam_wu_tpu.slam.ba import _residual_vector

            r = _residual_vector(g, zero, fix_first)
            return jnp.sum(r * r)

        H0, _, chi2_0 = linearize(graph)
        lam0 = jnp.maximum(1e-5 * jnp.max(jnp.abs(jnp.diag(H0))), 1e-12)

        def step(state, _):
            g, lam, ni, chi2 = state
            H, grad, chi2_cur = linearize(g)
            A = H + lam * jnp.eye(n, dtype=dtype)
            dx = -jnp.linalg.solve(A, grad)
            cam_new, cube_new = _apply_increments(g, dx, fix_first)
            g_new = g._replace(cam_Tcw=cam_new, cube=cube_new)
            chi2_new = chi2_of(g_new)
            denom = jnp.maximum(jnp.abs(matmul(dx, lam * dx - grad)), 1e-30)
            rho = (chi2_cur - chi2_new) / denom
            accept = (rho > 0) & jnp.isfinite(chi2_new)
            lam_next = jnp.where(
                accept,
                lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                lam * ni,
            )
            ni_next = jnp.where(accept, 2.0, ni * 2.0)
            out = jax.tree.map(lambda a, b: jnp.where(accept, a, b), g_new, g)
            return (out, lam_next, ni_next, jnp.where(accept, chi2_new, chi2_cur)), None

        init = (graph, lam0, jnp.asarray(2.0, dtype), chi2_0)
        (g_fin, lam_fin, _, chi2_fin), _ = jax.lax.scan(step, init, None, length=iterations)
        return BAResult(
            cam_Tcw=g_fin.cam_Tcw, cube=g_fin.cube, chi2=chi2_fin, lambda_final=lam_fin
        )

    return optimize


def make_mesh(n_devices: int | None = None, axis: str = "kf") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def replicate_to_mesh(tree, mesh: Mesh):
    """Place a pytree fully-replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
