"""Spanning-tree initial-estimate propagation over the camera-object graph.

Covers the reference's g2o `EstimatePropagator` / `HyperDijkstra` pair
(object_slam/Thirdparty/g2o/g2o/core/estimate_propagator.{h,cpp},
hyper_dijkstra.{h,cpp}): before a *batch* optimisation, vertices with no
estimate are initialised by walking min-cost paths from the fixed vertices
and composing each edge's measurement along the way.

The g2o implementation is a sequential Dijkstra with a priority queue over a
pointer graph.  The re-design here is a fixed-shape *parallel
Bellman-Ford*: every relaxation round updates ALL vertices at once with
masked min-reductions over the edge tables, so the whole propagation is one
`lax.fori_loop` of dense tensor ops (no queue, no data-dependent shapes).
A graph of diameter D converges in D rounds; rounds are cheap (a handful of
(F,)/(F, O) element-wise ops and SE3 composes).

Edge semantics (matching graph.py / the reference measurement models):
- odometry edge i:   odom[i] = Tcw_i * Twc_{i-1}
    forward   Tcw_i     = odom[i] * Tcw_{i-1}
    backward  Tcw_{i-1} = odom[i]^-1 * Tcw_i
- camera-object edge (f, o): cube_meas[f, o] is the cuboid in camera frame f
    frame -> object:  cube_world = meas.transform_from(Twc_f)
    object -> frame:  Twc_f = pose_w * pose_meas^-1  =>
                      Tcw_f = pose_meas * pose_w^-1
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph


class PropagateResult(NamedTuple):
    graph: CameraObjectGraph  # estimates overwritten where reached
    frame_dist: jnp.ndarray  # (F,) path cost from the fixed set (inf = unreached)
    cube_dist: jnp.ndarray  # (O,) path cost (inf = unreached)


def _select(pred: jnp.ndarray, a, b):
    """Per-element pytree select: leaves of a where pred else b (pred is
    broadcast over trailing leaf axes)."""

    def sel(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.ndim - pred.ndim))
        return jnp.where(p, x, y)

    return jax.tree.map(sel, a, b)


def propagate_estimates(
    graph: CameraObjectGraph,
    fixed_frames: jnp.ndarray | None = None,
    odom_cost: float = 1.0,
    cube_cost: float | None = None,
    rounds: int | None = None,
) -> PropagateResult:
    """Initialise every reachable vertex estimate from the fixed frames.

    Args:
      graph: measurements + masks (estimates of non-fixed vertices ignored).
      fixed_frames: (F,) bool — trusted pose slots to propagate FROM.
        Defaults to frame 0 (the reference fixes vertex 0,
        main_obj.cpp:758-760).
      odom_cost / cube_cost: per-edge path costs.  cube_cost defaults to
        F * odom_cost + 1, which makes a single landmark hop more expensive
        than the LONGEST possible odometry path: relative odometry is far
        more reliable than a single-view cuboid measurement, so hops only
        bridge genuine odometry breaks — the same preference as g2o's
        `EstimatePropagatorCostOdometry` (on the real TUM data, hop-eager
        costs initialise far frames from one noisy cuboid view and batch LM
        falls into a chi2-8x local minimum; odometry-preferring costs
        reproduce the incremental solver's optimum exactly).
      rounds: relaxation rounds; defaults to F + O (covers any diameter).

    Unreached vertices keep their incoming estimates.
    """
    F = graph.capacity
    O = graph.n_objects
    dtype = graph.cam_Tcw.trans.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    if cube_cost is None:
        cube_cost = F * odom_cost + 1.0

    if fixed_frames is None:
        fixed_frames = jnp.arange(F) == 0
    fixed_frames = fixed_frames & graph.frame_mask

    if rounds is None:
        rounds = F + O

    idx = jnp.arange(F)
    prev_i = jnp.maximum(idx - 1, 0)
    next_i = jnp.minimum(idx + 1, F - 1)
    # odometry edge i links frames (i-1, i); valid both directions
    fwd_ok = graph.odom_mask & (idx > 0) & graph.frame_mask
    # edge at slot i+1 seen from frame i
    bwd_ok = graph.odom_mask[next_i] & (idx < F - 1) & graph.frame_mask
    meas_ok = (
        graph.cube_meas_mask
        & graph.frame_mask[:, None]
        & (graph.cube_meas_weight > 0)
    )
    odom_inv = graph.odom.inverse()

    dist_f0 = jnp.where(fixed_frames, 0.0, inf)
    dist_o0 = jnp.full((O,), inf, dtype)

    def body(_, carry):
        dist_f, dist_o, Tcw, cube = carry

        # -- odometry forward: frame i-1 -> frame i --------------------------
        cand = jnp.where(fwd_ok, dist_f[prev_i] + odom_cost, inf)
        pose = graph.odom.compose(Tcw[prev_i])
        better = cand < dist_f
        dist_f = jnp.where(better, cand, dist_f)
        Tcw = _select(better, pose, Tcw)

        # -- odometry backward: frame i+1 -> frame i -------------------------
        cand = jnp.where(bwd_ok, dist_f[next_i] + odom_cost, inf)
        pose = odom_inv[next_i].compose(Tcw[next_i])
        better = cand < dist_f
        dist_f = jnp.where(better, cand, dist_f)
        Tcw = _select(better, pose, Tcw)

        # -- frame -> object: lift the min-cost frame's measurement ----------
        cand_fo = jnp.where(meas_ok, dist_f[:, None] + cube_cost, inf)  # (F, O)
        best_f = jnp.argmin(cand_fo, axis=0)  # (O,)
        cand_o = jnp.take_along_axis(cand_fo, best_f[None, :], axis=0)[0]
        meas_best = jax.tree.map(
            lambda x: jnp.take_along_axis(
                x, best_f[None, :].reshape((1, O) + (1,) * (x.ndim - 2)), axis=0
            )[0],
            graph.cube_meas,
        )  # (O,) cuboid measurements from each object's best frame
        cube_cand = meas_best.transform_from(Tcw[best_f].inverse())
        better = cand_o < dist_o
        dist_o = jnp.where(better, cand_o, dist_o)
        cube = _select(better, cube_cand, cube)

        # -- object -> frame: Tcw_f = pose_meas * pose_world^-1 --------------
        cand_of = jnp.where(meas_ok, dist_o[None, :] + cube_cost, inf)  # (F, O)
        best_o = jnp.argmin(cand_of, axis=1)  # (F,)
        cand_f = jnp.take_along_axis(cand_of, best_o[:, None], axis=1)[:, 0]
        meas_f = jax.tree.map(
            lambda x: jnp.take_along_axis(
                x, best_o[:, None].reshape((F, 1) + (1,) * (x.ndim - 2)), axis=1
            )[:, 0],
            graph.cube_meas,
        )  # (F,) each frame's measurement of its best object
        pose_cand = meas_f.pose.compose(cube.pose[best_o].inverse())
        better = cand_f < dist_f
        dist_f = jnp.where(better, cand_f, dist_f)
        Tcw = _select(better, pose_cand, Tcw)

        return dist_f, dist_o, Tcw, cube

    dist_f, dist_o, Tcw, cube = jax.lax.fori_loop(
        0, rounds, body, (dist_f0, dist_o0, graph.cam_Tcw, graph.cube)
    )
    out = graph._replace(cam_Tcw=Tcw, cube=cube)
    return PropagateResult(out, dist_f, dist_o)
