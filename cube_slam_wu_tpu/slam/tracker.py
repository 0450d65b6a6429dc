"""Incremental camera-object SLAM driver.

Re-designs the reference's per-frame loop (incremental_build_graph,
object_slam/src/main_obj.cpp:479-841) as a single jit-compiled `lax.scan`
over frame slots: every step activates one more frame in the fixed-capacity
graph (constant-velocity pose initialisation, measurement insertion) and
re-optimises the full graph with 5 LM iterations — the same O(N)-per-frame
re-optimisation schedule as the reference, but compiled once and executed
entirely on device.

Objects are a batch axis: each frame carries up to O cuboid measurements
(with masks); an object's vertex is initialised from its first observation
(the reference's frame-0 special case generalised, main_obj.cpp:741-750).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.precision import matmul
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam import ba
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph


class FrameInput(NamedTuple):
    """Per-frame measurement inputs (leading axis = frame, then object)."""

    meas: Cuboid  # (N, O) camera-frame cuboid measurements
    quality: jnp.ndarray  # (N, O) in [0.5, 1]; weight = 2*quality
    has_meas: jnp.ndarray  # (N, O) bool
    active: jnp.ndarray  # (N,) bool: frame exists (for padded batches)
    # optional 2D bbox observations [cx, cy, w, h] per (frame, object) for
    # EdgeSE3CuboidProj factors (g2o_Object.h:264-292).  The reference's
    # object_slam driver builds only the 3D EdgeSE3Cuboid; the projection
    # edge is part of its capability surface and is wired here behind
    # bbox_weight (None/0 = reference behaviour).
    bbox: jnp.ndarray | None = None  # (N, O, 4)
    bbox_weight: jnp.ndarray | None = None  # (N, O)


def _set_se3(batch: SE3, i, value: SE3) -> SE3:
    return SE3(batch.quat.at[i].set(value.quat), batch.trans.at[i].set(value.trans))


def _set_cuboid(batch: Cuboid, i, value: Cuboid) -> Cuboid:
    return Cuboid(_set_se3(batch.pose, i, value.pose), batch.scale.at[i].set(value.scale))


def _insert_frame(
    graph: CameraObjectGraph,
    i,
    frame: FrameInput,
    first_Twc: SE3,
    gate_threshold: float | None,
    soft_gate_alpha: float | None,
    soft_gate_power: float,
) -> CameraObjectGraph:
    """Constant-velocity pose init + measurement insertion + cuboid vertex
    initialisation (shared by the full-graph and windowed steps).

    Innovation gating (beyond the reference, which feeds every detection into
    the graph unweighted): before inserting a camera-object edge, the 9-d
    `min_log_error` innovation of the measurement against the CURRENT cuboid
    estimate (at the constant-velocity predicted pose) is computed;
    `gate_threshold` drops edges whose innovation norm exceeds it, and
    `soft_gate_alpha` scales the measurement quality by
    1/(1 + alpha*innovation^power).  This is what keeps the online pipeline
    at trajectory parity despite noisier single-frame detections."""
    O = graph.n_objects

    # -- constant-velocity pose initialisation (main_obj.cpp:548-565) ----
    prev = graph.cam_Tcw[jnp.maximum(i - 1, 0)]
    prevprev = graph.cam_Tcw[jnp.maximum(i - 2, 0)]
    odom_cv = prev.compose(prevprev.inverse())
    ident = SE3.identity((), graph.cam_Tcw.trans.dtype)
    use_cv = i > 1
    odom_val = jax.tree.map(
        lambda a, b: jnp.where(use_cv, a, b), odom_cv, ident
    )
    curr_Tcw_pred = odom_val.compose(prev)
    first_Tcw = first_Twc.inverse()
    curr_Tcw = jax.tree.map(
        lambda a, b: jnp.where(i == 0, a, b), first_Tcw, curr_Tcw_pred
    )

    # -- innovation gating against the current cuboid estimates ----------
    curr_Twc = curr_Tcw.inverse()
    Twc_b = SE3(
        jnp.broadcast_to(curr_Twc.quat, (O, 4)),
        jnp.broadcast_to(curr_Twc.trans, (O, 3)),
    )
    pred_global = frame.meas.transform_from(Twc_b)  # (O,)
    innovation = jnp.linalg.norm(
        graph.cube.min_log_error(pred_global), axis=-1
    )  # (O,)
    can_gate = graph.cube_valid & (i > 0)
    quality = frame.quality
    has_meas = frame.has_meas
    if soft_gate_alpha is not None:
        quality = jnp.where(
            can_gate,
            quality / (1.0 + soft_gate_alpha * innovation**soft_gate_power),
            quality,
        )
    if gate_threshold is not None:
        has_meas = has_meas & jnp.where(
            can_gate, innovation < gate_threshold, True
        )

    # -- write the new frame into the graph ------------------------------
    g = graph._replace(
        cam_Tcw=_set_se3(graph.cam_Tcw, i, curr_Tcw),
        frame_mask=graph.frame_mask.at[i].set(frame.active),
        odom=_set_se3(graph.odom, i, odom_val),
        odom_mask=graph.odom_mask.at[i].set(frame.active & (i > 0)),
        cube_meas=_set_cuboid(graph.cube_meas, i, frame.meas),
        cube_meas_weight=graph.cube_meas_weight.at[i].set(2.0 * quality),
        cube_meas_mask=graph.cube_meas_mask.at[i].set(frame.active & has_meas),
    )
    if frame.bbox is not None:
        g = g._replace(
            bbox_meas=g.bbox_meas.at[i].set(frame.bbox),
            bbox_weight=g.bbox_weight.at[i].set(frame.bbox_weight),
            bbox_mask=g.bbox_mask.at[i].set(
                frame.active & has_meas & (frame.bbox_weight > 0)
            ),
        )

    # -- cuboid vertex initialisation on first observation ---------------
    # (generalises the reference's frame-0 init, main_obj.cpp:741-750)
    init_cube = frame.meas.transform_from(Twc_b)  # (O,)
    set_cube = (~g.cube_valid) & frame.active & frame.has_meas
    return g._replace(
        cube=jax.tree.map(
            lambda a, b: jnp.where(
                set_cube.reshape((O,) + (1,) * (a.ndim - 1)), a, b
            ),
            init_cube,
            g.cube,
        ),
        cube_valid=g.cube_valid | set_cube,
    )


def make_incremental_step(
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
):
    """Build the full-graph scan body:
    (graph, (index, FrameInput slice, first_pose)) -> graph.

    `first_pose` is the fixed frame-0 camera-to-world pose (the reference
    uses the first ground-truth pose, main_obj.cpp:526)."""

    def step(carry, inp):
        graph: CameraObjectGraph = carry
        i, frame, first_Twc = inp
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )
        # -- full-graph re-optimisation (main_obj.cpp:802-803) ---------------
        result = ba.optimize(
            g, iterations=iterations, fix_first=True, robust_delta=robust_delta
        )
        g = g._replace(cam_Tcw=result.cam_Tcw, cube=result.cube)
        # skip everything for padded slots
        g = jax.tree.map(lambda a, b: jnp.where(frame.active, a, b), g, graph)
        # per-frame optimized landmark snapshot (cube_pose_opti_history,
        # main_obj.cpp:815-819)
        return g, (result.chi2, g.cube.to_minimal())

    return step


def make_windowed_step(
    window: int,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
):
    """Fixed-lag scan body: optimise only the trailing `window` frames; on
    frame departure absorb its cuboid edges into the Gaussian prior
    (slam.window).  Per-frame cost is O(window^2 .. ^3) independent of the
    sequence length, unlike the reference's whole-graph re-optimisation
    (main_obj.cpp:802-803)."""
    from cube_slam_wu_tpu.slam import window as win_mod

    W = window

    def step(carry, inp):
        graph, prior = carry
        i, frame, first_Twc = inp
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )

        # -- absorb the departing frame (index i - W) into the prior ---------
        d = jnp.maximum(i - W, 0)
        departing = i >= W
        Twc_d = g.cam_Tcw[d].inverse()
        meas_d = jax.tree.map(lambda a: a[d], g.cube_meas)
        prior_new = win_mod.absorb_frame(
            prior,
            Twc_d,
            meas_d,
            g.cube_meas_weight[d],
            g.cube_meas_mask[d] & departing,
            g.cube,
        )

        # -- optimise the trailing window ------------------------------------
        s = jnp.clip(i - W + 1, 0, g.capacity - W)
        win = win_mod.window_slice(g, s, W)
        result = ba.optimize(
            win, iterations=iterations, fix_first=True, prior=prior_new,
            robust_delta=robust_delta,
        )
        g = win_mod.window_scatter(g, result.cam_Tcw, s)
        g = g._replace(cube=result.cube)

        # skip everything for padded slots
        g = jax.tree.map(lambda a, b: jnp.where(frame.active, a, b), g, graph)
        prior_new = jax.tree.map(
            lambda a, b: jnp.where(frame.active, a, b), prior_new, prior
        )
        return (g, prior_new), (result.chi2, g.cube.to_minimal())

    return step


class PointState(NamedTuple):
    """Rolling point-landmark state carried by the point-augmented windowed
    step: the dense observation raster (the reference's analogue is
    ORB-SLAM2's per-keyframe feature observations — its repo references the
    integration, README.md:8, and its g2o ships the mono projection edges,
    types_six_dof_expmap.h:145-175) plus current world estimates."""

    obs_uv: jnp.ndarray  # (F, P, 2) pixel observations per frame slot
    obs_mask: jnp.ndarray  # (F, P) observation validity
    points: jnp.ndarray  # (P, 3) world estimates
    point_valid: jnp.ndarray  # (P,) triangulated + accepted

    @staticmethod
    def empty(capacity: int, n_points: int, dtype=jnp.float64) -> "PointState":
        return PointState(
            obs_uv=jnp.zeros((capacity, n_points, 2), dtype),
            obs_mask=jnp.zeros((capacity, n_points), bool),
            points=jnp.zeros((n_points, 3), dtype),
            point_valid=jnp.zeros((n_points,), bool),
        )


def make_windowed_point_step(
    window: int,
    K: jnp.ndarray,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
    point_weight: float = 0.05,
    min_obs: int = 3,
    reproj_gate_px: float = 8.0,
    point_huber: float | None = 2.0,
    max_point_range: float = 60.0,
):
    """Fixed-lag scan body with point landmarks: the full CubeSLAM objective
    (odometry + cuboid + bbox + point reprojection) optimised jointly over
    the trailing window via slam.point_ba's Schur reduction.

    This is the paper's camera+points+objects coupling (the reference repo
    only references its ORB-SLAM2 integration, README.md:8): points supply
    dense frame-to-frame relative-pose information that the cuboid edges
    alone cannot (a monocular trajectory constrained only by per-frame
    object observations drifts with the measurement noise), while the
    cuboids anchor global scale.

    carry = (graph, CubePrior, PointState); input adds per-frame point
    observations (obs_uv (P, 2), obs_mask (P,)), a `respawned (P,)` flag
    marking slots the front-end re-seeded with a NEW physical feature —
    their observation history and point estimate are cleared so a reused
    slot can never mix two landmarks (chimera points) — and a
    `ground_hint (P,)` flag for features the front-end believes lie on the
    ground plane (below the horizon, outside every detection bbox).

    Per step: record observations -> initialise never-valid slots with
    >= `min_obs` in-window observations (batched DLT at the current window
    poses, accepted only under `reproj_gate_px` and in front of the camera
    within `max_point_range`) -> gate each observation by reprojection
    error -> joint LM.

    Monocular bootstrap: DLT needs baseline, but early in a run (or when
    object observations are too weak to drag the camera) the pose estimates
    have near-zero baseline, so triangulation degenerates exactly when
    points are needed most.  Ground-hinted slots that fail DLT are instead
    initialised by intersecting their newest observation ray with the
    world ground plane z = 0 — the same known-camera-height geometry the
    cuboid proposals use for their 2D->3D lift — which is valid from a
    SINGLE view and therefore supplies metric-scale motion constraints
    immediately (the CubeSLAM paper's ground-scale reasoning applied to
    points).  The init is only a starting value: the landmark stays a free
    3-DoF variable in the joint BA.

    Points falling out of the window are NOT marginalised (their estimate
    simply stops updating once unobserved) — the trajectory information
    they carried lives on through the optimised poses and the cuboid
    prior; this is the standard fixed-lag treatment of opportunistic
    features.  A valid point whose in-window observations are ALL rejected
    by the reprojection gate (>= 3 of them) is demoted to invalid so the
    slot can re-initialise instead of carrying a garbage landmark."""
    from cube_slam_wu_tpu.slam import point_ba
    from cube_slam_wu_tpu.slam import window as win_mod
    from cube_slam_wu_tpu.slam.point_ba import PointFactors

    W = window

    def step(carry, inp):
        graph, prior, ps = carry
        i, frame, first_Twc, obs_i, obs_mask_i, respawned, ground_hint = inp
        g = _insert_frame(
            graph, i, frame, first_Twc,
            gate_threshold, soft_gate_alpha, soft_gate_power,
        )
        dtype = ps.points.dtype
        P = ps.points.shape[0]

        # -- record this frame's point observations; forget respawned slots -
        omask = ps.obs_mask & ~respawned[None, :]
        omask = omask.at[i].set(obs_mask_i & frame.active)
        ouv = ps.obs_uv.at[i].set(obs_i)
        pvalid = ps.point_valid & ~respawned

        # -- absorb the departing frame into the cuboid prior ---------------
        d = jnp.maximum(i - W, 0)
        departing = i >= W
        Twc_d = g.cam_Tcw[d].inverse()
        meas_d = jax.tree.map(lambda a: a[d], g.cube_meas)
        prior_new = win_mod.absorb_frame(
            prior,
            Twc_d,
            meas_d,
            g.cube_meas_weight[d],
            g.cube_meas_mask[d] & departing,
            g.cube,
        )

        # -- window slices ----------------------------------------------------
        s = jnp.clip(i - W + 1, 0, g.capacity - W)
        win = win_mod.window_slice(g, s, W)
        obs_uv_w = jax.lax.dynamic_slice_in_dim(ouv, s, W, axis=0)
        obs_mask_w = jax.lax.dynamic_slice_in_dim(omask, s, W, axis=0)
        obs_mask_w = obs_mask_w & win.frame_mask[:, None]

        # -- triangulate fresh tracks at the current window poses -----------
        n_obs = jnp.sum(obs_mask_w, axis=0)  # (P,)
        fresh = (~pvalid) & (n_obs >= min_obs)
        X_new, tri_ok = point_ba.triangulate_points(
            win.cam_Tcw, obs_uv_w, obs_mask_w, K
        )

        def reproj_err(points):
            proj = jax.vmap(
                lambda T: jax.vmap(
                    lambda X: point_ba.project_point(T, X, K)
                )(points)
            )(win.cam_Tcw)  # (W, P, 2)
            return jnp.linalg.norm(proj - obs_uv_w, axis=-1)

        # DLT acceptance: finite solution, all-window reprojection under the
        # gate, and a sane camera-relative range in the newest frame
        err_new = jnp.where(obs_mask_w, reproj_err(X_new), 0.0)
        newest_C = win.cam_Tcw[-1].inverse().trans
        rng_new = jnp.linalg.norm(X_new - newest_C[None, :], axis=-1)
        accept = (
            fresh
            & tri_ok
            & jnp.all(err_new < reproj_gate_px, axis=0)
            & (rng_new < max_point_range)
        )

        # ground-plane bootstrap for hinted slots DLT could not solve:
        # lift the NEWEST observation's ray onto world z = 0
        last_row = jnp.max(
            jnp.where(obs_mask_w, jnp.arange(W)[:, None], -1), axis=0
        )  # (P,)
        row = jnp.clip(last_row, 0, W - 1)
        Tcw_last = win.cam_Tcw[row]  # (P,) poses
        uv_last = jnp.take_along_axis(
            obs_uv_w, row[None, :, None], axis=0
        )[0]  # (P, 2)
        Twc_last = Tcw_last.inverse()
        Kinv = jnp.linalg.inv(K)
        ray_c = matmul(
            jnp.concatenate([uv_last, jnp.ones_like(uv_last[:, :1])], axis=-1),
            Kinv.T,
        )  # (P, 3) camera-frame directions
        from cube_slam_wu_tpu.core import rotations as _rotu

        d_w = _rotu.quat_rotate(Twc_last.quat, ray_c)
        C = Twc_last.trans  # (P, 3) camera centres
        dz = d_w[..., 2]
        t_hit = -C[..., 2] / jnp.where(jnp.abs(dz) > 1e-6, dz, -1e-6)
        X_ground = C + t_hit[:, None] * d_w
        ground_accept = (
            fresh
            & ~accept
            & ground_hint
            & (last_row >= 0)
            & (dz < -0.02)  # ray actually descends to the ground
            & (t_hit > 0.5)
            & (t_hit < max_point_range)
            & (C[..., 2] > 0.2)  # camera above the plane
        )

        points = jnp.where(accept[:, None], X_new, ps.points)
        points = jnp.where(ground_accept[:, None], X_ground, points)
        pvalid = pvalid | accept | ground_accept

        # -- per-observation outlier gate vs current estimates --------------
        err = reproj_err(points)
        obs_ok = obs_mask_w & pvalid[None, :] & (err < reproj_gate_px)

        # demote landmarks that every in-window observation rejects
        n_win = jnp.sum(obs_mask_w, axis=0)
        n_ok = jnp.sum(obs_ok, axis=0)
        garbage = pvalid & (n_win >= 3) & (n_ok == 0)
        pvalid = pvalid & ~garbage
        obs_ok = obs_ok & pvalid[None, :]

        factors = PointFactors(
            points=points,
            point_mask=pvalid,
            obs_uv=obs_uv_w,
            obs_mask=obs_ok,
            obs_weight=jnp.full((W, P), point_weight, dtype),
        )
        result = point_ba.optimize(
            win, factors, K,
            iterations=iterations, fix_first=True,
            robust_delta=robust_delta, prior=prior_new,
            point_huber=point_huber,
        )
        g = win_mod.window_scatter(g, result.cam_Tcw, s)
        g = g._replace(cube=result.cube)
        points = result.points

        # skip everything for padded slots
        ps_new = PointState(ouv, omask, points, pvalid)
        g = jax.tree.map(lambda a, b: jnp.where(frame.active, a, b), g, graph)
        prior_new = jax.tree.map(
            lambda a, b: jnp.where(frame.active, a, b), prior_new, prior
        )
        ps_new = jax.tree.map(
            lambda a, b: jnp.where(frame.active, a, b), ps_new, ps
        )
        return (g, prior_new, ps_new), (result.chi2, g.cube.to_minimal())

    return step


def run_incremental(
    first_Twc: SE3,
    frames: FrameInput,
    capacity: int | None = None,
    iterations: int = 5,
    gate_threshold: float | None = None,
    soft_gate_alpha: float | None = None,
    soft_gate_power: float = 1.0,
    window: int | None = None,
    robust_delta: float | None = None,
    K: jnp.ndarray | None = None,
    point_obs: tuple | None = None,
    point_weight: float = 0.05,
    point_opts: dict | None = None,
):
    """Run incremental SLAM over all frames.

    Returns (graph, chi2_history (N,), cube_history (N, O, 9)) — the
    per-frame optimized landmark snapshots mirror the reference's
    cube_pose_opti_history (main_obj.cpp:815-819).

    `window=None` re-optimises the full graph every frame (the reference's
    schedule, main_obj.cpp:802-803); `window=W` runs the fixed-lag smoother
    (slam.window) with O(W)-bounded per-frame cost.  A window >= the
    sequence length is exactly the full-graph path (no frame ever departs).

    `point_obs = (obs_uv (N, P, 2), obs_mask (N, P)[, ground_hint (N, P)])`
    adds point-landmark reprojection factors to the WINDOWED path
    (make_windowed_point_step; requires `window` and `K`): pre-tracked
    feature observations (e.g. slam.features.build_point_tracks, whose
    slots are never reused so no respawn flags are needed) are triangulated
    and jointly optimised with the cuboids inside each window.  The
    optional ground_hint enables single-view ground-plane initialisation
    for those slots (see make_windowed_point_step).

    frames fields have leading axes (N, O) (padded allowed via `active`)."""
    n, n_obj = frames.quality.shape
    capacity = capacity or n
    dtype = frames.meas.scale.dtype
    graph = CameraObjectGraph.empty(capacity, n_obj, dtype)
    if K is not None:
        graph = graph._replace(K=jnp.asarray(K, dtype))

    idxs = jnp.arange(n)
    first_b = SE3(
        jnp.broadcast_to(first_Twc.quat, (n, 4)),
        jnp.broadcast_to(first_Twc.trans, (n, 3)),
    )
    if window is None or window >= capacity:
        step = make_incremental_step(
            iterations, gate_threshold, soft_gate_alpha, soft_gate_power,
            robust_delta,
        )
        graph, (chi2s, cube_history) = jax.lax.scan(
            step, graph, (idxs, frames, first_b)
        )
        return graph, chi2s, cube_history

    from cube_slam_wu_tpu.slam.window import CubePrior

    prior = CubePrior.empty(n_obj, dtype)
    if point_obs is not None:
        if K is None:
            raise ValueError("point_obs requires K (projection intrinsics)")
        obs_uv, obs_mask = point_obs[0], point_obs[1]
        obs_uv = jnp.asarray(obs_uv, dtype)
        obs_mask = jnp.asarray(obs_mask, bool)
        P = obs_uv.shape[1]
        step = make_windowed_point_step(
            window, jnp.asarray(K, dtype), iterations, gate_threshold,
            soft_gate_alpha, soft_gate_power, robust_delta,
            point_weight=point_weight, **(point_opts or {}),
        )
        ps = PointState.empty(capacity, P, dtype)
        respawned = jnp.zeros((n, P), bool)  # pre-built tracks: no slot reuse
        ground = point_obs[2] if len(point_obs) > 2 else jnp.zeros((n, P), bool)
        (graph, _, _), (chi2s, cube_history) = jax.lax.scan(
            step,
            (graph, prior, ps),
            (idxs, frames, first_b, obs_uv, obs_mask, respawned,
             jnp.asarray(ground, bool)),
        )
        return graph, chi2s, cube_history

    step = make_windowed_step(
        window, iterations, gate_threshold, soft_gate_alpha, soft_gate_power,
        robust_delta,
    )
    (graph, _), (chi2s, cube_history) = jax.lax.scan(
        step, (graph, prior), (idxs, frames, first_b)
    )
    return graph, chi2s, cube_history
