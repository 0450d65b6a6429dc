"""Fused single-dispatch online SLAM step.

The two-phase online driver (pipeline.run_online_frontend +
tracker.run_incremental) mirrors the reference's per-frame loop
(main_obj.cpp:541-835) but keeps association, tracklet bookkeeping and
measurement assembly host-side — ~8 blocking host<->device syncs per frame.

This module collapses the whole per-frame step into ONE jitted dispatch:

    (state, gray image, yolo boxes, frame index)
        -> (state', Twc pose + report scalars)

Everything the host loop used to do between kernels now lives on device:

- line detection (ops.detect) and batched cuboid proposals (ops.proposal)
  — unchanged kernels;
- IoU tracklet association (ops.association.associate_detections) + the
  tracklet book state transitions (spawn into free slots, accept, retire)
  as device arrays — the host _TrackletBook's semantics vectorized;
- ground->camera measurement assembly with yaw canonicalization
  (pipeline._proposal_measurement's math, main_obj.cpp:649-675, :732);
- the incremental BA step (tracker.make_incremental_step /
  make_windowed_step — constant-velocity init, innovation gating, LM).

Per frame the host only (a) reads the image + detection txt and ships them
up with the dispatch (the grayscale goes as uint8 — 0.31 MB — and is cast
to f32 on device), and (b) pulls the optimized pose + a handful of report
scalars: 1 blocking sync and ~0.31 MB up / ~46 B down per frame.

The caps-off exact-gather fallback (pipeline._exact_gather_fallback) is
preserved inside the step as a `lax.cond`: when a binding dist_gather_cap
shed valid hypotheses, the frame's proposals are recomputed with the caps
disabled — both variants compile into the one program, so the fallback
costs zero extra dispatches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import pathlib
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam import tracker
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu.utils import io as uio

# TUM fr3 intrinsics the fused driver assumes (main_obj.cpp:484-486)
TUM_FR3_K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1.0]])


class OnlineBook(NamedTuple):
    """Device-resident tracklet slots (the host _TrackletBook's state)."""

    bbox: jnp.ndarray  # (O, 4) last associated detection box (corners)
    alive: jnp.ndarray  # (O,) currently matchable
    used: jnp.ndarray  # (O,) ever spawned
    last: jnp.ndarray  # (O,) int32 frame of last association
    range: jnp.ndarray  # (O,) last camera-relative range (-1 = none)
    yaw: jnp.ndarray  # (O,) last accepted yaw
    count: jnp.ndarray  # (O,) int32 accepted measurements

    @staticmethod
    def empty(n_slots: int, dtype=jnp.float32) -> "OnlineBook":
        return OnlineBook(
            bbox=jnp.zeros((n_slots, 4), dtype),
            alive=jnp.zeros(n_slots, bool),
            used=jnp.zeros(n_slots, bool),
            last=jnp.full(n_slots, -1, jnp.int32),
            range=jnp.full(n_slots, -1.0, dtype),
            yaw=jnp.zeros(n_slots, dtype),
            count=jnp.zeros(n_slots, jnp.int32),
        )


class OnlineState(NamedTuple):
    graph: CameraObjectGraph
    book: OnlineBook
    # fixed-lag smoother prior (slam.window.CubePrior); present but unused
    # when the step runs the full-graph (window=None) path
    prior: object = None


class StepReport(NamedTuple):
    """Per-frame scalars pulled with the pose (FrontendReport counters)."""

    cap_overflow: jnp.ndarray  # int32 hypotheses shed before fallback
    cap_fallback: jnp.ndarray  # bool: exact recompute taken
    no_valid_proposal: jnp.ndarray  # bool
    n_matched: jnp.ndarray  # int32 measurements accepted
    dropped: jnp.ndarray  # int32 new detections without a free slot
    chi2: jnp.ndarray  # post-optimization chi2


def _spawn_new_tracks(book: OnlineBook, det_is_new, det_of_track, matched):
    """Assign new detections (ascending det index) to free slots (ascending
    slot index) — the host loop's `for d in nonzero(det_is_new): spawn()`
    vectorized.  Returns (det_of_track, matched, used', alive', dropped)."""
    O = book.used.shape[0]
    D = det_is_new.shape[0]
    free = ~book.used  # (O,)
    free_rank = jnp.cumsum(free) - 1  # rank of each free slot
    new_rank = jnp.cumsum(det_is_new) - 1  # rank of each new det
    n_new = jnp.sum(det_is_new)
    n_free = jnp.sum(free)
    # det index for each rank r (scatter; untouched ranks stay D = invalid)
    det_for_rank = jnp.full((O + 1,), D, jnp.int32)
    det_for_rank = det_for_rank.at[
        jnp.where(det_is_new, jnp.minimum(new_rank, O), O)
    ].set(jnp.arange(D, dtype=jnp.int32), mode="drop")
    spawn = free & (free_rank < n_new)
    d_spawn = det_for_rank[jnp.clip(free_rank, 0, O)]
    det_of_track = jnp.where(spawn, d_spawn, det_of_track)
    matched = matched | spawn
    return (
        det_of_track,
        matched,
        book.used | spawn,
        book.alive | spawn,
        (n_new - jnp.minimum(n_new, n_free)).astype(jnp.int32),
    )


def _measurements_from_proposals(
    res, det_of_track, matched, roll0, pitch0, yaw0, cam_t, dtype,
    canonicalize_yaw=True,
):
    """pipeline._proposal_measurement vectorized over object slots on
    device (main_obj.cpp:649-675; quality :732).  Returns
    (meas9 (O, 9), quality (O,), rng (O,))."""
    from cube_slam_wu_tpu.core import rotations as rotu

    D = res.pos.shape[0]
    d = jnp.clip(det_of_track, 0, D - 1)
    pos = res.pos[d]
    rotY = res.rotY[d]
    scale = res.scale[d]
    nerr = res.normalized_error[d]
    rdel = res.camera_roll_delta[d]
    pdel = res.camera_pitch_delta[d]

    half_pi = jnp.asarray(math.pi / 2, dtype)
    yaw_init = yaw0 - half_pi
    k = jnp.where(
        canonicalize_yaw, jnp.round((rotY - yaw_init) / half_pi), 0.0
    )
    yaw_c = rotY - k * half_pi
    swap = jnp.mod(k.astype(jnp.int32), 2) != 0
    sl = jnp.where(swap, scale[:, 1], scale[:, 0])
    sw = jnp.where(swap, scale[:, 0], scale[:, 1])
    zeros = jnp.zeros_like(yaw_c)
    cube_ground = Cuboid.from_minimal(
        jnp.stack(
            [pos[:, 0], pos[:, 1], pos[:, 2], zeros, zeros, yaw_c,
             sl, sw, scale[:, 2]],
            axis=-1,
        )
    )
    R_new = jax.vmap(rotu.euler_zyx_to_rot)(
        roll0 + rdel, pitch0 + pdel, jnp.broadcast_to(yaw0, rdel.shape)
    )
    pose_used = SE3.from_rot_trans(
        R_new, jnp.broadcast_to(cam_t, (rdel.shape[0], 3))
    )
    local = cube_ground.transform_to(pose_used)
    meas9 = local.to_minimal()
    quality = (1.0 - nerr + 0.5) / 2.0
    rng = jnp.linalg.norm(pos - cam_t[None, :], axis=-1)
    z = jnp.zeros_like(quality)
    return (
        jnp.where(matched[:, None], meas9, 0.0),
        jnp.where(matched, quality, z),
        jnp.where(matched, rng, z),
    )


def make_online_step(
    K_np: np.ndarray,
    T0_np: np.ndarray,
    capacity: int,
    dtype,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    max_objects: int = 1,
    max_detections: int = 1,
    min_iou: float = 0.3,
    iterations: int = 5,
    soft_gate_alpha: float | None = 1.0,
    soft_gate_power: float = 1.0,
    robust_delta: float | None = None,
    bbox_edge_weight: float = 0.005,
    window: int | None = None,
    canonicalize_yaw: bool = True,
    track_max_age: int | None = None,
    exact_fallback: bool = True,
    sample_cam_roll_pitch: bool = True,
):
    """Build the fused per-frame step for the TUM-class online pipeline
    (fixed first camera pose fed to the proposal engine, main_obj.cpp:
    624-628; constant-velocity BA pose init).

    Returns step(state, gray_u8 (H, W) uint8, boxes_c (D, 4) corners,
    det_mask (D,), i int32) -> (state', (Twc_xyzq (7,), StepReport)).

    Frame 0 needs its own instance (sample_cam_roll_pitch=False, the
    reference samples roll/pitch only after the first frame)."""
    from cube_slam_wu_tpu.core import rotations as rotu
    from cube_slam_wu_tpu.ops.detect import (
        DetectConfig,
        detect_line_segments as _dls,
        detect_line_segments_recover,
    )
    from cube_slam_wu_tpu.ops.association import associate_detections
    from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboids

    detect_cfg = detect_cfg or DetectConfig()
    detect_line_segments = (
        detect_line_segments_recover if detect_cfg.short_recovery else _dls
    )
    over = dict(proposal_overrides or {})
    over.setdefault("nominal_skew_ratio", 2.0)  # main_obj.cpp:499
    over.setdefault("rank_margin", 2e-3)  # see run_online_frontend
    over.setdefault("bilinear_dist", True)
    O, D = max_objects, max_detections

    T0 = np.asarray(T0_np, np.float64)
    roll0, pitch0, yaw0 = (
        float(v)
        for v in rotu.rot_to_euler_zyx(jnp.asarray(T0[:3, :3]))
    )
    K = jnp.asarray(K_np, dtype)
    T0_j = jnp.asarray(T0, dtype)
    cam_t = jnp.asarray(T0[:3, 3], dtype)
    first_Twc = SE3.from_matrix(jnp.asarray(T0, dtype))

    if window is None or window >= capacity:
        ba_step = tracker.make_incremental_step(
            iterations, None, soft_gate_alpha, soft_gate_power, robust_delta
        )
        windowed = False
    else:
        ba_step = tracker.make_windowed_step(
            window, iterations, None, soft_gate_alpha, soft_gate_power,
            robust_delta,
        )
        windowed = True

    def caps_off(cfg):
        return dataclasses.replace(
            cfg, dist_gather_cap=0, dist_gather_cap2=0, merge_cap=0
        )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: OnlineState, gray_u8, boxes_c, det_mask, i):
        graph, book = state.graph, state.book

        # the image ships as uint8 (rounded BT.601 grayscale is exactly
        # u8-representable) — 4x fewer bytes through the host->device link
        # than f32; cast on device.
        gray32 = gray_u8.astype(jnp.float32)
        # ---- line detection (always f32: dtype-pinned line sets, see
        # run_online_frontend) ------------------------------------------------
        lines32, lmask = detect_line_segments(gray32, detect_cfg)
        lines = lines32.astype(dtype)
        gray = gray32.astype(dtype)

        # ---- batched proposals at the FIXED first pose ----------------------
        cfg = ProposalConfig(
            max_lines=int(lines.shape[0]),
            sample_cam_roll_pitch=sample_cam_roll_pitch,
            **over,
        )
        xywh = jnp.stack(
            [
                boxes_c[:, 0] - 1.0,  # matlab -1 offset (main_obj.cpp:620)
                boxes_c[:, 1] - 1.0,
                boxes_c[:, 2] - boxes_c[:, 0],
                boxes_c[:, 3] - boxes_c[:, 1],
            ],
            axis=-1,
        ).astype(dtype)
        res = detect_cuboids(gray, K, T0_j, xywh, det_mask, lines, lmask, cfg)
        overflow = jnp.sum(res.cap_overflow).astype(jnp.int32)
        if exact_fallback:
            # caps-off exact recompute (pipeline._exact_gather_fallback as a
            # lax.cond: both proposal variants live in this one program)
            res = jax.lax.cond(
                overflow > 0,
                lambda: detect_cuboids(
                    gray, K, T0_j, xywh, det_mask, lines, lmask, caps_off(cfg)
                ),
                lambda: res,
            )
        det_valid = res.valid & det_mask
        any_valid = jnp.any(det_valid)

        # ---- tracklet association + book update -----------------------------
        alive = book.alive
        if track_max_age is not None:
            alive = alive & (i - book.last <= track_max_age)
        det_of_track, matched, det_is_new = associate_detections(
            book.bbox, alive, boxes_c.astype(dtype), det_valid, min_iou=min_iou
        )
        det_of_track, matched, used, alive, dropped = _spawn_new_tracks(
            book._replace(alive=alive), det_is_new, det_of_track, matched
        )

        meas9, quality, rng = _measurements_from_proposals(
            res, det_of_track, matched,
            jnp.asarray(roll0, dtype), jnp.asarray(pitch0, dtype),
            jnp.asarray(yaw0, dtype), cam_t, dtype,
            canonicalize_yaw=canonicalize_yaw,
        )

        dsafe = jnp.clip(det_of_track, 0, D - 1)
        box_of_track = boxes_c[dsafe].astype(dtype)
        book = OnlineBook(
            bbox=jnp.where(matched[:, None], box_of_track, book.bbox),
            alive=alive,
            used=used,
            last=jnp.where(matched, i, book.last),
            range=jnp.where(matched, rng, book.range),
            yaw=jnp.where(
                matched, res.rotY[dsafe].astype(dtype), book.yaw
            ),
            count=book.count + matched.astype(jnp.int32),
        )

        # ---- frame assembly + incremental BA --------------------------------
        x0, y0, x1, y1 = (box_of_track[:, j] for j in range(4))
        bbox_cxywh = jnp.stack(
            [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=-1
        )
        w = jnp.asarray(bbox_edge_weight, dtype)
        frame = tracker.FrameInput(
            meas=Cuboid.from_minimal(meas9),
            quality=quality,
            has_meas=matched,
            active=jnp.asarray(True),
            bbox=jnp.where(matched[:, None], bbox_cxywh, 0.0),
            bbox_weight=jnp.where(matched, w, jnp.zeros_like(quality)),
        )
        if windowed:
            (graph, prior), (chi2, _) = ba_step(
                (graph, state.prior), (i, frame, first_Twc)
            )
        else:
            prior = state.prior
            graph, (chi2, _) = ba_step(graph, (i, frame, first_Twc))

        Twc = graph.cam_Tcw[i].inverse()
        out = (
            jnp.concatenate([Twc.trans, Twc.quat]),
            StepReport(
                cap_overflow=overflow,
                cap_fallback=(overflow > 0) if exact_fallback
                else jnp.asarray(False),
                no_valid_proposal=~any_valid,
                n_matched=jnp.sum(matched & any_valid).astype(jnp.int32),
                dropped=dropped,
                chi2=chi2,
            ),
        )
        return OnlineState(graph, book, prior), out

    return step


class FusedRunResult(NamedTuple):
    traj_Twc_xyzq: np.ndarray  # (N, 7)
    cubes_minimal: np.ndarray  # (O, 9)
    cube_valid: np.ndarray  # (O,)
    chi2: np.ndarray  # (N,)
    report: dict  # aggregated counters
    syncs_per_frame: float  # measured blocking pulls / frame
    bytes_up_per_frame: float
    bytes_down_per_frame: float
    # host-clock seconds of each frame's loop iteration (read, upload,
    # dispatch, and the pull of the previous frame's pose); the first two
    # include tracing (and compiling) the two step variants
    frame_s: np.ndarray


def run_online_slam_fused(
    base_folder,
    n_frames: int | None = None,
    dtype=jnp.float32,
    max_objects: int = 1,
    max_detections: int = 1,
    overlap: bool = True,
    capacity: int | None = None,
    **step_kwargs,
):
    """Drive the fused step over a sequence in the reference's TUM dataset
    layout (object_slam/data/: raw_imgs/%04d_rgb_raw.{jpg,png,pgm},
    filter_2d_obj_txts/, truth_cam_poses.txt for the first pose): the
    single-dispatch production online loop.  A missing frame image raises;
    a missing detection file means no detections in that frame.

    With `overlap=True` the pose of frame i-1 is pulled while frame i's
    dispatch is in flight (one-frame latency, standard double buffering) —
    the count of blocking syncs per frame is 1 either way.

    Returns FusedRunResult (trajectory + aggregated report + measured
    transfer accounting)."""
    base = pathlib.Path(base_folder)
    truth = uio.read_number_txt(base / "truth_cam_poses.txt")
    n = truth.shape[0] if n_frames is None else min(n_frames, truth.shape[0])
    capacity = capacity or n  # fixed graph capacity: a warm-up run over a
    # few frames at the full capacity shares every compiled executable with
    # the real run (all shapes are capacity-static)
    K_np = TUM_FR3_K
    first = SE3.from_xyzq(jnp.asarray(truth[0, 1:8], dtype))
    T0_np = np.asarray(first.matrix(), np.float64)

    D = max_detections
    mk = functools.partial(
        make_online_step,
        K_np, T0_np, capacity, dtype,
        max_objects=max_objects, max_detections=D, **step_kwargs,
    )
    step0 = mk(sample_cam_roll_pitch=False)  # main_obj.cpp:624
    stepN = mk(sample_cam_roll_pitch=True)

    graph = CameraObjectGraph.empty(capacity, max_objects, dtype)._replace(
        K=jnp.asarray(K_np, dtype)
    )
    window = step_kwargs.get("window")
    if window is not None and window < capacity:
        from cube_slam_wu_tpu.slam.window import CubePrior

        prior = CubePrior.empty(max_objects, dtype)
    else:
        prior = None
    state = OnlineState(graph, OnlineBook.empty(max_objects, dtype), prior)

    bytes_up = bytes_down = 0
    n_syncs = 0
    outs = []
    frame_s = []
    pending = None

    def pull(p):
        nonlocal n_syncs, bytes_down
        host = jax.device_get(p)
        n_syncs += 1
        bytes_down += sum(
            np.asarray(leaf).nbytes for leaf in jax.tree.leaves(host)
        )
        return host

    for i in range(n):
        t_frame = time.perf_counter()
        img_path = uio.frame_image_path(base, i)
        det_path = base / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt"
        if not img_path.exists():
            raise FileNotFoundError(f"frame {i}: no image at {img_path}")
        gray_np = uio.load_image_gray(img_path).astype(np.uint8)
        if det_path.exists():
            boxes_c, _conf, dmask = uio.read_detections_txt(det_path, n_max=D)
        else:
            boxes_c = np.zeros((D, 4))
            dmask = np.zeros(D, bool)
        gray = jnp.asarray(gray_np)
        boxes_j = jnp.asarray(boxes_c, dtype)
        dmask_j = jnp.asarray(dmask)
        bytes_up += gray_np.nbytes + boxes_j.nbytes + dmask_j.nbytes + 4
        step = step0 if i == 0 else stepN
        state, out = step(state, gray, boxes_j, dmask_j, jnp.asarray(i, jnp.int32))
        if overlap:
            if pending is not None:
                outs.append(pull(pending))
            pending = out
        else:
            outs.append(pull(out))
        frame_s.append(time.perf_counter() - t_frame)
    if pending is not None:
        outs.append(pull(pending))

    final = jax.device_get(
        (state.graph.cam_Twc().to_xyzq(), state.graph.cube.to_minimal(),
         state.graph.cube_valid)
    )
    traj, cubes, cube_valid = final
    report = dict(
        cap_overflow=int(sum(int(o[1].cap_overflow) for o in outs)),
        cap_fallbacks=int(sum(bool(o[1].cap_fallback) for o in outs)),
        no_valid_proposal=int(sum(bool(o[1].no_valid_proposal) for o in outs)),
        n_measurements=int(sum(int(o[1].n_matched) for o in outs)),
        dropped=int(sum(int(o[1].dropped) for o in outs)),
    )
    return FusedRunResult(
        traj_Twc_xyzq=np.asarray(traj),
        cubes_minimal=np.asarray(cubes),
        cube_valid=np.asarray(cube_valid),
        chi2=np.asarray([float(o[1].chi2) for o in outs]),
        report=report,
        syncs_per_frame=n_syncs / max(n, 1),
        bytes_up_per_frame=bytes_up / max(n, 1),
        bytes_down_per_frame=bytes_down / max(n, 1),
        frame_s=np.asarray(frame_s),
    )
