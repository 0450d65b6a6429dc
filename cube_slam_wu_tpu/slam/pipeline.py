"""End-to-end SLAM pipelines over the reference dataset layout.

Offline mode replays precomputed cuboid detections
(detect_cuboids_saved.txt + pop_cam_poses_saved.txt, mirroring
object_slam/src/main_obj.cpp:682-722 and main():844-904); online mode runs
the full front-end (lines -> proposals) per frame.  Data paths follow the
reference `object_slam/data/` contract.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam import tracker
from cube_slam_wu_tpu.utils import io as uio


class OfflineData(NamedTuple):
    pred_objects: np.ndarray  # rows: frame x y z yaw l w h err
    init_poses: np.ndarray  # rows: t x y z qx qy qz qw (pop cam poses)
    truth_poses: np.ndarray  # rows: t x y z qx qy qz qw


def load_offline_dataset(base_folder) -> OfflineData:
    base = pathlib.Path(base_folder)
    return OfflineData(
        pred_objects=uio.read_number_txt(base / "detect_cuboids_saved.txt"),
        init_poses=uio.read_number_txt(base / "pop_cam_poses_saved.txt"),
        truth_poses=uio.read_number_txt(base / "truth_cam_poses.txt"),
    )


def _default_dtype():
    """float64 when x64 is enabled (CPU tests), else float32 (the
    accelerator path — avoids per-array truncation warnings)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def build_offline_frames(data: OfflineData, dtype=None) -> tracker.FrameInput:
    """Assemble per-frame measurement inputs from the offline txts
    (main_obj.cpp:682-736)."""
    dtype = dtype or _default_dtype()
    n = data.truth_poses.shape[0]
    meas9 = np.zeros((n, 9))
    quality = np.zeros((n,))
    has = np.zeros((n,), bool)

    by_frame = {int(r[0]): r for r in data.pred_objects}
    for i in range(n):
        row = by_frame.get(i)
        if row is None:
            continue
        cube_pose = np.array(
            [row[1], row[2], row[3], 0.0, 0.0, row[4], row[5], row[6], row[7]]
        )
        cam_pop = SE3.from_xyzq(jnp.asarray(data.init_poses[i, 1:8], dtype))
        cube_ground = Cuboid.from_minimal(jnp.asarray(cube_pose, dtype))
        local = cube_ground.transform_to(cam_pop)
        meas9[i] = np.asarray(local.to_minimal())
        quality[i] = (1.0 - row[8] + 0.5) / 2.0
        has[i] = True

    # single-landmark dataset -> object axis O = 1
    meas = Cuboid.from_minimal(jnp.asarray(meas9[:, None, :], dtype))
    return tracker.FrameInput(
        meas=meas,
        quality=jnp.asarray(quality[:, None], dtype),
        has_meas=jnp.asarray(has[:, None]),
        active=jnp.ones((n,), bool),
    )


class FrontendReport(NamedTuple):
    """Per-run accounting of skipped/failed frames (VERDICT 5.3: surface
    pipeline-level failures instead of silently continuing)."""

    n_frames: int
    missing_image: list
    missing_detections: list
    empty_detections: list
    no_valid_proposal: list
    dropped_detections: int  # valid detections with no free object slot
    far_spawns: int = 0  # new-object spawns skipped by spawn_range_m
    # frames where a binding ProposalConfig.dist_gather_cap shed valid
    # hypotheses; each such frame is transparently recomputed with the exact
    # full gather (cap_fallbacks counts the reruns), so a binding cap can
    # never silently change a ranking off-distribution
    cap_overflow_frames: int = 0
    cap_fallbacks: int = 0

    def summary(self) -> str:
        return (
            f"frames={self.n_frames} missing_img={len(self.missing_image)} "
            f"missing_det={len(self.missing_detections)} "
            f"empty_det={len(self.empty_detections)} "
            f"no_proposal={len(self.no_valid_proposal)} "
            f"dropped_det={self.dropped_detections} "
            f"far_spawns={self.far_spawns} "
            f"cap_overflow={self.cap_overflow_frames}"
        )


def _exact_gather_fallback(res, report, recompute):
    """dist_gather_cap safety net (ProposalConfig.dist_gather_cap): if the
    compacted chamfer gather shed valid hypotheses this frame
    (res.cap_overflow > 0 for any detection), transparently recompute with
    the caps disabled — the exact full gather — so a binding cap can never
    silently change a ranking on off-distribution scenes.  `recompute()`
    re-runs the frame's detect call with a caps-off config (compiled once,
    only when first needed)."""
    if int(np.sum(np.asarray(res.cap_overflow))) == 0:
        return res, report
    report = report._replace(
        cap_overflow_frames=report.cap_overflow_frames + 1,
        cap_fallbacks=report.cap_fallbacks + 1,
    )
    return recompute(), report


def _caps_off(cfg):
    return dataclasses.replace(
        cfg, dist_gather_cap=0, dist_gather_cap2=0, merge_cap=0
    )


def _associate_local(book, boxes_c, det_valid, min_iou):
    """(O x D) IoU association of the host tracklet book against this
    frame's detections; returns writable host copies."""
    from cube_slam_wu_tpu.ops.association import associate_detections

    out = associate_detections(
        jnp.asarray(book.bbox),
        jnp.asarray(book.alive),
        jnp.asarray(boxes_c),
        jnp.asarray(det_valid),
        min_iou=min_iou,
    )
    # one transfer, writable copies (np.asarray of a jax array is RO)
    return tuple(np.array(v) for v in jax.device_get(out))


def _se3_inv_mat(T: np.ndarray) -> np.ndarray:
    """Exact inverse of a rigid 4x4 (R^T, -R^T t) on the host."""
    out = np.eye(4)
    R = T[:3, :3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


# Per-frame device work consolidated into single launches: the online loop
# builds its FrameInput and reads back the post-step state via ONE jitted
# call each, with numpy leaves transferred at dispatch, instead of one eager
# launch and one transfer per leaf.


@jax.jit
def _assemble_frame(meas9, quality, has, bbox, w):
    return tracker.FrameInput(
        meas=Cuboid.from_minimal(meas9),
        quality=quality,
        has_meas=has,
        active=jnp.asarray(True),
        bbox=bbox,
        bbox_weight=jnp.where(has, w, jnp.zeros_like(w)),
    )


@jax.jit
def _post_step_state(g, i):
    """Everything the next iteration's host-side prediction and
    association gate need, in one launch."""
    i0 = jnp.maximum(i - 1, 0)
    return (
        g.cam_Tcw[i].matrix(),
        g.cam_Tcw[i0].matrix(),
        g.cube.pose.trans,
        g.cube_valid,
    )


class _TrackletBook:
    """Host-side tracklet slots shared by the online drivers (the two-phase
    `run_online_frontend` and the interleaved `_run_kitti_tracked`):
    per-slot last-box / liveness / association bookkeeping.  Association
    *policy* (IoU matching, depth gates, spawn gates) stays in the drivers;
    this holds the state transitions they share.  Slots are never reused
    once retired — a retired slot's landmark estimate belongs to the old
    object."""

    _KEYS = (
        "track_bbox", "track_alive", "track_used", "track_last",
        "track_range", "track_yaw", "meas_count",
    )

    def __init__(self, n_slots: int):
        self.bbox = np.zeros((n_slots, 4))  # last associated box (corners)
        self.alive = np.zeros(n_slots, bool)  # currently matchable
        self.used = np.zeros(n_slots, bool)  # ever spawned
        self.last = np.full(n_slots, -1)  # frame of last association
        self.range = np.full(n_slots, -1.0)  # last camera-relative range
        self.yaw = np.full(n_slots, np.nan)  # last accepted yaw (prior)
        self.count = np.zeros(n_slots, np.int64)  # accepted measurements

    def _arrays(self):
        return (self.bbox, self.alive, self.used, self.last, self.range,
                self.yaw, self.count)

    def retire_stale(self, i: int, max_age: int | None) -> None:
        """Stop matching tracks not associated for > max_age frames (a
        stale box left where an object exited otherwise captures the next
        object entering near that image position)."""
        if max_age is not None:
            self.alive[self.alive & (i - self.last > max_age)] = False

    def spawn(self) -> int | None:
        """Claim the first never-used slot; None when all are taken."""
        free = np.nonzero(~self.used)[0]
        if free.size == 0:
            return None
        o = int(free[0])
        self.alive[o] = True
        self.used[o] = True
        return o

    def accept(self, o: int, i: int, box, rng: float, yaw: float) -> None:
        self.bbox[o] = box
        self.last[o] = i
        self.range[o] = rng
        self.yaw[o] = yaw
        self.count[o] += 1

    def state(self) -> dict:
        return dict(zip(self._KEYS, self._arrays()))

    def load_state(self, data) -> None:
        for key, arr in zip(self._KEYS, self._arrays()):
            if key in data:  # older checkpoints lack some keys
                arr[:] = data[key]


def _proposal_measurement(
    res, d: int, roll, pitch, yaw, cam_t, dtype, canonicalize_yaw=True
):
    """Ground-frame proposal row `d` -> (camera-frame 9-DoF measurement,
    fit quality, camera-relative range).  Mirrors the reference's
    measurement assembly (main_obj.cpp:649-675; quality :732); shared by
    both online drivers.

    Canonicalizes the front face: rotates yaw by the multiple of 90 deg
    that brings it nearest the facing-the-camera init (camera_yaw - 90,
    box_proposal_detail.cpp:180), swapping l/w on odd multiples.
    Equivalent for every downstream consumer (the cuboid edge
    disambiguates with min_log_error, g2o_Object.h:76-101) but makes the
    measurement invariant to which of the 4 equivalent front-face
    labelings the f32/f64 grids pick.  The camera pose used for the
    transform carries the proposal's sampled roll/pitch deltas
    (main_obj.cpp:667-675)."""
    from cube_slam_wu_tpu.core import rotations as rotu

    yaw_init = yaw - np.pi / 2
    k = (
        int(np.round((float(res.rotY[d]) - yaw_init) / (np.pi / 2)))
        if canonicalize_yaw
        else 0
    )
    yaw_c = float(res.rotY[d]) - k * (np.pi / 2)
    sl, sw = (
        (float(res.scale[d][1]), float(res.scale[d][0]))
        if k % 2
        else (float(res.scale[d][0]), float(res.scale[d][1]))
    )
    cube_ground = Cuboid.from_minimal(
        jnp.asarray(
            [*res.pos[d], 0.0, 0.0, yaw_c, sl, sw, float(res.scale[d][2])],
            dtype,
        )
    )
    R_new = rotu.euler_zyx_to_rot(
        jnp.asarray(roll + float(res.camera_roll_delta[d]), dtype),
        jnp.asarray(pitch + float(res.camera_pitch_delta[d]), dtype),
        jnp.asarray(yaw, dtype),
    )
    pose_used = SE3.from_rot_trans(R_new, jnp.asarray(cam_t, dtype))
    local = cube_ground.transform_to(pose_used)
    quality = (1.0 - float(res.normalized_error[d]) + 0.5) / 2.0
    rng = float(np.linalg.norm(np.asarray(res.pos[d]) - np.asarray(cam_t)))
    return np.asarray(local.to_minimal()), quality, rng


def run_online_frontend(
    frame_specs,
    K_np: np.ndarray,
    first_Twc: SE3,
    dtype,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    max_objects: int = 1,
    max_detections: int | None = None,
    min_iou: float = 0.3,
    use_yaw_prior: bool = False,
    canonicalize_yaw: bool = True,
    line_track_weight: float = 0.0,
    line_track_gate: float = 80.0,
    checkpoint_path=None,
    checkpoint_every: int = 25,
    track_max_age: int | None = None,
    depth_gate_m: float | None = None,
    spawn_range_m: float | None = None,
    range_weight_m: float | None = None,
):
    """Multi-object online front-end: per frame, line detection -> batched
    cuboid proposals for every 2D detection -> IoU tracklet association into
    fixed object slots.  Returns (FrameInput with (N, O) axes, FrontendReport).

    `depth_gate_m` is a pose-free association gate for moving-camera
    (KITTI-class) scenes: an IoU match is DROPPED when the detection's
    camera-relative range jumps more than this many metres from the
    track's last accepted range.  2D-IoU-only association builds CHIMERA
    tracks on forward drives — as the camera passes object A, object B
    enters the view overlapping A's stale box and the track hands off
    seamlessly between objects (measured: one track spanning 70 frames /
    35 m of travel with 21 m measurement errors).  A handoff jumps the
    range discontinuously (departing object ~2-3 m, entrant ~7-8 m), so
    range continuity vetoes it; the starved stale track then retires by
    `track_max_age` and the entrant spawns a fresh landmark.  None
    (default) disables — the reference's near-static single-object TUM
    scene never needs it.

    `spawn_range_m` refuses to SPAWN a landmark from a detection whose
    lifted camera-relative range exceeds this many metres.  Monocular
    ground-plane lift precision degrades quadratically with range (a
    sub-pixel bbox error at 36 m lifted to a 21 m position error in the
    measurement audit), and a track seeded from one garbage far proposal
    usually starves immediately — leaving a permanent wild landmark.
    Existing tracks keep being measured at any range (their graph weight
    already reflects proposal quality).  None (default) disables.

    `range_weight_m` scales each accepted measurement's quality by
    `min(1, (range_weight_m / range)^2)`: monocular ground-plane lift
    position noise grows ~quadratically with range (a fixed pixel error
    spans `r/f` metres laterally and `r^2/(f*h)` in depth), so a far
    measurement carries quadratically less information than the
    reference's fit-quality-only weight (main_obj.cpp:732) assigns it.
    None (default) keeps reference behaviour.

    `checkpoint_path` enables elastic resume for long (KITTI-length) runs:
    every `checkpoint_every` frames the accumulated measurements + tracklet
    state are saved (slam.checkpoint npz); an existing file resumes the loop
    at the first unprocessed frame (the reference's crash story is "rerun
    from scratch", SURVEY.md section 5.3).  Line-track descriptor state is
    not checkpointed: after a resume the first frame simply has no
    frame-to-frame match info (one-frame quality detail, only when
    line_track_weight > 0).

    `frame_specs` is a list of (image_path, detections_path) per frame.
    Mirrors the reference online branch (main_obj.cpp:585-679) but
    generalised from its `frames_cuboids[0][0]` single-landmark shortcut
    (main_obj.cpp:647) to O object slots via
    ops.association.associate_detections; proposals for frames > 0 are
    generated around the FIRST camera pose with roll/pitch sampling
    (main_obj.cpp:624-628), so no tracker feedback enters the front-end.

    `use_yaw_prior` threads each track's accepted yaw into the next frame's
    hypothesis scoring (the reference's box_proposal_detail.cpp:178 TODO).
    Off by default: on the bundled sequence it locks onto early yaw errors
    and degrades ATE (0.186 -> 0.56 aligned).

    `track_max_age` retires a track whose last association is more than
    that many frames old: its slot stops matching new detections (a stale
    2D box left where an object EXITED the view otherwise captures the
    next object that ENTERS near that image position, cross-contaminating
    landmarks — measured as 24-34 m landmark errors on a 300-frame
    forward drive).  Retired slots stay dead (their landmark keeps its
    estimate via the graph); new objects spawn into never-used slots.
    None (default) never retires — the reference's single-object TUM
    behaviour, where the one object is observed in nearly every frame.
    """
    from cube_slam_wu_tpu.core import rotations as rotu
    from cube_slam_wu_tpu.ops.detect import (
        DetectConfig,
        detect_line_segments as _dls,
        detect_line_segments_recover,
    )
    from cube_slam_wu_tpu.ops.proposal import (
        ProposalConfig,
        detect_cuboid_single,
        detect_cuboids,
    )

    detect_cfg = detect_cfg or DetectConfig()
    detect_line_segments = (
        detect_line_segments_recover if detect_cfg.short_recovery else _dls
    )
    over = dict(proposal_overrides or {})
    over.setdefault("nominal_skew_ratio", 2.0)  # main_obj.cpp:499
    # f32-stable winner selection (see ProposalConfig.rank_margin): the
    # online path runs f32, where plain argmin flips near-ties.
    # Swept {0, 3e-4, 1e-3, 2e-3} x {f32, f64} on the full 58-frame run:
    # every setting is dtype-stable to <=0.05% ATE once lines/merge are
    # dtype-pinned and the chamfer sampling is bilinear; 2e-3 is the best
    # ATE (0.2413, bit-equal across dtypes) while 5e-3 already biases the
    # ranking toward low grid indices (0.24 -> 0.28 ATE in ablation).
    over.setdefault("rank_margin", 2e-3)
    # smooth chamfer sampling (see ProposalConfig.bilinear_dist): kills the
    # pixel-boundary score jumps that dominate the residual f32 noise
    over.setdefault("bilinear_dist", True)
    n = len(frame_specs)
    O = max_objects
    D = max_detections or max(1, max_objects)

    T0 = np.asarray(first_Twc.matrix())
    roll0, pitch0, yaw0 = (
        float(v) for v in rotu.rot_to_euler_zyx(jnp.asarray(T0[:3, :3]))
    )
    K = jnp.asarray(K_np, dtype)
    T0_j = jnp.asarray(T0, dtype)

    meas9 = np.zeros((n, O, 9))
    quality = np.zeros((n, O))
    has = np.zeros((n, O), bool)
    bbox2d = np.zeros((n, O, 4))  # associated YOLO box as [cx, cy, w, h]
    book = _TrackletBook(O)
    report = FrontendReport(n, [], [], [], [], 0)
    # line-track consistency state (VERDICT round-1 item 7): LBD float
    # descriptors of the previous frame's lines, matched frame-to-frame to
    # down-weight cuboid measurements from frames whose ROI line sets are
    # unstable.  line_track_weight=0 disables (reference behaviour: quality
    # depends only on the proposal error, main_obj.cpp:732).
    prev_lines32 = prev_lmask = prev_desc = None
    line_matched = mids32 = None

    start_frame = 0
    if checkpoint_path is not None:
        from cube_slam_wu_tpu.slam import checkpoint as ckpt

        def _ckpt_state():
            return dict(
                i_next=np.asarray(start_frame),
                meas9=meas9, quality=quality, has=has, bbox2d=bbox2d,
                **book.state(),
                missing_image=np.asarray(report.missing_image, np.int64),
                missing_detections=np.asarray(
                    report.missing_detections, np.int64
                ),
                empty_detections=np.asarray(
                    report.empty_detections, np.int64
                ),
                no_valid_proposal=np.asarray(
                    report.no_valid_proposal, np.int64
                ),
                dropped=np.asarray(report.dropped_detections),
                far_spawns=np.asarray(report.far_spawns),
                cap_overflow_frames=np.asarray(report.cap_overflow_frames),
                cap_fallbacks=np.asarray(report.cap_fallbacks),
            )

        cp = ckpt._resolve(checkpoint_path)
        if cp.exists():
            data = np.load(cp)
            # prefix copy: an interrupted run may have been saved with a
            # shorter frame list than this resume (or vice versa)
            m = min(n, data["meas9"].shape[0])
            start_frame = min(int(data["i_next"]), n)
            meas9[:m] = data["meas9"][:m]
            quality[:m] = data["quality"][:m]
            has[:m] = data["has"][:m]
            bbox2d[:m] = data["bbox2d"][:m]
            book.load_state(data)
            report = FrontendReport(
                n,
                list(data["missing_image"]),
                list(data["missing_detections"]),
                list(data["empty_detections"]),
                list(data["no_valid_proposal"]),
                int(data["dropped"]),
                int(data["far_spawns"]) if "far_spawns" in data else 0,
                cap_overflow_frames=(
                    int(data["cap_overflow_frames"])
                    if "cap_overflow_frames" in data
                    else 0
                ),
                cap_fallbacks=(
                    int(data["cap_fallbacks"]) if "cap_fallbacks" in data else 0
                ),
            )

    for i, (img_path, det_path) in enumerate(frame_specs):
        if i < start_frame:
            continue
        if (
            checkpoint_path is not None
            and i > start_frame
            and (i - start_frame) % max(checkpoint_every, 1) == 0
        ):
            state = _ckpt_state()
            state["i_next"] = np.asarray(i)
            ckpt.save_pytree(checkpoint_path, state)
        img_path = pathlib.Path(img_path)
        det_path = pathlib.Path(det_path)
        if not img_path.exists():
            report.missing_image.append(i)
            continue
        if not det_path.exists():
            report.missing_detections.append(i)
            continue
        boxes_c, conf, dmask = uio.read_detections_txt(det_path, n_max=D)
        if not dmask.any():
            report.empty_detections.append(i)
            continue
        gray = jnp.asarray(uio.load_image_gray(img_path), dtype)
        # line detection ALWAYS runs in f32: its vote accumulation / peak
        # ordering is dtype-sensitive (f64 vs f32 flip 1-2 borderline
        # segments), and a different line set shifts VP-support angle scores
        # by ~0.05 — far beyond any ranking margin.  Detecting in one fixed
        # dtype makes the f64 and f32 pipelines see identical lines, so
        # the remaining winner noise is ~1e-5 and rank_margin absorbs it.
        lines32, lmask = detect_line_segments(
            gray.astype(jnp.float32), detect_cfg
        )
        lines = lines32.astype(dtype)
        if line_track_weight > 0.0:
            from cube_slam_wu_tpu.ops import lbd as lbd_ops

            desc, dvalid = lbd_ops.lbd_descriptors(
                gray.astype(jnp.float32), lines32, lmask
            )
            dvalid = dvalid & lmask
            line_matched = None
            if prev_desc is not None:
                _, _, matched_j = lbd_ops.l2_match(
                    desc,
                    prev_desc,
                    dvalid,
                    prev_lmask,
                    query_lines=lines32,
                    train_lines=prev_lines32,
                    max_midpoint_dist=line_track_gate,
                )
                line_matched = np.asarray(matched_j)
                mids32 = np.asarray(
                    0.5 * (lines32[:, 0:2] + lines32[:, 2:4])
                )
            prev_lines32, prev_lmask, prev_desc = lines32, dvalid, desc
        cfg = ProposalConfig(
            max_lines=int(lines.shape[0]),
            sample_cam_roll_pitch=(i != 0),  # main_obj.cpp:624
            **over,
        )
        # corners -> [x y w h] with the matlab -1 offset (main_obj.cpp:620)
        xywh = np.column_stack(
            [
                boxes_c[:, 0] - 1.0,
                boxes_c[:, 1] - 1.0,
                boxes_c[:, 2] - boxes_c[:, 0],
                boxes_c[:, 3] - boxes_c[:, 1],
            ]
        )
        if O == 1 and D == 1 and use_yaw_prior:
            # single-track path keeps the per-track yaw prior plumbing
            prior = (
                jnp.asarray(book.yaw[0], dtype)
                if np.isfinite(book.yaw[0])
                else None
            )
            def one_det(c, _prior=prior):
                r = detect_cuboid_single(
                    gray, K, T0_j, jnp.asarray(xywh[0], dtype), lines, lmask,
                    c, yaw_prior=_prior,
                )
                return jax.tree.map(
                    lambda a: np.asarray(a)[None], jax.device_get(r)
                )

            res = one_det(cfg)
            res, report = _exact_gather_fallback(
                res, report, lambda: one_det(_caps_off(cfg))
            )
        else:
            def many_det(c):
                r = detect_cuboids(
                    gray, K, T0_j, jnp.asarray(xywh, dtype),
                    jnp.asarray(dmask), lines, lmask, c,
                )
                return jax.device_get(r)

            res = many_det(cfg)
            res, report = _exact_gather_fallback(
                res, report, lambda: many_det(_caps_off(cfg))
            )
        det_valid = res.valid & dmask
        if not det_valid.any():
            report.no_valid_proposal.append(i)
            continue

        book.retire_stale(i, track_max_age)
        det_of_track, matched, det_is_new = _associate_local(
            book, boxes_c, det_valid, min_iou
        )
        if depth_gate_m is not None:
            # camera-relative range of each candidate (flat-ground lift is
            # camera-relative-correct even at the fixed pose, so this range
            # is the true depth up to measurement noise)
            cam_t = T0[:3, 3]
            for o in np.nonzero(matched)[0]:
                d = int(det_of_track[o])
                rng_d = float(np.linalg.norm(np.asarray(res.pos[d]) - cam_t))
                if (
                    book.range[o] >= 0.0
                    and abs(rng_d - book.range[o]) > depth_gate_m
                ):
                    matched[o] = False  # drop the handoff measurement
        # spawn new tracks into free (never-used) slots (caller-side policy;
        # the op only flags candidates)
        for d in np.nonzero(det_is_new)[0]:
            if spawn_range_m is not None:
                rng_d = float(
                    np.linalg.norm(np.asarray(res.pos[d]) - T0[:3, 3])
                )
                if rng_d > spawn_range_m:
                    report = report._replace(
                        far_spawns=report.far_spawns + 1
                    )
                    continue
            o = book.spawn()
            if o is None:
                report = report._replace(
                    dropped_detections=report.dropped_detections + 1
                )
                continue
            det_of_track[o] = d
            matched[o] = True

        for o in np.nonzero(matched)[0]:
            d = int(det_of_track[o])
            meas9[i, o], quality[i, o], rng_d = _proposal_measurement(
                res, d, roll0, pitch0, yaw0, T0[:3, 3], dtype,
                canonicalize_yaw=canonicalize_yaw,
            )
            book.accept(o, i, boxes_c[d], rng_d, float(res.rotY[d]))
            if range_weight_m is not None:
                quality[i, o] *= min(
                    1.0, (range_weight_m / max(rng_d, 1e-6)) ** 2
                )
            if line_track_weight > 0.0 and line_matched is not None:
                # fraction of this track's ROI lines that found a
                # frame-to-frame descriptor match: unstable line sets imply
                # an unstable proposal, so scale the measurement weight
                x0b, y0b, x1b, y1b = boxes_c[d]
                mx, my = (x0b + x1b) / 2, (y0b + y1b) / 2
                hw = (x1b - x0b) * 0.6 + 10
                hh = (y1b - y0b) * 0.6 + 10
                roi = (
                    np.asarray(lmask)
                    & (np.abs(mids32[:, 0] - mx) < hw)
                    & (np.abs(mids32[:, 1] - my) < hh)
                )
                cons = float(line_matched[roi].mean()) if roi.any() else 0.0
                quality[i, o] *= (1.0 - line_track_weight) + (
                    line_track_weight * cons
                )
            x0b, y0b, x1b, y1b = boxes_c[d]
            bbox2d[i, o] = [
                (x0b + x1b) / 2, (y0b + y1b) / 2, x1b - x0b, y1b - y0b
            ]
            has[i, o] = True

    if checkpoint_path is not None:
        state = _ckpt_state()
        state["i_next"] = np.asarray(n)
        ckpt.save_pytree(checkpoint_path, state)

    frames = tracker.FrameInput(
        meas=Cuboid.from_minimal(jnp.asarray(meas9, dtype)),
        quality=jnp.asarray(quality, dtype),
        has_meas=jnp.asarray(has),
        active=jnp.ones((n,), bool),
        bbox=jnp.asarray(bbox2d, dtype),
        bbox_weight=jnp.zeros((n, O), dtype),  # caller scales (bbox_edge_weight)
    )
    return frames, report


def run_online_slam(
    base_folder,
    n_frames: int | None = None,
    iterations: int = 5,
    dtype=None,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    soft_gate_alpha: float | None = 1.0,
    refine_with_points: bool = False,
    use_yaw_prior: bool = False,
    max_objects: int = 1,
    max_detections: int | None = None,
    min_iou: float = 0.3,
    window: int | None = None,
    line_track_weight: float = 0.0,
    robust_delta: float | None = None,
    bbox_edge_weight: float = 0.005,
    point_weight: float = 0.0,
    n_points: int = 128,
    checkpoint_path=None,
    checkpoint_every: int = 25,
):
    """Full online mono pipeline over the reference dataset layout: per-frame
    line detection -> cuboid proposals (all detections) -> IoU association
    into object slots -> incremental BA (mirrors main_obj.cpp online branch,
    :585-679, generalised to `max_objects` landmarks).

    `bbox_edge_weight` adds EdgeSE3CuboidProj factors on the associated
    YOLO boxes (g2o_Object.h:264-292 — shipped by the reference but unused
    by its driver, which builds only the 3D edge, main_obj.cpp:762-782).
    The 2D box anchors the projected cuboid against the detector's most
    reliable signal; on the full bundled 58-frame run this is the largest
    single quality lever measured:
    ATE 0.2353 -> 0.1789 direct / 0.1966 -> 0.1311 aligned at the default
    (weight 0.005, soft_gate_alpha 1.0), beating BOTH the reference's
    committed output (0.2205/0.1704) and our own offline parity run
    (0.2014).  The basin is flat (0.003..0.006 all <= 0.184) and the result
    is bit-identical in float32.  Set 0.0 for reference-parity behaviour
    (gate alpha 2.0 was the optimum there, ATE 0.2353).

    `checkpoint_path` threads the front-end's elastic-resume checkpoint
    (see run_online_frontend): a COMPLETED checkpoint doubles as a
    front-end cache — re-runs with different backend settings
    (bbox_edge_weight / soft_gate_alpha / window) skip the per-frame
    detect+propose loop entirely and only re-run the BA."""
    dtype = dtype or _default_dtype()
    base = pathlib.Path(base_folder)
    truth = uio.read_number_txt(base / "truth_cam_poses.txt")
    n = truth.shape[0] if n_frames is None else min(n_frames, truth.shape[0])

    K_np = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1.0]])
    first_Twc = SE3.from_xyzq(jnp.asarray(truth[0, 1:8], dtype))

    frame_specs = [
        (
            uio.frame_image_path(base, i),
            base / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt",
        )
        for i in range(n)
    ]
    frames, report = run_online_frontend(
        frame_specs,
        K_np,
        first_Twc,
        dtype,
        detect_cfg=detect_cfg,
        proposal_overrides=proposal_overrides,
        max_objects=max_objects,
        max_detections=max_detections,
        min_iou=min_iou,
        use_yaw_prior=use_yaw_prior,
        line_track_weight=line_track_weight,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
    )
    if bbox_edge_weight > 0.0:
        # EdgeSE3CuboidProj factors on the associated YOLO boxes
        # (g2o_Object.h:264-292; beyond the reference driver, which builds
        # only the 3D edge, main_obj.cpp:762-782)
        frames = frames._replace(
            bbox_weight=jnp.where(
                frames.has_meas, jnp.asarray(bbox_edge_weight, dtype), 0.0
            )
        )
    point_obs = None
    if point_weight > 0.0:
        if window is None or window >= n:
            raise ValueError("point_weight > 0 requires a fixed-lag window")
        from cube_slam_wu_tpu.slam.features import build_point_tracks

        if all(pathlib.Path(img).exists() for img, _ in frame_specs):
            grays = [
                jnp.asarray(uio.load_image_gray(img), jnp.float32)
                for img, _ in frame_specs
            ]
            obs_uv, obs_mask = build_point_tracks(grays, max_corners=n_points)
            point_obs = (obs_uv[:n], obs_mask[:n])
        # frames with missing images would misalign the track raster;
        # fall back to the point-free windowed path (report carries the
        # missing-image list)

    graph, chi2s, cube_hist = tracker.run_incremental(
        first_Twc,
        frames,
        iterations=iterations,
        soft_gate_alpha=soft_gate_alpha,
        window=window,
        robust_delta=robust_delta,
        K=jnp.asarray(K_np, dtype)
        if (bbox_edge_weight > 0.0 or point_obs is not None)
        else None,
        point_obs=point_obs,
        point_weight=point_weight,
    )

    if refine_with_points:
        graph = _point_refinement(graph, base, n, jnp.asarray(K_np, dtype), dtype)

    traj = np.asarray(graph.cam_Twc().to_xyzq())
    cubes = np.asarray(graph.cube.to_minimal())
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cubes[0],
        chi2=np.asarray(chi2s),
        timestamps=truth[:n, 0],
        cube_history=np.asarray(cube_hist),
        cubes_minimal=cubes,
        cube_valid=np.asarray(graph.cube_valid),
        frontend_report=report,
    )


def run_kitti_slam(
    seq_dir,
    detections_dir,
    poses_path=None,
    n_frames: int | None = None,
    iterations: int = 5,
    dtype=None,
    detect_cfg=None,
    proposal_overrides: dict | None = None,
    soft_gate_alpha: float | None = 2.0,
    max_objects: int = 8,
    max_detections: int = 4,
    min_iou: float = 0.25,
    window: int | None = None,
    robust_delta: float | None = None,
    bbox_edge_weight: float = 0.0,
    checkpoint_path=None,
    checkpoint_every: int = 25,
    track_max_age: int | None = 12,
    depth_gate_m: float | None = 2.5,
    spawn_range_m="auto",
    min_meas: int = 2,
    range_weight_m: float | None = None,
    pose_feedback: bool = False,
    point_weight: float = 0.0,
    n_points: int = 96,
    point_opts: dict | None = None,
    line_track_weight="auto",
    line_track_gate: float = 80.0,
):
    """Multi-object online SLAM over a KITTI-odometry-layout sequence
    (BASELINE config 5; the reference's capability class per its paper,
    README.md:3-4 — the repo itself bundles no KITTI driver).

    Detections come from per-frame txts (`x y w h prob`, the reference's
    filter_2d_obj_txts contract); images from image_0/.

    `pose_feedback=True` interleaves front-end and back-end:
    each frame's proposal grid runs at the tracker's constant-velocity
    PREDICTED pose.  The reference's online branch instead reuses the
    first frame's pose for every frame (main_obj.cpp:624-628) — fine for
    its near-static TUM scene, but on a forward/curving drive the
    hypothesis grid's yaw window and ground geometry drift away from the
    camera and single-view winners become garbage with plausible 2D
    projections (measured: ATE 2.9 m after 100 synthetic frames, landmark
    errors 20+ m).  `pose_feedback=False` keeps the reference-parity
    two-phase schedule (front-end pass at the first pose, then one
    tracker scan).

    `min_meas` reports a landmark as valid only after it has accepted that
    many measurements: a slot seeded by a single garbage proposal that then
    starved (spawn_range_m catches most, not all) never anchors anything
    and should not appear in the output object set.  The graph itself
    keeps every slot (a one-measurement landmark is self-consistent and
    cannot distort the trajectory)."""
    from cube_slam_wu_tpu.utils import kitti as ukitti

    dtype = dtype or _default_dtype()
    seq = ukitti.load_sequence(seq_dir, poses_path)
    n_avail = len(seq.image_paths)
    n = n_avail if n_frames is None else min(n_frames, n_avail)
    if n == 0:
        raise ValueError(f"no images under {seq_dir}/image_0")
    if isinstance(spawn_range_m, str):  # "auto"
        # Gate on monocular DEPTH SENSITIVITY rather than a fixed range:
        # one pixel of bbox-bottom error lifts to ~r^2/(f*h_cam) metres of
        # depth error, so the range at which landmark seeding becomes
        # unreliable scales with sqrt(f*h_cam).  0.6 m/px is the measured
        # sweet spot (300-frame synthetic sweep, f=240/h=1.65: 10 m too
        # tight -> drift, 25 m too loose -> 7-8 m wild landmarks, ~15 m
        # best = 0.59 m/px; real KITTI f~718/h=1.65 lands at ~27 m).
        h_cam = (
            float(abs(seq.poses_T_wc[0][2, 3]))
            if seq.poses_T_wc is not None
            else ukitti.CAMERA_HEIGHT_M
        )
        h_cam = max(h_cam, 0.5)
        spawn_range_m = float(np.sqrt(0.6 * seq.K[0, 0] * h_cam))
    if point_weight > 0.0 and not pose_feedback:
        raise ValueError(
            "point_weight > 0 needs the interleaved loop (pose_feedback=True)"
        )
    if isinstance(line_track_weight, str):  # "auto"
        # Measured on the 120-frame interleaved drive: frame-to-frame
        # LBD line-consistency weighting rescues the cuboid-only backend
        # (ATE 19.2 -> 3.8 m at w=0.5: it down-weights the unstable
        # proposals that otherwise drag the pose) but HURTS on top of
        # joint point BA (0.69 -> 0.87 m: points already anchor the pose,
        # so down-weighting honest cuboid measurements only loses
        # information).  auto = 0.5 for the no-points interleaved mode,
        # else 0.
        line_track_weight = (
            0.5 if (pose_feedback and point_weight == 0.0) else 0.0
        )
    if pose_feedback:
        return _run_kitti_tracked(
            seq, n, dtype,
            iterations=iterations,
            detect_cfg=detect_cfg,
            proposal_overrides=proposal_overrides,
            soft_gate_alpha=soft_gate_alpha,
            max_objects=max_objects,
            max_detections=max_detections,
            min_iou=min_iou,
            window=window,
            robust_delta=robust_delta,
            bbox_edge_weight=bbox_edge_weight,
            track_max_age=track_max_age,
            spawn_range_m=spawn_range_m,
            min_meas=min_meas,
            range_weight_m=range_weight_m,
            detections_dir=detections_dir,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
            point_weight=point_weight,
            n_points=n_points,
            point_opts=point_opts,
            line_track_weight=line_track_weight,
            line_track_gate=line_track_gate,
        )

    if seq.poses_T_wc is not None:
        T0 = jnp.asarray(seq.poses_T_wc[0], dtype)
        first_Twc = SE3.from_rot_trans(T0[:3, :3], T0[:3, 3])
    else:
        from cube_slam_wu_tpu.utils.synth import camera_pose

        T0 = jnp.asarray(camera_pose(0.0), dtype)
        first_Twc = SE3.from_rot_trans(T0[:3, :3], T0[:3, 3])

    frame_specs = [
        (seq.image_paths[i], ukitti.detection_txt_path(detections_dir, i))
        for i in range(n)
    ]
    frames, report = run_online_frontend(
        frame_specs,
        seq.K,
        first_Twc,
        dtype,
        detect_cfg=detect_cfg,
        proposal_overrides=proposal_overrides,
        max_objects=max_objects,
        max_detections=max_detections,
        min_iou=min_iou,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        track_max_age=track_max_age,
        depth_gate_m=depth_gate_m,
        spawn_range_m=spawn_range_m,
        range_weight_m=range_weight_m,
    )
    if bbox_edge_weight > 0.0:
        frames = frames._replace(
            bbox_weight=jnp.where(
                frames.has_meas, jnp.asarray(bbox_edge_weight, dtype), 0.0
            )
        )
    graph, chi2s, cube_hist = tracker.run_incremental(
        first_Twc,
        frames,
        iterations=iterations,
        soft_gate_alpha=soft_gate_alpha,
        window=window,
        robust_delta=robust_delta,
        K=jnp.asarray(seq.K, dtype) if bbox_edge_weight > 0.0 else None,
    )
    traj = np.asarray(graph.cam_Twc().to_xyzq())
    cubes = np.asarray(graph.cube.to_minimal())
    meas_count = np.asarray(frames.has_meas).sum(axis=0)
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cubes[0],
        chi2=np.asarray(chi2s),
        timestamps=seq.timestamps[:n],
        cube_history=np.asarray(cube_hist),
        cubes_minimal=cubes,
        cube_valid=np.asarray(graph.cube_valid) & (meas_count >= min_meas),
        frontend_report=report,
    )


def _run_kitti_tracked(
    seq,
    n: int,
    dtype,
    iterations: int,
    detect_cfg,
    proposal_overrides,
    soft_gate_alpha,
    max_objects: int,
    max_detections: int,
    min_iou: float,
    window: int | None,
    robust_delta,
    bbox_edge_weight: float,
    track_max_age: int | None,
    detections_dir,
    spawn_range_m: float | None = 25.0,
    min_meas: int = 2,
    range_weight_m: float | None = None,
    checkpoint_path=None,
    checkpoint_every: int = 25,
    assoc_gate_m: float = 3.0,
    point_weight: float = 0.0,
    n_points: int = 96,
    point_opts: dict | None = None,
    line_track_weight: float = 0.0,
    line_track_gate: float = 80.0,
):
    """Interleaved front-end/back-end loop (see run_kitti_slam docstring):
    one jit-compiled tracker step per frame, with the next frame's proposal
    grid anchored at the tracker's constant-velocity predicted pose.

    `assoc_gate_m` is a 3D association gate only this interleaved mode can
    provide: an IoU match is vetoed when the detection's world-lifted
    cuboid position is more than this many metres from the track's current
    landmark estimate, and the detection spawns a new track instead.
    Without it, 2D-IoU-only association builds CHIMERA tracks on forward
    drives — as the camera passes object A, object B enters the view
    overlapping A's stale box and the track hands off seamlessly from
    object to object (measured: one track spanning 70 frames / 35 m of
    travel with 21 m measurement errors, dragging the trajectory to
    ATE 2.9 m).  Age-based retirement cannot break a seamless handoff.

    `point_weight > 0` adds point landmarks to the windowed joint BA (the
    paper's camera+points+objects coupling; requires `window`): Harris+ZNCC
    features tracked incrementally (slam.features.IncrementalTracker, slot
    reuse with respawn flags), triangulated/ground-bootstrapped and
    optimised inside each window (tracker.make_windowed_point_step).
    Ground hints come from corners below the principal row and outside
    every detection bbox."""
    from cube_slam_wu_tpu.ops.detect import DetectConfig, detect_line_segments
    from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboids
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph
    from cube_slam_wu_tpu.slam.window import CubePrior
    from cube_slam_wu_tpu.utils import kitti as ukitti

    detect_cfg = detect_cfg or DetectConfig()
    over = dict(proposal_overrides or {})
    over.setdefault("nominal_skew_ratio", 2.0)
    over.setdefault("rank_margin", 2e-3)
    over.setdefault("bilinear_dist", True)
    O, D = max_objects, max_detections
    K_j = jnp.asarray(seq.K, dtype)

    if seq.poses_T_wc is not None:
        T0 = np.asarray(seq.poses_T_wc[0])
    else:
        from cube_slam_wu_tpu.utils.synth import camera_pose

        T0 = np.asarray(camera_pose(0.0))
    first_Twc = SE3.from_rot_trans(
        jnp.asarray(T0[:3, :3], dtype), jnp.asarray(T0[:3, 3], dtype)
    )

    graph = CameraObjectGraph.empty(n, O, dtype)._replace(K=K_j)
    windowed = window is not None and window < n
    use_points = point_weight > 0.0
    if use_points and not windowed:
        raise ValueError("point_weight > 0 requires a fixed-lag window")
    ftracker = None
    if use_points:
        from cube_slam_wu_tpu.slam.features import IncrementalTracker

        step_fn = tracker.make_windowed_point_step(
            window, K_j, iterations, None, soft_gate_alpha, 1.0,
            robust_delta, point_weight=point_weight, **(point_opts or {}),
        )
        carry = (
            graph,
            CubePrior.empty(O, dtype),
            tracker.PointState.empty(n, n_points, dtype),
        )
        # level-camera horizon: ground candidates sit below the principal row
        ftracker = IncrementalTracker(
            n_points, horizon_row=float(seq.K[1, 2]) + 5.0
        )
    elif windowed:
        step_fn = tracker.make_windowed_step(
            window, iterations, None, soft_gate_alpha, 1.0, robust_delta
        )
        carry = (graph, CubePrior.empty(O, dtype))
    else:
        step_fn = tracker.make_incremental_step(
            iterations, None, soft_gate_alpha, 1.0, robust_delta
        )
        carry = graph
    step = jax.jit(step_fn)

    book = _TrackletBook(O)
    report = FrontendReport(n, [], [], [], [], 0)
    chi2s = np.zeros(n)
    cube_hist = np.zeros((n, O, 9))
    start_frame = 0
    # frame-to-frame LBD line tracking state (quality modulation; mirrors
    # run_online_frontend's line_track_weight block)
    prev_lines32 = prev_lmask = prev_desc = None
    line_matched = None
    mids32 = None
    if line_track_weight > 0.0:
        from cube_slam_wu_tpu.ops import lbd as lbd_ops

    if checkpoint_path is not None:
        from cube_slam_wu_tpu.slam import checkpoint as ckpt

        cp = ckpt._resolve(checkpoint_path)
        if cp.exists():
            # the checkpoint is TWO files written back-to-back (state, then
            # the graph carry); a crash between the writes — or a stale
            # state file from an earlier run — leaves a torn pair.  Treat
            # any unreadable half as "no checkpoint" instead of crashing.
            try:
                data = np.load(cp)
                resumed_carry = ckpt.load_pytree(
                    cp.parent / (cp.name + ".carry"), carry
                )
            except (OSError, ValueError, KeyError) as e:
                print(
                    f"[kitti] torn/stale checkpoint at {cp} ({e}); "
                    "starting fresh",
                    flush=True,
                )
                data = None
        else:
            data = None
        if data is not None:
            start_frame = min(int(data["i_next"]), n)
            carry = resumed_carry
            book.load_state(data)
            m = min(n, data["chi2s"].shape[0])
            chi2s[:m] = data["chi2s"][:m]
            cube_hist[:m] = data["cube_hist"][:m]
            if ftracker is not None:
                ftracker.load_state(data)
                prev = pathlib.Path(seq.image_paths[start_frame - 1]) if start_frame > 0 else None
                if prev is not None and prev.exists():
                    ftracker.prev_gray = jnp.asarray(
                        uio.load_image_gray(prev), jnp.float32
                    )

        def _save(i_next):
            ckpt.save_pytree(
                cp,
                dict(
                    i_next=np.asarray(i_next),
                    **book.state(),
                    **(ftracker.state() if ftracker is not None else {}),
                    chi2s=chi2s, cube_hist=cube_hist,
                ),
            )
            ckpt.save_pytree(cp.parent / (cp.name + ".carry"), carry)

    # Host-side caches refreshed from the ONE post-step transfer each frame:
    # the two most recent optimized Tcw matrices (constant-velocity pose
    # prediction) and the cuboid landmark positions/validity (3D association
    # gate).  Computing the prediction and gate from these instead of
    # touching the device graph removes 3 device round trips per frame.
    Tcw_prev = Tcw_prevprev = None  # (4,4) float64, frames i-1 / i-2
    cube_pos_h = np.zeros((O, 3))
    cube_valid_h = np.zeros(O, bool)
    for i in range(start_frame, n):
        if (
            checkpoint_path is not None
            and i > start_frame
            and (i - start_frame) % max(checkpoint_every, 1) == 0
        ):
            _save(i)

        g = carry[0] if windowed else carry
        if i > 0 and Tcw_prev is None:
            # resumed mid-run: one-time refill of the host caches
            Tcw_prev, Tcw_prevprev, cube_pos_h, cube_valid_h = jax.device_get(
                (
                    g.cam_Tcw[i - 1].matrix(),
                    g.cam_Tcw[max(i - 2, 0)].matrix(),
                    g.cube.pose.trans,
                    g.cube_valid,
                )
            )
            Tcw_prev = np.asarray(Tcw_prev, np.float64)
            Tcw_prevprev = np.asarray(Tcw_prevprev, np.float64)
            cube_pos_h = np.asarray(cube_pos_h)
            cube_valid_h = np.asarray(cube_valid_h)
        # constant-velocity predicted pose (the tracker will recompute the
        # same prediction inside _insert_frame), entirely on host
        if i == 0:
            T_pred = np.asarray(
                jax.device_get(first_Twc.matrix()), dtype=np.float64
            )
        else:
            if i > 1:
                pred_Tcw = Tcw_prev @ _se3_inv_mat(Tcw_prevprev) @ Tcw_prev
            else:
                pred_Tcw = Tcw_prev
            T_pred = _se3_inv_mat(pred_Tcw)
        # ZYX euler on host (rotations.rot_to_euler_zyx, regular branch) —
        # a device round trip here would be pure latency
        R_p = T_pred[:3, :3]
        pitch_p = float(np.arcsin(np.clip(-R_p[2, 0], -1.0, 1.0)))
        roll_p = float(np.arctan2(R_p[2, 1], R_p[2, 2]))
        yaw_p = float(np.arctan2(R_p[1, 0], R_p[0, 0]))

        meas9 = np.zeros((O, 9))  # from_minimal(0) == Cuboid.identity
        quality_i = np.zeros(O)
        has_i = np.zeros(O, bool)
        bbox_i = np.zeros((O, 4))

        img_path = pathlib.Path(seq.image_paths[i])
        det_path = pathlib.Path(ukitti.detection_txt_path(detections_dir, i))
        ok = True
        gray = None
        boxes_c = None
        gray32 = None
        if not img_path.exists():
            report.missing_image.append(i)
            ok = False
        else:
            # cast on the HOST and upload each dtype once: an on-device
            # .astype would be one more eager launch
            img_np = uio.load_image_gray(img_path)
            gray32 = jnp.asarray(np.asarray(img_np, np.float32))
            gray = (
                gray32
                if jnp.dtype(dtype) == jnp.float32
                else jnp.asarray(np.asarray(img_np, np.dtype(dtype)))
            )
        if ok and not det_path.exists():
            report.missing_detections.append(i)
            ok = False
        if ok:
            boxes_c, conf, dmask = uio.read_detections_txt(det_path, n_max=D)
            if not np.asarray(dmask).any():
                report.empty_detections.append(i)
                ok = False

        # -- incremental feature tracking (runs on every frame with an
        #    image, detections or not) ------------------------------------
        pt_obs = np.zeros((n_points, 2))
        pt_alive = np.zeros(n_points, bool)
        pt_respawn = np.zeros(n_points, bool)
        pt_ground = np.zeros(n_points, bool)
        if ftracker is not None and gray32 is not None:
            pt_obs, pt_alive, pt_respawn, pt_ground = ftracker.advance(
                gray32,
                np.asarray(boxes_c)[np.asarray(dmask)]
                if boxes_c is not None
                else None,
            )

        if ok:
            lines32, lmask = detect_line_segments(gray32, detect_cfg)
            if line_track_weight > 0.0:
                line_matched = None
                desc, dvalid = lbd_ops.lbd_descriptors(
                    gray32, lines32, lmask
                )
                dvalid = dvalid & lmask
                if prev_desc is not None:
                    _, _, matched_j = lbd_ops.l2_match(
                        desc, prev_desc, dvalid, prev_lmask,
                        query_lines=lines32, train_lines=prev_lines32,
                        max_midpoint_dist=line_track_gate,
                    )
                    line_matched = np.asarray(matched_j)
                    mids32 = np.asarray(
                        0.5 * (lines32[:, 0:2] + lines32[:, 2:4])
                    )
                prev_lines32, prev_lmask, prev_desc = lines32, dvalid, desc
            cfg = ProposalConfig(
                max_lines=int(lines32.shape[0]),
                sample_cam_roll_pitch=(i != 0),
                **over,
            )
            xywh = np.column_stack(
                [
                    np.asarray(boxes_c)[:, 0] - 1.0,
                    np.asarray(boxes_c)[:, 1] - 1.0,
                    np.asarray(boxes_c)[:, 2] - np.asarray(boxes_c)[:, 0],
                    np.asarray(boxes_c)[:, 3] - np.asarray(boxes_c)[:, 1],
                ]
            )
            def kitti_det(c):
                r = detect_cuboids(
                    gray, K_j, jnp.asarray(T_pred, dtype),
                    jnp.asarray(xywh, dtype), jnp.asarray(dmask),
                    lines32.astype(dtype), lmask, c,
                )
                return jax.device_get(r)

            res = kitti_det(cfg)
            res, report = _exact_gather_fallback(
                res, report, lambda: kitti_det(_caps_off(cfg))
            )
            det_valid = res.valid & np.asarray(dmask)
            if not det_valid.any():
                report.no_valid_proposal.append(i)
                ok = False
        if ok:
            book.retire_stale(i, track_max_age)
            det_of_track, matched, det_is_new = _associate_local(
                book, boxes_c, det_valid, min_iou
            )
            # 3D gate: res.pos is the cuboid position in the world frame of
            # the predicted pose; compare against the landmark estimate.
            # Policy on veto: DROP the measurement only.  Retiring the track
            # or spawning a new one here is a runaway under pose drift (a
            # drifted pose makes honest re-observations fail the gate, so
            # anchors die and pose-consistent duplicates — which cannot
            # anchor anything — take their slots: measured ATE 2.9 -> 29).
            # A dropped handoff measurement instead starves the stale track
            # until age retirement frees the entrant to spawn cleanly.
            if assoc_gate_m is not None and assoc_gate_m > 0:
                cube_pos = cube_pos_h  # (O, 3) cached from last step's pull
                cube_ok = cube_valid_h
                for o in np.nonzero(matched)[0]:
                    if not cube_ok[o]:
                        continue
                    d = int(det_of_track[o])
                    dist3 = float(
                        np.linalg.norm(np.asarray(res.pos[d]) - cube_pos[o])
                    )
                    if dist3 > assoc_gate_m:
                        matched[o] = False
            for d in np.nonzero(det_is_new)[0]:
                if spawn_range_m is not None:
                    rng_d = float(
                        np.linalg.norm(np.asarray(res.pos[d]) - T_pred[:3, 3])
                    )
                    if rng_d > spawn_range_m:
                        report = report._replace(
                            far_spawns=report.far_spawns + 1
                        )
                        continue
                o = book.spawn()
                if o is None:
                    report = report._replace(
                        dropped_detections=report.dropped_detections + 1
                    )
                    continue
                det_of_track[o] = d
                matched[o] = True
            for o in np.nonzero(matched)[0]:
                d = int(det_of_track[o])
                meas9[o], quality_i[o], rng_d = _proposal_measurement(
                    res, d, roll_p, pitch_p, yaw_p, T_pred[:3, 3], dtype
                )
                book.accept(
                    o, i, np.asarray(boxes_c)[d], rng_d, float(res.rotY[d])
                )
                if range_weight_m is not None:
                    quality_i[o] *= min(
                        1.0, (range_weight_m / max(rng_d, 1e-6)) ** 2
                    )
                if line_track_weight > 0.0 and line_matched is not None:
                    # fraction of the detection ROI's lines with a
                    # frame-to-frame descriptor match: unstable line sets
                    # imply an unstable proposal (run_online_frontend's
                    # identical block)
                    x0b, y0b, x1b, y1b = np.asarray(boxes_c)[d]
                    mx, my = (x0b + x1b) / 2, (y0b + y1b) / 2
                    hw = (x1b - x0b) * 0.6 + 10
                    hh = (y1b - y0b) * 0.6 + 10
                    roi = (
                        np.asarray(lmask)
                        & (np.abs(mids32[:, 0] - mx) < hw)
                        & (np.abs(mids32[:, 1] - my) < hh)
                    )
                    cons = (
                        float(line_matched[roi].mean()) if roi.any() else 0.0
                    )
                    quality_i[o] *= (1.0 - line_track_weight) + (
                        line_track_weight * cons
                    )
                x0b, y0b, x1b, y1b = np.asarray(boxes_c)[d]
                bbox_i[o] = [
                    (x0b + x1b) / 2, (y0b + y1b) / 2, x1b - x0b, y1b - y0b
                ]
                has_i[o] = True

        npdt = np.dtype(jnp.dtype(dtype).name)
        frame = _assemble_frame(
            np.asarray(meas9, npdt),
            np.asarray(quality_i, npdt),
            has_i,
            np.asarray(bbox_i, npdt),
            np.asarray(bbox_edge_weight, npdt),
        )
        if use_points:
            carry, (chi2, cube_min) = step(
                carry,
                (
                    np.int32(i), frame, first_Twc,
                    np.asarray(pt_obs, npdt), pt_alive,
                    pt_respawn, pt_ground,
                ),
            )
        else:
            carry, (chi2, cube_min) = step(
                carry, (np.int32(i), frame, first_Twc)
            )
        # ONE launch + ONE transfer per frame: step outputs + everything
        # the next iteration's host-side prediction and association gate
        # need
        g_next = carry[0] if windowed else carry
        (
            chi2_h, cube_min_h, T1_h, T2_h, cube_pos_h, cube_valid_h
        ) = jax.device_get(
            (chi2, cube_min) + _post_step_state(g_next, np.int32(i))
        )
        Tcw_prev = np.asarray(T1_h, np.float64)
        Tcw_prevprev = np.asarray(T2_h, np.float64)
        cube_pos_h = np.asarray(cube_pos_h)
        cube_valid_h = np.asarray(cube_valid_h)
        chi2s[i] = float(chi2_h)
        cube_hist[i] = np.asarray(cube_min_h)

    if checkpoint_path is not None:
        _save(n)

    graph = carry[0] if windowed else carry
    traj = np.asarray(graph.cam_Twc().to_xyzq())
    cubes = np.asarray(graph.cube.to_minimal())
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cubes[0],
        chi2=chi2s,
        timestamps=seq.timestamps[:n],
        cube_history=cube_hist,
        cubes_minimal=cubes,
        cube_valid=np.asarray(graph.cube_valid) & (book.count >= min_meas),
        frontend_report=report,
    )


def _point_refinement(
    graph,
    base,
    n,
    K,
    dtype,
    max_corners: int = 192,
    outlier_px: float = 3.0,
    min_track_obs: int = 3,
    obs_weight: float = 0.05,
):
    """Joint camera-object-point polish after the incremental pass
    (BASELINE config 4: feature tracking + cuboid landmarks + joint BA).

    Harris+ZNCC tracks over the sequence are triangulated from the
    incremental trajectory; observations whose initial reprojection error
    exceeds `outlier_px` are dropped (ZNCC drift/mismatch gating), then one
    Schur-reduced LM refines poses, cuboids and points together.

    Note: on the bundled 58-frame cabinet sequence this polish does NOT
    improve ATE (0.234 -> 0.238 at the default gate) — the trajectory error
    there is dominated by cuboid-measurement bias, which world-frame-agnostic
    monocular points cannot correct, and the low-texture scene yields noisy
    ZNCC tracks.  It is therefore off by default; the machinery (tracking,
    exact DLT triangulation, joint Schur BA) is validated in tests."""
    import jax as jax_
    import jax.numpy as jnp_

    from cube_slam_wu_tpu.slam import features, point_ba
    from cube_slam_wu_tpu.slam.point_ba import PointFactors

    grays = []
    for i in range(n):
        p = uio.frame_image_path(base, i)
        if not p.exists():
            return graph
        grays.append(jnp.asarray(uio.load_image_gray(p), dtype))
    obs_uv, obs_mask = features.build_point_tracks(grays, max_corners=max_corners)
    obs_uv = jnp.asarray(obs_uv, dtype)
    obs_mask = jnp.asarray(obs_mask)
    pts, ok = point_ba.triangulate_points(graph.cam_Tcw, obs_uv, obs_mask, K)

    # reprojection gating against the incremental trajectory
    proj = jax_.vmap(
        lambda T: jax_.vmap(lambda X: point_ba.project_point(T, X, K))(pts)
    )(graph.cam_Tcw)
    err = jnp.linalg.norm(proj - obs_uv, axis=-1)
    obs_ok = obs_mask & ok[None, :] & (err < outlier_px)
    track_ok = ok & (jnp.sum(obs_ok, axis=0) >= min_track_obs)
    obs_ok = obs_ok & track_ok[None, :]

    factors = PointFactors(
        points=pts,
        point_mask=track_ok,
        obs_uv=obs_uv,
        obs_mask=obs_ok,
        # pixel residuals vs unit-information odometry/cuboid edges
        obs_weight=jnp_.full(obs_mask.shape, obs_weight, dtype),
    )
    res = point_ba.optimize(graph, factors, K, iterations=8)
    return graph._replace(cam_Tcw=res.cam_Tcw, cube=res.cube)


class SlamOutput(NamedTuple):
    traj_Twc_xyzq: np.ndarray  # (N, 7) x y z qx qy qz qw
    cube_minimal: np.ndarray  # (9,) final cuboid [xyz rpy lwh] (object 0)
    chi2: np.ndarray  # (N,) per-frame final chi2
    timestamps: np.ndarray
    cube_history: np.ndarray | None = None  # (N, O, 9) per-frame optimized
    cubes_minimal: np.ndarray | None = None  # (O, 9) all object landmarks
    cube_valid: np.ndarray | None = None  # (O,) landmark initialised
    frontend_report: "FrontendReport | None" = None


def run_offline_slam(base_folder, iterations: int = 5, dtype=None) -> SlamOutput:
    """Offline-mode incremental SLAM over the bundled dataset; returns the
    optimized trajectory (camera-to-world, TUM order) like
    output_cam_poses.txt."""
    dtype = dtype or _default_dtype()
    data = load_offline_dataset(base_folder)
    frames = build_offline_frames(data, dtype)
    first_Twc = SE3.from_xyzq(jnp.asarray(data.truth_poses[0, 1:8], dtype))
    graph, chi2s, cube_hist = tracker.run_incremental(
        first_Twc, frames, iterations=iterations
    )
    traj = np.asarray(graph.cam_Twc().to_xyzq())
    cube = np.asarray(graph.cube.to_minimal())[0]
    return SlamOutput(
        traj_Twc_xyzq=traj,
        cube_minimal=cube,
        chi2=np.asarray(chi2s),
        timestamps=data.truth_poses[:, 0],
        cube_history=np.asarray(cube_hist),
    )
