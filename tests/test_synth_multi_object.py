"""Multi-object online SLAM end-to-end on synthetic cuboid-world sequences
(utils/synth.py) — the wiring the round-1 VERDICT flagged as missing:
detect_cuboids -> ops.association -> O>=1 CameraObjectGraph -> incremental BA.
"""

import pathlib

import numpy as np
import pytest

from cube_slam_wu_tpu.utils import synth
from cube_slam_wu_tpu.utils import kitti as ukitti


TWO_OBJECTS = [
    synth.SynthObject(np.array([-1.5, 5.5, 0.45]), 1.7, np.array([0.7, 0.45, 0.45])),
    synth.SynthObject(np.array([1.6, 7.5, 0.6]), 0.3, np.array([0.9, 0.5, 0.6])),
]


def test_render_and_detections_deterministic():
    a = synth.make_sequence(n_frames=3, size=(240, 320), objects=TWO_OBJECTS)
    b = synth.make_sequence(n_frames=3, size=(240, 320), objects=TWO_OBJECTS)
    for ia, ib in zip(a.images, b.images):
        np.testing.assert_array_equal(ia, ib)
    assert a.images[0].min() < 150  # cuboid faces rendered (not just bg)
    assert len(a.detections[0]) >= 1


def test_kitti_roundtrip(tmp_path):
    """write_kitti_sequence -> utils.kitti.load_sequence recovers K, poses
    (z-up), image paths and timestamps."""
    seq = synth.make_sequence(n_frames=4, n_objects=2, size=(120, 160))
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    loaded = ukitti.load_sequence(out, poses_path)
    np.testing.assert_allclose(loaded.K, seq.K, atol=1e-5)
    assert len(loaded.image_paths) == 4
    np.testing.assert_allclose(loaded.poses_T_wc, seq.T_wc, atol=1e-6)
    np.testing.assert_allclose(loaded.timestamps, seq.timestamps, atol=1e-6)
    boxes, conf, mask = __import__(
        "cube_slam_wu_tpu.utils.io", fromlist=["io"]
    ).read_detections_txt(ukitti.detection_txt_path(det_dir, 0))
    assert mask.sum() == len(seq.detections[0])


@pytest.mark.slow
def test_multi_object_online_e2e(tmp_path):
    """Full pipeline on a 12-frame 2-object synthetic scene: both objects
    must be spawned as separate tracks, and the optimized landmarks must sit
    near their ground-truth positions."""
    import jax.numpy as jnp

    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam import pipeline, tracker

    seq = synth.make_sequence(
        n_frames=12, size=(240, 320), speed=0.35, noise_px=0.5,
        objects=TWO_OBJECTS,
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    specs = [
        (out / "image_0" / f"{i:06d}.pgm", det_dir / f"{i:06d}.txt")
        for i in range(12)
    ]
    T0 = jnp.asarray(seq.T_wc[0])
    first = SE3.from_rot_trans(T0[:3, :3], T0[:3, 3])
    frames, report = pipeline.run_online_frontend(
        specs, seq.K, first, jnp.float64, max_objects=3, max_detections=3
    )
    has = np.asarray(frames.has_meas)
    assert has[:, 0].sum() >= 6  # track 0 observed in most frames
    assert has[:, 1].sum() >= 4  # second object tracked separately
    assert len(report.missing_image) == 0

    graph, chi2s, _ = tracker.run_incremental(
        first, frames, soft_gate_alpha=2.0
    )
    valid = np.asarray(graph.cube_valid)
    assert valid[:2].all()
    cubes = np.asarray(graph.cube.to_minimal())
    gt = np.stack([o.pos for o in seq.objects])
    # match each estimated landmark to its nearest gt object
    for o in range(2):
        d = np.linalg.norm(gt - cubes[o, :3], axis=1).min()
        assert d < 0.6, f"landmark {o} off by {d:.2f} m from every gt object"


@pytest.mark.slow
def test_spawn_range_gate(tmp_path):
    """A detection whose lifted range exceeds spawn_range_m must not seed a
    landmark (far monocular lifts are unreliable: a sub-pixel bbox error at
    36 m audits to a 21 m landmark error), and the skip must be reported."""
    import jax.numpy as jnp

    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam import pipeline

    objects = [
        synth.SynthObject(
            np.array([-1.5, 5.5, 0.45]), 1.7, np.array([0.7, 0.45, 0.45])
        ),
        # far object, scaled up so its box is still detectable
        synth.SynthObject(
            np.array([1.8, 12.0, 0.9]), 0.3, np.array([1.3, 0.8, 0.9])
        ),
    ]
    seq = synth.make_sequence(
        n_frames=6, size=(240, 320), speed=0.35, noise_px=0.3, objects=objects
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    specs = [
        (out / "image_0" / f"{i:06d}.pgm", det_dir / f"{i:06d}.txt")
        for i in range(6)
    ]
    T0 = jnp.asarray(seq.T_wc[0])
    first = SE3.from_rot_trans(T0[:3, :3], T0[:3, 3])
    frames, report = pipeline.run_online_frontend(
        specs, seq.K, first, jnp.float64, max_objects=3, max_detections=3,
        spawn_range_m=8.0,
    )
    has = np.asarray(frames.has_meas)
    assert has[:, 0].sum() >= 4  # near object tracked normally
    assert has[:, 1:].sum() == 0  # far object never seeded a landmark
    assert report.far_spawns >= 1  # and the skip was surfaced


@pytest.mark.slow
def test_track_max_age_retirement(tmp_path):
    """A track whose object left the view must retire after track_max_age
    frames: a NEW object appearing near the stale box position must spawn a
    fresh landmark, not contaminate the old one (and retired slots must not
    be reused).  With retirement off, the entrant is captured by the stale
    track — the cross-contamination the gate exists to prevent."""
    import jax.numpy as jnp

    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam import pipeline

    H, W = 240, 320
    K = np.array(
        [[0.75 * W, 0, W / 2.0], [0, 0.75 * W, H / 2.0 - 0.05 * H], [0, 0, 1.0]]
    )
    A = synth.SynthObject(
        np.array([-1.5, 5.5, 0.45]), 1.7, np.array([0.7, 0.45, 0.45])
    )
    B = synth.SynthObject(
        np.array([-1.3, 6.0, 0.5]), 0.3, np.array([0.8, 0.5, 0.5])
    )
    rng = np.random.default_rng(0)
    T = synth.camera_pose(0.0)
    per_frame = [[A]] * 3 + [[]] * 6 + [[B]] * 3  # A exits; B enters later
    images = [synth.render_frame(T, objs, K, (H, W)) for objs in per_frame]
    detections = [
        synth.detect_objects(T, objs, K, (H, W), noise_px=0.3, rng=rng)
        for objs in per_frame
    ]
    seq = synth.SynthSequence(
        K, np.stack([T] * 12), images, detections, [A, B],
        np.arange(12) * 0.1,
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    specs = [
        (out / "image_0" / f"{i:06d}.pgm", det_dir / f"{i:06d}.txt")
        for i in range(12)
    ]
    first = SE3.from_rot_trans(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))

    frames, _ = pipeline.run_online_frontend(
        specs, K, first, jnp.float64, max_objects=3, max_detections=2,
        track_max_age=4,
    )
    has = np.asarray(frames.has_meas)
    assert np.nonzero(has[:, 0])[0].max() <= 2  # A's track ends with A
    assert has[9:, 1].sum() >= 2  # B spawned a fresh slot

    frames, _ = pipeline.run_online_frontend(
        specs, K, first, jnp.float64, max_objects=3, max_detections=2,
        track_max_age=None,
    )
    has = np.asarray(frames.has_meas)
    # without retirement the stale track captures the entrant (documented
    # failure mode this gate prevents)
    assert has[9:, 0].sum() >= 2
    assert has[:, 1:].sum() == 0


@pytest.mark.slow
def test_kitti_driver_e2e(tmp_path):
    """run_kitti_slam over a written KITTI-layout synthetic sequence with the
    windowed back-end: finite trajectory, bounded ATE, multiple landmarks."""
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    seq = synth.make_sequence(
        n_frames=16, n_objects=3, size=(240, 320), speed=0.35, noise_px=0.5
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    result = pipeline.run_kitti_slam(
        out,
        det_dir,
        poses_path,
        max_objects=4,
        max_detections=3,
        window=8,
        min_meas=1,  # 16-frame clip: the far objects get few measurements
    )
    assert np.isfinite(result.traj_Twc_xyzq).all()
    ate = ate_rmse(result.traj_Twc_xyzq[:, :3], seq.T_wc[:16, :3, 3])
    assert ate < 0.5, f"synthetic KITTI ATE {ate:.3f}"
    assert np.asarray(result.cube_valid).sum() >= 2


@pytest.mark.slow
def test_kitti_pose_feedback_mode(tmp_path):
    """The interleaved front-end/back-end driver (pose_feedback=True: each
    frame's proposal grid anchored at the tracker's constant-velocity
    predicted pose, with the 3D association gate) must run end-to-end with
    comparable accuracy to the two-phase schedule."""
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    seq = synth.make_sequence(
        n_frames=12, size=(240, 320), speed=0.35, noise_px=0.5,
        objects=TWO_OBJECTS,
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    result = pipeline.run_kitti_slam(
        out,
        det_dir,
        poses_path,
        max_objects=4,
        max_detections=3,
        window=8,
        min_meas=1,  # short clip: few measurements per landmark
        pose_feedback=True,
    )
    assert np.isfinite(result.traj_Twc_xyzq).all()
    ate = ate_rmse(result.traj_Twc_xyzq[:, :3], seq.T_wc[:12, :3, 3])
    # wiring gate, not an accuracy gate: on this near-static 12-frame clip
    # every mode sits in the single-view measurement-noise regime (two-phase
    # measures ~0.5 m here); the interleaved mode's first frames use
    # predictions from barely-constrained poses, so its bound is looser
    assert ate < 1.5, f"pose-feedback KITTI ATE {ate:.3f}"
    assert np.asarray(result.cube_valid).sum() >= 2


@pytest.mark.slow
def test_kitti_points_improve_interleaved_drive(tmp_path):
    """Joint point BA in the interleaved driver (point_weight > 0): on a
    textured forward drive the point landmarks must cut the trajectory
    error vs the cuboid-only interleaved run (the measured 120-frame matrix:
    cuboid-only 7.3-20 m, with points ~0.7 m; this 60-frame gate is looser
    but still separates the modes decisively)."""
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    N = 60
    seq = synth.make_sequence(
        n_frames=N, n_objects=6, size=(240, 320), speed=0.5, curve=0.002,
        noise_px=0.8, dropout=0.05, seed=4, ground_texture=4.0,
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    gt = seq.T_wc[:N, :3, 3]

    base = pipeline.run_kitti_slam(
        out, det_dir, poses_path, max_objects=8, max_detections=4,
        window=16, pose_feedback=True,
    )
    ate_base = ate_rmse(np.asarray(base.traj_Twc_xyzq)[:N, :3], gt)

    pts = pipeline.run_kitti_slam(
        out, det_dir, poses_path, max_objects=8, max_detections=4,
        window=16, pose_feedback=True, point_weight=0.3,
    )
    ate_pts = ate_rmse(np.asarray(pts.traj_Twc_xyzq)[:N, :3], gt)
    assert np.isfinite(ate_pts)
    assert ate_pts < 1.0, f"points ATE {ate_pts:.3f}"
    assert ate_pts < ate_base * 0.75, (ate_pts, ate_base)


def test_kitti_torn_checkpoint_starts_fresh(tmp_path):
    """A checkpoint state file whose companion .carry is missing (torn pair
    from a crash between the two writes, or a stale file from an earlier
    run) must fall back to a fresh start, not crash (round-4 regression:
    FileNotFoundError on resume)."""
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    seq = synth.make_sequence(
        n_frames=12, n_objects=2, size=(240, 320), speed=0.35, noise_px=0.5
    )
    out, det_dir, poses_path = synth.write_kitti_sequence(seq, tmp_path / "seq")
    cp = tmp_path / "fe.npz"
    kw = dict(
        max_objects=4, max_detections=3, window=8, min_meas=1,
        pose_feedback=True,  # the two-file (state + .carry) tracked driver
    )
    # full run writes the pair; delete the carry half to tear it
    ref = pipeline.run_kitti_slam(
        out, det_dir, poses_path, checkpoint_path=cp, checkpoint_every=4, **kw
    )
    carry_file = tmp_path / "fe.npz.carry.npz"
    assert cp.exists() and carry_file.exists()
    # resume path with an INTACT pair: skips straight to the checkpointed
    # carry and must reproduce the original trajectory (this load was dead
    # code before round 4 — save appended .npz to the carry name, load did
    # not, so every KITTI mid-run resume raised FileNotFoundError)
    resumed = pipeline.run_kitti_slam(
        out, det_dir, poses_path, checkpoint_path=cp, checkpoint_every=4, **kw
    )
    np.testing.assert_allclose(
        resumed.traj_Twc_xyzq, ref.traj_Twc_xyzq, atol=1e-5
    )
    carry_file.unlink()
    result = pipeline.run_kitti_slam(
        out, det_dir, poses_path, checkpoint_path=cp, checkpoint_every=4, **kw
    )
    assert np.isfinite(result.traj_Twc_xyzq).all()
    np.testing.assert_allclose(
        result.traj_Twc_xyzq, ref.traj_Twc_xyzq, atol=1e-5
    )
