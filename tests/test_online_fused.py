"""Fused single-dispatch online step (slam/online.py) gates.

The fused step moves association, tracklet bookkeeping, measurement
assembly and the incremental BA into ONE jitted dispatch per frame
(round-5 verdict item 1: collapse the online per-frame step to <= 2 host
syncs).  These tests pin:

- equivalence with the two-phase driver (run_online_frontend +
  run_incremental) on a real TUM prefix — same trajectory to f32
  measurement-assembly round-off;
- the transfer contract: exactly 1 blocking sync per frame, image-up /
  pose-down only;
- (slow) the full 58-frame online ATE gate at the two-phase path's level.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from cube_slam_wu_tpu.slam.online import run_online_slam_fused
from cube_slam_wu_tpu.utils import io as uio
from cube_slam_wu_tpu.utils.metrics import ate_rmse

BASE = "/root/reference/object_slam/data"


@pytest.fixture(scope="module")
def fused_prefix(reference_root):
    return run_online_slam_fused(BASE, n_frames=6, dtype=jnp.float32)


def test_fused_matches_two_phase_prefix(reference_root, fused_prefix):
    from cube_slam_wu_tpu.slam.pipeline import run_online_slam

    ref = run_online_slam(BASE, n_frames=6, dtype=jnp.float32)
    d = np.abs(
        fused_prefix.traj_Twc_xyzq - np.asarray(ref.traj_Twc_xyzq)
    ).max()
    # the only difference is measurement assembly in device f32 vs host
    # f64-intermediate (pipeline._proposal_measurement); everything else
    # (detector, proposals, association, BA) is the same compiled code
    assert d < 5e-4, d
    dc = np.abs(fused_prefix.cubes_minimal[0] - np.asarray(ref.cube_minimal)).max()
    assert dc < 5e-4, dc


def test_fused_transfer_contract(reference_root, fused_prefix):
    assert fused_prefix.syncs_per_frame == 1.0
    # image (480x640 uint8) + boxes up; pose + report scalars down
    assert fused_prefix.bytes_up_per_frame < 0.35e6
    assert fused_prefix.bytes_down_per_frame < 200
    assert fused_prefix.report["cap_fallbacks"] == 0


def test_fused_empty_detection_frame(reference_root):
    """Frame 20 of the bundled sequence has an empty detection file; the
    fused step must process it as a measurement-free frame (pose from
    constant-velocity + odometry only), like the two-phase driver."""
    out = run_online_slam_fused(BASE, n_frames=22, dtype=jnp.float32)
    assert out.report["no_valid_proposal"] >= 1
    assert np.isfinite(out.traj_Twc_xyzq).all()


@pytest.mark.slow
def test_fused_full_online_ate_gate(reference_root):
    truth = uio.read_number_txt(BASE + "/truth_cam_poses.txt")
    ref_out = uio.read_number_txt(BASE + "/output_cam_poses.txt")
    ate_ref = ate_rmse(ref_out[: len(truth), 1:4], truth[:, 1:4])
    result = run_online_slam_fused(BASE, dtype=jnp.float32)
    ate = ate_rmse(result.traj_Twc_xyzq[:, :3], truth[:, 1:4])
    assert np.isfinite(ate)
    # the two-phase default config measures 0.1789; the fused path must hold
    # the same beat-the-reference margin
    assert ate <= ate_ref * 0.9, f"fused online ATE {ate:.4f} vs ref {ate_ref:.4f}"
    assert result.syncs_per_frame == 1.0


def test_missing_frame_raises(tmp_path):
    """A frame image that is not there is an error, not a black frame; a
    missing detection file still means no detections."""
    from cube_slam_wu_tpu.utils import synth

    seq = synth.make_sequence(n_frames=2, n_objects=1, size=(48, 64), seed=0)
    base = synth.write_tum_sequence(seq, tmp_path / "tum")
    (base / "raw_imgs" / "0000_rgb_raw.pgm").unlink()
    with pytest.raises(FileNotFoundError, match="frame 0"):
        run_online_slam_fused(str(base), dtype=jnp.float32)


def test_fused_rendered_sequence_contract(tmp_path):
    """The fused driver on a small rendered PGM sequence: finite poses, one
    blocking sync per frame, one host time per frame."""
    from cube_slam_wu_tpu.utils import synth

    seq = synth.make_sequence(n_frames=3, n_objects=1, size=(96, 128), seed=1)
    base = synth.write_tum_sequence(seq, tmp_path / "tum")
    out = run_online_slam_fused(str(base), dtype=jnp.float32)
    assert out.traj_Twc_xyzq.shape == (3, 7)
    assert np.isfinite(out.traj_Twc_xyzq).all()
    assert out.syncs_per_frame == 1.0
    assert out.frame_s.shape == (3,) and (out.frame_s > 0).all()


def test_spawn_new_tracks_matches_host_semantics():
    """_spawn_new_tracks vectorizes the host loop `for d in
    nonzero(det_is_new): o = book.spawn()` (first never-used slot per new
    detection, ascending, drop when full).  Randomized equivalence against
    a literal host re-implementation."""
    import numpy as np
    from cube_slam_wu_tpu.slam.online import OnlineBook, _spawn_new_tracks
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for trial in range(50):
        O = int(rng.integers(1, 7))
        D = int(rng.integers(1, 6))
        used = rng.random(O) < 0.5
        alive = used & (rng.random(O) < 0.8)
        det_is_new = rng.random(D) < 0.5
        det_of_track = rng.integers(0, D + 1, size=O)
        matched = (det_of_track < D) & alive

        # host reference
        h_used = used.copy()
        h_alive = alive.copy()
        h_dot = det_of_track.copy()
        h_matched = matched.copy()
        h_dropped = 0
        for d in np.nonzero(det_is_new)[0]:
            free = np.nonzero(~h_used)[0]
            if free.size == 0:
                h_dropped += 1
                continue
            o = int(free[0])
            h_used[o] = True
            h_alive[o] = True
            h_dot[o] = d
            h_matched[o] = True

        book = OnlineBook.empty(O)._replace(
            used=jnp.asarray(used), alive=jnp.asarray(alive)
        )
        dot, m, u, a, drop = _spawn_new_tracks(
            book, jnp.asarray(det_is_new),
            jnp.asarray(det_of_track, jnp.int32), jnp.asarray(matched),
        )
        np.testing.assert_array_equal(np.asarray(u), h_used, err_msg=str(trial))
        np.testing.assert_array_equal(np.asarray(a), h_alive)
        np.testing.assert_array_equal(np.asarray(m), h_matched)
        np.testing.assert_array_equal(
            np.asarray(dot)[np.asarray(m)], h_dot[h_matched]
        )
        assert int(drop) == h_dropped, (trial, int(drop), h_dropped)


@pytest.mark.slow
def test_fused_multi_object_matches_two_phase(tmp_path):
    """O=3 / D=3 fused step vs the two-phase driver on a synthetic
    TUM-layout multi-object sequence: the vectorized association + spawn +
    measurement assembly must reproduce the host bookkeeping end-to-end
    (same trajectory and landmark set to f32 assembly round-off).

    Note the synthetic world's K differs from the drivers' hard-coded TUM
    intrinsics — irrelevant here: both paths consume the same inputs
    through the same proposal engine, and equivalence (not accuracy) is
    the property under test."""
    from cube_slam_wu_tpu.slam.pipeline import run_online_slam
    from cube_slam_wu_tpu.utils import synth

    seq = synth.make_sequence(
        n_frames=8, n_objects=3, size=(480, 640), speed=0.3, noise_px=0.5,
        seed=2,
    )
    base = synth.write_tum_sequence(seq, tmp_path / "tum")
    fused = run_online_slam_fused(
        str(base), dtype=jnp.float32, max_objects=3, max_detections=3
    )
    ref = run_online_slam(
        str(base), dtype=jnp.float32, max_objects=3, max_detections=3
    )
    d = np.abs(fused.traj_Twc_xyzq - np.asarray(ref.traj_Twc_xyzq)).max()
    assert d < 5e-3, d
    np.testing.assert_array_equal(
        fused.cube_valid, np.asarray(ref.cube_valid)
    )
    dc = np.abs(
        fused.cubes_minimal[fused.cube_valid]
        - np.asarray(ref.cubes_minimal)[np.asarray(ref.cube_valid)]
    ).max()
    assert dc < 5e-3, dc
    assert fused.report["n_measurements"] >= 8


def test_fused_windowed_matches_two_phase(reference_root):
    """Fixed-lag fused step (window < capacity: the CubePrior rides in
    OnlineState, departing frames absorbed on device) vs the two-phase
    windowed driver on a real TUM prefix."""
    from cube_slam_wu_tpu.slam.pipeline import run_online_slam

    fused = run_online_slam_fused(
        BASE, n_frames=6, dtype=jnp.float32, window=3
    )
    ref = run_online_slam(BASE, n_frames=6, dtype=jnp.float32, window=3)
    d = np.abs(fused.traj_Twc_xyzq - np.asarray(ref.traj_Twc_xyzq)).max()
    assert d < 5e-4, d
