"""Checkpoint round-trip tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from cube_slam_wu_tpu.slam import checkpoint
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph
from test_ba import _make_synthetic


def test_graph_roundtrip(tmp_path):
    graph, _, _ = _make_synthetic(F=8, n_active=5, seed=4)
    p = tmp_path / "ckpt.npz"
    checkpoint.save_pytree(p, graph)
    template = CameraObjectGraph.empty(8)
    restored = checkpoint.load_pytree(p, template)
    for a, b in zip(
        __import__("jax").tree.leaves(graph), __import__("jax").tree.leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_capacity_mismatch_rejected(tmp_path):
    graph, _, _ = _make_synthetic(F=8, seed=1)
    p = tmp_path / "ckpt.npz"
    checkpoint.save_pytree(p, graph)
    with pytest.raises(ValueError):
        checkpoint.load_pytree(p, CameraObjectGraph.empty(16))


def test_missing_leaf_rejected(tmp_path):
    p = tmp_path / "ckpt.npz"
    checkpoint.save_pytree(p, {"a": jnp.ones(3)})
    with pytest.raises(KeyError):
        checkpoint.load_pytree(p, {"a": jnp.ones(3), "b": jnp.ones(2)})


def test_frontend_checkpoint_resume(tmp_path):
    """Elastic resume of the online front-end (SURVEY 5.3/5.4: the
    reference's crash story is rerun-from-scratch): interrupt after a
    checkpoint, resume from the file, and require results identical to an
    uninterrupted run."""
    import numpy as np

    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils import synth

    seq = synth.make_sequence(n_frames=8, n_objects=2, size=(240, 320),
                              speed=0.35, noise_px=0.5)
    out, det_dir, _ = synth.write_kitti_sequence(seq, tmp_path / "seq")
    specs = [
        (out / "image_0" / f"{i:06d}.pgm", det_dir / f"{i:06d}.txt")
        for i in range(8)
    ]
    T0 = jnp.asarray(seq.T_wc[0])
    first = SE3.from_rot_trans(T0[:3, :3], T0[:3, 3])
    kw = dict(max_objects=3, max_detections=3)

    ref_frames, ref_rep = pipeline.run_online_frontend(
        specs, seq.K, first, jnp.float64, **kw
    )

    ck = tmp_path / "fe.npz"
    # "interrupted" run: process only the first 5 frames, checkpointing
    # every 2 -> file holds state through frame 4
    pipeline.run_online_frontend(
        specs[:5], seq.K, first, jnp.float64,
        checkpoint_path=ck, checkpoint_every=2, **kw
    )
    assert ck.exists()
    # fix up i_next: the completed 5-frame run saved i_next=5 for n=5;
    # resuming the 8-frame run continues at frame 5
    frames, rep = pipeline.run_online_frontend(
        specs, seq.K, first, jnp.float64,
        checkpoint_path=ck, checkpoint_every=2, **kw
    )
    np.testing.assert_array_equal(
        np.asarray(frames.has_meas), np.asarray(ref_frames.has_meas)
    )
    np.testing.assert_allclose(
        np.asarray(frames.meas.to_minimal()),
        np.asarray(ref_frames.meas.to_minimal()),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(frames.quality), np.asarray(ref_frames.quality), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(frames.bbox), np.asarray(ref_frames.bbox), atol=1e-12
    )


def test_frontend_checkpoint_preserves_cap_counters(tmp_path):
    """cap_overflow_frames / cap_fallbacks must survive a checkpoint+resume
    cycle — a resumed run previously reset them to 0, under-reporting cap
    saturation in summary() (ADVICE r3)."""
    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils import synth

    seq = synth.make_sequence(n_frames=4, n_objects=1, size=(240, 320),
                              speed=0.35, noise_px=0.5)
    out, det_dir, _ = synth.write_kitti_sequence(seq, tmp_path / "seq")
    specs = [
        (out / "image_0" / f"{i:06d}.pgm", det_dir / f"{i:06d}.txt")
        for i in range(4)
    ]
    T0 = jnp.asarray(seq.T_wc[0])
    first = SE3.from_rot_trans(T0[:3, :3], T0[:3, 3])
    kw = dict(max_objects=2, max_detections=2)

    ck = tmp_path / "fe.npz"
    pipeline.run_online_frontend(
        specs[:2], seq.K, first, jnp.float64,
        checkpoint_path=ck, checkpoint_every=1, **kw
    )
    assert ck.exists()
    # inject non-zero counters as if the interrupted run had hit the cap
    data = dict(np.load(ck))
    assert "cap_overflow_frames" in data and "cap_fallbacks" in data
    data["cap_overflow_frames"] = np.asarray(3)
    data["cap_fallbacks"] = np.asarray(2)
    np.savez(ck, **data)

    _, rep = pipeline.run_online_frontend(
        specs, seq.K, first, jnp.float64,
        checkpoint_path=ck, checkpoint_every=1, **kw
    )
    assert rep.cap_overflow_frames >= 3
    assert rep.cap_fallbacks >= 2
    assert "cap_overflow=3" in rep.summary() or rep.cap_overflow_frames > 3
