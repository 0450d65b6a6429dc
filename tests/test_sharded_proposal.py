"""Hypothesis-grid TP: sharded proposal == single-device proposal.

Runs on the virtual 8-device CPU mesh (tests/conftest.py) — validates the
SURVEY.md section 2.9 "shard proposal-scoring tensors across chips" design
without several cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboid_single
from cube_slam_wu_tpu.parallel.sharded_proposal import detect_cuboid_sharded
from cube_slam_wu_tpu.utils import io as uio


@pytest.fixture(scope="module")
def demo_inputs(reference_root):
    base = reference_root / "detect_3d_cuboid/data"
    gray = jnp.asarray(uio.load_image_gray(base / "0000_rgb_raw.jpg"))
    edges = uio.read_number_txt(base / "edge_detection/LSD/0000_edge.txt")
    L = 320
    lines = np.zeros((L, 4))
    lines[: len(edges)] = edges[:, :4]
    mask = np.zeros(L, bool)
    mask[: len(edges)] = True
    K = jnp.asarray([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1.0]])
    T_wc = jnp.asarray(
        [
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, -1.0, 0.0, 1.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    bbox = jnp.asarray([187.0, 188.0, 14.0, 123.0])
    return gray, K, T_wc, bbox, jnp.asarray(lines), jnp.asarray(mask)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single(demo_inputs, n_dev):
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=int(lines.shape[0]), sample_cam_roll_pitch=True)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("hyp",))

    ref = detect_cuboid_single(gray, K, T_wc, bbox, lines, mask, cfg)
    got = detect_cuboid_sharded(gray, K, T_wc, bbox, lines, mask, cfg, mesh)

    assert bool(got.valid) == bool(ref.valid)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got.rotY), np.asarray(ref.rotY), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(got.scale), np.asarray(ref.scale), rtol=1e-12
    )
    np.testing.assert_array_equal(
        np.asarray(got.box_config_type), np.asarray(ref.box_config_type)
    )
    np.testing.assert_allclose(
        np.asarray(got.corners_2d), np.asarray(ref.corners_2d), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(got.normalized_error),
        np.asarray(ref.normalized_error),
        rtol=1e-12,
    )


def test_sharded_rp1_grid(demo_inputs):
    """RP=1 (no roll/pitch sampling) still pads/shards correctly."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=int(lines.shape[0]), sample_cam_roll_pitch=False)
    mesh = Mesh(np.array(jax.devices()[:4]), ("hyp",))
    ref = detect_cuboid_single(gray, K, T_wc, bbox, lines, mask, cfg)
    got = detect_cuboid_sharded(gray, K, T_wc, bbox, lines, mask, cfg, mesh)
    assert bool(got.valid) == bool(ref.valid)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(ref.pos), rtol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(got.box_config_type), np.asarray(ref.box_config_type)
    )
