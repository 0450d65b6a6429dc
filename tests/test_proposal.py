"""Proposal-engine tests: oracle equivalence + demo-fixture regression.

The oracle (tests/oracle_proposal.py) is a naive sequential restatement of
the reference's proposal loop; the vectorized engine must produce the same
valid-hypothesis set, scores and winner.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cube_slam_wu_tpu.ops.proposal import (
    ProposalConfig,
    detect_cuboid_single,
    fuse_normalized_scores,
)
from cube_slam_wu_tpu.utils import io as uio

from oracle_proposal import detect_cuboid_oracle, fuse_scores

FIXTURE = pathlib.Path("/root/reference/detect_3d_cuboid/data")


def test_fuse_matches_oracle_random():
    rng = np.random.default_rng(0)
    for trial in range(8):
        n = int(rng.integers(2, 60))
        d = rng.random(n) * 3
        a = rng.random(n) * 2
        ref_scores, ref_keep = fuse_scores(d, a)
        pad = 80
        dj = np.full(pad, 1e9)
        aj = np.full(pad, 1e9)
        valid = np.zeros(pad, bool)
        dj[:n], aj[:n], valid[:n] = d, a, True
        scores, kept = fuse_normalized_scores(
            jnp.asarray(dj), jnp.asarray(aj), jnp.asarray(valid), 0.8, True
        )
        scores, kept = np.asarray(scores), np.asarray(kept)
        assert sorted(np.nonzero(kept)[0].tolist()) == sorted(ref_keep)
        got = scores[sorted(ref_keep)]
        np.testing.assert_allclose(got, ref_scores[np.argsort(ref_keep)], atol=1e-9)


@pytest.fixture(scope="module")
def demo_inputs():
    if not FIXTURE.exists():
        pytest.skip("reference fixture not available")
    gray = jnp.asarray(uio.load_image_gray(FIXTURE / "0000_rgb_raw.jpg"))
    edges = uio.read_number_txt(FIXTURE / "edge_detection/LSD/0000_edge.txt")
    K = np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1.0]])
    T_wc = np.array(
        [
            [1, 0.0011, 0.0004, 0],
            [0, -0.3376, 0.9413, 0],
            [0.0011, -0.9413, -0.3376, 1.35],
            [0, 0, 0, 1.0],
        ]
    )
    bbox = np.array([187.0, 188.0, 201.0, 311.0])
    L = 320
    lines = np.zeros((L, 4))
    lines[: len(edges)] = edges[:, :4]
    mask = np.zeros(L, bool)
    mask[: len(edges)] = True
    return gray, K, T_wc, bbox, lines, mask


def test_engine_matches_oracle_on_demo(demo_inputs):
    """Full hypothesis-set equivalence on the bundled LSD-edge fixture
    (detect_3d_cuboid/src/main.cpp:29-76 configuration)."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=lines.shape[0])
    res, intern = detect_cuboid_single(
        gray,
        jnp.asarray(K),
        jnp.asarray(T_wc),
        jnp.asarray(bbox),
        jnp.asarray(lines),
        jnp.asarray(mask),
        cfg,
        return_internals=True,
    )
    intern = {k: np.asarray(v) for k, v in intern.items()}
    res = jax.tree.map(np.asarray, res)

    mlines = intern["merged_lines"][intern["merged_mask"]]
    records, best = detect_cuboid_oracle(
        intern["dist_map"], mlines, K, T_wc, bbox, intern["yaws"]
    )

    # flat layout: config blocks outermost, then (rp=1, yaw, top) row-major
    Y = len(intern["yaws"])
    T = len(intern["top_xs"])
    block = Y * T

    def flat_idx(r):
        yi = int(np.argmin(np.abs(intern["yaws"] - r["yaw"])))
        return (r["config"] - 1) * block + yi * T + r["top_id"]

    # identical valid hypothesis sets
    engine_valid = set(np.nonzero(intern["valid"])[0].tolist())
    oracle_valid = {flat_idx(r) for r in records}
    assert engine_valid == oracle_valid
    assert len(records) > 50  # the fixture produces a healthy grid

    # identical per-hypothesis scores (distance lookups may differ by one
    # pixel at floor boundaries -> small tolerance)
    for r in records:
        fi = flat_idx(r)
        assert abs(intern["dist"][fi] - r["dist"]) < 0.05
        assert abs(intern["angle"][fi] - r["angle"]) < 1e-3

    # same winner
    assert res.valid
    assert res.box_config_type[0] == best["config"]
    assert res.box_config_type[1] == best["vp1_pos"]
    np.testing.assert_allclose(res.rotY, best["yaw"], atol=1e-9)
    np.testing.assert_allclose(res.pos, best["pos"], atol=5e-3)
    np.testing.assert_allclose(res.scale, best["scale"], atol=5e-3)


def test_demo_fixture_regression(demo_inputs):
    """Pinned winner for the bundled fixture.

    The pinned values equal the output of the reference engine compiled
    from source on this machine (tools/ref_oracle; tests/test_ref_oracle_
    parity.py pins that directly).  The differing winner recorded in the
    reference header comment (detect_3d_cuboid.h:43-56) is stale — see
    docs/ORACLE_PARITY.md."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=lines.shape[0])
    res = detect_cuboid_single(
        gray,
        jnp.asarray(K),
        jnp.asarray(T_wc),
        jnp.asarray(bbox),
        jnp.asarray(lines),
        jnp.asarray(mask),
        cfg,
    )
    res = jax.tree.map(np.asarray, res)
    assert res.valid
    np.testing.assert_allclose(res.pos, [-0.2558, 1.7545, 0.4630], atol=2e-3)
    np.testing.assert_allclose(res.scale, [0.2391, 0.2383, 0.4630], atol=2e-3)
    np.testing.assert_allclose(res.rotY, -2.2515, atol=1e-3)
    assert res.box_config_type.tolist() == [1, 2]


def test_engine_f32_same_winner(demo_inputs):
    """The f32 (accelerator-precision) path must select the same hypothesis."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=lines.shape[0])
    f32 = jnp.float32
    res = detect_cuboid_single(
        gray.astype(f32),
        jnp.asarray(K, f32),
        jnp.asarray(T_wc, f32),
        jnp.asarray(bbox, f32),
        jnp.asarray(lines, f32),
        jnp.asarray(mask),
        cfg,
    )
    res = jax.tree.map(np.asarray, res)
    assert res.valid
    np.testing.assert_allclose(res.pos, [-0.2558, 1.7545, 0.4630], atol=2e-2)
    np.testing.assert_allclose(res.rotY, -2.2515, atol=1e-2)


def test_multi_box_batch(demo_inputs):
    """detect_cuboids vmaps the per-box program; element 0 must equal the
    single-box result and masked boxes must come back invalid."""
    from cube_slam_wu_tpu.ops.proposal import detect_cuboids

    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=lines.shape[0])
    bboxes = np.stack([bbox, [80.0, 120.0, 150.0, 200.0]])
    bmask = np.array([True, False])
    res = detect_cuboids(
        gray,
        jnp.asarray(K),
        jnp.asarray(T_wc),
        jnp.asarray(bboxes),
        jnp.asarray(bmask),
        jnp.asarray(lines),
        jnp.asarray(mask),
        cfg,
    )
    res = jax.tree.map(np.asarray, res)
    assert res.pos.shape == (2, 3)
    assert bool(res.valid[0]) and not bool(res.valid[1])
    single = jax.tree.map(
        np.asarray,
        detect_cuboid_single(
            gray, jnp.asarray(K), jnp.asarray(T_wc), jnp.asarray(bbox),
            jnp.asarray(lines), jnp.asarray(mask), cfg,
        ),
    )
    np.testing.assert_allclose(res.pos[0], single.pos, atol=1e-9)
    np.testing.assert_allclose(res.rotY[0], single.rotY, atol=1e-12)


def test_height_sampling(demo_inputs):
    """Bbox-height sampling (whether_sample_bbox_height) triples the grid
    with per-sample fusion; it must run, produce a valid winner, and agree
    with the single-sample result when the extra samples lose."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    cfg = ProposalConfig(max_lines=lines.shape[0], sample_bbox_height=True)
    res = detect_cuboid_single(
        gray,
        jnp.asarray(K),
        jnp.asarray(T_wc),
        jnp.asarray(bbox),
        jnp.asarray(lines),
        jnp.asarray(mask),
        cfg,
    )
    res = jax.tree.map(np.asarray, res)
    assert res.valid
    assert np.all(res.scale > 0)
    # the winner is the demo chair: position in the same neighbourhood as the
    # single-sample result (height sampling may pick a different expansion)
    np.testing.assert_allclose(res.pos[:2], [-0.2558, 1.7545], atol=0.3)


def test_cap_overflow_reported(demo_inputs):
    """A binding dist_gather_cap must be observable (VERDICT r2 item 4):
    cap_overflow counts the valid hypotheses the compacted chamfer gather
    shed; 0 certifies the compaction was exact this frame."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    args = (
        gray, jnp.asarray(K), jnp.asarray(T_wc), jnp.asarray(bbox),
        jnp.asarray(lines), jnp.asarray(mask),
    )
    # tiny caps: the fixture has far more valid hypotheses than 16/8
    tiny = ProposalConfig(
        max_lines=lines.shape[0], dist_gather_cap=16, dist_gather_cap2=8
    )
    res_tiny = detect_cuboid_single(*args, tiny)
    assert int(res_tiny.cap_overflow) > 0
    # default caps are sized with headroom over the bundled data: exact
    dflt = ProposalConfig(max_lines=lines.shape[0])
    res_dflt = detect_cuboid_single(*args, dflt)
    assert int(res_dflt.cap_overflow) == 0
    # exact (caps off) run agrees with the default-cap run on the fixture
    exact = ProposalConfig(
        max_lines=lines.shape[0], dist_gather_cap=0, dist_gather_cap2=0
    )
    res_exact = detect_cuboid_single(*args, exact)
    assert int(res_exact.cap_overflow) == 0
    np.testing.assert_allclose(res_dflt.pos, res_exact.pos, atol=1e-12)
    np.testing.assert_allclose(res_dflt.rotY, res_exact.rotY, atol=1e-12)


def test_exact_gather_fallback_helper():
    """Pipeline fallback: overflow > 0 triggers one caps-off recompute and
    bumps the report counters; overflow == 0 never recomputes."""
    from cube_slam_wu_tpu.slam.pipeline import (
        FrontendReport,
        _caps_off,
        _exact_gather_fallback,
    )

    rep = FrontendReport(1, [], [], [], [], 0)

    class _Res:
        def __init__(self, n):
            self.cap_overflow = np.array([n])

    sentinel = object()
    res2, rep2 = _exact_gather_fallback(_Res(3), rep, lambda: sentinel)
    assert res2 is sentinel
    assert rep2.cap_fallbacks == 1 and rep2.cap_overflow_frames == 1

    r0 = _Res(0)
    res3, rep3 = _exact_gather_fallback(
        r0, rep, lambda: (_ for _ in ()).throw(AssertionError("recomputed"))
    )
    assert res3 is r0
    assert rep3.cap_fallbacks == 0

    c = _caps_off(ProposalConfig(dist_gather_cap=4608, dist_gather_cap2=1536))
    assert c.dist_gather_cap == 0 and c.dist_gather_cap2 == 0


def test_merge_cap_exact_and_observable(demo_inputs):
    """ProposalConfig.merge_cap: compacting inside-ROI lines before the
    merge is exact while n_inside <= cap (identical winner + scores to the
    uncapped run); a binding cap is counted in cap_overflow and zeroed by
    the drivers' _caps_off fallback."""
    gray, K, T_wc, bbox, lines, mask = demo_inputs
    args = (
        gray, jnp.asarray(K), jnp.asarray(T_wc), jnp.asarray(bbox),
        jnp.asarray(lines), jnp.asarray(mask),
    )
    capped = ProposalConfig(max_lines=lines.shape[0], merge_cap=128)
    uncapped = ProposalConfig(max_lines=lines.shape[0], merge_cap=0)
    res_c = detect_cuboid_single(*args, capped)
    res_u = detect_cuboid_single(*args, uncapped)
    assert int(res_c.cap_overflow) == 0
    np.testing.assert_array_equal(
        np.asarray(res_c.pos), np.asarray(res_u.pos)
    )
    np.testing.assert_array_equal(
        np.asarray(res_c.rotY), np.asarray(res_u.rotY)
    )
    np.testing.assert_array_equal(
        np.asarray(res_c.normalized_error), np.asarray(res_u.normalized_error)
    )
    # binding cap (fixture has 89 inside-ROI lines): overflow observable
    tiny = ProposalConfig(max_lines=lines.shape[0], merge_cap=16)
    res_t = detect_cuboid_single(*args, tiny)
    assert int(res_t.cap_overflow) > 0

    from cube_slam_wu_tpu.slam.pipeline import _caps_off

    assert _caps_off(capped).merge_cap == 0
