"""Line-detector behavioural tests: synthetic scenes + fixture recall."""

import jax.numpy as jnp
import numpy as np
import pytest

from cube_slam_wu_tpu.ops.detect import DetectConfig, detect_line_segments
from cube_slam_wu_tpu.utils import io as uio


def _match(l, r, perp_tol=4.0, ov_min=0.5, ang_tol=0.15):
    qa, qb = r[:2], r[2:]
    d = qb - qa
    L = np.linalg.norm(d) + 1e-9
    n = np.array([-d[1], d[0]]) / L
    perp = max(abs((l[:2] - qa) @ n), abs((l[2:] - qa) @ n))
    ta, tb = (l[:2] - qa) @ d / L**2, (l[2:] - qa) @ d / L**2
    ov = min(max(ta, tb), 1) - max(min(ta, tb), 0)
    a1 = np.arctan2(l[3] - l[1], l[2] - l[0])
    a2 = np.arctan2(r[3] - r[1], r[2] - r[0])
    da = abs(a1 - a2) % np.pi
    da = min(da, np.pi - da)
    return perp < perp_tol and ov > ov_min and da < ang_tol


def _detected(gray, cfg=DetectConfig()):
    lines, mask = detect_line_segments(jnp.asarray(gray), cfg)
    return np.asarray(lines)[np.asarray(mask)]


def test_synthetic_rectangle():
    img = np.full((120, 160), 40.0)
    img[30:90, 40:120] = 200.0
    lines = _detected(img)
    expected = [
        np.array([40, 30, 119, 30.0]),
        np.array([40, 89, 119, 89.0]),
        np.array([40, 30, 40, 89.0]),
        np.array([119, 30, 119, 89.0]),
    ]
    for e in expected:
        assert any(_match(l, e) for l in lines), (e, lines[:10])


def test_synthetic_diagonal():
    img = np.full((160, 160), 30.0)
    ys, xs = np.mgrid[0:160, 0:160]
    img[(xs + ys) > 160] = 220.0  # diagonal step edge
    lines = _detected(img)
    diag = np.array([20.0, 140.0, 140.0, 20.0])
    assert any(_match(l, diag, perp_tol=4.0, ov_min=0.6) for l in lines)


def test_blank_image_no_lines():
    img = np.full((120, 160), 128.0)
    lines = _detected(img)
    assert len(lines) == 0


def test_fixture_recall(reference_root):
    """Recall of the reference's own LSD output on the bundled demo image
    (behavioural parity target, SURVEY.md section 7.1)."""
    base = reference_root / "detect_3d_cuboid/data"
    gray = uio.load_image_gray(base / "0000_rgb_raw.jpg")
    ref = uio.read_number_txt(base / "edge_detection/LSD/0000_edge.txt")
    lines = _detected(gray)
    ref_long = ref[np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1]) > 40]
    hits = sum(any(_match(l, r) for l in lines) for r in ref_long)
    recall = hits / len(ref_long)
    assert recall >= 0.9, recall
    # and we should not produce a wildly larger set than LSD
    assert len(lines) < 4 * len(ref)


def test_endpoint_stability_under_subpixel_warp(reference_root):
    """Endpoint stability: detect on an image and on a known sub-pixel
    affine warp of it, un-warp, and require small median endpoint drift.
    The reference's chain-walking detectors get this implicitly by re-walking
    the same pixel chains (lsd.cpp:637); for the batched Hough detector the
    bound is ~t_bin from along-line endpoint quantisation."""
    from cube_slam_wu_tpu.utils.metrics import line_endpoint_stability

    base = reference_root / "object_slam/data/raw_imgs"
    gray = uio.load_image_gray(base / "0000_rgb_raw.jpg")
    H, W = gray.shape

    th, tx, ty = 0.005, 1.3, -1.7
    A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.array([tx, ty])
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    sx = A[0, 0] * xs + A[0, 1] * ys + t[0]
    sy = A[1, 0] * xs + A[1, 1] * ys + t[1]
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    warped = (
        gray[y0, x0] * (1 - fx) * (1 - fy)
        + gray[y0, x0 + 1] * fx * (1 - fy)
        + gray[y0 + 1, x0] * (1 - fx) * fy
        + gray[y0 + 1, x0 + 1] * fx * fy
    )

    lines_a = _detected(gray)
    lines_w = _detected(warped)
    un = np.empty_like(lines_w)
    un[:, 0:2] = lines_w[:, 0:2] @ A.T + t
    un[:, 2:4] = lines_w[:, 2:4] @ A.T + t
    drift, n = line_endpoint_stability(
        lines_a, un, max_mid_dist=6.0, max_angle_deg=4.0
    )
    assert n >= 40, n
    assert drift < 3.0, drift


def test_nfa_rejects_noise():
    """A-contrario gate: on a pure-noise image the NFA-validated detector
    must report (near-)nothing, while min_inliers alone lets spurious
    alignments through (the exact failure LSD's NFA exists to prevent,
    lsd.cpp:873)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(160, 200))
    base = _detected(img.astype(np.float64))
    gated = _detected(
        img.astype(np.float64),
        DetectConfig(nfa_validation=True),
    )
    assert len(gated) <= max(2, len(base) // 4), (len(base), len(gated))


def test_nfa_keeps_real_structure(reference_root):
    """NFA validation must not cost fixture recall: the reference LSD's own
    long segments stay detected."""
    base = reference_root / "detect_3d_cuboid/data"
    gray = uio.load_image_gray(base / "0000_rgb_raw.jpg")
    ref = uio.read_number_txt(base / "edge_detection/LSD/0000_edge.txt")
    lines = _detected(gray, DetectConfig(nfa_validation=True))
    ref_long = ref[np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1]) > 40]
    hits = sum(any(_match(l, r) for l in lines) for r in ref_long)
    assert hits / len(ref_long) >= 0.85, hits / len(ref_long)


def test_octave_pyramid_recall(reference_root):
    """2-octave detection (library capability: numOfOctave_ pyramids,
    binary_descriptor.cpp:352-372): endpoints come back in octave-0
    coordinates and recall does not regress vs single-octave."""
    from cube_slam_wu_tpu.ops.detect import detect_line_segments_octaves

    base = reference_root / "detect_3d_cuboid/data"
    gray = np.asarray(uio.load_image_gray(base / "0000_rgb_raw.jpg"))
    ref = uio.read_number_txt(base / "edge_detection/LSD/0000_edge.txt")
    ref_long = ref[np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1]) > 40]

    def recall(lines):
        return sum(any(_match(l, r) for l in lines) for r in ref_long) / len(
            ref_long
        )

    l1, m1 = detect_line_segments_octaves(jnp.asarray(gray), n_octaves=1)
    l2, m2 = detect_line_segments_octaves(jnp.asarray(gray), n_octaves=2)
    one = np.asarray(l1)[np.asarray(m1)]
    two = np.asarray(l2)[np.asarray(m2)]
    H, W = gray.shape
    assert (two[:, [0, 2]] < W + 2).all() and (two[:, [1, 3]] < H + 2).all()
    assert recall(two) >= recall(one) - 1e-9, (recall(one), recall(two))


def test_octave_single_equals_base():
    from cube_slam_wu_tpu.ops.detect import detect_line_segments_octaves

    img = np.full((120, 160), 40.0)
    img[30:90, 40:120] = 200.0
    l0, m0 = detect_line_segments(jnp.asarray(img))
    l1, m1 = detect_line_segments_octaves(jnp.asarray(img), n_octaves=1)
    np.testing.assert_array_equal(np.asarray(l0), np.asarray(l1))
    np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))


def test_short_band_recall_quantified(reference_root):
    """15-40 px recall (VERDICT r2 item 8): the reference wrapper keeps
    every segment > 15 px (line_lbd_allclass.h:32-35), so the short band
    needs a number.  Defaults trade short-segment recall for the online
    latency the ATE numbers are pinned to; the high-recall config (more
    Hough peaks + runs) is the documented knob for cluttered scenes.
    Measured on the demo fixture vs the reference LSD's own output:
    default 0.54 / high-recall 0.62 in (15,40], with >40 px recall 0.94 /
    0.95 (COVERAGE.md).  (inlier_rho_tol=1.0 would lift these to
    0.56/0.65 and 0.95/0.97 but costs online ATE — see DetectConfig.)"""
    base = reference_root / "detect_3d_cuboid/data"
    gray = uio.load_image_gray(base / "0000_rgb_raw.jpg")
    ref = uio.read_number_txt(base / "edge_detection/LSD/0000_edge.txt")
    lens = np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1])
    band = ref[(lens > 15) & (lens <= 40)]

    def band_recall(cfg):
        lines = _detected(gray, cfg)
        hits = sum(any(_match(l, r) for l in lines) for r in band)
        return hits / len(band)

    r_default = band_recall(DetectConfig())
    assert r_default >= 0.50, r_default
    high = DetectConfig(n_peaks=512, runs_per_peak=8, max_output=512)
    r_high = band_recall(high)
    assert r_high >= 0.58, r_high
    assert r_high > r_default


def test_short_band_recovery_pass(reference_root):
    """Additive recovery pass (round-5 verdict item 6): pass-1 claimed
    pixels suppressed, residual re-extraction with a lower run gate, pass-2
    survivors fill EXTRA output slots only.  Measured 0.751 in (15, 40]
    (vs 0.54 single-pass) with >40 px recall 0.968 and the pass-1 slot
    prefix preserved verbatim."""
    from cube_slam_wu_tpu.ops.detect import detect_line_segments_recover

    base = reference_root / "detect_3d_cuboid/data"
    gray = uio.load_image_gray(base / "0000_rgb_raw.jpg")
    ref = uio.read_number_txt(base / "edge_detection/LSD/0000_edge.txt")
    lens = np.hypot(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1])
    band = ref[(lens > 15) & (lens <= 40)]
    long_band = ref[lens > 40]

    cfg = DetectConfig()
    lines, mask = detect_line_segments_recover(jnp.asarray(gray), cfg)
    det = np.asarray(lines)[np.asarray(mask)]
    r_short = sum(any(_match(l, r) for l in det) for r in band) / len(band)
    r_long = sum(any(_match(l, r) for l in det) for r in long_band) / len(
        long_band
    )
    assert r_short >= 0.73, r_short
    assert r_long >= 0.94, r_long

    # additivity: the single-pass output is the verbatim prefix
    l1, m1 = detect_line_segments(jnp.asarray(gray), cfg)
    n1 = int(np.asarray(m1).sum())
    assert np.array_equal(
        np.asarray(l1)[np.asarray(m1)], np.asarray(lines)[:n1]
    )


def _blur_fixed_numpy(img):
    """Integer reference of gaussian_blur5_fixed (replicate border)."""
    from cube_slam_wu_tpu.ops.detect import _BLUR_BITS, _BLUR_TAPS

    a = np.clip(np.round(img), 0, 255).astype(np.int64)
    for axis in (0, 1):
        n = a.shape[axis]
        a = sum(
            k * np.take(a, np.clip(np.arange(n) + off, 0, n - 1), axis=axis)
            for off, k in zip(range(-2, 3), _BLUR_TAPS)
        )
    return a / float(1 << 2 * _BLUR_BITS)


@pytest.mark.parametrize("shape", [(7, 5), (48, 64), (480, 640)])
def test_fixed_blur_is_exact(shape):
    """The detector's blur is integer arithmetic: it equals the int64
    reference exactly (so no backend's summation order can change it) and
    stays within 0.5 gray levels of the float Gaussian it stands for."""
    from cube_slam_wu_tpu.ops.detect import gaussian_blur5, gaussian_blur5_fixed

    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.float32)
    ours = np.asarray(gaussian_blur5_fixed(jnp.asarray(img)))
    ref = _blur_fixed_numpy(img)
    assert np.array_equal(ours, ref.astype(np.float32))
    assert np.abs(ours - np.asarray(gaussian_blur5(jnp.asarray(img)))).max() < 0.5


def test_fixed_blur_rounds_and_clips_input():
    from cube_slam_wu_tpu.ops.detect import gaussian_blur5_fixed

    img = np.array([[-3.0, 0.4, 254.6, 300.0]] * 5, np.float32)
    out = np.asarray(gaussian_blur5_fixed(jnp.asarray(img)))
    ref = np.asarray(gaussian_blur5_fixed(jnp.asarray(np.clip(np.round(img), 0, 255))))
    assert np.array_equal(out, ref)
