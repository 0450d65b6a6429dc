"""Image op tests: exact EDT vs scipy, Canny behaviour on synthetic shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi

from cube_slam_wu_tpu.ops import image as image_ops


def test_edt_matches_scipy_exact():
    rng = np.random.default_rng(0)
    edge = rng.random((60, 83)) < 0.02
    edge[0, 0] = True  # ensure nonempty
    ours = np.asarray(image_ops.distance_transform(jnp.asarray(edge)))
    # scipy: distance to nearest zero; invert mask
    ref = ndi.distance_transform_edt(~edge)
    np.testing.assert_allclose(ours, ref, atol=1e-3)


@pytest.mark.parametrize(
    "shape, density", [((37, 53), 0.05), ((128, 96), 0.002), ((480, 640), 0.01)]
)
def test_edt_xla_matches_scipy(shape, density):
    """The XLA row stage at three shapes, VGA included (the proposal
    grid's distance maps are 480x640)."""
    rng = np.random.default_rng(sum(shape))
    edge = rng.random(shape) < density
    edge[shape[0] // 2, shape[1] // 3] = True
    ours = np.asarray(image_ops.distance_transform(jnp.asarray(edge)))
    np.testing.assert_allclose(ours, ndi.distance_transform_edt(~edge), atol=1e-3)


def test_edt_empty_edges_large():
    edge = jnp.zeros((16, 16), bool)
    out = np.asarray(image_ops.distance_transform(edge))
    assert np.all(out > 1e3)


def test_canny_detects_square_outline():
    img = np.zeros((64, 64))
    img[20:44, 16:48] = 200.0
    edges = np.asarray(image_ops.canny(jnp.asarray(img), 80.0, 200.0))
    # edges hug the square boundary, none deep inside or far outside
    assert edges[18:22, 30].any() and edges[42:46, 30].any()
    assert edges[32, 14:18].any() and edges[32, 46:50].any()
    assert not edges[30:34, 28:36].any()
    assert not edges[:10].any() and not edges[-10:].any()


def test_canny_hysteresis_links_weak_to_strong():
    # gradient ramp edge: one segment strong, contiguous weak part kept,
    # isolated weak part dropped
    img = np.zeros((40, 80))
    img[:, 40:] = 120.0  # uniform step edge, |gx|+|gy| = 4*120 > 200 strong
    strong = np.asarray(image_ops.canny(jnp.asarray(img), 80.0, 200.0))
    assert strong[:, 39:41].any()
    img2 = np.zeros((40, 80))
    img2[:, 40:] = 30.0  # 4*30 = 120: weak only -> no strong seed -> dropped
    weak_only = np.asarray(image_ops.canny(jnp.asarray(img2), 80.0, 200.0))
    assert not weak_only.any()


def test_replicate_roi_matches_crop_filter():
    """Sobel on the replicate-filled buffer == Sobel on the crop with
    replicate border, inside the ROI."""
    rng = np.random.default_rng(1)
    img = rng.random((32, 40)) * 255
    x0, y0, x1, y1 = 5, 7, 30, 25
    buf = np.asarray(image_ops.replicate_roi(jnp.asarray(img), x0, y0, x1, y1))
    gx_full, gy_full = image_ops.sobel3(jnp.asarray(buf))
    crop = img[y0 : y1 + 1, x0 : x1 + 1]
    gx_crop, gy_crop = image_ops.sobel3(jnp.asarray(crop))
    np.testing.assert_allclose(
        np.asarray(gx_full)[y0 : y1 + 1, x0 : x1 + 1], np.asarray(gx_crop), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(gy_full)[y0 : y1 + 1, x0 : x1 + 1], np.asarray(gy_crop), atol=1e-9
    )


def test_rgb_to_gray_rounding():
    img = jnp.asarray([[[100.0, 150.0, 200.0]]])
    out = float(image_ops.rgb_to_gray(img)[0, 0])
    expect = np.floor(0.299 * 100 + 0.587 * 150 + 0.114 * 200 + 0.5)
    assert out == expect


def test_hysteresis_matches_connected_components_no_wrap():
    """Hysteresis fixpoint == weak pixels 8-connected to a strong seed,
    with NO wraparound across image borders (cv::Canny semantics; the
    round-3 roll-based loop leaked chains across borders).  Ground truth
    via scipy connected-component labelling on the same weak/strong masks."""
    rng = np.random.default_rng(7)
    for _ in range(3):
        h = int(rng.integers(40, 160))
        w = int(rng.integers(40, 200))
        g = ndi.gaussian_filter(rng.random((h, w)) * 255.0, 3.0) * 4.0
        gj = jnp.asarray(g.astype(np.float32))
        gx, gy = image_ops.sobel3(gj)
        mag = jnp.abs(gx) + jnp.abs(gy)
        keep = image_ops._nms(mag, gx, gy)
        strong = np.asarray(keep & (mag > 80.0))
        weak = np.asarray(keep & (mag > 30.0))
        lab, _ = ndi.label(weak, structure=np.ones((3, 3)))
        keep_ids = np.unique(lab[strong & (lab > 0)])
        truth = np.isin(lab, keep_ids) & weak & (lab > 0)
        ours = np.asarray(image_ops.canny(gj, 30.0, 80.0))
        np.testing.assert_array_equal(ours, truth)


def test_edt_column_doubling_matches_scan_semantics():
    """The min-plus doubling column pass gives exact per-column distances
    (small integers) wherever a column has an edge, and stays above the
    1e6 clamp where it does not."""
    rng = np.random.default_rng(3)
    edge = rng.random((77, 41)) < 0.03
    edge[:, 0] = False  # one empty column
    g = np.asarray(image_ops._edt_1d_columns(jnp.asarray(edge)))
    for x in range(edge.shape[1]):
        rows = np.nonzero(edge[:, x])[0]
        for y in range(edge.shape[0]):
            if len(rows):
                assert g[y, x] == np.abs(rows - y).min()
            else:
                assert g[y, x] > 1e6
