"""Line-Band-Descriptor (LBD) + binary conversion + Hamming matching.

Batched re-design of the reference's descriptor stack
(line_lbd/libs/binary_descriptor.cpp:1150-1515 `computeLBD`,
`binaryConversion` :405-416, and the Multi-Index-Hashing matcher in
binary_descriptor_matcher.cpp).  The math follows the reference exactly:

- 9 bands x width 7 line-support region sampled along/perpendicular to the
  line, gradients projected on the line direction dL and its clockwise
  orthogonal dO, positive/negative parts split,
- per-row global Gaussian weight (sigma = halfHeight), per-band local
  Gaussian spill into the two neighbouring bands (sigma = (2w+1)/2),
- band means/stds with 1/(2w) edge-band and 1/(3w) inner-band normalisers,
- two-stage normalisation (means and stds separately), 0.4 clipping,
  re-normalisation -> 72-float descriptor,
- 256-bit binarisation by comparing the 32 fixed band pairs (the constant
  table from the LBD paper, binary_descriptor.cpp:74-107).

Matching replaces MIH hash tables with a dense XOR+popcount Hamming matrix —
at padded set sizes of a few hundred lines the dense form is one batched
op with no data-dependent control flow, and exactly reproduces nearest-neighbour matching
with the reference's dist<25 acceptance (line_lbd_allclass.cpp:352-369).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.precision import einsum

NUM_BANDS = 9
BAND_WIDTH = 7

# band-pair comparison table (binary_descriptor.cpp:74-107)
_COMBINATIONS = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6),
    (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
    (2, 3), (2, 4), (2, 5), (2, 6), (2, 7), (2, 8),
    (3, 4), (3, 5), (3, 6), (3, 7), (3, 8),
    (4, 5), (4, 6), (4, 7), (4, 8),
    (5, 6), (5, 7), (5, 8),
    (6, 7), (6, 8),
    (7, 8),
)


def _gauss_coefs(dtype):
    """Local (3w) and global (9w) Gaussian weights
    (binary_descriptor.cpp:147-177; note the integer divisions)."""
    w = BAND_WIDTH
    u_l = (w * 3 - 1) // 2
    sigma_l = (w * 2 + 1) // 2
    i = jnp.arange(w * 3, dtype=dtype)
    coef_l = jnp.exp(-((i - u_l) ** 2) / (2.0 * sigma_l * sigma_l))
    n = NUM_BANDS * w
    u_g = (n - 1) // 2
    sigma_g = u_g
    j = jnp.arange(n, dtype=dtype)
    coef_g = jnp.exp(-((j - u_g) ** 2) / (2.0 * sigma_g * sigma_g))
    return coef_l, coef_g


_GRAD_BIAS = 1020.0  # |3x3 Sobel of a u8 image| <= 4*255
_GRAD_SCALE = 2048.0  # bias*2*scale + bias*2 = 4.18M < 2^24: exact in f32


def _pack_gradients(gx, gy):
    """Pack the two INTEGER-VALUED gradient maps into one f32 so each
    descriptor sample costs ONE gather instead of two.  Exact: Sobel-of-u8 values are ints in
    [-1020, 1020], so (gx+1020)*2048 + (gy+1020) <= 4.18M sits inside the
    f32 24-bit mantissa."""
    gxr = jnp.round(gx.astype(jnp.float32))
    gyr = jnp.round(gy.astype(jnp.float32))
    return (gxr + _GRAD_BIAS) * _GRAD_SCALE + (gyr + _GRAD_BIAS)


def int_gradients(gray):
    """Reference-semantics gradient maps as a jitted op: 5x5 sigma-1
    Gaussian blur (reflect-101 border) ROUNDED to u8 levels, then integer
    3x3 Sobel (BinaryDescriptor::computeSobel, binary_descriptor.cpp:
    352-398; the reference's Sobel runs on the quantised blurred image).
    Returns float32 maps holding exact integers."""
    g = jnp.asarray(gray, jnp.float32)
    x = jnp.arange(5.0) - 2.0
    k = jnp.exp(-(x * x) / 2.0)
    k = (k / jnp.sum(k)).astype(jnp.float32)
    a = jnp.pad(g, 2, mode="reflect")  # BORDER_REFLECT_101
    H, W = g.shape
    h = sum(k[i] * jax.lax.dynamic_slice_in_dim(a, i, W, axis=1) for i in range(5))
    v = sum(k[i] * jax.lax.dynamic_slice_in_dim(h, i, H, axis=0) for i in range(5))
    blur = jnp.clip(jnp.round(v), 0.0, 255.0)
    b = jnp.pad(blur, 1, mode="reflect")
    sm_v = b[0:H, :] + 2.0 * b[1 : H + 1, :] + b[2 : H + 2, :]
    gx = sm_v[:, 2 : W + 2] - sm_v[:, 0:W]
    sm_h = b[:, 0:W] + 2.0 * b[:, 1 : W + 1] + b[:, 2 : W + 2]
    gy = sm_h[2 : H + 2, :] - sm_h[0:H, :]
    return gx, gy


@jax.jit
def _descriptor_from_samples(packed, xi, yi, w_valid, dLx, dLy):
    """Shared descriptor core: given the PACKED gradient map
    (`_pack_gradients`) and per-sample integer coordinates (L, 63,
    max_len), compute the 72-float LBD exactly as computeLBD does after
    its sampling loop (binary_descriptor.cpp:1298-1482): gradient
    projection on (dL, dO), per-row +/- split sums, global/local Gaussian
    band weighting, mean/std per band, two-stage normalisation, 0.4 clip,
    re-normalisation."""
    dtype = packed.dtype
    dOx, dOy = -dLy, dLx  # clockwise orthogonal
    height = NUM_BANDS * BAND_WIDTH  # 63

    # ONE flat 1-D take per sample
    W = packed.shape[1]
    flat_idx = yi * W + xi
    v = jnp.take(packed.reshape(-1), flat_idx)
    dx = jnp.floor(v / _GRAD_SCALE) - _GRAD_BIAS
    dy = v - (dx + _GRAD_BIAS) * _GRAD_SCALE - _GRAD_BIAS
    gdl = dx * dLx[:, None, None] + dy * dLy[:, None, None]
    gdo = dx * dOx[:, None, None] + dy * dOy[:, None, None]

    wv = w_valid[:, None, :]
    pos_l = jnp.sum(jnp.where(wv & (gdl > 0), gdl, 0.0), axis=-1)  # (L, 63)
    neg_l = jnp.sum(jnp.where(wv & (gdl <= 0), -gdl, 0.0), axis=-1)
    pos_o = jnp.sum(jnp.where(wv & (gdo > 0), gdo, 0.0), axis=-1)
    neg_o = jnp.sum(jnp.where(wv & (gdo <= 0), -gdo, 0.0), axis=-1)

    coef_l, coef_g = _gauss_coefs(dtype)
    rows = jnp.stack([pos_l, neg_l, pos_o, neg_o], axis=-1) * coef_g[None, :, None]
    rows2 = rows * rows  # squared AFTER global weighting (matches reference)

    band_of_row = (jnp.arange(height) // BAND_WIDTH).astype(jnp.int32)
    hmod = jnp.arange(height) % BAND_WIDTH

    # contribution weights of each row into (own band, band-1, band+1)
    c_self = coef_l[hmod + BAND_WIDTH]
    c_above = coef_l[hmod + 2 * BAND_WIDTH]  # into band-1
    c_below = coef_l[hmod]  # into band+1

    def accumulate(target_band_of_row, coefs):
        onehot = (
            target_band_of_row[None, :] == jnp.arange(NUM_BANDS)[:, None]
        ).astype(dtype)  # (9, 63)
        s1 = einsum("bh,h,lhc->lbc", onehot, coefs, rows)
        s2 = einsum("bh,h,lhc->lbc", onehot, coefs * coefs, rows2)
        return s1, s2

    s1a, s2a = accumulate(band_of_row, c_self)
    s1b, s2b = accumulate(band_of_row - 1, c_above)
    s1c, s2c = accumulate(band_of_row + 1, c_below)
    band_sum = s1a + s1b + s1c  # (L, 9, 4)
    band_sum2 = s2a + s2b + s2c

    inv_n = jnp.where(
        (jnp.arange(NUM_BANDS) == 0) | (jnp.arange(NUM_BANDS) == NUM_BANDS - 1),
        1.0 / (BAND_WIDTH * 2.0),
        1.0 / (BAND_WIDTH * 3.0),
    ).astype(dtype)[None, :, None]
    mean = band_sum * inv_n
    var = jnp.maximum(band_sum2 * inv_n - mean * mean, 0.0)
    std = jnp.sqrt(var)

    desc = jnp.concatenate([mean, std], axis=-1)  # (L, 9, 8): 4 means + 4 stds
    # two-stage normalisation: means and stds separately
    m_norm = jnp.sqrt(jnp.sum(mean * mean, axis=(1, 2)) + 1e-24)
    s_norm = jnp.sqrt(jnp.sum(std * std, axis=(1, 2)) + 1e-24)
    desc = jnp.concatenate(
        [mean / m_norm[:, None, None], std / s_norm[:, None, None]], axis=-1
    )
    desc = jnp.minimum(desc, 0.4)  # illumination clipping
    flat = desc.reshape(desc.shape[0], -1)
    flat = flat / jnp.sqrt(jnp.sum(flat * flat, axis=-1, keepdims=True) + 1e-24)
    return flat.reshape(-1, NUM_BANDS * 8)


@functools.partial(jax.jit, static_argnames=("max_len",))
def lbd_descriptors(
    gray: jnp.ndarray,
    lines: jnp.ndarray,
    mask: jnp.ndarray,
    max_len: int = 160,
    num_pixels: jnp.ndarray | None = None,
    gradients: tuple[jnp.ndarray, jnp.ndarray] | None = None,
):
    """Compute 72-float LBD descriptors for a padded line set.

    Reference semantics (computeLBD, binary_descriptor.cpp:1150-1513):
    integer halfWidth = (numOfPixels-1)/2, samples rounded half-away-from-
    zero and clamped to [0, W-1]x[0, H-1], line-support length equal to the
    Bresenham pixel count (cv::LineIterator semantics ~ Chebyshev length+1,
    line_lbd_allclass.cpp:62-64), gradients from the blurred image's 3x3
    Sobel (computeSobel :374-398).  Pinned against the reference compiled
    from source by tests/test_lbd_oracle_parity.py.

    Args:
      gray: (H, W) grayscale image (the reference computes Sobel on the
        Gaussian-blurred octave image, binary_descriptor.cpp:352-374).
      lines: (L, 4) [x1 y1 x2 y2]; mask: (L,).
      max_len: static cap on the sampled line-support length in pixels.
      num_pixels: optional (L,) override of the per-line support length
        (the reference's KeyLine.numOfPixels); default derives it from the
        endpoints with LineIterator semantics.
      gradients: optional precomputed (gx, gy) maps; default recomputes
        blur+Sobel from `gray`.

    Returns (desc (L, 72) float, valid (L,)).
    """
    dtype = gray.dtype
    H, W = gray.shape
    if gradients is None:
        # reference-semantics integer gradients (rounded u8 blur + integer
        # Sobel): matches computeSobel to the u8 blur's +-1 fixed-point
        # quantisation, and integer values enable the exact packed
        # single-gather sampling below
        gx, gy = int_gradients(gray)
    else:
        gx, gy = gradients
    packed = _pack_gradients(gx, gy)

    sx, sy = lines[:, 0], lines[:, 1]
    ex, ey = lines[:, 2], lines[:, 3]
    direction = jnp.arctan2(ey - sy, ex - sx)
    dLx, dLy = jnp.cos(direction), jnp.sin(direction)
    dOx, dOy = -dLy, dLx  # clockwise orthogonal
    midx, midy = 0.5 * (sx + ex), 0.5 * (sy + ey)
    if num_pixels is None:
        # cv::LineIterator 8-connected count on rounded endpoints
        n_pix = (
            jnp.maximum(
                jnp.abs(jnp.round(ex) - jnp.round(sx)),
                jnp.abs(jnp.round(ey) - jnp.round(sy)),
            )
            + 1.0
        )
    else:
        n_pix = num_pixels.astype(dtype)
    n_pix = jnp.minimum(n_pix, float(max_len))
    half_w = jnp.floor((n_pix - 1.0) / 2.0)  # integer halfWidth (ref :1250)

    height = NUM_BANDS * BAND_WIDTH  # 63
    half_h = (height - 1) // 2  # 31

    h_ids = jnp.arange(height, dtype=dtype)  # (63,)
    w_ids = jnp.arange(max_len, dtype=dtype)  # (max_len,)
    w_valid = w_ids[None, :] < n_pix[:, None]  # (L, max_len)

    # sample positions: pos(h, w) = mid + (w - halfW)*dL + (h - halfH)*dO
    px = (
        midx[:, None, None]
        + (w_ids[None, None, :] - half_w[:, None, None]) * dLx[:, None, None]
        + (h_ids[None, :, None] - half_h) * dOx[:, None, None]
    )  # (L, 63, max_len)
    py = (
        midy[:, None, None]
        + (w_ids[None, None, :] - half_w[:, None, None]) * dLy[:, None, None]
        + (h_ids[None, :, None] - half_h) * dOy[:, None, None]
    )
    # round half away from zero (C round(); after the >=0 clamp this is
    # floor(x+0.5) for every value that can land in range)
    xi = jnp.clip(jnp.floor(px + 0.5).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.floor(py + 0.5).astype(jnp.int32), 0, H - 1)
    return _descriptor_from_samples(packed, xi, yi, w_valid, dLx, dLy), mask


def reference_gradients(gray_u8):
    """OpenCV-equivalent gradient maps for LBD parity: GaussianBlur(5x5,
    sigma=1, BORDER_REFLECT_101) rounded to uint8, then 3x3 Sobel (CV_16S,
    BORDER_REFLECT_101) — BinaryDescriptor::computeSobel
    (binary_descriptor.cpp:352-398) at octave 0.

    The Sobel stage is bit-exact vs the reference build.  The blur stage
    matches to +/-1 gray level: OpenCV's 8U Gaussian runs a fixed-point
    (position-dependent, IPP-backed) pipeline whose exact rounding is not
    reproducible from the documented kernel; measured agreement on the
    cabinet fixture is 54% exact / 46% off-by-one.  Pass oracle-dumped (dx, dy) to
    `lbd_descriptors(..., gradients=...)` when exact parity is required.

    Returns (gx, gy) int32 arrays.
    """
    import numpy as np

    g = np.asarray(gray_u8, np.float64)
    x = np.arange(5.0) - 2.0
    k = np.exp(-(x * x) / 2.0)
    k = k / k.sum()
    a = np.pad(g, 2, mode="reflect")  # BORDER_REFLECT_101
    H, W = g.shape
    h = sum(k[i] * a[:, i : i + W] for i in range(5))
    v = sum(k[i] * h[i : i + H, :] for i in range(5))
    blur = np.clip(np.rint(v), 0, 255).astype(np.int64)
    b = np.pad(blur, 1, mode="reflect")
    sm_v = b[0:H, :] + 2 * b[1 : H + 1, :] + b[2 : H + 2, :]
    gx = sm_v[:, 2 : W + 2] - sm_v[:, 0:W]
    sm_h = b[:, 0:W] + 2 * b[:, 1 : W + 1] + b[:, 2 : W + 2]
    gy = sm_h[2 : H + 2, :] - sm_h[0:H, :]
    return gx.astype(np.int32), gy.astype(np.int32)


def lbd_descriptors_ref_exact(
    gray_shape,
    gradients,
    lines,
    angles,
    num_pixels,
    max_len: int = 700,
):
    """Reference-exact LBD path (test/oracle infrastructure).

    computeLBD accumulates its sample coordinates sequentially in float32
    (sCorX += dL[0] per column, sCorX0 -= dL[1] per row,
    binary_descriptor.cpp:1270-1327); near .5-boundaries the accumulated
    f32 rounding decides which pixel gets sampled, so bit-faithful parity
    requires replicating that accumulation order.  This wrapper reproduces
    the C scalar setup + accumulation with host numpy float32 ops (IEEE f32
    adds in C program order), then runs the SAME jitted descriptor core the
    production path uses (`_descriptor_from_samples`).

    Args:
      gray_shape: (H, W) of the octave image.
      gradients: (gx, gy) int arrays (e.g. oracle dx/dy dumps or
        `reference_gradients`).
      lines: (L, 4) endpoints; angles: (L,) KeyLine.angle (f32);
      num_pixels: (L,) KeyLine.numOfPixels.

    Returns desc (L, 72) float32.
    """
    import numpy as np

    f32 = np.float32
    H, W = gray_shape
    lines = np.asarray(lines, np.float64)
    sx = lines[:, 0].astype(f32)
    sy = lines[:, 1].astype(f32)
    ex = lines[:, 2].astype(f32)
    ey = lines[:, 3].astype(f32)
    angle = np.asarray(angles, f32)
    npix = np.minimum(np.asarray(num_pixels, np.int64), max_len)

    # C scalar setup (:1249-1271), f32 op order
    dL0 = np.cos(angle.astype(np.float64)).astype(f32)
    dL1 = np.sin(angle.astype(np.float64)).astype(f32)
    halfW = ((npix - 1) // 2).astype(f32)
    midx = (np.float64(0.5) * (sx + ex).astype(np.float64)).astype(f32)
    midy = (np.float64(0.5) * (sy + ey).astype(np.float64)).astype(f32)
    height = NUM_BANDS * BAND_WIDTH
    half_h = f32((height - 1) // 2)
    rx = ((-dL0 * halfW).astype(f32) + (dL1 * half_h).astype(f32)).astype(f32) + midx
    ry = ((-dL1 * halfW).astype(f32) - (dL0 * half_h).astype(f32)).astype(f32) + midy
    rx = rx.astype(f32)
    ry = ry.astype(f32)

    L = len(lines)
    max_np = int(npix.max()) if L else 1
    # np.add.accumulate is a strict left fold at the accumulator dtype, i.e.
    # the same IEEE-f32 add sequence as the C loops.
    row_sx = np.add.accumulate(
        np.concatenate([rx[None], np.broadcast_to(-dL1, (height - 1, L))]), axis=0, dtype=f32
    )  # (63, L) row starts
    row_sy = np.add.accumulate(
        np.concatenate([ry[None], np.broadcast_to(dL0, (height - 1, L))]), axis=0, dtype=f32
    )
    cx = np.add.accumulate(
        np.concatenate(
            [row_sx[None], np.broadcast_to(dL0, (max_np - 1, height, L))]
        ),
        axis=0,
        dtype=f32,
    )  # (max_np, 63, L)
    cy = np.add.accumulate(
        np.concatenate(
            [row_sy[None], np.broadcast_to(dL1, (max_np - 1, height, L))]
        ),
        axis=0,
        dtype=f32,
    )
    xi = np.clip(np.floor(cx.astype(np.float64) + 0.5), 0, W - 1).astype(np.int32)
    yi = np.clip(np.floor(cy.astype(np.float64) + 0.5), 0, H - 1).astype(np.int32)
    xi = np.transpose(xi, (2, 1, 0))  # (L, 63, max_np)
    yi = np.transpose(yi, (2, 1, 0))

    w_valid = jnp.asarray(np.arange(max_np)[None, :] < npix[:, None])
    packed = _pack_gradients(
        jnp.asarray(np.asarray(gradients[0]), jnp.float32),
        jnp.asarray(np.asarray(gradients[1]), jnp.float32),
    )
    return _descriptor_from_samples(
        packed, jnp.asarray(xi), jnp.asarray(yi), w_valid,
        jnp.asarray(dL0), jnp.asarray(dL1)
    )


def lbd_descriptors_octaves(
    gray: jnp.ndarray,
    lines: jnp.ndarray,
    mask: jnp.ndarray,
    octaves: jnp.ndarray,
    n_octaves: int,
    max_len: int = 160,
):
    """LBD descriptors computed on each segment's ORIGINATING octave image
    (detect_descrip_lines_octaves semantics, line_lbd_allclass.cpp:296-349:
    the reference runs computeLBD per pyramid level; descriptors of a
    coarse-octave segment must come from the coarse image, where its
    support region is the structure the detector actually saw).

    Args:
      gray: (H, W) base image; the pyramid is rebuilt with the same
        `downsample2` the detector used.
      lines: (L, 4) in OCTAVE-0 coordinates (as returned by
        detect_line_segments_octaves); octaves: (L,) int32 provenance from
        `return_octaves=True`; n_octaves: static pyramid depth.

    Returns (desc (L, 72), valid (L,)).
    """
    from cube_slam_wu_tpu.ops.detect import downsample2

    if n_octaves == 1:
        return lbd_descriptors(gray, lines, mask, max_len=max_len)
    desc = None
    img = gray
    for o in range(n_octaves):
        scale = float(2**o)
        # inverse of the detector's pixel-centre mapping
        # x_full = scale * x_o + (scale - 1) / 2
        lines_o = (lines - (scale - 1.0) / 2.0) / scale
        sel = octaves == o
        d_o, _ = lbd_descriptors(img, lines_o, mask & sel, max_len=max_len)
        desc = d_o if desc is None else jnp.where(sel[:, None], d_o, desc)
        if o + 1 < n_octaves:
            img = downsample2(img)
    return desc, mask


def binarize_lbd(desc: jnp.ndarray) -> jnp.ndarray:
    """72-float LBD -> 256-bit binary as (L, 8) uint32 words
    (binaryConversion semantics: bit j of pair p set iff
    band[p0*8+j] > band[p1*8+j])."""
    L = desc.shape[0]
    d = desc.reshape(L, NUM_BANDS, 8)
    a = jnp.asarray([c[0] for c in _COMBINATIONS])
    b = jnp.asarray([c[1] for c in _COMBINATIONS])
    bits = d[:, a, :] > d[:, b, :]  # (L, 32, 8) -> 256 bits
    bits = bits.reshape(L, 8, 32)  # 8 words of 32 bits
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(
        bits.astype(jnp.uint32) << shifts[None, None, :], axis=-1, dtype=jnp.uint32
    )
    return words


def pack_lbd_bytes(desc_bytes: jnp.ndarray) -> jnp.ndarray:
    """Convert reference-layout 32-byte binary descriptors (byte p = the 8
    comparison bits of band pair p, binaryConversion bit j = 1<<j,
    binary_descriptor.cpp:405-416/:769-773) into the (L, 8)-uint32 word
    layout `binarize_lbd` produces, so stored reference descriptors can be
    matched against ours directly."""
    b = jnp.asarray(desc_bytes, jnp.uint32)  # (L, 32)
    L = b.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint32)
    bits = (b[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)  # (L, 32p, 8j)
    bits = bits.reshape(L, 8, 32)  # same flatten order as binarize_lbd
    wshifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << wshifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _popcount32(x: jnp.ndarray) -> jnp.ndarray:
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


@jax.jit
def hamming_match(
    query_words: jnp.ndarray,
    train_words: jnp.ndarray,
    query_mask: jnp.ndarray,
    train_mask: jnp.ndarray,
    max_dist: int = 25,
):
    """Nearest-neighbour binary matching with the reference's dist<25 filter
    (match_line_descrip, line_lbd_allclass.cpp:352-369).

    Returns (match_idx (Lq,), match_dist (Lq,), matched (Lq,)).
    """
    xor = query_words[:, None, :] ^ train_words[None, :, :]
    dist = jnp.sum(_popcount32(xor), axis=-1).astype(jnp.int32)  # (Lq, Lt)
    big = jnp.iinfo(jnp.int32).max
    dist = jnp.where(train_mask[None, :], dist, big)
    idx = jnp.argmin(dist, axis=-1)
    best = jnp.take_along_axis(dist, idx[:, None], axis=-1)[:, 0]
    matched = query_mask & (best < max_dist)
    return idx, best, matched


@functools.partial(jax.jit, static_argnames=("k",))
def knn_match(
    query_words: jnp.ndarray,
    train_words: jnp.ndarray,
    query_mask: jnp.ndarray,
    train_mask: jnp.ndarray,
    k: int = 2,
):
    """k-nearest-neighbour binary matching
    (BinaryDescriptorMatcher::knnMatch, binary_descriptor_matcher.cpp:
    216-376 — the MIH hash-table k-NN replaced by one dense XOR+popcount
    matrix + top_k at padded set sizes).

    Returns (idx (Lq, k) train indices best-first, dist (Lq, k) int32,
    valid (Lq, k) — False where fewer than k masked train rows exist or
    the query is masked out).  k larger than the padded train capacity Lt
    is honoured by padding the trailing k - Lt rows with valid=False."""
    xor = query_words[:, None, :] ^ train_words[None, :, :]
    dist = jnp.sum(_popcount32(xor), axis=-1).astype(jnp.int32)  # (Lq, Lt)
    big = jnp.iinfo(jnp.int32).max
    dist = jnp.where(train_mask[None, :], dist, big)
    Lt = train_words.shape[0]
    k_eff = min(k, Lt)
    neg, idx = jax.lax.top_k(-dist, k_eff)
    d = -neg
    if k_eff < k:
        pad = ((0, 0), (0, k - k_eff))
        idx = jnp.pad(idx, pad)
        d = jnp.pad(d, pad, constant_values=big)
    valid = query_mask[:, None] & (d < big)
    return idx, d, valid


@jax.jit
def radius_match(
    query_words: jnp.ndarray,
    train_words: jnp.ndarray,
    query_mask: jnp.ndarray,
    train_mask: jnp.ndarray,
    max_dist: int = 25,
):
    """All train matches within a Hamming radius per query
    (BinaryDescriptorMatcher::radiusMatch, binary_descriptor_matcher.cpp:
    448-597).  Dense form: returns the full (Lq, Lt) int32 distance matrix
    and the boolean within-radius mask (padded rows/columns excluded) —
    callers slice out per-query match lists."""
    xor = query_words[:, None, :] ^ train_words[None, :, :]
    dist = jnp.sum(_popcount32(xor), axis=-1).astype(jnp.int32)
    within = (
        (dist <= max_dist) & query_mask[:, None] & train_mask[None, :]
    )
    return dist, within


@jax.jit
def match_lines_filtered(
    query_words: jnp.ndarray,
    train_words: jnp.ndarray,
    query_mask: jnp.ndarray,
    train_mask: jnp.ndarray,
    max_dist: int = 25,
):
    """Quality matching path: nearest neighbour + mutual-consistency check
    (the raw `hamming_match` mirrors the reference's NN-only behaviour; for
    frame-to-frame tracking the mutual check removes most false positives).

    Returns (match_idx, match_dist, matched)."""
    xor = query_words[:, None, :] ^ train_words[None, :, :]
    dist = jnp.sum(_popcount32(xor), axis=-1).astype(jnp.int32)
    big = jnp.iinfo(jnp.int32).max
    dist = jnp.where(train_mask[None, :] & query_mask[:, None], dist, big)
    fwd = jnp.argmin(dist, axis=-1)
    bwd = jnp.argmin(dist, axis=-2)
    best = jnp.take_along_axis(dist, fwd[:, None], axis=-1)[:, 0]
    mutual = bwd[fwd] == jnp.arange(dist.shape[0])
    matched = query_mask & (best < max_dist) & mutual
    return fwd, best, matched


@functools.partial(jax.jit, static_argnames=("mutual",))
def l2_match(
    query_desc: jnp.ndarray,
    train_desc: jnp.ndarray,
    query_mask: jnp.ndarray,
    train_mask: jnp.ndarray,
    max_dist: float = 0.6,
    query_lines: jnp.ndarray | None = None,
    train_lines: jnp.ndarray | None = None,
    max_midpoint_dist: float | None = None,
    mutual: bool = True,
):
    """Float-descriptor matching on L2 distance over the unit-norm LBD
    vectors, before binarization.

    The reference matches the 32-byte binarized descriptors
    (BinaryDescriptorMatcher, line_lbd_allclass.cpp:352-369); keeping the
    float vectors roughly quadruples the number of frame-to-frame matches at
    equal geometric consistency on the bundled sequence, at the cost of an
    L2 instead of XOR+popcount — the (Lq, Lt, D) distance is a single fused
    matmul-shaped op, so the float path is the recommended tracking
    matcher.

    Optional guided matching for video: with `query_lines`/`train_lines`
    ((L, 4) endpoints) and `max_midpoint_dist`, candidates farther than the
    given midpoint motion are excluded before the NN step (standard
    small-baseline gating; beyond the reference).

    Returns (match_idx (Lq,), match_dist (Lq,), matched (Lq,)).
    """
    # ||a-b||^2 = 2 - 2 a.b for unit-norm descriptors, but compute directly
    # for robustness to zero rows
    d2 = jnp.sum(
        (query_desc[:, None, :] - train_desc[None, :, :]) ** 2, axis=-1
    )
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    big = jnp.asarray(1e9, dist.dtype)
    valid = train_mask[None, :] & query_mask[:, None]
    if max_midpoint_dist is not None:
        if query_lines is None or train_lines is None:
            raise ValueError("max_midpoint_dist requires query_lines and train_lines")
        mq = (query_lines[:, :2] + query_lines[:, 2:]) * 0.5
        mt = (train_lines[:, :2] + train_lines[:, 2:]) * 0.5
        move = jnp.linalg.norm(mq[:, None, :] - mt[None, :, :], axis=-1)
        valid = valid & (move <= max_midpoint_dist)
    dist = jnp.where(valid, dist, big)
    fwd = jnp.argmin(dist, axis=-1)
    best = jnp.take_along_axis(dist, fwd[:, None], axis=-1)[:, 0]
    matched = query_mask & (best < max_dist)
    if mutual:
        bwd = jnp.argmin(dist, axis=-2)
        matched = matched & (bwd[fwd] == jnp.arange(dist.shape[0]))
    return fwd, best, matched
