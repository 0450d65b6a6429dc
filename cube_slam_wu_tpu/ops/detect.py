"""Batched, fixed-shape line-segment detection.

Replaces the reference's sequential detectors — EDLine's anchor/edge-chaining
(line_lbd/libs/binary_descriptor.cpp:1583-2875) and von-Gioi LSD's region
growing (line_lbd/libs/lsd.cpp) — with a fully-batched orientation-aware
Hough formulation with no data-dependent control flow:

  1. Gaussian blur in fixed point + Sobel gradients (the reference pyramid
     base, binary_descriptor.cpp:352-374, which blurs the 8-bit image),
  2. non-maximum-suppressed edge mask with a gradient threshold,
  3. gradient-weighted votes into a (normal-angle, offset) Hough accumulator —
     each pixel votes only near its own gradient orientation, which is what
     makes the transform segment-friendly (one scatter-add),
  4. 3x3 peak NMS + top-P peak extraction,
  5. per-peak inlier binning along the line direction and gap-tolerant run
     extraction (batched 1D scans over a (P, n_bins) occupancy raster) —
     the parallel analogue of LSD's region growing / EDLine's chain walking,
  6. duplicate removal + collinear merging (ops.lines.merge_break_lines).

Correctness target is behavioural parity with the reference detectors on
their own fixtures (SURVEY.md section 7.1): recall of long segments,
validated in tests/test_detect.py.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.precision import einsum, tensordot
from cube_slam_wu_tpu.ops import image as image_ops
from cube_slam_wu_tpu.ops import lines as line_ops


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    n_theta: int = 180  # normal-angle bins over [0, pi)
    rho_bin: float = 1.5  # px per offset bin
    t_bin: float = 2.0  # px per along-line bin
    grad_threshold: float = 30.0  # on |gx|+|gy| of the blurred image
    n_peaks: int = 384  # Hough peaks examined
    runs_per_peak: int = 6  # segments extracted per peak
    max_runs: int = 32  # run-id capacity per peak
    # px half-width of the perpendicular inlier window.  Round-4 negative
    # result: 1.0 (3 taps/bin) measures BETTER single-image fixture recall
    # (0.952/0.649 vs 0.935/0.631 at >40/>15 px) and cuts the detector's
    # dominant cost — the (P, NB, S) support gather — by 40%, but COSTS
    # sequence accuracy
    # on the 58-frame TUM online run (ATE 0.1789 -> 0.2007 default mode,
    # 0.2353 -> 0.2723 reference-parity mode): frame-to-frame line-set
    # stability matters more to the proposal scores than per-frame recall.
    # The default stays 2.0 (quality-pinned); 1.0 is the documented
    # latency knob when ATE is not the objective.
    inlier_rho_tol: float = 2.0
    inlier_angle_tol_deg: float = 11.0
    min_inliers: float = 7.0  # occupied bins per run (~14 px)
    gap_bins: int = 2  # tolerated empty bins inside a run
    merge_dist: float = 8.0
    merge_angle_deg: float = 5.0
    min_length: float = 15.0  # line_lbd_detect.line_length_thres analogue
    max_merge_iters: int = 400
    max_edge_pixels: int = 32768  # compaction cap for the Hough vote scatter
    max_output: int = 384  # final segment capacity (top-K by length)
    # Helmholtz NFA validation (optional): keep a run only if its aligned
    # support is statistically significant against the image's own occupancy
    # rate — the a-contrario principle of LSD's rect NFA (lsd.cpp:873) and
    # EDLine's LineValidation_ (binary_descriptor.cpp:2793-2875).  Off by
    # default: min_inliers already gates weak runs, and the fixture-fitted
    # defaults are what the online-ATE numbers are pinned to.
    nfa_validation: bool = False
    nfa_log10_eps: float = 0.0  # keep if log10(NFA) < this (eps = 1)
    # Additive short-segment recovery (round-5 verdict item 6): after the
    # main pass, zero the edge pixels its accepted segments claim and run a
    # second extraction with a lower run gate on the residual — short
    # structures whose Hough peaks lost to long segments in pass 1 can now
    # win.  Pass-2 segments never perturb the pass-1 set: they only fill
    # EMPTY output slots after a dominance dedupe against pass 1
    # (detect_line_segments_recover).  Off by default; ~2x detector cost.
    short_recovery: bool = False
    short_min_inliers: float = 4.0  # pass-2 run gate (~8 px)
    short_n_peaks: int = 512
    short_extra_capacity: int = 384  # extra output slots for recovered segs
    # claim tightness: greedier claiming (3 px / 14 deg) eats the evidence
    # of short segments ADJACENT to accepted long ones and caps the 15-40 px
    # union recall at ~0.69; the tight setting measures 0.75 (fixture sweep)
    claim_rho_px: float = 1.5  # pixel-to-segment claim distance
    claim_angle_deg: float = 8.0


def gaussian_blur5(gray: jnp.ndarray, sigma: float = 1.0) -> jnp.ndarray:
    """5x5 Gaussian blur, replicate border (cv::GaussianBlur(Size(5,5),1))."""
    xs = jnp.arange(-2, 3, dtype=gray.dtype)
    k = jnp.exp(-(xs**2) / (2.0 * sigma**2))
    k = k / jnp.sum(k)

    def conv1(a, axis):
        idx = jnp.clip(
            jnp.arange(a.shape[axis])[:, None] + jnp.arange(-2, 3)[None, :],
            0,
            a.shape[axis] - 1,
        )
        g = jnp.take(a, idx, axis=axis)
        return tensordot(g, k, axes=[[axis + 1], [0]])

    return conv1(conv1(gray, 0), 1)


# gaussian_blur5's taps (sigma 1) in 11-bit fixed point, summing to 2^11
_BLUR_TAPS = (112, 500, 824, 500, 112)
_BLUR_BITS = 11


def gaussian_blur5_fixed(gray: jnp.ndarray) -> jnp.ndarray:
    """gaussian_blur5 of an 8-bit image in integer arithmetic.

    The input is rounded and clipped to [0, 255]; both passes are exact
    int32 sums (at most 255 * 2^22), so the result does not depend on the
    order in which a backend sums.  Float sums differ in their last bits
    between backends (XLA on an H100 and on the CPU disagree on about 80%
    of a 640x480 frame's pixels), and those bits decide the detector's NMS
    ties and Hough bins."""
    dtype = gray.dtype
    a = jnp.clip(jnp.round(gray), 0, 255).astype(jnp.int32)

    def conv1(a, axis):
        n = a.shape[axis]
        out = 0
        for off, k in zip(range(-2, 3), _BLUR_TAPS):
            idx = jnp.clip(jnp.arange(n) + off, 0, n - 1)
            out = out + k * jnp.take(a, idx, axis=axis)
        return out

    b = conv1(conv1(a, 0), 1)
    return b.astype(dtype) * (1.0 / (1 << 2 * _BLUR_BITS))


def _angle_dist_pi(a, b):
    d = jnp.abs(a - b)
    d = jnp.mod(d, math.pi)
    return jnp.minimum(d, math.pi - d)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_line_segments(
    gray: jnp.ndarray,
    cfg: DetectConfig = DetectConfig(),
    suppress: jnp.ndarray | None = None,
):
    """Detect line segments.

    Returns (lines (K, 4) [x1 y1 x2 y2] left-to-right, mask (K,)) with
    K = min(max_output, n_peaks * runs_per_peak) (top-K by length).

    `suppress` (optional (H, W) bool) removes edge pixels from every stage
    (votes AND support sampling) — the recovery pass's claimed-pixel mask.
    """
    dtype = gray.dtype
    H, W = gray.shape
    g = gaussian_blur5_fixed(gray)
    gx, gy = image_ops.sobel3(g)
    mag = jnp.abs(gx) + jnp.abs(gy)
    keep = image_ops._nms(mag, gx, gy) & (mag > cfg.grad_threshold)
    if suppress is not None:
        keep = keep & ~suppress

    # normal (gradient) angle folded to [0, pi)
    psi = jnp.mod(jnp.arctan2(gy, gx), math.pi)

    # ---- compact to the strongest edge pixels ------------------------------
    # (typically ~10% of the image passes NMS; all per-peak work below is
    # O(edge pixels), which matters because scatters are expensive)
    NE = min(cfg.max_edge_pixels, H * W)
    score_flat = jnp.where(keep, mag, 0.0).reshape(-1)
    # approx_max_k: exactness buys nothing here — which of the weakest
    # near-threshold pixels make the NE cut is arbitrary, and at VGA the
    # NMS'd edge count is usually below NE anyway.  On the GPU it is exact;
    # its cost against top_k there is not measured yet.
    top_w, top_pix = jax.lax.approx_max_k(score_flat, NE)
    flat_w = top_w
    flat_y = (top_pix // W).astype(dtype)
    flat_x = (top_pix % W).astype(dtype)
    flat_psi = psi.reshape(-1)[top_pix]
    edge_valid = flat_w > 0

    # ---- Hough accumulation (votes at own angle bin +-1) -------------------
    NT = cfg.n_theta
    diag = math.hypot(H, W)
    NR = int(2 * diag / cfg.rho_bin) + 2
    rho_off = diag  # shift so rho >= 0

    tbin0 = jnp.floor(flat_psi / (math.pi / NT)).astype(jnp.int32) % NT

    acc = jnp.zeros((NT, NR), dtype)
    for dt in (-1, 0, 1):
        tb = (tbin0 + dt) % NT
        theta = (tb.astype(dtype) + 0.5) * (math.pi / NT)
        rho = flat_x * jnp.cos(theta) + flat_y * jnp.sin(theta)
        rb = jnp.clip(((rho + rho_off) / cfg.rho_bin).astype(jnp.int32), 0, NR - 1)
        acc = acc.at[tb, rb].add(flat_w)

    # ---- peak extraction: 3x3 NMS then top-P -------------------------------
    def max3(a, axis, wrap):
        lo = jnp.roll(a, 1, axis)
        hi = jnp.roll(a, -1, axis)
        if not wrap:
            # non-wrapping axis: neighbours beyond the edge do not exist
            idx = [slice(None)] * a.ndim
            idx[axis] = slice(0, 1)
            lo = lo.at[tuple(idx)].set(0.0)
            idx[axis] = slice(-1, None)
            hi = hi.at[tuple(idx)].set(0.0)
        return jnp.maximum(a, jnp.maximum(lo, hi))

    neigh = max3(max3(acc, 0, wrap=True), 1, wrap=False)
    is_peak = (acc >= neigh) & (acc > 0)
    peak_score = jnp.where(is_peak, acc, 0.0)
    P = cfg.n_peaks
    top_vals, top_idx = jax.lax.top_k(peak_score.reshape(-1), P)
    pk_t = top_idx // NR
    pk_r = top_idx % NR
    pk_valid = top_vals > 0
    theta_p = (pk_t.astype(dtype) + 0.5) * (math.pi / NT)  # (P,)
    rho_p = (pk_r.astype(dtype) + 0.5) * cfg.rho_bin - rho_off

    # ---- per-peak inlier raster along the line ----------------------------
    # GATHER formulation: instead of scattering every edge pixel into
    # per-peak bins (scatters were the detector's round-1 bottleneck),
    # walk each peak line through a dense packed field and read the support.
    # Pack NMS'd gradient magnitude and the quantised normal angle into ONE
    # f32 per pixel (mag*256 + psi_bin; mag <= 2040 so the product stays
    # well inside the 24-bit f32 mantissa) so each sample costs one gather.
    cos_p, sin_p = jnp.cos(theta_p), jnp.sin(theta_p)
    PSI_Q = 256
    psi_bin_img = jnp.floor(psi / math.pi * PSI_Q).astype(dtype)
    packed = jnp.where(keep & (mag > cfg.grad_threshold), jnp.floor(mag), 0.0) * (
        PSI_Q * 1.0
    ) + psi_bin_img

    # bins are centred on the projection of the image centre onto the line,
    # so |t_rel| <= diag/2 always covers the visible extent
    NB = int(diag / cfg.t_bin) + 2
    ex_p, ey_p = -sin_p, cos_p  # along-line direction
    t_c = 0.5 * W * ex_p + 0.5 * H * ey_p  # centre projection
    ax_p = rho_p * cos_p + t_c * ex_p  # anchor point on the line
    ay_p = rho_p * sin_p + t_c * ey_p

    t_rel = (jnp.arange(NB, dtype=dtype) - 0.5 * NB + 0.5) * cfg.t_bin  # (NB,)
    n_perp = int(math.ceil(cfg.inlier_rho_tol)) * 2 + 1
    offs = jnp.arange(n_perp, dtype=dtype) - (n_perp - 1) / 2.0  # (S,)

    # sample positions: anchor + t*dir + o*normal  ->  (P, NB, S)
    sx = (
        ax_p[:, None, None]
        + t_rel[None, :, None] * ex_p[:, None, None]
        + offs[None, None, :] * cos_p[:, None, None]
    )
    sy = (
        ay_p[:, None, None]
        + t_rel[None, :, None] * ey_p[:, None, None]
        + offs[None, None, :] * sin_p[:, None, None]
    )
    xi = jnp.round(sx).astype(jnp.int32)
    yi = jnp.round(sy).astype(jnp.int32)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    # flat 1D take (against the 2D gather form: not measured on the GPU)
    v = jnp.take(
        packed.reshape(-1),
        jnp.clip(yi, 0, H - 1) * W + jnp.clip(xi, 0, W - 1),
    )
    s_mag = jnp.floor(v / PSI_Q)
    s_psi = (v - s_mag * PSI_Q) * (math.pi / PSI_Q)
    ang_ok = _angle_dist_pi(s_psi, theta_p[:, None, None]) < math.radians(
        cfg.inlier_angle_tol_deg
    )
    w_smp = jnp.where(inb & ang_ok & (s_mag > 0), s_mag, 0.0)
    occ = jnp.sum(w_smp, axis=-1)  # (P, NB) weighted support per bin
    # perpendicular first moment per bin: lets each run re-fit a local
    # offset+tilt, fixing the ~half-window bias a global Hough line has on
    # slightly-bent structures (LSD fits each region locally; this is the
    # batched analogue)
    occ_o = jnp.sum(w_smp * offs[None, None, :], axis=-1)  # (P, NB)

    # ---- gap-tolerant run extraction on the (P, NB) raster ----------------
    occb = occ > 0
    # close gaps of up to gap_bins via 1D dilation then logical AND trimming
    closed = occb
    for _ in range(cfg.gap_bins):
        closed = closed | jnp.roll(closed, 1, -1) | jnp.roll(closed, -1, -1)
    # runs of `closed`; trim later using occb
    prev = jnp.concatenate([jnp.zeros_like(closed[:, :1]), closed[:, :-1]], axis=1)
    run_start = closed & ~prev
    run_id = jnp.cumsum(run_start, axis=1) * closed  # 1-based ids, 0 = background
    run_id = jnp.minimum(run_id, cfg.max_runs)

    bin_t = t_rel  # per-bin along-line offset relative to the anchor

    def per_peak(run_id_p, occb_p, occ_p, occo_p):
        ids = run_id_p  # (NB,)
        seg_ids = jnp.arange(1, cfg.max_runs + 1)
        member = (ids[None, :] == seg_ids[:, None]) & occb_p[None, :]  # (R, NB)
        counts = jnp.sum(member, axis=1)
        w_bin = jnp.where(member, occ_p[None, :], 0.0)
        o_bin = jnp.where(member, occo_p[None, :], 0.0)
        weights = jnp.sum(w_bin, axis=1)
        tmin = jnp.min(jnp.where(member, bin_t[None, :], jnp.inf), axis=1)
        tmax = jnp.max(jnp.where(member, bin_t[None, :], -jnp.inf), axis=1)
        # weighted linear re-fit of the perpendicular offset o(t) = c0 + c1*t
        # over the run's bins (normal equations of the 2-param LS problem)
        St = jnp.sum(w_bin * bin_t[None, :], axis=1)
        Stt = jnp.sum(w_bin * bin_t[None, :] ** 2, axis=1)
        So = jnp.sum(o_bin, axis=1)
        Sto = jnp.sum(o_bin * bin_t[None, :], axis=1)
        det = weights * Stt - St * St
        safe = det > 1e-6
        c1 = jnp.where(safe, (weights * Sto - St * So) / jnp.where(safe, det, 1.0), 0.0)
        c0 = jnp.where(weights > 0, (So - c1 * St) / jnp.maximum(weights, 1e-9), 0.0)
        c0 = jnp.clip(c0, -cfg.inlier_rho_tol, cfg.inlier_rho_tol)
        c1 = jnp.clip(c1, -0.2, 0.2)
        # pick the longest runs
        S = cfg.runs_per_peak
        sel = jax.lax.top_k(counts.astype(dtype), S)[1]
        return counts[sel], weights[sel], tmin[sel], tmax[sel], c0[sel], c1[sel]

    counts, weights, tmin, tmax, c0, c1 = jax.vmap(per_peak)(
        run_id, occb, occ, occ_o
    )

    ok = (counts >= cfg.min_inliers) & pk_valid[:, None] & jnp.isfinite(tmin) & jnp.isfinite(tmax)

    if cfg.nfa_validation:
        # a-contrario gate (LSD lsd.cpp:873 / EDLine LineValidation_
        # semantics, re-stated on the run raster): under the null hypothesis
        # every bin is occupied independently with the image's own global
        # occupancy rate p0; a run spanning n bins with k occupied is kept
        # only if  NFA = N_tests * P[B(n, p0) >= k]  is below eps.  The
        # binomial tail is an exact masked sum over the (small) bin axis —
        # no early-exit recursion like the reference, just one lgamma batch.
        from jax.scipy.special import gammaln

        inb_bin = jnp.any(inb, axis=-1)  # (P, NB) bins with any valid sample
        p0 = jnp.sum(jnp.where(inb_bin, occb, False)) / jnp.maximum(
            jnp.sum(inb_bin), 1
        )
        p0 = jnp.clip(p0.astype(dtype), 1e-6, 1.0 - 1e-6)
        n_run = jnp.clip(
            jnp.round((tmax - tmin) / cfg.t_bin).astype(jnp.int32) + 1, 1, NB
        )  # (P, S) span in bins
        k_run = jnp.minimum(counts, n_run)
        js = jnp.arange(NB + 1, dtype=dtype)  # term index
        nf = n_run.astype(dtype)[..., None]
        kf = k_run.astype(dtype)[..., None]
        logterm = (
            gammaln(nf + 1.0)
            - gammaln(js + 1.0)
            - gammaln(nf - js + 1.0)
            + js * jnp.log(p0)
            + (nf - js) * jnp.log1p(-p0)
        )
        term_ok = (js >= kf) & (js <= nf)
        tail = jnp.sum(jnp.where(term_ok, jnp.exp(logterm), 0.0), axis=-1)
        # number of tests: every (start, end) bin pair on every peak line
        log10_nfa = math.log10(P * NB * NB / 2.0) + jnp.log10(
            jnp.maximum(tail, 1e-300)
        )
        ok = ok & (log10_nfa < cfg.nfa_log10_eps)
    # endpoints: p = anchor + t*(-sin,cos); extend to bin edges
    ex = ex_p[:, None]
    ey = ey_p[:, None]
    bx = ax_p[:, None]
    by = ay_p[:, None]
    t0 = tmin - 0.5 * cfg.t_bin
    t1 = tmax + 0.5 * cfg.t_bin
    # apply the per-run local re-fit: p(t) = anchor + t*dir + (c0+c1*t)*normal
    o0 = c0 + c1 * t0
    o1 = c0 + c1 * t1
    x1 = bx + t0 * ex + o0 * cos_p[:, None]
    y1 = by + t0 * ey + o0 * sin_p[:, None]
    x2 = bx + t1 * ex + o1 * cos_p[:, None]
    y2 = by + t1 * ey + o1 * sin_p[:, None]
    segs = jnp.stack([x1, y1, x2, y2], axis=-1).reshape(-1, 4)
    seg_mask = ok.reshape(-1)
    seg_weight = jnp.where(seg_mask, weights.reshape(-1), 0.0)
    segs = jnp.where(seg_mask[:, None], segs, 0.0)

    # compact to the strongest candidates before the O(K^2) dedupe/merge
    # (most of the n_peaks*runs_per_peak slots fail the min_inliers gate)
    M = min(2 * cfg.max_output + cfg.max_output // 2, segs.shape[0])
    _, sel_idx = jax.lax.top_k(seg_weight, M)
    segs = segs[sel_idx]
    seg_mask = seg_mask[sel_idx]
    seg_weight = seg_weight[sel_idx]

    # one-shot dedupe: drop a segment if a strictly stronger, nearly-parallel
    # segment overlaps it (adjacent Hough peaks produce near-duplicates)
    ang = jnp.arctan2(segs[:, 3] - segs[:, 1], segs[:, 2] - segs[:, 0])
    dvec = segs[:, 2:4] - segs[:, 0:2]
    dlen = jnp.linalg.norm(dvec, axis=-1) + 1e-9
    dunit = dvec / dlen[:, None]
    nunit = jnp.stack([-dunit[:, 1], dunit[:, 0]], axis=-1)

    rel_a = segs[None, :, 0:2] - segs[:, None, 0:2]  # head_j - head_i
    rel_b = segs[None, :, 2:4] - segs[:, None, 0:2]
    perp = jnp.maximum(
        jnp.abs(einsum("ijk,ik->ij", rel_a, nunit)),
        jnp.abs(einsum("ijk,ik->ij", rel_b, nunit)),
    )
    ta = einsum("ijk,ik->ij", rel_a, dunit) / dlen[:, None]
    tb = einsum("ijk,ik->ij", rel_b, dunit) / dlen[:, None]
    ov = jnp.minimum(jnp.maximum(ta, tb), 1.0) - jnp.maximum(jnp.minimum(ta, tb), 0.0)
    d_ang = jnp.abs(ang[:, None] - ang[None, :])
    d_ang = jnp.minimum(jnp.mod(d_ang, math.pi), math.pi - jnp.mod(d_ang, math.pi))
    dominated_by = (
        (perp < 2.0)
        & (ov > 0.6)
        & (d_ang < math.radians(3.0))
        & (
            (seg_weight[None, :] > seg_weight[:, None])
            | (
                (seg_weight[None, :] == seg_weight[:, None])
                & (jnp.arange(segs.shape[0])[None, :] < jnp.arange(segs.shape[0])[:, None])
            )
        )
        & seg_mask[None, :]
    )
    seg_mask = seg_mask & ~jnp.any(dominated_by, axis=1)

    # compact dedupe survivors to 1.5x the output capacity before the
    # O(K^2)-per-round merge (stable order preserved; the merge cost grows
    # with the square of the slot count).
    # Beyond-capacity survivors are the weakest by support weight, the same
    # candidates the final top-`max_output` cut would shed anyway.
    Mc = min(cfg.max_output + cfg.max_output // 2, segs.shape[0])
    if Mc < segs.shape[0]:
        keep_idx = jax.lax.top_k(
            jnp.where(seg_mask, seg_weight, -1.0), Mc
        )[1]
        keep_idx = jnp.sort(keep_idx)  # stable relative order for the merge
        segs = segs[keep_idx]
        seg_mask = seg_mask[keep_idx]

    segs = line_ops.align_left_right(segs)
    merged, merged_mask = line_ops.merge_break_lines(
        segs,
        seg_mask,
        cfg.merge_dist,
        cfg.merge_angle_deg,
        cfg.min_length,
        max_iters=cfg.max_merge_iters,
    )

    # final fixed-capacity output: keep the longest max_output segments.
    # This bounds every downstream consumer's line axis (the proposal
    # engine's per-ROI merge is O(L^2) in this capacity).
    K = min(cfg.max_output, merged.shape[0])
    lens = jnp.where(merged_mask, line_ops.line_lengths(merged), 0.0)
    _, out_idx = jax.lax.top_k(lens, K)
    return merged[out_idx], merged_mask[out_idx] & (lens[out_idx] > 0)


@functools.partial(jax.jit, static_argnames=("shape", "rho_tol", "ang_tol_deg"))
def _claimed_mask(shape, psi, lines, mask, rho_tol: float, ang_tol_deg: float):
    """(H, W) bool: pixels geometrically claimed by the accepted segments
    (within `rho_tol` of the segment, inside its span +-2 px, gradient
    normal within `ang_tol_deg` of the segment normal).  lax.fori over
    segments with an (H, W) carry — O(K * H * W) flops, O(H * W) memory."""
    H, W = shape
    dtype = lines.dtype
    ys = jnp.arange(H, dtype=dtype)[:, None]
    xs = jnp.arange(W, dtype=dtype)[None, :]
    ang_tol = math.radians(ang_tol_deg)

    def body(i, claimed):
        x1, y1, x2, y2 = lines[i]
        dx, dy = x2 - x1, y2 - y1
        L = jnp.sqrt(dx * dx + dy * dy) + 1e-9
        ux, uy = dx / L, dy / L
        rx = xs - x1
        ry = ys - y1
        perp = jnp.abs(rx * (-uy) + ry * ux)
        t = rx * ux + ry * uy
        normal_ang = jnp.mod(jnp.arctan2(dy, dx) + math.pi / 2, math.pi)
        ang_ok = _angle_dist_pi(psi, normal_ang) < ang_tol
        hit = (
            mask[i]
            & (perp <= rho_tol)
            & (t >= -2.0)
            & (t <= L + 2.0)
            & ang_ok
        )
        return claimed | hit

    init = jnp.zeros((H, W), bool)
    return jax.lax.fori_loop(0, lines.shape[0], body, init)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_line_segments_recover(
    gray: jnp.ndarray, cfg: DetectConfig = DetectConfig()
):
    """Two-pass detection with ADDITIVE short-segment recovery.

    Pass 1 is exactly `detect_line_segments(gray, cfg)` — its output slots
    are preserved verbatim (same segments, same length-descending order).
    Pass 2 reruns the extraction on the residual edge field (pass-1 claimed
    pixels suppressed) with a lower run gate (`short_min_inliers`) and its
    own peak budget, recovering short structures whose Hough evidence lost
    to long segments (the reference's region growers find these locally,
    lsd.cpp:637; a global accumulator needs the second look).  Pass-2
    segments dominated by a pass-1 segment are dropped; survivors fill the
    EMPTY output slots only.

    Returns (lines (K, 4), mask (K,)) like detect_line_segments.
    """
    l1, m1 = detect_line_segments(gray, cfg)
    H, W = gray.shape
    g = gaussian_blur5_fixed(gray)
    gx, gy = image_ops.sobel3(g)
    psi = jnp.mod(jnp.arctan2(gy, gx), math.pi)
    claimed = _claimed_mask(
        (H, W), psi, l1, m1, cfg.claim_rho_px, cfg.claim_angle_deg
    )
    cfg2 = dataclasses.replace(
        cfg,
        min_inliers=cfg.short_min_inliers,
        n_peaks=cfg.short_n_peaks,
    )
    l2, m2 = detect_line_segments(gray, cfg2, suppress=claimed)

    # dominance dedupe: drop pass-2 segments a pass-1 segment already covers
    d1 = l1[:, 2:4] - l1[:, 0:2]
    len1 = jnp.linalg.norm(d1, axis=-1) + 1e-9
    u1 = d1 / len1[:, None]
    n1 = jnp.stack([-u1[:, 1], u1[:, 0]], axis=-1)
    rel_a = l2[None, :, 0:2] - l1[:, None, 0:2]  # (K1, K2, 2)
    rel_b = l2[None, :, 2:4] - l1[:, None, 0:2]
    perp = jnp.maximum(
        jnp.abs(einsum("ijk,ik->ij", rel_a, n1)),
        jnp.abs(einsum("ijk,ik->ij", rel_b, n1)),
    )
    ta = einsum("ijk,ik->ij", rel_a, u1) / len1[:, None]
    tb = einsum("ijk,ik->ij", rel_b, u1) / len1[:, None]
    ov = jnp.minimum(jnp.maximum(ta, tb), 1.0) - jnp.maximum(
        jnp.minimum(ta, tb), 0.0
    )
    a1 = jnp.arctan2(d1[:, 1], d1[:, 0])
    a2 = jnp.arctan2(l2[:, 3] - l2[:, 1], l2[:, 2] - l2[:, 0])
    d_ang = _angle_dist_pi(a1[:, None], a2[None, :])
    dominated = jnp.any(
        m1[:, None]
        & (perp < 3.0)
        & (ov > 0.5)
        & (d_ang < math.radians(5.0)),
        axis=0,
    )
    m2 = m2 & ~dominated

    # pass-1 keeps its slots verbatim (priority offset); pass-2 survivors
    # follow by length in the extra output capacity, so downstream consumers
    # of the plain detector see an unchanged prefix
    K = l1.shape[0]
    K_out = K + cfg.short_extra_capacity
    all_lines = jnp.concatenate([l1, l2], axis=0)
    all_mask = jnp.concatenate([m1, m2], axis=0)
    lens = jnp.where(
        all_mask, jnp.linalg.norm(all_lines[:, 2:4] - all_lines[:, 0:2], axis=-1), 0.0
    )
    prio = lens + jnp.where(
        jnp.arange(all_lines.shape[0]) < K, jnp.asarray(1e6, lens.dtype), 0.0
    )
    prio = jnp.where(all_mask, prio, 0.0)
    _, sel = jax.lax.top_k(prio, min(K_out, all_lines.shape[0]))
    return all_lines[sel], all_mask[sel] & (prio[sel] > 0)


def downsample2(gray: jnp.ndarray) -> jnp.ndarray:
    """One pyramid level: Gaussian blur then 2x decimation (the reference's
    per-octave pyramid step, binary_descriptor.cpp:352-372 /
    LSDDetector.cpp:55-102 with reductionRatio = 2)."""
    g = gaussian_blur5(gray)
    return g[::2, ::2]


def _clip_segments_to_image(lines: jnp.ndarray, W: int, H: int):
    """Clip segments to the image rectangle along their own direction (slab
    intersection); returns (clipped lines, still-nonempty mask)."""
    a = lines[:, 0:2]
    d = lines[:, 2:4] - a
    lo = jnp.asarray([0.0, 0.0], lines.dtype)
    hi = jnp.asarray([W - 1.0, H - 1.0], lines.dtype)
    safe_d = jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
    t0 = (lo - a) / safe_d
    t1 = (hi - a) / safe_d
    tmin = jnp.max(jnp.minimum(t0, t1), axis=1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=1)
    tmin_c = jnp.clip(tmin, 0.0, 1.0)
    tmax_c = jnp.clip(tmax, 0.0, 1.0)
    p1 = a + tmin_c[:, None] * d
    p2 = a + tmax_c[:, None] * d
    ok = tmax_c > tmin_c
    return jnp.concatenate([p1, p2], axis=1), ok


def detect_line_segments_octaves(
    gray: jnp.ndarray,
    cfg: DetectConfig = DetectConfig(),
    n_octaves: int = 1,
    return_octaves: bool = False,
):
    """Multi-octave detection (numOfOctave_ / Octave_ratio = 2 semantics of
    the reference wrapper, line_lbd_allclass.cpp:114-127): detect on each
    pyramid level, scale endpoints back to octave-0 pixels (the wrapper's
    mat_to_keylines octave scaling, line_lbd_allclass.cpp:70-111), then
    cross-octave dedupe + merge (OctaveKeyLines analogue,
    binary_descriptor.cpp:796-1150).

    Both reference drivers run numOfOctave_ = 1 (detect_lines.cpp:59,
    main_obj.cpp defaults), so this is library-capability parity; coarser
    octaves add long low-frequency structures the full-res pass fragments.

    Returns (lines (n_octaves * K, 4), mask) in octave-0 coordinates;
    with `return_octaves`, also the (K,) int32 octave index each segment
    was detected in (the provenance `lbd_descriptors_octaves` needs to
    compute descriptors on the originating octave image, matching
    detect_descrip_lines_octaves, line_lbd_allclass.cpp:296-349).
    """
    per_octave = []
    img = gray
    for o in range(n_octaves):
        lines_o, mask_o = detect_line_segments(img, cfg)
        scale = float(2**o)
        # pixel-centre mapping: x_full = scale * x + (scale - 1) / 2
        lines_o = lines_o * scale + (scale - 1.0) / 2.0
        if o > 0:
            # coarse-octave bin-edge extension overshoots by up to
            # 2^o * t_bin px once scaled back — clip to the image rectangle
            lines_o, in_img = _clip_segments_to_image(
                lines_o, gray.shape[1], gray.shape[0]
            )
            mask_o = mask_o & in_img
        per_octave.append((lines_o, mask_o))
        if o + 1 < n_octaves:
            img = downsample2(img)
    if n_octaves == 1:
        if return_octaves:
            lines0, mask0 = per_octave[0]
            return lines0, mask0, jnp.zeros((lines0.shape[0],), jnp.int32)
        return per_octave[0]
    # cross-octave dedupe with FINE priority (OctaveKeyLines keeps the
    # higher-resolution observation of a structure): fine-octave lines pass
    # through untouched; a coarser line survives only if no finer line is
    # near-collinear with it and covers most of its extent.  (A full
    # merge_break_lines across octaves measurably drags fine endpoints
    # toward the 2^o-quantised coarse ones — recall 0.94 -> 0.86.)
    lines = jnp.concatenate([l for l, _ in per_octave], axis=0)
    mask = jnp.concatenate([m for _, m in per_octave], axis=0)
    K1 = per_octave[0][0].shape[0]
    oct_id = jnp.concatenate(
        [jnp.full((l.shape[0],), o) for o, (l, _) in enumerate(per_octave)]
    )
    a = lines[:, 0:2]
    dvec = lines[:, 2:4] - a
    dlen = jnp.linalg.norm(dvec, axis=-1) + 1e-9
    dunit = dvec / dlen[:, None]
    nunit = jnp.stack([-dunit[:, 1], dunit[:, 0]], axis=-1)
    rel_a = lines[None, :, 0:2] - a[:, None, :]
    rel_b = lines[None, :, 2:4] - a[:, None, :]
    perp = jnp.maximum(
        jnp.abs(einsum("ijk,ik->ij", rel_a, nunit)),
        jnp.abs(einsum("ijk,ik->ij", rel_b, nunit)),
    )
    ta = einsum("ijk,ik->ij", rel_a, dunit) / dlen[:, None]
    tb = einsum("ijk,ik->ij", rel_b, dunit) / dlen[:, None]
    ov = jnp.minimum(jnp.maximum(ta, tb), 1.0) - jnp.maximum(
        jnp.minimum(ta, tb), 0.0
    )
    ang = jnp.arctan2(dvec[:, 1], dvec[:, 0])
    d_ang = _angle_dist_pi(ang[:, None], ang[None, :])
    covered_by_finer = (
        (perp < cfg.merge_dist)
        & (ov > 0.5)
        & (d_ang < math.radians(cfg.merge_angle_deg))
        & (oct_id[None, :] < oct_id[:, None])
        & mask[None, :]
    )
    mask = mask & ~jnp.any(covered_by_finer, axis=1)
    K = min(cfg.max_output, lines.shape[0])
    lens = jnp.where(mask, line_ops.line_lengths(lines), 0.0)
    # octave-0 lines always make the cut (they can never be displaced by a
    # coarse addition); coarser octaves fill the remaining slots by length
    BIG = 4.0 * math.hypot(*gray.shape)
    _, out_idx = jax.lax.top_k(
        jnp.where(lens > 0, lens + BIG * (oct_id == 0), 0.0), K
    )
    out_mask = mask[out_idx] & (lens[out_idx] > 0)
    if return_octaves:
        return lines[out_idx], out_mask, oct_id[out_idx].astype(jnp.int32)
    return lines[out_idx], out_mask
