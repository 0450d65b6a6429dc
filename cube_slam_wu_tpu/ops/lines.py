"""Line-segment tensor utilities: padded sets + masks, merge, filtering.

Fixed-shape replacements for the reference's line handling in the proposal
engine: `align_left_right_edges` (object_3d_util.cpp:246-258),
`merge_break_lines` (object_3d_util.cpp:431-543) and the inside-box edge
filter (box_proposal_detail.cpp:271-283).  Variable-count line sets become a
(L, 4) array `[x1 y1 x2 y2]` plus a boolean validity mask; the greedy merge
is reproduced as a `lax.while_loop` that merges the lexicographically-first
candidate pair per iteration (the reference restarts its O(n^2) scan after
every merge, so first-match order is exactly its behaviour).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = jnp.inf


def align_left_right(lines: jnp.ndarray) -> jnp.ndarray:
    """Ensure each segment's first endpoint has the smaller x
    (object_3d_util.cpp:246-258)."""
    flip = lines[..., 2] < lines[..., 0]
    swapped = jnp.concatenate([lines[..., 2:4], lines[..., 0:2]], axis=-1)
    return jnp.where(flip[..., None], swapped, lines)


def line_angles(lines: jnp.ndarray) -> jnp.ndarray:
    """atan2(dy, dx); with left-to-right segments this is in [-pi/2, pi/2]."""
    return jnp.arctan2(lines[..., 3] - lines[..., 1], lines[..., 2] - lines[..., 0])


def line_lengths(lines: jnp.ndarray) -> jnp.ndarray:
    return jnp.hypot(lines[..., 2] - lines[..., 0], lines[..., 3] - lines[..., 1])


def line_midpoints(lines: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (lines[..., 0:2] + lines[..., 2:4])


def inside_box_mask(lines: jnp.ndarray, top_left, bottom_right) -> jnp.ndarray:
    """Both endpoints inside [top_left, bottom_right] (inclusive), matching
    check_inside_box (object_3d_util.cpp:239-242)."""
    def inside(pt):
        return (
            (top_left[0] <= pt[..., 0])
            & (pt[..., 0] <= bottom_right[0])
            & (top_left[1] <= pt[..., 1])
            & (pt[..., 1] <= bottom_right[1])
        )

    return inside(lines[..., 0:2]) & inside(lines[..., 2:4])


def _angle_diff_half(a, b):
    d = jnp.abs(a - b)
    return jnp.minimum(d, jnp.pi - d)


def _merge_candidates(lines, mask, ang_thr, dist_thresh):
    """Pairwise merge-candidacy matrix + merged endpoints, mirroring the
    per-pair conditions of the reference merge (object_3d_util.cpp:459-505).

    Returns (cand (L, L) bool upper-triangular, mstart (L, L, 2),
    mend (L, L, 2))."""
    L = lines.shape[0]
    upper = jnp.arange(L)[:, None] < jnp.arange(L)[None, :]
    ang = line_angles(lines)
    angle_ok = _angle_diff_half(ang[:, None], ang[None, :]) < ang_thr
    tail, head = lines[:, 2:4], lines[:, 0:2]
    d12 = jnp.linalg.norm(tail[:, None, :] - head[None, :, :], axis=-1)
    d21 = jnp.linalg.norm(tail[None, :, :] - head[:, None, :], axis=-1)
    dist_ok = (d12 < dist_thresh) | (d21 < dist_thresh)
    # merged endpoints: leftmost head, rightmost tail
    i_head_first = lines[:, None, 0] < lines[None, :, 0]
    mstart = jnp.where(i_head_first[..., None], head[:, None, :], head[None, :, :])
    i_tail_last = lines[:, None, 2] > lines[None, :, 2]
    mend = jnp.where(i_tail_last[..., None], tail[:, None, :], tail[None, :, :])
    mang = jnp.arctan2(mend[..., 1] - mstart[..., 1], mend[..., 0] - mstart[..., 0])
    merge_ok = _angle_diff_half(ang[:, None], mang) < ang_thr
    cand = upper & mask[:, None] & mask[None, :] & angle_ok & dist_ok & merge_ok
    return cand, mstart, mend


def merge_break_lines(
    lines: jnp.ndarray,
    mask: jnp.ndarray,
    dist_thresh: float = 20.0,
    angle_thresh_deg: float = 5.0,
    min_length: float = 30.0,
    max_iters: int = 64,
):
    """Merge nearly-collinear, endpoint-adjacent segments, then length
    filtering (object_3d_util.cpp:431-543).

    Batched reformulation of the reference's one-merge-per-scan greedy
    loop: each round commits ALL mutual-first-choice candidate pairs
    simultaneously (disjoint by construction), so a chain of k collinear
    stubs coalesces in O(log k) rounds instead of k sequential scans.  The
    per-pair merge conditions are identical to the reference's; only the
    commit order differs, and the reference restarts its scan after every
    merge, so the final merged set is order-insensitive for
    non-overlapping chains.
    """
    L = lines.shape[0]
    ang_thr = jnp.deg2rad(angle_thresh_deg)
    pair_rank = jnp.arange(L)[:, None] * L + jnp.arange(L)[None, :]
    big = L * L

    def body(state):
        lines, mask, _, it = state
        cand, mstart, mend = _merge_candidates(lines, mask, ang_thr, dist_thresh)
        # symmetric rank matrix: each segment's first choice over both roles
        rank = jnp.where(cand, pair_rank, big)
        rank = jnp.minimum(rank, rank.T)  # (L, L), symmetric
        partner = jnp.argmin(rank, axis=1)
        has = jnp.min(rank, axis=1) < big
        # accept mutual-first-choice pairs (i < partner[i])
        ids = jnp.arange(L)
        accept = has & (partner[partner] == ids) & (ids < partner)
        j = partner
        new_lines = jnp.concatenate([mstart[ids, j], mend[ids, j]], axis=-1)
        lines = jnp.where(accept[:, None], new_lines, lines)
        # deactivate the absorbed partner (duplicate-index-safe via max)
        absorbed = jnp.zeros(L, bool).at[jnp.where(accept, j, ids)].max(accept)
        mask = mask & ~absorbed
        return lines, mask, jnp.any(accept), it + 1

    def cond(state):
        _, _, merged_any, it = state
        return jnp.logical_and(merged_any, it < max_iters)

    # initial flag must be True; deriving it from `mask` keeps its sharding
    # type ("varying manual axes") consistent under shard_map
    init_found = jnp.any(mask) | jnp.logical_not(jnp.any(mask))
    lines, mask, _, _ = jax.lax.while_loop(
        cond, body, (lines, mask, init_found, jnp.asarray(0))
    )
    if min_length > 0:
        mask = mask & (line_lengths(lines) > min_length)
    return lines, mask


def bbox_overlap_ratio(rect1: jnp.ndarray, rect2: jnp.ndarray) -> jnp.ndarray:
    """IoU of [x, y, w, h] rectangles (bboxOverlapratio,
    object_3d_util.cpp:1014-1018).  Broadcasts over leading dims."""
    ax1, ay1 = rect1[..., 0], rect1[..., 1]
    ax2, ay2 = ax1 + rect1[..., 2], ay1 + rect1[..., 3]
    bx1, by1 = rect2[..., 0], rect2[..., 1]
    bx2, by2 = bx1 + rect2[..., 2], by1 + rect2[..., 3]
    iw = jnp.maximum(jnp.minimum(ax2, bx2) - jnp.maximum(ax1, bx1), 0.0)
    ih = jnp.maximum(jnp.minimum(ay2, by2) - jnp.maximum(ay1, by1), 0.0)
    inter = iw * ih
    union = rect1[..., 2] * rect1[..., 3] + rect2[..., 2] * rect2[..., 3] - inter
    return inter / jnp.maximum(union, 1e-12)


def point_boundary_dist(rect: jnp.ndarray, pt: jnp.ndarray) -> jnp.ndarray:
    """min distance of a point to the nearer vertical/horizontal rect border
    (pointBoundaryDist, object_3d_util.cpp:1021-1035)."""
    mid_x = rect[..., 0] + rect[..., 2] / 2.0
    mid_y = rect[..., 1] + rect[..., 3] / 2.0
    dx = jnp.where(
        pt[..., 0] < mid_x,
        jnp.abs(pt[..., 0] - rect[..., 0]),
        jnp.abs(pt[..., 0] - rect[..., 0] - rect[..., 2]),
    )
    dy = jnp.where(
        pt[..., 1] < mid_y,
        jnp.abs(pt[..., 1] - rect[..., 1]),
        jnp.abs(pt[..., 1] - rect[..., 1] - rect[..., 3]),
    )
    return jnp.minimum(dx, dy)
