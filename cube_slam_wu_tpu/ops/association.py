"""Detection-to-object data association.

The reference associates per-frame 2D detections with tracked object
landmarks when building the KITTI/object graphs (object association by
bbox overlap, object_slam/src/main_obj.cpp detection ingestion; the
bundled TUM demo hardcodes a single object so the association is trivial
there).  This module provides the general multi-object version as
fixed-shape device ops:

- `iou_matrix`: pairwise IoU between two padded bbox sets;
- `greedy_assign`: deterministic greedy matching (repeated global argmax
  with row/column masking) expressed as a `lax.scan` over min(R, C)
  rounds — no data-dependent shapes, jit/vmap/shard_map safe.

Greedy (not Hungarian) matches the reference's behaviour class: at SLAM
object counts (O, D ≲ tens) the IoU margins are large and greedy equals
the optimal assignment in practice, while staying O(K·R·C) with static
shapes instead of an inherently sequential augmenting-path search.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def iou_matrix(
    boxes_a: jnp.ndarray,
    boxes_b: jnp.ndarray,
    mask_a: jnp.ndarray | None = None,
    mask_b: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Pairwise IoU of (R, 4) and (C, 4) boxes given as [x1, y1, x2, y2].

    Invalid rows/columns (masks False) get IoU 0.
    """
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    ix1 = jnp.maximum(a[..., 0], b[..., 0])
    iy1 = jnp.maximum(a[..., 1], b[..., 1])
    ix2 = jnp.minimum(a[..., 2], b[..., 2])
    iy2 = jnp.minimum(a[..., 3], b[..., 3])
    inter = jnp.maximum(ix2 - ix1, 0.0) * jnp.maximum(iy2 - iy1, 0.0)
    area_a = jnp.maximum(a[..., 2] - a[..., 0], 0.0) * jnp.maximum(
        a[..., 3] - a[..., 1], 0.0
    )
    area_b = jnp.maximum(b[..., 2] - b[..., 0], 0.0) * jnp.maximum(
        b[..., 3] - b[..., 1], 0.0
    )
    union = area_a + area_b - inter
    iou = jnp.where(union > 0, inter / jnp.maximum(union, 1e-12), 0.0)
    if mask_a is not None:
        iou = jnp.where(mask_a[:, None], iou, 0.0)
    if mask_b is not None:
        iou = jnp.where(mask_b[None, :], iou, 0.0)
    return iou


def greedy_assign(score: jnp.ndarray, min_score: float = 0.0):
    """Greedy one-to-one assignment on an (R, C) score matrix (higher is
    better): repeatedly take the globally best remaining pair whose score
    exceeds `min_score`, masking its row and column.

    Returns (col_of_row (R,) int32 — C if unassigned, assigned (R,) bool).
    Deterministic: ties break toward the smallest flat index (row-major).
    """
    R, C = score.shape
    score = score.astype(jnp.float32)
    neg = jnp.asarray(-jnp.inf, score.dtype)

    def round_(carry, _):
        s, col_of_row, assigned = carry
        flat = jnp.argmax(s)
        r, c = flat // C, flat % C
        ok = s[r, c] > min_score
        col_of_row = jnp.where(
            ok, col_of_row.at[r].set(c.astype(jnp.int32)), col_of_row
        )
        assigned = jnp.where(ok, assigned.at[r].set(True), assigned)
        s = jnp.where(ok, s.at[r, :].set(neg).at[:, c].set(neg), s)
        return (s, col_of_row, assigned), None

    init = (
        score,
        jnp.full((R,), C, jnp.int32),
        jnp.zeros((R,), bool),
    )
    (s, col_of_row, assigned), _ = jax.lax.scan(
        round_, init, None, length=min(R, C)
    )
    return col_of_row, assigned


def associate_detections(
    track_bboxes: jnp.ndarray,
    track_mask: jnp.ndarray,
    det_bboxes: jnp.ndarray,
    det_mask: jnp.ndarray,
    min_iou: float = 0.3,
):
    """Match detections to tracked objects by bbox IoU.

    track_bboxes: (O, 4) predicted 2D boxes of existing object landmarks
    (e.g. `Cuboid.project_bbox` converted to corners); det_bboxes: (D, 4)
    this frame's detections.  Returns:

    - det_of_track (O,) int32: detection index per object, D if none;
    - matched (O,) bool;
    - det_is_new (D,) bool: valid detections left unmatched (candidate new
      object landmarks — the caller decides whether to spawn).
    """
    iou = iou_matrix(track_bboxes, det_bboxes, track_mask, det_mask)
    det_of_track, matched = greedy_assign(iou, min_score=min_iou)
    O, D = iou.shape
    used = jnp.zeros((D + 1,), bool).at[det_of_track].max(matched)[:D]
    det_is_new = det_mask & ~used
    return det_of_track, matched, det_is_new
