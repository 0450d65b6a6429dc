"""Point-feature front-end: Harris corners + ZNCC patch tracking.

The reference's point landmarks come from its ORB-SLAM2 integration (not
present in the repo — README.md:8 — but its g2o ships the mono point
projection edges we cover in slam/point_ba).  This module provides the
batched feature front-end that feeds those edges: batched Harris corner
detection and zero-mean NCC patch tracking over a search window, both
fixed-shape (padded corner sets + masks) and jit-compiled.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.precision import einsum
from cube_slam_wu_tpu.ops import image as image_ops
from cube_slam_wu_tpu.ops.detect import gaussian_blur5


def _box_blur(a: jnp.ndarray, r: int) -> jnp.ndarray:
    """(2r+1)^2 box filter via separable cumsum differences."""
    for axis in (-2, -1):
        n = a.shape[axis]
        idx = jnp.arange(n)
        lo = jnp.clip(idx - r, 0, n - 1)
        hi = jnp.clip(idx + r, 0, n - 1)
        c = jnp.cumsum(a, axis=axis)
        c = jnp.concatenate(
            [jnp.zeros_like(jax.lax.slice_in_dim(c, 0, 1, axis=axis)), c], axis=axis
        )
        a = jnp.take(c, hi + 1, axis=axis) - jnp.take(c, lo, axis=axis)
    return a


@functools.partial(jax.jit, static_argnames=("max_corners", "border"))
def harris_corners(
    gray: jnp.ndarray,
    max_corners: int = 256,
    k: float = 0.04,
    rel_threshold: float = 1e-5,
    border: int = 12,
):
    """Harris corner detection; returns (pts (K, 2) [x, y] float, mask (K,)).

    Standard pipeline: blurred Sobel products -> windowed structure tensor ->
    R = det - k*tr^2 -> 3x3 NMS -> top-K above rel_threshold * max(R)."""
    g = gaussian_blur5(gray)
    gx, gy = image_ops.sobel3(g)
    Ixx = _box_blur(gx * gx, 2)
    Iyy = _box_blur(gy * gy, 2)
    Ixy = _box_blur(gx * gy, 2)
    R = (Ixx * Iyy - Ixy * Ixy) - k * (Ixx + Iyy) ** 2

    # 3x3 non-max suppression
    m = R
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)):
        m = jnp.maximum(m, jnp.roll(R, (dy, dx), axis=(-2, -1)))
    is_peak = (R >= m) & (R > rel_threshold * jnp.max(R))

    h, w = gray.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = jnp.where(is_peak & inside, R, -jnp.inf)
    vals, idx = jax.lax.top_k(score.reshape(-1), max_corners)
    py = (idx // w).astype(gray.dtype)
    px = (idx % w).astype(gray.dtype)
    return jnp.stack([px, py], axis=-1), jnp.isfinite(vals) & (vals > 0)


@functools.partial(jax.jit, static_argnames=("patch_radius", "search_radius"))
def track_corners(
    gray_prev: jnp.ndarray,
    gray_next: jnp.ndarray,
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    patch_radius: int = 4,
    search_radius: int = 24,
    min_zncc: float = 0.7,
):
    """Track corners by exhaustive ZNCC over a search window.

    Returns (new_pts (K, 2), tracked (K,), zncc (K,)).  Fully batched with
    no data-dependent control flow.  The naive (K, displacements, patch)
    formulation re-gathers every window pixel ~(2r+1)^2/stride times —
    18.7M taps at the production shapes.  Instead assemble each corner's
    (2(s+r)+1)^2 search window ONCE — image rows by an axis-0 gather,
    columns by a one-hot einsum (on the GPU, against a direct gather: not
    measured yet) — correlate the reference
    patch against it with one grouped VALID conv (identical tap values:
    per-tap index clipping commutes with window assembly), and read the
    candidate means/norms from cumsum box sums over the same window."""
    r, s = patch_radius, search_radius
    H, W = gray_prev.shape
    P = (2 * r + 1) ** 2
    dy, dx = jnp.meshgrid(
        jnp.arange(-r, r + 1), jnp.arange(-r, r + 1), indexing="ij"
    )
    dy = dy.reshape(-1)
    dx = dx.reshape(-1)  # (P,)

    x0 = jnp.round(pts[:, 0]).astype(jnp.int32)
    y0 = jnp.round(pts[:, 1]).astype(jnp.int32)

    def patch_at(img, cy, cx):  # (K,) centres -> (K, P) patches
        yy = jnp.clip(cy[:, None] + dy[None, :], 0, H - 1)
        xx = jnp.clip(cx[:, None] + dx[None, :], 0, W - 1)
        return img[yy, xx]

    ref = patch_at(gray_prev, y0, x0)  # (K, P)
    ref = ref - jnp.mean(ref, axis=-1, keepdims=True)
    ref_n = jnp.sqrt(jnp.sum(ref * ref, axis=-1) + 1e-9)

    # per-corner search windows: (K, Wd, Wd).  Gather whole IMAGE ROWS
    # (axis-0 slices), then select each corner's Wd columns with a one-hot
    # einsum instead of a per-element take of every window pixel.  Values
    # are bit-identical to the per-element clipped gather: row and column
    # indices carry the same clip, and a one-hot dot at HIGHEST precision
    # is exact selection (single 1.0 partner; reduced-precision rounding of
    # the pixel values must stay off).
    wr = s + r
    Wd = 2 * wr + 1
    off = jnp.arange(-wr, wr + 1)
    wy = jnp.clip(y0[:, None] + off[None, :], 0, H - 1)  # (K, Wd)
    wx = jnp.clip(x0[:, None] + off[None, :], 0, W - 1)
    K = pts.shape[0]
    rows = gray_next[wy]  # (K, Wd, W) — row-contiguous DMA gather
    onehot = (
        jnp.arange(W)[None, :, None] == wx[:, None, :]
    ).astype(gray_next.dtype)  # (K, W, Wd)
    win = einsum(
        "kvp,kpc->kvc", rows, onehot, precision=jax.lax.Precision.HIGHEST
    )

    # Numerics: everything below runs on the WINDOW-MEAN-SUBTRACTED field.
    # The raw sum-of-squares form S2 - S1^2/P cancels catastrophically in
    # f32 (S2 ~ 3e6 for bright windows -> ~0.4 absolute noise on the
    # variance of low-contrast patches, i.e. 1e-4-level zncc noise that
    # flips borderline min_zncc decisions); after centering, S2 is on the
    # order of the variance itself and the cancellation vanishes.
    win0 = win - jnp.mean(win, axis=(-2, -1), keepdims=True)

    # numerator: sum(ref * (cand - mean_cand)) per displacement == grouped
    # VALID conv of the zero-meaned ref patch over the centered window,
    # minus the residual mean term (sum(ref) is only ~0 up to f32
    # rounding).  HIGHEST precision keeps the f32 products that a TF32 or
    # bf16 default would round.
    num = jax.lax.conv_general_dilated(
        win0[None],  # (1, K, Wd, Wd)
        ref.reshape(K, 1, 2 * r + 1, 2 * r + 1),
        window_strides=(1, 1),
        padding="VALID",
        feature_group_count=K,
        precision=jax.lax.Precision.HIGHEST,
    )[0]  # (K, D1, D1) with D1 = 2s+1

    # candidate patch sums / sum-of-squares via cumsum box filters
    def box_valid(a):  # (K, Wd, Wd) -> (K, D1, D1) sums over (2r+1)^2
        for axis in (-2, -1):
            c = jnp.cumsum(a, axis=axis)
            zero = jnp.zeros_like(jax.lax.slice_in_dim(c, 0, 1, axis=axis))
            c = jnp.concatenate([zero, c], axis=axis)
            hi = jax.lax.slice_in_dim(c, 2 * r + 1, Wd + 1, axis=axis)
            lo = jax.lax.slice_in_dim(c, 0, Wd - 2 * r, axis=axis)
            a = hi - lo
        return a

    s1 = box_valid(win0)
    s2 = box_valid(win0 * win0)
    ref_sum = jnp.sum(ref, axis=-1)  # ~1e-4 in f32, not exactly 0
    num = num - (s1 / P) * ref_sum[:, None, None]
    cand_var = jnp.maximum(s2 - s1 * s1 / P, 0.0)
    # a candidate variance below the cancellation noise floor of the
    # S2 - S1^2/P form (~s2 * f32-eps * P) is indistinguishable from an
    # exactly-flat patch, whose true zncc is 0 (the direct per-patch form
    # returns literally 0 there: cand - mean is exact zeros).  Zero those
    # lanes instead of dividing the numerator's own rounding residual by a
    # vanishing norm (measured blowup: |zncc| ~ 20 on sky patches).  The
    # clip bounds the survivors by Cauchy-Schwarz against num's rounding.
    reliable = cand_var > 1e-5 * s2 + 1e-6
    cand_n = jnp.sqrt(cand_var + 1e-9)
    zncc = jnp.where(
        reliable,
        jnp.clip(num / (ref_n[:, None, None] * cand_n), -1.0, 1.0),
        0.0,
    ).reshape(K, -1)  # (K, D)

    sy, sx = jnp.meshgrid(
        jnp.arange(-s, s + 1), jnp.arange(-s, s + 1), indexing="ij"
    )
    sy = sy.reshape(-1)
    sx = sx.reshape(-1)  # (D,) — same (sy, sx) row-major order as zncc
    best = jnp.argmax(zncc, axis=-1)
    best_zncc = jnp.take_along_axis(zncc, best[:, None], axis=-1)[:, 0]

    # sub-pixel peak: separable 3-point parabola fit on the zncc surface
    # around the argmax.  Integer-snapped displacements put +-0.5 px of
    # quantisation noise on EVERY point observation the BA consumes; the
    # refinement recovers the peak to ~0.1 px (clamped to +-0.5, and
    # skipped at window borders / degenerate curvature).
    D1 = 2 * s + 1
    bi = best // D1
    bj = best % D1

    def parab(idx_lo, idx_c, idx_hi, valid):
        z_lo = jnp.take_along_axis(zncc, idx_lo[:, None], axis=-1)[:, 0]
        z_c = jnp.take_along_axis(zncc, idx_c[:, None], axis=-1)[:, 0]
        z_hi = jnp.take_along_axis(zncc, idx_hi[:, None], axis=-1)[:, 0]
        denom = z_lo - 2.0 * z_c + z_hi
        ok = valid & (denom < -1e-9)
        off = jnp.where(ok, 0.5 * (z_lo - z_hi) / jnp.where(ok, denom, -1.0), 0.0)
        return jnp.clip(off, -0.5, 0.5)

    ii = jnp.clip(bi, 1, D1 - 2)
    jj = jnp.clip(bj, 1, D1 - 2)
    sub_y = parab(
        (ii - 1) * D1 + bj, ii * D1 + bj, (ii + 1) * D1 + bj, bi == ii
    )
    sub_x = parab(
        bi * D1 + jj - 1, bi * D1 + jj, bi * D1 + jj + 1, bj == jj
    )

    new_x = (x0 + sx[best]).astype(pts.dtype) + sub_x.astype(pts.dtype)
    new_y = (y0 + sy[best]).astype(pts.dtype) + sub_y.astype(pts.dtype)
    inb = (new_x >= r) & (new_x < W - r) & (new_y >= r) & (new_y < H - r)
    tracked = mask & (best_zncc > min_zncc) & inb
    return jnp.stack([new_x, new_y], axis=-1), tracked, best_zncc


class IncrementalTracker:
    """Host-side rolling feature tracker for the interleaved per-frame loop
    (slam.pipeline._run_kitti_tracked): fixed P slots, ZNCC tracking frame to
    frame, dead slots REUSED by re-detection (the windowed point step clears
    a respawned slot's observation history, so reuse cannot mix landmarks).

    Per frame call `advance(gray, bboxes)` -> (pts (P, 2), alive (P,),
    respawned (P,), ground_hint (P,)).  `bboxes` are the frame's 2D detection
    corners [x0 y0 x1 y1] (or None): a corner inside any box belongs to an
    OBJECT, not the ground, so its slot gets no ground hint; ground hints
    also require the corner to sit below the horizon row."""

    def __init__(
        self,
        n_slots: int = 96,
        horizon_row: float | None = None,
        redetect_min_alive: float = 0.6,
        redetect_spacing: float = 8.0,
        **track_kwargs,
    ):
        import numpy as np

        self.P = n_slots
        self.pts = np.zeros((n_slots, 2))
        self.alive = np.zeros(n_slots, bool)
        self.ground = np.zeros(n_slots, bool)
        self.prev_gray = None
        self.horizon_row = horizon_row
        self.min_alive = int(redetect_min_alive * n_slots)
        self.spacing = redetect_spacing
        self.track_kwargs = track_kwargs

    def state(self) -> dict:
        return dict(
            feat_pts=self.pts, feat_alive=self.alive, feat_ground=self.ground
        )

    def load_state(self, data) -> None:
        if "feat_pts" in data:
            self.pts[:] = data["feat_pts"]
            self.alive[:] = data["feat_alive"]
            self.ground[:] = data["feat_ground"]

    def _hints(self, cand, bboxes):
        import numpy as np

        g = np.ones(len(cand), bool)
        if self.horizon_row is not None:
            g &= cand[:, 1] > self.horizon_row
        if bboxes is not None and len(bboxes):
            b = np.asarray(bboxes)
            inside = (
                (cand[:, 0:1] >= b[None, :, 0]) & (cand[:, 0:1] <= b[None, :, 2])
                & (cand[:, 1:2] >= b[None, :, 1]) & (cand[:, 1:2] <= b[None, :, 3])
            ).any(axis=1)
            g &= ~inside
        return g

    def advance(self, gray, bboxes=None):
        import numpy as np

        respawned = np.zeros(self.P, bool)
        if self.prev_gray is not None and self.alive.any():
            new_pts, tracked, _ = track_corners(
                self.prev_gray, gray, jnp.asarray(self.pts),
                jnp.asarray(self.alive), **self.track_kwargs,
            )
            # one transfer for both outputs (per-leaf pulls each pay a
            # device round trip)
            new_pts, tracked = jax.device_get((new_pts, tracked))
            self.pts = np.array(new_pts)
            self.alive = np.array(tracked)
        elif self.prev_gray is None:
            self.alive[:] = False

        if self.alive.sum() < self.min_alive:
            fresh, fmask = jax.device_get(
                harris_corners(gray, max_corners=self.P)
            )
            fresh = np.asarray(fresh)[np.asarray(fmask)]
            if self.alive.any() and len(fresh):
                d = np.linalg.norm(
                    fresh[:, None, :] - self.pts[None, self.alive, :], axis=-1
                ).min(axis=1)
                fresh = fresh[d > self.spacing]
            free = np.nonzero(~self.alive)[0]
            take = min(len(fresh), len(free))
            if take:
                slots = free[:take]
                self.pts[slots] = fresh[:take]
                self.alive[slots] = True
                respawned[slots] = True
                self.ground[slots] = self._hints(fresh[:take], bboxes)

        self.prev_gray = gray
        return (
            self.pts.copy(), self.alive.copy(), respawned,
            self.ground & self.alive,
        )


def build_point_tracks(
    grays,
    max_corners: int = 192,
    capacity: int | None = None,
    redetect_min_alive: int | None = None,
    redetect_spacing: float = 8.0,
    **track_kwargs,
):
    """Track Harris corners through a frame list, re-detecting as tracks die.

    grays: list/array of (H, W) images.  Returns (obs_uv (F, C, 2),
    obs_mask (F, C)) with C = `capacity` (default 2*max_corners).  When the
    live count drops below `redetect_min_alive` (default max_corners//2),
    new corners are detected in the current frame and appended into UNUSED
    slots (never reviving a dead slot, so each slot remains one physical
    landmark for triangulation); corners within `redetect_spacing` px of a
    live track are skipped.  Set redetect_min_alive=0 to disable
    (the round-1 die-permanently behaviour)."""
    import numpy as np

    capacity = capacity or 2 * max_corners
    if redetect_min_alive is None:
        redetect_min_alive = max_corners // 2

    F = len(grays)
    obs_uv = np.zeros((F, capacity, 2))
    obs_mask = np.zeros((F, capacity), bool)

    pts0, mask0 = harris_corners(grays[0], max_corners=max_corners)
    pts0, mask0 = np.asarray(pts0), np.asarray(mask0)
    n0 = min(int(mask0.sum()), capacity)
    cur = np.zeros((capacity, 2))
    alive = np.zeros(capacity, bool)
    cur[:n0] = pts0[mask0][:n0]
    alive[:n0] = True
    next_free = n0
    obs_uv[0], obs_mask[0] = cur.copy(), alive.copy()

    for f in range(1, F):
        cur_j, alive_j, _ = track_corners(
            grays[f - 1], grays[f], jnp.asarray(cur), jnp.asarray(alive), **track_kwargs
        )
        cur, alive = np.array(cur_j), np.array(alive_j)  # writable copies
        if alive.sum() < redetect_min_alive and next_free < capacity:
            fresh, fmask = harris_corners(grays[f], max_corners=max_corners)
            fresh, fmask = np.asarray(fresh), np.asarray(fmask)
            cand = fresh[fmask]
            if alive.any() and len(cand):
                d = np.linalg.norm(
                    cand[:, None, :] - cur[None, alive, :], axis=-1
                ).min(axis=1)
                cand = cand[d > redetect_spacing]
            take = min(len(cand), capacity - next_free)
            if take:
                cur[next_free : next_free + take] = cand[:take]
                alive[next_free : next_free + take] = True
                next_free += take
        obs_uv[f], obs_mask[f] = cur.copy(), alive.copy()
    return obs_uv, obs_mask
