"""Sliding-window (fixed-lag) bundle adjustment support.

The reference re-optimises the ENTIRE graph every frame
(object_slam/src/main_obj.cpp:802-803); its sparse block solver
(Thirdparty/g2o/g2o/core/block_solver.h) tolerates growing graphs, but the
cost is still O(frames) per frame and unusable at KITTI length.  This
design instead runs a fixed-lag smoother:

- only the most recent W frames are free variables (the oldest in-window
  pose is the gauge anchor, held fixed — it carries the frozen past);
- when a frame leaves the window, its camera-object edges are absorbed
  into a per-object Gaussian prior: the departing pose is frozen, so each
  of its cuboid edges becomes a UNARY factor on the object, linearised
  once at the object's estimate (first-estimates-style linearisation
  point) and accumulated as a 9x9 information block + gradient;
- odometry edges of departed frames contribute through the fixed anchor.

The full-graph path (window=None in slam.tracker.run_incremental) is kept
for reference-parity runs on the bundled 58-frame sequence; equivalence of
the two is pinned by tests/test_window_ba.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.precision import einsum
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

_EPS = 1e-9

# graph fields with a leading frame axis (sliced/scattered by the window)
_FRAME_FIELDS = (
    "cam_Tcw",
    "frame_mask",
    "odom",
    "odom_mask",
    "cube_meas",
    "cube_meas_weight",
    "cube_meas_mask",
    "bbox_meas",
    "bbox_weight",
    "bbox_mask",
)


class CubePrior(NamedTuple):
    """Accumulated Gaussian prior over the O cuboid landmarks.

    Energy per object: E(c) = 0.5 d^T H d + b^T d with d = c boxminus lin
    (right-multiplicative tangent, Cuboid.exp_update convention).  S / c_vec
    are the residual factorisation r(d) = S d + c_vec with S^T S = H and
    S^T c_vec = b, recomputed at absorption time so the LM residual vector
    is a cheap matmul.
    """

    H: jnp.ndarray  # (O, 9, 9)
    b: jnp.ndarray  # (O, 9)
    S: jnp.ndarray  # (O, 9, 9) upper-triangular sqrt information
    c_vec: jnp.ndarray  # (O, 9)
    lin: Cuboid  # (O,) linearisation points
    valid: jnp.ndarray  # (O,) bool

    @staticmethod
    def empty(n_objects: int, dtype=jnp.float64) -> "CubePrior":
        O = n_objects
        return CubePrior(
            H=jnp.zeros((O, 9, 9), dtype),
            b=jnp.zeros((O, 9), dtype),
            S=jnp.zeros((O, 9, 9), dtype),
            c_vec=jnp.zeros((O, 9), dtype),
            lin=Cuboid.identity((O,), dtype),
            valid=jnp.zeros((O,), bool),
        )


def prior_residuals(prior: CubePrior, cube: Cuboid) -> jnp.ndarray:
    """(O, 9) residual rows of the prior at candidate estimates `cube`."""
    d = cube.log_error(prior.lin)  # (O, 9): cube = lin (+) d
    r = einsum("oij,oj->oi", prior.S, d) + prior.c_vec
    return jnp.where(prior.valid[:, None], r, 0.0)


def absorb_frame(
    prior: CubePrior,
    Twc_frozen: SE3,
    meas: Cuboid,
    weight: jnp.ndarray,
    mask: jnp.ndarray,
    cube_est: Cuboid,
    absorb_gate: float = 3.0,
    info_cap: float = 1e4,
) -> CubePrior:
    """Fold the departing frame's camera-object edges into the prior.

    Twc_frozen: () the departed camera pose (now constant); meas/weight/mask:
    (O,) its cuboid measurements; cube_est: (O,) current landmark estimates
    (used as linearisation point on an object's FIRST absorption).

    `absorb_gate` drops edges whose residual norm at the linearisation point
    exceeds it: a measurement that far from the landmark estimate is an
    outlier (wrong association, degenerate proposal), and freezing it into a
    permanent Gaussian would bias the landmark forever — the in-window
    optimisation already got its chance to reconcile it.  `info_cap` bounds
    each absorption's information diagonal: near-pi relative rotations make
    the SE3-log Jacobian diverge, and one such edge would otherwise poison
    the prior's H with ~1e12 entries — which silently disables ALL later
    window solves because LM seeds lambda_0 from max diag(H) (measured: the
    camera freezes at the origin and chi2 grows monotonically).
    """
    O = weight.shape[0]
    dtype = weight.dtype
    Twc_b = SE3(
        jnp.broadcast_to(Twc_frozen.quat, (O, 4)),
        jnp.broadcast_to(Twc_frozen.trans, (O, 3)),
    )
    meas_global = meas.transform_from(Twc_b)  # (O,)

    first = mask & ~prior.valid
    lin = jax.tree.map(
        lambda a, b: jnp.where(
            first.reshape((O,) + (1,) * (a.ndim - 1)), a, b
        ),
        cube_est,
        prior.lin,
    )

    def one(lin_o: Cuboid, meas_o: Cuboid, w_o):
        # same residual direction as graph_residuals' camera-object term:
        # r(c) = w * c.min_log_error(meas_global) (g2o_Object.h:250-259)
        def f(d):
            return w_o * lin_o.exp_update(d).min_log_error(meas_o)

        zero = jnp.zeros((9,), dtype)
        return f(zero), jax.jacfwd(f)(zero)

    r0, J = jax.vmap(one)(lin, meas_global, weight)  # (O, 9), (O, 9, 9)
    innov = jnp.linalg.norm(r0, axis=-1) / jnp.maximum(weight, 1e-9)
    gate = (mask & (weight > 0) & (innov < absorb_gate)).astype(dtype)
    # bound each edge's information so one degenerate linearisation cannot
    # poison the (never-decaying) prior
    jmax = jnp.max(jnp.abs(J), axis=(-2, -1))  # (O,)
    shrink = jnp.minimum(1.0, jnp.sqrt(info_cap) / jnp.maximum(jmax, 1e-12))
    J = J * (gate * shrink)[:, None, None]
    r0 = r0 * (gate * shrink)[:, None]

    H = prior.H + einsum("oki,okj->oij", J, J)
    b = prior.b + einsum("oki,ok->oi", J, r0)
    valid = prior.valid | (gate > 0)

    eye = jnp.eye(9, dtype=dtype)
    L = jnp.linalg.cholesky(H + _EPS * eye[None])  # (O, 9, 9) lower
    S = jnp.swapaxes(L, -1, -2)
    c_vec = jax.vmap(
        lambda Lo, bo: jax.scipy.linalg.solve_triangular(Lo, bo, lower=True)
    )(L, b)
    vgate = valid[:, None]
    return CubePrior(
        H=H,
        b=b,
        S=jnp.where(vgate[..., None], S, 0.0),
        c_vec=jnp.where(vgate, c_vec, 0.0),
        lin=lin,
        valid=valid,
    )


def window_slice(graph: CameraObjectGraph, start, W: int) -> CameraObjectGraph:
    """Gather the W-frame window [start, start+W) as a standalone graph.

    The first in-window odometry edge reaches outside the window, so its
    mask is cleared (the anchor pose is fixed instead)."""
    updates = {}
    for name in _FRAME_FIELDS:
        leaf = getattr(graph, name)
        updates[name] = jax.tree.map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, start, W, axis=0), leaf
        )
    win = graph._replace(**updates)
    return win._replace(odom_mask=win.odom_mask.at[0].set(False))


def window_scatter(
    graph: CameraObjectGraph, cam_win: SE3, start
) -> CameraObjectGraph:
    """Write the optimized window poses back into the full-capacity graph."""
    cam = jax.tree.map(
        lambda full, win: jax.lax.dynamic_update_slice_in_dim(
            full, win, start, axis=0
        ),
        graph.cam_Tcw,
        cam_win,
    )
    return graph._replace(cam_Tcw=cam)
