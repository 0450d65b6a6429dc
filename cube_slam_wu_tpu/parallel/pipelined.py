"""Pipeline-parallel online front-end: line detection and cuboid proposal
as pipeline STAGES on separate devices, frames streaming through.

The reference processes each frame start-to-finish in one thread
(detect lines main_obj.cpp:593, then detect_cuboid :633).  A two-device
pipeline raises steady-state throughput from 1/(t_detect + t_proposal) to
1/max(t_detect, t_proposal) — close to 2x when the two stages cost about
the same (their times on the GPU are not measured yet) — while DP over
frames is impossible (online SLAM consumes frames in order) unless latency
is allowed to grow.

Shape: one SPMD program under `shard_map` over a 2-device mesh
axis.  Each tick of a `lax.scan`:
  - the device picks ITS stage's work item (tick - stage_id): stage 0 runs
    `detect_line_segments` on frame t, stage 1 runs `detect_cuboid_single`
    on the lines it received from stage 0 last tick (frame t-1);
  - the detected line set is handed to the next stage with a single
    `ppermute` (the image itself is never shipped: the frame stream is
    replicated in device memory and each stage indexes its own item).
The per-device branch is a `lax.cond` on `axis_index` — no collective sits
inside a branch, so the program is valid SPMD.  Outputs are concatenated
over the stage axis and the last stage's rows are the per-frame results
(a pipeline of S stages over T frames runs T + S - 1 ticks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cube_slam_wu_tpu.ops.detect import DetectConfig, detect_line_segments
from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboid_single

N_STAGES = 2  # detect | propose


def make_pipelined_frontend(
    mesh,
    K_np: np.ndarray,
    T_wc_np: np.ndarray,
    detect_cfg: DetectConfig = DetectConfig(),
    proposal_overrides: dict | None = None,
    dtype=jnp.float32,
    axis_name: str | None = None,
):
    """Build `fn(grays (T, H, W), bboxes (T, 4)[, T_wcs (T, 4, 4)]) ->
    ProposalResult (T, ...)` running the detect|propose pipeline over the
    first 2 devices of `mesh`'s `axis_name` axis.  Matches the sequential
    per-frame glue of `pipeline.run_online_frontend` (detection in f32,
    proposal in `dtype`, max_lines = detector capacity).

    `T_wcs` (optional) gives each frame its OWN camera pose, serving the
    interleaved `pose_feedback` mode where the proposal grid anchors at the
    tracker's constant-velocity predicted pose: prediction for frame t
    needs only the back-end state through frame t-1, which is ready while
    stage 0 is still detecting frame t+1 — so per-frame poses keep the
    2-stage overlap intact (the driver rolls predictions a chunk ahead,
    local-BAs per chunk).  Omitted, every frame uses `T_wc_np` (the
    reference's static-pose TUM schedule, main_obj.cpp:624-628)."""
    axis = axis_name or mesh.axis_names[0]
    S = mesh.shape[axis]
    if S != N_STAGES:
        raise ValueError(
            f"pipelined frontend needs a {N_STAGES}-device '{axis}' axis, "
            f"got {S}"
        )
    # detector output capacity: top-K by length (detect_line_segments)
    L = min(detect_cfg.max_output, detect_cfg.n_peaks * detect_cfg.runs_per_peak)
    over = dict(proposal_overrides or {})
    over.setdefault("rank_margin", 2e-3)
    over.setdefault("bilinear_dist", True)
    prop_cfg = ProposalConfig(max_lines=L, **over)
    Kj = jnp.asarray(K_np, dtype)
    Tj = jnp.asarray(T_wc_np, dtype)

    def program(grays, bboxes, T_wcs):
        T = grays.shape[0]
        sid = jax.lax.axis_index(axis)
        # the replicated frame stream is consumed at device-varying indices
        # (tick - stage_id), so mark it varying up front — otherwise inner
        # while_loops see mixed varying/unvarying carries and fail typing
        grays = jax.lax.pcast(grays, axis, to="varying")
        bboxes = jax.lax.pcast(bboxes, axis, to="varying")
        T_wcs = jax.lax.pcast(T_wcs, axis, to="varying")
        zero_res = jax.tree.map(
            lambda s: jax.lax.pcast(
                jnp.zeros(s.shape, s.dtype), axis, to="varying"
            ),
            jax.eval_shape(
                lambda g, b, l, m: detect_cuboid_single(
                    g, Kj, T_wcs[0], b, l, m, prop_cfg
                ),
                grays[0],
                bboxes[0],
                jax.lax.pcast(jnp.zeros((L, 4), dtype), axis, to="varying"),
                jax.lax.pcast(jnp.zeros((L,), bool), axis, to="varying"),
            ),
        )

        def tick(carry, t):
            lines_in, mask_in = carry
            item = jnp.clip(t - sid, 0, T - 1)
            gray = grays[item]
            bbox = bboxes[item]
            T_pose = T_wcs[item]

            def s_detect(_):
                l32, m = detect_line_segments(
                    gray.astype(jnp.float32), detect_cfg
                )
                return l32.astype(dtype), m, zero_res

            def s_propose(_):
                res = detect_cuboid_single(
                    gray, Kj, T_pose, bbox, lines_in, mask_in, prop_cfg
                )
                zl = jax.lax.pcast(
                    jnp.zeros((L, 4), dtype), axis, to="varying"
                )
                zm = jax.lax.pcast(jnp.zeros((L,), bool), axis, to="varying")
                return zl, zm, res

            lines_out, mask_out, res = jax.lax.cond(
                sid == 0, s_detect, s_propose, None
            )
            # hand the line set to the next stage
            lines_nxt = jax.lax.ppermute(lines_out, axis, [(0, 1)])
            mask_nxt = jax.lax.ppermute(mask_out, axis, [(0, 1)])
            return (lines_nxt, mask_nxt), res

        init = jax.tree.map(
            lambda x: jax.lax.pcast(x, axis, to="varying"),
            (jnp.zeros((L, 4), dtype), jnp.zeros((L,), bool)),
        )
        _, ys = jax.lax.scan(tick, init, jnp.arange(T + N_STAGES - 1))
        return ys

    from jax.sharding import PartitionSpec as P

    sharded = jax.jit(
        jax.shard_map(
            program,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=P(axis),
        )
    )

    def run(grays, bboxes, T_wcs=None):
        T = int(grays.shape[0])
        if T_wcs is None:
            T_wcs = jnp.broadcast_to(Tj, (T, 4, 4))
        ys = sharded(
            jnp.asarray(grays, dtype),
            jnp.asarray(bboxes, dtype),
            jnp.asarray(T_wcs, dtype),
        )
        # rows are concatenated over the stage axis: the LAST stage's block
        # holds the results; within it, frame t completes at tick t + S - 1
        n_ticks = T + N_STAGES - 1
        return jax.tree.map(
            lambda y: y[(N_STAGES - 1) * n_ticks + N_STAGES - 1 :], ys
        )

    return run
