"""Hypothesis-grid tensor parallelism for the cuboid proposal engine.

The reference's proposal loop is single-threaded C++ (SURVEY.md section 2.9:
no TP of any kind); the scale-out for "per-frame work exceeds one
device" is to shard the (roll, pitch) sample axis of the hypothesis grid across
the mesh:

- the image, lines, calibration and bbox are replicated (small),
- each device runs `ops.proposal.hypothesis_grid` on its roll/pitch slice —
  the corner chains, chamfer dist-map gathers, VP-angle scores and 3D
  lifting, i.e. all of the per-hypothesis work,
- the per-hypothesis score/validity/state arrays are reassembled along the
  hypothesis axis (RP-major, so contiguous roll/pitch chunks concatenate
  exactly) — this is the only communication, a few (H,) vectors,
- score fusion + ranking (`_fuse_and_rank`) min-max-normalise over ALL
  hypotheses of a height sample, so they run on the reassembled arrays.

The roll/pitch axis is padded to a device-count multiple with `rp_valid`
masking; masked rows produce valid=False hypotheses, which fusion and
ranking ignore, so the sharded result is numerically identical to
`detect_cuboid_single` (asserted in tests/test_sharded_proposal.py on a
virtual 8-device CPU mesh).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cube_slam_wu_tpu.core import camera as cam
from cube_slam_wu_tpu.ops import lines as line_ops
from cube_slam_wu_tpu.ops import proposal as prop


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh", "axis_name")
)
def detect_cuboid_sharded(
    gray: jnp.ndarray,
    K: jnp.ndarray,
    T_wc: jnp.ndarray,
    bbox: jnp.ndarray,
    lines: jnp.ndarray,
    line_mask: jnp.ndarray,
    cfg: prop.ProposalConfig,
    mesh,
    axis_name: str = "hyp",
    yaw_prior: jnp.ndarray | None = None,
):
    """`detect_cuboid_single` with the roll/pitch hypothesis axis sharded
    over `mesh[axis_name]`.  Setup mirrors detect_cuboid_single
    (box_proposal_detail.cpp:65-205); see module docstring for the design.
    """
    n_dev = mesh.shape[axis_name]
    dtype = gray.dtype
    bbox = bbox.astype(dtype)
    left = jnp.floor(bbox[0])
    top = jnp.floor(bbox[1])
    w = jnp.floor(bbox[2])
    h = jnp.floor(bbox[3])
    right = left + w

    lines = line_ops.align_left_right(lines.astype(dtype))

    cam0 = cam.make_camera_pose(K.astype(dtype), T_wc.astype(dtype))
    euler_raw = cam0.euler

    if cfg.sample_cam_roll_pitch:
        rp_off = prop._sample_offsets(-6.0, 6.0, 3.0, dtype) * (math.pi / 180.0)
        rolls = euler_raw[0] + rp_off
        pitchs = euler_raw[1] + rp_off
        roll_grid, pitch_grid = jnp.meshgrid(rolls, pitchs, indexing="ij")
        roll_flat = roll_grid.reshape(-1)
        pitch_flat = pitch_grid.reshape(-1)
    else:
        roll_flat = euler_raw[0][None]
        pitch_flat = euler_raw[1][None]
    RP = roll_flat.shape[0]

    # pad the roll/pitch axis to a device-count multiple; padded rows are
    # masked out via rp_valid (exactly ignored by fusion/ranking)
    RP_pad = -(-RP // n_dev) * n_dev
    pad = RP_pad - RP
    roll_pad = jnp.concatenate([roll_flat, jnp.broadcast_to(roll_flat[-1:], (pad,))])
    pitch_pad = jnp.concatenate(
        [pitch_flat, jnp.broadcast_to(pitch_flat[-1:], (pad,))]
    )
    rp_valid = jnp.arange(RP_pad) < RP

    yaw_off = prop._sample_offsets(-45.0, 45.0, 6.0, dtype) * (math.pi / 180.0)
    yaw_init = euler_raw[2] - math.pi / 2.0
    yaws = yaw_init + yaw_off

    step = jnp.minimum(20.0, jnp.floor(w / 10.0))
    ks = jnp.arange(cfg.max_top_samples, dtype=dtype)
    top_xs = left + 5.0 + ks * step
    top_ok = (top_xs <= right - 5.0) & (step >= 1.0)

    rep = dict(
        gray=gray,
        K=K.astype(dtype),
        T_wc=T_wc.astype(dtype),
        box=(left, top, w, h, right),
        lines=lines,
        line_mask=line_mask,
        euler_raw=euler_raw,
        yaws=yaws,
        top_xs=top_xs,
        top_ok=top_ok,
    )

    def local(roll_l, pitch_l, rpv_l, r):
        hb, aux = prop.hypothesis_grid(
            r["gray"], r["K"], r["T_wc"], r["box"], r["lines"], r["line_mask"],
            cfg, r["euler_raw"], roll_l, pitch_l, rpv_l,
            r["yaws"], r["top_xs"], r["top_ok"], include_maps=False,
        )
        return hb, aux["yaw_f"], aux["roll_f"], aux["pitch_f"]

    out_shapes = jax.eval_shape(local, roll_pad, pitch_pad, rp_valid, rep)
    out_specs = jax.tree.map(
        lambda s: P(None, axis_name) if len(s.shape) == 2 else P(axis_name),
        out_shapes,
    )
    hb, yaw_f, roll_f, pitch_f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P()),
        out_specs=out_specs,
    )(roll_pad, pitch_pad, rp_valid, rep)

    nC = int(cfg.consider_config_1) + int(cfg.consider_config_2)
    aux = dict(yaw_f=yaw_f, roll_f=roll_f, pitch_f=pitch_f, nC=nC)
    return prop._fuse_and_rank(hb, aux, cfg, euler_raw, yaw_prior, False)
