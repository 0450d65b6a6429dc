"""Benchmark: cuboid-proposal frames/s on one device, plus secondary numbers.

    python bench.py

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device"}; secondary numbers (BA ms/iter, line matching, detector, the fused
end-to-end online loop) go to stderr.

The headline is the throughput of the full cuboid-proposal hypothesis grid
for one 2D detection at VGA (Canny + exact EDT + corner/scoring grid +
fusion + lifting), the dominant per-frame stage of the reference's online
mode (SURVEY.md section 3.1).  `vs_baseline` compares against 10 frames/s,
the order of magnitude of the reference's single-threaded C++ proposal stage
on a desktop CPU (the reference publishes no numbers — BASELINE.md).

Inputs are rendered from a seed (utils.synth.fr3_one_object_scene, the
scene chip_smoke.py runs), so the bench needs no dataset.  Times are medians
of repeated calls on the host clock, each ending in block_until_ready.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import numpy as np

BASELINE_FPS = 10.0


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _median_s(f, *args, reps=10):
    """Median wall seconds of f(*args) after one warm-up (compile) call."""
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _scene(n_frames):
    """The rendered one-object fr3 sequence, in a temporary directory."""
    from cube_slam_wu_tpu.utils import synth

    tmp = tempfile.TemporaryDirectory(prefix="bench_")
    base, _ = synth.fr3_one_object_scene(tmp.name, n_frames=n_frames)
    return tmp, base


def main():
    import jax
    import jax.numpy as jnp

    from cube_slam_wu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    _log(f"device: {device}")
    dtype = jnp.float32

    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.ops.detect import detect_line_segments
    from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboid_single
    from cube_slam_wu_tpu.slam.online import TUM_FR3_K
    from cube_slam_wu_tpu.utils import io as uio

    tmp, base = _scene(58)
    truth = uio.read_number_txt(base / "truth_cam_poses.txt")
    n_e2e = len(truth)
    gray = jnp.asarray(uio.load_image_gray(uio.frame_image_path(base, 0)), dtype)
    boxes, _, _ = uio.read_detections_txt(
        base / "filter_2d_obj_txts" / "0000_yolo2_0.15.txt", n_max=1
    )
    x0, y0, x1, y1 = boxes[0]
    bbox = jnp.asarray([x0 - 1.0, y0 - 1.0, x1 - x0, y1 - y0], dtype)
    K = jnp.asarray(TUM_FR3_K, dtype)
    T_wc = SE3.from_xyzq(jnp.asarray(truth[0, 1:8], dtype)).matrix()
    lines, mask = detect_line_segments(gray)
    L = int(lines.shape[0])

    # ---- headline: proposal grid, reference-parity configuration ----------
    # (int-cast chamfer lookups, box_proposal_detail.cpp:327 semantics); the
    # production online config (bilinear chamfer) is a secondary number
    cfg = ProposalConfig(max_lines=L, sample_cam_roll_pitch=True)
    cfg_prod = ProposalConfig(
        max_lines=L,
        sample_cam_roll_pitch=True,
        rank_margin=2e-3,
        bilinear_dist=True,
        nominal_skew_ratio=2.0,
    )

    def proposal(c):
        return jax.jit(
            lambda g: detect_cuboid_single(g, K, T_wc, bbox, lines, mask, c)
        )

    sec_per_frame = _median_s(proposal(cfg), gray, reps=20)
    fps = 1.0 / sec_per_frame
    _log(f"proposal grid (25 roll/pitch x 16 yaw): {sec_per_frame * 1e3:.3f} "
         f"ms -> {fps:.1f} obj-frames/s")
    sec_prod = _median_s(proposal(cfg_prod), gray, reps=20)
    _log(f"proposal grid, production online config (bilinear chamfer): "
         f"{sec_prod * 1e3:.3f} ms -> {1.0 / sec_prod:.1f} obj-frames/s")

    # ---- BA ms/iter size sweep --------------------------------------------
    from cube_slam_wu_tpu.core.cuboid import Cuboid
    from cube_slam_wu_tpu.slam import ba
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

    def build_graph(F):
        rng = np.random.default_rng(1)
        tang = jnp.asarray(rng.normal(size=(F, 6)) * 0.05, dtype)
        Tcw = SE3.exp(tang)
        odom_parts = [SE3.identity((), dtype)] + [
            Tcw[i].compose(Tcw[i - 1].inverse()) for i in range(1, F)
        ]
        odom = jax.tree.map(lambda *xs: jnp.stack(xs), *odom_parts)
        cube = Cuboid.from_minimal(
            jnp.asarray([0.5, 2.0, 0.3, 0, 0, 0.7, 0.4, 0.3, 0.3], dtype)
        )
        meas = cube.transform_to(Tcw.inverse())
        meas = jax.tree.map(lambda x: x[:, None], meas)
        return CameraObjectGraph.empty(F, 1, dtype)._replace(
            cam_Tcw=SE3.exp(tang + 0.01),
            cube=jax.tree.map(lambda x: x[None], cube),
            frame_mask=jnp.ones(F, bool),
            cube_valid=jnp.ones(1, bool),
            odom=odom,
            odom_mask=jnp.arange(F) > 0,
            cube_meas=meas,
            cube_meas_weight=jnp.full((F, 1), 1.8, dtype),
            cube_meas_mask=jnp.ones((F, 1), bool),
        )

    one_iter = jax.jit(lambda g: ba.optimize(g, iterations=1))
    for F in (64, 256, 1024):
        ms = _median_s(one_iter, build_graph(F)) * 1e3
        _log(f"BA F={F}: {ms:.3f} ms/iter")
    txt = one_iter.lower(build_graph(64)).compile().as_text()
    n_fus = txt.count(" fusion(") + txt.count(" fusion.")
    n_ops = sum(1 for ln in txt.splitlines() if " = " in ln and "ROOT" not in ln)
    _log(f"BA F=64: compiled module has ~{n_fus} fusions / {n_ops} HLO ops "
         f"for 1 LM iteration")

    # ---- line detection + LBD + matching, frame pair ------------------------
    from cube_slam_wu_tpu.ops import lbd as lbd_ops

    g1 = gray
    g2 = jnp.asarray(uio.load_image_gray(uio.frame_image_path(base, 1)), dtype)
    l1, m1 = detect_line_segments(g1)
    w1 = lbd_ops.binarize_lbd(lbd_ops.lbd_descriptors(g1, l1, m1)[0])

    @jax.jit
    def match(g):
        l2, m2 = detect_line_segments(g)
        w2 = lbd_ops.binarize_lbd(lbd_ops.lbd_descriptors(g, l2, m2)[0])
        return lbd_ops.hamming_match(w2, w1, m2, m1), m2

    line_ms = _median_s(match, g2) * 1e3
    (_, _, matched), m2 = match(g2)
    _log(f"line detect+LBD+match (frame pair): {line_ms:.3f} ms/frame; "
         f"{int(jnp.sum(matched))} matches dist<25 of "
         f"{int(jnp.sum(m2))} query lines")
    det_ms = _median_s(jax.jit(detect_line_segments), gray) * 1e3
    _log(f"line detector: {det_ms:.3f} ms/frame")

    print(
        json.dumps(
            {
                "metric": "cuboid_proposal_fps",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / BASELINE_FPS, 2),
                "device": device,
            }
        ),
        flush=True,
    )

    # ---- end-to-end fused online SLAM on the rendered sequence -------------
    from cube_slam_wu_tpu.slam.online import run_online_slam_fused
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    # warm-up over 3 frames at full capacity compiles both step variants;
    # frames 0 and 1 of a call trace them again, so steady state is frame 2 on
    run_online_slam_fused(str(base), n_frames=3, capacity=n_e2e)
    result = run_online_slam_fused(str(base))
    steady = result.frame_s[2:] * 1e3
    ate = ate_rmse(result.traj_Twc_xyzq[:, :3], truth[:, 1:4])
    _log(f"end-to-end fused online SLAM, rendered {n_e2e}-frame fr3 scene: "
         f"median {np.median(steady):.3f} ms/frame, p80 "
         f"{np.percentile(steady, 80):.3f} ms over {len(steady)} steady "
         f"frames; whole call {result.frame_s.sum():.2f} s incl. tracing; "
         f"ATE {ate:.4f} m; {result.syncs_per_frame:.0f} blocking sync/frame; "
         f"report {result.report}")
    tmp.cleanup()


if __name__ == "__main__":
    main()
