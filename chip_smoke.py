"""Smoke test of the fused online SLAM path on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device   — JAX must see a GPU; prints the card's name and power limit.
2. inputs   — renders the seeded 58-frame 640x480 one-object scene with the
              TUM fr3 intrinsics (utils.synth.fr3_one_object_scene) and
              writes it in the TUM dataset layout.
3. main     — `cli online --fused` on it (cold), then the fused driver again
              (warm through the persistent compile cache): poses finite,
              measurements accepted, ATE against the rendered truth.
4. ref      — every dot in the lowered BA and fused step runs at HIGHEST
              precision; GPU against CPU in f32 on the first 12 frames: the
              line detector per frame (identical line sets, endpoints
              within 0.05 px), a BA on identical inputs and the whole fused
              step (poses within 5e-3, identical cube validity); prints the
              GPU run-to-run difference.
5. edt      — ops.image.distance_transform on the GPU at 480x640 against
              scipy.ndimage.distance_transform_edt (<= 1e-3 px).

The last line of stdout is one JSON object with "ok" and the device.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 58  # length of the reference's TUM fr3 sequence
SIZE = (480, 640)
REF_FRAMES = 12
POSE_TOL = 5e-3  # GPU vs CPU, every pose component
LINE_TOL = 0.05  # px, GPU vs CPU detector endpoints
EDT_TOL = 1e-3  # px


def _fail(msg: str, device=None) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(json.dumps({"ok": False, "error": msg, "device": device}))
    sys.exit(1)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device():
    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if dev.platform != "gpu":
        _fail(f"no GPU: jax.devices()[0] is {dev.platform}", info)
    print(f"card: {_card()}")
    print(f"jax {jax.__version__}, device {dev.device_kind} x{info['count']}")
    return info


def phase_inputs(root: pathlib.Path, n_frames=N_FRAMES, size=SIZE):
    from cube_slam_wu_tpu.utils import synth

    base, seq = synth.fr3_one_object_scene(root, n_frames=n_frames, size=size)
    n_det = sum(len(d) > 0 for d in seq.detections)
    print(f"inputs: {n_frames} frames {size[1]}x{size[0]}, "
          f"{n_det} with a detection, at {base}")
    return base


def phase_main(base: pathlib.Path, out: pathlib.Path):
    from cube_slam_wu_tpu import cli
    from cube_slam_wu_tpu.slam.online import run_online_slam_fused
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["online", "--fused", "--base", str(base), "--out", str(out)])
    cold = time.perf_counter() - t0
    printed = buf.getvalue()
    print("".join(f"  cli| {ln}\n" for ln in printed.splitlines()), end="")
    report = ast.literal_eval(printed.split("report ", 1)[1].splitlines()[0])
    traj = uio.read_number_txt(out / "output_cam_poses.txt")
    truth = uio.read_number_txt(base / "truth_cam_poses.txt")
    n = len(truth)
    if traj.shape != (n, 8) or not np.isfinite(traj).all():
        _fail(f"poses: shape {traj.shape}, finite {np.isfinite(traj).all()}")
    if report["n_measurements"] <= 0:
        _fail(f"no measurement accepted: {report}")
    ate = ate_rmse(traj[:, 1:4], truth[:, 1:4])

    t0 = time.perf_counter()
    warm = run_online_slam_fused(str(base))
    warm_s = time.perf_counter() - t0
    # frames 0 and 1 trace the two step variants (every driver call traces
    # afresh; the persistent cache skips only XLA compilation)
    steady = warm.frame_s[2:] * 1e3
    print(f"main: cap_overflow={report['cap_overflow']} "
          f"no_valid_proposal={report['no_valid_proposal']} "
          f"n_measurements={report['n_measurements']}")
    print(f"main: ATE vs rendered truth {ate:.4f} m over {n} frames")
    print(f"main: cold cli run {cold:.2f} s ({cold / n * 1e3:.1f} ms/frame, "
          f"compile included); warm driver run {warm_s:.2f} s "
          f"({warm_s / n * 1e3:.2f} ms/frame, tracing included)")
    print(f"main: steady state over frames 2-{n - 1}: median "
          f"{np.median(steady):.3f} ms/frame, p80 "
          f"{np.percentile(steady, 80):.3f} ms ({len(steady)} frames; host "
          f"clock, frame read and the previous pose pull included)")
    d = np.abs(warm.traj_Twc_xyzq - traj[:, 1:]).max()
    print(f"main: cold vs warm pose max diff {d:.3e}")
    return n


def _noisy_ba_graph(n_frames: int, seed: int = 0):
    """A camera-object graph at the smoke's size with seeded measurement
    noise, so that the optimum is neither the initial guess nor the truth."""
    import jax
    import jax.numpy as jnp

    from cube_slam_wu_tpu.core.cuboid import Cuboid
    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

    f32 = jnp.float32
    rng = np.random.default_rng(seed)
    tang = rng.normal(size=(n_frames, 6)) * 0.05
    Tcw = SE3.exp(jnp.asarray(tang, f32))
    odom = [SE3.identity((), f32)] + [
        Tcw[i].compose(Tcw[i - 1].inverse()) for i in range(1, n_frames)
    ]
    cube = Cuboid.from_minimal(
        jnp.asarray([0.5, 2.0, 0.3, 0, 0, 0.7, 0.4, 0.3, 0.3], f32)
    )
    meas = cube.transform_to(Tcw.inverse()).to_minimal()
    meas = meas + jnp.asarray(rng.normal(size=meas.shape) * 0.02, f32)
    init = tang + rng.normal(size=tang.shape) * 0.02
    return CameraObjectGraph.empty(n_frames, 1, f32)._replace(
        cam_Tcw=SE3.exp(jnp.asarray(init, f32)),
        cube=jax.tree.map(lambda x: x[None], cube),
        frame_mask=jnp.ones(n_frames, bool),
        cube_valid=jnp.ones(1, bool),
        odom=jax.tree.map(lambda *xs: jnp.stack(xs), *odom),
        odom_mask=jnp.arange(n_frames) > 0,
        cube_meas=jax.tree.map(lambda x: x[:, None], Cuboid.from_minimal(meas)),
        cube_meas_weight=jnp.full((n_frames, 1), 1.8, f32),
        cube_meas_mask=jnp.ones((n_frames, 1), bool),
    )


def _not_highest(lowered) -> tuple[int, int]:
    """(dots, dots not at HIGHEST precision) in a lowered computation."""
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", lowered.as_text())
    return len(dots), sum("HIGHEST" not in d for d in dots)


def _online_step_lowered(capacity: int):
    import jax.numpy as jnp

    from cube_slam_wu_tpu.slam import online
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

    f32 = jnp.float32
    step = online.make_online_step(online.TUM_FR3_K, np.eye(4), capacity, f32)
    state = online.OnlineState(
        CameraObjectGraph.empty(capacity, 1, f32),
        online.OnlineBook.empty(1, f32), None,
    )
    return step.lower(
        state, jnp.zeros(SIZE, jnp.uint8), jnp.zeros((1, 4), f32),
        jnp.ones(1, bool), jnp.asarray(1, jnp.int32),
    )


def _line_gap(a, b) -> float:
    """Largest endpoint difference (px) of two detector outputs with the
    same mask; inf if the masks differ."""
    (la, ma), (lb, mb) = a, b
    if not np.array_equal(ma, mb):
        return np.inf
    return float(np.abs(la[ma] - lb[mb]).max(initial=0.0))


def phase_reference(base: pathlib.Path, capacity: int, n_frames=REF_FRAMES):
    import jax

    from cube_slam_wu_tpu.ops.detect import detect_line_segments
    from cube_slam_wu_tpu.slam import ba
    from cube_slam_wu_tpu.slam.online import run_online_slam_fused
    from cube_slam_wu_tpu.utils import io as uio

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]

    # (a) the precision policy, read off the lowered programs: every f32
    # product of the BA and of the whole fused step is a HIGHEST dot
    graph = _noisy_ba_graph(capacity)
    opt = jax.jit(lambda g: ba.optimize(g, iterations=10))
    for name, lowered in (("BA", opt.lower(graph)),
                          ("fused step", _online_step_lowered(capacity))):
        n, bad = _not_highest(lowered)
        print(f"ref: {name}: {n} dots, {bad} below HIGHEST precision")
        if n == 0 or bad:
            _fail(f"{name}: {bad} of {n} dots below HIGHEST precision")

    # (b) the line detector per frame: its blur is integer arithmetic, so
    # the two backends find the same lines (the endpoints' least-squares
    # refit still sums floats in backend order)
    worst = 0.0
    for i in range(n_frames):
        g = uio.load_image_gray(uio.frame_image_path(base, i))
        g = np.asarray(g, np.float32)
        gpu_l, cpu_l = (
            jax.device_get(detect_line_segments(jax.device_put(g, d)))
            for d in (gpu, cpu)
        )
        gap = _line_gap(gpu_l, cpu_l)
        if not gap <= LINE_TOL:
            _fail(f"frame {i}: GPU {int(gpu_l[1].sum())} lines, CPU "
                  f"{int(cpu_l[1].sum())}, endpoint gap {gap:.3e} px")
        worst = max(worst, gap)
    print(f"ref: detector, {n_frames} frames: identical line sets, endpoints "
          f"within {worst:.3e} px (tol {LINE_TOL})")

    # (c) the f32 back-end on identical inputs: the BA must match the CPU
    def solve(dev):
        r = opt(jax.device_put(graph, dev))
        return np.asarray(r.cam_Tcw.trans), float(r.chi2)

    t_gpu, c_gpu = solve(gpu)
    with jax.default_device(cpu):
        t_cpu, c_cpu = solve(cpu)
    d_ba = np.abs(t_gpu - t_cpu).max()
    print(f"ref: BA {capacity} frames x 10 LM iterations, GPU vs CPU f32 "
          f"camera max diff {d_ba:.3e} (tol {POSE_TOL}); chi2 GPU {c_gpu:.6e} "
          f"CPU {c_cpu:.6e}")
    if not d_ba <= POSE_TOL:
        _fail(f"BA poses differ between GPU and CPU by {d_ba:.3e}")

    # (d) the whole fused step, at the main run's capacity (same shapes)
    def run():
        return run_online_slam_fused(
            str(base), n_frames=n_frames, capacity=capacity
        )

    gpu_a, gpu_b = run(), run()
    with jax.default_device(cpu):
        cpu_r = run()
    per_frame = np.abs(gpu_a.traj_Twc_xyzq - cpu_r.traj_Twc_xyzq).max(axis=1)
    d_ref = per_frame.max()
    d_run = np.abs(gpu_a.traj_Twc_xyzq - gpu_b.traj_Twc_xyzq).max()
    print(f"ref: fused step {n_frames} frames, GPU vs CPU f32 pose max diff "
          f"{d_ref:.3e} (tol {POSE_TOL}); cube_valid GPU "
          f"{gpu_a.cube_valid.tolist()} CPU {cpu_r.cube_valid.tolist()}")
    print(f"ref: GPU run-to-run pose max diff {d_run:.3e}")
    if not d_ref <= POSE_TOL:
        _fail(f"GPU vs CPU poses differ by {d_ref:.3e}; per frame "
              f"{np.array2string(per_frame[:n_frames], precision=3)}")
    if not np.array_equal(gpu_a.cube_valid, cpu_r.cube_valid):
        _fail("cube_valid differs between GPU and CPU")


def phase_edt(size=SIZE):
    import jax
    import jax.numpy as jnp
    import scipy.ndimage as ndi

    from cube_slam_wu_tpu.ops import image as image_ops

    rng = np.random.default_rng(0)
    edge = rng.random(size) < 0.01
    ours = np.asarray(jax.jit(image_ops.distance_transform)(jnp.asarray(edge)))
    d = np.abs(ours - ndi.distance_transform_edt(~edge)).max()
    print(f"edt: {size[0]}x{size[1]} vs scipy max abs diff {d:.3e} px "
          f"(tol {EDT_TOL})")
    if not d <= EDT_TOL:
        _fail(f"EDT differs from scipy by {d:.3e} px")


def main() -> None:
    info = phase_device()
    from cube_slam_wu_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        base = phase_inputs(root)
        n = phase_main(base, root / "out")
        phase_reference(base, capacity=n)
    phase_edt()
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
