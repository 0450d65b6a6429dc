"""Command-line entry points (the reference's ROS nodes, without ROS).

  python -m cube_slam_wu_tpu.cli offline --base <object_slam/data> --out out/
  python -m cube_slam_wu_tpu.cli online  --base <object_slam/data> --out out/
  python -m cube_slam_wu_tpu.cli detect-lines --image img.jpg --out out/
  python -m cube_slam_wu_tpu.cli detect-cuboid --image img.jpg --edges e.txt \
      --bbox x,y,w,h --out out/

Outputs follow the reference's artifact contract: TUM-format
output_cam_poses.txt / output_obj_poses.txt (main_obj.cpp:305-336),
saved_edges.txt (detect_lines.cpp:25-106), overlay images (PNG, written
without Pillow).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def _write_outputs(out_dir, result, truth):
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils import viz
    from cube_slam_wu_tpu.utils.metrics import ate_rmse, rpe_rmse

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    uio.write_tum_trajectory(
        out_dir / "output_cam_poses.txt", result.timestamps, result.traj_Twc_xyzq
    )
    obj_rows = (
        result.cube_history[:, 0, :]
        if result.cube_history is not None
        else result.cube_minimal[None]
    )
    np.savetxt(out_dir / "output_obj_poses.txt", obj_rows, fmt="%.6f")
    img = viz.trajectory_top_view(result.traj_Twc_xyzq[:, :3], truth[:, 1:4])
    uio.write_png(out_dir / "trajectory_top_view.png", img)
    ate = ate_rmse(result.traj_Twc_xyzq[:, :3], truth[:, 1:4])
    rpe_t, rpe_r = rpe_rmse(result.traj_Twc_xyzq, truth[:, 1:8])
    print(f"ATE RMSE vs truth: {ate:.4f} m")
    print(f"RPE RMSE (delta=1): {rpe_t:.4f} m / {rpe_r:.4f} deg")
    print(f"outputs written to {out_dir}")


def _write_point_cloud(out_dir, base, result, every: int):
    """Merged colored point cloud from the dataset's RGB-D pairs at the
    OPTIMIZED camera poses (rviz cloud topic analogue, main_obj.cpp:73-101;
    depth scaling + calib at main_obj.cpp:340-345)."""
    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils import viz

    import jax.numpy as jnp

    base = pathlib.Path(base)
    K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1.0]])
    all_xyz, all_rgb = [], []
    n = len(result.timestamps)
    for i in range(0, n, every):
        depth_path = base / "depth_imgs" / f"{i:04d}_depth_raw.png"
        rgb_path = uio.frame_image_path(base, i)
        if not depth_path.exists() or not rgb_path.exists():
            continue
        from PIL import Image

        depth = np.asarray(Image.open(depth_path))
        rgb = uio.load_image_rgb(rgb_path)
        T_wc = np.asarray(
            SE3.from_xyzq(jnp.asarray(result.traj_Twc_xyzq[i])).matrix()
        )
        xyz, cols = viz.depth_to_point_cloud(rgb, depth, K, T_wc)
        all_xyz.append(xyz)
        all_rgb.append(cols)
    if not all_xyz:
        print("point cloud skipped: no depth_imgs/ found")
        return
    viz.write_ply(
        pathlib.Path(out_dir) / "map_cloud.ply",
        np.concatenate(all_xyz),
        np.concatenate(all_rgb),
    )
    print(f"point cloud ({sum(len(a) for a in all_xyz)} pts) -> {out_dir}/map_cloud.ply")


def cmd_offline(args):
    from cube_slam_wu_tpu.slam.pipeline import run_offline_slam
    from cube_slam_wu_tpu.utils import io as uio

    if not pathlib.Path(args.base).is_dir():
        raise SystemExit(f"error: --base {args.base!r} is not a directory")
    result = run_offline_slam(args.base, iterations=args.iterations)
    truth = uio.read_number_txt(pathlib.Path(args.base) / "truth_cam_poses.txt")
    _write_outputs(args.out, result, truth)
    if args.save_cloud:
        _write_point_cloud(args.out, args.base, result, args.save_cloud)


def cmd_online(args):
    from cube_slam_wu_tpu.slam.pipeline import run_online_slam
    from cube_slam_wu_tpu.utils import io as uio

    if not pathlib.Path(args.base).is_dir():
        raise SystemExit(f"error: --base {args.base!r} is not a directory")
    if args.fused:
        # fused single-dispatch serving path (slam/online.py): 1 blocking
        # host sync per frame; same trajectory as the two-phase driver
        import jax.numpy as jnp
        import numpy as np

        from cube_slam_wu_tpu.slam.online import run_online_slam_fused
        from cube_slam_wu_tpu.slam.pipeline import SlamOutput

        if args.point_weight or args.checkpoint:
            raise SystemExit(
                "error: --fused supports the default online config "
                "(no --point-weight / --checkpoint yet); drop --fused for those"
            )
        fr = run_online_slam_fused(
            args.base,
            n_frames=args.frames,
            iterations=args.iterations,
            bbox_edge_weight=args.bbox_edge_weight,
            window=args.window if args.window and args.window > 0 else None,
        )
        truth = uio.read_number_txt(
            pathlib.Path(args.base) / "truth_cam_poses.txt"
        )
        n = len(fr.traj_Twc_xyzq)
        result = SlamOutput(
            traj_Twc_xyzq=fr.traj_Twc_xyzq,
            cube_minimal=fr.cubes_minimal[0],
            chi2=fr.chi2,
            timestamps=truth[:n, 0],
            cubes_minimal=fr.cubes_minimal,
            cube_valid=fr.cube_valid,
        )
        print(
            f"fused: {fr.syncs_per_frame:.0f} sync/frame, "
            f"{fr.bytes_up_per_frame / 1e6:.2f} MB up / "
            f"{fr.bytes_down_per_frame:.0f} B down; report {fr.report}"
        )
        _write_outputs(args.out, result, truth[:n])
        return
    result = run_online_slam(
        args.base,
        n_frames=args.frames,
        iterations=args.iterations,
        bbox_edge_weight=args.bbox_edge_weight,
        window=args.window if args.window and args.window > 0 else None,
        point_weight=args.point_weight,
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
    )
    truth = uio.read_number_txt(pathlib.Path(args.base) / "truth_cam_poses.txt")
    n = len(result.timestamps)
    _write_outputs(args.out, result, truth[:n])
    if args.save_cloud:
        _write_point_cloud(args.out, args.base, result, args.save_cloud)


def cmd_kitti(args):
    """Multi-object online SLAM over a KITTI-odometry-layout sequence
    (BASELINE config 5).  Writes a KITTI-format trajectory (12-number rows),
    a TUM-format one, per-object cuboids and, when ground truth is given, the
    ATE/RPE numbers."""
    import numpy as np

    from cube_slam_wu_tpu.slam.pipeline import run_kitti_slam
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils import kitti as ukitti
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    if not pathlib.Path(args.seq).is_dir():
        raise SystemExit(f"error: --seq {args.seq!r} is not a directory")
    if not pathlib.Path(args.detections).is_dir():
        raise SystemExit(
            f"error: --detections {args.detections!r} is not a directory"
        )
    result = run_kitti_slam(
        args.seq,
        args.detections,
        poses_path=args.poses,
        n_frames=args.frames,
        iterations=args.iterations,
        max_objects=args.max_objects,
        max_detections=args.max_detections,
        window=args.window if args.window and args.window > 0 else None,
        bbox_edge_weight=args.bbox_edge_weight,
        track_max_age=args.track_max_age if args.track_max_age > 0 else None,
        depth_gate_m=args.depth_gate if args.depth_gate > 0 else None,
        spawn_range_m=(
            "auto"
            if args.spawn_range < 0
            else (args.spawn_range if args.spawn_range > 0 else None)
        ),
        min_meas=args.min_meas,
        range_weight_m=args.range_weight if args.range_weight > 0 else None,
        pose_feedback=args.pose_feedback,
        point_weight=args.point_weight,
        n_points=args.n_points,
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpoint_every,
    )
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    uio.write_tum_trajectory(
        out_dir / "output_cam_poses.txt", result.timestamps, result.traj_Twc_xyzq
    )
    # KITTI 12-number rows in the cam-forward first-camera world
    from cube_slam_wu_tpu.core.se3 import SE3 as _SE3
    import jax.numpy as jnp

    Rinv = np.eye(4)
    Rinv[:3, :3] = ukitti.KITTI_TO_ZUP.T
    rows = []
    for xyzq in result.traj_Twc_xyzq:
        T = np.array(_SE3.from_xyzq(jnp.asarray(xyzq)).matrix())
        T[2, 3] -= ukitti.CAMERA_HEIGHT_M
        rows.append((Rinv @ T)[:3, :4].ravel())
    np.savetxt(out_dir / "trajectory_kitti.txt", np.asarray(rows), fmt="%.9e")
    np.savetxt(
        out_dir / "output_obj_poses.txt",
        result.cubes_minimal[np.asarray(result.cube_valid)],
        fmt="%.6f",
    )
    if result.frontend_report is not None:
        print("frontend:", result.frontend_report.summary())
    if args.poses:
        seq = ukitti.load_sequence(args.seq, args.poses)
        n = len(result.timestamps)
        truth_xyz = seq.poses_T_wc[:n, :3, 3]
        ate = ate_rmse(result.traj_Twc_xyzq[:, :3], truth_xyz)
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
    print(f"outputs written to {out_dir}")


def cmd_detect_lines(args):
    if not pathlib.Path(args.image).is_file():
        raise SystemExit(f"error: --image {args.image!r} not found")
    import jax.numpy as jnp

    from cube_slam_wu_tpu.ops.detect import (
        DetectConfig,
        detect_line_segments,
        detect_line_segments_recover,
    )
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils import viz

    gray = jnp.asarray(uio.load_image_gray(args.image))
    if args.short_recovery:
        lines, mask = detect_line_segments_recover(
            gray, DetectConfig(short_recovery=True)
        )
    else:
        lines, mask = detect_line_segments(gray)
    lines = np.asarray(lines)[np.asarray(mask)]
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savetxt(out_dir / "saved_edges.txt", lines, fmt="%.3f")
    rgb = uio.load_image_rgb(args.image)
    uio.write_png(out_dir / "saved_edges.png", viz.draw_lines_overlay(rgb, lines))
    print(f"{len(lines)} lines -> {out_dir}/saved_edges.txt|png")


def cmd_match_lines(args):
    """Two-image line matching demo (the reference's match_line_descrip
    usage, line_lbd_allclass.cpp:352-369): detect + LBD descriptors on both
    frames, Hamming-match the binarized codes, write a drawLineMatches-style
    side-by-side visualization."""
    for path in (args.image_a, args.image_b):
        if not pathlib.Path(path).is_file():
            raise SystemExit(f"error: image {path!r} not found")
    import jax.numpy as jnp

    from cube_slam_wu_tpu.ops.detect import detect_line_segments
    from cube_slam_wu_tpu.ops.lbd import (
        binarize_lbd,
        lbd_descriptors,
        match_lines_filtered,
    )
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils import viz

    ga = jnp.asarray(uio.load_image_gray(args.image_a), jnp.float32)
    gb = jnp.asarray(uio.load_image_gray(args.image_b), jnp.float32)
    la, ma = detect_line_segments(ga)
    lb, mb = detect_line_segments(gb)
    da, va = lbd_descriptors(ga, la, ma)
    db, vb = lbd_descriptors(gb, lb, mb)
    idx, dist, matched = match_lines_filtered(
        binarize_lbd(da), binarize_lbd(db), va & ma, vb & mb,
        max_dist=args.max_dist,
    )
    n = int(np.asarray(matched).sum())
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    img = viz.draw_line_matches(
        uio.load_image_rgb(args.image_a), np.asarray(la),
        uio.load_image_rgb(args.image_b), np.asarray(lb),
        np.asarray(idx), np.asarray(matched),
    )
    uio.write_png(out_dir / "line_matches.png", img)
    rows = np.column_stack(
        [
            np.nonzero(np.asarray(matched))[0],
            np.asarray(idx)[np.asarray(matched)],
            np.asarray(dist)[np.asarray(matched)],
        ]
    )
    np.savetxt(out_dir / "line_matches.txt", rows, fmt="%d")
    print(f"{n} matches -> {out_dir}/line_matches.png|txt")


def cmd_detect_cuboid(args):
    if not pathlib.Path(args.image).is_file():
        raise SystemExit(f"error: --image {args.image!r} not found")
    import jax
    import jax.numpy as jnp

    from cube_slam_wu_tpu.config import DEMO_DETECT_3D
    from cube_slam_wu_tpu.ops.detect import detect_line_segments
    from cube_slam_wu_tpu.ops.proposal import ProposalConfig, detect_cuboid_single
    from cube_slam_wu_tpu.utils import io as uio
    from cube_slam_wu_tpu.utils import viz

    gray = jnp.asarray(uio.load_image_gray(args.image))
    if args.edges:
        edges = uio.read_number_txt(args.edges)
        L = max(128, int(2 ** np.ceil(np.log2(len(edges) + 1))))
        lines = np.zeros((L, 4))
        lines[: len(edges)] = edges[:, :4]
        mask = np.zeros(L, bool)
        mask[: len(edges)] = True
        lines, mask = jnp.asarray(lines), jnp.asarray(mask)
    else:
        lines, mask = detect_line_segments(gray)
    cam = DEMO_DETECT_3D.camera
    if args.calib:
        fx, fy, cx, cy = _parse_floats(args.calib, 4, "calib")
    else:
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    K = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    T_wc = (
        jnp.asarray(np.loadtxt(args.pose))
        if args.pose
        else jnp.asarray(
            [
                [1, 0.0011, 0.0004, 0],
                [0, -0.3376, 0.9413, 0],
                [0.0011, -0.9413, -0.3376, 1.35],
                [0, 0, 0, 1.0],
            ]
        )
    )
    bbox = jnp.asarray(_parse_floats(args.bbox, 4, "bbox"))
    cfg = ProposalConfig(
        max_lines=int(lines.shape[0]),
        sample_cam_roll_pitch=args.sample_roll_pitch,
        sample_bbox_height=args.sample_height,
        nominal_skew_ratio=args.skew,
        max_cuboid_num=max(args.top_k, 1),
    )
    res = jax.tree.map(
        np.asarray,
        detect_cuboid_single(gray, K, T_wc, bbox, lines, mask, cfg),
    )
    if args.top_k > 1:
        for r in range(args.top_k):
            print(
                f"rank {r}: valid={bool(res.valid[r])} "
                f"pos={np.round(res.pos[r], 4)} "
                f"scale={np.round(res.scale[r], 4)} "
                f"rotY={float(res.rotY[r]):.4f} "
                f"err={float(res.normalized_error[r]):.4f}"
            )
        res = jax.tree.map(lambda a: a[0], res)  # winner drives the overlay
    print(f"valid: {bool(res.valid)}")
    print(f"pos:   {np.round(res.pos, 4)}")
    print(f"scale: {np.round(res.scale, 4)}")
    print(f"rotY:  {float(res.rotY):.4f}")
    print(f"config:{res.box_config_type}")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rgb = uio.load_image_rgb(args.image)
    img = viz.draw_cuboid(
        rgb,
        res.corners_2d,
        int(res.box_config_type[0]),
        int(res.box_config_type[1]),
    )
    uio.write_png(out_dir / "cuboid_proposal.png", img)
    print(f"overlay -> {out_dir}/cuboid_proposal.png")


def _parse_floats(text, n, name):
    parts = text.split(",")
    try:
        vals = [float(v) for v in parts]
    except ValueError:
        raise SystemExit(
            f"error: --{name} expects {n} comma-separated numbers, got {text!r}"
        )
    if len(vals) != n:
        raise SystemExit(
            f"error: --{name} expects {n} comma-separated numbers, got {len(vals)}"
        )
    return vals


def main(argv=None):
    from cube_slam_wu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="cube_slam_wu_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    po = sub.add_parser("offline", help="offline-mode SLAM over a dataset folder")
    po.add_argument("--base", required=True)
    po.add_argument("--out", default="out")
    po.add_argument("--iterations", type=int, default=5)
    po.add_argument(
        "--save-cloud",
        type=int,
        default=0,
        metavar="N",
        help="dump map_cloud.ply from every Nth RGB-D pair (0 = off)",
    )
    po.set_defaults(fn=cmd_offline)

    pn = sub.add_parser("online", help="full online mono SLAM")
    pn.add_argument("--base", required=True)
    pn.add_argument("--out", default="out")
    pn.add_argument("--frames", type=int, default=None)
    pn.add_argument("--iterations", type=int, default=5)
    pn.add_argument("--bbox-edge-weight", type=float, default=0.005,
                    help="2D bbox projection-edge weight (0 = reference-"
                         "parity: 3D cuboid edges only)")
    pn.add_argument("--window", type=int, default=0,
                    help="sliding BA window (0 = full-graph re-optimisation)")
    pn.add_argument("--point-weight", type=float, default=0.0,
                    help="point-landmark reprojection weight in the joint "
                         "windowed BA (0 = off; needs --window)")
    pn.add_argument("--checkpoint", default="",
                    help="front-end checkpoint npz: saved every "
                         "--checkpoint-every frames, resumed if it exists; "
                         "a completed one acts as a front-end cache for "
                         "backend-setting sweeps")
    pn.add_argument("--checkpoint-every", type=int, default=25)
    pn.add_argument(
        "--fused",
        action="store_true",
        help="fused single-dispatch serving path (slam/online.py): the "
             "whole per-frame step in one jitted call, 1 host sync/frame",
    )
    pn.add_argument(
        "--save-cloud",
        type=int,
        default=0,
        metavar="N",
        help="dump map_cloud.ply from every Nth RGB-D pair (0 = off)",
    )
    pn.set_defaults(fn=cmd_online)

    pk = sub.add_parser(
        "kitti", help="multi-object online SLAM over a KITTI-layout sequence"
    )
    pk.add_argument("--seq", required=True, help="sequence dir (image_0/, calib.txt)")
    pk.add_argument("--detections", required=True, help="per-frame yolo txt dir")
    pk.add_argument("--poses", default=None, help="KITTI ground-truth poses txt")
    pk.add_argument("--out", default="out")
    pk.add_argument("--frames", type=int, default=None)
    pk.add_argument("--iterations", type=int, default=5)
    pk.add_argument("--max-objects", type=int, default=8)
    pk.add_argument("--max-detections", type=int, default=4)
    pk.add_argument("--window", type=int, default=16,
                    help="sliding BA window (0 = full-graph re-optimisation)")
    pk.add_argument("--bbox-edge-weight", type=float, default=0.0,
                    help="2D bbox projection-edge weight")
    pk.add_argument("--track-max-age", type=int, default=12,
                    help="retire a track after this many frames without an "
                         "association (0 = never)")
    pk.add_argument("--depth-gate", type=float, default=2.5,
                    help="drop IoU matches whose camera-relative range jumps "
                         "more than this many metres (0 = off)")
    pk.add_argument("--spawn-range", type=float, default=-1.0,
                    help="do not spawn landmarks beyond this range in metres "
                         "(0 = off, negative = auto from intrinsics: the "
                         "range where 1 px of bbox error lifts to 0.6 m of "
                         "depth)")
    pk.add_argument("--min-meas", type=int, default=2,
                    help="report a landmark only after this many accepted "
                         "measurements")
    pk.add_argument("--range-weight", type=float, default=0.0,
                    help="scale measurement weight by (R/range)^2 beyond "
                         "this range R in metres (0 = off)")
    pk.add_argument("--pose-feedback", action="store_true",
                    help="interleave front/back-end: run each frame's "
                         "proposal grid at the tracker's predicted pose")
    pk.add_argument("--point-weight", type=float, default=0.0,
                    help="point-landmark reprojection weight in the joint "
                         "windowed BA (0 = off; needs --pose-feedback and a "
                         "window)")
    pk.add_argument("--n-points", type=int, default=96,
                    help="feature-track slots for --point-weight")
    pk.add_argument("--checkpoint", default="",
                    help="front-end checkpoint npz: saved every "
                         "--checkpoint-every frames, resumed if it exists")
    pk.add_argument("--checkpoint-every", type=int, default=25)
    pk.set_defaults(fn=cmd_kitti)

    pl = sub.add_parser("detect-lines", help="line detection on one image")
    pl.add_argument("--image", required=True)
    pl.add_argument("--out", default="out")
    pl.add_argument(
        "--short-recovery",
        action="store_true",
        help="additive short-segment recovery pass (15-40 px recall "
             "0.54 -> 0.75; ~2x detector cost)",
    )
    pl.set_defaults(fn=cmd_detect_lines)

    pm = sub.add_parser(
        "match-lines", help="detect + LBD-match lines across two images"
    )
    pm.add_argument("--image-a", required=True)
    pm.add_argument("--image-b", required=True)
    pm.add_argument("--max-dist", type=int, default=25)
    pm.add_argument("--out", default="out")
    pm.set_defaults(fn=cmd_match_lines)

    pc = sub.add_parser("detect-cuboid", help="single-image cuboid proposal")
    pc.add_argument("--image", required=True)
    pc.add_argument("--bbox", required=True, help="x,y,w,h")
    pc.add_argument("--edges", default=None, help="precomputed edges txt")
    pc.add_argument("--calib", default=None, help="fx,fy,cx,cy")
    pc.add_argument("--pose", default=None, help="4x4 T_wc txt")
    pc.add_argument("--skew", type=float, default=1.0)
    pc.add_argument("--sample-roll-pitch", action="store_true")
    pc.add_argument("--top-k", type=int, default=1,
                    help="return the K best-ranked proposals "
                         "(max_cuboid_num ObjectSet semantics)")
    pc.add_argument("--sample-height", action="store_true",
                    help="sample 3 bbox-height expansions (whether_sample_bbox_height)")
    pc.add_argument("--out", default="out")
    pc.set_defaults(fn=cmd_detect_cuboid)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
