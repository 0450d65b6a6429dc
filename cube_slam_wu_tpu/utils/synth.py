"""Synthetic cuboid-world sequence generator (KITTI-format).

The reference evaluates multi-object SLAM on KITTI (README.md:3-4) but
bundles neither KITTI data nor a generator; its bundled TUM subset is
single-object.  This module renders ground-truth sequences of flat-shaded
cuboids on a ground plane — enough structure for the full online pipeline
(Canny/line detection -> VP-based proposals -> association -> BA) to run
end-to-end with known ground truth, at any length, and writes them in the
KITTI odometry layout (image_0/NNNNNN.pgm, calib.txt, times.txt, poses.txt
+ per-frame YOLO-style detection txts, the reference's
filter_2d_obj_txts contract, main_obj.cpp:616-620).

Conventions match utils.kitti: camera x right / y down / z forward, world
z-up, camera CAMERA_HEIGHT_M above ground.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np

from cube_slam_wu_tpu.utils.kitti import CAMERA_HEIGHT_M, KITTI_TO_ZUP

# flat-shade gray levels by face orientation (world axes); distinct levels
# give each cuboid edge a clean intensity step for Canny / line detection
_FACE_SHADE = {"top": 230, "front": 120, "back": 90, "left": 160, "right": 60}
_SKY = 200
_GROUND_NEAR = 170
_GROUND_FAR = 185


class SynthObject(NamedTuple):
    pos: np.ndarray  # (3,) world, z = half-height (sits on ground)
    yaw: float
    scale: np.ndarray  # (3,) half-extents (l, w, h)


class SynthSequence(NamedTuple):
    K: np.ndarray
    T_wc: np.ndarray  # (N, 4, 4) camera-to-world, z-up world
    images: list  # N arrays (H, W) uint8
    detections: list  # N arrays (D_i, 5) [x y w h conf] (1-based x/y, matlab
    # convention like the reference's txts, main_obj.cpp:620 subtracts 1)
    objects: list  # list[SynthObject] ground truth
    timestamps: np.ndarray


def _corners_world(obj: SynthObject) -> np.ndarray:
    """(8, 3) corners: bottom 4 then top 4, counter-clockwise."""
    sx, sy, sz = obj.scale
    c, s = np.cos(obj.yaw), np.sin(obj.yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    local = np.array(
        [
            [dx, dy, dz]
            for dz in (-sz, sz)
            for dx, dy in ((sx, sy), (-sx, sy), (-sx, -sy), (sx, -sy))
        ]
    )
    return obj.pos[None, :] + local @ R.T


# faces as corner index quads + outward normal in object frame
_FACES = [
    ((4, 5, 6, 7), np.array([0, 0, 1.0]), "top"),
    ((0, 1, 5, 4), np.array([0, 1.0, 0]), "front"),
    ((2, 3, 7, 6), np.array([0, -1.0, 0]), "back"),
    ((1, 2, 6, 5), np.array([-1.0, 0, 0]), "left"),
    ((3, 0, 4, 7), np.array([1.0, 0, 0]), "right"),
]


def camera_pose(t: float, speed: float = 1.0, curve: float = 0.0) -> np.ndarray:
    """T_wc at arc-length time t: forward along +y with optional curvature
    (turn rate rad/s), camera level, CAMERA_HEIGHT_M above ground."""
    if abs(curve) > 1e-9:
        r = speed / curve
        heading = curve * t
        x = r * (1 - np.cos(heading))
        y = r * np.sin(heading)
    else:
        heading = 0.0
        x, y = 0.0, speed * t
    hdg = np.array([-np.sin(heading), np.cos(heading), 0.0])
    right = np.array([np.cos(heading), np.sin(heading), 0.0])
    up = np.array([0.0, 0.0, 1.0])
    T = np.eye(4)
    # camera axes in world: x=right, y=down, z=forward(heading)
    T[:3, 0], T[:3, 1], T[:3, 2] = right, -up, hdg
    T[:3, 3] = np.array([x, y, CAMERA_HEIGHT_M])
    return T


def _ground_speckle(T_wc, K, size, amplitude, cell=0.25, max_range=30.0):
    """World-anchored procedural ground texture: each ground pixel's ray is
    intersected with z = 0 and the hit cell hashed to a gray offset — the
    pattern is attached to the WORLD, so it is view-consistent across frames
    (a screen-space noise would be untrackable).  Amplitude fades with range
    so sub-pixel far cells do not alias frame to frame.  Returns (H, W)
    additive offsets (zero above the horizon / beyond range)."""
    H, W = size
    R_wc = T_wc[:3, :3]
    C = T_wc[:3, 3]
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    rays_c = np.stack([us, vs, np.ones_like(us)], axis=-1) @ np.linalg.inv(K).T
    d_w = rays_c @ R_wc.T  # (H, W, 3)
    dz = d_w[..., 2]
    with np.errstate(all="ignore"):
        t = -C[2] / dz
    hit = (dz < -1e-6) & (t > 0) & (t < max_range / np.maximum(1e-6, np.linalg.norm(d_w, axis=-1)))
    Xw = C[None, None, :2] + t[..., None] * d_w[..., :2]
    ix = np.floor(Xw[..., 0] / cell).astype(np.int64)
    iy = np.floor(Xw[..., 1] / cell).astype(np.int64)
    h = ((ix * 73856093) ^ (iy * 19349663)) & 0xFFFF
    val = (h / 65535.0) * 2.0 - 1.0
    rng_m = t * np.linalg.norm(d_w, axis=-1)
    fade = np.clip(1.0 - rng_m / max_range, 0.0, 1.0)
    return np.where(hit, amplitude * val * fade, 0.0)


def render_frame(
    T_wc: np.ndarray, objects, K: np.ndarray, size=(480, 640),
    ground_texture: float = 0.0,
) -> np.ndarray:
    """Flat-shaded render of the cuboid set: painter's algorithm over
    back-face-culled faces.  Returns (H, W) uint8.

    `ground_texture` > 0 adds world-anchored speckle to the ground plane
    (gray-level amplitude): real roads have trackable micro-texture, and a
    perfectly flat-shaded ground starves any point-feature front-end — set
    it when exercising the point-landmark pipeline."""
    H, W = size
    img = np.full((H, W), _SKY, np.float64)
    # ground: rows below the horizon get a gentle depth gradient
    R_cw = T_wc[:3, :3].T
    t_c = -R_cw @ T_wc[:3, 3]
    fy, cy = K[1, 1], K[1, 2]
    rows = np.arange(H, dtype=np.float64)
    # level camera: the ground plane's vanishing line sits at the principal
    # row, so everything below cy is ground
    del fy
    horizon = cy
    ground = rows[:, None] >= horizon
    frac = np.clip((rows[:, None] - horizon) / max(H - horizon, 1.0), 0, 1)
    img = np.where(ground, _GROUND_FAR + (_GROUND_NEAR - _GROUND_FAR) * frac, img)
    if ground_texture > 0.0:
        img = img + _ground_speckle(T_wc, K, size, ground_texture)

    faces = []
    for obj in objects:
        cw = _corners_world(obj)
        cc = cw @ R_cw.T + t_c[None, :]
        if np.any(cc[:, 2] < 0.3):
            continue  # behind / too close: skip the whole object
        uv = (cc @ K.T)
        uv = uv[:, :2] / uv[:, 2:3]
        c, s = np.cos(obj.yaw), np.sin(obj.yaw)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        for quad, n_local, name in _FACES:
            n_world = Rz @ n_local
            n_cam = R_cw @ n_world
            center_cam = cc[list(quad)].mean(axis=0)
            if np.dot(n_cam, center_cam) >= 0:
                continue  # back-face
            depth = center_cam[2]
            faces.append((depth, uv[list(quad)], _FACE_SHADE[name]))
    faces.sort(key=lambda f: -f[0])

    ys = np.arange(H) + 0.5
    xs = np.arange(W) + 0.5
    for _, quad, shade in faces:
        x0 = max(int(np.floor(quad[:, 0].min())), 0)
        x1 = min(int(np.ceil(quad[:, 0].max())) + 1, W)
        y0 = max(int(np.floor(quad[:, 1].min())), 0)
        y1 = min(int(np.ceil(quad[:, 1].max())) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        gx = xs[x0:x1][None, :]
        gy = ys[y0:y1][:, None]
        # winding-agnostic convex test: inside iff all edge cross-products
        # share a sign (projected quads can wind either way)
        pos = np.ones((y1 - y0, x1 - x0), bool)
        neg = np.ones((y1 - y0, x1 - x0), bool)
        for k in range(4):
            ax, ay = quad[k]
            bx, by = quad[(k + 1) % 4]
            cross = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
            pos &= cross >= 0
            neg &= cross <= 0
        inside = pos | neg
        patch = img[y0:y1, x0:x1]
        img[y0:y1, x0:x1] = np.where(inside, float(shade), patch)
    return np.clip(img, 0, 255).astype(np.uint8)


def detect_objects(
    T_wc: np.ndarray,
    objects,
    K: np.ndarray,
    size=(480, 640),
    noise_px: float = 1.0,
    dropout: float = 0.0,
    min_height_px: float = 25.0,
    rng=None,
) -> np.ndarray:
    """Ground-truth 2D detections: projected-corner bboxes with pixel noise
    and optional dropout.  Rows [x y w h conf], 1-based coords like the
    reference's filter_2d_obj_txts (main_obj.cpp:620)."""
    rng = rng or np.random.default_rng(0)
    H, W = size
    R_cw = T_wc[:3, :3].T
    t_c = -R_cw @ T_wc[:3, 3]
    rows = []
    for obj in objects:
        cc = _corners_world(obj) @ R_cw.T + t_c[None, :]
        if np.any(cc[:, 2] < 0.3):
            continue
        uv = cc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        x0, y0 = uv.min(axis=0)
        x1, y1 = uv.max(axis=0)
        # only fully-visible objects: a truncated bbox misstates the object
        # extent and breaks single-view depth (the reference consumes
        # pre-FILTERED yolo boxes, "cleaned yolo", main_obj.cpp:614)
        if x0 < 2 or y0 < 2 or x1 > W - 3 or y1 > H - 3:
            continue
        if (x1 - x0) < 10 or (y1 - y0) < min_height_px:
            continue
        if rng.random() < dropout:
            continue
        jit = rng.normal(0, noise_px, 4)
        x0, y0, x1, y1 = x0 + jit[0], y0 + jit[1], x1 + jit[2], y1 + jit[3]
        x0, x1 = np.clip([x0, x1], 0, W - 1)
        y0, y1 = np.clip([y0, y1], 0, H - 1)
        if x1 <= x0 + 5 or y1 <= y0 + 5:
            continue
        rows.append([x0 + 1, y0 + 1, x1 - x0, y1 - y0, 0.9])
    return np.asarray(rows).reshape(-1, 5)


def make_sequence(
    n_frames: int = 60,
    n_objects: int = 4,
    size=(480, 640),
    speed: float = 0.8,
    curve: float = 0.0,
    dt: float = 0.1,
    noise_px: float = 1.0,
    dropout: float = 0.0,
    seed: int = 0,
    objects: list | None = None,
    ground_texture: float = 0.0,
    K: np.ndarray | None = None,
) -> SynthSequence:
    """Generate a full synthetic sequence: objects scattered ahead of the
    trajectory on both road sides (or an explicit `objects` list), camera
    driving forward.  `K` defaults to a 0.75·W focal length; pass the
    intrinsics the consuming driver assumes (e.g. the TUM fr3 camera of
    slam.online.TUM_FR3_K) so that ATE against the rendered truth means
    something."""
    rng = np.random.default_rng(seed)
    H, W = size
    if K is None:
        K = np.array(
            [[0.75 * W, 0, W / 2.0], [0, 0.75 * W, H / 2.0 - 0.05 * H],
             [0, 0, 1.0]]
        )
    K = np.asarray(K, np.float64)
    total_dist = speed * dt * n_frames
    if objects is not None:
        T_wc = np.stack(
            [camera_pose(i * dt, speed, curve) for i in range(n_frames)]
        )
        images = [
            render_frame(T, objects, K, size, ground_texture=ground_texture)
            for T in T_wc
        ]
        detections = [
            detect_objects(
                T, objects, K, size, noise_px=noise_px, dropout=dropout, rng=rng
            )
            for T in T_wc
        ]
        timestamps = np.arange(n_frames) * dt
        return SynthSequence(K, T_wc, images, detections, list(objects), timestamps)
    objects = []
    for i in range(n_objects):
        side = -1.0 if i % 2 == 0 else 1.0
        y = 5.0 + (total_dist + 7.0) * (i + 0.5) / n_objects
        x = side * rng.uniform(1.2, 2.2)
        scale = np.array(
            [rng.uniform(0.5, 1.1), rng.uniform(0.35, 0.6), rng.uniform(0.4, 0.8)]
        )
        yaw = rng.uniform(-0.4, 0.4) + (0.0 if i % 2 else np.pi / 2)
        objects.append(
            SynthObject(np.array([x, y, scale[2]]), float(yaw), scale)
        )

    T_wc = np.stack([camera_pose(i * dt, speed, curve) for i in range(n_frames)])
    images = [
        render_frame(T, objects, K, size, ground_texture=ground_texture)
        for T in T_wc
    ]
    detections = [
        detect_objects(
            T, objects, K, size, noise_px=noise_px, dropout=dropout, rng=rng
        )
        for T in T_wc
    ]
    timestamps = np.arange(n_frames) * dt
    return SynthSequence(K, T_wc, images, detections, objects, timestamps)


def write_kitti_sequence(seq: SynthSequence, out_dir, detections_subdir="detections"):
    """Write the sequence in KITTI odometry layout (consumable by
    utils.kitti.load_sequence + the kitti CLI driver; images as PGM).
    Returns (seq_dir, detections_dir, poses_path)."""
    from cube_slam_wu_tpu.utils.io import write_pnm

    out = pathlib.Path(out_dir)
    img_dir = out / "image_0"
    det_dir = out / detections_subdir
    img_dir.mkdir(parents=True, exist_ok=True)
    det_dir.mkdir(parents=True, exist_ok=True)

    K = seq.K
    p0 = np.zeros((3, 4))
    p0[:, :3] = K
    with open(out / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(f"{v:.6e}" for v in p0.ravel()) + "\n")
    np.savetxt(out / "times.txt", seq.timestamps, fmt="%.6f")

    # z-up T_wc -> KITTI convention (world = first-camera frame, cam-forward):
    # invert utils.kitti.parse_poses (T_zup = R @ T_kitti; z += height)
    Rinv = np.eye(4)
    Rinv[:3, :3] = KITTI_TO_ZUP.T
    rows = []
    for T in seq.T_wc:
        Tk = T.copy()
        Tk[2, 3] -= CAMERA_HEIGHT_M
        Tk = Rinv @ Tk
        rows.append(Tk[:3, :4].ravel())
    poses_path = out / "poses.txt"
    np.savetxt(poses_path, np.asarray(rows), fmt="%.9e")

    for i, (img, det) in enumerate(zip(seq.images, seq.detections)):
        write_pnm(img_dir / f"{i:06d}.pgm", img)
        np.savetxt(det_dir / f"{i:06d}.txt", det, fmt="%.3f")
    return out, det_dir, poses_path


def write_tum_sequence(seq: SynthSequence, out_dir):
    """Write the sequence in the reference's object_slam/data layout
    (raw_imgs/%04d_rgb_raw.pgm, filter_2d_obj_txts/%04d_yolo2_0.15.txt
    rows [x y w h conf], truth_cam_poses.txt TUM rows) — consumable by
    pipeline.run_online_slam and online.run_online_slam_fused.  Returns
    the base dir."""
    import jax.numpy as jnp

    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.utils.io import write_pnm

    out = pathlib.Path(out_dir)
    (out / "raw_imgs").mkdir(parents=True, exist_ok=True)
    (out / "filter_2d_obj_txts").mkdir(parents=True, exist_ok=True)
    rows = []
    for i, T in enumerate(seq.T_wc):
        xyzq = np.asarray(SE3.from_matrix(jnp.asarray(T)).to_xyzq())
        rows.append([seq.timestamps[i], *xyzq])
    np.savetxt(out / "truth_cam_poses.txt", np.asarray(rows), fmt="%.9f")
    for i, (img, det) in enumerate(zip(seq.images, seq.detections)):
        write_pnm(out / "raw_imgs" / f"{i:04d}_rgb_raw.pgm", img)
        np.savetxt(
            out / "filter_2d_obj_txts" / f"{i:04d}_yolo2_0.15.txt",
            det,
            fmt="%.3f",
        )
    return out


def fr3_one_object_scene(out_dir, n_frames: int = 58, size=(480, 640), seed=0):
    """Render the one-object TUM fr3 scene and write it in the TUM layout.

    One box-sized object 7 m ahead, slightly right; the camera (1.65 m up,
    level) drives towards it at 0.3 m/s, keeping it fully in view.  Rendered
    with the fr3 intrinsics the fused driver assumes (slam.online
    .TUM_FR3_K); 58 frames is the length of the reference's fr3 sequence.
    Returns (base dir, SynthSequence)."""
    from cube_slam_wu_tpu.slam.online import TUM_FR3_K

    obj = SynthObject(
        pos=np.array([0.8, 7.0, 0.45]), yaw=0.6,
        scale=np.array([0.7, 0.5, 0.45]),
    )
    seq = make_sequence(
        n_frames=n_frames, size=size, speed=0.3, noise_px=0.5, seed=seed,
        objects=[obj], K=TUM_FR3_K,
    )
    return write_tum_sequence(seq, pathlib.Path(out_dir) / "tum"), seq


def proposal_demo_inputs(dtype, img_hw=(192, 256), n_lines=16):
    """Rendered cuboid scene + ground-truth edge segments packaged as
    `detect_cuboid_single` inputs (gray, K, T_wc, bbox, lines, mask).

    Used by the multi-chip dryrun and the multi-process validation worker:
    the proposal grid produces a VALID winner on this scene (random noise
    yields none, which would make sharded==single checks vacuous)."""
    import jax.numpy as jnp

    H, W = img_hw
    obj = SynthObject(
        np.array([0.3, 3.8, 0.42]), 0.45, np.array([0.55, 0.4, 0.42])
    )
    T = camera_pose(0.0)
    K_np = np.array(
        [[0.75 * W, 0, W / 2.0], [0, 0.75 * W, H / 2.0 - 0.05 * H], [0, 0, 1.0]]
    )
    img = render_frame(T, [obj], K_np, img_hw)
    det = detect_objects(T, [obj], K_np, img_hw, noise_px=0.0, min_height_px=10)
    assert len(det) == 1, "synth object must be fully visible"
    cw = _corners_world(obj)
    R_cw = T[:3, :3].T
    cc = cw @ R_cw.T + (-R_cw @ T[:3, 3])[None, :]
    uv = cc @ K_np.T
    uv = uv[:, :2] / uv[:, 2:3]
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    lines = np.zeros((n_lines, 4))
    for k, (a, b) in enumerate(edges):
        lines[k] = [*uv[a], *uv[b]]
    mask = np.zeros(n_lines, bool)
    mask[: len(edges)] = True
    bbox = np.array([det[0, 0] - 1.0, det[0, 1] - 1.0, det[0, 2], det[0, 3]])
    return (
        jnp.asarray(img.astype(np.float64), dtype),
        jnp.asarray(K_np, dtype),
        jnp.asarray(T, dtype),
        jnp.asarray(bbox, dtype),
        jnp.asarray(lines, dtype),
        jnp.asarray(mask),
    )
