"""Multi-process / multi-host execution (jax.distributed over DCN).

The reference is a single C++ process with no distributed compute at all
(SURVEY.md section 2.9 / 5.8 — its ROS pub/sub is viz-only,
object_slam/src/main_obj.cpp:205-222).  The scale-out design is:

- `jax.distributed.initialize` forms one global runtime from N processes
  (one per host); every process sees the GLOBAL device list and builds the
  same `Mesh` over it;
- the shard_map programs in this package (parallel/sharded_ba.py factor
  reduction, dp detection batches) are written against a mesh axis, not a
  device count — they run unchanged on a multi-process mesh, with the psum
  /all_gather collectives riding the device interconnect within a host
  and the network across hosts;
- inputs become global arrays via `jax.make_array_from_callback`: each
  process materialises only the shards it owns (replicated state:
  everyone owns a copy).

This module provides the initialisation + global-array helpers, a
validation worker (`worker_main`) that runs the dp-sharded proposal batch
and the factor-sharded BA across the process boundary and asserts equality
with a purely-local single-process run, and `launch()`, which spawns N OS
processes on the CPU backend (gloo collectives) so the multi-process path
is testable on one machine without a pod — the same recipe
tests/test_multihost.py and the driver dryrun use.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np


def initialize(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Join the global distributed runtime (idempotent per process)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "kf"):
    """One-axis mesh over ALL global devices (every process must build the
    identical mesh: jax.devices() is globally consistent after initialize)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def make_global(value: np.ndarray, mesh, spec):
    """Turn a host-local ndarray (same on every process, by construction)
    into a global jax.Array with the given PartitionSpec; each process
    materialises only its addressable shards."""
    import jax
    from jax.sharding import NamedSharding

    value = np.asarray(value)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        value.shape, sharding, lambda idx: value[idx]
    )


def replicate_tree(tree, mesh):
    """Fully-replicated global placement of a pytree of host ndarrays."""
    import jax
    from jax.sharding import PartitionSpec as P

    return jax.tree.map(
        lambda a: make_global(np.asarray(a), mesh, P()), tree
    )


def allgather(x):
    """Gather a (possibly non-addressable) global array to every host."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


# ---------------------------------------------------------------------------
# validation worker: dp proposal + factor-sharded BA across processes
# ---------------------------------------------------------------------------


def _build_ba_graph(F: int, dtype):
    """Tiny multi-object graph with a known-good structure (mirrors the
    dryrun's BA block in __graft_entry__.py)."""
    import jax
    import jax.numpy as jnp

    from cube_slam_wu_tpu.core.cuboid import Cuboid
    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

    O = 2
    rng = np.random.default_rng(1)
    graph = CameraObjectGraph.empty(F, O, dtype)
    tang = jnp.asarray(rng.normal(size=(F, 6)) * 0.05, dtype)
    Tcw = SE3.exp(tang)
    odom_list = [SE3.identity((), dtype)]
    for i in range(1, F):
        odom_list.append(Tcw[i].compose(Tcw[i - 1].inverse()))
    odom = jax.tree.map(lambda *xs: jnp.stack(xs), *odom_list)
    cubes = Cuboid.from_minimal(
        jnp.asarray(
            [
                [0.5, 2.0, 0.3, 0, 0, 0.7, 0.4, 0.3, 0.3],
                [-0.6, 2.5, 0.25, 0, 0, -0.4, 0.3, 0.25, 0.25],
            ],
            dtype,
        )
    )
    Tcw_b = SE3(
        jnp.broadcast_to(Tcw.quat[:, None, :], (F, O, 4)),
        jnp.broadcast_to(Tcw.trans[:, None, :], (F, O, 3)),
    )
    cube_b = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (F,) + x.shape), cubes
    )
    meas_b = cube_b.transform_to(Tcw_b.inverse())
    return graph._replace(
        cam_Tcw=SE3.exp(tang + 0.01),
        cube=cubes,
        frame_mask=jnp.ones(F, bool),
        cube_valid=jnp.ones(O, bool),
        odom=odom,
        odom_mask=jnp.arange(F) > 0,
        cube_meas=meas_b,
        cube_meas_weight=jnp.full((F, O), 1.8, dtype),
        cube_meas_mask=jnp.ones((F, O), bool),
    )


def worker_main(argv=None) -> None:
    """Entry for one process of the multi-process validation run.

    Asserts, across a REAL process boundary:
    1. dp-sharded proposal batch == this process's own local (single-device)
       run of the same batch;
    2. factor-sharded BA (psum Hessian reduction over gloo/DCN) == local
       single-process slam.ba.optimize.
    """
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    # fault-injection hook for the launch() liveness test: the named worker
    # dies BEFORE joining the distributed runtime, so the remaining workers
    # block in initialize — launch() must detect the death and fail fast
    # instead of hanging until the gloo timeout.
    if os.environ.get("CUBESLAM_MH_DIE_BEFORE_INIT") == str(args.process_id):
        print(f"[multihost p{args.process_id}] injected pre-init death", flush=True)
        sys.exit(3)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    initialize(args.coordinator, args.num_processes, args.process_id)

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cube_slam_wu_tpu.ops.proposal import (
        ProposalConfig,
        detect_cuboid_single,
    )
    from cube_slam_wu_tpu.parallel import sharded_ba
    from cube_slam_wu_tpu.slam import ba as local_ba
    from cube_slam_wu_tpu.utils import synth

    dtype = jnp.float64
    mesh = global_mesh("kf")
    n_dev = len(jax.devices())
    assert n_dev >= args.num_processes * 2, (
        "expected multiple local devices per process"
    )

    # ---- 1. dp-sharded proposal batch across the process boundary ----------
    cfg = ProposalConfig(max_lines=16, max_top_samples=8)
    gray, K, T_wc, bbox, lines, mask = synth.proposal_demo_inputs(
        dtype, img_hw=(192, 256), n_lines=16
    )
    B = n_dev
    shift = np.arange(B)[:, None] * np.array([1.0, 0.5, 0.0, 0.0])
    bbox_b = np.asarray(bbox)[None] + shift
    gray_b = np.broadcast_to(np.asarray(gray), (B,) + gray.shape)
    lines_b = np.broadcast_to(np.asarray(lines), (B,) + lines.shape)
    mask_b = np.broadcast_to(np.asarray(mask), (B,) + mask.shape)

    def proposals_block(gray_b, bbox_b, lines_b, mask_b):
        return jax.vmap(
            lambda g, b, l, m: detect_cuboid_single(g, K, T_wc, b, l, m, cfg)
        )(gray_b, bbox_b, lines_b, mask_b)

    sharded = jax.jit(
        jax.shard_map(
            proposals_block,
            mesh=mesh,
            in_specs=(P("kf"), P("kf"), P("kf"), P("kf")),
            out_specs=P("kf"),
        )
    )
    gs = make_global(gray_b, mesh, P("kf"))
    bs = make_global(bbox_b, mesh, P("kf"))
    ls = make_global(lines_b, mesh, P("kf"))
    ms = make_global(mask_b, mesh, P("kf"))
    res = sharded(gs, bs, ls, ms)
    pos = allgather(res.pos)
    valid = allgather(res.valid)

    # local single-process reference (this process's own devices only)
    ref = jax.vmap(
        lambda b: detect_cuboid_single(
            jnp.asarray(gray), K, T_wc, jnp.asarray(b, dtype),
            jnp.asarray(lines), jnp.asarray(mask), cfg,
        )
    )(jnp.asarray(bbox_b, dtype))
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    both = valid & np.asarray(ref.valid)
    assert both.sum() >= B - 1, f"expected valid proposals, got {both.sum()}"
    np.testing.assert_allclose(
        pos[both], np.asarray(ref.pos)[both], rtol=1e-8, atol=1e-8
    )

    # ---- 2. factor-sharded BA with cross-process psum reduction ------------
    F = 2 * n_dev
    graph = _build_ba_graph(F, dtype)
    graph_host = jax.tree.map(np.asarray, graph)
    graph_g = jax.tree.map(
        lambda a: make_global(a, mesh, P()), graph_host
    )
    optimize = sharded_ba.make_sharded_optimize(mesh, axis="kf", iterations=3)
    out = optimize(graph_g)
    chi2 = float(allgather(out.chi2))
    trans = allgather(out.cam_Tcw.trans)

    ref_ba = local_ba.optimize(graph, iterations=3)
    chi2_ref = float(ref_ba.chi2)
    np.testing.assert_allclose(chi2, chi2_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        trans, np.asarray(ref_ba.cam_Tcw.trans), rtol=1e-9, atol=1e-10
    )

    with open(args.out, "w") as f:
        f.write(
            f"OK p{args.process_id}/{args.num_processes} "
            f"devices={n_dev} proposals_valid={int(both.sum())}/{B} "
            f"ba_chi2={chi2:.6e} (local {chi2_ref:.6e})\n"
        )
    print(
        f"[multihost p{args.process_id}] OK: {n_dev} global devices, "
        f"dp proposals == local, sharded BA chi2 {chi2:.3e} == local",
        flush=True,
    )


def _free_port() -> int:
    """Ask the OS for a currently-free TCP port (bind to 0, read it back).
    A stale worker or TIME_WAIT on a fixed port would make
    jax.distributed.initialize hang until its timeout instead of failing
    fast; a fresh ephemeral port per launch avoids the collision class."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    num_processes: int = 2,
    local_devices: int = 4,
    out_dir: str | None = None,
    port: int | None = None,
    timeout_s: int = 900,
    fail_fast_grace_s: float = 10.0,
) -> list[str]:
    """Spawn `num_processes` OS processes on the CPU backend, each with
    `local_devices` virtual devices, run `worker_main`, and return the
    per-process result lines.  Raises on any worker failure.  The
    coordinator port is picked fresh from the OS by default; pass `port`
    only to pin it explicitly.

    Liveness supervision: workers are POLLED, not joined sequentially — if
    any worker dies while others are still running (e.g. one crashed before
    `jax.distributed.initialize`, leaving the rest blocked on the
    coordinator barrier), the survivors are killed after `fail_fast_grace_s`
    and a RuntimeError naming the dead worker is raised in seconds instead
    of hanging until the distributed-runtime timeout
    (tests/test_multihost.py::test_worker_death_fails_fast)."""
    import tempfile
    import time

    port = port if port is not None else _free_port()
    out_dir = out_dir or tempfile.mkdtemp(prefix="cubeslam_mh_")
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}"
    )
    # keep worker compilation independent of any parent-process cache state
    env_base.pop("JAX_COMPILATION_CACHE_DIR", None)

    procs = []
    outs = []
    log_files = []
    log_paths = []
    for pid in range(num_processes):
        out_path = os.path.join(out_dir, f"worker_{pid}.txt")
        log_path = os.path.join(out_dir, f"worker_{pid}.log")
        outs.append(out_path)
        log_paths.append(log_path)
        cmd = [
            sys.executable,
            "-m",
            "cube_slam_wu_tpu.parallel.multihost",
            "--coordinator",
            f"localhost:{port}",
            "--num-processes",
            str(num_processes),
            "--process-id",
            str(pid),
            "--out",
            out_path,
        ]
        lf = open(log_path, "w")
        log_files.append(lf)
        procs.append(
            subprocess.Popen(cmd, env=env_base, stdout=lf, stderr=lf)
        )

    def read_log(pid):
        try:
            if not log_files[pid].closed:
                log_files[pid].flush()
            with open(log_paths[pid]) as f:
                return f.read()[-4000:]
        except OSError:
            return "<no log>"

    def kill_all():
        for q in procs:
            if q.poll() is None:
                q.kill()
        for q in procs:
            try:
                q.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    try:
        deadline = time.monotonic() + timeout_s
        first_death = None  # (pid, rc, time)
        while True:
            running = [pr.poll() is None for pr in procs]
            failed = [
                pid
                for pid, pr in enumerate(procs)
                if pr.poll() is not None and pr.returncode != 0
            ]
            if failed and first_death is None:
                first_death = (failed[0], procs[failed[0]].returncode,
                               time.monotonic())
            if not any(running):
                break
            if first_death is not None and (
                time.monotonic() - first_death[2] > fail_fast_grace_s
            ):
                pid, rc, _ = first_death
                kill_all()
                raise RuntimeError(
                    f"multihost worker {pid} died (rc={rc}) while "
                    f"{sum(running)} worker(s) were still running; "
                    f"killed survivors.  Worker {pid} log:\n{read_log(pid)}"
                )
            if time.monotonic() > deadline:
                kill_all()
                raise TimeoutError(
                    f"multihost launch exceeded {timeout_s}s; killed all "
                    f"workers.  Worker 0 log:\n{read_log(0)}"
                )
            time.sleep(0.25)
    finally:
        for lf in log_files:
            lf.close()

    results = []
    for pid, (pr, out_path) in enumerate(zip(procs, outs)):
        if pr.returncode != 0 or not os.path.exists(out_path):
            raise RuntimeError(
                f"multihost worker {pid} failed "
                f"(rc={pr.returncode}):\n{read_log(pid)}"
            )
        with open(out_path) as f:
            results.append(f.read().strip())
    return results


if __name__ == "__main__":
    worker_main()
