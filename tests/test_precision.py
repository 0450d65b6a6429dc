"""The library's f32 products run at HIGHEST precision from every entry
point, and importing the package changes no process-wide JAX option."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cube_slam_wu_tpu  # noqa: F401


def _dots(lowered):
    return re.findall(r"stablehlo\.dot_general[^\n]*", lowered.as_text())


def _ba():
    from cube_slam_wu_tpu.core.cuboid import Cuboid
    from cube_slam_wu_tpu.core.se3 import SE3
    from cube_slam_wu_tpu.slam import ba
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

    F, f32 = 4, jnp.float32
    Tcw = SE3.exp(jnp.asarray(np.random.default_rng(0).normal(size=(F, 6)) * 0.05, f32))
    cube = Cuboid.from_minimal(jnp.asarray([0.5, 2.0, 0.3, 0, 0, 0.7, 0.4, 0.3, 0.3], f32))
    g = CameraObjectGraph.empty(F, 1, f32)._replace(
        cam_Tcw=Tcw,
        cube=jax.tree.map(lambda x: x[None], cube),
        frame_mask=jnp.ones(F, bool),
        cube_valid=jnp.ones(1, bool),
        cube_meas=jax.tree.map(lambda x: x[:, None], cube.transform_to(Tcw.inverse())),
        cube_meas_weight=jnp.ones((F, 1), f32),
        cube_meas_mask=jnp.ones((F, 1), bool),
    )
    return jax.jit(lambda g: ba.optimize(g, iterations=2)).lower(g)


def _online_step():
    from cube_slam_wu_tpu.slam import online
    from cube_slam_wu_tpu.slam.graph import CameraObjectGraph

    f32 = jnp.float32
    step = online.make_online_step(online.TUM_FR3_K, np.eye(4), 4, f32)
    state = online.OnlineState(
        CameraObjectGraph.empty(4, 1, f32), online.OnlineBook.empty(1, f32), None
    )
    return step.lower(
        state, jnp.zeros((48, 64), jnp.uint8), jnp.asarray([[10.0, 10, 40, 40]]),
        jnp.ones(1, bool), jnp.asarray(1, jnp.int32),
    )


def _lbd():
    from cube_slam_wu_tpu.ops import lbd

    lines = jnp.asarray([[5.0, 5, 40, 30], [10, 40, 50, 10]])
    return jax.jit(lambda g: lbd.lbd_descriptors(g, lines, jnp.ones(2, bool))).lower(
        jnp.zeros((48, 64), jnp.float32)
    )


@pytest.mark.parametrize("build", [_ba, _online_step, _lbd], ids=["ba", "online_step", "lbd"])
def test_every_dot_is_highest(build):
    dots = _dots(build())
    assert dots
    assert all("HIGHEST" in d for d in dots), [d[:160] for d in dots if "HIGHEST" not in d]


def test_import_sets_no_global_precision():
    assert jax.config.jax_default_matmul_precision is None
