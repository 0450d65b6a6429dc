"""Spanning-tree estimate propagation (slam/propagate.py) — the batched
re-design of g2o's estimate_propagator + hyper_dijkstra
(object_slam/Thirdparty/g2o/g2o/core/estimate_propagator.cpp): batch-mode
vertex initialisation by composing measurements along min-cost paths from
the fixed frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cube_slam_wu_tpu.core.cuboid import Cuboid
from cube_slam_wu_tpu.core.se3 import SE3
from cube_slam_wu_tpu.slam import ba
from cube_slam_wu_tpu.slam.graph import CameraObjectGraph
from cube_slam_wu_tpu.slam.propagate import propagate_estimates


def _chain_graph(F=12, O=1, seed=0, drop_odom=(), meas_frames=None):
    """Ground-truth trajectory + one cuboid; odometry measurements exact,
    estimates for frames >0 left at identity (uninitialised)."""
    rng = np.random.default_rng(seed)
    tang = rng.normal(size=(F, 6)) * np.array([0.3, 0.3, 0.1, 0.05, 0.05, 0.3])
    tang[0] = 0
    Tcw_gt = SE3.exp(jnp.asarray(np.cumsum(tang, axis=0), jnp.float64))
    cube_gt = Cuboid.from_minimal(
        jnp.asarray([[0.6, 2.5, 0.35, 0, 0, 0.8, 0.5, 0.35, 0.35]] * O, jnp.float64)
    )

    g = CameraObjectGraph.empty(F, O, jnp.float64)
    odom_list = [SE3.identity((), jnp.float64)]
    for i in range(1, F):
        odom_list.append(Tcw_gt[i].compose(Tcw_gt[i - 1].inverse()))
    odom = jax.tree.map(lambda *xs: jnp.stack(xs), *odom_list)
    odom_mask = np.arange(F) > 0
    for d in drop_odom:
        odom_mask[d] = False

    meas_mask = np.zeros((F, O), bool)
    frames = range(F) if meas_frames is None else meas_frames
    for f in frames:
        meas_mask[f, :] = True
    Twc_b = Tcw_gt.inverse()
    Twc_b = SE3(
        jnp.broadcast_to(Twc_b.quat[:, None, :], (F, O, 4)),
        jnp.broadcast_to(Twc_b.trans[:, None, :], (F, O, 3)),
    )
    cube_b = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (F,) + x.shape), cube_gt
    )
    meas = cube_b.transform_to(Twc_b)

    g = g._replace(
        cam_Tcw=SE3.identity((F,), jnp.float64)._replace(
            quat=SE3.identity((F,), jnp.float64).quat
        ),
        frame_mask=jnp.ones(F, bool),
        cube_valid=jnp.ones(O, bool),
        odom=odom,
        odom_mask=jnp.asarray(odom_mask),
        cube_meas=meas,
        cube_meas_weight=jnp.where(jnp.asarray(meas_mask), 1.8, 0.0),
        cube_meas_mask=jnp.asarray(meas_mask),
    )
    # frame 0 estimate = truth (the fixed vertex); everything else identity
    first = jax.tree.map(lambda gt, cur: cur.at[0].set(gt[0]),
                         Tcw_gt, g.cam_Tcw)
    return g._replace(cam_Tcw=first), Tcw_gt, cube_gt


def test_odometry_chain_recovered_exactly():
    g, Tcw_gt, _ = _chain_graph(F=12, meas_frames=[])
    res = propagate_estimates(g)
    np.testing.assert_allclose(
        np.asarray(res.graph.cam_Tcw.trans),
        np.asarray(Tcw_gt.trans),
        atol=1e-9,
    )
    # frame k reached at cost k along the chain
    np.testing.assert_allclose(
        np.asarray(res.frame_dist), np.arange(12), atol=1e-9
    )


def test_object_hop_bridges_broken_chain():
    """Odometry missing at slot 6 splits the chain; both halves observe the
    cuboid, so frames 6+ must be reached via frame<6 -> object -> frame>=6
    and recover their ground-truth poses from the measurement composition."""
    g, Tcw_gt, cube_gt = _chain_graph(F=12, drop_odom=(6,))
    res = propagate_estimates(g, cube_cost=3.0)
    assert np.isfinite(np.asarray(res.frame_dist)).all()
    np.testing.assert_allclose(
        np.asarray(res.graph.cam_Tcw.trans),
        np.asarray(Tcw_gt.trans),
        atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(res.graph.cube.to_minimal()[0]),
        np.asarray(cube_gt.to_minimal()[0]),
        atol=1e-9,
    )
    # every frame past the break observes the cuboid, so each is reached by
    # the direct hop frame0 -> object -> frame_k at cost 2 * cube_cost = 6
    d = np.asarray(res.frame_dist)
    assert (d[6:] == 6.0).all() and (d[:6] == np.arange(6)).all()


def test_prefers_odometry_over_object_hop():
    """With an intact chain AND object measurements, the default cost
    (cube_cost = F * odom_cost + 1) keeps every frame on the pure odometry
    path (g2o's odometry-cost preference); hop-eager explicit costs make the
    far frames switch to the cheaper 2-hop landmark path."""
    g, _, _ = _chain_graph(F=10)
    res = propagate_estimates(g)
    np.testing.assert_allclose(
        np.asarray(res.frame_dist), np.arange(10), atol=1e-9
    )
    d = np.asarray(propagate_estimates(g, cube_cost=3.0).frame_dist)
    np.testing.assert_allclose(d, np.minimum(np.arange(10), 6.0), atol=1e-9)


def test_unreached_vertices_keep_estimates():
    g, Tcw_gt, _ = _chain_graph(F=8, drop_odom=(4,), meas_frames=[])
    res = propagate_estimates(g)
    d = np.asarray(res.frame_dist)
    assert np.isinf(d[4:]).all() and np.isfinite(d[:4]).all()
    # frames 4+ untouched (identity estimates)
    np.testing.assert_allclose(
        np.asarray(res.graph.cam_Tcw.trans[4:]), 0.0, atol=0.0
    )
    assert np.isinf(np.asarray(res.cube_dist)).all()


@pytest.mark.slow
def test_propagate_then_optimize_beats_cold_start():
    """Batch LM from identity init on a long noisy chain stalls far from the
    truth; propagation first gives the optimizer a basin it converges in
    (the exact role of estimate_propagator before g2o batch solves)."""
    g, Tcw_gt, _ = _chain_graph(F=24, seed=3)
    # noise the odometry so the optimum isn't the propagation output itself
    noise = SE3.exp(
        jnp.asarray(
            np.random.default_rng(7).normal(size=(24, 6)) * 0.01, jnp.float64
        )
    )
    g = g._replace(odom=noise.compose(g.odom))

    cold = ba.optimize(g, iterations=10)
    warm_g = propagate_estimates(g).graph
    warm = ba.optimize(warm_g, iterations=10)

    def rmse(T):
        e = np.asarray(T.trans) - np.asarray(Tcw_gt.trans)
        return float(np.sqrt((e**2).sum(1).mean()))

    assert rmse(warm.cam_Tcw) < 0.05
    assert rmse(warm.cam_Tcw) < rmse(cold.cam_Tcw) * 0.5


@pytest.mark.slow
def test_batch_mode_on_real_data_matches_incremental(reference_root):
    """Real 58-frame TUM graph: blank every estimate except frame 0,
    propagate along the odometry spanning tree, batch-solve — must land in
    the same optimum as the incremental tracker (ATE 0.2014)."""
    from cube_slam_wu_tpu.core.cuboid import Cuboid
    from cube_slam_wu_tpu.slam import pipeline
    from cube_slam_wu_tpu.utils.metrics import ate_rmse

    data = pipeline.load_offline_dataset("/root/reference/object_slam/data")
    frames = pipeline.build_offline_frames(data)
    first = SE3.from_xyzq(jnp.asarray(data.truth_poses[0, 1:8]))
    from cube_slam_wu_tpu.slam import tracker as trk

    g, _, _ = trk.run_incremental(first, frames)
    g_blank = g._replace(
        cam_Tcw=jax.tree.map(
            lambda cur, src: cur.at[0].set(src[0]),
            SE3.identity((g.capacity,), jnp.float64),
            g.cam_Tcw,
        ),
        cube=Cuboid.identity((g.n_objects,), jnp.float64),
    )
    res = propagate_estimates(g_blank)
    assert np.isfinite(np.asarray(res.frame_dist)).all()
    opt = ba.optimize(res.graph, iterations=30)
    traj = np.asarray(opt.cam_Tcw.inverse().to_xyzq())
    n = data.truth_poses.shape[0]
    ate = ate_rmse(traj[:n, :3], data.truth_poses[:, 1:4])
    assert ate < 0.21, f"batch-mode ATE {ate:.4f}"
