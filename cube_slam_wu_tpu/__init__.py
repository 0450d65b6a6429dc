"""cube_slam_wu_tpu — monocular 3D object SLAM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of CubeSLAM
(reference: wuxiaolang/Cube_SLAM_wu, an annotated fork of shichaoy/cube_slam):

- vanishing-point based cuboid proposal generation over a batched hypothesis
  grid (camera roll/pitch x object yaw x top-edge samples x configurations),
  scored with chamfer edge distance + VP angle alignment
  (reference: detect_3d_cuboid/src/box_proposal_detail.cpp),
- line-segment detection, LBD band descriptors and Hamming matching as
  vectorized tensor ops (reference: line_lbd/),
- a joint camera-object Levenberg-Marquardt bundle adjuster with 9-DoF cuboid
  landmarks replacing the bundled g2o (reference: object_slam/),
- multi-device scaling via `jax.sharding` meshes with per-block Hessian
  reductions over collectives.

Everything in the compute path is fixed-shape, mask-based, jit-compiled JAX;
variable-count entities (lines, proposals, frames) are padded arrays with
validity masks.

Precision policy: every matrix product of the library — BA normal
equations, Schur/window einsums, LBD band einsums, projections — goes
through `core.precision` at HIGHEST precision, so it runs at full f32 on
every backend (a GPU would otherwise take TF32 for them, about three decimal
digits), whichever entry point or library call reaches it.  The package
sets no process-wide JAX option.
"""

__version__ = "0.1.0"

from cube_slam_wu_tpu.core import se3 as se3
from cube_slam_wu_tpu.core import cuboid as cuboid
from cube_slam_wu_tpu.core import rotations as rotations
