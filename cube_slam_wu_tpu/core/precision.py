"""The library's f32 product policy.

Every matrix product of the library goes through `einsum`, `matmul` or
`tensordot` here, at HIGHEST precision: full f32 on every backend,
whatever the caller's `jax_default_matmul_precision`.  A GPU would
otherwise run f32 products as TF32 (about three decimal digits), which the
BA normal equations, the Schur and window einsums and the LBD band sums do
not tolerate.
"""

import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

einsum = functools.partial(jnp.einsum, precision=HIGHEST)
matmul = functools.partial(jnp.matmul, precision=HIGHEST)
tensordot = functools.partial(jnp.tensordot, precision=HIGHEST)
