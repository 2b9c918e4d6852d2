"""modflow6_tpu: a JAX/XLA groundwater simulation framework.

A from-scratch reimplementation of the capabilities of USGS MODFLOW 6
(reference: MODFLOW 6.7.0.dev1) designed for accelerators; it runs on
NVIDIA GPUs, and on the CPU for tests:

- all grid state is dense ``jnp`` arrays over a static topology
- packages are pure functions ``(state, params, t) -> matrix/rhs contributions``
- the implicit CVFD system is assembled connection-wise (vectorized over edges)
  into an ELL-packed sparse matrix and solved by Krylov methods written with
  ``lax.while_loop`` (CG / BiCGSTAB, Jacobi & polynomial preconditioners)
- multi-chip scaling uses ``jax.sharding`` meshes with halo exchange, not MPI

MODFLOW 6 is double precision throughout (reference src/Utilities/kind.f90),
so importing this package enables JAX x64 mode.
"""

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
