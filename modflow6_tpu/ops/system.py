"""The assembled linear system: ELL-packed sparse matrix + rhs.

Plays the role of the reference's MatrixBaseType/SparseMatrix CSR storage
(src/Utilities/Matrix/MatrixBase.f90:12-36, SparseMatrix.f90) redesigned for
accelerators: the matrix is (diag[N], off[N, K]) with a static neighbor table
nbr[N, K], so SpMV is K gathers + fused multiply-adds with static shapes —
no row pointers, no indirection chains, no scalar loops.

Padded ELL slots point at their own row and must carry coefficient 0.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.tree_util.register_dataclass, data_fields=["diag", "off", "rhs"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class EllSystem:
    """A x = b with A = diag ⊕ off over a static neighbor table."""

    diag: jax.Array  # f64[N]
    off: jax.Array   # f64[N, K]; off[i, k] = A[i, nbr[i, k]]
    rhs: jax.Array   # f64[N]


def spmv(nbr: jax.Array, diag: jax.Array, off: jax.Array, x: jax.Array) -> jax.Array:
    """y = A @ x for the ELL matrix (equivalent role: SPARSKIT amux,
    reference src/Utilities/Libraries/sparskit2/)."""
    return diag * x + jnp.sum(off * x[nbr], axis=1)


def spmv_structured(shape, diag, off, x):
    """Structured 7-point-stencil SpMV for DIS grids: the ELL matrix with
    fixed slots [E,W,N,S,U,D] reshapes to per-direction coefficient fields
    and y = A x becomes six shifted multiplies — dense elementwise work, no
    gathers.  XLA fuses the pads, slices, multiplies and adds into one loop
    that reads each input once; a hand-written Pallas kernel measured
    slower on the H100 (PERF.md, "Stencil matvec on the H100")."""
    nlay, nrow, ncol = shape
    x3 = x.reshape(shape)
    c = off.reshape(nlay, nrow, ncol, 6)
    z = ((0, 0), (0, 0), (0, 0))

    def shift(arr, axis, d):
        # neighbor values offset by d along axis; zeros beyond the border
        sl = [slice(None)] * 3
        pad = [list(p) for p in z]
        if d == +1:
            sl[axis] = slice(1, None)
            pad[axis][1] = 1
        else:
            sl[axis] = slice(None, -1)
            pad[axis][0] = 1
        return jnp.pad(arr[tuple(sl)], pad)

    y = diag.reshape(shape) * x3
    y = y + c[..., 0] * shift(x3, 2, +1)   # east
    y = y + c[..., 1] * shift(x3, 2, -1)   # west
    y = y + c[..., 2] * shift(x3, 1, -1)   # north
    y = y + c[..., 3] * shift(x3, 1, +1)   # south
    y = y + c[..., 4] * shift(x3, 0, -1)   # up
    y = y + c[..., 5] * shift(x3, 0, +1)   # down
    return y.reshape(-1)


def make_matvec(dtopo, diag, off):
    """SpMV for the topology: structured shifts for DIS grids, gathers
    for unstructured tables."""
    shape = getattr(dtopo, "grid_shape", None)
    if shape is not None:
        return lambda v: spmv_structured(shape, diag, off, v)
    return lambda v: spmv(dtopo.nbr, diag, off, v)


def residual(nbr, diag, off, x, b):
    """r = b - A x (reference ims_base_residual, ImsLinearBase.f90)."""
    return b - spmv(nbr, diag, off, x)


def to_scipy_csr(topo, diag, off):
    """Export to scipy CSR (host, tests/debug only)."""
    import scipy.sparse as sp

    N = topo.nodes
    K = topo.max_degree
    nbr = np.asarray(topo.nbr)
    off = np.asarray(off)
    diag = np.asarray(diag)
    rows = np.repeat(np.arange(N), K)
    cols = nbr.reshape(-1)
    vals = off.reshape(-1)
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
    mat = mat + sp.diags(diag)
    return mat


def apply_dirichlet(nbr, active, diag, off, rhs, x, symmetric=True, own=None):
    """Row/column fixups before the linear solve.

    Vectorized equivalent of the reference's pre-solve adjustments
    (NumericalSolution.f90 sln_ls:2404-2475):

    - active rows with a tiny diagonal get diag=-1 and rhs -= x (keeps the
      row consistent so the Krylov solve returns x unchanged there);
    - inactive / Dirichlet rows (active <= 0) become identity rows with
      rhs = x;
    - if ``symmetric``, coefficients coupling an active row to a Dirichlet
      column are moved to the rhs and zeroed so the matrix stays symmetric
      (required for CG);
    - ``own`` (sharded path): rows outside the owned block (halo mirror
      cells) are also forced to identity — their true equations live on the
      neighboring shard — but their *columns* are kept, since their values
      are synchronized each matvec (the interface-model mask of the
      reference, Connections.f90:28).
    """
    is_active = active > 0
    row_active = is_active if own is None else (is_active & own)

    # tiny-diagonal fix for active rows
    tiny = row_active & (jnp.abs(diag) < 1.0e-15)
    diag = jnp.where(tiny, -1.0, diag)
    rhs = jnp.where(tiny, rhs - x, rhs)

    # Dirichlet / inactive / non-owned rows → identity
    diag = jnp.where(row_active, diag, 1.0)
    off = jnp.where(row_active[:, None], off, 0.0)
    rhs = jnp.where(row_active, rhs, x)

    if symmetric:
        nbr_fixed = ~is_active[nbr]  # [N, K] column is Dirichlet (global truth)
        move = row_active[:, None] & nbr_fixed
        rhs = rhs - jnp.sum(jnp.where(move, off * x[nbr], 0.0), axis=1)
        off = jnp.where(move, 0.0, off)

    return diag, off, rhs


def apply_dirichlet_structured(shape, active, diag, off, rhs, x,
                               symmetric=True, own=None):
    """Row/column fixups without the [N,K] neighbor gather: neighbor activity
    and values come from shifted dense fields (see ops.system.apply_dirichlet
    for semantics; reference sln_ls NumericalSolution.f90:2404-2475)."""
    is_active = active > 0
    row_active = is_active if own is None else (is_active & own)

    tiny = row_active & (jnp.abs(diag) < 1.0e-15)
    diag = jnp.where(tiny, -1.0, diag)
    rhs = jnp.where(tiny, rhs - x, rhs)

    diag = jnp.where(row_active, diag, 1.0)
    off = jnp.where(row_active[:, None], off, 0.0)
    rhs = jnp.where(row_active, rhs, x)

    if symmetric:
        nlay, nrow, ncol = shape
        act3 = is_active.reshape(shape)
        x3 = x.reshape(shape)
        c = off.reshape(nlay, nrow, ncol, 6)

        def shifted(arr, axis, d, fill):
            sl = [slice(None)] * 3
            pad = [[0, 0], [0, 0], [0, 0]]
            if d == +1:
                sl[axis] = slice(1, None)
                pad[axis][1] = 1
            else:
                sl[axis] = slice(None, -1)
                pad[axis][0] = 1
            return jnp.pad(arr[tuple(sl)], pad, constant_values=fill)

        moves = []
        for slot, (axis, d) in enumerate([(2, +1), (2, -1), (1, -1), (1, +1),
                                          (0, -1), (0, +1)]):
            nbr_fixed = ~shifted(act3, axis, d, True)
            move = row_active.reshape(shape) & nbr_fixed
            xn = shifted(x3, axis, d, 0.0)
            moves.append(jnp.where(move, c[..., slot] * xn, 0.0))
            c = c.at[..., slot].set(jnp.where(move, 0.0, c[..., slot]))
        rhs = rhs - sum(moves).reshape(-1)
        off = c.reshape(-1, 6)

    return diag, off, rhs
