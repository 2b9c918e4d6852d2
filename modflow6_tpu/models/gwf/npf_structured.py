"""Structured (DIS) NPF assembly: the gather-free hot path.

Same physics as npf.assemble (behavioral parity: gwf-npf.f90 npf_fc /
calc_condsat), but expressed as dense per-direction slice operations on
(nlay, nrow, ncol) fields — no edge gathers, no scatters.  Combined with
ops.system.spmv_structured this makes the entire outer iteration pure
dense elementwise work, bound by memory bandwidth.

Applicability: DIS topologies with ``grid_shape`` set (adjacent-layer
vertical connections) and no rotated-anisotropy angles.  Inactive cells
(idomain holes) are handled by the ibound masks inside hcond/vcond — a
missing edge simply assembles a zero coefficient.

Slot order matches Topology._ell structured mode: [E, W, N, S, U, D].
"""

from __future__ import annotations

import jax.numpy as jnp

from ...constants import DZERO
from ...ops import conductance as condops


def _dir_slices(shape):
    """Return per-direction (n-side slice, m-side slice) index tuples."""
    return {
        "x": ((slice(None), slice(None), slice(None, -1)),
              (slice(None), slice(None), slice(1, None))),
        "y": ((slice(None), slice(None, -1), slice(None)),
              (slice(None), slice(1, None), slice(None))),
        "z": ((slice(None, -1), slice(None), slice(None)),
              (slice(1, None), slice(None), slice(None))),
    }


def _geometry(shape, delr, delc):
    """Per-direction (cl1, cl2, width) broadcastable arrays."""
    nlay, nrow, ncol = shape
    gx = (0.5 * delr[:-1][None, None, :], 0.5 * delr[1:][None, None, :],
          delc[None, :, None])
    gy = (0.5 * delc[:-1][None, :, None], 0.5 * delc[1:][None, :, None],
          delr[None, None, :])
    area = (delc[:, None] * delr[None, :])[None]
    return gx, gy, area


def structured_condsat(shape, delr, delc, opts, icelltype, k11, k22, k33,
                       top, bot, sat0):
    """Saturated conductances as three dense arrays (cx, cy, cz).

    cx[k,i,j] = condsat between (k,i,j) and (k,i,j+1) — shapes are the full
    grid shape with the last index along the direction unused (zero).
    Mirrors calc_condsat (gwf-npf.f90:1950).
    """
    t3 = top.reshape(shape)
    b3 = bot.reshape(shape)
    s3 = sat0.reshape(shape)
    k11_3 = k11.reshape(shape)
    k22_3 = k22.reshape(shape)
    k33_3 = k33.reshape(shape)
    sl = _dir_slices(shape)
    gx, gy, area = _geometry(shape, delr, delc)

    def horiz(kfield, dir_key, geom):
        ns, ms = sl[dir_key]
        cl1, cl2, width = geom
        thk_n = s3[ns] * (t3[ns] - b3[ns])
        thk_m = s3[ms] * (t3[ms] - b3[ms])
        return condops.condmean(kfield[ns], kfield[ms], thk_n, thk_m,
                                cl1, cl2, width, opts.icellavg)

    cx = horiz(k11_3, "x", gx)
    cy = horiz(k22_3 if opts.ik22 else k11_3, "y", gy)

    ns, ms = sl["z"]
    kv_n, kv_m = k33_3[ns], k33_3[ms]
    bovk1 = s3[ns] * (t3[ns] - b3[ns]) * 0.5 / jnp.where(kv_n != 0, kv_n, 1.0)
    bovk2 = s3[ms] * (t3[ms] - b3[ms]) * 0.5 / jnp.where(kv_m != 0, kv_m, 1.0)
    denom = bovk1 + bovk2
    cz = jnp.where(denom != DZERO, area / jnp.where(denom != 0, denom, 1.0),
                   DZERO)
    return cx, cy, cz


def assemble_structured(shape, delr, delc, opts, arrays, head, ibound, sat,
                        condsat3):
    """npf_fc on dense per-direction slices → (diag, off[N,6], rhs).

    ``condsat3``: (cx, cy, cz) from structured_condsat.
    """
    nlay, nrow, ncol = shape
    t3 = arrays.top.reshape(shape)
    b3 = arrays.bot.reshape(shape)
    h3 = head.reshape(shape)
    ib3 = ibound.reshape(shape)
    s3 = sat.reshape(shape)
    ict3 = arrays.icelltype.reshape(shape)
    k11_3 = arrays.k11.reshape(shape)
    k22_3 = arrays.k22.reshape(shape)
    k33_3 = arrays.k33.reshape(shape)
    sl = _dir_slices(shape)
    gx, gy, area = _geometry(shape, delr, delc)
    cx0, cy0, cz0 = condsat3

    def horiz(kfield, dir_key, geom, cs):
        ns, ms = sl[dir_key]
        cl1, cl2, width = geom
        return condops.hcond(
            ib3[ns], ib3[ms], ict3[ns], ict3[ms], opts.inewton,
            1, opts.icellavg, cs,
            h3[ns], h3[ms], s3[ns], s3[ms], kfield[ns], kfield[ms],
            t3[ns], t3[ms], b3[ns], b3[ms], cl1, cl2, width)

    cond_x = horiz(k11_3, "x", gx, cx0)
    cond_y = horiz(k22_3 if opts.ik22 else k11_3, "y", gy, cy0)

    ns, ms = sl["z"]
    cond_z = condops.vcond(
        ib3[ns], ib3[ms], ict3[ns], ict3[ms], opts.ivarcv, opts.idewatcv,
        cz0, h3[ns], h3[ms], k33_3[ns], k33_3[ms], s3[ns], s3[ms],
        t3[ns], t3[ms], b3[ns], b3[ms], area)

    zero3 = jnp.zeros(shape)
    rhs3 = zero3

    # perched correction (vertical only): move the term for dewatered
    # underlying cells to the rhs (gwf-npf.f90:520-545)
    if opts.iperched:
        perched = (ict3[ms] != 0) & (h3[ms] < t3[ms]) & (cond_z != DZERO)
        cz_nm = jnp.where(perched, DZERO, cond_z)   # off(n,m) = D slot of n
        cz_mn = cond_z                              # off(m,n) = U slot of m
        diag_z_n = -cond_z
        diag_z_m = jnp.where(perched, DZERO, -cond_z)
        rhs3 = rhs3.at[:-1].add(jnp.where(perched, -cond_z * b3[ns], DZERO))
        rhs3 = rhs3.at[1:].add(jnp.where(perched, cond_z * b3[ns], DZERO))
    else:
        cz_nm = cond_z
        cz_mn = cond_z
        diag_z_n = -cond_z
        diag_z_m = -cond_z

    pad_x = ((0, 0), (0, 0), (0, 1))
    pad_xw = ((0, 0), (0, 0), (1, 0))
    pad_y = ((0, 0), (0, 1), (0, 0))
    pad_yn = ((0, 0), (1, 0), (0, 0))
    pad_z = ((0, 1), (0, 0), (0, 0))
    pad_zu = ((1, 0), (0, 0), (0, 0))

    cE = jnp.pad(cond_x, pad_x)
    cW = jnp.pad(cond_x, pad_xw)
    cS = jnp.pad(cond_y, pad_y)
    cN = jnp.pad(cond_y, pad_yn)
    cD = jnp.pad(cz_nm, pad_z)
    cU = jnp.pad(cz_mn, pad_zu)

    diag3 = -(cE + cW + cS + cN) + jnp.pad(diag_z_n, pad_z) + jnp.pad(
        diag_z_m, pad_zu)
    off = jnp.stack([cE, cW, cN, cS, cU, cD], axis=-1)

    N = nlay * nrow * ncol
    return diag3.reshape(-1), off.reshape(N, 6), rhs3.reshape(-1)
