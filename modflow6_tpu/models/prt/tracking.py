"""Pollock semi-analytic particle tracking on structured DIS grids.

Behavioral parity target: the reference PRT tracking kernels for
rectangular cells (src/Solution/ParticleTracker/MethodCellPollock.f90:19-27
and MethodSubcellPollock.f90), orchestrated per-cell by MethodDis
(src/Solution/ParticleTracker/MethodDis.f90).  The reference dispatches a
method object per particle per cell; here the whole swarm advances in one
``vmap`` of a ``lax.while_loop`` cell-transition kernel — every particle is
tracked simultaneously with static shapes (the natural data-parallel formulation of
an embarrassingly parallel workload).

Pollock's method: within a cell, each face-normal velocity component varies
linearly between the two opposing face velocities, so the trajectory and
the exit time have closed forms:
    v(s)   = v1 + A*s,          A = (v2 - v1) / ds
    s(t)   = s + (vp*exp(A*t) - vp) / A      (vp = velocity at the particle)
    t_exit = ln(v_exit / vp) / A             (v_exit = face being approached)
with the A→0 limits handled as straight-line motion.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import DONE

DINF = jnp.inf
_EPS = 1e-30

# termination status codes (mirrors the reference's istatus semantics)
ACTIVE = 0
TERM_BOUNDARY = 1   # left the grid / entered inactive cell
TERM_WEAK = 2       # no exit face (weak sink / stagnation)
TERM_TIMEOUT = 3    # still tracking when the time budget expired (resumable)


@partial(jax.tree_util.register_dataclass,
         data_fields=["qleft", "qright", "qfront", "qback", "qtop", "qbot",
                      "porosity", "sat", "active_cell"],
         meta_fields=["shape", "delr", "delc"])
@dataclasses.dataclass(frozen=True)
class CellFlows:
    """Per-cell face flows (positive in +x / +y(up-row) / +z(up) direction)
    and cell properties on the (nlay, nrow, ncol) grid."""

    qleft: jax.Array    # f64[L,R,C] flow across west face (+x into cell)
    qright: jax.Array   # f64[L,R,C] flow across east face (+x out of cell)
    qfront: jax.Array   # f64[L,R,C] flow across south face (+y into cell)
    qback: jax.Array    # f64[L,R,C] flow across north face (+y out of cell)
    qtop: jax.Array     # f64[L,R,C] flow across top face (+z out of cell)
    qbot: jax.Array     # f64[L,R,C] flow across bottom face (+z into cell)
    porosity: jax.Array  # f64[L,R,C]
    sat: jax.Array       # f64[L,R,C] thickness fraction, scales z area
    active_cell: jax.Array  # bool[L,R,C]
    shape: tuple
    delr: tuple          # column widths (x), static
    delc: tuple          # row widths (y), static


def build_cell_flows(topo, grid, q_edge, porosity, sat) -> CellFlows:
    """Assemble CellFlows for a DIS grid from the FMI edge-flow field.

    ``topo`` is the host Topology (its static ``direction`` axis hints
    classify each edge; the flow values themselves stay on device).
    """
    nlay, nrow, ncol = grid.shape
    N = nlay * nrow * ncol
    n = topo.edge_n
    d = topo.direction
    q_nm = -q_edge   # flow from n toward m along the n→m direction

    acc_x = jnp.zeros(N).at[n].add(jnp.where(d == 0, q_nm, 0.0))
    acc_y = jnp.zeros(N).at[n].add(jnp.where(d == 1, q_nm, 0.0))
    acc_z = jnp.zeros(N).at[n].add(jnp.where(d == 2, q_nm, 0.0))
    q_east = acc_x.reshape(grid.shape)    # +x out across east face
    q_south = acc_y.reshape(grid.shape)   # toward row+1: -y direction
    q_down = acc_z.reshape(grid.shape)    # toward lay+1: -z direction

    zc = jnp.zeros((nlay, nrow, 1))
    zr = jnp.zeros((nlay, 1, ncol))
    zl = jnp.zeros((1, nrow, ncol))
    # +x flows on west/east faces
    qleft = jnp.concatenate([zc, q_east[:, :, :-1]], axis=2)
    qright = q_east
    # +y flows (+y = toward decreasing row). south face of (l,r,c) touches
    # row r+1; +y flow across it = -(southward flow) = -q_south[l,r,c].
    # north ("back") face touches row r-1; +y flow = -q_south[l,r-1,c].
    qfront = -q_south
    qback = jnp.concatenate([zr, -q_south[:, :-1, :]], axis=1)
    # +z flows (+z up): bottom face +z flow = -q_down[l,r,c]; top face
    # +z flow = -q_down[l-1,r,c]
    qbot = -q_down
    qtop = jnp.concatenate([zl, -q_down[:-1, :, :]], axis=0)

    return CellFlows(
        qleft=qleft, qright=qright,
        qfront=qfront, qback=qback,
        qtop=qtop, qbot=qbot,
        porosity=jnp.asarray(porosity).reshape(grid.shape),
        sat=jnp.asarray(sat).reshape(grid.shape),
        active_cell=jnp.asarray(grid.idomain > 0).reshape(grid.shape),
        shape=(nlay, nrow, ncol),
        delr=tuple(np.asarray(grid.delr, float)),
        delc=tuple(np.asarray(grid.delc, float)))


def _axis_exit(vp, v1, v2, s, ds):
    """Exit time + analytic update along one axis (Pollock closed form).

    vp: velocity at the particle; v1/v2: low/high-face velocities (+axis
    positive); s: local coordinate in [0, ds].  Returns (t_exit, A, moving)
    where t_exit = time to reach a face (inf if trapped on this axis).
    """
    A = (v2 - v1) / ds
    lin = jnp.abs(A) * ds < 1e-12 * (jnp.abs(v1) + jnp.abs(v2) + _EPS)

    # Exit time through a face at distance d from the particle:
    #   t = ln(v_face/vp)/A = log1p(A*d/vp)/A
    # — this form is exact in the A→0 limit and, unlike ln(v_face/vp),
    # suffers no cancellation when the flow is nearly uniform (v_face≈vp).
    vp_safe = jnp.where(vp != 0, vp, 1.0)
    A_safe = jnp.where(A != 0, A, 1.0)

    pos_ok = (vp > 0) & (v2 > 0)
    rel_hi = A * (ds - s) / vp_safe
    t_hi = jnp.where(
        lin, (ds - s) / vp_safe,
        jnp.log1p(jnp.maximum(rel_hi, -DONE + _EPS)) / A_safe)
    t_hi = jnp.where(pos_ok & (rel_hi > -DONE), t_hi, DINF)

    neg_ok = (vp < 0) & (v1 < 0)
    rel_lo = A * (0.0 - s) / vp_safe
    t_lo = jnp.where(
        lin, (0.0 - s) / vp_safe,
        jnp.log1p(jnp.maximum(rel_lo, -DONE + _EPS)) / A_safe)
    t_lo = jnp.where(neg_ok & (rel_lo > -DONE), t_lo, DINF)

    t = jnp.minimum(t_hi, t_lo)
    t = jnp.where(t > 0, t, DINF)
    return t, A, lin


def _axis_advance(vp, v1, A, lin, s, dt):
    """Position after dt along one axis (exact exponential solution);
    expm1 keeps full precision as A → 0."""
    s_exp = s + vp * jnp.expm1(A * dt) / jnp.where(A != 0, A, 1.0)
    s_lin = s + vp * dt
    return jnp.where(lin, s_lin, s_exp)


def make_tracker(flows: CellFlows, max_transitions: int = 4096):
    """Build the jittable swarm tracker.

    Returns track(x, y, z, lay, row, col, tmax) -> dict of final particle
    state; all inputs are arrays over the particle axis.  Coordinates are
    global model coordinates: x along columns (east+), y along rows
    (north+, row 0 at the top edge), z elevation.
    """
    nlay, nrow, ncol = flows.shape
    delr = jnp.asarray(flows.delr)                  # [ncol]
    delc = jnp.asarray(flows.delc)                  # [nrow]
    xedge = jnp.concatenate([jnp.zeros(1), jnp.cumsum(delr)])   # [ncol+1]
    # y decreases with row index; row 0 spans [ytot - delc[0], ytot]
    ytot = jnp.sum(delc)
    yedge = ytot - jnp.concatenate([jnp.zeros(1), jnp.cumsum(delc)])

    def one(x, y, z, lay, row, col, top3, bot3, tmax):
        """Track a single particle for at most tmax (vmapped)."""

        def cond(state):
            x, y, z, lay, row, col, trem, status, t_elapsed, nhops = state
            return (status == ACTIVE) & (nhops < max_transitions)

        def body(state):
            x, y, z, lay, row, col, trem, status, t_elapsed, nhops = state
            dx = delr[col]
            dy = delc[row]
            ztop = top3[lay, row, col]
            zbot = bot3[lay, row, col]
            dz = jnp.maximum(ztop - zbot, _EPS)
            theta = flows.porosity[lay, row, col]
            satf = flows.sat[lay, row, col]

            # pass-to-bottom: a dry cell drops the particle instantly to
            # the underlying layer (MethodCellPassToBot.f90 role); at the
            # bottom layer a dry cell terminates like an inactive one
            dry = satf <= 1.0e-10
            at_bottom = lay >= nlay - 1
            drop = dry & ~at_bottom
            lay = jnp.where(drop, lay + 1, lay)
            z = jnp.where(drop, zbot, z)
            status = jnp.where(dry & at_bottom, TERM_BOUNDARY, status)

            ztop = top3[lay, row, col]
            zbot = bot3[lay, row, col]
            dz = jnp.maximum(ztop - zbot, _EPS)
            theta = flows.porosity[lay, row, col]
            satf = jnp.maximum(flows.sat[lay, row, col], 1.0e-10)

            # face areas (saturated thickness scales the horizontal faces)
            ax = dy * dz * satf
            ay = dx * dz * satf
            az = dx * dy

            vx1 = flows.qleft[lay, row, col] / (ax * theta)
            vx2 = flows.qright[lay, row, col] / (ax * theta)
            vy1 = flows.qfront[lay, row, col] / (ay * theta)
            vy2 = flows.qback[lay, row, col] / (ay * theta)
            vz1 = flows.qbot[lay, row, col] / (az * theta)
            vz2 = flows.qtop[lay, row, col] / (az * theta)

            # local coordinates
            sx = x - xedge[col]
            sy = y - yedge[row + 1]     # cell spans [yedge[row+1], yedge[row]]
            sz = z - zbot

            Axc = (vx2 - vx1) / dx
            vxp = vx1 + Axc * sx
            Ayc = (vy2 - vy1) / dy
            vyp = vy1 + Ayc * sy
            Azc = (vz2 - vz1) / dz
            vzp = vz1 + Azc * sz

            tx, Ax_, linx = _axis_exit(vxp, vx1, vx2, sx, dx)
            ty, Ay_, liny = _axis_exit(vyp, vy1, vy2, sy, dy)
            tz, Az_, linz = _axis_exit(vzp, vz1, vz2, sz, dz)

            t_exit = jnp.minimum(jnp.minimum(tx, ty), tz)
            no_exit = ~jnp.isfinite(t_exit)
            # a cell with no outflow face is a sink (e.g. CHD/WEL
            # absorbing the flow): terminate on the spot, like the
            # reference's sink termination, recording time-of-entry
            dt = jnp.minimum(t_exit, trem)
            dt = jnp.where(no_exit, 0.0, dt)

            sx2 = jnp.clip(_axis_advance(vxp, vx1, Ax_, linx, sx, dt), 0.0, dx)
            sy2 = jnp.clip(_axis_advance(vyp, vy1, Ay_, liny, sy, dt),
                           0.0, dy)
            sz2 = jnp.clip(_axis_advance(vzp, vz1, Az_, linz, sz, dt), 0.0, dz)

            x2 = xedge[col] + sx2
            y2 = yedge[row + 1] + sy2
            z2 = zbot + sz2

            out_of_time = (trem <= t_exit) & ~no_exit
            # which face was crossed (only when t_exit realized)
            cross_x = (t_exit == tx) & ~out_of_time & ~no_exit
            cross_y = (t_exit == ty) & ~out_of_time & ~no_exit
            cross_z = (t_exit == tz) & ~out_of_time & ~no_exit
            xdir = jnp.where(vxp > 0, 1, -1)
            ydir = jnp.where(vyp > 0, -1, 1)   # +y = row-1
            zdir = jnp.where(vzp > 0, -1, 1)   # +z = lay-1

            col2 = col + jnp.where(cross_x, xdir, 0)
            row2 = row + jnp.where(cross_y, ydir, 0)
            lay2 = lay + jnp.where(cross_z, zdir, 0)

            left_grid = ((col2 < 0) | (col2 >= ncol) | (row2 < 0)
                         | (row2 >= nrow) | (lay2 < 0) | (lay2 >= nlay))
            col2c = jnp.clip(col2, 0, ncol - 1)
            row2c = jnp.clip(row2, 0, nrow - 1)
            lay2c = jnp.clip(lay2, 0, nlay - 1)
            inactive = ~flows.active_cell[lay2c, row2c, col2c]

            status2 = jnp.where(
                no_exit, TERM_WEAK,
                jnp.where(out_of_time, TERM_TIMEOUT,
                          jnp.where(left_grid | inactive, TERM_BOUNDARY,
                                    ACTIVE)))
            status2 = jnp.where(dry & at_bottom, TERM_BOUNDARY, status2)
            trem2 = jnp.maximum(trem - dt, 0.0)
            return (x2, y2, z2, lay2c, row2c, col2c, trem2, status2,
                    t_elapsed + dt, nhops + 1)

        init = (x, y, z, lay, row, col, tmax, ACTIVE, 0.0,
                jnp.asarray(0, jnp.int32))
        x2, y2, z2, l2, r2, c2, trem, status, t_el, hops = \
            jax.lax.while_loop(cond, body, init)
        return dict(x=x2, y=y2, z=z2, lay=l2, row=r2, col=c2,
                    status=status, time=t_el, transitions=hops)

    def track(x, y, z, lay, row, col, top3, bot3, tmax):
        f = jax.vmap(lambda xi, yi, zi, li, ri, ci: one(
            xi, yi, zi, li, ri, ci, top3, bot3, tmax))
        return f(x, y, z, lay, row, col)

    return track
