"""Particle tracking on DISV polygonal-prism grids (the ternary method).

Behavioral parity target: MethodCellTernary + TernarySolveTrack.f90
(src/Solution/ParticleTracker/TernarySolveTrack.f90, ~5.9k LoC) and
MethodDisv.f90: each polygonal cell is fanned into triangles from the
cell centroid; internal-edge fluxes are chosen so every subtriangle is
in mass balance; within a triangle the velocity is the lowest-order
Raviart-Thomas (RT0) field matching the three edge fluxes, and the exit
time through each edge has a closed form.

Redesign (NOT a port): the reference walks one particle at a
time through per-cell method objects, solving exit times with
root-finding fallbacks in skew coordinates.  Here the key observation is
that the RT0 field on a triangle is v(x) = c·x + d with a *scalar*
coefficient c = div/2 — so the signed distance to every edge line
evolves exponentially, exactly like a Pollock axis:

    φ(t)  = n·x(t) − b,     φ' = c·φ + r,
    t_exit = log1p(c·(−φ0)/ν0)/c,    ν0 = c·φ0 + r  (rate toward edge)

Three edge exits + the Pollock vertical exit give a static-shape kernel;
the whole swarm advances in one ``vmap`` of a ``lax.while_loop`` over
(cell, triangle) transitions.  Internal fan fluxes come from the
telescoping chain u_i = u_{i−1} − (Q_i + qz_i) with the zero-mean gauge,
the vectorized equivalent of the reference's subcell mass-balance setup.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DINF = jnp.inf
_EPS = 1e-30

ACTIVE = 0
TERM_BOUNDARY = 1
TERM_WEAK = 2
TERM_TIMEOUT = 3


@partial(jax.tree_util.register_dataclass,
         data_fields=["px", "py", "qx", "qy", "cx", "cy", "tri_area",
                      "nact", "valid", "nbr_cell", "nbr_tri", "edge3d",
                      "edge_sign", "cell_area", "topz", "botz",
                      "porosity", "active_cell", "vedge_up", "vedge_dn",
                      "vsign_up", "vsign_dn"],
         meta_fields=["ncpl", "nlay", "maxv"])
@dataclasses.dataclass(frozen=True)
class DisvFan:
    """Static triangle-fan geometry + edge bookkeeping for a DISV grid.

    Horizontal arrays are (ncpl, maxv) padded per-side; ``edge3d`` maps
    (lay, cell, side) → flowja edge index (−1 at boundaries/padding).
    """

    px: jax.Array        # f64[ncpl, maxv] side start vertex x
    py: jax.Array
    qx: jax.Array        # f64[ncpl, maxv] side end vertex x
    qy: jax.Array
    cx: jax.Array        # f64[ncpl] centroid
    cy: jax.Array
    tri_area: jax.Array  # f64[ncpl, maxv]
    nact: jax.Array      # i32[ncpl] actual side count
    valid: jax.Array     # bool[ncpl, maxv]
    nbr_cell: jax.Array  # i32[ncpl, maxv] 2-D neighbor cell (−1 none)
    nbr_tri: jax.Array   # i32[ncpl, maxv] matching side in the neighbor
    edge3d: jax.Array    # i32[nlay, ncpl, maxv] flowja edge id (−1 none)
    edge_sign: jax.Array  # f64[nlay, ncpl, maxv] outflow = sign·q_nm
    cell_area: jax.Array  # f64[ncpl]
    topz: jax.Array      # f64[nlay, ncpl]
    botz: jax.Array      # f64[nlay, ncpl]
    porosity: jax.Array  # f64[nlay, ncpl]
    active_cell: jax.Array  # bool[nlay, ncpl]
    vedge_up: jax.Array  # i32[nlay, ncpl] edge id toward layer above (−1)
    vedge_dn: jax.Array  # i32[nlay, ncpl] edge id toward layer below (−1)
    vsign_up: jax.Array  # f64: outflow across the top = sign·q_nm
    vsign_dn: jax.Array
    ncpl: int = 0
    nlay: int = 0
    maxv: int = 0


def build_fan(grid, topo, porosity) -> DisvFan:
    """Host-side fan construction from a DisvGrid + its Topology."""
    ncpl, nlay = grid.ncpl, grid.nlay
    verts = np.asarray(grid.vertices, float)
    # normalize each cell's vertex loop to CCW order
    loops = []
    for c in range(ncpl):
        vv = list(np.asarray(grid.cell_verts[c], int))
        if len(vv) > 1 and vv[0] == vv[-1]:
            vv = vv[:-1]
        pts = verts[vv]
        area2 = np.sum(pts[:, 0] * np.roll(pts[:, 1], -1)
                       - np.roll(pts[:, 0], -1) * pts[:, 1])
        if area2 < 0:
            vv = vv[::-1]
        loops.append(vv)
    maxv = max(len(v) for v in loops)

    px = np.zeros((ncpl, maxv))
    py = np.zeros((ncpl, maxv))
    qx = np.ones((ncpl, maxv))   # nonzero padding avoids 0-length sides
    qy = np.zeros((ncpl, maxv))
    tri_area = np.full((ncpl, maxv), 1.0)
    valid = np.zeros((ncpl, maxv), bool)
    nact = np.zeros(ncpl, np.int32)
    cxa = np.zeros(ncpl)
    cya = np.zeros(ncpl)
    cell_area = np.zeros(ncpl)
    side_of = {}                 # (vmin, vmax) -> [(cell, side)]
    for c, vv in enumerate(loops):
        k = len(vv)
        nact[c] = k
        pts = verts[vv]
        # polygon centroid (area-weighted; reference uses the same fan)
        x0, y0 = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        cross = x0 * y1 - x1 * y0
        A = 0.5 * np.sum(cross)
        cell_area[c] = A
        cxa[c] = np.sum((x0 + x1) * cross) / (6.0 * A)
        cya[c] = np.sum((y0 + y1) * cross) / (6.0 * A)
        for i in range(k):
            a, b = vv[i], vv[(i + 1) % k]
            px[c, i], py[c, i] = verts[a]
            qx[c, i], qy[c, i] = verts[b]
            tri_area[c, i] = 0.5 * abs(
                (verts[b][0] - verts[a][0]) * (cya[c] - verts[a][1])
                - (cxa[c] - verts[a][0]) * (verts[b][1] - verts[a][1]))
            valid[c, i] = True
            side_of.setdefault((min(a, b), max(a, b)), []).append((c, i))

    nbr_cell = np.full((ncpl, maxv), -1, np.int32)
    nbr_tri = np.full((ncpl, maxv), -1, np.int32)
    for sides in side_of.values():
        if len(sides) == 2:
            (c1, i1), (c2, i2) = sides
            nbr_cell[c1, i1], nbr_tri[c1, i1] = c2, i2
            nbr_cell[c2, i2], nbr_tri[c2, i2] = c1, i1

    # map topology edges onto fan sides / vertical faces
    edge3d = np.full((nlay, ncpl, maxv), -1, np.int32)
    edge_sign = np.zeros((nlay, ncpl, maxv))
    vedge_up = np.full((nlay, ncpl), -1, np.int32)
    vedge_dn = np.full((nlay, ncpl), -1, np.int32)
    vsign_up = np.zeros((nlay, ncpl))
    vsign_dn = np.zeros((nlay, ncpl))
    en = np.asarray(topo.edge_n)
    em = np.asarray(topo.edge_m)
    ihc = np.asarray(topo.ihc)
    for e in range(en.shape[0]):
        n, m = int(en[e]), int(em[e])
        if ihc[e] == 0:
            # vertical: m = n + ncpl (layer below n).  Convention:
            # outflow_across_face = sign · q_nm (q_nm = flow n→m).  For
            # the upper cell n the downward outflow IS q_nm (+1); for
            # the lower cell m the upward outflow is −q_nm (−1).
            ln, cn = divmod(n, ncpl)
            lm, cm = divmod(m, ncpl)
            vedge_dn[ln, cn] = e
            vsign_dn[ln, cn] = 1.0
            vedge_up[lm, cm] = e
            vsign_up[lm, cm] = -1.0
        else:
            ln, cn = divmod(n, ncpl)
            lm, cm = divmod(m, ncpl)
            if ln != lm:
                continue                 # staggered: not supported here
            found = False
            for i in range(nact[cn]):
                if nbr_cell[cn, i] == cm:
                    edge3d[ln, cn, i] = e
                    edge_sign[ln, cn, i] = 1.0     # outflow n→m = q_nm
                    j = nbr_tri[cn, i]
                    edge3d[lm, cm, j] = e
                    edge_sign[lm, cm, j] = -1.0
                    found = True
                    break
            if not found:
                raise ValueError(
                    f"DISV edge {n}-{m} has no shared polygon side")

    tops = np.concatenate([np.asarray(grid.top_surf)[None],
                           np.asarray(grid.botm)[:-1]], axis=0)
    return DisvFan(
        px=jnp.asarray(px), py=jnp.asarray(py),
        qx=jnp.asarray(qx), qy=jnp.asarray(qy),
        cx=jnp.asarray(cxa), cy=jnp.asarray(cya),
        tri_area=jnp.asarray(tri_area), nact=jnp.asarray(nact),
        valid=jnp.asarray(valid), nbr_cell=jnp.asarray(nbr_cell),
        nbr_tri=jnp.asarray(nbr_tri), edge3d=jnp.asarray(edge3d),
        edge_sign=jnp.asarray(edge_sign),
        cell_area=jnp.asarray(cell_area),
        topz=jnp.asarray(tops), botz=jnp.asarray(grid.botm),
        porosity=jnp.asarray(np.asarray(porosity).reshape(nlay, ncpl)),
        active_cell=jnp.asarray(np.asarray(grid.idomain).reshape(
            nlay, ncpl) > 0),
        vedge_up=jnp.asarray(vedge_up), vedge_dn=jnp.asarray(vedge_dn),
        vsign_up=jnp.asarray(vsign_up), vsign_dn=jnp.asarray(vsign_dn),
        ncpl=ncpl, nlay=nlay, maxv=maxv)


def fan_fluxes(fan: DisvFan, q_edge):
    """Per-step device prep: outer-side outflows, vertical outflows, and
    the internal fan chain (TernarySolveTrack subcell mass balance).

    Returns (Qout[nlay,ncpl,maxv], u[nlay,ncpl,maxv], qzt, qzb) where
    ``u[l,c,i]`` is the flux from triangle i into triangle i+1 and qzt/
    qzb are per-TRIANGLE vertical outflows (area shares incl. the
    divergence residual)."""
    q_nm = -q_edge      # q_edge is positive into edge_n (repo convention)
    qpad = jnp.concatenate([q_nm, jnp.zeros(1)])
    Qout = qpad[fan.edge3d] * fan.edge_sign
    Qout = jnp.where(fan.valid[None], Qout, 0.0)
    qz_up = qpad[fan.vedge_up] * fan.vsign_up
    qz_dn = qpad[fan.vedge_dn] * fan.vsign_dn
    # area shares per triangle
    share = fan.tri_area / fan.cell_area[:, None]
    share = jnp.where(fan.valid, share, 0.0)
    qzt = qz_up[:, :, None] * share[None]
    qzb = qz_dn[:, :, None] * share[None]
    # residual divergence (boundary sinks/sources, storage) enters the
    # chain as a distributed area-share term so it telescopes exactly —
    # but NOT the vertical faces: the kernel's RT0 divergence c then
    # carries the sink, so strong-sink cells trap particles (TERM_WEAK)
    # instead of ejecting them through a fictitious z face
    resid = (jnp.sum(Qout, axis=2) + qz_up + qz_dn)
    # chain: u_i = u_{i−1} − (Qout_i + qz_i − resid_i·share_i) — the
    # sink term −resid·share balances each triangle; gauge: zero-mean
    # over the active sides (minimal circulation)
    t_out = Qout + qzt + qzb - resid[:, :, None] * share[None]
    cums = jnp.cumsum(jnp.where(fan.valid[None], t_out, 0.0), axis=2)
    nact = jnp.maximum(fan.nact, 1).astype(cums.dtype)
    mean = jnp.sum(jnp.where(fan.valid[None], cums, 0.0), axis=2) \
        / nact[None]
    u = -(cums - mean[:, :, None])
    return Qout, u, qzt, qzb


def _edge_exit(c, nux, nuy, dconst_x, dconst_y, bx, by, x, y, band):
    """Exit time through the line n·x = b from inside (φ0 = n·x − b < 0)
    for the field v = c·x + d (scalar c) — Pollock-form log1p.

    A particle within ``band`` of the edge (e.g. released on the fan
    apex, or arriving exactly on a shared edge) exits immediately with
    t = 0 when the flow points outward — the vectorized equivalent of
    the reference's vertex/edge nudging.  RT0 normal-flux continuity
    guarantees the neighboring triangle never bounces it straight back.
    """
    phi0 = nux * x + nuy * y - (nux * bx + nuy * by)
    # rate of φ at the particle = n·v(x)
    nu0 = nux * (c * x + dconst_x) + nuy * (c * y + dconst_y)
    ok = (nu0 > 0) & (phi0 < band)
    lin = jnp.abs(c) * jnp.abs(phi0) < 1e-12 * (jnp.abs(nu0) + _EPS)
    c_safe = jnp.where(c != 0, c, 1.0)
    nu_safe = jnp.where(nu0 != 0, nu0, 1.0)
    rel = c * (-phi0) / nu_safe
    t = jnp.where(lin, -phi0 / nu_safe,
                  jnp.log1p(jnp.maximum(rel, -1.0 + _EPS)) / c_safe)
    t = jnp.where(phi0 >= 0, 0.0, t)
    t = jnp.where(ok & (rel > -1.0) & (t >= 0), t, DINF)
    return t


def make_tracker_disv(fan: DisvFan, max_transitions: int = 8192):
    """Build the jittable DISV swarm tracker.

    track(x, y, z, lay, cell, tri, Qout, u, qzt, qzb, sat, tmax) → final
    state dict (vmapped over particles)."""
    ncpl, nlay, maxv = fan.ncpl, fan.nlay, fan.maxv

    def one(x, y, z, lay, cell, tri, Qout, u, qzt, qzb, sat, tmax):

        def cond(st):
            return (st[7] == ACTIVE) & (st[9] < max_transitions)

        def body(st):
            x, y, z, lay, cell, tri, trem, status, t_el, nhops = st
            k = fan.nact[cell]
            tri_n = (tri + 1) % k
            tri_p = (tri + k - 1) % k
            ztop = fan.topz[lay, cell]
            zbot = fan.botz[lay, cell]
            dz = jnp.maximum(ztop - zbot, _EPS)
            theta = fan.porosity[lay, cell]
            satf = jnp.maximum(sat[lay, cell], 1e-8)
            hvol = dz * theta * satf           # horizontal flux→velocity
            A = fan.tri_area[cell, tri]

            # triangle vertices: P (side start), Q (side end), C centroid
            Px, Py = fan.px[cell, tri], fan.py[cell, tri]
            Qx, Qy = fan.qx[cell, tri], fan.qy[cell, tri]
            Cx, Cy = fan.cx[cell], fan.cy[cell]

            # RT0 edge fluxes (outward, per unit thickness):
            #   outer edge P→Q: Qout; internal Q→C: u_i; internal C→P:
            #   −u_{i−1}
            q1 = Qout[lay, cell, tri] / hvol
            q2 = u[lay, cell, tri] / hvol
            q3 = -u[lay, cell, tri_p] / hvol
            inv2A = 1.0 / (2.0 * A)
            # v(x) = [q1(x−C) + q2(x−P) + q3(x−Q)]·inv2A = c·x + d
            c = (q1 + q2 + q3) * inv2A
            dx_ = -(q1 * Cx + q2 * Px + q3 * Qx) * inv2A
            dy_ = -(q1 * Cy + q2 * Py + q3 * Qy) * inv2A

            # outward normals of the three edges (CCW polygon → outward
            # normal of edge a→b is (by−ay, ax−bx))
            def nrm(ax, ay, bx, by):
                return by - ay, ax - bx

            n1x, n1y = nrm(Px, Py, Qx, Qy)       # outer
            n2x, n2y = nrm(Qx, Qy, Cx, Cy)       # internal → tri+1
            n3x, n3y = nrm(Cx, Cy, Px, Py)       # internal → tri−1
            charlen = jnp.sqrt(2.0 * A)
            b1 = 1e-9 * charlen * jnp.hypot(n1x, n1y)
            b2 = 1e-9 * charlen * jnp.hypot(n2x, n2y)
            b3 = 1e-9 * charlen * jnp.hypot(n3x, n3y)
            t1 = _edge_exit(c, n1x, n1y, dx_, dy_, Px, Py, x, y, b1)
            t2 = _edge_exit(c, n2x, n2y, dx_, dy_, Qx, Qy, x, y, b2)
            t3 = _edge_exit(c, n3x, n3y, dx_, dy_, Cx, Cy, x, y, b3)

            # vertical Pollock between the triangle's z faces
            az = A * theta
            vz1 = -qzb[lay, cell, tri] / az      # +z velocity at bottom
            vz2 = qzt[lay, cell, tri] / az       # +z velocity at top
            Az = (vz2 - vz1) / dz
            sz = z - zbot
            vzp = vz1 + Az * sz
            linz = jnp.abs(Az) * dz < 1e-12 * (jnp.abs(vz1)
                                               + jnp.abs(vz2) + _EPS)
            vz_safe = jnp.where(vzp != 0, vzp, 1.0)
            Az_safe = jnp.where(Az != 0, Az, 1.0)
            rel_hi = Az * (dz - sz) / vz_safe
            tz_hi = jnp.where(linz, (dz - sz) / vz_safe,
                              jnp.log1p(jnp.maximum(rel_hi, -1.0 + _EPS))
                              / Az_safe)
            tz_hi = jnp.where((vzp > 0) & (vz2 > 0) & (rel_hi > -1.0)
                              & (tz_hi > 0), tz_hi, DINF)
            rel_lo = Az * (0.0 - sz) / vz_safe
            tz_lo = jnp.where(linz, -sz / vz_safe,
                              jnp.log1p(jnp.maximum(rel_lo, -1.0 + _EPS))
                              / Az_safe)
            tz_lo = jnp.where((vzp < 0) & (vz1 < 0) & (rel_lo > -1.0)
                              & (tz_lo > 0), tz_lo, DINF)

            t_exit = jnp.minimum(jnp.minimum(t1, t2),
                                 jnp.minimum(t3, jnp.minimum(tz_hi,
                                                             tz_lo)))
            no_exit = ~jnp.isfinite(t_exit)
            dt = jnp.where(no_exit, 0.0, jnp.minimum(t_exit, trem))

            # advance: x(t) = (x0 + d/c)e^{ct} − d/c, linear fallback
            linc = jnp.abs(c) * dt < 1e-12
            c_s = jnp.where(c != 0, c, 1.0)
            em1 = jnp.expm1(c * dt)
            x2 = jnp.where(linc, x + (c * x + dx_) * dt,
                           x + (x + dx_ / c_s) * em1)
            y2 = jnp.where(linc, y + (c * y + dy_) * dt,
                           y + (y + dy_ / c_s) * em1)
            sz2 = jnp.clip(jnp.where(linz, sz + vzp * dt,
                                     sz + vzp * jnp.expm1(Az * dt)
                                     / Az_safe), 0.0, dz)
            z2 = zbot + sz2

            out_of_time = (trem <= t_exit) & ~no_exit
            hit1 = (t_exit == t1) & ~out_of_time & ~no_exit
            hit2 = (t_exit == t2) & ~out_of_time & ~no_exit
            hit3 = (t_exit == t3) & ~out_of_time & ~no_exit
            hit_up = (t_exit == tz_hi) & ~out_of_time & ~no_exit
            hit_dn = (t_exit == tz_lo) & ~out_of_time & ~no_exit

            ncell = fan.nbr_cell[cell, tri]
            ntri = fan.nbr_tri[cell, tri]
            cell2 = jnp.where(hit1 & (ncell >= 0), ncell, cell)
            tri2 = jnp.where(hit1 & (ncell >= 0), jnp.maximum(ntri, 0),
                             jnp.where(hit2, tri_n,
                                       jnp.where(hit3, tri_p, tri)))
            lay2 = lay + jnp.where(hit_up, -1, 0) + jnp.where(hit_dn, 1, 0)

            left = (hit1 & (ncell < 0)) | (lay2 < 0) | (lay2 >= nlay)
            lay2c = jnp.clip(lay2, 0, nlay - 1)
            inactive = ~fan.active_cell[lay2c, cell2]
            status2 = jnp.where(
                no_exit, TERM_WEAK,
                jnp.where(out_of_time, TERM_TIMEOUT,
                          jnp.where(left | inactive, TERM_BOUNDARY,
                                    ACTIVE)))
            return (x2, y2, z2, lay2c, cell2, tri2,
                    jnp.maximum(trem - dt, 0.0), status2, t_el + dt,
                    nhops + 1)

        init = (x, y, z, lay, cell, tri, tmax, ACTIVE, 0.0,
                jnp.asarray(0, jnp.int32))
        x2, y2, z2, l2, c2, t2_, trem, status, t_el, hops = \
            jax.lax.while_loop(cond, body, init)
        return dict(x=x2, y=y2, z=z2, lay=l2, cell=c2, tri=t2_,
                    status=status, time=t_el, transitions=hops)

    def track(x, y, z, lay, cell, tri, Qout, u, qzt, qzb, sat, tmax):
        f = jax.vmap(lambda xi, yi, zi, li, ci, ti: one(
            xi, yi, zi, li, ci, ti, Qout, u, qzt, qzb, sat, tmax))
        return f(x, y, z, lay, cell, tri)

    return track


def locate(fan: DisvFan, x, y, z):
    """Host-side release-point location → (lay, cell, tri)."""
    px = np.asarray(fan.px)
    py = np.asarray(fan.py)
    qx = np.asarray(fan.qx)
    qy = np.asarray(fan.qy)
    cx = np.asarray(fan.cx)
    cy = np.asarray(fan.cy)
    val = np.asarray(fan.valid)
    topz = np.asarray(fan.topz)
    botz = np.asarray(fan.botz)
    x, y, z = (np.asarray(v, float) for v in (x, y, z))
    cells = np.zeros(x.shape, np.int32)
    tris = np.zeros(x.shape, np.int32)
    lays = np.zeros(x.shape, np.int32)
    for p in range(x.shape[0]):
        found = False
        for c in range(fan.ncpl):
            for i in range(fan.maxv):
                if not val[c, i]:
                    continue
                pts = [(px[c, i], py[c, i]), (qx[c, i], qy[c, i]),
                       (cx[c], cy[c])]
                s = []
                for (ax, ay), (bx, by) in zip(pts, pts[1:] + pts[:1]):
                    s.append((bx - ax) * (y[p] - ay)
                             - (x[p] - ax) * (by - ay))
                if all(v >= -1e-12 for v in s):
                    cells[p], tris[p] = c, i
                    found = True
                    break
            if found:
                break
        if not found:
            raise ValueError(f"release point {p} outside the grid")
        for L in range(fan.nlay):
            if z[p] <= topz[L, cells[p]] and z[p] >= botz[L, cells[p]]:
                lays[p] = L
                break
        else:
            lays[p] = 0 if z[p] > topz[0, cells[p]] else fan.nlay - 1
    return lays, cells, tris
