"""SWF: surface-water flow models (diffusive wave) — the CHF (channel,
DISV1D) and OLF (overland, DIS2D) model family.

Behavioral parity targets in the reference:
- DFW package: Manning's-equation conductance between reaches,
  src/SurfaceWaterFlow/swf-dfw.f90: qcalc (cond·Δstage), get_cond:707-790
  (upstream/central depth weighting, quadratic depth smoothing over 1e-6,
  harmonic mean of half-cell conductances), get_cond_n:796-823
  (conveyance/(dx·√dhds)), and the Newton fill by numerical perturbation
  dfw_qnm_fc_nr:564-643.
- STO package (swf-sto.f90): surface storage V = A·depth per step.
- FLW point inflows; ZDG zero-depth-gradient outflow boundary
  (swf-zdg.f90): q = −conveyance(depth)·√slope.
- CHF/OLF thin wrappers (chf.f90:22, olf.f90:22): same engine on a 1-D
  channel topology (DISV1D role) or a 2-D raster (DIS2D role).

Design: all reach state is dense vectors; the Newton Jacobian is
assembled edge-wise from three vectorized conductance evaluations (base,
stage_n+ε, stage_m+ε) — the same finite-difference linearization the
reference uses, with no scalar loops.  The model plugs into the standard
NumericalSolution/ImsSettings stack (BiCGSTAB — the Jacobian is
asymmetric).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ...constants import DPREC, DZERO
from ..discretization.topology import Topology
from ..gwf import npf as npf_mod

DEM10 = 1.0e-10
SMOOTH_RANGE = 1.0e-6


@dataclasses.dataclass(frozen=True)
class Disv1dGrid:
    """A 1-D chain/network of reaches (the DISV1D role, Disv1d.f90).

    Each reach has a length, width, and bottom elevation; connections are
    user-supplied pairs (defaults to a simple chain).
    """

    nodes: int
    length: np.ndarray   # f64[n] reach length
    width: np.ndarray    # f64[n] reach width
    bot: np.ndarray      # f64[n] streambed elevation
    pairs: list          # [(n, m)] connections

    @staticmethod
    def chain(length, width, bot):
        length = np.asarray(length, np.float64)
        n = length.shape[0]
        width = np.broadcast_to(np.asarray(width, np.float64), (n,)).copy()
        bot = np.broadcast_to(np.asarray(bot, np.float64), (n,)).copy()
        return Disv1dGrid(n, length, width, bot,
                          [(i, i + 1) for i in range(n - 1)])

    @property
    def shape(self):
        return (self.nodes,)

    @property
    def idomain(self):
        return np.ones(self.nodes, np.int32)

    @property
    def area(self):
        return self.length * self.width

    @property
    def top(self):
        return self.bot + 1e30   # unbounded stage

    def build_topology(self) -> Topology:
        n = np.array([min(a, b) for a, b in self.pairs], np.int32)
        m = np.array([max(a, b) for a, b in self.pairs], np.int32)
        cl1 = 0.5 * self.length[n]
        cl2 = 0.5 * self.length[m]
        # hwva = flow width perpendicular to the connection
        hwva = 0.5 * (self.width[n] + self.width[m])
        return Topology(
            nodes=self.nodes, edge_n=n, edge_m=m,
            ihc=np.ones(len(self.pairs), np.int32),
            cl1=cl1, cl2=cl2, hwva=hwva,
            direction=np.full(len(self.pairs), -1, np.int32),
            anglex=np.zeros(len(self.pairs)))


def _squadratic(x, rng=SMOOTH_RANGE):
    """Quadratic 0→1 smoothing of x over [0, rng] (SmoothingModule
    sQuadratic role): returns the smoothing factor."""
    t = jnp.clip(x / rng, 0.0, 1.0)
    return t * (2.0 - t)


def _perturb(x):
    """Numerical-derivative step (MathUtil get_perturbation role)."""
    return jnp.sqrt(DPREC) * jnp.maximum(jnp.abs(x), 1.0)


@dataclasses.dataclass(frozen=True)
class SwfPackageData:
    """Per-sweep stress data pytree (so exchange-coupled inflows pass
    through jit as arguments, not stale closure constants).

    ``lkg``: head-dependent leakage to an external head (the SWF side of
    the SWF-GWF exchange): (node, bhead, cond) — q into the reach is
    cond·(bhead − stage), with infiltration smoothly shut off as the
    reach dries (exg-swfgwf qcalc role)."""

    flw: object = None
    lkg: object = None


jax.tree_util.register_dataclass(SwfPackageData,
                                 data_fields=["flw", "lkg"],
                                 meta_fields=[])


@dataclasses.dataclass
class SwfModel:
    """Diffusive-wave surface water model (CHF/OLF engine)."""

    name: str
    grid: object                 # Disv1dGrid or DisGrid (nlay=1)
    topo: Topology
    dtopo: npf_mod.DeviceTopology
    bot: jax.Array               # f64[N] bed/land elevation
    manningsn: jax.Array         # f64[N]
    strt: jax.Array              # initial stage
    ibound0: jax.Array
    unitconv: float = 1.0
    icentral: int = 1            # 1=central depth weighting, 0=upstream
    transient: bool = True
    flw: object = None           # (node[i32 B], q[f64 B], mask[bool B])
    chd: object = None           # (node, stage, mask) constant-stage cells
    zdg: object = None           # (node, idcxs?, width, slope, rough, mask)
    pcp: object = None           # (node, rate, mask) precipitation
    evp: object = None           # (node, rate, mask) evaporation
    cdb: object = None           # (node, width, mask) critical-depth bnd
    gravconv: float = 9.80665    # DGRAVITY·lengthconv·timeconv² (swf-cdb)
    inewton: int = 1
    use_structured: bool = False
    sto_arrays: object = None    # presence flags transient storage
    xt3d = None
    # per-node n-point cross sections (CXS package, swf-cxs.f90 via
    # ops/cxs.py); None → rectangular wide-channel conveyance
    xs_station: object = None    # f64[N, P]
    xs_height: object = None     # f64[N, P]
    xs_rf: object = None         # f64[N, P-1]
    xs_rect: object = None       # bool[N]
    has_xs: object = None        # bool[N] node has a section assigned

    @property
    def nodes(self) -> int:
        return self.dtopo.nodes

    @property
    def is_linear(self) -> bool:
        return False

    @property
    def packages(self):
        return SwfPackageData(flw=self.flw)

    def boundary_state(self, stage, pkgs=None):
        ibound = jnp.asarray(self.ibound0, jnp.int32)
        if self.chd is not None:
            node, val, mask = self.chd
            ibound = ibound.at[node].set(jnp.where(mask, -1, ibound[node]))
            stage = stage.at[node].set(jnp.where(mask, val, stage[node]))
        return ibound, stage

    # ----------------------------------------------------------- hydraulics

    def _conveyance(self, depth, width, rough):
        """Rectangular (wide-channel) conveyance a·r^(2/3)/rough with
        r = depth (CxsType.get_conveyance default path)."""
        d = jnp.maximum(depth, DZERO)
        return width * d * d ** (2.0 / 3.0) / rough

    def _conveyance_at(self, nodes, depth, width, rough):
        """Conveyance at given cells: n-point section (CXS) when the cell
        has one, rectangular wide-channel otherwise."""
        rect = self._conveyance(depth, width, rough)
        if self.xs_station is None:
            return rect
        from ...ops import cxs
        cx = cxs.conveyance(self.xs_station[nodes], self.xs_height[nodes],
                            self.xs_rf[nodes], rough,
                            jnp.maximum(depth, DZERO),
                            self.xs_rect[nodes])
        return jnp.where(self.has_xs[nodes], cx, rect)

    def _half_cond(self, nodes, depth, dx, width, dhds, rough):
        """get_cond_n: unitconv·conveyance/(dx·√dhds)."""
        dhds_sqr = jnp.maximum(jnp.sqrt(jnp.maximum(dhds, DZERO)), DEM10)
        return self.unitconv * self._conveyance_at(nodes, depth, width,
                                                   rough) / dx / dhds_sqr

    def _edge_q(self, sn, sm):
        """Flow m→n per canonical edge at given end stages (qcalc)."""
        t = self.dtopo
        n, m = t.edge_n, t.edge_m
        cl1, cl2 = t.cl1, t.cl2
        length = cl1 + cl2
        depth_n = sn - self.bot[n]
        depth_m = sm - self.bot[m]
        dhds = jnp.abs(sm - sn) / length
        if self.icentral == 0:
            up_n = sn > sm
            depth_n, depth_m = (jnp.where(up_n, depth_n, depth_m),
                                jnp.where(up_n, depth_n, depth_m))
        depth_n = depth_n * _squadratic(depth_n)
        depth_m = depth_m * _squadratic(depth_m)
        rough_n = self.manningsn[n]
        rough_m = self.manningsn[m]
        cn = self._half_cond(n, depth_n, cl1, t.hwva, dhds, rough_n)
        cm = self._half_cond(m, depth_m, cl2, t.hwva, dhds, rough_m)
        cond = jnp.where(cn + cm > DPREC, cn * cm / (cn + cm), DZERO)
        return cond * (sm - sn)

    def _zdg_q(self, stage):
        """ZDG outflow (swf-zdg.f90): q = −unitconv·conveyance(depth)·√S0."""
        node, width, slope, rough, mask = self.zdg
        depth = stage[node] - self.bot[node]
        depth = depth * _squadratic(depth)
        conv = self._conveyance(depth, width, rough)
        return jnp.where(mask, -self.unitconv * conv * jnp.sqrt(slope),
                         DZERO)

    # ------------------------------------------------------------ assembly

    def assemble(self, stage, stage_old, ibound, delt, iss: bool,
                 pkgs=None, newton: bool = True):
        """Newton system by edge-wise numerical perturbation
        (dfw_qnm_fc_nr) + storage + boundary packages."""
        t = self.dtopo
        n, m = t.edge_n, t.edge_m
        N, K = self.nodes, t.max_degree
        act_e = (ibound[n] != 0) & (ibound[m] != 0)

        sn, sm = stage[n], stage[m]
        q0 = self._edge_q(sn, sm)
        en = _perturb(sn)
        em = _perturb(sm)
        dq_dn = (self._edge_q(sn + en, sm) - q0) / en
        dq_dm = (self._edge_q(sn, sm + em) - q0) / em
        q0 = jnp.where(act_e, q0, DZERO)
        dq_dn = jnp.where(act_e, dq_dn, DZERO)
        dq_dm = jnp.where(act_e, dq_dm, DZERO)

        diag = jnp.zeros(N)
        off = jnp.zeros(N * K)
        rhs = jnp.zeros(N)
        # row n: rhs -= q; amat(n,n) += dq/dsn; amat(n,m) += dq/dsm;
        # rhs += dq/dsn·sn + dq/dsm·sm   (Newton linearization)
        diag = diag.at[n].add(dq_dn).at[m].add(-dq_dm)
        off = off.at[t.slot_nm].add(dq_dm)
        off = off.at[t.slot_mn].add(-dq_dn)
        rhs = rhs.at[n].add(-q0 + dq_dn * sn + dq_dm * sm)
        rhs = rhs.at[m].add(q0 - dq_dm * sm - dq_dn * sn)

        # storage: A·(depth − depth_old)/delt leaves the cell
        if self.transient and not iss:
            area = jnp.asarray(self.grid.area)
            dnew = stage - self.bot
            fnew = _squadratic(dnew)
            dold = (stage_old - self.bot)
            dold = dold * _squadratic(dold)
            # d(V)/ds via perturbation of the smoothed depth
            eps = _perturb(stage)
            dpert = (stage + eps) - self.bot
            vterm = area / delt
            dvds = vterm * ((dpert * _squadratic(dpert) - dnew * fnew)
                            / eps)
            q_sto = -vterm * (dnew * fnew - dold)
            act = ibound > 0
            diag = diag + jnp.where(act, -dvds, DZERO)
            rhs = rhs + jnp.where(act, -q_sto - dvds * stage, DZERO)

        flw = self.flw
        if pkgs is not None and getattr(pkgs, "flw", None) is not None:
            flw = pkgs.flw
        if flw is not None:
            node, qin, mask = flw
            act = mask & (ibound[node] > 0)
            rhs = rhs.at[node].add(jnp.where(act, -qin, DZERO))

        lkg = getattr(pkgs, "lkg", None) if pkgs is not None else None
        if lkg is not None:
            node, bhead, lcond = lkg

            def q_lkg(st):
                depth = st[node] - self.bot[node]
                f = _squadratic(depth, 1e-4)
                dh = bhead - st[node]
                return lcond * jnp.where(dh < 0, f * dh, dh)

            act = ibound[node] > 0
            q = q_lkg(stage)
            eps = _perturb(stage[node])
            qp = q_lkg(stage.at[node].add(eps))
            dq = (qp - q) / eps
            diag = diag.at[node].add(jnp.where(act, dq, DZERO))
            rhs = rhs.at[node].add(
                jnp.where(act, -q + dq * stage[node], DZERO))

        if self.zdg is not None:
            node = self.zdg[0]
            mask = self.zdg[4]
            act = mask & (ibound[node] > 0)
            q = self._zdg_q(stage)
            eps = _perturb(stage[node])
            stage_p = stage.at[node].add(eps)
            qp = self._zdg_q(stage_p)
            dq = (qp - q) / eps
            diag = diag.at[node].add(jnp.where(act, dq, DZERO))
            rhs = rhs.at[node].add(
                jnp.where(act, -q + dq * stage[node], DZERO))

        # PCP precipitation: rate × water-surface area, stage-independent
        # (swf-pcp.f90 qpcp = precipitation·area)
        if self.pcp is not None:
            node, rate, mask = self.pcp
            act = mask & (ibound[node] > 0)
            area = jnp.asarray(self.grid.area).reshape(-1)[node]
            rhs = rhs.at[node].add(jnp.where(act, -rate * area, DZERO))

        # EVP evaporation: −rate × area, smoothly shut off as the reach
        # dries (swf-evp.f90 reduction_depth ramp); Newton by perturbation
        if self.evp is not None:
            node, rate, mask = self.evp
            act = mask & (ibound[node] > 0)
            area = jnp.asarray(self.grid.area).reshape(-1)[node]

            def q_evp(st):
                depth = st[node] - self.bot[node]
                return -rate * area * _squadratic(depth, 1e-6)

            q = q_evp(stage)
            eps = _perturb(stage[node])
            qp = q_evp(stage.at[node].add(eps))
            dq = (qp - q) / eps
            diag = diag.at[node].add(jnp.where(act, dq, DZERO))
            rhs = rhs.at[node].add(
                jnp.where(act, -q + dq * stage[node], DZERO))

        # CDB critical-depth outflow: q = −√(gravconv·a²·r)
        # (swf-cdb.f90 qcalc; rectangular a = w·d, r = d)
        if self.cdb is not None:
            node, width_c, mask = self.cdb
            act = mask & (ibound[node] > 0)

            def q_cdb(st):
                d = jnp.maximum(st[node] - self.bot[node], DZERO)
                a = width_c * d
                val = self.gravconv * a * a * d
                return -jnp.where(val > DPREC, jnp.sqrt(val), DZERO)

            q = q_cdb(stage)
            eps = _perturb(stage[node])
            qp = q_cdb(stage.at[node].add(eps))
            dq = (qp - q) / eps
            diag = diag.at[node].add(jnp.where(act, dq, DZERO))
            rhs = rhs.at[node].add(
                jnp.where(act, -q + dq * stage[node], DZERO))

        return diag, off.reshape(N, K), rhs

    def edge_conductances(self, stage, ibound, pkgs=None):
        return jnp.zeros_like(self.dtopo.cl1)

    def edge_flows(self, stage, ibound, cond=None, pkgs=None):
        """Per-edge flow (positive into edge_n), dfw_cq role."""
        t = self.dtopo
        q = self._edge_q(stage[t.edge_n], stage[t.edge_m])
        act = (ibound[t.edge_n] != 0) & (ibound[t.edge_m] != 0)
        return jnp.where(act, q, DZERO)

    def boundary_budget(self, stage, ibound, pkgs=None):
        out = {}
        if self.flw is not None:
            node, qin, mask = self.flw
            out["FLW"] = jnp.where(mask & (ibound[node] > 0), qin, DZERO)
        lkg = getattr(pkgs, "lkg", None) if pkgs is not None else None
        if lkg is not None:
            node, bhead, lcond = lkg

            def q_lkg(st):
                depth = st[node] - self.bot[node]
                f = _squadratic(depth, 1e-4)
                dh = bhead - st[node]
                return lcond * jnp.where(dh < 0, f * dh, dh)

            act = ibound[node] > 0
            out["LKG"] = jnp.where(act, q_lkg(stage), DZERO)

        if self.zdg is not None:
            out["ZDG"] = self._zdg_q(stage)
        if self.pcp is not None:
            node, rate, mask = self.pcp
            area = jnp.asarray(self.grid.area).reshape(-1)[node]
            out["PCP"] = jnp.where(mask & (ibound[node] > 0), rate * area,
                                   DZERO)
        if self.evp is not None:
            node, rate, mask = self.evp
            area = jnp.asarray(self.grid.area).reshape(-1)[node]
            depth = stage[node] - self.bot[node]
            out["EVP"] = jnp.where(
                mask & (ibound[node] > 0),
                -rate * area * _squadratic(depth, 1e-6), DZERO)
        if self.cdb is not None:
            node, width_c, mask = self.cdb
            d = jnp.maximum(stage[node] - self.bot[node], DZERO)
            val = self.gravconv * (width_c * d) ** 2 * d
            out["CDB"] = jnp.where(
                mask & (ibound[node] > 0),
                -jnp.where(val > DPREC, jnp.sqrt(val), DZERO), DZERO)
        return out


def _pack(entries, ncols):
    if not entries:
        return None
    arr = np.asarray(entries, np.float64)
    node = jnp.asarray(arr[:, 0].astype(np.int32))
    cols = [jnp.asarray(arr[:, i + 1]) for i in range(ncols)]
    return (node, *cols, jnp.ones(arr.shape[0], bool))


def build_chf(name, grid: Disv1dGrid, *, manningsn=0.035, strt=None,
              unitconv=1.0, icentral=1, flw=None, chd=None, zdg=None,
              pcp=None, evp=None, cdb=None,
              transient=True, cxs_sections=None, idcxs=None) -> SwfModel:
    """Channel-flow model (chf.f90 role) on a 1-D reach network.
    ``cxs_sections``: list of (xfraction, height[, manfraction]) n-point
    sections; ``idcxs``: 1-based section id per reach (0 = rectangular),
    the CXS package role (swf-cxs.f90)."""
    return _build_swf(name, grid, manningsn, strt, unitconv, icentral,
                      flw, chd, zdg, transient, cxs_sections, idcxs,
                      pcp=pcp, evp=evp, cdb=cdb)


def build_olf(name, grid, *, manningsn=0.035, strt=None, unitconv=1.0,
              icentral=1, flw=None, chd=None, zdg=None,
              pcp=None, evp=None, cdb=None,
              transient=True, cxs_sections=None, idcxs=None) -> SwfModel:
    """Overland-flow model (olf.f90 role) on a DIS raster (nlay=1); the
    grid's ``botm`` is the land-surface elevation."""
    return _build_swf(name, grid, manningsn, strt, unitconv, icentral,
                      flw, chd, zdg, transient, cxs_sections, idcxs,
                      pcp=pcp, evp=evp, cdb=cdb)


def _build_swf(name, grid, manningsn, strt, unitconv, icentral, flw, chd,
               zdg, transient, cxs_sections=None, idcxs=None, pcp=None,
               evp=None, cdb=None):
    topo = grid.build_topology()
    dtopo = npf_mod.DeviceTopology.from_host(topo)
    # the solver path uses the general (gather) matvec: stage problems are
    # small relative to GWF and the Jacobian is edge-assembled anyway
    dtopo = dataclasses.replace(dtopo, grid_shape=None)
    N = grid.nodes
    bot = jnp.asarray(np.asarray(grid.bot, np.float64).reshape(-1))
    mn = jnp.asarray(np.broadcast_to(np.asarray(manningsn, np.float64),
                                     (N,)).copy())
    strt_v = (bot + 0.0 if strt is None
              else jnp.asarray(np.broadcast_to(
                  np.asarray(strt, np.float64), (N,)).copy()))
    xs = {}
    if cxs_sections:
        # per-node section assignment (CXS packagedata idcxs role):
        # sections are (xfraction, height[, manfraction]) with stations
        # scaled by the cell width
        from ...ops import cxs as cxs_mod
        width = np.broadcast_to(
            np.asarray(getattr(grid, "width", 1.0), np.float64),
            (N,)).copy()
        secs = []
        has = np.zeros(N, bool)
        for node in range(N):
            isec = -1 if idcxs is None else int(idcxs[node]) - 1
            if 0 <= isec < len(cxs_sections):
                xf, hts = cxs_sections[isec][0], cxs_sections[isec][1]
                rf = (cxs_sections[isec][2]
                      if len(cxs_sections[isec]) > 2 else None)
                st = np.asarray(xf, np.float64) * width[node]
                secs.append((st, hts, rf))
                has[node] = True
            else:
                secs.append(([0.0, 1.0], [0.0, 0.0], None))
        st, ht, rf, rect = cxs_mod.pack_sections(secs)
        xs = dict(xs_station=jnp.asarray(st), xs_height=jnp.asarray(ht),
                  xs_rf=jnp.asarray(rf), xs_rect=jnp.asarray(rect),
                  has_xs=jnp.asarray(has))
    return SwfModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo, bot=bot,
        manningsn=mn, strt=strt_v,
        ibound0=jnp.asarray(np.asarray(grid.idomain).reshape(-1) > 0,
                            jnp.int32),
        unitconv=unitconv, icentral=icentral, transient=transient,
        flw=_pack(flw, 1), chd=_pack(chd, 1),
        zdg=_pack(zdg, 3), pcp=_pack(pcp, 1), evp=_pack(evp, 1),
        cdb=_pack(cdb, 1), **xs)
