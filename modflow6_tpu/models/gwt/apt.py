"""APT: advanced-package transport (LKT/SFT/MWT) and MVT mover transport.

Behavioral parity targets:
- src/Model/TransportModel/tsp-apt.f90 (2,963 LoC): the shared base for
  lake (LKT), stream (SFT), well (MWT) transport — each flow-package
  feature gets its own concentration DOF; feature equations carry
  storage d(V·c)/dt, upstream-weighted advective exchange with the host
  cells at the FMI-provided package flows, external inflows at source
  concentrations, outflows at the feature concentration, and
  feature→feature routing (stream network, lake outlets).
- src/Model/TransportModel/tsp-mvt.f90 (905 LoC): mover transport —
  water moved by MVR carries the provider's concentration into the
  receiver feature.
- The GWE analogs (gwe-lke/sfe/mwe.f90) are the same equations scaled by
  eqnsclfac (energy per unit temperature) — pass a GWE-configured base
  model and the scaling rides through.

Design: mirrors AugmentedGwfModel — the transport vector becomes
x = [conc(N), c_feat(R)] with the same widened neighbor table; because
the flow field is frozen within a transport step, ALL feature terms are
linear and enter the matrix directly (no Picard lagging), including the
feature→feature routing entries (asymmetric — BiCGSTAB).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import DZERO
from ..gwf.advanced import _build_ext_table, AugTopo


@partial(jax.tree_util.register_dataclass,
         data_fields=["fields", "q_conn", "v_new", "v_old", "ext_q",
                      "ext_conc", "out_q", "pair_q", "mvr_cell_q",
                      "mvr_cell_node"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class AptFlows:
    """Per-step coupling data for the augmented transport model.

    fields:   base fmi.FlowFields for the grid part
    q_conn:   f64[C_all] flow per feature↔cell connection (positive into
              the aquifer), ordered as the connection edges
    v_new/v_old: f64[R] feature volumes at the new/old time level
    ext_q:    f64[R] external inflow rate per feature (rain/runoff/
              specified inflow/mvr-from-nonfeature already folded in)
    ext_conc: f64[R] flow-weighted source concentration of ext_q
    out_q:    f64[R] total outflow leaving each feature at its own
              concentration (outlets, downstream routing, withdrawals,
              pumping, TO-MVR)
    pair_q:   f64[P] flow for each feature→feature edge (routing, lake
              outlets, diversions, feature-to-feature movers)
    mvr_cell_q/mvr_cell_node: flows moved from non-feature providers
              (WEL/DRN/...) into features, carrying the provider CELL's
              concentration (edges built per mover)
    """

    fields: object
    q_conn: jax.Array
    v_new: jax.Array
    v_old: jax.Array
    ext_q: jax.Array
    ext_conc: jax.Array
    out_q: jax.Array
    pair_q: jax.Array
    mvr_cell_q: jax.Array
    mvr_cell_node: jax.Array


class AugmentedGwtModel:
    """GWT/GWE model + feature-concentration rows for the advanced
    packages of a matching AugmentedGwfModel.

    ``uzf``: optional gwf.uzf.UzfColumns — adds one concentration row
    per unsaturated column (UZT, tsp-apt.f90 via gwt-uzt.f90: storage is
    θ-volume, external inflow is the accepted infiltration, the
    water-table recharge leaves at the column's concentration).  Passing
    a GWE-configured base gives UZE the same way LKT/SFT/MWT become
    LKE/SFE/MWE (the eqnsclfac scaling rides through)."""

    def __init__(self, base, gwf_aug, uzf=None):
        self.base = base
        self.gwf = gwf_aug
        N = base.nodes
        if gwf_aug.n_grid != N:
            raise ValueError("transport and flow grids differ")
        self.n_grid = N
        self.uzf = uzf
        n_uzf = int(uzf.node.shape[0]) if uzf is not None else 0
        self._uzf_off = gwf_aug.n_extra    # uzf rows after gwf features
        self.n_extra = gwf_aug.n_extra + n_uzf

        # connection edges in the same order the flow model declares them
        conn_edges = []
        self._conn_feat = []     # feature row (0-based in extra space)
        for name in ("maw", "lak", "sfr"):
            d = getattr(gwf_aug, name)
            if d is None:
                continue
            off = getattr(gwf_aug, f"_{name}_offset") - N
            if name == "maw":
                cells, owners = d.conn_node, d.conn_well
            elif name == "lak":
                cells, owners = d.conn_node, d.conn_lake
            else:
                cells, owners = d.node, np.arange(d.nreaches)
            for cell, owner in zip(np.asarray(cells), np.asarray(owners)):
                conn_edges.append((int(cell), N + off + int(owner)))
                self._conn_feat.append(off + int(owner))
        if uzf is not None:
            for i, cell in enumerate(np.asarray(uzf.node)):
                conn_edges.append((int(cell), N + self._uzf_off + i))
                self._conn_feat.append(self._uzf_off + i)

        # feature→feature transfer edges (dst receives at src's conc):
        # lake outlets, sfr routing pairs, sfr diversions, feature movers
        pair_edges = []          # (dst_row, src_row) in combined space
        self._pairs = []         # bookkeeping (kind, index) for extraction
        lak, sfr, maw = gwf_aug.lak, gwf_aug.sfr, gwf_aug.maw
        lak_off = getattr(gwf_aug, "_lak_offset", N) - N
        sfr_off = getattr(gwf_aug, "_sfr_offset", N) - N
        maw_off = getattr(gwf_aug, "_maw_offset", N) - N
        if lak is not None:
            for i in range(len(lak.out_type)):
                dst = int(lak.out_to[i])
                src = int(lak.out_lake[i])
                if dst >= 0 and dst != src:
                    self._pairs.append(("lak_out", i))
                    pair_edges.append((N + lak_off + dst, N + lak_off + src))
        if sfr is not None:
            ups = np.asarray(sfr.upstream)
            fr = np.asarray(sfr.frac)
            for r in range(sfr.nreaches):
                for j in range(ups.shape[1]):
                    if fr[r, j] != 0.0 and int(ups[r, j]) != r:
                        self._pairs.append(("sfr_route", (r, int(ups[r, j]),
                                                          float(fr[r, j]))))
                        pair_edges.append((N + sfr_off + r,
                                           N + sfr_off + int(ups[r, j])))
            for i in range(len(sfr.div_src)):
                self._pairs.append(("sfr_div", i))
                pair_edges.append((N + sfr_off + sfr.div_to[i],
                                   N + sfr_off + sfr.div_src[i]))
        feat_off = {"lak": lak_off, "sfr": sfr_off, "maw": maw_off}
        mvr_cell_edges = []      # (recv feature row, provider cell)
        self._mvr_feat = []      # mover indices with feature providers
        self._mvr_cell = []      # mover indices with cell providers
        if gwf_aug.mvr is not None:
            m = gwf_aug.mvr
            for i in range(m.nmovers):
                pk, rk = m.prov_pkg[i], m.recv_pkg[i]
                roff = feat_off.get(rk)
                if roff is None:
                    continue
                dst = N + roff + m.recv_id[i]
                if pk in feat_off:
                    # provider outlet/reach/well: concentration of the
                    # provider FEATURE; lak provider entry space is the
                    # outlet — map to its source lake
                    if pk == "lak":
                        src_feat = int(lak.out_lake[m.prov_id[i]])
                    else:
                        src_feat = m.prov_id[i]
                    self._pairs.append(("mvr", i))
                    pair_edges.append((dst, N + feat_off[pk] + src_feat))
                    self._mvr_feat.append(i)
                else:
                    # provider boundary entry: concentration of its cell
                    pdata = getattr(gwf_aug.base.packages, pk)
                    cell = int(np.asarray(pdata.node)[m.prov_id[i]])
                    self._mvr_cell.append(i)
                    mvr_cell_edges.append((dst, cell))

        base_nbr = np.asarray(base.dtopo.nbr)
        all_edges = conn_edges + pair_edges + mvr_cell_edges
        nbr_ext, slot_ab, slot_ba = _build_ext_table(
            base_nbr, N, self.n_extra, all_edges)
        self.dtopo = AugTopo(nbr=jnp.asarray(nbr_ext))
        self.Ktot = nbr_ext.shape[1]
        self.Kb = base_nbr.shape[1]
        nc = len(conn_edges)
        npair = len(pair_edges)
        # connection slots: ab = (cell, feat), ba = (feat, cell)
        self.slot_cf = jnp.asarray(slot_ab[:nc], jnp.int32)
        self.slot_fc = jnp.asarray(slot_ba[:nc], jnp.int32)
        self.conn_feat = jnp.asarray(self._conn_feat, jnp.int32)
        # pair slots: ab = (dst, src)
        self.slot_pair = jnp.asarray(slot_ab[nc:nc + npair], jnp.int32)
        self.pair_dst = jnp.asarray(
            [e[0] - N for e in pair_edges], jnp.int32)
        self.slot_mvr_cell = jnp.asarray(slot_ab[nc + npair:], jnp.int32)
        self.mvr_cell_dst = jnp.asarray(
            [e[0] - N for e in mvr_cell_edges], jnp.int32)
        self.conn_cell = jnp.asarray([e[0] for e in conn_edges], jnp.int32)
        self.use_structured = False
        self.inewton = 0

    # ----------------------------------------------------- model surface

    @property
    def nodes(self):
        return self.n_grid + self.n_extra

    @property
    def strt(self):
        extra = getattr(self, "strt_extra", None)
        if extra is None:
            extra = jnp.zeros(self.n_extra)
        return jnp.concatenate([jnp.asarray(self.base.strt),
                                jnp.asarray(extra)])

    @property
    def packages(self):
        return None

    @property
    def grid(self):
        return self.base.grid

    def boundary_state(self, x, pkgs=None):
        ib, conc = self.base.boundary_state(x[:self.n_grid])
        ib_ext = jnp.ones(self.n_extra, jnp.int32)
        return (jnp.concatenate([ib, ib_ext]),
                jnp.concatenate([conc, x[self.n_grid:]]))

    def assemble(self, x, x_old, ibound, delt, iss, pkgs: AptFlows = None,
                 newton: bool = True):
        N, Kb, Ktot = self.n_grid, self.Kb, self.Ktot
        f = pkgs
        esf = self.base.eqnsclfac
        diag_b, off_b, rhs_b = self.base.assemble(
            x[:N], x_old[:N], ibound[:N], delt, iss, f.fields)
        R = self.n_extra
        diag = jnp.concatenate([diag_b, jnp.zeros(R)])
        off = jnp.zeros(self.nodes * Ktot)
        off = off.at[:N * Ktot].set(
            jnp.zeros((N, Ktot)).at[:, :Kb].set(
                off_b.reshape(N, Kb)).reshape(-1))
        rhs = jnp.concatenate([rhs_b, jnp.zeros(R)])
        frow = N + jnp.arange(R)
        cf = x[frow]

        # feature storage d(V·c)/dt (apt_fc_expanded storage block)
        sc_new = f.v_new / delt * esf
        sc_old = f.v_old / delt * esf
        diag = diag.at[frow].add(-jnp.where(iss, 0.0, sc_new))
        rhs = rhs.at[frow].add(-jnp.where(iss, 0.0, sc_old) * x_old[frow])

        # feature↔cell advective exchange, upstream weighted
        # (apt_fc: q>0 leaves the feature at c_f, enters the cell;
        #  q<0 enters the feature at the cell's concentration)
        q = f.q_conn * esf
        qp = jnp.maximum(q, DZERO)
        qm = jnp.maximum(-q, DZERO)
        featrow = N + self.conn_feat
        cell = self.conn_cell
        # constant-concentration cells still exchange mass with features;
        # their own rows are re-pinned by the Dirichlet fixup afterwards
        act = ibound[cell] != 0
        qp = jnp.where(act, qp, DZERO)
        qm = jnp.where(act, qm, DZERO)
        diag = diag.at[featrow].add(-qp)
        off = off.at[self.slot_fc].add(qm)
        diag = diag.at[cell].add(-qm)
        off = off.at[self.slot_cf].add(qp)

        # external inflows at source concentration; outflows at c_f
        diag = diag.at[frow].add(-f.out_q * esf)
        rhs = rhs.at[frow].add(-f.ext_q * f.ext_conc * esf)

        # feature→feature transfers at the source feature's concentration
        if self.slot_pair.shape[0] > 0:
            off = off.at[self.slot_pair].add(f.pair_q * esf)
        # movers from non-feature providers: mass at the provider cell's
        # concentration (tsp-mvt.f90 qfrommvr at provider conc)
        if self.slot_mvr_cell.shape[0] > 0:
            off = off.at[self.slot_mvr_cell].add(f.mvr_cell_q * esf)

        # dead features (no volume, no flow): pin to the old concentration
        dead = (f.v_new + f.out_q + f.ext_q) * esf < 1e-30
        qsum = jnp.zeros(R).at[self.conn_feat].add(qp + qm)
        dead = dead & (qsum < 1e-30)
        diag = diag.at[frow].add(jnp.where(dead, -1.0, DZERO))
        rhs = rhs.at[frow].add(jnp.where(dead, -x_old[frow], DZERO))
        return diag, off.reshape(self.nodes, Ktot), rhs

    def edge_conductances(self, x, ibound, pkgs=None):
        return self.base.edge_conductances(x[:self.n_grid],
                                           ibound[:self.n_grid])

    def feature_budget(self, x, x_old, delt, flows: AptFlows):
        """Per-feature mass rates (apt_bd role): storage, gwf exchange,
        external in, outflow."""
        N = self.n_grid
        R = self.n_extra
        esf = self.base.eqnsclfac
        frow = N + jnp.arange(R)
        cf = x[frow]
        q = flows.q_conn * esf
        qp = jnp.maximum(q, DZERO)
        qm = jnp.maximum(-q, DZERO)
        m_gwf = jnp.zeros(R).at[self.conn_feat].add(
            -qp * cf[self.conn_feat] + qm * x[self.conn_cell])
        return {
            "APT-STO": -(flows.v_new * cf - flows.v_old * x_old[frow])
            / delt * esf,
            "APT-GWF": m_gwf,
            "APT-IN": flows.ext_q * flows.ext_conc * esf,
            "APT-OUT": -flows.out_q * cf * esf,
        }


def extract_apt_flows(gwt_aug: AugmentedGwtModel, x_flow, x_flow_old,
                      fields, delt, iss, pkgs=None, ext_conc=None,
                      uzf_res=None, uzf_theta_old=None):
    """Build AptFlows from a solved flow step of the matching
    AugmentedGwfModel (the FMI hand-off for feature terms).

    ``ext_conc``: dict feature-package name → source concentration for its
    external inflows (rain/runoff/inflow), scalar or per-feature.
    ``uzf_res``/``uzf_theta_old``: the step's gwf.uzf.UzfResult and the
    start-of-step water contents, when the model carries UZT rows."""
    gwf = gwt_aug.gwf
    N = gwf.n_grid
    R = gwt_aug.n_extra
    ib, _ = gwf.boundary_state(x_flow, pkgs)
    ext_conc = ext_conc or {}

    qp_list = []
    v_new = jnp.zeros(R)
    v_old = jnp.zeros(R)
    ext_q = jnp.zeros(R)
    ext_c = jnp.zeros(R)
    out_q = jnp.zeros(R)

    qp_mvr, qto, qfrom = {}, {}, {}
    if gwf.mvr is not None:
        qp_all, qto, qfrom = gwf.eval_movers(x_flow, ib, pkgs)
    else:
        qp_all = jnp.zeros(0)

    def conc_of(name, n):
        c = ext_conc.get(name, 0.0)
        return jnp.broadcast_to(jnp.asarray(c, jnp.float64), (n,))

    if gwf.maw is not None:
        d = gwf.maw
        off = gwf._maw_offset - N
        hw = x_flow[gwf._maw_offset + jnp.arange(d.nwells)]
        hw0 = x_flow_old[gwf._maw_offset + jnp.arange(d.nwells)]
        q_gwf = d.cond * d.active[d.conn_well] * (
            hw[d.conn_well] - x_flow[d.conn_node])
        qp_list.append(q_gwf)
        vol = d.area * jnp.maximum(hw - d.bottom, 1e-8)
        vol0 = d.area * jnp.maximum(hw0 - d.bottom, 1e-8)
        idx = off + jnp.arange(d.nwells)
        v_new = v_new.at[idx].set(vol)
        v_old = v_old.at[idx].set(vol0)
        rate, _ = d.rate_actual_and_deriv(x_flow, gwf._maw_offset)
        # injection enters at the source conc; pumping leaves at c_f
        ext_q = ext_q.at[idx].add(jnp.maximum(rate, 0.0))
        ext_c = ext_c.at[idx].set(conc_of("maw", d.nwells))
        out_q = out_q.at[idx].add(jnp.maximum(-rate, 0.0))
        if d.fw_cond is not None:
            qfw, _ = d.flowing_well_q(x_flow, gwf._maw_offset)
            out_q = out_q.at[idx].add(jnp.maximum(-qfw, 0.0))

    if gwf.lak is not None:
        d = gwf.lak
        off = gwf._lak_offset - N
        s = x_flow[gwf._lak_offset + jnp.arange(d.nlakes)]
        s0 = x_flow_old[gwf._lak_offset + jnp.arange(d.nlakes)]
        h = x_flow[d.conn_node]
        coupled = h > d.belev
        q_gwf = d.conn_cond(s[d.conn_lake], h) * d.active[d.conn_lake] \
            * jnp.where(coupled, s[d.conn_lake] - h,
                        s[d.conn_lake] - d.belev)
        qp_list.append(q_gwf)
        idx = off + jnp.arange(d.nlakes)
        v_new = v_new.at[idx].set(d.volume_of(s))
        v_old = v_old.at[idx].set(d.volume_of(s0))
        ext_q = ext_q.at[idx].add(d.rainfall * d.active)
        ext_c = ext_c.at[idx].set(conc_of("lak", d.nlakes))
        out_q = out_q.at[idx].add(d.withdrawal * d.active)
        # evaporation removes water, not mass (concentrating) — excluded
        for i in range(len(d.out_type)):
            qo, _ = d.outlet_flow(x_flow, gwf._lak_offset, i)
            out_q = out_q.at[off + int(d.out_lake[i])].add(qo)

    if gwf.sfr is not None:
        d = gwf.sfr
        off = gwf._sfr_offset - N
        st = x_flow[gwf._sfr_offset + jnp.arange(d.nreaches)]
        st0 = x_flow_old[gwf._sfr_offset + jnp.arange(d.nreaches)]
        h = x_flow[d.node]
        coupled = h > d.strtop
        q_gwf = d.cond * d.active * jnp.where(coupled, st - h,
                                              st - d.strtop)
        qp_list.append(q_gwf)
        dnew = jnp.maximum(st - d.strtop, 0.0)
        dold = jnp.maximum(st0 - d.strtop, 0.0)
        if d.xs_station is not None:
            from ...ops import cxs
            a_new = cxs.wetted_area(d.xs_station, d.xs_height, dnew)
            a_old = cxs.wetted_area(d.xs_station, d.xs_height, dold)
        else:
            a_new = d.width * dnew
            a_old = d.width * dold
        idx = off + jnp.arange(d.nreaches)
        v_new = v_new.at[idx].set(a_new * d.length)
        v_old = v_old.at[idx].set(a_old * d.length)
        ext = (d.inflow + d.runoff + d.rainfall) * d.active
        ext_q = ext_q.at[idx].add(ext)
        ext_c = ext_c.at[idx].set(conc_of("sfr", d.nreaches))
        q_man, _ = d._manning(st)
        out_q = out_q.at[idx].add(q_man * d.active)

    if gwt_aug.uzf is not None:
        u = gwt_aug.uzf
        if uzf_res is None or uzf_theta_old is None:
            raise ValueError("UZT rows need uzf_res/uzf_theta_old")
        dz = (u.celtop - u.celbot) / u.nz
        idx = gwt_aug._uzf_off + jnp.arange(u.node.shape[0])
        v_new = v_new.at[idx].set(
            jnp.sum(uzf_res.theta, axis=1) * dz * u.area)
        v_old = v_old.at[idx].set(
            jnp.sum(uzf_theta_old, axis=1) * dz * u.area)
        # accepted infiltration enters at the source concentration;
        # recharge leaves to the cell through the conn edge (q_conn);
        # ET removes water, not mass (gwt-uzt.f90 convention)
        fin_acc = (u.finf - uzf_res.rej) * u.area
        ext_q = ext_q.at[idx].add(jnp.maximum(fin_acc, 0.0))
        ext_c = ext_c.at[idx].set(conc_of("uzf", u.node.shape[0]))
        qp_list.append(uzf_res.rch * u.area)

    # feature→feature pair flows in edge declaration order
    pair_q = []
    lak, sfr = gwf.lak, gwf.sfr
    if sfr is not None:
        q_man_s, _ = sfr._manning(
            x_flow[gwf._sfr_offset + jnp.arange(sfr.nreaches)])
        qd_s, _div_in = sfr.routing(q_man_s * sfr.active, qto.get("sfr"))
    for kind, info in gwt_aug._pairs:
        if kind == "lak_out":
            qo, _ = lak.outlet_flow(x_flow, gwf._lak_offset, info)
            qto_l = qto.get("lak")
            if qto_l is not None:
                qo = qo - qto_l[info]
            pair_q.append(jnp.maximum(qo, 0.0))
        elif kind == "sfr_route":
            r, u, frac = info
            pair_q.append(frac * qd_s[u])
        elif kind == "sfr_div":
            # re-run the diversion chain to get individual flows
            qd_tmp = q_man_s * sfr.active
            if qto.get("sfr") is not None:
                qd_tmp = jnp.maximum(qd_tmp - qto["sfr"], 0.0)
            val = None
            for i2 in range(len(sfr.div_src)):
                s2 = sfr.div_src[i2]
                rule = sfr.div_rule[i2]
                v = sfr.divflow[i2]
                qs = qd_tmp[s2]
                if rule == "fraction":
                    vq = qs * v
                elif rule == "excess":
                    vq = jnp.maximum(qs - v, DZERO)
                elif rule == "threshold":
                    vq = jnp.where(qs < v, DZERO, v)
                else:
                    vq = jnp.minimum(v, qs)
                qd_tmp = qd_tmp.at[s2].add(-vq)
                if i2 == info:
                    val = vq
            pair_q.append(val)
        elif kind == "mvr":
            pair_q.append(qp_all[info])
    pair_q = jnp.stack(pair_q) if pair_q else jnp.zeros(0)

    mvr_cell_q = (jnp.stack([qp_all[i] for i in gwt_aug._mvr_cell])
                  if gwt_aug._mvr_cell else jnp.zeros(0))

    q_conn = jnp.concatenate(qp_list) if qp_list else jnp.zeros(0)
    return AptFlows(fields=fields, q_conn=q_conn, v_new=v_new, v_old=v_old,
                    ext_q=ext_q, ext_conc=ext_c, out_q=out_q,
                    pair_q=pair_q, mvr_cell_q=mvr_cell_q,
                    mvr_cell_node=gwt_aug.mvr_cell_dst)


class CoupledAugmented:
    """Sequential flow→transport stepping for augmented models (the
    CoupledGwfGwt pattern extended with APT/MVT feature rows)."""

    def __init__(self, gwf_aug, gwt_aug: AugmentedGwtModel,
                 gwf_settings=None, gwt_settings=None, ext_conc=None):
        from ...solution.ims import ImsSettings, NumericalSolution
        from . import fmi

        self.gwf = gwf_aug
        self.gwt = gwt_aug
        self.ext_conc = ext_conc or {}
        self._fmi = fmi
        self._uzf_theta = None
        self._uzf_watab = None
        self.gwf_sol = NumericalSolution(gwf_aug, gwf_settings or
                                         ImsSettings(
                                             outer_dvclose=1e-8,
                                             inner_dvclose=1e-10,
                                             inner_rclose=1e-9,
                                             inner_maximum=1000,
                                             outer_maximum=100,
                                             linear_acceleration="bicgstab"))
        self.gwt_sol = NumericalSolution(gwt_aug, gwt_settings or
                                         ImsSettings(
                                             outer_dvclose=1e-8,
                                             inner_dvclose=1e-10,
                                             inner_rclose=1e-9,
                                             inner_maximum=1000,
                                             outer_maximum=50,
                                             linear_acceleration="bicgstab"))

    def step(self, x_flow_old, x_conc_old, delt, kstp=1, iss_flow=False):
        N = self.gwf.n_grid
        head_old = jnp.asarray(x_flow_old)[:N]
        pkgs = None
        uzf_res = None
        theta_old = self._uzf_theta
        if self.gwt.uzf is not None:
            # march the columns at the step-start head and couple the
            # head-dependent terms through pkgs.uzf (Simulation parity)
            from ..gwf import uzf as uzf_mod
            import dataclasses as _dc
            u = self.gwt.uzf
            if theta_old is None:
                theta_old = uzf_mod.initial_theta(u)
            if self._uzf_watab is None:
                self._uzf_watab = uzf_mod.watab_of(u, head_old)
            uzf_res = uzf_mod.advance(u, theta_old, delt, head=head_old,
                                      watab_old=self._uzf_watab)
            pkgs = _dc.replace(self.gwf.base.packages,
                               uzf=uzf_mod.make_step(u, uzf_res))
        x_flow, finfo, aux = self.gwf_sol.solve_timestep(
            x_flow_old, delt, kstp=kstp, iss=iss_flow, pkgs=pkgs)
        head = x_flow[:N]
        ib_grid = aux["ibound"][:N]
        fields = self._fmi.from_gwf_step(
            self.gwf.base, head, head_old, ib_grid, None, delt, iss_flow,
            ssm_spec=self.gwt.base.ssm_spec)
        flows = extract_apt_flows(self.gwt, x_flow,
                                  jnp.asarray(x_flow_old), fields, delt,
                                  iss_flow, ext_conc=self.ext_conc,
                                  uzf_res=uzf_res, uzf_theta_old=theta_old)
        conc, tinfo, _ = self.gwt_sol.solve_timestep(
            x_conc_old, delt, kstp=kstp, iss=False, pkgs=flows)
        if uzf_res is not None:
            self._uzf_theta = uzf_res.theta
            self._uzf_watab = uzf_res.watab
        return x_flow, conc, finfo, tinfo, flows
