"""GWF model: composes DIS + NPF + STO + IC + stress packages into the
per-iteration system assembly.

Plays the role of the reference's GwfModelType phase methods
(src/Model/GroundWaterFlow/gwf.f90:36-103): ``assemble`` is the fused
cf+fc+fn sweep (gwf_cf/gwf_fc/gwf_nr), producing the full (diag, off, rhs)
of the implicit CVFD system for the current head iterate.

Everything here is pure-functional over pytrees so the whole outer
iteration jits into one XLA computation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import DZERO
from . import bnd, npf, npf_structured, sto


@partial(jax.tree_util.register_dataclass,
         data_fields=["chd", "wel", "rch", "drn", "riv", "ghb", "evt",
                      "buy_conc", "csub_state", "uzf"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class PackageData:
    """Stress-period package data bundle (a pytree, passed through jit so
    per-period updates don't invalidate compiled steps)."""

    chd: Optional[bnd.ChdData] = None
    wel: Optional[bnd.WelData] = None
    rch: Optional[bnd.RchData] = None
    drn: Optional[bnd.DrnData] = None
    riv: Optional[bnd.RivData] = None
    ghb: Optional[bnd.GhbData] = None
    evt: Optional[bnd.EvtData] = None
    # lagged concentration(s) driving the BUY density terms (set by the
    # coupled driver each step; rides the pytree so jit never retraces)
    buy_conc: Optional[jax.Array] = None
    # CSUB state (csub.CsubState: es0/pcs/compaction), committed per step
    csub_state: object = None
    # UZF per-step coupling data (uzf.UzfStep, built by the Simulation
    # driver from the explicit column march each step attempt)
    uzf: object = None


@dataclasses.dataclass
class GwfModel:
    """Host-side model container (static config + device arrays)."""

    name: str
    grid: object                 # DisGrid / DisvGrid / DisuGrid
    topo: object                 # host Topology
    dtopo: npf.DeviceTopology
    npf_opts: npf.NpfOptions
    npf_arrays: npf.NpfArrays
    strt: object                 # f64[N] initial head
    ibound0: object              # i32[N] base ibound from idomain
    sto_opts: Optional[sto.StoOptions] = None
    sto_arrays: Optional[sto.StoArrays] = None
    chd: Optional[bnd.ChdData] = None
    wel: Optional[bnd.WelData] = None
    rch: Optional[bnd.RchData] = None
    drn: Optional[bnd.DrnData] = None
    riv: Optional[bnd.RivData] = None
    ghb: Optional[bnd.GhbData] = None
    evt: Optional[bnd.EvtData] = None
    inewton: int = 0
    inewtonur: int = 0           # NEWTON UNDER_RELAXATION option (gwf_nur
    # runs only when set, gwf.f90 gwf_nur: `this%inewtonur /= 0`)
    wel_iflowred: int = 0
    wel_flowred: float = 0.0
    buy: object = None           # buy.BuyData variable-density terms
    csub: object = None          # csub.CsubData compaction/subsidence
    vsc: object = None           # vsc.VscData viscosity K scaling
    hfb: object = None           # [(n, m, hydchr)] horizontal-flow barriers
    condsat3: object = None      # (cx, cy, cz) dense condsat (structured path)
    delr: object = None          # f64[ncol] (structured path)
    delc: object = None          # f64[nrow]
    ixt3d: int = 0               # 0=off 1=full-tensor 2=rhs-only (npf XT3D)
    xt3d: object = None          # Xt3dData (built in finalize_setup)
    wetdry: object = None        # f64[N] WETDRY thresholds (REWET option)
    rewet_opts: tuple = (1.0, 1, 0)   # (wetfct, iwetit, ihdwet)
    gnc: object = None           # gnc.GncData ghost-node correction

    # -------------------------------------------------------------- setup

    @property
    def use_structured(self) -> bool:
        """Gather-free dense assembly: DIS grids without rotated-anisotropy
        angles (see npf_structured)."""
        o = self.npf_opts
        return (self.dtopo.grid_shape is not None and not self.ixt3d
                and self.vsc is None
                and not (o.iangle1 or o.iangle2 or o.iangle3))

    def finalize_setup(self):
        """Precompute condsat (reference npf_ar → calc_condsat)."""
        if self.ixt3d:
            from . import xt3d as xt3d_mod
            if self.hfb:
                raise NotImplementedError("HFB with XT3D not yet implemented")
            a, o = self.npf_arrays, self.npf_opts
            self.xt3d = xt3d_mod.build_xt3d(
                self.grid, self.topo, a.k11, a.k22, a.k33,
                a.angle1 if o.iangle1 else 0.0,
                a.angle2 if o.iangle2 else 0.0,
                a.angle3 if o.iangle3 else 0.0, ixt3d=self.ixt3d)
            if self.ixt3d == 1:
                # full mode widens the stencil to depth 2: the solver-side
                # neighbor table becomes the extended one
                self.dtopo = dataclasses.replace(
                    self.dtopo, nbr=self.xt3d.nbr_ext, grid_shape=None)
            else:
                self.dtopo = dataclasses.replace(self.dtopo, grid_shape=None)
            return
        if self.vsc is not None and self.hfb:
            raise NotImplementedError(
                "VSC rebuilds condsat per step, which would drop the HFB "
                "modifications — not supported together yet")
        if self.vsc is not None and self.ixt3d:
            raise NotImplementedError("VSC with XT3D not supported yet")
        ib = jnp.asarray(self.ibound0, jnp.int32)
        strt = jnp.asarray(self.strt)
        sat0 = npf.initial_sat(self.npf_opts, self.npf_arrays, strt, ib)
        condsat = npf.compute_condsat(self.dtopo, self.npf_opts,
                                      self.npf_arrays, sat0, strt)
        if self.hfb:
            condsat = self._apply_hfb(condsat)
        self.npf_arrays = dataclasses.replace(self.npf_arrays, condsat=condsat)
        if self.use_structured:
            self.delr = jnp.asarray(self.grid.delr)
            self.delc = jnp.asarray(self.grid.delc)
            a = self.npf_arrays
            self.condsat3 = npf_structured.structured_condsat(
                self.dtopo.grid_shape, self.delr, self.delc, self.npf_opts,
                a.icelltype, a.k11, a.k22, a.k33, a.top, a.bot, sat0)
            if self.hfb:
                self.condsat3 = self._apply_hfb_structured(self.condsat3)

    def _hfb_series(self, csat, n, m, hydchr, e=None):
        """Reference HFB conductance math (gwf-hfb.f90 condsat_modify /
        hfb_fc:304-327): hydchr > 0 is a barrier hydraulic characteristic —
        series-combine csat with condhfb = hydchr*fawidth*faheight;
        hydchr < 0 is a direct conductance multiplier (cond = -csat*hydchr)."""
        import numpy as np
        topo = self.topo
        top = np.asarray(self.grid.top)
        bot = np.asarray(self.grid.bot)
        if e is not None and topo.ihc[e] == 2:
            fah = min(top[n], top[m]) - max(bot[n], bot[m])
        else:
            fah = 0.5 * ((top[n] - bot[n]) + (top[m] - bot[m]))
        faw = topo.hwva[e] if e is not None else 1.0
        if hydchr > 0:
            condhfb = hydchr * faw * fah
            return csat * condhfb / (csat + condhfb)
        return -csat * hydchr

    def _apply_hfb(self, condsat):
        import numpy as np
        topo = self.topo
        lookup = {(int(a), int(b)): e
                  for e, (a, b) in enumerate(zip(topo.edge_n, topo.edge_m))}
        cs = np.asarray(condsat).copy()
        for n, m, hydchr in self.hfb:
            n, m = int(min(n, m)), int(max(n, m))
            e = lookup.get((n, m))
            if e is None:
                raise ValueError(f"HFB cells {n},{m} are not connected")
            cs[e] = self._hfb_series(float(cs[e]), n, m, float(hydchr), e)
        return jnp.asarray(cs)

    def _apply_hfb_structured(self, condsat3):
        """Mirror the barrier into the dense (cx, cy, cz) structured arrays
        (slot (k,i,j) holds the conductance toward (k,i,j+1) etc.)."""
        import numpy as np
        topo = self.topo
        shape = self.dtopo.grid_shape
        ncol = shape[2]
        ncpl = shape[1] * shape[2]
        lookup = {(int(a), int(b)): e
                  for e, (a, b) in enumerate(zip(topo.edge_n, topo.edge_m))}
        cx, cy, cz = (np.asarray(c).copy() for c in condsat3)
        for n, m, hydchr in self.hfb:
            n, m = int(min(n, m)), int(max(n, m))
            e = lookup[(n, m)]
            if m == n + 1:
                arr = cx
            elif m == n + ncol:
                arr = cy
            elif m == n + ncpl:
                arr = cz
            else:
                raise ValueError(f"HFB edge {n},{m} not axis-aligned")
            flat = arr.reshape(-1)
            flat[n] = self._hfb_series(float(flat[n]), n, m, float(hydchr), e)
        return (jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cz))

    @property
    def nodes(self) -> int:
        return self.dtopo.nodes

    @property
    def is_linear(self) -> bool:
        """True when the assembled system does not depend on the current
        head iterate: every cell confined (sat ≡ 1), storage non-convertible,
        and no head-switched boundary terms.  The fused solver then hoists
        assembly out of the Picard loop — the analog of the reference's
        confined-cell work skip in npf_cf (gwf-npf.f90:444-470): the f64
        assembly is then paid once per time step, not once per outer
        iteration."""
        if self.inewton or self.ixt3d or self.wel_iflowred:
            return False
        if self.buy is not None or self.vsc is not None:
            return False
        if self.csub is not None:
            return False
        if self.drn is not None or self.riv is not None or self.evt is not None:
            return False
        if np.any(np.asarray(self.npf_arrays.icelltype) != 0):
            return False
        if self.sto_arrays is not None and np.any(
                np.asarray(self.sto_arrays.iconvert) != 0):
            return False
        return True

    # ---------------------------------------------------------- stress rp

    @property
    def packages(self) -> PackageData:
        """Static package bundle (models built via builder.build_gwf)."""
        return PackageData(chd=self.chd, wel=self.wel, rch=self.rch,
                           drn=self.drn, riv=self.riv, ghb=self.ghb,
                           evt=self.evt)

    def boundary_state(self, head, pkgs: PackageData = None):
        """Apply CHD to (ibound, head) — the rp/ad phase of CHD."""
        if pkgs is None:
            pkgs = self.packages
        ibound = jnp.asarray(self.ibound0, jnp.int32)
        if pkgs.chd is not None:
            ibound, head = bnd.apply_chd(ibound, head, pkgs.chd)
        return ibound, head

    # ---------------------------------------------------------- assembly

    def assemble(self, head, head_old, ibound, delt, iss: bool,
                 pkgs: PackageData = None, newton: bool = True):
        """One full system build at the current head iterate.

        Returns (diag, off, rhs, cond) where cond is the per-edge
        conductance (kept for the budget/flowja phase).  ``newton=False``
        rebuilds with standard conductance only (the backtracking pass,
        sln_buildsystem(kiter, inewton=0), NumericalSolution.f90:2699).
        """
        if pkgs is None:
            pkgs = self.packages
        opts, arrays = self.npf_opts, self.npf_arrays
        if self.vsc is not None and pkgs.buy_conc is not None:
            # viscosity scales K (update_k_with_vsc) and condsat is rebuilt
            # from the scaled K (npf kchangeper path); uses the same lagged
            # concentration field as BUY
            from . import vsc as vsc_mod
            vr = vsc_mod.viscosity_ratio(self.vsc, pkgs.buy_conc)
            arrays = dataclasses.replace(
                arrays, k11=arrays.k11 * vr, k22=arrays.k22 * vr,
                k33=arrays.k33 * vr)
            strt = jnp.asarray(self.strt)
            sat0 = npf.initial_sat(opts, arrays, strt, ibound)
            arrays = dataclasses.replace(
                arrays, condsat=npf.compute_condsat(self.dtopo, opts,
                                                    arrays, sat0, strt))
        sat = npf.compute_saturation(opts, arrays, head, ibound)
        if self.xt3d is not None:
            from . import xt3d as xt3d_mod
            if self.inewton:
                # xt3d_fc inewton branch + xt3d_fn Jacobian terms
                diag, off, rhs = xt3d_mod.assemble_newton(
                    self.xt3d, head, ibound, sat, arrays.icelltype,
                    add_fn=newton)
            else:
                diag, off, rhs = xt3d_mod.assemble(self.xt3d, head,
                                                   ibound, sat)
        elif self.use_structured:
            diag, off, rhs = npf_structured.assemble_structured(
                self.dtopo.grid_shape, self.delr, self.delc, opts, arrays,
                head, ibound, sat, self.condsat3)
        else:
            diag, off, rhs, cond_e = npf.assemble(self.dtopo, opts, arrays,
                                                  head, ibound, sat)
            if self.gnc is not None:
                # ghost-node correction, explicit form (GhostNode.f90
                # gnc_fc else-branch): rhs(n) -= ΔQ, rhs(m) += ΔQ
                from . import gnc as gnc_mod
                rterm = gnc_mod.gnc_rhs_terms(self.gnc, cond_e, head,
                                              ibound)
                rhs = rhs.at[self.gnc.n].add(-rterm)
                rhs = rhs.at[self.gnc.m].add(rterm)

        if self.sto_arrays is not None and not iss:
            d_add, r_add = sto.assemble(self.sto_opts, self.sto_arrays,
                                        head, head_old, ibound, delt)
            diag = diag + d_add
            rhs = rhs + r_add

        if self.csub is not None and pkgs.csub_state is not None:
            from . import csub as csub_mod
            d_add, r_add = csub_mod.assemble_csub(
                self.csub, pkgs.csub_state, arrays.top, arrays.bot,
                jnp.asarray(self.grid.area), arrays.icelltype, head,
                head_old, ibound, delt)
            if not iss:
                diag = diag + d_add
                rhs = rhs + r_add

        if self.buy is not None and pkgs.buy_conc is not None:
            from . import buy as buy_mod
            dense = buy_mod.calcdens(self.buy, pkgs.buy_conc)
            cond_e = npf.edge_conductance(self.dtopo, opts, arrays, head,
                                          ibound, sat)
            diag, off, rhs = buy_mod.assemble_buy(
                self.dtopo, self.buy, dense, cond_e, sat,
                arrays.top, arrays.bot, ibound, head, diag, off, rhs)

        area = jnp.asarray(self.grid.area)
        top, bot = arrays.top, arrays.bot
        if pkgs.wel is not None:
            hcof, r = bnd.wel_terms(pkgs.wel, head, ibound, arrays.icelltype,
                                    top, bot, self.wel_iflowred, self.wel_flowred)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.wel.node,
                                          pkgs.wel.mask, hcof, r)
        if pkgs.rch is not None:
            hcof, r = bnd.rch_terms(pkgs.rch, ibound, area)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.rch.node,
                                          pkgs.rch.mask, hcof, r)
        if pkgs.drn is not None:
            hcof, r = bnd.drn_terms(pkgs.drn, head, ibound)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.drn.node,
                                          pkgs.drn.mask, hcof, r)
        if pkgs.riv is not None:
            hcof, r = bnd.riv_terms(pkgs.riv, head, ibound)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.riv.node,
                                          pkgs.riv.mask, hcof, r)
        if pkgs.ghb is not None:
            hcof, r = bnd.ghb_terms(pkgs.ghb, ibound)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.ghb.node,
                                          pkgs.ghb.mask, hcof, r)
        if pkgs.evt is not None:
            hcof, r = bnd.evt_terms(pkgs.evt, head, ibound, area)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.evt.node,
                                          pkgs.evt.mask, hcof, r)
        if pkgs.uzf is not None:
            # head-dependent UZF terms at the current iterate (the
            # reference's per-iteration uzf_fc → uzf_solve sweep)
            from . import uzf as uzf_mod
            hcof, r, _ = uzf_mod.uzf_matrix_terms(pkgs.uzf, head, ibound)
            mask = jnp.ones_like(pkgs.uzf.node, bool)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.uzf.node,
                                          mask, hcof, r)

        if self.inewton and newton:
            diag, off, rhs = npf.newton_terms(self.dtopo, opts, arrays,
                                              head, ibound, diag, off, rhs)
            if self.sto_arrays is not None and not iss:
                d_add, r_add = sto.newton_terms(self.sto_opts, self.sto_arrays,
                                                head, ibound, delt)
                diag = diag + d_add
                rhs = rhs + r_add
            if pkgs.wel is not None and self.wel_iflowred:
                hcof, r = bnd.wel_newton(pkgs.wel, head, ibound,
                                         arrays.icelltype, top, bot,
                                         self.wel_iflowred, self.wel_flowred)
                diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.wel.node,
                                              pkgs.wel.mask, hcof, r)

        return diag, off, rhs

    def edge_conductances(self, head, ibound, pkgs=None):
        """Per-edge conductances for flowja/budget output (npf_cq inputs);
        called once per time step, outside the iteration hot loop.  With
        VSC active the viscosity K scaling is applied (vsc_cq parity)."""
        opts, arrays = self.npf_opts, self.npf_arrays
        conc = getattr(pkgs, "buy_conc", None) if pkgs is not None else None
        if self.vsc is not None and conc is not None:
            from . import vsc as vsc_mod
            vr = vsc_mod.viscosity_ratio(self.vsc, conc)
            arrays = dataclasses.replace(
                arrays, k11=arrays.k11 * vr, k22=arrays.k22 * vr,
                k33=arrays.k33 * vr)
            strt = jnp.asarray(self.strt)
            sat0 = npf.initial_sat(opts, arrays, strt, ibound)
            arrays = dataclasses.replace(
                arrays, condsat=npf.compute_condsat(self.dtopo, opts,
                                                    arrays, sat0, strt))
        sat = npf.compute_saturation(opts, arrays, head, ibound)
        if self.xt3d is not None:
            # XT3D has no per-edge two-point conductance; budgets use
            # edge_flows below instead
            return jnp.zeros(self.xt3d.edge_n.shape[0])
        return npf.edge_conductance(self.dtopo, opts, arrays, head, ibound,
                                    sat)

    def edge_flows(self, head, ibound, cond=None, pkgs=None):
        """Per-edge flow q (positive into edge_n) for flowja/budgets.

        Standard NPF: q = cond·(h_m − h_n) (npf_cq); XT3D: the full
        multi-point expression (xt3d_flowja); BUY adds the buoyancy ΔQ
        (buy_cq) when ``pkgs.buy_conc`` is present — required so the FMI
        velocity field stays conservative under density coupling."""
        if self.xt3d is not None:
            from . import xt3d as xt3d_mod
            sat = npf.compute_saturation(self.npf_opts, self.npf_arrays,
                                         head, ibound)
            return xt3d_mod.edge_flows(self.xt3d, head, ibound, sat,
                                       newton=bool(self.inewton))
        if cond is None:
            cond = self.edge_conductances(head, ibound, pkgs)
        q = npf.flowja(self.dtopo, cond, head)
        if self.gnc is not None:
            # flowja correction at gnc connections (gnc_cq role): flow
            # n→m gains ΔQ, so q (positive into n) loses it
            from . import gnc as gnc_mod
            dq = gnc_mod.deltaQgnc(self.gnc, cond, head, ibound)
            q = q.at[self.gnc.edge_idx].add(-dq)
        buy_conc = getattr(pkgs, "buy_conc", None) if pkgs is not None \
            else None
        if self.buy is not None and buy_conc is not None:
            from . import buy as buy_mod
            a = self.npf_arrays
            sat = npf.compute_saturation(self.npf_opts, a, head, ibound)
            dense = buy_mod.calcdens(self.buy, buy_conc)
            q = q + buy_mod.edge_flow_correction(
                self.dtopo, self.buy, dense, cond, sat, a.top, a.bot,
                ibound, head)
        return q

    # ------------------------------------------------------------ budget

    def boundary_budget(self, head, ibound, pkgs: PackageData = None):
        """Per-package boundary flow rates for budget reporting.

        Returns dict name -> per-entry q (positive = into the aquifer).
        """
        if pkgs is None:
            pkgs = self.packages
        area = jnp.asarray(self.grid.area)
        arrays = self.npf_arrays
        out = {}
        if pkgs.chd is not None:
            out["CHD"] = None  # computed from flowja residual, see budget.py
        if pkgs.wel is not None:
            hcof, r = bnd.wel_terms(pkgs.wel, head, ibound, arrays.icelltype,
                                    arrays.top, arrays.bot,
                                    self.wel_iflowred, self.wel_flowred)
            out["WEL"] = bnd.bound_flows(pkgs.wel.node, pkgs.wel.mask, hcof, r,
                                         head, ibound)
        if pkgs.rch is not None:
            hcof, r = bnd.rch_terms(pkgs.rch, ibound, area)
            out["RCH"] = bnd.bound_flows(pkgs.rch.node, pkgs.rch.mask, hcof, r,
                                         head, ibound)
        if pkgs.drn is not None:
            hcof, r = bnd.drn_terms(pkgs.drn, head, ibound)
            out["DRN"] = bnd.bound_flows(pkgs.drn.node, pkgs.drn.mask, hcof, r,
                                         head, ibound)
        if pkgs.riv is not None:
            hcof, r = bnd.riv_terms(pkgs.riv, head, ibound)
            out["RIV"] = bnd.bound_flows(pkgs.riv.node, pkgs.riv.mask, hcof, r,
                                         head, ibound)
        if pkgs.ghb is not None:
            hcof, r = bnd.ghb_terms(pkgs.ghb, ibound)
            out["GHB"] = bnd.bound_flows(pkgs.ghb.node, pkgs.ghb.mask, hcof, r,
                                         head, ibound)
        if pkgs.evt is not None:
            hcof, r = bnd.evt_terms(pkgs.evt, head, ibound, area)
            out["EVT"] = bnd.bound_flows(pkgs.evt.node, pkgs.evt.mask, hcof, r,
                                         head, ibound)
        if pkgs.uzf is not None:
            from . import uzf as uzf_mod
            _, _, parts = uzf_mod.uzf_matrix_terms(pkgs.uzf, head, ibound)
            out["UZF-GWRCH"] = parts["UZF-GWRCH"]
            if pkgs.uzf.iseepflag:
                out["UZF-GWD"] = parts["UZF-GWD"]
            if pkgs.uzf.igwetflag:
                out["UZF-GWET"] = parts["UZF-GWET"]
        return out
