"""Advanced stress packages with their own DOF rows (MAW/LAK/SFR/UZF).

The reference appends package equations to the solution matrix through
``bnd_ac``/``bnd_mc`` (extra connections) and fills them in ``bnd_fc``
(gwf-maw.f90:1-4666, gwf-lak.f90:1-6149, gwf-sfr.f90:1-5893).  This
redesign generalizes the ELL system instead: the solution vector becomes
``x = [head(N), pkg_dofs(R)]``, the neighbor table is extended with
package↔cell and package↔package slots (host-built once), and every
package contributes batched scatter-adds — the base grid assembly
(including the structured fast path) is embedded unchanged in the first
K_base slots of the widened table.

Conventions follow the CVFD matrix (negative definite, A·x = b): a
package↔cell exchange q = c·(dof − h) adds −c to both diagonals and +c to
the two coupling slots.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import DPREC, DZERO
from . import bnd


@dataclasses.dataclass(frozen=True)
class AugTopo:
    """Minimal device topology for the augmented (N+R)-row system —
    quacks like npf.DeviceTopology for make_matvec/apply_dirichlet."""

    nbr: jax.Array           # i32[N+R, Ktot]
    grid_shape: tuple = None

    @property
    def nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]


def _build_ext_table(base_nbr, N, R, edges, ktot_min=0):
    """Extend the base neighbor table with package rows.

    ``edges`` is a list of (row_a, row_b) pairs over the combined index
    space (grid rows < N, package rows N..N+R-1).  Returns
    (nbr_ext[N+R, Ktot], slot_ab[i], slot_ba[i]) where the slots are flat
    indices into the widened [N+R, Ktot] array.  ``ktot_min`` forces a
    minimum table width (sharded builds equalize widths across shards).
    """
    Kb = base_nbr.shape[1]
    fill = np.zeros(N + R, np.int64)
    fill[:N] = Kb
    deg = fill.copy()
    for a, b in edges:
        deg[a] += 1
        deg[b] += 1
    Ktot = max(int(deg.max(initial=Kb)), Kb, int(ktot_min))
    nbr = np.tile(np.arange(N + R, dtype=np.int32)[:, None], (1, Ktot))
    nbr[:N, :Kb] = base_nbr
    slot_ab = np.zeros(len(edges), np.int64)
    slot_ba = np.zeros(len(edges), np.int64)
    for i, (a, b) in enumerate(edges):
        sa, sb = fill[a], fill[b]
        nbr[a, sa] = b
        nbr[b, sb] = a
        slot_ab[i] = a * Ktot + sa
        slot_ba[i] = b * Ktot + sb
        fill[a] = sa + 1
        fill[b] = sb + 1
    return nbr, slot_ab, slot_ba


# ------------------------------------------------------------------- MAW

BIGHEAD = 1.0e20   # reference DEP20 sentinel: option not active


@partial(jax.tree_util.register_dataclass,
         data_fields=["conn_well", "conn_node", "cond", "area", "bottom",
                      "rate", "strt", "slot_cw", "slot_wc", "active",
                      "head_limit", "pumpelev", "reduction_length",
                      "fw_elev", "fw_cond", "fw_rlen", "shut_min",
                      "shut_max", "shut"],
         meta_fields=["nwells", "storage"])
@dataclasses.dataclass(frozen=True)
class MawData:
    """Multi-aquifer well package (gwf-maw.f90 behavioral core).

    Implemented: SPECIFIED / THIEM conductance (precomputed at build),
    wellbore storage, pumping rate, HEAD_LIMIT shutoff
    (maw_calculate_wellq shutofflevel branch, undamped — the reference's
    theta/kappa damping only accelerates the same fixed point),
    RATE_SCALING (pump_elevation + reduction_length sQSaturation ramps),
    and FLOWING_WELLS (fwelev/fwcond/fwrlen head-dependent discharge with
    Newton term, maw_calculate_conn_terms flowing-well block), and
    SHUT_OFF minrate/maxrate hysteresis advanced per time step
    (advance_shutoff), and all four condeqn conductance equations
    (THIEM/SKIN/CUMULATIVE/MEAN, maw_calculate_satcond)."""

    conn_well: jax.Array   # i32[C] well index per connection
    conn_node: jax.Array   # i32[C] gwf node per connection
    cond: jax.Array        # f64[C] saturated connection conductance
    area: jax.Array        # f64[W] wellbore cross-sectional area
    bottom: jax.Array      # f64[W] well bottom elevation
    rate: jax.Array        # f64[W] pumping rate (negative = withdrawal)
    strt: jax.Array        # f64[W] initial well head
    slot_cw: jax.Array     # i32[C] flat ext-slot of (cell row, well col)
    slot_wc: jax.Array     # i32[C] flat ext-slot of (well row, cell col)
    active: jax.Array      # bool[W]
    head_limit: jax.Array = None        # f64[W]; BIGHEAD = off
    pumpelev: jax.Array = None          # f64[W]
    reduction_length: jax.Array = None  # f64[W]; BIGHEAD = off
    fw_elev: jax.Array = None           # f64[W] flowing-well spill elev
    fw_cond: jax.Array = None           # f64[W]; 0 = not flowing
    fw_rlen: jax.Array = None           # f64[W] smoothing length
    # SHUT_OFF minrate/maxrate hysteresis (gwf-maw.f90 shutoffmin/max):
    # a shut well pumps nothing; the shut flag advances per TIME STEP at
    # the accepted solution (the reference iterates it per Picard
    # iteration with damping — same hysteresis band, different path)
    shut_min: jax.Array = None          # f64[W]; BIGHEAD = off
    shut_max: jax.Array = None          # f64[W]
    shut: jax.Array = None              # bool[W] current shut state
    nwells: int = 0
    storage: bool = True

    def advance_shutoff(self, x, N):
        """New shut flags from the accepted solution: shut when the
        head-limited |rate| drops below minrate; reopen when the
        potential |rate| exceeds maxrate (maw_calculate_wellq
        shutoff branch)."""
        if self.shut_min is None:
            return self.shut
        open_data = dataclasses.replace(
            self, shut=jnp.zeros(self.nwells, bool))
        q_pot = open_data.rate_actual(x, N)
        on = self.shut_min != BIGHEAD
        shut_now = on & ~self.shut & (jnp.abs(q_pot) < self.shut_min)
        stay_shut = on & self.shut & ~(jnp.abs(q_pot) > self.shut_max)
        return shut_now | stay_shut

    def terms(self, x, x_old, N, Ktot, delt, iss, diag, offf, rhs,
              qfrom=None):
        """Scatter MAW equations into the augmented system (maw_fc role).
        ``qfrom``: f64[W] mover inflow per well (qfrommvr, gwf-maw.f90
        maw_fc mover block)."""
        w = self.conn_well
        node = self.conn_node
        hw_rows = N + w
        c = self.cond * self.active[w]
        # gwf row: flux q = c (hw - h)
        diag = diag.at[node].add(-c)
        offf = offf.at[self.slot_cw].add(c)
        # well row: Σ c (h_k - hw) - A/Δt (hw - hw_old) + rate = 0
        diag = diag.at[hw_rows].add(-c)
        offf = offf.at[self.slot_wc].add(c)
        wrow = N + jnp.arange(self.nwells)
        act = self.active
        if self.storage and not iss:
            sc = self.area / delt * act
            diag = diag.at[wrow].add(-sc)
            rhs = rhs.at[wrow].add(-sc * x_old[wrow])
        rate, drate = self.rate_actual_and_deriv(x, N)
        diag = diag.at[wrow].add(drate * act)
        rhs = rhs.at[wrow].add((-rate + drate * x[wrow]) * act)
        if self.fw_cond is not None:
            # flowing-well discharge, Newton-linearized on the well row
            qfw, dqfw = self.flowing_well_q(x, N)
            diag = diag.at[wrow].add(dqfw * act)
            rhs = rhs.at[wrow].add((-qfw + dqfw * x[wrow]) * act)
        if qfrom is not None:
            rhs = rhs.at[wrow].add(-qfrom * act)
        # inactive wells: identity row handled by ibound/apply_dirichlet
        return diag, offf, rhs

    def rate_actual(self, x, N):
        """Simulated pumping rate per well at the current iterate
        (maw_calculate_wellq role)."""
        return self.rate_actual_and_deriv(x, N)[0]

    def rate_actual_and_deriv(self, x, N):
        """(q, dq/dhw): the RATE_SCALING branch is head-dependent, so its
        derivative goes on the well-row diagonal — without it the Picard
        iteration flip-flops across the ramp (the reference relies on its
        Newton formulation here)."""
        from ...ops.smoothing import sq_saturation, sq_saturation_derivative

        q = self.rate
        if self.shut is not None:
            q = jnp.where(self.shut, DZERO, q)
        dq = jnp.zeros(self.nwells)
        if self.reduction_length is not None:
            hw = x[N + jnp.arange(self.nwells)]
            bt = self.pumpelev
            tp = bt + jnp.where(self.reduction_length == BIGHEAD, 1.0,
                                self.reduction_length)
            sat = sq_saturation(tp, bt, hw)
            dsat = sq_saturation_derivative(tp, bt, hw)
            on = self.reduction_length != BIGHEAD
            scale_ext = jnp.where(on, sat, 1.0)
            scale_inj = jnp.where(on, 1.0 - sat, 1.0)
            ext = q < DZERO
            q = jnp.where(ext, q * scale_ext, q * scale_inj)
            dq = jnp.where(on, jnp.where(ext, self.rate * dsat,
                                         -self.rate * dsat), DZERO)
        if self.head_limit is not None:
            # undamped shutoff core (maw_calculate_qpot role): the potential
            # inflow from the aquifer with the well head pinned at the
            # limit; withdrawal is capped so hw cannot be drawn below it
            w = self.conn_well
            qin = self.cond * (x[self.conn_node] - self.head_limit[w])
            qpot = jnp.zeros(self.nwells).at[w].add(qin)
            limited = -jnp.clip(qpot, DZERO, -self.rate)
            lim_on = (self.rate < DZERO) & (self.head_limit != BIGHEAD)
            q = jnp.where(lim_on, limited, q)
            dq = jnp.where(lim_on, DZERO, dq)
        if self.shut is not None:
            # SHUT_OFF: a shut well pumps nothing regardless of limits
            q = jnp.where(self.shut, DZERO, q)
            dq = jnp.where(self.shut, DZERO, dq)
        return q, dq

    def flowing_well_q(self, x, N):
        """(q, dq/dhw) per well for the flowing-well discharge
        q = −fwcond·sat(hw)·(hw − fwelev); sat ramps over fwrlen."""
        from ...ops.smoothing import sq_saturation

        hw = x[N + jnp.arange(self.nwells)]
        tp = self.fw_elev + jnp.maximum(self.fw_rlen, 1e-9)
        sat = sq_saturation(tp, self.fw_elev, hw)
        q = -self.fw_cond * sat * (hw - self.fw_elev)
        eps = jnp.sqrt(DPREC) * jnp.maximum(jnp.abs(hw), 1.0)
        hw2 = hw + eps
        sat2 = sq_saturation(tp, self.fw_elev, hw2)
        q2 = -self.fw_cond * sat2 * (hw2 - self.fw_elev)
        return q, (q2 - q) / eps

    def available(self, x, N):
        """Water a mover can take: the actual withdrawal plus any
        flowing-well discharge (both positive out of the well)."""
        avail = jnp.maximum(-self.rate_actual(x, N), DZERO)
        if self.fw_cond is not None:
            qfw, _ = self.flowing_well_q(x, N)
            avail = avail + jnp.maximum(-qfw, DZERO)
        return avail * self.active

    def budget(self, x, x_old, N, delt, iss, qfrom=None):
        """Per-well flows: GWF exchange (positive into aquifer), rate,
        storage (maw_bd role)."""
        w = self.conn_well
        hw = x[N + w]
        h = x[self.conn_node]
        q_gwf = self.cond * self.active[w] * (hw - h)  # into aquifer
        out = {"MAW-GWF": q_gwf,
               "MAW-RATE": self.rate_actual(x, N) * self.active}
        if self.fw_cond is not None:
            out["MAW-FW"] = self.flowing_well_q(x, N)[0] * self.active
        if self.storage and not iss:
            wrow = N + jnp.arange(self.nwells)
            out["MAW-STO"] = -self.area / delt * (x[wrow] - x_old[wrow]) \
                * self.active
        if qfrom is not None:
            out["MAW-FROM-MVR"] = qfrom * self.active
        return out


def build_maw(wells, grid, k11=None, k22=None):
    """``wells``: list of dicts with keys radius, bottom, strt, rate,
    connections = [(node, cond_or_spec) ...]: a number ≥ 0 is a
    SPECIFIED saturated conductance, < 0 requests THIEM with screen =
    full cell height, and a dict(condeqn=THIEM|SKIN|CUMULATIVE|MEAN,
    scrn_top, scrn_bot, hk_skin, radius_skin) evaluates the reference's
    maw_calculate_satcond equations 1-4 exactly (gwf-maw.f90:
    T2pi = 2π·thka·√(k11·k22), eradius = √(area/8π), skin Tcontrast,
    MEAN midpoint-perimeter form).  Optional per-well keys: head_limit
    (HEAD_LIMIT record), pumpelev + reduction_length (RATE_SCALING),
    flowing=dict(elev, cond, rlen), shut_off=(minrate, maxrate)."""
    conn_well, conn_node, conds = [], [], []
    area, bottomw, strtw, ratew = [], [], [], []
    hlim, pelev, rlen, fwe, fwc, fwr = [], [], [], [], [], []
    smin, smax = [], []
    top = np.asarray(grid.top)
    bot = np.asarray(grid.bot)
    for iw, wspec in enumerate(wells):
        r = float(wspec["radius"])
        area.append(np.pi * r * r)
        bottomw.append(float(wspec.get("bottom", 0.0)))
        strtw.append(float(wspec["strt"]))
        ratew.append(float(wspec.get("rate", 0.0)))
        hlim.append(float(wspec.get("head_limit", BIGHEAD)))
        pelev.append(float(wspec.get("pumpelev", 0.0)))
        rlen.append(float(wspec.get("reduction_length", BIGHEAD)))
        so = wspec.get("shut_off")
        smin.append(float(so[0]) if so else BIGHEAD)
        smax.append(float(so[1]) if so else BIGHEAD)
        fw = wspec.get("flowing")
        fwe.append(float(fw["elev"]) if fw else 0.0)
        fwc.append(float(fw["cond"]) if fw else 0.0)
        fwr.append(float(fw.get("rlen", 1.0)) if fw else 1.0)
        for node, cond in wspec["connections"]:
            conn_well.append(iw)
            conn_node.append(int(node))
            node = int(node)
            if isinstance(cond, dict) or (not isinstance(cond, dict)
                                          and float(cond) < 0):
                spec2 = cond if isinstance(cond, dict) \
                    else dict(condeqn="THIEM")
                eqn = spec2["condeqn"].upper()
                kc11 = float(np.asarray(k11)[node])
                kc22 = (float(np.asarray(k22)[node]) if k22 is not None
                        else kc11)
                sqrtk = np.sqrt(kc11 * kc22)
                thka = float(top[node] - bot[node])
                area = float(np.asarray(grid.area).reshape(-1)[node])
                tthkw = float(spec2.get("scrn_top", top[node])
                              - spec2.get("scrn_bot", bot[node]))
                T2pi = 2.0 * np.pi * thka * sqrtk
                eradius = np.sqrt(area / (8.0 * np.pi))
                lc1 = lc2 = 0.0
                if eqn in ("THIEM", "CUMULATIVE"):
                    lc1 = np.log(eradius / r) / T2pi
                if eqn in ("SKIN", "CUMULATIVE"):
                    hks = float(spec2["hk_skin"])
                    srad = float(spec2["radius_skin"])
                    tcontrast = (sqrtk * thka) / (hks * tthkw)
                    lc2 = (tcontrast - 1.0) * np.log(srad / r) / T2pi
                if eqn == "MEAN":
                    hks = float(spec2["hk_skin"])
                    srad = float(spec2["radius_skin"])
                    ravg = 0.5 * (r + srad)
                    slen = srad - r
                    conds.append(hks * 2.0 * np.pi * ravg * tthkw / slen)
                else:
                    conds.append(1.0 / (lc1 + lc2))
            else:
                conds.append(float(cond))
    out = dict(conn_well=np.asarray(conn_well, np.int32),
               conn_node=np.asarray(conn_node, np.int32),
               cond=np.asarray(conds, np.float64),
               area=np.asarray(area), bottom=np.asarray(bottomw),
               strt=np.asarray(strtw), rate=np.asarray(ratew),
               nwells=len(wells))
    if any(h != BIGHEAD for h in hlim):
        out["head_limit"] = np.asarray(hlim)
    if any(v != BIGHEAD for v in rlen):
        out["pumpelev"] = np.asarray(pelev)
        out["reduction_length"] = np.asarray(rlen)
    if any(c != 0.0 for c in fwc):
        out["fw_elev"] = np.asarray(fwe)
        out["fw_cond"] = np.asarray(fwc)
        out["fw_rlen"] = np.asarray(fwr)
    if any(v != BIGHEAD for v in smin):
        out["shut_min"] = np.asarray(smin)
        out["shut_max"] = np.asarray(smax)
        out["shut"] = np.zeros(len(wells), bool)
    return out


# ------------------------------------------------------------------- LAK

GRAVITY = 9.80665    # DGRAVITY (SI); scaled by convlength/convtime opts
WEIR_CD = 0.61       # DCD, Constants.f90:133


@partial(jax.tree_util.register_dataclass,
         data_fields=["conn_lake", "conn_node", "cond", "belev", "surf_area",
                      "bottom", "strt", "rainfall", "evap", "withdrawal",
                      "out_invert", "out_width",
                      "out_rough", "out_slope", "out_rate", "slot_cl",
                      "slot_lc", "active", "tab_stage", "tab_volume",
                      "tab_sarea", "conn_telev", "conn_ihc", "conn_conv"],
         meta_fields=["nlakes", "noutlets", "out_type", "out_lake",
                      "out_to", "convfact", "out_slot"])
@dataclasses.dataclass(frozen=True)
class LakData:
    """Lake package (gwf-lak.f90 behavioral core).

    Implemented: linear lakebed leakance exchange with free-drainage
    switch when the aquifer head is below the lakebed, storage from
    stage/volume/surface-area TABLES (lak_calculate_vol/sarea
    piecewise-linear interpolation, gwf-lak.f90:1982-2152) or constant
    surface area, rainfall/evaporation/withdrawal, SPECIFIED / MANNING /
    WEIR outlets (lak_calculate_outlet_outflow) with downstream-lake
    coupling carried in the JACOBIAN (not rhs-lagged) when slots are
    provided.  Not yet: horizontal/embedded connections with
    stage-dependent wetted area."""

    conn_lake: jax.Array   # i32[C]
    conn_node: jax.Array   # i32[C]
    cond: jax.Array        # f64[C] bedleak × connection area
    belev: jax.Array       # f64[C] lakebed elevation at the connection
    surf_area: jax.Array   # f64[L]
    bottom: jax.Array      # f64[L]
    strt: jax.Array        # f64[L]
    rainfall: jax.Array    # f64[L] volumetric rate
    evap: jax.Array        # f64[L] volumetric rate
    withdrawal: jax.Array  # f64[L]
    out_lake: tuple        # int[O] source lake (host/static)
    out_to: tuple          # int[O] receiving lake (-1 external; host/static)
    out_invert: jax.Array  # f64[O]
    out_width: jax.Array   # f64[O]
    out_rough: jax.Array   # f64[O]
    out_slope: jax.Array   # f64[O]
    out_rate: jax.Array    # f64[O] (SPECIFIED outlets)
    slot_cl: jax.Array     # i32[C]
    slot_lc: jax.Array     # i32[C]
    active: jax.Array      # bool[L]
    tab_stage: jax.Array = None    # f64[L, T] stage/volume/sarea tables
    tab_volume: jax.Array = None   # f64[L, T]
    tab_sarea: jax.Array = None    # f64[L, T]
    # horizontal-connection wetted-area scaling (lak_calculate_conn_*):
    conn_telev: jax.Array = None   # f64[C] connection top elevation
    conn_ihc: jax.Array = None     # i32[C] 0=vertical, 1=horizontal
    conn_conv: jax.Array = None    # bool[C] connected cell convertible
    out_slot: tuple = None         # int[O] ext slot of (dst row, src row)
    nlakes: int = 0
    noutlets: int = 0
    out_type: tuple = ()   # "specified" | "manning" | "weir" per outlet
    convfact: float = 1.0  # convlength·convtime² gravity conversion

    # -------------------------------------------------- stage relations

    def conn_cond(self, s, h):
        """Effective connection conductance (lak_calculate_conn_conductance
        + lak_calculate_cond_head): HORIZONTAL connections to convertible
        cells scale the saturated conductance by the quadratic wetted
        saturation at vv = ½(min(stage, telev) + min(head, telev));
        vertical (lakebed) connections use the full value."""
        if self.conn_telev is None or self.conn_ihc is None:
            return self.cond
        from ...ops.smoothing import quadratic_saturation
        topl = self.conn_telev
        botl = self.belev
        vv = 0.5 * (jnp.minimum(s, topl) + jnp.minimum(h, topl))
        sat = quadratic_saturation(topl, botl, vv)
        conv = (self.conn_conv if self.conn_conv is not None
                else jnp.ones_like(sat, bool))
        scale_h = jnp.where(conv, sat, 1.0)
        # vertical: full conductance when telev == belev (plain lakebed)
        thin = jnp.abs(topl - botl) < 1e-10
        scale_v = jnp.where(thin, 1.0, sat)
        return self.cond * jnp.where(self.conn_ihc == 1, scale_h, scale_v)

    def sarea_of(self, s):
        """Lake surface area at stage (lak_calculate_sarea): table
        piecewise-linear (clamped) or the constant surf_area."""
        if self.tab_stage is None:
            return self.surf_area
        return jax.vmap(jnp.interp)(s, self.tab_stage, self.tab_sarea)

    def volume_of(self, s):
        """Lake volume at stage (lak_calculate_vol): table interpolation
        with linear extrapolation above the table top at the last
        surface area; without tables, prism above the lake bottom."""
        if self.tab_stage is None:
            return self.surf_area * jnp.maximum(s - self.bottom, 0.0)
        v = jax.vmap(jnp.interp)(s, self.tab_stage, self.tab_volume)
        return v + jnp.maximum(s - self.tab_stage[:, -1], 0.0) \
            * self.tab_sarea[:, -1]

    def outlet_flow(self, x, N, i):
        """(q, dq/ds_src) for outlet i at the current iterate
        (lak_calculate_outlet_outflow select case)."""
        src = int(self.out_lake[i])
        srow = N + src
        typ = self.out_type[i]
        if typ == "specified":
            return self.out_rate[i], jnp.zeros(())
        d = jnp.maximum(x[srow] - self.out_invert[i], 0.0)
        if typ == "weir":
            # q = (2/3)·Cd·w·d·√(2·g·d)
            coef = (2.0 / 3.0) * WEIR_CD * self.out_width[i] \
                * jnp.sqrt(2.0 * GRAVITY * self.convfact)
            q = coef * d ** 1.5
            dq = jnp.where(d > 0.0, 1.5 * coef * jnp.sqrt(d), 0.0)
            return q, dq
        coef = self.out_width[i] / self.out_rough[i] * \
            jnp.sqrt(self.out_slope[i])
        q = coef * d ** (5.0 / 3.0)
        dq = jnp.where(d > 0.0, coef * (5.0 / 3.0) * d ** (2.0 / 3.0), 0.0)
        return q, dq

    def available(self, x, N):
        """Mover-available water per OUTLET (the LAK provider entry space,
        gwf-lak.f90 outlets feed the mover)."""
        return jnp.stack([self.outlet_flow(x, N, i)[0]
                          for i in range(len(self.out_type))]) \
            if self.out_type else jnp.zeros(0)

    def terms(self, x, x_old, N, Ktot, delt, iss, diag, offf, rhs,
              qto_out=None, qfrom=None):
        """``qto_out``: f64[O] mover water taken per outlet (reduces what
        the downstream lake receives); ``qfrom``: f64[L] mover inflow per
        lake."""
        L = self.nlakes
        lrow = N + jnp.arange(L)
        lk = self.conn_lake
        node = self.conn_node
        s = x[N + lk]
        h = x[node]
        act_c = self.active[lk]
        # exchange q = c (s − h) when h > belev, else c (s − belev)
        # (lak_calculate_conn_exchange); the switch is re-evaluated each
        # Picard iteration on the current iterate
        coupled = h > self.belev
        c = self.conn_cond(s, h) * act_c
        c_h = jnp.where(coupled, c, 0.0)
        diag = diag.at[node].add(-c_h)
        offf = offf.at[self.slot_cl].add(c_h)
        # free drainage: the cell receives the Picard-lagged flux
        # c (s_k − belev) — a constant this iteration, keeping the matrix
        # symmetric (lak_calculate_conn_exchange free-drainage branch)
        rhs = rhs.at[node].add(
            jnp.where(coupled, 0.0, -c * (s - self.belev)))
        diag = diag.at[N + lk].add(-c)
        offf = offf.at[self.slot_lc].add(c_h)
        rhs = rhs.at[N + lk].add(jnp.where(coupled, 0.0, -c * self.belev))
        # storage + fixed sources: −(V(s) − V(s_old))/Δt, Newton-linearized
        # with dV/ds = sarea(s) (lak_calculate_vol/sarea); constant-area
        # lakes reduce to the familiar A/Δt (s − s_old) form
        act = self.active
        s_l = x[lrow]
        if self.tab_stage is None:
            sc = jnp.where(iss, 0.0, self.surf_area / delt) * act
            diag = diag.at[lrow].add(-sc)
            rhs = rhs.at[lrow].add(-sc * x_old[lrow])
        else:
            sa_k = self.sarea_of(s_l)
            v_k = self.volume_of(s_l)
            v_old = self.volume_of(x_old[lrow])
            sc = jnp.where(iss, 0.0, sa_k / delt) * act
            diag = diag.at[lrow].add(-sc)
            rhs = rhs.at[lrow].add(jnp.where(
                iss, 0.0, ((v_k - v_old) / delt) * act) - sc * s_l)
        rhs = rhs.at[lrow].add(-(self.rainfall - self.evap
                                 - self.withdrawal) * act)
        # mover inflow (lagged constant this iteration, lak_fc mover block)
        if qfrom is not None:
            rhs = rhs.at[lrow].add(-qfrom * act)
        # outlets, linearized at the current iterate; out_lake/out_to are
        # host Python ints (pytree aux data) so this loop unrolls at trace
        # time — no traced indices reach int()
        for i in range(len(self.out_type)):
            src = int(self.out_lake[i])
            dst = int(self.out_to[i])
            srow = N + src
            q, dq = self.outlet_flow(x, N, i)
            # source row: −q(s) ⇒ −[q_k + dq·(s−s_k)]
            diag = diag.at[srow].add(-dq)
            rhs = rhs.at[srow].add(q - dq * x[srow])
            if dst >= 0:
                # receiving lake gains q(s_src) less whatever the mover
                # takes from this outlet (the moved slice stays lagged)
                q_dst = q if qto_out is None else q - qto_out[i]
                if self.out_slot is not None and int(self.out_slot[i]) >= 0:
                    # Jacobian-coupled: A[dst,src] += dq (asymmetric —
                    # requires BiCGSTAB, like Newton fills)
                    offf = offf.at[self.out_slot[i]].add(dq)
                    rhs = rhs.at[N + dst].add(-q_dst + dq * x[srow])
                else:
                    rhs = rhs.at[N + dst].add(-q_dst)
        return diag, offf, rhs

    def budget(self, x, x_old, N, delt, iss, qto_out=None, qfrom=None):
        lk = self.conn_lake
        s = x[N + lk]
        h = x[self.conn_node]
        coupled = h > self.belev
        q = self.conn_cond(s, h) * self.active[lk] * jnp.where(
            coupled, s - h, s - self.belev)
        out = {"LAK-GWF": q,
               "LAK-RAIN": self.rainfall * self.active,
               "LAK-EVAP": -self.evap * self.active,
               "LAK-WDRL": -self.withdrawal * self.active}
        if self.out_type:
            q_out = self.available(x, N)
            if qto_out is not None:
                out["LAK-TO-MVR"] = -qto_out
                q_out = q_out - qto_out
            out["LAK-OUT"] = -q_out
        if qfrom is not None:
            out["LAK-FROM-MVR"] = qfrom * self.active
        if not iss:
            lrow = N + jnp.arange(self.nlakes)
            out["LAK-STO"] = -(self.volume_of(x[lrow])
                               - self.volume_of(x_old[lrow])) / delt \
                * self.active
        return out


def build_lak(lakes, outlets=None):
    """``lakes``: list of dicts (strt, bottom, surf_area, rainfall, evap,
    withdrawal, connections=[(node, bedleak_times_area, belev)], optional
    table=[(stage, volume, sarea), ...] — the LAK TABLES block);
    ``outlets``: list of dicts (lake, to=-1, type in specified|manning|
    weir, invert, width, rough, slope, rate)."""
    outlets = outlets or []
    tables = None
    if any("table" in s for s in lakes):
        T = max(max(len(s.get("table", [])) for s in lakes), 2)
        L = len(lakes)
        tstage = np.zeros((L, T))
        tvol = np.zeros((L, T))
        tsar = np.zeros((L, T))
        for il, s in enumerate(lakes):
            tab = s.get("table")
            if tab:
                rows = np.asarray(tab, np.float64)
                n = rows.shape[0]
                tstage[il, :n] = rows[:, 0]
                tvol[il, :n] = rows[:, 1]
                tsar[il, :n] = rows[:, 2]
                # pad: continue linearly above the table top
                for j in range(n, T):
                    tstage[il, j] = tstage[il, j - 1] + 1.0
                    tvol[il, j] = tvol[il, j - 1] + tsar[il, n - 1]
                    tsar[il, j] = tsar[il, n - 1]
            else:
                # synthesize a linear prism table from surf_area/bottom
                a = float(s["surf_area"])
                b = float(s.get("bottom", 0.0))
                tstage[il] = b + np.linspace(0.0, 1.0, T) * 1e4
                tvol[il] = (tstage[il] - b) * a
                tsar[il] = a
        tables = (tstage, tvol, tsar)
    conn_lake, conn_node, cond, belev = [], [], [], []
    telev, ihc = [], []
    for il, spec in enumerate(lakes):
        for conn in spec["connections"]:
            node, c, be = conn[0], conn[1], conn[2]
            te = conn[3] if len(conn) > 3 else be
            ic = conn[4] if len(conn) > 4 else 0
            conn_lake.append(il)
            conn_node.append(int(node))
            cond.append(float(c))
            belev.append(float(be))
            telev.append(float(te))
            ihc.append(int(ic))
    return dict(
        conn_lake=np.asarray(conn_lake, np.int32),
        conn_node=np.asarray(conn_node, np.int32),
        cond=np.asarray(cond), belev=np.asarray(belev),
        conn_telev=np.asarray(telev), conn_ihc=np.asarray(ihc, np.int32),
        surf_area=np.asarray([s["surf_area"] for s in lakes]),
        bottom=np.asarray([s.get("bottom", -1e30) for s in lakes]),
        strt=np.asarray([s["strt"] for s in lakes]),
        rainfall=np.asarray([s.get("rainfall", 0.0) for s in lakes]),
        evap=np.asarray([s.get("evap", 0.0) for s in lakes]),
        withdrawal=np.asarray([s.get("withdrawal", 0.0) for s in lakes]),
        out_lake=tuple(int(o["lake"]) for o in outlets) or (0,),
        out_to=tuple(int(o.get("to", -1)) for o in outlets) or (-1,),
        out_invert=np.asarray([o.get("invert", 0.0) for o in outlets]
                              or [0.0]),
        out_width=np.asarray([o.get("width", 1.0) for o in outlets] or [1.0]),
        out_rough=np.asarray([o.get("rough", 0.03) for o in outlets]
                             or [1.0]),
        out_slope=np.asarray([o.get("slope", 1e-3) for o in outlets]
                             or [1.0]),
        out_rate=np.asarray([o.get("rate", 0.0) for o in outlets] or [0.0]),
        out_type=tuple(o.get("type", "specified") for o in outlets),
        nlakes=len(lakes), noutlets=len(outlets),
        **({"tab_stage": tables[0], "tab_volume": tables[1],
            "tab_sarea": tables[2]} if tables is not None else {}))


# ------------------------------------------------------------------- SFR

@partial(jax.tree_util.register_dataclass,
         data_fields=["cond", "strtop", "width", "rough", "slope", "length",
                      "upstream", "frac", "inflow", "rainfall", "evap",
                      "runoff", "node", "strt", "slot_cr", "slot_rc",
                      "active", "divflow", "xs_station", "xs_height",
                      "xs_rf", "xs_rect", "up_pair_r", "up_pair_u",
                      "up_pair_f", "up_pair_slot"],
         meta_fields=["nreaches", "div_src", "div_to", "div_rule"])
@dataclasses.dataclass(frozen=True)
class SfrData:
    """Streamflow routing package (gwf-sfr.f90 behavioral core).

    Implemented: Manning outflow (rectangular wide-channel or N-POINT
    CROSS SECTIONS via ops/cxs.py, matching SwfCxsUtils conveyance),
    upstream-fraction routing with the upstream coupling in the JACOBIAN
    (up_pair_slot entries — asymmetric, BiCGSTAB), DIVERSIONS with the
    four cprior rules (sfr_calc_div: FRACTION/EXCESS/THRESHOLD/UPTO,
    sequentially consuming the remaining downstream flow), linear
    streambed exchange with free-drainage switch, rainfall/evap/runoff/
    specified inflow, mover terms.  Not yet: transient channel storage."""

    cond: jax.Array      # f64[R] bed conductance (k·w·L/thick)
    strtop: jax.Array    # f64[R] streambed top elevation
    width: jax.Array     # f64[R]
    rough: jax.Array     # f64[R]
    slope: jax.Array     # f64[R]
    length: jax.Array    # f64[R]
    upstream: jax.Array  # i32[R, U] upstream reach ids (self-padded)
    frac: jax.Array      # f64[R, U] fraction of upstream outflow received
    inflow: jax.Array    # f64[R] specified inflow
    rainfall: jax.Array  # f64[R] volumetric
    evap: jax.Array      # f64[R] volumetric
    runoff: jax.Array    # f64[R]
    node: jax.Array      # i32[R] gwf cell (-? always valid here)
    strt: jax.Array      # f64[R] initial stage
    slot_cr: jax.Array   # i32[R] (cell row, reach col) ext slot
    slot_rc: jax.Array   # i32[R] (reach row, cell col) ext slot
    active: jax.Array    # bool[R]
    divflow: jax.Array = None     # f64[D] diversion values (period data)
    xs_station: jax.Array = None  # f64[R, P] n-point stations
    xs_height: jax.Array = None   # f64[R, P]
    xs_rf: jax.Array = None       # f64[R, P-1] roughness fractions
    xs_rect: jax.Array = None     # bool[R] rectangular fast path
    up_pair_r: jax.Array = None   # i32[P] routing pair: downstream reach
    up_pair_u: jax.Array = None   # i32[P] routing pair: upstream reach
    up_pair_f: jax.Array = None   # f64[P] ustrf fraction
    up_pair_slot: jax.Array = None  # i32[P] ext slot of (r row, u col)
    nreaches: int = 0
    div_src: tuple = ()  # int[D] diverting reach
    div_to: tuple = ()   # int[D] receiving reach
    div_rule: tuple = () # str[D] cprior

    def _manning(self, stage):
        d = jnp.maximum(stage - self.strtop, 0.0)
        if self.xs_station is not None:
            from ...ops import cxs
            conv = cxs.conveyance(self.xs_station, self.xs_height,
                                  self.xs_rf, self.rough, d, self.xs_rect)
            q = conv * jnp.sqrt(self.slope)
            eps = jnp.sqrt(DPREC) * jnp.maximum(jnp.abs(d), 1.0)
            conv2 = cxs.conveyance(self.xs_station, self.xs_height,
                                   self.xs_rf, self.rough, d + eps,
                                   self.xs_rect)
            dq = (conv2 * jnp.sqrt(self.slope) - q) / eps
            return q, jnp.where(d > 0.0, dq, 0.0)
        coef = self.width / self.rough * jnp.sqrt(self.slope)
        q = coef * d ** (5.0 / 3.0)
        dq = jnp.where(d > 0.0, coef * (5.0 / 3.0) * d ** (2.0 / 3.0), 0.0)
        return q, dq

    def routing(self, q, qto):
        """Downstream-routable flow after mover and diversions.

        qd starts as the reach outflow less mover take; each diversion on
        a reach then consumes from the remainder in declared order
        (sfr_calc_div + the qd bookkeeping of sfr_solve).  Returns
        (qd[R], div_in[R] inflow delivered to diversion receivers)."""
        qd = q if qto is None else jnp.maximum(q - qto, 0.0)
        div_in = jnp.zeros(self.nreaches)
        for i in range(len(self.div_src)):
            s, t = self.div_src[i], self.div_to[i]
            rule = self.div_rule[i]
            v = self.divflow[i]
            qs = qd[s]
            if rule == "fraction":
                vq = qs * v
            elif rule == "excess":
                vq = jnp.maximum(qs - v, DZERO)
            elif rule == "threshold":
                vq = jnp.where(qs < v, DZERO, v)
            else:  # upto
                vq = jnp.minimum(v, qs)
            qd = qd.at[s].add(-vq)
            div_in = div_in.at[t].add(vq)
        return qd, div_in

    def available(self, x, N):
        """Mover-available water per reach: the downstream outflow at the
        current iterate (sfr dsflow feeds the mover)."""
        q, _ = self._manning(x[N + jnp.arange(self.nreaches)])
        return q * self.active

    def terms(self, x, x_old, N, Ktot, delt, iss, diag, offf, rhs,
              qto=None, qfrom=None):
        """``qto``: f64[R] mover water taken from each reach's outflow
        (reduces downstream routing); ``qfrom``: f64[R] mover inflow."""
        R = self.nreaches
        rrow = N + jnp.arange(R)
        stage = x[rrow]
        h = x[self.node]
        act = self.active
        # gwf exchange q_gwf = c (stage − h), free drainage below bed
        coupled = h > self.strtop
        c = self.cond * act
        c_h = jnp.where(coupled, c, 0.0)
        diag = diag.at[self.node].add(-c_h)
        offf = offf.at[self.slot_cr].add(c_h)
        # free drainage below the streambed: the cell receives the
        # Picard-lagged flux c (stage_k − strtop), a constant this
        # iteration (symmetric matrix; gwf-sfr.f90 sfr_calc disconnected
        # branch).  The previous -c*strtop here injected a spurious
        # c*strtop source that flipped the switch every iteration.
        rhs = rhs.at[self.node].add(
            jnp.where(coupled, 0.0, -c * (stage - self.strtop)))
        diag = diag.at[rrow].add(-c)
        offf = offf.at[self.slot_rc].add(c_h)
        rhs = rhs.at[rrow].add(jnp.where(coupled, 0.0, -c * self.strtop))
        # outflow (Manning) linearized: continuity row r:
        #   Qin + ext − Qout(s_r) − q_gwf = 0
        q, dq = self._manning(stage)
        diag = diag.at[rrow].add(-dq * act)
        rhs = rhs.at[rrow].add((q - dq * stage) * act)
        # upstream inflows: Σ_u frac·Qout_u(s_u), linearized in s_u.
        # The coupling coefficient dq_u goes into the (r,u) slot only when
        # reaches are declared connected; here routed via rhs with the
        # current iterate (Picard-lagged, converges with the outer loop).
        up = self.upstream
        q_route, div_in = self.routing(q, qto)
        q_up = q_route[up] * self.frac
        rhs = rhs.at[rrow].add(-q_up.sum(axis=1) * act)
        # upstream coupling in the Jacobian: downstream row r gains
        # t(s_u) = ustrf·qd(s_u); t' ≈ ustrf·(qd_k/q_k)·dq_u (the mover/
        # diversion reduction factor is Picard-lagged, exact when absent)
        if self.up_pair_slot is not None and self.up_pair_r.shape[0] > 0:
            u = self.up_pair_u
            factor = jnp.where(q[u] > DZERO,
                               q_route[u] / jnp.where(q[u] > DZERO, q[u],
                                                      1.0), DZERO)
            tprime = self.up_pair_f * factor * dq[u] \
                * act[self.up_pair_r] * act[u]
            offf = offf.at[self.up_pair_slot].add(tprime)
            rhs = rhs.at[N + self.up_pair_r].add(tprime * stage[u])
        ext = (self.inflow + self.runoff + self.rainfall - self.evap) * act
        rhs = rhs.at[rrow].add(-ext)
        rhs = rhs.at[rrow].add(-div_in * act)
        if qfrom is not None:
            rhs = rhs.at[rrow].add(-qfrom * act)
        return diag, offf, rhs

    def budget(self, x, x_old, N, delt, iss, qto=None, qfrom=None):
        rrow = N + jnp.arange(self.nreaches)
        stage = x[rrow]
        h = x[self.node]
        coupled = h > self.strtop
        q_gwf = self.cond * self.active * jnp.where(
            coupled, stage - h, stage - self.strtop)
        q_out, _ = self._manning(stage)
        q_out = q_out * self.active
        out = {"SFR-GWF": q_gwf,
               "SFR-EXT": (self.inflow + self.runoff + self.rainfall
                           - self.evap) * self.active}
        if qto is not None:
            out["SFR-TO-MVR"] = -qto
            q_out = jnp.maximum(q_out - qto, 0.0)
        out["SFR-OUT"] = -q_out
        if qfrom is not None:
            out["SFR-FROM-MVR"] = qfrom * self.active
        return out


def build_sfr(reaches):
    """``reaches``: list of dicts (node, cond, strtop, width, rough, slope,
    length, upstream=[(reach, frac)...], inflow, rainfall, evap, runoff,
    strt); optional per-reach keys: xsection=(stations, heights[,
    rough_fracs]) n-point cross section (XFRACTION·width convention),
    diversions=[dict(to, cprior, flow) ...]."""
    R = len(reaches)
    U = max((len(r.get("upstream", [])) for r in reaches), default=0)
    U = max(U, 1)
    upstream = np.tile(np.arange(R, dtype=np.int32)[:, None], (1, U))
    frac = np.zeros((R, U))
    for i, r in enumerate(reaches):
        for u, (ur, f) in enumerate(r.get("upstream", [])):
            upstream[i, u] = ur
            frac[i, u] = f
    g = lambda k, d=0.0: np.asarray([r.get(k, d) for r in reaches],
                                    np.float64)
    out = dict(
        cond=g("cond"), strtop=g("strtop"), width=g("width", 1.0),
        rough=g("rough", 0.03), slope=g("slope", 1e-3),
        length=g("length", 1.0), upstream=upstream, frac=frac,
        inflow=g("inflow"), rainfall=g("rainfall"), evap=g("evap"),
        runoff=g("runoff"),
        node=np.asarray([r["node"] for r in reaches], np.int32),
        strt=g("strt"), nreaches=R)
    if any("xsection" in r for r in reaches):
        from ...ops import cxs
        secs = []
        for i, r in enumerate(reaches):
            xsec = r.get("xsection")
            if xsec is None:
                # rectangular default: two walls + bed at the reach width
                w = float(out["width"][i])
                big = 1e6
                secs.append(([0.0, 0.0, w, w], [big, 0.0, 0.0, big], None))
            else:
                st = np.asarray(xsec[0], np.float64) * float(out["width"][i])
                secs.append((st, xsec[1],
                             xsec[2] if len(xsec) > 2 else None))
        st, ht, rf, rect = cxs.pack_sections(secs)
        out.update(xs_station=st, xs_height=ht, xs_rf=rf, xs_rect=rect)
    divs = []
    for i, r in enumerate(reaches):
        for dv in r.get("diversions", []):
            divs.append((i, int(dv["to"]), str(dv["cprior"]).lower(),
                         float(dv.get("flow", 0.0))))
    if divs:
        out.update(div_src=tuple(d[0] for d in divs),
                   div_to=tuple(d[1] for d in divs),
                   div_rule=tuple(d[2] for d in divs),
                   divflow=np.asarray([d[3] for d in divs]))
    return out


# -------------------------------------------------------------- augmented

class AugmentedGwfModel:
    """GWF model + advanced packages as one (N+R)-row system.

    Drop-in for NumericalSolution: exposes assemble/boundary_state/dtopo/
    strt over the augmented vector.  Plays the role of the reference's
    sln_connect + bnd_ac matrix expansion (NumericalSolution.f90 +
    BoundaryPackage bnd_ac overrides)."""

    def __init__(self, base, maw=None, lak=None, sfr=None, mvr=None,
                 ktot_min=0):
        self.base = base
        N = base.nodes
        offset = N
        pkg_edges = []
        specs = []
        for name, spec, data_cls in (("maw", maw, MawData),
                                     ("lak", lak, LakData),
                                     ("sfr", sfr, SfrData)):
            if spec is None:
                setattr(self, name, None)
                continue
            specs.append((name, spec, data_cls, offset))
            if name == "maw":
                rows = spec["nwells"]
                cells = spec["conn_node"]
                owners = spec["conn_well"]
            elif name == "lak":
                rows = spec["nlakes"]
                cells = spec["conn_node"]
                owners = spec["conn_lake"]
            else:
                rows = spec["nreaches"]
                cells = spec["node"]
                owners = np.arange(rows)
            for cell, owner in zip(cells, owners):
                pkg_edges.append((int(cell), offset + int(owner)))
            offset += rows
        self.n_grid = N
        self.n_extra = offset - N
        # package↔package coupling edges (Jacobian-coupled outlets and
        # upstream routing; reference carries these through bnd_ac too):
        # lake outlet (dst, src) pairs and SFR routing (r, u) pairs
        lak_out_edge = []
        sfr_pair_edge = []
        offs = {name: off for name, _, _, off in specs}
        if lak is not None and lak.get("noutlets", 0):
            loff = offs["lak"]
            out_lake, out_to = lak["out_lake"], lak["out_to"]
            for iout in range(len(lak["out_type"])):
                src, dst = int(out_lake[iout]), int(out_to[iout])
                if dst >= 0 and dst != src:
                    lak_out_edge.append(len(pkg_edges))
                    pkg_edges.append((loff + dst, loff + src))
                else:
                    lak_out_edge.append(-1)
        if sfr is not None:
            soff = offs["sfr"]
            ups, fr = sfr["upstream"], sfr["frac"]
            sfr_pairs = []
            for r in range(sfr["nreaches"]):
                for j in range(ups.shape[1]):
                    if fr[r, j] != 0.0 and int(ups[r, j]) != r:
                        sfr_pairs.append((r, int(ups[r, j]),
                                          float(fr[r, j])))
                        sfr_pair_edge.append(len(pkg_edges))
                        pkg_edges.append((soff + r, soff + int(ups[r, j])))
        base_nbr = np.asarray(base.topo.nbr) if not base.use_structured \
            else np.asarray(base.topo.nbr)
        nbr_ext, slot_ab, slot_ba = _build_ext_table(
            base_nbr, N, self.n_extra, pkg_edges, ktot_min=ktot_min)
        self.dtopo = AugTopo(nbr=jnp.asarray(nbr_ext))
        self.Ktot = nbr_ext.shape[1]
        self.Kb = base_nbr.shape[1]

        # distribute slots back to packages in edge order
        i = 0
        for name, spec, data_cls, off in specs:
            n_conn = len(spec["conn_node"]) if name != "sfr" \
                else len(spec["node"])
            sab = jnp.asarray(slot_ab[i:i + n_conn], jnp.int32)
            sba = jnp.asarray(slot_ba[i:i + n_conn], jnp.int32)
            i += n_conn
            kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in spec.items()}
            if name == "maw":
                data = MawData(**kw, slot_cw=sab, slot_wc=sba,
                               active=jnp.ones(spec["nwells"], bool))
            elif name == "lak":
                out_slot = tuple(
                    int(slot_ab[e]) if e >= 0 else -1
                    for e in lak_out_edge) or None
                if "conn_conv" not in kw:
                    ict = getattr(getattr(base, "npf_arrays", None),
                                  "icelltype", None)
                    if ict is not None:
                        kw["conn_conv"] = jnp.asarray(
                            np.asarray(ict)[spec["conn_node"]] != 0)
                data = LakData(**kw, slot_cl=sab, slot_lc=sba,
                               active=jnp.ones(spec["nlakes"], bool),
                               out_slot=out_slot)
            else:
                if sfr_pairs:
                    pr = jnp.asarray([p[0] for p in sfr_pairs], jnp.int32)
                    pu = jnp.asarray([p[1] for p in sfr_pairs], jnp.int32)
                    pf = jnp.asarray([p[2] for p in sfr_pairs])
                    ps = jnp.asarray([int(slot_ab[e])
                                      for e in sfr_pair_edge], jnp.int32)
                else:
                    pr = pu = ps = jnp.zeros(0, jnp.int32)
                    pf = jnp.zeros(0)
                data = SfrData(**kw, slot_cr=sab, slot_rc=sba,
                               active=jnp.ones(spec["nreaches"], bool),
                               up_pair_r=pr, up_pair_u=pu, up_pair_f=pf,
                               up_pair_slot=ps)
            setattr(self, name, data)
            setattr(self, f"_{name}_offset", off)

        self.use_structured = False
        # Newton rides through: the base assembles its upstream-weighted
        # Jacobian (npf_fn/sto_fn), the feature rows keep their own
        # analytic derivative terms (maw_fn/sfr submodule roles are the
        # rate_actual_and_deriv / flowing_well / outlet dq terms already
        # in MawData/LakData/SfrData.terms); NUR applies to grid rows
        # only (gwf_nur operates per gwf node)
        self.inewton = getattr(base, "inewton", 0)
        self.inewtonur = getattr(base, "inewtonur", 0)

        # ------------------------------------------------------ MVR mover
        self.mvr = None
        if mvr:
            from . import mvr as mvr_mod
            data = mvr_mod.build_mvr(mvr)
            base_pkgs = base.packages
            for pk in set(data.prov_pkg):
                if pk in ("wel", "drn", "riv", "ghb"):
                    if getattr(base_pkgs, pk, None) is None:
                        raise ValueError(
                            f"mover provider {pk!r} not present in model")
                elif getattr(self, pk, None) is None:
                    raise ValueError(
                        f"mover provider {pk!r} not present in model")
            for rk in set(data.recv_pkg):
                if getattr(self, rk, None) is None:
                    raise ValueError(
                        f"mover receiver {rk!r} not present in model")
            self.mvr = data

    # ---------------------------------------------------------- mover eval

    def _recv_sizes(self):
        sizes = {}
        if self.sfr is not None:
            sizes["sfr"] = self.sfr.nreaches
        if self.lak is not None:
            sizes["lak"] = self.lak.nlakes
        if self.maw is not None:
            sizes["maw"] = self.maw.nwells
        return sizes

    def eval_movers(self, x, ibound, pkgs=None):
        """Provider availabilities at the current iterate → mover chain.
        Returns (qp[M], qto: dict, qfrom: dict); all-zero dicts if no MVR.
        (gwf-mvr.f90 mvr_fc role — Picard-lagged like the reference.)"""
        from . import mvr as mvr_mod
        N = self.n_grid
        p = pkgs if pkgs is not None else self.base.packages
        avail = mvr_mod.base_package_available(
            self.base, p, x[:N], ibound[:N])
        if self.sfr is not None:
            avail["sfr"] = self.sfr.available(x, self._sfr_offset)
        if self.lak is not None:
            avail["lak"] = self.lak.available(x, self._lak_offset)
        if self.maw is not None:
            avail["maw"] = self.maw.available(x, self._maw_offset)
        return mvr_mod.run_movers(self.mvr, avail, self._recv_sizes())

    # ------------------------------------------------- model interface

    @property
    def nodes(self):
        return self.n_grid + self.n_extra

    @property
    def name(self):
        return self.base.name

    @property
    def grid(self):
        return self.base.grid

    @property
    def topo(self):
        return self.base.topo

    @property
    def npf_arrays(self):
        return self.base.npf_arrays

    @property
    def sto_arrays(self):
        return self.base.sto_arrays

    @property
    def sto_opts(self):
        return self.base.sto_opts

    @property
    def strt(self):
        parts = [jnp.asarray(self.base.strt)]
        for name in ("maw", "lak", "sfr"):
            d = getattr(self, name)
            if d is not None:
                parts.append(d.strt)
        return jnp.concatenate(parts)

    @property
    def packages(self):
        return self.base.packages

    def boundary_state(self, x, pkgs=None):
        head = x[:self.n_grid]
        ibound, head = self.base.boundary_state(head, pkgs)
        ib_ext = jnp.ones(self.n_extra, jnp.int32)
        return (jnp.concatenate([ibound, ib_ext]),
                jnp.concatenate([head, x[self.n_grid:]]))

    def assemble(self, x, x_old, ibound, delt, iss, pkgs=None,
                 newton: bool = True):
        N, Kb, Ktot = self.n_grid, self.Kb, self.Ktot
        head = x[:N]
        diag_b, off_b, rhs_b = self.base.assemble(
            head, x_old[:N], ibound[:N], delt, iss, pkgs, newton=newton)
        diag = jnp.concatenate([diag_b, jnp.zeros(self.n_extra)])
        offf = jnp.zeros((self.nodes) * Ktot)
        off_emb = jnp.zeros((N, Ktot)).at[:, :Kb].set(off_b.reshape(N, Kb))
        offf = offf.at[:N * Ktot].set(off_emb.reshape(-1))
        rhs = jnp.concatenate([rhs_b, jnp.zeros(self.n_extra)])
        qto, qfrom = {}, {}
        if self.mvr is not None:
            _, qto, qfrom = self.eval_movers(x, ibound, pkgs)
        if self.maw is not None:
            diag, offf, rhs = self.maw.terms(
                x, x_old, self._maw_offset, Ktot, delt, iss, diag, offf,
                rhs, qfrom=qfrom.get("maw"))
        if self.lak is not None:
            diag, offf, rhs = self.lak.terms(
                x, x_old, self._lak_offset, Ktot, delt, iss, diag, offf,
                rhs, qto_out=qto.get("lak"), qfrom=qfrom.get("lak"))
        if self.sfr is not None:
            diag, offf, rhs = self.sfr.terms(
                x, x_old, self._sfr_offset, Ktot, delt, iss, diag, offf,
                rhs, qto=qto.get("sfr"), qfrom=qfrom.get("sfr"))
        return diag, offf.reshape(self.nodes, Ktot), rhs

    def edge_conductances(self, x, ibound, pkgs=None):
        return self.base.edge_conductances(x[:self.n_grid],
                                           ibound[:self.n_grid])

    def edge_flows(self, x, ibound, cond=None, pkgs=None):
        return self.base.edge_flows(x[:self.n_grid], ibound[:self.n_grid],
                                    cond, pkgs)

    def boundary_budget(self, x, ibound, pkgs=None):
        out = self.base.boundary_budget(x[:self.n_grid],
                                        ibound[:self.n_grid], pkgs)
        if self.mvr is not None:
            # water a mover takes no longer exits through the provider's
            # normal fate: reduce the reported package rate by qtomvr
            # (the aquifer-side total is unchanged; the moved slice shows
            # up as <PKG>-TO-MVR in advanced_budget)
            _, qto, _ = self.eval_movers(x, ibound, pkgs)
            for pk in ("wel", "drn", "riv", "ghb"):
                if pk in qto and out.get(pk.upper()) is not None:
                    out[pk.upper()] = out[pk.upper()] + qto[pk]
        return out

    def advanced_budget(self, x, x_old, delt, iss, pkgs=None):
        qto, qfrom = {}, {}
        if self.mvr is not None:
            ib, _ = self.boundary_state(x, pkgs)
            _, qto, qfrom = self.eval_movers(x, ib, pkgs)
        out = {}
        if self.maw is not None:
            out.update(self.maw.budget(x, x_old, self._maw_offset, delt,
                                       iss, qfrom=qfrom.get("maw")))
        if self.lak is not None:
            out.update(self.lak.budget(x, x_old, self._lak_offset, delt,
                                       iss, qto_out=qto.get("lak"),
                                       qfrom=qfrom.get("lak")))
        if self.sfr is not None:
            out.update(self.sfr.budget(x, x_old, self._sfr_offset, delt,
                                       iss, qto=qto.get("sfr"),
                                       qfrom=qfrom.get("sfr")))
        # standard-package providers: the moved slice is reported as its
        # own TO-MVR term (BoundaryPackage.f90:670-684 relabeling)
        for pk in ("wel", "drn", "riv", "ghb"):
            if pk in qto:
                out[f"{pk.upper()}-TO-MVR"] = -qto[pk]
        return out

    def mvr_budget(self, x, pkgs=None):
        """Per-mover moved rates (gwf-mvr.f90 budget role): list of
        (provider, iprov, receiver, ircv, rate)."""
        if self.mvr is None:
            return []
        ib, _ = self.boundary_state(x, pkgs)
        qp, _, _ = self.eval_movers(x, ib, pkgs)
        m = self.mvr
        return [(m.prov_pkg[i], m.prov_id[i], m.recv_pkg[i], m.recv_id[i],
                 qp[i]) for i in range(m.nmovers)]
