"""CSUB: skeletal compaction and subsidence.

Behavioral parity target: src/Model/GroundWaterFlow/gwf-csub.f90 (7,471
LoC — the reference's largest package).  Implemented scope:

- geostatic stress accumulated down columns from moist/saturated unit
  weights (csub_cg_calc_stress:3918-4041) and effective stress
  es = gs − (h̄ − bot);
- coarse-grained elastic skeletal storage (csub_cg_fc:4694-4748 with
  csub_cg_calc_sske:5008-5055, f = 1/((1+e)·adjes),
  adjes = es − (z − bot)(sgs − 1), csub_calc_adjes:5446-5458);
- no-delay interbeds with elastic/inelastic switching on the
  preconsolidation stress (csub_nodelay_fc:4156-4252): rho1 = Sske-based,
  rho2 = Ssk-based (inelastic when es > pcs), with the exact rhs forms
  for elastic and inelastic interbeds;
- the HEAD_BASED option (f ≡ 1) and the specific-storage input mode
  (istoragec=1) including the initial-stress conversion of the
  user storages in the effective-stress case (gwf-csub.f90:4420-4485);
- preconsolidation-stress and compaction state tracking per step.

Delay interbeds (idelay>0) are implemented in csub_delay.py: batched
vertical consolidation columns solved by a vmapped Thomas tridiagonal
sweep inside a lax.while_loop stress iteration (csub_delay_sln role).
Not implemented (loud guard): material-property updating
(UPDATE_MATERIAL_PROPERTIES) and water-compressibility terms.

Design: stresses are dense per-cell vectors (the down-column
geostatic accumulation is a cumsum over the layer axis); interbeds are
vectorized lists scattered onto their cells' rows; all state
(es0/pcs/compaction) rides a pytree through jit.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ...constants import DONE, DZERO

DLOG10ES = 0.4342942


@partial(jax.tree_util.register_dataclass,
         data_fields=["sgm", "sgs", "cg_ske_cr", "cg_theta", "cg_thickini",
                      "ib_node", "ib_thick", "ib_rci", "ib_ci", "ib_theta",
                      "ib_ielastic", "sig0", "delay", "up"],
         meta_fields=["head_based", "nlay", "ncpl"])
@dataclasses.dataclass(frozen=True)
class CsubData:
    """Static package data (after initial-stress storage conversion)."""

    sgm: jax.Array         # moist specific gravity per cell
    sgs: jax.Array         # saturated specific gravity per cell
    cg_ske_cr: jax.Array   # coarse elastic storage (converted)
    cg_theta: jax.Array    # coarse porosity
    cg_thickini: jax.Array  # coarse-grained thickness per cell
    ib_node: jax.Array     # i32[NB] interbed host cell
    ib_thick: jax.Array    # interbed thickness
    ib_rci: jax.Array      # recompression (elastic) index (converted)
    ib_ci: jax.Array       # compression (inelastic) index (converted)
    ib_theta: jax.Array
    ib_ielastic: jax.Array  # bool[NB] elastic-only interbed
    sig0: jax.Array        # user overburden addition per cell
    delay: object = None   # csub_delay.DelayData (idelay>0 interbeds)
    # optional explicit "cell above" index chain (i32[N], -1 = top):
    # replaces the layer-major reshape+cumsum so sharded local node
    # orderings can accumulate geostatic stress (calc_stress)
    up: object = None
    head_based: bool = False
    nlay: int = 1
    ncpl: int = 1


@partial(jax.tree_util.register_dataclass,
         data_fields=["es0", "pcs", "comp", "cg_comp", "db", "db_comp"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class CsubState:
    es0: jax.Array        # effective stress at start of step, per cell
    pcs: jax.Array        # preconsolidation stress per interbed
    comp: jax.Array       # cumulative interbed compaction
    cg_comp: jax.Array    # cumulative coarse compaction
    db: object = None     # csub_delay.DelayState (delay columns)
    db_comp: object = None  # f64[B] cumulative delay-bed compaction


def _hbar(h, bot, omega=1e-6):
    """Corrected head clamped smoothly at the cell bottom (sQuadratic0sp)."""
    return jnp.maximum(h, bot)


def _znode(top, bot, hbar):
    """Node elevation for stress adjustment (csub_calc_znode)."""
    z = jnp.where(hbar < top, 0.5 * (hbar + bot), 0.5 * (top + bot))
    return jnp.clip(z, bot, top)


def calc_stress(csub: CsubData, top, bot, head, ibound):
    """(gs, es) per cell (csub_cg_calc_stress)."""
    thick = top - bot
    h = jnp.where(ibound != 0, head, bot)
    hb = _hbar(h, bot)
    gs_cell = jnp.where(
        h < top,
        (top - hb) * csub.sgm + (hb - bot) * csub.sgs,
        thick * csub.sgs) + csub.sig0
    if csub.up is None:
        # overlying-cell accumulation: cumsum down the layer axis
        # (DIS/DISV layer-major ordering)
        g3 = gs_cell.reshape(csub.nlay, csub.ncpl)
        gs = jnp.cumsum(g3, axis=0).reshape(-1)
    else:
        # explicit up-chain gather: works for arbitrary node orderings
        # (sharded local blocks); nlay-1 sweeps converge the ancestor sum
        up = csub.up
        upc = jnp.maximum(up, 0)

        def body(_, g):
            return gs_cell + jnp.where(up >= 0, g[upc], DZERO)

        gs = jax.lax.fori_loop(0, max(csub.nlay - 1, 1), body, gs_cell) \
            if csub.nlay > 1 else gs_cell
    es = gs - (hb - bot)
    return gs, es


def _sfact(csub, theta, es_adj):
    """f = 1/((1+e)·adjes) (csub_calc_sfacts); 1 for head-based."""
    if csub.head_based:
        return jnp.ones_like(es_adj)
    void = theta / (DONE - theta)
    denom = es_adj * (DONE + void)
    return jnp.where(denom != 0.0, DONE / denom, DZERO)


def _sat(icelltype, top, bot, h):
    conv = icelltype != 0
    s = jnp.clip((h - bot) / jnp.where(top > bot, top - bot, DONE),
                 0.0, 1.0)
    return jnp.where(conv, s, 1.0)


def assemble_csub(csub: CsubData, state: CsubState, top, bot, area,
                  icelltype, head, head_old, ibound, delt):
    """(diag_add, rhs_add) from coarse + no-delay interbed storage."""
    tled = DONE / delt
    hb = _hbar(head, bot)
    gs, es = calc_stress(csub, top, bot, head, ibound)
    act = ibound > 0
    snnew = _sat(icelltype, top, bot, head)
    snold = _sat(icelltype, top, bot, head_old)

    # ---- coarse-grained elastic storage (csub_cg_fc)
    zn = _znode(top, bot, hb)
    es_adj = es - (zn - bot) * (csub.sgs - DONE)
    sske = _sfact(csub, csub.cg_theta, es_adj) * csub.cg_ske_cr
    rho1 = sske * area * csub.cg_thickini * tled
    hcof = -rho1 * snnew
    rhs = (rho1 * snold * state.es0
           - rho1 * snnew * (gs + bot)
           - rho1 * snnew * (head - hb))
    diag_add = jnp.where(act, hcof, DZERO)
    rhs_add = jnp.where(act, rhs, DZERO)

    # ---- no-delay interbeds (csub_nodelay_fc), scattered to host cells
    if csub.ib_node.shape[0] > 0:
        nb = csub.ib_node
        hbn = hb[nb]
        zn_i = _znode(top[nb], bot[nb], hbn)
        es_adj_i = es[nb] - (zn_i - bot[nb]) * (csub.sgs[nb] - DONE)
        f = _sfact(csub, csub.ib_theta, es_adj_i)
        sto_fac = tled * snnew[nb] * csub.ib_thick * f
        sto_fac0 = tled * snold[nb] * csub.ib_thick * f
        r1 = csub.ib_rci * sto_fac0
        r2e = csub.ib_rci * sto_fac
        inelastic = (es[nb] > state.pcs) & ~csub.ib_ielastic
        r2 = jnp.where(inelastic, csub.ib_ci * sto_fac, r2e)
        rcorr = r2 * (head[nb] - hbn)
        rhs_el = r1 * state.es0[nb] - r2 * (gs[nb] + bot[nb]) - rcorr
        rhs_in = (-r2 * (gs[nb] + bot[nb]) + state.pcs * (r2 - r1)
                  + r1 * state.es0[nb] - rcorr)
        rhs_ib = jnp.where(csub.ib_ielastic, rhs_el, rhs_in)
        a = area[nb]
        actn = ibound[nb] > 0
        diag_add = diag_add.at[nb].add(jnp.where(actn, -r2 * a, DZERO))
        rhs_add = rhs_add.at[nb].add(jnp.where(actn, rhs_ib * a, DZERO))

    # ---- delay interbeds: solve the consolidation columns at the current
    # iterate, couple the two end conductances into the cell row
    # (csub_delay_sln + csub_interbed_fc delay branch)
    if csub.delay is not None and state.db is not None:
        from . import csub_delay as cd
        dd = csub.delay
        dn = dd.node
        h_db, _, _ = cd.solve_columns(
            dd, state.db, head[dn], gs[dn], top[dn], bot[dn],
            csub.sgm[dn], csub.sgs[dn], delt, csub.head_based)
        hcof_d, rhs_d = cd.cell_terms(dd, h_db, area)
        actd = ibound[dn] > 0
        diag_add = diag_add.at[dn].add(jnp.where(actd, hcof_d, DZERO))
        rhs_add = rhs_add.at[dn].add(jnp.where(actd, rhs_d, DZERO))
    return diag_add, rhs_add


def advance_state(csub: CsubData, state: CsubState, top, bot, area,
                  icelltype, head, head_old, ibound, delt) -> CsubState:
    """End-of-step updates: es0 ← es, pcs ← max(pcs, es), compaction
    accumulated from the storage release (csub_cg_update / csub_nodelay
    update role: compaction volume = water squeezed out)."""
    diag_c, rhs_c = assemble_csub(csub, state, top, bot, area, icelltype,
                                  head, head_old, ibound, delt)
    # per-cell storage release rate (positive = water released into the
    # model = compaction), boundary-flow convention q = hcof·h − rhs
    q_cell = diag_c * head - rhs_c
    gs, es = calc_stress(csub, top, bot, head, ibound)
    # split coarse vs interbed: recompute the interbed-only part
    zero_ib = dataclasses.replace(
        csub, ib_node=jnp.zeros(0, jnp.int32), ib_thick=jnp.zeros(0),
        ib_rci=jnp.zeros(0), ib_ci=jnp.zeros(0), ib_theta=jnp.zeros(0),
        ib_ielastic=jnp.zeros(0, bool), delay=None)
    diag_cg, rhs_cg = assemble_csub(zero_ib, state, top, bot, area,
                                    icelltype, head, head_old, ibound,
                                    delt)
    q_cg = diag_cg * head - rhs_cg

    # delay interbeds: advance column state and accumulate compaction
    db_new, db_comp = state.db, state.db_comp
    q_delay = jnp.zeros_like(q_cell)
    if csub.delay is not None and state.db is not None:
        from . import csub_delay as cd
        dd = csub.delay
        dn = dd.node
        h_db, geo_db, es_db = cd.solve_columns(
            dd, state.db, head[dn], gs[dn], top[dn], bot[dn],
            csub.sgm[dn], csub.sgs[dn], delt, csub.head_based)
        hcof_d, rhs_d = cd.cell_terms(dd, h_db, area)
        q_delay = q_delay.at[dn].add(hcof_d * head[dn] - rhs_d)
        db_comp = db_comp + cd.compaction(dd, state.db, es_db,
                                          csub.sgs[dn], csub.head_based)
        db_new = cd.DelayState(h0=h_db, es0=es_db,
                               pcs=jnp.maximum(state.db.pcs, es_db))

    dcomp_cell = (q_cell - q_cg - q_delay) * delt / area  # no-delay beds
    dcg = q_cg * delt / area
    # distribute cell interbed compaction to interbeds by their share of
    # the release — with one interbed per cell (the common case) this is
    # exact; multiple interbeds per cell share proportionally to r2·thick
    comp = state.comp + dcomp_cell[csub.ib_node] * _share(csub, state, es)
    return CsubState(es0=es, pcs=jnp.maximum(state.pcs, es[csub.ib_node]),
                     comp=comp, cg_comp=state.cg_comp + dcg,
                     db=db_new, db_comp=db_comp)


def _share(csub, state, es):
    if csub.ib_node.shape[0] == 0:
        return jnp.zeros(0)
    w = csub.ib_thick * jnp.where(
        (es[csub.ib_node] > state.pcs) & ~csub.ib_ielastic,
        csub.ib_ci, csub.ib_rci)
    tot = jnp.zeros(es.shape[0]).at[csub.ib_node].add(w)
    return w / jnp.where(tot[csub.ib_node] > 0, tot[csub.ib_node], DONE)


def make_csub(grid, *, sgm=1.7, sgs=2.0, cg_ske_cr=1e-5, cg_theta=0.2,
              cg_thick_frac=1.0, interbeds=(), sig0=0.0, head_based=False,
              strt=None, icelltype=None, istoragec=True,
              pcs_offset=0.0, delay_interbeds=(), ndelaycells=9):
    """Build CsubData + initial CsubState.

    interbeds: (node, thick, sske_or_cr, ssv_or_cc, theta[, pcs_abs]);
    with istoragec the storages are converted at initial stress in the
    effective-stress case (gwf-csub.f90:4420-4485); without it the values
    are compression indices scaled by 0.4342942 (dlog10es).
    ``pcs_offset``: initial preconsolidation stress offset above the
    initial effective stress (relative spec, ispecified_pcs=0).
    ``delay_interbeds``: list of dicts (node, thick, kv, sske_cr, ssv_cc,
    theta, rnb) — idelay>0 beds solved as vertical consolidation columns
    of ``ndelaycells`` nodes (csub_delay.py).
    """
    N = grid.nodes
    shp = grid.shape
    nlay = shp[0] if len(shp) > 1 else 1
    ncpl = N // nlay
    full = lambda v: jnp.broadcast_to(                      # noqa: E731
        jnp.asarray(v, jnp.float64), (N,))
    top = jnp.asarray(np.asarray(grid.top).reshape(-1))
    bot = jnp.asarray(np.asarray(grid.bot).reshape(-1))

    ib = np.asarray(interbeds, np.float64).reshape(-1, max(
        len(interbeds[0]) if len(interbeds) else 5, 5))
    nb = ib.shape[0]
    csub = CsubData(
        sgm=full(sgm), sgs=full(sgs), cg_ske_cr=full(cg_ske_cr),
        cg_theta=full(cg_theta),
        cg_thickini=(top - bot) * full(cg_thick_frac),
        ib_node=jnp.asarray(ib[:, 0].astype(np.int32)) if nb
        else jnp.zeros(0, jnp.int32),
        ib_thick=jnp.asarray(ib[:, 1]) if nb else jnp.zeros(0),
        ib_rci=jnp.asarray(ib[:, 2]) if nb else jnp.zeros(0),
        ib_ci=jnp.asarray(ib[:, 3]) if nb else jnp.zeros(0),
        ib_theta=jnp.asarray(ib[:, 4]) if nb else jnp.zeros(0),
        ib_ielastic=(jnp.asarray(ib[:, 2] == ib[:, 3]) if nb
                     else jnp.zeros(0, bool)),
        sig0=full(sig0), head_based=bool(head_based),
        nlay=int(nlay), ncpl=int(ncpl))

    # initial stresses at strt
    h0 = (jnp.asarray(np.asarray(strt, np.float64).reshape(-1))
          if strt is not None else top)
    ibound = jnp.ones(N, jnp.int32)
    gs0, es0 = calc_stress(csub, top, bot, h0, ibound)

    # storage conversion (specific-storage input, effective-stress mode)
    if not head_based:
        if istoragec:
            hb0 = _hbar(h0, bot)
            zn = _znode(top, bot, hb0)
            adj = es0 - (zn - bot) * (csub.sgs - DONE)
            void = csub.cg_theta / (DONE - csub.cg_theta)
            csub = dataclasses.replace(
                csub, cg_ske_cr=csub.cg_ske_cr * adj * (DONE + void))
            if nb:
                adj_i = adj[csub.ib_node]
                void_i = csub.ib_theta / (DONE - csub.ib_theta)
                fact = adj_i * (DONE + void_i)
                csub = dataclasses.replace(
                    csub, ib_rci=csub.ib_rci * fact,
                    ib_ci=csub.ib_ci * fact)
        else:
            csub = dataclasses.replace(
                csub, cg_ske_cr=csub.cg_ske_cr * DLOG10ES,
                ib_rci=csub.ib_rci * DLOG10ES,
                ib_ci=csub.ib_ci * DLOG10ES)

    pcs = es0[csub.ib_node] + pcs_offset if nb else jnp.zeros(0)

    db_state = None
    db_comp = None
    if delay_interbeds:
        from . import csub_delay as cd
        dfields, h0_db = cd.build_delay(delay_interbeds, grid,
                                        np.asarray(h0), ncells=ndelaycells)
        dd = cd.DelayData(**{
            k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in dfields.items()})
        # storage conversion at initial stress, as for no-delay interbeds
        if not head_based:
            if istoragec:
                hb0 = _hbar(h0, bot)
                zn = _znode(top, bot, hb0)
                adj = (es0 - (zn - bot) * (csub.sgs - DONE))[dd.node]
                void_d = dd.theta / (DONE - dd.theta)
                fact = adj * (DONE + void_d)
                dd = dataclasses.replace(dd, rci=dd.rci * fact,
                                         ci=dd.ci * fact)
            else:
                dd = dataclasses.replace(dd, rci=dd.rci * DLOG10ES,
                                         ci=dd.ci * DLOG10ES)
        csub = dataclasses.replace(csub, delay=dd)
        # initial column stresses at the initial heads
        dn = dd.node
        gs0_d, es0_d = cd._stress(dd, jnp.asarray(h0_db), h0[dn],
                                  gs0[dn], top[dn], bot[dn],
                                  csub.sgm[dn], csub.sgs[dn])
        db_state = cd.DelayState(h0=jnp.asarray(h0_db), es0=es0_d,
                                 pcs=es0_d + pcs_offset)
        db_comp = jnp.zeros(dd.nbeds)

    state = CsubState(es0=es0, pcs=pcs,
                      comp=jnp.zeros(nb), cg_comp=jnp.zeros(N),
                      db=db_state, db_comp=db_comp)
    return csub, state


# jitted entry for the per-step state advance: the delay-column
# while_loop is far too slow dispatched eagerly (simulation.py and tests
# call this once per time step)
advance_state_jit = jax.jit(advance_state)
