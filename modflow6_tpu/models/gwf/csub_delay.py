"""CSUB delay interbeds: vertical consolidation sub-columns.

Behavioral parity target: the delay-interbed half of
src/Model/GroundWaterFlow/gwf-csub.f90 —
- csub_delay_calc_stress:5799-5867 (geostatic load accumulated down the
  column from the host-cell load above the interbed top),
- csub_delay_calc_ssksske:5879-5972 (elastic/inelastic switching on the
  per-node preconsolidation stress, effective-stress factors),
- csub_delay_assemble_fc:6017-6140 (tridiagonal backward-Euler system:
  vertical conduction kv/dz between nodes, 2·kv/dz to the host cell at
  both ends, skeletal storage),
- csub_delay_sln:5649-5730 (iterate assemble→Thomas-solve→re-stress until
  the max head change is below 100·DPREC),
- csub_delay_fc:~4901 (host-cell hcof/rhs from the two end conductances,
  scaled by area·rnb),
- csub_delay_calc_comp (compaction from strain increments per node).

Design: all delay interbeds solve simultaneously — the column state
is a dense [n_interbeds, ndelaycells] array, the Thomas solve is a pair
of lax.scan sweeps over the (static) column length batched across
interbeds, and the nonlinear stress iteration is one lax.while_loop for
the whole batch.  Saturated-column assumption (dsn = 1): delay beds sit
below the water table in the reference test problems; the hbar bottom
clamp is retained.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...constants import DONE, DZERO


@partial(jax.tree_util.register_dataclass,
         data_fields=["node", "kv", "rci", "ci", "theta", "rnb", "dzini",
                      "z", "ielastic"],
         meta_fields=["ncells"])
@dataclasses.dataclass(frozen=True)
class DelayData:
    """Static delay-interbed data (storages already converted like the
    no-delay interbeds)."""

    node: jax.Array      # i32[B] host cell
    kv: jax.Array        # f64[B] vertical K of the interbed
    rci: jax.Array       # f64[B] recompression (elastic) storage
    ci: jax.Array        # f64[B] compression (inelastic) storage
    theta: jax.Array     # f64[B] porosity
    rnb: jax.Array       # f64[B] equivalent-interbed count (material factor)
    dzini: jax.Array     # f64[B] cell size = thick / ncells
    z: jax.Array         # f64[B, ND] node-center elevations, top first
    ielastic: jax.Array  # bool[B]
    ncells: int = 9

    @property
    def nbeds(self) -> int:
        return self.node.shape[0]


@partial(jax.tree_util.register_dataclass,
         data_fields=["h0", "es0", "pcs"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class DelayState:
    h0: jax.Array    # f64[B, ND] heads at start of step
    es0: jax.Array   # f64[B, ND] effective stress at start of step
    pcs: jax.Array   # f64[B, ND] preconsolidation stress per node


def thomas(dl, dd, du, b):
    """Batched Thomas tridiagonal solve (ims_misc_thomas role).

    dl/dd/du/b: f64[B, N] (dl[:,0], du[:,-1] ignored).  Two lax.scan
    sweeps along the static column axis, batched over interbeds.
    """
    def fwd(carry, x):
        cp_prev, dp_prev = carry
        a, bb, c, r = x
        m = bb - a * cp_prev
        cp = c / m
        dp = (r - a * dp_prev) / m
        return (cp, dp), (cp, dp)

    xs = (dl.T, dd.T, du.T, b.T)   # scan over the column axis
    zero = jnp.zeros(dd.shape[0])
    _, (cps, dps) = lax.scan(fwd, (zero, zero), xs)

    def bwd(x_next, cd):
        cp, dp = cd
        x = dp - cp * x_next
        return x, x

    _, xs_rev = lax.scan(bwd, zero, (cps, dps), reverse=True)
    return xs_rev.T


def _hbar(h, bot):
    return jnp.maximum(h, bot)


def _stress(dd: DelayData, h, hcell, gs_cell, top_c, bot_c, sgm, sgs):
    """(geo, es) per delay node (csub_delay_calc_stress).

    gs_cell/top_c/bot_c/sgm/sgs: f64[B] host-cell values; h f64[B, ND];
    hcell f64[B]."""
    dzh = 0.5 * dd.dzini[:, None]
    top_ib = dd.z[:, 0] + dd.dzini * 0.5
    hbc = _hbar(hcell, bot_c)
    sadd_top = jnp.where(hcell < top_ib,
                         (top_ib - hbc) * sgm + (hbc - bot_c) * sgs,
                         (top_ib - bot_c) * sgs)
    sigma0 = gs_cell - sadd_top
    topn = dd.z + dzh
    botn = dd.z - dzh
    hb = _hbar(h, botn)
    sadd = jnp.where(h < topn,
                     (topn - hb) * sgm[:, None] + (hb - botn) * sgs[:, None],
                     (topn - botn) * sgs[:, None])
    geo = sigma0[:, None] + jnp.cumsum(sadd, axis=1)
    es = geo - (hb - botn)
    return geo, es


def _znode(top, bot, hbar):
    z = jnp.where(hbar < top, 0.5 * (hbar + bot), 0.5 * (top + bot))
    return jnp.clip(z, bot, top)


def _ssk(dd: DelayData, es, pcs, sgs, head_based):
    """(ssk, sske) per node (csub_delay_calc_ssksske): effective-stress
    factor f = 1/((1+e)·adjes) with the current stress (ieslag off), the
    inelastic switch on the node preconsolidation stress."""
    if head_based:
        f = jnp.ones_like(es)
    else:
        dzh = 0.5 * dd.dzini[:, None]
        zbot = dd.z - dzh
        # znode at the node's own saturated center (confined columns:
        # znode = z, the reference's dbrelz recentring coincides)
        znode = dd.z
        adjes = es - (znode - zbot) * (sgs[:, None] - DONE)
        void = dd.theta / (DONE - dd.theta)
        denom = adjes * (DONE + void[:, None])
        f = jnp.where(denom != DZERO, DONE / denom, DZERO)
    sske = f * dd.rci[:, None]
    convert = (es > pcs) & ~dd.ielastic[:, None]
    ssk = jnp.where(convert, f * dd.ci[:, None], sske)
    return ssk, sske


def solve_columns(dd: DelayData, st: DelayState, hcell, gs_cell, top_c,
                  bot_c, sgm, sgs, delt, head_based,
                  dclose=1e-10, itmax=100):
    """Solve every delay column to convergence at the given host-cell
    heads (csub_delay_sln for the whole batch).  Returns (h, geo, es)."""
    smult = (dd.dzini / delt)[:, None]
    c = (dd.kv / dd.dzini)[:, None]
    ND = dd.ncells
    dzh = 0.5 * dd.dzini[:, None]
    botn = dd.z - dzh

    def body(carry):
        h, _, it = carry
        geo, es = _stress(dd, h, hcell, gs_cell, top_c, bot_c, sgm, sgs)
        ssk, sske = _ssk(dd, es, st.pcs, sgs, head_based)
        hb = _hbar(h, botn)
        # tridiagonal system (csub_delay_assemble_fc, saturated dsn=1)
        dl = jnp.broadcast_to(c, (dd.nbeds, ND))
        du = dl
        aii = -2.0 * dl - smult * ssk
        aii = aii.at[:, 0].add(-c[:, 0])
        aii = aii.at[:, -1].add(-c[:, 0])
        r_el = -smult * (ssk * (geo + botn) - sske * st.es0)
        r_in = -smult * (ssk * (geo + botn - st.pcs)
                         + sske * (st.pcs - st.es0))
        r = jnp.where(dd.ielastic[:, None], r_el, r_in)
        r = r + smult * ssk * (h - hb)    # hbar storage correction
        r = r.at[:, 0].add(-2.0 * c[:, 0] * hcell)
        r = r.at[:, -1].add(-2.0 * c[:, 0] * hcell)
        h_new = thomas(dl, aii, du, r)
        dh = jnp.max(jnp.abs(h_new - h)) if dd.nbeds else jnp.zeros(())
        return h_new, dh, it + 1

    def cond(carry):
        _, dh, it = carry
        return (dh > dclose) & (it < itmax)

    h0 = st.h0
    h, _, _ = body((h0, jnp.asarray(jnp.inf), 0))
    h, _, _ = lax.while_loop(cond, lambda cr: body(cr),
                             (h, jnp.asarray(jnp.inf), 1))
    geo, es = _stress(dd, h, hcell, gs_cell, top_c, bot_c, sgm, sgs)
    return h, geo, es


def cell_terms(dd: DelayData, h, area):
    """(diag_add_cells, rhs_add_cells) scattered from the end-node
    conductances (csub_delay_fc × area·rnb, csub_interbed_fc sign)."""
    c2 = 2.0 * dd.kv / dd.dzini
    f = area[dd.node] * dd.rnb
    hcof = -(c2 + c2) * f
    rhs = -c2 * (h[:, 0] + h[:, -1]) * f
    return hcof, rhs


def compaction(dd: DelayData, st: DelayState, es, sgs, head_based):
    """Compaction increment per interbed (csub_delay_calc_comp, dsn=1),
    already scaled by rnb."""
    ssk, sske = _ssk(dd, es, st.pcs, sgs, head_based)
    v_el = ssk * (es - st.es0)
    v_in = ssk * (es - st.pcs) + sske * (st.pcs - st.es0)
    v = jnp.where(dd.ielastic[:, None], v_el, v_in) * dd.dzini[:, None]
    return v.sum(axis=1) * dd.rnb


def build_delay(interbeds, grid, strt, ncells=9):
    """``interbeds``: list of dicts (node, thick, kv, sske_cr, ssv_cc,
    theta, rnb=1, head=strt) — the PACKAGEDATA columns for idelay beds.
    Columns are centered in their host cell.  Returns (DelayData fields
    dict, initial heads h0[B, ND])."""
    B = len(interbeds)
    top = np.asarray(grid.top).reshape(-1)
    bot = np.asarray(grid.bot).reshape(-1)
    node = np.asarray([int(b["node"]) for b in interbeds], np.int32)
    thick = np.asarray([b["thick"] for b in interbeds], np.float64)
    dzini = thick / ncells
    z = np.zeros((B, ncells))
    h0 = np.zeros((B, ncells))
    strt = np.broadcast_to(np.asarray(strt, np.float64).reshape(-1),
                           top.shape)
    for i, b in enumerate(interbeds):
        zc = 0.5 * (top[node[i]] + bot[node[i]])   # column center
        ztop = zc + 0.5 * thick[i] - 0.5 * dzini[i]
        z[i] = ztop - np.arange(ncells) * dzini[i]
        h0[i] = float(b.get("head", strt[node[i]]))
    return dict(
        node=node, kv=np.asarray([b["kv"] for b in interbeds]),
        rci=np.asarray([b["sske_cr"] for b in interbeds]),
        ci=np.asarray([b["ssv_cc"] for b in interbeds]),
        theta=np.asarray([b.get("theta", 0.3) for b in interbeds]),
        rnb=np.asarray([b.get("rnb", 1.0) for b in interbeds]),
        dzini=dzini, z=z,
        ielastic=np.asarray([b["sske_cr"] == b["ssv_cc"]
                             for b in interbeds]),
        ncells=ncells), h0
