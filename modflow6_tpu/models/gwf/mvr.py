"""MVR: the water mover — routes simulated flows from provider package
entries to receiver package entries.

Behavioral parity targets in the reference:
- src/Model/ModelUtilities/Mover.f90: the four mover rules (qrcalc):
    FACTOR    qr = min(qta·value, qa)       (factor of TOTAL available,
                                             capped by remaining)
    EXCESS    qr = max(qa − value, 0)
    THRESHOLD qr = value if qa ≥ value else 0
    UPTO      qr = min(qa, value)
  and the sequential provider-consumption semantics of update_provider
  (each mover reduces the provider's remaining available water qformvr,
  so later movers on the same provider entry see less).
- src/Model/GroundWaterFlow/gwf-mvr.f90: provider/receiver bookkeeping,
  budget terms.
- Providers accumulate available water during their fc phase
  (gwf-wel.f90:367 rhs>0, gwf-drn.f90:413 fact·cond·(h−drnbot), the
  SFR downstream outflow, LAK outlet flows, MAW pumped rate); receivers
  get qfrommvr as extra inflow in their continuity equations.

Design: the mover list is static (host metadata); the per-iteration
evaluation unrolls at trace time into a short chain of vectorized
gather/scatter updates on the per-package "available" vectors — the
mover count is tiny (dozens) next to the grid, so the sequential
consumption semantics cost nothing.  All provider availabilities are
recomputed from the current Picard iterate, so the moved water lags one
nonlinear iteration exactly as the reference's mvr_fc does.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import DZERO

PROVIDERS = ("wel", "drn", "riv", "ghb", "sfr", "lak", "maw", "uzf")
RECEIVERS = ("sfr", "lak", "maw", "uzf")
RULES = ("factor", "excess", "threshold", "upto")


@partial(jax.tree_util.register_dataclass,
         data_fields=["value"],
         meta_fields=["prov_pkg", "prov_id", "recv_pkg", "recv_id",
                      "mvrtype"])
@dataclasses.dataclass(frozen=True)
class MvrData:
    """Static mover table.  ``prov_id`` indexes the provider package's
    entry space (WEL/DRN/RIV/GHB: boundary entry; SFR: reach; LAK:
    OUTLET number; MAW: well; UZF: column)."""

    value: jax.Array      # f64[M] the rule value (factor or rate)
    prov_pkg: tuple = ()  # str[M]
    prov_id: tuple = ()   # int[M]
    recv_pkg: tuple = ()  # str[M]
    recv_id: tuple = ()   # int[M]
    mvrtype: tuple = ()   # str[M] in RULES

    @property
    def nmovers(self) -> int:
        return len(self.prov_pkg)


def build_mvr(movers) -> MvrData:
    """``movers``: list of dicts with keys provider ("wel"...), iprov,
    receiver ("sfr"...), ircv, mvrtype ("factor"|"excess"|"threshold"|
    "upto"), value."""
    for m in movers:
        if m["provider"] not in PROVIDERS:
            raise ValueError(f"unknown mover provider {m['provider']!r}")
        if m["receiver"] not in RECEIVERS:
            raise ValueError(f"unknown mover receiver {m['receiver']!r}")
        if m["mvrtype"] not in RULES:
            raise ValueError(f"unknown mover type {m['mvrtype']!r}")
    return MvrData(
        value=jnp.asarray([float(m["value"]) for m in movers]),
        prov_pkg=tuple(m["provider"] for m in movers),
        prov_id=tuple(int(m["iprov"]) for m in movers),
        recv_pkg=tuple(m["receiver"] for m in movers),
        recv_id=tuple(int(m["ircv"]) for m in movers),
        mvrtype=tuple(m["mvrtype"] for m in movers))


def run_movers(mvr: MvrData, avail: dict, recv_sizes: dict):
    """Evaluate the mover chain.

    ``avail``: per provider package name, f64[n_entries] of available
    (positive) water this iteration.  ``recv_sizes``: receiver package
    name -> number of receivable entries.

    Returns (qp[M] per-mover moved rate,
             qto: provider pkg -> f64[n] water taken per entry,
             qfrom: receiver pkg -> f64[n] water delivered per entry).
    """
    qa = dict(avail)                       # remaining (consumed in order)
    qta = {k: v for k, v in avail.items()}  # total at start (FACTOR base)
    qto = {k: jnp.zeros_like(v) for k, v in avail.items()}
    qfrom = {k: jnp.zeros(n) for k, n in recv_sizes.items()}
    qps = []
    for i in range(mvr.nmovers):
        pk, pi = mvr.prov_pkg[i], mvr.prov_id[i]
        rk, ri = mvr.recv_pkg[i], mvr.recv_id[i]
        a = qa[pk][pi]
        ta = qta[pk][pi]
        v = mvr.value[i]
        typ = mvr.mvrtype[i]
        if typ == "factor":
            qr = jnp.minimum(jnp.where(ta > DZERO, ta * v, DZERO), a)
        elif typ == "excess":
            qr = jnp.maximum(a - v, DZERO)
        elif typ == "threshold":
            qr = jnp.where(v > a, DZERO, v)
        else:  # upto
            qr = jnp.minimum(a, v)
        qr = jnp.maximum(qr, DZERO)
        qa[pk] = qa[pk].at[pi].add(-qr)
        qto[pk] = qto[pk].at[pi].add(qr)
        if rk in qfrom:
            qfrom[rk] = qfrom[rk].at[ri].add(qr)
        qps.append(qr)
    qp = jnp.stack(qps) if qps else jnp.zeros(0)
    return qp, qto, qfrom


def base_package_available(base, pkgs, head, ibound):
    """Available (positive, leaving-the-aquifer) water per entry for the
    standard stress providers WEL/DRN/RIV/GHB, from the current iterate.

    Matches the accumulate_qformvr calls in gwf-wel.f90:367 (rhs>0),
    gwf-drn.f90:404-414 (discharging drains), gwf-riv/gwf-ghb analogs:
    q = hcof·h − rhs is positive INTO the aquifer, so available = max(−q,0).
    """
    from . import bnd

    arrays = base.npf_arrays
    out = {}
    if getattr(pkgs, "wel", None) is not None:
        w = pkgs.wel
        hcof, r = bnd.wel_terms(w, head, ibound, arrays.icelltype,
                                arrays.top, arrays.bot,
                                base.wel_iflowred, base.wel_flowred)
        q = bnd.bound_flows(w.node, w.mask, hcof, r, head, ibound)
        out["wel"] = jnp.maximum(-q, DZERO)
    if getattr(pkgs, "drn", None) is not None:
        d = pkgs.drn
        hcof, r = bnd.drn_terms(d, head, ibound)
        q = bnd.bound_flows(d.node, d.mask, hcof, r, head, ibound)
        out["drn"] = jnp.maximum(-q, DZERO)
    if getattr(pkgs, "riv", None) is not None:
        rv = pkgs.riv
        hcof, r = bnd.riv_terms(rv, head, ibound)
        q = bnd.bound_flows(rv.node, rv.mask, hcof, r, head, ibound)
        out["riv"] = jnp.maximum(-q, DZERO)
    if getattr(pkgs, "ghb", None) is not None:
        gh = pkgs.ghb
        hcof, r = bnd.ghb_terms(gh, ibound)
        q = bnd.bound_flows(gh.node, gh.mask, hcof, r, head, ibound)
        out["ghb"] = jnp.maximum(-q, DZERO)
    return out
