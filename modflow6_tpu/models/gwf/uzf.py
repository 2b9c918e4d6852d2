"""UZF: unsaturated-zone flow columns (kinematic wave) with water-table
coupling, unsaturated/groundwater ET, and groundwater seepage discharge.

Behavioral parity target: src/Model/GroundWaterFlow/gwf-uzf.f90 (3,063
LoC) + src/Model/ModelUtilities/UzfCellGroup.f90 + UzfEtUtil.f90:
vertical unsaturated columns under the land surface accept infiltration,
percolate it downward by the kinematic-wave approximation of Richards'
equation with a Brooks-Corey relative permeability,

    ∂θ/∂t + ∂q(θ)/∂z = 0,     q(θ) = vks·((θ−θr)/(θs−θr))^eps,

and deliver recharge to the *water table* (not the column bottom):

- the unsaturated zone spans [watab, celtop] with watab = clip(hgwf,
  celbot, celtop) (UzfCellGroup sethead);
- infiltration is smoothly rejected as the head approaches land surface
  (rejfinf: scale = sLinear(celtop − hgwf, surfdep)) and limited by vks;
- a rising water table releases the water stored in the newly saturated
  zone as extra recharge (uz_rise);
- unsaturated ET removes PET from the profile above the extinction
  depth, bounded below by extwc (routewaves ietflag branch);
- residual PET is taken from groundwater by a linear decay between land
  surface and extinction depth (simgwet/etfunc_lin, igwetflag=1);
- when the head rises above land surface, groundwater discharges to the
  surface through a vks-scaled drain (gwseep, iseepflag).

Redesign (NOT a port): the reference solves the PDE by exact
method-of-characteristics wave tracking — per-cell dynamic lists of
trailing/lead waves, deeply sequential and shape-dynamic.  Here the same
PDE is solved with a conservative first-order upwind finite-volume
discretization over ``nz`` static sub-cells per column spanning
[celbot, celtop], vectorized over all columns and advanced by
CFL-limited sub-steps inside ``lax.scan``.  Sub-cells below the water
table are pinned at θs; the recharge flux is gathered at the water-table
interface with ``take_along_axis`` (static shapes, no per-column wave
lists).  Kinematic waves travel strictly downward, so upwinding is exact
and the scheme converges to the wave solutions the reference tracks
analytically (tests pin the analytic front-arrival time).

Coupling: ``advance`` marches the water content explicitly from the
step-start head; the *head-dependent* matrix terms (recharge delivery
scaling, surface rejection, groundwater ET, seepage) are re-evaluated at
the current head iterate inside ``GwfModel.assemble`` via
``uzf_matrix_terms`` — the role of the reference's per-iteration
uzf_fc → uzf_solve sweep.  The Simulation driver adds a package
convergence re-solve (gwf-uzf.f90 uzf_cc role): if the recharge computed
from the converged head differs from what the solve used, the step is
re-solved with the updated column state.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ...constants import DZERO
from ...ops.smoothing import s_cubic_linear, sq_saturation


@partial(jax.tree_util.register_dataclass,
         data_fields=["node", "thtr", "thts", "thti", "eps", "vks",
                      "celtop", "celbot", "surfdep", "area", "finf",
                      "pet", "extdp", "extwc"],
         meta_fields=["nz", "ietflag", "iseepflag", "igwetflag"])
@dataclasses.dataclass(frozen=True)
class UzfColumns:
    """Static column parameters (uzf packagedata + period data)."""

    node: jax.Array     # i32[C] GWF cell hosting the column
    thtr: jax.Array     # residual water content
    thts: jax.Array     # saturated water content
    thti: jax.Array     # initial water content
    eps: jax.Array      # Brooks-Corey exponent
    vks: jax.Array      # vertical saturated K
    celtop: jax.Array   # land-surface elevation (dis top − surfdep)
    celbot: jax.Array   # cell bottom elevation
    surfdep: jax.Array  # surface-depression depth (smoothing range)
    area: jax.Array     # column plan-view area
    finf: jax.Array     # applied infiltration rate (period data)
    pet: jax.Array      # potential ET rate (period data)
    extdp: jax.Array    # ET extinction depth below land surface
    extwc: jax.Array    # ET extinction water content
    nz: int = 20
    ietflag: int = 0    # SIMULATE_ET
    iseepflag: int = 0  # SIMULATE_GWSEEP
    igwetflag: int = 0  # LINEAR_GWET (1) — residual PET from groundwater


def make_uzf(entries, nz=20, ietflag=0, iseepflag=0, igwetflag=0):
    """Build UzfColumns.

    ``entries`` may be dicts with keys (node, vks, thtr, thts, thti, eps,
    area, celtop, celbot, surfdep, finf, pet, extdp, extwc) — missing
    optionals default to 0 — or legacy 9-tuples
    (node, vks, thtr, thts, thti, eps, depth, area, finf) which place the
    column at [0, depth] decoupled from heads.
    """
    rows = []
    for e in entries:
        if isinstance(e, dict):
            rows.append((e["node"], e["vks"], e["thtr"], e["thts"],
                         e["thti"], e["eps"], e.get("celtop", 1.0),
                         e.get("celbot", 0.0),
                         e.get("surfdep", 1e-5), e.get("area", 1.0),
                         e.get("finf", 0.0), e.get("pet", 0.0),
                         e.get("extdp", 0.0), e.get("extwc", 0.0)))
        else:
            node, vks, thtr, thts, thti, eps, depth, area, finf = e
            rows.append((node, vks, thtr, thts, thti, eps, depth, 0.0,
                         1e-5, area, finf, 0.0, 0.0, 0.0))
    a = np.asarray(rows, np.float64)
    return UzfColumns(
        node=jnp.asarray(a[:, 0].astype(np.int32)),
        vks=jnp.asarray(a[:, 1]), thtr=jnp.asarray(a[:, 2]),
        thts=jnp.asarray(a[:, 3]), thti=jnp.asarray(a[:, 4]),
        eps=jnp.asarray(a[:, 5]), celtop=jnp.asarray(a[:, 6]),
        celbot=jnp.asarray(a[:, 7]), surfdep=jnp.asarray(a[:, 8]),
        area=jnp.asarray(a[:, 9]), finf=jnp.asarray(a[:, 10]),
        pet=jnp.asarray(a[:, 11]), extdp=jnp.asarray(a[:, 12]),
        extwc=jnp.asarray(a[:, 13]), nz=int(nz), ietflag=int(ietflag),
        iseepflag=int(iseepflag), igwetflag=int(igwetflag))


def initial_theta(uzf: UzfColumns) -> jax.Array:
    return jnp.broadcast_to(uzf.thti[:, None],
                            (uzf.thti.shape[0], uzf.nz))


def watab_of(uzf: UzfColumns, head) -> jax.Array:
    """Water-table elevation per column (UzfCellGroup sethead)."""
    return jnp.clip(head[uzf.node], uzf.celbot, uzf.celtop)


@partial(jax.tree_util.register_dataclass,
         data_fields=["theta", "watab", "rch", "rej", "uzet", "gwpet",
                      "finf_top", "sat_col", "wc"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class UzfResult:
    """Outcome of one explicit column march.

    rch/rej/uzet are time-averaged rates per unit area; ``gwpet`` is the
    residual PET available for groundwater ET (setgwpet role);
    ``finf_top`` the vks/capacity-limited applied infiltration (for the
    head-dependent surface terms); ``sat_col`` marks columns whose
    unsaturated zone has vanished; ``wc`` the mean unsaturated water
    content (observation support).
    """

    theta: jax.Array
    watab: jax.Array
    rch: jax.Array
    rej: jax.Array
    uzet: jax.Array
    gwpet: jax.Array
    finf_top: jax.Array
    sat_col: jax.Array
    wc: jax.Array


def _flux(uzf, theta):
    """q(θ) per sub-cell (UzfCellGroup rate function)."""
    srel = jnp.clip((theta - uzf.thtr[:, None])
                    / (uzf.thts - uzf.thtr)[:, None], 0.0, 1.0)
    return uzf.vks[:, None] * srel ** uzf.eps[:, None]


def advance(uzf: UzfColumns, theta, delt, head=None, watab_old=None,
            nsub=None):
    """March the columns through one GWF time step → UzfResult.

    ``head``: GWF heads (step-start iterate) fixing the water table for
    the march; None decouples the column (watab = celbot).
    ``watab_old``: previous step's water table for the uz_rise release.
    """
    C, nz = theta.shape
    depth = uzf.celtop - uzf.celbot
    dz = depth / nz
    if head is not None:
        watab = watab_of(uzf, head)
    else:
        watab = uzf.celbot
        watab = jnp.broadcast_to(watab, (C,))
    # sub-cell bottom elevations; cell k is saturated when its center
    # sits below the water table
    kk = jnp.arange(nz)
    zc = uzf.celtop[:, None] - (kk[None, :] + 0.5) * dz[:, None]
    sat = zc < watab[:, None]
    sat_col = sat[:, 0]          # the whole column is below the WT
    n_unsat = jnp.sum(~sat, axis=1)

    # uz_rise: water stored in the newly flooded zone becomes recharge
    rise = jnp.zeros(C)
    if watab_old is not None:
        newly = sat & (zc >= jnp.minimum(watab_old, watab)[:, None])
        rise = jnp.sum(jnp.where(newly, theta - uzf.thtr[:, None], 0.0),
                       axis=1) * dz
    # flooded cells carry θs while submerged; cells re-exposed by a
    # falling WT start saturated and drain kinematically
    theta = jnp.where(sat, uzf.thts[:, None], theta)

    # surface rejection scale at the fixed step head (rejfinf sLinear)
    if head is not None:
        rej_scale = jnp.clip((uzf.celtop - head[uzf.node])
                             / jnp.maximum(uzf.surfdep, 1e-30), 0.0, 1.0)
    else:
        rej_scale = jnp.ones(C)

    # CFL: max wave speed dq/dθ = vks·eps/(θs−θr) at saturation
    vmax = uzf.vks * uzf.eps / (uzf.thts - uzf.thtr)
    if nsub is None:
        nsub = int(np.ceil(float(jnp.max(vmax * delt / dz)) * 1.05)) + 1
    dt = delt / nsub

    # ET weights: fraction of each sub-cell inside the extinction zone
    if uzf.ietflag:
        z_ext = uzf.celtop - uzf.extdp
        overlap = (jnp.minimum(uzf.celtop[:, None] - kk[None, :] * dz[:, None],
                               uzf.celtop[:, None])
                   - jnp.maximum(uzf.celtop[:, None]
                                 - (kk[None, :] + 1) * dz[:, None],
                                 z_ext[:, None]))
        et_w = jnp.clip(overlap, 0.0, None) \
            / jnp.maximum(uzf.extdp, 1e-30)[:, None]
    else:
        et_w = jnp.zeros((C, nz))

    def substep(carry, _):
        th, rch_acc, rej_acc, et_acc = carry
        q = _flux(uzf, th)
        # surface inflow: rejection scale, vks limit, then capacity
        fin_want = uzf.finf * rej_scale
        fin_top = jnp.minimum(fin_want, uzf.vks)
        cap = (uzf.thts - th[:, 0]) * dz / dt + q[:, 0]
        fin_top = jnp.minimum(fin_top, cap)
        fin_top = jnp.where(sat_col, DZERO, fin_top)
        rej = uzf.finf - fin_top
        # interface fluxes: strictly-downward kinematic wave → upwind
        # from above; f_in[:, k] = flux INTO sub-cell k
        f_in = jnp.concatenate([fin_top[:, None], q[:, :-1]], axis=1)
        f_out = q
        # recharge leaves at the water-table interface: the outflow of
        # the last unsaturated cell (or fin_top for a flooded column)
        kw = jnp.clip(n_unsat - 1, 0, nz - 1)
        q_wt = jnp.take_along_axis(q, kw[:, None], axis=1)[:, 0]
        q_wt = jnp.where(sat_col, DZERO, q_wt)
        # unsaturated ET limited by extwc (routewaves ietflag)
        if uzf.ietflag:
            demand = uzf.pet[:, None] * et_w
            avail = jnp.clip(th - jnp.maximum(uzf.extwc, uzf.thtr)[:, None],
                             0.0, None) * dz[:, None] / dt
            et = jnp.minimum(demand, avail) * (~sat)
        else:
            et = jnp.zeros_like(th)
        th_new = th + dt / dz[:, None] * (f_in - f_out) - dt / dz[:, None] * et
        th_new = jnp.clip(th_new, uzf.thtr[:, None], uzf.thts[:, None])
        th_new = jnp.where(sat, uzf.thts[:, None], th_new)
        return (th_new, rch_acc + q_wt * dt, rej_acc + rej * dt,
                et_acc + jnp.sum(et, axis=1) * dt), None

    (theta, rch, rej, uzet), _ = lax.scan(
        substep, (theta, jnp.zeros(C), jnp.zeros(C), jnp.zeros(C)),
        None, length=nsub)
    rch = rch / delt + rise / delt
    rej_rate = rej / delt
    uzet_rate = uzet / delt
    # residual PET for groundwater ET (setgwpet: gwpet = pet − uzet)
    gwpet = jnp.clip(uzf.pet - uzet_rate, 0.0, None)
    # vks/capacity-limited surface flux for the head-dependent terms
    finf_top = jnp.minimum(uzf.finf, uzf.vks)
    wc = jnp.sum(jnp.where(~sat, theta, 0.0), axis=1) \
        / jnp.maximum(n_unsat, 1)
    return UzfResult(theta=theta, watab=watab, rch=rch, rej=rej_rate,
                     uzet=uzet_rate, gwpet=gwpet, finf_top=finf_top,
                     sat_col=sat_col, wc=wc)


@partial(jax.tree_util.register_dataclass,
         data_fields=["node", "area", "vks", "celtop", "surfdep", "rch",
                      "gwpet", "extdp", "finf_top", "sat_col"],
         meta_fields=["iseepflag", "igwetflag"])
@dataclasses.dataclass(frozen=True)
class UzfStep:
    """Per-step coupling data carried in PackageData (built from a
    UzfResult); everything the head-dependent matrix terms need."""

    node: jax.Array
    area: jax.Array
    vks: jax.Array
    celtop: jax.Array
    surfdep: jax.Array
    rch: jax.Array       # per-area recharge rate from the wave march
    gwpet: jax.Array     # residual PET per area
    extdp: jax.Array
    finf_top: jax.Array  # vks-limited applied infiltration
    sat_col: jax.Array   # b[C] column fully saturated → direct recharge
    iseepflag: int = 0
    igwetflag: int = 0


def make_step(uzf: UzfColumns, res: UzfResult) -> UzfStep:
    return UzfStep(node=uzf.node, area=uzf.area, vks=uzf.vks,
                   celtop=uzf.celtop, surfdep=uzf.surfdep, rch=res.rch,
                   gwpet=res.gwpet, extdp=uzf.extdp,
                   finf_top=res.finf_top, sat_col=res.sat_col,
                   iseepflag=uzf.iseepflag, igwetflag=uzf.igwetflag)


def uzf_matrix_terms(s: UzfStep, head, ibound):
    """Head-dependent (hcof, rhs) per column at the current iterate —
    the uzf_fc/uzf_solve per-iteration sweep, in my q = hcof·h − rhs
    boundary convention.  Returns (hcof, rhs, parts) with parts the
    individual rates for budgets (positive into the aquifer)."""
    h = head[s.node]
    act = ibound[s.node] > 0
    rng = 1e-5

    # 1. recharge delivery from the wave march, smoothly gated off as
    #    the cell dries below its bottom... the gate is against celbot,
    #    but watab ≥ celbot already bounds rch; gate on activity only
    #    (addrech sSCurve at celbot − DEM5; celbot = watab lower bound).
    q_rch = jnp.where(s.sat_col, DZERO, s.area * s.rch)

    # 2. flooded columns: infiltration becomes direct head-dependent
    #    recharge, linearly rejected over surfdep (rejfinf sLinear)
    F = s.area * s.finf_top
    x = s.celtop - h
    sd = jnp.maximum(s.surfdep, 1e-30)
    in_band = (x > DZERO) & (x < sd)
    scale = jnp.clip(x / sd, 0.0, 1.0)
    hcof2 = jnp.where(s.sat_col & in_band, -F / sd, DZERO)
    rhs2 = jnp.where(s.sat_col,
                     jnp.where(in_band, -F * s.celtop / sd,
                               -F * scale), DZERO)
    q_inf = hcof2 * h - rhs2

    # 3. groundwater seepage to land surface (gwseep, iseepflag)
    hcof3 = jnp.zeros_like(h)
    rhs3 = jnp.zeros_like(h)
    if s.iseepflag:
        Q = s.area * s.vks
        y, _ = s_cubic_linear(h - s.celtop, sd)
        seep = y * Q * (h - s.celtop) / sd
        pos = seep > DZERO
        hcof3 = jnp.where(pos, -y * Q / sd, DZERO)
        rhs3 = jnp.where(pos, -y * Q * s.celtop / sd, DZERO)
    q_seep = hcof3 * h - rhs3

    # 4. groundwater ET from residual PET (simgwet/etfunc_lin linear
    #    decay between land surface and extinction depth)
    rhs4 = jnp.zeros_like(h)
    if s.igwetflag:
        has = s.extdp > 1e-6
        fact = sq_saturation(s.celtop, s.celtop - s.extdp, h)
        rhs4 = jnp.where(has, s.area * s.gwpet * fact, DZERO)
    q_gwet = -rhs4

    hcof = jnp.where(act, hcof2 + hcof3, DZERO)
    rhs = jnp.where(act, -q_rch + rhs2 + rhs3 + rhs4, DZERO)
    parts = {"UZF-GWRCH": jnp.where(act, q_rch + q_inf, DZERO),
             "UZF-GWD": jnp.where(act, q_seep, DZERO),
             "UZF-GWET": jnp.where(act, q_gwet, DZERO)}
    return hcof, rhs, parts
