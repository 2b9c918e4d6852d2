"""NPF: node-property-flow — inter-cell conductance assembly.

Behavioral parity targets in the reference:
  - npf_cf (saturation recalc)   src/Model/GroundWaterFlow/gwf-npf.f90:444-471
  - npf_fc (conductance fill)    gwf-npf.f90:474-574
  - npf_fn (Newton terms)        gwf-npf.f90:578-698
  - npf_nur (NR under-relax)     gwf-npf.f90:705-741
  - npf_cq (flowja)              gwf-npf.f90:745-771
  - thksat                       gwf-npf.f90:775-794
  - calc_condsat                 gwf-npf.f90:1950-2037
  - hy_eff                       gwf-npf.f90:2280-2355
  - hyeff ellipsoid projection   src/Utilities/HGeoUtil.f90:29-108

Design: the reference loops per connection with scalar math; here
every per-connection quantity is an array over the symmetric-half edge list,
so the whole `cf`+`fc` phase is a fused elementwise pass followed by one
unique-index scatter into the ELL matrix and two segment-sums onto the
diagonal.  Static option flags select traced branches at compile time.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ...constants import C3D_STAGGERED, C3D_VERTICAL, DEM6, DONE, DZERO
from ...ops import conductance as condops
from ...ops.smoothing import quadratic_saturation, quadratic_saturation_derivative


@partial(jax.tree_util.register_dataclass,
         data_fields=["edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva",
                      "anglex", "nbr", "slot_nm", "slot_mn"],
         meta_fields=["grid_shape"])
@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Device-resident connection topology (see discretization.Topology)."""

    edge_n: jax.Array   # i32[E]
    edge_m: jax.Array   # i32[E]
    ihc: jax.Array      # i32[E]
    cl1: jax.Array      # f64[E]
    cl2: jax.Array      # f64[E]
    hwva: jax.Array     # f64[E]
    anglex: jax.Array   # f64[E]
    nbr: jax.Array      # i32[N, K]
    slot_nm: jax.Array  # i32[E] flat ELL slot of (n,m)
    slot_mn: jax.Array  # i32[E] flat ELL slot of (m,n)
    grid_shape: tuple = None  # (nlay, nrow, ncol) → structured stencil path

    @property
    def nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    @staticmethod
    def from_host(topo) -> "DeviceTopology":
        return DeviceTopology(
            edge_n=jnp.asarray(topo.edge_n, jnp.int32),
            edge_m=jnp.asarray(topo.edge_m, jnp.int32),
            ihc=jnp.asarray(topo.ihc, jnp.int32),
            cl1=jnp.asarray(topo.cl1),
            cl2=jnp.asarray(topo.cl2),
            hwva=jnp.asarray(topo.hwva),
            anglex=jnp.asarray(topo.anglex),
            nbr=jnp.asarray(topo.nbr, jnp.int32),
            slot_nm=jnp.asarray(topo.slot_nm, jnp.int32),
            slot_mn=jnp.asarray(topo.slot_mn, jnp.int32),
            grid_shape=getattr(topo, "grid_shape", None),
        )


@dataclasses.dataclass(frozen=True)
class NpfOptions:
    """Static NPF formulation flags (compile-time branch selection)."""

    icellavg: int = 0       # CCOND_* averaging method
    inewton: int = 0        # Newton-Raphson formulation
    ivarcv: int = 0         # VARIABLECV
    idewatcv: int = 0       # VARIABLECV DEWATERED
    iperched: int = 0       # PERCHED
    ik22: bool = False      # K22 provided
    ik33: bool = False      # K33 provided
    iangle1: bool = False
    iangle2: bool = False
    iangle3: bool = False
    thickstrt: bool = False
    satomega: float = 0.0   # set to 1e-6 when Newton


@partial(jax.tree_util.register_dataclass,
         data_fields=["icelltype", "k11", "k22", "k33", "angle1", "angle2",
                      "angle3", "condsat", "top", "bot"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class NpfArrays:
    """Per-cell NPF properties + per-edge saturated conductance."""

    icelltype: jax.Array  # i32[N]
    k11: jax.Array        # f64[N]
    k22: jax.Array        # f64[N]
    k33: jax.Array        # f64[N]
    angle1: jax.Array     # f64[N] radians
    angle2: jax.Array     # f64[N]
    angle3: jax.Array     # f64[N]
    condsat: jax.Array    # f64[E]
    top: jax.Array        # f64[N]
    bot: jax.Array        # f64[N]


def _hyeff(k11, k22, k33, ang1, ang2, ang3, vg1, vg2, vg3, iavgmeth=0):
    """Effective K along a unit direction on the conductivity ellipsoid
    (reference HGeoUtil.f90 hyeff), vectorized."""
    s1, c1 = jnp.sin(ang1), jnp.cos(ang1)
    s2, c2 = jnp.sin(ang2), jnp.cos(ang2)
    s3, c3 = jnp.sin(ang3), jnp.cos(ang3)
    # rows of the rotation matrix applied to vg → ellipse-local components
    ve1 = c1 * c2 * vg1 + s1 * c2 * vg2 + s2 * vg3
    ve2 = (c1 * s2 * s3 - s1 * c3) * vg1 + (s1 * s2 * s3 + c1 * c3) * vg2 + (-c2 * s3) * vg3
    ve3 = (-c1 * s2 * c3 - s1 * s3) * vg1 + (-s1 * s2 * c3 + c1 * s3) * vg2 + (c2 * c3) * vg3
    if iavgmeth == 0:
        dnum = jnp.ones_like(ve1)
        d1, d2, d3 = ve1**2, ve2**2, ve3**2
        nz1, nz2, nz3 = ve1 != DZERO, ve2 != DZERO, ve3 != DZERO
        dnum = dnum * jnp.where(nz1, k11, 1.0)
        d2 = d2 * jnp.where(nz1, k11, 1.0)
        d3 = d3 * jnp.where(nz1, k11, 1.0)
        dnum = dnum * jnp.where(nz2, k22, 1.0)
        d1 = d1 * jnp.where(nz2, k22, 1.0)
        d3 = d3 * jnp.where(nz2, k22, 1.0)
        dnum = dnum * jnp.where(nz3, k33, 1.0)
        d1 = d1 * jnp.where(nz3, k33, 1.0)
        d2 = d2 * jnp.where(nz3, k33, 1.0)
        denom = d1 + d2 + d3
        return jnp.where(denom > DZERO, dnum / jnp.where(denom > 0, denom, 1.0), DZERO)
    return ve1**2 * k11 + ve2**2 * k22 + ve3**2 * k33


def edge_hy(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays):
    """Per-edge effective hydraulic conductivity (hkn, hkm) for both cells.

    Matches hy_eff (gwf-npf.f90:2280): plain k11 (horizontal) / k33
    (vertical) unless anisotropy options require ellipsoid projection.
    """
    n, m = dtopo.edge_n, dtopo.edge_m
    is_vert = dtopo.ihc == C3D_VERTICAL

    def one_side(idx):
        k11, k22, k33 = arrays.k11[idx], arrays.k22[idx], arrays.k33[idx]
        hy_v = k33
        hy_h = k11
        if opts.iangle2:
            a1 = arrays.angle1[idx] if opts.iangle1 else jnp.zeros_like(k11)
            a2 = arrays.angle2[idx]
            a3 = arrays.angle3[idx] if opts.iangle3 else jnp.zeros_like(k11)
            hy_v = _hyeff(k11, k22, k33, a1, a2, a3, 0.0, 0.0, 1.0)
        if opts.ik22:
            vg1 = jnp.cos(dtopo.anglex)
            vg2 = jnp.sin(dtopo.anglex)
            a1 = arrays.angle1[idx] if opts.iangle1 else jnp.zeros_like(k11)
            a2 = arrays.angle2[idx] if opts.iangle2 else jnp.zeros_like(k11)
            a3 = arrays.angle3[idx] if opts.iangle3 else jnp.zeros_like(k11)
            hy_h = _hyeff(k11, k22, k33, a1, a2, a3, vg1, vg2, jnp.zeros_like(vg1))
        return jnp.where(is_vert, hy_v, hy_h)

    return one_side(n), one_side(m)


def initial_sat(opts: NpfOptions, arrays: NpfArrays, strt, ibound):
    """Saturation used for condsat precompute: 1, or strt-based with THICKSTRT
    for confined-by-thickstrt cells (reference calc_initial_sat)."""
    N = arrays.top.shape[0]
    ones = jnp.ones(N)
    if not opts.thickstrt:
        return ones
    use_strt = (ibound != 0) & (arrays.icelltype < 0)
    return jnp.where(
        use_strt,
        quadratic_saturation(arrays.top, arrays.bot, strt, 0.0),
        ones)


def compute_condsat(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
                    sat0, strt=None):
    """Saturated conductance per edge (reference calc_condsat gwf-npf.f90:1950).

    ``sat0`` is the initial saturation from :func:`initial_sat`; ``strt``
    only matters under THICKSTRT (heads default to cell tops otherwise).
    """
    n, m = dtopo.edge_n, dtopo.edge_m
    hkn, hkm = edge_hy(dtopo, opts, arrays)
    topn, topm = arrays.top[n], arrays.top[m]
    botn, botm = arrays.bot[n], arrays.bot[m]
    satn, satm = sat0[n], sat0[m]
    is_vert = dtopo.ihc == C3D_VERTICAL

    # vertical: vcond at full(initial) saturation, variable-CV + dewatered path
    # with h = bot so the wetted-thickness branch is taken
    bovk1 = satn * (topn - botn) * 0.5 / jnp.where(hkn != 0, hkn, 1.0)
    bovk2 = satm * (topm - botm) * 0.5 / jnp.where(hkm != 0, hkm, 1.0)
    denom = bovk1 + bovk2
    csat_v = jnp.where(denom != DZERO, dtopo.hwva / jnp.where(denom != 0, denom, 1.0), DZERO)

    # horizontal: condmean at initial saturation (staggered-aware)
    is_stag = dtopo.ihc == C3D_STAGGERED
    thksatn = jnp.where(
        is_stag,
        condops.staggered_thkfrac(topn, botn, satn, topm, botm),
        satn * (topn - botn))
    thksatm = jnp.where(
        is_stag,
        condops.staggered_thkfrac(topm, botm, satm, topn, botn),
        satm * (topm - botm))
    csat_h = condops.condmean(hkn, hkm, thksatn, thksatm,
                              dtopo.cl1, dtopo.cl2, dtopo.hwva, opts.icellavg)
    return jnp.where(is_vert, csat_v, csat_h)


def compute_saturation(opts: NpfOptions, arrays: NpfArrays, head, ibound):
    """npf_cf: per-cell wetted fraction for convertible cells
    (reference gwf-npf.f90:444-471 + thksat :775-794)."""
    top, bot = arrays.top, arrays.bot
    if opts.inewton:
        sat = quadratic_saturation(top, bot, head, opts.satomega)
    else:
        thick = jnp.where(top != bot, top - bot, 1.0)
        sat = jnp.where(head >= top, DONE, (head - bot) / thick)
    sat = jnp.where(ibound == 0, DZERO, sat)
    return jnp.where(arrays.icelltype != 0, sat, DONE)


def edge_conductance(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
                     head, ibound, sat):
    """Per-edge conductance (the body of npf_fc's connection loop)."""
    n, m = dtopo.edge_n, dtopo.edge_m
    hkn, hkm = edge_hy(dtopo, opts, arrays)
    hn, hm = head[n], head[m]
    ibdn, ibdm = ibound[n], ibound[m]
    ictn, ictm = arrays.icelltype[n], arrays.icelltype[m]
    topn, topm = arrays.top[n], arrays.top[m]
    botn, botm = arrays.bot[n], arrays.bot[m]
    satn, satm = sat[n], sat[m]
    is_vert = dtopo.ihc == C3D_VERTICAL

    cond_h = condops.hcond(
        ibdn, ibdm, ictn, ictm, opts.inewton, dtopo.ihc, opts.icellavg,
        arrays.condsat, hn, hm, satn, satm, hkn, hkm,
        topn, topm, botn, botm, dtopo.cl1, dtopo.cl2, dtopo.hwva)
    cond_v = condops.vcond(
        ibdn, ibdm, ictn, ictm, opts.ivarcv, opts.idewatcv,
        arrays.condsat, hn, hm, hkn, hkm, satn, satm,
        topn, topm, botn, botm, dtopo.hwva)
    return jnp.where(is_vert, cond_v, cond_h)


def assemble(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
             head, ibound, sat):
    """npf_fc: conductances → (diag, off, rhs) contributions.

    Returns (diag[N], off[N,K], rhs[N]).  The perched correction
    (iperched) moves the vertical term for dewatered underlying cells to
    the rhs, per gwf-npf.f90:520-545.
    """
    N, K = dtopo.nodes, dtopo.max_degree
    n, m = dtopo.edge_n, dtopo.edge_m
    cond = edge_conductance(dtopo, opts, arrays, head, ibound, sat)

    perched = jnp.zeros_like(cond, dtype=bool)
    if opts.iperched:
        is_vert = dtopo.ihc == C3D_VERTICAL
        ictm = arrays.icelltype[m]
        perched = is_vert & (ictm != 0) & (head[m] < arrays.top[m])

    # normal symmetric fill: off(n,m)=off(m,n)=cond, diag -= cond at both ends
    off_edge_nm = jnp.where(perched, DZERO, cond)
    off_edge_mn = jnp.where(perched, cond, cond)  # perched keeps (m,n) = +cond
    diag_n = jnp.where(perched, -cond, -cond)
    diag_m = jnp.where(perched, DZERO, -cond)
    rhs_n = jnp.where(perched, -cond * arrays.bot[n], DZERO)
    rhs_m = jnp.where(perched, cond * arrays.bot[n], DZERO)

    off = jnp.zeros((N * K,))
    off = off.at[dtopo.slot_nm].add(off_edge_nm)
    off = off.at[dtopo.slot_mn].add(off_edge_mn)
    off = off.reshape(N, K)

    diag = (jnp.zeros(N).at[n].add(diag_n)).at[m].add(diag_m)
    rhs = (jnp.zeros(N).at[n].add(rhs_n)).at[m].add(rhs_m)
    return diag, off, rhs, cond


def newton_terms(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
                 head, ibound, diag, off, rhs):
    """npf_fn: add Newton saturation-derivative terms (gwf-npf.f90:578-698)."""
    n, m = dtopo.edge_n, dtopo.edge_m
    hn, hm = head[n], head[m]
    is_vert_constcv = (dtopo.ihc == C3D_VERTICAL) & (opts.ivarcv == 0)

    ups_is_n = hm < hn
    iups = jnp.where(ups_is_n, n, m)
    h_up = jnp.where(ups_is_n, hn, hm)
    h_dn = jnp.where(ups_is_n, hm, hn)
    ict_up = arrays.icelltype[iups]

    topup = arrays.top[iups]
    botup = arrays.bot[iups]
    is_stag = dtopo.ihc == C3D_STAGGERED
    topup = jnp.where(is_stag, jnp.minimum(arrays.top[n], arrays.top[m]), topup)
    botup = jnp.where(is_stag, jnp.maximum(arrays.bot[n], arrays.bot[m]), botup)

    cond = arrays.condsat
    consterm = -cond * (h_up - h_dn)
    derv = quadratic_saturation_derivative(topup, botup, h_up, opts.satomega)
    # term for the row of the upstream cell's diagonal
    active = (ict_up != 0) & ~is_vert_constcv
    term = jnp.where(active, consterm * derv, DZERO)
    term = jnp.where(ups_is_n, term, -term)

    # rhs: += term * h_up on row n, -= on row m
    rhs = rhs.at[n].add(jnp.where(active, term * h_up, DZERO))
    rhs = rhs.at[m].add(jnp.where(active, -term * h_up, DZERO))

    N, K = dtopo.nodes, dtopo.max_degree
    off_flat = off.reshape(N * K)
    # iups == n: diag[n] += term ; off(m,n) += -term  (only if ibound[m] > 0)
    # iups == m: off(n,m) += term (if ibound[n] > 0) ; diag[m] += -term
    diag = diag.at[n].add(jnp.where(active & ups_is_n, term, DZERO))
    diag = diag.at[m].add(jnp.where(active & ~ups_is_n, -term, DZERO))
    off_flat = off_flat.at[dtopo.slot_mn].add(
        jnp.where(active & ups_is_n & (ibound[m] > 0), -term, DZERO))
    off_flat = off_flat.at[dtopo.slot_nm].add(
        jnp.where(active & ~ups_is_n & (ibound[n] > 0), term, DZERO))
    return diag, off_flat.reshape(N, K), rhs


def under_relax(arrays: NpfArrays, ibound, x, xtemp, dx, bot_nur):
    """npf_nur: pull heads that dropped below cell bottoms back toward the
    bottom (gwf-npf.f90:705-741).  Returns (x, dx, applied_any, dxmax)."""
    applies = (ibound >= 1) & (arrays.icelltype > 0) & (x < bot_nur)
    xx = xtemp * (1.0 - 0.9) + bot_nur * 0.9
    dxx = jnp.where(applies, x - xx, DZERO)
    x = jnp.where(applies, xx, x)
    dx = jnp.where(applies, DZERO, dx)
    dxmax = dxx[jnp.argmax(jnp.abs(dxx))]
    return x, dx, applies.any(), dxmax


def flowja(dtopo: DeviceTopology, cond, head, rhs_edges=None):
    """npf_cq: inter-cell flow for each half-edge, positive into cell n
    (reference gwf-npf.f90:745-771: qnm = cond*(hm-hn))."""
    n, m = dtopo.edge_n, dtopo.edge_m
    return cond * (head[m] - head[n])


# ----------------------------------------------------------- wetting/drying

def wetdry_update(dtopo, arrays, wetdry, ibound, head, kiter,
                  iwetit=1, ihdwet=0, wetfct=1.0):
    """One wetting/drying sweep (sgwf_npf_wetdry + rewet_check).

    Vectorized over all cells/edges:
    - rewetting (every ``iwetit`` outer iterations): a dry wettable cell
      (ibound 0, WETDRY ≠ 0) rewets when the cell BELOW it (vertical
      connection) or — if WETDRY > 0 — a horizontally adjacent cell is
      active with head ≥ bot + |WETDRY|; the rewetted head is
      bot + WETFCT·(hm − bot) (IHDWET=0, eq. 3a) or bot + WETFCT·|WETDRY|
      (eq. 3b), with hm the highest triggering neighbor head;
    - drying: active convertible cells with min(h, top) − bot ≤ 0 go
      inactive at head = DHDRY.

    Returns (ibound, head, changed).
    """
    from ...constants import DHDRY

    n, m = dtopo.edge_n, dtopo.edge_m
    bot, top = arrays.bot, arrays.top
    awd = jnp.abs(wetdry)
    turnon = bot + awd
    vert = dtopo.ihc == 0          # edge (n, m): m is the deeper cell

    do_check = (kiter % iwetit) == 0
    # n rewetted by m (below for vertical, or horizontal with wd>0)
    cn = ((ibound[n] == 0) & (wetdry[n] != 0.0) & (ibound[m] > 0)
          & (head[m] >= turnon[n]) & (vert | (wetdry[n] > 0.0)))
    # m rewetted by n (horizontal only — n is ABOVE m on vertical edges)
    cm = ((ibound[m] == 0) & (wetdry[m] != 0.0) & (ibound[n] > 0)
          & (head[n] >= turnon[m]) & (~vert & (wetdry[m] > 0.0)))
    hm_max = jnp.full_like(head, -jnp.inf)
    hm_max = hm_max.at[n].max(jnp.where(cn, head[m], -jnp.inf))
    hm_max = hm_max.at[m].max(jnp.where(cm, head[n], -jnp.inf))
    rewet = do_check & jnp.isfinite(hm_max)
    h_wet = jnp.where(ihdwet == 0, bot + wetfct * (hm_max - bot),
                      bot + wetfct * awd)
    head = jnp.where(rewet, h_wet, head)
    ibound = jnp.where(rewet, 1, ibound)

    # drying (freshly rewetted heads sit above bot, so they survive)
    thick = jnp.minimum(head, top) - bot
    dry = (ibound > 0) & (arrays.icelltype != 0) & (thick <= 0.0)
    head = jnp.where(dry, DHDRY, head)
    ibound = jnp.where(dry, 0, ibound)
    changed = jnp.any(rewet) | jnp.any(dry)
    return ibound, head, changed
