"""Deck loading for the advanced stress packages: MAW6 / LAK6 / SFR6 /
UZF6 / CSUB6 / MVR6 files in a GWF model name file.

Behavioral parity targets: the PACKAGEDATA / CONNECTIONDATA / OUTLETS /
TABLES / DIVERSIONS / PACKAGES / PERIOD block formats of gwf-maw.f90,
gwf-lak.f90 (+ its TAB6 utl-laktab files), gwf-sfr.f90, gwf-uzf.f90,
gwf-csub.f90 and gwf-mvr.f90 as specified by their dfn files
(doc/mf6io/mf6ivar/dfn/gwf-*.dfn).

Scope: the first stress period's settings are folded into the static
package build (later PERIOD blocks raise a loud NotImplementedError —
per-period advanced-package updates re-enter through the programmatic
API).  SPECIFIED/THIEM MAW conductance, VERTICAL lake connections,
Manning SFR reaches with upstream-fraction routing + diversions, the
four mover rules, no-delay and delay interbeds.
"""

from __future__ import annotations

import os

import numpy as np

from . import schema
from .reader import BlockFile


def _period_blocks(bf):
    """{kper: [token lists]} from all PERIOD blocks."""
    out = {}
    for b in bf.get_all("PERIOD"):
        out[int(b.index)] = list(b.lines)
    return out


def _only_first_period(periods, what):
    late = [k for k in periods if k > 1]
    if late:
        raise NotImplementedError(
            f"{what}: PERIOD blocks beyond the first stress period "
            f"(kper={late}) are not supported by the deck loader yet — "
            "drive per-period advanced-package updates programmatically")
    return periods.get(1, [])


def apply_maw_period(wells, lines):
    """Apply one PERIOD block's settings to the wells spec (gwf-maw.f90
    maw_rp; values persist across periods until redefined)."""
    schema.check_block_keywords("gwf-maw", "period",
                                [t[1] for t in lines if len(t) > 1])
    for toks in lines:
        w = int(toks[0]) - 1
        key = toks[1].upper()
        if key == "RATE":
            wells[w]["rate"] = float(toks[2])
        elif key == "HEAD_LIMIT":
            v = toks[2]
            if v.upper() == "OFF":
                wells[w].pop("head_limit", None)
            else:
                wells[w]["head_limit"] = float(v)
        elif key == "STATUS":
            if toks[2].upper() == "INACTIVE":
                wells[w]["rate"] = 0.0
        elif key == "RATE_SCALING":
            wells[w]["pumpelev"] = float(toks[2])
            wells[w]["reduction_length"] = float(toks[3])
        elif key == "FLOWING_WELL":
            wells[w]["flowing"] = dict(elev=float(toks[2]),
                                       cond=float(toks[3]),
                                       rlen=float(toks[4]))
        elif key == "SHUT_OFF":
            wells[w]["shut_off"] = (float(toks[2]), float(toks[3]))
        else:
            raise NotImplementedError(f"MAW period setting {key}")


def load_maw(path, grid, cellid):
    """MAW6 file → (wells spec for build_maw, later PERIOD blocks)."""
    bf = BlockFile(path)
    schema.check_options("gwf-maw", bf.options(), path)
    pdata = {}
    for toks in bf.get("PACKAGEDATA").lines:
        w = int(toks[0]) - 1
        pdata[w] = dict(radius=float(toks[1]), bottom=float(toks[2]),
                        strt=float(toks[3]), condeqn=toks[4].upper(),
                        ngwfnodes=int(toks[5]), connections=[])
    for toks in bf.get("CONNECTIONDATA").lines:
        w = int(toks[0]) - 1
        node, nt = cellid(toks, start=2)
        # scrn_top scrn_bot hk_skin radius_skin follow the cellid
        eqn = pdata[w]["condeqn"]
        if eqn == "SPECIFIED":
            conn = (node, float(toks[2 + nt + 2]))
        else:
            conn = (node, dict(condeqn=eqn,
                               scrn_top=float(toks[2 + nt]),
                               scrn_bot=float(toks[2 + nt + 1]),
                               hk_skin=float(toks[2 + nt + 2]),
                               radius_skin=float(toks[2 + nt + 3])))
        pdata[w]["connections"].append(conn)
    periods = _period_blocks(bf)
    wells = [pdata[w] for w in sorted(pdata)]
    apply_maw_period(wells, periods.get(1, []))
    return wells, {k: v for k, v in periods.items() if k > 1}


def load_lak(path, grid, cellid, base_dir):
    """LAK6 file → (lakes spec, outlets spec) for build_lak."""
    bf = BlockFile(path)
    schema.check_options("gwf-lak", bf.options(), path)
    area = np.asarray(grid.area).reshape(-1)
    lakes = {}
    for toks in bf.get("PACKAGEDATA").lines:
        il = int(toks[0]) - 1
        lakes[il] = dict(strt=float(toks[1]), surf_area=0.0,
                         connections=[])
    for toks in bf.get("CONNECTIONDATA").lines:
        il = int(toks[0]) - 1
        node, nt = cellid(toks, start=2)
        claktype = toks[2 + nt].upper()
        bedleak = toks[2 + nt + 1]
        belev = float(toks[2 + nt + 2])
        telev = float(toks[2 + nt + 3])
        connwidth = float(toks[2 + nt + 5])
        connlen = float(toks[2 + nt + 4])
        if claktype == "VERTICAL":
            carea = area[node]
        else:  # HORIZONTAL / EMBEDDED: wetted area from len × width
            carea = connlen * connwidth
        leak = 0.0 if str(bedleak).upper() == "NONE" else float(bedleak)
        # HORIZONTAL (and EMBEDDED*, approximated the same way) scale the
        # saturated conductance by the wetted fraction between belev and
        # telev at run time (lak_calculate_conn_conductance)
        ictype = 0 if claktype == "VERTICAL" else 1
        lakes[il]["connections"].append(
            (node, leak * carea, belev, telev, ictype))
        lakes[il]["surf_area"] += carea if claktype == "VERTICAL" else 0.0
    tab_b = bf.get("TABLES")
    if tab_b is not None:
        for toks in tab_b.lines:
            il = int(toks[0]) - 1
            assert toks[1].upper() == "TAB6" and toks[2].upper() == "FILEIN"
            tpath = os.path.join(base_dir, toks[3])
            tbf = BlockFile(tpath)
            rows = [(float(t[0]), float(t[1]), float(t[2]))
                    for t in tbf.get("TABLE").lines]
            lakes[il]["table"] = rows
    outlets = []
    out_b = bf.get("OUTLETS")
    if out_b is not None:
        for toks in out_b.lines:
            outlets.append(dict(
                lake=int(toks[1]) - 1,
                to=int(toks[2]) - 1,       # 0 → -1 external
                type=toks[3].lower(),
                invert=float(toks[4]), width=float(toks[5]),
                rough=float(toks[6]), slope=float(toks[7])))
    lakes_l = [lakes[i] for i in sorted(lakes)]
    periods = _period_blocks(bf)
    apply_lak_period(lakes_l, outlets, periods.get(1, []))
    return (lakes_l, outlets), {k: v for k, v in periods.items() if k > 1}


def apply_lak_period(lakes, outlets, lines):
    """Apply one PERIOD block to the lakes/outlets spec (gwf-lak.f90
    lak_rp laksetting keystrings)."""
    schema.check_block_keywords("gwf-lak", "period",
                                [t[1] for t in lines if len(t) > 1])
    for toks in lines:
        no = int(toks[0]) - 1
        key = toks[1].upper()
        if key == "RAINFALL":
            lakes[no]["rainfall"] = float(toks[2]) * lakes[no]["surf_area"]
        elif key == "EVAPORATION":
            lakes[no]["evap"] = float(toks[2]) * lakes[no]["surf_area"]
        elif key == "WITHDRAWAL":
            lakes[no]["withdrawal"] = float(toks[2])
        elif key == "RATE":
            outlets[no]["rate"] = float(toks[2])
            outlets[no]["type"] = "specified"
        elif key == "INVERT":
            outlets[no]["invert"] = float(toks[2])
        elif key == "STATUS":
            pass
        else:
            raise NotImplementedError(f"LAK period setting {key}")


def load_sfr(path, grid, cellid):
    """SFR6 file → reaches spec for build_sfr."""
    bf = BlockFile(path)
    schema.check_options("gwf-sfr", bf.options(), path)
    reaches = {}
    ustrf = {}
    ndv = {}
    for toks in bf.get("PACKAGEDATA").lines:
        r = int(toks[0]) - 1
        node, nt = cellid(toks, start=1)
        c = 1 + nt
        rlen, rwid, rgrd, rtp, rbth, rhk, man = (
            float(toks[c]), float(toks[c + 1]), float(toks[c + 2]),
            float(toks[c + 3]), float(toks[c + 4]), float(toks[c + 5]),
            float(toks[c + 6]))
        ustrf[r] = float(toks[c + 8])
        ndv[r] = int(toks[c + 9])
        reaches[r] = dict(node=node, cond=rhk * rwid * rlen / max(rbth,
                                                                  1e-30),
                          strtop=rtp, width=rwid, rough=man, slope=rgrd,
                          length=rlen, strt=rtp + 0.1, upstream=[],
                          diversions=[])
    # downstream links: reach u lists -d for its downstream receivers;
    # receiver d gets fraction ustrf_d / Σ ustrf over u's receivers
    down = {r: [] for r in reaches}
    cb = bf.get("CONNECTIONDATA")
    if cb is not None:
        for toks in cb.lines:
            r = int(toks[0]) - 1
            for t in toks[1:]:
                ic = int(float(t))
                if ic < 0:
                    down[r].append(-ic - 1)
    for u, ds in down.items():
        tot = sum(ustrf[d] for d in ds)
        for d in ds:
            frac = ustrf[d] / tot if tot > 0 else 0.0
            reaches[d]["upstream"].append((u, frac))
    div_of = {}
    db = bf.get("DIVERSIONS")
    if db is not None:
        for toks in db.lines:
            r, idv = int(toks[0]) - 1, int(toks[1]) - 1
            dto = int(toks[2]) - 1
            cprior = toks[3].lower()
            div_of[(r, idv)] = dict(to=dto, cprior=cprior, flow=0.0)
            reaches[r]["diversions"].append(div_of[(r, idv)])
    reaches_l = [reaches[i] for i in sorted(reaches)]
    periods = _period_blocks(bf)
    apply_sfr_period(reaches_l, periods.get(1, []))
    return reaches_l, {k: v for k, v in periods.items() if k > 1}


def apply_sfr_period(reaches, lines):
    """Apply one PERIOD block to the reaches spec (gwf-sfr.f90 sfr_rp)."""
    schema.check_block_keywords("gwf-sfr", "period",
                                [t[1] for t in lines if len(t) > 1])
    for toks in lines:
        r = int(toks[0]) - 1
        key = toks[1].upper()
        if key == "INFLOW":
            reaches[r]["inflow"] = float(toks[2])
        elif key == "RAINFALL":
            reaches[r]["rainfall"] = float(toks[2]) \
                * reaches[r]["length"] * reaches[r]["width"]
        elif key == "EVAPORATION":
            reaches[r]["evap"] = float(toks[2]) \
                * reaches[r]["length"] * reaches[r]["width"]
        elif key == "RUNOFF":
            reaches[r]["runoff"] = float(toks[2])
        elif key == "DIVERSION":
            reaches[r]["diversions"][int(toks[2]) - 1]["flow"] = \
                float(toks[3])
        elif key in ("MANNING", "STAGE", "STATUS"):
            if key == "MANNING":
                reaches[r]["rough"] = float(toks[2])
        else:
            raise NotImplementedError(f"SFR period setting {key}")


def load_uzf(path, grid, cellid):
    """UZF6 file → (columns, flags) for make_uzf (utl-uzf dfn blocks)."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("gwf-uzf", opts, path)
    flags = dict(ietflag=int("SIMULATE_ET" in opts),
                 iseepflag=int("SIMULATE_GWSEEP" in opts),
                 igwetflag=int("LINEAR_GWET" in opts
                               or "SQUARE_GWET" in opts))
    cols = []
    for toks in bf.get("PACKAGEDATA").lines:
        iu = int(toks[0]) - 1
        node, nt = cellid(toks, start=1)
        c = 1 + nt
        cols.append(dict(iuzno=iu, node=node,
                         landflag=int(toks[c]),
                         surfdep=float(toks[c + 2]),
                         vks=float(toks[c + 3]), thtr=float(toks[c + 4]),
                         thts=float(toks[c + 5]), thti=float(toks[c + 6]),
                         eps=float(toks[c + 7]), finf=0.0, pet=0.0,
                         extdp=0.0, extwc=0.0))
    byid = {c["iuzno"]: c for c in cols}
    periods = _period_blocks(bf)
    apply_uzf_period(byid, periods.get(1, []))
    return ([byid[i] for i in sorted(byid)], flags,
            {k: v for k, v in periods.items() if k > 1})


def apply_uzf_period(byid, lines):
    """Apply one PERIOD block to the UZF columns (gwf-uzf.f90 uzf_rp)."""
    for toks in lines:
        iu = int(toks[0]) - 1
        byid[iu]["finf"] = float(toks[1])
        for k, name in ((2, "pet"), (3, "extdp"), (4, "extwc")):
            if len(toks) > k:
                byid[iu][name] = float(toks[k])


def load_csub(path, grid, cellid, shp, base_dir, read_grid_array):
    """CSUB6 file → make_csub kwargs (gwf-csub.dfn blocks)."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("gwf-csub", opts, path)
    kw = dict(head_based="HEAD_BASED" in opts)
    dims = bf.dimensions()
    gg = lambda name, d: read_grid_array(   # noqa: E731
        bf, "GRIDDATA", name, shp, base_dir, default=d)
    kw["cg_ske_cr"] = np.asarray(gg("CG_SKE_CR", 1e-5)).reshape(-1)
    kw["cg_theta"] = np.asarray(gg("CG_THETA", 0.2)).reshape(-1)
    kw["sgm"] = np.asarray(gg("SGM", 1.7)).reshape(-1)
    kw["sgs"] = np.asarray(gg("SGS", 2.0)).reshape(-1)
    interbeds, delay = [], []
    pb = bf.get("PACKAGEDATA")
    if pb is not None and dims.get("NINTERBEDS", 0):
        for toks in pb.lines:
            node, nt = cellid(toks, start=1)
            c = 1 + nt
            cdelay = toks[c].upper()
            # pcs0 thick_frac rnb ssv_cc sse_cr theta kv h0
            thick = float(toks[c + 2])
            rnb = float(toks[c + 3])
            ssv = float(toks[c + 4])
            sse = float(toks[c + 5])
            theta = float(toks[c + 6])
            if cdelay == "DELAY":
                delay.append(dict(node=node, thick=thick, rnb=rnb,
                                  kv=float(toks[c + 7]), sske_cr=sse,
                                  ssv_cc=ssv, theta=theta))
            else:
                interbeds.append((node, thick, sse, ssv, theta))
    kw["interbeds"] = interbeds
    kw["delay_interbeds"] = delay
    _only_first_period(_period_blocks(bf), "CSUB")
    return kw


def load_apt(path, component):
    """APT transport package file (gwt-lkt/sft/mwt/uzt.dfn and the GWE
    lke/sfe/mwe/uze analogs) → dict(strt=[per-feature], ext_conc=[...]).

    PACKAGEDATA supplies the feature starting concentrations; the PERIOD
    block's RAINFALL/RUNOFF/INFLOW/EXT-INFLOW settings supply source
    concentrations for the feature's external inflows.  This apt
    build carries ONE source concentration per feature (AptFlows
    ext_conc), so the per-source settings collapse onto it (last one
    wins) — the reference tracks them separately
    (tsp-apt.f90 apt_set_stressperiod)."""
    bf = BlockFile(path)
    schema.check_options(component, bf.options(), path)
    strt = {}
    for toks in bf.get("PACKAGEDATA").lines:
        strt[int(toks[0]) - 1] = float(toks[1])
    n = max(strt) + 1 if strt else 0
    ext = np.zeros(n)
    for toks in _only_first_period(_period_blocks(bf),
                                   component.upper()):
        f = int(toks[0]) - 1
        key = toks[1].upper()
        if key in ("RAINFALL", "RUNOFF", "INFLOW", "EXT-INFLOW",
                   "CONCENTRATION", "TEMPERATURE"):
            ext[f] = float(toks[2])
        elif key == "STATUS":
            pass
        else:
            raise NotImplementedError(
                f"{component} period setting {key}")
    return dict(strt=np.asarray([strt.get(i, 0.0) for i in range(n)]),
                ext_conc=ext)


def parse_mvr_period(lines, name_to_kind):
    """One MVR PERIOD block → movers list (the block REPLACES the whole
    mover set, gwf-mvr.f90 mvr_rp)."""
    movers = []
    for toks in lines:
        p1, id1, p2, id2, typ, val = (toks[0].upper(), int(toks[1]) - 1,
                                      toks[2].upper(), int(toks[3]) - 1,
                                      toks[4].lower(), float(toks[5]))
        movers.append(dict(provider=name_to_kind[p1], iprov=id1,
                           receiver=name_to_kind[p2], ircv=id2,
                           mvrtype=typ, value=val))
    return movers


def load_exchange_mvr(path, kind_of):
    """Exchange-scope MVR6 file (GwfExchangeMover.f90 role): MODELNAMES
    entries ``mname1 pname1 id1 mname2 pname2 id2 mvrtype value``.

    ``kind_of``: callable (mname, pname) → package kind string.
    Returns movers with model-qualified ids:
    dict(provider, prov_model, iprov, receiver, recv_model, ircv,
         mvrtype, value)."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("gwf-mvr", opts, path)
    movers = []
    for toks in _only_first_period(_period_blocks(bf), "exchange MVR"):
        m1, p1, id1 = toks[0].upper(), toks[1].upper(), int(toks[2]) - 1
        m2, p2, id2 = toks[3].upper(), toks[4].upper(), int(toks[5]) - 1
        movers.append(dict(
            provider=kind_of(m1, p1), prov_model=m1, iprov=id1,
            receiver=kind_of(m2, p2), recv_model=m2, ircv=id2,
            mvrtype=toks[6].lower(), value=float(toks[7])))
    return movers


def load_mvr(path, name_to_kind):
    """MVR6 file → (movers list for build_mvr, later PERIOD blocks).

    ``name_to_kind``: package name (upper) → kind string ("wel"...)."""
    bf = BlockFile(path)
    schema.check_options("gwf-mvr", bf.options(), path)
    periods = _period_blocks(bf)
    movers = parse_mvr_period(periods.get(1, []), name_to_kind)
    return movers, {k: v for k, v in periods.items() if k > 1}
