"""Load a full MF6 simulation from an mfsim.nam workspace.

Behavioral parity target: the reference's IDM load + SimulationCreate path
(src/Utilities/Idm/IdmLoad.f90 simnam_load/simtdis_load/load_models,
src/SimulationCreate.f90:200-729): parse mfsim.nam, TDIS, IMS, the model
nam file and its packages, and assemble a runnable Simulation.

Round-1 scope: one GWF model, DIS grid, packages
DIS/NPF/IC/STO/CHD/WEL/DRN/RIV/GHB/RCH/EVT/OC (list-based input,
stress-period blocks with MF6 persistence semantics).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ...models.discretization import DisGrid
from ...models.discretization.disv import DisvGrid
from ...models.discretization.disu import DisuGrid
from ...models.gwf import builder
from ...models.gwf.buy import make_buy
from ...models.gwf.model import PackageData
from ...models.simulation import Simulation
from ...solution.ims import ImsSettings
from ...timing.tdis import StressPeriod, Tdis
from ..oc import OutputControl, parse_spec
from .arrays import read_grid_array
from . import schema
from .reader import BlockFile


def _f(tok):
    return float(tok)


def load_tdis(path):
    bf = BlockFile(path)
    dims = bf.dimensions()
    nper = dims.get("NPER", 1)
    b = bf.get("PERIODDATA")
    periods = []
    for toks in b.lines[:nper]:
        periods.append(StressPeriod(float(toks[0]), int(toks[1]),
                                    float(toks[2])))
    opts = bf.options()
    schema.check_options("sim-tdis", opts, path)
    return Tdis(tuple(periods),
                time_units=str(opts.get("TIME_UNITS", "UNKNOWN")),
                start_date_time=str(opts.get("START_DATE_TIME", "")))


def load_ims(path) -> ImsSettings:
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("sln-ims", opts, path)
    complexity = opts.get("COMPLEXITY", "SIMPLE")
    if isinstance(complexity, bool):
        complexity = "SIMPLE"
    s = ImsSettings.from_complexity(str(complexity))
    v = opts.get("CSV_INNER_OUTPUT")
    if isinstance(v, list) and v[0].upper() == "FILEOUT":
        s.csv_inner_path = os.path.join(os.path.dirname(path), v[1])

    nl = bf.get("NONLINEAR")
    if nl is not None:
        kv = {t[0].upper(): t[1:] for t in nl.lines}
        if "OUTER_DVCLOSE" in kv:
            s.outer_dvclose = _f(kv["OUTER_DVCLOSE"][0])
        if "OUTER_HCLOSE" in kv:  # deprecated alias
            s.outer_dvclose = _f(kv["OUTER_HCLOSE"][0])
        if "OUTER_MAXIMUM" in kv:
            s.outer_maximum = int(kv["OUTER_MAXIMUM"][0])
        if "UNDER_RELAXATION" in kv:
            ur = kv["UNDER_RELAXATION"][0].upper()
            s.under_relaxation = {"NONE": "none", "SIMPLE": "simple",
                                  "COOLEY": "cooley", "DBD": "dbd"}[ur]
        if "UNDER_RELAXATION_GAMMA" in kv:
            s.gamma = _f(kv["UNDER_RELAXATION_GAMMA"][0])
        if "UNDER_RELAXATION_THETA" in kv:
            s.theta = _f(kv["UNDER_RELAXATION_THETA"][0])
        if "UNDER_RELAXATION_KAPPA" in kv:
            s.akappa = _f(kv["UNDER_RELAXATION_KAPPA"][0])
        if "UNDER_RELAXATION_MOMENTUM" in kv:
            s.amomentum = _f(kv["UNDER_RELAXATION_MOMENTUM"][0])
        if "BACKTRACKING_NUMBER" in kv:
            s.backtracking_number = int(kv["BACKTRACKING_NUMBER"][0])
        if "BACKTRACKING_TOLERANCE" in kv:
            s.backtracking_tolerance = _f(kv["BACKTRACKING_TOLERANCE"][0])
        if "BACKTRACKING_REDUCTION_FACTOR" in kv:
            s.backtracking_reduction_factor = _f(
                kv["BACKTRACKING_REDUCTION_FACTOR"][0])
        if "BACKTRACKING_RESIDUAL_LIMIT" in kv:
            s.backtracking_residual_limit = _f(
                kv["BACKTRACKING_RESIDUAL_LIMIT"][0])

    lin = bf.get("LINEAR")
    if lin is not None:
        kv = {t[0].upper(): t[1:] for t in lin.lines}
        if "INNER_MAXIMUM" in kv:
            s.inner_maximum = int(kv["INNER_MAXIMUM"][0])
        if "INNER_DVCLOSE" in kv:
            s.inner_dvclose = _f(kv["INNER_DVCLOSE"][0])
        if "INNER_HCLOSE" in kv:
            s.inner_dvclose = _f(kv["INNER_HCLOSE"][0])
        if "INNER_RCLOSE" in kv:
            s.inner_rclose = _f(kv["INNER_RCLOSE"][0])
            if len(kv["INNER_RCLOSE"]) > 1:
                opt = kv["INNER_RCLOSE"][1].upper()
                s.icnvgopt = {"STRICT": 1, "L2NORM_RHS": 2,
                              "RELATIVE_RCLOSE": 3,
                              "L2NORM_RELATIVE_RCLOSE": 4}.get(opt, 0)
        if "LINEAR_ACCELERATION" in kv:
            acc = kv["LINEAR_ACCELERATION"][0].upper()
            s.linear_acceleration = "cg" if acc == "CG" else "bicgstab"
        if "RELAXATION_FACTOR" in kv:
            s.relaxation_factor = _f(kv["RELAXATION_FACTOR"][0])
            if s.relaxation_factor != 0.0:
                # the reference uses this as the MILU(0)/MILUT relax in its
                # ILU factorization (ImsLinearBase.f90 ims_base_pcu); this
                # build preconditions with Jacobi/Chebyshev polynomials
                # instead, where no such knob exists.  Warn loudly rather
                # than silently diverge from deck intent.
                import warnings
                warnings.warn(
                    "IMS RELAXATION_FACTOR applies to the reference's ILU "
                    "preconditioner; this build uses polynomial "
                    "preconditioning and ignores it (iteration counts may "
                    "differ, results do not)", stacklevel=2)
        if "NUMBER_ORTHOGONALIZATIONS" in kv:
            s.north = int(kv["NUMBER_ORTHOGONALIZATIONS"][0])
        if "PRECONDITIONER_LEVELS" in kv or "PRECONDITIONER_DROP_TOLERANCE" in kv:
            import warnings
            warnings.warn(
                "IMS PRECONDITIONER_LEVELS/DROP_TOLERANCE configure the "
                "reference's ILUT; this build maps them to a Chebyshev "
                "polynomial preconditioner of matching cost", stacklevel=2)
            s.preconditioner = "chebyshev"
            s.preconditioner_order = 4

    # NO_PTC lives in the OPTIONS block (sln-ims.dfn:134-156)
    no_ptc = opts.get("NO_PTC")
    if no_ptc is not None:
        val = str(no_ptc).upper()
        s.no_ptc = "first" if val == "FIRST" else "all"
    return s


def load_dis(path) -> DisGrid:
    bf = BlockFile(path)
    base = os.path.dirname(path)
    d = bf.dimensions()
    nlay, nrow, ncol = d["NLAY"], d["NROW"], d["NCOL"]
    delr = read_grid_array(bf, "GRIDDATA", "DELR", (ncol,), base)
    delc = read_grid_array(bf, "GRIDDATA", "DELC", (nrow,), base)
    top = read_grid_array(bf, "GRIDDATA", "TOP", (nrow, ncol), base)
    botm = read_grid_array(bf, "GRIDDATA", "BOTM", (nlay, nrow, ncol), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nlay, nrow, ncol),
                              base, dtype=np.int64, default=1)
    opts = bf.options()
    schema.check_options("gwf-dis", opts, path)
    schema.check_griddata("gwf-dis", bf, path)
    return DisGrid.create(nlay, nrow, ncol, delr, delc, top, botm, idomain,
                          xorigin=float(opts.get("XORIGIN", 0.0)),
                          yorigin=float(opts.get("YORIGIN", 0.0)),
                          angrot=float(opts.get("ANGROT", 0.0)))


def load_disv(path) -> DisvGrid:
    """DISV grid file (reference src/Model/Discretization/Disv.f90 +
    gwf-disv.dfn): DIMENSIONS NCPL/NLAY/NVERT, VERTICES, CELL2D blocks."""
    bf = BlockFile(path)
    base = os.path.dirname(path)
    d = bf.dimensions()
    nlay, ncpl, nvert = d["NLAY"], d["NCPL"], d["NVERT"]
    verts = np.zeros((nvert, 2))
    for toks in bf.get("VERTICES").lines:
        iv = int(toks[0]) - 1
        verts[iv] = (float(toks[1]), float(toks[2]))
    cell2d = [None] * ncpl
    for toks in bf.get("CELL2D").lines:
        ic = int(toks[0]) - 1
        xc, yc = float(toks[1]), float(toks[2])
        ncvert = int(toks[3])
        ivs = [int(t) - 1 for t in toks[4:4 + ncvert]]
        # MF6 lists cell vertices clockwise with an optional closing
        # duplicate; DisvGrid wants an open ring
        if len(ivs) > 1 and ivs[0] == ivs[-1]:
            ivs = ivs[:-1]
        cell2d[ic] = (xc, yc, ivs)
    top = read_grid_array(bf, "GRIDDATA", "TOP", (ncpl,), base)
    botm = read_grid_array(bf, "GRIDDATA", "BOTM", (nlay, ncpl), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nlay, ncpl),
                              base, dtype=np.int64, default=1)
    return DisvGrid.create(nlay, ncpl, verts, cell2d, top, botm, idomain)


def load_disu(path) -> DisuGrid:
    """DISU grid file (Disu.f90 + gwf-disu.dfn): NODES/NJA dimensions,
    GRIDDATA top/bot/area, CONNECTIONDATA iac/ja/ihc/cl12/hwva/angldegx."""
    bf = BlockFile(path)
    base = os.path.dirname(path)
    d = bf.dimensions()
    nodes, nja = d["NODES"], d["NJA"]
    top = read_grid_array(bf, "GRIDDATA", "TOP", (nodes,), base)
    bot = read_grid_array(bf, "GRIDDATA", "BOT", (nodes,), base)
    area = read_grid_array(bf, "GRIDDATA", "AREA", (nodes,), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nodes,), base,
                              dtype=np.int64, default=1)
    iac = read_grid_array(bf, "CONNECTIONDATA", "IAC", (nodes,), base,
                          dtype=np.int64)
    ja = read_grid_array(bf, "CONNECTIONDATA", "JA", (nja,), base,
                         dtype=np.int64)
    ihc = read_grid_array(bf, "CONNECTIONDATA", "IHC", (nja,), base,
                          dtype=np.int64)
    cl12 = read_grid_array(bf, "CONNECTIONDATA", "CL12", (nja,), base)
    hwva = read_grid_array(bf, "CONNECTIONDATA", "HWVA", (nja,), base)
    angldegx = read_grid_array(bf, "CONNECTIONDATA", "ANGLDEGX", (nja,),
                               base)
    # MF6 ja is 1-based with each row led by the cell number itself
    return DisuGrid.create(top, bot, area, iac, np.abs(ja) - 1, ihc, cl12,
                           hwva, angldegx, idomain)


def load_oc(path, mdir, component="gwf-oc"):
    """OC file → (hds_path, cbc_path, OutputControl with PERIOD blocks)."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options(component, opts, path)

    def _fileout(key):
        v = opts.get(key)
        if isinstance(v, list) and v[0].upper() == "FILEOUT":
            return os.path.join(mdir, v[1])
        return None

    oc = OutputControl()
    for b in bf.get_all("PERIOD"):
        actions = {}
        for toks in b.lines:
            verb = toks[0].upper()
            what = toks[1].upper()
            if verb in ("SAVE", "PRINT"):
                actions[(verb, what)] = parse_spec(toks[2:])
        oc.set_period(b.index, actions)
    # CONCENTRATION/TEMPERATURE/STAGE share the HEAD slot (tsp-oc, swf oc)
    dv = (_fileout("HEAD") or _fileout("CONCENTRATION")
          or _fileout("TEMPERATURE") or _fileout("STAGE"))
    return dv, _fileout("BUDGET"), oc


def load_exchange_gwfgwf(path, grid1, grid2):
    """GWF6-GWF6 exchange file → (ExchangePair list, mvr file or None)
    (reference exg-gwfgwf.f90 + DisConnExchange.f90 exchangedata; the
    MVR6 FILEIN option is the exchange mover, GwfExchangeMover.f90)."""
    from ...models.gwf.exchange import ExchangePair
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("exg-gwfgwf", opts, path)
    mvr_path = None
    v = opts.get("MVR6")
    if isinstance(v, list) and v[0].upper() == "FILEIN":
        mvr_path = os.path.join(os.path.dirname(path), v[1])
    aux_names = []
    aux = opts.get("AUXILIARY")
    if aux:
        aux_names = [str(a).upper()
                     for a in (aux if isinstance(aux, list) else [aux])]
    pairs = []
    b = bf.get("EXCHANGEDATA")
    for toks in bf.expand_open_close(b):
        n1, nt1 = _cellid_to_node(toks, grid1)
        n2, nt2 = _cellid_to_node(toks, grid2, start=nt1)
        base = nt1 + nt2
        ihc = int(toks[base])
        cl1, cl2, hwva = (float(toks[base + 1]), float(toks[base + 2]),
                          float(toks[base + 3]))
        ang = 0.0
        if "ANGLDEGX" in aux_names:
            ang = float(toks[base + 4 + aux_names.index("ANGLDEGX")])
        pairs.append(ExchangePair(n1, n2, ihc, cl1, cl2, hwva, ang))
    return pairs, mvr_path


def _cellid_to_node(toks, grid, start=0):
    """Parse a cellid (1-based) → 0-based node; returns (node, ntok)."""
    if isinstance(grid, DisGrid):
        k, i, j = (int(toks[start]) - 1, int(toks[start + 1]) - 1,
                   int(toks[start + 2]) - 1)
        return int(grid.node_number(k, i, j)), 3
    if hasattr(grid, "ncpl"):
        k, c = int(toks[start]) - 1, int(toks[start + 1]) - 1
        return k * grid.ncpl + c, 2
    return int(toks[start]) - 1, 1


def _load_period_lists(path, grid, ncols, colnames, component=None):
    """Read a list-based stress package file.

    Returns (options, dimensions, {kper: [(node, v1, v2, ...)]},
    {kper: {AUXNAME: [values]}}, ts_refs) where ``ts_refs`` lists
    (kper, row, col, SERIESNAME) for values given as time-series names
    (utl-ts per-entry bindings; the TS6 FILEIN option supplies the
    series).
    """
    bf = BlockFile(path)
    opts = bf.options()
    if component:
        schema.check_options(component, opts, path)
    dims = bf.dimensions()
    aux_names = []
    aux_opt = opts.get("AUXILIARY")
    if aux_opt:
        aux_names = [str(a).upper() for a in
                     (aux_opt if isinstance(aux_opt, list) else [aux_opt])]
    has_bnames = "BOUNDNAMES" in opts
    periods = {}
    aux_periods = {}
    bname_periods = {}
    ts_refs = []
    for b in bf.get_all("PERIOD"):
        entries = []
        auxvals = {a: [] for a in aux_names}
        bnames = []
        for row, toks in enumerate(bf.expand_open_close(b)):
            node, ntok = _cellid_to_node(toks, grid)
            vals = []
            for col in range(ncols):
                t = toks[ntok + col]
                try:
                    vals.append(float(t))
                except ValueError:
                    ts_refs.append((b.index, row, col, t.upper()))
                    vals.append(0.0)
            entries.append((node, *vals))
            for ia, a in enumerate(aux_names):
                auxvals[a].append(float(toks[ntok + ncols + ia]))
            if has_bnames and len(toks) > ntok + ncols + len(aux_names):
                bnames.append(toks[ntok + ncols + len(aux_names)].upper())
            else:
                bnames.append(None)
        periods[b.index] = entries
        aux_periods[b.index] = auxvals
        bname_periods[b.index] = bnames
    return opts, dims, periods, aux_periods, ts_refs, bname_periods


_LIST_PACKAGES = {
    "CHD6": ("chd", 1, builder.chd_data),
    "WEL6": ("wel", 1, builder.wel_data),
    "DRN6": ("drn", 2, builder.drn_data),
    "RIV6": ("riv", 3, builder.riv_data),
    "GHB6": ("ghb", 2, builder.ghb_data),
    "RCH6": ("rch", 1, builder.rch_data),
    "EVT6": ("evt", 3, builder.evt_data),
}


def _load_grid(pkg_files):
    """Dispatch the discretization package (DIS6/DISV6/DISU6)."""
    if "DIS6" in pkg_files:
        return load_dis(pkg_files["DIS6"][0])
    if "DISV6" in pkg_files:
        return load_disv(pkg_files["DISV6"][0])
    if "DISU6" in pkg_files:
        return load_disu(pkg_files["DISU6"][0])
    raise NotImplementedError(
        "model requires a DIS6, DISV6, or DISU6 package")


def _load_gwf_model(ws, mfname, mname, hds_path=None, cbc_path=None):
    """Load one GWF model nam file + packages → a bundle dict."""
    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    newton = False
    mopts = mnam.options()
    schema.check_options("gwf-nam", mopts, mfname)
    if "NEWTON" in mopts:
        v = mopts["NEWTON"]
        vals = ([str(x).upper() for x in (v if isinstance(v, list) else [v])]
                if v is not True else [])
        newton = "under_relaxation" if "UNDER_RELAXATION" in vals else True

    # NetCDF export/input records (gwf-nam nc_structured/nc_filerecord)
    nc_out = None
    v = mopts.get("NETCDF_STRUCTURED")
    if isinstance(v, list) and v[0].upper() == "FILEOUT":
        nc_out = os.path.join(mdir, v[1])
    nc_in = None
    v = mopts.get("NETCDF")
    if isinstance(v, list) and v[0].upper() == "FILEIN":
        nc_in = os.path.join(mdir, v[1])

    pkg_files = {}
    pkg_name_kind = {}
    _kind_of = {"WEL6": "wel", "DRN6": "drn", "RIV6": "riv", "GHB6": "ghb",
                "MAW6": "maw", "LAK6": "lak", "SFR6": "sfr", "UZF6": "uzf"}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        pkg_files.setdefault(ftype, []).append(os.path.join(mdir, toks[1]))
        if ftype in _kind_of:
            kind = _kind_of[ftype]
            base_name = ftype[:-1]
            n_inst = len(pkg_files[ftype])
            pkg_name_kind[f"{base_name}-{n_inst}"] = kind
            pkg_name_kind[base_name] = kind
            if len(toks) > 2:
                pkg_name_kind[toks[2].upper()] = kind

    grid = _load_grid(pkg_files)
    N = grid.nodes
    shp = grid.shape
    base = mdir

    ic_bf = BlockFile(pkg_files["IC6"][0])
    strt = read_grid_array(ic_bf, "GRIDDATA", "STRT", shp, base,
                           default=0.0,
                           nc=(nc_in, "ic") if nc_in else None)

    npf_bf = BlockFile(pkg_files["NPF6"][0])
    nopts = npf_bf.options()
    schema.check_options("gwf-npf", nopts, pkg_files["NPF6"][0])
    schema.check_griddata("gwf-npf", npf_bf, pkg_files["NPF6"][0])
    icellavg = 0
    if "ALTERNATIVE_CELL_AVERAGING" in nopts:
        v = str(nopts["ALTERNATIVE_CELL_AVERAGING"]).upper()
        schema.check_valid_value("gwf-npf", "options",
                                 "ALTERNATIVE_CELL_AVERAGING", v,
                                 pkg_files["NPF6"][0])
        icellavg = {"LOGARITHMIC": 1, "AMT-LMK": 2, "AMT-HMK": 3}[v]
    rewetting = None
    if "REWET" in nopts:
        # REWET WETFCT <f> IWETIT <i> IHDWET <i> record (gwf-npf.dfn)
        v = nopts["REWET"]
        toks = [str(t).upper() for t in (v if isinstance(v, list) else [])]
        kv = {toks[i]: toks[i + 1] for i in range(0, len(toks) - 1, 2)}
        wetdry_arr = read_grid_array(npf_bf, "GRIDDATA", "WETDRY", shp,
                                     base, default=0.0)
        rewetting = dict(wetdry=np.asarray(wetdry_arr).reshape(-1),
                         wetfct=float(kv.get("WETFCT", 1.0)),
                         iwetit=int(kv.get("IWETIT", 1)),
                         ihdwet=int(kv.get("IHDWET", 0)))
    nc_npf = (nc_in, "npf") if nc_in else None
    icelltype = read_grid_array(npf_bf, "GRIDDATA", "ICELLTYPE", shp, base,
                                dtype=np.int64, default=0, nc=nc_npf)
    k = read_grid_array(npf_bf, "GRIDDATA", "K", shp, base, default=1.0,
                        nc=nc_npf)
    k22 = read_grid_array(npf_bf, "GRIDDATA", "K22", shp, base, nc=nc_npf)
    k33 = read_grid_array(npf_bf, "GRIDDATA", "K33", shp, base, nc=nc_npf)
    if k33 is not None and "K33OVERK" in nopts:
        k33 = k33 * k
    if k22 is not None and "K22OVERK" in nopts:
        k22 = k22 * k

    def _load_tv(bfopts, key):
        """TVK6/TVS6 FILEIN subpackage → {kper: [(node, PROP, value)]}
        (gwf-tvk.f90 / gwf-tvs.f90 period blocks)."""
        v = bfopts.get(key)
        if not (isinstance(v, list) and v[0].upper() == "FILEIN"):
            return {}
        tv_bf = BlockFile(os.path.join(mdir, v[1]))
        out = {}
        for b in tv_bf.get_all("PERIOD"):
            entries = []
            for toks in tv_bf.expand_open_close(b):
                node, ntok = _cellid_to_node(toks, grid)
                entries.append((node, toks[ntok].upper(),
                                float(toks[ntok + 1])))
            out[b.index] = entries
        return out

    tvk = _load_tv(nopts, "TVK6")

    storage = None
    sto_periods = {}
    tvs = {}
    if "STO6" in pkg_files:
        sto_bf = BlockFile(pkg_files["STO6"][0])
        sopts = sto_bf.options()
        schema.check_options("gwf-sto", sopts, pkg_files["STO6"][0])
        schema.check_griddata("gwf-sto", sto_bf, pkg_files["STO6"][0])
        storage = dict(
            iconvert=read_grid_array(sto_bf, "GRIDDATA", "ICONVERT", shp,
                                     base, dtype=np.int64, default=0).reshape(-1),
            ss=read_grid_array(sto_bf, "GRIDDATA", "SS", shp, base,
                               default=0.0).reshape(-1),
            sy=read_grid_array(sto_bf, "GRIDDATA", "SY", shp, base,
                               default=0.0).reshape(-1),
            istor_coef=1 if "STORAGECOEFFICIENT" in sopts else 0,
            iconf_ss=1 if "SS_CONFINED_ONLY" in sopts else 0)
        for b in sto_bf.get_all("PERIOD"):
            kw = b.lines[0][0].upper() if b.lines else "TRANSIENT"
            sto_periods[b.index] = (kw == "TRANSIENT")
        tvs = _load_tv(sopts, "TVS6")

    # --- stress packages with period data
    pkg_periods = {}   # attr -> {kper: entries}
    pkg_opts = {}
    pkg_aux = {}       # attr -> {kper: {AUXNAME: [values]}}
    ts_bindings = []   # (attr, kper, row, col, TimeSeries)
    bname_rows = {}    # BOUNDNAME -> (PKG, row) for observation IDs
    # --- array-based recharge (gwf-rcha.dfn READASARRAYS) with optional
    # TAS6 time-array series (utl-tas.dfn)
    rcha = None
    tas_binding = None
    if "RCH6" in pkg_files:
        rch_bf = BlockFile(pkg_files["RCH6"][0])
        ropts = rch_bf.options()
        if "READASARRAYS" in ropts:
            ncpl = int(np.prod(shp[1:])) if len(shp) == 3 else \
                (shp[1] if len(shp) == 2 else N)
            shp2 = shp[1:] if len(shp) > 1 else shp
            pb = rch_bf.get("PERIOD", 1)
            if pb is None or not pb.lines:
                raise NotImplementedError("RCHA needs a PERIOD 1 block")
            head_toks = pb.lines[0]
            if head_toks[0].upper() != "RECHARGE":
                raise NotImplementedError(
                    f"RCHA period variable {head_toks[0]} not supported")
            if len(head_toks) > 2 \
                    and head_toks[1].upper() == "TIMEARRAYSERIES":
                from ..timeseries import load_tas
                v = ropts.get("TAS6")
                if not (isinstance(v, list)
                        and v[0].upper() == "FILEIN"):
                    raise ValueError("TIMEARRAYSERIES without TAS6 FILEIN")
                tas_binding = load_tas(os.path.join(mdir, v[1]), shp2,
                                       mdir)
                rcha = np.zeros(ncpl)
            else:
                rcha = np.asarray(read_grid_array(
                    rch_bf, "PERIOD", "RECHARGE", shp2, mdir)).reshape(-1)
            del pkg_files["RCH6"]

    for ftype, (attr, ncols, mk) in _LIST_PACKAGES.items():
        if ftype not in pkg_files:
            continue
        all_periods = {}
        all_aux = {}
        for path in pkg_files[ftype]:   # multiple instances merge
            nc = ncols
            if ftype == "EVT6":
                # segmented ET: extra pxdp/petm columns (gwf-evt.dfn NSEG)
                nseg = BlockFile(path).dimensions().get("NSEG", 1)
                nc = 3 + 2 * (nseg - 1)
            opts, dims, periods, auxp, ts_refs, bnp = \
                _load_period_lists(
                path, grid, nc, None,
                component="gwf-" + ftype[:-1].lower())
            pkg_opts[attr] = opts
            # boundname → (attr, row) map for the obs ID processor
            for kper_b, names in bnp.items():
                if kper_b != 1:
                    continue
                for row, nm in enumerate(names):
                    if nm:
                        bname_rows[nm] = (attr.upper(), row)
            if ts_refs:
                from ..timeseries import load_ts6
                v = opts.get("TS6")
                if not (isinstance(v, list) and v[0].upper() == "FILEIN"):
                    raise ValueError(
                        f"{path}: time-series value names need a "
                        "TS6 FILEIN option")
                series = load_ts6(os.path.join(mdir, v[1]))
                for kper, row, col, nm in ts_refs:
                    if nm not in series:
                        raise ValueError(
                            f"{path}: unknown time series {nm}")
                    ts_bindings.append((attr, kper, row, col, series[nm]))
            for kper, entries in periods.items():
                all_periods.setdefault(kper, []).extend(entries)
            for kper, av in auxp.items():
                tgt = all_aux.setdefault(kper, {})
                for a, vals in av.items():
                    tgt.setdefault(a, []).extend(vals)
        pkg_periods[attr] = all_periods
        pkg_aux[attr] = all_aux

    # maxbound across periods per package (static shapes)
    first_pkgs = {}
    maxbound = {}
    for attr, periods in pkg_periods.items():
        mb = max((len(v) for v in periods.values()), default=1)
        maxbound[attr] = mb
        mk = {a: f for _, (a, _, f) in _LIST_PACKAGES.items()}[attr]
        # period-1 state: empty (all-masked) unless the package defines
        # PERIOD 1 — later periods activate via period_data
        first_pkgs[attr] = mk(periods.get(1, []), maxbound=mb)

    wel_afr = None
    if "wel" in pkg_opts and "AUTO_FLOW_REDUCE" in pkg_opts["wel"]:
        wel_afr = float(pkg_opts["wel"]["AUTO_FLOW_REDUCE"])

    model = builder.build_gwf(
        mname, grid,
        icelltype=icelltype.reshape(-1), k=k.reshape(-1),
        k22=k22.reshape(-1) if k22 is not None else None,
        k33=k33.reshape(-1) if k33 is not None else None,
        strt=strt.reshape(-1), newton=newton,
        icellavg=icellavg,
        ivarcv=1 if "VARIABLECV" in nopts else 0,
        idewatcv=1 if (isinstance(nopts.get("VARIABLECV"), (list, str))
                       and "DEWATERED" in str(nopts["VARIABLECV"]).upper())
        else 0,
        iperched=1 if "PERCHED" in nopts else 0,
        thickstrt="THICKSTRT" in nopts,
        storage=storage,
        wel_auto_flow_reduce=wel_afr,
        rewetting=rewetting)

    # attach first-period package data
    for attr, data in first_pkgs.items():
        setattr(model, attr, data)
    if rcha is not None:
        model.rch = builder.rch_data(list(enumerate(rcha.tolist())))
        # carry the array recharge through the period-data persistence
        first_pkgs["rch"] = model.rch

    # --- BUY buoyancy package (gwf-buy.dfn): DENSEREF + per-species
    # packagedata (irhospec modelname auxspeciesname drhodc crhoref)
    buy = None
    if "BUY6" in pkg_files:
        buy_bf = BlockFile(pkg_files["BUY6"][0])
        bopts = buy_bf.options()
        schema.check_options("gwf-buy", bopts, pkg_files["BUY6"][0])
        drho, cref = [], []
        pd = buy_bf.get("PACKAGEDATA")
        if pd is not None:
            for toks in pd.lines:
                drho.append(float(toks[3]))
                cref.append(float(toks[4]))
        buy = dict(denseref=float(bopts.get("DENSEREF", 1000.0)),
                   drhodc=drho or [0.7], crhoref=cref or [0.0],
                   iform=1 if "HHFORMULATION_RHS" in bopts else 2)
        model.buy = make_buy(**buy)

    # --- advanced packages (MAW/LAK/SFR/UZF/CSUB decks) + MVR movers
    from . import advanced_loader as adv_ld

    def cellid(toks, start):
        return _cellid_to_node(toks, grid, start=start)

    uzf_entries = None
    adv = {}
    adv_periods = {}     # kper -> {pkg: period lines} for kper > 1

    def _merge_periods(pkg, periods):
        for kper, lines in periods.items():
            adv_periods.setdefault(kper, {})[pkg] = lines

    if "MAW6" in pkg_files:
        adv["maw"], p = adv_ld.load_maw(pkg_files["MAW6"][0], grid, cellid)
        _merge_periods("maw", p)
    if "LAK6" in pkg_files:
        adv["lak"], p = adv_ld.load_lak(pkg_files["LAK6"][0], grid, cellid,
                                        mdir)
        _merge_periods("lak", p)
    if "SFR6" in pkg_files:
        adv["sfr"], p = adv_ld.load_sfr(pkg_files["SFR6"][0], grid, cellid)
        _merge_periods("sfr", p)
    if "UZF6" in pkg_files:
        cols_, flags_, p = adv_ld.load_uzf(pkg_files["UZF6"][0], grid,
                                           cellid)
        uzf_entries = (cols_, flags_)
        _merge_periods("uzf", p)
    if "CSUB6" in pkg_files:
        kwc = adv_ld.load_csub(pkg_files["CSUB6"][0], grid, cellid, shp,
                               base, read_grid_array)
        from ...models.gwf.csub import make_csub
        cdata, cstate = make_csub(grid, strt=np.asarray(model.strt), **kwc)
        model.csub = cdata
        model.csub_state0 = cstate
    movers = None
    if "MVR6" in pkg_files:
        movers, p = adv_ld.load_mvr(pkg_files["MVR6"][0], pkg_name_kind)
        _merge_periods("mvr", p)
    base_model = model
    if adv or movers:
        from ...models.gwf.advanced import (AugmentedGwfModel, build_lak,
                                            build_maw, build_sfr)
        model = AugmentedGwfModel(
            model,
            maw=build_maw(adv["maw"], grid,
                          k11=base_model.npf_arrays.k11,
                          k22=base_model.npf_arrays.k22)
            if "maw" in adv else None,
            lak=build_lak(*adv["lak"]) if "lak" in adv else None,
            sfr=build_sfr(adv["sfr"]) if "sfr" in adv else None,
            mvr=movers)

    # --- OC output files + period selection
    oc = None
    if "OC6" in pkg_files:
        h, c, oc = load_oc(pkg_files["OC6"][0], mdir)
        hds_path = hds_path or h
        cbc_path = cbc_path or c

    # --- OBS6 continuous observations (utl-obs.dfn files)
    obs = None
    if "OBS6" in pkg_files:
        from ..obs import ObsGroup, load_obs6
        groups = [load_obs6(p, cellid, mdir, bname_rows=bname_rows)
                  for p in pkg_files["OBS6"]]
        obs = ObsGroup([m for g in groups for m in g.managers])

    return dict(name=mname, model=model, base_model=base_model, grid=grid,
                ts_bindings=ts_bindings,
                storage=storage,
                uzf_entries=uzf_entries, obs=obs, tas=tas_binding,
                adv_specs=dict(adv, movers=movers,
                               mvr_kinds=pkg_name_kind),
                adv_periods=adv_periods, nc_out=nc_out,
                sto_periods=sto_periods, pkg_periods=pkg_periods,
                pkg_aux=pkg_aux, maxbound=maxbound, first_pkgs=first_pkgs,
                hds_path=hds_path, cbc_path=cbc_path, oc=oc,
                tvk=tvk, tvs=tvs)


def _build_uzf(bundle):
    """UZF columns from the loaded entries (gwf-uzf.f90 node geometry:
    landflag cells measure from land surface minus surfdep)."""
    from ...models.gwf.uzf import make_uzf
    cols, uzflags = bundle["uzf_entries"]
    grid = bundle["grid"]
    gtop = np.asarray(grid.top).reshape(-1)
    gbot = np.asarray(grid.bot).reshape(-1)
    garea = np.asarray(grid.area).reshape(-1)
    ent = []
    for c in cols:
        n = c["node"]
        top = gtop[n] - (c["surfdep"] if c.get("landflag") else 0.0)
        ent.append(dict(node=n, vks=c["vks"], thtr=c["thtr"],
                        thts=c["thts"], thti=c["thti"], eps=c["eps"],
                        celtop=float(top), celbot=float(gbot[n]),
                        surfdep=c["surfdep"], area=float(garea[n]),
                        finf=c["finf"], pet=c["pet"],
                        extdp=c["extdp"], extwc=c["extwc"]))
    return make_uzf(ent, **uzflags)


def _attach_advanced_periods(simulation, bundle):
    """Transient advanced-package PERIOD blocks: apply each block's
    settings at the period boundary and rebuild the augmented model
    (the reference re-reads period data in <pkg>_rp each period;
    values persist until redefined).  Feature sets are static
    (PACKAGEDATA), so the augmented row layout — and the state vector —
    is unchanged; rebuilding retriggers one jit trace per changed
    period."""
    from . import advanced_loader as adv_ld

    specs = bundle["adv_specs"]
    periods = bundle["adv_periods"]
    grid = bundle["grid"]

    def hook(kper):
        ch = periods.get(kper)
        if not ch:
            return
        if "maw" in ch:
            adv_ld.apply_maw_period(specs["maw"], ch["maw"])
        if "lak" in ch:
            adv_ld.apply_lak_period(*specs["lak"], ch["lak"])
        if "sfr" in ch:
            adv_ld.apply_sfr_period(specs["sfr"], ch["sfr"])
        if "mvr" in ch:
            specs["movers"] = adv_ld.parse_mvr_period(
                ch["mvr"], specs["mvr_kinds"])
        if "uzf" in ch:
            cols, _ = bundle["uzf_entries"]
            adv_ld.apply_uzf_period({c["iuzno"]: c for c in cols},
                                    ch["uzf"])
            simulation.uzf = _build_uzf(bundle)
            # theta/water-table state persists across the rebuild
        if any(k in ch for k in ("maw", "lak", "sfr", "mvr")):
            from ...models.gwf.advanced import (AugmentedGwfModel,
                                                build_lak, build_maw,
                                                build_sfr)
            from ...solution.ims import NumericalSolution
            base = getattr(simulation.model, "base", simulation.model)
            model = AugmentedGwfModel(
                base,
                maw=build_maw(specs["maw"], grid) if "maw" in specs
                else None,
                lak=build_lak(*specs["lak"]) if "lak" in specs else None,
                sfr=build_sfr(specs["sfr"]) if "sfr" in specs else None,
                mvr=specs.get("movers"))
            simulation.model = model
            simulation.solution = NumericalSolution(model,
                                                    simulation.solution.s)

    simulation.period_hooks.append(hook)


def _merge_augmented(bundles, exchanges, exg_mvr_files, merge_gwf_models):
    """Multi-model composite WITH advanced packages and exchange movers.

    The reference distributes advanced packages per model and routes
    cross-model mover water through GwfExchangeMover.f90; in the merged-
    composite design the union model carries ALL models' feature rows
    (node indices shifted), so an exchange mover is an ordinary mover
    over the combined feature numbering."""
    from ...models.gwf.advanced import (AugmentedGwfModel, build_lak,
                                        build_maw, build_sfr)
    from . import advanced_loader as adv_ld

    for b in bundles:
        if b.get("uzf_entries") or getattr(b["base_model"], "csub", None) \
                is not None:
            raise NotImplementedError(
                "UZF/CSUB in multi-model composites not supported yet")
    base = merge_gwf_models([b["base_model"] for b in bundles], exchanges)
    offsets = list(base._offsets)

    maw_wells = []
    lak_lakes, lak_outlets = [], []
    sfr_reaches = []
    # per-model feature index offsets (provider lak entry space = outlets)
    koff = []
    for b, off in zip(bundles, offsets):
        specs = b["adv_specs"]
        koff.append(dict(maw=len(maw_wells), lak=len(lak_lakes),
                         lak_out=len(lak_outlets),
                         sfr=len(sfr_reaches)))
        if specs.get("maw"):
            for w in specs["maw"]:
                w = dict(w)
                w["connections"] = [(int(n) + off, *rest)
                                    for n, *rest in w["connections"]]
                maw_wells.append(w)
        if specs.get("lak"):
            lakes, outlets = specs["lak"]
            nl0 = koff[-1]["lak"]
            for lk in lakes:
                lk = dict(lk)
                lk["connections"] = [(int(c[0]) + off, *c[1:])
                                     for c in lk["connections"]]
                lak_lakes.append(lk)
            for o in outlets:
                o = dict(o)
                o["lake"] += nl0
                if o.get("to", -1) >= 0:
                    o["to"] += nl0
                lak_outlets.append(o)
        if specs.get("sfr"):
            r0 = koff[-1]["sfr"]
            for r in specs["sfr"]:
                r = dict(r)
                r["node"] = int(r["node"]) + off
                r["upstream"] = [(u + r0, f) for u, f in r["upstream"]]
                r["diversions"] = [dict(d, to=d["to"] + r0)
                                   for d in r["diversions"]]
                sfr_reaches.append(r)

    movers = []
    for mi, b in enumerate(bundles):
        for mv in (b["adv_specs"].get("movers") or []):
            mv = dict(mv)
            pk, rk = mv["provider"], mv["receiver"]
            if pk in ("wel", "drn", "riv", "ghb") and mi != 0:
                raise NotImplementedError(
                    "standard-package mover providers outside the first "
                    "model are not supported in merged composites (entry "
                    "offsets are period-dependent)")
            if pk == "lak":
                mv["iprov"] += koff[mi]["lak_out"]
            elif pk in koff[mi]:
                mv["iprov"] += koff[mi][pk]
            if rk in koff[mi]:
                mv["ircv"] += koff[mi][rk]
            movers.append(mv)

    name_idx = {b["name"].upper(): i for i, b in enumerate(bundles)}
    for path in exg_mvr_files:
        def kind_of(mname, pname):
            b = bundles[name_idx[mname]]
            return b["adv_specs"]["mvr_kinds"][pname]

        for mv in adv_ld.load_exchange_mvr(path, kind_of):
            pm = name_idx[mv.pop("prov_model")]
            rm = name_idx[mv.pop("recv_model")]
            pk, rk = mv["provider"], mv["receiver"]
            if pk in ("wel", "drn", "riv", "ghb") and pm != 0:
                raise NotImplementedError(
                    "standard-package exchange-mover providers outside "
                    "the first model are not supported yet")
            if pk == "lak":
                mv["iprov"] += koff[pm]["lak_out"]
            elif pk in koff[pm]:
                mv["iprov"] += koff[pm][pk]
            if rk in koff[rm]:
                mv["ircv"] += koff[rm][rk]
            movers.append(mv)

    import types as _types
    import jax.numpy as _jnp
    grid_shim = _types.SimpleNamespace(
        top=np.asarray(base.npf_arrays.top),
        bot=np.asarray(base.npf_arrays.bot),
        area=np.asarray(_jnp.asarray(base.grid.area)).reshape(-1))
    return AugmentedGwfModel(
        base,
        maw=build_maw(maw_wells, grid_shim) if maw_wells else None,
        lak=build_lak(lak_lakes, lak_outlets) if lak_lakes else None,
        sfr=build_sfr(sfr_reaches) if sfr_reaches else None,
        mvr=movers or None)


# list-package value-column field names per attr (ts per-entry binding)
_TS_FIELDS = dict(chd=["head"], wel=["q"], drn=["elev", "cond"],
                  riv=["stage", "cond", "rbot"], ghb=["bhead", "cond"],
                  rch=["recharge"], evt=["surface", "rate", "depth"])


def _attach_ts_bindings(simulation, bundle):
    """Per-step TS6 value refresh (TsManager ad role): entries whose deck
    value was a series NAME get the step-averaged series value written
    into the packed package arrays before every step."""
    import dataclasses as dc

    bindings = bundle["ts_bindings"]
    pkg_periods = bundle["pkg_periods"]

    def hook(kper, kstp, delt):
        t0 = simulation.records[-1].totim if simulation.records else 0.0
        for attr, bkper, row, col, series in bindings:
            redef = sorted(k for k in pkg_periods[attr] if k > bkper)
            hi = redef[0] if redef else 10 ** 9
            if not (bkper <= kper < hi):
                continue
            v = series.step_value(t0, t0 + delt)
            field = _TS_FIELDS[attr][col]
            for k in list(simulation.period_data):
                if not (bkper <= k < hi):
                    continue
                pd = simulation.period_data[k]
                pkg = getattr(pd, attr)
                if pkg is None:
                    continue
                arr = getattr(pkg, field).at[row].set(v)
                simulation.period_data[k] = dc.replace(
                    pd, **{attr: dc.replace(pkg, **{field: arr})})

    simulation.step_hooks.append(hook)


def _transient_flags(tdis, storage, sto_periods):
    """Per-period steady/transient flags with MF6 persistence (initial
    default steady if STO absent, first STO period setting otherwise)."""
    transient = []
    cur = storage is not None
    if sto_periods:
        cur = sto_periods.get(min(sto_periods), cur)
    for kper in range(1, tdis.nper + 1):
        if kper in sto_periods:
            cur = sto_periods[kper]
        transient.append(cur)
    return transient


def _attach_period_data(simulation, pkg_periods, maxbound, first_pkgs,
                        offset=0):
    """Fill simulation.period_data with MF6 persistence semantics."""
    all_kpers = sorted({kp for periods in pkg_periods.values()
                        for kp in periods})
    if not all_kpers:
        return
    mkmap = {a: f for _, (a, _, f) in _LIST_PACKAGES.items()}
    current = dict(first_pkgs)
    for kper in all_kpers:
        for attr, periods in pkg_periods.items():
            if kper in periods:
                entries = [(n + offset, *vals) for n, *vals in periods[kper]]
                current[attr] = mkmap[attr](entries, maxbound=maxbound[attr])
        simulation.period_data[kper] = PackageData(**{
            a: current.get(a) for a in
            ("chd", "wel", "rch", "drn", "riv", "ghb", "evt")})


def _merge_period_data(simulation, bundles, offsets):
    """Multi-model composite: merge per-model period data, node indices
    shifted into the composite numbering."""
    from ...models.gwf.exchange import _concat_pkg
    from ...models.gwf import bnd
    all_kpers = sorted({kp for b in bundles
                        for periods in b["pkg_periods"].values()
                        for kp in periods})
    if not all_kpers:
        return
    mkmap = {a: f for _, (a, _, f) in _LIST_PACKAGES.items()}
    clsmap = dict(chd=bnd.ChdData, wel=bnd.WelData, rch=bnd.RchData,
                  drn=bnd.DrnData, riv=bnd.RivData, ghb=bnd.GhbData,
                  evt=bnd.EvtData)
    current = [dict(b["first_pkgs"]) for b in bundles]
    for kper in all_kpers:
        for mi, b in enumerate(bundles):
            for attr, periods in b["pkg_periods"].items():
                if kper in periods:
                    current[mi][attr] = mkmap[attr](
                        periods[kper], maxbound=b["maxbound"][attr])
        merged = {}
        for attr, cls in clsmap.items():
            datas = [cur.get(attr) for cur in current]
            merged[attr] = _concat_pkg(cls, datas, offsets)
        simulation.period_data[kper] = PackageData(**merged)


def _load_gwt_model(ws, mfname, mname):
    """Load one GWT model nam file + packages (IC/ADV/DSP/MST/SSM/CNC/SRC).

    Parity target: gwt.f90 package set + SimulationCreate; SSM sources are
    supported for srctype AUX with period-1 aux concentrations."""
    from ...models.gwt import builder as gwt_builder

    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    pkg_files = {}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        pkg_files.setdefault(ftype, []).append(os.path.join(mdir, toks[1]))

    grid = _load_grid(pkg_files)
    shp = grid.shape
    base = mdir
    N = grid.nodes

    ic_bf = BlockFile(pkg_files["IC6"][0])
    strt = read_grid_array(ic_bf, "GRIDDATA", "STRT", shp, base, default=0.0)

    scheme = "upstream"
    if "ADV6" in pkg_files:
        aopts = BlockFile(pkg_files["ADV6"][0]).options()
        schema.check_options("gwt-adv", aopts, pkg_files["ADV6"][0])
        scheme = str(aopts.get("SCHEME", "upstream")).lower()

    dsp = None
    if "DSP6" in pkg_files:
        dsp_bf = BlockFile(pkg_files["DSP6"][0])
        dsp = {}
        for key in ("ALH", "ALV", "ATH1", "ATH2", "ATV", "DIFFC"):
            arr = read_grid_array(dsp_bf, "GRIDDATA", key, shp, base)
            if arr is not None:
                dsp[key.lower()] = arr.reshape(-1)

    porosity, decay, sorption = 0.3, None, None
    if "MST6" in pkg_files:
        mst_bf = BlockFile(pkg_files["MST6"][0])
        mopts = mst_bf.options()
        schema.check_options("gwt-mst", mopts, pkg_files["MST6"][0])
        schema.check_griddata("gwt-mst", mst_bf, pkg_files["MST6"][0])
        porosity = read_grid_array(mst_bf, "GRIDDATA", "POROSITY", shp, base,
                                   default=0.3).reshape(-1)
        decay_arr = read_grid_array(mst_bf, "GRIDDATA", "DECAY", shp, base)
        if decay_arr is not None:
            idcy = 2 if "ZERO_ORDER_DECAY" in mopts else 1
            decay = (idcy, decay_arr.reshape(-1))
        sorb = mopts.get("SORPTION")
        if sorb:
            from ...models.gwt import mst as mst_mod
            kind = {"LINEAR": mst_mod.SORPTION_LINEAR,
                    "FREUNDLICH": mst_mod.SORPTION_FREUNDLICH,
                    "LANGMUIR": mst_mod.SORPTION_LANGMUIR}[str(sorb).upper()]
            bd = read_grid_array(mst_bf, "GRIDDATA", "BULK_DENSITY", shp,
                                 base, default=0.0)
            kd = read_grid_array(mst_bf, "GRIDDATA", "DISTCOEF", shp, base,
                                 default=0.0)
            sp2 = read_grid_array(mst_bf, "GRIDDATA", "SP2", shp, base,
                                  default=0.0)
            sorption = dict(isrb=kind, bulk_density=bd.reshape(-1),
                            distcoef=kd.reshape(-1), sp2=sp2.reshape(-1))

    cnc = src = None
    if "CNC6" in pkg_files:
        _, _, periods, _, _, _ = _load_period_lists(pkg_files["CNC6"][0], grid,
                                              1, None)
        cnc = periods.get(1, [])
    if "SRC6" in pkg_files:
        _, _, periods, _, _, _ = _load_period_lists(pkg_files["SRC6"][0], grid,
                                              1, None)
        src = periods.get(1, [])

    # SSM: sources block pname/srctype/auxname → {gwf pkg attr: auxname}
    ssm_sources = []
    if "SSM6" in pkg_files:
        ssm_bf = BlockFile(pkg_files["SSM6"][0])
        b = ssm_bf.get("SOURCES")
        if b is not None:
            for toks in b.lines:
                ssm_sources.append((toks[0].upper(), toks[1].upper(),
                                    toks[2].upper() if len(toks) > 2 else None))

    hds_path = cbc_path = None
    oc = None
    if "OC6" in pkg_files:
        hds_path, cbc_path, oc = load_oc(pkg_files["OC6"][0], mdir,
                                         component="gwt-oc")

    # APT advanced-transport package files (gwt-lkt/sft/mwt/uzt.dfn)
    from . import advanced_loader as adv_ld
    apt = {}
    for ftype, kind, comp in (("LKT6", "lak", "gwt-lkt"),
                              ("SFT6", "sfr", "gwt-sft"),
                              ("MWT6", "maw", "gwt-mwt"),
                              ("UZT6", "uzf", "gwt-uzt")):
        if ftype in pkg_files:
            apt[kind] = adv_ld.load_apt(pkg_files[ftype][0], comp)

    model = gwt_builder.build_gwt(
        mname, grid, porosity=porosity, strt=strt.reshape(-1),
        scheme=scheme, decay=decay, sorption=sorption,
        cnc=cnc, src=src, dsp=dsp)
    return dict(name=mname, model=model, grid=grid, ssm_sources=ssm_sources,
                apt=apt, hds_path=hds_path, oc=oc)


def _load_gwe_model(ws, mfname, mname):
    """Load one GWE model nam file + packages (IC/ADV/CND/EST/SSM/CTP/ESL).

    Parity target: gwe.f90 package set via SimulationCreate
    (src/SimulationCreate.f90:200-349 gwe_cr) and the gwe-est/gwe-cnd/
    gwe-ctp/gwe-esl dfn block formats."""
    from ...models.gwe import builder as gwe_builder

    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    mopts = mnam.options()
    schema.check_options("gwe-nam", mopts, mfname)
    pkg_files = {}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        pkg_files.setdefault(ftype, []).append(os.path.join(mdir, toks[1]))

    grid = _load_grid(pkg_files)
    shp = grid.shape
    base = mdir
    N = grid.nodes

    ic_bf = BlockFile(pkg_files["IC6"][0])
    strt = read_grid_array(ic_bf, "GRIDDATA", "STRT", shp, base, default=0.0)

    scheme = "upstream"
    if "ADV6" in pkg_files:
        aopts = BlockFile(pkg_files["ADV6"][0]).options()
        schema.check_options("gwe-adv", aopts, pkg_files["ADV6"][0])
        scheme = str(aopts.get("SCHEME", "upstream")).lower()

    # EST: energy storage (gwe-est.dfn options + griddata)
    kw = dict(porosity=0.3)
    decay = None
    if "EST6" in pkg_files:
        est_bf = BlockFile(pkg_files["EST6"][0])
        eopts = est_bf.options()
        schema.check_options("gwe-est", eopts, pkg_files["EST6"][0])
        schema.check_griddata("gwe-est", est_bf, pkg_files["EST6"][0])
        kw["porosity"] = read_grid_array(est_bf, "GRIDDATA", "POROSITY",
                                         shp, base, default=0.3).reshape(-1)
        kw["rhow"] = float(eopts.get("DENSITY_WATER", 1000.0))
        kw["cpw"] = float(eopts.get("HEAT_CAPACITY_WATER", 4184.0))
        kw["latheatvap"] = float(eopts.get("LATENT_HEAT_VAPORIZATION", 0.0))
        rhos = read_grid_array(est_bf, "GRIDDATA", "DENSITY_SOLID", shp,
                               base, default=2650.0)
        cps = read_grid_array(est_bf, "GRIDDATA", "HEAT_CAPACITY_SOLID",
                              shp, base, default=800.0)
        kw["rhos"] = rhos.reshape(-1)
        kw["cps"] = cps.reshape(-1)
        dw = ("ZERO_ORDER_DECAY_WATER" in eopts)
        ds = ("ZERO_ORDER_DECAY_SOLID" in eopts)
        if dw or ds:
            from ...models.gwe import est as est_mod
            idcysrc = (est_mod.DECAY_BOTH if dw and ds
                       else est_mod.DECAY_WATER if dw
                       else est_mod.DECAY_SOLID)
            rw = read_grid_array(est_bf, "GRIDDATA", "DECAY_WATER", shp,
                                 base, default=0.0).reshape(-1)
            rs = read_grid_array(est_bf, "GRIDDATA", "DECAY_SOLID", shp,
                                 base, default=0.0).reshape(-1)
            decay = (idcysrc, rw, rs)

    # CND: conduction + thermal dispersion (gwe-cnd.dfn griddata)
    cnd = None
    if "CND6" in pkg_files:
        cnd_bf = BlockFile(pkg_files["CND6"][0])
        schema.check_options("gwe-cnd", cnd_bf.options(),
                             pkg_files["CND6"][0])
        cnd = {}
        for key in ("ALH", "ALV", "ATH1", "ATH2", "ATV", "KTW", "KTS"):
            arr = read_grid_array(cnd_bf, "GRIDDATA", key, shp, base)
            if arr is not None:
                cnd[key.lower()] = arr.reshape(-1)

    ctp = esl = None
    if "CTP6" in pkg_files:
        _, _, periods, _, _, _ = _load_period_lists(pkg_files["CTP6"][0], grid,
                                              1, None, component="gwe-ctp")
        ctp = periods.get(1, [])
    if "ESL6" in pkg_files:
        _, _, periods, _, _, _ = _load_period_lists(pkg_files["ESL6"][0], grid,
                                              1, None, component="gwe-esl")
        esl = periods.get(1, [])

    ssm_sources = []
    if "SSM6" in pkg_files:
        ssm_bf = BlockFile(pkg_files["SSM6"][0])
        b = ssm_bf.get("SOURCES")
        if b is not None:
            for toks in b.lines:
                ssm_sources.append((toks[0].upper(), toks[1].upper(),
                                    toks[2].upper() if len(toks) > 2
                                    else None))

    hds_path = oc = None
    if "OC6" in pkg_files:
        hds_path, _, oc = load_oc(pkg_files["OC6"][0], mdir,
                                  component="gwe-oc")

    # GWE energy-transport analogs of the APT files (gwe-lke/sfe/mwe/uze)
    from . import advanced_loader as adv_ld
    apt = {}
    for ftype, kind, comp in (("LKE6", "lak", "gwe-lke"),
                              ("SFE6", "sfr", "gwe-sfe"),
                              ("MWE6", "maw", "gwe-mwe"),
                              ("UZE6", "uzf", "gwe-uze")):
        if ftype in pkg_files:
            apt[kind] = adv_ld.load_apt(pkg_files[ftype][0], comp)

    model = gwe_builder.build_gwe(
        mname, grid, strt=strt.reshape(-1), scheme=scheme, decay=decay,
        cnd=cnd, ctp=ctp, esl=esl, **kw)
    return dict(name=mname, model=model, grid=grid,
                ssm_sources=ssm_sources, apt=apt, hds_path=hds_path,
                oc=oc)


def _load_prt_model(ws, mfname, mname, gwf_model, gwf_grid):
    """Load one PRT model nam file (DIS/MIP/PRP/OC) → PrtDriver.

    Parity target: prt.f90 package set (prt-mip.dfn griddata, prt-prp.dfn
    packagedata/releasetimes/period blocks, TRACK/TRACKCSV filerecords).
    The PRT grid must match the flow model's grid (the reference couples
    them 1:1 through exg-gwfprt/FMI)."""
    from ...models.prt.model import PrtModel, ReleasePoints
    from ...models.prt.simulation import PrtDriver
    from ...models.prt.trackfile import ReleaseSchedule

    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    mopts = mnam.options()
    schema.check_options("prt-nam", mopts, mfname)
    pkg_files = {}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        pkg_files.setdefault(ftype, []).append(os.path.join(mdir, toks[1]))

    grid = _load_grid(pkg_files)
    if grid.nodes != gwf_grid.nodes:
        raise ValueError("PRT grid does not match the GWF grid")
    shp = grid.shape
    porosity = np.full(grid.nodes, 0.3)
    izone = None
    if "MIP6" in pkg_files:
        mip_bf = BlockFile(pkg_files["MIP6"][0])
        schema.check_options("prt-mip", mip_bf.options(),
                             pkg_files["MIP6"][0])
        porosity = read_grid_array(mip_bf, "GRIDDATA", "POROSITY", shp,
                                   mdir, default=0.3).reshape(-1)
        iz = read_grid_array(mip_bf, "GRIDDATA", "IZONE", shp, mdir,
                             dtype=np.int64)
        izone = iz.reshape(-1) if iz is not None else None

    prp_path = pkg_files.get("PRP6", [None])[0]
    if prp_path is None:
        raise NotImplementedError("PRT model requires a PRP6 package")
    prp_bf = BlockFile(prp_path)
    popts = prp_bf.options()
    schema.check_options("prt-prp", popts, prp_path)

    def _fileout(key):
        v = popts.get(key)
        if isinstance(v, list) and v[0].upper() == "FILEOUT":
            return os.path.join(mdir, v[1])
        return None

    local_z = "LOCAL_Z" in popts
    xs, ys, zs, cells = [], [], [], []
    for toks in prp_bf.get("PACKAGEDATA").lines:
        node, nt = _cellid_to_node(toks, grid, start=1)
        cells.append(node)
        xs.append(float(toks[1 + nt]))
        ys.append(float(toks[1 + nt + 1]))
        zs.append(float(toks[1 + nt + 2]))
    xs, ys, zs = np.asarray(xs), np.asarray(ys), np.asarray(zs)
    if local_z:
        # zrpt is a [0,1] fraction of the cell's saturated thickness
        # (prp "local_z"); convert with the static cell geometry
        gtop = np.asarray(gwf_grid.top).reshape(-1)[cells]
        gbot = np.asarray(gwf_grid.bot).reshape(-1)[cells]
        zs = gbot + zs * (gtop - gbot)

    times = []
    rt_b = prp_bf.get("RELEASETIMES")
    if rt_b is not None:
        times = [float(t[0]) for t in rt_b.lines]
    period_settings = {}
    for b in prp_bf.get_all("PERIOD"):
        settings = []
        for toks in b.lines:
            kw = toks[0].upper()
            if kw in ("ALL", "FIRST", "LAST"):
                settings.append((kw.lower(),))
            elif kw == "FREQUENCY":
                settings.append(("frequency", int(toks[1])))
            elif kw == "STEPS":
                settings.append(("steps", [int(t) for t in toks[1:]]))
            elif kw == "FRACTION":
                settings.append(("fraction", float(toks[1])))
            else:
                raise NotImplementedError(f"PRP release setting {kw}")
        period_settings[b.index] = settings

    prt = PrtModel(mname, gwf_grid, jnp_asarray_f64(porosity),
                   ReleasePoints(x=xs, y=ys, z=zs))
    stoptime = float(popts["STOPTIME"]) if "STOPTIME" in popts else np.inf
    return PrtDriver(
        model=prt, gwf_model=gwf_model,
        schedule=ReleaseSchedule(period_settings=period_settings,
                                 times=tuple(times)),
        track_path=_fileout("TRACK"), trackcsv_path=_fileout("TRACKCSV"),
        stoptime=stoptime,
        istopzone=int(popts.get("ISTOPZONE", 0) or 0), izone=izone)


def jnp_asarray_f64(a):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a, np.float64))


def _load_swf_simulation(ws, sim, tdis, entry):
    """One CHF6/OLF6 model (+ optional EMS/IMS) → SwfSimulation."""
    from .swf_loader import load_swf_model
    from ...models.swf.simulation import SwfSimulation

    mtype, mfname, mname = entry
    bundle = load_swf_model(ws, mfname, mname, mtype)
    settings = None
    for sg in sim.get_all("SOLUTIONGROUP"):
        for toks in sg.lines:
            if toks[0].upper() == "IMS6":
                s = load_ims(os.path.join(ws, toks[1]))
                # SWF stages need the DBD under-relaxation defaults when
                # the deck's IMS leaves them unset (swf IMS presets)
                if s.under_relaxation in (None, "none"):
                    s = dataclasses.replace(
                        s, under_relaxation="dbd", theta=0.9,
                        akappa=1e-4, gamma=0.0, amomentum=0.0,
                        no_ptc=True)
                settings = s
    return SwfSimulation(tdis, bundle["model"], settings,
                         sto_periods=bundle["sto_periods"],
                         has_sto=bundle["has_sto"],
                         hds_path=bundle["hds_path"], oc=bundle["oc"])


def load_simulation(workspace, hds_path=None, cbc_path=None, lst_path=None):
    """Load mfsim.nam and everything it references → Simulation.

    Parity target: the reference IDM load + SimulationCreate
    (SimulationCreate.f90:200-729).  Supported: any number of GWF6 models
    joined by GWF6-GWF6 exchanges (merged-composite coupling,
    models.gwf.exchange.merge_gwf_models), one optional GWT6 model coupled
    to the (first) GWF model via GWF6-GWT6, DIS/DISV/DISU grids,
    per-solution-group IMS settings, OC PERIOD save/print selection.
    """
    ws = os.path.abspath(workspace)
    sim = BlockFile(os.path.join(ws, "mfsim.nam"))

    # HPC partition spec (utl-hpc.dfn PARTITIONS block — the reference's
    # explicit model→rank load balance, DistributedSim.f90)
    hpc_partitions = None
    sopts = sim.options()
    v = sopts.get("HPC6")
    if isinstance(v, list) and v[0].upper() == "FILEIN":
        hbf = BlockFile(os.path.join(ws, v[1]))
        pb = hbf.get("PARTITIONS")
        if pb is not None:
            hpc_partitions = {t[0].upper(): int(t[1]) for t in pb.lines}

    # timing
    timing = sim.get("TIMING")
    tdis = load_tdis(os.path.join(ws, timing.lines[0][1]))

    # models
    models_blk = sim.get("MODELS")
    assert models_blk is not None and len(models_blk.lines) >= 1
    entries = []
    for i, toks in enumerate(models_blk.lines):
        mtype = toks[0].upper()
        mfname = toks[1]
        mname = toks[2].upper() if len(toks) > 2 else f"MODEL{i + 1}"
        if mtype not in ("GWF6", "GWT6", "GWE6", "PRT6", "CHF6", "OLF6"):
            raise NotImplementedError(f"model type {mtype} not yet loadable")
        entries.append((mtype, mfname, mname))
    gwf_entries = [e for e in entries if e[0] == "GWF6"]
    gwt_entries = [e for e in entries if e[0] in ("GWT6", "GWE6")]
    prt_entries = [e for e in entries if e[0] == "PRT6"]
    swf_entries = [e for e in entries if e[0] in ("CHF6", "OLF6")]
    if swf_entries:
        if gwf_entries or gwt_entries or len(swf_entries) > 1:
            raise NotImplementedError(
                "CHF/OLF decks load standalone (one SWF model per "
                "simulation); couple SWF-GWF programmatically via "
                "models.swf.exchange")
        return _load_swf_simulation(ws, sim, tdis, swf_entries[0])
    if len(gwt_entries) > 1:
        raise NotImplementedError("multiple GWT models not yet loadable")

    # exchanges
    exg_entries = []
    exg_blk = sim.get("EXCHANGES")
    if exg_blk is not None:
        for toks in exg_blk.lines:
            exg_entries.append((toks[0].upper(), toks[1], toks[2].upper(),
                                toks[3].upper()))

    # solution groups → per-model IMS settings (+ MXITER group Picard)
    sln_settings = {}       # model name -> ImsSettings
    default_settings = ImsSettings()
    sgp_mxiter = 1
    for sg in sim.get_all("SOLUTIONGROUP"):
        for toks in sg.lines:
            if toks[0].upper() == "MXITER":
                sgp_mxiter = int(toks[1])
            if toks[0].upper() == "IMS6":
                s = load_ims(os.path.join(ws, toks[1]))
                names = [t.upper() for t in toks[2:]]
                if not sln_settings:
                    default_settings = s
                for nm in names:
                    sln_settings[nm] = s

    # --- load GWF models
    bundles = [_load_gwf_model(ws, mfname, mname)
               for _, mfname, mname in gwf_entries]
    by_name = {b["name"].upper(): i for i, b in enumerate(bundles)}

    gwf_settings = sln_settings.get(bundles[0]["name"].upper(),
                                    default_settings)
    # SFR routing / LAK cascade / Newton Jacobians are asymmetric: CG
    # silently diverges there (the reference requires BICGSTAB for
    # asymmetric systems, imslinear); upgrade with a warning
    _needs_asym = any(
        b["adv_specs"].get("sfr") is not None
        or b["adv_specs"].get("lak") is not None
        or getattr(b["base_model"], "inewton", 0)
        for b in bundles)
    if _needs_asym and gwf_settings.linear_acceleration == "cg":
        import warnings

        warnings.warn(
            "deck requests CG but the system is asymmetric "
            "(SFR/LAK/Newton); using BICGSTAB", stacklevel=2)
        gwf_settings = dataclasses.replace(gwf_settings,
                                           linear_acceleration="bicgstab")

    if len(bundles) == 1:
        model = bundles[0]["model"]
        offsets = [0]
    else:
        from ...models.gwf.exchange import GwfGwfExchange, merge_gwf_models
        exchanges = []
        exg_mvr_files = []
        for etype, efile, m1, m2 in exg_entries:
            if etype != "GWF6-GWF6":
                continue
            i1, i2 = by_name[m1], by_name[m2]
            pairs, mvr_path = load_exchange_gwfgwf(
                os.path.join(ws, efile), bundles[i1]["grid"],
                bundles[i2]["grid"])
            if mvr_path:
                exg_mvr_files.append(mvr_path)
            exchanges.append(GwfGwfExchange(i1, i2, pairs))
        if not exchanges:
            raise NotImplementedError(
                "multiple GWF models require GWF6-GWF6 exchanges (separate "
                "uncoupled solutions are not supported yet)")
        any_adv = any(
            b["adv_specs"].get(k) is not None
            for b in bundles for k in ("maw", "lak", "sfr")) \
            or any(b["adv_specs"].get("movers") for b in bundles) \
            or exg_mvr_files
        if any_adv:
            model = _merge_augmented(bundles, exchanges, exg_mvr_files,
                                     merge_gwf_models)
            offsets = list(model.base._offsets)
        else:
            model = merge_gwf_models([b["model"] for b in bundles],
                                     exchanges)
            offsets = list(model._offsets)

    transient = _transient_flags(tdis, bundles[0]["storage"],
                                 bundles[0]["sto_periods"])

    # --- optional GWT/GWE transport model
    gwt_bundle = None
    gwt_kwargs = {}
    if gwt_entries:
        if len(bundles) > 1:
            raise NotImplementedError(
                "GWT coupling with multi-model GWF not yet supported")
        ttype, mfname, mname = gwt_entries[0]
        if ttype == "GWE6":
            gwt_bundle = _load_gwe_model(ws, mfname, mname)
        else:
            gwt_bundle = _load_gwt_model(ws, mfname, mname)
        gwtm = gwt_bundle["model"]
        # SSM AUX sources: map (gwf package, auxname) → period-1 aux concs
        ssm_spec = {}
        for pname, srctype, auxname in gwt_bundle["ssm_sources"]:
            if srctype not in ("AUX", "AUXMIXED"):
                raise NotImplementedError(f"SSM srctype {srctype}")
            attr = pname[:3].lower()
            auxp = bundles[0]["pkg_aux"].get(attr, {})
            vals = auxp.get(1, {}).get(auxname)
            if vals is None:
                raise ValueError(
                    f"SSM source {pname} references aux {auxname} but the "
                    f"{attr.upper()} package has no such period-1 column")
            mb = bundles[0]["maxbound"][attr]
            arr = np.zeros(mb)
            arr[:len(vals)] = vals
            # keys match boundary_budget's names (WEL/RCH/DRN/..., see
            # gwt.fmi.from_gwf_step)
            ssm_spec[attr.upper()] = arr
        gwtm.ssm_spec = ssm_spec or None

        # APT: feature-concentration rows riding the augmented GWF model
        apt_spec = gwt_bundle.get("apt") or {}
        apt_ext_conc = {}
        if apt_spec:
            import jax.numpy as jnp
            from ...models.gwf.advanced import AugmentedGwfModel
            from ...models.gwt.apt import AugmentedGwtModel
            if not isinstance(model, AugmentedGwfModel):
                raise ValueError(
                    "APT transport packages (LKT/SFT/MWT/UZT and GWE "
                    "analogs) require the matching advanced packages in "
                    "the GWF model")
            uzf_obj = None
            if "uzf" in apt_spec:
                if not bundles[0].get("uzf_entries"):
                    raise ValueError("UZT/UZE requires a GWF UZF package")
                uzf_obj = _build_uzf(bundles[0])
            gwt_aug = AugmentedGwtModel(gwtm, model, uzf=uzf_obj)
            Ngrid = model.n_grid
            strt_extra = np.zeros(gwt_aug.n_extra)
            for kind, spec in apt_spec.items():
                off = (gwt_aug._uzf_off if kind == "uzf"
                       else getattr(model, f"_{kind}_offset") - Ngrid)
                nfeat = len(spec["strt"])
                strt_extra[off:off + nfeat] = spec["strt"]
                apt_ext_conc[kind] = jnp.asarray(spec["ext_conc"])
            gwt_aug.strt_extra = jnp.asarray(strt_extra)
            gwtm = gwt_aug

        gwt_kwargs = dict(
            gwt=gwtm,
            gwt_settings=sln_settings.get(mname.upper(), None),
            conc_path=gwt_bundle["hds_path"],
            gwt_oc=gwt_bundle["oc"],
            conc_text="TEMPERATURE" if ttype == "GWE6"
            else "CONCENTRATION")

    simulation = Simulation(
        tdis, model, gwf_settings, transient=transient,
        hds_path=hds_path or bundles[0]["hds_path"],
        cbc_path=cbc_path or bundles[0]["cbc_path"],
        lst_path=lst_path, oc=bundles[0]["oc"],
        obs=bundles[0].get("obs"),
        nc_path=bundles[0].get("nc_out"), **gwt_kwargs)
    if gwt_entries:
        simulation.apt_ext_conc = apt_ext_conc
    simulation.sgp_mxiter = sgp_mxiter
    # reference failure semantics: abort on nonconvergence unless the
    # simulation CONTINUE option is set (sim-nam continue keyword)
    simulation.fail_fast = "CONTINUE" not in sopts
    # model→rank spec for the sharded runner (owner vector hint)
    simulation.hpc_partitions = hpc_partitions
    simulation.model_offsets = {b["name"].upper(): off
                                for b, off in zip(bundles, offsets)}
    simulation.model_sizes = {b["name"].upper(): b["grid"].nodes
                              for b in bundles}

    # --- PRT particle-tracking models (explicit solutions over the flow)
    for _, mfname, mname in prt_entries:
        if len(bundles) > 1:
            raise NotImplementedError(
                "PRT with multi-model GWF not yet supported")
        gm = bundles[0]["model"]
        drv = _load_prt_model(ws, mfname, mname, getattr(gm, "base", gm),
                              bundles[0]["grid"])
        simulation.prt_drivers.append(drv)

    if bundles[0].get("tas") is not None:
        # RCHA driven by a time-array series: refresh the recharge array
        # from the TAS before every step (TasManager ad role)
        from ...models.gwf import bnd as bnd_mod
        from ..timeseries import bind_array_series
        import jax.numpy as jnp

        tas = bundles[0]["tas"]
        ncpl = int(np.prod(np.asarray(tas.arrays[0]).shape))
        nodes = jnp.arange(ncpl, dtype=jnp.int32)
        ones = jnp.ones(ncpl, bool)

        def set_rch(arr):
            rd = bnd_mod.RchData(nodes,
                                 jnp.asarray(np.asarray(arr).reshape(-1)),
                                 ones)
            simulation.model.rch = rd
            for k in list(getattr(simulation, "period_data", {}) or {}):
                simulation.period_data[k] = dataclasses.replace(
                    simulation.period_data[k], rch=rd)

        bind_array_series(simulation, tas, set_rch)

    if bundles[0].get("uzf_entries"):
        from ...models.gwf.uzf import initial_theta
        simulation.uzf = _build_uzf(bundles[0])
        simulation.uzf_theta = initial_theta(simulation.uzf)
    if bundles[0].get("adv_periods"):
        _attach_advanced_periods(simulation, bundles[0])
    if len(bundles) == 1 and bundles[0].get("ts_bindings"):
        _attach_ts_bindings(simulation, bundles[0])

    if len(bundles) == 1:
        _attach_period_data(simulation, bundles[0]["pkg_periods"],
                            bundles[0]["maxbound"], bundles[0]["first_pkgs"])
        simulation.tvk = bundles[0].get("tvk", {})
        simulation.tvs = bundles[0].get("tvs", {})
    else:
        _merge_period_data(simulation, bundles, offsets)
        if any(b.get("tvk") or b.get("tvs") for b in bundles):
            raise NotImplementedError(
                "TVK/TVS with multi-model simulations not supported yet")
    return simulation
