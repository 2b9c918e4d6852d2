"""GWF-GWF exchange: couple multiple GWF models into one solution matrix.

Behavioral parity target: GwfExchangeType (reference
src/Exchange/exg-gwfgwf.f90:47): the exchange contributes two-point-flux
conductance terms between node pairs of different models into the global
system (gwf_gwf_fc exg-gwfgwf.f90:488-550), with per-pair CVFD geometry
(ihc/cl1/cl2/hwva/angldegx from DisConnExchange.f90).

Formulation: instead of separate model matrices glued by an
exchange object, the models are merged into ONE composite model whose
topology is the disjoint union of the member topologies plus the exchange
edges (models.discretization.topology.concat_topologies).  Every kernel —
conductance assembly, SpMV, Krylov — then runs over the combined static
ELL with zero special-casing; the exchange edges get exactly the same
condmean/hcond treatment the reference applies in gwf_gwf_fc.  This is the
single-process analog of the reference's one-global-matrix-per-solution
design (NumericalSolution spanning all models, SURVEY §2.2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..discretization.topology import Topology
from . import bnd, npf
from .model import GwfModel


@dataclasses.dataclass(frozen=True)
class ExchangePair:
    """One exchange connection (exg-gwfgwf exchangedata record)."""

    node1: int      # node in model 1 (local numbering)
    node2: int      # node in model 2 (local numbering)
    ihc: int = 1
    cl1: float = 1.0
    cl2: float = 1.0
    hwva: float = 1.0
    angldegx: float = 0.0


@dataclasses.dataclass(frozen=True)
class GwfGwfExchange:
    """Exchange between two member models (by index into the model list)."""

    model1: int
    model2: int
    pairs: list


@dataclasses.dataclass
class MergedGrid:
    """Minimal grid facade over the union of member grids."""

    nodes: int
    area: np.ndarray
    top: np.ndarray
    bot: np.ndarray
    idomain: np.ndarray
    shape: tuple


def _concat_pkg(cls, datas, offsets):
    """Concatenate one package type across models, shifting node indices."""
    live = [(d, off) for d, off in zip(datas, offsets) if d is not None]
    if not live:
        return None
    fields = [f.name for f in dataclasses.fields(cls)]
    out = {}
    for f in fields:
        parts = []
        for d, off in live:
            v = jnp.asarray(getattr(d, f))
            if f == "node":
                v = v + off
            parts.append(v)
        out[f] = jnp.concatenate(parts)
    return cls(**out)


def merge_gwf_models(models, exchanges) -> GwfModel:
    """Union of GWF models + exchange edges → one composite GwfModel.

    All members must share NPF options (the reference likewise requires
    consistent formulations across an exchange, e.g. matching Newton
    settings — exg-gwfgwf.f90 validate).
    """
    offsets = np.cumsum([0] + [m.nodes for m in models])[:-1]
    N = int(sum(m.nodes for m in models))

    o0 = models[0].npf_opts
    for m in models[1:]:
        if m.npf_opts != o0:
            raise ValueError("exchange requires matching NPF options")
        if bool(m.inewton) != bool(models[0].inewton):
            raise ValueError("exchange requires matching Newton settings")

    # ---- merged topology: member edges shifted + exchange edges appended
    parts = {k: [] for k in ("edge_n", "edge_m", "ihc", "cl1", "cl2",
                             "hwva", "direction", "anglex")}
    for m, off in zip(models, offsets):
        t = m.topo
        parts["edge_n"].append(t.edge_n.astype(np.int64) + off)
        parts["edge_m"].append(t.edge_m.astype(np.int64) + off)
        parts["ihc"].append(t.ihc)
        parts["cl1"].append(t.cl1)
        parts["cl2"].append(t.cl2)
        parts["hwva"].append(t.hwva)
        parts["direction"].append(t.direction)
        parts["anglex"].append(t.anglex)
    for exg in exchanges:
        p = np.array([[pp.node1 + offsets[exg.model1],
                       pp.node2 + offsets[exg.model2]] for pp in exg.pairs],
                     np.int64)
        lo = np.minimum(p[:, 0], p[:, 1])
        hi = np.maximum(p[:, 0], p[:, 1])
        parts["edge_n"].append(lo)
        parts["edge_m"].append(hi)
        parts["ihc"].append(np.array([pp.ihc for pp in exg.pairs], np.int32))
        parts["cl1"].append(np.array([pp.cl1 for pp in exg.pairs]))
        parts["cl2"].append(np.array([pp.cl2 for pp in exg.pairs]))
        parts["hwva"].append(np.array([pp.hwva for pp in exg.pairs]))
        parts["direction"].append(np.full(len(exg.pairs), -1, np.int32))
        parts["anglex"].append(np.deg2rad(
            np.array([pp.angldegx for pp in exg.pairs])))
    cat = {k: np.concatenate(v) for k, v in parts.items()}
    order = np.lexsort((cat["edge_m"], cat["edge_n"]))
    topo = Topology(
        nodes=N,
        edge_n=cat["edge_n"][order].astype(np.int32),
        edge_m=cat["edge_m"][order].astype(np.int32),
        ihc=cat["ihc"][order].astype(np.int32),
        cl1=cat["cl1"][order], cl2=cat["cl2"][order],
        hwva=cat["hwva"][order],
        direction=cat["direction"][order].astype(np.int32),
        anglex=cat["anglex"][order])
    dtopo = npf.DeviceTopology.from_host(topo)

    # ---- merged cell arrays
    def cat_np(get):
        return np.concatenate([np.asarray(get(m)).reshape(-1)
                               for m in models])

    def cat_jnp(get):
        return jnp.concatenate([jnp.asarray(get(m)).reshape(-1)
                                for m in models])

    grid = MergedGrid(
        nodes=N,
        area=cat_np(lambda m: m.grid.area),
        top=cat_np(lambda m: m.grid.top),
        bot=cat_np(lambda m: m.grid.bot),
        idomain=cat_np(lambda m: m.grid.idomain),
        shape=(N,))

    a0 = models[0].npf_arrays
    arrays = npf.NpfArrays(
        icelltype=cat_jnp(lambda m: m.npf_arrays.icelltype),
        k11=cat_jnp(lambda m: m.npf_arrays.k11),
        k22=cat_jnp(lambda m: m.npf_arrays.k22),
        k33=cat_jnp(lambda m: m.npf_arrays.k33),
        angle1=cat_jnp(lambda m: m.npf_arrays.angle1),
        angle2=cat_jnp(lambda m: m.npf_arrays.angle2),
        angle3=cat_jnp(lambda m: m.npf_arrays.angle3),
        condsat=jnp.zeros(topo.nedges),
        top=cat_jnp(lambda m: m.npf_arrays.top),
        bot=cat_jnp(lambda m: m.npf_arrays.bot))

    sto_opts = sto_arrays = None
    if all(m.sto_arrays is not None for m in models):
        from . import sto as sto_mod
        sto_opts = models[0].sto_opts
        sto_arrays = sto_mod.StoArrays(
            iconvert=cat_jnp(lambda m: m.sto_arrays.iconvert),
            ss=cat_jnp(lambda m: m.sto_arrays.ss),
            sy=cat_jnp(lambda m: m.sto_arrays.sy),
            top=arrays.top, bot=arrays.bot,
            area=jnp.asarray(grid.area))

    merged = GwfModel(
        name="+".join(m.name for m in models),
        grid=grid, topo=topo, dtopo=dtopo,
        npf_opts=o0, npf_arrays=arrays,
        strt=cat_jnp(lambda m: m.strt),
        ibound0=cat_jnp(lambda m: m.ibound0),
        sto_opts=sto_opts, sto_arrays=sto_arrays,
        chd=_concat_pkg(bnd.ChdData, [m.chd for m in models], offsets),
        wel=_concat_pkg(bnd.WelData, [m.wel for m in models], offsets),
        rch=_concat_pkg(bnd.RchData, [m.rch for m in models], offsets),
        drn=_concat_pkg(bnd.DrnData, [m.drn for m in models], offsets),
        riv=_concat_pkg(bnd.RivData, [m.riv for m in models], offsets),
        ghb=_concat_pkg(bnd.GhbData, [m.ghb for m in models], offsets),
        evt=_concat_pkg(bnd.EvtData, [m.evt for m in models], offsets),
        inewton=models[0].inewton,
        wel_iflowred=max(m.wel_iflowred for m in models),
        wel_flowred=max(m.wel_flowred for m in models),
        hfb=None)
    merged.finalize_setup()
    merged._offsets = offsets        # model → global node offset
    return merged


def split_heads(merged, heads):
    """Slice the composite head vector back into per-model arrays."""
    offs = list(merged._offsets) + [merged.nodes]
    h = np.asarray(heads)
    return [h[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
