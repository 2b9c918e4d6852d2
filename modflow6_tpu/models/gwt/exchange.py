"""GWT-GWT exchange: multi-model transport via the merged composite.

Behavioral parity target: src/Exchange/exg-gwtgwt.f90 — advective and
dispersive coupling of transport models across the same interface the
GWF-GWF exchange defines.  Formulation (mirroring
models.gwf.exchange): the member transport models are merged into ONE
composite GwtModel over the merged flow model's topology — the exchange
edges are then ordinary edges, so upstream advection weighting and
dispersion act across the interface with zero special-casing, and the
FMI fields of the merged GWF model line up edge-for-edge.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..gwf import npf as npf_mod
from .model import CncData, GwtModel, SrcData
from . import mst as mst_mod


def _cat(get, models):
    return jnp.concatenate([jnp.asarray(get(m)).reshape(-1)
                            for m in models])


def merge_gwt_models(models, gwf_merged) -> GwtModel:
    """Union of GWT models over a merged GWF composite's topology.

    ``gwf_merged`` must be the model from merge_gwf_models for the same
    member ordering (its _offsets give the node numbering)."""
    offsets = list(gwf_merged._offsets)
    N = gwf_merged.nodes
    m0 = models[0]
    if any(m.iadvwt != m0.iadvwt for m in models):
        raise ValueError("exchange requires a consistent ADV scheme")
    if any((m.dsp is None) != (m0.dsp is None) for m in models):
        raise ValueError("exchange requires consistent DSP usage")

    def cat_pkg(cls, get):
        live = [(get(m), off) for m, off in zip(models, offsets)
                if get(m) is not None]
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

    dsp = None
    if m0.dsp is not None:
        from . import dsp as dsp_mod
        dsp = dsp_mod.DspData(
            alh=_cat(lambda m: m.dsp.alh, models),
            alv=_cat(lambda m: m.dsp.alv, models),
            ath1=_cat(lambda m: m.dsp.ath1, models),
            ath2=_cat(lambda m: m.dsp.ath2, models),
            atv=_cat(lambda m: m.dsp.atv, models),
            diffc=_cat(lambda m: m.dsp.diffc, models),
            idisp=max(m.dsp.idisp for m in models),
            idiffc=max(m.dsp.idiffc for m in models))

    merged = GwtModel(
        name="+".join(m.name for m in models),
        grid=gwf_merged.grid, topo=gwf_merged.topo, dtopo=gwf_merged.dtopo,
        strt=_cat(lambda m: m.strt, models),
        ibound0=_cat(lambda m: m.ibound0, models),
        mst_opts=m0.mst_opts,
        mst_arrays=mst_mod.MstArrays(
            porosity=_cat(lambda m: m.mst_arrays.porosity, models),
            decay=_cat(lambda m: m.mst_arrays.decay, models),
            decay_sorbed=_cat(lambda m: m.mst_arrays.decay_sorbed, models),
            bulk_density=_cat(lambda m: m.mst_arrays.bulk_density, models),
            distcoef=_cat(lambda m: m.mst_arrays.distcoef, models),
            sp2=_cat(lambda m: m.mst_arrays.sp2, models)),
        iadvwt=m0.iadvwt, eqnsclfac=m0.eqnsclfac,
        dsp=dsp,
        cnc=cat_pkg(CncData, lambda m: m.cnc),
        src=cat_pkg(SrcData, lambda m: m.src),
        ssm_spec=m0.ssm_spec,
        top=jnp.asarray(np.asarray(gwf_merged.grid.top).reshape(-1)),
        bot=jnp.asarray(np.asarray(gwf_merged.grid.bot).reshape(-1)),
        area=jnp.asarray(np.asarray(gwf_merged.grid.area).reshape(-1)))
    merged._offsets = offsets
    return merged
