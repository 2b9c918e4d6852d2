"""Distributed transport: GWT/GWE sharded on the general partition.

JAX equivalent of the reference's distributed transport build
(src/Distributed/VirtualGwtModel.f90:1 virtual transport models,
src/Model/Connection/GwtGwtConnection.f90:1 interface models,
ParallelSolution convergence reductions): flow and transport share ONE
node-block partition, each shard runs the full single-chip assembly for
both models, and the only cross-shard traffic is the halo exchange of
head/concentration plus the masked psum/pmax Krylov reductions.

The FMI hand-off is shard-local by construction: each shard rebuilds its
FlowFields (edge flows, saturations, storage rates, boundary flows) from
its OWN local flow solution — the role of the reference's
FlowModelInterface running inside each rank (tsp-fmi.f90) — so no global
gather of the flow field ever happens.

Transport stencils reach further than the 7-point flow stencil
(dispersion cross terms and TVD limiters read neighbor-of-neighbor
state), so the shared partition is built with halo depth 2 whenever DSP/
CND or TVD is active — the reference's stencil-depth expansion
(GridConnection.f90 exchangeStencilDepth).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..constants import DZERO
from ..models.gwt import adv as adv_mod
from ..models.gwt import fmi
from ..models.gwt.model import CncData, SrcData
from ..solution.ims import ImsSettings
from .general import (GeneralPartition, _AreaShim, _remap_bound, _stack,
                      halo_exchange_shifts, implicit_local_solve,
                      partition_general)


def transport_halo_depth(tmodel) -> int:
    """2 when the transport stencil reads 2-hop state (DSP/CND cross
    terms, TVD limiter), else 1."""
    disp = getattr(tmodel, "dsp", None) or getattr(tmodel, "cnd", None)
    return 2 if (disp is not None or tmodel.iadvwt == adv_mod.TVD) else 1


def partition_coupled(gwf_model, tmodel, nshards, owner=None):
    """One partition serving both models (identical owner vector)."""
    depth = max(transport_halo_depth(tmodel),
                2 if gwf_model.ixt3d == 1 else 1)
    part = partition_general(gwf_model, nshards, owner=owner, depth=depth)
    return part


@partial(jax.tree_util.register_dataclass,
         data_fields=["strt", "ibound0", "top", "bot", "area", "arrays",
                      "disp", "cnc", "src"],
         meta_fields=[])
@dataclasses.dataclass
class TransportPartition:
    """Stacked per-shard transport arrays layered on a GeneralPartition."""

    strt: jnp.ndarray
    ibound0: jnp.ndarray
    top: jnp.ndarray
    bot: jnp.ndarray
    area: jnp.ndarray
    arrays: object          # stacked MstArrays / EstArrays
    disp: object            # stacked DspData / CndData or None
    cnc: object             # remapped CncData or None
    src: object             # remapped SrcData or None


def _field_names(tmodel):
    """(arrays attr, dispersion attr, cnc attr, src attr) per model type."""
    if hasattr(tmodel, "est_arrays"):      # GweModel
        return "est_arrays", "cnd", "ctp", "esl"
    return "mst_arrays", "dsp", "cnc", "src"


def partition_transport(part: GeneralPartition, tmodel
                        ) -> TransportPartition:
    """Slice a GwtModel/GweModel's node arrays onto the partition."""
    if getattr(tmodel, "ist", None) is not None:
        raise NotImplementedError(
            "sharded transport does not distribute IST yet")
    nsh, n_local = part.nshards, part.n_local
    arr_attr, disp_attr, cnc_attr, src_attr = _field_names(tmodel)

    def slice_nodes(arr, fill=0.0, dtype=np.float64):
        g = np.asarray(arr, dtype).reshape(-1)
        out = np.full((nsh, n_local), fill, dtype)
        for p, (loc, _, _) in enumerate(part.locals_info):
            out[p, :len(loc)] = g[loc]
        return jnp.asarray(out)

    def slice_tree(tree):
        if tree is None:
            return None
        return jax.tree.map(lambda a: slice_nodes(a), tree)

    cnc_d = getattr(tmodel, cnc_attr, None)
    src_d = getattr(tmodel, src_attr, None)
    return TransportPartition(
        strt=slice_nodes(tmodel.strt),
        ibound0=slice_nodes(tmodel.ibound0, dtype=np.int32),
        top=slice_nodes(tmodel.top, 1.0),
        bot=slice_nodes(tmodel.bot),
        area=slice_nodes(tmodel.area, 1.0),
        arrays=slice_tree(getattr(tmodel, arr_attr)),
        disp=slice_tree(getattr(tmodel, disp_attr, None)),
        cnc=_remap_bound(cnc_d, ["conc"], CncData, part.g2l_list, nsh,
                         n_local - 1),
        src=_remap_bound(src_d, ["q"], SrcData, part.g2l_list, nsh,
                         n_local - 1))


class GeneralCoupledSolution:
    """Sharded sequential GWF→GWT/GWE stepping on a 1-D mesh.

    Each shard: full flow assembly + Picard/Krylov, local FMI snapshot,
    full transport assembly + Krylov — the SolutionGroup flow-then-
    transport order (SolutionGroup.f90:48) with all collectives inside
    one jitted shard_map."""

    def __init__(self, part: GeneralPartition, tmodel,
                 gwf_settings: ImsSettings, gwt_settings=None, mesh=None,
                 ssm_spec=None):
        self.part = part
        self.tmodel = tmodel
        self.tpart = partition_transport(part, tmodel)
        self.s_flow = gwf_settings
        self.s_trans = gwt_settings or ImsSettings(
            outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
            inner_maximum=1000, outer_maximum=50,
            linear_acceleration="bicgstab")
        self.ssm_spec = dict(ssm_spec or {})
        for k, v in self.ssm_spec.items():
            if np.ndim(v) != 0:
                raise NotImplementedError(
                    "sharded SSM supports scalar source concentrations "
                    f"per package (got array for {k})")
        if mesh is None:
            devs = np.array(jax.devices()[:part.nshards])
            mesh = Mesh(devs, ("y",))
        assert mesh.devices.size == part.nshards
        self.mesh = mesh
        self._step = jax.jit(self._build_step(), static_argnames=("iss",))

    def _halo_exchange(self, x, send_idx, recv_idx):
        xe = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        buf = xe[send_idx]
        rec = lax.all_to_all(buf, "y", split_axis=0, concat_axis=0,
                             tiled=True)
        xe = xe.at[recv_idx.reshape(-1)].set(rec.reshape(-1))
        return xe[:-1]

    def _build_step(self):
        part = self.part
        tmodel = self.tmodel
        sf, st = self.s_flow, self.s_trans
        model = part.model
        use_cg_f = sf.linear_acceleration == "cg"
        use_cg_t = st.linear_acceleration == "cg"
        ssm_spec = self.ssm_spec
        arr_attr, disp_attr, cnc_attr, src_attr = _field_names(tmodel)

        def shard_fn(head0, conc0, dtopo, dtopo_b, arrays, sarr, xt3d,
                     ib0, strt, area, own, hsend, hrecv, pkgs,
                     tarr, delt, kstp, iss):
            sq = lambda t: jax.tree.map(lambda a: a[0], t)   # noqa: E731
            head = sq(head0)
            conc = sq(conc0)
            own_l = sq(own)
            hsend_l = sq(hsend)
            hrecv_l = sq(hrecv)
            pkgs_l = {k: (sq(v) if v is not None else None)
                      for k, v in pkgs.items()}
            sarr_l = sq(sarr) if sarr is not None else None

            lm = dataclasses.replace(
                model, grid=_AreaShim(sq(area)), topo=None,
                dtopo=sq(dtopo), npf_arrays=sq(arrays),
                sto_arrays=sarr_l,
                xt3d=sq(xt3d) if xt3d is not None else None,
                strt=sq(strt), ibound0=sq(ib0), condsat3=None,
                delr=None, delc=None, hfb=None, **pkgs_l)

            def halo(v):
                return halo_exchange_shifts(v, part.halo_perms, hsend_l,
                                            hrecv_l)

            def dot(a, b):
                return lax.psum(jnp.sum(jnp.where(own_l, a * b, DZERO)),
                                "y")

            def absmax(v):
                return lax.pmax(
                    jnp.max(jnp.abs(jnp.where(own_l, v, DZERO))), "y")

            # ---- flow solve (shard-local Picard); BUY/VSC see the lagged
            # start-of-step concentration (sequential solution-group order)
            pkgs_solve = None
            if getattr(model, "buy", None) is not None \
                    or getattr(model, "vsc", None) is not None:
                pkgs_solve = dataclasses.replace(lm.packages,
                                                 buy_conc=halo(conc))
            ibound, head = lm.boundary_state(head)
            head = halo(head)
            head_old = head
            head, kif, convf, innf = implicit_local_solve(
                lm, head, head_old, ibound, delt, iss, sf, use_cg_f,
                halo, dot, absmax, kstp, own_l, pkgs=pkgs_solve)

            # ---- local FMI snapshot (tsp-fmi.f90 per-rank role)
            fields = fmi.from_gwf_step(lm, head, head_old, ibound, None,
                                       delt, iss, pkgs=pkgs_solve,
                                       ssm_spec=ssm_spec)

            # ---- transport solve on the same split
            tarr_l = sq(tarr)
            lm_t = dataclasses.replace(
                tmodel, topo=None, dtopo=sq(dtopo_b),
                strt=tarr_l.strt, ibound0=tarr_l.ibound0,
                top=tarr_l.top, bot=tarr_l.bot, area=tarr_l.area,
                grid=None,
                **{arr_attr: tarr_l.arrays, disp_attr: tarr_l.disp,
                   cnc_attr: tarr_l.cnc, src_attr: tarr_l.src})
            ib_t, conc = lm_t.boundary_state(conc)
            conc = halo(conc)
            conc_old = conc
            conc, kit, convt, innt = implicit_local_solve(
                lm_t, conc, conc_old, ib_t, delt, False, st, use_cg_t,
                halo, dot, absmax, kstp, own_l, pkgs=fields)

            return (head[None], conc[None], kif[None],
                    (convf & convt)[None], (innf + innt)[None])

        def step(head_stacked, conc_stacked, sarr, pkgs, tarr, delt, kstp,
                 iss: bool):
            sp = P("y")
            rep = P()

            def like(tree, spec):
                return jax.tree.map(lambda _: spec, tree)

            fn = partial(shard_fn, iss=iss)
            in_specs = (sp, sp, like(part.dtopo, sp),
                        like(part.dtopo_base, sp),
                        like(part.npf_arrays, sp), like(sarr, sp),
                        like(part.xt3d, sp), sp, sp, sp, sp,
                        like(part.halo_send, sp),
                        like(part.halo_recv, sp),
                        like(pkgs, sp), like(tarr, sp), rep, rep)
            out_specs = (sp, sp, sp, sp, sp)
            sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                           out_specs=out_specs)
            return sm(head_stacked, conc_stacked, part.dtopo,
                      part.dtopo_base, part.npf_arrays, sarr, part.xt3d,
                      part.ibound0, part.strt, part.area, part.own,
                      part.halo_send, part.halo_recv, pkgs, tarr, delt,
                      kstp)

        return step

    # ---------------------------------------------------------- driving

    def solve_timestep(self, head_stacked, conc_stacked, delt, kstp=1,
                       iss=False):
        head, conc, kiter, converged, inner = self._step(
            head_stacked, conc_stacked, self.part.sto_arrays,
            self.part.pkgs, self.tpart, jnp.asarray(delt),
            jnp.asarray(kstp, jnp.int32), iss=bool(iss))
        return head, conc, dict(
            outer=int(np.asarray(kiter).max()),
            converged=bool(np.asarray(converged).all()),
            inner=int(np.asarray(inner).max()))

    def scatter(self, vec_global):
        part = self.part
        g = np.asarray(vec_global).reshape(-1)
        out = np.zeros((part.nshards, part.n_local))
        for p in range(part.nshards):
            loc = part.local2global[p]
            sel = loc >= 0
            out[p, sel] = g[loc[sel]]
        return jnp.asarray(out)

    def gather(self, vec_stacked):
        part = self.part
        hs = np.asarray(vec_stacked)
        own = np.asarray(part.own)
        out = np.zeros(part.model.nodes)
        for p in range(part.nshards):
            sel = own[p]
            out[part.local2global[p][sel]] = hs[p][sel]
        return out
