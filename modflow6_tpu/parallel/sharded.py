"""Sharded numerical solution: the whole Picard+Krylov time step as one
`shard_map` program over a device mesh.

JAX equivalent of the reference's parallel run (SURVEY §2.8/§3.3):

  reference                               here
  ---------                               ----
  model-per-rank + interface models       row-block shards + halo rows
  VirtualDataManager.synchronize(STG_*)   `lax.ppermute` halo exchanges at
    before exg_ad/cf/fc                   the same three points per outer it
  PETSc KSP global reductions             `lax.psum` dots inside the CG loop
  MPI_Allreduce convergence scalars       `lax.pmax` on masked |dx|
  BJACOBI + per-rank ILU preconditioner   per-shard Jacobi/Neumann precond

Every collective result is replicated, so the `lax.while_loop` convergence
decisions are identical on all shards — the lockstep structure the
reference achieves with blocking MPI.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..constants import DZERO
from ..models.gwf import bnd, npf, npf_structured, sto
from ..ops.solvers.krylov import cg, bicgstab, epfact, refined_solve
from ..ops.solvers.precond import make_preconditioner
from ..ops.system import (apply_dirichlet, apply_dirichlet_structured,
                          make_matvec, spmv)
from ..solution.ims import ImsSettings
from .partition import RowPartition


def _shard_precond_kind(kind: str) -> str:
    """Geometric MG is a whole-grid structured method; per-shard it
    degrades to Chebyshev (the same substitution ims._make_precond makes
    for unstructured models)."""
    return "chebyshev" if kind == "mg" else kind


def _shard_precond_order(s) -> int:
    kind = _shard_precond_kind(s.preconditioner)
    return max(s.preconditioner_order, 4 if kind == "chebyshev" else 0)


class ShardedSolution:
    """Solves time steps of a row-partitioned GWF model on a 1-D mesh."""

    def __init__(self, part: RowPartition, settings: ImsSettings, mesh=None):
        self.part = part
        self.s = settings
        if mesh is None:
            devs = np.array(jax.devices()[:part.nshards])
            mesh = Mesh(devs, ("y",))
        assert mesh.devices.size == part.nshards
        self.mesh = mesh
        self.dtopo = npf.DeviceTopology.from_host(part.topo_local)
        self._own = jnp.asarray(part.own_mask)
        g = part.grid_local
        self._lshape = (g.nlay, g.nrow, g.ncol)

        # per-shard condsat (reference calc_condsat, vmapped over shards)
        def _condsat(arrays, strt, ib):
            sat0 = npf.initial_sat(part.npf_opts, arrays, strt, ib)
            return npf.compute_condsat(self.dtopo, part.npf_opts, arrays,
                                       sat0, strt)
        condsat = jax.vmap(_condsat)(part.npf_arrays, part.strt, part.ibound0)
        self.npf_arrays = dataclasses.replace(part.npf_arrays, condsat=condsat)

        # structured (gather-free) local assembly: per-shard dense condsat
        self._structured = (self.dtopo.grid_shape is not None
                            and not (part.npf_opts.iangle1
                                     or part.npf_opts.iangle2
                                     or part.npf_opts.iangle3))
        if self._structured:
            self._delr = jnp.asarray(g.delr)
            self._delc = jnp.asarray(g.delc)
            if part.condsat3 is not None:
                # sliced from the global model — carries HFB modifications
                self.condsat3 = tuple(jnp.asarray(c) for c in part.condsat3)
            else:

                def _condsat3(arrays, strt, ib):
                    sat0 = npf.initial_sat(part.npf_opts, arrays, strt, ib)
                    return npf_structured.structured_condsat(
                        self.dtopo.grid_shape, self._delr, self._delc,
                        part.npf_opts, arrays.icelltype, arrays.k11,
                        arrays.k22, arrays.k33, arrays.top, arrays.bot, sat0)
                self.condsat3 = jax.vmap(_condsat3)(self.npf_arrays,
                                                    part.strt, part.ibound0)
        else:
            if part.condsat3 is not None:
                raise NotImplementedError(
                    "HFB-modified condsat requires the structured path")
            self.condsat3 = None

        # the stacked per-shard arrays live on their shards' devices and
        # enter the step as arguments: closed over, they would be embedded
        # in the program as constants, replicated on every device
        self._fixed = jax.device_put(
            (self.npf_arrays, self.condsat3, part.ibound0, part.strt,
             part.area, part.sto_arrays, part.chd, part.wel, part.rch,
             part.drn, part.riv, part.ghb, part.evt),
            NamedSharding(mesh, P("y")))
        self._step = jax.jit(self._build_step(), static_argnames=("iss",))

    # ---------------------------------------------------------------- halo

    def _halo_exchange(self, x):
        """Sync the two halo rows from the owning neighbors (axis 'y')."""
        nlay, nrl2, ncol = self._lshape
        x3 = x.reshape(nlay, nrl2, ncol)
        nsh = self.part.nshards
        fwd = [(i, i + 1) for i in range(nsh - 1)]
        bwd = [(i + 1, i) for i in range(nsh - 1)]
        # my last owned row → next shard's north halo (row 0)
        recv_north = lax.ppermute(x3[:, -2, :], "y", fwd)
        # my first owned row → previous shard's south halo (row -1)
        recv_south = lax.ppermute(x3[:, 1, :], "y", bwd)
        x3 = x3.at[:, 0, :].set(recv_north).at[:, -1, :].set(recv_south)
        return x3.reshape(-1)

    # ---------------------------------------------------------------- step

    def _build_step(self):
        part = self.part
        s = self.s
        dtopo = self.dtopo
        own = self._own
        use_cg = s.linear_acceleration == "cg"
        solver = cg if use_cg else bicgstab

        def shard_fn(head0, npf_arrays, condsat3, sto_arrays, ibound0, strt,
                     area, chd, wel, rch, drn, riv, ghb, evt, delt, kstp,
                     iss):
            # shard_map passes blocks with the sharded axis kept (size 1)
            squeeze = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
            head = squeeze(head0)
            arrays = squeeze(npf_arrays)
            cs3 = squeeze(condsat3) if condsat3 is not None else None
            sarr = squeeze(sto_arrays) if sto_arrays is not None else None
            ib0 = squeeze(ibound0)
            chd_d = squeeze(chd) if chd is not None else None
            wel_d = squeeze(wel) if wel is not None else None
            rch_d = squeeze(rch) if rch is not None else None
            drn_d = squeeze(drn) if drn is not None else None
            riv_d = squeeze(riv) if riv is not None else None
            ghb_d = squeeze(ghb) if ghb is not None else None
            evt_d = squeeze(evt) if evt is not None else None
            area_l = squeeze(area)

            def dot(a, b):
                return lax.psum(jnp.sum(jnp.where(own, a * b, DZERO)), "y")

            def absmax(v):
                return lax.pmax(jnp.max(jnp.abs(jnp.where(own, v, DZERO))), "y")

            # CHD rp/ad (local, covers owned + halo copies)
            ibound = ib0
            if chd_d is not None:
                ibound, head = bnd.apply_chd(ibound, head, chd_d)
            head = self._halo_exchange(head)   # STG_BFR_EXG_AD analog
            head_old = head

            def outer_body(carry):
                head, kiter, _, inner_tot = carry
                head = self._halo_exchange(head)   # STG_BFR_EXG_CF analog
                sat = npf.compute_saturation(part.npf_opts, arrays, head,
                                             ibound)
                if self._structured:
                    diag, off, rhs = npf_structured.assemble_structured(
                        dtopo.grid_shape, self._delr, self._delc,
                        part.npf_opts, arrays, head, ibound, sat, cs3)
                else:
                    diag, off, rhs, _ = npf.assemble(dtopo, part.npf_opts,
                                                     arrays, head, ibound, sat)
                if sarr is not None and not iss:
                    d_add, r_add = sto.assemble(part.sto_opts, sarr, head,
                                                head_old, ibound, delt)
                    diag = diag + d_add
                    rhs = rhs + r_add
                if wel_d is not None:
                    hc, r = bnd.wel_terms(wel_d, head, ibound,
                                          arrays.icelltype, arrays.top,
                                          arrays.bot, part.wel_iflowred,
                                          part.wel_flowred)
                    diag, rhs = bnd.scatter_terms(diag, rhs, wel_d.node,
                                                  wel_d.mask, hc, r)
                if rch_d is not None:
                    hc, r = bnd.rch_terms(rch_d, ibound, area_l)
                    diag, rhs = bnd.scatter_terms(diag, rhs, rch_d.node,
                                                  rch_d.mask, hc, r)
                if drn_d is not None:
                    hc, r = bnd.drn_terms(drn_d, head, ibound)
                    diag, rhs = bnd.scatter_terms(diag, rhs, drn_d.node,
                                                  drn_d.mask, hc, r)
                if riv_d is not None:
                    hc, r = bnd.riv_terms(riv_d, head, ibound)
                    diag, rhs = bnd.scatter_terms(diag, rhs, riv_d.node,
                                                  riv_d.mask, hc, r)
                if ghb_d is not None:
                    hc, r = bnd.ghb_terms(ghb_d, ibound)
                    diag, rhs = bnd.scatter_terms(diag, rhs, ghb_d.node,
                                                  ghb_d.mask, hc, r)
                if evt_d is not None:
                    hc, r = bnd.evt_terms(evt_d, head, ibound, area_l)
                    diag, rhs = bnd.scatter_terms(diag, rhs, evt_d.node,
                                                  evt_d.mask, hc, r)
                if part.inewton:
                    diag, off, rhs = npf.newton_terms(
                        dtopo, part.npf_opts, arrays, head, ibound,
                        diag, off, rhs)
                    if sarr is not None and not iss:
                        d_add, r_add = sto.newton_terms(part.sto_opts, sarr,
                                                        head, ibound, delt)
                        diag = diag + d_add
                        rhs = rhs + r_add
                    if wel_d is not None and part.wel_iflowred:
                        hc, r = bnd.wel_newton(wel_d, head, ibound,
                                               arrays.icelltype, arrays.top,
                                               arrays.bot, part.wel_iflowred,
                                               part.wel_flowred)
                        diag, rhs = bnd.scatter_terms(diag, rhs, wel_d.node,
                                                      wel_d.mask, hc, r)

                active = jnp.where(ibound > 0, 1,
                                   jnp.where(ibound < 0, -1, 0))
                if self._structured:
                    diag, off, rhs = apply_dirichlet_structured(
                        dtopo.grid_shape, active, diag, off, rhs, head,
                        symmetric=use_cg, own=own)
                else:
                    diag, off, rhs = apply_dirichlet(
                        dtopo.nbr, active, diag, off, rhs, head,
                        symmetric=use_cg, own=own)

                local_mv = make_matvec(dtopo, diag, off)

                def matvec(v):
                    v = self._halo_exchange(v)   # STG_BFR_EXG_FC analog
                    return local_mv(v)

                r0 = rhs - matvec(head)
                l2norm0 = jnp.sqrt(dot(r0, r0))
                if s.precision == "mixed":
                    diag32 = diag.astype(jnp.float32)
                    off32 = off.astype(jnp.float32)
                    local_mv32 = make_matvec(dtopo, diag32, off32)

                    def matvec32(v):
                        return local_mv32(self._halo_exchange(v))

                    precond32 = make_preconditioner(
                        _shard_precond_kind(s.preconditioner), matvec32,
                        diag32, order=_shard_precond_order(s))
                    res = refined_solve(
                        solver, matvec, matvec32, rhs, head, precond32,
                        itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                        rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                        north=s.north, l2norm0=l2norm0,
                        epfact_val=epfact(s.icnvgopt, kstp),
                        dot=dot, absmax=absmax)
                else:
                    precond = make_preconditioner(
                        _shard_precond_kind(s.preconditioner), matvec, diag,
                        order=_shard_precond_order(s))
                    res = solver(matvec, rhs, head, precond,
                                 itmax=s.inner_maximum,
                                 dvclose=s.inner_dvclose,
                                 rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                                 north=s.north, l2norm0=l2norm0,
                                 epfact_val=epfact(s.icnvgopt, kstp),
                                 dot=dot, absmax=absmax)
                x = self._halo_exchange(res.x)
                dxmax = absmax(jnp.where(active > 0, x - head, DZERO))
                converged = dxmax <= s.outer_dvclose
                return x, kiter + 1, converged, inner_tot + res.iters

            def outer_cond(carry):
                _, kiter, converged, _ = carry
                return (~converged) & (kiter < s.outer_maximum)

            init = (head, jnp.zeros((), jnp.int32), jnp.zeros((), bool),
                    jnp.zeros((), jnp.int32))
            head, kiter, converged, inner_tot = lax.while_loop(
                outer_cond, outer_body, init)
            return (head[None], kiter[None], converged[None],
                    inner_tot[None])

        def step(head_stacked, fixed, delt, kstp, iss: bool):
            (npf_arrays, condsat3, ibound0, strt, area, sto_arrays, chd, wel,
             rch, drn, riv, ghb, evt) = fixed
            spec_shard = P("y")
            rep = P()

            def spec_like(tree, spec):
                return jax.tree.map(lambda _: spec, tree)

            fn = partial(shard_fn, iss=iss)
            in_specs = (spec_shard, spec_like(npf_arrays, spec_shard),
                        spec_like(condsat3, spec_shard),
                        spec_like(sto_arrays, spec_shard),
                        spec_shard, spec_shard, spec_shard,
                        spec_like(chd, spec_shard),
                        spec_like(wel, spec_shard),
                        spec_like(rch, spec_shard),
                        spec_like(drn, spec_shard),
                        spec_like(riv, spec_shard),
                        spec_like(ghb, spec_shard),
                        spec_like(evt, spec_shard),
                        rep, rep)
            out_specs = (spec_shard, spec_shard, spec_shard, spec_shard)
            sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                           out_specs=out_specs)
            return sm(head_stacked, npf_arrays, condsat3, sto_arrays,
                      ibound0, strt, area, chd, wel, rch, drn, riv, ghb, evt,
                      delt, kstp)

        return step

    # ------------------------------------------------------------ driving

    def solve_timestep(self, head_stacked, delt, kstp=1, iss=False):
        """One time step. ``head_stacked``: (P, N_local) with halo rows."""
        head, kiter, converged, inner = self._step(
            head_stacked, self._fixed,
            jnp.asarray(delt), jnp.asarray(kstp, jnp.int32), iss=bool(iss))
        return head, dict(outer=int(kiter.max()),
                          converged=bool(np.asarray(converged).all()),
                          inner=int(inner.max()))

    # ------------------------------------------------ layout conversions

    def scatter_heads(self, head_global):
        """Global flat head → stacked (P, N_local) with halo duplicates."""
        part = self.part
        g = part.grid_local
        nlay, nrl2, ncol = self._lshape
        nrl = part.nrow_local
        nrow = nrl * part.nshards
        h3 = np.asarray(head_global).reshape(nlay, nrow, ncol)
        out = np.zeros((part.nshards, nlay, nrl2, ncol))
        for p in range(part.nshards):
            r0, r1 = p * nrl - 1, (p + 1) * nrl + 1
            s0, s1 = max(r0, 0), min(r1, nrow)
            out[p][:, s0 - r0:s1 - r0, :] = h3[:, s0:s1, :]
        return jnp.asarray(out.reshape(part.nshards, -1))

    def gather_heads(self, head_stacked):
        """Stacked (P, N_local) → global flat head (owned rows only)."""
        part = self.part
        nlay, nrl2, ncol = self._lshape
        nrl = part.nrow_local
        hs = np.asarray(head_stacked).reshape(part.nshards, nlay, nrl2, ncol)
        rows = [hs[p][:, 1:-1, :] for p in range(part.nshards)]
        return np.concatenate(rows, axis=1).reshape(-1)
