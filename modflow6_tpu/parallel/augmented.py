"""Sharded augmented models: MAW/LAK/SFR feature rows on the general
partition.

JAX equivalent of distributing the reference's advanced packages
with their models (each MPI rank owns its models' packages; boundary
feature↔cell coefficients ride the interface-model matrix,
src/Model/Connection/SpatialModelConnection.f90): each feature row is
OWNED by the shard that owns its host cell.  Feature static data is
small (R ≪ N), so every shard replicates the full feature tables — the
local assembly produces garbage in non-owned feature rows, which the
owned-row masking of the sharded Krylov solve already tolerates (halo
rows are identity rows; their values arrive by halo exchange).  The
owner shard's feature rows are exact because its halo is expanded to
hold every connection cell of its owned features (partition_general
``extra_halo``).

Augmented row layout per shard: [n_local cell slots | R feature rows] —
feature rows keep their GLOBAL extra index on every shard, so the halo
exchange for features is a plain owner-broadcast with identical local
indices on both sides.
"""

from __future__ import annotations

import copy
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..constants import DZERO
from ..models.gwf.advanced import AugmentedGwfModel, AugTopo
from ..solution.ims import ImsSettings
from .general import (GeneralPartition, _AreaShim, _stack,
                      implicit_local_solve, partition_general)


class _BaseShim:
    """Host-side stand-in for the local base model during per-shard
    AugmentedGwfModel construction (only topology metadata is read)."""

    def __init__(self, nodes, nbr):
        self.nodes = nodes
        self.topo = types.SimpleNamespace(nbr=nbr)
        self.use_structured = False
        self.inewton = 0
        self.packages = None


def _feature_table(aug):
    """[(kind, idx, host_cell, conn_cells)] in the aug row order."""
    feats = []
    for kind in ("maw", "lak", "sfr"):
        d = getattr(aug, kind)
        if d is None:
            continue
        if kind == "maw":
            cw = np.asarray(d.conn_well)
            cn = np.asarray(d.conn_node)
            for w in range(d.nwells):
                cells = cn[cw == w]
                feats.append((kind, w, int(cells[0]), cells))
        elif kind == "lak":
            cl = np.asarray(d.conn_lake)
            cn = np.asarray(d.conn_node)
            for il in range(d.nlakes):
                cells = cn[cl == il]
                feats.append((kind, il, int(cells[0]), cells))
        else:
            nd = np.asarray(d.node)
            for r in range(d.nreaches):
                feats.append((kind, r, int(nd[r]), nd[r:r + 1]))
    return feats


_SKIP = {
    "maw": {"slot_cw", "slot_wc", "active"},
    "lak": {"slot_cl", "slot_lc", "active", "out_slot"},
    "sfr": {"slot_cr", "slot_rc", "active", "up_pair_r", "up_pair_u",
            "up_pair_f", "up_pair_slot"},
}
_CELL_FIELDS = {"maw": {"conn_node"}, "lak": {"conn_node"},
                "sfr": {"node"}}


def _spec_from_data(kind, d, map_cell):
    """Reconstruct the build_* spec dict from a Data object, with cell
    indices remapped into a shard's local space."""
    spec = {}
    for f in dataclasses.fields(type(d)):
        if f.name in _SKIP[kind]:
            continue
        v = getattr(d, f.name)
        if v is None:
            continue
        if f.name in _CELL_FIELDS[kind]:
            v = map_cell(np.asarray(v))
        elif isinstance(v, (jnp.ndarray, np.ndarray)) \
                or hasattr(v, "shape"):
            v = np.asarray(v)
        spec[f.name] = v
    return spec


@dataclasses.dataclass
class AugmentedPartition:
    part: GeneralPartition          # base-cell partition (extra halos)
    template: object                # shard-0 AugmentedGwfModel (statics)
    nbr: jnp.ndarray                # stacked i32[P, n_aug, Ktot]
    maw: object                     # stacked MawData or None
    lak: object
    sfr: object
    own: jnp.ndarray                # bool[P, n_aug]
    halo_perms: tuple               # static ppermute perms per shift
    halo_send: tuple                # [P, S_d] per shift (aug rows)
    halo_recv: tuple
    owner_feat: np.ndarray          # i64[R]
    n_aug: int
    aug: object                     # the global AugmentedGwfModel


def partition_augmented(aug: AugmentedGwfModel, nshards, owner=None):
    """Split an augmented model: cells by blocks, features to their host
    cell's shard, full feature tables replicated."""
    if aug.mvr is not None:
        raise NotImplementedError(
            "sharded augmented models do not distribute MVR yet")
    base = aug.base
    N = base.nodes
    if owner is None:
        bounds = np.linspace(0, N, nshards + 1).astype(np.int64)
        owner = np.zeros(N, np.int64)
        for p in range(nshards):
            owner[bounds[p]:bounds[p + 1]] = p
    else:
        owner = np.asarray(owner, np.int64)

    feats = _feature_table(aug)
    R = aug.n_extra
    assert len(feats) == R
    owner_feat = np.asarray([owner[host] for _, _, host, _ in feats],
                            np.int64)
    extra_halo = {p: set() for p in range(nshards)}
    for f, (_, _, host, cells) in enumerate(feats):
        p = int(owner_feat[f])
        for c in np.asarray(cells):
            extra_halo[p].add(int(c))

    part = partition_general(base, nshards, owner=owner,
                             extra_halo=extra_halo)
    n_local = part.n_local
    n_aug = n_local + R

    # ---- per-shard augmented builds (two passes to equalize Ktot)
    def build_shard(p, ktot_min):
        loc, g2l, _ = part.locals_info[p]
        nl = len(loc)
        npad = n_local - nl
        counter = [0]

        def map_cell(arr):
            out = np.empty(arr.shape, np.int64)
            flat = out.reshape(-1)
            aflat = np.asarray(arr).reshape(-1)
            for i, c in enumerate(aflat):
                li = g2l.get(int(c), -1)
                if li < 0:
                    li = nl + (counter[0] % max(npad, 1))
                    counter[0] += 1
                flat[i] = li
            return out

        shim = _BaseShim(n_local,
                         np.asarray(jax.tree.map(lambda a: a[p],
                                                 part.dtopo).nbr))
        kw = {}
        for kind in ("maw", "lak", "sfr"):
            d = getattr(aug, kind)
            kw[kind] = _spec_from_data(kind, d, map_cell) \
                if d is not None else None
        return AugmentedGwfModel(shim, ktot_min=ktot_min, **kw)

    models = [build_shard(p, 0) for p in range(nshards)]
    kmax = max(m.Ktot for m in models)
    models = [m if m.Ktot == kmax else build_shard(p, kmax)
              for p, m in enumerate(models)]
    t0 = models[0]
    for m in models[1:]:
        assert m.Ktot == t0.Ktot and m.n_extra == t0.n_extra
        if m.lak is not None:
            assert m.lak.out_slot == t0.lak.out_slot, \
                "outlet slot layout diverged across shards"

    nbr_st = jnp.stack([m.dtopo.nbr for m in models])
    maw_st = _stack([m.maw for m in models]) if t0.maw is not None else None
    lak_st = _stack([m.lak for m in models]) if t0.lak is not None else None
    sfr_st = _stack([m.sfr for m in models]) if t0.sfr is not None else None

    # ---- ownership over aug rows
    own = np.zeros((nshards, n_aug), bool)
    own[:, :n_local] = np.asarray(part.own)
    for f in range(R):
        own[owner_feat[f], n_local + f] = True

    # ---- halo maps over aug rows: cell pairs + feature broadcasts
    from .general import build_shift_maps
    pairs = {}
    for q in range(nshards):
        loc, _, _ = part.locals_info[q]
        owned_ct = int(np.asarray(part.own)[q].sum())
        for g in loc[owned_ct:]:
            p = int(owner[int(g)])
            pairs.setdefault((p, q), []).append(
                (part.g2l_list[p][int(g)], part.g2l_list[q][int(g)]))
    for f in range(R):
        p = int(owner_feat[f])
        for q in range(nshards):
            if q == p:
                continue
            pairs.setdefault((p, q), []).append(
                (n_local + f, n_local + f))
    pairs_arr = {
        pq: (np.asarray([s for s, _ in lst], np.int64),
             np.asarray([r for _, r in lst], np.int64))
        for pq, lst in pairs.items()}
    perms, sends, recvs = build_shift_maps(pairs_arr, nshards, n_aug)

    return AugmentedPartition(
        part=part, template=t0, nbr=nbr_st, maw=maw_st, lak=lak_st,
        sfr=sfr_st, own=jnp.asarray(own),
        halo_perms=perms, halo_send=sends, halo_recv=recvs,
        owner_feat=owner_feat, n_aug=n_aug, aug=aug)


class ShardedAugmentedSolution:
    """Solves time steps of a sharded augmented model on a 1-D mesh."""

    def __init__(self, apart: AugmentedPartition, settings: ImsSettings,
                 mesh=None):
        self.apart = apart
        self.s = settings
        if mesh is None:
            devs = np.array(jax.devices()[:apart.part.nshards])
            mesh = Mesh(devs, ("y",))
        assert mesh.devices.size == apart.part.nshards
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
        ap = self.apart
        part = ap.part
        model = part.model
        template = ap.template
        s = self.s
        use_cg = s.linear_acceleration == "cg"

        def shard_fn(x0, dtopo, arrays, sarr, ib0, strt, area, own,
                     hsend, hrecv, pkgs, aug_nbr, maw, lak, sfr,
                     delt, kstp, iss):
            sq = lambda t: jax.tree.map(lambda a: a[0], t)   # noqa: E731
            x = sq(x0)
            own_l = sq(own)
            hsend_l = sq(hsend)
            hrecv_l = sq(hrecv)
            pkgs_l = {k: (sq(v) if v is not None else None)
                      for k, v in pkgs.items()}
            lm_base = dataclasses.replace(
                model, grid=_AreaShim(sq(area)), topo=None,
                dtopo=sq(dtopo), npf_arrays=sq(arrays),
                sto_arrays=sq(sarr) if sarr is not None else None,
                xt3d=None, strt=sq(strt), ibound0=sq(ib0), condsat3=None,
                delr=None, delc=None, hfb=None, **pkgs_l)
            lm = copy.copy(template)
            lm.base = lm_base
            lm.dtopo = AugTopo(nbr=sq(aug_nbr))
            lm.maw = sq(maw) if maw is not None else None
            lm.lak = sq(lak) if lak is not None else None
            lm.sfr = sq(sfr) if sfr is not None else None

            def halo(v):
                from .general import halo_exchange_shifts
                return halo_exchange_shifts(v, ap.halo_perms, hsend_l,
                                            hrecv_l)

            def dot(a, b):
                return lax.psum(jnp.sum(jnp.where(own_l, a * b, DZERO)),
                                "y")

            def absmax(v):
                return lax.pmax(
                    jnp.max(jnp.abs(jnp.where(own_l, v, DZERO))), "y")

            ibound, x = lm.boundary_state(x)
            x = halo(x)
            x_old = x
            x, kiter, converged, inner = implicit_local_solve(
                lm, x, x_old, ibound, delt, iss, s, use_cg,
                halo, dot, absmax, kstp, own_l)
            return (x[None], kiter[None], converged[None], inner[None])

        def step(x_stacked, sarr, pkgs, delt, kstp, iss: bool):
            sp = P("y")
            rep = P()

            def like(tree, spec):
                return jax.tree.map(lambda _: spec, tree)

            from functools import partial as _part
            fn = _part(shard_fn, iss=iss)
            in_specs = (sp, like(part.dtopo, sp),
                        like(part.npf_arrays, sp), like(sarr, sp), sp,
                        sp, sp, sp, like(ap.halo_send, sp),
                        like(ap.halo_recv, sp), like(pkgs, sp), sp,
                        like(ap.maw, sp), like(ap.lak, sp),
                        like(ap.sfr, sp), rep, rep)
            out_specs = (sp, sp, sp, sp)
            sm = shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                           out_specs=out_specs)
            return sm(x_stacked, part.dtopo, part.npf_arrays, sarr,
                      part.ibound0, part.strt, part.area, ap.own,
                      ap.halo_send, ap.halo_recv, pkgs, ap.nbr, ap.maw,
                      ap.lak, ap.sfr, delt, kstp)

        return step

    # ---------------------------------------------------------- driving

    def solve_timestep(self, x_stacked, delt, kstp=1, iss=False):
        x, kiter, converged, inner = self._step(
            x_stacked, self.apart.part.sto_arrays, self.apart.part.pkgs,
            jnp.asarray(delt), jnp.asarray(kstp, jnp.int32), iss=bool(iss))
        return x, dict(outer=int(np.asarray(kiter).max()),
                       converged=bool(np.asarray(converged).all()),
                       inner=int(np.asarray(inner).max()))

    def scatter(self, x_global):
        """Global augmented vector [N+R] → stacked [P, n_aug]."""
        ap = self.apart
        part = ap.part
        N = part.model.nodes
        g = np.asarray(x_global).reshape(-1)
        out = np.zeros((part.nshards, ap.n_aug))
        for p in range(part.nshards):
            loc = part.local2global[p]
            sel = loc >= 0
            out[p, :part.n_local][sel] = g[loc[sel]]
            out[p, part.n_local:] = g[N:]
        return jnp.asarray(out)

    def gather(self, x_stacked):
        ap = self.apart
        part = ap.part
        N = part.model.nodes
        xs = np.asarray(x_stacked)
        own = np.asarray(part.own)
        out = np.zeros(N + ap.n_aug - part.n_local)
        for p in range(part.nshards):
            sel = own[p]
            out[part.local2global[p][sel]] = xs[p, :part.n_local][sel]
        for f, p in enumerate(ap.owner_feat):
            out[N + f] = xs[p, part.n_local + f]
        return out
