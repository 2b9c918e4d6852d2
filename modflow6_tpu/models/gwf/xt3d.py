"""XT3D full-tensor flux approximation, vectorized over connections.

Behavioral parity targets in the reference:
  - coefficient math      src/Model/ModelUtilities/Xt3dAlgorithm.f90:47-490
    (qconds/abhats/getrot/tranvc/abwts)
  - assembly              src/Model/ModelUtilities/Xt3dInterface.f90:371-494
    (xt3d_fc), :1382-1433 (amat_nbrs/nbrnbrs), :1522-1544 (xt3d_rhs)
  - geometry loading      Xt3dInterface.f90:1211-1273 (xt3d_load),
    :1300-1378 (xt3d_areas), :1577-1611 (xt3d_fillrmatck);
    Dis.f90:1039-1160 / Disv.f90:979-1080 (connection normal/vector)

Redesign: the reference loops cells×neighbors with scalar work arrays;
here every per-connection quantity is an [E] or [E, K] array aligned with
the ELL neighbor table, and the whole coefficient computation (rotation
matrices, omega weights, 2×2 solves, sigma products) is one batched einsum
pipeline per Picard iteration — no gather chains beyond the fixed-K
neighbor lookups.

Full-matrix mode (ixt3d=1) needs the depth-2 stencil: the neighbor table
is extended with neighbors-of-neighbors (host-built), the assembled
off-diagonal block is [N, K+K2], and SpMV/apply_dirichlet work unchanged
on the wider table.  RHS mode (ixt3d=2) keeps the depth-1 stencil and
moves the perpendicular-gradient terms to the right-hand side.

Geometry simplifications vs the reference (documented, test-covered):
connection vectors use full-saturation cell-center elevations (exact for
confined cells; the reference recomputes z midpoints from current
saturation), and XT3D+Newton (xt3d_fn) is not yet implemented — XT3D
models solve with Picard/BiCGSTAB.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_TINY = 1e-300


@partial(jax.tree_util.register_dataclass,
         data_fields=["nbr", "valid0", "vc", "vn", "dl", "dln", "allhc",
                      "ck", "top", "bot", "edge_n", "edge_m", "k_nm", "k_mn",
                      "ihc_e", "hwva_e", "pos_n_jm", "pos_m_in", "nbr_ext"],
         meta_fields=["ixt3d", "vcthresh"])
@dataclasses.dataclass(frozen=True)
class Xt3dData:
    """Static XT3D geometry + tensor data (host-built, device-resident)."""

    nbr: jax.Array       # i32[N, K] depth-1 neighbor table (self-padded)
    valid0: jax.Array    # bool[N, K] structural validity
    vc: jax.Array        # f64[N, K, 3] unit connection vectors (cell→nbr)
    vn: jax.Array        # f64[N, K, 3] unit face normals (cell→nbr)
    dl: jax.Array        # f64[N, K] connection length, cell side
    dln: jax.Array       # f64[N, K] connection length, neighbor side
    allhc: jax.Array     # bool[N] all connections horizontal
    ck: jax.Array        # f64[N, 3, 3] conductivity tensors
    top: jax.Array       # f64[N]
    bot: jax.Array       # f64[N]
    edge_n: jax.Array    # i32[E]
    edge_m: jax.Array    # i32[E]
    k_nm: jax.Array      # i32[E] slot of m in n's neighbor list
    k_mn: jax.Array      # i32[E] slot of n in m's neighbor list
    ihc_e: jax.Array     # i32[E]
    hwva_e: jax.Array    # f64[E]
    pos_n_jm: jax.Array  # i32[E, K] flat (N*Ktot) slot of col nbr[m,k] in row n
    pos_m_in: jax.Array  # i32[E, K] flat slot of col nbr[n,k] in row m
    nbr_ext: jax.Array   # i32[N, Ktot] extended (depth-2) neighbor table
    ixt3d: int = 1       # 1=full matrix, 2=rhs-only
    vcthresh: float = 0.0


# --------------------------------------------------------------- host build

def cell_centers(grid):
    """(x, y, z) cell centers; y decreases with row index so that the
    reference's 'back' (i2<i1) direction is +y (Dis.f90:1150-1156)."""
    from ..discretization.dis import DisGrid
    from ..discretization.disv import DisvGrid

    top = np.asarray(grid.top, np.float64)
    bot = np.asarray(grid.bot, np.float64)
    z = 0.5 * (top + bot)
    if isinstance(grid, DisGrid):
        delr = np.asarray(grid.delr, np.float64)
        delc = np.asarray(grid.delc, np.float64)
        xcol = np.cumsum(delr) - 0.5 * delr
        yrow = -(np.cumsum(delc) - 0.5 * delc)
        nlay, nrow, ncol = grid.shape
        x = np.tile(xcol[None, None, :], (nlay, nrow, 1)).reshape(-1)
        y = np.tile(yrow[None, :, None], (nlay, 1, ncol)).reshape(-1)
        return x, y, z
    if isinstance(grid, DisvGrid):
        x = np.tile(np.asarray(grid.xc, np.float64), grid.nlay)
        y = np.tile(np.asarray(grid.yc, np.float64), grid.nlay)
        return x, y, z
    # DISU: user-supplied centers required
    if hasattr(grid, "xc") and getattr(grid, "xc", None) is not None:
        return (np.asarray(grid.xc, np.float64),
                np.asarray(grid.yc, np.float64), z)
    raise ValueError("XT3D on DISU requires cell center coordinates")


def _tensor(n, k11, k22, k33, angle1, angle2, angle3):
    """Per-cell rotated conductivity tensors (xt3d_fillrmatck,
    Xt3dInterface.f90:1577-1611; angles in degrees as in the npf input)."""
    def full(v):
        return np.broadcast_to(np.asarray(v, np.float64), (n,))

    a1 = np.deg2rad(full(angle1))
    a2 = np.deg2rad(full(angle2))
    a3 = np.deg2rad(full(angle3))
    s1, c1 = np.sin(a1), np.cos(a1)
    s2, c2 = np.sin(a2), np.cos(a2)
    s3, c3 = np.sin(a3), np.cos(a3)
    r = np.zeros((n, 3, 3))
    r[:, 0, 0] = c1 * c2
    r[:, 0, 1] = c1 * s2 * s3 - s1 * c3
    r[:, 0, 2] = -c1 * s2 * c3 - s1 * s3
    r[:, 1, 0] = s1 * c2
    r[:, 1, 1] = s1 * s2 * s3 + c1 * c3
    r[:, 1, 2] = -s1 * s2 * c3 + c1 * s3
    r[:, 2, 0] = s2
    r[:, 2, 1] = -c2 * s3
    r[:, 2, 2] = c2 * c3
    kd = np.zeros((n, 3, 3))
    kd[:, 0, 0] = full(k11)
    kd[:, 1, 1] = full(k22)
    kd[:, 2, 2] = full(k33)
    return np.einsum("nij,njk,nlk->nil", r, kd, r)


def build_xt3d(grid, topo, k11, k22, k33, angle1=0.0, angle2=0.0,
               angle3=0.0, ixt3d=1, ktot_min=0) -> Xt3dData:
    """Host-side geometry/tensor preparation (xt3d_df + xt3d_load roles).
    ``ktot_min``: pad the extended-table width (sharded solves need one
    common width across shards)."""
    N = topo.nodes
    E = topo.nedges
    K = topo.max_degree
    en = topo.edge_n.astype(np.int64)
    em = topo.edge_m.astype(np.int64)
    k_nm = (topo.slot_nm.astype(np.int64) - en * K).astype(np.int32)
    k_mn = (topo.slot_mn.astype(np.int64) - em * K).astype(np.int32)
    x, y, z = cell_centers(grid)
    top = np.asarray(grid.top, np.float64)
    bot = np.asarray(grid.bot, np.float64)

    ihc = np.asarray(topo.ihc)
    horiz = ihc != 0
    dx = np.where(horiz, x[em] - x[en], 0.0)
    dy = np.where(horiz, y[em] - y[en], 0.0)
    dz = z[em] - z[en]
    # connection vector n→m at full saturation (connection_vector,
    # Dis.f90:1094-1160 with satn=satm=1)
    conlen_h = np.sqrt(dx * dx + dy * dy + dz * dz)
    conlen = np.where(horiz, conlen_h, np.abs(dz))
    conlen = np.where(conlen > 0.0, conlen, 1.0)
    vcx = np.where(horiz, dx / conlen, 0.0)
    vcy = np.where(horiz, dy / conlen, 0.0)
    vcz = np.where(horiz, dz / conlen, np.sign(dz))
    vc_e = np.stack([vcx, vcy, vcz], axis=1)
    # face normal n→m (connection_normal): horizontal from ANGLDEGX,
    # vertical ±z
    ang = np.asarray(topo.anglex)
    vn_e = np.stack([np.where(horiz, np.cos(ang), 0.0),
                     np.where(horiz, np.sin(ang), 0.0),
                     np.where(horiz, 0.0, np.sign(dz))], axis=1)
    clsum = np.asarray(topo.cl1) + np.asarray(topo.cl2)
    clsum = np.where(clsum > 0.0, clsum, 1.0)
    dl_n = conlen * np.asarray(topo.cl1) / clsum
    dl_m = conlen * np.asarray(topo.cl2) / clsum

    nbr = np.asarray(topo.nbr)
    valid0 = nbr != np.arange(N, dtype=nbr.dtype)[:, None]
    vc = np.zeros((N, K, 3))
    vn = np.zeros((N, K, 3))
    dl = np.ones((N, K))
    dln = np.ones((N, K))
    vc[en, k_nm] = vc_e
    vc[em, k_mn] = -vc_e
    vn[en, k_nm] = vn_e
    vn[em, k_mn] = -vn_e
    dl[en, k_nm] = dl_n
    dln[en, k_nm] = dl_m
    dl[em, k_mn] = dl_m
    dln[em, k_mn] = dl_n
    allhc = np.ones(N, bool)
    vert = ~horiz
    allhc[en[vert]] = False
    allhc[em[vert]] = False

    ck = _tensor(N, k11, k22, k33, angle1, angle2, angle3)

    # extended (depth-2) neighbor table + cross scatter positions
    if ixt3d == 1:
        depth1 = [dict() for _ in range(N)]
        for row in range(N):
            for s in range(K):
                j = int(nbr[row, s])
                if j != row:
                    depth1[row][j] = s
        ext = [dict() for _ in range(N)]
        for e in range(E):
            nn, mm = int(en[e]), int(em[e])
            for s in range(K):
                j = int(nbr[mm, s])
                if j != mm and j != nn and j not in depth1[nn] and \
                        j not in ext[nn]:
                    ext[nn][j] = len(ext[nn])
                i = int(nbr[nn, s])
                if i != nn and i != mm and i not in depth1[mm] and \
                        i not in ext[mm]:
                    ext[mm][i] = len(ext[mm])
        K2 = max((len(d) for d in ext), default=0)
        Ktot = max(K + K2, ktot_min)
        nbr_ext = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, Ktot))
        nbr_ext[:, :K] = nbr
        for row, d in enumerate(ext):
            for col, s in d.items():
                nbr_ext[row, K + s] = col
        sentinel = N * Ktot
        pos_n_jm = np.full((E, K), sentinel, np.int64)
        pos_m_in = np.full((E, K), sentinel, np.int64)
        for e in range(E):
            nn, mm = int(en[e]), int(em[e])
            for s in range(K):
                j = int(nbr[mm, s])
                if j != mm and j != nn:
                    sl = depth1[nn].get(j)
                    sl = (K + ext[nn][j]) if sl is None else sl
                    pos_n_jm[e, s] = nn * Ktot + sl
                i = int(nbr[nn, s])
                if i != nn and i != mm:
                    sl = depth1[mm].get(i)
                    sl = (K + ext[mm][i]) if sl is None else sl
                    pos_m_in[e, s] = mm * Ktot + sl
    else:
        nbr_ext = nbr.astype(np.int32)
        sentinel = N * K
        pos_n_jm = np.full((E, K), sentinel, np.int64)
        pos_m_in = np.full((E, K), sentinel, np.int64)

    return Xt3dData(
        nbr=jnp.asarray(nbr, jnp.int32), valid0=jnp.asarray(valid0),
        vc=jnp.asarray(vc), vn=jnp.asarray(vn), dl=jnp.asarray(dl),
        dln=jnp.asarray(dln), allhc=jnp.asarray(allhc), ck=jnp.asarray(ck),
        top=jnp.asarray(top), bot=jnp.asarray(bot),
        edge_n=jnp.asarray(en, jnp.int32), edge_m=jnp.asarray(em, jnp.int32),
        k_nm=jnp.asarray(k_nm), k_mn=jnp.asarray(k_mn),
        ihc_e=jnp.asarray(ihc, jnp.int32),
        hwva_e=jnp.asarray(np.asarray(topo.hwva)),
        pos_n_jm=jnp.asarray(pos_n_jm, jnp.int32),
        pos_m_in=jnp.asarray(pos_m_in, jnp.int32),
        nbr_ext=jnp.asarray(nbr_ext, jnp.int32),
        ixt3d=int(ixt3d), vcthresh=0.0)


# ------------------------------------------------------------ device math

def _abwts(vccde, nde1, valid, dl, dln, dl01, vcthresh):
    """Vectorized abwts (Xt3dAlgorithm.f90:389-490): omega/b/a weights for
    the perpendicular direction nde1 (1='d', 2='e')."""
    nde2 = 3 - nde1
    comp = vccde[..., nde1]
    acomp = jnp.abs(comp)
    vcmx = jnp.max(jnp.where(valid, acomp, 0.0), axis=1)
    dlm = 0.5 * (dl + dln)
    cosang = vccde[..., 0]
    d01 = dl01[:, None]
    dl4wt = jnp.sqrt(jnp.maximum(
        dlm * dlm + d01 * d01 - 2.0 * dlm * d01 * cosang, 0.0))
    omwt = jnp.where(valid, acomp * dl4wt, 0.0)
    dsum = omwt.sum(axis=1) * (1.0 + 1e-10)
    omwt = jnp.where(valid, (dsum[:, None] - omwt) * acomp, 0.0)
    bd = omwt * jnp.sign(comp)
    dsum2 = (omwt * acomp).sum(axis=1)
    bd = bd / jnp.maximum(dsum2, _TINY)[:, None]
    acd = (bd * vccde[..., 0]).sum(axis=1)
    aed = (bd * vccde[..., nde2]).sum(axis=1)
    if vcthresh > 0.0:
        fatten = jnp.where(vcmx < vcthresh, vcmx / vcthresh, 1.0)
        acd, aed, bd = acd * fatten, aed * fatten, bd * fatten[:, None]
    return acd, jnp.ones_like(acd), aed, bd


def _abhats(vc, vn01, dl, dln, ck, valid, il01_oh, allhc, ar, dl01,
            vcthresh):
    """Vectorized abhats (Xt3dAlgorithm.f90:127-265) for one side of every
    interface at once.  Shapes: vc [E,K,3], vn01 [E,3], ck [E,3,3]."""
    vcc = (vc * il01_oh[..., None]).sum(axis=1)                     # [E,3]
    cmp = jnp.einsum("ekc,ec->ek", vc, vcc)
    acmp = jnp.where(valid, jnp.abs(cmp), 2.0)
    iml = jnp.argmin(acmp, axis=1)
    acmpmn = jnp.take_along_axis(acmp, iml[:, None], 1)[:, 0]
    found = acmpmn < (1.0 - 1e-10)
    cmpmn = jnp.take_along_axis(cmp, iml[:, None], 1)[:, 0]
    vcmax = jnp.take_along_axis(vc, iml[:, None, None], 1)[:, 0, :]
    dnm = jnp.sqrt(jnp.maximum(1.0 - cmpmn * cmpmn, _TINY))
    vcd = (vcmax - cmpmn[:, None] * vcc) / dnm[:, None]
    vce = jnp.cross(vcc, vcd)
    rmat = jnp.stack([vcc, vcd, vce], axis=-1)                      # [E,3,3]
    vccde = jnp.einsum("ekc,ecd->ekd", vc, rmat)
    acd, add, aed, bd = _abwts(vccde, 1, valid, dl, dln, dl01, vcthresh)
    iscomp = jnp.any(valid & (jnp.abs(vccde[..., 2]) > 1e-10), axis=1)
    ace0, aee0, ade0, be0 = _abwts(vccde, 2, valid, dl, dln, dl01, vcthresh)
    use_e = (~allhc) & iscomp
    ace = jnp.where(use_e, ace0, 0.0)
    aee = jnp.where(use_e, aee0, 1.0)
    ade = jnp.where(use_e, ade0, 0.0)
    be = jnp.where(use_e[:, None], be0, 0.0)
    determ = add * aee - ade * aed
    oodet = 1.0 / jnp.where(jnp.abs(determ) > _TINY, determ, 1.0)
    alphad = (acd * aee - ace * aed) * oodet
    alphae = (ace * add - acd * ade) * oodet
    betad = (bd * aee[:, None] - be * aed[:, None]) * oodet[:, None]
    betae = (be * add[:, None] - bd * ade[:, None]) * oodet[:, None]
    vnck = jnp.einsum("ec,ecd->ed", vn01, ck)
    sigma = jnp.einsum("ec,ecd->ed", vnck, rmat)
    ahat_f = (sigma[:, 0] - sigma[:, 1] * alphad
              - sigma[:, 2] * alphae) / dl01
    bhat_f = jnp.where(valid,
                       (sigma[:, 1, None] * betad + sigma[:, 2, None] * betae)
                       / jnp.maximum(dl + dln, _TINY), 0.0)
    sigma1_nf = jnp.einsum("ec,ec->e", vnck, vcc)
    ahat = jnp.where(found, ahat_f, sigma1_nf / dl01)
    bhat = jnp.where(found[:, None], bhat_f, 0.0)
    return ahat * ar, bhat * ar[:, None]


def _areas(d: Xt3dData, sat):
    """Interfacial areas, non-Newton branch (xt3d_areas,
    Xt3dInterface.f90:1300-1378)."""
    n, m = d.edge_n, d.edge_m
    thksatn = sat[n] * (d.top[n] - d.bot[n])
    thksatm = sat[m] * (d.top[m] - d.bot[m])
    stag = d.ihc_e == 2
    sill_top = jnp.minimum(d.top[n], d.top[m])
    sill_bot = jnp.maximum(d.bot[n], d.bot[m])
    tpn = d.bot[n] + thksatn
    tpm = d.bot[m] + thksatm
    thksatn = jnp.where(
        stag, jnp.maximum(jnp.minimum(tpn, sill_top) - sill_bot, 0.0),
        thksatn)
    thksatm = jnp.where(
        stag, jnp.maximum(jnp.minimum(tpm, sill_top) - sill_bot, 0.0),
        thksatm)
    vert = d.ihc_e == 0
    ar01 = jnp.where(vert, d.hwva_e, d.hwva_e * thksatn)
    ar10 = jnp.where(vert, d.hwva_e, d.hwva_e * thksatm)
    return ar01, ar10


def xt3d_chats(d: Xt3dData, ibound, sat, areas=None):
    """chat01 [E], chati0 [E,K], chat1j [E,K] (qconds,
    Xt3dAlgorithm.f90:47-123) for every interface at once.
    ``areas``: optional (ar01, ar10) override (Newton unit-area pass)."""
    K = d.nbr.shape[1]
    n, m = d.edge_n, d.edge_m
    act = ibound != 0
    ar01, ar10 = _areas(d, sat) if areas is None else areas
    oh = jnp.arange(K, dtype=jnp.int32)[None, :]
    oh_n = oh == d.k_nm[:, None]
    oh_m = oh == d.k_mn[:, None]

    def side(cell, oh_c, ar, k_slot):
        nbr_c = d.nbr[cell]
        valid = d.valid0[cell] & act[nbr_c] & ~oh_c
        dl01 = jnp.take_along_axis(d.dl[cell], k_slot[:, None], 1)[:, 0]
        vn01 = jnp.take_along_axis(
            d.vn[cell], k_slot[:, None, None], 1)[:, 0, :]
        return _abhats(d.vc[cell], vn01, d.dl[cell], d.dln[cell], d.ck[cell],
                       valid, oh_c, d.allhc[cell], ar, dl01, d.vcthresh)

    ahat0, bhat0 = side(n, oh_n, ar01, d.k_nm)
    ahat1, bhat1 = side(m, oh_m, ar10, d.k_mn)
    denom = ahat0 + ahat1
    wght1 = jnp.where(jnp.abs(denom) > 1e-40, ahat0 / denom, 1.0)
    wght0 = 1.0 - wght1
    live = (act[n] & act[m] & (ar01 > 0.0)).astype(ahat0.dtype)
    chat01 = wght1 * ahat1 * live
    chati0 = wght0[:, None] * bhat0 * live[:, None]
    chat1j = wght1[:, None] * bhat1 * live[:, None]
    return chat01, chati0, chat1j


def _fill(d: Xt3dData, head, chat01, chati0, chat1j):
    """Matrix/rhs fill from interface coefficients (the xt3d_amat* /
    xt3d_rhs family); shared by the Picard and Newton assemblies."""
    N, K = d.nbr.shape
    Ktot = d.nbr_ext.shape[1]
    n, m = d.edge_n, d.edge_m
    s0 = chati0.sum(axis=1)
    s1 = chat1j.sum(axis=1)
    diag = jnp.zeros(N).at[n].add(-chat01).at[m].add(-chat01)
    offf = jnp.zeros(N * Ktot)
    flat_nm = n.astype(jnp.int32) * Ktot + d.k_nm
    flat_mn = m.astype(jnp.int32) * Ktot + d.k_mn
    rhs = jnp.zeros(N)
    if d.ixt3d == 1:
        diag = diag.at[n].add(-s0).at[m].add(-s1)
        offf = offf.at[flat_nm].add(chat01 + s1)
        offf = offf.at[flat_mn].add(chat01 + s0)
        ar = jnp.arange(K, dtype=jnp.int32)[None, :]
        idx_nk = (n[:, None] * Ktot + ar).reshape(-1)
        idx_mk = (m[:, None] * Ktot + ar).reshape(-1)
        offf = offf.at[idx_nk].add(chati0.reshape(-1))
        offf = offf.at[idx_mk].add(chat1j.reshape(-1))
        offf = offf.at[d.pos_n_jm.reshape(-1)].add(
            -chat1j.reshape(-1), mode="drop")
        offf = offf.at[d.pos_m_in.reshape(-1)].add(
            -chati0.reshape(-1), mode="drop")
    else:
        offf = offf.at[flat_nm].add(chat01)
        offf = offf.at[flat_mn].add(chat01)
        # xt3d_rhs: move perpendicular terms to the right-hand side
        hn = head[n][:, None]
        hm = head[m][:, None]
        t_n = (chati0 * (head[d.nbr[n]] - hn)).sum(axis=1)
        t_m = (chat1j * (head[d.nbr[m]] - hm)).sum(axis=1)
        rhs = rhs.at[n].add(-t_n + t_m).at[m].add(t_n - t_m)
    return diag, offf, rhs


def assemble(d: Xt3dData, head, ibound, sat):
    """(diag, off, rhs) XT3D contributions (xt3d_fc assembly).

    Full mode returns off over the extended table [N, K+K2]; RHS mode over
    the depth-1 table with the neighbor terms moved to rhs."""
    N = d.nbr.shape[0]
    Ktot = d.nbr_ext.shape[1]
    chat01, chati0, chat1j = xt3d_chats(d, ibound, sat)
    diag, offf, rhs = _fill(d, head, chat01, chati0, chat1j)
    return diag, offf.reshape(N, Ktot), rhs


def _areas_newton(d: Xt3dData, sat, head):
    """Newton-branch interfacial areas (xt3d_areas inewton path,
    Xt3dInterface.f90:1318-1351): mean full-saturation thickness area,
    then upstream-saturation scaling; ar10 = ar01."""
    n, m = d.edge_n, d.edge_m
    thkn = d.top[n] - d.bot[n]
    thkm = d.top[m] - d.bot[m]
    stag = d.ihc_e == 2
    sill_top = jnp.minimum(d.top[n], d.top[m])
    sill_bot = jnp.maximum(d.bot[n], d.bot[m])
    tpn = d.bot[n] + thkn
    tpm = d.bot[m] + thkm
    thkn = jnp.where(
        stag, jnp.maximum(jnp.minimum(tpn, sill_top) - sill_bot, 0.0),
        thkn)
    thkm = jnp.where(
        stag, jnp.maximum(jnp.minimum(tpm, sill_top) - sill_bot, 0.0),
        thkm)
    vert = d.ihc_e == 0
    ar_full = jnp.where(vert, d.hwva_e,
                        d.hwva_e * 0.5 * (thkn + thkm))
    sat_up = jnp.where(head[m] < head[n], sat[n], sat[m])
    ar_act = jnp.where(vert, ar_full, ar_full * sat_up)
    return ar_full, ar_act


def assemble_newton(d: Xt3dData, head, ibound, sat, icelltype,
                    add_fn: bool = True):
    """Newton XT3D system (xt3d_fc inewton branch + xt3d_fn,
    Xt3dInterface.f90:440-470 + 693-793).

    Coefficients are computed at unit interface area, the saturated flow
    qsat = q(unit)·area(full saturation) is saved per connection, the
    matrix fill uses area(full)·sat(upstream), and the Newton terms add
    qsat·∂sat/∂h(upstream) on the upstream column with the matching rhs
    shift.  ``add_fn=False`` gives the residual-consistent system
    without the Jacobian terms (sln_buildsystem inewton=0 role)."""
    from ...ops.smoothing import quadratic_saturation_derivative
    N = d.nbr.shape[0]
    Ktot = d.nbr_ext.shape[1]
    n, m = d.edge_n, d.edge_m
    ar_full, ar_act = _areas_newton(d, sat, head)
    ones = jnp.ones_like(ar_full)
    chat01u, chati0u, chat1ju = xt3d_chats(d, ibound, sat,
                                           areas=(ones, ones))
    hn, hm = head[n], head[m]
    qn = (chati0u * (head[d.nbr[n]] - hn[:, None])).sum(axis=1)
    qm = (chat1ju * (head[d.nbr[m]] - hm[:, None])).sum(axis=1)
    qsat = (chat01u * (hm - hn) + qn - qm) * ar_full
    chat01 = chat01u * ar_act
    chati0 = chati0u * ar_act[:, None]
    chat1j = chat1ju * ar_act[:, None]
    diag, offf, rhs = _fill(d, head, chat01, chati0, chat1j)
    if add_fn:
        up_is_n = hm < hn
        up = jnp.where(up_is_n, n, m)
        stag = d.ihc_e == 2
        topup = jnp.where(stag, jnp.minimum(d.top[n], d.top[m]),
                          d.top[up])
        botup = jnp.where(stag, jnp.maximum(d.bot[n], d.bot[m]),
                          d.bot[up])
        derv = quadratic_saturation_derivative(topup, botup, head[up])
        skip = (icelltype[up] == 0) & (d.ixt3d == 1)
        act = (ibound[n] != 0) & (ibound[m] != 0) & ~skip
        term = jnp.where(act, qsat * derv, 0.0)
        hup = head[up]
        flat_nm = n.astype(jnp.int32) * Ktot + d.k_nm
        flat_mn = m.astype(jnp.int32) * Ktot + d.k_mn
        diag = diag.at[n].add(jnp.where(up_is_n, term, 0.0))
        offf = offf.at[flat_mn].add(jnp.where(up_is_n, -term, 0.0))
        offf = offf.at[flat_nm].add(jnp.where(up_is_n, 0.0, term))
        diag = diag.at[m].add(jnp.where(up_is_n, 0.0, -term))
        rhs = rhs.at[n].add(term * hup).at[m].add(-term * hup)
    return diag, offf.reshape(N, Ktot), rhs


def edge_flows(d: Xt3dData, head, ibound, sat, newton=False):
    """Per-edge flow q_nm (positive into n) for budget/flowja output
    (xt3d_flowja, Xt3dInterface.f90; same expression as the Newton qnm
    in xt3d_fc:455-465).  ``newton`` switches to the upstream-saturation
    area convention so budgets match the Newton system."""
    n, m = d.edge_n, d.edge_m
    if newton:
        _, ar_act = _areas_newton(d, sat, head)
        chat01, chati0, chat1j = xt3d_chats(d, ibound, sat,
                                            areas=(ar_act, ar_act))
    else:
        chat01, chati0, chat1j = xt3d_chats(d, ibound, sat)
    qn = (chati0 * (head[d.nbr[n]] - head[n][:, None])).sum(axis=1)
    qm = (chat1j * (head[d.nbr[m]] - head[m][:, None])).sum(axis=1)
    return chat01 * (head[m] - head[n]) + qn - qm
