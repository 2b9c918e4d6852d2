"""Grid connection topology: the CSR/ELL structure every stencil kernel uses.

Equivalent in capability to the reference's ConnectionsType
(src/Model/ModelUtilities/Connections.f90:19-55): per-connection geometry
arrays (cl1/cl2/hwva/ihc) over the symmetric half of the adjacency, plus the
full CSR pattern.  Redesigned for accelerators:

- the *symmetric-half edge list* (arrays over edges, n < m) drives vectorized
  conductance computation (one vectorized pass over all connections at once);
- an *ELL packing* (fixed max-degree neighbor table) stores the assembled
  off-diagonal coefficients so SpMV is K gathers + K fused multiply-adds with
  fully static shapes — no CSR row pointers on device;
- precomputed *edge→ELL-slot* scatter maps let assembly write each
  coefficient exactly once (unique-index scatter, no atomics).

Topology construction happens once on host in numpy; only the arrays the
kernels need are shipped to device.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static connection topology over ``nodes`` cells.

    Edge arrays are over the symmetric half (each connection appears once,
    with ``n < m``), sorted lexicographically by (n, m) to match the
    reference's CSR ordering of the upper triangle.
    """

    nodes: int
    edge_n: np.ndarray  # int32[E] lower-numbered cell of each connection
    edge_m: np.ndarray  # int32[E] higher-numbered cell
    ihc: np.ndarray     # int32[E] 0=vertical 1=horizontal 2=staggered
    cl1: np.ndarray     # f64[E] distance from n's center to shared face
    cl2: np.ndarray     # f64[E] distance from m's center to shared face
    hwva: np.ndarray    # f64[E] face width (horizontal) or flow area (vertical)
    direction: np.ndarray  # int32[E] 0=x 1=y 2=z (axis hint; -1 if unstructured)
    anglex: np.ndarray  # f64[E] angle of n→m normal in x-y plane (radians)
    # structured fast path (DIS grids): fixed slot semantics
    # [0=E, 1=W, 2=N, 3=S, 4=U, 5=D] so the assembled ELL matrix reshapes to
    # per-direction stencil coefficient arrays and SpMV becomes shifts —
    # no gathers.  None → greedy slot assignment (general grids).
    grid_shape: tuple = None  # (nlay, nrow, ncol) when structured
    # minimum ELL width: sharded solves pad every shard's local table to a
    # common width so one shard_map program serves all shards
    pad_degree: int = 0

    @property
    def nedges(self) -> int:
        return int(self.edge_n.shape[0])

    @property
    def structured(self) -> bool:
        return self.grid_shape is not None

    # ------------------------------------------------------------------ ELL

    @cached_property
    def _ell(self):
        """Build the ELL neighbor table and edge→slot scatter maps."""
        n_arr, m_arr = self.edge_n, self.edge_m
        N, E = self.nodes, self.nedges

        if self.structured:
            # fixed slots [E, W, N, S, U, D]; edge direction determines the
            # slot on each side (n is always the lower-numbered cell:
            # west / north / above of m)
            K = 6
            slot_of_n = np.where(self.direction == 0, 0,
                                 np.where(self.direction == 1, 3, 5))
            slot_of_m = np.where(self.direction == 0, 1,
                                 np.where(self.direction == 1, 2, 4))
            slot_nm = (n_arr.astype(np.int64) * K + slot_of_n).astype(np.int32)
            slot_mn = (m_arr.astype(np.int64) * K + slot_of_m).astype(np.int32)
            nbr = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, K))
            nbr.reshape(-1)[slot_nm] = m_arr
            nbr.reshape(-1)[slot_mn] = n_arr
            return K, nbr, slot_nm, slot_mn

        degree = np.zeros(N, dtype=np.int64)
        np.add.at(degree, n_arr, 1)
        np.add.at(degree, m_arr, 1)
        K = max(int(degree.max(initial=0)), 1, int(self.pad_degree))

        nbr = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, K))
        slot_nm = np.zeros(E, dtype=np.int32)
        slot_mn = np.zeros(E, dtype=np.int32)
        fill = np.zeros(N, dtype=np.int32)
        # deterministic slot assignment in edge order; per-edge loop is
        # host-side setup only (runs once per grid)
        for e in range(E):
            n, m = int(n_arr[e]), int(m_arr[e])
            sn, sm = fill[n], fill[m]
            nbr[n, sn] = m
            nbr[m, sm] = n
            slot_nm[e] = n * K + sn
            slot_mn[e] = m * K + sm
            fill[n] = sn + 1
            fill[m] = sm + 1
        return K, nbr, slot_nm, slot_mn

    @property
    def max_degree(self) -> int:
        return self._ell[0]

    @property
    def nbr(self) -> np.ndarray:
        """int32[N, K] neighbor table; padded slots point at the row itself."""
        return self._ell[1]

    @property
    def slot_nm(self) -> np.ndarray:
        """int32[E] flat index (into N*K) of the (n-row, m-col) entry."""
        return self._ell[2]

    @property
    def slot_mn(self) -> np.ndarray:
        """int32[E] flat index (into N*K) of the (m-row, n-col) entry."""
        return self._ell[3]

    # ------------------------------------------------------------------ CSR

    @cached_property
    def csr(self):
        """Full CSR pattern (diagonal first per row, then ascending columns),
        matching the reference's ia/ja layout (Connections.f90).

        Returns (ia, ja, edge_pos_nm, edge_pos_mn) where the edge_pos arrays
        give, for each half-edge, the position of (n,m) and (m,n) in ja.
        """
        N, E = self.nodes, self.nedges
        n_arr, m_arr = self.edge_n, self.edge_m
        degree = np.zeros(N, dtype=np.int64)
        np.add.at(degree, n_arr, 1)
        np.add.at(degree, m_arr, 1)
        ia = np.zeros(N + 1, dtype=np.int64)
        ia[1:] = np.cumsum(degree + 1)  # +1 for the diagonal entry
        nja = int(ia[-1])
        ja = np.empty(nja, dtype=np.int64)
        # diagonal first
        ja[ia[:-1]] = np.arange(N)
        # neighbors ascending: collect then sort per row
        rows = np.concatenate([n_arr, m_arr])
        cols = np.concatenate([m_arr, n_arr])
        edge_ids = np.concatenate([np.arange(E), np.arange(E)])
        is_nm = np.concatenate([np.ones(E, bool), np.zeros(E, bool)])
        order = np.lexsort((cols, rows))
        rows, cols, edge_ids, is_nm = rows[order], cols[order], edge_ids[order], is_nm[order]
        # position within each row: running offset
        pos = ia[rows] + 1 + (np.arange(rows.size) - np.searchsorted(rows, rows, side="left"))
        # searchsorted trick gives index within the row group because rows are sorted
        ja[pos] = cols
        edge_pos_nm = np.empty(E, dtype=np.int64)
        edge_pos_mn = np.empty(E, dtype=np.int64)
        edge_pos_nm[edge_ids[is_nm]] = pos[is_nm]
        edge_pos_mn[edge_ids[~is_nm]] = pos[~is_nm]
        return ia, ja, edge_pos_nm, edge_pos_mn

    # ------------------------------------------------------------- helpers

    def degree_histogram(self) -> np.ndarray:
        deg = np.zeros(self.nodes, dtype=np.int64)
        np.add.at(deg, self.edge_n, 1)
        np.add.at(deg, self.edge_m, 1)
        return np.bincount(deg)


def concat_topologies(topos, node_offsets) -> "Topology":
    """Concatenate disjoint topologies (multi-model coupling into one system)."""
    parts_n, parts_m = [], []
    for t, off in zip(topos, node_offsets):
        parts_n.append(t.edge_n.astype(np.int64) + off)
        parts_m.append(t.edge_m.astype(np.int64) + off)
    nodes = int(sum(t.nodes for t in topos))
    return Topology(
        nodes=nodes,
        edge_n=np.concatenate(parts_n).astype(np.int32),
        edge_m=np.concatenate(parts_m).astype(np.int32),
        ihc=np.concatenate([t.ihc for t in topos]),
        cl1=np.concatenate([t.cl1 for t in topos]),
        cl2=np.concatenate([t.cl2 for t in topos]),
        hwva=np.concatenate([t.hwva for t in topos]),
        direction=np.concatenate([t.direction for t in topos]),
        anglex=np.concatenate([t.anglex for t in topos]),
    )
