"""GNC: ghost-node correction for non-CVFD-compliant grids.

Behavioral parity target: src/Exchange/GhostNode.f90 — the head driving
the two-point flux across a refinement interface is interpolated from
contributing cells j with weights α (gnc_df GNCDATA), and the flux
correction per connection (n, m) is

    ΔQ = cond · Σ_j α_j (h_n − h_j)        (deltaQgnc:449-486)

applied in the EXPLICIT form of gnc_fc:280-324: rhs(n) −= ΔQ_j terms,
rhs(m) += them, re-evaluated each Picard iteration (the reference's
implicit mode puts the same terms in the matrix; the explicit form
converges with the nonlinear outer loop and keeps the stencil intact).

Design: contributors are a dense [G, J] table (α = 0 padding); the
per-iteration correction is two gathers + one scatter-add, with the
connection conductances gathered from the same edge-conductance vector
the NPF fill uses.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import DZERO


@partial(jax.tree_util.register_dataclass,
         data_fields=["edge_idx", "n", "m", "jcells", "alphas"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class GncData:
    edge_idx: jax.Array   # i32[G] index into the topology edge arrays
    n: jax.Array          # i32[G] noden (the ghosted side)
    m: jax.Array          # i32[G] nodem
    jcells: jax.Array     # i32[G, J] contributing cells (self-padded)
    alphas: jax.Array     # f64[G, J] interpolation weights (0 = pad)


def build_gnc(topo, entries):
    """``entries``: list of (noden, nodem, [(cellj, alpha), ...]) in model
    node numbers (the GNCDATA block role)."""
    lookup = {(int(a), int(b)): e
              for e, (a, b) in enumerate(zip(topo.edge_n, topo.edge_m))}
    G = len(entries)
    J = max(len(e[2]) for e in entries)
    eidx = np.zeros(G, np.int64)
    nn = np.zeros(G, np.int64)
    mm = np.zeros(G, np.int64)
    jc = np.zeros((G, J), np.int64)
    al = np.zeros((G, J))
    for i, (n, m, contribs) in enumerate(entries):
        key = (min(int(n), int(m)), max(int(n), int(m)))
        if key not in lookup:
            raise ValueError(f"GNC cells {n},{m} are not connected")
        eidx[i] = lookup[key]
        nn[i], mm[i] = int(n), int(m)
        jc[i, :] = int(n)            # α=0 self padding
        for jj, (cj, a) in enumerate(contribs):
            jc[i, jj] = int(cj)
            al[i, jj] = float(a)
    return GncData(edge_idx=jnp.asarray(eidx, jnp.int32),
                   n=jnp.asarray(nn, jnp.int32),
                   m=jnp.asarray(mm, jnp.int32),
                   jcells=jnp.asarray(jc, jnp.int32),
                   alphas=jnp.asarray(al))


def gnc_rhs_terms(gnc: GncData, cond_edges, head, ibound):
    """rhs adjustments (add to the model rhs): (rhs_add indexed scatter).

    Returns drhs f64[N-like via scatter]: caller does
    rhs = rhs.at[gnc.n].add(-rterm) / .at[gnc.m].add(+rterm)."""
    cond = cond_edges[gnc.edge_idx]
    act = (ibound[gnc.n] != 0) & (ibound[gnc.m] != 0)
    a_act = jnp.where(ibound[gnc.jcells] != 0, gnc.alphas, DZERO)
    rterm = (a_act * (head[gnc.n][:, None] - head[gnc.jcells])).sum(axis=1)
    return jnp.where(act, cond * rterm, DZERO)


def deltaQgnc(gnc: GncData, cond_edges, head, ibound):
    """ΔQ per gnc entry (deltaQgnc role) for budget/flowja corrections."""
    return gnc_rhs_terms(gnc, cond_edges, head, ibound)
