"""PRT driver: per-timestep particle advance over a solved GWF step.

Behavioral parity target: the reference's explicit PRT solution inside the
simulation loop (src/Model/ParticleTracking/prt.f90:62-85 prt_solve per
time step; src/Solution/ExplicitSolution.f90:39) with PRP release
scheduling (prt-prp.f90 prp_rp) and track-file output
(src/Solution/ParticleTracker/TrackControl.f90 role).

Design: all particles live in fixed-shape arrays (npts × nreleases);
each accepted flow step builds the cell flow fields once and advances
(a) the already-live swarm for the full step and (b) each release batch
whose release instant falls inside the step for the remainder of the
step — every advance is one vmapped Pollock kernel call with a scalar
time horizon, so nothing retraces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..gwf import npf as npf_mod
from . import tracking
from .trackfile import (REASON_TERMINATE, REASON_TIMESTEP, ReleaseSchedule,
                        TrackFileWriter)

TERM_STOPTIME = 4
TERM_STOPZONE = 5


@dataclasses.dataclass
class PrtDriver:
    """Owns the particle state across the simulation time loop."""

    model: object                  # PrtModel
    gwf_model: object
    schedule: ReleaseSchedule
    track_path: str = None
    trackcsv_path: str = None
    stoptime: float = np.inf
    istopzone: int = 0
    izone: object = None           # i32[N] MIP zones (stop-zone support)

    def begin(self, tdis):
        self.release_times = self.schedule.release_times(tdis)
        npts = len(self.model.prp.x)
        nrel = max(len(self.release_times), 1)
        ntot = npts * nrel
        self.is_disv = hasattr(self.model.grid, "ncpl")
        if self.is_disv:
            # DISV: ternary triangle-fan tracking (MethodCellTernary)
            from . import tracking_disv
            g = self.model.grid
            self._fan = tracking_disv.build_fan(
                g, self.gwf_model.topo,
                np.asarray(self.model.porosity).reshape(-1))
            lay, row, col = tracking_disv.locate(
                self._fan, np.asarray(self.model.prp.x, float),
                np.asarray(self.model.prp.y, float),
                np.asarray(self.model.prp.z, float))
            # (lay, cell, tri) ride the (lay, row, col) slots
        else:
            lay, row, col = self.model.locate()
        tile = lambda a: np.tile(np.asarray(a), nrel)       # noqa: E731
        self.x = jnp.asarray(tile(np.asarray(self.model.prp.x, float)))
        self.y = jnp.asarray(tile(np.asarray(self.model.prp.y, float)))
        self.z = jnp.asarray(tile(np.asarray(self.model.prp.z, float)))
        self.lay = jnp.asarray(tile(lay))
        self.row = jnp.asarray(tile(row))
        self.col = jnp.asarray(tile(col))
        # release time of each particle slot
        rt = np.repeat(np.asarray(self.release_times), npts) \
            if len(self.release_times) else np.full(npts, np.inf)
        self.trelease = np.asarray(rt, float)
        self.released = np.zeros(ntot, bool)
        self.status = np.full(ntot, tracking.ACTIVE, np.int32)
        self.ttrack = np.zeros(ntot)                # cumulative travel time
        self.irpt = np.tile(np.arange(npts, dtype=np.int32), nrel)
        self.writer = TrackFileWriter(self.track_path) \
            if self.track_path else None
        self.csv_writer = TrackFileWriter(self.trackcsv_path, csv=True) \
            if self.trackcsv_path else None
        self._step_fn = None

    # ------------------------------------------------------------ kernel

    def _make_step(self):
        if self.is_disv:
            return self._make_step_disv()
        g = self.model.grid
        gwf = self.gwf_model
        top3 = jnp.asarray(g.top).reshape(g.shape)
        bot3 = jnp.asarray(g.bot).reshape(g.shape)
        porosity = self.model.porosity

        def step(head, ibound, cond, x, y, z, lay, row, col, live, tmax):
            q_edge = npf_mod.flowja(gwf.dtopo, cond, head)
            sat = npf_mod.compute_saturation(gwf.npf_opts, gwf.npf_arrays,
                                             head, ibound)
            flows = tracking.build_cell_flows(gwf.topo, g, q_edge,
                                              porosity, sat)
            track = tracking.make_tracker(flows)
            out = track(x, y, z, lay, row, col, top3, bot3, tmax)
            # only live particles move; others keep their state
            keep = lambda new, old: jnp.where(live, new, old)  # noqa: E731
            return dict(x=keep(out["x"], x), y=keep(out["y"], y),
                        z=keep(out["z"], z), lay=keep(out["lay"], lay),
                        row=keep(out["row"], row),
                        col=keep(out["col"], col),
                        status=out["status"], time=out["time"])

        return jax.jit(step)

    def _make_step_disv(self):
        from ..gwf import npf as npf_mod
        from . import tracking_disv
        g = self.model.grid
        gwf = self.gwf_model
        fan = self._fan

        def step(head, ibound, cond, x, y, z, lay, cell, tri, live, tmax):
            q_edge = gwf.edge_flows(head, ibound, cond)
            sat = npf_mod.compute_saturation(
                gwf.npf_opts, gwf.npf_arrays, head,
                ibound).reshape(g.nlay, g.ncpl)
            Qout, u, qzt, qzb = tracking_disv.fan_fluxes(fan, q_edge)
            track = tracking_disv.make_tracker_disv(fan)
            out = track(x, y, z, lay, cell, tri, Qout, u, qzt, qzb, sat,
                        tmax)
            keep = lambda new, old: jnp.where(live, new, old)  # noqa: E731
            return dict(x=keep(out["x"], x), y=keep(out["y"], y),
                        z=keep(out["z"], z), lay=keep(out["lay"], lay),
                        row=keep(out["cell"], cell),
                        col=keep(out["tri"], tri),
                        status=out["status"], time=out["time"])

        return jax.jit(step)

    # ------------------------------------------------------------- drive

    def on_step(self, kper, kstp, delt, totim, head, ibound, cond):
        """Advance the swarm across one accepted flow step
        (prt.f90 prt_solve role)."""
        if self._step_fn is None:
            self._step_fn = self._make_step()
        # augmented flow models carry extra feature rows; tracking uses
        # the grid part only
        ng = getattr(self.gwf_model, "n_grid", None)
        if ng is None:
            ng = self.gwf_model.nodes
        head = jnp.asarray(head)[:ng]
        ibound = jnp.asarray(ibound)[:ng]
        t0 = totim - delt
        rt = self.trelease
        # batches: live-before-step (track full delt) + each release
        # instant inside (t0, totim] (track totim - rt)
        # horizons are capped at STOPTIME (prp stoptime: tracking halts at
        # that simulation time exactly, not at the end of the step)
        horizons = [(None, float(min(delt, self.stoptime - t0)))]
        for t in np.unique(rt[(rt > t0 - 1e-12) & (rt <= totim + 1e-12)
                              & ~self.released]):
            horizons.append((float(t),
                             float(min(totim, self.stoptime) - t)))
        for rel_t, tmax in horizons:
            if rel_t is None:
                live_np = self.released & (self.status == tracking.ACTIVE)
            else:
                live_np = np.abs(rt - rel_t) <= 1e-12
                self.released |= live_np
            if not live_np.any() or tmax <= 0:
                continue
            live = jnp.asarray(live_np)
            out = self._step_fn(head, ibound, cond, self.x, self.y, self.z,
                                self.lay, self.row, self.col, live,
                                jnp.asarray(float(tmax)))
            self.x, self.y, self.z = out["x"], out["y"], out["z"]
            self.lay, self.row, self.col = (out["lay"], out["row"],
                                            out["col"])
            st = np.asarray(out["status"])
            tt = np.asarray(out["time"])
            self.ttrack = np.where(live_np, self.ttrack + tt, self.ttrack)
            # TERM_TIMEOUT within a step means still active next step
            new_status = np.where(st == tracking.TERM_TIMEOUT,
                                  tracking.ACTIVE, st)
            self.status = np.where(live_np, new_status, self.status)
        # stop-zone / stoptime termination (prp istopzone / stoptime)
        if self.istopzone and self.izone is not None:
            node = self._node_of()
            inzone = np.asarray(self.izone).reshape(-1)[node] \
                == self.istopzone
            self.status = np.where(
                self.released & (self.status == tracking.ACTIVE) & inzone,
                TERM_STOPZONE, self.status)
        if np.isfinite(self.stoptime):
            self.status = np.where(
                self.released & (self.status == tracking.ACTIVE)
                & (self.ttrack + self.trelease >= self.stoptime - 1e-12),
                TERM_STOPTIME, self.status)
        self._write_records(kper, kstp)

    def _node_of(self):
        if getattr(self, "is_disv", False):
            return (np.asarray(self.lay) * self.model.grid.ncpl
                    + np.asarray(self.row))
        shp = self.model.grid.shape
        return (np.asarray(self.lay) * shp[1] + np.asarray(self.row)) \
            * shp[2] + np.asarray(self.col)

    def _write_records(self, kper, kstp):
        """One record per released particle per step (TrackControl role)."""
        sel = np.flatnonzero(self.released)
        if not len(sel):
            return
        node = self._node_of()
        reason = np.where(self.status[sel] == tracking.ACTIVE,
                          REASON_TIMESTEP, REASON_TERMINATE)
        for w in (self.writer, self.csv_writer):
            if w is None:
                continue
            w.write(kper, kstp, self.irpt[sel] + 1,
                    np.asarray(self.lay)[sel] + 1, node[sel] + 1,
                    self.status[sel], reason,
                    self.trelease[sel],
                    self.ttrack[sel] + self.trelease[sel],
                    np.asarray(self.x)[sel], np.asarray(self.y)[sel],
                    np.asarray(self.z)[sel])

    def finish(self):
        for w in (self.writer, self.csv_writer):
            if w is not None:
                w.close()
