"""IMS-equivalent numerical solution: Picard/Newton outer loop around the
Krylov solvers.

Behavioral parity targets in the reference:
  - outer loop / convergence    src/Solution/NumericalSolution.f90:1482-1837
    (solve), sln_ca:1287-1327, sln_buildsystem:1941-1991
  - pre-solve row fixups        sln_ls:2404-2475 (see ops.system.apply_dirichlet)
  - under-relaxation            sln_underrelax:2989-3114 (SIMPLE/COOLEY/DBD)
  - complexity presets          sln_setouter:2623-2671 +
                                LinearMethods/ImsLinearSettings.f90 preset_config
  - Newton under-relaxation     npf_nur + sln_nur_has_converged

Design: each outer (Picard) iteration — assemble, fix up, Krylov solve,
convergence bookkeeping, under-relaxation — is one jitted device
computation; the Python loop over outer iterations only inspects the scalar
convergence result.  (A fully fused `lax.while_loop` outer loop is used by
the benchmark path; the Python loop keeps per-iteration diagnostics exact.)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DZERO, DONE
from ..ops.solvers.krylov import (_is_close, bicgstab, cg, epfact,
                                  refined_solve)
from ..ops.solvers.precond import make_preconditioner
from ..ops.system import (apply_dirichlet, apply_dirichlet_structured,
                          make_matvec, spmv)


@dataclasses.dataclass
class ImsSettings:
    """IMS nonlinear+linear settings (reference ims8 input)."""

    outer_dvclose: float = 1e-3
    outer_maximum: int = 25
    under_relaxation: str = "none"       # none|simple|cooley|dbd
    gamma: float = 1.0
    theta: float = 1.0
    akappa: float = 0.0
    amomentum: float = 0.0
    backtracking_number: int = 0
    backtracking_tolerance: float = 0.0
    backtracking_reduction_factor: float = 0.0
    backtracking_residual_limit: float = 0.0
    inner_maximum: int = 50
    inner_dvclose: float = 1e-3
    inner_rclose: float = 0.1
    icnvgopt: int = 0                    # rclose option
    linear_acceleration: str = "cg"      # cg|bicgstab
    relaxation_factor: float = 0.0       # MILU(0) relax in the reference —
    # meaningless without ILU; the deck loader warns loudly when set (see
    # utils/mf6io/loader.py) rather than silently changing behavior.
    preconditioner: str = "jacobi"       # jacobi|neumann|chebyshev|mg|none
    preconditioner_order: int = 2
    north: int = 0                       # reorthogonalization frequency
    no_ptc: object = False               # False | "first" | "all"/True
    ptcexp: float = 1.0                  # PTC del update exponent (ats_exp)
    ptcdel0: float = 0.0                 # initial pseudo-time step (0=auto)
    precision: str = "f64"               # f64 | mixed (f32 Krylov + f64
    # iterative refinement: half the bytes per Krylov iteration; see
    # ops.solvers.krylov.refined_solve)
    csv_inner_path: str = None           # CSV_INNER_OUTPUT FILEOUT: write
    # one row per inner iteration (dvmax/rmax/l2norm traces)

    @staticmethod
    def from_complexity(complexity: str = "simple") -> "ImsSettings":
        c = complexity.strip().lower()
        if c == "simple":
            return ImsSettings()
        if c == "moderate":
            return ImsSettings(
                outer_dvclose=1e-2, outer_maximum=50, under_relaxation="dbd",
                theta=0.9, akappa=1e-4, gamma=0.0, amomentum=0.0,
                inner_maximum=100, inner_dvclose=1e-2, inner_rclose=0.1,
                linear_acceleration="bicgstab")
        if c == "complex":
            return ImsSettings(
                outer_dvclose=1e-1, outer_maximum=100, under_relaxation="dbd",
                theta=0.8, akappa=1e-4, gamma=0.0, amomentum=0.0,
                backtracking_number=20, backtracking_tolerance=1.05,
                backtracking_reduction_factor=0.1,
                backtracking_residual_limit=0.002,
                inner_maximum=500, inner_dvclose=1e-1, inner_rclose=0.1,
                linear_acceleration="bicgstab")
        raise ValueError(f"unknown complexity {complexity!r}")


def _make_precond(s, model, dtopo, matvec, diag, off):
    """Preconditioner factory shared by the diagnostic and fused paths.
    ``mg`` needs the structured stencil form; everything else goes through
    ops.solvers.precond.make_preconditioner."""
    if s.preconditioner == "mg" and getattr(model, "use_structured", False):
        from ..ops.solvers.mg import make_mg_preconditioner
        return make_mg_preconditioner(dtopo.grid_shape, diag, off)
    kind = "chebyshev" if s.preconditioner == "mg" else s.preconditioner
    return make_preconditioner(kind, matvec, diag,
                               order=max(s.preconditioner_order,
                                         4 if kind == "chebyshev" else 0))


class SolveInfo(NamedTuple):
    converged: bool
    outer_iterations: int
    inner_iterations: int
    dvmax_outer: float
    dvmax_history: list
    # [(kiter, n_inner, dvmax[], rmax[], l2norm[])] per outer iteration
    # when csv_inner_path is set (CSV_INNER_OUTPUT role)
    inner_traces: object = None


def _signed_absmax(v):
    return v[jnp.argmax(jnp.abs(v))]


class NumericalSolution:
    """Drives one or more models (sharing one matrix) through a time step.

    Round-1 scope: a single GWF model per solution; multi-model coupling
    adds exchange edges into the same topology (models.discretization
    concat_topologies).
    """

    def __init__(self, model, settings: ImsSettings):
        self.model = model
        self.s = settings
        self._outer_iter_jit = jax.jit(
            self._outer_iter,
            static_argnames=("iss", "kiter_is_first", "use_ptc"))

    # ------------------------------------------------------- one outer it

    def _use_ptc(self, iss, kper=1) -> bool:
        """PTC applies to Newton models in steady-state periods
        (gwf_ptcchk, gwf.f90:601-617), gated by the IMS NO_PTC option
        (sln_ls, NumericalSolution.f90:2484-2497)."""
        s = self.s
        if not (iss and getattr(self.model, "inewton", 0)):
            return False
        if s.no_ptc in (True, "all"):
            return False
        if s.no_ptc == "first" and kper == 1:
            return False
        return True

    def _outer_iter(self, head, head_old, ibound, delt, kstp,
                    ur_state, kiter, pkgs, iss: bool, kiter_is_first: bool,
                    use_ptc: bool = False):
        """Assemble + fix up + linear solve + convergence bookkeeping."""
        s = self.s
        model = self.model
        dtopo = model.dtopo

        diag, off, rhs = model.assemble(head, head_old, ibound, delt,
                                        iss, pkgs)
        xtemp = head
        active = jnp.where(ibound > 0, 1, jnp.where(ibound < 0, -1, 0))
        if model.use_structured:
            diag, off, rhs = apply_dirichlet_structured(
                dtopo.grid_shape, active, diag, off, rhs, head,
                symmetric=(s.linear_acceleration == "cg"))
        else:
            diag, off, rhs = apply_dirichlet(
                dtopo.nbr, active, diag, off, rhs, head,
                symmetric=(s.linear_acceleration == "cg"))

        if use_ptc:
            diag, rhs, ur_state = self._apply_ptc(
                diag, off, rhs, head, active, delt, ur_state, kiter_is_first)

        matvec = make_matvec(dtopo, diag, off)
        r0 = rhs - matvec(head)
        l2norm0 = jnp.sqrt(jnp.sum(r0 * r0))
        epf = epfact(s.icnvgopt, kstp)
        solver = cg if s.linear_acceleration == "cg" else bicgstab
        if s.precision == "mixed":
            diag32 = diag.astype(jnp.float32)
            off32 = off.astype(jnp.float32)
            matvec32 = make_matvec(dtopo, diag32, off32)
            precond32 = _make_precond(s, model, dtopo, matvec32, diag32,
                                      off32)
            res = refined_solve(
                solver, matvec, matvec32, rhs, head, precond32,
                itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                north=s.north, l2norm0=l2norm0, epfact_val=epf)
        else:
            precond = _make_precond(s, model, dtopo, matvec, diag, off)
            res = solver(matvec, rhs, head, precond,
                         itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                         rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                         north=s.north, l2norm0=l2norm0, epfact_val=epf,
                         trace=s.csv_inner_path is not None)
        x = res.x

        # outer convergence: max dependent-variable change over active cells
        dx = jnp.where(active > 0, x - xtemp, DZERO)
        dxmax = _signed_absmax(dx)
        converged = jnp.abs(dxmax) <= s.outer_dvclose

        # under-relaxation (only applied when not converged)
        x_ur, ur_state_new = self._under_relax(x, xtemp, active, dxmax,
                                               ur_state, kiter_is_first)
        x = jnp.where(converged, x, x_ur)

        # Newton under-relaxation on the model (npf_nur) — only with the
        # NEWTON UNDER_RELAXATION option (gwf.f90 gwf_nur gates on
        # this%inewtonur)
        if model.inewton and getattr(model, "inewtonur", 0):
            from ..models.gwf import npf as npf_mod
            dxold = jnp.where(active > 0, x - xtemp, DZERO)
            ng = getattr(model, "n_grid", None)
            if ng is not None and ng != x.shape[0]:
                # augmented models: gwf_nur relaxes the grid rows only
                xg, dxg, applied, _ = npf_mod.under_relax(
                    model.npf_arrays, ibound[:ng], x[:ng], xtemp[:ng],
                    dxold[:ng], model.npf_arrays.bot)
                x_nur = jnp.concatenate([xg, x[ng:]])
                dx_nur = jnp.concatenate([dxg, jnp.zeros_like(x[ng:])])
            else:
                x_nur, dx_nur, applied, _ = npf_mod.under_relax(
                    model.npf_arrays, ibound, x, xtemp, dxold,
                    model.npf_arrays.bot)
            x = jnp.where(converged, x, x_nur)
            # NUR convergence rescue (sln_nur_has_converged,
            # NumericalSolution.f90): BOTH the max change at unrelaxed
            # cells AND the post-NUR recomputed dxmax must be ≤ dvclose
            dxold_max = jnp.max(jnp.abs(dx_nur))
            hncg = jnp.max(jnp.abs(jnp.where(active > 0, x_nur - xtemp,
                                             DZERO)))
            nur_conv = (applied & (dxold_max <= s.outer_dvclose)
                        & (hncg <= s.outer_dvclose))
            converged = converged | (~converged & nur_conv)

        if res.trace is not None:
            ur_state_new = {**ur_state_new, "inner_trace": res.trace}
        return x, converged, dxmax, res.iters, ur_state_new

    # ------------------------------------------------------------- ptc

    def _apply_ptc(self, diag, off, rhs, head, active, delt, ur_state,
                   kiter_is_first):
        """Pseudo-transient continuation diagonal terms.

        Behavioral parity: gwf_ptc (gwf.f90:625-687) computes the
        reciprocal pseudo-time step ptcf = max |resid|/V over active cells
        (V = cell volume at full saturation); sln_ls
        (NumericalSolution.f90:2499-2569) turns it into ptcdel with the
        (l2norm0/l2norm)**ptcexp update and subtracts 1/ptcdel from active
        diagonals (the matrix is negative definite, so this *strengthens*
        the diagonal) with the matching rhs shift.
        """
        s = self.s
        model = self.model
        matvec = make_matvec(model.dtopo, diag, off)
        resid = jnp.where(active > 0, matvec(head) - rhs, DZERO)
        l2norm = jnp.sqrt(jnp.sum(resid * resid))
        area = jnp.asarray(model.grid.area)
        vol = area * (model.npf_arrays.top - model.npf_arrays.bot)
        vol = jnp.where(vol > DZERO, vol, DONE)
        if vol.shape[0] != resid.shape[0]:
            # augmented models: gwf_ptc measures grid cells only;
            # feature rows keep a unit pseudo-volume
            vol = jnp.concatenate(
                [vol, jnp.ones(resid.shape[0] - vol.shape[0])])
        ptcf = jnp.max(jnp.where(active > 0, jnp.abs(resid) / vol, DZERO))
        ptcf = jnp.where(ptcf == DZERO, DONE / (delt * 10.0), ptcf)
        if kiter_is_first:
            ptcdel = jnp.asarray(s.ptcdel0) if s.ptcdel0 > 0 else DONE / ptcf
            iptc_on = jnp.ones((), bool)
        else:
            l2norm0 = ur_state["ptc_l2norm0"]
            iptc_on = ~_is_close(l2norm, l2norm0)
            ptcdel = jnp.where(
                l2norm > DZERO,
                ur_state["ptcdel"] * (l2norm0 / l2norm) ** s.ptcexp, DZERO)
        ptcval = jnp.where(ptcdel > DZERO, DONE / ptcdel, DONE)
        add = jnp.where((active > 0) & iptc_on, ptcval, DZERO)
        diag = diag - add
        rhs = rhs - add * head
        return diag, rhs, {**ur_state, "ptcdel": ptcdel,
                           "ptc_l2norm0": l2norm}

    # ----------------------------------------------------- backtracking

    def _residual_l2(self, head, head_old, ibound, delt, iss, pkgs):
        """‖A·x − b‖₂ over active rows of the *raw* assembled system
        (sln_l2norm + sln_calc_residual, NumericalSolution.f90:2845-2872;
        backtracking rebuilds with inewton=0, sln_backtracking:2699)."""
        model = self.model
        try:
            diag, off, rhs = model.assemble(head, head_old, ibound, delt,
                                            iss, pkgs, newton=False)
        except TypeError:
            diag, off, rhs = model.assemble(head, head_old, ibound, delt,
                                            iss, pkgs)
        matvec = make_matvec(model.dtopo, diag, off)
        active = jnp.where(ibound > 0, 1, jnp.where(ibound < 0, -1, 0))
        r = jnp.where(active > 0, matvec(head) - rhs, DZERO)
        return jnp.sqrt(jnp.sum(r * r))

    def _backtrack(self, head, head_prev, head_old, ibound, delt, res_prev,
                   pkgs, iss: bool, kiter_is_first: bool):
        """One backtracking pass before an outer iteration
        (sln_backtracking, NumericalSolution.f90:2680-2776).

        Returns (head', res_prev').  At the first outer iteration only the
        reference residual is recorded.  Otherwise, while the new residual
        exceeds res_prev*btol, the iterate is pulled back toward the
        previous outer iterate by breduc, up to numtrack times, stopping
        early when the remaining step is below dvclose
        (get_backtracking_flag:2800-2826) or the residual drops below
        res_lim.
        """
        s = self.s
        l2 = lambda x: self._residual_l2(x, head_old, ibound, delt, iss, pkgs)
        if kiter_is_first:
            return head, l2(head)

        active = ibound > 0
        res_new0 = l2(head)

        def cond(c):
            nb, x, res_new, done = c
            return (~done) & (nb < s.backtracking_number)

        def body(c):
            nb, x, res_new, _ = c
            dxmax = jnp.max(jnp.abs(jnp.where(active, x - head_prev, DZERO)))
            # dependent-variable change already below dvclose → stop
            stop_small = s.backtracking_reduction_factor * dxmax < s.outer_dvclose
            x_new = jnp.where(
                active,
                head_prev + s.backtracking_reduction_factor * (x - head_prev),
                x)
            x = jnp.where(stop_small, x, x_new)
            res_new = jnp.where(stop_small, res_new, l2(x))
            done = (stop_small
                    | (res_new < res_prev * s.backtracking_tolerance)
                    | (res_new < s.backtracking_residual_limit))
            return nb + 1, x, res_new, done

        needs_bt = res_new0 > res_prev * s.backtracking_tolerance
        nb, head_bt, res_bt, _ = jax.lax.while_loop(
            cond, body,
            (jnp.zeros((), jnp.int32), head, res_new0, ~needs_bt))
        return head_bt, res_bt

    # ------------------------------------------------------ under-relax

    def _under_relax(self, x, xtemp, active, dxmax, ur_state, kiter_is_first):
        s = self.s
        mode = s.under_relaxation
        delx = jnp.where(active > 0, x - xtemp, DZERO)
        if mode == "none":
            return x, ur_state
        if mode == "simple":
            xnew = jnp.where(active > 0, xtemp + s.gamma * delx, x)
            return xnew, ur_state
        if mode == "cooley":
            bigch = dxmax
            if kiter_is_first:
                relax = jnp.asarray(DONE)
                bigchold = bigch
            else:
                es = bigch / (ur_state["bigchold"] * ur_state["relaxold"])
                aes = jnp.abs(es)
                relax = jnp.where(es < -DONE, 0.5 / aes, (3.0 + es) / (3.0 + aes))
                bigchold = (DONE - s.gamma) * bigch + s.gamma * ur_state["bigchold"]
            xnew = jnp.where((active > 0) & (relax < DONE),
                             xtemp + relax * delx, x)
            return xnew, {**ur_state, "relaxold": relax, "bigchold": bigchold}
        if mode == "dbd":
            if kiter_is_first:
                wsave = jnp.ones_like(x)
                hchold = jnp.full_like(x, 1e-20)
                deold = jnp.zeros_like(x)
            else:
                wsave = ur_state["wsave"]
                hchold = ur_state["hchold"]
                deold = ur_state["deold"]
            ww = jnp.where(deold * delx < DZERO, s.theta * wsave,
                           wsave + s.akappa)
            ww = jnp.minimum(ww, DONE)
            if kiter_is_first:
                hchold_new = delx
            else:
                hchold_new = (DONE - s.gamma) * delx + s.gamma * hchold
            kiter = ur_state["kiter"]
            amom = jnp.where(kiter > 4, s.amomentum, DZERO)
            delx_adj = delx * ww + amom * hchold_new
            xnew = jnp.where(active > 0, xtemp + delx_adj, x)
            return xnew, {**ur_state, "wsave": ww, "hchold": hchold_new,
                          "deold": delx, "kiter": kiter + 1}
        raise ValueError(f"unknown under_relaxation {mode!r}")

    def _init_ur_state(self, n):
        zero = jnp.zeros(())
        return dict(relaxold=jnp.asarray(1.0), bigchold=jnp.asarray(1e-20),
                    wsave=jnp.ones(n), hchold=jnp.full(n, 1e-20),
                    deold=jnp.zeros(n), kiter=jnp.asarray(1, jnp.int32),
                    ptcdel=zero, ptc_l2norm0=zero)

    # ----------------------------------------------------------- ca

    def solve_timestep(self, head_old, delt, kstp=1, iss=False, pkgs=None,
                       kper=1, ibound_in=None):
        """One time step: Picard loop to convergence (sln_ca).

        Returns (head, SolveInfo, aux) where aux carries (ibound, cond) for
        the output phase.  ``ibound_in``: carry dry/wet cell status across
        steps when NPF rewetting is active (the reference's persistent
        ibound; pass the previous step's aux["ibound"]).
        """
        s = self.s
        model = self.model
        if pkgs is None:
            pkgs = model.packages
        ibound, head = model.boundary_state(jnp.asarray(head_old), pkgs)
        wetdry = getattr(model, "wetdry", None)
        if ibound_in is not None:
            # keep cells that dried in earlier steps dry (but let CHD
            # repinning from boundary_state win)
            ibound = jnp.where((ibound_in == 0) & (ibound > 0), 0, ibound)
        if wetdry is not None:
            # hold = bot at dry wettable cells so rewetted storage terms
            # reference the cell bottom (gwf-npf.f90:395-400 irestore)
            head = jnp.where((ibound == 0) & (wetdry != 0.0),
                             model.npf_arrays.bot, head)
        head_old_adj = head  # CHD cells pinned in old head too (model_ad)
        ur_state = self._init_ur_state(head.shape[0])
        use_ptc = self._use_ptc(bool(iss), kper)
        use_bt = s.backtracking_number > 0

        total_inner = 0
        dv_hist = []
        inner_traces = []
        converged = False
        kiter = 0
        delt = jnp.asarray(delt)
        kstp = jnp.asarray(kstp, jnp.int32)
        res_prev = jnp.zeros(())
        head_prev = head
        if use_bt and not hasattr(self, "_backtrack_jit"):
            self._backtrack_jit = jax.jit(
                self._backtrack, static_argnames=("iss", "kiter_is_first"))
        if wetdry is not None and not hasattr(self, "_wetdry_jit"):
            from ..models.gwf import npf as npf_mod
            wetfct, iwetit, ihdwet = model.rewet_opts
            self._wetdry_jit = jax.jit(partial(
                npf_mod.wetdry_update, model.dtopo, model.npf_arrays,
                wetdry, iwetit=iwetit, ihdwet=ihdwet, wetfct=wetfct))
        for kiter in range(1, s.outer_maximum + 1):
            wd_changed = False
            if wetdry is not None:
                # npf_cf wetting/drying sweep before formulate
                ibound, head, chg = self._wetdry_jit(
                    ibound, head, jnp.asarray(kiter, jnp.int32))
                wd_changed = bool(chg)
            if use_bt:
                head, res_prev = self._backtrack_jit(
                    head, head_prev, head_old_adj, ibound, delt, res_prev,
                    pkgs, iss=bool(iss), kiter_is_first=(kiter == 1))
            head_prev = head
            head, conv, dxmax, inner, ur_state = self._outer_iter_jit(
                head, head_old_adj, ibound, delt, kstp, ur_state,
                jnp.asarray(kiter, jnp.int32), pkgs, iss=bool(iss),
                kiter_is_first=(kiter == 1), use_ptc=use_ptc)
            total_inner += int(inner)
            dv_hist.append(float(dxmax))
            if s.csv_inner_path and "inner_trace" in ur_state:
                tr = ur_state["inner_trace"]
                inner_traces.append(
                    (kiter, int(inner)) + tuple(np.asarray(t) for t in tr))
            if bool(conv) and not wd_changed:
                converged = True
                break
        info = SolveInfo(converged, kiter, total_inner,
                         dv_hist[-1] if dv_hist else 0.0, dv_hist,
                         inner_traces if s.csv_inner_path else None)
        if not hasattr(self, "_edge_cond_jit"):
            self._edge_cond_jit = jax.jit(self.model.edge_conductances)
        cond = self._edge_cond_jit(head, ibound, pkgs)
        return head, info, dict(ibound=ibound, cond=cond)
