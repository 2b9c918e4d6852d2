"""Fully-fused time step: the entire Picard outer loop + Krylov inner loop
as one jittable device computation (no host round trips).

This is the benchmark / production path; `solution.ims.NumericalSolution`
is the diagnostic path with per-iteration host-side reporting.  Both share
the same assembly and solver code; parity between them is tested in
tests/test_fused.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import DZERO
from ..ops.solvers.krylov import bicgstab, cg, epfact, refined_solve
from ..ops.solvers.precond import make_preconditioner
from ..ops.system import (apply_dirichlet, apply_dirichlet_structured,
                          make_matvec, spmv)
from .ims import ImsSettings


def make_fused_step(model, settings: ImsSettings, iss: bool, kper: int = 1):
    """Returns step(head_old, delt, kstp) -> (head, outer_iters, inner_iters,
    converged).  Pure function of its inputs; jit/pmap/scan-able."""
    s = settings
    dtopo = model.dtopo
    use_cg = s.linear_acceleration == "cg"
    solver = cg if use_cg else bicgstab
    use_ptc = bool(iss) and bool(getattr(model, "inewton", 0))
    if s.no_ptc in (True, "all") or (s.no_ptc == "first" and kper == 1):
        use_ptc = False

    # a linear model's system is constant within the time step: assemble
    # (and fix up, cast, precondition) once per step instead of once per
    # Picard iteration (see GwfModel.is_linear)
    hoist = getattr(model, "is_linear", False) and not use_ptc

    def step(head_old, delt, kstp):
        ibound, head = model.boundary_state(head_old)
        head_old_adj = head
        from .ims import _make_precond

        def build_system(head):
            diag, off, rhs = model.assemble(head, head_old_adj, ibound,
                                            delt, iss)
            active = jnp.where(ibound > 0, 1, jnp.where(ibound < 0, -1, 0))
            if model.use_structured:
                diag, off, rhs = apply_dirichlet_structured(
                    dtopo.grid_shape, active, diag, off, rhs, head,
                    symmetric=use_cg)
            else:
                diag, off, rhs = apply_dirichlet(dtopo.nbr, active, diag, off,
                                                 rhs, head, symmetric=use_cg)
            return diag, off, rhs, active

        def make_solvers(diag, off):
            matvec = make_matvec(dtopo, diag, off)
            if s.precision == "mixed":
                diag32 = diag.astype(jnp.float32)
                off32 = off.astype(jnp.float32)
                matvec32 = make_matvec(dtopo, diag32, off32)
                precond32 = _make_precond(s, model, dtopo, matvec32,
                                          diag32, off32)
                return matvec, matvec32, precond32
            precond = _make_precond(s, model, dtopo, matvec, diag, off)
            return matvec, None, precond

        if hoist:
            hdiag, hoff, hrhs, hactive = build_system(head)
            hsolvers = make_solvers(hdiag, hoff)

        def outer_body(carry):
            head, kiter, _, inner_tot, ptc_state = carry
            if hoist:
                diag, off, rhs, active = hdiag, hoff, hrhs, hactive
                matvec, matvec32, precond = hsolvers
            else:
                diag, off, rhs, active = build_system(head)
                if use_ptc:
                    diag, rhs, ptc_state = _apply_ptc_fused(
                        model, s, dtopo, diag, off, rhs, head, active, delt,
                        kiter, ptc_state)
                matvec, matvec32, precond = make_solvers(diag, off)
            r0 = rhs - matvec(head)
            l2norm0 = jnp.sqrt(jnp.sum(r0 * r0))
            if s.precision == "mixed":
                res = refined_solve(
                    solver, matvec, matvec32, rhs, head, precond,
                    itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                    rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                    north=s.north, l2norm0=l2norm0,
                    epfact_val=epfact(s.icnvgopt, kstp))
            else:
                res = solver(matvec, rhs, head, precond,
                             itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                             rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                             north=s.north, l2norm0=l2norm0,
                             epfact_val=epfact(s.icnvgopt, kstp))
            x = res.x
            dxmax = jnp.max(jnp.abs(jnp.where(active > 0, x - head, DZERO)))
            converged = dxmax <= s.outer_dvclose
            if s.under_relaxation == "simple":
                x = jnp.where(converged | (active <= 0), x,
                              head + s.gamma * (x - head))
            if model.inewton and getattr(model, "inewtonur", 0):
                from ..models.gwf import npf as npf_mod
                dxold = jnp.where(active > 0, x - head, DZERO)
                x_nur, _, _, _ = npf_mod.under_relax(
                    model.npf_arrays, ibound, x, head, dxold,
                    model.npf_arrays.bot)
                x = jnp.where(converged, x, x_nur)
            return x, kiter + 1, converged, inner_tot + res.iters, ptc_state

        def outer_cond(carry):
            _, kiter, converged, _, _ = carry
            return (~converged) & (kiter < s.outer_maximum)

        zero = jnp.zeros(())
        init = (head, jnp.zeros((), jnp.int32), jnp.zeros((), bool),
                jnp.zeros((), jnp.int32), (zero, zero))
        head, kiter, converged, inner_tot, _ = lax.while_loop(
            outer_cond, outer_body, init)
        return head, kiter, inner_tot, converged

    return step


def _apply_ptc_fused(model, s, dtopo, diag, off, rhs, head, active, delt,
                     kiter, ptc_state):
    """PTC terms inside the fused while_loop — same math as
    NumericalSolution._apply_ptc (gwf_ptc gwf.f90:625-687 + sln_ls
    NumericalSolution.f90:2499-2569) with the first-iteration branch as a
    jnp.where on the carried (ptcdel, l2norm0) state."""
    from ..ops.solvers.krylov import _is_close

    ptcdel_prev, l2norm0 = ptc_state
    matvec = make_matvec(dtopo, diag, off)
    resid = jnp.where(active > 0, matvec(head) - rhs, DZERO)
    l2norm = jnp.sqrt(jnp.sum(resid * resid))
    area = jnp.asarray(model.grid.area)
    vol = area * (model.npf_arrays.top - model.npf_arrays.bot)
    vol = jnp.where(vol > DZERO, vol, 1.0)
    ptcf = jnp.max(jnp.where(active > 0, jnp.abs(resid) / vol, DZERO))
    ptcf = jnp.where(ptcf == DZERO, 1.0 / (delt * 10.0), ptcf)
    first = kiter == 0
    ptcdel_first = (jnp.asarray(s.ptcdel0) if s.ptcdel0 > 0
                    else 1.0 / ptcf)
    ptcdel_next = jnp.where(
        l2norm > DZERO, ptcdel_prev * (l2norm0 / l2norm) ** s.ptcexp, DZERO)
    ptcdel = jnp.where(first, ptcdel_first, ptcdel_next)
    iptc_on = first | ~_is_close(l2norm, l2norm0)
    ptcval = jnp.where(ptcdel > DZERO, 1.0 / ptcdel, 1.0)
    add = jnp.where((active > 0) & iptc_on, ptcval, DZERO)
    return diag - add, rhs - add * head, (ptcdel, l2norm)


def make_fused_run(model, settings: ImsSettings, iss: bool, nsteps: int):
    """Multi-step transient run as one lax.scan over fused steps."""
    step = make_fused_step(model, settings, iss)

    def run(head0, delts):
        def body(head, xs):
            delt, kstp = xs
            head, kiter, inner, conv = step(head, delt, kstp)
            return head, (kiter, inner, conv)

        kstps = jnp.arange(1, nsteps + 1)
        head, (kiters, inners, convs) = lax.scan(body, head0, (delts, kstps))
        return head, kiters, inners, convs

    return run
