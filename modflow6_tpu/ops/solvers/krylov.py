"""Krylov accelerators: preconditioned CG and BiCGSTAB as jitted while-loops.

Behavioral parity targets in the reference IMS linear solver:
  - CG        src/Solution/LinearMethods/ImsLinearBase.f90:30-240 (ims_base_cg)
  - BiCGSTAB  ImsLinearBase.f90:249-549 (ims_base_bcgs)
  - convergence test ims_base_testcnvg (ImsLinearBase.f90)
  - epfact    ims_base_epfact

Design: the entire inner iteration runs inside one
``lax.while_loop`` on device — no host round trips per iteration.  The
matrix-vector product and the reduction ("dot") are injected as functions so
the same loop body serves the single-chip path (ELL SpMV, local dot) and
the sharded path (halo-exchange SpMV, ``psum`` dots) unchanged.

Convergence semantics match IMS: the iterate update's infinity norm
("dvmax", signed value of max magnitude) against DVCLOSE and the residual
infinity/L2 norm against RCLOSE, per ICNVGOPT.  The loop also exits on
stagnation (current and previous rho/alpha/omega equal to within 100*eps),
like the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ...constants import DPREC, DSAME


def vector_dot(a, b):
    """Default dot product.

    ``sum(a*b)``: a multiply fused into a reduction, which XLA emits
    as one pass over both vectors.
    """
    return jnp.sum(a * b)


class KrylovResult(NamedTuple):
    x: jax.Array
    iters: jax.Array     # number of inner iterations performed
    converged: jax.Array  # bool
    dvmax: jax.Array     # signed max dependent-variable change of last iter
    rmax: jax.Array      # signed max residual of last iter
    l2norm: jax.Array    # residual L2 norm of last iter
    # per-inner-iteration (dvmax, rmax, l2norm) arrays of shape (itmax,)
    # when the solver ran with trace=True (IMS CSV_INNER_OUTPUT role)
    trace: object = None


def _signed_absmax(v):
    return v[jnp.argmax(jnp.abs(v))]


def _is_close(a, b, rtol=None):
    if rtol is None:
        # 100 * machine eps of the working dtype (DSAME for f64; the f32
        # inner loop of refined_solve needs the f32 floor or stagnation
        # detection degenerates to exact equality)
        rtol = 100.0 * float(jnp.finfo(jnp.asarray(a).dtype).eps)
    return (a == b) | (jnp.abs(a - b) <= rtol * jnp.maximum(jnp.abs(a), jnp.abs(b)))


def _sign_dprec(x):
    eps = jnp.asarray(DPREC, x.dtype)
    return jnp.where(x >= 0.0, eps, -eps)


def _test_cnvg(icnvgopt, iiter0, dvmax, rcnvg, l2norm0, epfact, dvclose, rclose):
    """IMS convergence test; returns icnvg in {-1, 0, 1}.

    ``iiter0`` is the 0-based inner iteration index.
    """
    z = jnp.zeros((), jnp.int32)
    one = jnp.ones((), jnp.int32)
    neg = -one
    advclose = jnp.abs(dvmax) <= dvclose
    if icnvgopt == 0:
        return jnp.where(advclose & (jnp.abs(rcnvg) <= rclose), one, z)
    if icnvgopt == 1:
        hit = advclose & (jnp.abs(rcnvg) <= rclose)
        return jnp.where(hit, jnp.where(iiter0 == 0, one, neg), z)
    if icnvgopt == 2:
        return jnp.where(
            advclose | (rcnvg <= rclose), one,
            jnp.where(rcnvg <= l2norm0 * epfact, neg, z))
    if icnvgopt == 3:
        return jnp.where(advclose, one,
                         jnp.where(rcnvg <= l2norm0 * rclose, neg, z))
    if icnvgopt == 4:
        return jnp.where(
            advclose & (rcnvg <= rclose), one,
            jnp.where(rcnvg <= l2norm0 * epfact, neg, z))
    raise ValueError(f"unknown icnvgopt {icnvgopt}")


def epfact(icnvgopt: int, kstp) -> jax.Array:
    """Residual-criterion relaxation factor (reference ims_base_epfact)."""
    if icnvgopt == 2:
        return jnp.where(kstp == 1, 0.01, 0.10)
    if icnvgopt == 4:
        return jnp.asarray(1.0e-4)
    return jnp.asarray(1.0)


def cg(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array,
    precond: Callable,
    *,
    itmax: int,
    dvclose: float,
    rclose: float,
    icnvgopt: int = 0,
    north: int = 0,
    l2norm0=0.0,
    epfact_val=1.0,
    dot: Callable = vector_dot,
    absmax: Callable = _signed_absmax,
    trace: bool = False,
) -> KrylovResult:
    """Preconditioned conjugate gradient, IMS semantics.

    ``dot`` and ``absmax`` are injectable so the sharded path can use
    psum/pmax collectives (masked to owned rows) without changing the loop.
    ``trace=True`` records (dvmax, rmax, l2norm) per inner iteration into
    (itmax,) buffers riding the while_loop carry (CSV_INNER_OUTPUT role).
    """
    d0 = b - matvec(x0)

    def cond(s):
        return (~s["done"]) & (s["iiter"] < itmax)

    def body(s):
        iiter = s["iiter"]
        z = precond(s["d"])
        rho = dot(s["d"], z)
        beta = jnp.where(iiter == 0, 0.0,
                         rho / jnp.where(s["rho0"] != 0.0, s["rho0"], 1.0))
        p = z + beta * s["p"]
        q = matvec(p)
        denom = dot(p, q)
        denom = denom + _sign_dprec(denom)
        alpha = rho / denom
        tv = alpha * p
        x = s["x"] + tv
        dvmax = absmax(tv)
        d = s["d"] - alpha * q
        rmax = absmax(d)
        l2norm = jnp.sqrt(dot(d, d))
        rcnvg = l2norm if icnvgopt in (2, 3, 4) else rmax
        icnvg = _test_cnvg(icnvgopt, iiter, dvmax, rcnvg,
                           l2norm0, epfact_val, dvclose, rclose)
        icnvg = jnp.where(rcnvg == 0.0, jnp.ones((), jnp.int32), icnvg)
        stagnant = _is_close(rho, s["rho0"])
        done = (icnvg != 0) | stagnant | (rho == 0.0)
        if north > 0:
            recompute = ((iiter + 2) % north == 0) & ~done
            d = jnp.where(recompute, b - matvec(x), d)
        out = dict(x=x, d=d, p=p, rho0=rho, iiter=iiter + 1, icnvg=icnvg,
                   done=done, dvmax=dvmax, rmax=rmax, l2norm=l2norm)
        if trace:
            out["tr"] = tuple(
                buf.at[iiter].set(v) for buf, v in
                zip(s["tr"], (dvmax, rmax, l2norm)))
        return out

    zero = jnp.zeros((), b.dtype)
    init = dict(x=x0, d=d0, p=jnp.zeros_like(b), rho0=zero,
                iiter=jnp.zeros((), jnp.int32),
                icnvg=jnp.zeros((), jnp.int32),
                done=jnp.zeros((), bool), dvmax=zero, rmax=zero, l2norm=zero)
    if trace:
        init["tr"] = tuple(jnp.zeros(itmax) for _ in range(3))
    s = jax.lax.while_loop(cond, body, init)
    return KrylovResult(s["x"], s["iiter"], s["icnvg"] == 1,
                        s["dvmax"], s["rmax"], s["l2norm"],
                        s.get("tr"))


def refined_solve(
    solver: Callable,
    matvec64: Callable,
    matvec32: Callable,
    b: jax.Array,
    x0: jax.Array,
    precond32: Callable,
    *,
    itmax: int,
    dvclose: float,
    rclose: float,
    icnvgopt: int = 0,
    north: int = 0,
    l2norm0=0.0,
    epfact_val=1.0,
    dot: Callable = vector_dot,
    absmax: Callable = _signed_absmax,
    max_passes: int = 8,
) -> KrylovResult:
    """Mixed-precision linear solve: f32 Krylov + f64 iterative refinement.

    Design point: the Krylov inner loop (the reference's ims_base_cg hot
    loop, ImsLinearBase.f90:30-240) is bound by memory bandwidth, and f32
    halves the bytes every iteration moves.  Classic iterative refinement
    recovers full f64 accuracy:

        r = b - A x                (f64 residual, exact to working precision)
        repeat:  solve A d = r in f32 (Krylov, stagnation-guarded)
                 x += d; r = b - A x   (f64)
        until IMS convergence criteria hold in f64

    Each pass contracts the error by ~f32 machine epsilon (1e-7 relative),
    so 2-3 passes reach any f64-level dvclose/rclose.  The returned
    KrylovResult reports IMS-semantics convergence measured in f64 (dvmax of
    the last correction, f64 residual norms), so outer-loop behavior matches
    the f64 path.  ``dot``/``absmax`` are the injectable (possibly psum'd)
    reductions; they are used for both precisions.
    """
    f32 = jnp.float32
    f64 = b.dtype

    def f64_norms(r):
        rmax = absmax(r)
        l2 = jnp.sqrt(dot(r, r))
        return rmax, l2

    r0 = b - matvec64(x0)

    def cond(s):
        return (~s["done"]) & (s["npass"] < max_passes) & (s["iters"] < itmax)

    def body(s):
        r32 = s["r"].astype(f32)
        # each pass only needs to contract its own residual by ~1e-5 —
        # comfortably inside f32 — before handing control back to the f64
        # refinement; pushing the f32 recursion further just burns
        # iterations below its precision floor.  icnvgopt=3 exits on
        # l2 <= l2(pass start) * rclose (or on the caller's dvclose).
        l2r0 = jnp.sqrt(dot(r32, r32))
        res = solver(matvec32, r32, jnp.zeros_like(r32), precond32,
                     itmax=itmax, dvclose=dvclose, rclose=1.0e-5,
                     icnvgopt=3, north=north,
                     l2norm0=l2r0,
                     epfact_val=jnp.asarray(1.0, f32),
                     dot=dot, absmax=absmax)
        d = res.x.astype(f64)
        x = s["x"] + d
        r = b - matvec64(x)
        dvmax = absmax(d)
        rmax, l2 = f64_norms(r)
        rcnvg = l2 if icnvgopt in (2, 3, 4) else rmax
        icnvg = _test_cnvg(icnvgopt, jnp.zeros((), jnp.int32),
                           dvmax, rcnvg, l2norm0, epfact_val,
                           dvclose, rclose)
        # a pass that produced no correction cannot make progress (f32 floor)
        stalled = dvmax == 0.0
        done = (icnvg != 0) | stalled
        return dict(x=x, r=r, iters=s["iters"] + res.iters,
                    npass=s["npass"] + 1, done=done,
                    icnvg=icnvg, dvmax=dvmax, rmax=rmax, l2=l2)

    rmax0, l20 = f64_norms(r0)
    init = dict(x=x0, r=r0, iters=jnp.zeros((), jnp.int32),
                npass=jnp.zeros((), jnp.int32),
                done=jnp.zeros((), bool), icnvg=jnp.zeros((), jnp.int32),
                dvmax=jnp.zeros(()), rmax=rmax0, l2=l20)
    s = jax.lax.while_loop(cond, body, init)
    return KrylovResult(s["x"], s["iters"], s["icnvg"] == 1,
                        s["dvmax"], s["rmax"], s["l2"])


def bicgstab(
    matvec: Callable,
    b: jax.Array,
    x0: jax.Array,
    precond: Callable,
    *,
    itmax: int,
    dvclose: float,
    rclose: float,
    icnvgopt: int = 0,
    north: int = 0,
    l2norm0=0.0,
    epfact_val=1.0,
    dot: Callable = vector_dot,
    absmax: Callable = _signed_absmax,
    trace: bool = False,
) -> KrylovResult:
    """Preconditioned BiCGSTAB, IMS semantics (for asymmetric Newton/XT3D systems)."""
    d0 = b - matvec(x0)

    def cond(s):
        return (~s["done"]) & (s["iiter"] < itmax)

    def body(s):
        iiter = s["iiter"]
        rho = dot(s["dhat"], s["d"])
        beta = jnp.where(
            iiter == 0, 0.0,
            (rho / jnp.where(s["rho0"] != 0.0, s["rho0"], 1.0))
            * (s["alpha0"] / jnp.where(s["omega0"] != 0.0, s["omega0"], 1.0)))
        p = jnp.where(iiter == 0, s["d"],
                      s["d"] + beta * (s["p"] - s["omega0"] * s["v"]))
        phat = precond(p)
        v = matvec(phat)
        denom = dot(s["dhat"], v)
        denom = denom + _sign_dprec(denom)
        alpha = rho / denom
        q = s["d"] - alpha * v
        qhat = precond(q)
        t = matvec(qhat)
        numer = dot(t, q)
        denom2 = dot(t, t)
        denom2 = denom2 + _sign_dprec(denom2)
        omega = numer / denom2
        tv = alpha * phat + omega * qhat
        x = s["x"] + tv
        dvmax = absmax(tv)
        d = q - omega * t
        rmax = absmax(d)
        l2norm = jnp.sqrt(dot(d, d))
        rcnvg = l2norm if icnvgopt in (2, 3, 4) else rmax
        icnvg = _test_cnvg(icnvgopt, iiter, dvmax, rcnvg,
                           l2norm0, epfact_val, dvclose, rclose)
        icnvg = jnp.where(rcnvg == 0.0, jnp.ones((), jnp.int32), icnvg)
        stagnant = (_is_close(rho, s["rho0"]) | _is_close(alpha, s["alpha0"])
                    | _is_close(omega, s["omega0"]))
        done = (icnvg != 0) | stagnant | (rho * omega == 0.0)
        if north > 0:
            recompute = ((iiter + 2) % north == 0) & ~done
            d = jnp.where(recompute, b - matvec(x), d)
        out = dict(x=x, d=d, dhat=s["dhat"], p=p, v=v, rho0=rho,
                   alpha0=alpha, omega0=omega, iiter=iiter + 1,
                   icnvg=icnvg, done=done,
                   dvmax=dvmax, rmax=rmax, l2norm=l2norm)
        if trace:
            out["tr"] = tuple(
                buf.at[iiter].set(val) for buf, val in
                zip(s["tr"], (dvmax, rmax, l2norm)))
        return out

    zero = jnp.zeros((), b.dtype)
    init = dict(x=x0, d=d0, dhat=d0, p=jnp.zeros_like(b), v=jnp.zeros_like(b),
                rho0=zero, alpha0=zero, omega0=zero,
                iiter=jnp.zeros((), jnp.int32), icnvg=jnp.zeros((), jnp.int32),
                done=jnp.zeros((), bool), dvmax=zero, rmax=zero, l2norm=zero)
    if trace:
        init["tr"] = tuple(jnp.zeros(itmax) for _ in range(3))
    s = jax.lax.while_loop(cond, body, init)
    return KrylovResult(s["x"], s["iiter"], s["icnvg"] == 1,
                        s["dvmax"], s["rmax"], s["l2norm"], s.get("tr"))
