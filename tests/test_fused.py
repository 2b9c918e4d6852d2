"""Fused (fully-jitted) step parity with the diagnostic Python-loop path."""

import numpy as np

import jax
import jax.numpy as jnp

from modflow6_tpu.models.discretization import DisGrid
from modflow6_tpu.models.gwf.builder import build_gwf
from modflow6_tpu.solution import ImsSettings, NumericalSolution
from modflow6_tpu.solution.fused import make_fused_run, make_fused_step


def tight(**kw):
    base = dict(outer_dvclose=1e-8, outer_maximum=100,
                inner_dvclose=1e-10, inner_rclose=1e-9, inner_maximum=2000)
    base.update(kw)
    return ImsSettings(**base)


def make_model(transient=True):
    rng = np.random.default_rng(11)
    nrow, ncol = 12, 10
    g = DisGrid.create(1, nrow, ncol, 10.0, 10.0, 20.0,
                       np.zeros((1, nrow, ncol)))
    kw = dict(k=np.exp(rng.normal(0, 0.5, nrow * ncol)), strt=8.0,
              chd=[(i * ncol, 10.0) for i in range(nrow)],
              wel=[(55, -10.0)])
    if transient:
        kw["storage"] = {"ss": 1e-4, "iconvert": 0}
    return build_gwf("f", g, **kw)


def test_fused_step_matches_python_loop():
    model = make_model()
    s = tight()
    sol = NumericalSolution(model, s)
    h_ref, info, _ = sol.solve_timestep(model.strt, delt=2.0, kstp=1,
                                        iss=False)
    step = jax.jit(make_fused_step(model, s, iss=False))
    h_fused, kiter, inner, conv = step(jnp.asarray(model.strt),
                                       jnp.asarray(2.0),
                                       jnp.asarray(1, jnp.int32))
    assert bool(conv)
    assert int(kiter) == info.outer_iterations
    np.testing.assert_allclose(np.asarray(h_fused), np.asarray(h_ref),
                               rtol=0, atol=1e-12)


def test_fused_run_scan():
    model = make_model()
    s = tight()
    sol = NumericalSolution(model, s)
    delts = [1.0, 1.5, 2.25]
    h_ref = jnp.asarray(model.strt)
    for kstp, dt in enumerate(delts, 1):
        h_ref, info, _ = sol.solve_timestep(h_ref, delt=dt, kstp=kstp,
                                            iss=False)
        assert info.converged
    run = jax.jit(make_fused_run(model, s, iss=False, nsteps=3))
    h, kiters, inners, convs = run(jnp.asarray(model.strt),
                                   jnp.asarray(delts))
    assert bool(convs.all())
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), atol=1e-12)


def test_mixed_precision_matches_f64():
    """precision='mixed' (f32 Krylov + f64 iterative refinement,
    ops.solvers.krylov.refined_solve) must reach the same heads as the f64
    path to well below outer_dvclose, in both paths (fused + diagnostic)."""
    model = make_model()
    delts = [1.0, 2.0, 4.0]
    run64 = jax.jit(make_fused_run(model, tight(), iss=False, nsteps=3))
    h64, _, _, c64 = run64(jnp.asarray(model.strt), jnp.asarray(delts))
    runmx = jax.jit(make_fused_run(model, tight(precision="mixed"),
                                   iss=False, nsteps=3))
    hmx, _, _, cmx = runmx(jnp.asarray(model.strt), jnp.asarray(delts))
    assert bool(c64.all()) and bool(cmx.all())
    np.testing.assert_allclose(np.asarray(hmx), np.asarray(h64), atol=1e-7)

    sol = NumericalSolution(model, tight(precision="mixed"))
    h = jnp.asarray(model.strt)
    for kstp, dt in enumerate(delts, 1):
        h, info, _ = sol.solve_timestep(h, delt=dt, kstp=kstp, iss=False)
        assert info.converged
    np.testing.assert_allclose(np.asarray(h), np.asarray(h64), atol=1e-7)
