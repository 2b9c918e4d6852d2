"""CPU checks of what the GPU smoke run (chip_smoke.py) is built from: its
device check, its plain NumPy reference assembly and deck writer, the
compile cache placement, and the matvec each topology gets."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from modflow6_tpu.models.discretization import DisGrid, DisvGrid  # noqa: E402
from modflow6_tpu.models.gwf.builder import build_gwf  # noqa: E402
from modflow6_tpu.ops.system import make_matvec, to_scipy_csr  # noqa: E402
from modflow6_tpu.solution import ImsSettings  # noqa: E402
from modflow6_tpu.solution.fused import make_fused_run  # noqa: E402


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(env_set, tmp_path):
    from modflow6_tpu.utils import compile_cache

    before = jax.config.values["jax_compilation_cache_dir"]
    env = {compile_cache.ENV_VAR: str(tmp_path)} if env_set else {}
    try:
        path = compile_cache.enable_compile_cache(env)
        now = jax.config.values["jax_compilation_cache_dir"]
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_set:
        assert path == str(tmp_path)
        assert now == before  # JAX reads the variable itself
    else:
        assert path == now == str(compile_cache.CHECKOUT / ".jax_cache")
        assert (compile_cache.CHECKOUT / "chip_smoke.py").is_file()
        gitignore = (compile_cache.CHECKOUT / ".gitignore").read_text()
        assert ".jax_cache/" in gitignore.split()


def test_reference_assembly_matches_package():
    """The NumPy reference system equals the package's assembly on every
    row that is not constant-head."""
    inp = chip_smoke.flagship_inputs(2, 16, 16)
    model = chip_smoke.build_flagship(inp)
    n = model.nodes
    h_old = 40.0 + np.random.default_rng(1).normal(size=n)
    ib, h = model.boundary_state(jnp.asarray(h_old))
    diag, off, rhs = model.assemble(h, h, ib, chip_smoke.DELT, False)
    a_pkg = to_scipy_csr(model.topo, np.asarray(diag),
                         np.asarray(off)).toarray()
    a_ref, b_ref, fixed = chip_smoke.reference_system(inp, np.asarray(h),
                                                      chip_smoke.DELT)
    rows = ~fixed
    assert fixed.sum() == 2 * 16
    scale = np.abs(a_pkg).max()
    np.testing.assert_allclose(a_ref.toarray()[rows], a_pkg[rows],
                               rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(b_ref[rows], np.asarray(rhs)[rows],
                               rtol=1e-12)


def test_deck_round_trip_matches_fused(tmp_path):
    """The written deck, run through the command-line entry point, gives
    the fused f64 heads; its heads satisfy the reference equations."""
    from modflow6_tpu.__main__ import main

    shape, nsteps = (2, 16, 32), 2
    inp = chip_smoke.flagship_inputs(*shape)
    chip_smoke.write_deck(str(tmp_path), inp, chip_smoke.EXACT_IMS, nsteps)
    assert main([str(tmp_path)]) == 0
    heads = chip_smoke.read_step_heads(str(tmp_path / "flagship.hds"),
                                       shape[0])
    assert heads.shape == (nsteps, int(np.prod(shape)))

    model = chip_smoke.build_flagship(inp)
    run = jax.jit(make_fused_run(model, ImsSettings(**chip_smoke.EXACT_IMS),
                                 iss=False, nsteps=nsteps))
    h, _, _, conv = run(jnp.asarray(model.strt),
                        jnp.full(nsteps, chip_smoke.DELT))
    assert bool(conv.all())
    np.testing.assert_allclose(heads[-1], np.asarray(h), rtol=0, atol=1e-8)
    resid = chip_smoke.max_residual(inp, heads[-2], heads[-1],
                                    chip_smoke.DELT)
    assert resid <= chip_smoke.RESID_FACTOR * chip_smoke.EXACT_IMS[
        "inner_rclose"]


def _disv_grid(nlay, nrow, ncol, d=10.0):
    verts = [(j * d, -i * d) for i in range(nrow + 1)
             for j in range(ncol + 1)]
    cell2d = []
    for i in range(nrow):
        for j in range(ncol):
            v = i * (ncol + 1) + j
            cell2d.append(((j + 0.5) * d, -(i + 0.5) * d,
                           [v, v + 1, v + ncol + 2, v + ncol + 1]))
    ncpl = nrow * ncol
    return DisvGrid.create(nlay, ncpl, np.array(verts), cell2d, top=20.0,
                           botm=np.array([[0.0] * ncpl, [-20.0] * ncpl]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["dis", "disv"])
def test_make_matvec_matches_scipy(kind, dtype):
    """make_matvec gives A x for the structured (DIS) and the gathered
    (DISV) system, in f32 and f64."""
    nlay, nrow, ncol = 2, 6, 7
    if kind == "dis":
        grid = DisGrid.create(nlay, nrow, ncol, 10.0, 10.0, 20.0,
                              np.array([0.0, -20.0])[:, None, None]
                              * np.ones((nlay, nrow, ncol)))
    else:
        grid = _disv_grid(nlay, nrow, ncol)
    rng = np.random.default_rng(5)
    n = nlay * nrow * ncol
    model = build_gwf("mv", grid, k=np.exp(rng.normal(size=n)), strt=10.0,
                      storage={"ss": 1e-4, "iconvert": 0},
                      chd=[(0, 12.0)])
    assert (model.dtopo.grid_shape is not None) == (kind == "dis")
    ib, h = model.boundary_state(jnp.asarray(model.strt))
    diag, off, _ = model.assemble(h, h, ib, 1.0, False)
    x = rng.normal(size=n)
    y = make_matvec(model.dtopo, jnp.asarray(diag, dtype),
                    jnp.asarray(off, dtype))(jnp.asarray(x, dtype))
    assert y.dtype == dtype
    a = to_scipy_csr(model.topo, np.asarray(diag), np.asarray(off))
    ref = a @ x
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(np.asarray(y, np.float64), ref, rtol=0,
                               atol=tol * np.abs(a).max() * np.abs(x).max())
