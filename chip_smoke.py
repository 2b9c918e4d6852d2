"""Run the groundwater solve once on the GPU, end to end, and check it.

    python chip_smoke.py               # one card
    python chip_smoke.py --multichip   # four cards: the sharded paths only

On one card, in order:

1. exact: 1x256x256, one transient step of the fused f64 solve against
   scipy's direct solve of the same system, assembled by the plain NumPy
   reference in this file (max |dh| <= 1e-8 m);
2. fused: 4x1024x1024, three transient steps of the fused mixed-precision
   solve (the ``bench.py`` model and settings).  Prints compile seconds,
   wall seconds per step, iteration counts and peak device memory; the last
   step must satisfy the reference equations;
3. deck: the same model written as an ``mfsim.nam`` deck and run through
   ``python -m modflow6_tpu``'s ``main`` in this process (a child process
   would compete for the card's memory).  Its last heads must match the
   fused phase and satisfy the reference equations.

``--multichip`` runs one mixed-precision step of the 4x1024x1024 model on
the structured row-sharded path and on the general sharded path over a
four-device mesh, each against the single-card fused step on device 0.

The script exits non-zero, and prints no result, when JAX finds no GPU or a
phase fails.  Its last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = (4, 1024, 1024)
EXACT_SHAPE = (1, 256, 256)
DELT = 5.0
NSTEPS = 3
NDEV_MULTI = 4
# bench.py's IMS settings for the flagship model
FLAGSHIP_IMS = dict(outer_dvclose=1e-5, outer_maximum=50,
                    inner_dvclose=1e-7, inner_rclose=1e-5,
                    inner_maximum=400)
# tight settings (as tests/test_fused.py) with the inner loop run to
# dvclose 1e-12, so the f64 CG error stays far below the 1e-8 m bound
EXACT_IMS = dict(outer_dvclose=1e-8, outer_maximum=100,
                 inner_dvclose=1e-12, inner_rclose=1e-9,
                 inner_maximum=5000)
# f64 CG to inner_dvclose 1e-12 leaves an error far below this; the
# heads span ~10 m and GPU reduction order changes only the last bits
EXACT_TOL = 1e-8
# mixed (fused) and f64 (deck) runs both stop at outer_dvclose 1e-5
AGREE_TOL = 1e-4
# the residual of converged heads is <= inner_rclose in the solver's own
# arithmetic; the factor 10 allows for the reference's reassembly rounding
RESID_FACTOR = 10.0


# ------------------------------------------------------------- the model

def flagship_inputs(nlay, nrow, ncol, seed=75):
    """Raw inputs of the flagship model: a confined transient DIS aquifer
    with lognormal K, constant heads on the west (45 m) and east (35 m)
    columns of layer 1, one pumping well at the centre of layer 1 and
    uniform recharge."""
    rng = np.random.default_rng(seed)
    return dict(shape=(nlay, nrow, ncol), delr=10.0, delc=10.0, top=50.0,
                botm=np.linspace(0.0, -50.0, nlay),
                k=np.exp(rng.normal(0.0, 1.0, size=nlay * nrow * ncol)),
                ss=1e-5, strt=40.0, chd_west=45.0, chd_east=35.0,
                wel_node=(nrow // 2) * ncol + ncol // 2, wel_q=-500.0,
                rch=1e-4)


def chd_nodes(inp):
    """(nodes, heads) of the constant-head cells (layer 1)."""
    _, nrow, ncol = inp["shape"]
    rows = np.arange(nrow) * ncol
    nodes = np.concatenate([rows, rows + ncol - 1])
    heads = np.concatenate([np.full(nrow, inp["chd_west"]),
                            np.full(nrow, inp["chd_east"])])
    return nodes, heads


def build_flagship(inp):
    """The package's GwfModel of ``flagship_inputs``."""
    from modflow6_tpu.models.discretization import DisGrid
    from modflow6_tpu.models.gwf.builder import build_gwf

    nlay, nrow, ncol = inp["shape"]
    g = DisGrid.create(nlay, nrow, ncol, delr=inp["delr"], delc=inp["delc"],
                       top=inp["top"],
                       botm=inp["botm"][:, None, None]
                       * np.ones((nlay, nrow, ncol)))
    nodes, heads = chd_nodes(inp)
    return build_gwf(
        "flagship", g, k=inp["k"], strt=inp["strt"],
        storage={"ss": inp["ss"], "iconvert": 0},
        chd=list(zip(nodes.tolist(), heads.tolist())),
        wel=[(inp["wel_node"], inp["wel_q"])],
        rch=[(n, inp["rch"]) for n in range(nrow * ncol)])


def reference_system(inp, h_old, delt):
    """A, b and the constant-head mask of one transient step, in plain
    NumPy: MODFLOW 6's confined CVFD with harmonic-mean horizontal
    conductance, its vertical conductance, specific storage, WEL and RCH.
    Constant-head rows are identity rows.  Independent of the package."""
    import scipy.sparse as sp

    nlay, nrow, ncol = shape = inp["shape"]
    n = nlay * nrow * ncol
    delr, delc = inp["delr"], inp["delc"]
    area = delr * delc
    tops = np.concatenate([[inp["top"]], inp["botm"][:-1]])
    thick = np.broadcast_to((tops - inp["botm"])[:, None, None], shape)
    k = inp["k"].reshape(shape)
    t = k * thick
    node = np.arange(n).reshape(shape)

    def harmonic(t1, t2, width, length):
        # condmean, harmonic: width * t1 t2 / (t1 cl2 + t2 cl1), cl = length/2
        return width * t1 * t2 / (0.5 * length * (t1 + t2))

    faces = [
        (node[:, :, :-1], node[:, :, 1:],
         harmonic(t[:, :, :-1], t[:, :, 1:], delc, delr)),
        (node[:, :-1], node[:, 1:],
         harmonic(t[:, :-1], t[:, 1:], delr, delc)),
        (node[:-1], node[1:],
         area / (0.5 * thick[:-1] / k[:-1] + 0.5 * thick[1:] / k[1:])),
    ]
    i = np.concatenate([f[0].ravel() for f in faces])
    j = np.concatenate([f[1].ravel() for f in faces])
    c = np.concatenate([f[2].ravel() for f in faces])

    sc = inp["ss"] * area * thick.ravel() / delt
    diag = -sc - np.bincount(i, c, n) - np.bincount(j, c, n)
    b = -sc * np.asarray(h_old, np.float64)
    b[inp["wel_node"]] -= inp["wel_q"]
    b[:nrow * ncol] -= inp["rch"] * area

    fixed = np.zeros(n, bool)
    nodes, heads = chd_nodes(inp)
    fixed[nodes] = True
    b[nodes] = heads
    ki, kj = ~fixed[i], ~fixed[j]
    rows = np.concatenate([i[ki], j[kj], np.arange(n)])
    cols = np.concatenate([j[ki], i[kj], np.arange(n)])
    vals = np.concatenate([c[ki], c[kj], np.where(fixed, 1.0, diag)])
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return a, b, fixed


def max_residual(inp, h_old, h, delt):
    """max |A h - b| over the cells that are not constant-head."""
    a, b, fixed = reference_system(inp, h_old, delt)
    r = a @ np.asarray(h, np.float64) - b
    return float(np.abs(r[~fixed]).max())


def _write_binary_array(path, arr, text, shape):
    """One MODFLOW 6 binary array record: kstp, kper, pertim, totim, text,
    ncol, nrow, ilay, then the values as f64."""
    nlay, nrow, ncol = shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iidd", 1, 1, 0.0, 0.0))
        f.write(text.upper().rjust(16)[:16].encode())
        f.write(struct.pack("<iii", ncol, nrow, nlay))
        f.write(np.asarray(arr, "<f8").tobytes())


def write_deck(ws, inp, ims, nsteps, delt=DELT):
    """Write the flagship model as an mfsim.nam workspace: K and RCHA as
    OPEN/CLOSE (BINARY) arrays, CHD and WEL as lists, heads saved every
    step to ``flagship.hds``."""
    nlay, nrow, ncol = inp["shape"]

    def put(name, text):
        with open(os.path.join(ws, name), "w") as f:
            f.write(text.strip() + "\n")

    put("mfsim.nam", """
BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 flagship.nam flagship
END MODELS
BEGIN EXCHANGES
END EXCHANGES
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims flagship
END SOLUTIONGROUP""")
    put("sim.tdis", f"""
BEGIN OPTIONS
  TIME_UNITS DAYS
END OPTIONS
BEGIN DIMENSIONS
  NPER 1
END DIMENSIONS
BEGIN PERIODDATA
  {delt * nsteps!r} {nsteps} 1.0
END PERIODDATA""")
    put("sim.ims", f"""
BEGIN NONLINEAR
  OUTER_DVCLOSE {ims['outer_dvclose']!r}
  OUTER_MAXIMUM {ims['outer_maximum']}
  UNDER_RELAXATION NONE
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM {ims['inner_maximum']}
  INNER_DVCLOSE {ims['inner_dvclose']!r}
  INNER_RCLOSE {ims['inner_rclose']!r}
  LINEAR_ACCELERATION CG
END LINEAR""")
    put("flagship.nam", """
BEGIN PACKAGES
  DIS6 flagship.dis dis
  IC6 flagship.ic ic
  NPF6 flagship.npf npf
  STO6 flagship.sto sto
  CHD6 flagship.chd chd
  WEL6 flagship.wel wel
  RCH6 flagship.rcha rcha
  OC6 flagship.oc oc
END PACKAGES""")
    botm = "\n".join(f"    CONSTANT {v!r}" for v in inp["botm"].tolist())
    put("flagship.dis", f"""
BEGIN DIMENSIONS
  NLAY {nlay}
  NROW {nrow}
  NCOL {ncol}
END DIMENSIONS
BEGIN GRIDDATA
  DELR
    CONSTANT {inp['delr']!r}
  DELC
    CONSTANT {inp['delc']!r}
  TOP
    CONSTANT {inp['top']!r}
  BOTM LAYERED
{botm}
  IDOMAIN
    CONSTANT 1
END GRIDDATA""")
    put("flagship.ic", f"""
BEGIN GRIDDATA
  STRT
    CONSTANT {inp['strt']!r}
END GRIDDATA""")
    _write_binary_array(os.path.join(ws, "k.bin"), inp["k"], "K",
                        inp["shape"])
    put("flagship.npf", """
BEGIN GRIDDATA
  ICELLTYPE
    CONSTANT 0
  K
    OPEN/CLOSE k.bin (BINARY)
END GRIDDATA""")
    put("flagship.sto", f"""
BEGIN GRIDDATA
  ICONVERT
    CONSTANT 0
  SS
    CONSTANT {inp['ss']!r}
  SY
    CONSTANT 0.0
END GRIDDATA
BEGIN PERIOD 1
  TRANSIENT
END PERIOD""")
    nodes, heads = chd_nodes(inp)
    chd = "\n".join(f"  1 {n // ncol + 1} {n % ncol + 1} {h!r}"
                    for n, h in zip(nodes.tolist(), heads.tolist()))
    put("flagship.chd", f"""
BEGIN DIMENSIONS
  MAXBOUND {len(nodes)}
END DIMENSIONS
BEGIN PERIOD 1
{chd}
END PERIOD""")
    w = inp["wel_node"]
    put("flagship.wel", f"""
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 {w // ncol + 1} {w % ncol + 1} {inp['wel_q']!r}
END PERIOD""")
    _write_binary_array(os.path.join(ws, "rch.bin"),
                        np.full(nrow * ncol, inp["rch"]), "RECHARGE",
                        (1, nrow, ncol))
    put("flagship.rcha", """
BEGIN OPTIONS
  READASARRAYS
END OPTIONS
BEGIN PERIOD 1
  RECHARGE
    OPEN/CLOSE rch.bin (BINARY)
END PERIOD""")
    put("flagship.oc", """
BEGIN OPTIONS
  HEAD FILEOUT flagship.hds
END OPTIONS
BEGIN PERIOD 1
  SAVE HEAD ALL
END PERIOD""")


def read_step_heads(path, nlay):
    """Heads of every saved step of a .hds file, as flat [nsteps, N]."""
    from modflow6_tpu.utils.binary import read_head_file

    recs = read_head_file(path)
    layers = [r["data"].reshape(-1) for r in recs]
    return np.stack([np.concatenate(layers[s:s + nlay])
                     for s in range(0, len(layers), nlay)])


# ------------------------------------------------------------ the device

def require_gpu():
    """The JAX devices, if they are GPUs; exit non-zero otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}")
    return devs


def card_name_and_power():
    """nvidia-smi's name and power limit of each card (a child process
    that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class CacheEvents:
    """Counts JAX's persistent compilation cache hits and misses while
    active."""

    def __init__(self):
        self.hits = self.misses = 0

    def __call__(self, event, **kwargs):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def __str__(self):
        return f"cache_hits={self.hits} cache_misses={self.misses}"


@contextlib.contextmanager
def cache_events():
    import jax

    ev = CacheEvents()
    jax.monitoring.register_event_listener(ev)
    try:
        yield ev
    finally:
        jax.monitoring.unregister_event_listener(ev)


def _peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ------------------------------------------------------------- the phases

def _fused_step(model, ims, precision):
    import jax
    from modflow6_tpu.solution import ImsSettings
    from modflow6_tpu.solution.fused import make_fused_step

    settings = ImsSettings(**ims, precision=precision)
    return jax.jit(make_fused_step(model, settings, iss=False))


def exact_phase(shape=EXACT_SHAPE):
    """One fused f64 step against scipy's direct solve of the reference
    system."""
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    inp = flagship_inputs(*shape)
    model = build_flagship(inp)
    step = _fused_step(model, EXACT_IMS, "f64")
    with cache_events() as ev:
        h, kiter, inner, conv = step(jnp.asarray(model.strt),
                                     jnp.asarray(DELT),
                                     jnp.asarray(1, jnp.int32))
        h = np.asarray(h)
    a, b, _ = reference_system(inp, np.full(h.size, inp["strt"]), DELT)
    h_ref = spla.spsolve(a.tocsc(), b)
    err = float(np.abs(h - h_ref).max())
    ok = bool(conv) and err <= EXACT_TOL
    print(f"exact: shape={shape} converged={bool(conv)} outer={int(kiter)} "
          f"inner={int(inner)} max_dh={err!r} tol={EXACT_TOL} {ev} ok={ok}",
          flush=True)
    return ok


def fused_phase(shape=FLAGSHIP, nsteps=NSTEPS):
    """The fused mixed-precision run; returns (ok, heads of every step)."""
    import jax
    import jax.numpy as jnp

    inp = flagship_inputs(*shape)
    t0 = time.perf_counter()
    model = build_flagship(inp)
    t_build = time.perf_counter() - t0
    step = _fused_step(model, FLAGSHIP_IMS, "mixed")
    h = jnp.asarray(model.strt)
    args = (h, jnp.asarray(DELT), jnp.asarray(1, jnp.int32))
    with cache_events() as ev:
        t0 = time.perf_counter()
        compiled = step.lower(*args).compile()
        t_compile = time.perf_counter() - t0
    print(f"fused: shape={shape} cells={int(np.prod(shape))} "
          f"build_s={t_build!r} compile_s={t_compile!r} {ev}", flush=True)
    print(f"fused: memory_analysis {compiled.memory_analysis()}", flush=True)
    heads = [np.asarray(model.strt)]
    ok = True
    for kstp in range(1, nsteps + 1):
        t0 = time.perf_counter()
        h, kiter, inner, conv = compiled(h, jnp.asarray(DELT),
                                         jnp.asarray(kstp, jnp.int32))
        jax.block_until_ready(h)
        dt = time.perf_counter() - t0
        ok &= bool(conv)
        heads.append(np.asarray(h))
        print(f"fused: step={kstp} wall_s={dt!r} outer={int(kiter)} "
              f"inner={int(inner)} converged={bool(conv)}", flush=True)
    peak = _peak_bytes(jax.devices()[0])
    resid = max_residual(inp, heads[-2], heads[-1], DELT)
    limit = RESID_FACTOR * FLAGSHIP_IMS["inner_rclose"]
    ok &= resid <= limit
    print(f"fused: peak_bytes_in_use={peak} max_residual={resid!r} "
          f"limit={limit!r} ok={ok}", flush=True)
    return ok, heads


def deck_phase(fused_heads, shape=FLAGSHIP, nsteps=NSTEPS):
    """The flagship deck through the command-line entry point, against the
    fused phase's last heads."""
    from modflow6_tpu.__main__ import main as mf6_main

    inp = flagship_inputs(*shape)
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        write_deck(ws, inp, FLAGSHIP_IMS, nsteps)
        t_write = time.perf_counter() - t0
        with cache_events() as ev:
            t0 = time.perf_counter()
            rc = mf6_main([ws])
            t_run = time.perf_counter() - t0
        heads = read_step_heads(os.path.join(ws, "flagship.hds"), shape[0])
    h_old = heads[-2] if len(heads) > 1 else np.full(heads.shape[1],
                                                     inp["strt"])
    resid = max_residual(inp, h_old, heads[-1], DELT)
    limit = RESID_FACTOR * FLAGSHIP_IMS["inner_rclose"]
    err = float(np.abs(heads[-1] - fused_heads[-1]).max())
    ok = (rc == 0 and len(heads) == nsteps and err <= AGREE_TOL
          and resid <= limit)
    print(f"deck: shape={shape} rc={rc} steps={len(heads)} "
          f"write_s={t_write!r} run_s={t_run!r} {ev} "
          f"max_dh_vs_fused={err!r} tol={AGREE_TOL} max_residual={resid!r} "
          f"limit={limit!r} ok={ok}", flush=True)
    return ok


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def multichip_phase(shape=FLAGSHIP, ndev=NDEV_MULTI):
    """One mixed step on the structured and general sharded paths over
    ``ndev`` devices, each against the single-device fused step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from modflow6_tpu.parallel import partition_model
    from modflow6_tpu.parallel.general import (GeneralShardedSolution,
                                               partition_general)
    from modflow6_tpu.parallel.sharded import ShardedSolution
    from modflow6_tpu.solution import ImsSettings

    devs = jax.devices()
    if len(devs) < ndev:
        raise SystemExit(f"chip_smoke: --multichip needs {ndev} devices, "
                         f"JAX found {len(devs)}")
    inp = flagship_inputs(*shape)
    model = build_flagship(inp)
    step = _fused_step(model, FLAGSHIP_IMS, "mixed")
    args = (jnp.asarray(model.strt), jnp.asarray(DELT),
            jnp.asarray(1, jnp.int32))
    _, t_first = _timed(lambda: step(*args))
    (h_ref, _, _, conv), t_step = _timed(lambda: step(*args))
    h_ref = np.asarray(h_ref)
    print(f"multichip: single device0 first_call_s={t_first!r} "
          f"step_s={t_step!r} converged={bool(conv)}", flush=True)
    ok = bool(conv)

    mesh = Mesh(np.array(devs[:ndev]), ("y",))
    settings = ImsSettings(**FLAGSHIP_IMS, precision="mixed")
    for name, partition, cls in (
            ("structured", partition_model, ShardedSolution),
            ("general", partition_general, GeneralShardedSolution)):
        t0 = time.perf_counter()
        sol = cls(partition(model, ndev), settings, mesh=mesh)
        t_part = time.perf_counter() - t0
        h0 = sol.scatter_heads(np.asarray(model.strt))
        call = lambda: sol.solve_timestep(h0, delt=DELT, kstp=1,  # noqa: E731
                                          iss=False)
        _, t_first = _timed(call)
        (hs, info), t_step = _timed(call)
        placed = {sh.device.id for sh in hs.addressable_shards}
        err = float(np.abs(sol.gather_heads(hs) - h_ref).max())
        good = (info["converged"] and err <= AGREE_TOL
                and len(placed) == ndev)
        ok &= good
        print(f"multichip: {name} shards={ndev} devices={sorted(placed)} "
              f"partition_s={t_part!r} first_call_s={t_first!r} "
              f"step_s={t_step!r} outer={info['outer']} "
              f"inner={info['inner']} converged={info['converged']} "
              f"max_dh_vs_single={err!r} tol={AGREE_TOL} ok={good}",
              flush=True)
    return ok


# ------------------------------------------------------------------ main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help=f"run only the sharded paths on {NDEV_MULTI} cards")
    args = ap.parse_args(argv)

    devs = require_gpu()
    print(f"device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}", flush=True)
    print(f"card: {card_name_and_power()}", flush=True)

    import modflow6_tpu  # noqa: F401  (enables x64)
    from modflow6_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile_cache: {enable_compile_cache()}", flush=True)
    if args.multichip:
        ok = multichip_phase()
    else:
        ok = exact_phase()
        fused_ok, heads = fused_phase()
        ok = deck_phase(heads) and fused_ok and ok
    if not ok:
        raise SystemExit("chip_smoke: a phase failed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    sys.exit(main())
