"""Benchmark: grid-cell Krylov-iteration throughput of the IMS-equivalent
implicit solve on the GPU.

Prints ONE JSON line:
  {"metric": "ims_cell_iters_per_s", "value": N, "unit": "cell-iter/s",
   "vs_baseline": R, "device": {...}, "card": "<name>, <power limit>"}

- value: grid cells × inner (Krylov) iterations per wall-clock second of
  the fully-fused transient solve (assembly + fixups + preconditioned
  CG inner loop) of the flagship model (``chip_smoke.flagship_inputs``).
- vs_baseline: ratio against a single-core scipy CSR implementation of the
  same Jacobi-CG iteration on the same system (a host-CPU proxy for the
  reference's Fortran IMS loop, which the environment cannot build).
- device: platform, device_kind and count as JAX reports them; card: the
  name and power limit nvidia-smi reports.

Fails when JAX finds no GPU.

Usage: python bench.py [--nlay N] [--nrow N] [--ncol N] [--steps N]
                       [--precision f64|mixed]
"""

import argparse
import json
import time

import numpy as np

import chip_smoke


def scipy_baseline_rate(a, b, x0, iters=60):
    """Single-core Jacobi-CG iteration rate with scipy CSR (cells·iter/s)."""
    n = b.size
    minv = 1.0 / a.diagonal()
    x = np.array(x0, np.float64)
    r = b - a @ x
    p = np.zeros_like(x)
    rho0 = 0.0
    t0 = time.perf_counter()
    for it in range(iters):
        z = minv * r
        rho = r @ z
        beta = 0.0 if it == 0 else rho / rho0
        p = z + beta * p
        q = a @ p
        alpha = rho / (p @ q)
        x += alpha * p
        r -= alpha * q
        rho0 = rho
    dt = time.perf_counter() - t0
    return n * iters / dt


def main():
    ap = argparse.ArgumentParser()
    # default = the flagship 4.2M-cell DIS model
    ap.add_argument("--nlay", type=int, default=4)
    ap.add_argument("--nrow", type=int, default=1024)
    ap.add_argument("--ncol", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--precision", choices=["f64", "mixed"], default="mixed",
                    help="mixed = f32 Krylov inner loop + f64 iterative "
                    "refinement (half the bytes per iteration; final heads "
                    "still satisfy the f64 IMS convergence criteria)")
    args = ap.parse_args()

    devs = chip_smoke.require_gpu()
    card = chip_smoke.card_name_and_power()
    import jax
    import jax.numpy as jnp
    import modflow6_tpu  # noqa: F401  (enables x64)
    from modflow6_tpu.solution import ImsSettings
    from modflow6_tpu.solution.fused import make_fused_run
    from modflow6_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    inp = chip_smoke.flagship_inputs(args.nlay, args.nrow, args.ncol)
    model = chip_smoke.build_flagship(inp)
    settings = ImsSettings(**chip_smoke.FLAGSHIP_IMS,
                           precision=args.precision)
    ncells = model.nodes
    run = jax.jit(make_fused_run(model, settings, iss=False,
                                 nsteps=args.steps))
    delts = jnp.asarray(np.full(args.steps, chip_smoke.DELT))
    h0 = jnp.asarray(model.strt)

    # compile + warmup
    out = run(h0, delts)
    jax.block_until_ready(out)
    # timed
    t0 = time.perf_counter()
    head, kiters, inners, convs = run(h0, delts)
    jax.block_until_ready(head)
    elapsed = time.perf_counter() - t0
    total_inner = int(np.asarray(inners).sum())
    rate = ncells * total_inner / elapsed

    a, b, _ = chip_smoke.reference_system(inp, np.asarray(model.strt),
                                          chip_smoke.DELT)
    base = scipy_baseline_rate(a, b, np.asarray(model.strt))

    print(json.dumps({
        "metric": "ims_cell_iters_per_s",
        "value": rate,
        "unit": "cell-iter/s",
        "vs_baseline": rate / base,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card,
        "cells": ncells,
        "steps": args.steps,
        "inner_total": total_inner,
        "elapsed_s": elapsed,
        "converged": bool(np.asarray(convs).all()),
    }))


if __name__ == "__main__":
    main()
