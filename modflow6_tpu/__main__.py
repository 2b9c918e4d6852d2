"""Command-line entry point: ``python -m modflow6_tpu [workspace]``.

Role parity: the reference's ``mf6`` program + command-line flags
(src/mf6.f90:6-13, src/Utilities/comarg.f90:28-251): run the simulation
found in the working directory's mfsim.nam and print a termination
message.  Unrecognized reference-only flags are accepted and ignored with
a note where harmless.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mf6tpu",
        description="MODFLOW 6-compatible groundwater simulator (JAX)")
    ap.add_argument("workspace", nargs="?", default=".",
                    help="directory containing mfsim.nam (default: cwd)")
    ap.add_argument("-v", "--version", action="store_true",
                    help="print version and exit")
    ap.add_argument("-l", "--level", choices=["summary", "detail"],
                    default=None, help="profiling level (PROFILE_OPTION)")
    ap.add_argument("-m", "--mode", choices=["validate", "run"],
                    default="run",
                    help="validate = load inputs only (comarg -m validate)")
    ap.add_argument("--lst", default=None, help="listing file path")
    args = ap.parse_args(argv)

    import modflow6_tpu
    if args.version:
        print(f"modflow6-tpu {modflow6_tpu.__version__}")
        return 0

    from modflow6_tpu.utils.mf6io import load_simulation
    from modflow6_tpu.utils.mf6io.schema import set_strict

    # validate mode rejects unknown keywords outright (dfn-spec check)
    set_strict(args.mode == "validate")
    t0 = time.time()
    sim = load_simulation(args.workspace, lst_path=args.lst)
    if args.level:
        from modflow6_tpu.utils.profiler import Profiler
        sim.profile_mode = args.level
        sim.prof = Profiler()
    if args.mode == "validate":
        print(f"mf6tpu: model input validated "
              f"({sim.model.nodes} nodes, {sim.tdis.nper} periods)")
        return 0
    recs = sim.run()
    ok = all(r.converged for r in recs)
    elapsed = time.time() - t0
    if ok:
        print(f"Normal termination of simulation ({elapsed:.1f} s, "
              f"{len(recs)} steps)")
        return 0
    print("Premature termination of simulation: convergence failure",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    from modflow6_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
