"""CLI driver — `python -m gadget_leicester_tpu param.txt [restartflag]`,
the rebuild of `mpirun -np K Gadget2 param.txt [restartflag]` [G2: main.c].

restartflag: 0 (default) cold start from InitCondFile; 1 resume from
restart dump; 2 start from a snapshot file.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gadget_leicester_tpu",
        description="GADGET rebuilt in JAX: TreePM N-body + SPH")
    ap.add_argument("paramfile", help="GADGET parameter file")
    ap.add_argument("restartflag", nargs="?", type=int, default=0,
                    choices=[0, 1, 2])
    ap.add_argument("--max-steps", type=int, default=1000000)
    ap.add_argument("--pmgrid", type=int, default=None,
                    help="PM mesh size (the -DPMGRID compile flag analog); "
                         "default: auto-derived for periodic boxes (TreePM), "
                         "0 forces tree-only")
    ap.add_argument("--cooling", default=None,
                    choices=["none", "beta", "stamatellos"])
    ap.add_argument("--sinks", action="store_true", default=None)
    ap.add_argument("--isothermal", action="store_true", default=None)
    ap.add_argument("--makeglass", type=int, default=0, metavar="NSIDE",
                    help="MAKEGLASS mode: generate an NSIDE^3 glass file "
                         "into OutputDir and exit [G2: -DMAKEGLASS]")
    ap.add_argument("--devices", type=int, default=None, metavar="K",
                    help="run domain-decomposed over K devices (the "
                         "`mpirun -np K` analog); requires periodic TreePM")
    args = ap.parse_args(argv)

    from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from gadget_leicester_tpu.core.config import read_parameter_file
    from gadget_leicester_tpu.models.simulation import Simulation

    cfg = read_parameter_file(args.paramfile)
    if args.makeglass:
        import numpy as np
        from gadget_leicester_tpu.io.snapshot import (Header, SnapshotData,
                                                      write_snapshot)
        from gadget_leicester_tpu.models.glass import make_glass
        import os as _os
        box = cfg.box_size or 1.0
        pos, amax = make_glass(args.makeglass, box=box)
        n = len(pos)
        h = Header()
        h.npart = np.array([0, n, 0, 0, 0, 0], np.uint32)
        h.npart_total = h.npart.copy()
        h.box_size = box
        h.mass[1] = 1.0 / n
        snap = SnapshotData(header=h, pos=pos.astype(np.float32),
                            vel=np.zeros((n, 3), np.float32),
                            ids=np.arange(1, n + 1, dtype=np.uint32),
                            mass=np.full(n, 1.0 / n, np.float32))
        _os.makedirs(cfg.output_dir, exist_ok=True)
        out = _os.path.join(cfg.output_dir, "glass.dat")
        write_snapshot(out, snap, fmt=cfg.snap_format)
        print(f"glass written: {out} (N={n}, residual force ratio "
              f"{float(amax[-1] / amax[0]):.3f})")
        return 0
    # only explicitly-given flags override the config/sidecar derivation;
    # the stock lcdm_gas.param must run TreePM with no extra flags
    overrides = {}
    if args.pmgrid is not None:
        overrides["pmgrid"] = args.pmgrid
        overrides["gravity_mode"] = "treepm" if args.pmgrid else "auto"
    if args.cooling is not None:
        overrides["cooling"] = args.cooling
    if args.sinks is not None:
        overrides["sinks"] = args.sinks
    if args.isothermal is not None:
        overrides["isotherm_eqs"] = args.isothermal
    sim = Simulation.from_param_file(args.paramfile, None,
                                     restart_flag=args.restartflag,
                                     opt_overrides=overrides,
                                     mesh=args.devices)
    opts = sim.opts
    ndev = f" on {args.devices} devices" if args.devices else ""
    print(f"N={int(sim.state.p.alive.sum())} particles{ndev}; "
          f"t={sim.time:g} -> {cfg.time_max:g}; "
          f"gravity={opts.gravity_mode}, pmgrid={opts.pmgrid}")
    sim.run(max_steps=args.max_steps)
    print(f"done: {sim.step_count} steps, t={sim.time:g}, "
          f"{sim.snapshot_count} snapshots in {cfg.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
