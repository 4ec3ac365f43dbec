#!/usr/bin/env python
"""Evrard collapse energy curves at several resolutions — the published
trajectory oracle infrastructure (SURVEY.md §4 item 3).

Runs the gassphere (Evrard 1988) setup at the requested particle counts,
samples kinetic / thermal / potential energy on a fixed time grid, and
writes docs/evrard_curves.json. A converged high-resolution curve becomes
the committed reference table the e2e test asserts against
(tests/test_gassphere_e2e.py::test_evrard_energy_curves); the classic
published landmarks (Evrard 1988; Steinmetz & Mueller 1993 fig. 3;
the GADGET paper's gassphere figure) are asserted as wide physical
windows: collapse bounce near t~1, potential minimum depth, virial end
state. [UNVERIFIED-FORK: no external curve data is available in this
offline environment — the committed reference is the self-converged
high-N run, cross-checked between backends.]

Usage: python -u tools/evrard_curves.py [N1,N2,...] [t_end]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def run_curve(n_gas, t_end=3.0, n_samples=60, backend=None):
    import jax.numpy as jnp  # noqa: F401
    from gadget_leicester_tpu import read_parameter_file
    from gadget_leicester_tpu.core.config import SimOptions
    from gadget_leicester_tpu.models.ics import gassphere_ics
    from gadget_leicester_tpu.models.simulation import Simulation
    from gadget_leicester_tpu.utils.diagnostics import energy_statistics

    cfg = read_parameter_file(
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "parameterfiles",
            "gassphere.param"))
    # G=1 units; run past the bounce into virialization
    import dataclasses
    cfg = dataclasses.replace(cfg, grav_internal=1.0, time_max=t_end,
                              max_size_timestep=0.01)
    opts = SimOptions()
    if backend:
        opts = dataclasses.replace(opts, sph_backend=backend)
    sim = Simulation(cfg, opts)
    pos, vel, mass, ptype, u = gassphere_ics(n_gas=n_gas, mode="grid")
    sim.set_ics(pos, vel, mass, ptype, u=u)
    n_real = len(pos)

    ts = np.linspace(0.0, t_end, n_samples + 1)[1:]
    rows = []
    t_wall = time.time()
    for t_target in ts:
        sim.run_until(float(t_target))
        e = energy_statistics(sim.state, sim.cfg, sim.opts)
        rows.append(dict(t=float(sim.time),
                         ekin=float(e.kinetic),
                         etherm=float(e.internal),
                         epot=float(e.potential),
                         etot=float(e.total)))
        print(f"N={n_real} t={rows[-1]['t']:.3f} K={rows[-1]['ekin']:.4f} "
              f"U={rows[-1]['etherm']:.4f} W={rows[-1]['epot']:.4f} "
              f"E={rows[-1]['etot']:.4f}", flush=True)
    return dict(n_gas=n_real, t_end=t_end, wall_s=time.time() - t_wall,
                rows=rows)


def main():
    ns = [int(x) for x in (sys.argv[1].split(",") if len(sys.argv) > 1
                           else ["1472", "6000", "28000"])]
    t_end = float(sys.argv[2]) if len(sys.argv) > 2 else 3.0
    out = {"curves": []}
    for n in ns:
        out["curves"].append(run_curve(n, t_end=t_end))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "evrard_curves.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
