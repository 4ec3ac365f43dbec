#!/usr/bin/env python
"""Layzer-Irvine cosmic-energy conservation check on the lcdm_gas config
(gate |dE_LI|/|W| < 1e-3, BASELINE.json).

Usage: python -u tools/li_check.py [n_side] [a_end] [stats_every]

RESUMABLE: every stats cadence the run writes a bitwise restart dump +
the tracker's integral state to <checkout>/li_out/li_resume_{n_side}.npz; a re-run with the same n_side picks up from
the dump instead of re-integrating from a=0.0909, so a wall-budget kill
costs at most one cadence of progress. Delete the dump to start fresh.
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "li_out")
sys.path.insert(0, REPO)

from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np


def main():
    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    a_end = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25
    every = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    from gadget_leicester_tpu.core.config import (SimOptions, auto_pmgrid,
                                                  parse_parameter_text)
    from gadget_leicester_tpu.models.ics import lcdm_gas_ics
    from gadget_leicester_tpu.models.simulation import (Simulation,
                                                        potential_pass)
    from gadget_leicester_tpu.utils.diagnostics import (LayzerIrvineTracker,
                                                        energy_statistics)

    box = 50000.0
    param = f"""
InitCondFile x
OutputDir  {OUT}
TimeBegin  0.090909
TimeMax    1.0
ComovingIntegrationOn 1
PeriodicBoundariesOn 1
BoxSize    {box}
Omega0     0.3
OmegaLambda 0.7
OmegaBaryon 0.04
HubbleParam 0.7
ErrTolIntAccuracy 0.025
MaxSizeTimestep 0.025
CourantFac 0.15
DesNumNgb 33
MaxNumNgbDeviation 2
ArtBulkViscConst 0.8
InitGasTemp 1000
MinGasTemp 5
SofteningGas  {box / n_side / 30:.3f}
SofteningHalo {box / n_side / 30:.3f}
SofteningGasMaxPhys  {box / n_side / 30:.3f}
SofteningHaloMaxPhys {box / n_side / 30:.3f}
MinGasHsmlFractional 0.1
"""
    cfg = parse_parameter_text(param)
    pmgrid = auto_pmgrid(2 * n_side**3)
    # capacities: LI_SR_CAP/LI_SPH_CAP env overrides (0 = auto; overflow
    # is watched below)
    sr_cap = int(os.environ.get("LI_SR_CAP", "0"))
    sph_cap = int(os.environ.get("LI_SPH_CAP", "0"))
    opts = SimOptions(periodic=True, pmgrid=pmgrid, gravity_mode="treepm",
                      sph_backend="auto", sph_capacity=sph_cap,
                      sr_capacity=sr_cap)
    import dataclasses
    import json
    from gadget_leicester_tpu.io.restart import load_restart, save_restart
    from gadget_leicester_tpu.models.grids import make_grid_cache

    os.makedirs(OUT, exist_ok=True)
    resume_path = os.path.join(OUT, f"li_resume_{n_side}.npz")
    tracker = LayzerIrvineTracker()
    sim = Simulation(cfg, opts)
    if os.path.exists(resume_path):
        state, meta = load_restart(resume_path)
        sim.state = dataclasses.replace(
            state, grids=make_grid_cache(cfg, opts, state.p.n_max,
                                         state.gas.n_gas_max))
        li = json.loads(meta["li_tracker"])
        tracker._prev = tuple(li["prev"]) if li["prev"] else None
        tracker._integral = li["integral"]
        tracker._e0 = li["e0"]
        print(f"RESUME from {resume_path}: a={sim.time:.4f} "
              f"integral={tracker._integral:.6g}", flush=True)
    else:
        pos, vel, mass, ptype, u = lcdm_gas_ics(
            n_side=n_side, box=box, omega0=0.3, omega_b=0.04,
            hubble=cfg.hubble_internal, g=cfg.grav_internal)
        sim.set_ics(pos, vel, mass, ptype, u=u)
    print(f"N={2*n_side**3} pmgrid={pmgrid} a: {sim.time:.4f} -> {a_end}",
          flush=True)

    def dump():
        li = {"prev": list(tracker._prev) if tracker._prev else None,
              "integral": tracker._integral, "e0": tracker._e0}
        save_restart(resume_path, sim.canonical_state(),
                     extra_meta={"li_tracker": json.dumps(li)})

    def stats():
        sim.state = potential_pass(sim.state, cfg, opts)
        st = energy_statistics(sim.state, cfg, opts)
        a = sim.time
        d = tracker.update(a, st)
        print(f"a={a:.4f}  T={float(st.kinetic)/a**2:.6g} "
              f"W={float(st.potential)/a:.6g} U={float(st.internal):.6g} "
              f"LI drift={d:.3e} ovf={int(sim.state.overflow_flags)}",
              flush=True)
        return d

    t0 = time.time()
    stats()
    drift = 0.0
    nstep = 0
    while sim.time < a_end and nstep < 4000:
        sim.step(every)
        nstep += every
        drift = stats()
        dump()
    print(f"steps={nstep} wall={time.time()-t0:.0f}s final drift={drift:.3e}",
          flush=True)
    print("PASS" if drift < 1e-3 else "FAIL", flush=True)


if __name__ == "__main__":
    main()
