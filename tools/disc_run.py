#!/usr/bin/env python
"""Flagship Leicester-disc workload run: a
self-gravitating protoplanetary disc with beta cooling + sinks evolved
through sink formation and sustained accretion over >= 10 inner orbits,
on the accelerator. Tracks energy, angular momentum, sink count/mass, and
throughput; writes docs/disc_run.json every cadence.

RESUMABLE: bitwise restart dump at <checkout>/disc_out/disc_resume_{n}.npz every
cadence (delete to start fresh) — a wall kill costs one cadence.

Usage: python -u tools/disc_run.py [n_gas] [t_end] [stats_every_steps]

Inner orbit at r_in = 0.25 (G = M* = 1): T_in = 2*pi*0.125 = 0.785;
10 inner orbits = 7.9 time units. [G2: the fork's cooling+sink physics
is the reference's purpose per BASELINE.json.]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np


def sink_stats(state):
    s = state.sinks
    if s is None:
        return 0, 0.0, 0.0, 0
    used = s.slot >= 0
    idx = jnp.maximum(s.slot, 0)
    alive = used & state.p.alive[idx]
    n_sink = int(jnp.sum(alive))
    m_sink = float(jnp.sum(jnp.where(alive, state.p.mass[idx], 0.0)))
    m_acc = float(jnp.sum(jnp.where(alive, s.acc_mass, 0.0)))
    n_acc = int(jnp.sum(jnp.where(alive, s.n_accreted, 0)))
    return n_sink, m_sink, m_acc, n_acc


def main():
    n_gas = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    t_end = float(sys.argv[2]) if len(sys.argv) > 2 else 7.9
    every = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    from gadget_leicester_tpu.core.config import (SimOptions,
                                                  parse_parameter_text)
    from gadget_leicester_tpu.io.restart import load_restart, save_restart
    from gadget_leicester_tpu.models.ics import disc_ics
    from gadget_leicester_tpu.models.simulation import Simulation
    from gadget_leicester_tpu.models.sinks import register_sinks_from_types
    from gadget_leicester_tpu.utils.diagnostics import energy_statistics

    ptxt = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "parameterfiles", "disc.param")).read()
    ptxt = ptxt.replace("TimeMax             50.0",
                        f"TimeMax             {max(t_end, 10.0)}")
    cfg = parse_parameter_text(ptxt)
    opts = SimOptions(periodic=False, cooling="beta", sinks=True)

    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "disc_out")
    os.makedirs(out, exist_ok=True)
    resume = os.path.join(out, f"disc_resume_{n_gas}.npz")
    out_json = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "disc_run.json")

    sim = Simulation(cfg, opts)
    pos, vel, mass, ptype, u = disc_ics(n_gas=n_gas)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)
    rows = []
    if os.path.exists(resume):
        st, meta = load_restart(resume)
        sim.state = st
        sim.step_count = int(meta.get("step_count", 0))
        if os.path.exists(out_json):
            rows = json.load(open(out_json))["rows"]
        print(f"resumed at t={sim.time:.3f} step={sim.step_count}",
              flush=True)

    e0 = energy_statistics(sim.state, sim.cfg, sim.opts)
    L0 = np.asarray(e0.ang_mom)
    print(f"n={len(pos)} t0={sim.time:.3f} E0={float(e0.total):.5f} "
          f"Lz0={L0[2]:.5f} M0={float(e0.mass):.6f}", flush=True)

    t_wall0 = time.time()
    steps0 = sim.step_count
    while sim.time < t_end:
        sim.step()
        if (sim.step_count - steps0) % every == 0:
            e = energy_statistics(sim.state, sim.cfg, sim.opts)
            n_sink, m_sink, m_acc, n_acc = sink_stats(sim.state)
            wall = time.time() - t_wall0
            row = dict(t=float(sim.time), step=int(sim.step_count),
                       etot=float(e.total), epot=float(e.potential),
                       ekin=float(e.kinetic), etherm=float(e.internal),
                       Lz=float(np.asarray(e.ang_mom)[2]),
                       mass=float(e.mass), n_sink=n_sink, m_sink=m_sink,
                       m_accreted=m_acc, n_accreted=n_acc,
                       overflow=int(sim.state.overflow_flags),
                       wall_s=wall,
                       steps_per_s=(sim.step_count - steps0) / max(wall, 1e-9))
            rows.append(row)
            print(json.dumps(row), flush=True)
            save_restart(resume, sim.state, step_count=sim.step_count)
            os.makedirs(os.path.dirname(out_json), exist_ok=True)
            json.dump({"n_gas": n_gas, "t_end": t_end, "rows": rows},
                      open(out_json, "w"), indent=1)
    print("DONE t=", sim.time, flush=True)


if __name__ == "__main__":
    main()
