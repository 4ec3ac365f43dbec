#!/usr/bin/env python
"""Benchmark: particle updates per second per GPU on the lcdm_gas TreePM+SPH
workload (BASELINE.md north-star metric; reference instrument:
[G2: timings.txt part/sec, gravtree.c — the part/sec line always prints]).

Prints ONE JSON line to stdout:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "detail": {..., "device": ..., "card": "<name>, <power limit>"}}

Runs on a GPU only: without one, or if any phase fails, it exits non-zero
and prints no result. Env knobs: BENCH_NSIDE (default 128), BENCH_STEPS
(default 6), BENCH_PMGRID (default: auto from N).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BASELINE = 1e7  # north-star target [BASELINE.md]
METRIC = "particle_updates_per_sec_per_chip_lcdm_gas"


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def main():
    n_side = int(os.environ.get("BENCH_NSIDE", "128"))
    n_steps = int(os.environ.get("BENCH_STEPS", "6"))

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _log(f"no GPU (JAX found {dev.platform!r}); nothing measured")
        return 1
    from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _log(f"device: {dev.device_kind}; card: {card}")

    import jax.numpy as jnp

    from gadget_leicester_tpu.core import timeline
    from gadget_leicester_tpu.core.config import (SimOptions, auto_pmgrid,
                                                  parse_parameter_text)
    from gadget_leicester_tpu.models.ics import lcdm_gas_ics
    from gadget_leicester_tpu.models.simulation import (Simulation,
                                                        sync_point_step)

    box = 50000.0
    param = f"""
InitCondFile x
OutputDir  {os.path.join(REPO, "bench_out")}
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
    pmgrid = int(os.environ.get("BENCH_PMGRID", "0")) or auto_pmgrid(
        2 * n_side**3)
    opts = SimOptions(periodic=True, pmgrid=pmgrid, gravity_mode="treepm")
    sim = Simulation(cfg, opts)

    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=n_side, box=box, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    t0 = time.time()
    sim.set_ics(pos, vel, mass, ptype, u=u)
    jax.block_until_ready(sim.state)
    init_s = time.time() - t0

    @jax.jit
    def count_active(st):
        ti_next = timeline.min_active_ti_end(st.p.ti_endstep, st.p.alive)
        return jnp.sum(timeline.active_mask(st.p.ti_endstep, ti_next,
                                            st.p.alive))

    t0 = time.time()
    st = sync_point_step(sim.state, sim.cfg, sim.opts)
    upd0 = count_active(st)
    jax.block_until_ready((st, upd0 + upd0))
    compile_s = time.time() - t0
    _log(f"compile done in {compile_s:.1f}s")

    # the active count accumulates on the device: one readback at the end
    total = None
    t0 = time.time()
    for _ in range(n_steps):
        c = count_active(st)
        total = c if total is None else total + c
        st = sync_point_step(st, sim.cfg, sim.opts)
    jax.block_until_ready((st, total))
    elapsed = time.time() - t0
    updates = int(total)
    if int(st.overflow_flags):
        _log(f"overflow_flags={int(st.overflow_flags)}: result invalid")
        return 1

    ups = updates / elapsed
    print(json.dumps({
        "metric": METRIC,
        "value": round(ups, 1),
        "unit": "updates/s",
        "vs_baseline": round(ups / BASELINE, 4),
        "detail": {
            "n_particles": int(2 * n_side**3),
            "n_side": n_side,
            "steps": n_steps,
            "elapsed_s": round(elapsed, 3),
            "compile_s": round(compile_s, 2),
            "init_s": round(init_s, 2),
            "device": dev.device_kind,
            "card": card,
            "pmgrid": pmgrid,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
