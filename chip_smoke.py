#!/usr/bin/env python
"""GPU smoke test: the lcdm_gas TreePM+SPH main path at 2 x 128^3 on one card,
and every cell-pair kernel checked against its plain references there.

    python chip_smoke.py            # one GPU: main path + kernel parity
    python chip_smoke.py --four     # four GPUs: the SPMD slab step against
                                    # the one-card run, and nothing else

Phases (one process; any failure exits non-zero before the last line):

1. Main path. ``parameterfiles/lcdm_gas.param`` with 2 x 128^3 particles
   from ``lcdm_gas_ics`` (random Zeldovich field from ``--seed``) goes
   through ``Simulation(cfg, opts)`` -> ``set_ics`` -> ``Simulation.run``:
   two sync points that compile (the step, then the first energy
   statistics), then ``--steps`` timed ones. The state must stay finite with the particle count
   unchanged, no overflow bit set and no capacity bump.
2. Kernel parity (compiled for the card, never interpreted), on the final
   state at full width: each Triton sum against the XLA cells path on the
   same cell list (precision HIGHEST), the SPH sums against the all-pairs
   oracle (ops.sph_dense) on a sub-volume, and the TreePM total against
   direct summation with the Ewald correction (utils.forcetest) on 4096
   random particles. Each line prints the measured numbers beside the
   tolerance and the reason for it.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

# Tolerances of the parity checks (printed beside each result).
# Sums against the XLA path differ only by summation order and f32
# rounding of the separations (the kernel uses cell-relative coordinates,
# the XLA path box coordinates). The short-range gravity and the hydro
# acceleration of a near-uniform early-time box are residuals of nearly
# cancelling pair terms, so their error is judged relative to the rms
# force and per particle only at the 99th percentile; density-like sums
# have no cancellation and are held per particle.
TOL = {
    "vector_p99_rel": 1e-3,      # 99th pct of |d a| / |a|
    "vector_max_rms": 1e-2,      # max |d a| / rms |a| (rcut-edge pairs)
    "scalar_p99_rel": 1e-5,      # 99th pct of |d x| / |x| (rho, phi)
    "scalar_max_rel": 1e-4,
    # the truncated potential jumps by erfc(2.25) m / rcut ~ 1.5e-3 m / rcut
    # at rcut: a pair whose separation rounds across rcut (box coordinates
    # in the XLA path, cell-relative in the kernel) moves phi by ~1e-4
    "pot_max_rel": 1e-3,
    "field_max": 1e-4,           # max |d x| / max |x| (dA/dt, div, curl)
    # max_signal_vel is a MAX over the pairs inside max(h_i, h_j): a pair
    # at the support edge can enter one path's set and not the other's
    # (the sums are continuous there, W' -> 0; the max is not)
    "vsig_p99_rel": 1e-5,
    "vsig_max_rel": 1e-2,
    "oracle_vector_rms": 1e-3,   # all-pairs SPH oracle: rms-relative
    "oracle_scalar_max": 1e-4,
    "treepm_rms": 1e-2,          # README: < 1% rms force error (of max)
}


def _fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(name, ok, detail):
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        _fail(name)


def _card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        _fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def _timed(fn, reps=3):
    """(result, first-call seconds, [steady seconds]) with device fences."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, ts


def _vec_err(got, ref):
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.linalg.norm(got - ref, axis=-1)
    a = np.linalg.norm(ref, axis=-1)
    rms = np.sqrt(np.mean(a * a))
    rel = d / np.maximum(a, 1e-30)
    return float(np.percentile(rel, 99)), float(d.max() / rms), \
        float(np.sqrt(np.mean(d * d)) / rms)


def _scal_err(got, ref):
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    return float(np.percentile(rel, 99)), float(rel.max()), \
        float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _setup(n_side, seed):
    import dataclasses
    from gadget_leicester_tpu.core.config import (options_from_config,
                                                  read_parameter_file)
    from gadget_leicester_tpu.models.ics import lcdm_gas_ics
    cfg = read_parameter_file(os.path.join(REPO, "parameterfiles",
                                           "lcdm_gas.param"))
    cfg = dataclasses.replace(cfg, output_dir=OUT_DIR)
    os.makedirs(OUT_DIR, exist_ok=True)
    ics = lcdm_gas_ics(n_side=n_side, box=cfg.box_size, omega0=cfg.omega0,
                       omega_b=cfg.omega_baryon, hubble=cfg.hubble_internal,
                       g=cfg.grav_internal, seed=seed)
    opts = options_from_config(cfg, n_particles=len(ics[0]))
    return cfg, opts, ics


def _check_state(sim, n, label):
    import jax.numpy as jnp
    import numpy as np
    from gadget_leicester_tpu.models.simulation import potential_pass
    from gadget_leicester_tpu.utils.diagnostics import energy_statistics
    st = sim.canonical_state()
    ovf = int(st.overflow_flags)
    print(f"{label}: overflow_flags={ovf} sr_capacity={sim.opts.sr_capacity}"
          f" sph_capacity={sim.opts.sph_capacity}", flush=True)
    _check(f"{label} overflow", ovf == 0 and sim.opts.sr_capacity == 0
           and sim.opts.sph_capacity == 0,
           "no overflow bit and no capacity bump (0 = auto capacities)")
    alive = int(jnp.sum(st.p.alive))
    _check(f"{label} particle count", alive == n, f"{alive} of {n} alive")
    ng = st.gas.n_gas_max
    fields = {"pos": st.p.pos, "vel": st.p.vel, "acc": st.p.acc,
              "rho": st.gas.density[:ng], "hsml": st.gas.hsml,
              "entropy": st.gas.entropy}
    bad = [k for k, v in fields.items() if not bool(jnp.all(jnp.isfinite(v)))]
    _check(f"{label} finite state", not bad, f"non-finite: {bad or 'none'}")
    gas = np.asarray(st.p.alive[:ng] & (st.p.ptype[:ng] == 0))
    rho = np.asarray(st.gas.density)[gas]
    _check(f"{label} densities", bool(np.all(rho > 0)),
           f"rho min {rho.min():.6g} max {rho.max():.6g}")
    e = energy_statistics(potential_pass(st, sim.cfg, sim.opts), sim.cfg,
                          sim.opts)
    vals = {k: float(getattr(e, k)) for k in ("kinetic", "potential",
                                                "internal", "total")}
    _check(f"{label} finite energies",
           all(np.isfinite(v) for v in vals.values()),
           " ".join(f"{k}={v:.9g}" for k, v in vals.items()))
    return st


# ---------------------------------------------------------------------------
# phase 1: the main path on one card
# ---------------------------------------------------------------------------
def main_path(n_side, steps, seed):
    import jax
    from gadget_leicester_tpu.models.simulation import Simulation
    cfg, opts, ics = _setup(n_side, seed)
    n = len(ics[0])
    print(f"N = {n} ({n_side}^3 gas + {n_side}^3 dark matter), "
          f"pmgrid = {opts.pmgrid}", flush=True)
    sim = Simulation(cfg, opts)
    t0 = time.perf_counter()
    sim.set_ics(*ics[:4], u=ics[4])
    jax.block_until_ready(sim.state)
    print(f"set_ics seconds (compile + initial density/forces): "
          f"{time.perf_counter() - t0:.3f}", flush=True)
    # the first sync point closes the initial half step (a does not move)
    # and the second runs the first energy statistics: both compile
    t0 = time.perf_counter()
    sim.run(max_steps=2)
    jax.block_until_ready(sim.state)
    print(f"compile seconds (first two Simulation.run sync points: step, "
          f"potential and energy-statistics programs compiled and run): "
          f"{time.perf_counter() - t0:.3f}", flush=True)
    t0 = time.perf_counter()
    sim.run(max_steps=steps)
    jax.block_until_ready(sim.state)
    dt = (time.perf_counter() - t0) / steps
    print(f"seconds per step (Simulation.run, {steps} steady sync points, "
          f"host loop and logs included): {dt:.4f}", flush=True)
    print(f"steps taken: {sim.step_count}, a = {sim.time:.6f}", flush=True)
    st = _check_state(sim, n, "main path")
    return cfg, sim.opts, st


# ---------------------------------------------------------------------------
# phase 2: kernel parity at full width
# ---------------------------------------------------------------------------
def kernel_parity(cfg, opts, st):
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gadget_leicester_tpu.core.config import GAMMA
    from gadget_leicester_tpu.models.forces import (_treepm_gravity,
                                                    comoving_factors,
                                                    softening_table)
    from gadget_leicester_tpu.models.grids import (grav_grid_geometry,
                                                   sph_cells_geometry)
    from gadget_leicester_tpu.ops.cell_pairs import (density_sweep_kernel,
                                                     pair_backend)
    from gadget_leicester_tpu.ops.gravity_short import \
        shortrange_gravity_cells
    from gadget_leicester_tpu.ops.neighbors import build_cell_list
    from gadget_leicester_tpu.ops.pm import ASMTH, RCUT
    from gadget_leicester_tpu.ops.softening import SOFTFAC
    from gadget_leicester_tpu.ops.sph_cells import (density_sums_cells,
                                                    hydro_force_cells)
    from gadget_leicester_tpu.ops.sph_dense import density_sums, hydro_force
    from gadget_leicester_tpu.utils.forcetest import exact_periodic_acc

    _check("dispatch", pair_backend() == "triton",
           f"pair_backend() = {pair_backend()!r} on "
           f"{jax.default_backend()!r}")
    p, gas = st.p, st.gas
    box = float(cfg.box_size)
    fac = comoving_factors(cfg, st.ti_current)
    eps = softening_table(cfg, fac.atime)
    soft = SOFTFAC * eps[p.ptype]

    # --- short-range gravity ------------------------------------------
    n_cells, cap, _ = grav_grid_geometry(cfg, opts, p.n_max)
    asmth = ASMTH * box / opts.pmgrid
    rcut = RCUT * asmth
    cl = jax.jit(lambda q: build_cell_list(
        q, p.alive, 0.0, box, n_cells=n_cells, capacity=cap,
        periodic=True))(p.pos)
    _check("gravity grid", not bool(cl.overflow),
           f"{n_cells}^3 cells, capacity {cap}, max count "
           f"{int(cl.counts.max())}")

    def grav(backend):
        return jax.jit(lambda c, q: shortrange_gravity_cells(
            c, q, p.mass, soft, p.alive, asmth, rcut, box=box,
            periodic=True, with_potential=True, backend=backend))

    gk = grav("triton")
    gx = grav("xla")
    (ak, pk), ck, tk = _timed(lambda: gk(cl, p.pos))
    (ax, px), cx, tx = _timed(lambda: gx(cl, p.pos))
    print(f"timing sr_gravity: triton {min(tk):.6f} s (first call "
          f"{ck:.2f} s), xla {min(tx):.6f} s (first call {cx:.2f} s), "
          f"same cell list, N = {p.n_max}", flush=True)
    p99, mx, _ = _vec_err(ak, ax)
    _check("sr_gravity acc vs XLA cells (precision HIGHEST)",
           p99 <= TOL["vector_p99_rel"] and mx <= TOL["vector_max_rms"],
           f"p99 |da|/|a| = {p99:.3e} (tol {TOL['vector_p99_rel']:.0e}), "
           f"max |da|/rms = {mx:.3e} (tol {TOL['vector_max_rms']:.0e})")
    s99, smx, _ = _scal_err(pk, px)
    _check("sr_gravity pot vs XLA cells (precision HIGHEST)",
           s99 <= TOL["scalar_p99_rel"] and smx <= TOL["pot_max_rel"],
           f"p99 rel = {s99:.3e} (tol {TOL['scalar_p99_rel']:.0e}), max "
           f"rel = {smx:.3e} (tol {TOL['pot_max_rel']:.0e})")
    del ax, px

    # TreePM total against direct summation + Ewald correction
    rng = np.random.default_rng(5)
    sub = jnp.asarray(np.sort(rng.choice(p.n_max, 4096, replace=False)))
    def treepm_total(s):
        acc_sr, _, _, _, acc_pm, _ = _treepm_gravity(s, cfg, opts, soft)
        return acc_sr[sub] * cfg.grav_internal + acc_pm[sub]

    tot = jax.jit(treepm_total)(dataclasses.replace(st, grids=None))
    t0 = time.perf_counter()
    exact = jax.block_until_ready(jax.jit(
        lambda: exact_periodic_acc(p.pos, p.mass, soft, p.alive, sub,
                                   box))()) * cfg.grav_internal
    print(f"direct+Ewald oracle on 4096 targets: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    d = np.linalg.norm(np.asarray(tot, np.float64)
                       - np.asarray(exact, np.float64), axis=1)
    a = np.linalg.norm(np.asarray(exact, np.float64), axis=1)
    rms_max = float(np.sqrt(np.mean(d * d)) / a.max())
    _check("TreePM total vs direct+Ewald (4096 random particles)",
           rms_max <= TOL["treepm_rms"],
           f"rms |da| / max |a| = {rms_max:.3e} (tol "
           f"{TOL['treepm_rms']:.0e}: README < 1% rms force error, "
           f"normalised as in tests/test_pm.py); rms |da| / rms |a| = "
           f"{np.sqrt(np.mean(d * d) / np.mean(a * a)):.3e}, median "
           f"|da|/|a| = {np.median(d / a):.3e} (early-time net force is a "
           f"small residual)")

    # --- SPH ----------------------------------------------------------
    ng = gas.n_gas_max
    pos_g, vel_g, mass_g = p.pos[:ng], gas.vel_pred, p.mass[:ng]
    gm = p.alive[:ng] & (p.ptype[:ng] == 0)
    n_sph, cap_s = sph_cells_geometry(cfg, opts, ng)
    cls = jax.jit(lambda q: build_cell_list(
        q, gm, 0.0, box, n_cells=n_sph, capacity=cap_s,
        periodic=True))(pos_g)
    _check("SPH grid", not bool(cls.overflow),
           f"{n_sph}^3 cells, capacity {cap_s}, max count "
           f"{int(cls.counts.max())}")
    h = gas.hsml

    dk_fn = jax.jit(lambda c, q, hh: density_sweep_kernel(
        c, q, vel_g, mass_g, gm, gm)(hh))
    dx_fn = jax.jit(lambda c, q, hh: density_sums_cells(
        c, q, vel_g, mass_g, hh, gm, box=box, periodic=True))
    dk, ck, tk = _timed(lambda: dk_fn(cls, pos_g, h))
    dxr, cx, tx = _timed(lambda: dx_fn(cls, pos_g, h))
    print(f"timing sph_density (one sweep): triton {min(tk):.6f} s (first "
          f"call {ck:.2f} s), xla {min(tx):.6f} s (first call {cx:.2f} s), "
          f"same cell list, Ngas = {ng}", flush=True)
    g = np.asarray(gm)
    s99, smx, _ = _scal_err(np.asarray(dk[0])[g], np.asarray(dxr[0])[g])
    _check("sph_density rho vs XLA cells (precision HIGHEST)",
           s99 <= TOL["scalar_p99_rel"] and smx <= TOL["scalar_max_rel"],
           f"p99 rel = {s99:.3e} (tol {TOL['scalar_p99_rel']:.0e}), max "
           f"rel = {smx:.3e} (tol {TOL['scalar_max_rel']:.0e})")
    for k, name in ((1, "drho/dh"), (2, "div v"), (3, "curl v")):
        _, _, fm = _scal_err(np.asarray(dk[k])[g], np.asarray(dxr[k])[g])
        _check(f"sph_density {name} vs XLA cells", fm <= TOL["field_max"],
               f"max |d|/max|x| = {fm:.3e} (tol {TOL['field_max']:.0e})")
    del dxr

    rho = gas.density
    prs = jnp.where(gm, gas.entropy_pred * rho ** GAMMA, 0.0)
    hargs = (pos_g, vel_g, mass_g, h, rho, prs, gas.dhsml_density_factor,
             gas.div_vel, gas.curl_vel, gm)
    hkw = dict(visc_const=cfg.art_bulk_visc_const, box=box, periodic=True,
               hubble_a2_flow=fac.hubble_a2_flow,
               hubble_a2_norm=fac.hubble_a2_norm, fac_mu=fac.fac_mu)
    hk_fn = jax.jit(lambda c, *a: hydro_force_cells(c, *a, backend="triton",
                                                    **hkw))
    hx_fn = jax.jit(lambda c, *a: hydro_force_cells(c, *a, **hkw))
    hk, ck, tk = _timed(lambda: hk_fn(cls, *hargs))
    hxr, cx, tx = _timed(lambda: hx_fn(cls, *hargs))
    print(f"timing sph_hydro: triton {min(tk):.6f} s (first call {ck:.2f} "
          f"s), xla {min(tx):.6f} s (first call {cx:.2f} s), same cell "
          f"list, Ngas = {ng}", flush=True)
    p99, mx, _ = _vec_err(np.asarray(hk.acc)[g], np.asarray(hxr.acc)[g])
    _check("sph_hydro acc vs XLA cells (precision HIGHEST)",
           p99 <= TOL["vector_p99_rel"] and mx <= TOL["vector_max_rms"],
           f"p99 |da|/|a| = {p99:.3e} (tol {TOL['vector_p99_rel']:.0e}), "
           f"max |da|/rms = {mx:.3e} (tol {TOL['vector_max_rms']:.0e})")
    _, _, fm = _scal_err(np.asarray(hk.dt_entropy)[g],
                         np.asarray(hxr.dt_entropy)[g])
    _check("sph_hydro dt_entropy vs XLA cells", fm <= TOL["field_max"],
           f"max |d|/max|x| = {fm:.3e} (tol {TOL['field_max']:.0e})")
    s99, smx, _ = _scal_err(np.asarray(hk.max_signal_vel)[g],
                            np.asarray(hxr.max_signal_vel)[g])
    _check("sph_hydro max_signal_vel vs XLA cells",
           s99 <= TOL["vsig_p99_rel"] and smx <= TOL["vsig_max_rel"],
           f"p99 rel = {s99:.3e} (tol {TOL['vsig_p99_rel']:.0e}), max rel = "
           f"{smx:.3e} (tol {TOL['vsig_max_rel']:.0e})")
    del hxr

    # all-pairs oracle on a sub-volume: inner targets see every source
    # within 2 cell edges (h <= one SPH cell edge)
    edge = box / n_sph
    pg = np.asarray(pos_g)
    lo, side = 0.5 * box - 3125.0, 6250.0
    inner = g & np.all((pg >= lo) & (pg < lo + side), axis=1)
    near = g & np.all((pg >= lo - 2 * edge) & (pg < lo + side + 2 * edge),
                      axis=1)
    loc = np.flatnonzero(near)
    sel = jnp.asarray(loc)
    is_in = inner[loc]
    dd = density_sums(pos_g[sel], vel_g[sel], mass_g[sel], h[sel],
                      gm[sel], block=64)
    hd = hydro_force(*(a[sel] for a in hargs[:9]), gm[sel], block=64,
                     **{k: v for k, v in hkw.items()
                        if k not in ("box", "periodic")})
    tgt = loc[is_in]
    s99, smx, _ = _scal_err(np.asarray(dk[0])[tgt], np.asarray(dd[0])[is_in])
    _check(f"sph_density rho vs all-pairs oracle ({len(tgt)} targets)",
           smx <= TOL["oracle_scalar_max"],
           f"max rel = {smx:.3e} (tol {TOL['oracle_scalar_max']:.0e})")
    _, _, rms = _vec_err(np.asarray(hk.acc)[tgt], np.asarray(hd.acc)[is_in])
    _check(f"sph_hydro acc vs all-pairs oracle ({len(tgt)} targets)",
           rms <= TOL["oracle_vector_rms"],
           f"rms |da|/rms |a| = {rms:.3e} "
           f"(tol {TOL['oracle_vector_rms']:.0e})")
    _, _, fm = _scal_err(np.asarray(hk.dt_entropy)[tgt],
                         np.asarray(hd.dt_entropy)[is_in])
    _check("sph_hydro dt_entropy vs all-pairs oracle",
           fm <= TOL["oracle_scalar_max"],
           f"max |d|/max|x| = {fm:.3e} "
           f"(tol {TOL['oracle_scalar_max']:.0e})")


# ---------------------------------------------------------------------------
# --four: the SPMD slab step against the one-card run
# ---------------------------------------------------------------------------
def four_cards(n_side, steps, seed):
    import jax
    import numpy as np
    from gadget_leicester_tpu.models.simulation import Simulation
    if len(jax.devices()) != 4:
        _fail(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    cfg, opts, ics = _setup(n_side, seed)
    n = len(ics[0])
    print(f"N = {n}, pmgrid = {opts.pmgrid}, {steps + 2} sync points",
          flush=True)
    outs = {}
    for label, mesh in (("one card", None), ("mesh=4", 4)):
        sim = Simulation(cfg, opts, mesh=mesh)
        t0 = time.perf_counter()
        sim.set_ics(*ics[:4], u=ics[4])
        sim.run(max_steps=2)
        jax.block_until_ready(sim.state)
        c = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim.run(max_steps=steps)
        jax.block_until_ready(sim.state)
        dt = (time.perf_counter() - t0) / steps
        print(f"{label}: set_ics + compile + first two sync points {c:.2f} "
              f"s, seconds per step {dt:.4f} ({steps} steady sync points), "
              f"a = {sim.time:.6f}", flush=True)
        st = _check_state(sim, n, label)
        order = np.argsort(np.asarray(st.p.pid)[np.asarray(st.p.alive)])
        alive = np.asarray(st.p.alive)
        outs[label] = (int(st.ti_current),
                       np.asarray(st.p.pos)[alive][order],
                       np.asarray(st.p.vel)[alive][order],
                       np.asarray(st.p.pid)[alive][order])
    (t1, x1, v1, id1), (t4, x4, v4, id4) = outs["one card"], outs["mesh=4"]
    _check("SPMD particle count and ids", len(id1) == len(id4) == n
           and np.array_equal(id1, id4), f"{len(id4)} of {n}, ids equal")
    _check("SPMD time", t1 == t4, f"ti_current {t4} vs {t1}")
    box = cfg.box_size
    dx = x4 - x1
    dx = dx - box * np.round(dx / box)
    spacing = box / n_side
    dxm = float(np.abs(dx).max()) / spacing
    dv = np.linalg.norm(v4 - v1, axis=1)
    vrms = float(np.sqrt(np.mean(np.sum(v1 * v1, axis=1))))
    dvm = float(dv.max()) / vrms
    # the two runs differ in summation order (slab ghosts, per-shard PM
    # deposit), so trajectories agree to f32 round-off amplified over a
    # few steps, far below the interparticle spacing
    _check("SPMD positions vs one card", dxm <= 1e-3,
           f"max |dx| = {dxm:.3e} mean spacings (tol 1e-3)")
    _check("SPMD velocities vs one card", dvm <= 1e-3,
           f"max |dv| / rms v = {dvm:.3e} (tol 1e-3)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card SPMD comparison")
    ap.add_argument("--n-side", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, "gadget_leicester_tpu")):
        _fail("run from a checkout of the repository (package not found)")
    sys.path.insert(0, REPO)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        _fail(f"no GPU: JAX found {devs[0].platform!r} devices")
    from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(_card_line(), flush=True)
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)

    if args.four:
        four_cards(args.n_side, args.steps, args.seed)
    else:
        cfg, opts, st = main_path(args.n_side, args.steps, args.seed)
        kernel_parity(cfg, opts, st)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
