"""The simulation driver — rebuild of [G2: run.c :: run()] and
[G2: init.c :: init()] / [G2: begrun.c :: begrun()].

The reference's main loop { find sync point -> drift -> domain decompose ->
forces -> kick -> output } becomes: a single jitted ``sync_point_step``
(state -> state, fully on-device) driven by a thin host loop that handles
wall-clock concerns only (snapshots, restart dumps, logging) — the host
never touches particle data between steps.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gadget_leicester_tpu.core.config import (GAMMA, GAMMA_MINUS1, TIMEBASE,
                                              BOLTZMANN_CGS, HYDROGEN_MASSFRAC,
                                              PROTONMASS_CGS, SimConfig,
                                              SimOptions)
from gadget_leicester_tpu.core import timeline
from gadget_leicester_tpu.core.state import SimState, from_arrays
from gadget_leicester_tpu.models import integrate
from gadget_leicester_tpu.models.forces import (compute_forces,
                                                compute_potential)
from gadget_leicester_tpu.models.cooling import apply_cooling
from gadget_leicester_tpu.models.sinks import accrete_onto_sinks, create_sinks


def _uses_pm_split(opts: SimOptions) -> bool:
    """Does this configuration run the two-timescale TreePM machinery?"""
    return opts.periodic and opts.pmgrid > 0 and not opts.nogravity and \
        opts.gravity_mode in ("auto", "treepm")


@partial(jax.jit, static_argnames=("cfg", "opts"))
def potential_pass(state: SimState, cfg: SimConfig,
                   opts: SimOptions) -> SimState:
    """Jitted on-demand full-potential computation [G2: potential.c]."""
    return compute_potential(state, cfg, opts)


# --- per-component CPU probes [G2: run.c CPU_* buckets] -------------------
# The production step is ONE fused XLA program, so per-phase wall times are
# sampled by running each phase standalone on the current state (results
# discarded) at the statistics cadence — see Simulation._sample_cpu.
@partial(jax.jit, static_argnames=("cfg", "opts"))
def _probe_drift(state, cfg, opts):
    ti_next = timeline.min_active_ti_end(state.p.ti_endstep, state.p.alive)
    return integrate.drift_all(state, cfg, opts,
                               jnp.minimum(ti_next, state.pm_ti_endstep))


@partial(jax.jit, static_argnames=("cfg", "opts"))
def _probe_gravity(state, cfg, opts):
    do_pm = jnp.asarray(False) if _uses_pm_split(opts) else None
    return compute_forces(state, cfg, opts, do_sph=False, do_pm=do_pm)


@partial(jax.jit, static_argnames=("cfg", "opts"))
def _probe_hydro(state, cfg, opts):
    from gadget_leicester_tpu.models.forces import (comoving_factors,
                                                    compute_sph)
    fac = comoving_factors(cfg, state.ti_current)
    active = (state.p.ti_endstep == state.ti_current) & state.p.alive
    return compute_sph(state, cfg, opts, fac,
                       active[:state.gas.n_gas_max])


@partial(jax.jit, static_argnames=("cfg", "opts"))
def _probe_kick(state, cfg, opts):
    state = integrate.advance_and_find_timesteps(state, cfg, opts)
    if _uses_pm_split(opts):
        state = integrate.pm_step_update(state, cfg, opts,
                                         jnp.asarray(False))
    return state


@partial(jax.jit, static_argnames=("cfg", "opts"))
def sync_point_step(state: SimState, cfg: SimConfig, opts: SimOptions) -> SimState:
    """One sync-point iteration of the main loop [G2: run.c].

    TreePM runs PM long-range on its own global timestep
    [G2: timestep.c PM part]: the next sync point is the earlier of the
    particle bins' end and the PM step end; PM forces recompute only at PM
    steps and all particles receive the PM kick there.
    """
    pm_split = _uses_pm_split(opts)
    # overflow bits are STICKY across steps: the host reads them at
    # diagnostics cadence, bumps capacities, and clears them there — a
    # burst between readings must not be lost
    ti_next = timeline.min_active_ti_end(state.p.ti_endstep, state.p.alive)
    if pm_split:
        ti_next = jnp.minimum(ti_next, state.pm_ti_endstep)
    with jax.named_scope("drift"):
        state = integrate.drift_all(state, cfg, opts, ti_next)
    is_pm_step = state.ti_current == state.pm_ti_endstep
    state = compute_forces(state, cfg, opts,
                           do_pm=is_pm_step if pm_split else None)
    if opts.cooling != "none":
        with jax.named_scope("cooling"):
            state = apply_cooling(state, cfg, opts)
    if opts.sinks:
        with jax.named_scope("sinks"):
            state = create_sinks(state, cfg, opts)
            state = accrete_onto_sinks(state, cfg, opts)
    with jax.named_scope("advance"):
        state = integrate.advance_and_find_timesteps(state, cfg, opts)
        if pm_split:
            state = integrate.pm_step_update(state, cfg, opts, is_pm_step)
    return state


@partial(jax.jit, static_argnames=("cfg", "opts", "n_steps"))
def run_steps(state: SimState, cfg: SimConfig, opts: SimOptions,
              n_steps: int) -> SimState:
    """n sync-point iterations fused into one device program (lax.scan) —
    zero host round-trips."""

    def body(st, _):
        return sync_point_step(st, cfg, opts), None

    state, _ = jax.lax.scan(body, state, None, length=n_steps)
    return state


@partial(jax.jit, static_argnames=("cfg", "opts", "n_steps"))
def run_steps_counted(state: SimState, cfg: SimConfig, opts: SimOptions,
                      n_steps: int):
    """run_steps + an in-graph count of particle updates (the active set
    of each sync point), so benchmarking needs zero host round-trips —
    the rebuild of the reference's part/sec instrument
    [G2: gravtree.c -> timings.txt]."""

    def body(carry, _):
        st, nupd = carry
        ti_next = timeline.min_active_ti_end(st.p.ti_endstep, st.p.alive)
        n_active = jnp.sum(
            timeline.active_mask(st.p.ti_endstep, ti_next, st.p.alive))
        st = sync_point_step(st, cfg, opts)
        return (st, nupd + n_active), None

    (state, n_updates), _ = jax.lax.scan(
        body, (state, jnp.zeros((), jnp.int32)),
        None, length=n_steps)
    return state, n_updates


# ---------------------------------------------------------------------------
# Initialisation [G2: init.c]
# ---------------------------------------------------------------------------
def _initial_hsml_guess(pos: np.ndarray, mask: np.ndarray, des_ngb: float) -> float:
    """Mean-interparticle-spacing h guess; the adaptive solve refines it."""
    if mask.sum() == 0:
        return 1.0
    pts = pos[mask]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-10)))
    n = int(mask.sum())
    return float((3.0 * vol * des_ngb / (4.0 * np.pi * max(n, 1))) ** (1.0 / 3.0))


def init_state(
    cfg: SimConfig,
    opts: SimOptions,
    pos: np.ndarray,
    vel: np.ndarray,
    mass: np.ndarray,
    ptype: np.ndarray,
    pid: Optional[np.ndarray] = None,
    u: Optional[np.ndarray] = None,
    pad: bool = True,
) -> SimState:
    """IC arrays -> consistent runtime state [G2: init.c :: init()]:

    * velocities scaled for comoving runs (snapshot stores v_snap with
      v_internal = v_snap * a^{3/2}... GADGET: P.Vel *= sqrt(a)*a for gadget
      convention u_int = a^2 dx/dt; here we adopt the GADGET internal
      convention directly: vel_internal = v_snap * a0^{1/2} is applied by
      the IO layer, not here)
    * initial smoothing lengths solved by the adaptive density pass
    * thermal energy u -> entropy A = (gamma-1) u / rho^{gamma-1}
    * first full force computation so the first kick has accelerations
    """
    n = pos.shape[0]
    if pid is None:
        pid = np.arange(1, n + 1)
    if cfg.comoving_integration_on:
        # IC files store v_file = v_pec/sqrt(a); internal vel = a*v_pec
        # => vel = v_file * a0^{3/2} [G2: read_ic.c velocity scaling]
        vel = np.asarray(vel) * cfg.time_begin**1.5
    state = from_arrays(pos, vel, mass, ptype, pid, opts, u=u, pad=pad)
    from gadget_leicester_tpu.models.grids import make_grid_cache
    state = dataclasses.replace(
        state, grids=make_grid_cache(cfg, opts, state.p.n_max,
                                     state.gas.n_gas_max))

    ng = state.gas.n_gas_max
    gas_mask_np = np.zeros(ng, bool)
    n_gas = int((ptype == 0).sum())
    gas_mask_np[:n_gas] = True

    if n_gas:
        # initial h guess, then let density_adaptive converge it
        h0 = _initial_hsml_guess(np.asarray(pos), ptype == 0, cfg.des_num_ngb)
        gas = state.gas
        hsml = gas.hsml.at[:n_gas].set(h0)
        # u from InitGasTemp if ICs carry no thermal energy [G2: init.c]
        u_arr = np.zeros(ng)
        if u is not None:
            u_arr[:n_gas] = np.asarray(u)[:n_gas]
        if cfg.init_gas_temp > 0 and (u is None or np.all(u_arr[:n_gas] == 0)):
            mean_mol = 4.0 / (1.0 + 3.0 * HYDROGEN_MASSFRAC)
            u_init = (
                BOLTZMANN_CGS / PROTONMASS_CGS * cfg.init_gas_temp / mean_mol
                / GAMMA_MINUS1 / cfg.unit_velocity_in_cm_per_s**2
            )
            u_arr[:n_gas] = u_init
        gas = dataclasses.replace(
            gas,
            hsml=hsml,
            entropy=gas.entropy.at[:].set(jnp.asarray(u_arr, gas.entropy.dtype)),
            vel_pred=state.p.vel[:ng],
        )
        state = dataclasses.replace(state, gas=gas)
        state = _init_finalize_gas(state, cfg, opts,
                                   jnp.asarray(gas_mask_np))
    else:
        state = _init_finalize_nogas(state, cfg, opts)
    return state


@partial(jax.jit, static_argnames=("cfg", "opts"))
def _init_finalize_gas(state: SimState, cfg: SimConfig, opts: SimOptions,
                       gas_mask) -> SimState:
    """Device part of init: first density pass, u -> entropy conversion,
    and the full force recomputation — ONE compiled program (eager op-by-op
    execution costs minutes over remote-dispatch transports)."""
    state = compute_forces(state, cfg, opts, do_sph=True)
    gas = state.gas
    rho_safe = jnp.where(gas.density > 0, gas.density, 1.0)
    if opts.isotherm_eqs:
        # entropy slot stores c_s^2 = (gamma-1) u (isothermal sound speed^2)
        a_ent = GAMMA_MINUS1 * gas.entropy
    else:
        # u -> entropy uses PHYSICAL density rho_com * a3inv
        # [G2: init.c Entropy = GAMMA_MINUS1*u / pow(Density/a3, GAMMA_MINUS1)]
        from gadget_leicester_tpu.models.forces import comoving_factors
        a3inv = comoving_factors(cfg, state.ti_current).a3inv
        a_ent = GAMMA_MINUS1 * gas.entropy / (rho_safe * a3inv)**GAMMA_MINUS1
    a_ent = jnp.where(gas_mask, a_ent, 0.0)
    if opts.isotherm_eqs:
        pressure = a_ent * gas.density
    else:
        pressure = a_ent * gas.density**GAMMA
    gas = dataclasses.replace(gas, entropy=a_ent, entropy_pred=a_ent,
                              pressure=pressure)
    state = dataclasses.replace(state, gas=gas)
    # recompute hydro forces with the true entropy-based pressure
    return compute_forces(state, cfg, opts, do_sph=True)


@partial(jax.jit, static_argnames=("cfg", "opts"))
def _init_finalize_nogas(state: SimState, cfg: SimConfig,
                         opts: SimOptions) -> SimState:
    return compute_forces(state, cfg, opts, do_sph=False)


# ---------------------------------------------------------------------------
# Host-side driver
# ---------------------------------------------------------------------------
class Simulation:
    """begrun()/run() equivalent: owns config, state, and the host loop.

    ``mesh`` (int device count or a jax Mesh) routes stepping through the
    owner-computes SPMD step (parallel.spmd) — the rebuild of
    `mpirun -np K Gadget2 param.txt` [G2: main.c]: the state lives in the
    slab layout between steps; snapshots/energy/restarts convert through
    the lossless spmd_to_canonical bridge; slab edges re-balance on the
    statistics cadence (re-decomposition recompiles the step, matching
    the reference's occasional domain_Decomposition())."""

    def __init__(self, cfg: SimConfig, opts: Optional[SimOptions] = None,
                 mesh=None):
        from gadget_leicester_tpu.core.config import options_from_config
        self.cfg = cfg
        self.opts = opts if opts is not None else options_from_config(cfg)
        self.state: Optional[SimState] = None
        self.step_count = 0
        self.logs = None            # RunLogs, created on demand
        self.li_tracker = None      # LayzerIrvineTracker (comoving runs)
        self.li_drift = 0.0         # latest |dE_LI|/|W|
        self.snapshot_count = 0
        self.next_snapshot_time = cfg.time_of_first_snapshot
        self.next_stats_time = cfg.time_begin
        self.last_restart_wall = None
        self.mesh = None
        self.spmd_edges = None      # current slab boundaries [d+1]
        self.spmd_caps = None       # (cap_g, cap_r) per shard
        self.spmd_domain = None     # vacuum: (origin[3], extent) cube
        self._spmd_step = None      # jitted shard_map step
        if mesh is not None:
            from jax.sharding import Mesh as _Mesh
            from gadget_leicester_tpu.parallel.mesh import make_mesh
            self.mesh = mesh if isinstance(mesh, _Mesh) else \
                make_mesh(int(mesh))

    @classmethod
    def from_param_file(cls, path: str, opts: Optional[SimOptions] = None,
                        restart_flag: int = 0,
                        opt_overrides: Optional[dict] = None,
                        mesh=None) -> "Simulation":
        """`Gadget2 param.txt [restartflag]` equivalent [G2: main.c]:
        restart_flag 0 = cold start from InitCondFile, 1 = resume from the
        restart dump, 2 = start from a snapshot named by InitCondFile.

        When ``opts`` is None the static flags come from, in order: the
        config itself (periodic / auto TreePM pmgrid from the IC count),
        then a `<paramfile>.opts` Makefile-style sidecar, then
        ``opt_overrides`` (e.g. explicit CLI flags)."""
        from gadget_leicester_tpu.core.config import (options_from_config,
                                                      options_sidecar_path,
                                                      parse_makefile_options,
                                                      read_parameter_file)
        cfg = read_parameter_file(path)
        sidecar = options_sidecar_path(path)
        side_kw = {}
        if opts is None and os.path.exists(sidecar):
            with open(sidecar) as fh:
                side_kw = parse_makefile_options(fh.read())
        if opt_overrides:
            side_kw.update(opt_overrides)
        if restart_flag == 1:
            from gadget_leicester_tpu.io.restart import load_restart
            rp = os.path.join(cfg.output_dir, (cfg.restart_file or "restart"))
            state, meta = load_restart(rp)
            if opts is None:
                n_alive = int(np.asarray(state.p.alive).sum())
                opts = options_from_config(cfg, n_particles=n_alive, **side_kw)
            sim = cls(cfg, opts, mesh=mesh)
            # restarts store no grid cache (derived data); re-allocate
            from gadget_leicester_tpu.models.grids import make_grid_cache
            sim.state = dataclasses.replace(
                state, grids=make_grid_cache(cfg, sim.opts, state.p.n_max,
                                             state.gas.n_gas_max))
            sim.step_count = meta.get("step_count", 0)
            sim.snapshot_count = meta.get("snapshot_count", 0)
            if sim.mesh is not None:
                # restart dumps are layout-canonical; re-decompose
                sim._decompose()
        else:
            from gadget_leicester_tpu.io.snapshot import read_snapshot
            from gadget_leicester_tpu.io.state_io import ic_arrays_from_snapshot
            snap = read_snapshot(cfg.init_cond_file)
            pos, vel, mass, ptype, u = ic_arrays_from_snapshot(snap, cfg)
            if opts is None:
                # Makefile analog: stock .param + IC count decide TreePM/pmgrid
                opts = options_from_config(cfg, n_particles=len(pos), **side_kw)
            sim = cls(cfg, opts, mesh=mesh)
            sim.set_ics(pos, vel, mass, ptype, pid=snap.ids.astype(np.int64),
                        u=u)
        return sim

    def set_ics(self, pos, vel, mass, ptype, pid=None, u=None):
        self.state = init_state(self.cfg, self.opts, pos, vel, mass, ptype,
                                pid=pid, u=u)
        if self.mesh is not None:
            self._decompose()
        return self.state

    # ------------------------------------------------------------------
    # SPMD domain decomposition [G2: domain.c :: domain_Decomposition()]
    # ------------------------------------------------------------------
    def _decompose(self):
        """(Re-)lay the state onto the mesh with cost-balanced slab edges
        and (re)build the jitted SPMD step. Accepts the current state in
        EITHER layout (slab layouts canonicalise first)."""
        from jax.sharding import NamedSharding
        from gadget_leicester_tpu.parallel.spmd import (
            make_spmd_step, spmd_min_width, spmd_to_canonical, state_specs,
            to_spmd)
        if self.spmd_caps is not None:
            self.state = spmd_to_canonical(self.state, *self.spmd_caps)
        domain = None
        if not self.opts.periodic:
            # vacuum: re-fit the static domain cube to the current
            # particle cloud with 15%-per-side headroom (escapees raise
            # flag bit 4, which lands back here) [G2: pm_nonperiodic.c
            # mesh placement + domain.c]
            import numpy as np
            pos = np.asarray(self.state.p.pos)
            alive = np.asarray(self.state.p.alive)
            lo = pos[alive].min(axis=0)
            hi = pos[alive].max(axis=0)
            ext = float((hi - lo).max()) * 1.3 + 1e-6
            domain = (0.5 * (lo + hi) - 0.5 * ext, ext)
            if self.opts.pmgrid <= 0:
                # vacuum SPMD runs as vacuum TreePM: pick the PM grid
                # from the particle count, as the periodic auto path does
                from gadget_leicester_tpu.core.config import auto_pmgrid
                self.opts = dataclasses.replace(
                    self.opts, pmgrid=auto_pmgrid(int(alive.sum())))
        self.spmd_domain = domain
        mw = spmd_min_width(self.cfg, self.opts, self.state.gas.n_gas_max,
                            extent=None if domain is None else domain[1])
        st, caps, edges = to_spmd(self.state, self.mesh, self.cfg,
                                  min_width=mw, domain=domain)
        # per-shard grid cache: the cell list + ghost-row selection persist
        # across sync points (the [G2: domain.c/forcetree.c] rebuild
        # cadence, SPMD edition — see parallel.spmd.make_spmd_grid_cache)
        from gadget_leicester_tpu.parallel.spmd import make_spmd_grid_cache
        st = dataclasses.replace(st, grids=make_spmd_grid_cache(
            self.cfg, self.opts, self.mesh, caps, edges, domain=domain))
        specs = state_specs(st)
        st = jax.tree_util.tree_map(
            lambda x, sp: jax.device_put(x, NamedSharding(self.mesh, sp)),
            st, specs)
        self.state = st
        self.spmd_caps = caps
        self.spmd_edges = edges
        self._spmd_step = make_spmd_step(self.cfg, self.opts, self.mesh,
                                         edges=edges, domain=domain)(st)

    def maybe_rebalance(self, threshold: float = 1.3):
        """Re-decompose when the per-slab particle counts have drifted
        from balance (the TreeDomainUpdateFrequency analog; recompiles).
        Returns True when a re-decomposition happened."""
        if self.mesh is None:
            return False
        import numpy as np
        from gadget_leicester_tpu.parallel.mesh import AXIS
        d = self.mesh.shape[AXIS]
        alive = np.asarray(self.state.p.alive)
        x_raw = np.asarray(self.state.p.pos[:, 0])[alive]
        if self.opts.periodic:
            x = np.mod(x_raw, self.cfg.box_size)
        else:
            d0, ext = self.spmd_domain
            x = np.clip(x_raw - float(np.asarray(d0).reshape(3)[0]),
                        0.0, ext)
        counts = np.bincount(
            np.clip(np.searchsorted(self.spmd_edges, x, side="right") - 1,
                    0, d - 1), minlength=d)
        if counts.max() > threshold * max(1.0, counts.mean()):
            self._decompose()
            return True
        return False

    def _sample_cpu(self) -> dict:
        """Sampled per-component device timings for cpu.txt
        [G2: run.c CPU_Gravity/CPU_Hydro/... buckets]. Runs each phase as
        a standalone program on the current state (results discarded);
        enabled with GLT_CPU_DETAIL=1 (the probes pay a one-time compile).
        Off-mesh only — the SPMD step has no standalone phase programs."""
        import time as _time
        if self.mesh is not None or os.environ.get("GLT_CPU_DETAIL") != "1":
            return {}
        out = {}
        probes = [("drift", _probe_drift), ("gravity", _probe_gravity),
                  ("kick", _probe_kick)]
        if self.state.gas.n_gas_max > 1:
            probes.insert(2, ("hydro", _probe_hydro))
        for name, fn in probes:
            t0 = _time.time()
            jax.block_until_ready(fn(self.state, self.cfg, self.opts))
            out[name] = _time.time() - t0
        return out

    def canonical_state(self) -> SimState:
        """The state in canonical (gas-block-first) layout — what every
        I/O / diagnostics consumer expects; identity off-mesh."""
        if self.mesh is None or self.spmd_caps is None:
            return self.state
        from gadget_leicester_tpu.parallel.spmd import spmd_to_canonical
        return spmd_to_canonical(self.state, *self.spmd_caps)

    @property
    def time(self) -> float:
        return float(timeline.ti_to_time(self.state.ti_current, self.cfg))

    def step(self, n: int = 1):
        if self._spmd_step is not None:
            for _ in range(n):
                self.state = self._spmd_step(self.state)
        elif n == 1:
            self.state = sync_point_step(self.state, self.cfg, self.opts)
        else:
            self.state = run_steps(self.state, self.cfg, self.opts, n)
        self.step_count += n
        return self.state

    def run_until(self, time_end: Optional[float] = None,
                  max_steps: int = 100000, callback=None):
        """Host loop until `time_end` (defaults to TimeMax) [G2: run.c]."""
        cfg = self.cfg
        t_end = cfg.time_max if time_end is None else time_end
        if cfg.comoving_integration_on:
            ti_end = int(round(np.log(t_end / cfg.time_begin) / cfg.timebase_interval))
        else:
            ti_end = int(round((t_end - cfg.time_begin) / cfg.timebase_interval))
        ti_end = min(ti_end, TIMEBASE)
        for _ in range(max_steps):
            if int(self.state.ti_current) >= ti_end:
                break
            self.step()
            if callback is not None:
                callback(self)
        return self.state

    # ------------------------------------------------------------------
    # Full lifecycle with outputs — [G2: run.c :: run()]
    # ------------------------------------------------------------------
    def run(self, max_steps: int = 1000000, wall_limit_s: Optional[float] = None):
        """Main loop with snapshot/energy/restart cadence and log files."""
        import time as _time

        from gadget_leicester_tpu.io.restart import save_restart
        from gadget_leicester_tpu.io.snapshot import write_snapshot_set
        from gadget_leicester_tpu.io.state_io import snapshot_from_state
        from gadget_leicester_tpu.utils.diagnostics import energy_statistics
        from gadget_leicester_tpu.utils.logfiles import RunLogs

        cfg, opts = self.cfg, self.opts
        if self.logs is None:
            self.logs = RunLogs(cfg)
        # OutputListOn: snapshot times from file [G2: begrun.c read_outputlist]
        output_times = None
        if cfg.output_list_on and cfg.output_list_filename:
            with open(cfg.output_list_filename) as fh:
                output_times = sorted(
                    float(line.split()[0]) for line in fh
                    if line.strip() and not line.startswith("%"))
        wall0 = _time.time()
        limit = wall_limit_s if wall_limit_s is not None else cfg.time_limit_cpu
        self.last_restart_wall = _time.time()

        for _ in range(max_steps):
            if int(self.state.ti_current) >= TIMEBASE:
                break
            if _time.time() - wall0 > limit:
                # planned self-resubmission before the queue kills us
                # [G2: run.c TimeLimitCPU + ResubmitOn/ResubmitCommand]
                save_restart(
                    os.path.join(cfg.output_dir,
                                 cfg.restart_file or "restart"),
                    self.canonical_state(), step_count=self.step_count,
                    extra_meta={"snapshot_count": self.snapshot_count})
                if cfg.resubmit_on and cfg.resubmit_command:
                    import subprocess
                    subprocess.Popen(cfg.resubmit_command, shell=True)
                break
            t_before = self.time
            t0 = _time.time()
            # profiling harness (SURVEY §5 tracing subsystem): set
            # GLT_PROFILE_DIR to capture a jax.profiler trace of steps
            # [GLT_PROFILE_START, GLT_PROFILE_START+GLT_PROFILE_STEPS)
            pdir = os.environ.get("GLT_PROFILE_DIR")
            if pdir:
                pstart = int(os.environ.get("GLT_PROFILE_START", "2"))
                pn = int(os.environ.get("GLT_PROFILE_STEPS", "2"))
                if self.step_count == pstart:
                    jax.profiler.start_trace(pdir)
                elif self.step_count == pstart + pn:
                    jax.profiler.stop_trace()
            pm_beg_before = int(self.state.pm_ti_begstep)
            self.step()
            dt_wall = _time.time() - t0
            phases = {"total": dt_wall}
            was_pm = int(self.state.pm_ti_begstep) != pm_beg_before
            t_now = self.time
            self.logs.log_info(self.step_count, t_now, t_now - t_before)
            n_active = int(jnp.sum(timeline.active_mask(
                self.state.p.ti_begstep, self.state.ti_current,
                self.state.p.alive)))
            self.logs.log_timings(self.step_count, n_active, dt_wall,
                                  pm=was_pm)

            if t_now >= self.next_stats_time:
                # recompute-with-bigger [G2: gravtree.c realloc-on-overflow
                # bunching]: the STICKY overflow bits mean some cell
                # dropped particles since the last reading — double the
                # static capacity (recompiles the step), clear the flags,
                # and continue
                ovf = int(self.state.overflow_flags)
                if ovf:
                    from gadget_leicester_tpu.models.grids import (
                        grav_grid_geometry, make_grid_cache,
                        sph_cells_geometry)
                    self.state = dataclasses.replace(
                        self.state, overflow_flags=jnp.int32(0))
                    new_opts = self.opts
                    n_max = self.state.p.n_max
                    ng = self.state.gas.n_gas_max
                    if ovf & 2:
                        _, cur = sph_cells_geometry(cfg, new_opts, ng)
                        new_opts = dataclasses.replace(
                            new_opts, sph_capacity=cur * 2)
                    if ovf & 1:
                        _, cur, _ = grav_grid_geometry(cfg, new_opts, n_max)
                        new_opts = dataclasses.replace(
                            new_opts, sr_capacity=cur * 2)
                    if self.mesh is not None and ovf & (1 | 2 | 4):
                        # SPMD ghost/migration buffers may be the culprit
                        # (their overflow ORs into the same bits): double
                        # the BufferSize analog as well
                        cur = new_opts.spmd_ghost_frac or 0.25
                        new_opts = dataclasses.replace(
                            new_opts, spmd_ghost_frac=min(1.0, cur * 2))
                    self.logs.log_info(
                        self.step_count, t_now,
                        0.0, note=f"overflow {ovf}: capacities -> "
                        f"sph={new_opts.sph_capacity} "
                        f"sr={new_opts.sr_capacity} "
                        f"ghost={new_opts.spmd_ghost_frac}")
                    self.opts = new_opts
                    opts = new_opts
                    # new capacities change the cached grid shapes
                    self.state = dataclasses.replace(
                        self.state, grids=make_grid_cache(cfg, opts, n_max,
                                                          ng))
                    if self.mesh is not None:
                        self._decompose()   # rebuild the SPMD step too
                # full potential on demand [G2: potential.c] — the in-step
                # pot of the TreePM path carries only the PM piece.
                # SPMD runs canonicalise first (the lossless bridge).
                tp0 = _time.time()
                cst = potential_pass(self.canonical_state(), cfg, opts)
                if self.mesh is None:
                    self.state = cst
                st = energy_statistics(cst, cfg, opts)
                phases["potential"] = _time.time() - tp0
                phases.update(self._sample_cpu())
                self.logs.log_energy(t_now, st)
                if cfg.comoving_integration_on:
                    from gadget_leicester_tpu.utils.diagnostics import \
                        LayzerIrvineTracker
                    if self.li_tracker is None:
                        self.li_tracker = LayzerIrvineTracker()
                    self.li_drift = self.li_tracker.update(t_now, st)
                self.next_stats_time += cfg.time_bet_statistics
                if opts.forcetest > 0:
                    from gadget_leicester_tpu.utils.forcetest import (
                        run_forcetest, write_forcetest_file)
                    res = run_forcetest(cst, cfg, opts)
                    write_forcetest_file(res, cst, cfg)
                # work-balance maintenance on the same cadence
                # [G2: domain.c re-decomposition triggers]
                td0 = _time.time()
                if self.maybe_rebalance():
                    phases["domain"] = _time.time() - td0
            if output_times is not None:
                due = (self.snapshot_count < len(output_times)
                       and t_now >= output_times[self.snapshot_count])
            else:
                due = (t_now >= self.next_snapshot_time
                       and cfg.time_bet_snapshot > 0)
            if due:
                ts0 = _time.time()
                cst = self.canonical_state()
                if opts.output_potential:
                    cst = potential_pass(cst, cfg, opts)
                    if self.mesh is None:
                        self.state = cst
                snap = snapshot_from_state(
                    cst, cfg, opts,
                    with_potential=opts.output_potential)
                base = os.path.join(
                    cfg.output_dir,
                    f"{cfg.snapshot_file_base}_{self.snapshot_count:03d}")
                write_snapshot_set(base, snap, cfg.num_files_per_snapshot,
                                   fmt=cfg.snap_format)
                self.snapshot_count += 1
                phases["snapshot"] = _time.time() - ts0
                if output_times is None:
                    if cfg.comoving_integration_on:
                        self.next_snapshot_time = max(
                            self.next_snapshot_time * cfg.time_bet_snapshot,
                            t_now * 1.0000001)
                    else:
                        self.next_snapshot_time += cfg.time_bet_snapshot
            if (_time.time() - self.last_restart_wall
                    > cfg.cpu_time_bet_restart_file):
                tr0 = _time.time()
                save_restart(
                    os.path.join(cfg.output_dir,
                                 cfg.restart_file or "restart"),
                    self.canonical_state(), step_count=self.step_count,
                    extra_meta={"snapshot_count": self.snapshot_count})
                self.last_restart_wall = _time.time()
                phases["restart"] = _time.time() - tr0
            self.logs.log_cpu(self.step_count, t_now, phases)
        return self.state
