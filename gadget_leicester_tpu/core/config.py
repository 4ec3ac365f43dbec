"""Runtime configuration: GADGET parameter files + static feature options.

Rebuild of [G2: begrun.c :: read_parameter_file()] (the ~80-key tag/value
text parameter file) and of the Makefile ``-DOPT`` compile-time flag axis
[G2: Makefile]. The reference splits configuration across a text file parsed
into ``struct global_data_all_processes All`` and ``#ifdef`` feature gates;
here both become typed frozen dataclasses:

* :class:`SimConfig` — every runtime parameter, parsed from an UNMODIFIED
  stock GADGET ``.param`` file (bit-compat requirement: existing parameter
  files must work unchanged).
* :class:`SimOptions` — the static/compile-time axis (PERIODIC, PMGRID,
  ISOTHERM_EQS, cooling, sinks, ...). Hashable, passed as a static argument
  to jitted step functions so XLA specialises on it, exactly as ``-DOPT``
  flags specialised the C build.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Physical constants (cgs) — mirrors [G2: allvars.h] macro block.
# ---------------------------------------------------------------------------
GRAVITY_CGS = 6.672e-8          # cm^3 g^-1 s^-2  [G2: allvars.h GRAVITY]
SOLAR_MASS_CGS = 1.989e33
BOLTZMANN_CGS = 1.3806e-16
PROTONMASS_CGS = 1.6726e-24
HUBBLE_CGS = 3.2407789e-18      # h/s (100 km/s/Mpc in cgs)
SEC_PER_MEGAYEAR = 3.155e13
GAMMA = 5.0 / 3.0               # adiabatic index [G2: allvars.h GAMMA]
GAMMA_MINUS1 = GAMMA - 1.0
HYDROGEN_MASSFRAC = 0.76

# Integer timeline resolution [G2: allvars.h TIMEBASE = 1<<28].
TIMEBASE = 1 << 28

N_TYPES = 6  # particle types: 0 gas, 1 halo, 2 disk, 3 bulge, 4 stars, 5 bndry


@dataclass(frozen=True)
class SimOptions:
    """Static feature flags — the rebuild of the Makefile ``-DOPT`` axis.

    Frozen/hashable so it can be a static argument under ``jax.jit``;
    flipping any flag recompiles the step function, which is the exact
    moral equivalent of recompiling the C binary with different ``-DOPT``.
    """

    periodic: bool = False               # -DPERIODIC
    pmgrid: int = 0                      # -DPMGRID=n (0 = tree-only)
    isotherm_eqs: bool = False           # -DISOTHERM_EQS
    nogravity: bool = False              # -DNOGRAVITY
    unequal_softenings: bool = True      # -DUNEQUALSOFTENINGS
    adaptive_gravsoft_forgas: bool = False  # -DADAPTIVE_GRAVSOFT_FORGAS
    flexsteps: bool = False              # -DFLEXSTEPS — accepted for
    # Makefile parity, INTENTIONALLY a no-op: the reference staggers
    # individual timesteps to smooth per-rank MPI load [G2: timestep.c
    # FLEXSTEPS]; in the sync-point model every device executes the
    # same program and inactive work is skipped per cell (activity
    # gating), so there is no load imbalance for staggering to smooth.
    forcetest: float = 0.0               # -DFORCETEST=frac (0 disables)
    makeglass: int = 0                   # -DMAKEGLASS=n
    # Leicester-fork physics [UNVERIFIED-FORK per SURVEY.md §2]:
    cooling: str = "none"                # "none" | "beta" | "stamatellos"
    sinks: bool = False                  # sink/accretion particles
    # Precision axis [-DDOUBLEPRECISION]; "f32" matches the stock build.
    dtype: str = "f32"                   # "f32" | "f64"
    # Static capacities of the rebuild (the analog of PartAllocFactor headroom):
    max_ngb: int = 96                    # fixed neighbour-list capacity K
    tree_depth: int = 8                  # octree depth (max 10 = Morton bits/3)
    # Backend selection (static — specialises the jitted step like -DOPT):
    gravity_mode: str = "auto"           # "auto"|"direct"|"treepm"|"tree"
    sph_backend: str = "auto"            # "auto"|"dense"|"cells"
    sph_grid: int = 0                    # cells per axis for SPH (0 = auto)
    sph_capacity: int = 0                # per-cell capacity for SPH (0 = auto)
    sr_capacity: int = 0                 # per-cell capacity, short-range grav
    direct_threshold: int = 8192         # N below which direct gravity wins
    hr_types: int = 0                    # PLACEHIGHRESREGION type bitmask
                                         # (with gravity_mode="zoom")
    hr_pmgrid: int = 0                   # fine zoom mesh (0 = pmgrid)
    output_potential: bool = False       # -DOUTPUTPOTENTIAL: POT snapshot block
    spmd_ghost_frac: float = 0.0         # SPMD ghost-buffer size as a chunk
                                         # fraction (0 = auto from the
                                         # boundary-strip occupancy; the
                                         # BufferSize analog [G2: allvars.h])

    def replace(self, **kw) -> "SimOptions":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The runtime parameter table.
#
# Field names are snake_case; `gadget_key` metadata holds the stock .param
# tag so unmodified GADGET parameter files parse. Defaults marked REQUIRED
# must appear in the file (stock GADGET hard-errors on missing keys).
# ---------------------------------------------------------------------------
_REQ = object()  # sentinel for required keys


def _p(key: str, typ, default=_REQ):
    return field(
        default=None if default is _REQ else default,
        metadata={"gadget_key": key, "type": typ, "required": default is _REQ},
    )


@dataclass(frozen=True)
class SimConfig:
    """All runtime parameters [G2: begrun.c :: read_parameter_file()].

    One field per stock GADGET-2 parameter-file tag, plus derived unit /
    cosmology constants computed by :meth:`finalize` (the rebuild of
    [G2: begrun.c :: set_units()]).
    """

    # --- File names / formats ---
    init_cond_file: str = _p("InitCondFile", str)
    output_dir: str = _p("OutputDir", str)
    energy_file: str = _p("EnergyFile", str, "energy.txt")
    info_file: str = _p("InfoFile", str, "info.txt")
    timings_file: str = _p("TimingsFile", str, "timings.txt")
    cpu_file: str = _p("CpuFile", str, "cpu.txt")
    restart_file: str = _p("RestartFile", str, "restart")
    snapshot_file_base: str = _p("SnapshotFileBase", str, "snapshot")
    output_list_filename: str = _p("OutputListFilename", str, "")
    output_list_on: int = _p("OutputListOn", int, 0)
    ic_format: int = _p("ICFormat", int, 1)
    snap_format: int = _p("SnapFormat", int, 1)
    num_files_per_snapshot: int = _p("NumFilesPerSnapshot", int, 1)
    num_files_written_in_parallel: int = _p("NumFilesWrittenInParallel", int, 1)

    # --- CPU / memory limits ---
    time_limit_cpu: float = _p("TimeLimitCPU", float, 86400.0)
    resubmit_on: int = _p("ResubmitOn", int, 0)
    resubmit_command: str = _p("ResubmitCommand", str, "")
    cpu_time_bet_restart_file: float = _p("CpuTimeBetRestartFile", float, 7200.0)
    part_alloc_factor: float = _p("PartAllocFactor", float, 1.6)
    tree_alloc_factor: float = _p("TreeAllocFactor", float, 0.8)
    buffer_size: float = _p("BufferSize", float, 30.0)

    # --- Run span / cosmology ---
    time_begin: float = _p("TimeBegin", float)
    time_max: float = _p("TimeMax", float)
    omega0: float = _p("Omega0", float, 0.0)
    omega_lambda: float = _p("OmegaLambda", float, 0.0)
    omega_baryon: float = _p("OmegaBaryon", float, 0.0)
    hubble_param: float = _p("HubbleParam", float, 1.0)
    box_size: float = _p("BoxSize", float, 0.0)
    periodic_boundaries_on: int = _p("PeriodicBoundariesOn", int, 0)
    comoving_integration_on: int = _p("ComovingIntegrationOn", int, 0)

    # --- Output cadence ---
    time_bet_snapshot: float = _p("TimeBetSnapshot", float, 0.1)
    time_of_first_snapshot: float = _p("TimeOfFirstSnapshot", float, 0.0)
    time_bet_statistics: float = _p("TimeBetStatistics", float, 0.1)

    # --- Integrator accuracy ---
    type_of_timestep_criterion: int = _p("TypeOfTimestepCriterion", int, 0)
    err_tol_int_accuracy: float = _p("ErrTolIntAccuracy", float, 0.025)
    max_size_timestep: float = _p("MaxSizeTimestep", float, 0.01)
    min_size_timestep: float = _p("MinSizeTimestep", float, 0.0)
    max_rms_displacement_fac: float = _p("MaxRMSDisplacementFac", float, 0.2)

    # --- Tree accuracy ---
    err_tol_theta: float = _p("ErrTolTheta", float, 0.5)
    type_of_opening_criterion: int = _p("TypeOfOpeningCriterion", int, 1)
    err_tol_force_acc: float = _p("ErrTolForceAcc", float, 0.005)
    tree_domain_update_frequency: float = _p("TreeDomainUpdateFrequency", float, 0.1)

    # --- SPH ---
    des_num_ngb: float = _p("DesNumNgb", float, 50.0)
    max_num_ngb_deviation: float = _p("MaxNumNgbDeviation", float, 2.0)
    art_bulk_visc_const: float = _p("ArtBulkViscConst", float, 0.8)
    init_gas_temp: float = _p("InitGasTemp", float, 0.0)
    min_gas_temp: float = _p("MinGasTemp", float, 0.0)
    courant_fac: float = _p("CourantFac", float, 0.15)
    min_gas_hsml_fractional: float = _p("MinGasHsmlFractional", float, 0.0)

    # --- Units ---
    unit_length_in_cm: float = _p("UnitLength_in_cm", float, 3.085678e21)
    unit_mass_in_g: float = _p("UnitMass_in_g", float, 1.989e43)
    unit_velocity_in_cm_per_s: float = _p("UnitVelocity_in_cm_per_s", float, 1.0e5)
    gravity_constant_internal: float = _p("GravityConstantInternal", float, 0.0)

    # --- Softening (per type, comoving + max-physical) ---
    softening_gas: float = _p("SofteningGas", float, 0.0)
    softening_halo: float = _p("SofteningHalo", float, 0.0)
    softening_disk: float = _p("SofteningDisk", float, 0.0)
    softening_bulge: float = _p("SofteningBulge", float, 0.0)
    softening_stars: float = _p("SofteningStars", float, 0.0)
    softening_bndry: float = _p("SofteningBndry", float, 0.0)
    softening_gas_max_phys: float = _p("SofteningGasMaxPhys", float, 0.0)
    softening_halo_max_phys: float = _p("SofteningHaloMaxPhys", float, 0.0)
    softening_disk_max_phys: float = _p("SofteningDiskMaxPhys", float, 0.0)
    softening_bulge_max_phys: float = _p("SofteningBulgeMaxPhys", float, 0.0)
    softening_stars_max_phys: float = _p("SofteningStarsMaxPhys", float, 0.0)
    softening_bndry_max_phys: float = _p("SofteningBndryMaxPhys", float, 0.0)

    # --- Leicester-fork runtime knobs [UNVERIFIED-FORK, SURVEY.md §2] ---
    cooling_beta: float = _p("CoolingBeta", float, 10.0)      # beta-cooling du/dt=-u*Omega/beta
    cooling_tbg: float = _p("CoolingTbg", float, 10.0)        # radiative background temp [K]
    cooling_column_fac: float = _p("CoolingColumnFac", float, 1.0)  # zeta in Sigma^2 = zeta rho|psi|/(4 pi G)
    sink_accretion_radius: float = _p("SinkAccretionRadius", float, 0.0)
    sink_formation_density: float = _p("SinkFormationDensity", float, 0.0)

    # --- Derived (filled by finalize(); not parameter-file keys) ---
    unit_time_in_s: float = field(default=0.0, metadata={})
    unit_density_in_cgs: float = field(default=0.0, metadata={})
    unit_pressure_in_cgs: float = field(default=0.0, metadata={})
    unit_energy_in_cgs: float = field(default=0.0, metadata={})
    grav_internal: float = field(default=0.0, metadata={})   # All.G
    hubble_internal: float = field(default=0.0, metadata={}) # All.Hubble
    timebase_interval: float = field(default=0.0, metadata={})
    min_entropy: float = field(default=0.0, metadata={})

    # ------------------------------------------------------------------
    def finalize(self) -> "SimConfig":
        """Compute derived unit/cosmology constants [G2: begrun.c :: set_units()]."""
        ut = self.unit_length_in_cm / self.unit_velocity_in_cm_per_s
        udens = self.unit_mass_in_g / self.unit_length_in_cm**3
        upress = self.unit_mass_in_g / self.unit_length_in_cm / ut**2
        uenergy = self.unit_mass_in_g * self.unit_velocity_in_cm_per_s**2
        if self.gravity_constant_internal == 0.0:
            g = GRAVITY_CGS / self.unit_length_in_cm**3 * self.unit_mass_in_g * ut**2
        else:
            g = self.gravity_constant_internal
        hubble = HUBBLE_CGS * ut  # [G2: set_units] All.Hubble = HUBBLE * UnitTime
        if self.comoving_integration_on:
            tb_int = (  # log-a timeline [G2: begrun.c]
                (_safe_log(self.time_max) - _safe_log(self.time_begin)) / TIMEBASE
            )
        else:
            tb_int = (self.time_max - self.time_begin) / TIMEBASE
        return dataclasses.replace(
            self,
            unit_time_in_s=ut,
            unit_density_in_cgs=udens,
            unit_pressure_in_cgs=upress,
            unit_energy_in_cgs=uenergy,
            grav_internal=g,
            hubble_internal=hubble,
            timebase_interval=tb_int,
        )

    @property
    def softenings(self):
        """Comoving softening per type, GADGET order [G2: gravtree.c :: set_softenings()]."""
        return (
            self.softening_gas, self.softening_halo, self.softening_disk,
            self.softening_bulge, self.softening_stars, self.softening_bndry,
        )

    @property
    def softenings_max_phys(self):
        return (
            self.softening_gas_max_phys, self.softening_halo_max_phys,
            self.softening_disk_max_phys, self.softening_bulge_max_phys,
            self.softening_stars_max_phys, self.softening_bndry_max_phys,
        )

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def _safe_log(x: float) -> float:
    import math
    return math.log(x) if x > 0 else 0.0


# ---------------------------------------------------------------------------
# Parameter-file parsing
# ---------------------------------------------------------------------------
def _key_table():
    tbl = {}
    for f in dataclasses.fields(SimConfig):
        k = f.metadata.get("gadget_key")
        if k:
            tbl[k] = f
    return tbl


def parse_parameter_text(text: str, strict: bool = False) -> SimConfig:
    """Parse stock GADGET-2 parameter-file text into a :class:`SimConfig`.

    Format [G2: begrun.c :: read_parameter_file()]: one ``Tag  value`` pair
    per line; ``%`` and ``#`` start comments; unknown tags are a hard error
    in stock GADGET (here: error iff ``strict``, else ignored so fork-added
    keys don't break parsing); missing required tags are always an error.
    """
    tbl = _key_table()
    values = {}
    unknown = []
    for raw in text.splitlines():
        line = raw.split("%")[0].split("#")[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        tag = parts[0]
        val = parts[1].strip() if len(parts) > 1 else ""
        f = tbl.get(tag)
        if f is None:
            unknown.append(tag)
            continue
        typ = f.metadata["type"]
        if typ is str:
            values[f.name] = val
        elif typ is int:
            values[f.name] = int(float(val))
        else:
            values[f.name] = float(val)
    if strict and unknown:
        raise ValueError(f"unknown parameter tags: {unknown}")
    missing = [
        f.metadata["gadget_key"]
        for f in tbl.values()
        if f.metadata.get("required") and f.name not in values
    ]
    if missing:
        raise ValueError(f"missing required parameter tags: {missing}")
    return SimConfig(**values).finalize()


def read_parameter_file(path: str, strict: bool = False) -> SimConfig:
    with open(path) as fh:
        return parse_parameter_text(fh.read(), strict=strict)


def write_parameter_file(cfg: SimConfig, path: str) -> None:
    """Emit a stock-format parameter file (round-trip support)."""
    lines = []
    for f in dataclasses.fields(SimConfig):
        k = f.metadata.get("gadget_key")
        if not k:
            continue
        v = getattr(cfg, f.name)
        if v is None:
            continue
        lines.append(f"{k:<35} {v}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


# 3-smooth (2^a * 3^b) FFT-friendly PM mesh sizes.
PMGRID_SIZES = (16, 24, 32, 48, 64, 96, 128, 144, 192, 216, 288, 324,
                384, 432, 512, 576, 768, 864, 1152)


def auto_pmgrid(n_particles: int) -> int:
    """PM mesh for a periodic TreePM run, derived from particle count.

    The reference binds PMGRID at build time [G2: Makefile -DPMGRID];
    the rebuild derives it: smallest 3-smooth mesh keeping the mean
    short-range cell occupancy <= ~110 particles (ncells = floor(g/5.625),
    from rcut = 4.5 * ASMTH * box/g), which bounds the 27-cell pair work
    per particle."""
    for g in PMGRID_SIZES:
        if int(g / 5.625) ** 3 * 110 >= n_particles:
            return g
    return PMGRID_SIZES[-1]


# Makefile -DOPT flag -> (SimOptions field, value parser). Value-less flags
# map to True; PMGRID=n carries its int.
_MAKEFILE_FLAGS = {
    "PERIODIC": ("periodic", None),
    "PMGRID": ("pmgrid", int),
    "ISOTHERM_EQS": ("isotherm_eqs", None),
    "NOGRAVITY": ("nogravity", None),
    "UNEQUALSOFTENINGS": ("unequal_softenings", None),
    "ADAPTIVE_GRAVSOFT_FORGAS": ("adaptive_gravsoft_forgas", None),
    "FLEXSTEPS": ("flexsteps", None),
    "FORCETEST": ("forcetest", float),
    "MAKEGLASS": ("makeglass", int),
    "OUTPUTPOTENTIAL": ("output_potential", None),
    "DOUBLEPRECISION": ("dtype", lambda v: "f64"),
    "COOLING": ("cooling", lambda v: v if isinstance(v, str) else "beta"),
    "SINKS": ("sinks", None),
    # PLACEHIGHRESREGION=<type bitmask> selects the two-mesh zoom path
    # [G2: pm_nonperiodic.c]; pair with gravity_mode="zoom" (vacuum runs)
    "PLACEHIGHRESREGION": ("hr_types", int),
    "HIGHRESPMGRID": ("hr_pmgrid", int),
}


def parse_makefile_options(text: str) -> dict:
    """Parse GADGET Makefile-style option lines into SimOptions overrides.

    Accepts the reference's Makefile idiom (`OPT += -DPMGRID=128`), bare
    `-DPERIODIC`, and plain `PMGRID=128` / `PERIODIC` lines; `#` comments
    and blank lines ignored. Unknown flags hard-error (same contract as the
    .param parser: silent typos are worse than failures) [G2: Makefile]."""
    out = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("OPT"):
            line = line.split("=", 1)[1] if "=" in line else ""
        for tok in line.split():
            tok = tok.strip()
            if tok in ("+=", "="):
                continue
            if tok.startswith("-D"):
                tok = tok[2:]
            if not tok:
                continue
            key, _, val = tok.partition("=")
            if key not in _MAKEFILE_FLAGS:
                raise ValueError(f"unknown Makefile option flag: {key!r}")
            fieldname, conv = _MAKEFILE_FLAGS[key]
            if conv is None:
                out[fieldname] = True
            else:
                out[fieldname] = conv(val) if val else conv("")
    if out.get("pmgrid", 0) and "gravity_mode" not in out:
        out["gravity_mode"] = "treepm"
    return out


def options_sidecar_path(param_path: str) -> str:
    """The blessed Makefile-analog sidecar: `<paramfile>.opts` next to the
    parameter file carries the compile-time flags the reference's Makefile
    would (e.g. a line `OPT += -DPERIODIC -DPMGRID=192`)."""
    return param_path + ".opts"


def options_from_config(cfg: SimConfig, n_particles: int = 0,
                        **overrides) -> SimOptions:
    """Derive static options from a runtime config.

    With ``n_particles`` given, a periodic box defaults to TreePM with an
    auto-derived PM mesh — the stock `lcdm_gas.param` must run TreePM with
    no extra flags, mirroring how the reference binds PMGRID at build time."""
    kw = {"periodic": bool(cfg.periodic_boundaries_on)}
    if kw["periodic"] and n_particles > 0:
        kw["pmgrid"] = auto_pmgrid(n_particles)
        kw["gravity_mode"] = "treepm"
    kw.update(overrides)
    return SimOptions(**{}).replace(**kw)
