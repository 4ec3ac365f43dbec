"""SoA particle-state pytrees — the rebuild of [G2: allvars.h] particle structs.

The reference keeps AoS arrays ``struct particle_data *P`` and
``struct sph_particle_data *SphP`` (gas fields parallel to the first
N_gas entries of P). Redesign:

* **SoA** jnp arrays (one array per field) so every kernel is a wide
  vector op; padded to a fixed capacity (static shapes — the analog of
  ``PartAllocFactor`` headroom [G2: allocate.c]).
* Dead/padded/accreted particles are masked via ``alive``; nothing is ever
  deleted (sink accretion masks gas out, it doesn't compact).
* Gas fields live in a parallel :class:`GasState` sized ``n_gas_max``;
  gas particles occupy slots ``[0, n_gas)`` exactly as in the reference.
* Velocity convention matches GADGET: ``vel`` is the internal kick
  variable; snapshot I/O converts with ``sqrt(a)`` factors for comoving
  runs [G2: io.c].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from gadget_leicester_tpu.core.config import SimOptions

PAD_MULTIPLE = 256  # capacity rounding — static-shape headroom


def _round_up(n: int, m: int = PAD_MULTIPLE) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _dataclass_pytree(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def strip_grids(state):
    """Drop the grid cache (for serialization / re-layout: the cache is
    pure derived data and is rebuilt on the first force pass)."""
    return dataclasses.replace(state, grids=None)


@_dataclass_pytree
@dataclass
class ParticleState:
    """All-particle fields [G2: allvars.h struct particle_data]."""

    pos: jnp.ndarray        # [N,3] position (comoving in cosmological runs)
    vel: jnp.ndarray        # [N,3] internal velocity variable
    mass: jnp.ndarray       # [N]
    ptype: jnp.ndarray      # [N] int32, 0..5
    pid: jnp.ndarray        # [N] int64 particle ID
    acc: jnp.ndarray        # [N,3] short-range/tree gravitational acceleration
    acc_pm: jnp.ndarray     # [N,3] long-range PM acceleration (FROZEN between
                            # PM steps [G2: timestep.c PM kick machinery])
    pot: jnp.ndarray        # [N] potential (TreePM in-step: full PM+SR
                            # potential when sinks/Stamatellos consume it,
                            # PM-only otherwise; diagnostics use the
                            # on-demand compute_potential either way)
    pot_pm: jnp.ndarray     # [N] long-range PM potential piece (FROZEN
                            # between PM steps, like acc_pm)
    old_acc: jnp.ndarray    # [N] |acc| of previous step (relative opening crit)
    ti_begstep: jnp.ndarray # [N] int64 tick at which current step began
    ti_endstep: jnp.ndarray # [N] int64 tick at which current step ends
    alive: jnp.ndarray      # [N] bool — False for padding / accreted

    @property
    def n_max(self) -> int:
        return self.pos.shape[0]


@_dataclass_pytree
@dataclass
class GasState:
    """SPH fields, parallel to P[0:n_gas] [G2: allvars.h struct sph_particle_data]."""

    entropy: jnp.ndarray          # [Ng] entropic function A = P/rho^gamma
    dt_entropy: jnp.ndarray       # [Ng] dA/dt from viscous (+cooling) terms
    density: jnp.ndarray          # [Ng]
    hsml: jnp.ndarray             # [Ng] smoothing length
    pressure: jnp.ndarray         # [Ng]
    vel_pred: jnp.ndarray         # [Ng,3] predicted velocity at current time
    div_vel: jnp.ndarray          # [Ng]
    curl_vel: jnp.ndarray         # [Ng] |rot v|
    dhsml_density_factor: jnp.ndarray  # [Ng] f_i correction
    max_signal_vel: jnp.ndarray   # [Ng]
    num_ngb: jnp.ndarray          # [Ng] effective neighbour number (float)
    hydro_acc: jnp.ndarray        # [Ng,3]
    entropy_pred: jnp.ndarray     # [Ng] predicted entropy at current time

    @property
    def n_gas_max(self) -> int:
        return self.entropy.shape[0]


@_dataclass_pytree
@dataclass
class SinkState:
    """Sink/accretion particle bookkeeping (Leicester fork; SURVEY.md §2).

    Sinks are regular collisionless particles (their slot index in
    ParticleState); this records per-sink accretion tallies. Fixed capacity.
    """

    slot: jnp.ndarray        # [S] int32 index into ParticleState (-1 = unused)
    acc_mass: jnp.ndarray    # [S] cumulative accreted mass
    n_accreted: jnp.ndarray  # [S] int32 count of accreted gas particles


@_dataclass_pytree
@dataclass
class SimState:
    """Full dynamical state — the pytree that a simulation step maps to itself."""

    p: ParticleState
    gas: GasState
    sinks: SinkState
    ti_current: jnp.ndarray   # int64 scalar — integer timeline position
    pm_ti_endstep: jnp.ndarray  # int64 scalar — end of current PM step
    pm_ti_begstep: jnp.ndarray  # int64 scalar
    rng_key: jnp.ndarray      # jax PRNG key (glass-making etc.)
    overflow_flags: jnp.ndarray  # int32 bitmask: 1=short-range cells over
                                 # capacity, 2=SPH cells over capacity —
                                 # sticky; nonzero means forces dropped
                                 # particles (recompute-bigger needed)
    grids: object = None      # models.grids.GridCache | None — persistent
                              # stale-tolerant neighbour grids (rebuilt on a
                              # displacement cadence, the analog of
                              # [G2: domain.c TreeDomainUpdateFrequency])

    @property
    def n_max(self) -> int:
        return self.p.n_max

    @property
    def n_gas_max(self) -> int:
        return self.gas.n_gas_max


# ---------------------------------------------------------------------------
# Allocation / construction
# ---------------------------------------------------------------------------
def allocate(
    n: int,
    n_gas: int,
    opts: SimOptions,
    n_sinks_max: int = 64,
    pad: bool = True,
) -> SimState:
    """Fixed-capacity state allocation [G2: allocate.c :: allocate_memory()].

    Capacities round up to PAD_MULTIPLE (static-shape headroom, the
    analog of PartAllocFactor).
    """
    f = jnp.float64 if opts.dtype == "f64" else jnp.float32
    nm = _round_up(n) if pad else n
    ngm = _round_up(max(n_gas, 1)) if pad else max(n_gas, 1)
    z3 = jnp.zeros((nm, 3), f)
    z1 = jnp.zeros((nm,), f)
    p = ParticleState(
        pos=z3, vel=z3, mass=z1,
        ptype=jnp.zeros((nm,), jnp.int32),
        pid=jnp.zeros((nm,), jnp.int32),
        acc=z3, acc_pm=z3, pot=z1, pot_pm=z1, old_acc=z1,
        ti_begstep=jnp.zeros((nm,), jnp.int32),
        ti_endstep=jnp.zeros((nm,), jnp.int32),
        alive=jnp.zeros((nm,), bool),
    )
    g3 = jnp.zeros((ngm, 3), f)
    g1 = jnp.zeros((ngm,), f)
    gas = GasState(
        entropy=g1, dt_entropy=g1, density=g1, hsml=g1, pressure=g1,
        vel_pred=g3, div_vel=g1, curl_vel=g1,
        dhsml_density_factor=jnp.ones((ngm,), f),
        max_signal_vel=g1, num_ngb=g1, hydro_acc=g3, entropy_pred=g1,
    )
    sinks = SinkState(
        slot=-jnp.ones((n_sinks_max,), jnp.int32),
        acc_mass=jnp.zeros((n_sinks_max,), f),
        n_accreted=jnp.zeros((n_sinks_max,), jnp.int32),
    )
    return SimState(
        p=p, gas=gas, sinks=sinks,
        ti_current=jnp.int32(0),
        pm_ti_endstep=jnp.int32(0),
        pm_ti_begstep=jnp.int32(0),
        rng_key=jax.random.PRNGKey(42),
        overflow_flags=jnp.int32(0),
    )


def from_arrays(
    pos: np.ndarray,
    vel: np.ndarray,
    mass: np.ndarray,
    ptype: np.ndarray,
    pid: np.ndarray,
    opts: SimOptions,
    u: np.ndarray | None = None,
    pad: bool = True,
) -> SimState:
    """Build a SimState from host IC arrays (gas first, GADGET type order).

    `u` is specific internal energy for gas particles (converted to entropy
    after the first density pass, as in [G2: init.c :: init()]).
    """
    n = int(pos.shape[0])
    order = np.argsort(ptype, kind="stable")  # gas (type 0) first
    pos, vel, mass = pos[order], vel[order], mass[order]
    ptype, pid = ptype[order], pid[order]
    n_gas = int(np.sum(ptype == 0))
    # `u` must be aligned with the gas subset in input order; the stable
    # sort preserves that relative order, so u[:n_gas] lines up below.
    st = allocate(n, n_gas, opts, pad=pad)
    f = st.p.pos.dtype
    p = st.p
    p = dataclasses.replace(
        p,
        pos=p.pos.at[:n].set(jnp.asarray(pos, f)),
        vel=p.vel.at[:n].set(jnp.asarray(vel, f)),
        mass=p.mass.at[:n].set(jnp.asarray(mass, f)),
        ptype=p.ptype.at[:n].set(jnp.asarray(ptype, jnp.int32)),
        pid=p.pid.at[:n].set(jnp.asarray(pid, jnp.int32)),
        alive=p.alive.at[:n].set(True),
    )
    gas = st.gas
    if u is not None and n_gas:
        # stash u in entropy slot until init converts it (flagged by caller)
        gas = dataclasses.replace(
            gas, entropy=gas.entropy.at[:n_gas].set(jnp.asarray(u[:n_gas], f))
        )
    return dataclasses.replace(st, p=p, gas=gas)


def n_alive(st: SimState) -> int:
    return int(jnp.sum(st.p.alive))


def n_gas_alive(st: SimState) -> int:
    ng = st.gas.n_gas_max
    return int(jnp.sum(st.p.alive[:ng] & (st.p.ptype[:ng] == 0)))
