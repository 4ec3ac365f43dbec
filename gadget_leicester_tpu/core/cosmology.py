"""Comoving-integration drift/kick factor tables [G2: driftfac.c].

The reference precomputes three length-1000 tables on a log-a grid between
``TimeBegin`` and ``TimeMax`` by GSL quadrature, then interpolates:

* drift factor      ``int dt/a^2 = int da / (a^3 H(a))``
* gravity kick      ``int dt/a   = int da / (a^2 H(a))``
* hydro kick        ``int dt/a^{3(gamma-1)} ... / a`` (entropy-form factor)

[G2: driftfac.c :: init_drift_table(), get_drift_factor(),
get_gravkick_factor(), get_hydrokick_factor()].

Rebuild: the tables are computed once on host with numpy
cumulative Simpson/trapezoid integration (no GSL), stored as a small pytree
of jnp arrays, and looked up inside jit with ``jnp.interp`` on log(a) —
branch-free, vectorises over per-particle timesteps.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from gadget_leicester_tpu.core.config import GAMMA, SimConfig

DRIFT_TABLE_LENGTH = 1024  # reference uses 1000 [G2: driftfac.c DRIFT_TABLE_LENGTH]
_SUBDIV = 64  # fine substeps per table bin for the host-side quadrature


def hubble_function(a, omega0, omega_lambda, hubble):
    """H(a) in internal units [G2: driftfac.c / allvars].

    H(a) = Hubble * sqrt(Omega0/a^3 + (1-Omega0-OmegaLambda)/a^2 + OmegaLambda)
    """
    omega_k = 1.0 - omega0 - omega_lambda
    return hubble * jnp.sqrt(omega0 / a**3 + omega_k / a**2 + omega_lambda)


@jax.tree_util.register_pytree_node_class
@dataclass
class DriftTables:
    """Precomputed cumulative integrals on a log-a grid (pytree of arrays)."""

    log_a_begin: float
    log_a_max: float
    drift: jnp.ndarray      # cumulative int da/(a^3 H)
    gravkick: jnp.ndarray   # cumulative int da/(a^2 H)
    hydrokick: jnp.ndarray  # cumulative int da/(a^{3(g-1)+1} ... ) see below

    def tree_flatten(self):
        return (self.drift, self.gravkick, self.hydrokick), (
            self.log_a_begin,
            self.log_a_max,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], *children)

    # -- lookups (jit-safe) -------------------------------------------------
    def _interp(self, table, log_a):
        n = table.shape[0]
        x = (log_a - self.log_a_begin) / (self.log_a_max - self.log_a_begin)
        xi = jnp.clip(x, 0.0, 1.0) * (n - 1)
        grid = jnp.arange(n, dtype=table.dtype)
        return jnp.interp(xi, grid, table)

    def drift_factor(self, log_a0, log_a1):
        return self._interp(self.drift, log_a1) - self._interp(self.drift, log_a0)

    def gravkick_factor(self, log_a0, log_a1):
        return self._interp(self.gravkick, log_a1) - self._interp(self.gravkick, log_a0)

    def hydrokick_factor(self, log_a0, log_a1):
        return self._interp(self.hydrokick, log_a1) - self._interp(self.hydrokick, log_a0)


def _hubble_np(a, omega0, omega_lambda, hubble):
    omega_k = 1.0 - omega0 - omega_lambda
    return hubble * np.sqrt(omega0 / a**3 + omega_k / a**2 + omega_lambda)


def init_drift_tables(cfg: SimConfig) -> DriftTables:
    """Host-side table build [G2: driftfac.c :: init_drift_table()].

    Integrands (matching the reference's drift_integ/gravkick_integ/
    hydrokick_integ, expressed in da):
      drift:     1 / (H(a) a^3)
      gravkick:  1 / (H(a) a^2)
      hydrokick: 1 / (H(a) a^{3(gamma-1)} a)   (entropy-formulation kick)
    Cumulative from a_begin, on a log-a grid, trapezoid with _SUBDIV
    substeps per bin (matches GSL 1e-8 tolerance to ~1e-10 on these smooth
    integrands).
    """
    if not cfg.comoving_integration_on:
        # Physical integration: factors are just dt; table is unused but we
        # return an identity-like structure to keep the pytree static.
        z = jnp.zeros((2,), dtype=jnp.float64)
        return DriftTables(0.0, 1.0, z, z, z)

    log_a0 = np.log(cfg.time_begin)
    log_a1 = np.log(cfg.time_max)
    n = DRIFT_TABLE_LENGTH
    # fine grid for quadrature
    fine = np.exp(np.linspace(log_a0, log_a1, (n - 1) * _SUBDIV + 1))
    h = _hubble_np(fine, cfg.omega0, cfg.omega_lambda, cfg.hubble_internal)
    integrands = {
        "drift": 1.0 / (h * fine**3),
        "gravkick": 1.0 / (h * fine**2),
        "hydrokick": 1.0 / (h * fine ** (3.0 * (GAMMA - 1.0)) * fine),
    }
    out = {}
    da = np.diff(fine)
    for k, f in integrands.items():
        seg = 0.5 * (f[:-1] + f[1:]) * da          # trapezoid per fine step
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        out[k] = jnp.asarray(cum[:: _SUBDIV])      # sample at table nodes
    return DriftTables(float(log_a0), float(log_a1), out["drift"],
                       out["gravkick"], out["hydrokick"])


# ---------------------------------------------------------------------------
# Interval factors used by the integrator.
#
# Redesign note: the reference differenced cumulative tables
# [G2: driftfac.c :: get_drift_factor() = DriftTable[i1]-DriftTable[i0]]
# in double precision. In f32 that cancellation destroys all accuracy for
# small steps, so instead we evaluate each interval integral DIRECTLY with
# fixed-order Gauss-Legendre quadrature in log(a) — cancellation-free,
# branch-free, vectorises over per-particle (ti0, ti1) intervals, and needs
# no tables at all. 3-point GL on these smooth (exponential-in-loga)
# integrands is accurate to ~5e-7 relative even over d(loga) ~ 1 (error
# scales as h^7 f^(6); per-particle intervals are <~ 0.05, where the
# error is below f32 resolution) — and each node costs an exp + a
# hubble sqrt PER PARTICLE per call, so the order is a direct O(N)
# hot-loop cost (6+ factor calls per sync point).
#
# In physical (non-comoving) runs all three factors are simply dt
# [G2: predict.c / timestep.c branch on All.ComovingIntegrationOn].
# ---------------------------------------------------------------------------
# 3-point Gauss-Legendre nodes/weights on [0, 1], kept as PYTHON floats:
# scalar constants inline into the HLO, where array-shaped trace constants
# would be hoisted as extra executable parameters.
_GL = (
    (0.1127016653792583, 0.2777777777777778),
    (0.5, 0.4444444444444444),
    (0.8872983346207417, 0.2777777777777778),
)


def _interval_quad(cfg: SimConfig, ti0, ti1, power: float):
    """int_{a0}^{a1} da / (H(a) a^power) over the tick interval, via GL8
    in loga:  int f(a) dloga with f = 1/(H(a) a^{power-1}). Unrolled over
    scalar nodes (see _GL note)."""
    ti0, ti1 = jnp.broadcast_arrays(jnp.asarray(ti0), jnp.asarray(ti1))
    la0 = np.log(cfg.time_begin) + ti0 * cfg.timebase_interval
    dla = (ti1 - ti0) * cfg.timebase_interval
    total = 0.0
    for x, w in _GL:
        a = jnp.exp(la0 + dla * x)
        f = 1.0 / (hubble_function(a, cfg.omega0, cfg.omega_lambda,
                                   cfg.hubble_internal) * a ** (power - 1.0))
        total = total + w * f
    return dla * total


def drift_factor(tables: DriftTables, cfg: SimConfig, ti0, ti1):
    """int dt/a^2 over [ti0, ti1] (vectorises over particle intervals)."""
    del tables
    if cfg.comoving_integration_on:
        return _interval_quad(cfg, ti0, ti1, 3.0)
    return (jnp.asarray(ti1) - ti0) * cfg.timebase_interval


def gravkick_factor(tables: DriftTables, cfg: SimConfig, ti0, ti1):
    """int dt/a over [ti0, ti1]."""
    del tables
    if cfg.comoving_integration_on:
        return _interval_quad(cfg, ti0, ti1, 2.0)
    return (jnp.asarray(ti1) - ti0) * cfg.timebase_interval


def hydrokick_factor(tables: DriftTables, cfg: SimConfig, ti0, ti1):
    """int dt/a^{3(gamma-1)+1} over [ti0, ti1] (entropy-form hydro kick)."""
    del tables
    if cfg.comoving_integration_on:
        return _interval_quad(cfg, ti0, ti1, 3.0 * (GAMMA - 1.0) + 1.0)
    return (jnp.asarray(ti1) - ti0) * cfg.timebase_interval
