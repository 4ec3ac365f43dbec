"""Radiative cooling — Leicester-fork physics [SURVEY.md §2, UNVERIFIED-FORK:
the fork adds radiative cooling for self-gravitating protoplanetary disc
runs; the standard Leicester choices are Gammie beta-cooling and
Stamatellos et al. (2007) polytropic radiative cooling].

Pointwise per-particle physics — trivially vectorised: one masked
vector op over the gas block, folded into dt_entropy so the entropy kick
integrates it with the same KDK machinery.

beta-cooling:  du/dt = -u * Omega(R) / beta, with Omega the Keplerian
frequency about the central object (first sink slot, else the origin with
total enclosed mass approximated by the central sink mass). In entropy
variables at fixed density: dA/dt = -A * Omega / beta.

Stamatellos et al. (2007, A&A 475, 37) radiative cooling/heating
approximation — the "polytropic pseudo-cloud" method:

    du_i/dt = 4 sigma_SB (T_bg^4 - T_i^4)
              / ( Sigma_i^2 kappa_R(rho_i, T_i) + kappa_P(rho_i, T_i)^{-1} )

where the pseudo-mean column density is estimated from the local density
and gravitational potential,

    Sigma_i^2 = zeta * rho_i |psi_i| / (4 pi G),

(psi_i the *self-gravity* potential of the gas — point-mass sink
contributions are subtracted), and kappa is the Bell & Lin (1994)
piecewise power-law opacity kappa = kappa_0 rho^a T^b across 8 regimes
(ice grains, ice evaporation, dust, dust evaporation, molecules, H-
scattering, bound-free/free-free, electron scattering). We follow the
common simplification kappa_P = kappa_R. The denominator interpolates
between the optically-thick diffusion limit (Sigma^2 kappa) and the
optically-thin emission limit (1/kappa). zeta (``CoolingColumnFac``)
absorbs the polytropic-index-dependent dimensionless factor; the exact
fork normalisation is [UNVERIFIED-FORK] until the reference mount
appears, but the functional form above is the published method.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from gadget_leicester_tpu.core.config import (BOLTZMANN_CGS, GAMMA,
                                              GAMMA_MINUS1,
                                              HYDROGEN_MASSFRAC,
                                              PROTONMASS_CGS, SimConfig,
                                              SimOptions)
from gadget_leicester_tpu.core.state import SimState

SIGMA_SB_CGS = 5.6704e-5   # erg cm^-2 s^-1 K^-4
MEAN_MOL_NEUTRAL = 4.0 / (1.0 + 3.0 * HYDROGEN_MASSFRAC)  # ~2.4 for H2+He... (neutral)

# Bell & Lin (1994) opacity regimes: kappa = k0 * rho^a * T^b  [cgs].
# Order matters: regime n hands over to n+1 at the crossing temperature
# T_{n,n+1}(rho) = (k0_n rho^{a_n} / k0_{n+1} rho^{a_{n+1}})^{1/(b_{n+1}-b_n)}.
_BELL_LIN = (
    # (k0,      a,        b)
    (2.0e-4,    0.0,      2.0),     # ice grains
    (2.0e16,    0.0,     -7.0),     # ice evaporation
    (0.1,       0.0,      0.5),     # metal/dust grains
    (2.0e81,    1.0,    -24.0),     # dust evaporation
    (1.0e-8,    2.0 / 3.0, 3.0),    # molecules
    (1.0e-36,   1.0 / 3.0, 10.0),   # H- scattering
    (1.5e20,    1.0,     -2.5),     # bound-free / free-free
    (0.348,     0.0,      0.0),     # electron scattering
)


def bell_lin_opacity(rho_cgs, temp_k):
    """Rosseland-mean opacity [cm^2/g], Bell & Lin (1994) piecewise power
    laws with density-dependent crossing temperatures. Fully vectorised
    (nested where-chain over 8 static regimes — XLA fuses it).

    All selection runs in log space with TRACE-TIME Python-float log
    constants: k0 spans 1e-36..2e81, far outside f32 range, so computing
    jnp.log(k0) or k0*rho**a*t**b directly overflows (f32 inf) and corrupts
    the regime choice."""
    import math
    rho = jnp.maximum(rho_cgs, 1e-30)
    t = jnp.maximum(temp_k, 1.0)
    logr = jnp.log(rho)
    logt = jnp.log(t)
    logk0 = [math.log(k0) for (k0, _, _) in _BELL_LIN]
    log_kappas = [logk0[i] + a * logr + b * logt
                  for i, (_, a, b) in enumerate(_BELL_LIN)]
    out_log = log_kappas[-1]
    for i in range(len(_BELL_LIN) - 2, -1, -1):
        _, aa, ba = _BELL_LIN[i]
        _, ab, bb = _BELL_LIN[i + 1]
        log_tcross = (logk0[i] - logk0[i + 1] + (aa - ab) * logr) / (bb - ba)
        out_log = jnp.where(logt < log_tcross, log_kappas[i], out_log)
    # clamp before exp: physical range is ~1e-8..1e10 cm^2/g
    return jnp.exp(jnp.clip(out_log, -60.0, 60.0))


def _sink_potential_correction(state: SimState, cfg: SimConfig, ng: int):
    """G * sum_s M_s / |x - x_s| — the point-mass part of the potential
    contributed by registered sinks, to be REMOVED from psi so the column
    estimate sees only the gas cloud's self-gravity [Stamatellos 2007
    pseudo-cloud assumption]."""
    p = state.p
    s_valid = state.sinks.slot >= 0
    s_idx = jnp.maximum(state.sinks.slot, 0)
    s_pos = p.pos[s_idx]                            # [S,3]
    s_mass = jnp.where(s_valid, p.mass[s_idx], 0.0)
    dx = p.pos[None, :ng, :] - s_pos[:, None, :]    # [S,Ng,3]
    r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
    r = jnp.maximum(r, 1e-20)
    return -cfg.grav_internal * jnp.sum(s_mass[:, None] / r, axis=0)  # [Ng]


def apply_cooling(state: SimState, cfg: SimConfig, opts: SimOptions) -> SimState:
    gas = state.gas
    p = state.p
    ng = gas.n_gas_max
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)

    if opts.cooling == "beta":
        # central object: first registered sink, else origin with the total
        # non-gas mass (disc-around-star setups put the star at slot 0 type 5)
        slot0 = state.sinks.slot[0]
        has_sink = slot0 >= 0
        idx = jnp.maximum(slot0, 0)
        center = jnp.where(has_sink, p.pos[idx], jnp.zeros(3, p.pos.dtype))
        m_central = jnp.where(
            has_sink,
            p.mass[idx],
            jnp.sum(jnp.where(p.alive & (p.ptype != 0), p.mass, 0.0)),
        )
        dx = p.pos[:ng] - center[None, :]
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        r = jnp.maximum(r, 1e-10)
        omega = jnp.sqrt(cfg.grav_internal * jnp.maximum(m_central, 1e-30) / r**3)
        dcool = -gas.entropy_pred * omega / cfg.cooling_beta
    elif opts.cooling == "stamatellos":
        # ---- Stamatellos et al. (2007) pseudo-cloud radiative rate ----
        rho = jnp.maximum(gas.density, 1e-30)       # internal units (physical:
        # disc runs are non-comoving; comoving runs would need *a3inv here)
        # temperature from the entropy function A: u = A rho^{g-1}/(g-1)
        u_int = gas.entropy_pred * rho**GAMMA_MINUS1 / GAMMA_MINUS1
        u_cgs = u_int * cfg.unit_velocity_in_cm_per_s**2
        temp = jnp.maximum(
            GAMMA_MINUS1 * MEAN_MOL_NEUTRAL * PROTONMASS_CGS / BOLTZMANN_CGS
            * u_cgs, 1.0)
        rho_cgs = rho * cfg.unit_density_in_cgs

        # gas-only potential: strip registered sinks' point-mass term
        psi = p.pot[:ng] - _sink_potential_correction(state, cfg, ng)
        psi_mag = jnp.maximum(-psi, 0.0)            # bound regions: psi < 0
        # Sigma^2 = zeta rho |psi| / (4 pi G)  -> cgs
        sigma2_int = (cfg.cooling_column_fac * rho * psi_mag
                      / (4.0 * jnp.pi * cfg.grav_internal))
        sigma2_cgs = sigma2_int * (cfg.unit_mass_in_g
                                   / cfg.unit_length_in_cm**2)**2
        # floor: at least the particle's own smoothing-length column
        sigma_self = rho_cgs * jnp.maximum(gas.hsml, 1e-30) * cfg.unit_length_in_cm
        sigma2_cgs = jnp.maximum(sigma2_cgs, sigma_self**2)

        kappa = bell_lin_opacity(rho_cgs, temp)
        tbg4 = jnp.asarray(cfg.cooling_tbg, temp.dtype)**4
        dudt_cgs = (4.0 * SIGMA_SB_CGS * (tbg4 - temp**4)
                    / (sigma2_cgs * kappa + 1.0 / kappa))
        # cgs -> internal du/dt, then to dA/dt at fixed density
        dudt_int = dudt_cgs / (cfg.unit_velocity_in_cm_per_s**2
                               / cfg.unit_time_in_s)
        dcool = GAMMA_MINUS1 * dudt_int / rho**GAMMA_MINUS1
    else:
        return state

    dcool = jnp.where(gas_mask, dcool, 0.0)
    gas = dataclasses.replace(gas, dt_entropy=gas.dt_entropy + dcool)
    return dataclasses.replace(state, gas=gas)
