"""Sink/accretion particles — Leicester-fork physics [SURVEY.md §2,
UNVERIFIED-FORK: accretion-radius sink checks a la Bate et al. 1995].

A sink is a collisionless particle registered in ``SinkState.slot``. Each
sync point, gas particles inside a sink's accretion radius that are bound
and approaching are accreted: their mass and momentum transfer to the sink
and they are masked dead (``alive=False``) — the rebuild of particle
removal is masking, never compaction (static shapes).

Vectorised as an [S, Ng] distance/criteria matrix (S = sink capacity is
small and static), with conservation-exact mass/momentum transfer.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.core.config import (GAMMA_MINUS1, SimConfig,
                                              SimOptions)
from gadget_leicester_tpu.core.state import SimState

# f32 pair sums: no TF32 on GPU tensor cores
HIGHEST = jax.lax.Precision.HIGHEST


def _min_image(dx, cfg: SimConfig, opts: SimOptions):
    """Periodic minimum-image displacement (no-op for vacuum runs)."""
    if not opts.periodic or cfg.box_size <= 0:
        return dx
    box = cfg.box_size
    return dx - box * jnp.round(dx / box)


def register_sinks_from_types(state: SimState, sink_type: int = 5) -> SimState:
    """Mark all particles of `sink_type` as sinks (host-side setup helper)."""
    import numpy as np
    ptype = np.asarray(state.p.ptype)
    alive = np.asarray(state.p.alive)
    idx = np.where((ptype == sink_type) & alive)[0]
    s = state.sinks
    cap = s.slot.shape[0]
    slot = np.full(cap, -1, np.int32)
    slot[: min(len(idx), cap)] = idx[:cap]
    sinks = dataclasses.replace(s, slot=jnp.asarray(slot))
    return dataclasses.replace(state, sinks=sinks)


def accrete_onto_sinks(state: SimState, cfg: SimConfig, opts: SimOptions) -> SimState:
    if cfg.sink_accretion_radius <= 0:
        return state
    p, gas, sinks = state.p, state.gas, state.sinks
    ng = gas.n_gas_max
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)

    s_valid = sinks.slot >= 0                       # [S]
    s_idx = jnp.maximum(sinks.slot, 0)
    s_pos = p.pos[s_idx]                            # [S,3]
    s_vel = p.vel[s_idx]
    s_mass = p.mass[s_idx]

    dx = _min_image(s_pos[:, None, :] - p.pos[None, :ng, :], cfg, opts)
    r2 = jnp.sum(dx * dx, axis=-1)                  # [S,Ng]
    dv = s_vel[:, None, :] - p.vel[None, :ng, :]
    # criteria [Bate et al. 1995 style]: inside r_acc, approaching, bound
    inside = r2 < cfg.sink_accretion_radius**2
    approaching = jnp.sum(dv * dx, axis=-1) < 0     # moving toward sink... sign:
    # (v_gas - v_sink) . (x_gas - x_sink) < 0  <=>  (dv).(dx) < 0 with our defs
    v2 = jnp.sum(dv * dv, axis=-1)
    # boundness vs the SOFTENED sink potential, including the gas particle's
    # thermal energy: 0.5 v_rel^2 + u < G M_s / sqrt(r^2 + eps^2)
    # (eps = type-5 softening; a pure point-mass check over-accretes close
    # hot gas and under-weights softened dynamics)
    eps = cfg.softenings[5]
    r_soft = jnp.sqrt(r2 + eps * eps)
    rho_safe = jnp.maximum(gas.density, 1e-30)
    u_gas = gas.entropy_pred * rho_safe**GAMMA_MINUS1 / GAMMA_MINUS1  # [Ng]
    bound = (0.5 * v2 + u_gas[None, :]
             < cfg.grav_internal * s_mass[:, None] / r_soft)
    take = inside & approaching & bound & gas_mask[None, :] & s_valid[:, None]

    # a gas particle goes to the NEAREST claiming sink only
    big = jnp.asarray(1e30, r2.dtype)
    r2m = jnp.where(take, r2, big)
    winner = jnp.argmin(r2m, axis=0)                # [Ng]
    any_take = jnp.any(take, axis=0)                # [Ng]
    claim = (jnp.arange(sinks.slot.shape[0])[:, None] == winner[None, :]) & any_take[None, :]

    m_g = jnp.where(gas_mask, p.mass[:ng], 0.0)
    dm = jnp.sum(jnp.where(claim, m_g[None, :], 0.0), axis=1)            # [S]
    dp = jnp.einsum("sn,nc->sc", jnp.where(claim, m_g[None, :], 0.0),
                    p.vel[:ng], precision=HIGHEST)                       # [S,3]
    n_acc = jnp.sum(claim, axis=1).astype(jnp.int32)

    # update sink particles (conserve mass + momentum)
    new_mass = s_mass + dm
    new_vel = (s_mass[:, None] * s_vel + dp) / jnp.maximum(new_mass, 1e-30)[:, None]
    mass_upd = p.mass.at[s_idx].set(jnp.where(s_valid, new_mass, p.mass[s_idx]))
    vel_upd = p.vel.at[s_idx].set(jnp.where(s_valid[:, None], new_vel, p.vel[s_idx]))

    # kill accreted gas
    alive = p.alive.at[:ng].set(p.alive[:ng] & ~any_take)

    p = dataclasses.replace(p, mass=mass_upd, vel=vel_upd, alive=alive)
    sinks = dataclasses.replace(
        sinks,
        acc_mass=sinks.acc_mass + dm,
        n_accreted=sinks.n_accreted + n_acc,
    )
    return dataclasses.replace(state, p=p, sinks=sinks)


def create_sinks(state: SimState, cfg: SimConfig, opts: SimOptions) -> SimState:
    """Density-threshold sink formation [Bate et al. 1995 style checks;
    SURVEY.md §2 fork row, UNVERIFIED-FORK].

    A gas particle becomes a sink when ALL of:
      * physical density rho > SinkFormationDensity,
      * converging flow (div v < 0),
      * thermally bound: alpha = u / |psi| <= 0.5 (virial-style check),
      * it is a local potential minimum: no other gas particle within
        SinkAccretionRadius has lower potential,
      * a free sink slot exists.

    At most ONE sink forms per sync point (the densest passing candidate) —
    formation is rare and serialising it keeps the check O(N) vector ops
    instead of an O(N^2) candidate-pair matrix; competitors form on the
    next sync point. The particle is converted in place to type 5 (its gas
    slot is thereafter excluded by every gas_mask), preserving mass and
    momentum exactly.
    """
    if cfg.sink_formation_density <= 0:
        return state
    p, gas, sinks = state.p, state.gas, state.sinks
    ng = gas.n_gas_max
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)

    rho = gas.density
    rho_safe = jnp.maximum(rho, 1e-30)
    u = gas.entropy_pred * rho_safe**GAMMA_MINUS1 / GAMMA_MINUS1
    psi_mag = jnp.maximum(-p.pot[:ng], 1e-30)
    cand = (gas_mask
            & (rho > cfg.sink_formation_density)
            & (gas.div_vel < 0.0)
            & (u <= 0.5 * psi_mag))

    any_cand = jnp.any(cand)
    best = jnp.argmax(jnp.where(cand, rho, -1.0))       # densest candidate

    # local-potential-minimum check vs ALL gas within r_acc of `best`
    r_acc = jnp.asarray(cfg.sink_accretion_radius
                        if cfg.sink_accretion_radius > 0 else 0.0,
                        p.pos.dtype)
    dxb = _min_image(p.pos[:ng] - p.pos[best][None, :], cfg, opts)
    r2b = jnp.sum(dxb * dxb, axis=-1)
    near = gas_mask & (r2b < r_acc * r_acc)
    near = near.at[best].set(False)
    deeper = near & (p.pot[:ng] < p.pot[best])
    is_pot_min = ~jnp.any(deeper)

    free = sinks.slot < 0
    has_free = jnp.any(free)
    free_slot = jnp.argmax(free)

    do_form = any_cand & is_pot_min & has_free

    ptype = p.ptype.at[best].set(
        jnp.where(do_form, jnp.int32(5), p.ptype[best]))
    slot = sinks.slot.at[free_slot].set(
        jnp.where(do_form, best.astype(jnp.int32), sinks.slot[free_slot]))

    p = dataclasses.replace(p, ptype=ptype)
    sinks = dataclasses.replace(sinks, slot=slot)
    return dataclasses.replace(state, p=p, sinks=sinks)
