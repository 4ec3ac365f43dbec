"""Sinks under the owner-computes SPMD step (VERDICT r2 item 8).

Accretion parity vs the single-device step on the virtual CPU mesh:
sink mass/momentum updates and gas removal must agree even when the
accretion volume straddles a slab face or the periodic wrap, and the
replicated PID-keyed registry must tally the same accreted totals as
the canonical row-indexed one [G2-fork: sink accretion; the claim
pattern is gravtree.c's export-evaluate-return applied to accretion].
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from gadget_leicester_tpu.core.config import SimOptions, parse_parameter_text
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.models.simulation import Simulation, sync_point_step
from gadget_leicester_tpu.models.sinks import register_sinks_from_types
from gadget_leicester_tpu.parallel.mesh import make_mesh
from gadget_leicester_tpu.parallel.spmd import (make_spmd_step,
                                                spmd_min_width,
                                                spmd_to_canonical, to_spmd)

BOX = 50000.0
PARAM = f"""
InitCondFile x
OutputDir  /tmp/spmd_sink_test
TimeBegin  0.090909
TimeMax    1.0
ComovingIntegrationOn 1
PeriodicBoundariesOn 1
BoxSize    {BOX}
Omega0     0.3
OmegaLambda 0.7
OmegaBaryon 0.04
HubbleParam 0.7
ErrTolIntAccuracy 0.025
MaxSizeTimestep 0.02
CourantFac 0.15
DesNumNgb 33
MaxNumNgbDeviation 2
ArtBulkViscConst 0.8
InitGasTemp 1000
MinGasTemp 5
SofteningGas  100
SofteningHalo 100
SofteningBndry 100
SofteningGasMaxPhys  100
SofteningHaloMaxPhys 100
SofteningBndryMaxPhys 100
MinGasHsmlFractional 0.1
SinkAccretionRadius {BOX / 16}
"""


def _ics_with_sinks(cfg, n_side, edges):
    """lcdm gas + 3 heavy sinks: slab interior, on a slab face, and on
    the periodic wrap — with nearby gas given infall velocities so the
    accretion criteria (inside, approaching, bound) all pass."""
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=n_side, box=BOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    # gas only (drop the DM block: keeps the test fast and the accretion
    # bookkeeping easy to reason about)
    ngas = n_side ** 3
    pos, vel, mass, ptype, u = (pos[:ngas], vel[:ngas], mass[:ngas],
                                ptype[:ngas], u[:ngas])
    face = float(edges[1])                  # an interior slab boundary
    s_pos = np.array([
        [0.38 * BOX, 0.5 * BOX, 0.5 * BOX],  # slab interior (off faces)
        [face, 0.3 * BOX, 0.6 * BOX],        # on a slab face
        [0.0, 0.7 * BOX, 0.2 * BOX],         # on the periodic wrap
    ], np.float32)
    m_sink = float(np.sum(mass)) * 50.0     # deep potential => bound gas
    s_mass = np.full(3, m_sink, np.float32)
    r_acc = cfg.sink_accretion_radius
    # infall: gas within r_acc of a sink moves toward it
    for sp in s_pos:
        d = pos - sp[None, :]
        d -= BOX * np.round(d / BOX)
        r = np.sqrt(np.sum(d * d, axis=1))
        near = r < 0.9 * r_acc
        vel[near] = (-d[near] / np.maximum(r[near], 1.0)[:, None]) * 50.0
    pos = np.concatenate([pos, s_pos])
    vel = np.concatenate([vel, np.zeros((3, 3), np.float32)])
    mass = np.concatenate([mass, s_mass])
    ptype = np.concatenate([ptype, np.full(3, 5, np.int32)])
    return pos, vel, mass, ptype, u


@pytest.mark.slow
def test_spmd_sink_accretion_matches_single_device():
    n_side = 16
    n_dev = 4
    cfg = parse_parameter_text(PARAM)
    opts = SimOptions(periodic=True, pmgrid=24, gravity_mode="treepm",
                      sph_backend="cells", sinks=True)
    # uniform edges known up front so the ICs can place a sink on a face
    edges = np.linspace(0.0, BOX, n_dev + 1)
    pos, vel, mass, ptype, u = _ics_with_sinks(cfg, n_side, edges)

    sim = Simulation(cfg, opts)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    sim.state = register_sinks_from_types(sim.state)

    mesh = make_mesh(n_dev)
    mw = spmd_min_width(cfg, opts, sim.state.gas.n_gas_max)
    assert float(np.min(np.diff(edges))) >= mw
    spmd_state, (cap_g, cap_r), sedges = to_spmd(sim.state, mesh, cfg,
                                                 edges=edges, min_width=mw)
    # registry keys by PID in the slab layout
    slot_pids = np.asarray(spmd_state.sinks.slot)
    assert np.sum(slot_pids >= 0) == 3
    step = make_spmd_step(cfg, opts, mesh, edges=sedges)(spmd_state)

    ref = sim.state
    got = spmd_state
    for _ in range(2):
        got = step(got)
    for _ in range(2):
        ref = sync_point_step(ref, cfg, opts)

    assert int(got.overflow_flags) == 0

    # accretion actually happened, on every sink
    n_ref = np.asarray(ref.sinks.n_accreted)
    assert np.sum(n_ref) > 0, "test ICs produced no accretion"
    assert np.all(n_ref[np.asarray(ref.sinks.slot) >= 0][:3] > 0)

    # registry tallies agree (ref slots are rows, spmd slots are pids —
    # compare by sink pid)
    ref_slot = np.asarray(ref.sinks.slot)
    ref_pid_of_slot = np.asarray(ref.p.pid)[np.maximum(ref_slot, 0)]
    for k in range(len(slot_pids)):
        if slot_pids[k] < 0:
            continue
        j = int(np.where(ref_pid_of_slot == slot_pids[k])[0][0])
        assert ref_slot[j] >= 0
        np.testing.assert_allclose(
            float(got.sinks.acc_mass[k]), float(ref.sinks.acc_mass[j]),
            rtol=1e-5, err_msg=f"sink pid {slot_pids[k]} acc_mass")
        assert int(got.sinks.n_accreted[k]) == int(ref.sinks.n_accreted[j])

    # same survivors, same sink masses/velocities (match by pid)
    def by_pid(state):
        alive = np.asarray(state.p.alive)
        pid = np.asarray(state.p.pid)[alive]
        order = np.argsort(pid)
        return (pid[order],
                np.asarray(state.p.mass)[alive][order],
                np.asarray(state.p.vel)[alive][order],
                np.asarray(state.p.ptype)[alive][order])

    pid_r, mass_r, vel_r, ptype_r = by_pid(ref)
    pid_g, mass_g, vel_g, ptype_g = by_pid(got)
    np.testing.assert_array_equal(pid_r, pid_g)
    np.testing.assert_array_equal(ptype_r, ptype_g)
    np.testing.assert_allclose(mass_g, mass_r, rtol=1e-5)
    sel = ptype_r == 5
    vscale = max(np.max(np.abs(vel_r[sel])), 1e-30)
    np.testing.assert_allclose(vel_g[sel], vel_r[sel],
                               atol=2e-3 * vscale, rtol=0)

    # total mass (gas + sinks) conserved exactly per layout
    m0 = float(np.sum(mass))
    for st in (ref, got):
        alive = np.asarray(st.p.alive)
        np.testing.assert_allclose(
            float(np.sum(np.asarray(st.p.mass)[alive])), m0, rtol=1e-6)

    # round-trip: canonical layout recovers a row-indexed registry
    canon = spmd_to_canonical(got, cap_g, cap_r)
    cslot = np.asarray(canon.sinks.slot)
    for k in range(len(slot_pids)):
        if slot_pids[k] < 0:
            assert cslot[k] == -1 or cslot[k] >= 0  # unused slots stay -1
            continue
        assert cslot[k] >= 0
        assert int(np.asarray(canon.p.pid)[cslot[k]]) == int(slot_pids[k])
        assert int(np.asarray(canon.p.ptype)[cslot[k]]) == 5
