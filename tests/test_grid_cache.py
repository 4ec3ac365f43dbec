"""Stale-tolerant grid cache (models.grids): the cell-assignment cache
must change nothing physical — pair forces read fresh positions, the
displacement margin guards stencil coverage, and the rebuild triggers
fire when they must [G2: domain.c TreeDomainUpdateFrequency — the
reference's own stale-grid cadence]."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from gadget_leicester_tpu.core.config import SimOptions, parse_parameter_text
from gadget_leicester_tpu.core.state import strip_grids
from gadget_leicester_tpu.models.ics import lcdm_gas_ics
from gadget_leicester_tpu.models.simulation import Simulation, sync_point_step

BOX = 50000.0
PARAM = f"""
InitCondFile x
OutputDir  /tmp/grid_cache_test
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
SofteningGasMaxPhys  100
SofteningHaloMaxPhys 100
MinGasHsmlFractional 0.1
"""


def _setup(n_side=12, **opt_kw):
    cfg = parse_parameter_text(PARAM)
    opts = SimOptions(periodic=True, pmgrid=24, gravity_mode="treepm",
                      sph_backend="cells", sph_capacity=64, **opt_kw)
    sim = Simulation(cfg, opts)
    pos, vel, mass, ptype, u = lcdm_gas_ics(
        n_side=n_side, box=BOX, omega0=0.3, omega_b=0.04,
        hubble=cfg.hubble_internal, g=cfg.grav_internal)
    sim.set_ics(pos, vel, mass, ptype, u=u)
    return sim


def test_cached_step_matches_fresh_builds():
    """Trajectories with the persistent cache must match per-step fresh
    builds to f32 rounding (same pair sets while within margin)."""
    sim = _setup()
    cfg, opts = sim.cfg, sim.opts
    a = sim.state
    b = strip_grids(sim.state)
    assert a.grids is not None and a.grids.grav is not None
    for _ in range(8):
        a = sync_point_step(a, cfg, opts)
        b = sync_point_step(b, cfg, opts)
    assert int(a.ti_current) == int(b.ti_current)
    assert float(a.grids.grav_disp) > 0.0
    np.testing.assert_array_equal(np.asarray(a.p.pos), np.asarray(b.p.pos))
    vs = max(float(jnp.max(jnp.abs(b.p.vel))), 1e-30)
    np.testing.assert_allclose(np.asarray(a.p.vel), np.asarray(b.p.vel),
                               atol=2e-5 * vs, rtol=0)
    rs = max(float(jnp.max(b.gas.density)), 1e-30)
    np.testing.assert_allclose(np.asarray(a.gas.density),
                               np.asarray(b.gas.density),
                               atol=2e-5 * rs, rtol=0)


def test_rebuild_triggers_on_margin():
    """Artificially inflating the displacement counter past every margin
    must force a rebuild (counters reset to zero on the next force pass)."""
    sim = _setup()
    cfg, opts = sim.cfg, sim.opts
    st = sync_point_step(sim.state, cfg, opts)
    st = sync_point_step(st, cfg, opts)
    g0 = st.grids
    assert float(g0.grav_disp) > 0.0
    poked = dataclasses.replace(
        st, grids=dataclasses.replace(
            g0, grav_disp=jnp.float32(1e9)))
    after = sync_point_step(poked, cfg, opts)
    # rebuild resets the counter; only the post-step drift remains
    assert float(after.grids.grav_disp) < 1e6
    # and the rebuilt-grid trajectory still matches the cached one
    cont = sync_point_step(st, cfg, opts)
    np.testing.assert_allclose(np.asarray(after.p.pos),
                               np.asarray(cont.p.pos), rtol=0, atol=1e-3)


def test_rebuild_triggers_on_population_change():
    """Killing a particle (accretion analog) must rebuild the grid even
    with zero displacement — the population trigger."""
    sim = _setup()
    cfg, opts = sim.cfg, sim.opts
    st = sync_point_step(sim.state, cfg, opts)
    st = sync_point_step(st, cfg, opts)
    alive = st.p.alive
    ng = st.gas.n_gas_max
    kill = int(np.flatnonzero(np.asarray(alive[:ng]))[0])
    st2 = dataclasses.replace(
        st, p=dataclasses.replace(st.p, alive=alive.at[kill].set(False)))
    after = sync_point_step(st2, cfg, opts)
    assert int(after.grids.grav_count) == int(jnp.sum(st2.p.alive))
    # the killed slot must no longer contribute mass anywhere: total
    # density-weighted checks are implicit; at least its own fields froze
    assert not bool(after.p.alive[kill])


def test_stale_assignments_across_periodic_wrap():
    """A particle that drifts across the periodic wrap while its cell
    assignment is stale must still get correct forces (per-pair minimum
    image in the kernels; models.grids docstring requirement)."""
    from gadget_leicester_tpu.ops.gravity_short import shortrange_gravity_cells
    from gadget_leicester_tpu.ops.neighbors import build_cell_list
    from gadget_leicester_tpu.ops.gravity_direct import direct_gravity

    rng = np.random.RandomState(7)
    n = 256
    box = 100.0
    pos0 = (rng.rand(n, 3) * box).astype(np.float32)
    # cluster some particles tight against the x=0 face so the wrap matters
    pos0[:32, 0] = rng.rand(32) * 0.5
    mass = np.ones(n, np.float32)
    soft = np.full(n, 0.5, np.float32)
    alive = np.ones(n, bool)
    pmgrid = 8
    asmth = 1.25 * box / pmgrid
    rcut = 4.5 * asmth
    n_cells = 3
    cl = build_cell_list(jnp.asarray(pos0), jnp.asarray(alive), 0.0, box,
                         n_cells=n_cells, capacity=192, periodic=True)
    # drift the face particles BACKWARD across the wrap (x -> box - eps),
    # keeping the stale assignment (cell 0 in x)
    pos1 = pos0.copy()
    pos1[:32, 0] = np.mod(pos1[:32, 0] - 0.4, box)
    acc = shortrange_gravity_cells(
        cl, jnp.asarray(pos1), jnp.asarray(mass), jnp.asarray(soft),
        jnp.asarray(alive), asmth, rcut, box=box, periodic=True)
    # oracle: truncated direct sum at the TRUE positions
    from gadget_leicester_tpu.ops.gravity_direct import shortrange_trunc
    from gadget_leicester_tpu.ops.softening import grav_fac
    p = jnp.asarray(pos1)
    d = p[:, None, :] - p[None, :, :]
    d = d - box * jnp.round(d / box)
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    h = jnp.maximum(jnp.asarray(soft)[:, None], jnp.asarray(soft)[None, :])
    fac = grav_fac(r, h) * shortrange_trunc(r, asmth)
    fac = jnp.where((r < rcut) & (r > 0), fac, 0.0)
    ref = -jnp.einsum("ij,ijd->id", fac * mass[None, :], d)
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(ref),
                               atol=1e-5 * scale, rtol=0)
