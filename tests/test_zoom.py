"""PLACEHIGHRESREGION two-mesh zoom gravity vs the direct-summation
oracle (VERDICT r1 item 6: rms force error < 1% in the high-res region).
[G2: pm_nonperiodic.c with PLACEHIGHRESREGION]"""

import numpy as np
import jax.numpy as jnp

from gadget_leicester_tpu.core.config import SimOptions, parse_parameter_text
from gadget_leicester_tpu.core.state import from_arrays
from gadget_leicester_tpu.models.forces import compute_forces
from gadget_leicester_tpu.ops.gravity_direct import direct_gravity


def _zoom_setup(rng):
    """A Plummer-ish high-res clump (type 1) inside a sparse coarse
    background (type 2, heavier particles) — the zoom-simulation shape."""
    n_hr, n_bg = 3000, 500
    # HR clump of radius ~30 centred in a 1000^3 region
    r = 30.0 * rng.power(1.5, n_hr) ** (1 / 3)
    u = rng.normal(size=(n_hr, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
    pos_hr = 500.0 + r[:, None] * u
    pos_bg = rng.uniform(0.0, 1000.0, (n_bg, 3))
    pos = np.concatenate([pos_hr, pos_bg]).astype(np.float32)
    mass = np.concatenate([np.full(n_hr, 1.0), np.full(n_bg, 50.0)])
    ptype = np.concatenate([np.full(n_hr, 1), np.full(n_bg, 2)])
    vel = np.zeros_like(pos)
    return pos, vel, mass.astype(np.float32), ptype.astype(np.int32), n_hr


def test_zoom_gravity_vs_direct(rng):
    pos, vel, mass, ptype, n_hr = _zoom_setup(rng)
    param = """
InitCondFile x
OutputDir /tmp/zoom
TimeBegin 0
TimeMax 1
ComovingIntegrationOn 0
PeriodicBoundariesOn 0
SofteningGas 0.5
SofteningHalo 0.5
SofteningDisk 20
"""
    cfg = parse_parameter_text(param)
    opts = SimOptions(periodic=False, pmgrid=32, hr_pmgrid=32, hr_types=0b10,
                      gravity_mode="zoom")
    state = from_arrays(pos, vel, mass, ptype,
                        np.arange(len(mass)), opts)
    state = compute_forces(state, cfg, opts, do_sph=False)

    from gadget_leicester_tpu.models.forces import softening_table
    from gadget_leicester_tpu.ops.softening import SOFTFAC
    soft = SOFTFAC * softening_table(cfg)[state.p.ptype]
    acc_d, pot_d = direct_gravity(state.p.pos, state.p.mass, soft,
                                  state.p.alive, periodic=False)
    g = cfg.grav_internal
    acc_ref = np.asarray(acc_d) * g
    acc_got = np.asarray(state.p.acc + state.p.acc_pm)
    alive = np.asarray(state.p.alive)
    is_hr = alive & (np.asarray(state.p.ptype) == 1)

    num = np.sum((acc_got - acc_ref) ** 2, axis=1)
    den = np.maximum(np.sum(acc_ref**2, axis=1), 1e-30)
    rel = np.sqrt(num / den)
    rms_hr = np.sqrt(np.mean(rel[is_hr] ** 2))
    assert rms_hr < 0.01, f"HR rms force error {rms_hr:.4f}"
    rms_all = np.sqrt(np.mean(rel[alive] ** 2))
    assert rms_all < 0.02, f"global rms force error {rms_all:.4f}"

    # potential parity (zoom pot = PM + both SR passes)
    pot_ref = np.asarray(pot_d) * g
    pot_got = np.asarray(state.p.pot)
    perr = np.abs(pot_got - pot_ref) / np.maximum(np.abs(pot_ref), 1e-30)
    assert np.sqrt(np.mean(perr[is_hr] ** 2)) < 0.02
