"""Force-computation orchestrator — rebuild of [G2: accel.c ::
compute_accelerations()] plus the per-force comoving factor plumbing from
[G2: gravtree.c, hydra.c].

Fixed order, as in the reference: long-range PM (PM steps only) ->
short-range/tree gravity -> SPH density (adaptive h) -> SPH hydro force.

Gravity backend selection is static (SimOptions/GravityMode): "direct"
(all-pairs oracle & small-N path), "tree" (Barnes-Hut), "treepm"
(tree short-range + FFT long-range). All backends return acceleration
WITHOUT the G factor; it is applied once here [G2: gravtree.c applies
All.G at the end].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.core.config import GAMMA, SimConfig, SimOptions
from gadget_leicester_tpu.core.cosmology import hubble_function
from gadget_leicester_tpu.core.state import SimState
from gadget_leicester_tpu.models.grids import resolve_sph_backend
from gadget_leicester_tpu.ops.gravity_direct import direct_gravity
from gadget_leicester_tpu.ops.sph_dense import density_adaptive, hydro_force
from gadget_leicester_tpu.ops.softening import SOFTFAC

# f32 pair sums: no TF32 on GPU tensor cores
HIGHEST = jax.lax.Precision.HIGHEST


class ComovingFactors(NamedTuple):
    """All a(t)-dependent factors used by one force pass [G2: hydra.c head]."""

    atime: jnp.ndarray        # a (1 for physical)
    hubble_a: jnp.ndarray     # H(a) (1 for physical)
    hubble_a2_flow: jnp.ndarray  # a^2 H for the pairwise Hubble-flow term (0 physical)
    hubble_a2_norm: jnp.ndarray  # a^2 H for DtEntropy normalisation (1 physical)
    fac_mu: jnp.ndarray       # a^{3(gamma-1)/2 - 1} (1 physical)
    a3inv: jnp.ndarray        # 1/a^3 (1 physical)


def comoving_factors(cfg: SimConfig, ti_current) -> ComovingFactors:
    one = jnp.asarray(1.0)
    if not cfg.comoving_integration_on:
        z = jnp.asarray(0.0)
        return ComovingFactors(one, one, z, one, one, one)
    a = cfg.time_begin * jnp.exp(ti_current * cfg.timebase_interval)
    h_a = hubble_function(a, cfg.omega0, cfg.omega_lambda, cfg.hubble_internal)
    ha2 = a * a * h_a
    fac_mu = a ** (3.0 * (GAMMA - 1.0) / 2.0) / a
    return ComovingFactors(a, h_a, ha2, ha2, fac_mu, 1.0 / a**3)


def softening_table(cfg: SimConfig, atime: float | jnp.ndarray = 1.0):
    """Per-type Plummer softening, with comoving->physical capping
    [G2: gravtree.c :: set_softenings()]: in comoving runs the physical
    softening eps_phys = a * eps_com is capped at SofteningMaxPhys, i.e.
    the comoving table entry becomes min(eps_com, maxphys/a).

    Built by stacking SCALAR entries (python-level branch on maxphys>0):
    scalars inline into the HLO (see core/cosmology._GL note)."""
    vals = []
    for e, mp in zip(cfg.softenings, cfg.softenings_max_phys):
        if cfg.comoving_integration_on and mp > 0:
            vals.append(jnp.minimum(jnp.float32(e), mp / atime))
        else:
            vals.append(jnp.float32(e) * jnp.ones(()))
    return jnp.stack([jnp.asarray(v, jnp.float32).reshape(()) for v in vals])


def gather_gas(state: SimState):
    """Views of the gas block (slots [0, n_gas_max)) of particle arrays."""
    ng = state.gas.n_gas_max
    p = state.p
    gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
    return p.pos[:ng], p.mass[:ng], gas_mask


def compute_forces(
    state: SimState,
    cfg: SimConfig,
    opts: SimOptions,
    do_sph: bool = True,
    do_pm=None,
) -> SimState:
    """One full force computation at the current sync point.

    Updates: p.acc (short-range/tree), p.acc_pm (long-range, only when
    `do_pm` — a traced bool — is true; frozen otherwise, the PM-step
    machinery of [G2: timestep.c]), p.pot, and the SPH gas fields.
    do_pm=None means "always" (init / non-split callers).
    """
    p = state.p
    fac = comoving_factors(cfg, state.ti_current)

    # the active set [G2: timestep.c ti_endstep == All.Ti_Current]: only
    # these particles receive fresh forces this sync point; the rest keep
    # their frozen acc (used by vel_pred drifts) — the pair kernel skips
    # cells that hold no active particle.
    active = (p.ti_endstep == state.ti_current) & p.alive

    # ----- gravity ------------------------------------------------------
    mode = opts.gravity_mode
    if mode == "auto":
        if opts.periodic:
            # periodic + PMGRID -> TreePM; periodic without PM -> the
            # Ewald-corrected tree [G2: PERIODIC without PMGRID]
            mode = "treepm" if opts.pmgrid > 0 else "tree"
        else:
            mode = "direct" if p.n_max <= opts.direct_threshold else "tree"

    if not opts.nogravity:
        eps = softening_table(cfg, fac.atime)
        soft = SOFTFAC * eps[p.ptype]  # force softening h = 2.8 eps
        if opts.adaptive_gravsoft_forgas and state.gas.n_gas_max > 1:
            # gas gravitational softening follows the SPH smoothing length
            # [G2: ADAPTIVE_GRAVSOFT_FORGAS]
            ng_ = state.gas.n_gas_max
            gas_soft = jnp.maximum(state.gas.hsml, SOFTFAC * eps[0])
            soft = soft.at[:ng_].set(
                jnp.where(p.ptype[:ng_] == 0, gas_soft, soft[:ng_]))
        acc_pm = state.p.acc_pm
        pot_pm = jnp.zeros_like(p.pot)
        if mode == "treepm":
            with jax.named_scope("gravity"):
                acc, pot, pot_pm, sr_ovf, acc_pm, new_grids = _treepm_gravity(
                    state, cfg, opts, soft, do_pm, active)
            state = dataclasses.replace(
                state, grids=new_grids,
                overflow_flags=state.overflow_flags
                | jnp.where(sr_ovf, jnp.int32(1), jnp.int32(0)))
        elif mode == "zoom":
            acc, pot, acc_pm, z_ovf = _zoom_gravity(state, cfg, opts, soft)
            state = dataclasses.replace(
                state, overflow_flags=state.overflow_flags
                | jnp.where(z_ovf, jnp.int32(1), jnp.int32(0)))
        elif mode == "tree":
            acc, pot = _tree_gravity(state, cfg, opts, soft)
            acc_pm = jnp.zeros_like(acc)
        else:
            acc, pot = direct_gravity(
                p.pos, p.mass, soft, p.alive,
                box=cfg.box_size,
                periodic=opts.periodic,
            )
            acc_pm = jnp.zeros_like(acc)
        acc = acc * cfg.grav_internal
        pot = pot * cfg.grav_internal
        pot_pm = pot_pm * cfg.grav_internal
        if mode == "treepm" and (opts.sinks or opts.cooling == "stamatellos"):
            # the SR potential row is cell-gated like the force: inactive
            # particles keep their last full potential [G2: P.Potential is
            # refreshed when the particle is active]
            pot = jnp.where(active, pot, p.pot)
        if cfg.comoving_integration_on and not opts.periodic:
            # vacuum-boundary comoving runs need the homogeneous-background
            # correction term [G2: gravtree.c comoving correction]:
            # acc += Omega0 H0^2 / 2 * a^... * pos  (background subtraction)
            corr = 0.5 * cfg.omega0 * cfg.hubble_internal**2
            acc = acc + corr * p.pos
        # short-range acc updates only for ACTIVE particles [G2: gravtree.c
        # walks the active list]; inactive keep the frozen value (which the
        # kernel's skipped cells never computed)
        acc = jnp.where(active[:, None], acc, p.acc)
        acc = jnp.where(p.alive[:, None], acc, 0.0)
        acc_pm = jnp.where(p.alive[:, None], acc_pm, 0.0)
    else:
        acc = jnp.zeros_like(p.acc)
        acc_pm = jnp.zeros_like(p.acc)
        pot = jnp.zeros_like(p.pot)
        pot_pm = jnp.zeros_like(p.pot)

    total = acc + acc_pm
    old_acc = jnp.sqrt(jnp.sum(total * total, axis=-1))
    p = dataclasses.replace(p, acc=acc, acc_pm=acc_pm, pot=pot,
                            pot_pm=pot_pm, old_acc=old_acc)
    state = dataclasses.replace(state, p=p)

    # ----- SPH ----------------------------------------------------------
    if do_sph and state.gas.n_gas_max > 1:
        with jax.named_scope("sph"):
            state = compute_sph(state, cfg, opts, fac,
                                active[:state.gas.n_gas_max])
    return state


def _treepm_gravity(state: SimState, cfg: SimConfig, opts: SimOptions,
                    soft, do_pm=None, active=None):
    """TreePM: FFT PM long-range + cell-list erfc short-range
    [G2: pm_periodic.c + forcetree.c shortrange]. The PM part recomputes
    only when `do_pm` (PM steps); otherwise the frozen state.p.acc_pm is
    returned unchanged. Returns (acc_sr, pot, overflow, acc_pm, grids)
    with acc_pm ALREADY scaled by G (it is stored in state); ``grids`` is
    the updated cache (the cell grid is reused across sync points and
    rebuilt on the displacement cadence — models.grids)."""
    from gadget_leicester_tpu.models.grids import grav_grid_geometry, refresh
    from gadget_leicester_tpu.ops.cell_pairs import pair_backend
    from gadget_leicester_tpu.ops.gravity_short import shortrange_gravity_cells
    from gadget_leicester_tpu.ops.neighbors import build_cell_list
    from gadget_leicester_tpu.ops.pm import ASMTH, RCUT, pm_forces_periodic

    p = state.p
    box = cfg.box_size
    g = opts.pmgrid
    asmth_len = ASMTH * box / g
    rcut = RCUT * asmth_len
    # grid + staleness margin + capacity (shared with the cache allocator)
    n_cells, cap, margin = grav_grid_geometry(cfg, opts, p.n_max)

    def build():
        return build_cell_list(p.pos, p.alive, 0.0, box, n_cells=n_cells,
                               capacity=cap, periodic=True)

    grids = state.grids
    with jax.named_scope("sr_grid"):
        if grids is not None and grids.grav is not None:
            count_now = jnp.sum(p.alive).astype(jnp.int32)
            cl, gv, gd, gc, _ = refresh(
                grids.grav, grids.grav_valid, grids.grav_disp,
                grids.grav_count, margin, count_now, build)
            grids = dataclasses.replace(grids, grav=cl, grav_valid=gv,
                                        grav_disp=gd, grav_count=gc)
        else:
            cl = build()

    # the in-step potential is needed only by sink creation and the
    # Stamatellos cooling column estimate; otherwise diagnostics get the
    # FULL potential on demand from compute_potential() [G2: potential.c]
    # and the PM pass skips the 4th gather component. When needed, the
    # SHORT-RANGE part is recomputed fresh EVERY sync point; only the
    # smooth PM piece stays frozen between PM steps — so periodic
    # sink/cooling runs see the true potential minimum, not a stale
    # smoothed one.
    with_pot = opts.sinks or opts.cooling == "stamatellos"
    with jax.named_scope("sr_pairs"):
        res = shortrange_gravity_cells(
            cl, p.pos, p.mass, soft, p.alive, asmth_len, rcut, box=box,
            periodic=True, with_potential=with_pot,
            backend=pair_backend(dtype=opts.dtype), targets=active)
    acc_sr, pot_sr = res if with_pot else (res, None)
    overflow = cl.overflow

    def compute_pm(_):
        with jax.named_scope("pm"):
            if with_pot:
                a, pt = pm_forces_periodic(p.pos, p.mass, p.alive, box, g,
                                           with_potential=True)
            else:
                a = pm_forces_periodic(p.pos, p.mass, p.alive, box, g)
                pt = jnp.zeros(p.n_max, a.dtype)
            return a * cfg.grav_internal, pt

    if do_pm is None:
        acc_pm, pot_pm = compute_pm(None)
    else:
        acc_pm, pot_pm = jax.lax.cond(
            do_pm, compute_pm,
            lambda _: (state.p.acc_pm,
                       state.p.pot_pm
                       / jnp.maximum(cfg.grav_internal, 1e-37)),
            operand=None)
    if with_pot:
        # PM self-energy removal as in compute_potential
        pot = pot_pm + pot_sr + p.mass / (jnp.sqrt(jnp.pi) * asmth_len)
    else:
        pot = pot_pm
    return acc_sr, pot, pot_pm, overflow, acc_pm, grids


def compute_potential(state: SimState, cfg: SimConfig,
                      opts: SimOptions) -> SimState:
    """On-demand FULL gravitational potential for every particle —
    rebuild of [G2: potential.c :: compute_potential()], which the
    reference likewise runs only when diagnostics or snapshots need it.

    TreePM: PM mesh potential + erfc-truncated softened short-range sum
    (the in-step p.pot carries only the PM part). Tree/direct backends
    already produce the full potential; this recomputes it at the
    current positions."""
    p = state.p
    fac = comoving_factors(cfg, state.ti_current)
    if opts.nogravity:
        return state
    eps = softening_table(cfg, fac.atime)
    soft = SOFTFAC * eps[p.ptype]
    if opts.adaptive_gravsoft_forgas and state.gas.n_gas_max > 1:
        ng_ = state.gas.n_gas_max
        gas_soft = jnp.maximum(state.gas.hsml, SOFTFAC * eps[0])
        soft = soft.at[:ng_].set(
            jnp.where(p.ptype[:ng_] == 0, gas_soft, soft[:ng_]))

    mode = opts.gravity_mode
    if mode == "auto":
        if opts.periodic:
            mode = "treepm" if opts.pmgrid > 0 else "tree"
        else:
            mode = "direct" if p.n_max <= opts.direct_threshold else "tree"

    if mode == "treepm":
        from gadget_leicester_tpu.ops.pm import (ASMTH, RCUT,
                                                 pm_potential_periodic)
        box = cfg.box_size
        g = opts.pmgrid
        asmth_len = ASMTH * box / g
        rcut = RCUT * asmth_len
        pot_pm = pm_potential_periodic(p.pos, p.mass, p.alive, box, g)
        from gadget_leicester_tpu.models.grids import grav_grid_geometry
        from gadget_leicester_tpu.ops.cell_pairs import pair_backend
        from gadget_leicester_tpu.ops.gravity_short import \
            shortrange_gravity_cells
        from gadget_leicester_tpu.ops.neighbors import build_cell_list
        n_cells, cap, _ = grav_grid_geometry(cfg, opts, p.n_max)
        cl = build_cell_list(p.pos, p.alive, 0.0, box, n_cells=n_cells,
                             capacity=cap, periodic=True)
        _, pot_sr = shortrange_gravity_cells(
            cl, p.pos, p.mass, soft, p.alive, asmth_len, rcut, box=box,
            periodic=True, with_potential=True,
            backend=pair_backend(dtype=opts.dtype))
        sr_ovf = cl.overflow
        # an over-capacity grid truncates the potential feeding the energy
        # diagnostics — surface it like the force passes do
        state = dataclasses.replace(
            state, overflow_flags=state.overflow_flags
            | jnp.where(sr_ovf, jnp.int32(1), jnp.int32(0)))
        # remove the PM self-term: the mesh potential includes each
        # particle's own smoothed cloud, phi_self = -m/(sqrt(pi) asmth)
        # [G2: potential.c PM self-energy correction]
        pot = pot_pm + pot_sr + p.mass / (jnp.sqrt(jnp.pi) * asmth_len)
    elif mode == "zoom":
        _, pot, _, z_ovf = _zoom_gravity(state, cfg, opts, soft)
        state = dataclasses.replace(
            state, overflow_flags=state.overflow_flags
            | jnp.where(z_ovf, jnp.int32(1), jnp.int32(0)))
    elif mode == "tree":
        _, pot = _tree_gravity(state, cfg, opts, soft)
    else:
        _, pot = direct_gravity(p.pos, p.mass, soft, p.alive,
                                box=cfg.box_size, periodic=opts.periodic)
    pot = pot * cfg.grav_internal
    pot = jnp.where(p.alive, pot, 0.0)
    return dataclasses.replace(
        state, p=dataclasses.replace(p, pot=pot))


def _tree_gravity(state: SimState, cfg: SimConfig, opts: SimOptions, soft):
    """Barnes-Hut tree gravity — vacuum, or periodic-without-PM with the
    tabulated Ewald correction [G2: force_treeevaluate_ewald_correction]."""
    from gadget_leicester_tpu.ops.tree import tree_gravity
    p = state.p
    return tree_gravity(
        p.pos, p.mass, soft, p.alive,
        theta=cfg.err_tol_theta,
        opening=cfg.type_of_opening_criterion,
        err_tol_force_acc=cfg.err_tol_force_acc,
        old_acc=p.old_acc / jnp.maximum(cfg.grav_internal, 1e-37),
        depth=opts.tree_depth,
        periodic=opts.periodic,
        box=float(cfg.box_size),
    )


def _zoom_gravity(state: SimState, cfg: SimConfig, opts: SimOptions, soft):
    """PLACEHIGHRESREGION two-mesh zoom gravity for vacuum boundaries —
    rebuild of [G2: pm_nonperiodic.c with PLACEHIGHRESREGION; forcetree.c
    short-range with per-region truncation]:

      * COARSE vacuum PM over the bounding box of all alive particles
        (smoothing a_c = 1.25 coarse cells);
      * FINE band-pass mesh (erf(a_h) - erf(a_c)) over the auto-fitted
        bounding box of the opts.hr_types particle types;
      * short-range pass A: all particles, erfc(a_c) cut at rcut_c,
        EXCLUDING pairs with both ends in the HR region;
      * short-range pass B: HR-region particles only, erfc(a_h)/rcut_h.

    Pair (i,j) both-HR: B + fine + coarse = exact. Any other pair:
    A + coarse = exact. Region boxes are traced (re-fitted every force
    pass, exactly the reference's behaviour). Returns (acc_sr, pot,
    acc_pm_scaled, overflow)."""
    from gadget_leicester_tpu.ops.gravity_direct import (shortrange_trunc,
                                                         shortrange_trunc_pot)
    from gadget_leicester_tpu.ops.neighbors import (apply_pairwise,
                                                    build_cell_list)
    from gadget_leicester_tpu.ops.pm import (ASMTH, RCUT, pm_forces_diff,
                                             pm_forces_nonperiodic)
    from gadget_leicester_tpu.ops.softening import grav_fac, grav_pot

    p = state.p
    n_c = opts.pmgrid
    n_h = opts.hr_pmgrid if opts.hr_pmgrid > 0 else opts.pmgrid
    f = p.pos.dtype

    # coarse region: bounding cube of everything alive (1% pad)
    lo = jnp.min(jnp.where(p.alive[:, None], p.pos, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(p.alive[:, None], p.pos, -jnp.inf), axis=0)
    pad = 0.01 * jnp.max(hi - lo) + 1e-6
    origin_c = lo - pad
    extent_c = jnp.max(hi - lo) + 2 * pad
    asmth_c = ASMTH * extent_c / n_c
    rcut_c = RCUT * asmth_c

    # HR region: bounding cube of the flagged types (padded)
    hr_sel = p.alive & ((opts.hr_types >> jnp.clip(p.ptype, 0, 5)) & 1 == 1)
    lo_h = jnp.min(jnp.where(hr_sel[:, None], p.pos, jnp.inf), axis=0)
    hi_h = jnp.max(jnp.where(hr_sel[:, None], p.pos, -jnp.inf), axis=0)
    pad_h = 0.05 * jnp.max(hi_h - lo_h) + 1e-6
    origin_h = lo_h - pad_h
    extent_h = jnp.max(hi_h - lo_h) + 2 * pad_h
    asmth_h = ASMTH * extent_h / n_h
    rcut_h = RCUT * asmth_h

    acc_c, pot_c = pm_forces_nonperiodic(
        p.pos, p.mass, p.alive, origin_c, extent_c, n_c,
        with_potential=True)
    acc_f, pot_f, in_hr = pm_forces_diff(
        p.pos, p.mass, p.alive, origin_h, extent_h, n_h, asmth_c,
        with_potential=True)
    acc_pm = (acc_c + acc_f) * cfg.grav_internal
    pot_pm = pot_c + pot_f

    src_mass = jnp.where(p.alive, p.mass, 0.0)
    in_hr_f = in_hr.astype(f)

    def sr_pass(cl, rcut, asmth, exclude_hr_pairs, hr_only):
        def pair_fn(idx, tp, cand):
            ts = soft[idx]
            valid = cand >= 0
            ci = jnp.maximum(cand, 0)
            sp = p.pos[ci]
            sm = jnp.where(valid, src_mass[ci], 0.0)
            if hr_only:
                sm = sm * in_hr_f[ci]
            dx = tp[:, None, :] - sp
            r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
            h = jnp.maximum(ts[:, None], soft[ci])
            fac = grav_fac(r, h) * shortrange_trunc(r, asmth)
            fac = jnp.where(r < rcut, fac, 0.0)
            pw = grav_pot(r, h) * shortrange_trunc_pot(r, asmth)
            pw = jnp.where((r < rcut) & (r > 0), pw, 0.0)
            if exclude_hr_pairs:
                both = in_hr_f[idx][:, None] * in_hr_f[ci]
                fac = fac * (1.0 - both)
                pw = pw * (1.0 - both)
            w = sm * fac
            return (-jnp.einsum("bc,bcd->bd", w, dx, precision=HIGHEST),
                    jnp.sum(sm * pw, axis=-1))

        return apply_pairwise(cl, p.pos, pair_fn, block=256)

    n_cells_c = max(3, int(n_c / (RCUT * ASMTH)))
    cap_c = opts.sr_capacity if opts.sr_capacity > 0 else max(
        64, -(-4 * p.n_max // n_cells_c**3 // 8) * 8)
    cl_c = build_cell_list(p.pos, p.alive, origin_c, extent_c,
                           n_cells=n_cells_c, capacity=cap_c,
                           periodic=False)
    acc_a, pot_a = sr_pass(cl_c, rcut_c, asmth_c,
                           exclude_hr_pairs=True, hr_only=False)

    n_cells_h = max(3, int(n_h / (RCUT * ASMTH)))
    cap_h = opts.sr_capacity if opts.sr_capacity > 0 else max(
        64, -(-4 * p.n_max // n_cells_h**3 // 8) * 8)
    cl_h = build_cell_list(p.pos, p.alive & in_hr, origin_h, extent_h,
                           n_cells=n_cells_h, capacity=cap_h,
                           periodic=False)
    acc_b, pot_b = sr_pass(cl_h, rcut_h, asmth_h,
                           exclude_hr_pairs=False, hr_only=True)
    acc_b = jnp.where(in_hr[:, None], acc_b, 0.0)
    pot_b = jnp.where(in_hr, pot_b, 0.0)

    acc_sr = acc_a + acc_b
    # PM self-energy corrections [G2: potential.c]: each mesh includes the
    # particle's own smoothed cloud — the coarse vacuum mesh contributes
    # -m/(sqrt(pi) a_c) for everyone, the band-pass fine mesh an extra
    # -m (1/a_h - 1/a_c)/sqrt(pi) for in-region particles
    self_c = p.mass / (jnp.sqrt(jnp.pi) * asmth_c)
    self_h = p.mass * (1.0 / asmth_h - 1.0 / asmth_c) / jnp.sqrt(jnp.pi)
    pot = pot_pm + pot_a + pot_b + self_c + jnp.where(in_hr, self_h, 0.0)
    return acc_sr, pot, jnp.where(p.alive[:, None], acc_pm, 0.0), \
        cl_c.overflow | cl_h.overflow


def compute_sph(state: SimState, cfg: SimConfig, opts: SimOptions,
                fac: ComovingFactors, active=None) -> SimState:
    """density() -> hydro_force() [G2: accel.c ordering].

    ``active`` (bool [n_gas_max], None = all): SPH fields recompute only
    for active gas; inactive keep their drift-predicted values as both
    stored state and pair-source terms [G2: density.c/hydra.c walk the
    active list; predict.c supplies the inactive side]."""
    gas = state.gas
    pos_g, mass_g, gas_mask = gather_gas(state)
    if active is None:
        active = jnp.ones_like(gas_mask)
    active_g = active & gas_mask
    eps_gas = softening_table(cfg, fac.atime)[0]
    min_hsml = cfg.min_gas_hsml_fractional * SOFTFAC * eps_gas

    backend = resolve_sph_backend(opts, gas.n_gas_max)
    if backend == "cells":
        from gadget_leicester_tpu.models.grids import sph_cells_geometry
        from gadget_leicester_tpu.ops.cell_pairs import pair_backend
        from gadget_leicester_tpu.ops.neighbors import build_cell_list
        from gadget_leicester_tpu.ops.sph_cells import (
            density_adaptive_cells, hydro_force_cells)
        pairs = pair_backend(dtype=opts.dtype)
        if opts.periodic:
            origin = jnp.zeros(3, pos_g.dtype)
            extent = jnp.full((3,), cfg.box_size, pos_g.dtype)
        else:
            lo = jnp.min(jnp.where(gas_mask[:, None], pos_g, jnp.inf), axis=0)
            hi = jnp.max(jnp.where(gas_mask[:, None], pos_g, -jnp.inf), axis=0)
            pad = 0.01 * (hi - lo) + 1e-6
            origin, extent = lo - pad, (hi - lo) + 2 * pad
        # h is CAPPED at the cell edge (max_hsml) — the void-h compromise,
        # SURVEY.md §7 hard part 2
        n_cells, cap = sph_cells_geometry(cfg, opts, gas.n_gas_max)
        cl = build_cell_list(pos_g, gas_mask, origin, extent,
                             n_cells=n_cells, capacity=cap,
                             periodic=opts.periodic)
        max_hsml = jnp.min(extent) / n_cells
        with jax.named_scope("density"):
            dres = density_adaptive_cells(
                cl, pos_g, gas.vel_pred, mass_g,
                jnp.minimum(gas.hsml, max_hsml), gas_mask,
                des_num_ngb=cfg.des_num_ngb,
                max_dev=cfg.max_num_ngb_deviation,
                min_hsml=min_hsml, max_hsml=max_hsml,
                box=cfg.box_size, periodic=opts.periodic,
                backend=pairs, targets=active_g,
            )
    else:
        dres = density_adaptive(
            pos_g, gas.vel_pred, mass_g, gas.hsml, gas_mask,
            des_num_ngb=cfg.des_num_ngb,
            max_dev=cfg.max_num_ngb_deviation,
            min_hsml=min_hsml,
            box=cfg.box_size,
            periodic=opts.periodic,
        )
    # merge: active gas takes the fresh solve; inactive keeps the
    # drift-forecast fields [G2: predict.c drift_particle] so pair sources
    # and stored state stay the frozen-step values. A particle DROPPED by
    # an over-capacity cell comes back with rho==0 — keep its forecast
    # instead of poisoning downstream physics (the entropy floor divides
    # by rho^(gamma-1)); the overflow flag tells the host to re-run with
    # bigger capacity [G2: the realloc-on-overflow bunching of gravtree.c].
    take = active_g & (dres.rho > 0)
    dres = dres._replace(
        rho=jnp.where(take, dres.rho, gas.density),
        hsml=jnp.where(take, dres.hsml, gas.hsml),
        dhsml_factor=jnp.where(take, dres.dhsml_factor,
                               gas.dhsml_density_factor),
        div_vel=jnp.where(take, dres.div_vel, gas.div_vel),
        curl_vel=jnp.where(take, dres.curl_vel, gas.curl_vel),
        num_ngb_eff=jnp.where(take, dres.num_ngb_eff, gas.num_ngb),
    )

    # entropy-form pressure P = A_pred rho^gamma [G2: density.c tail]
    if opts.isotherm_eqs:
        # isothermal EOS: P = c_s^2 rho, entropy slot stores c_s^2
        pressure = gas.entropy_pred * dres.rho
    else:
        pressure = gas.entropy_pred * dres.rho**GAMMA
    pressure = jnp.where(gas_mask, pressure, 0.0)

    hydro_kw = dict(
        visc_const=cfg.art_bulk_visc_const,
        box=cfg.box_size,
        periodic=opts.periodic,
        hubble_a2_flow=fac.hubble_a2_flow,
        hubble_a2_norm=fac.hubble_a2_norm,
        fac_mu=fac.fac_mu,
    )
    if backend == "cells":
        with jax.named_scope("hydro"):
            hres = hydro_force_cells(
                cl, pos_g, gas.vel_pred, mass_g, dres.hsml, dres.rho,
                pressure, dres.dhsml_factor, dres.div_vel, dres.curl_vel,
                gas_mask, backend=pairs, targets=active_g, **hydro_kw)
    else:
        hres = hydro_force(
            pos_g, gas.vel_pred, mass_g, dres.hsml, dres.rho, pressure,
            dres.dhsml_factor, dres.div_vel, dres.curl_vel, gas_mask,
            **hydro_kw)
    # hydro outputs update only active gas (skipped cells returned zeros);
    # cell-dropped particles (take==False) keep their frozen values too
    hydro_acc = jnp.where(take[:, None], hres.acc, gas.hydro_acc)
    dt_entropy = jnp.where(take, hres.dt_entropy, gas.dt_entropy)
    max_signal_vel = jnp.where(take, hres.max_signal_vel,
                               gas.max_signal_vel)
    if opts.isotherm_eqs:
        dt_entropy = jnp.zeros_like(dt_entropy)  # entropy fixed (isothermal)

    if backend == "cells":
        state = dataclasses.replace(
            state, overflow_flags=state.overflow_flags
            | jnp.where(cl.overflow, jnp.int32(2), jnp.int32(0)))

    gas = dataclasses.replace(
        gas,
        density=dres.rho,
        hsml=dres.hsml,
        pressure=pressure,
        div_vel=dres.div_vel,
        curl_vel=dres.curl_vel,
        dhsml_density_factor=dres.dhsml_factor,
        num_ngb=dres.num_ngb_eff,
        hydro_acc=hydro_acc,
        dt_entropy=dt_entropy,
        max_signal_vel=max_signal_vel,
    )
    return dataclasses.replace(state, gas=gas)
