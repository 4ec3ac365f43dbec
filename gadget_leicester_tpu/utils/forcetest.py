"""Force-accuracy oracle mode — rebuild of [G2: gravtree_forcetest.c ::
gravity_forcetest()] (-DFORCETEST=frac): for a random subset of particles,
compute the exact force by direct summation (Ewald lattice sum when
periodic) alongside the production force, and log relative errors to
``forcetest.txt`` for offline analysis.

This is the reference's primary gravity ground truth (SURVEY.md §4 item 1).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from gadget_leicester_tpu.core.config import SimConfig, SimOptions
from gadget_leicester_tpu.core.state import SimState
from gadget_leicester_tpu.core import timeline
from gadget_leicester_tpu.models.forces import softening_table, comoving_factors
from gadget_leicester_tpu.ops.softening import SOFTFAC


def run_forcetest(state: SimState, cfg: SimConfig, opts: SimOptions,
                  fraction: float | None = None, rng_seed: int = 0,
                  max_subset: int = 512):
    """Return per-particle relative force errors for a random subset.

    Exact force: direct summation with spline softening; periodic boxes use
    the Ewald pair sum [G2: forcetest uses the Ewald correction]. The
    production force is whatever ``state.p.acc`` currently holds (computed
    by the active gravity backend), so this measures the full stack.
    """
    frac = opts.forcetest if fraction is None else fraction
    p = state.p
    alive = np.asarray(p.alive)
    idx_all = np.where(alive)[0]
    rng = np.random.default_rng(rng_seed)
    n_test = max(1, min(int(len(idx_all) * frac), max_subset))
    subset = rng.choice(idx_all, size=n_test, replace=False)

    pos = np.asarray(p.pos, np.float64)
    mass = np.asarray(p.mass, np.float64)
    mass[~alive] = 0.0
    fac = comoving_factors(cfg, state.ti_current)
    eps = np.asarray(softening_table(cfg, fac.atime))
    soft = SOFTFAC * eps[np.asarray(p.ptype)]

    if opts.periodic and cfg.box_size > 0:
        from gadget_leicester_tpu.ops.ewald import ewald_pair_force
        acc_exact = np.zeros((n_test, 3))
        for k, i in enumerate(subset):
            r = pos[i] - pos
            f = ewald_pair_force(r, cfg.box_size, nmax=3, kmax=3)
            f[i] = 0.0
            # softened short-distance correction: replace -r/r^3 by the
            # spline kernel within the softening length
            d = np.linalg.norm(r, axis=1)
            hmax = np.maximum(soft[i], soft)
            near = (d < hmax) & (d > 0)
            if near.any():
                from gadget_leicester_tpu.ops.softening import grav_fac
                g_soft = np.asarray(grav_fac(jnp.asarray(d[near]),
                                             jnp.asarray(hmax[near])))
                f[near] = -r[near] * g_soft[:, None]
            acc_exact[k] = (mass[:, None] * f).sum(axis=0)
    else:
        from gadget_leicester_tpu.ops.softening import grav_fac
        acc_exact = np.zeros((n_test, 3))
        for k, i in enumerate(subset):
            r = pos[i] - pos
            d = np.linalg.norm(r, axis=1)
            hmax = np.maximum(soft[i], soft)
            g = np.asarray(grav_fac(jnp.asarray(d), jnp.asarray(hmax)))
            f = -r * g[:, None]
            f[i] = 0.0
            acc_exact[k] = (mass[:, None] * f).sum(axis=0)

    acc_exact *= cfg.grav_internal
    acc_code = np.asarray(p.acc, np.float64)[subset]
    err = np.linalg.norm(acc_code - acc_exact, axis=1) / np.maximum(
        np.linalg.norm(acc_exact, axis=1), 1e-30)
    return {
        "subset": subset,
        "acc_exact": acc_exact,
        "acc_code": acc_code,
        "rel_err": err,
    }


def exact_periodic_acc(pos, mass, soft, alive, targets, box: float,
                       block: int = 16):
    """Device oracle for large N: accelerations (no G) of the ``targets``
    rows by direct summation over every alive source, minimum image with
    the spline-softened kernel plus the tabulated Ewald correction for the
    other images [G2: gravity_forcetest() with the Ewald correction].
    O(len(targets) * N) — for a subset of a few thousand targets."""
    import jax
    from gadget_leicester_tpu.ops.ewald import (ewald_correction_jnp,
                                                ewald_correction_table)
    from gadget_leicester_tpu.ops.softening import grav_fac
    table = ewald_correction_table()
    src_m = jnp.where(alive, mass, 0.0)
    nt = targets.shape[0]
    pad = -nt % block
    tg = jnp.concatenate([targets, jnp.full((pad,), targets[0])])

    def one(idx):
        dx = pos[idx][:, None, :] - pos[None, :, :]
        dx = dx - box * jnp.round(dx / box)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        h = jnp.maximum(soft[idx][:, None], soft[None, :])
        fac = jnp.where(r > 0, grav_fac(r, h), 0.0)
        acc = -jnp.einsum("bn,bnc->bc", src_m[None, :] * fac, dx,
                          precision=jax.lax.Precision.HIGHEST)
        corr, _ = ewald_correction_jnp(dx, box, table)
        corr = jnp.where((r > 0)[..., None], corr, 0.0)
        return acc + jnp.einsum("n,bnc->bc", src_m, corr,
                                precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(one, tg.reshape(-1, block))
    return out.reshape(-1, 3)[:nt]


def write_forcetest_file(result, state: SimState, cfg: SimConfig,
                         path: str | None = None):
    """forcetest.txt lines [G2: gravity_forcetest() output]:
    type time |pos| f_exact(xyz) f_code(xyz) rel_err"""
    path = path or os.path.join(cfg.output_dir or ".", "forcetest.txt")
    t = float(timeline.ti_to_time(state.ti_current, cfg))
    ptype = np.asarray(state.p.ptype)
    pos = np.asarray(state.p.pos)
    with open(path, "a") as fh:
        for k, i in enumerate(result["subset"]):
            r = np.linalg.norm(pos[i])
            fe, fc = result["acc_exact"][k], result["acc_code"][k]
            fh.write(
                f"{ptype[i]} {t:.6g} {r:.6g} "
                f"{fe[0]:.6g} {fe[1]:.6g} {fe[2]:.6g} "
                f"{fc[0]:.6g} {fc[1]:.6g} {fc[2]:.6g} "
                f"{result['rel_err'][k]:.6g}\n")
