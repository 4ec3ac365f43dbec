"""Cell-list SPH density + hydro-force sweeps — the large-N production path.

Same per-pair math as ``ops.sph_dense`` (the all-pairs oracle), but sources
come from the 27-cell stencil of a :class:`~.neighbors.CellList` instead of
the full O(N^2) product. Requirements:

* density (gather, radius h_i):  cell_size >= max h over gas
* hydro (symmetric, max(h_i,h_j)): cell_size >= max h over gas

The adaptive-h loop caps h at the cell size; the caller watches the cap /
overflow flags and rebuilds with larger cells (recompute-bigger fallback,
SURVEY.md §5).

``backend="xla"`` evaluates the sums as blocked gathers (the plain
reference); ``backend="triton"`` runs the ops.cell_pairs kernel on the same
cell list (power-of-two capacity). ``targets`` (bool, None = all gas)
restricts which rows are solved; the kernel skips cells without one.
``interpret`` runs the kernel in the Pallas interpreter (CPU tests).
"""

from __future__ import annotations

from functools import partial

from gadget_leicester_tpu.ops.jit_util import hybrid_jit

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.core.config import GAMMA, GAMMA_MINUS1
from gadget_leicester_tpu.ops.neighbors import CellList, apply_pairwise
from gadget_leicester_tpu.ops.sph_dense import (DensityResult, HydroResult,
                                                density_adaptive_generic)
from gadget_leicester_tpu.ops.sph_kernels import (kernel_dw_dr,
                                                  kernel_w_and_dwdh)


def _min_image(dx, box):
    return dx - box * jnp.round(dx / box)


HIGHEST = jax.lax.Precision.HIGHEST


@partial(hybrid_jit, static_argnames=("block", "periodic", "n_targets"))
def density_sums_cells(
    cl: CellList, pos, vel, mass, hsml, gas_mask,
    box=0.0, block: int = 256, periodic: bool = False,
    n_targets: int | None = None,
):
    """Cell-list version of [G2: density.c :: density_evaluate()] sums.
    ``n_targets``: evaluate only the first n rows as targets (SPMD slabs:
    local prefix; ghost rows are sources only). ``hsml`` is sized to the
    target prefix in that case."""
    src_mass = jnp.where(gas_mask, mass, 0.0)

    def pair_fn(idx, tp, cand):
        th = hsml[idx]
        valid = cand >= 0
        ci = jnp.maximum(cand, 0)
        sp = pos[ci]                       # [B,C,3]
        sv = vel[ci]
        sm = jnp.where(valid, src_mass[ci], 0.0)
        dx = tp[:, None, :] - sp
        if periodic:
            dx = _min_image(dx, box)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        w, dwdh = kernel_w_and_dwdh(r, th[:, None])
        dwdr = kernel_dw_dr(r, th[:, None])
        rho = jnp.sum(sm * w, axis=-1)
        drho_dh = jnp.sum(sm * dwdh, axis=-1)
        dv = vel[idx][:, None, :] - sv
        rinv = jnp.where(r > 0, 1.0 / jnp.maximum(r, 1e-37), 0.0)
        fac = sm * dwdr * rinv
        divv = -jnp.sum(fac * jnp.sum(dv * dx, axis=-1), axis=-1)
        rot = jnp.einsum("bc,bcd->bd", fac, jnp.cross(dv, dx),
                         precision=HIGHEST)
        return rho, drho_dh, divv, rot

    return apply_pairwise(cl, pos, pair_fn, block=block, n_targets=n_targets)


def density_adaptive_cells(
    cl: CellList, pos, vel, mass, hsml0, gas_mask,
    des_num_ngb: float, max_dev: float,
    min_hsml: float = 0.0, max_hsml=None,
    box: float = 0.0, periodic: bool = False,
    block: int = 256, max_iters: int = 40,
    n_targets: int | None = None,
    backend: str = "xla", targets=None, interpret: bool = False,
) -> DensityResult:
    """Adaptive-h solve; with ``n_targets``, only the first n rows are
    solved (outputs sized n_targets); all rows source the sums. Rows
    outside ``targets`` come back with rho == 0."""
    nt = pos.shape[0] if n_targets is None else n_targets
    solve_mask = gas_mask[:nt]
    if targets is not None:
        solve_mask = solve_mask & targets[:nt]
    if backend == "triton":
        from gadget_leicester_tpu.ops.cell_pairs import density_sweep_kernel
        sweep = density_sweep_kernel(cl, pos, vel, mass, gas_mask,
                                     solve_mask, interpret=interpret)
    else:
        def sweep(h):
            return density_sums_cells(cl, pos, vel, mass, h, gas_mask,
                                      box=box, block=block,
                                      periodic=periodic, n_targets=n_targets)

    return density_adaptive_generic(
        sweep, mass[:nt], hsml0[:nt], solve_mask, des_num_ngb, max_dev,
        min_hsml=min_hsml, max_hsml=max_hsml, max_iters=max_iters)


@partial(hybrid_jit, static_argnames=("block", "periodic", "n_targets",
                                      "backend", "visc_const", "interpret"))
def hydro_force_cells(
    cl: CellList, pos, vel, mass, hsml, rho, pressure, dhsml_factor,
    div_vel, curl_vel, gas_mask, visc_const: float,
    box: float = 0.0, periodic: bool = False, block: int = 256,
    hubble_a2_flow: float = 0.0, hubble_a2_norm: float = 1.0,
    fac_mu: float = 1.0, n_targets: int | None = None,
    backend: str = "xla", targets=None, interpret: bool = False,
) -> HydroResult:
    """Cell-list version of [G2: hydra.c :: hydro_evaluate()]. With
    ``n_targets`` only the first n rows are targets (outputs sized n);
    all rows (incl. SPMD ghosts) source the pair sums."""
    rho_safe = jnp.where(rho > 0, rho, 1.0)
    src_mass = jnp.where(gas_mask, mass, 0.0)
    c_snd = jnp.sqrt(GAMMA * pressure / rho_safe)
    p_over_rho2 = pressure / rho_safe**2 * dhsml_factor
    h_safe = jnp.where(hsml > 0, hsml, 1.0)
    balsara = jnp.abs(div_vel) / (
        jnp.abs(div_vel) + curl_vel + 1e-4 * c_snd / h_safe / fac_mu)

    def pair_fn(idx, tp, cand):
        tv = vel[idx]
        th, trho, tpor2 = hsml[idx], rho[idx], p_over_rho2[idx]
        tc, tbal = c_snd[idx], balsara[idx]

        valid = cand >= 0
        ci = jnp.maximum(cand, 0)
        sp, sv = pos[ci], vel[ci]
        sm = jnp.where(valid, src_mass[ci], 0.0)
        sh, srho = hsml[ci], rho[ci]
        spor2, sc, sbal = p_over_rho2[ci], c_snd[ci], balsara[ci]
        sgm = valid & gas_mask[ci]

        dx = tp[:, None, :] - sp
        if periodic:
            dx = _min_image(dx, box)
        r2 = jnp.sum(dx * dx, axis=-1)
        r = jnp.sqrt(r2)
        inside = (r < jnp.maximum(th[:, None], sh)) & (r > 0) & sgm
        rinv = jnp.where(r > 0, 1.0 / jnp.maximum(r, 1e-37), 0.0)
        dwk_i = kernel_dw_dr(r, th[:, None])
        dwk_j = kernel_dw_dr(r, sh)
        dv = tv[:, None, :] - sv
        vdotr2 = jnp.sum(dv * dx, axis=-1) + hubble_a2_flow * r2
        approaching = vdotr2 < 0
        mu_ij = fac_mu * vdotr2 * rinv
        vsig = tc[:, None] + sc - 3.0 * jnp.where(approaching, mu_ij, 0.0)
        rho_ij = 0.5 * (trho[:, None] + srho)
        rho_ij = jnp.where(rho_ij > 0, rho_ij, 1.0)
        f_ij = 0.5 * (tbal[:, None] + sbal)
        visc = jnp.where(approaching,
                         0.5 * visc_const * vsig * (-mu_ij) / rho_ij * f_ij, 0.0)
        hfc_visc = 0.5 * sm * visc * (dwk_i + dwk_j) * rinv
        hfc = hfc_visc + sm * (tpor2[:, None] * dwk_i + spor2 * dwk_j) * rinv
        hfc = jnp.where(inside, hfc, 0.0)
        hfc_visc = jnp.where(inside, hfc_visc, 0.0)
        acc = -jnp.einsum("bc,bcd->bd", hfc, dx, precision=HIGHEST)
        dt_ent = 0.5 * jnp.sum(hfc_visc * vdotr2, axis=-1)
        msv = jnp.max(jnp.where(inside, vsig, 0.0), axis=-1)
        return acc, dt_ent, msv

    nt = pos.shape[0] if n_targets is None else n_targets
    if backend == "triton":
        from gadget_leicester_tpu.ops.cell_pairs import hydro_sums_kernel
        tgt = gas_mask if targets is None else gas_mask & targets
        tgt = tgt & (jnp.arange(pos.shape[0]) < nt)
        acc, dt_ent, msv = hydro_sums_kernel(
            cl, pos, vel, src_mass, hsml, rho, p_over_rho2, c_snd, balsara,
            gas_mask, tgt, visc_const, hubble_a2_flow, fac_mu,
            interpret=interpret)
        acc, dt_ent, msv = acc[:nt], dt_ent[:nt], msv[:nt]
    else:
        acc, dt_ent, msv = apply_pairwise(cl, pos, pair_fn, block=block,
                                          n_targets=n_targets)
    dt_ent = dt_ent * GAMMA_MINUS1 / (
        hubble_a2_norm * rho_safe[:nt]**GAMMA_MINUS1)
    gm = gas_mask[:nt]
    return HydroResult(
        acc=jnp.where(gm[:, None], acc, 0.0),
        dt_entropy=jnp.where(gm, dt_ent, 0.0),
        max_signal_vel=jnp.where(gm, msv, 0.0),
    )
