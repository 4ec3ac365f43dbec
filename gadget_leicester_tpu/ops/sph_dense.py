"""All-pairs SPH density + hydro force (small-N path and correctness oracle).

Rebuild of [G2: density.c :: density()/density_evaluate()] and
[G2: hydra.c :: hydro_force()/hydro_evaluate()] as row-blocked, masked,
static-shape batched ops. At gassphere scale (~1.5k gas) all-pairs
beats any neighbour structure; at larger N the cell-list kernels in
``ops.neighbors`` reuse the same per-pair math.

The adaptive smoothing-length solve — the reference's per-particle
Newton/bisection loop repeated until global convergence (MPI_Allreduce of
the unconverged count) — becomes a single ``lax.while_loop`` over the full
gas array with a converged mask; the "global" reduction is a jnp.any.

Comoving factors follow [G2: hydra.c] exactly (fac_mu, hubble_a2, a3inv);
pass atime=1, hubble_a=1 for physical integration.
"""

from __future__ import annotations

from functools import partial

from gadget_leicester_tpu.ops.jit_util import hybrid_jit
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.core.config import GAMMA, GAMMA_MINUS1
from gadget_leicester_tpu.ops.sph_kernels import kernel_dw_dr, kernel_w_and_dwdh

# f32 pair sums: no TF32 on GPU tensor cores
HIGHEST = jax.lax.Precision.HIGHEST

NORM_COEFF = 4.0 * jnp.pi / 3.0  # effective-Ngb normalisation [G2: density.c]


def _min_image(dx, box):
    return dx - box * jnp.round(dx / box)


class DensityResult(NamedTuple):
    rho: jnp.ndarray
    dhsml_factor: jnp.ndarray   # f_i = (1 + h/(3 rho) drho/dh)^-1
    div_vel: jnp.ndarray        # divergence of velocity (normalised by rho)
    curl_vel: jnp.ndarray       # |rot v| / rho
    num_ngb_eff: jnp.ndarray    # (4 pi/3) h^3 rho / m  — effective Ngb count
    hsml: jnp.ndarray
    iters: jnp.ndarray          # int32 — while_loop trips used


@partial(hybrid_jit, static_argnames=("block", "periodic"))
def density_sums(pos, vel, mass, hsml, gas_mask, box=0.0, block=512, periodic=False):
    """One density sweep: rho, drho/dh, raw div/rot sums for every gas slot.

    pos/vel/mass/hsml are gas-array-sized [Ng(,3)]; gas_mask marks live gas.
    Returns unnormalised sums (div/rot still need the 1/rho).
    """
    ng = pos.shape[0]
    nb = -(-ng // block)
    npad = nb * block
    posp = jnp.pad(pos, ((0, npad - ng), (0, 0)))
    velp = jnp.pad(vel, ((0, npad - ng), (0, 0)))
    hp = jnp.pad(hsml, (0, npad - ng))
    src_mass = jnp.where(gas_mask, mass, 0.0)

    def one_block(i):
        tp = jax.lax.dynamic_slice(posp, (i * block, 0), (block, 3))
        tv = jax.lax.dynamic_slice(velp, (i * block, 0), (block, 3))
        th = jax.lax.dynamic_slice(hp, (i * block,), (block,))
        dx = tp[:, None, :] - pos[None, :, :]
        if periodic:
            dx = _min_image(dx, box)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        w, dwdh = kernel_w_and_dwdh(r, th[:, None])
        dwdr = kernel_dw_dr(r, th[:, None])
        m = src_mass[None, :]
        rho = jnp.sum(m * w, axis=-1)
        drho_dh = jnp.sum(m * dwdh, axis=-1)
        dv = tv[:, None, :] - vel[None, :, :]
        rinv = jnp.where(r > 0, 1.0 / jnp.maximum(r, 1e-37), 0.0)
        fac = m * dwdr * rinv                      # [B,Ng]
        divv = -jnp.sum(fac * jnp.sum(dv * dx, axis=-1), axis=-1)
        # rot = sum fac * (dv x dx)  [G2: density_evaluate rot accumulation]
        cross = jnp.cross(dv, dx)
        rot = jnp.einsum("bn,bnc->bc", fac, cross, precision=HIGHEST)
        return rho, drho_dh, divv, rot

    rho, drho_dh, divv, rot = jax.lax.map(one_block, jnp.arange(nb))
    return (
        rho.reshape(npad)[:ng],
        drho_dh.reshape(npad)[:ng],
        divv.reshape(npad)[:ng],
        rot.reshape(npad, 3)[:ng],
    )


def density_adaptive(
    pos,
    vel,
    mass,
    hsml0,
    gas_mask,
    des_num_ngb: float,
    max_dev: float,
    min_hsml: float = 0.0,
    box: float = 0.0,
    periodic: bool = False,
    block: int = 512,
    max_iters: int = 40,
) -> DensityResult:
    """All-pairs adaptive-h density solve (see density_adaptive_generic)."""

    def sweep(h):
        return density_sums(pos, vel, mass, h, gas_mask, box=box,
                            block=block, periodic=periodic)

    return density_adaptive_generic(
        sweep, mass, hsml0, gas_mask, des_num_ngb, max_dev,
        min_hsml=min_hsml, max_iters=max_iters)


def density_adaptive_generic(
    sweep,
    mass,
    hsml0,
    gas_mask,
    des_num_ngb: float,
    max_dev: float,
    min_hsml: float = 0.0,
    max_hsml=None,
    max_iters: int = 40,
) -> DensityResult:
    """Adaptive-h density solve [G2: density.c :: density()], generic over
    the neighbour-sum backend: ``sweep(h, undone=None) -> (rho, drho_dh,
    divv_raw, rot_raw)`` (all-pairs or cell lists). ``undone`` (bool mask
    of slots still iterating) lets tiled backends SKIP fully-converged
    tiles on later Newton sweeps — the rebuild of the reference's
    shrinking ntot list [G2: density.c "ntot" re-iteration loop];
    backends may ignore it and return garbage for done slots (the loop
    keeps each done slot's last accepted sums).

    Newton step on the effective neighbour number
    N_eff = (4 pi/3) h^3 rho / m toward DesNumNgb, with Left/Right
    bisection brackets as fallback, masked ``lax.while_loop`` until every
    live gas particle converges (|N_eff - des| < max_dev) or max_iters.
    `max_hsml` (None or a possibly-traced scalar) caps h — cell-list
    backends require h <= cell size; callers watch the cap and rebuild
    with bigger cells when hit.
    """
    f = hsml0.dtype

    def eff_ngb(h, rho):
        m_safe = jnp.where(mass > 0, mass, 1.0)
        return NORM_COEFF * h**3 * rho / m_safe

    def dh_factor(h, rho, drho_dh):
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        fac_ = 1.0 / (1.0 + h * drho_dh / (3.0 * rho_safe))
        return jnp.where((fac_ > 0.1) & (fac_ < 10.0), fac_, 1.0)

    # seed sweep; the loop carries the sums so NO final sweep is needed
    # (warm-started solves cost exactly one sweep)
    h0 = jnp.maximum(hsml0, jnp.asarray(min_hsml, f))
    if max_hsml is not None:
        h0 = jnp.minimum(h0, max_hsml)
    import inspect
    takes_undone = len(inspect.signature(sweep).parameters) >= 2
    sums0 = sweep(h0, None) if takes_undone else sweep(h0)
    z = jnp.zeros_like(h0)

    def converged(h, rho):
        return jnp.abs(eff_ngb(h, rho) - des_num_ngb) < max_dev

    def cond(carry):
        h, left, right, done, it, sums = carry
        return jnp.logical_and(it < max_iters,
                               jnp.logical_not(jnp.all(done)))

    def body(carry):
        h, left, right, done, it, sums = carry
        rho, drho_dh = sums[0], sums[1]
        neff = eff_ngb(h, rho)
        dh_fac = dh_factor(h, rho, drho_dh)
        conv = converged(h, rho)
        narrow = (left > 0) & (right > 0) & ((right - left) < 1e-3 * left)
        now_done = conv | narrow | ~gas_mask | done
        low = neff < des_num_ngb
        left_n = jnp.where(~now_done & low, jnp.maximum(h, left), left)
        right_n = jnp.where(
            ~now_done & ~low,
            jnp.where(right > 0, jnp.minimum(h, right), h),
            right,
        )
        neff_safe = jnp.maximum(neff, 1e-6)
        fac_ = 1.0 - (neff - des_num_ngb) / (3.0 * neff_safe) * dh_fac
        fac_ = jnp.clip(fac_, 1.0 / 1.26, 1.26)
        h_newton = h * fac_
        h_bisect = jnp.cbrt(0.5 * (left_n**3 + right_n**3))
        both = (left_n > 0) & (right_n > 0)
        h_next = jnp.where(both, h_bisect, h_newton)
        h_next = jnp.maximum(h_next, min_hsml)
        if max_hsml is not None:
            h_next = jnp.minimum(h_next, max_hsml)
        h_out = jnp.where(now_done, h, h_next)
        if takes_undone:
            raw = sweep(h_out, jnp.logical_not(now_done))
        else:
            raw = sweep(h_out)
        # done slots keep their last accepted sums (their tile may have
        # been skipped and returned zeros); undone slots take the fresh
        # sweep
        def mrg(old, new):
            m = now_done if old.ndim == 1 else now_done[:, None]
            return jnp.where(m, old, new)

        sums_new = tuple(mrg(o, n) for o, n in zip(sums, raw))
        return (h_out, left_n, right_n, now_done, it + 1, sums_new)

    done0 = converged(h0, sums0[0]) | ~gas_mask
    init = (h0, z, z, done0, jnp.int32(0), sums0)
    h, left, right, done, iters, sums = jax.lax.while_loop(cond, body, init)

    rho, drho_dh, divv_raw, rot_raw = sums
    rho_safe = jnp.where(rho > 0, rho, 1.0)
    dh_fac = dh_factor(h, rho, drho_dh)
    div_vel = divv_raw / rho_safe
    curl_vel = jnp.sqrt(jnp.sum(rot_raw**2, axis=-1)) / rho_safe
    neff = eff_ngb(h, rho)
    return DensityResult(
        rho=jnp.where(gas_mask, rho, 0.0),
        dhsml_factor=jnp.where(gas_mask, dh_fac, 1.0),
        div_vel=jnp.where(gas_mask, div_vel, 0.0),
        curl_vel=jnp.where(gas_mask, curl_vel, 0.0),
        num_ngb_eff=neff,
        hsml=h,
        iters=iters,
    )


class HydroResult(NamedTuple):
    acc: jnp.ndarray            # [Ng,3] hydrodynamic acceleration
    dt_entropy: jnp.ndarray     # [Ng] dA/dt (viscous heating only)
    max_signal_vel: jnp.ndarray # [Ng]


@partial(hybrid_jit, static_argnames=("block", "periodic"))
def hydro_force(
    pos,
    vel,            # predicted velocities at current time [G2: VelPred]
    mass,
    hsml,
    rho,
    pressure,
    dhsml_factor,
    div_vel,
    curl_vel,
    gas_mask,
    visc_const: float,
    box: float = 0.0,
    periodic: bool = False,
    block: int = 512,
    hubble_a2_flow: float = 0.0,  # a^2 H(a) for comoving Hubble-flow term; 0 physical
    hubble_a2_norm: float = 1.0,  # a^2 H(a) for DtEntropy normalisation; 1 physical
    fac_mu: float = 1.0,          # a^{3(gamma-1)/2 - 1}; 1 physical
) -> HydroResult:
    """Entropy-formulation SPH momentum + entropy equation
    [G2: hydra.c :: hydro_evaluate()], Springel & Hernquist (2002):

      a_i = -sum_j m_j [ f_i P_i/rho_i^2 dW_i + f_j P_j/rho_j^2 dW_j
                         + Pi_ij * (dW_i + dW_j)/2 ] \\hat r
      dA_i/dt = (gamma-1)/rho_i^{gamma-1} * 1/2 sum_j m_j Pi_ij v_ij.r_ij ...

    with Monaghan-Balsara viscosity Pi_ij built from the pairwise signal
    velocity v_sig = c_i + c_j - 3 mu_ij and the Balsara limiter.
    """
    ng = pos.shape[0]
    nb = -(-ng // block)
    npad = nb * block

    def padv(x):
        return jnp.pad(x, ((0, npad - ng),) + ((0, 0),) * (x.ndim - 1))

    posp, velp, hp = padv(pos), padv(vel), padv(hsml)
    rhop, pp_, fp = padv(rho), padv(pressure), padv(dhsml_factor)
    divp, curlp = padv(div_vel), padv(curl_vel)

    rho_safe = jnp.where(rho > 0, rho, 1.0)
    src_mass = jnp.where(gas_mask, mass, 0.0)
    c_snd = jnp.sqrt(GAMMA * pressure / rho_safe)
    p_over_rho2 = pressure / rho_safe**2 * dhsml_factor
    h_safe = jnp.where(hsml > 0, hsml, 1.0)
    balsara = jnp.abs(div_vel) / (
        jnp.abs(div_vel) + curl_vel + 1e-4 * c_snd / h_safe / fac_mu
    )

    c_sndp, por2p, balp = padv(c_snd), padv(p_over_rho2), padv(balsara)

    def one_block(i):
        sl1 = lambda a: jax.lax.dynamic_slice(a, (i * block,), (block,))
        sl3 = lambda a: jax.lax.dynamic_slice(a, (i * block, 0), (block, 3))
        tp, tv = sl3(posp), sl3(velp)
        th, trho, tpor2 = sl1(hp), sl1(rhop), sl1(por2p)
        tc, tbal = sl1(c_sndp), sl1(balp)

        dx = tp[:, None, :] - pos[None, :, :]
        if periodic:
            dx = _min_image(dx, box)
        r2 = jnp.sum(dx * dx, axis=-1)
        r = jnp.sqrt(r2)
        inside = (r < jnp.maximum(th[:, None], hsml[None, :])) & (r > 0)
        inside &= gas_mask[None, :]

        rinv = jnp.where(r > 0, 1.0 / jnp.maximum(r, 1e-37), 0.0)
        dwk_i = kernel_dw_dr(r, th[:, None])
        dwk_j = kernel_dw_dr(r, hsml[None, :])

        dv = tv[:, None, :] - vel[None, :, :]
        # comoving Hubble-flow term [G2: hydra.c vdotr2 += hubble_a2*r2];
        # hubble_a2_flow = 0 for physical runs.
        vdotr2 = jnp.sum(dv * dx, axis=-1) + hubble_a2_flow * r2
        approaching = vdotr2 < 0
        mu_ij = fac_mu * vdotr2 * rinv
        vsig = tc[:, None] + c_snd[None, :] - 3.0 * jnp.where(approaching, mu_ij, 0.0)
        rho_ij = 0.5 * (trho[:, None] + rho[None, :])
        rho_ij = jnp.where(rho_ij > 0, rho_ij, 1.0)
        f_ij = 0.5 * (tbal[:, None] + balsara[None, :])
        visc = jnp.where(
            approaching,
            0.5 * visc_const * vsig * (-mu_ij) / rho_ij * f_ij,
            0.0,
        )
        m = src_mass[None, :]
        hfc_visc = 0.5 * m * visc * (dwk_i + dwk_j) * rinv
        hfc = hfc_visc + m * (tpor2[:, None] * dwk_i + p_over_rho2[None, :] * dwk_j) * rinv
        hfc = jnp.where(inside, hfc, 0.0)
        hfc_visc = jnp.where(inside, hfc_visc, 0.0)
        acc = -jnp.einsum("bn,bnc->bc", hfc, dx, precision=HIGHEST)
        dt_ent = 0.5 * jnp.sum(hfc_visc * vdotr2, axis=-1)
        msv = jnp.max(jnp.where(inside, vsig, 0.0), axis=-1)
        return acc, dt_ent, msv

    acc, dt_ent, msv = jax.lax.map(one_block, jnp.arange(nb))
    acc = acc.reshape(npad, 3)[:ng]
    dt_ent = dt_ent.reshape(npad)[:ng]
    msv = msv.reshape(npad)[:ng]
    # final scaling [G2: hydra.c tail]:
    # DtEntropy *= GAMMA_MINUS1 / (hubble_a2 * rho^{gamma-1})
    dt_ent = dt_ent * GAMMA_MINUS1 / (hubble_a2_norm * rho_safe**GAMMA_MINUS1)
    gm = gas_mask
    return HydroResult(
        acc=jnp.where(gm[:, None], acc, 0.0),
        dt_entropy=jnp.where(gm, dt_ent, 0.0),
        max_signal_vel=jnp.where(gm, msv, 0.0),
    )
