"""Direct-summation O(N^2) gravity — the rebuild of the reference's built-in
accuracy oracle [G2: gravtree_forcetest.c :: gravity_forcetest()] and the
production gravity path for small-N configs (gassphere-scale), where brute
force beats any tree.

Row-blocked all-pairs: targets are processed in blocks of ``block`` rows
against all N sources via ``lax.map``, bounding peak memory at
``block * N`` while keeping every op a wide static-shape vector op.
Softening is spline (Plummer-equivalent eps * 2.8), symmetrised with
max(h_i, h_j) as in [G2: forcetree.c UNEQUALSOFTENINGS].

Optional short-range truncation (erfc) turns the same kernel into the
TreePM short-range force [G2: forcetree.c :: force_treeevaluate_shortrange()].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.ops.softening import grav_fac, grav_pot

# f32 pair sums: no TF32 on GPU tensor cores
HIGHEST = jax.lax.Precision.HIGHEST


def _min_image(dx, box):
    """Periodic minimum-image convention [G2: NEAREST macro]."""
    return dx - box * jnp.round(dx / box)


def shortrange_trunc(r, asmth):
    """TreePM short-range truncation factor applied to the force
    [G2: forcetree.c shortrange_table; Springel 2005 eq. 17]:

        f_short(r) = erfc(r/(2 Asmth)) + r/(Asmth sqrt(pi)) exp(-r^2/(4 Asmth^2))
    """
    x = r / (2.0 * asmth)
    return jax.lax.erfc(x) + (2.0 * x / jnp.sqrt(jnp.pi)) * jnp.exp(-x * x)


def shortrange_trunc_pot(r, asmth):
    """Potential-space truncation: phi_short = -(m/r) erfc(r/(2 Asmth))."""
    return jax.lax.erfc(r / (2.0 * asmth))


@partial(
    jax.jit,
    static_argnames=("block", "periodic", "with_potential", "asmth", "rcut"),
)
def direct_gravity(
    pos,
    mass,
    soft,          # per-particle FORCE softening h = 2.8*eps
    alive,
    box: float = 0.0,
    asmth: float = 0.0,   # >0 enables erfc short-range truncation
    rcut: float = 0.0,    # >0 additionally zeroes the force beyond rcut
    block: int = 1024,
    periodic: bool = False,
    with_potential: bool = True,
):
    """Return (acc[N,3], pot[N]) — accelerations WITHOUT the G factor
    (caller multiplies by All.G, matching [G2: gravtree.c] which applies G
    once at the end).
    """
    n = pos.shape[0]
    nb = -(-n // block)
    npad = nb * block
    posp = jnp.pad(pos, ((0, npad - n), (0, 0)))
    softp = jnp.pad(soft, (0, npad - n))
    src_mass = jnp.where(alive, mass, 0.0)

    def one_block(i):
        tp = jax.lax.dynamic_slice(posp, (i * block, 0), (block, 3))
        ts = jax.lax.dynamic_slice(softp, (i * block,), (block,))
        dx = tp[:, None, :] - pos[None, :, :]          # [B,N,3]
        if periodic:
            dx = _min_image(dx, box)
        r2 = jnp.sum(dx * dx, axis=-1)
        r = jnp.sqrt(r2)
        h = jnp.maximum(ts[:, None], soft[None, :])    # symmetrised softening
        fac = grav_fac(r, h)                           # ~1/r^3, 0 at r=0
        if asmth > 0.0:
            fac = fac * shortrange_trunc(r, asmth)
        if rcut > 0.0:
            fac = jnp.where(r < rcut, fac, 0.0)
        w = src_mass[None, :] * fac                    # [B,N]
        acc = -jnp.einsum("bn,bnc->bc", w, dx, precision=HIGHEST)
        if with_potential:
            pw = grav_pot(r, h)
            if asmth > 0.0:
                # outside the softening kernel use the truncated -erfc/r;
                # inside keep the softened form (h << Asmth in practice).
                pw_trunc = -shortrange_trunc_pot(r, asmth) / jnp.maximum(r, 1e-37)
                pw = jnp.where(r >= h, pw_trunc, pw)
            # mask self term (r==0 diagonal) and dead sources
            pw = jnp.where(r > 0, pw, 0.0)
            pot = jnp.sum(src_mass[None, :] * pw, axis=-1)
        else:
            pot = jnp.zeros((block,), pos.dtype)
        return acc, pot

    accs, pots = jax.lax.map(one_block, jnp.arange(nb))
    acc = accs.reshape(npad, 3)[:n]
    pot = pots.reshape(npad)[:n]
    acc = jnp.where(alive[:, None], acc, 0.0)
    pot = jnp.where(alive, pot, 0.0)
    return acc, pot
