"""Short-range (cutoff) gravity over cell lists — the TreePM short-range
force for near-uniform regimes [G2: forcetree.c ::
force_treeevaluate_shortrange()].

The erfc-truncated force vanishes beyond Rcut ~ 4.5 Asmth, so with
cell_size >= Rcut the 27-stencil candidate set is exact. In strongly
clustered regimes the Barnes-Hut tree backend (ops.tree) takes over for
the short-range sum; this path is the fast early-time / quasi-uniform
kernel (SURVEY.md §7 step 7).
"""

from __future__ import annotations

from functools import partial

from gadget_leicester_tpu.ops.jit_util import hybrid_jit

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.ops.gravity_direct import shortrange_trunc
from gadget_leicester_tpu.ops.neighbors import CellList, apply_pairwise
from gadget_leicester_tpu.ops.softening import grav_fac

HIGHEST = jax.lax.Precision.HIGHEST


def _min_image(dx, box):
    return dx - box * jnp.round(dx / box)


@partial(hybrid_jit, static_argnames=("block", "periodic", "with_potential",
                                      "n_targets", "backend", "interpret"))
def shortrange_gravity_cells(
    cl: CellList,
    pos,
    mass,
    soft,
    alive,
    asmth: float,
    rcut: float,
    box: float = 0.0,
    block: int = 256,
    periodic: bool = True,
    with_potential: bool = False,
    n_targets: int | None = None,
    backend: str = "xla",
    targets=None,
    interpret: bool = False,
):
    """acc[N,3] (no G factor), erfc-truncated, zero beyond rcut.
    with_potential additionally returns the erfc-truncated softened
    potential [G2: potential.c with PMGRID]. ``n_targets``: only the
    first n rows are targets (SPMD slab prefix; ghosts source only).

    ``backend``: "xla" (the blocked gather below, the plain reference) or
    "triton" (ops.cell_pairs; needs a power-of-two capacity). ``targets``
    ([N] bool, None = all alive) lets the kernel skip cells without a
    target; rows outside it are unspecified. ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    from gadget_leicester_tpu.ops.gravity_direct import shortrange_trunc_pot
    from gadget_leicester_tpu.ops.softening import grav_pot
    nt = pos.shape[0] if n_targets is None else n_targets
    if backend == "triton":
        from gadget_leicester_tpu.ops.cell_pairs import \
            shortrange_gravity_kernel
        tgt = alive if targets is None else targets & alive
        tgt = tgt & (jnp.arange(pos.shape[0]) < nt)
        res = shortrange_gravity_kernel(cl, pos, mass, soft, alive, tgt,
                                        asmth, rcut,
                                        with_potential=with_potential,
                                        interpret=interpret)
        if with_potential:
            return (jnp.where(alive[:nt, None], res[0][:nt], 0.0),
                    jnp.where(alive[:nt], res[1][:nt], 0.0))
        return jnp.where(alive[:nt, None], res[:nt], 0.0)
    src_mass = jnp.where(alive, mass, 0.0)

    def pair_fn(idx, tp, cand):
        ts = soft[idx]
        valid = cand >= 0
        ci = jnp.maximum(cand, 0)
        sp = pos[ci]
        sm = jnp.where(valid, src_mass[ci], 0.0)
        dx = tp[:, None, :] - sp
        if periodic:
            dx = _min_image(dx, box)
        r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
        h = jnp.maximum(ts[:, None], soft[ci])
        fac = grav_fac(r, h) * shortrange_trunc(r, asmth)
        fac = jnp.where(r < rcut, fac, 0.0)
        w = sm * fac
        acc = -jnp.einsum("bc,bcd->bd", w, dx, precision=HIGHEST)
        if with_potential:
            pw = grav_pot(r, h) * shortrange_trunc_pot(r, asmth)
            pw = jnp.where((r < rcut) & (r > 0), pw, 0.0)
            return (acc, jnp.sum(sm * pw, axis=-1))
        return (acc,)

    if with_potential:
        acc, pot = apply_pairwise(cl, pos, pair_fn, block=block,
                                  n_targets=n_targets)
        return (jnp.where(alive[:nt, None], acc, 0.0),
                jnp.where(alive[:nt], pot, 0.0))
    (acc,) = apply_pairwise(cl, pos, pair_fn, block=block,
                            n_targets=n_targets)
    return jnp.where(alive[:nt, None], acc, 0.0)
