"""Glass-file generation — rebuild of the reference's MAKEGLASS mode
[G2: Makefile -DMAKEGLASS=n + run.c/gravity sign-reversal hooks].

A "glass" is a sub-random uniform particle distribution: start from
Poisson positions and evolve them under SIGN-REVERSED gravity (particles
repel) with velocity damping; the configuration relaxes toward a
force-free glass. Used as low-noise ICs for cosmological runs.

Rebuild: a fused jit loop — reversed PM forces (mesh-only, adequate
for glass-making), steepest-descent-like position updates, periodic wrap.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gadget_leicester_tpu.ops.pm import pm_forces_periodic


@partial(jax.jit, static_argnames=("grid_n", "n_steps"))
def _glass_relax(pos, box: float, grid_n: int, n_steps: int, step_fac: float):
    n = pos.shape[0]
    mass = jnp.ones((n,), pos.dtype)
    alive = jnp.ones((n,), bool)

    def body(pos, j):
        acc = pm_forces_periodic(pos, mass, alive, box, grid_n)
        # reversed gravity + normalised displacement step (damped: no
        # velocity carried between steps = heavy friction limit); the step
        # decays geometrically so the relaxation converges instead of
        # bouncing at fixed amplitude
        amax = jnp.max(jnp.sqrt(jnp.sum(acc * acc, axis=-1)))
        step = step_fac * 0.96**j
        disp = -acc / jnp.maximum(amax, 1e-30) * step
        return jnp.mod(pos + disp, box), amax

    pos, amax_hist = jax.lax.scan(body, pos, jnp.arange(n_steps))
    return pos, amax_hist


def make_glass(n_side: int, box: float = 1.0, seed: int = 4,
               n_steps: int = 60, grid_n: int | None = None):
    """Return [n_side^3, 3] glass positions in a periodic box."""
    rng = np.random.default_rng(seed)
    n = n_side**3
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)), jnp.float32)
    g = grid_n or max(16, 2 * n_side)
    spacing = box / n_side
    pos, amax = _glass_relax(pos, box, g, n_steps, 0.15 * spacing)
    return np.asarray(pos), np.asarray(amax)
