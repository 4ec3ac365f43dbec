"""W4 cubic-spline SPH kernel (Monaghan & Lattanzio 1985), GADGET convention.

[G2: allvars.h KERNEL_COEFF_*; density.c / hydra.c inline kernel evaluation]

GADGET normalises the spline so that W has compact support radius exactly
``h`` (NOT 2h): with u = r/h,

    W(u) = 8/(pi h^3) * ( 1 - 6u^2 + 6u^3 )        0   <= u <= 1/2
         = 8/(pi h^3) * 2 (1-u)^3                  1/2 <  u <= 1
         = 0                                       u > 1

All functions are branch-free (jnp.where) and broadcast over arbitrary
shapes — the reference evaluates these scalar-at-a-time inside neighbour
loops; here they vectorise over full [N, K] neighbour blocks.
"""

from __future__ import annotations

import jax.numpy as jnp

NORM_3D = 8.0 / jnp.pi  # KERNEL_COEFF_1


def kernel_w(r, h):
    """W(r, h). Zero outside support; safe at h==0 (returns 0)."""
    hinv = jnp.where(h > 0, 1.0 / h, 0.0)
    u = r * hinv
    one_m = 1.0 - u
    w_inner = 1.0 - 6.0 * u * u + 6.0 * u * u * u
    w_outer = 2.0 * one_m * one_m * one_m
    w = jnp.where(u < 0.5, w_inner, jnp.where(u < 1.0, w_outer, 0.0))
    hinv3 = hinv * hinv * hinv
    return NORM_3D * hinv3 * w


def kernel_dw_dr(r, h):
    """dW/dr. Matches [G2: KERNEL_COEFF_3/COEFF_2 branch] analytically."""
    hinv = jnp.where(h > 0, 1.0 / h, 0.0)
    u = r * hinv
    one_m = 1.0 - u
    d_inner = u * (18.0 * u - 12.0)          # d/du (1 - 6u^2 + 6u^3)
    d_outer = -6.0 * one_m * one_m           # d/du 2(1-u)^3
    d = jnp.where(u < 0.5, d_inner, jnp.where(u < 1.0, d_outer, 0.0))
    hinv2 = hinv * hinv
    return NORM_3D * hinv2 * hinv2 * d


def kernel_w_and_dwdh(r, h):
    """Return (W, dW/dh) — both needed by the density loop.

    dW/dh = -(1/h) (3 W + u dW/du) with W = h^-3 w(u)
    [G2: density.c :: density_evaluate() dhsmlrho accumulation].
    """
    hinv = jnp.where(h > 0, 1.0 / h, 0.0)
    u = r * hinv
    one_m = 1.0 - u
    w_inner = 1.0 - 6.0 * u * u + 6.0 * u * u * u
    w_outer = 2.0 * one_m * one_m * one_m
    wu = jnp.where(u < 0.5, w_inner, jnp.where(u < 1.0, w_outer, 0.0))
    d_inner = u * (18.0 * u - 12.0)
    d_outer = -6.0 * one_m * one_m
    du = jnp.where(u < 0.5, d_inner, jnp.where(u < 1.0, d_outer, 0.0))
    hinv2 = hinv * hinv
    hinv3 = hinv2 * hinv
    w = NORM_3D * hinv3 * wu
    dwdh = -NORM_3D * hinv3 * hinv * (3.0 * wu + u * du)
    return w, dwdh
