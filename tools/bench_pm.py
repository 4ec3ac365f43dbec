#!/usr/bin/env python
"""PM deposit/gather microbench: windowed scatter/gather vs per-corner.

Usage: python -u tools/bench_pm.py [N_million] [mesh_n]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np


def fence(x):
    leaf = jax.tree_util.tree_leaves(x)[0]
    return float(jnp.asarray(leaf).reshape(-1)[0])


def timeit(fn, *args, reps=3):
    fence(fn(*args))
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    fence(out)
    return (time.time() - t0) / reps


def old_deposit(pos, weight, box, n):
    f = pos.dtype
    u = pos * (n / box)
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0
    grid = jnp.zeros((n, n, n), f)
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - frac[:, 0], frac[:, 0])
        ix = jnp.mod(i0[:, 0] + dx, n)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - frac[:, 1], frac[:, 1])
            iy = jnp.mod(i0[:, 1] + dy, n)
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - frac[:, 2], frac[:, 2])
                iz = jnp.mod(i0[:, 2] + dz, n)
                grid = grid.at[ix, iy, iz].add(weight * wx * wy * wz)
    return grid


def old_gather_vec(field, pos, box, n):
    u = pos * (n / box)
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = u - i0
    val = jnp.zeros(pos.shape[:1] + field.shape[-1:], field.dtype)
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - frac[:, 0], frac[:, 0])
        ix = jnp.mod(i0[:, 0] + dx, n)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - frac[:, 1], frac[:, 1])
            iy = jnp.mod(i0[:, 1] + dy, n)
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - frac[:, 2], frac[:, 2])
                iz = jnp.mod(i0[:, 2] + dz, n)
                val = val + field[ix, iy, iz, :] * (wx * wy * wz)[:, None]
    return val


def main():
    nm = float(sys.argv[1]) if len(sys.argv) > 1 else 4.2
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    npart = int(nm * 1e6)
    box = 50000.0
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(0, box, (npart, 3)), jnp.float32)
    w = jnp.ones((npart,), jnp.float32)
    from gadget_leicester_tpu.ops.pm import cic_deposit, cic_gather_vec

    t = timeit(jax.jit(lambda p, w_: old_deposit(p, w_, box, n)), pos, w)
    print(f"old deposit  N={npart} mesh={n}: {t*1e3:.0f} ms", flush=True)
    t = timeit(jax.jit(lambda p, w_: cic_deposit(p, w_, box, n)), pos, w)
    print(f"new deposit  N={npart} mesh={n}: {t*1e3:.0f} ms", flush=True)

    # equality check (small)
    ps, ws = pos[:100000], w[:100000]
    a = old_deposit(ps, ws, box, 64)
    b = jax.jit(lambda p, w_: cic_deposit(p, w_, box, 64))(ps, ws)
    err = float(jnp.max(jnp.abs(a - b)))
    print(f"deposit max abs diff (64^3, 100k): {err:.2e}", flush=True)

    field = jnp.asarray(rng.normal(size=(n, n, n, 4)), jnp.float32)
    t = timeit(jax.jit(lambda f_, p: old_gather_vec(f_, p, box, n)),
               field, pos)
    print(f"old gather4  N={npart} mesh={n}: {t*1e3:.0f} ms", flush=True)
    t = timeit(jax.jit(lambda f_, p: cic_gather_vec(f_, p, box, n)),
               field, pos)
    print(f"new gather4  N={npart} mesh={n}: {t*1e3:.0f} ms", flush=True)
    a = old_gather_vec(field, ps, box, n)
    b = jax.jit(lambda f_, p: cic_gather_vec(f_, p, box, n))(field, ps)
    err = float(jnp.max(jnp.abs(a - b)))
    print(f"gather max abs diff: {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
