"""Persistent stale-tolerant neighbour grids — the rebuild of the
reference's *occasional* domain/tree rebuild cadence
[G2: domain.c :: domain_Decomposition() triggered every
TreeDomainUpdateFrequency * N force computations; forcetree.c drifts node
centres between rebuilds].

The reference does NOT rebuild its tree every sync point: it tolerates
slightly stale node geometry and re-decomposes only on a cadence. Here
the uniform-grid CELL ASSIGNMENTS of the short-range gravity grid (the
product of the O(N log N) sort in build_cell_list) are cached in the
SimState and reused across sync points; pair forces always read FRESH
positions, so the physics of found pairs is exact — staleness only
affects *which* pairs the stencil can see.

Coverage guarantee. A pair within interaction range ``r_int`` is found iff
the two ASSIGNED cells differ by <= 1 per axis, which holds when the
build-time separation is below the cell edge:

    r_int + 2 * max_displacement_since_build  <=  cell_edge

The grid therefore carries a static ``margin`` (cell_edge - r_int) and a
running displacement counter (incremented every drift by the step's max
per-particle |dx|_inf); it rebuilds — inside the jitted step, via
``lax.cond`` — when ``2 * disp > margin``. The margin is the hard slack
when the geometry has one, else a SOFT margin of ``SOFT_RCUT_FRAC *
rcut``: pairs that staleness can lose lie in the thin shell
[rcut - 2*disp, rcut] where the erfc truncation has already suppressed the
force to a few percent of 1/r^2 [G2: shortrange_table cutoff at RCUT = 4.5
ASMTH] — the same graceful-tail argument that sets RCUT itself. The
in-run forcetest oracle measures the combined error.

Pair sums over stale assignments must not assume a particle lies in its
assigned cell: the XLA path minimum-images every pair, and the kernel
stores cell-relative coordinates minimum-imaged when packed
(ops.cell_pairs).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.core.config import SimConfig, SimOptions
from gadget_leicester_tpu.ops.neighbors import CellList

# gravity soft-margin floor, as a fraction of rcut (see module docstring)
SOFT_RCUT_FRAC = 0.08


@dataclass
class GridCache:
    """Cached neighbour structure + staleness bookkeeping (a SimState
    field; ``None`` for configurations that build no uniform grid). The
    SPMD step caches a per-shard (cell list, ghost rows) pair in ``grav``
    with a leading shard axis on every leaf."""

    grav: object                       # CellList | (CellList, rows)
    grav_disp: jnp.ndarray             # f32: max-displacement sum since build
    grav_valid: jnp.ndarray            # bool
    grav_count: jnp.ndarray            # i32: alive count at build


jax.tree_util.register_dataclass(
    GridCache,
    data_fields=["grav", "grav_disp", "grav_valid", "grav_count"],
    meta_fields=[],
)


# ---------------------------------------------------------------------------
# Static geometry (shared by the force pass and the cache allocator)
# ---------------------------------------------------------------------------
def resolve_gravity_mode(opts: SimOptions, n_max: int) -> str:
    """The static backend dispatch of forces.compute_forces."""
    mode = opts.gravity_mode
    if mode == "auto":
        if opts.periodic:
            mode = "treepm" if opts.pmgrid > 0 else "tree"
        else:
            mode = "direct" if n_max <= opts.direct_threshold else "tree"
    return mode


def resolve_sph_backend(opts: SimOptions, ng: int) -> str:
    backend = opts.sph_backend
    if backend == "auto":
        backend = "dense" if ng <= 4096 else "cells"
    return backend


def grav_grid_geometry(cfg: SimConfig, opts: SimOptions, n_max: int):
    """(n_cells, capacity, margin) for the periodic TreePM short-range
    grid. The grid starts at the finest edge >= rcut and coarsens while
    the mean occupancy stays at or below 0.8 * 128 slots (the occupancy
    target; an ``sr_capacity`` override replaces the 128), buying a hard
    staleness margin for sparse runs. ``margin`` is the staleness budget
    (see module docstring); the capacity follows the pair backend
    (ops.cell_pairs.pair_backend)."""
    from gadget_leicester_tpu.ops.cell_pairs import (kernel_capacity,
                                                     pair_backend)
    from gadget_leicester_tpu.ops.pm import ASMTH, RCUT
    box = float(cfg.box_size)
    g = opts.pmgrid
    asmth_len = ASMTH * box / g
    rcut = RCUT * asmth_len
    n_cells = max(3, int(box / rcut))
    occ_target = 0.80 * (opts.sr_capacity if opts.sr_capacity > 0 else 128)
    while n_cells > 4 and n_max / (n_cells - 1) ** 3 <= occ_target:
        n_cells -= 1
    hard = box / n_cells - rcut
    margin = max(hard, SOFT_RCUT_FRAC * rcut)
    mean = n_max / n_cells**3
    if pair_backend(dtype=opts.dtype) == "triton":
        cap = kernel_capacity(mean, opts.sr_capacity)
    else:
        cap = opts.sr_capacity if opts.sr_capacity > 0 else max(
            64, int(8 * mean))
    return n_cells, cap, margin


def sph_cells_geometry(cfg: SimConfig, opts: SimOptions, ng: int):
    """(n_cells, capacity) for the SPH cell grid: cells ~1.6x the typical
    smoothing length (h is capped at the cell edge), capacity by the pair
    backend."""
    from gadget_leicester_tpu.ops.cell_pairs import (kernel_capacity,
                                                     pair_backend)
    if opts.sph_grid > 0:
        n_cells = opts.sph_grid
    else:
        spacing_cells = (ng ** (1.0 / 3.0)) / (
            1.6 * (3.0 * cfg.des_num_ngb / (4.0 * 3.14159)) ** (1.0 / 3.0))
        n_cells = max(3, int(spacing_cells))
    mean = ng / n_cells**3
    if pair_backend(dtype=opts.dtype) == "triton":
        cap = kernel_capacity(mean, opts.sph_capacity)
    else:
        cap = opts.sph_capacity if opts.sph_capacity > 0 else max(
            32, int(6 * mean))
    return n_cells, cap


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------
def _empty_cl(total_cells: int, capacity: int, n: int, n_cells, periodic,
              dtype) -> CellList:
    return CellList(
        cells=jnp.full((total_cells, capacity), -1, jnp.int32),
        cell_of=jnp.full((n,), -1, jnp.int32),
        counts=jnp.zeros((total_cells,), jnp.int32),
        overflow=jnp.asarray(False),
        gslot=jnp.full((n,), -1, jnp.int32),
        origin=jnp.zeros((3,), dtype),
        inv_cell=jnp.ones((3,), dtype),
        n_cells=n_cells,
        periodic=periodic,
    )


def make_grid_cache(cfg: SimConfig, opts: SimOptions, n_max: int,
                    ng: int) -> Optional[GridCache]:
    """Allocate an (invalid) cache matching the step's static grid
    geometry; the first force pass builds in place. None when no cached
    structure applies (non-TreePM gravity and dense SPH)."""
    f = jnp.float64 if opts.dtype == "f64" else jnp.float32
    mode = resolve_gravity_mode(opts, n_max)

    grav = None
    if mode == "treepm" and not opts.nogravity:
        n_cells, cap, _ = grav_grid_geometry(cfg, opts, n_max)
        grav = _empty_cl(n_cells**3, cap, n_max, n_cells, True, f)
    # (the SPH cell grid stays fresh-build: its h cap is the cell edge,
    # with no staleness slack)

    if grav is None:
        return None
    return GridCache(
        grav=grav,
        grav_disp=jnp.zeros((), jnp.float32),
        grav_valid=jnp.asarray(False),
        grav_count=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# In-step refresh
# ---------------------------------------------------------------------------
def note_drift(grids: Optional[GridCache], dx_max) -> Optional[GridCache]:
    """Accumulate this drift's max per-particle displacement (called by
    integrate.drift_all). ``dx_max``: traced scalar, max over alive
    particles of |dx|_inf."""
    if grids is None:
        return None
    d = jnp.asarray(dx_max, jnp.float32)
    return dataclasses.replace(
        grids, grav_disp=grids.grav_disp + d)


def refresh(cached_cl, valid, disp, count, margin, count_now, build_fn):
    """Shared rebuild-on-demand logic: returns (cl, valid', disp', count',
    rebuilt). ``margin`` may be traced; ``build_fn()`` builds fresh
    structures (any pytree matching ``cached_cl``)."""
    need = (~valid) | (2.0 * disp > margin) | (count_now != count)
    cl = jax.lax.cond(need, lambda _: build_fn(), lambda _: cached_cl,
                      operand=None)
    return (cl,
            jnp.asarray(True),
            jnp.where(need, jnp.float32(0.0), disp),
            jnp.where(need, count_now, count),
            need)
