"""Cell-list neighbour infrastructure — the array-program replacement for the
reference's tree-walk neighbour search [G2: ngb.c ::
ngb_treefind_variable()/ngb_treefind_pairs()].

The reference finds SPH neighbours by walking the gravity octree with
per-particle pointer chasing. Redesign (BASELINE.json north star:
"sorted cell lists"):

* bin particles into a uniform grid with FIXED per-cell capacity
  (static shapes; overflow detected, handled by recompute-with-bigger —
  the analog of GADGET's buffer-overflow bunching [SURVEY.md §5]);
* particles sorted by cell id (``jax.lax.sort`` = the Morton/PH-order
  analog of [G2: peano.c :: peano_hilbert_order()] for cache locality);
* interactions evaluated target-block x 27-stencil-candidates as wide
  masked vector ops (XLA path) or by the GPU cell-pair kernel
  (ops.cell_pairs) — every op static-shape.

The same structure serves SPH density (gather), SPH hydro (symmetric
pairs, cell >= global max h) and TreePM short-range gravity (cell >= rcut).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from gadget_leicester_tpu.ops.jit_util import hybrid_jit

import jax
import jax.numpy as jnp


@dataclass
class CellList:
    cells: jnp.ndarray      # [n_cells^3, capacity] int32 particle idx, -1 pad
    cell_of: jnp.ndarray    # [N] int32 flat cell id per particle
    counts: jnp.ndarray     # [n_cells^3] int32 occupancy (may exceed capacity!)
    overflow: jnp.ndarray   # bool scalar — any cell over capacity
    origin: jnp.ndarray     # [3] grid origin
    inv_cell: jnp.ndarray   # [3] 1/cell_size
    # [N] int32 flat slot index into cells.reshape(-1): gslot[p] such that
    # cells.reshape(-1)[gslot[p]] == p (-1 = dead/dropped). Lets merges be
    # one row GATHER per particle instead of per-component scatters.
    gslot: jnp.ndarray
    n_cells: int            # STATIC per-axis count — int (cube) or (nx,ny,nz)
    periodic: bool          # STATIC — bool or per-axis (px,py,pz) tuple


jax.tree_util.register_dataclass(
    CellList,
    data_fields=["cells", "cell_of", "counts", "overflow", "origin",
                 "inv_cell", "gslot"],
    meta_fields=["n_cells", "periodic"],
)


def _axes3(v):
    """Normalise an int/bool or 3-tuple to a 3-tuple (per-axis grids for
    slab-local SPMD domains: clamped in x, periodic in y/z)."""
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _flat_cell_id(coords, n_cells):
    _, ny, nz = _axes3(n_cells)
    return (coords[..., 0] * ny + coords[..., 1]) * nz + coords[..., 2]


@partial(hybrid_jit, static_argnames=("n_cells", "capacity", "periodic"))
def build_cell_list(
    pos,
    mask,
    origin,
    extent,
    n_cells: int,
    capacity: int,
    periodic: bool = False,
) -> CellList:
    """Bin `pos` into an n_cells^3 grid over [origin, origin+extent).

    Dead/masked particles land in no cell. Overflowing cells drop the
    excess (reported via ``overflow``; callers re-run with a larger
    capacity — recompute-bigger fallback, SURVEY.md §5).
    """
    n = pos.shape[0]
    ncv = _axes3(n_cells)
    pv = _axes3(periodic)
    origin = jnp.broadcast_to(jnp.asarray(origin, pos.dtype), (3,))
    extent = jnp.broadcast_to(jnp.asarray(extent, pos.dtype), (3,))
    inv_cell = jnp.asarray(ncv, pos.dtype) / extent
    rel = (pos - origin) * inv_cell
    coords = jnp.floor(rel).astype(jnp.int32)
    ncv_arr = jnp.asarray(ncv, jnp.int32)
    wrapped = jnp.mod(coords, ncv_arr)
    clamped = jnp.clip(coords, 0, ncv_arr - 1)
    coords = jnp.where(jnp.asarray(pv, bool), wrapped, clamped)
    cid = _flat_cell_id(coords, n_cells)
    total = ncv[0] * ncv[1] * ncv[2]
    cid = jnp.where(mask, cid, total)  # dead -> sentinel bucket

    order = jnp.argsort(cid)  # dead sort to the end
    cid_sorted = cid[order]
    # rank within cell: i - first occurrence of this cid, via an O(N)
    # cummax segment scan (searchsorted costs an extra O(N log N) pass)
    i_arr = jnp.arange(n, dtype=jnp.int32)
    newseg = jnp.concatenate([jnp.ones((1,), bool),
                              cid_sorted[1:] != cid_sorted[:-1]])
    first = jax.lax.cummax(jnp.where(newseg, i_arr, 0))
    rank = i_arr - first

    cells = jnp.full((total + 1, capacity), -1, jnp.int32)
    ok = rank < capacity
    cells = cells.at[
        jnp.where(ok, cid_sorted, total),
        jnp.where(ok, rank, 0),
    ].set(jnp.where(ok, order.astype(jnp.int32), -1), mode="drop")
    counts = jnp.zeros((total + 1,), jnp.int32).at[cid_sorted].add(1)
    overflow = jnp.any(counts[:total] > capacity)
    # inverse map for gather-merges: particle -> flat slot in cells
    ok_live = ok & (cid_sorted < total)
    gslot = jnp.full((n,), -1, jnp.int32).at[order].set(
        jnp.where(ok_live, cid_sorted * capacity + rank, -1))
    return CellList(
        cells=cells[:total],
        cell_of=jnp.where(mask, _flat_cell_id(coords, n_cells), -1),
        counts=counts[:total],
        overflow=overflow,
        gslot=gslot,
        origin=origin,
        inv_cell=inv_cell,
        n_cells=n_cells,
        periodic=periodic,
    )


def _stencil_cids(coords, n_cells, periodic):
    """[..., 27] flat cell ids of the 3^3 stencil around integer coords.
    Out-of-range cells (non-periodic axes) -> -1."""
    ncv = jnp.asarray(_axes3(n_cells), jnp.int32)
    pv = jnp.asarray(_axes3(periodic), bool)
    offs = jnp.stack(
        jnp.meshgrid(*([jnp.arange(-1, 2)] * 3), indexing="ij"), -1
    ).reshape(27, 3)
    c = coords[..., None, :] + offs  # [..., 27, 3]
    in_range = (c >= 0) & (c < ncv)
    valid = jnp.all(pv | in_range, axis=-1)
    c = jnp.where(pv, jnp.mod(c, ncv), jnp.clip(c, 0, ncv - 1))
    cid = _flat_cell_id(c, n_cells)
    return jnp.where(valid, cid, -1)


def candidate_indices(cl: CellList, target_pos):
    """For each target position: [T, 27*capacity] candidate particle
    indices (-1 = none). Memory is bounded by the caller blocking targets."""
    rel = (target_pos - cl.origin) * cl.inv_cell
    coords = jnp.floor(rel).astype(jnp.int32)
    ncv = jnp.asarray(_axes3(cl.n_cells), jnp.int32)
    pv = jnp.asarray(_axes3(cl.periodic), bool)
    coords = jnp.where(pv, jnp.mod(coords, ncv),
                       jnp.clip(coords, 0, ncv - 1))
    cids = _stencil_cids(coords, cl.n_cells, cl.periodic)      # [T,27]
    safe = jnp.maximum(cids, 0)
    cand = cl.cells[safe]                                      # [T,27,cap]
    cand = jnp.where(cids[..., None] >= 0, cand, -1)
    return cand.reshape(target_pos.shape[0], -1)               # [T,27*cap]


def apply_pairwise(
    cl: CellList,
    target_pos,
    pair_fn,
    block: int = 256,
    n_targets: int | None = None,
):
    """See below. ``n_targets`` restricts evaluation to the first
    n_targets rows of target_pos (the local-owned prefix in SPMD slabs;
    ghost sources still participate via the cell list)."""
    if n_targets is not None:
        target_pos = target_pos[:n_targets]
    return _apply_pairwise(cl, target_pos, pair_fn, block)


def _apply_pairwise(
    cl: CellList,
    target_pos,
    pair_fn,
    block: int = 256,
):
    """Blocked evaluation driver: for each target block, gather the stencil
    candidates and call ``pair_fn(tgt_idx, tgt_pos, cand_idx)`` where
    tgt_idx is [B] global target indices (clipped for the padded tail —
    those rows are discarded), tgt_pos is [B,3], and cand_idx is
    [B, 27*cap] (-1 padded). ``pair_fn`` returns a pytree of per-target
    reductions; results are concatenated over blocks.

    This is the rebuild of the export/evaluate/return bunch loop
    [G2: gravtree.c BunchSizeForce] — but as static-shape blocks.
    """
    t = target_pos.shape[0]
    nb = -(-t // block)
    tpad = nb * block
    pos_p = jnp.pad(target_pos, ((0, tpad - t), (0, 0)))

    def one_block(i):
        start = i * block
        idx = jnp.minimum(start + jnp.arange(block, dtype=jnp.int32), t - 1)
        tp = jax.lax.dynamic_slice(pos_p, (start, 0), (block, 3))
        cand = candidate_indices(cl, tp)
        return pair_fn(idx, tp, cand)

    out = jax.lax.map(one_block, jnp.arange(nb))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((tpad,) + x.shape[2:])[:t], out
    )


