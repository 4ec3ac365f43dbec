"""Owner-computes domain-decomposed SPMD step — the production rebuild of
the reference's spatial domain decomposition and ghost exchange
[G2: domain.c :: domain_Decomposition(), domain_exchangeParticles();
gravtree.c / density.c / hydra.c export-evaluate-import loops].

Design (explicit shard_map + collectives — no GSPMD all-gathers of
particle sources):

* **Ownership**: periodic x-slabs, one per device of the ``shard`` mesh
  axis. Every shard holds a FIXED-capacity chunk of each SimState array
  (particle dims sharded on dim 0), gas slots first within the chunk — so
  shard_map's local view IS a smaller valid SimState (the layout
  invariant "gas occupies slots [0, n_gas)" holds per shard).
* **Migration** [G2: domain_exchangeParticles]: after the drift, particles
  that crossed a slab face are compacted into fixed buffers, ppermute'd
  one hop (per-step drifts are << a slab width), and merged into dead
  slots; capacity overrun or >1-slab jumps raise overflow_flags bit 4.
* **Ghosts** [G2: gravtree.c export buffers]: boundary strips within the
  interaction range of a face travel both ways via ppermute. Short-range
  gravity uses rcut; SPH uses its h cap, with TWO rounds per step —
  positions/velocities before density, density/pressure fields before
  hydro — exactly the reference's two communication phases.
* **Forces**: each shard builds a LOCAL anisotropic cell grid over
  [x0-range, x1+range) x [0, box)^2 (clamped in x, periodic in y/z) and
  runs the same cell-list pair sums as one device (the GPU kernel or the
  XLA path, ops.cell_pairs.pair_backend) with targets = the owned prefix
  and ghosts as sources only (ops.neighbors per-axis grids, n_targets).
* **PM**: parallel.pm_sharded.pm_local_forces (local deposit +
  psum_scatter to slabs + pencil FFT + all_gather of the force mesh).
* **Global control**: sync tick via pmin; PM rms-displacement via psum.

* **Sinks**: formation elects a global winner (pmax + owner election);
  accretion ships compacted sink blocks around the ring and returns
  ghost-sink deltas to owners. The replicated registry keys by PID
  (shard-local rows churn under migration).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from gadget_leicester_tpu.core.config import (GAMMA, GAMMA_MINUS1,
                                              SimConfig, SimOptions)
from gadget_leicester_tpu.core.state import GasState, ParticleState, SimState
from gadget_leicester_tpu.core import timeline
from gadget_leicester_tpu.models import integrate
from gadget_leicester_tpu.models.forces import (comoving_factors,
                                                softening_table)
from gadget_leicester_tpu.ops.cell_pairs import kernel_capacity, pair_backend
from gadget_leicester_tpu.ops.softening import SOFTFAC
from gadget_leicester_tpu.parallel.mesh import AXIS

# f32 pair sums: no TF32 on GPU tensor cores
HIGHEST = jax.lax.Precision.HIGHEST

_P_FIELDS = ["pos", "vel", "mass", "ptype", "pid", "acc", "acc_pm",
             "pot", "pot_pm", "old_acc", "ti_begstep", "ti_endstep"]


# ---------------------------------------------------------------------------
# Host-side layout conversion
# ---------------------------------------------------------------------------
def balance_edges(pos_x, alive, box: float, d: int,
                  min_width: float = 0.0, origin: float = 0.0,
                  periodic: bool = True) -> np.ndarray:
    """Cost-balanced slab boundaries — the rebuild of the reference's
    work-balanced domain split [G2: domain.c :: domain_decompose() with
    GravCost weights]: slab edges at the x-quantiles of the alive
    particles (equal counts => equal tile/sort/pack work per shard),
    blended back toward uniform just enough to honour min_width (the
    rcut / SPH-cell ghost constraint). Vacuum runs (periodic=False) work
    in the domain frame [origin, origin+box) -> [0, box)."""
    x_raw = np.asarray(pos_x)[np.asarray(alive)]
    x = np.sort(np.mod(x_raw, box) if periodic
                else np.clip(x_raw - origin, 0.0, box))
    if len(x) == 0:
        return np.linspace(0.0, box, d + 1)
    q = np.quantile(x, np.linspace(0.0, 1.0, d + 1))
    q[0], q[-1] = 0.0, box
    uniform = np.linspace(0.0, box, d + 1)
    # blend toward uniform until every slab is >= min_width
    for t in np.linspace(0.0, 1.0, 21):
        e = (1 - t) * q + t * uniform
        if min_width <= 0 or np.min(np.diff(e)) >= min_width:
            return e
    return uniform


def spmd_min_width(cfg: SimConfig, opts: SimOptions, n_gas: int,
                   extent: float | None = None) -> float:
    """The slab-width floor: every slab must span at least rcut (gravity
    ghosts) and the SPH cell edge (density/hydro ghosts). ``extent``
    overrides cfg.box_size (the vacuum domain cube edge)."""
    from gadget_leicester_tpu.ops.pm import ASMTH, RCUT
    box = float(cfg.box_size) if extent is None else float(extent)
    rcut = RCUT * ASMTH * box / max(opts.pmgrid, 1)
    spacing_cells = (n_gas ** (1.0 / 3.0)) / (
        1.6 * (3.0 * cfg.des_num_ngb / (4.0 * 3.14159)) ** (1.0 / 3.0))
    cell_sph = box / max(3, int(spacing_cells))
    return max(rcut, cell_sph) * 1.02


# slot head-room of the slab layout: to_spmd sizes per-shard chunks as
# ceil(max_shard_count / SLAB_FILL) — so SLAB_FILL * n_slots is also the
# step's estimator of the REAL max-shard particle count (grid occupancy
# tuning must not count dead padding; see _gravity/_sph)
SLAB_FILL = 0.6


def to_spmd(state: SimState, mesh: Mesh, cfg: SimConfig,
            fill_frac: float = SLAB_FILL, edges=None, min_width: float = 0.0,
            domain=None):
    """Re-lay a canonical SimState into the per-shard slab layout.

    Each shard's chunk is [cap_g gas slots | cap_r other slots]; global
    arrays are the concatenation over shards. ``edges`` ([d+1] slab
    boundaries; None = cost-balanced via :func:`balance_edges`).
    ``domain``: (origin[3], extent) static cube for vacuum runs — edges
    and slab membership then live in the domain frame [0, extent).
    Returns (state, (cap_g, cap_r), edges)."""
    d = mesh.shape[AXIS]
    per = domain is None
    box = float(cfg.box_size) if per else float(domain[1])
    orig_x = 0.0 if per else float(np.asarray(domain[0]).reshape(3)[0])
    p = state.p
    ng = state.gas.n_gas_max
    pos = np.asarray(p.pos)
    alive = np.asarray(p.alive)
    is_gas = np.zeros(p.n_max, bool)
    is_gas[:ng] = np.asarray(p.ptype[:ng] == 0) & alive[:ng]
    is_rest = alive & ~is_gas
    if edges is None:
        edges = balance_edges(pos[:, 0], alive, box, d, min_width,
                              origin=orig_x, periodic=per)
    edges = np.asarray(edges, np.float64)
    xw = np.mod(pos[:, 0], box) if per else np.clip(
        pos[:, 0] - orig_x, 0.0, np.nextafter(box, 0.0))
    slab = np.clip(np.searchsorted(edges, xw, side="right") - 1, 0, d - 1)

    def cap_for(sel):
        counts = np.bincount(slab[sel], minlength=d)
        return max(8, int(np.ceil(counts.max() / fill_frac / 8.0)) * 8)

    cap_g, cap_r = cap_for(is_gas), cap_for(is_rest)
    stride = cap_g + cap_r
    nm, ngm = d * stride, d * cap_g

    dst = np.full(p.n_max, -1, np.int64)
    for sh in range(d):
        rows_g = np.where(is_gas & (slab == sh))[0]
        dst[rows_g] = sh * stride + np.arange(len(rows_g))
        rows_r = np.where(is_rest & (slab == sh))[0]
        dst[rows_r] = sh * stride + cap_g + np.arange(len(rows_r))

    def scat(arr, n_out, rows, dd):
        a = np.asarray(arr)
        out = np.zeros((n_out,) + a.shape[1:], a.dtype)
        out[dd] = a[rows]
        return jnp.asarray(out)

    rows_all = np.where(dst >= 0)[0]
    newp = ParticleState(
        **{f: scat(getattr(p, f), nm, rows_all, dst[rows_all])
           for f in _P_FIELDS},
        alive=scat(p.alive, nm, rows_all, dst[rows_all]))

    rows_g = np.where(is_gas)[0]
    gdst = dst[rows_g]
    gdst = (gdst // stride) * cap_g + gdst % stride
    g = state.gas
    newg = GasState(**{
        f.name: scat(getattr(g, f.name), ngm, rows_g, gdst)
        for f in dataclasses.fields(g)})
    newg = dataclasses.replace(
        newg,
        dhsml_density_factor=jnp.where(
            jnp.asarray(newg.hsml) > 0, newg.dhsml_density_factor, 1.0),
        hsml=jnp.maximum(newg.hsml, 1e-30))
    # sink registry: canonical slots are ROW indices; rows churn under
    # migration, so the slab layout keys the registry by PID instead
    # (translated back by spmd_to_canonical)
    sinks = state.sinks
    slot = np.asarray(sinks.slot)
    if np.any(slot >= 0):
        pid = np.asarray(p.pid)
        slot = np.where(slot >= 0, pid[np.maximum(slot, 0)], -1)
        sinks = dataclasses.replace(
            sinks, slot=jnp.asarray(slot.astype(np.int32)))
    # grid caches are layout-specific derived data — drop on re-layout
    return (dataclasses.replace(state, p=newp, gas=newg, sinks=sinks,
                                grids=None),
            (cap_g, cap_r), edges)


def from_spmd(state: SimState, cap_g: int, cap_r: int):
    """Extract the alive particles of a slab-layout state as host arrays
    (pos, vel, mass, ptype, source_rows) — for quick analysis. For the
    FULL state (snapshots/energy/restart/re-decomposition) use
    :func:`spmd_to_canonical`, which is lossless."""
    alive = np.asarray(state.p.alive)
    rows = np.where(alive)[0]
    pos = np.asarray(state.p.pos)[rows]
    vel = np.asarray(state.p.vel)[rows]
    mass = np.asarray(state.p.mass)[rows]
    ptype = np.asarray(state.p.ptype)[rows]
    return pos, vel, mass, ptype, rows


def spmd_to_canonical(state: SimState, cap_g: int, cap_r: int) -> SimState:
    """LOSSLESS slab-layout -> canonical-layout conversion.

    The slab layout interleaves per-shard chunks [cap_g gas | cap_r other];
    the canonical layout wants ALL gas slots first. Permuting particle rows
    so every shard's gas block comes first restores the canonical invariant
    (gas state arrays are already in exactly that order, so they pass
    through unchanged); every dynamical field (acc, ti_*, entropy, ...)
    survives — this is the bridge the snapshot writer, energy instrument,
    restart dump, and re-decomposition all share [G2: the reference never
    needs this because its I/O walks per-rank arrays directly]."""
    stride = cap_g + cap_r
    d = state.p.n_max // stride
    gas_rows = (np.arange(d)[:, None] * stride
                + np.arange(cap_g)[None, :]).reshape(-1)
    rest_rows = (np.arange(d)[:, None] * stride + cap_g
                 + np.arange(cap_r)[None, :]).reshape(-1)
    order = jnp.asarray(np.concatenate([gas_rows, rest_rows]))
    newp = ParticleState(
        **{f: getattr(state.p, f)[order] for f in _P_FIELDS},
        alive=state.p.alive[order])
    # sink registry: slab layout keys by PID (see to_spmd) — translate
    # back to canonical ROW indices
    sinks = state.sinks
    slot = np.asarray(sinks.slot)
    if np.any(slot >= 0):
        pid = np.asarray(newp.pid)
        alive = np.asarray(newp.alive)
        row_of = {int(q): r for r, q in enumerate(pid) if alive[r]}
        slot = np.asarray([row_of.get(int(s), -1) if s >= 0 else -1
                           for s in slot], np.int32)
        sinks = dataclasses.replace(sinks, slot=jnp.asarray(slot))
    return dataclasses.replace(state, p=newp, sinks=sinks, grids=None)


def state_specs(state: SimState):
    """PartitionSpecs: particle/gas arrays sharded on dim 0, everything
    else (sink registry, scalars, rng) replicated."""
    psh = ParticleState(**{f: P(AXIS) if f in ("mass", "ptype", "pid", "pot",
                                               "pot_pm", "old_acc",
                                               "ti_begstep", "ti_endstep")
                           else P(AXIS, None)
                           for f in _P_FIELDS},
                        alive=P(AXIS))
    gsh = GasState(**{
        f.name: P(AXIS, None) if f.name in ("vel_pred", "hydro_acc")
        else P(AXIS)
        for f in dataclasses.fields(GasState)})
    rep = jax.tree_util.tree_map(lambda _: P(), state.sinks)
    # grid-cache leaves all carry a leading shard dim (make_spmd_grid_cache)
    grids_spec = jax.tree_util.tree_map(lambda _: P(AXIS), state.grids)
    return dataclasses.replace(
        state, p=psh, gas=gsh, sinks=rep, grids=grids_spec,
        ti_current=P(), pm_ti_endstep=P(), pm_ti_begstep=P(),
        rng_key=P(), overflow_flags=P())


# ---------------------------------------------------------------------------
# Static slab-grid geometry + the per-shard grid cache
# ---------------------------------------------------------------------------
def slab_grid_geom(cfg: SimConfig, opts: SimOptions, d: int, box: float,
                   w_min: float, n_loc: int) -> dict:
    """Static geometry of the per-shard short-range gravity grid, shared by
    the step factory and the cache allocator (shapes must match exactly —
    lax.cond pytrees) [G2: domain.c + forcetree.c rebuild cadence — the
    cache IS the rebuild cadence]. The capacity follows the pair backend
    (ops.cell_pairs.pair_backend)."""
    from gadget_leicester_tpu.models.grids import SOFT_RCUT_FRAC
    from gadget_leicester_tpu.ops.cell_pairs import (kernel_capacity,
                                                     pair_backend)
    from gadget_leicester_tpu.ops.pm import ASMTH, RCUT

    g_pm = opts.pmgrid
    asmth_len = ASMTH * box / g_pm
    rcut = RCUT * asmth_len
    nyz = max(3, int(box / rcut))
    gcap_g = _ghost_cap(n_loc, rcut, w_min, opts.spmd_ghost_frac)
    nx = max(1, int((w_min + 2.0 * rcut) / rcut))
    if pair_backend(dtype=opts.dtype) == "triton":
        # REAL-count estimate (slot counts carry the to_spmd fill padding
        # and the ghost buffers' dead slots)
        n_est = SLAB_FILL * n_loc * (1.0 + 3.0 * rcut / w_min)
        cap_sr = kernel_capacity(n_est / (nx * nyz * nyz), opts.sr_capacity)
    else:
        n_cat = n_loc + 2 * gcap_g
        cap_sr = opts.sr_capacity if opts.sr_capacity > 0 else max(
            64, -(-3 * n_cat // (nx * nyz * nyz) // 8) * 8)
    edge_x_min = (w_min + 2.0 * rcut) / nx
    margin_g = max(min(edge_x_min, box / nyz) - rcut, SOFT_RCUT_FRAC * rcut)
    return dict(rcut=rcut, gcap_g=gcap_g, cap_sr=cap_sr, nx=nx, nyz_g=nyz,
                margin_g=margin_g)


def make_spmd_grid_cache(cfg: SimConfig, opts: SimOptions, mesh: Mesh,
                         caps, edges, domain=None):
    """Allocate the (invalid) per-shard grid cache for the slab step —
    the SPMD port of models.grids.make_grid_cache. Every leaf carries a
    leading shard dim d (spec P(AXIS)); the local view inside shard_map
    is [1, ...] and the step squeezes/unsqueezes it.

    Cached per shard: the gravity cell list + its ghost-strip row
    selection. Ghost ROWS are part of the cache because the cell list
    indexes the concatenated [locals | ghosts] arrays: reusing assignments
    requires the ghost buffer slot -> particle map to stay fixed between
    rebuilds [G2: forcetree.c drifts node centres between rebuilds; export
    lists are regenerated — here the export SELECTION is frozen with the
    grid and only the VALUES are re-gathered each step]."""
    from gadget_leicester_tpu.models.grids import GridCache, _empty_cl

    d = mesh.shape[AXIS]
    per = bool(opts.periodic)
    box = float(cfg.box_size) if per else float(domain[1])
    edges = np.asarray(edges, np.float64)
    w_min = float(np.min(np.diff(edges)))
    cap_g, cap_r = caps
    n_loc = cap_g + cap_r
    geo = slab_grid_geom(cfg, opts, d, box, w_min, n_loc)
    f = jnp.float64 if opts.dtype == "f64" else jnp.float32

    def rep(tree):
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (d,) + x.shape), tree)

    nx, nyz_g, cap_sr = geo["nx"], geo["nyz_g"], geo["cap_sr"]
    n_cat_g = n_loc + 2 * geo["gcap_g"]
    grav_cl = _empty_cl(nx * nyz_g * nyz_g, cap_sr, n_cat_g,
                        (nx, nyz_g, nyz_g), (False, per, per), f)
    grav = rep((grav_cl, jnp.full((2 * geo["gcap_g"],), -1, jnp.int32)))
    return GridCache(
        grav=grav,
        grav_disp=jnp.zeros((d,), jnp.float32),
        grav_valid=jnp.zeros((d,), bool),
        grav_count=jnp.zeros((d,), jnp.int32),
    )


# ---------------------------------------------------------------------------
# In-shard primitives
# ---------------------------------------------------------------------------
def _pack(fields, mask, cap):
    """Stream-compact rows where mask into [cap] buffers (+count, ovf)."""
    idxpos = jnp.cumsum(mask) - 1
    put = jnp.where(mask & (idxpos < cap), idxpos, cap)
    outs = []
    for f in fields:
        buf = jnp.zeros((cap + 1,) + f.shape[1:], f.dtype)
        buf = buf.at[put].set(
            jnp.where(mask.reshape((-1,) + (1,) * (f.ndim - 1)), f,
                      jnp.zeros((), f.dtype)), mode="drop")
        outs.append(buf[:cap])
    count = jnp.sum(mask)
    return outs, count, count > cap


def _ring(bufs, direction, n_shards):
    """ppermute a list of arrays one hop around the slab ring.
    direction +1: data moves to the RIGHT neighbour (i -> i+1)."""
    perm = [(i, (i + direction) % n_shards) for i in range(n_shards)]
    return [jax.lax.ppermute(b, AXIS, perm) for b in bufs]


def _ghost_exchange(fields, pos_x, alive, x0, x1, margin, gcap, n_shards):
    """Both-ways boundary-strip exchange. Returns ([2*gcap]-ghost arrays,
    ghost-valid mask, overflow)."""
    near_l = alive & (pos_x < x0 + margin)
    near_r = alive & (pos_x >= x1 - margin)
    bl, cl_, o1 = _pack(fields, near_l, gcap)
    br, cr_, o2 = _pack(fields, near_r, gcap)
    from_left = _ring(br + [cr_.reshape(1)], +1, n_shards)
    from_right = _ring(bl + [cl_.reshape(1)], -1, n_shards)
    c_l, c_r = from_left[-1][0], from_right[-1][0]
    ghosts = [jnp.concatenate([a, b])
              for a, b in zip(from_left[:-1], from_right[:-1])]
    gvalid = jnp.concatenate([jnp.arange(gcap) < c_l,
                              jnp.arange(gcap) < c_r])
    return ghosts, gvalid, o1 | o2 | (c_l > gcap) | (c_r > gcap)


def _select_rows(mask, cap):
    """Packed row indices [cap] (int32, -1 pad) of ``mask`` + overflow —
    the index-only half of _pack (the cached-ghost selection)."""
    n = mask.shape[0]
    idxpos = jnp.cumsum(mask) - 1
    put = jnp.where(mask & (idxpos < cap), idxpos, cap)
    rows = jnp.full((cap + 1,), -1, jnp.int32).at[put].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")[:cap]
    return rows, jnp.sum(mask) > cap


def _ghost_rows_select(pos_x, alive, x0, x1, reach, gcap):
    """Fresh boundary-strip row selection: [2*gcap] rows (to-left block
    first), + overflow."""
    rl, o1 = _select_rows(alive & (pos_x < x0 + reach), gcap)
    rr, o2 = _select_rows(alive & (pos_x >= x1 - reach), gcap)
    return jnp.concatenate([rl, rr]), o1 | o2


def _ghost_exchange_rows(fields, alive, rows, gcap, n_shards):
    """Rows-driven both-ways boundary exchange — the cached-selection
    analog of _ghost_exchange. ``rows`` [2*gcap] from _ghost_rows_select
    (possibly from a PREVIOUS sync point: the cell lists index ghost
    slots, so slot -> particle must stay fixed between grid rebuilds);
    validity ships as data (a cached row may have died since selection).
    Returns ([2*gcap] ghost arrays in [from-left | from-right] order,
    ghost-valid mask)."""
    rl, rr = rows[:gcap], rows[gcap:]

    def gather(rws):
        v = (rws >= 0) & alive[jnp.maximum(rws, 0)]
        outs = [jnp.where(v.reshape((-1,) + (1,) * (f.ndim - 1)),
                          f[jnp.maximum(rws, 0)], jnp.zeros((), f.dtype))
                for f in fields]
        return outs, v

    bl, vl = gather(rl)
    br, vr = gather(rr)
    from_left = _ring(br + [vr.astype(jnp.int32)], +1, n_shards)
    from_right = _ring(bl + [vl.astype(jnp.int32)], -1, n_shards)
    ghosts = [jnp.concatenate([a, b])
              for a, b in zip(from_left[:-1], from_right[:-1])]
    gvalid = jnp.concatenate([from_left[-1] > 0, from_right[-1] > 0])
    return ghosts, gvalid


def _wrap_to_slab(x, xc, box):
    """Ghost/local x mapped to the frame of the slab centred at xc."""
    return xc + (x - xc) - box * jnp.round((x - xc) / box)


def _ghost_x(gx, x0, x1, margin, box, gcap):
    """Directional ghost-x mapping for a [2*gcap] _ghost_exchange buffer:
    the from-left half lands in [x0-margin, x0+...), the from-right half
    in [x1, x1+margin+...). The slab-CENTRE wrap is ambiguous for d <= 2
    (at d=1 both halves come from the SAME slab and must land on
    OPPOSITE faces; the centre wrap drops a ghost onto its original,
    doubling boundary-cell occupancy and hiding it from the far face's
    stencil) — the per-face mod is exact for every d."""
    lo = x0 - margin
    gl = lo + jnp.mod(gx[:gcap] - lo, box)
    gr = x1 + jnp.mod(gx[gcap:] - x1, box)
    return jnp.concatenate([gl, gr])


def _ghost_cap(n_local: int, reach: float, w_min: float,
               frac_override: float = 0.0) -> int:
    """Static per-direction ghost-buffer capacity: boundary-strip
    occupancy (reach/w_min of the chunk) with 2x clustering safety,
    never more than the whole chunk."""
    frac = frac_override if frac_override > 0.0 else min(
        1.0, 2.0 * reach / max(w_min, 1e-30))
    return min(n_local, max(8, -(-int(frac * n_local) // 8) * 8))


def _insert_into_dead(fields, alive, recv, valid_in):
    """Scatter received rows into dead slots; returns (fields, alive, ovf).

    Arrivals are ranked by a cumsum over the valid mask (NOT their raw
    buffer position — the right-neighbour block starts at mcap, so raw
    positions can exceed the dead-slot count even when the total count
    fits) and inserted dead-slot k <- k-th valid arrival."""
    n = alive.shape[0]
    order = jnp.argsort(alive.astype(jnp.int32))     # dead first (stable)
    n_dead = jnp.sum(~alive)
    rank = jnp.cumsum(valid_in) - 1                  # rank among valid rows
    tgt = jnp.where(valid_in & (rank < n_dead),
                    order[jnp.minimum(rank, n - 1)], n)
    outs = []
    for f, rec in zip(fields, recv):
        fbuf = jnp.concatenate([f, jnp.zeros((1,) + f.shape[1:], f.dtype)])
        outs.append(fbuf.at[tgt].set(rec, mode="drop")[:n])
    alive_new = jnp.concatenate([alive, jnp.zeros((1,), bool)]).at[tgt].set(
        True, mode="drop")[:n]
    return outs, alive_new, jnp.sum(valid_in) > n_dead


# ---------------------------------------------------------------------------
# The SPMD step factory
# ---------------------------------------------------------------------------
def make_spmd_step(cfg: SimConfig, opts: SimOptions, mesh: Mesh,
                   edges=None, migrate_frac: float = 0.15, domain=None,
                   phases: frozenset = frozenset(
                       ("drift", "migrate", "gravity", "sph", "kick"))):
    """Jitted owner-computes sync-point step over `mesh` (state in the
    to_spmd slab layout). ``edges``: the [d+1] slab boundaries from
    to_spmd (None = uniform) — cost-balanced decomposition bakes them as
    constants; repartitioning recompiles, exactly the cadence of the
    reference's occasional domain_Decomposition().

    Two geometries [G2: domain.c serves every config]:

    * periodic TreePM (+SPH): opts.periodic with PMGRID — slab ring over
      the box, ghost x wraps, pencil-FFT PM.
    * VACUUM TreePM (+SPH): opts.periodic False, PMGRID > 0, ``domain``
      = (origin[3], extent) a static cube enclosing all particles with
      headroom. The long-range split is the free-space PM
      (pm_local_forces_vacuum, one octant psum) with the SAME
      erfc/erf asmth as periodic; slabs partition the domain-frame x,
      ghosts are MASKED (never wrapped) at the outer faces, every cell
      grid is clamped on all axes, and minimum image is off. Escapees
      raise flag bit 4 -> the host re-fits the domain and re-decomposes
      (the occasional domain_Decomposition cadence). The reference's
      vacuum runs decompose the same way [G2: pm_nonperiodic.c +
      domain.c].

    Every slab must be >= rcut and >= the SPH cell edge."""
    from gadget_leicester_tpu.ops.pm import ASMTH, RCUT

    d = mesh.shape[AXIS]
    per = bool(opts.periodic)
    if per:
        box = float(cfg.box_size)
        dom0 = np.zeros(3, np.float64)
    else:
        if domain is None or opts.pmgrid <= 0:
            raise NotImplementedError(
                "vacuum SPMD requires PMGRID > 0 (vacuum TreePM) and a "
                "domain=(origin, extent) cube")
        box = float(domain[1])
        dom0 = np.asarray(domain[0], np.float64).reshape(3)
    dom0_j = jnp.asarray(dom0, jnp.float32)
    if edges is None:
        edges = np.linspace(0.0, box, d + 1)
    edges = np.asarray(edges, np.float64)
    w_min = float(np.min(np.diff(edges)))
    edges_j = jnp.asarray(edges, jnp.float32)
    g_pm = opts.pmgrid
    asmth_len = ASMTH * box / g_pm
    rcut = RCUT * asmth_len
    if w_min < rcut:
        raise ValueError(f"min slab width {w_min:.1f} < rcut {rcut:.1f}: "
                         "fewer shards or finer PM mesh")
    # the SAME pair sums as the single-device path serve the slab domains
    # (anisotropic grids: clamped x, periodic y/z) [G2: the reference's MPI
    # ranks run the same force loops as serial]
    pairs = pair_backend(dtype=opts.dtype)
    pyz = per            # y/z cell-grid periodicity (vacuum: all clamped)

    def _wx(x):
        """Absolute x -> domain-frame x in [0, box)."""
        return jnp.mod(x, box) if per else x - dom0_j[0]

    def _dompos(q):
        """Absolute positions -> domain frame (vacuum shifts ALL axes by
        dom0 so cell origins stay at 0; periodic uses raw coords)."""
        return q if per else q - dom0_j[None, :]

    def _fix_ghost_x(gx, x0, x1, margin, gvalid, gcap):
        """Periodic: remap wrapped ghost x onto the receiving slab's
        faces (_ghost_x). Vacuum: identity — but a ghost must LIE in the
        half-strip it arrived for ([x0-margin, x0) from the left, [x1,
        x1+margin) from the right); ring arrivals across an OUTER face
        (and d=1 self-arrivals) fail the test and are masked, the vacuum
        analog of 'no neighbour there'."""
        if per:
            return _ghost_x(gx, x0, x1, margin, box, gcap), gvalid
        ok = jnp.concatenate([
            (gx[:gcap] >= x0 - margin) & (gx[:gcap] < x0),
            (gx[gcap:] >= x1) & (gx[gcap:] < x1 + margin)])
        return gx, gvalid & ok

    def _migrate(st, me):
        p = st.p
        cap_g = st.gas.n_gas_max
        mcap = max(8, int(migrate_frac * p.n_max))
        xw = _wx(p.pos[:, 0])
        slab_of = jnp.clip(
            jnp.searchsorted(edges_j, xw, side="right") - 1, 0, d - 1
        ).astype(jnp.int32)
        stay = slab_of == me
        go_l = p.alive & (slab_of == jnp.mod(me - 1, d)) & ~stay
        go_r = p.alive & (slab_of == jnp.mod(me + 1, d)) & ~stay
        lost = p.alive & ~stay & ~go_l & ~go_r
        if not per:
            # domain escapees (any axis) force a host re-fit of the
            # static cube: same flag bit as a multi-slab hop (the host
            # response — re-decompose — is identical)
            rel = _dompos(p.pos)
            lost = lost | (p.alive & jnp.any((rel < 0.0) | (rel >= box),
                                             axis=1))
        lost_flag = st.overflow_flags | jnp.where(
            jnp.any(lost), jnp.int32(4), jnp.int32(0))
        if d == 1:
            # one slab: slab_of is clipped to 0 == me, so nothing ever
            # hops (go_l/go_r are constant-False); only the lost check
            # above has content (vacuum escapees)
            return dataclasses.replace(st, overflow_flags=lost_flag)

        gfields = [getattr(st.gas, f.name)
                   for f in dataclasses.fields(st.gas)]

        def move_block(lo, hi, gas_block):
            sl, sr = go_l[lo:hi], go_r[lo:hi]
            fields = [getattr(p, f)[lo:hi] for f in _P_FIELDS]
            if gas_block:
                fields = fields + gfields
            bl, cl_, o1 = _pack(fields, sl, mcap)
            br, cr_, o2 = _pack(fields, sr, mcap)
            from_r = _ring(bl + [cl_.reshape(1)], -1, d)
            from_l = _ring(br + [cr_.reshape(1)], +1, d)
            recv = [jnp.concatenate([a, b])
                    for a, b in zip(from_l[:-1], from_r[:-1])]
            c_l, c_r = from_l[-1][0], from_r[-1][0]
            valid_in = jnp.concatenate([jnp.arange(mcap) < c_l,
                                        jnp.arange(mcap) < c_r])
            alive_blk = p.alive[lo:hi] & stay[lo:hi]
            outs, alive_new, o3 = _insert_into_dead(fields, alive_blk,
                                                    recv, valid_in)
            ovf = o1 | o2 | o3 | (c_l > mcap) | (c_r > mcap)
            return outs, alive_new, ovf

        def do_moves(_):
            outs_g, alive_g, ovf_g = move_block(0, cap_g, True)
            outs_r, alive_r, ovf_r = move_block(cap_g, p.n_max, False)
            p_new = ParticleState(
                **{f: jnp.concatenate([outs_g[i], outs_r[i]])
                   for i, f in enumerate(_P_FIELDS)},
                alive=jnp.concatenate([alive_g, alive_r]))
            gas_new = GasState(**{
                f.name: outs_g[len(_P_FIELDS) + i]
                for i, f in enumerate(dataclasses.fields(st.gas))})
            return p_new, gas_new, ovf_g | ovf_r

        def no_moves(_):
            return p, st.gas, jnp.asarray(False)

        # most sync points move NOBODY (a slab width is many step
        # displacements), yet the pack/ring/scatter machinery touches
        # every field of every particle. Gate it on a GLOBAL
        # any-hop predicate: psum makes the lax.cond branch uniform
        # across shards, so the ppermutes inside stay in lockstep
        # [G2: domain.c re-decomposes on a cadence, not every step —
        # the common case does no particle exchange at all]
        n_move = jax.lax.psum(
            jnp.sum((go_l | go_r).astype(jnp.int32)), AXIS)
        p_new, gas_new, ovf = jax.lax.cond(
            n_move > 0, do_moves, no_moves, operand=None)
        flags = lost_flag | jnp.where(ovf, jnp.int32(4), jnp.int32(0))
        grids = st.grids
        if grids is not None:
            # migration re-slots particle rows: every cached cell list /
            # ghost-row selection goes stale the moment anyone moves
            # (n_move is psum'd, so the invalidation is shard-uniform)
            moved = n_move > 0
            grids = dataclasses.replace(
                grids, grav_valid=grids.grav_valid & ~moved)
        return dataclasses.replace(st, p=p_new, gas=gas_new, grids=grids,
                                   overflow_flags=flags)

    def _gravity(st, me, x0, x1, xc, is_pm_step):
        from gadget_leicester_tpu.models.forces import _treepm_gravity  # noqa
        from gadget_leicester_tpu.ops.gravity_short import \
            shortrange_gravity_cells
        from gadget_leicester_tpu.ops.neighbors import build_cell_list
        from gadget_leicester_tpu.parallel.pm_sharded import pm_local_forces

        p = st.p
        fac = comoving_factors(cfg, st.ti_current)
        active = (p.ti_endstep == st.ti_current) & p.alive
        eps = softening_table(cfg, fac.atime)
        soft = SOFTFAC * eps[p.ptype]

        # the PM potential column (one extra inverse FFT + a 4th gather
        # component) is computed only for its in-step consumers — sinks
        # and Stamatellos cooling; diagnostics recompute on demand from
        # the canonical state [G2: potential.c runs on its own cadence]
        want_pot_pm = opts.sinks or opts.cooling == "stamatellos"

        def compute_pm(_):
            if per:
                res = pm_local_forces(p.pos, p.mass, p.alive, box, g_pm,
                                      d, with_potential=want_pot_pm)
            else:
                from gadget_leicester_tpu.parallel.pm_sharded import \
                    pm_local_forces_vacuum
                res = pm_local_forces_vacuum(
                    p.pos, p.mass, p.alive, dom0_j, box, g_pm,
                    with_potential=want_pot_pm)
            if want_pot_pm:
                a, pt = res
            else:
                a, pt = res, jnp.zeros((p.n_max,), p.mass.dtype)
            return a * cfg.grav_internal, pt

        with jax.named_scope("spmd_pm"):
            acc_pm, pot = jax.lax.cond(
                is_pm_step, compute_pm,
                lambda _: (p.acc_pm,
                           p.pot_pm / jnp.maximum(cfg.grav_internal,
                                                  1e-37)),
                operand=None)

        # O(surface) ghost buffers [G2: gravtree.c exports only flagged
        # boundary particles, bounded by BufferSize]: the strip within
        # rcut (+ the staleness margin) of a face holds
        # ~ n_local * reach/slab_width particles; 2x safety for
        # clustering + the chunk-fill headroom. Overflow raises flag
        # bit 1 and the host re-runs with a bigger fraction.
        # Grid/ghost-row SELECTION is cached in st.grids (the rebuild
        # cadence of [G2: forcetree.c + domain.c]); the rebuild predicate
        # is psum'd so every shard takes the same branch (the ring
        # exchange itself runs every step, outside the cond).
        geo = slab_grid_geom(cfg, opts, d, box, w_min, p.n_max)
        gcap = geo["gcap_g"]
        margin_g = geo["margin_g"]
        reach_w = rcut + margin_g
        nx, nyz_g, cap_sr = geo["nx"], geo["nyz_g"], geo["cap_sr"]
        gr = st.grids
        use_cache = gr is not None and gr.grav is not None
        count_now = jnp.sum(p.alive.astype(jnp.int32))
        if use_cache:
            cl_cached, rows_cached = jax.tree_util.tree_map(
                lambda x: x[0], gr.grav)
            need_l = ((~gr.grav_valid[0])
                      | (2.0 * gr.grav_disp[0] > margin_g)
                      | (count_now != gr.grav_count[0]))
            need = jax.lax.psum(need_l.astype(jnp.int32), AXIS) > 0
            rows, ovf = jax.lax.cond(
                need,
                lambda _: _ghost_rows_select(_wx(p.pos[:, 0]), p.alive,
                                             x0, x1, reach_w, gcap),
                lambda _: (rows_cached, jnp.asarray(False)),
                operand=None)
        else:
            need = None
            rows, ovf = _ghost_rows_select(_wx(p.pos[:, 0]), p.alive,
                                           x0, x1, reach_w, gcap)
        with jax.named_scope("spmd_ghosts_grav"):
            ghosts, gvalid = _ghost_exchange_rows(
                [p.pos, p.mass, soft], p.alive, rows, gcap, d)
        gpos, gmass, gsoft = ghosts
        gpos = _dompos(gpos)
        gx_fixed, gvalid = _fix_ghost_x(gpos[:, 0], x0, x1,
                                        reach_w + margin_g, gvalid, gcap)
        gpos = gpos.at[:, 0].set(gx_fixed)
        lpos = _dompos(p.pos)
        if per:
            lpos = lpos.at[:, 0].set(
                _wrap_to_slab(jnp.mod(p.pos[:, 0], box), xc, box))
        cat_pos = jnp.concatenate([lpos, gpos])
        cat_mass = jnp.concatenate([p.mass, gmass])
        cat_soft = jnp.concatenate([soft, gsoft])
        cat_alive = jnp.concatenate([p.alive, gvalid])

        ext_x = (x1 - x0) + 2.0 * rcut
        with jax.named_scope("spmd_sr_build"):
            def build_cl(_):
                return build_cell_list(
                    cat_pos, cat_alive,
                    origin=jnp.stack([x0 - rcut, jnp.float32(0.0),
                                      jnp.float32(0.0)]).astype(lpos.dtype),
                    extent=jnp.stack([ext_x, jnp.float32(box),
                                      jnp.float32(box)]).astype(lpos.dtype),
                    n_cells=(nx, nyz_g, nyz_g),
                    capacity=cap_sr,
                    periodic=(False, pyz, pyz))

            if use_cache:
                cl = jax.lax.cond(need, build_cl, lambda _: cl_cached,
                                  operand=None)
            else:
                cl = build_cl(None)
        if use_cache:
            grids = dataclasses.replace(
                gr,
                grav=jax.tree_util.tree_map(lambda x: x[None], (cl, rows)),
                grav_valid=jnp.ones((1,), bool),
                grav_disp=jnp.where(need, 0.0, gr.grav_disp),
                grav_count=jnp.full((1,), count_now, jnp.int32))
            st = dataclasses.replace(st, grids=grids)
        # sinks/Stamatellos consume the potential every sync point, so
        # add the fresh short-range term in-step (the single-chip analog
        # in forces._treepm_gravity) [G2: potential.c with PMGRID]
        want_sr_pot = opts.sinks or opts.cooling == "stamatellos"
        # ghosts are SOURCES only: the kernel's target gate ends at the
        # local block
        cat_tgt = jnp.concatenate([active, jnp.zeros((2 * gcap,), bool)])
        with jax.named_scope("spmd_sr_pairs"):
            res = shortrange_gravity_cells(
                cl, cat_pos, cat_mass, cat_soft, cat_alive,
                asmth_len, rcut, box=box, periodic=per,
                with_potential=want_sr_pot, n_targets=p.n_max,
                backend=pairs, targets=cat_tgt)
        acc_sr, pot_sr = res if want_sr_pot else (res, None)
        flags = st.overflow_flags | jnp.where(
            cl.overflow | ovf, jnp.int32(1), jnp.int32(0))

        acc = acc_sr * cfg.grav_internal
        if not per and cfg.comoving_integration_on:
            # vacuum-boundary comoving runs: homogeneous-background
            # subtraction, as in the single-chip path [G2: gravtree.c
            # comoving correction]
            acc = acc + (0.5 * cfg.omega0 * cfg.hubble_internal**2) * p.pos
        acc = jnp.where(active[:, None], acc, p.acc)
        acc = jnp.where(p.alive[:, None], acc, 0.0)
        acc_pm = jnp.where(p.alive[:, None], acc_pm, 0.0)
        pot_pm_g = pot * cfg.grav_internal
        if want_sr_pot:
            # PM self-energy removal as in compute_potential
            pot_full = (pot + pot_sr
                        + p.mass / (jnp.sqrt(jnp.pi) * asmth_len)
                        ) * cfg.grav_internal
        else:
            # without sink/cooling consumers the stored pot carries the
            # PM piece only (diagnostics recompute on demand)
            pot_full = pot_pm_g
        total = acc + acc_pm
        old_acc = jnp.sqrt(jnp.sum(total * total, axis=-1))
        p = dataclasses.replace(p, acc=acc, acc_pm=acc_pm, pot=pot_full,
                                pot_pm=pot_pm_g, old_acc=old_acc)
        return dataclasses.replace(st, p=p, overflow_flags=flags), active

    def _sph(st, me, x0, x1, xc, active):
        from gadget_leicester_tpu.core.config import GAMMA_MINUS1  # noqa
        from gadget_leicester_tpu.ops.neighbors import build_cell_list
        from gadget_leicester_tpu.ops.sph_cells import (
            density_adaptive_cells, hydro_force_cells)

        gas = st.gas
        p = st.p
        ng = gas.n_gas_max
        fac = comoving_factors(cfg, st.ti_current)
        gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
        active_g = active[:ng] & gas_mask
        eps_gas = softening_table(cfg, fac.atime)[0]
        min_hsml = cfg.min_gas_hsml_fractional * SOFTFAC * eps_gas

        # SPH cell edge (and h cap): the single-device auto heuristic on
        # the GLOBAL gas count so results match the replicated run
        n_glob = ng * d
        spacing_cells = (n_glob ** (1.0 / 3.0)) / (
            1.6 * (3.0 * cfg.des_num_ngb / (4.0 * 3.14159)) ** (1. / 3))
        # floored so the cell edge (= ghost reach) never exceeds a slab
        # width — matters when the gas block is tiny/empty padding
        # (DM-only runs)
        n_sph = max(3, int(spacing_cells),
                    int(np.ceil(1.02 * box / w_min)))
        cell_sph = box / n_sph
        if w_min < cell_sph:
            raise ValueError("slab thinner than the SPH cell edge")
        max_hsml = cell_sph

        lpos = _dompos(p.pos[:ng])
        if per:
            lpos = lpos.at[:, 0].set(
                _wrap_to_slab(jnp.mod(p.pos[:ng, 0], box), xc, box))
        # O(surface) ghosts (see _gravity): strip within one SPH cell edge
        gcap = _ghost_cap(ng, cell_sph, w_min, opts.spmd_ghost_frac)
        h0 = jnp.minimum(gas.hsml, max_hsml)

        # ---- round 1: kinematic ghosts for the density solve -----------
        with jax.named_scope("spmd_ghosts_sph1"):
            ghosts, gvalid, ovf1 = _ghost_exchange(
                [p.pos[:ng], gas.vel_pred, p.mass[:ng],
                 gas_mask.astype(jnp.int32)],
                _wx(p.pos[:ng, 0]), gas_mask, x0, x1, cell_sph,
                gcap, d)
        gpos, gvel, gmass, gmask_i = ghosts
        gpos = _dompos(gpos)
        gx_f, gvalid = _fix_ghost_x(gpos[:, 0], x0, x1, cell_sph,
                                    gvalid, gcap)
        gpos = gpos.at[:, 0].set(gx_f)
        gv = gvalid & (gmask_i > 0)
        cat_pos = jnp.concatenate([lpos, gpos])
        cat_vel = jnp.concatenate([gas.vel_pred, gvel])
        cat_mass = jnp.concatenate([p.mass[:ng], gmass])
        cat_mask = jnp.concatenate([gas_mask, gv])

        nx = max(1, int((w_min + 2 * cell_sph) / cell_sph))
        ext_x_s = (x1 - x0) + 2 * cell_sph
        n_cat = cat_pos.shape[0]
        if pairs == "triton":
            # REAL-count estimate, not slot counts (see slab_grid_geom)
            n_est = SLAB_FILL * ng * (1.0 + 3.0 * cell_sph / w_min)
            cap_sph = kernel_capacity(n_est / (nx * n_sph * n_sph),
                                      opts.sph_capacity)
        else:
            cap_sph = opts.sph_capacity if opts.sph_capacity > 0 else max(
                64, -(-3 * n_cat // (nx * n_sph * n_sph) // 8) * 8)
        cl = build_cell_list(
            cat_pos, cat_mask,
            origin=jnp.stack([x0 - cell_sph, jnp.float32(0.0),
                              jnp.float32(0.0)]).astype(lpos.dtype),
            extent=jnp.stack([ext_x_s, jnp.float32(box),
                              jnp.float32(box)]).astype(lpos.dtype),
            n_cells=(nx, n_sph, n_sph),
            capacity=cap_sph,
            periodic=(False, pyz, pyz))
        h_cat = jnp.concatenate([h0, jnp.full((2 * gcap,), 1.0, h0.dtype)])
        # ghosts are SOURCES only (targets end at the local block)
        with jax.named_scope("spmd_sph_density"):
            dres = density_adaptive_cells(
                cl, cat_pos, cat_vel, cat_mass, h_cat,
                cat_mask, des_num_ngb=cfg.des_num_ngb,
                max_dev=cfg.max_num_ngb_deviation,
                min_hsml=min_hsml, max_hsml=max_hsml,
                box=box, periodic=per, n_targets=ng,
                backend=pairs, targets=active_g)

        rho = jnp.where(active_g, dres.rho, gas.density)
        hsml = jnp.where(active_g, dres.hsml, gas.hsml)
        dhf = jnp.where(active_g, dres.dhsml_factor,
                        gas.dhsml_density_factor)
        divv = jnp.where(active_g, dres.div_vel, gas.div_vel)
        curlv = jnp.where(active_g, dres.curl_vel, gas.curl_vel)
        nngb = jnp.where(active_g, dres.num_ngb_eff, gas.num_ngb)

        if opts.isotherm_eqs:
            pressure = gas.entropy_pred * rho
        else:
            pressure = gas.entropy_pred * rho**GAMMA
        pressure = jnp.where(gas_mask, pressure, 0.0)

        # ---- round 2: hydro ghosts (post-density fields) ----------------
        with jax.named_scope("spmd_ghosts_sph2"):
            ghosts2, gvalid2, ovf2 = _ghost_exchange(
                [p.pos[:ng], gas.vel_pred, p.mass[:ng], hsml, rho,
                 pressure, dhf, divv, curlv,
                 gas_mask.astype(jnp.int32)],
                _wx(p.pos[:ng, 0]), gas_mask, x0, x1, cell_sph,
                gcap, d)
        (g2pos, g2vel, g2mass, g2h, g2rho, g2prs, g2dhf, g2div, g2curl,
         g2mask_i) = ghosts2
        g2pos = _dompos(g2pos)
        g2x_f, gvalid2 = _fix_ghost_x(g2pos[:, 0], x0, x1, cell_sph,
                                      gvalid2, gcap)
        g2pos = g2pos.at[:, 0].set(g2x_f)
        gv2 = gvalid2 & (g2mask_i > 0)
        cat2 = dict(
            pos=jnp.concatenate([lpos, g2pos]),
            vel=jnp.concatenate([gas.vel_pred, g2vel]),
            mass=jnp.concatenate([p.mass[:ng], g2mass]),
            hsml=jnp.concatenate([hsml, g2h]),
            rho=jnp.concatenate([rho, g2rho]),
            prs=jnp.concatenate([pressure, g2prs]),
            dhf=jnp.concatenate([dhf, g2dhf]),
            div=jnp.concatenate([divv, g2div]),
            curl=jnp.concatenate([curlv, g2curl]),
            mask=jnp.concatenate([gas_mask, gv2]),
        )
        # the hydro pass reuses the density cell list: cat2's positions
        # and mask are IDENTICAL to round 1's (same locals, same
        # deterministic boundary-strip packing — only field VALUES
        # changed), and cell membership depends on position only
        cl2 = cl
        with jax.named_scope("spmd_sph_hydro"):
            hres = hydro_force_cells(
                cl2, cat2["pos"], cat2["vel"], cat2["mass"], cat2["hsml"],
                cat2["rho"], cat2["prs"], cat2["dhf"], cat2["div"],
                cat2["curl"], cat2["mask"],
                visc_const=cfg.art_bulk_visc_const, box=box, periodic=per,
                hubble_a2_flow=fac.hubble_a2_flow,
                hubble_a2_norm=fac.hubble_a2_norm, fac_mu=fac.fac_mu,
                n_targets=ng, backend=pairs,
                targets=jnp.concatenate([active_g,
                                         jnp.zeros((2 * gcap,), bool)]))

        hydro_acc = jnp.where(active_g[:, None], hres.acc, gas.hydro_acc)
        dt_entropy = jnp.where(active_g, hres.dt_entropy, gas.dt_entropy)
        if opts.isotherm_eqs:
            dt_entropy = jnp.zeros_like(dt_entropy)
        msv = jnp.where(active_g, hres.max_signal_vel, gas.max_signal_vel)

        flags = st.overflow_flags | jnp.where(
            cl.overflow | cl2.overflow | ovf1 | ovf2,
            jnp.int32(2), jnp.int32(0))
        gas = dataclasses.replace(
            gas, density=rho, hsml=hsml, pressure=pressure, div_vel=divv,
            curl_vel=curlv, dhsml_density_factor=dhf, num_ngb=nngb,
            hydro_acc=hydro_acc, dt_entropy=dt_entropy, max_signal_vel=msv)
        return dataclasses.replace(st, gas=gas, overflow_flags=flags)

    def _sinks(st, me):
        """Sink formation + accretion under SPMD [SURVEY.md §2 fork rows;
        the sink module's global claims become psum/ppermute collectives].

        Sinks are identified by ptype==5 AND membership of the replicated
        registry — ``sinks.slot`` holds PIDs in the slab layout (row
        indices are shard-local and churn under migration; to_spmd /
        spmd_to_canonical translate). Formation elects one global winner
        via pmax + owner election; accretion ships each shard's compacted
        sink block to both neighbours, computes claims against local gas,
        and returns ghost-sink deltas to their owners — the
        export-evaluate-return pattern [G2: gravtree.c] applied to
        accretion. Gas is claimed exactly once (it is local to one shard
        and killed there), so mass/momentum transfer is conservation-exact.
        """
        p, gas = st.p, st.gas
        S = st.sinks.slot.shape[0]
        ng = gas.n_gas_max
        rho_safe = jnp.maximum(gas.density, 1e-30)
        u_gas = gas.entropy_pred * rho_safe**GAMMA_MINUS1 / GAMMA_MINUS1
        r_acc = jnp.asarray(cfg.sink_accretion_radius
                            if cfg.sink_accretion_radius > 0 else 0.0,
                            p.pos.dtype)

        def mimg(dx):
            if not per:        # vacuum: true separations, no image
                return dx
            return dx - box * jnp.round(dx / box)

        # ---- formation (global densest-candidate pick) -----------------
        if cfg.sink_formation_density > 0:
            sinks = st.sinks
            gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
            psi_mag = jnp.maximum(-p.pot[:ng], 1e-30)
            cand = (gas_mask
                    & (gas.density > cfg.sink_formation_density)
                    & (gas.div_vel < 0.0)
                    & (u_gas <= 0.5 * psi_mag))
            rho_c = jnp.where(cand, gas.density, -1.0)
            best_l = jnp.argmax(rho_c)
            rho_l = rho_c[best_l]
            rho_g = jax.lax.pmax(rho_l, AXIS)
            any_cand = rho_g > 0.0
            owner = jax.lax.pmin(
                jnp.where(rho_l == rho_g, me, jnp.int32(d)), AXIS)
            is_owner = (me == owner) & any_cand
            bpos = jax.lax.psum(
                jnp.where(is_owner, p.pos[best_l],
                          jnp.zeros((3,), p.pos.dtype)), AXIS)
            bpot = jax.lax.psum(
                jnp.where(is_owner, p.pot[best_l],
                          jnp.zeros((), p.pot.dtype)), AXIS)
            dxb = mimg(p.pos[:ng] - bpos[None, :])
            r2b = jnp.sum(dxb * dxb, axis=-1)
            near = gas_mask & (r2b < r_acc * r_acc)
            near = near & ~(is_owner & (jnp.arange(ng) == best_l))
            deeper = jnp.sum((near & (p.pot[:ng] < bpot)).astype(jnp.int32))
            any_deeper = jax.lax.psum(deeper, AXIS) > 0
            free = sinks.slot < 0
            has_free = jnp.any(free)
            free_slot = jnp.argmax(free)
            do_form = any_cand & ~any_deeper & has_free
            ptype = p.ptype.at[best_l].set(
                jnp.where(do_form & is_owner, jnp.int32(5),
                          p.ptype[best_l]))
            new_pid = jax.lax.psum(
                jnp.where(do_form & is_owner, p.pid[best_l],
                          jnp.zeros((), p.pid.dtype)), AXIS)
            slot = sinks.slot.at[free_slot].set(
                jnp.where(do_form, new_pid.astype(sinks.slot.dtype),
                          sinks.slot[free_slot]))
            p = dataclasses.replace(p, ptype=ptype)
            st = dataclasses.replace(
                st, p=p, sinks=dataclasses.replace(sinks, slot=slot))

        # ---- accretion (export-evaluate-return over the sink ring) -----
        if cfg.sink_accretion_radius > 0:
            p, sinks = st.p, st.sinks
            gas_mask = p.alive[:ng] & (p.ptype[:ng] == 0)
            # registered sinks only (parity with the single-chip registry)
            in_reg = jnp.any(
                (p.pid[:, None] == sinks.slot[None, :].astype(p.pid.dtype))
                & (sinks.slot[None, :] >= 0), axis=1)
            sink_mask = p.alive & (p.ptype == 5) & in_reg
            idx_s = jnp.nonzero(sink_mask, size=S,
                                fill_value=-1)[0].astype(jnp.int32)
            valid_s = idx_s >= 0
            iS = jnp.maximum(idx_s, 0)
            spos = jnp.where(valid_s[:, None], p.pos[iS], 0.0)
            svel = jnp.where(valid_s[:, None], p.vel[iS], 0.0)
            smass = jnp.where(valid_s, p.mass[iS], 0.0)
            spid = jnp.where(valid_s, p.pid[iS],
                             jnp.asarray(-1, p.pid.dtype))
            ovf_s = jnp.sum(sink_mask) > S

            bufs = [spos, svel, smass, valid_s.astype(jnp.int32)]
            from_l = _ring(bufs, +1, d)
            from_r = _ring(bufs, -1, d)
            cpos = jnp.concatenate([spos, from_l[0], from_r[0]])
            cvel = jnp.concatenate([svel, from_l[1], from_r[1]])
            cmass = jnp.concatenate([smass, from_l[2], from_r[2]])
            cvalid = jnp.concatenate([valid_s, from_l[3] > 0,
                                      from_r[3] > 0])

            dx = mimg(cpos[:, None, :] - p.pos[None, :ng, :])  # [3S,ng,3]
            r2 = jnp.sum(dx * dx, axis=-1)
            dv = cvel[:, None, :] - p.vel[None, :ng, :]
            inside = r2 < r_acc * r_acc
            approaching = jnp.sum(dv * dx, axis=-1) < 0
            v2 = jnp.sum(dv * dv, axis=-1)
            eps5 = cfg.softenings[5]
            r_soft = jnp.sqrt(r2 + eps5 * eps5)
            bound = (0.5 * v2 + u_gas[None, :]
                     < cfg.grav_internal * cmass[:, None] / r_soft)
            take = (inside & approaching & bound
                    & gas_mask[None, :] & cvalid[:, None])
            # nearest claiming sink only; ring duplicates (d<=2) lose the
            # argmin tie to the identical local row, so their deltas are 0
            r2m = jnp.where(take, r2, jnp.asarray(1e30, r2.dtype))
            winner = jnp.argmin(r2m, axis=0)
            any_take = jnp.any(take, axis=0)
            claim = ((jnp.arange(3 * S)[:, None] == winner[None, :])
                     & any_take[None, :])
            m_g = jnp.where(gas_mask, p.mass[:ng], 0.0)
            wm = jnp.where(claim, m_g[None, :], 0.0)
            dm = jnp.sum(wm, axis=1)                        # [3S]
            dp = jnp.einsum("sn,nc->sc", wm, p.vel[:ng],
                            precision=HIGHEST)              # [3S,3]
            n_acc = jnp.sum(claim, axis=1).astype(jnp.int32)

            # deltas for ghost sinks travel back to their owner shard
            ret_r = _ring([dm[S:2 * S], dp[S:2 * S], n_acc[S:2 * S]],
                          -1, d)
            ret_l = _ring([dm[2 * S:], dp[2 * S:], n_acc[2 * S:]], +1, d)
            dm_t = dm[:S] + ret_r[0] + ret_l[0]
            dp_t = dp[:S] + ret_r[1] + ret_l[1]
            n_t = n_acc[:S] + ret_r[2] + ret_l[2]

            new_mass = smass + dm_t
            new_vel = (smass[:, None] * svel + dp_t) / jnp.maximum(
                new_mass, 1e-30)[:, None]
            put = jnp.where(valid_s, iS, jnp.int32(p.n_max))
            mass_u = p.mass.at[put].set(new_mass, mode="drop")
            vel_u = p.vel.at[put].set(new_vel, mode="drop")
            alive = p.alive.at[:ng].set(p.alive[:ng] & ~any_take)

            # replicated registry tallies: each sink is owned by exactly
            # one shard, so the psum of per-shard contributions is exact
            match = ((sinks.slot[:, None].astype(p.pid.dtype)
                      == spid[None, :])
                     & valid_s[None, :] & (sinks.slot[:, None] >= 0))
            acc_mass_c = jax.lax.psum(
                jnp.dot(match.astype(dm_t.dtype), dm_t, precision=HIGHEST), AXIS)
            n_acc_c = jax.lax.psum(match.astype(jnp.int32) @ n_t, AXIS)
            sinks = dataclasses.replace(
                sinks, acc_mass=sinks.acc_mass + acc_mass_c,
                n_accreted=sinks.n_accreted + n_acc_c)
            p = dataclasses.replace(p, mass=mass_u, vel=vel_u, alive=alive)
            flags = st.overflow_flags | jnp.where(
                ovf_s, jnp.int32(8), jnp.int32(0))
            st = dataclasses.replace(st, p=p, sinks=sinks,
                                     overflow_flags=flags)
        return st

    def local_step(st: SimState) -> SimState:
        me = jax.lax.axis_index(AXIS)
        x0 = edges_j[me]
        x1 = edges_j[me + 1]
        xc = 0.5 * (x0 + x1)

        ti_local = timeline.min_active_ti_end(st.p.ti_endstep, st.p.alive)
        ti_next = jax.lax.pmin(ti_local, AXIS)
        ti_next = jnp.minimum(ti_next, st.pm_ti_endstep)

        # ``phases`` is an anatomy knob (tools/anatomy_spmd.py): cumulative
        # prefixes of the phase list isolate per-phase device cost. The
        # default runs everything; partial steps are NOT physical.
        if "drift" in phases:
            with jax.named_scope("spmd_drift"):
                st = integrate.drift_all(st, cfg, opts, ti_next)
        is_pm_step = st.ti_current == st.pm_ti_endstep

        if "migrate" in phases:
            with jax.named_scope("spmd_migrate"):
                st = _migrate(st, me)
        active = (st.p.ti_endstep == st.ti_current) & st.p.alive
        if "gravity" in phases:
            with jax.named_scope("spmd_gravity"):
                st, active = _gravity(st, me, x0, x1, xc, is_pm_step)
        if st.gas.n_gas_max > 1 and "sph" in phases:
            with jax.named_scope("spmd_sph"):
                st = _sph(st, me, x0, x1, xc, active)
        if opts.cooling != "none" and "kick" in phases:
            from gadget_leicester_tpu.models.cooling import apply_cooling
            st = apply_cooling(st, cfg, opts)
        if opts.sinks and "kick" in phases:
            st = _sinks(st, me)
        if "kick" in phases:
            with jax.named_scope("spmd_kick"):
                st = integrate.advance_and_find_timesteps(st, cfg, opts)
                st = integrate.pm_step_update(st, cfg, opts, is_pm_step,
                                              axis_name=AXIS, pm_box=box)
        # overflow bits are shard-local; OR them across shards (psum per
        # bit) so the replicated scalar out-spec is valid and the host
        # sees every shard's trouble
        flags = jnp.int32(0)
        for k in range(4):
            bit = (st.overflow_flags >> k) & 1
            bit = jnp.minimum(jax.lax.psum(bit, AXIS), 1)
            flags = flags | (bit << k)
        return dataclasses.replace(st, overflow_flags=flags)

    def make(state_template: SimState):
        specs = state_specs(state_template)
        # check_vma off: the replicated outputs (ti_current via pmin,
        # pm_ti via psum'd vrms, overflow via all-gather OR) are
        # replicated by construction but not statically inferable
        fn = jax.shard_map(local_step, mesh=mesh,
                           in_specs=(specs,), out_specs=specs,
                           check_vma=False)
        return jax.jit(fn)

    return make
