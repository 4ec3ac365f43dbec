"""Barnes-Hut octree gravity as array programs — the rebuild of the reference's
largest component [G2: forcetree.c :: force_treebuild() /
force_treeevaluate()], redesigned from pointer-chasing to batched
static-shape array programs (SURVEY.md §7 hard part 1; BASELINE.json north
star: "Morton-sorted, fixed-depth batched multipole traversal").

Design
------
* **Build**: particles get 30-bit Morton keys (depth<=10 levels; the
  reference uses Peano-Hilbert keys for domain decomposition [G2: peano.c]
  — Morton preserves the same prefix-nesting property and is cheaper to
  compute); one global sort; every octree level is then a segmented
  reduction over the sorted particle array (``jax.ops.segment_sum``):
  monopole mass + centre of mass + max softening per node, exactly the
  quantities [G2: force_update_node_recursive()] accumulates. Child links
  are ``searchsorted`` ranges over the next level's sorted prefixes.
* **Traversal**: targets are processed in Morton-contiguous blocks
  (spatially compact). A per-block FRONTIER of candidate nodes walks down
  the levels: nodes passing the (conservative, block-level) opening test
  are evaluated as monopoles for every target in the block immediately;
  failing nodes expand their children into the next frontier (stream
  compaction via cumsum/scatter — fixed frontier capacity, overflow
  flagged). At the deepest level, surviving nodes are leaf buckets whose
  particles are evaluated directly, plus an exact RESIDUAL MONOPOLE for
  any bucket overflow (never silently dropped mass).
* Opening criteria: geometric BH (s/d > theta) and the relative criterion
  (M s^4 > alpha |a_old| d^6) [G2: force_treeevaluate() opening tests],
  made conservative over the block via min-distance / min-|a_old|.

Boundaries: vacuum (galaxy/cluster workloads) or periodic-without-PM via
the tabulated Ewald correction [G2: force_treeevaluate_ewald_correction()]
applied to every accepted monopole / bucket interaction (periodic=True).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from gadget_leicester_tpu.ops.jit_util import hybrid_jit
from typing import Tuple

import jax
import jax.numpy as jnp

from gadget_leicester_tpu.ops.softening import grav_fac, grav_pot

# f32 pair sums: no TF32 on GPU tensor cores
HIGHEST = jax.lax.Precision.HIGHEST

# sentinel beyond any valid 30-bit key — a PYTHON int, so it inlines into
# the HLO instead of being captured as a device Array (see
# core/cosmology._GL note)
BIGKEY = 2**30


def _part1by2(x):
    """Spread 10 bits of x over 30 (classic Morton magic numbers)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_keys(pos, origin, extent, depth: int):
    """30-bit Morton keys at `depth` levels (depth <= 10)."""
    assert 1 <= depth <= 10, f"octree depth {depth} out of range (max 10)"
    scale = (1 << depth) / extent
    c = jnp.clip(((pos - origin) * scale).astype(jnp.int32), 0, (1 << depth) - 1)
    key = (_part1by2(c[:, 0]) << 2) | (_part1by2(c[:, 1]) << 1) | _part1by2(c[:, 2])
    return key << (3 * (10 - depth))  # left-align so prefixes nest at 10 levels


@dataclass
class Octree:
    """Per-level node arrays (tuples indexed by level 1..depth; level 0 is
    the trivial root) + the Morton-sorted particle arrays."""

    depth: int                      # static
    n_alloc: Tuple[int, ...]        # static per-level allocation
    mass: Tuple[jnp.ndarray, ...]   # [M_L]
    com: Tuple[jnp.ndarray, ...]    # [M_L,3]
    maxsoft: Tuple[jnp.ndarray, ...]
    pfx: Tuple[jnp.ndarray, ...]    # [M_L] int32 sorted prefixes (pad BIGKEY)
    child_lo: Tuple[jnp.ndarray, ...]  # [M_L] first child index at L+1
    child_hi: Tuple[jnp.ndarray, ...]
    pstart: Tuple[jnp.ndarray, ...]    # [M_L] first particle (sorted order)
    pcount: Tuple[jnp.ndarray, ...]
    # sorted particles
    pos_s: jnp.ndarray
    mass_s: jnp.ndarray
    soft_s: jnp.ndarray
    alive_s: jnp.ndarray
    order: jnp.ndarray              # sorted -> original index
    origin: jnp.ndarray
    extent: jnp.ndarray             # scalar (cubic)


jax.tree_util.register_dataclass(
    Octree,
    data_fields=["mass", "com", "maxsoft", "pfx", "child_lo", "child_hi",
                 "pstart", "pcount", "pos_s", "mass_s", "soft_s", "alive_s",
                 "order", "origin", "extent"],
    meta_fields=["depth", "n_alloc"],
)


def build_octree(pos, mass, soft, alive, depth: int = 8) -> Octree:
    """[G2: force_treebuild() + force_update_node_recursive()] as sort +
    per-level segmented reductions."""
    n = pos.shape[0]
    f = pos.dtype
    lo = jnp.min(jnp.where(alive[:, None], pos, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(alive[:, None], pos, -jnp.inf), axis=0)
    extent = jnp.max(hi - lo) * 1.0001 + 1e-30
    origin = lo - 0.5 * (extent - (hi - lo))

    key = morton_keys(pos, origin, extent, depth)
    key = jnp.where(alive, key, BIGKEY)
    order = jnp.argsort(key)
    key_s = key[order]
    pos_s, mass_s = pos[order], jnp.where(alive, mass, 0.0)[order]
    soft_s, alive_s = soft[order], alive[order]
    wpos = mass_s[:, None] * pos_s
    idx = jnp.arange(n, dtype=jnp.int32)

    levels = {k: [] for k in ("mass", "com", "maxsoft", "pfx", "child_lo",
                              "child_hi", "pstart", "pcount")}
    n_alloc = []
    pfx_per_level = []
    for lvl in range(1, depth + 1):
        shift = 3 * (10 - lvl)
        pfx_s = key_s >> shift                       # dead -> BIGKEY>>shift
        alloc = min(n, 8**lvl) + 1
        n_alloc.append(alloc)
        newseg = jnp.concatenate([
            jnp.ones((1,), bool), pfx_s[1:] != pfx_s[:-1]])
        seg = jnp.cumsum(newseg) - 1                 # segment id per particle
        seg = jnp.minimum(seg, alloc - 1).astype(jnp.int32)
        seg_alive = jnp.where(alive_s, seg, alloc - 1)
        m = jax.ops.segment_sum(mass_s, seg_alive, num_segments=alloc)
        cw = jax.ops.segment_sum(wpos, seg_alive, num_segments=alloc)
        com = cw / jnp.maximum(m, 1e-37)[:, None]
        ms = jax.ops.segment_max(
            jnp.where(alive_s, soft_s, 0.0), seg_alive, num_segments=alloc)
        ms = jnp.where(m > 0, ms, 0.0)
        pfx_nodes = jax.ops.segment_min(
            jnp.where(alive_s, pfx_s, BIGKEY), seg_alive, num_segments=alloc)
        ps = jax.ops.segment_min(
            jnp.where(alive_s, idx, n), seg_alive, num_segments=alloc)
        pc = jax.ops.segment_sum(
            alive_s.astype(jnp.int32), seg_alive, num_segments=alloc)
        levels["mass"].append(m.astype(f))
        levels["com"].append(com.astype(f))
        levels["maxsoft"].append(ms.astype(f))
        levels["pfx"].append(pfx_nodes.astype(jnp.int32))
        levels["pstart"].append(ps.astype(jnp.int32))
        levels["pcount"].append(pc)
        pfx_per_level.append(pfx_nodes.astype(jnp.int32))

    # child ranges: children of node (level L, prefix p) are the nodes at
    # L+1 whose prefix>>3 == p; both prefix arrays are sorted.
    for lvl in range(1, depth + 1):
        i = lvl - 1
        if lvl < depth:
            nxt = pfx_per_level[i + 1]
            p = levels["pfx"][i]
            lo_i = jnp.searchsorted(nxt, p << 3, side="left").astype(jnp.int32)
            hi_i = jnp.searchsorted(nxt, (p + 1) << 3, side="left").astype(jnp.int32)
        else:
            z = jnp.zeros_like(levels["pfx"][i])
            lo_i, hi_i = z, z
        levels["child_lo"].append(lo_i)
        levels["child_hi"].append(hi_i)

    return Octree(
        depth=depth,
        n_alloc=tuple(n_alloc),
        mass=tuple(levels["mass"]),
        com=tuple(levels["com"]),
        maxsoft=tuple(levels["maxsoft"]),
        pfx=tuple(levels["pfx"]),
        child_lo=tuple(levels["child_lo"]),
        child_hi=tuple(levels["child_hi"]),
        pstart=tuple(levels["pstart"]),
        pcount=tuple(levels["pcount"]),
        pos_s=pos_s, mass_s=mass_s, soft_s=soft_s, alive_s=alive_s,
        order=order.astype(jnp.int32), origin=origin, extent=extent,
    )


def _eval_monopole(tpos, tsoft, node_com, node_mass, node_soft, valid,
                   pctx=None):
    """Softened monopole kernel for a [B] x [F] interaction set.
    Returns (acc [B,3], pot [B]). `pctx=(box, ewald_table)` adds the
    periodic minimum image + tabulated Ewald correction
    [G2: force_treeevaluate_ewald_correction()]."""
    dx = tpos[:, None, :] - node_com[None, :, :]
    if pctx is not None:
        box, table = pctx
        dx = dx - box * jnp.round(dx / box)
    r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
    h = jnp.maximum(tsoft[:, None], node_soft[None, :])
    m = jnp.where(valid[None, :], node_mass[None, :], 0.0)
    fac = grav_fac(r, h)
    acc = -jnp.einsum("bf,bfc->bc", m * fac, dx, precision=HIGHEST)
    pot = jnp.sum(m * jnp.where(r > 0, grav_pot(r, h), 0.0), axis=-1)
    if pctx is not None:
        from gadget_leicester_tpu.ops.ewald import ewald_correction_jnp
        ca, cp = ewald_correction_jnp(dx, box, table)
        acc = acc + jnp.einsum("bf,bfc->bc", m, ca, precision=HIGHEST)
        pot = pot + jnp.sum(m * cp, axis=-1)
    return acc, pot


@partial(hybrid_jit, static_argnames=("depth", "block", "frontier_cap",
                                   "bucket_cap", "opening", "periodic",
                                   "box", "ewald_res"))
def tree_gravity(
    pos,
    mass,
    soft,
    alive,
    theta: float = 0.5,
    opening: int = 1,
    err_tol_force_acc: float = 0.005,
    old_acc=None,
    depth: int = 8,
    block: int = 256,
    frontier_cap: int = 2048,
    bucket_cap: int = 48,
    periodic: bool = False,
    box: float = 0.0,
    ewald_res: int = 32,
):
    """Full Barnes-Hut accelerations + potentials (no G factor).

    opening=0: geometric BH criterion (s/d > theta);
    opening=1: relative criterion M s^4 > ErrTolForceAcc |a_old| d^6
    [G2: force_treeevaluate()], falling back to geometric on the first
    step (old_acc == 0), as the reference does.
    """
    n = pos.shape[0]
    f = pos.dtype
    if periodic:
        from gadget_leicester_tpu.ops.ewald import ewald_correction_table
        pctx = (box, ewald_correction_table(ewald_res))
        pos = jnp.mod(pos, box)
    else:
        pctx = None
    tree = build_octree(pos, mass, soft, alive, depth=depth)
    nb = -(-n // block)
    npad = nb * block

    if old_acc is None:
        old_acc = jnp.zeros((n,), f)
    old_acc_s = jnp.pad(old_acc[tree.order], (0, npad - n))
    pos_sp = jnp.pad(tree.pos_s, ((0, npad - n), (0, 0)))
    soft_sp = jnp.pad(tree.soft_s, (0, npad - n))
    alive_sp = jnp.pad(tree.alive_s, (0, npad - n))

    def traverse_block(bi):
        s = bi * block
        tpos = jax.lax.dynamic_slice(pos_sp, (s, 0), (block, 3))
        tsoft = jax.lax.dynamic_slice(soft_sp, (s,), (block,))
        talive = jax.lax.dynamic_slice(alive_sp, (s,), (block,))
        toldacc = jax.lax.dynamic_slice(old_acc_s, (s,), (block,))
        # block bounding sphere (alive targets only)
        w = talive[:, None]
        c = jnp.sum(jnp.where(w, tpos, 0.0), axis=0) / jnp.maximum(
            jnp.sum(talive), 1)
        rb = jnp.sqrt(jnp.max(jnp.where(
            talive, jnp.sum((tpos - c[None, :]) ** 2, -1), 0.0)))
        min_oldacc = jnp.min(jnp.where(talive, toldacc, jnp.inf))

        acc = jnp.zeros((block, 3), f)
        pot = jnp.zeros((block,), f)
        overflow = jnp.zeros((), bool)

        # frontier at level 1: up to 8 root children = first nodes of level 1
        fr = jnp.full((frontier_cap,), -1, jnp.int32)
        n1 = tree.n_alloc[0]
        first = jnp.arange(frontier_cap, dtype=jnp.int32)
        valid1 = (first < n1 - 1) & (tree.mass[0][jnp.minimum(first, n1 - 2)] > 0)
        fr = jnp.where(valid1, jnp.minimum(first, n1 - 2), -1)

        for lvl in range(1, tree.depth + 1):
            i = lvl - 1
            size = tree.extent / (1 << lvl)          # cell side at this level
            valid = fr >= 0
            ndx = jnp.maximum(fr, 0)
            ncom = tree.com[i][ndx]
            nmass = jnp.where(valid, tree.mass[i][ndx], 0.0)
            nsoft = tree.maxsoft[i][ndx]
            dcv = ncom - c[None, :]
            if periodic:
                dcv = dcv - box * jnp.round(dcv / box)
            d_com = jnp.sqrt(jnp.sum(dcv * dcv, -1))
            d = jnp.maximum(d_com - rb, 1e-30)       # conservative min dist
            if opening == 1:
                # relative criterion, geometric fallback when a_old == 0
                geo = size > theta * d
                rel = nmass * size**4 > err_tol_force_acc * \
                    jnp.maximum(min_oldacc, 1e-37) * d**6
                use_rel = min_oldacc > 0
                open_ = jnp.where(use_rel, rel, geo)
            else:
                open_ = size > theta * d
            # containment guard: a node whose cell may contain a target MUST
            # open (monopole of one's own cell is a self-force error); the
            # COM lies inside the cell, so any contained target is within
            # sqrt(3)*size of it [G2: in-node check in force_treeevaluate].
            open_ = open_ | (d < 1.7321 * size) | (d < nsoft)
            # a node with <= bucket_cap particles that would open is cheaper
            # to evaluate directly NOW as a bucket at the last level; here we
            # only monopole-accept the closed ones:
            accept = valid & (nmass > 0) & ~open_
            a, pp = _eval_monopole(tpos, tsoft, ncom, nmass, nsoft, accept,
                                   pctx=pctx)
            acc, pot = acc + a, pot + pp

            is_last = lvl == tree.depth
            opened = valid & (nmass > 0) & open_
            if not is_last:
                clo = tree.child_lo[i][ndx]
                chi = tree.child_hi[i][ndx]
                # frontier-capacity guard: parents whose children would not
                # fit are FORCE-ACCEPTED as monopoles (bounded extra error,
                # never dropped mass) — the "overflow -> refine" fallback of
                # SURVEY.md §7 hard part 1, degraded gracefully.
                n_child = jnp.where(opened, chi - clo, 0)
                cum = jnp.cumsum(n_child)
                fits = opened & (cum <= frontier_cap)
                forced = opened & ~fits
                overflow = overflow | jnp.any(forced)
                a, pp = _eval_monopole(tpos, tsoft, ncom, nmass, nsoft,
                                       forced, pctx=pctx)
                acc, pot = acc + a, pot + pp
                # expand children of fitting nodes -> next frontier
                cand = clo[:, None] + jnp.arange(8, dtype=jnp.int32)[None, :]
                cvalid = fits[:, None] & (cand < chi[:, None])
                candf = cand.reshape(-1)
                cvalf = cvalid.reshape(-1)
                pos_next = jnp.cumsum(cvalf) - 1
                putpos = jnp.where(cvalf, pos_next, frontier_cap)
                fr = jnp.full((frontier_cap + 1,), -1, jnp.int32).at[putpos].set(
                    jnp.where(cvalf, candf, -1), mode="drop")[:frontier_cap]
            else:
                # leaf buckets: direct evaluation of up to bucket_cap
                # particles + residual monopole for the remainder
                pstart = tree.pstart[i][ndx]
                pcnt = jnp.where(opened, tree.pcount[i][ndx], 0)
                overflow = overflow | jnp.any(pcnt > bucket_cap)
                pidx = pstart[:, None] + jnp.arange(bucket_cap,
                                                    dtype=jnp.int32)[None, :]
                pvalid = (jnp.arange(bucket_cap)[None, :] <
                          jnp.minimum(pcnt, bucket_cap)[:, None])
                pidc = jnp.minimum(pidx, n - 1).reshape(-1)
                ppos = tree.pos_s[pidc]
                pmass = jnp.where(pvalid.reshape(-1), tree.mass_s[pidc], 0.0)
                psoft = tree.soft_s[pidc]
                a, pp = _eval_pointset(tpos, tsoft, ppos, pmass, psoft,
                                       pctx=pctx)
                acc, pot = acc + a, pot + pp
                # residual monopole of dropped bucket tails
                m_eval = jax.ops.segment_sum(
                    pmass, jnp.repeat(jnp.arange(fr.shape[0]), bucket_cap),
                    num_segments=fr.shape[0])
                wx_eval = jax.ops.segment_sum(
                    pmass[:, None] * ppos,
                    jnp.repeat(jnp.arange(fr.shape[0]), bucket_cap),
                    num_segments=fr.shape[0])
                m_res = jnp.where(opened, tree.mass[i][ndx] - m_eval, 0.0)
                m_res = jnp.maximum(m_res, 0.0)
                com_res = (tree.mass[i][ndx, None] * tree.com[i][ndx]
                           - wx_eval) / jnp.maximum(m_res, 1e-37)[:, None]
                a, pp = _eval_monopole(tpos, tsoft, com_res, m_res, nsoft,
                                       m_res > 1e-37, pctx=pctx)
                acc, pot = acc + a, pot + pp

        acc = jnp.where(talive[:, None], acc, 0.0)
        pot = jnp.where(talive, pot, 0.0)
        return acc, pot, overflow

    accs, pots, ovfl = jax.lax.map(traverse_block, jnp.arange(nb))
    acc_s = accs.reshape(nb * block, 3)[:n]
    pot_s = pots.reshape(nb * block)[:n]
    # unsort back to original particle order
    acc = jnp.zeros_like(acc_s).at[tree.order].set(acc_s)
    pot = jnp.zeros_like(pot_s).at[tree.order].set(pot_s)
    return acc, pot


def _eval_pointset(tpos, tsoft, ppos, pmass, psoft, pctx=None):
    """Direct particle-particle kernel for leaf buckets [B] x [P]."""
    dx = tpos[:, None, :] - ppos[None, :, :]
    if pctx is not None:
        box, table = pctx
        dx = dx - box * jnp.round(dx / box)
    r = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
    h = jnp.maximum(tsoft[:, None], psoft[None, :])
    fac = grav_fac(r, h)
    acc = -jnp.einsum("bp,bpc->bc", pmass[None, :] * fac, dx,
                      precision=HIGHEST)
    pot = jnp.sum(pmass[None, :] * jnp.where(r > 0, grav_pot(r, h), 0.0),
                  axis=-1)
    if pctx is not None:
        from gadget_leicester_tpu.ops.ewald import ewald_correction_jnp
        ca, cp = ewald_correction_jnp(dx, box, table)
        m = pmass[None, :]
        acc = acc + jnp.einsum("bp,bpc->bc", m * jnp.ones_like(r), ca,
                             precision=HIGHEST)
        pot = pot + jnp.sum(m * cp, axis=-1)
    return acc, pot
