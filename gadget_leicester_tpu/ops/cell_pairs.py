"""Cell-pair sums on the GPU: one Pallas kernel skeleton (Triton route) with
three pair bodies, for the three pair loops of the force pass: TreePM
short-range gravity [G2: forcetree.c :: force_treeevaluate_shortrange()],
the SPH density sums [G2: density.c :: density_evaluate()] and the SPH
hydro sums [G2: hydra.c :: hydro_evaluate()].

Layout. Particles are binned by :func:`ops.neighbors.build_cell_list`; this
module gathers each cell's slots into SoA tiles ``src[F, C, cap]`` (``cap``
a power of two). Rows 0-2 hold positions RELATIVE to the assigned cell's
centre, minimum-imaged on periodic axes when packed, so the separation of a
pair is ``t - s - offset * edge`` with a per-neighbour constant shift: exact
for a stale in-margin assignment, and no per-pair minimum image. Empty or
dead slots park at a finite far offset with zero weight.

Grid. One program per (target cell, block of ``TB`` target slots): grid
``(C, cap // TB)``. A program loops over the 27 neighbour cells and, inside,
over ``SB``-slot chunks of each neighbour's occupied slots, so the work
follows the occupancy and not the capacity. Sums stay in registers and
nothing carries between programs. A program whose cell holds no flagged
target (inactive particles; converged targets of a density sweep), or
whose slot block lies past the cell's count, stores zeros and returns.

Geometry is per axis (``n_cells``/``periodic`` as 3-tuples), so the SPMD
slab grids (clamped x, periodic y/z) run the same kernel as one card.

The pair math is elementwise float32 on the CUDA cores; there is no dot.
The plain reference for every body is the XLA cells path
(``ops.gravity_short`` / ``ops.sph_cells`` with ``backend="xla"``), and
behind it the all-pairs oracles.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from gadget_leicester_tpu.ops.jit_util import hybrid_jit
from gadget_leicester_tpu.ops.neighbors import CellList, _axes3
from gadget_leicester_tpu.ops.sph_kernels import (kernel_dw_dr,
                                                  kernel_w_and_dwdh)

TB = 32          # target slots per program
SB = 16          # source slots per inner chunk
NUM_WARPS = 4
PARK_EDGES = 7.0  # parked slots sit this many cell edges away

_INV_SQRT_PI2 = 2.0 / math.sqrt(math.pi)


def pair_backend(platform: str | None = None, dtype="f32") -> str:
    """The one choice between the kernel and the XLA cells path, made from
    the observed platform: "gpu" -> "triton", "cpu" -> "xla" (also the
    tests' plain reference). The kernel is float32, so a DOUBLEPRECISION
    state takes the XLA path on either. Any other platform is an error."""
    platform = jax.default_backend() if platform is None else platform
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(f"no cell-pair backend for platform {platform!r}"
                           " (supported: gpu, cpu)")
    return "triton" if platform == "gpu" and dtype == "f32" else "xla"


def kernel_capacity(mean_occupancy: float, override: int = 0) -> int:
    """Per-cell slot capacity for the kernel tiles: a power of two at least
    twice the mean occupancy (the work follows the counts, so headroom
    costs memory only), never below one target block or source chunk."""
    want = override if override > 0 else int(math.ceil(2.0 * mean_occupancy))
    return max(TB, SB, 1 << max(0, (want - 1).bit_length()))


# ---------------------------------------------------------------------------
# Packing (XLA side)
# ---------------------------------------------------------------------------
def _cell_centers(cl: CellList, dtype):
    """[C, 3] geometric centres of the grid cells (grid-build frame)."""
    nx, ny, nz = _axes3(cl.n_cells)
    c_arr = jnp.arange(nx * ny * nz, dtype=jnp.int32)
    cx = (c_arr // (ny * nz)).astype(dtype)
    cy = ((c_arr // nz) % ny).astype(dtype)
    cz = (c_arr % nz).astype(dtype)
    return (jnp.stack([cx, cy, cz], -1) + 0.5) / cl.inv_cell + cl.origin


def pack_tiles(cl: CellList, pos, cols, valid):
    """``src[3 + len(cols), C, cap]`` float32 tiles: cell-relative positions
    then one row per column of ``cols`` ([N] arrays). ``valid`` ([N] bool)
    marks particles that may act as sources; other slots park far away
    with zero columns."""
    idx = jnp.maximum(cl.cells, 0)
    ok = (cl.cells >= 0) & valid[idx]
    centers = _cell_centers(cl, pos.dtype)
    rel = pos[idx] - centers[:, None, :]                    # [C, cap, 3]
    ext = jnp.asarray(_axes3(cl.n_cells), pos.dtype) / cl.inv_cell
    per = jnp.asarray(_axes3(cl.periodic), bool)
    rel = jnp.where(per, rel - ext * jnp.round(rel / ext), rel)
    far = -PARK_EDGES / cl.inv_cell
    rel = jnp.where(ok[..., None], rel, far)
    rows = [rel[..., 0], rel[..., 1], rel[..., 2]]
    if cols:
        table = jnp.stack(cols, axis=1)                     # [N, K]
        vals = jnp.where(ok[..., None], table[idx], 0.0)    # [C, cap, K]
        rows += [vals[..., k] for k in range(table.shape[1])]
    return jnp.stack(rows).astype(jnp.float32)


def target_tile(cl: CellList, col):
    """[1, C, cap] tile of a target-only column (0 in empty slots)."""
    idx = jnp.maximum(cl.cells, 0)
    return jnp.where(cl.cells >= 0, col[idx], 0.0)[None].astype(jnp.float32)


def cell_flags(cl: CellList, mask):
    """[C] int32: 1 where the cell holds a slot whose particle is in
    ``mask`` — the per-program activity gate."""
    idx = jnp.maximum(cl.cells, 0)
    return jnp.any((cl.cells >= 0) & mask[idx], axis=1).astype(jnp.int32)


def unpack_rows(out, cl: CellList):
    """Kernel output [R, C, cap] -> per-particle [N, R] via the cell list's
    slot map (dead or capacity-dropped particles get zero rows)."""
    r = out.shape[0]
    flat = out.reshape(r, -1)
    flat = jnp.concatenate([flat, jnp.zeros((r, 1), flat.dtype)], axis=1)
    gidx = jnp.where(cl.gslot >= 0, cl.gslot, flat.shape[1] - 1)
    return jnp.take(flat, gidx, axis=1).T


# ---------------------------------------------------------------------------
# The kernel skeleton
# ---------------------------------------------------------------------------
class PairSpec(NamedTuple):
    """One pair body. ``t_rows``: src rows loaded for the target block
    (positions first); ``s_rows``: src rows loaded per source chunk
    (positions first); ``n_extra``: target-only rows of the ``extra``
    input; ``reduce``: "sum" or "max" per output row; ``body(tv, sv, dx,
    dy, dz, prm)`` returns one [TB, SB] contribution per output."""

    name: str
    t_rows: tuple
    s_rows: tuple
    n_extra: int
    reduce: tuple
    body: Callable


# lax.div / lax.rem on non-negative ints: jnp's floor division and modulo
# add sign fix-ups that the Triton lowering rejects
_div, _rem = jax.lax.div, jax.lax.rem


def _neighbour(coord, off, n, periodic):
    a = coord + off
    if periodic:
        return _rem(a + n, n), None
    return jnp.clip(a, 0, n - 1), (a >= 0) & (a < n)


def _make_kernel(spec: PairSpec, n_cells, periodic, n_prm: int):
    nx, ny, nz = n_cells
    px, py, pz = periodic
    n_out = len(spec.reduce)
    f32 = jnp.float32

    def kernel(prm_ref, cnt_ref, flg_ref, src_ref, *rest):
        if spec.n_extra:
            extra_ref, out_ref = rest
        else:
            (out_ref,) = rest
        c = pl.program_id(0)
        base = pl.program_id(1) * TB
        cnt = cnt_ref[c]
        run = (flg_ref[c] != 0) & (base < cnt)

        @pl.when(run)
        def _():
            prm = tuple(prm_ref[i] for i in range(n_prm))
            tmask = (base + jnp.arange(TB, dtype=jnp.int32)) < cnt
            tv = tuple(src_ref[r, c, pl.ds(base, TB)] for r in spec.t_rows)
            tv += tuple(extra_ref[r, c, pl.ds(base, TB)]
                        for r in range(spec.n_extra))
            cx = _div(c, ny * nz)
            cy = _rem(_div(c, nz), ny)
            cz = _rem(c, nz)

            def nbr(j, accs):
                ox = _div(j, 9) - 1
                oy = _rem(_div(j, 3), 3) - 1
                oz = _rem(j, 3) - 1
                ax, vx = _neighbour(cx, ox, nx, px)
                ay, vy = _neighbour(cy, oy, ny, py)
                az, vz = _neighbour(cz, oz, nz, pz)
                nc = (ax * ny + ay) * nz + az
                ns = cnt_ref[nc]
                for v in (vx, vy, vz):
                    if v is not None:
                        ns = jnp.where(v, ns, 0)
                shx = ox.astype(f32) * prm[0]
                shy = oy.astype(f32) * prm[1]
                shz = oz.astype(f32) * prm[2]

                def chunk(i, accs):
                    s0 = i * SB
                    sv = tuple(src_ref[r, nc, pl.ds(s0, SB)]
                               for r in spec.s_rows)
                    smask = (s0 + jnp.arange(SB, dtype=jnp.int32)) < ns
                    ok = tmask[:, None] & smask[None, :]
                    dx = tv[0][:, None] - (sv[0][None, :] + shx)
                    dy = tv[1][:, None] - (sv[1][None, :] + shy)
                    dz = tv[2][:, None] - (sv[2][None, :] + shz)
                    vals = spec.body(tv, sv, dx, dy, dz, prm)
                    new = []
                    for acc, v, red in zip(accs, vals, spec.reduce):
                        v = jnp.where(ok, v, 0.0)
                        new.append(acc + v if red == "sum"
                                   else jnp.maximum(acc, v))
                    return tuple(new)

                return jax.lax.fori_loop(0, _div(ns + SB - 1, SB), chunk,
                                         accs)

            # partial sums stay [TB, SB] across the loops: one lane
            # reduction per output at the end, none per chunk
            zero = tuple(jnp.zeros((TB, SB), f32) for _ in range(n_out))
            accs = jax.lax.fori_loop(0, 27, nbr, zero)
            for r, (acc, red) in enumerate(zip(accs, spec.reduce)):
                out_ref[r, c, pl.ds(base, TB)] = (
                    jnp.sum(acc, axis=1) if red == "sum"
                    else jnp.max(acc, axis=1))

        @pl.when(jnp.logical_not(run))
        def _():
            for r in range(n_out):
                out_ref[r, c, pl.ds(base, TB)] = jnp.zeros((TB,), f32)

    return kernel


def pair_sums(spec: PairSpec, cl: CellList, src, prm, flags, extra=None,
              interpret: bool = False):
    """Run one pair body over a cell list. ``src`` [F, C, cap] from
    :func:`pack_tiles`; ``prm`` [P] float32 runtime scalars (the three
    cell edges first); ``flags`` [C] int32 from :func:`cell_flags`.
    Returns [R, C, cap] per-slot sums. ``interpret`` runs the kernel
    through the Pallas interpreter (CPU tests only)."""
    n_cells = _axes3(cl.n_cells)
    periodic = tuple(bool(p) for p in _axes3(cl.periodic))
    c, cap = cl.cells.shape
    if cap < max(TB, SB) or cap & (cap - 1):
        raise ValueError(f"kernel capacity {cap} must be a power of two "
                         f">= {max(TB, SB)}")
    kernel = _make_kernel(spec, n_cells, periodic, prm.shape[0])
    counts = jnp.minimum(cl.counts, cap).astype(jnp.int32)   # overflowed
    args = [prm.astype(jnp.float32), counts, flags.astype(jnp.int32),
            src.astype(jnp.float32)]
    if spec.n_extra:
        args.append(extra.astype(jnp.float32))
    return pl.pallas_call(
        kernel,
        grid=(c, cap // TB),
        out_shape=jax.ShapeDtypeStruct((len(spec.reduce), c, cap),
                                       jnp.float32),
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name=spec.name,
    )(*args)


def edges_of(cl: CellList):
    """[3] cell edge lengths (the stencil shift unit)."""
    return (1.0 / cl.inv_cell).astype(jnp.float32)


def _scalars(*vals):
    return jnp.stack([jnp.asarray(v, jnp.float32).reshape(()) for v in vals])


# ---------------------------------------------------------------------------
# Pair bodies
# ---------------------------------------------------------------------------
def _rinv_r(r2):
    pos = r2 > 0
    rinv = jnp.where(pos, jax.lax.rsqrt(jnp.where(pos, r2, 1.0)), 0.0)
    return rinv, r2 * rinv, pos


def _erfc(x):
    """erfc for x >= 0, fractional error < 1.2e-7 (Numerical Recipes'
    Chebyshev fit): lax.erfc has no Triton lowering."""
    t = 1.0 / (1.0 + 0.5 * x)
    p = -1.26551223 + t * (1.00002368 + t * (0.37409196 + t * (
        0.09678418 + t * (-0.18628806 + t * (0.27886807 + t * (
            -1.13520398 + t * (1.48851587 + t * (
                -0.82215223 + t * 0.17087277))))))))
    return t * jnp.exp(p - x * x)


def _grav_fac(u, rinv, hinv, h):
    """Softened 1/r^3 force factor of ops.softening.grav_fac without
    divisions (h = max softening of the pair, hinv its inverse)."""
    hinv3 = hinv * hinv * hinv
    rinv3 = rinv * rinv * rinv
    uinv3 = h * h * h * rinv3
    inner = hinv3 * (10.666666666667 + u * u * (32.0 * u - 38.4))
    outer = hinv3 * (21.333333333333 - 48.0 * u + 38.4 * u * u
                     - 10.666666666667 * (u * u * u)
                     - 0.066666666667 * uinv3)
    return jnp.where(u < 0.5, inner, jnp.where(u < 1.0, outer, rinv3))


def _grav_pot(u, rinv, hinv, h):
    """Softened potential factor of ops.softening.grav_pot (r > 0)."""
    uinv = h * rinv
    wp_inner = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    wp_outer = (-3.2 + 0.066666666667 * uinv
                + u * u * (10.666666666667
                           + u * (-16.0 + u * (9.6 - 2.133333333333 * u))))
    return jnp.where(u < 0.5, hinv * wp_inner,
                     jnp.where(u < 1.0, hinv * wp_outer, -rinv))


# gravity src rows: x y z mass soft 1/soft; prm: edges, 1/(2 asmth), rcut
def gravity_spec(with_potential: bool) -> PairSpec:
    def body(tv, sv, dx, dy, dz, prm):
        half_inv, rcut = prm[3], prm[4]
        r2 = dx * dx + dy * dy + dz * dz
        rinv, r, pos = _rinv_r(r2)
        h = jnp.maximum(tv[3][:, None], sv[4][None, :])
        hinv = jnp.minimum(tv[4][:, None], sv[5][None, :])
        u = r * hinv
        x = r * half_inv
        erfc = _erfc(x)
        trunc = erfc + _INV_SQRT_PI2 * x * jnp.exp(-x * x)
        keep = pos & (r < rcut)
        w = jnp.where(keep, sv[3][None, :] * _grav_fac(u, rinv, hinv, h)
                      * trunc, 0.0)
        out = (-w * dx, -w * dy, -w * dz)
        if with_potential:
            out += (jnp.where(keep, sv[3][None, :]
                              * _grav_pot(u, rinv, hinv, h) * erfc, 0.0),)
        return out

    n_out = 4 if with_potential else 3
    return PairSpec(name="sr_gravity_pairs", t_rows=(0, 1, 2, 4, 5),
                    s_rows=(0, 1, 2, 3, 4, 5), n_extra=0,
                    reduce=("sum",) * n_out, body=body)


# density src rows: x y z vx vy vz mass; extra: h
def _density_body(tv, sv, dx, dy, dz, prm):
    r2 = dx * dx + dy * dy + dz * dz
    rinv, r, _ = _rinv_r(r2)
    th = tv[6][:, None]
    w, dwdh = kernel_w_and_dwdh(r, th)
    dwdr = kernel_dw_dr(r, th)
    m = sv[6][None, :]
    dvx = tv[3][:, None] - sv[3][None, :]
    dvy = tv[4][:, None] - sv[4][None, :]
    dvz = tv[5][:, None] - sv[5][None, :]
    fac = m * dwdr * rinv
    return (m * w, m * dwdh,
            -fac * (dvx * dx + dvy * dy + dvz * dz),
            fac * (dvy * dz - dvz * dy),
            fac * (dvz * dx - dvx * dz),
            fac * (dvx * dy - dvy * dx))


DENSITY_SPEC = PairSpec(name="sph_density_pairs", t_rows=(0, 1, 2, 3, 4, 5),
                        s_rows=(0, 1, 2, 3, 4, 5, 6), n_extra=1,
                        reduce=("sum",) * 6, body=_density_body)


# hydro src rows: x y z vx vy vz mass h rho P/rho^2*f c_snd balsara
def hydro_spec(visc_const: float) -> PairSpec:
    def body(tv, sv, dx, dy, dz, prm):
        hubble_a2_flow, fac_mu = prm[3], prm[4]
        r2 = dx * dx + dy * dy + dz * dz
        rinv, r, pos = _rinv_r(r2)
        th, trho, tpor2, tc, tbal = (tv[k][:, None] for k in range(6, 11))
        sm, sh, srho, spor2, sc, sbal = (sv[k][None, :] for k in range(6, 12))
        inside = (r < jnp.maximum(th, sh)) & pos
        dwk_i = kernel_dw_dr(r, th)
        dwk_j = kernel_dw_dr(r, sh)
        vdotr2 = ((tv[3][:, None] - sv[3][None, :]) * dx
                  + (tv[4][:, None] - sv[4][None, :]) * dy
                  + (tv[5][:, None] - sv[5][None, :]) * dz
                  + hubble_a2_flow * r2)
        approaching = vdotr2 < 0
        mu_ij = fac_mu * vdotr2 * rinv
        vsig = tc + sc - 3.0 * jnp.where(approaching, mu_ij, 0.0)
        rho_ij = 0.5 * (trho + srho)
        rho_ij = jnp.where(rho_ij > 0, rho_ij, 1.0)
        f_ij = 0.5 * (tbal + sbal)
        visc = jnp.where(approaching,
                         0.5 * visc_const * vsig * (-mu_ij) / rho_ij * f_ij,
                         0.0)
        hfc_visc = 0.5 * sm * visc * (dwk_i + dwk_j) * rinv
        hfc = hfc_visc + sm * (tpor2 * dwk_i + spor2 * dwk_j) * rinv
        hfc = jnp.where(inside, hfc, 0.0)
        hfc_visc = jnp.where(inside, hfc_visc, 0.0)
        return (-hfc * dx, -hfc * dy, -hfc * dz,
                0.5 * hfc_visc * vdotr2,
                jnp.where(inside, vsig, 0.0))

    return PairSpec(name="sph_hydro_pairs",
                    t_rows=(0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11),
                    s_rows=tuple(range(12)), n_extra=0,
                    reduce=("sum",) * 4 + ("max",), body=body)


# ---------------------------------------------------------------------------
# Per-sum drivers (cell list in, per-particle sums out)
# ---------------------------------------------------------------------------
@partial(hybrid_jit, static_argnames=("with_potential", "interpret"))
def shortrange_gravity_kernel(cl: CellList, pos, mass, soft, alive, targets,
                              asmth, rcut, with_potential: bool = False,
                              interpret: bool = False):
    """Short-range gravity pair sums: [N, 3] acceleration (no G factor),
    plus [N] potential with ``with_potential``. ``targets`` ([N] bool)
    gates the programs: cells without a target store zeros."""
    soft_inv = 1.0 / jnp.maximum(soft, 1e-30)
    src = pack_tiles(cl, pos, [mass, soft, soft_inv], alive)
    prm = jnp.concatenate([edges_of(cl), _scalars(0.5 / asmth, rcut)])
    out = pair_sums(gravity_spec(with_potential), cl, src, prm,
                    cell_flags(cl, targets & alive), interpret=interpret)
    rows = unpack_rows(out, cl)
    if with_potential:
        return rows[:, :3], rows[:, 3]
    return rows[:, :3]


def density_sweep_kernel(cl: CellList, pos, vel, mass, gas_mask, targets,
                         interpret: bool = False):
    """Returns ``sweep(h, undone=None)`` for density_adaptive_generic over
    the first ``targets.shape[0]`` rows: the source tiles are packed once;
    each sweep packs only the target h and runs the programs of cells that
    still hold an undone target."""
    src = pack_tiles(cl, pos, [vel[:, 0], vel[:, 1], vel[:, 2], mass],
                     gas_mask)
    prm = edges_of(cl)
    n, nt = pos.shape[0], targets.shape[0]

    def sweep(h, undone=None):
        hp = jnp.zeros((n,), jnp.float32).at[:nt].set(h)
        tgt = targets if undone is None else targets & undone
        tgt = jnp.zeros((n,), bool).at[:nt].set(tgt)
        out = pair_sums(DENSITY_SPEC, cl, src, prm, cell_flags(cl, tgt),
                        extra=target_tile(cl, hp), interpret=interpret)
        rows = unpack_rows(out, cl)[:nt]
        return rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:6]

    return sweep


def hydro_sums_kernel(cl: CellList, pos, vel, mass, hsml, rho, p_over_rho2,
                      c_snd, balsara, gas_mask, targets, visc_const: float,
                      hubble_a2_flow, fac_mu, interpret: bool = False):
    """Hydro pair sums: ([N,3] acc, [N] raw dA/dt sum, [N] max signal
    velocity), before the entropy normalisation."""
    src = pack_tiles(cl, pos, [vel[:, 0], vel[:, 1], vel[:, 2], mass, hsml,
                               rho, p_over_rho2, c_snd, balsara], gas_mask)
    prm = jnp.concatenate([edges_of(cl), _scalars(hubble_a2_flow, fac_mu)])
    out = pair_sums(hydro_spec(float(visc_const)), cl, src, prm,
                    cell_flags(cl, targets & gas_mask), interpret=interpret)
    rows = unpack_rows(out, cl)
    return rows[:, :3], rows[:, 3], rows[:, 4]
