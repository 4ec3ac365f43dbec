"""Particle-mesh long-range gravity — rebuild of [G2: pm_periodic.c ::
pmforce_periodic()] as a single fused XLA program:

  CIC scatter-add -> jnp.fft.rfftn -> Green's function
  (-4 pi G / k^2) * exp(-k^2 Asmth^2) * CIC-deconvolution(sinc^-4)
  -> inverse FFT -> 4-point finite-difference gradient -> CIC gather.

The reference's FFTW-MPI slab machinery (ghost-layer exchanges, slab
decomposition) disappears: single-chip PM is one fused program; the
multi-chip version lives in ``parallel.pm_sharded`` (pencil FFT with
all_to_all over ICI).

Asmth/Rcut convention [G2: allvars.h ASMTH=1.25, RCUT=4.5]: the
long/short split scale is asmth = 1.25 grid cells; the short-range force
is cut at rcut = 4.5 * asmth.
"""

from __future__ import annotations

from functools import partial

from gadget_leicester_tpu.ops.jit_util import hybrid_jit

import jax
import jax.numpy as jnp

ASMTH = 1.25  # in units of mesh cells [G2: allvars.h]
RCUT = 4.5    # in units of asmth


def _cic_weights8(pos, box: float, n: int):
    """Base cell [N,3] (wrapped) + the 8 corner weights [N,8] in
    (dx,dy,dz) bit order (k = 4*dx + 2*dy + dz)."""
    u = pos * (n / box)
    i0f = jnp.floor(u)
    frac = u - i0f
    i0 = jnp.mod(i0f.astype(jnp.int32), n)
    wx = jnp.stack([1.0 - frac[:, 0], frac[:, 0]], -1)
    wy = jnp.stack([1.0 - frac[:, 1], frac[:, 1]], -1)
    wz = jnp.stack([1.0 - frac[:, 2], frac[:, 2]], -1)
    w = (wx[:, :, None, None] * wy[:, None, :, None]
         * wz[:, None, None, :]).reshape(-1, 8)
    return i0, w


def cic_deposit(pos, weight, box: float, n: int):
    """Cloud-in-cell mass assignment onto an [n,n,n] periodic mesh.

    Eight per-corner point scatter-adds (atomic adds on the GPU)."""
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


def cic_gather(grid, pos, box: float, n: int):
    """CIC interpolation of a scalar mesh field back to particle positions."""
    return cic_gather_vec(grid[..., None], pos, box, n)[:, 0]


def cic_gather_vec(field, pos, box: float, n: int):
    """CIC interpolation of a VECTOR mesh field [n,n,n,C] back to
    particle positions.

    The field is re-packed once so each cell's row carries its full
    2x2x2 corner neighbourhood ([n,n,n,8*C], built with eight rolls),
    and the per-particle interpolation is then ONE [8*C]-row gather —
    8x fewer gather ops than per-corner reads."""
    c = field.shape[-1]
    i0, w = _cic_weights8(pos, box, n)
    parts = []
    for k in range(8):
        dx, dy, dz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        part = field
        if dx:
            part = jnp.roll(part, -1, axis=0)
        if dy:
            part = jnp.roll(part, -1, axis=1)
        if dz:
            part = jnp.roll(part, -1, axis=2)
        parts.append(part)
    packed = jnp.concatenate(parts, axis=-1)         # [n,n,n,8*C]
    rows = packed[i0[:, 0], i0[:, 1], i0[:, 2]]      # [N, 8*C]
    rows = rows.reshape(-1, 8, c)
    return jnp.sum(rows * w[:, :, None], axis=1)


def greens_function(n: int, box: float, asmth_grid: float, dtype=jnp.float32):
    """k-space multiplier: -4 pi / k^2 * exp(-k^2 asmth^2) * CIC-deconv^2
    (G applied by the caller). Shaped for rfftn output [n, n, n//2+1].
    [G2: pm_periodic.c k-loop body]"""
    kf = 2.0 * jnp.pi / box
    kx = jnp.fft.fftfreq(n, 1.0 / n).astype(dtype) * kf
    kz = (jnp.arange(n // 2 + 1, dtype=dtype)) * kf
    KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
    k2 = KX**2 + KY**2 + KZ**2
    asmth_len = asmth_grid * box / n

    def sinc(x):
        x = jnp.abs(x)
        return jnp.where(x > 1e-8, jnp.sin(x) / jnp.where(x > 1e-8, x, 1.0), 1.0)

    h = box / n
    w = (sinc(KX * h / 2) * sinc(KY * h / 2) * sinc(KZ * h / 2)) ** 2  # CIC W(k)
    deconv = 1.0 / jnp.maximum(w, 1e-8) ** 2  # deposit + gather
    k2_safe = jnp.where(k2 > 0, k2, 1.0)
    g = -4.0 * jnp.pi / k2_safe * jnp.exp(-k2 * asmth_len**2) * deconv
    return jnp.where(k2 > 0, g, 0.0)


@partial(hybrid_jit, static_argnames=("n", "gradient", "with_potential"))
def pm_forces_periodic(
    pos,
    mass,
    alive,
    box: float,
    n: int,
    asmth_grid: float = ASMTH,
    gradient: str = "fd4",
    with_potential: bool = False,
):
    """Long-range accelerations (no G factor), periodic box.

    gradient="fd4": 4-point finite difference, matches the reference
    [G2: pm_periodic.c]; "spectral": ik-space gradient (3 extra iFFTs,
    more accurate at the Nyquist end).
    Returns acc[N,3], or (acc, pot[N]) when with_potential (sharing the
    deposit + forward FFT — the potential is a free CIC gather of phi).
    """
    f = pos.dtype
    posw = jnp.mod(pos, box)
    m = jnp.where(alive, mass, 0.0).astype(f)
    rho = cic_deposit(posw, m, box, n)     # mass mesh (not density; the
    # 4 pi G/k^2 Green's fn absorbs the cell volume via the DFT convention:
    # phi_k = G(k) rho_k / V_cell ... we fold constants below.
    rho_k = jnp.fft.rfftn(rho)
    g_k = greens_function(n, box, asmth_grid, dtype=f)
    # DFT normalisation: continuous FT ~ V_cell * DFT; inverse adds 1/V.
    # phi = F^-1[ -4 pi /k^2 rhohat ] with rhohat = mass_k / V_cell:
    cell_vol = (box / n) ** 3
    phi_k = g_k * rho_k / cell_vol
    phi = jnp.fft.irfftn(phi_k, (n, n, n))

    h = box / n
    kf = 2.0 * jnp.pi / box
    kx = jnp.fft.fftfreq(n, 1.0 / n).astype(f) * kf
    kz = jnp.arange(n // 2 + 1, dtype=f) * kf
    KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
    comp = []
    for K in (KX, KY, KZ):
        if gradient == "spectral":
            mult = -1j * K
        else:
            # the SAME 4th-order stencil [G2: pm_periodic.c], applied as
            # its (exactly equivalent) diagonal k-space multiplier —
            # three inverse FFTs instead of twelve 1M-cell rolls:
            # D4(k) = i (8 sin(kh) - sin(2kh)) / (6h)
            mult = -1j * (8.0 * jnp.sin(K * h) - jnp.sin(2.0 * K * h)) / (6.0 * h)
        comp.append(jnp.fft.irfftn(mult * phi_k, (n, n, n)))
    if with_potential:
        comp.append(phi)  # fold phi into the vector gather (one pass)
    force = jnp.stack(comp, axis=-1)
    out = cic_gather_vec(force, posw, box, n)
    acc = jnp.where(alive[:, None], out[:, :3], 0.0)
    if with_potential:
        return acc, jnp.where(alive, out[:, 3], 0.0)
    return acc


# ---------------------------------------------------------------------------
# Non-periodic (vacuum boundary) PM — rebuild of [G2: pm_nonperiodic.c]
# ---------------------------------------------------------------------------
def _freespace_kernel_k(n: int, cell: float, asmth_len: float, dtype):
    """FFT of the long-range free-space Green's function on the 2n^3
    zero-padded grid (Hockney & Eastwood convolution):

        g_long(x) = -erf(|x| / (2 asmth)) / |x|      (smooth at x=0)

    which is exactly the PM part of the TreePM force split — the erfc
    short-range remainder comes from the tree/cell kernels, identical to
    the periodic case [G2: pm_nonperiodic.c kernel setup].
    """
    m = 2 * n
    # signed distances with FFT wrap ordering: 0,1,...,n-1,-n,...,-1 (cells)
    ax = jnp.where(jnp.arange(m) < n, jnp.arange(m), jnp.arange(m) - m)
    ax = ax.astype(dtype) * cell
    X, Y, Z = jnp.meshgrid(ax, ax, ax, indexing="ij")
    r = jnp.sqrt(X**2 + Y**2 + Z**2)
    r_safe = jnp.maximum(r, 1e-30)
    g = -jax.lax.erf(r_safe / (2.0 * asmth_len)) / r_safe
    g0 = -1.0 / (asmth_len * jnp.sqrt(jnp.pi))  # limit at r -> 0
    g = jnp.where(r > 0, g, g0)
    gk = jnp.fft.rfftn(g)
    # CIC deconvolution (deposit + gather), as in the periodic Green's fn
    # [G2: pm_nonperiodic.c ff*ff factors]
    kf = 2.0 * jnp.pi / (m * cell)
    kx = jnp.fft.fftfreq(m, 1.0 / m).astype(dtype) * kf
    kz = jnp.arange(m // 2 + 1, dtype=dtype) * kf

    def sinc(x):
        x = jnp.abs(x)
        return jnp.where(x > 1e-8, jnp.sin(x) / jnp.where(x > 1e-8, x, 1.0),
                         1.0)

    KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
    w = (sinc(KX * cell / 2) * sinc(KY * cell / 2) * sinc(KZ * cell / 2)) ** 2
    return gk / jnp.maximum(w, 1e-8) ** 2


def vacuum_field(grid, n: int, cell, asmth_len):
    """Free-space (zero-padded Hockney-Eastwood) solve on the 2n^3 grid:
    returns (force[m,m,m,3], phi[m,m,m]). Shared by the single-device
    vacuum PM below and the SPMD vacuum PM (parallel.pm_sharded), which
    psums the deposited octant and then runs this replicated per shard
    [G2: pm_nonperiodic.c solve, rank-replicated instead of
    slab-decomposed FFT]."""
    f = grid.dtype
    m = 2 * n
    gk = _freespace_kernel_k(n, cell, asmth_len, f)
    phi_k = jnp.fft.rfftn(grid) * gk
    phi = jnp.fft.irfftn(phi_k, (m, m, m))
    h = cell
    # FD4 gradient as its diagonal k-space multiplier (see periodic path)
    kf = 2.0 * jnp.pi / (m * cell)
    kx = jnp.fft.fftfreq(m, 1.0 / m).astype(f) * kf
    kz = jnp.arange(m // 2 + 1, dtype=f) * kf
    KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
    comp = []
    for K in (KX, KY, KZ):
        mult = -1j * (8.0 * jnp.sin(K * h) - jnp.sin(2.0 * K * h)) / (6.0 * h)
        comp.append(jnp.fft.irfftn(mult * phi_k, (m, m, m)))
    return jnp.stack(comp, axis=-1), phi


@partial(hybrid_jit, static_argnames=("n", "with_potential"))
def pm_forces_nonperiodic(
    pos,
    mass,
    alive,
    origin,
    extent: float,
    n: int,
    asmth_grid: float = ASMTH,
    with_potential: bool = False,
):
    """Vacuum-boundary long-range accelerations (no G factor) via
    zero-padded FFT convolution on a 2n^3 mesh over the region
    [origin, origin+extent). Pair with the erfc-truncated short-range
    force (asmth = asmth_grid * extent / n) for the full gravity.
    """
    f = pos.dtype
    cell = extent / n
    asmth_len = asmth_grid * cell
    m = 2 * n
    rel = pos - jnp.broadcast_to(jnp.asarray(origin, f), (3,))[None, :]
    msrc = jnp.where(alive, mass, 0.0).astype(f)
    # deposit into the first octant of the padded grid; CIC in region coords
    grid = cic_deposit(jnp.clip(rel, 0.0, extent * 0.9999999),
                       msrc, 2.0 * extent, m)
    force, phi = vacuum_field(grid, n, cell, asmth_len)
    posw = jnp.clip(rel, 0.0, extent * 0.9999999)
    acc = cic_gather_vec(force, posw, 2.0 * extent, m)
    acc = jnp.where(alive[:, None], acc, 0.0)
    if with_potential:
        pot = jnp.where(alive, cic_gather(phi, posw, 2.0 * extent, m), 0.0)
        return acc, pot
    return acc


@partial(hybrid_jit, static_argnames=("n",))
def pm_potential_periodic(pos, mass, alive, box: float, n: int,
                          asmth_grid: float = ASMTH):
    """Long-range potential at particle positions (no G factor) — for
    energy diagnostics and the TreePM potential split."""
    f = pos.dtype
    m = jnp.where(alive, mass, 0.0).astype(f)
    posw = jnp.mod(pos, box)
    rho = cic_deposit(posw, m, box, n)
    rho_k = jnp.fft.rfftn(rho)
    g_k = greens_function(n, box, asmth_grid, dtype=f)
    phi = jnp.fft.irfftn(g_k * rho_k / (box / n) ** 3, (n, n, n))
    return cic_gather(phi, posw, box, n)


# ---------------------------------------------------------------------------
# Two-level zoom PM — rebuild of [G2: pm_nonperiodic.c PLACEHIGHRESREGION]
# ---------------------------------------------------------------------------
def _freespace_diff_kernel_k(n: int, cell, asmth_hi, asmth_lo, dtype):
    """FFT of the BAND-PASS free-space kernel on the 2n^3 padded grid:

        g_diff(x) = -[erf(|x|/(2 a_hi)) - erf(|x|/(2 a_lo))] / |x|

    i.e. the force content between the fine-mesh smoothing a_hi and the
    coarse-mesh smoothing a_lo — what the reference's second high-res
    mesh supplies inside the zoom region [G2: pm_nonperiodic.c kernel
    setup with PLACEHIGHRESREGION]. `cell`/`asmth_*` may be traced (the
    region auto-fits the flagged particle types each PM step)."""
    m = 2 * n
    ax = jnp.where(jnp.arange(m) < n, jnp.arange(m), jnp.arange(m) - m)
    ax = ax.astype(dtype) * cell
    X, Y, Z = jnp.meshgrid(ax, ax, ax, indexing="ij")
    r = jnp.sqrt(X**2 + Y**2 + Z**2)
    r_safe = jnp.maximum(r, 1e-30)
    g = -(jax.lax.erf(r_safe / (2.0 * asmth_hi))
          - jax.lax.erf(r_safe / (2.0 * asmth_lo))) / r_safe
    g0 = -(1.0 / asmth_hi - 1.0 / asmth_lo) / jnp.sqrt(jnp.pi)
    g = jnp.where(r > 0, g, g0)
    gk = jnp.fft.rfftn(g)
    kf = 2.0 * jnp.pi / (m * cell)
    kx = jnp.fft.fftfreq(m, 1.0 / m).astype(dtype) * kf
    kz = jnp.arange(m // 2 + 1, dtype=dtype) * kf

    def sinc(x):
        x = jnp.abs(x)
        return jnp.where(x > 1e-8, jnp.sin(x) / jnp.where(x > 1e-8, x, 1.0),
                         1.0)

    KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
    w = (sinc(KX * cell / 2) * sinc(KY * cell / 2) * sinc(KZ * cell / 2)) ** 2
    return gk / jnp.maximum(w, 1e-8) ** 2


@partial(hybrid_jit, static_argnames=("n", "with_potential"))
def pm_forces_diff(
    pos, mass, alive, origin, extent, n: int, asmth_lo,
    asmth_grid: float = ASMTH, with_potential: bool = False,
):
    """Band-pass zoom-mesh force for particles in [origin, origin+extent):
    smooth force at the FINE scale minus the coarse-mesh content already
    supplied at `asmth_lo`. Sources AND targets are the in-region alive
    particles (out-of-region rows return zero). `origin`/`extent` may be
    traced."""
    f = pos.dtype
    origin = jnp.broadcast_to(jnp.asarray(origin, f), (3,))
    extent = jnp.asarray(extent, f)
    cell = extent / n
    asmth_hi = asmth_grid * cell
    m = 2 * n
    rel = pos - origin[None, :]
    in_reg = jnp.all((rel >= 0) & (rel < extent), axis=-1) & alive
    msrc = jnp.where(in_reg, mass, 0.0).astype(f)
    posw = jnp.clip(rel, 0.0, extent * 0.9999999)
    grid = cic_deposit(posw, msrc, 2.0 * extent, m)
    gk = _freespace_diff_kernel_k(n, cell, asmth_hi, asmth_lo, f)
    phi_k = jnp.fft.rfftn(grid) * gk
    kf = 2.0 * jnp.pi / (m * cell)
    kx = jnp.fft.fftfreq(m, 1.0 / m).astype(f) * kf
    kz = jnp.arange(m // 2 + 1, dtype=f) * kf
    KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
    comp = []
    h = cell
    for K in (KX, KY, KZ):
        mult = -1j * (8.0 * jnp.sin(K * h) - jnp.sin(2.0 * K * h)) / (6.0 * h)
        comp.append(jnp.fft.irfftn(mult * phi_k, (m, m, m)))
    if with_potential:
        comp.append(jnp.fft.irfftn(phi_k, (m, m, m)))
    force = jnp.stack(comp, axis=-1)
    out = cic_gather_vec(force, posw, 2.0 * extent, m)
    acc = jnp.where(in_reg[:, None], out[:, :3], 0.0)
    if with_potential:
        return acc, jnp.where(in_reg, out[:, 3], 0.0), in_reg
    return acc, in_reg
