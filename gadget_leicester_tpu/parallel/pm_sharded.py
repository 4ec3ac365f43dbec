"""Sharded particle-mesh gravity — the multi-chip rebuild of the
reference's FFTW-MPI slab PM [G2: pm_periodic.c :: pmforce_periodic(),
slabs_per_task / ghost-layer exchange].

Redesign (explicit shard_map + collectives, not GSPMD guesswork):

* deposit: each shard CIC-deposits its OWN particles (whatever slab they
  fall in) onto a full local mesh, then one ``psum_scatter`` reduces and
  leaves each shard owning an x-slab — replacing the reference's
  send/recv of ghost layers with a single dense ICI collective (the
  particle sharding is positional, so a gather-based exchange would be
  all-to-all anyway; the mesh reduction has the same volume and rides
  the fastest collective path).
* FFT: pencil decomposition. rFFT along z and FFT along y are local to
  the x-slab; one ``all_to_all`` re-pencils x <-> kz so the x FFT is
  local too. k-space multipliers (Green's function, FD4 gradient) are
  built per-shard from its kz range. Inverse transforms mirror this.
* force gather: the 4-component force/potential mesh is ``all_gather``'d
  (n^3*4 floats over ICI) and each shard CIC-interpolates to its own
  particles.

Validated against the single-device ops.pm.pm_forces_periodic to ~1e-5
rms on a virtual 8-device CPU mesh (tests/test_pm_sharded.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gadget_leicester_tpu.ops.pm import ASMTH, cic_deposit, cic_gather_vec
from gadget_leicester_tpu.parallel.mesh import AXIS


def _kvec(n: int, dtype, box: float):
    kf = 2.0 * jnp.pi / box
    return jnp.fft.fftfreq(n, 1.0 / n).astype(dtype) * kf


def _pencil_rfft3(local, axis_name, n_shards):
    """Forward 3-D rFFT of an x-slab-sharded real mesh.

    local: [n/D, n, n] real. Returns [n, n, (n//2+1)/D] complex — the
    OUTPUT is kz-pencil-sharded (kx fully local after the all_to_all).
    Requires (n//2+1) % D == 0? No: we split the z axis BEFORE the rfft
    completes... we split kz in D chunks, so n//2+1 must be divisible by
    D — callers pad the mesh so that holds (n % (2*D) == 0 gives
    n//2+1 = D*m + 1 ... so instead we transform z fully and split the
    first n//2 bins, carrying the Nyquist bin replicated).

    Simpler contract used here: n % D == 0 and we all_to_all over the
    FULL fft (not rfft) z axis, keeping complex [n/D, n, n] -> after
    exchange [n, n, n/D]. The redundant negative-kz half costs 2x FFT
    work but keeps every axis evenly divisible — at PM mesh sizes the
    FFTs are a small part of the PM step, so the simplicity wins.
    """
    f = jnp.fft.fft(jnp.fft.fft(local.astype(jnp.complex64), axis=2), axis=1)
    # re-pencil: split kz (axis 2) across shards, concatenate x (axis 0)
    f = jax.lax.all_to_all(f, axis_name, split_axis=2, concat_axis=0,
                           tiled=True)                  # [n, n, n/D]
    return jnp.fft.fft(f, axis=0)


def _pencil_irfft3(fk, axis_name, n_shards):
    """Inverse of _pencil_rfft3: [n, n, n/D] complex -> [n/D, n, n] real."""
    f = jnp.fft.ifft(fk, axis=0)
    f = jax.lax.all_to_all(f, axis_name, split_axis=0, concat_axis=2,
                           tiled=True)                  # [n/D, n, n]
    f = jnp.fft.ifft(jnp.fft.ifft(f, axis=1), axis=2)
    return jnp.real(f)


def pm_local_forces(pos, mass, alive, box: float, n: int, d: int,
                    asmth_grid: float = ASMTH,
                    with_potential: bool = False):
    """PM force/potential for the LOCAL particles of one shard — call
    INSIDE a shard_map over the ``AXIS`` mesh axis (d = axis size). The
    collectives (psum_scatter, all_to_all, all_gather) ride that axis."""
    h = box / n
    asmth_len = asmth_grid * h
    cell_vol = h**3

    def sinc(x):
        x = jnp.abs(x)
        return jnp.where(x > 1e-8, jnp.sin(x) / jnp.where(x > 1e-8, x, 1.0),
                         1.0)

    def local_fn(pos, mass, alive):
        me = jax.lax.axis_index(AXIS)
        f = pos.dtype
        m = jnp.where(alive, mass, 0.0).astype(f)
        posw = jnp.mod(pos, box)
        # local full-mesh deposit, then reduce_scatter to own x-slab
        grid = cic_deposit(posw, m, box, n)             # [n, n, n]
        slab = jax.lax.psum_scatter(grid, AXIS, scatter_dimension=0,
                                    tiled=True)         # [n/D, n, n]

        fk = _pencil_rfft3(slab, AXIS, d)               # [n, n, n/D]

        # per-shard k arrays: kx full, ky full, kz = my n/D chunk
        kx = _kvec(n, f, box)
        kz_all = _kvec(n, f, box)
        kz = jax.lax.dynamic_slice(kz_all, (me * (n // d),), (n // d,))
        KX, KY, KZ = jnp.meshgrid(kx, kx, kz, indexing="ij")
        k2 = KX**2 + KY**2 + KZ**2
        w = (sinc(KX * h / 2) * sinc(KY * h / 2) * sinc(KZ * h / 2)) ** 2
        deconv = 1.0 / jnp.maximum(w, 1e-8) ** 2
        k2_safe = jnp.where(k2 > 0, k2, 1.0)
        gk = -4.0 * jnp.pi / k2_safe * jnp.exp(-k2 * asmth_len**2) * deconv
        gk = jnp.where(k2 > 0, gk, 0.0)
        phi_k = fk * (gk / cell_vol)

        comps = []
        for kvec in (KX, KY, KZ):
            mult = -1j * (8.0 * jnp.sin(kvec * h)
                          - jnp.sin(2.0 * kvec * h)) / (6.0 * h)
            comps.append(_pencil_irfft3(mult * phi_k, AXIS, d))
        if with_potential:
            comps.append(_pencil_irfft3(phi_k, AXIS, d))
        field_slab = jnp.stack(comps, axis=-1)          # [n/D, n, n, C]
        # each shard needs values at its own (arbitrary-x) particles:
        field = jax.lax.all_gather(field_slab, AXIS, axis=0, tiled=True)
        out = cic_gather_vec(field, posw, box, n)
        acc = jnp.where(alive[:, None], out[:, :3], 0.0)
        if with_potential:
            return acc, jnp.where(alive, out[:, 3], 0.0)
        return acc

    return local_fn(pos, mass, alive)


def pm_local_forces_vacuum(pos, mass, alive, origin, extent: float, n: int,
                           asmth_grid: float = ASMTH,
                           with_potential: bool = False):
    """Vacuum-boundary PM for the LOCAL particles of one shard — call
    INSIDE a shard_map over the ``AXIS`` axis [G2: pm_nonperiodic.c under
    MPI]. Each shard CIC-deposits its own particles onto the zero-padded
    2n^3 grid; only the (n+1)^3 octant is occupied, so ONE psum of that
    octant (4(n+1)^3 bytes over ICI) replicates the global density, and
    the free-space convolution (ops.pm.vacuum_field) then runs
    REPLICATED per shard with a local CIC gather. Replication trades
    FLOPs for zero further comms — the padded FFT is small next to the
    force kernels at production sizes; the pencil all_to_all
    decomposition (periodic path above) is the recorded upgrade if this
    ever profiles hot."""
    from gadget_leicester_tpu.ops.pm import cic_gather, vacuum_field
    f = pos.dtype
    cell = extent / n
    asmth_len = asmth_grid * cell
    m = 2 * n
    org = jnp.broadcast_to(jnp.asarray(origin, f), (3,))
    rel = jnp.clip(pos - org[None, :], 0.0, extent * 0.9999999)
    msrc = jnp.where(alive, mass, 0.0).astype(f)
    grid = cic_deposit(rel, msrc, 2.0 * extent, m)
    octant = jax.lax.psum(grid[:n + 1, :n + 1, :n + 1], AXIS)
    grid = jnp.zeros((m, m, m), f).at[:n + 1, :n + 1, :n + 1].set(octant)
    force, phi = vacuum_field(grid, n, cell, asmth_len)
    acc = cic_gather_vec(force, rel, 2.0 * extent, m)
    acc = jnp.where(alive[:, None], acc, 0.0)
    if with_potential:
        pot = jnp.where(alive, cic_gather(phi, rel, 2.0 * extent, m), 0.0)
        return acc, pot
    return acc


def make_pm_sharded(mesh: Mesh, box: float, n: int,
                    asmth_grid: float = ASMTH,
                    with_potential: bool = False):
    """Build fn(pos, mass, alive) -> acc (or (acc, pot)) operating on
    dim-0-sharded particle arrays over `mesh`. n % n_shards == 0."""
    d = mesh.shape[AXIS]
    if n % d != 0:
        raise ValueError(f"pm mesh n={n} must divide the {d}-way mesh axis")

    def local_fn(pos, mass, alive):
        return pm_local_forces(pos, mass, alive, box, n, d,
                               asmth_grid=asmth_grid,
                               with_potential=with_potential)

    spec_p = P(AXIS)
    out_specs = (P(AXIS), P(AXIS)) if with_potential else P(AXIS)
    fn = jax.shard_map(local_fn, mesh=mesh,
                       in_specs=(spec_p, spec_p, spec_p),
                       out_specs=out_specs)
    return fn
