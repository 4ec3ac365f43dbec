"""The GPU cell-pair kernel (ops.cell_pairs) in the Pallas interpreter,
against the XLA cells path (same cell list, same pair set) and the
all-pairs oracles; plus the backend dispatch rule, the CUDA lowering of
each body, the compile-cache helper and the f32 precision pins.

Geometries: fully periodic (one device), slab (clamped x, periodic y/z:
the SPMD shards) and vacuum (clamped on every axis)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import core as jax_core

from gadget_leicester_tpu.ops import cell_pairs
from gadget_leicester_tpu.ops.cell_pairs import (kernel_capacity,
                                                 pair_backend)
from gadget_leicester_tpu.ops.gravity_short import shortrange_gravity_cells
from gadget_leicester_tpu.ops.neighbors import build_cell_list
from gadget_leicester_tpu.ops.sph_cells import (density_adaptive_cells,
                                                density_sums_cells,
                                                hydro_force_cells)

BOX = 10.0
GEOMS = {
    "periodic": (4, True),
    "slab": ((3, 4, 4), (False, True, True)),
    "vacuum": (4, False),
}


N_CLUMP = 64


def _particles(rng, n=600, clumped=False, geom="periodic"):
    """Uniform particles. ``clumped``: the x-index-0 layer of a 4^3 grid is
    left empty and cell (2, 2, 2) holds exactly N_CLUMP particles (a full
    cell at capacity 64). The slab geometry keeps x away from the faces:
    its x axis is clamped, while the XLA reference minimum-images all axes
    (as the SPMD step does, where slabs are narrower than half the box)."""
    pos = rng.uniform(0.01, BOX - 0.01, (n, 3))
    if clumped:
        pos[:, 0] = rng.uniform(2.51, BOX - 0.01, n)
        inside = np.all((pos >= 5.0) & (pos < 7.5), axis=1)
        pos[inside, 0] -= 2.5
        pos[:N_CLUMP] = 6.25 + np.clip(rng.normal(scale=0.3,
                                                  size=(N_CLUMP, 3)),
                                       -1.2, 1.2)
    if geom == "slab":
        pos[:, 0] = 1.5 + pos[:, 0] * 0.7
    return (jnp.asarray(pos, jnp.float32),
            jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
            jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32))


def _cells(pos, mask, geom, capacity=64):
    n_cells, periodic = GEOMS[geom]
    origin, extent = (0.0, BOX)
    return build_cell_list(pos, mask, origin, extent, n_cells=n_cells,
                           capacity=capacity, periodic=periodic)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-30)
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _per(cl):
    """The XLA path's single periodicity switch for a grid."""
    return cl.periodic is not False


def _grav(cl, pos, mass, soft, alive, backend, **kw):
    asmth = BOX / 4 / 4.5 * 0.9
    return shortrange_gravity_cells(cl, pos, mass, soft, alive, asmth,
                                    4.5 * asmth, box=BOX, periodic=_per(cl),
                                    backend=backend, **kw)


# ---------------------------------------------------------------------------
# gravity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_potential", [False, True])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_gravity_kernel_matches_xla(rng, geom, with_potential):
    pos, _, mass = _particles(rng, clumped=geom != "slab", geom=geom)
    soft = jnp.asarray(rng.uniform(0.1, 0.3, pos.shape[0]), jnp.float32)
    alive = jnp.ones(pos.shape[0], bool).at[N_CLUMP::17].set(False)
    cl = _cells(pos, alive, geom, capacity=64)
    assert not bool(cl.overflow)
    ref = _grav(cl, pos, mass, soft, alive, "xla",
                with_potential=with_potential)
    got = _grav(cl, pos, mass, soft, alive, "triton",
                with_potential=with_potential, interpret=True)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        _close(g, r, 2e-5)


def test_gravity_kernel_matches_direct_oracle(rng):
    """Periodic erfc-truncated direct sum over all pairs (minimum image)."""
    from gadget_leicester_tpu.ops.gravity_direct import (shortrange_trunc,
                                                         shortrange_trunc_pot)
    from gadget_leicester_tpu.ops.softening import grav_fac, grav_pot
    pos, _, mass = _particles(rng, n=400)
    soft = jnp.full((400,), 0.2, jnp.float32)
    alive = jnp.ones(400, bool)
    cl = _cells(pos, alive, "periodic")
    acc, pot = _grav(cl, pos, mass, soft, alive, "triton",
                     with_potential=True, interpret=True)
    asmth = BOX / 4 / 4.5 * 0.9
    d = pos[:, None, :] - pos[None, :, :]
    d = d - BOX * jnp.round(d / BOX)
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    keep = (r < 4.5 * asmth) & (r > 0)
    fac = jnp.where(keep, grav_fac(r, 0.2) * shortrange_trunc(r, asmth), 0.0)
    ref = -jnp.einsum("ij,ijd->id", fac * mass[None, :], d,
                      precision=jax.lax.Precision.HIGHEST)
    pw = jnp.where(keep, grav_pot(r, 0.2) * shortrange_trunc_pot(r, asmth), 0.)
    _close(acc, ref, 2e-5)
    _close(pot, jnp.sum(pw * mass[None, :], axis=1), 2e-5)


def test_gravity_kernel_stale_assignment_across_wrap(rng):
    """Particles drifted across the periodic face keep their old cell: the
    cell-relative coordinates are minimum-imaged when packed."""
    pos, _, mass = _particles(rng, n=300)
    pos = pos.at[:30, 0].set(0.2)
    soft = jnp.full((300,), 0.2, jnp.float32)
    alive = jnp.ones(300, bool)
    cl = _cells(pos, alive, "periodic")
    moved = pos.at[:30, 0].set(BOX - 0.1)          # stale: still in cell 0
    fresh = _cells(moved, alive, "periodic")
    ref = _grav(fresh, moved, mass, soft, alive, "xla")
    got = _grav(cl, moved, mass, soft, alive, "triton", interpret=True)
    _close(got, ref, 2e-5)


# ---------------------------------------------------------------------------
# SPH density
# ---------------------------------------------------------------------------
def _gas(rng, geom, n=600):
    pos, vel, mass = _particles(rng, n=n, clumped=geom != "slab", geom=geom)
    gm = jnp.ones(n, bool).at[N_CLUMP::17].set(False)
    h = jnp.asarray(rng.uniform(0.8, 2.4, n), jnp.float32)
    return pos, vel, mass, gm, h


@pytest.mark.parametrize("geom", list(GEOMS))
def test_density_sweep_matches_xla(rng, geom):
    pos, vel, mass, gm, h = _gas(rng, geom)
    cl = _cells(pos, gm, geom)
    assert not bool(cl.overflow)
    ref = density_sums_cells(cl, pos, vel, mass, h, gm, box=BOX,
                             periodic=_per(cl))
    sweep = cell_pairs.density_sweep_kernel(cl, pos, vel, mass, gm, gm,
                                            interpret=True)
    got = sweep(h)
    g = np.asarray(gm)
    for a, b in zip(got, ref):
        _close(np.asarray(a)[g], np.asarray(b)[g], 2e-5)


def test_density_adaptive_matches_xla(rng):
    pos, vel, mass, gm, h = _gas(rng, "periodic")
    cl = _cells(pos, gm, "periodic")
    kw = dict(des_num_ngb=12.0, max_dev=1.0, max_hsml=BOX / 4, box=BOX,
              periodic=True)
    ref = density_adaptive_cells(cl, pos, vel, mass, h, gm, **kw)
    got = density_adaptive_cells(cl, pos, vel, mass, h, gm, backend="triton",
                                 interpret=True, **kw)
    g = np.asarray(gm)
    for name in ("rho", "hsml", "div_vel", "curl_vel"):
        _close(np.asarray(getattr(got, name))[g],
               np.asarray(getattr(ref, name))[g], 1e-4)


def test_density_matches_dense_oracle(rng):
    from gadget_leicester_tpu.ops.sph_dense import density_sums
    pos, vel, mass, gm, _ = _gas(rng, "periodic", n=400)
    h = jnp.full((400,), 1.5, jnp.float32)     # h <= cell edge 2.5
    cl = _cells(pos, gm, "periodic")
    got = cell_pairs.density_sweep_kernel(cl, pos, vel, mass, gm, gm,
                                          interpret=True)(h)
    ref = density_sums(pos, vel, mass, h, gm, box=BOX, periodic=True)
    g = np.asarray(gm)
    for a, b in zip(got, ref):
        _close(np.asarray(a)[g], np.asarray(b)[g], 2e-5)


# ---------------------------------------------------------------------------
# SPH hydro
# ---------------------------------------------------------------------------
def _hydro_inputs(rng, geom, n=600):
    pos, vel, mass, gm, h = _gas(rng, geom, n=n)
    cl = _cells(pos, gm, geom)
    rho = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    prs = 0.3 * rho ** (5.0 / 3.0)
    div = jnp.asarray(rng.normal(size=n), jnp.float32)
    curl = jnp.asarray(rng.uniform(0.0, 1.0, n), jnp.float32)
    dhf = jnp.asarray(rng.uniform(0.8, 1.2, n), jnp.float32)
    return cl, (pos, vel, mass, h, rho, prs, dhf, div, curl, gm)


HYDRO_KW = dict(visc_const=0.8, box=BOX, hubble_a2_flow=0.1,
                hubble_a2_norm=1.3, fac_mu=0.9)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_hydro_kernel_matches_xla(rng, geom):
    cl, args = _hydro_inputs(rng, geom)
    ref = hydro_force_cells(cl, *args, periodic=_per(cl), **HYDRO_KW)
    got = hydro_force_cells(cl, *args, periodic=_per(cl), backend="triton",
                            interpret=True, **HYDRO_KW)
    for a, b in zip(got, ref):
        _close(a, b, 2e-5)


def test_hydro_matches_dense_oracle(rng):
    from gadget_leicester_tpu.ops.sph_dense import hydro_force
    cl, args = _hydro_inputs(rng, "periodic", n=400)
    args = args[:3] + (jnp.full((400,), 1.2, jnp.float32),) + args[4:]
    got = hydro_force_cells(cl, *args, periodic=True, backend="triton",
                            interpret=True, **HYDRO_KW)
    ref = hydro_force(*args, periodic=True, **HYDRO_KW)
    g = np.asarray(args[-1])
    for a, b in zip(got, ref):
        _close(np.asarray(a)[g], np.asarray(b)[g], 2e-5)


# ---------------------------------------------------------------------------
# the skeleton: capacity, overflow, activity gate
# ---------------------------------------------------------------------------
def _body_call(body, rng, capacity, targets=None):
    """One call of each body on the same clumped particle set."""
    pos, vel, mass = _particles(rng, n=500, clumped=True)
    assert int(cell_pairs.cell_flags(
        _cells(pos, jnp.ones(500, bool), "periodic"),
        jnp.ones(500, bool)).min()) == 0
    mask = jnp.ones(500, bool)
    cl = _cells(pos, mask, "periodic", capacity=capacity)
    tgt = mask if targets is None else targets
    if body == "gravity":
        soft = jnp.full((500,), 0.2, jnp.float32)
        out = _grav(cl, pos, mass, soft, mask, "triton", targets=tgt,
                    interpret=True)
        return cl, (out,)
    if body == "density":
        sweep = cell_pairs.density_sweep_kernel(cl, pos, vel, mass, mask,
                                                tgt, interpret=True)
        return cl, sweep(jnp.full((500,), 1.5, jnp.float32))
    out = hydro_force_cells(cl, pos, vel, mass, jnp.full((500,), 1.5),
                            jnp.ones(500), jnp.ones(500), jnp.ones(500),
                            jnp.zeros(500), jnp.zeros(500), mask,
                            periodic=True, backend="triton", targets=tgt,
                            interpret=True, **HYDRO_KW)
    return cl, tuple(out)


BODIES = ["gravity", "density", "hydro"]


@pytest.mark.parametrize("body", BODIES)
def test_capacity_padding_changes_nothing(rng, body):
    """Extra empty slots (a larger power-of-two capacity) leave every sum
    bit-identical: the loops follow the counts, not the capacity."""
    seed = int(rng.integers(1 << 30))
    cl, small = _body_call(body, np.random.default_rng(seed), 64)
    assert not bool(cl.overflow) and int(cl.counts.max()) == 64  # full
    assert int(cl.counts.min()) == 0                             # empty
    _, big = _body_call(body, np.random.default_rng(seed), 256)
    for a, b in zip(small, big):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("body", BODIES)
def test_overflowing_cell_raises_flag_and_stays_finite(rng, body):
    """The clump overfills a cap-32 cell: the cell list flags it, dropped
    particles come back as zero rows, and nothing turns non-finite."""
    cl, out = _body_call(body, rng, 32)
    assert bool(cl.overflow)
    dropped = np.asarray(cl.gslot) < 0
    assert dropped.any()
    for a in out:
        a = np.asarray(a)
        assert np.all(np.isfinite(a))
        assert np.all(a[dropped] == 0)


@pytest.mark.parametrize("body", BODIES)
def test_inactive_cells_are_skipped(rng, body):
    """Cells without a target return zeros; targets keep the full sums."""
    seed = int(rng.integers(1 << 30))
    cl, full = _body_call(body, np.random.default_rng(seed), 64)
    tgt = jnp.arange(500) < 40
    _, part = _body_call(body, np.random.default_rng(seed), 64, targets=tgt)
    cell_has_tgt = np.asarray(cell_pairs.cell_flags(cl, tgt)) > 0
    in_tgt_cell = cell_has_tgt[np.asarray(cl.cell_of)]
    t = np.asarray(tgt)
    assert (~in_tgt_cell).any()
    for a, b in zip(part, full):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(a[t], b[t])
        assert np.all(a[~in_tgt_cell] == 0)


@pytest.mark.parametrize("mean,override,want", [
    (10.0, 0, 32), (33.0, 0, 128), (107.0, 0, 256), (50.0, 300, 512)])
def test_kernel_capacity(mean, override, want):
    cap = kernel_capacity(mean, override)
    assert cap == want
    assert cap & (cap - 1) == 0 and cap % cell_pairs.TB == 0


def test_kernel_refuses_non_power_of_two_capacity(rng):
    pos, _, mass = _particles(rng, n=100)
    mask = jnp.ones(100, bool)
    cl = _cells(pos, mask, "periodic", capacity=96)
    with pytest.raises(ValueError, match="power of two"):
        _grav(cl, pos, mass, jnp.full((100,), 0.2), mask, "triton",
              interpret=True)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("platform,dtype,want", [
    ("gpu", "f32", "triton"), ("cpu", "f32", "xla"), ("gpu", "f64", "xla"),
    ("cpu", "f64", "xla")])
def test_pair_backend_rule(platform, dtype, want):
    assert pair_backend(platform, dtype) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_pair_backend_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no cell-pair backend"):
        pair_backend(platform)


def test_pair_backend_here_is_xla():
    assert jax.default_backend() == "cpu"
    assert pair_backend() == "xla"


# ---------------------------------------------------------------------------
# CUDA lowering (Triton IR is generated here, without a card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("geom", ["periodic", "slab"])
@pytest.mark.parametrize("body", BODIES)
def test_bodies_lower_for_cuda(body, geom):
    n = 512
    r = np.random.default_rng(3)
    pos = jnp.asarray(r.uniform(0, BOX, (n, 3)), jnp.float32)
    one = jnp.ones(n, jnp.float32)
    mask = jnp.ones(n, bool)

    def fn(pos):
        cl = _cells(pos, mask, geom, capacity=64)
        if body == "gravity":
            return _grav(cl, pos, one, 0.2 * one, mask, "triton",
                         with_potential=True)
        if body == "density":
            return density_adaptive_cells(
                cl, pos, pos, one, one, mask, 33.0, 2.0, max_hsml=2.5,
                box=BOX, periodic=True, backend="triton").rho
        return hydro_force_cells(cl, pos, pos, one, one, one, one, one, one,
                                 one, mask, periodic=True, backend="triton",
                                 **HYDRO_KW).acc

    text = jax.jit(fn).trace(pos).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text


# ---------------------------------------------------------------------------
# precision pins: f32 pair sums must not drop to TF32 on the GPU
# ---------------------------------------------------------------------------
def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax_core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _pin_cases():
    from gadget_leicester_tpu.ops import (gravity_direct, sph_dense, tree)
    n = 64
    r = np.random.default_rng(0)
    pos = jnp.asarray(r.uniform(0, BOX, (n, 3)), jnp.float32)
    one = jnp.ones(n, jnp.float32)
    mask = jnp.ones(n, bool)
    cl = build_cell_list(pos, mask, 0.0, BOX, n_cells=4, capacity=32,
                         periodic=True)
    return {
        "gravity_short": lambda: shortrange_gravity_cells.__wrapped__(
            cl, pos, one, one, mask, 0.5, 2.2, box=BOX),
        "sph_cells_density": lambda: density_sums_cells.__wrapped__(
            cl, pos, pos, one, one, mask, box=BOX, periodic=True),
        "sph_cells_hydro": lambda: hydro_force_cells.__wrapped__(
            cl, pos, pos, one, one, one, one, one, one, one, mask,
            visc_const=0.8, box=BOX, periodic=True),
        "gravity_direct": lambda: gravity_direct.direct_gravity(
            pos, one, one, mask),
        "sph_dense_density": lambda: sph_dense.density_sums.__wrapped__(
            pos, pos, one, one, mask),
        "sph_dense_hydro": lambda: sph_dense.hydro_force.__wrapped__(
            pos, pos, one, one, one, one, one, one, one, mask,
            visc_const=0.8),
        "tree": lambda: tree.tree_gravity(pos, one, 0.1 * one, mask,
                                          depth=3),
    }


@pytest.mark.parametrize("name", ["gravity_short", "sph_cells_density",
                                  "sph_cells_hydro", "gravity_direct",
                                  "sph_dense_density", "sph_dense_hydro",
                                  "tree"])
def test_pair_sum_precision_is_pinned(name):
    precs = _dot_precisions(_pin_cases()[name])
    assert precs, f"{name}: no dot_general found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi for q in p), (name, p)


# ---------------------------------------------------------------------------
# compile-cache helper
# ---------------------------------------------------------------------------
_CACHE_PROBE = """
import json, os, sys
sys.path.insert(0, {repo!r})
import jax
from gadget_leicester_tpu.utils.compile_cache import enable_compile_cache
path = enable_compile_cache({checkout!r})
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: x * 2 + 1)(jax.numpy.arange(5.0)).block_until_ready()
print(json.dumps([path, jax.config.jax_compilation_cache_dir]))
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(tmp_path, env_set):
    import json
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkout = str(tmp_path / "checkout")
    os.makedirs(checkout)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(checkout, ".jax_cache")
    if env_set:
        want = str(tmp_path / "x")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c",
                        _CACHE_PROBE.format(repo=repo, checkout=checkout)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    path, cfg_dir = json.loads(r.stdout.strip().splitlines()[-1])
    assert path == want and cfg_dir == want
    assert os.listdir(want), "no cache entry written"
    if env_set:
        assert not os.path.exists(os.path.join(checkout, ".jax_cache"))


# ---------------------------------------------------------------------------
# on the card (skipped without a GPU; chip_smoke.py runs the same checks)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("body", BODIES)
def test_compiled_kernel_matches_xla_on_gpu(gpu_device, rng, body):
    pos, vel, mass = _particles(rng, n=4000)
    mask = jnp.ones(4000, bool)
    cl = _cells(pos, mask, "periodic", capacity=256)
    if body == "gravity":
        soft = jnp.full((4000,), 0.2, jnp.float32)
        ref = _grav(cl, pos, mass, soft, mask, "xla")
        got = _grav(cl, pos, mass, soft, mask, "triton")
        _close(got, ref, 1e-4)
    elif body == "density":
        h = jnp.full((4000,), 1.5, jnp.float32)
        ref = density_sums_cells(cl, pos, vel, mass, h, mask, box=BOX,
                                 periodic=True)
        got = cell_pairs.density_sweep_kernel(cl, pos, vel, mass, mask,
                                              mask)(h)
        for a, b in zip(got, ref):
            _close(a, b, 1e-4)
    else:
        args = (pos, vel, mass, jnp.full((4000,), 1.5), jnp.ones(4000),
                jnp.ones(4000), jnp.ones(4000), jnp.zeros(4000),
                jnp.zeros(4000), mask)
        ref = hydro_force_cells(cl, *args, periodic=True, **HYDRO_KW)
        got = hydro_force_cells(cl, *args, periodic=True, backend="triton",
                                **HYDRO_KW)
        for a, b in zip(got, ref):
            _close(a, b, 1e-4)
