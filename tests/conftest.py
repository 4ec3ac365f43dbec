"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without accelerators (SURVEY.md
§4 item 6 — the rebuild analog of `mpirun -np K` on one box). The platform
is pinned in the config before first backend use.

Tests marked ``gpu`` need the card (compiled kernels, no interpreter):
the ``gpu_device`` fixture skips them when JAX sees no GPU. The decision
is made inside the fixture, never at import, so every pytest-xdist worker
collects the same tests. ``python chip_smoke.py`` runs the same checks on
the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless the caller names platforms (e.g. JAX_PLATFORMS=cuda,cpu to run
# the gpu-marked tests on the card)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test on a machine without one."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernels have no "
                    "CPU path); chip_smoke.py runs these checks on the card")
    return devs[0]


@pytest.fixture()
def rng(request):
    # function-scoped + per-test seed: random data is deterministic and
    # INDEPENDENT of test execution order (a shared session stream made
    # borderline-tolerance tests order-flaky)
    import zlib
    seed = zlib.crc32(request.node.nodeid.encode())  # stable across runs
    return np.random.default_rng(seed)
