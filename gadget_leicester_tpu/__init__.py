"""gadget_leicester_tpu — a JAX cosmological N-body + SPH framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the GADGET-2
family Leicester fork (retrojetpacks/Gadget-Leicester): Barnes-Hut tree
gravity and TreePM, entropy-formulation SPH with adaptive smoothing lengths,
individual power-of-two block timesteps on a symplectic KDK integrator,
comoving or physical integration, periodic or vacuum boundaries, radiative
cooling and sink/accretion particles.

This is NOT a port: the architecture is accelerator-first (static shapes, masked
vectorised updates, Morton-sorted batched tree traversal, sharded FFT PM,
`shard_map` domain decomposition over a `jax.sharding.Mesh`).

Reference architecture is documented in SURVEY.md (repository root);
reference citations in docstrings use the convention ``[G2: file.c :: function()]``
(canonical GADGET-2.0.7 file + function; the reference mount was empty at
build time, see SURVEY.md provenance warning).
"""

__version__ = "0.1.0"

from gadget_leicester_tpu.core.config import SimConfig, SimOptions, read_parameter_file
from gadget_leicester_tpu.core.state import ParticleState, GasState, SimState

__all__ = [
    "SimConfig",
    "SimOptions",
    "read_parameter_file",
    "ParticleState",
    "GasState",
    "SimState",
    "__version__",
]
