"""Compute kernels (ops layer): SPH kernels, softened gravity, neighbour
infrastructure, Barnes-Hut tree, particle-mesh FFT gravity, the GPU
cell-pair kernel (ops.cell_pairs).

These are the rebuilds of the reference's hot loops
[G2: forcetree.c, density.c, hydra.c, pm_periodic.c] — batched, masked,
static-shape jnp/Pallas code instead of per-particle pointer walks.
"""
