"""Device-mesh sharding for sample-parallel (and optional tensor-parallel)
execution.

No reference analog: the reference is single-process OpenMP/BLAS
(SURVEY.md §2 parallelism census). This is its replacement:
`jax.sharding.Mesh` + jit shardings; XLA inserts the collectives (psum for
sharded reductions, all-gathers where layouts demand).
"""

from tcgan_tpu.parallel.mesh import (  # noqa: F401
    BATCH_AXIS,
    MODEL_AXIS,
    make_mesh,
    make_sharded_ensemble_step,
    make_sharded_gan_step,
    make_sharded_mm_step,
    with_mesh_axes,
)
