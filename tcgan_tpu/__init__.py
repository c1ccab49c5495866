"""tcgan_tpu — JAX framework with the capabilities of ahmadianlab/tc-gan,
running on an NVIDIA GPU (one H100, or several over a device mesh).

Fits stabilized supralinear network (SSN) circuit models — recurrent rate
networks with dynamics ``tau * dr/dt = -r + f(W @ r + I_ext)``, where
``f(u) = k * relu(u)**n`` — to distributions of heterogeneous neural tuning
curves via WGAN-GP, conditional WGAN, and moment matching.

Reference parity map (see SURVEY.md; the reference mount was empty at build
time, so citations are to the upstream layout ``tc_gan/...`` as reconstructed
there):

- ``tcgan_tpu.ops``      ~ ``tc_gan/ssnode.py`` + ``tc_gan/gradient_expressions/``
  (numeric + symbolic core, unified: JAX erases the NumPy/Theano split)
- ``tcgan_tpu.models``   ~ ``tc_gan/networks/`` (generator/critic assemblies)
- ``tcgan_tpu.train``    ~ ``tc_gan/drivers.py``, ``recorders.py``, ``execution.py``
- ``tcgan_tpu.cli``      ~ ``tc_gan/run/``
- ``tcgan_tpu.data``     ~ dataset loading / fake-truth generation
- ``tcgan_tpu.analysis`` ~ ``tc_gan/loaders.py``, ``tc_gan/analyzers/``
- ``tcgan_tpu.parallel`` — device-mesh sharding (no reference analog; the
  reference is single-process OpenMP)
- ``tcgan_tpu.ops.pallas`` ~ ``tc_gan/ext/`` (native solver; here a fused GPU
  kernel instead of OpenMP C)
"""

__version__ = "0.1.0"

from tcgan_tpu.ops import io_funs, weights, stimulus  # noqa: F401
