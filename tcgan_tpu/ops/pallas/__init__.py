"""Fused Pallas GPU kernel — the native-solver layer.

Reference parity: ``tc_gan/ext/`` (the reference's only first-party native
component, an OpenMP C batch Euler solver — SURVEY.md §2 native-code
census). Here the equivalent is a fused GPU kernel on Pallas's Triton
route: the whole fixed-point iteration (matmul + rectified-power
nonlinearity + convergence/divergence masking) runs inside one kernel,
one circuit per program, with the circuit's weights kept on chip.
"""

from tcgan_tpu.ops.pallas.ssn_solve import solve_fixed_point_pallas  # noqa: F401
