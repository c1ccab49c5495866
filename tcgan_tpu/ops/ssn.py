"""SSN model configuration and the Euler dynamics step.

The continuous dynamics (paper eq.; SURVEY.md §0):

    tau_a * dr_i/dt = -r_i + f(u_i),   u = W @ r + I_ext

with per-population time constants tau_E (first N neurons) / tau_I (last N)
and io nonlinearity f from :mod:`tcgan_tpu.ops.io_funs`. The forward Euler
step with timestep dt is

    r <- r + (dt / tau) * (-r + f(W @ r + I_ext)).

Reference parity: the scan body of ``tc_gan/networks/ssn.py`` (Theano path)
and the C loop of ``tc_gan/ext/`` (native path) — one JAX implementation
serves both (SURVEY.md §4's cross-implementation pattern collapses to
cross-checking this step against the Pallas kernel and the C++ CPU baseline).

Shape convention: the stimulus-condition axis S is kept as a leading
matrix dimension so the recurrent drive is a real matmul

    u = r @ W^T + I,   r: (..., S, 2N), W: (..., 2N, 2N)

(M = S conditions, K = N' = 2N, N = 2N) instead of S separate matvecs,
which is what puts the inner loop on the matrix units.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from tcgan_tpu.ops import io_funs

# Default circuit parameters. The reference's exact defaults could not be
# line-verified (empty reference mount — see SURVEY.md provenance notice);
# these follow the paper's bandwidth-tuning setup as recalled in SURVEY.md §2
# and are overridable everywhere (CLI: --J/--D/--S/--N/...).
DEFAULT_J = ((0.0957, 0.0638), (0.1197, 0.0479))
DEFAULT_D = ((0.7660, 0.5106), (0.9575, 0.3830))
DEFAULT_S = ((0.2500, 0.0918), (0.2500, 0.0918))
DEFAULT_BANDWIDTHS = (0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0)
DEFAULT_CONTRASTS = (20.0,)


@dataclasses.dataclass(frozen=True)
class SSNConfig:
    """Static (hashable, jit-safe) SSN + solver configuration.

    Mirrors the reference's shared flag family (SURVEY.md §5.6): circuit
    size/params, io type, integration step, solver tolerances, and the
    divergence ceiling.
    """

    N: int = 51  # sites per population (2N neurons total)
    k: float = 0.01
    n: float = 2.2
    tau_E: float = 0.016  # seconds
    tau_I: float = 0.002
    dt: float = 0.0005
    io_type: str = "asym_power"
    rate_soft_bound: float = 100.0
    rate_hard_bound: float = 200.0
    L: float = 1.0  # grid extent; sites span [-L/2, L/2]
    smoothness: float = 0.03125  # stimulus edge smoothing
    # Solver:
    max_iter: int = 10000
    atol: float = 1e-5  # convergence: max|dr/dt_scaled| < atol
    rate_stop_at: float = 200.0  # divergence ceiling on any rate
    seqlen: int = 4000  # BPTT path: number of unrolled Euler steps
    # Forward-solver backend: "xla" = lockstep batched while_loop;
    # "pallas" = fused GPU kernel, one circuit per program with per-circuit
    # early exit (ops/pallas; needs an NVIDIA GPU and one circuit's W
    # within a block's shared memory).
    backend: str = "xla"
    # Two-phase precision: TF32 matmul loop to a coarse residual, then an
    # f32-accurate tail to the real atol.
    pallas_two_phase: bool = True
    # Iterative-refinement tail: phase 2 iterates on the correction
    # e = r - r_ref with TF32 matmuls around an f32 (Precision.HIGHEST)
    # anchor u_ref = W r_ref + I, re-anchored each check chunk. Same
    # fixed point and residual criterion as a loop of f32 matmuls.
    pallas_refine: bool = True
    # Phase-2 divergence-reopen margin (two-phase kernel only). Phase 2
    # reopens phase-1-diverged rows because a TF32 peak test near
    # rate_stop_at can falsely flag valid near-critical circuits (its
    # ~1e-3 relative matmul error is amplified ~n-fold through
    # f(u)=k*u^n — well under a per cent at the threshold, never 2x).
    # But reopening EVERY diverged row lets oscillatory true divergers
    # burn the remaining phase-2 budget on divergence-heavy batches. With
    # margin m > 0, rows whose phase-1 rates are pinned ABOVE
    # m*rate_stop_at stay flagged — unreachable by precision noise, so
    # the false-positive band [stop_at, m*stop_at) still gets its f32
    # retrial while hard divergers keep their flag. 0 = reopen all.
    pallas_reopen_margin: float = 0.0
    check_every: int = 1  # convergence-check stride (both backends)
    # Time stepper: "euler" (reference-faithful forward Euler,
    # r += (dt/tau)(-r + f(u))) or "expo" (exponential Euler,
    # r += (1-exp(-dt/tau))(-r + f(u)) — integrates the stiff leak term
    # exactly, so dt is no longer capped by tau_I; same fixed point, same
    # convergence criterion, typically ~4x fewer iterations at dt ~ tau_I).
    stepper: str = "euler"
    # Initial rates for fixed-point solves: "zero" (reference-faithful) or
    # "feedforward" (r0 = f(I_ext) — the no-recurrence estimate, much
    # closer to r* than zero, so the residual has less distance to decay).
    init: str = "zero"
    # Fixed-point acceleration (XLA backend): "none" or "anderson" —
    # Anderson(1) extrapolation applied once per check chunk on the
    # chunk map H = stepper^check_every, safeguarded (bounded mixing
    # coefficient, rate clamping, active-mask gating). Same fixed point
    # and residual criterion; fewer chunks on slow-converging circuits.
    accel: str = "none"

    def __post_init__(self):
        if self.io_type not in io_funs.IO_TYPES:
            raise ValueError(f"io_type must be one of {io_funs.IO_TYPES}")
        # init/accel are compared by string downstream; a typo would
        # silently fall back to zero-init / plain iteration
        if self.init not in ("zero", "feedforward"):
            raise ValueError("init must be 'zero' or 'feedforward'; "
                             f"got {self.init!r}")
        if self.accel not in ("none", "anderson"):
            raise ValueError("accel must be 'none' or 'anderson'; "
                             f"got {self.accel!r}")
        # asym_tanh saturates over the (soft, hard) band: a zero-width
        # band divides by zero in both the JAX and C implementations
        # (NaN rates that burn max_iter with flag 0)
        if (self.io_type == "asym_tanh"
                and not self.rate_hard_bound > self.rate_soft_bound):
            raise ValueError(
                "asym_tanh requires rate_hard_bound > rate_soft_bound; "
                f"got soft={self.rate_soft_bound}, "
                f"hard={self.rate_hard_bound}")

    @property
    def num_neurons(self) -> int:
        return 2 * self.N

    def io_fun(self):
        return io_funs.make_io_fun(
            self.io_type, self.k, self.n, self.rate_soft_bound, self.rate_hard_bound
        )

    def io_deriv(self):
        return io_funs.make_io_deriv(
            self.io_type, self.k, self.n, self.rate_soft_bound, self.rate_hard_bound
        )

    def tau_vector(self, dtype=jnp.float32) -> jnp.ndarray:
        """(2N,) per-neuron time constants."""
        return jnp.concatenate(
            [
                jnp.full((self.N,), self.tau_E, dtype=dtype),
                jnp.full((self.N,), self.tau_I, dtype=dtype),
            ]
        )

    def step_gain(self, dtype=jnp.float32) -> jnp.ndarray:
        """(2N,) per-neuron update gain alpha: r += alpha * (-r + f(u)).

        "euler": alpha = dt/tau (the reference's integrator).
        "expo":  alpha = 1 - exp(-dt/tau) (exponential Euler; exact for the
        leak, unconditionally stable in the stiff direction).
        """
        ratio = self.dt / self.tau_vector(dtype=dtype)
        if self.stepper == "euler":
            return ratio
        if self.stepper == "expo":
            return 1.0 - jnp.exp(-ratio)
        raise ValueError(f"unknown stepper {self.stepper!r}")

    def site_pos(self, dtype=jnp.float32) -> jnp.ndarray:
        from tcgan_tpu.ops.weights import site_positions

        return site_positions(self.N, self.L, dtype=dtype)


def recurrent_drive(W: jnp.ndarray, r: jnp.ndarray, I_ext: jnp.ndarray) -> jnp.ndarray:
    """u = r @ W^T + I_ext with r: (..., S, 2N), W: (..., 2N, 2N).

    Precision.HIGHEST is load-bearing: it asks for full f32 (IEEE on an
    NVIDIA GPU) instead of a reduced-precision default (TF32 on the GPU's
    tensor cores, 10 mantissa bits), whose rounding floors the Euler
    residual near 1e-3-relative, so a tight atol would not converge.
    With HIGHEST the solve matches the f64 CPU solver's iteration counts
    (tests/test_native.py).
    """
    import jax

    return jnp.einsum("...ij,...sj->...si", W, r,
                      precision=jax.lax.Precision.HIGHEST) + I_ext


