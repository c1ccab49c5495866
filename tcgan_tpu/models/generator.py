"""SSN tuning-curve generator.

The WGAN "generator" is not a neural net: it is the circuit parameter set
theta = (J, D, S) (2x2 blocks each) plus per-connection noise z. A forward
pass samples z ~ N(0,1)^{B x 2N x 2N}, builds Dale-constrained weight
matrices, solves the SSN fixed point under the full bandwidth x contrast
stimulus battery, and reads out tuning curves at probe neurons.

Reference parity: generator assembly inside ``tc_gan/networks/bptt_gan.py``
/ ``tc_gan/networks/ssn.py`` (SURVEY.md §3.3), including:

- log-space parameterization of (J, D, S) for positivity (SURVEY.md §7 hard
  part #5);
- ``sample_sites`` probe readout (E cells; optionally I cells via
  ``include_inhibitory_neurons``);
- ``track_offset_identity``: keep probe sites as one concatenated vector
  (True) vs. treat each site as an independent tuning-curve sample (False);
- solver choice: implicit-diff fixed point (configs C2/C4/C5) or unrolled
  BPTT scan (config C3).

Everything here is one traced graph — z sampling, W build, the while-loop
solve, and the probe gather all fuse under jit; the batch dim shards over
the device mesh (tcgan_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tcgan_tpu.ops import euler, ift, stimulus, weights
from tcgan_tpu.ops.ssn import (
    DEFAULT_BANDWIDTHS,
    DEFAULT_CONTRASTS,
    DEFAULT_D,
    DEFAULT_J,
    DEFAULT_S,
    SSNConfig,
)


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Static generator configuration (jit-hashable)."""

    ssn: SSNConfig = SSNConfig()
    bandwidths: Tuple[float, ...] = DEFAULT_BANDWIDTHS
    contrasts: Tuple[float, ...] = DEFAULT_CONTRASTS
    sample_sites: int = 1
    track_offset_identity: bool = False
    include_inhibitory_neurons: bool = False
    solver: str = "ift"  # "ift" (fixed point + implicit grad) | "bptt"
    grad_method: str = "iterative"  # backward solve for the ift path
    bptt_checkpoint_chunk: int = 0  # 0 = no remat
    param_space: str = "log"  # "log" | "raw"
    dtype: Any = jnp.float32
    # Mesh sharding constraints (tcgan_tpu.parallel): names of mesh axes to
    # shard the circuit-sample batch (data parallel) and the 2N neuron axis
    # of W (tensor parallel, large-N), or None for unconstrained.
    mesh_axis: str | None = None
    model_axis: str | None = None
    # Antithetic quenched noise: sample batch/2 z-draws and use (+z, -z)
    # pairs — the pair-mean of any odd-in-z statistic vanishes exactly, so
    # generator-gradient variance drops without extra solver cost.
    antithetic: bool = False

    @property
    def n_stim(self) -> int:
        return len(self.bandwidths) * len(self.contrasts)

    @property
    def n_probe(self) -> int:
        return self.sample_sites * (2 if self.include_inhibitory_neurons else 1)

    @property
    def tc_dim(self) -> int:
        """Length of one tuning-curve sample vector as seen by the critic."""
        if self.track_offset_identity:
            return self.n_stim * self.n_probe
        return self.n_stim

    def samples_per_circuit(self) -> int:
        """How many critic samples one sampled circuit yields."""
        return 1 if self.track_offset_identity else self.n_probe

    def probe_indices(self) -> jnp.ndarray:
        """Neuron indices read out as tuning curves: ``sample_sites``
        consecutive sites starting at the grid center (E population; I
        population at the same sites appended when
        ``include_inhibitory_neurons``)."""
        N = self.ssn.N
        base = N // 2 + jnp.arange(self.sample_sites)
        if self.include_inhibitory_neurons:
            return jnp.concatenate([base, base + N])
        return base

    def stimulus_battery(self) -> jnp.ndarray:
        x = self.ssn.site_pos(dtype=self.dtype)
        return stimulus.stimulus_battery(
            self.bandwidths, self.contrasts, x, self.ssn.smoothness
        )

    def condition_features(self) -> jnp.ndarray:
        return stimulus.condition_features(
            self.bandwidths, self.contrasts, dtype=self.dtype
        )


def init_params(
    cfg: GeneratorConfig,
    J=DEFAULT_J,
    D=DEFAULT_D,
    S=DEFAULT_S,
) -> Dict[str, jnp.ndarray]:
    """Initial generator parameters in the unconstrained optimization space."""
    J = jnp.asarray(J, dtype=cfg.dtype)
    D = jnp.asarray(D, dtype=cfg.dtype)
    S = jnp.asarray(S, dtype=cfg.dtype)
    if cfg.param_space == "log":
        return {"J": jnp.log(J), "D": jnp.log(D), "S": jnp.log(S)}
    return {"J": J, "D": D, "S": S}


def param_values(cfg: GeneratorConfig, params: Dict[str, jnp.ndarray]):
    """Map unconstrained params to the positive circuit values (J, D, S)."""
    if cfg.param_space == "log":
        return (
            jnp.exp(params["J"]),
            jnp.exp(params["D"]),
            jnp.exp(params["S"]),
        )
    return params["J"], params["D"], params["S"]


def param_values_np(cfg: GeneratorConfig, host_params):
    """Host-NumPy twin of :func:`param_values` — for recorder paths that
    must not dispatch device ops (one host sync per step; see
    train/driver.py)."""
    import numpy as np

    if cfg.param_space == "log":
        return tuple(np.exp(np.asarray(host_params[k]))
                     for k in ("J", "D", "S"))
    return tuple(np.asarray(host_params[k]) for k in ("J", "D", "S"))


class GeneratorOutput(NamedTuple):
    """Forward-pass output.

    tc:        critic-ready tuning-curve samples,
               (B, n_stim * n_probe) when track_offset_identity else
               (B * n_probe, n_stim).
    rates:     (B, S, 2N) full converged rates (for penalties/analysis).
    converged: (B, S) bool; diverged: (B, S) bool; iters: (B, S) int32.
    """

    tc: jnp.ndarray
    rates: jnp.ndarray
    converged: jnp.ndarray
    diverged: jnp.ndarray
    iters: jnp.ndarray


def sample_tuning_curves(
    cfg: GeneratorConfig,
    params: Dict[str, jnp.ndarray],
    key: jax.Array,
    batch: int,
) -> GeneratorOutput:
    """Sample ``batch`` circuits and return their tuning curves.

    Differentiable w.r.t. ``params`` through the chosen solver path.
    """
    J, D, S = param_values(cfg, params)
    x = cfg.ssn.site_pos(dtype=cfg.dtype)
    if cfg.antithetic:
        if batch % 2:
            raise ValueError("antithetic sampling needs an even batch")
        z_half = weights.sample_z(key, (batch // 2,), cfg.ssn.N,
                                  dtype=cfg.dtype)
        z = jnp.concatenate([z_half, -z_half], axis=0)
    else:
        z = weights.sample_z(key, (batch,), cfg.ssn.N, dtype=cfg.dtype)
    if cfg.mesh_axis or cfg.model_axis:
        # Steer jit's auto-partitioning: batch axis -> data-parallel shards,
        # optional 2N axis -> tensor-parallel shards.
        from jax.sharding import PartitionSpec as P

        z = jax.lax.with_sharding_constraint(
            z, P(cfg.mesh_axis, None, cfg.model_axis)
        )
    W = weights.build_weight(J, D, S, z, x)
    I_ext = cfg.stimulus_battery()

    if cfg.solver == "ift":
        res = ift.solve_fixed_point_implicit(
            cfg.ssn, W, I_ext, grad_method=cfg.grad_method
        )
    elif cfg.solver == "bptt":
        res = euler.solve_dynamics(
            cfg.ssn,
            W,
            I_ext,
            checkpoint_chunk=cfg.bptt_checkpoint_chunk or None,
        )
    else:
        raise ValueError(f"unknown solver {cfg.solver!r}")

    probes = cfg.probe_indices()
    tc = res.r[..., probes]  # (B, S, P)
    if cfg.track_offset_identity:
        tc = tc.reshape(batch, -1)  # (B, S*P)
    else:
        tc = jnp.swapaxes(tc, -1, -2).reshape(batch * cfg.n_probe, cfg.n_stim)
    return GeneratorOutput(tc, res.r, res.converged, res.diverged, res.iters)


def rate_penalty(cfg: GeneratorConfig, rates: jnp.ndarray) -> jnp.ndarray:
    """Soft penalty on rates above the soft bound — the reference's BPTT
    "rate cost" that discourages circuits from drifting toward divergence
    (SURVEY.md §5.3). Quadratic above ``rate_soft_bound``, zero below."""
    excess = jnp.maximum(rates - cfg.ssn.rate_soft_bound, 0.0)
    return jnp.mean(excess**2) / cfg.ssn.rate_soft_bound**2
