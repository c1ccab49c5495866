"""Bandwidth x contrast stimulus battery for tuning-curve sweeps.

Reference parity: the ``BandwidthContrastStimulator`` inside
``tc_gan/networks/ssn.py`` (SURVEY.md §2 "Stimulator"). Math from the paper:
the visual stimulus is a bar of width (bandwidth) b centered on the grid,
presented at contrast c; the feedforward input to a neuron with preferred
position x is a smoothed boxcar

    I(x; b, c) = c * sigmoid((b/2 - |x|) / smoothness)

applied identically to the E and I neurons at each site.

The battery enumerates the full bandwidth x contrast grid once (static
shapes; the stimulus dimension is folded into the solver's matmul M-axis,
which is what makes the batched solve one matmul per step).
"""

from __future__ import annotations

import jax.numpy as jnp


def _sigmoid(y):
    return 0.5 * (jnp.tanh(y / 2.0) + 1.0)


def smooth_box(x, bandwidth, smoothness):
    """Smoothed boxcar of width ``bandwidth`` centered at 0, evaluated at x."""
    return _sigmoid((bandwidth / 2.0 - jnp.abs(x)) / smoothness)


def stimulus_battery(bandwidths, contrasts, x, smoothness) -> jnp.ndarray:
    """Build the full stimulus battery.

    Args:
      bandwidths: (n_b,) bar widths (same units as x).
      contrasts: (n_c,) contrast levels.
      x: (N,) site positions.
      smoothness: edge-smoothing length scale.

    Returns:
      I_ext: (n_b * n_c, 2N) external input, one row per stimulus condition,
      ordered contrast-major then bandwidth (condition index
      ``s = ic * n_b + ib``), duplicated over the E and I halves.
    """
    bandwidths = jnp.asarray(bandwidths, dtype=x.dtype)
    contrasts = jnp.asarray(contrasts, dtype=x.dtype)
    box = smooth_box(x[None, :], bandwidths[:, None], smoothness)  # (n_b, N)
    per_cond = contrasts[:, None, None] * box[None, :, :]  # (n_c, n_b, N)
    flat = per_cond.reshape(-1, x.shape[0])  # (n_c*n_b, N)
    return jnp.concatenate([flat, flat], axis=-1)  # (S, 2N)


def condition_features(bandwidths, contrasts, dtype=jnp.float32) -> jnp.ndarray:
    """Per-condition (bandwidth, contrast) feature rows, matching the battery
    ordering — used by the conditional WGAN to tag samples with their
    stimulus condition."""
    bandwidths = jnp.asarray(bandwidths, dtype=dtype)
    contrasts = jnp.asarray(contrasts, dtype=dtype)
    bb = jnp.tile(bandwidths, contrasts.shape[0])
    cc = jnp.repeat(contrasts, bandwidths.shape[0])
    return jnp.stack([bb, cc], axis=-1)  # (S, 2)
