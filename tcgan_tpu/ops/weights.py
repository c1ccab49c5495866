"""Batched SSN weight-matrix builder with Dale's-law rectification.

Reference parity: ``tc_gan/gradient_expressions/make_w_batch.py`` (SURVEY.md
§2 "Weight-matrix builder"). The math (from the paper, Arakaki/Barello/
Ahmadian PLoS CB 2019):

The network has two populations (E, I), each with N sites at preferred
positions x_1..x_N on a uniform grid over [-0.5, 0.5]. The full 2N-neuron
weight matrix is built from 2x2 block parameters J (mean synaptic strength),
D (disorder / heterogeneity), S (Gaussian spatial range), each indexed
[post, pre] with populations ordered (E, I):

    W_ij = sign(pre_j) * relu(J_ab + D_ab * z_ij) * exp(-d(x_i,x_j)^2 / (2 S_ab^2))

where a/b are the post/pre populations of neurons i/j, z_ij ~ N(0,1) is the
per-connection quenched noise sampled by the generator, and sign is +1 for
excitatory presynaptic neurons and -1 for inhibitory ones (Dale's law via
rectification of the noised strength, then column sign).

Everything is pure jnp and differentiable w.r.t. (J, D, S) so GAN gradients
flow to the circuit parameters — this is the role the reference needed Theano
for.

The builder produces a dense (..., 2N, 2N) matrix in one shot from
broadcasted (2N, 2N) block masks — no Python loops over blocks; XLA fuses the
whole thing into a couple of elementwise kernels.
"""

from __future__ import annotations

import jax.numpy as jnp


def site_positions(N: int, L: float = 1.0, dtype=jnp.float32) -> jnp.ndarray:
    """Uniform grid of N preferred positions spanning ``[-L/2, L/2]``."""
    return jnp.linspace(-L / 2.0, L / 2.0, N, dtype=dtype)


def block_matrices(J, D, S, N: int):
    """Expand 2x2 block params to full (2N, 2N) per-connection matrices.

    Index convention: block [a, b] = (post population a, pre population b),
    populations ordered (E, I); neuron order in the flat 2N vector is
    [E_1..E_N, I_1..I_N].
    """
    J = jnp.asarray(J)
    D = jnp.asarray(D)
    S = jnp.asarray(S)
    reps = (N, N)

    def expand(M):
        return jnp.block(
            [
                [jnp.broadcast_to(M[..., 0, 0, None, None], M.shape[:-2] + reps),
                 jnp.broadcast_to(M[..., 0, 1, None, None], M.shape[:-2] + reps)],
                [jnp.broadcast_to(M[..., 1, 0, None, None], M.shape[:-2] + reps),
                 jnp.broadcast_to(M[..., 1, 1, None, None], M.shape[:-2] + reps)],
            ]
        )

    return expand(J), expand(D), expand(S)


def presynaptic_sign(N: int, dtype=jnp.float32) -> jnp.ndarray:
    """Row vector of Dale signs over presynaptic index: +1 for E, -1 for I."""
    return jnp.concatenate(
        [jnp.ones((N,), dtype=dtype), -jnp.ones((N,), dtype=dtype)]
    )


def build_weight(J, D, S, z, x) -> jnp.ndarray:
    """Build batched Dale-constrained weight matrices.

    Args:
      J, D, S: (..., 2, 2) block parameters (mean, disorder, spatial range).
        All are expected positive; positivity is the caller's job (the
        generator parameterizes them in log/softplus space).
      z: (..., 2N, 2N) standard-normal quenched noise (one draw per circuit
        sample). Leading dims broadcast against J/D/S leading dims.
      x: (N,) site positions (shared by the E and I grids).

    Returns:
      W: (..., 2N, 2N) with W[i, j] = weight from presynaptic j onto
      postsynaptic i.
    """
    N = x.shape[0]
    Jf, Df, Sf = block_matrices(J, D, S, N)
    xx = jnp.concatenate([x, x])
    dist2 = (xx[:, None] - xx[None, :]) ** 2
    profile = jnp.exp(-dist2 / (2.0 * Sf**2))
    strength = jnp.maximum(Jf + Df * z, 0.0)
    return presynaptic_sign(N, dtype=strength.dtype) * strength * profile


def sample_z(key, batch_shape, N: int, dtype=jnp.float32) -> jnp.ndarray:
    """Sample the per-connection quenched noise z ~ N(0, 1)."""
    import jax

    shape = tuple(batch_shape) + (2 * N, 2 * N)
    return jax.random.normal(key, shape, dtype=dtype)
