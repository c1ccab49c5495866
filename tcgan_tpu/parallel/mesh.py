"""Device-mesh construction and sharded train-step factories.

Parallelism layout ([BASELINE] config C5; SURVEY.md §2 parallelism census):

- **Sample/data parallel (primary)**: the generator's circuit-sample batch
  axis shards over the ``"batch"`` mesh axis. Every sampled circuit's SSN
  solve is independent, so the only collectives are the loss/grad psums jit
  inserts for the shared (replicated) generator/critic parameters (NCCL
  all-reduces over NVLink between GPUs).
- **Tensor parallel (optional, large-N)**: the 2N neuron axis of W shards
  over the ``"model"`` mesh axis; the solver's ``r @ W^T`` contraction then
  reduce-scatters. Enabled by giving the mesh a model axis of size > 1.

The GPUs of one host are joined all to all, so the mesh shape follows the
algorithm alone (no torus to match).

Implementation style: jit automatic partitioning steered by sharding
constraints on the quenched noise z (batch axis) and W (model axis) inside
the generator (see ``GeneratorConfig.mesh_axis`` / ``model_axis``), plus
input shardings on the real-data stack. This follows the scaling-book
recipe: pick a mesh, annotate, let XLA insert collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def make_mesh(
    n_batch: Optional[int] = None,
    n_model: int = 1,
    devices=None,
) -> Mesh:
    """Build a (batch [, model]) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_batch is None:
        if len(devices) % n_model:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_model="
                f"{n_model} — a silent floor would idle "
                f"{len(devices) % n_model} chip(s)")
        n_batch = len(devices) // n_model
    if n_batch < 1 or n_batch * n_model > len(devices):
        raise ValueError(
            f"mesh {n_batch}x{n_model} needs {n_batch * n_model} devices, "
            f"have {len(devices)}")
    use = np.array(devices[: n_batch * n_model]).reshape(n_batch, n_model)
    return Mesh(use, (BATCH_AXIS, MODEL_AXIS))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def make_sharded_gan_step(impl, mesh: Mesh):
    """Shard a WGAN/cWGAN ``train_step_impl`` over ``mesh``.

    Signature preserved: ``(cfg, n_critic, state, real_stack, key)``. The
    model/optimizer state and RNG key are replicated; the real-data stack
    (n_critic, batch, dim) shards its batch axis. The generator's internal
    batch sharding comes from the ``mesh_axis`` constraint in
    ``GeneratorConfig`` — pass a cfg with ``mesh_axis=BATCH_AXIS``.
    """
    repl = _replicated(mesh)
    data_sh = NamedSharding(mesh, P(None, BATCH_AXIS))

    def wrapped(cfg, n_critic, state, real_stack, key):
        # Constrain the data batch INSIDE the jitted program instead of via
        # in_shardings: the CLI sampler materializes the stack under the
        # run's jax.set_mesh context, so it arrives as a COMMITTED
        # replicated array, and jit refuses to silently reshard committed
        # args to a mismatched in_sharding. with_sharding_constraint is a
        # resharding, so it accepts any incoming layout.
        real_stack = jax.lax.with_sharding_constraint(real_stack, data_sh)
        return impl(cfg, n_critic, state, real_stack, key)

    return jax.jit(
        wrapped,
        static_argnames=("cfg", "n_critic"),
        out_shardings=(repl, repl),
    )


def make_sharded_mm_step(impl, mesh: Mesh):
    """Shard a moment-matching ``train_step_impl`` over ``mesh``.

    All inputs are replicated (data moments are small dense vectors); the
    sample-parallel work comes from the generator's internal batch
    constraint (``mesh_axis``)."""
    repl = _replicated(mesh)
    return jax.jit(
        impl,
        static_argnames=("cfg",),
        in_shardings=(repl, repl, repl, repl),
        out_shardings=(repl, repl),
    )


def make_sharded_ensemble_step(impl, mesh: Mesh):
    """Shard an ensemble ``ensemble_train_step_impl`` over ``mesh``: the
    MEMBER axis (leading on every state/data/key leaf) shards over the
    batch mesh axis — K independent fits spread across chips, zero
    cross-member collectives (the embarrassingly-parallel layout;
    parameters are per-member, so nothing is replicated but the config).

    The member count must be divisible by the batch-axis size.
    """

    def member_shard(a):
        spec = P(BATCH_AXIS, *([None] * (a.ndim - 1)))
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))

    def wrapped(cfg, n_critic, states, real_stacks, keys):
        states = jax.tree.map(member_shard, states)
        real_stacks = member_shard(real_stacks)
        keys = member_shard(keys)
        new_states, metrics = impl(cfg, n_critic, states, real_stacks, keys)
        new_states = jax.tree.map(member_shard, new_states)
        return new_states, metrics

    return jax.jit(wrapped, static_argnames=("cfg", "n_critic"))


def with_mesh_axes(gen_cfg, batch: bool = True, model: bool = False):
    """Return a copy of a GeneratorConfig with mesh sharding constraints
    enabled (used by gan_common's --parallel mesh wiring)."""
    return dataclasses.replace(
        gen_cfg,
        mesh_axis=BATCH_AXIS if batch else None,
        model_axis=MODEL_AXIS if model else None,
    )
