"""Ensemble (multi-start) GAN fitting: K independent WGAN fits in ONE
jitted program via ``jax.vmap`` over the train state.

Why this exists: the SSN generator is tiny (12
parameters) and a single fit under-utilizes a chip at small batch. ``vmap``
over K member states batches every solver call and critic matmul K-fold —
one compiled program, no host loop over members — so multi-start fitting
(the standard defense against GAN seed variance and the identifiability
ridges documented in BASELINE.md) costs roughly one fit's wall-clock at
K-fold batch. The reference (one Theano process per fit, SURVEY.md §1 "no
scheduler") ran multi-start as shell-level job arrays.

Each member gets independent: generator start (optionally jittered in
log-parameter space), critic init, real-data minibatches, and z-noise
streams. Members share the static config.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.models import wgan as wgan_lib
from tcgan_tpu.models.wgan import TrainState, WGANConfig


def init_ensemble(
    cfg: WGANConfig,
    n_members: int,
    key: jax.Array,
    gen_init: Dict[str, jnp.ndarray] | None = None,
    start_jitter: float = 0.0,
    model=wgan_lib,
) -> TrainState:
    """TrainState with a leading member axis on every leaf.

    gen_init: shared starting point (unconstrained space); defaults to the
    config's params. start_jitter: stddev of log-space N(0, jitter^2) noise
    added per member (member 0 keeps the exact start). model: the model
    module supplying ``init_state`` (wgan or cwgan — same state contract).
    """
    k_members = jax.random.split(key, n_members)

    def init_one(k):
        kj, kc = jax.random.split(k)
        gp = gen_init if gen_init is not None else gen_lib.init_params(cfg.gen)
        return model.init_state(cfg, key=kc,
                                gen_init=_jitter(kj, gp, start_jitter))

    states = jax.vmap(init_one)(k_members)
    return _reset_member0(cfg, states, gen_init, start_jitter)


def _jitter(key, gp, start_jitter):
    """Log-space N(0, jitter^2) noise on every parameter leaf."""
    if start_jitter <= 0.0:
        return gp
    leaves, treedef = jax.tree.flatten(gp)
    ks = jax.random.split(key, len(leaves))
    leaves = [p + start_jitter * jax.random.normal(kk, p.shape, p.dtype)
              for p, kk in zip(leaves, ks)]
    return jax.tree.unflatten(treedef, leaves)


def _reset_member0(cfg, states, gen_init, start_jitter):
    """Member 0 keeps the exact requested start — including its
    parameter-EMA buffer, which init_state seeds FROM the jittered
    params (a stale jittered EMA would bias member 0's reported EMA
    estimate for ~1/(1-decay) steps)."""
    if start_jitter <= 0.0:
        return states
    base = gen_init if gen_init is not None else gen_lib.init_params(cfg.gen)
    set0 = lambda stacked, b: stacked.at[0].set(b)
    states = states._replace(
        gen_params=jax.tree.map(set0, states.gen_params, base))
    if getattr(states, "ema_params", None) is not None:
        states = states._replace(
            ema_params=jax.tree.map(set0, states.ema_params, base))
    return states


def make_ensemble_step_impl(impl):
    """Member-vmapped version of a ``train_step_impl`` with the standard
    ``(cfg, n_critic, state, real_stack, key)`` signature (wgan/cwgan)."""

    def ensemble_impl(cfg, n_critic, states, real_stacks, keys):
        return jax.vmap(impl, in_axes=(None, None, 0, 0, 0))(
            cfg, n_critic, states, real_stacks, keys)

    return ensemble_impl


ensemble_train_step_impl = make_ensemble_step_impl(wgan_lib.train_step_impl)

ensemble_train_step = jax.jit(
    ensemble_train_step_impl, static_argnames=("cfg", "n_critic")
)


def init_mm_ensemble(
    cfg,
    n_members: int,
    key: jax.Array,
    gen_init: Dict[str, jnp.ndarray] | None = None,
    start_jitter: float = 0.0,
):
    """Multi-start MOMENT-MATCHING ensemble state (MMState with a member
    axis on every leaf, including the moment-EMA buffers). Same jitter
    semantics as :func:`init_ensemble` (member 0 keeps the exact start).

    Why: moment matching with moment-EMA is the estimator that actually
    recovered the near-critical battery's parameters (BASELINE.md mm13fix),
    so its seed-to-seed spread vs the identifiability spectrum is the
    multi-start analysis one wants (VERDICT r2 #9)."""
    from tcgan_tpu.models import moments as mm_lib

    k_members = jax.random.split(key, n_members)

    def init_one(k):
        kj, kz = jax.random.split(k)
        gp = gen_init if gen_init is not None else gen_lib.init_params(cfg.gen)
        # per-member z_key: each member's fixed_z CRN set must be
        # independent, or the z-set's Monte-Carlo error becomes a shared
        # bias invisible to the member-to-member spread
        return mm_lib.init_state(cfg, gen_init=_jitter(kj, gp, start_jitter),
                                 z_key=kz)

    states = jax.vmap(init_one)(k_members)
    return _reset_member0(cfg, states, gen_init, start_jitter)


def make_mm_ensemble_step_impl(impl=None, per_member_data=False):
    """Member-vmapped moment-matching ``train_step_impl``
    (``(cfg, state, data_mean, data_second, key)`` signature). By default
    the data moments are shared across members (spread = estimator-
    internal noise); with ``per_member_data`` the moments carry a leading
    member axis — one independent dataset per member, so the spread is
    CRLB-comparable (run.ensemble --data-seed-per-member)."""
    if impl is None:
        from tcgan_tpu.models import moments as mm_lib

        impl = mm_lib.train_step_impl

    data_ax = 0 if per_member_data else None

    def ensemble_impl(cfg, states, data_mean, data_second, keys):
        return jax.vmap(impl, in_axes=(None, 0, data_ax, data_ax, 0))(
            cfg, states, data_mean, data_second, keys)

    return ensemble_impl


def member_params(cfg: WGANConfig, states: TrainState, member: int):
    """Positive-space (J, D, S) of one member (host NumPy)."""
    import numpy as np

    host = jax.tree.map(lambda a: np.asarray(a[member]), states.gen_params)
    return gen_lib.param_values_np(cfg.gen, host)


def ensemble_summary(cfg: WGANConfig, states: TrainState,
                     true_params: Dict | None = None) -> Dict:
    """Across-member parameter statistics (+ per-member recovery errors
    when truth is known) — the multi-start consistency check."""
    import numpy as np

    from tcgan_tpu.analysis.metrics import param_recovery_error

    K = int(jax.tree.leaves(states.gen_params)[0].shape[0])
    members = []
    for m in range(K):
        J, D, S = member_params(cfg, states, m)
        row = {"J": np.asarray(J).tolist(), "D": np.asarray(D).tolist(),
               "S": np.asarray(S).tolist()}
        if true_params is not None:
            row["recovery_error"] = param_recovery_error(
                {"J": J, "D": D, "S": S}, true_params)
        members.append(row)
    stack = {k: np.asarray([m[k] for m in members]) for k in ("J", "D", "S")}
    return {
        "n_members": K,
        "members": members,
        "mean": {k: v.mean(axis=0).tolist() for k, v in stack.items()},
        "std": {k: v.std(axis=0).tolist() for k, v in stack.items()},
    }
