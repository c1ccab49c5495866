"""Fixed-point solver: masked, batched `lax.while_loop` Euler iteration.

Reference parity: ``tc_gan/ssnode.py::find_fixed_points`` + the OpenMP C
solver in ``tc_gan/ext/`` (SURVEY.md §3.4). Semantics preserved:

- iterate ``r <- r + (dt/tau) * (-r + f(W r + I))`` until the residual
  ``max_i |-r_i + f(u_i)| < atol`` (converged), any rate exceeds
  ``rate_stop_at`` (diverged), or ``max_iter`` is hit (unconverged);
- per-sample convergence/divergence flags are first-class outputs — the GAN
  layer penalizes/rejects flagged samples (SURVEY.md §5.3).

Lockstep design: the whole batch runs one `lax.while_loop` on an "any
sample still active" predicate with masked updates (work-inefficient per
sample, but one batched matmul per substep; resolved samples are frozen
via `jnp.where` so their values don't drift). The residual check happens
every ``check_every`` iterations to keep the loop body a pure fused
matmul+elementwise block between checks.

This plain-XLA path is the semantic reference; the fused Pallas kernel in
``tcgan_tpu.ops.pallas`` implements the same contract and is cross-checked
against it (SURVEY.md §4's cross-implementation test pattern).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from tcgan_tpu.ops.ssn import SSNConfig, recurrent_drive


class FixedPointResult(NamedTuple):
    """Solver output.

    r:         (..., S, 2N) final rates (fixed point where ``converged``).
    converged: (..., S) bool — residual dropped below atol.
    diverged:  (..., S) bool — some rate exceeded rate_stop_at.
    iters:     (..., S) int32 — iterations consumed when the sample resolved
               (== max_iter for samples that never resolved).
    """

    r: jnp.ndarray
    converged: jnp.ndarray
    diverged: jnp.ndarray
    iters: jnp.ndarray


def solve_any(cfg: SSNConfig, W: jnp.ndarray, I_ext: jnp.ndarray
              ) -> FixedPointResult:
    """Backend-dispatching fixed-point solve (forward only).

    Uses the fused Pallas kernel when ``cfg.backend == "pallas"`` and the
    layout matches its contract (one batch dim, shared stimulus battery);
    otherwise the plain-XLA while_loop path. The kernel is compiled for
    the GPU and never interpreted here: off the GPU, or under a
    multi-device mesh (a ``pallas_call`` is opaque to automatic
    partitioning, so it would replicate the whole batch on every
    device), choosing it is an error.

    Dtype contract: the Pallas path computes and returns float32 rates
    regardless of input dtype; the XLA path preserves ``W.dtype``.
    Cross-backend f64 parity checks must therefore compare through the
    XLA or native solver, not the kernel.
    """
    if cfg.backend == "pallas" and W.ndim == 3 and I_ext.ndim == 2:
        from tcgan_tpu.ops.pallas import solve_fixed_point_pallas

        mesh = jax.sharding.get_abstract_mesh()
        if not mesh.empty and mesh.size > 1:
            raise ValueError(
                "the pallas solver backend does not run under a "
                f"{mesh.size}-device mesh (--parallel mesh): a pallas_call "
                "is opaque to automatic partitioning and would replicate "
                "the whole batch on every device; use the xla solver "
                "backend")
        return solve_fixed_point_pallas(
            cfg, W, I_ext,
            check_every=max(cfg.check_every, 1),
            two_phase=cfg.pallas_two_phase,
            refine=cfg.pallas_refine,
            accel=(cfg.accel == "anderson"),
        )
    return solve_fixed_point(cfg, W, I_ext,
                             check_every=max(cfg.check_every, 1))


def solve_fixed_point(
    cfg: SSNConfig,
    W: jnp.ndarray,
    I_ext: jnp.ndarray,
    r0: jnp.ndarray | None = None,
    check_every: int = 1,
) -> FixedPointResult:
    """Solve the SSN fixed point for a batch of circuits and stimuli.

    Args:
      cfg: static configuration (dt, tau, io, atol, max_iter, rate_stop_at).
      W: (..., 2N, 2N) weight matrices.
      I_ext: (..., S, 2N) external inputs (S stimulus conditions per circuit;
        broadcastable against W's leading dims).
      r0: optional initial rates, defaults to zeros.
      check_every: run the convergence/divergence reduction every k Euler
        steps (k > 1 trades a few extra iterations for fewer reductions).

    Returns:
      FixedPointResult. Not differentiable (while_loop); use
      :mod:`tcgan_tpu.ops.ift` for gradients through the solution.
    """
    f = cfg.io_fun()
    dtype = W.dtype
    lead = jnp.broadcast_shapes(W.shape[:-2], I_ext.shape[:-2])
    S = I_ext.shape[-2]
    n2 = W.shape[-1]
    I_ext = I_ext.astype(dtype)
    if r0 is None:
        if cfg.init == "feedforward":
            r0 = jnp.broadcast_to(f(I_ext), lead + (S, n2)).astype(dtype)
        else:
            r0 = jnp.zeros(lead + (S, n2), dtype=dtype)
    else:
        r0 = jnp.broadcast_to(r0, lead + (S, n2)).astype(dtype)

    dt_over_tau = cfg.step_gain(dtype=dtype)  # (2N,)
    # Hard ceiling well above the divergence-detection bound: the power-law
    # io makes runaway rates grow SUPER-exponentially, so an unchecked
    # check_every window can carry a sample from rate_stop_at to f32
    # overflow — inf rates then NaN-poison everything downstream (critic,
    # losses). Clipping above the detection ceiling preserves the diverged
    # flag semantics exactly (same clip the BPTT path applies).
    r_ceiling = jnp.asarray(10.0 * cfg.rate_stop_at, dtype)

    def substeps(r):
        def one(i, r):
            u = recurrent_drive(W, r, I_ext)
            delta = -r + f(u)
            return jnp.minimum(r + dt_over_tau * delta, r_ceiling)
        r = lax.fori_loop(0, check_every - 1, one, r) if check_every > 1 else r
        u = recurrent_drive(W, r, I_ext)
        delta = -r + f(u)
        return jnp.minimum(r + dt_over_tau * delta, r_ceiling), delta

    anderson = cfg.accel == "anderson"

    class _State(NamedTuple):
        r: jnp.ndarray
        converged: jnp.ndarray
        diverged: jnp.ndarray
        iters: jnp.ndarray
        it: jnp.ndarray
        # Anderson(1) chunk history (zeros-sized placeholders when off)
        r_in_prev: jnp.ndarray
        f_prev: jnp.ndarray  # previous chunk displacement H(r) - r

    def cond(s: _State):
        active = ~(s.converged | s.diverged)
        return jnp.any(active) & (s.it < cfg.max_iter)

    def body(s: _State):
        r_new, delta = substeps(s.r)
        err = jnp.max(jnp.abs(delta), axis=-1)  # (..., S)
        peak = jnp.max(r_new, axis=-1)
        active = ~(s.converged | s.diverged)
        it_next = s.it + check_every
        newly_div = active & (peak > cfg.rate_stop_at)
        newly_conv = active & ~newly_div & (err < cfg.atol)
        resolved_now = newly_div | newly_conv
        r_next = r_new
        f_cur = r_new - s.r  # chunk displacement F = H(r) - r
        if anderson:
            # Anderson(1) on the chunk map H: extrapolate along the secant
            # of the displacement, gamma = <F, F - F_prev> / ||F - F_prev||^2,
            # r_aa = H(r) - gamma * (H(r) - H(r_prev)). Safeguards: history
            # must exist (it > 0), |gamma| bounded, still-active samples
            # only, result clamped to [0, r_ceiling]. The residual/flags
            # above use the PLAIN chunk — the accepted fixed point and its
            # criterion are unchanged.
            dF = f_cur - s.f_prev
            denom = jnp.sum(dF * dF, axis=-1, keepdims=True)
            gamma = jnp.sum(f_cur * dF, axis=-1, keepdims=True) / (
                denom + 1e-30)
            h_prev = s.r_in_prev + s.f_prev  # H(r_prev)
            r_aa = r_new - gamma * (r_new - h_prev)
            r_aa = jnp.clip(r_aa, 0.0, r_ceiling)
            # Skip the extrapolation when it would overshoot past the
            # divergence ceiling: the NEXT chunk's peak > rate_stop_at test
            # must keep its plain-iteration semantics, so a near-critical
            # convergent sample is never falsely flagged by an AA overshoot.
            ok = ((s.it > 0)
                  & (jnp.abs(gamma[..., 0]) < 2.0)
                  & (denom[..., 0] > 0.0)
                  & (jnp.max(r_aa, axis=-1) <= cfg.rate_stop_at)
                  & active & ~resolved_now)
            r_next = jnp.where(ok[..., None], r_aa, r_new)
        return _State(
            r=jnp.where(active[..., None], r_next, s.r),
            converged=s.converged | newly_conv,
            diverged=s.diverged | newly_div,
            # clamp: the final chunk may overshoot max_iter by up to
            # check_every-1 substeps; recorded iters must never exceed
            # the budget or "iters == max_iter" stops meaning unresolved
            iters=jnp.where(resolved_now,
                            jnp.minimum(it_next, cfg.max_iter), s.iters),
            it=it_next,
            r_in_prev=s.r if anderson else s.r_in_prev,
            f_prev=f_cur if anderson else s.f_prev,
        )

    hist0 = (jnp.zeros_like(r0) if anderson
             else jnp.zeros((0,) * r0.ndim, dtype=dtype))
    init = _State(
        r=r0,
        converged=jnp.zeros(lead + (S,), dtype=bool),
        diverged=jnp.zeros(lead + (S,), dtype=bool),
        iters=jnp.full(lead + (S,), cfg.max_iter, dtype=jnp.int32),
        it=jnp.zeros((), dtype=jnp.int32),
        r_in_prev=hist0,
        f_prev=hist0,
    )
    out = lax.while_loop(cond, body, init)
    return FixedPointResult(out.r, out.converged, out.diverged, out.iters)
