"""Implicit-function-theorem gradients through the SSN fixed point.

Reference parity: ``tc_gan/gradient_expressions/SS_grad.py`` (SURVEY.md §2
"Fixed-point gradient expressions", §3.2). The reference assembled the IFT
linear system symbolically in Theano; here it is a ``jax.custom_vjp`` around
the while-loop solver, so ``jax.grad`` of any function of the fixed point
"just works" — including through the weight builder to (J, D, S).

Math. The fixed point satisfies r* = F(r*, W, I) with
F(r, W, I) = f(W r + I).  For a downstream cotangent ḡ = ∂L/∂r*, the IFT
gives

    λ solves   (I - ∂F/∂r)^T λ = ḡ,
    W̄ = (∂F/∂W)^T λ,   Ī = (∂F/∂I)^T λ,

with ∂F/∂r = diag(f'(u*)) W at u* = W r* + I.  Three backward linear-solve
methods are provided (flag ``grad_method``, mirroring the reference's choice
of exact implicit gradients plus the modern cheap approximations from
PAPERS.md):

- ``"iterative"`` (default): damped fixed-point/Richardson iteration of the
  adjoint system, λ <- λ + (dt/tau)(-λ + (∂F/∂r)^T λ + ḡ).  Converges under
  the same spectral condition that makes the forward Euler dynamics stable
  (the adjoint matrix is the transpose, same spectrum), costs one matvec per
  step, and needs O(1) memory.  Identical compute shape to the forward
  solve, so it reuses the same batched matmul layout.
- ``"direct"``: batched dense solve of (I - diag(f'(u*)) W)^T λ = ḡ via
  ``jnp.linalg.solve``.  Exact; O(S · (2N)^3) and O(S · (2N)^2) memory per
  sample — for small/medium N and for testing the iterative path.
- ``"jfb"``: Jacobian-free backprop (λ = ḡ; one-step approximation, see
  PAPERS.md "JFB: Jacobian-Free Backpropagation for Implicit Networks").

Divergence safety (SURVEY.md §7 hard part #1): cotangents of samples whose
forward solve diverged or failed to converge are zeroed inside the backward
pass (mask on ḡ and on the iteration), so a few bad samples cannot
NaN-poison the batch gradient.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from tcgan_tpu.ops.fixed_point import FixedPointResult, solve_any
from tcgan_tpu.ops.ssn import SSNConfig, recurrent_drive

GRAD_METHODS = ("iterative", "direct", "jfb")


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def fixed_point_rates(
    cfg: SSNConfig,
    grad_method: str,
    bwd_max_iter: int,
    bwd_atol: float,
    W: jnp.ndarray,
    I_ext: jnp.ndarray,
) -> FixedPointResult:
    """Differentiable fixed-point solve.

    Returns the full FixedPointResult; gradients flow through ``.r`` only
    (flags/iters are integer/bool diagnostics).
    """
    return solve_any(cfg, W, I_ext)


def _fwd(cfg, grad_method, bwd_max_iter, bwd_atol, W, I_ext):
    res = solve_any(cfg, W, I_ext)
    return res, (W, I_ext, res.r, res.converged)


def _bwd(cfg, grad_method, bwd_max_iter, bwd_atol, residuals, cot):
    W, I_ext, r_star, converged = residuals
    g = cot.r  # cotangent w.r.t. rates; flags carry no gradient
    fprime = cfg.io_deriv()
    u = recurrent_drive(W, r_star, I_ext)
    phi = fprime(u)  # (..., S, 2N)

    # Zero cotangents of unresolved/diverged samples — and zero their phi
    # too, so excluded samples are inert in EVERY adjoint method: the
    # direct method's linear system becomes the identity (a clipped
    # diverged sample's phi would otherwise make A singular/near-singular
    # and the LU solve emit inf/NaN, which `lam * ok` cannot remove since
    # NaN * 0 = NaN), and the iterative method's adjoint map becomes a
    # pure decay (an unstable excluded sample would otherwise blow up the
    # GLOBAL residual norm, either wasting the whole bwd_max_iter budget
    # or poisoning it with inf - inf = NaN, whose comparison exits the
    # loop with NaN lam for the entire batch).
    ok = converged[..., None].astype(g.dtype)
    # where, not multiply: a clipped/overflowed excluded sample can carry
    # NaN in g or phi already, and NaN * 0 = NaN
    g = jnp.where(ok > 0, g, jnp.zeros_like(g))
    phi = jnp.where(ok > 0, phi, jnp.zeros_like(phi))

    if grad_method == "jfb":
        lam = g
    elif grad_method == "direct":
        # A^T lam = g with A = I - diag(phi) W  (per batch x stimulus).
        n2 = W.shape[-1]
        eye = jnp.eye(n2, dtype=W.dtype)
        # A for stimulus s: eye - phi[..., s, :, None] * W  -> (..., S, 2N, 2N)
        A = eye - phi[..., :, None] * W[..., None, :, :]
        lam = jnp.linalg.solve(
            jnp.swapaxes(A, -1, -2), g[..., None]
        )[..., 0]
        # ok-masked phi made excluded rows' system the identity; the
        # where (not *) keeps any residual non-finite solve output from
        # leaking through (NaN * 0 = NaN).
        lam = jnp.where(ok > 0, lam, jnp.zeros_like(lam))
    elif grad_method == "iterative":
        # Damped Richardson on the adjoint: lam <- lam + a*(-lam + J^T lam + g)
        # with J^T lam = W^T (phi ⊙ lam); a = dt/tau (same damping as forward).
        dt_over_tau = cfg.step_gain(dtype=W.dtype)

        def jt(lam):
            return jnp.einsum("...ji,...sj->...si", W, phi * lam,
                              precision=jax.lax.Precision.HIGHEST)

        def cond(state):
            lam, delta_norm, it = state
            return (delta_norm >= bwd_atol) & (it < bwd_max_iter)

        def body(state):
            lam, _, it = state
            delta = -lam + jt(lam) + g
            lam_new = lam + dt_over_tau * delta
            return lam_new, jnp.max(jnp.abs(delta)), it + 1

        lam, _, _ = lax.while_loop(
            cond, body, (g, jnp.array(jnp.inf, W.dtype), jnp.array(0, jnp.int32))
        )
        # If a trusted sample's adjoint nonetheless fails to contract
        # within bwd_max_iter, lam is approximate (there is no backward
        # converged-flag channel); a non-finite lam is left in place so
        # the optimizer-level apply_if_finite guard skips the step
        # visibly rather than training on silently-zeroed gradients.
        lam = jnp.where(ok > 0, lam, jnp.zeros_like(lam))
    else:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")

    # Pull λ back through F(r, W, I) = f(W r + I) w.r.t. (W, I) at fixed r*.
    # d/dW: W̄_ij = sum_s phi_si * lam_si * r*_sj ; d/dI: Ī = phi ⊙ λ.
    # r* is where-masked too: an excluded sample can carry NaN rates, and
    # 0 * NaN = NaN would re-poison the einsum even with philam zeroed.
    philam = phi * lam
    r_ok = jnp.where(ok > 0, r_star, jnp.zeros_like(r_star))
    W_bar = jnp.einsum("...si,...sj->...ij", philam, r_ok,
                       precision=jax.lax.Precision.HIGHEST)
    I_bar = _unbroadcast(philam, I_ext.shape)
    W_bar = _unbroadcast(W_bar, W.shape)
    return W_bar, I_bar


def _unbroadcast(bar: jnp.ndarray, shape: tuple) -> jnp.ndarray:
    """Reduce a cotangent back to the primal's shape: sum over leading axes
    the primal lacked AND over axes where the primal had size 1 but
    broadcast to a larger size (e.g. I_ext (1, S, 2N) against W
    (B, 2N, 2N))."""
    if bar.shape == shape:
        return bar
    extra = bar.ndim - len(shape)
    if extra:
        bar = bar.sum(axis=tuple(range(extra)))
    keep = tuple(ax for ax, (b, p) in enumerate(zip(bar.shape, shape))
                 if b != p and p == 1)
    if keep:
        bar = bar.sum(axis=keep, keepdims=True)
    return bar


fixed_point_rates.defvjp(_fwd, _bwd)


def solve_fixed_point_implicit(
    cfg: SSNConfig,
    W: jnp.ndarray,
    I_ext: jnp.ndarray,
    grad_method: str = "iterative",
    bwd_max_iter: int = 20000,
    bwd_atol: float = 1e-6,
) -> FixedPointResult:
    """User-facing differentiable fixed-point solve (see module docstring)."""
    if grad_method not in GRAD_METHODS:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")
    return fixed_point_rates(cfg, grad_method, bwd_max_iter, bwd_atol, W, I_ext)
