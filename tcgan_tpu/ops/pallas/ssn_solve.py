"""Fused SSN fixed-point solver as a Pallas GPU kernel (Triton route).

Why a kernel: the plain-XLA while-loop solver runs the whole batch in
lockstep until its LAST sample resolves, with at least one batched matmul
launch per Euler substep, re-reading every circuit's (2N x 2N) weight
matrix from device memory each time. This kernel:

- runs ONE circuit per program (grid over the batch); the circuit's W^T
  is loaded once and stays on chip (shared memory / registers) for all
  Euler iterations — at N=51 it pads to 128 x 128 f32 = 64 KB, well
  inside a block's 227 KB of shared memory;
- runs its own `lax.while_loop`, so a program whose stimulus rows all
  converge or diverge STOPS (per-circuit early exit, like the reference C
  solver's per-sample exit, which lockstep XLA cannot express);
- fuses the io nonlinearity, the Euler update, the convergence residual
  and the divergence ceiling around the matmul, with no intermediate
  round-trips to device memory.

Semantics follow :func:`tcgan_tpu.ops.fixed_point.solve_fixed_point`
(same residual criterion, same flags; cross-checked by
tests/test_pallas_solver.py and on the card by chip_smoke.py).

Reference parity: tc_gan/ext/ (OpenMP C batch Euler solver).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tcgan_tpu.ops.fixed_point import FixedPointResult
from tcgan_tpu.ops.ssn import SSNConfig

# Smallest dot dimension the Triton route accepts.
MIN_DIM = 16
# Shared memory one block may use on Hopper (H100/H200): 227 KB.
SMEM_BYTES = 232448
NUM_WARPS = 8


def _pow2_at_least(x: int, lo: int = MIN_DIM) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


def padded_dims(n_stim: int, n_neurons: int) -> tuple[int, int]:
    """(s_pad, n_pad): stimulus rows and neuron lanes padded to powers of
    two of at least 16, as the Triton route requires."""
    return _pow2_at_least(n_stim), _pow2_at_least(n_neurons)


def check_fits(n_stim: int, n_neurons: int) -> None:
    """Raise unless one circuit's W^T and its rate state fit a block's
    shared memory — the design keeps both on chip for every iteration."""
    s_pad, n_pad = padded_dims(n_stim, n_neurons)
    need = 4 * (n_pad * n_pad + s_pad * n_pad)
    if need > SMEM_BYTES:
        raise ValueError(
            f"pallas solver: one circuit's W (2N={n_neurons}, padded to "
            f"{n_pad}) and rates ({n_stim} stimuli, padded to {s_pad}) need "
            f"{need} bytes, more than a block's {SMEM_BYTES} bytes of shared "
            "memory; use the xla solver backend for circuits this large")


def _io_fns(cfg: SSNConfig):
    """Closed-form io function with overflow guards, safe inside kernels."""
    k, n, r0, r1 = cfg.k, cfg.n, cfg.rate_soft_bound, cfg.rate_hard_bound

    def power(u):
        up = jnp.maximum(u, 0.0)
        # exp/log form for non-integer n; guard log(0)
        fp = jnp.exp(n * jnp.log(jnp.maximum(up, 1e-30))) * k
        return jnp.where(up > 0.0, fp, 0.0)

    if cfg.io_type == "asym_power":
        return power
    if cfg.io_type == "asym_tanh":
        d = r1 - r0

        def tanh_io(u):
            fp = power(u)
            arg = jnp.clip(jnp.maximum(fp - r0, 0.0) / d, 0.0, 30.0)
            return jnp.where(fp <= r0, fp, r0 + d * jnp.tanh(arg))

        return tanh_io
    if cfg.io_type == "asym_linear":
        u0 = float(np.power(r0 / k, 1.0 / n))
        slope = k * n * float(np.power(u0, n - 1.0))

        def linear_io(u):
            fp = power(u)
            return jnp.where(u <= u0, fp, r0 + slope * (u - u0))

        return linear_io
    raise ValueError(cfg.io_type)


def _solver_kernel(cfg: SSNConfig, s_pad: int, n_pad: int,
                   check_every: int, two_phase: bool, refine: bool,
                   accel: bool,
                   wt_ref, i_ref, dtau_ref, r_ref, conv_ref, div_ref,
                   iters_ref):
    """One circuit: state R is (s_pad, n_pad) stimulus rows x neuron
    lanes; per-row flags are (s_pad,) float32 0/1 vectors.

    two_phase: run a first while_loop with TF32 tensor-core matmuls
    (Precision.DEFAULT) down to a coarse residual, then a second loop to
    the real atol. The exponential residual decay spends most iterations
    above the coarse threshold, so most of the work runs at the fast rate
    while the converged answer keeps f32 accuracy.

    refine: run phase 2 as ITERATIVE REFINEMENT instead of a loop of
    full-f32 (Precision.HIGHEST, IEEE on the CUDA cores) matmuls: once per
    check chunk take a HIGHEST anchor ``u_ref = W r_ref + I`` at the
    current rates, then iterate on the correction ``e = r - r_ref`` with
    TF32 matmuls — ``u = u_ref + W e`` is f32-accurate in absolute terms
    because TF32's rounding error (10 mantissa bits) of ``W e`` is relative
    to the small ``|e|``, not to ``|r|``. Same Euler update, same residual
    criterion, same fixed point.
    """
    f = _io_fns(cfg)
    WT = wt_ref[...]  # (n_pad, n_pad), loaded once for every iteration
    I = i_ref[...]  # (s_pad, n_pad)
    dtau = dtau_ref[...]  # (1, n_pad), row-broadcasts

    def raw_drive(r, precision):
        return jax.lax.dot_general(
            r, WT, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision)

    def make_drive(precision):
        def drive(r):
            return raw_drive(r, precision) + I

        return drive

    # Clip above the divergence ceiling: the power-law io grows runaway
    # rates super-exponentially, so an unchecked check_every window can
    # carry a sample to f32 inf (which then NaN-poisons the GAN losses).
    # Same semantics-preserving clamp as the XLA/BPTT paths.
    r_ceiling = 10.0 * cfg.rate_stop_at

    def col(v):  # (s_pad,) -> (s_pad, 1)
        return v[:, None]

    def make_substep(drive):
        def substep(r, active):
            delta = -r + f(drive(r))
            return jnp.minimum(r + col(active) * (dtau * delta),
                               r_ceiling), delta

        return substep

    substep = make_substep(make_drive(jax.lax.Precision.HIGHEST))
    substep_fast = make_substep(make_drive(jax.lax.Precision.DEFAULT))

    class S(NamedTuple):
        it: jnp.ndarray
        r: jnp.ndarray  # (s_pad, n_pad)
        conv: jnp.ndarray  # (s_pad,) f32 0/1
        div: jnp.ndarray  # (s_pad,) f32 0/1
        iters: jnp.ndarray  # (s_pad,) f32
        # Anderson(1) chunk history; carried (and dropped by DCE) when
        # accel is off, so both paths share one state layout.
        nhist: jnp.ndarray  # scalar f32: chunks since this loop started
        r_in_prev: jnp.ndarray  # (s_pad, n_pad) previous chunk input
        f_prev: jnp.ndarray  # (s_pad, n_pad) previous chunk displacement

    def apply_anderson(s: S, r_new, active, resolved):
        """Anderson(1) on the chunk map H = step^check_every — same math
        and safeguards as the XLA path (ops/fixed_point.py): extrapolate
        along the displacement secant, gate on history/bounded-gamma/
        active, clamp to [0, r_ceiling]. Residual flags keep using the
        PLAIN chunk, so the accepted fixed point and its criterion are
        unchanged."""
        f_cur = r_new - s.r
        dF = f_cur - s.f_prev
        denom = jnp.sum(dF * dF, axis=-1)  # (s_pad,)
        gamma = jnp.sum(f_cur * dF, axis=-1) / (denom + 1e-30)
        h_prev = s.r_in_prev + s.f_prev
        r_aa = jnp.clip(r_new - col(gamma) * (r_new - h_prev), 0.0,
                        r_ceiling)
        # As in the XLA path: skip extrapolations that overshoot past the
        # divergence ceiling so the next chunk's peak test keeps its
        # plain-iteration semantics (no false divergence flags near
        # criticality).
        peak_aa = jnp.max(r_aa, axis=-1)
        # nhist counts whole chunks, so min(nhist, 1) is the 0/1 history
        # gate
        ok = (jnp.minimum(s.nhist, 1.0)
              * jnp.where(jnp.abs(gamma) < 2.0, 1.0, 0.0)
              * jnp.where(denom > 0.0, 1.0, 0.0)
              * jnp.where(peak_aa <= cfg.rate_stop_at, 1.0, 0.0)
              * active * (1.0 - resolved))
        return r_new + col(ok) * (r_aa - r_new), s.r, f_cur

    def make_cond(max_it):
        def cond(s: S):
            n_resolved = jnp.sum(s.conv) + jnp.sum(s.div)
            return (s.it < max_it) & (n_resolved < s_pad - 0.5)

        return cond

    def chunk_epilogue(s: S, r, delta, active, atol, max_it) -> S:
        """Shared end-of-chunk bookkeeping for BOTH loop variants:
        residual/peak reduction, convergence/divergence flag updates,
        iteration accounting, and the Anderson hook. One implementation
        so the resolved/iters/flag semantics cannot drift between the
        plain and iterative-refinement loops."""
        err = jnp.max(jnp.abs(delta), axis=-1)  # (s_pad,)
        peak = jnp.max(r, axis=-1)
        it_next = s.it + check_every
        div_hit = jnp.where(peak > cfg.rate_stop_at, 1.0, 0.0)
        conv_hit = jnp.where(err < atol, 1.0, 0.0)
        newly_div = active * div_hit
        newly_conv = active * (1.0 - div_hit) * conv_hit
        resolved = newly_div + newly_conv
        r_in_prev, f_prev = s.r_in_prev, s.f_prev
        if accel:
            r, r_in_prev, f_prev = apply_anderson(s, r, active, resolved)
        return S(
            it=it_next,
            r=r,
            conv=s.conv + newly_conv,
            div=s.div + newly_div,
            # clamp: the final chunk may overshoot max_it by up to
            # check_every-1 substeps; recorded iters must never
            # exceed the budget (iters == max_iter means unresolved)
            iters=s.iters + resolved * (
                jnp.minimum(it_next, max_it).astype(jnp.float32)
                - s.iters
            ),
            nhist=s.nhist + 1.0,
            r_in_prev=r_in_prev,
            f_prev=f_prev,
        )

    def make_loop(step_fn, atol, max_it):
        def body(s: S):
            active = 1.0 - s.conv - s.div  # (s_pad,)
            # a loop, not Python unrolling: 32 unrolled substeps took
            # minutes to compile for the GPU
            r = jax.lax.fori_loop(0, check_every - 1,
                                  lambda _, r: step_fn(r, active)[0], s.r)
            r, delta = step_fn(r, active)
            return chunk_epilogue(s, r, delta, active, atol, max_it)

        return make_cond(max_it), body

    def make_refine_loop(atol, max_it):
        """Phase-2 loop via iterative refinement (see docstring)."""
        drive_hi = make_drive(jax.lax.Precision.HIGHEST)

        def body(s: S):
            active = 1.0 - s.conv - s.div  # (s_pad,)
            u_anchor = drive_hi(s.r)  # HIGHEST anchor, once per chunk
            r_base = s.r

            def correction_step(_, carry):
                e, _ = carry
                u = u_anchor + raw_drive(e, jax.lax.Precision.DEFAULT)
                delta = -(r_base + e) + f(u)
                # same overflow clamp as the plain loops (on r = r_base + e)
                return jnp.minimum(e + col(active) * (dtau * delta),
                                   r_ceiling - r_base), delta

            zeros = jnp.zeros_like(s.r)
            e, delta = jax.lax.fori_loop(0, check_every, correction_step,
                                         (zeros, zeros))
            r = r_base + e
            return chunk_epilogue(s, r, delta, active, atol, max_it)

        return make_cond(max_it), body

    zeros_rn = jnp.zeros((s_pad, n_pad), jnp.float32)
    zeros_s = jnp.zeros((s_pad,), jnp.float32)
    init = S(
        it=jnp.zeros((), jnp.int32),
        r=f(I) if cfg.init == "feedforward" else zeros_rn,
        conv=zeros_s,
        div=zeros_s,
        iters=jnp.full((s_pad,), float(cfg.max_iter), jnp.float32),
        nhist=jnp.zeros((), jnp.float32),
        r_in_prev=zeros_rn,
        f_prev=zeros_rn,
    )
    if two_phase:
        # Phase 1: TF32 matmuls down to a coarse residual, HARD-CAPPED at
        # half the iteration budget — the TF32 residual floor can sit
        # above any fixed coarse threshold for strongly-coupled circuits,
        # and without the cap phase 1 would eat the whole budget and
        # nothing would ever meet the real atol. Divergence detection
        # stays live; "converged" here only means "left phase 1".
        coarse = max(cfg.atol * 100.0, 1e-2)
        cond1, body1 = make_loop(substep_fast, coarse, cfg.max_iter // 2)
        mid = jax.lax.while_loop(cond1, body1, init)
        # Phase 2: f32-accurate tail from the phase-1 state; reopen the
        # coarse-converged rows AND the diverged ones. A phase-1
        # divergence flag is a TF32 measurement: near the ceiling its
        # relative matmul error (~1e-3) is amplified ~n-fold through
        # f(u)=k*u^n, so a true-peak ~199 Hz sample can falsely read
        # >rate_stop_at — and a permanent flag would systematically
        # reject valid near-critical circuits (the regime this project
        # trains in) where the f32 XLA reference converges them.
        # Reopened truly-divergent rows re-flag themselves within a chunk
        # or two (their r is at/above the ceiling, the dynamics re-diverge
        # immediately); falsely-flagged rows relax back and converge.
        # Flag parity with the XLA path is decided only by f32 arithmetic.
        # pallas_reopen_margin > 0: rows PINNED above margin*rate_stop_at
        # are hard divergers (TF32 noise is well under a per cent, never
        # 2x) — keep their flag and phase-1 iteration count so they don't
        # burn the f32 budget re-proving it. Only the ambiguous
        # near-threshold band gets the f32 retrial.
        if cfg.pallas_reopen_margin > 0:
            peak1 = jnp.max(mid.r, axis=-1)
            keep_div = mid.div * jnp.where(
                peak1 > cfg.pallas_reopen_margin * cfg.rate_stop_at,
                1.0, 0.0)
        else:
            keep_div = zeros_s
        init2 = S(it=mid.it, r=mid.r,
                  conv=zeros_s,
                  div=keep_div,
                  iters=keep_div * mid.iters
                  + (1.0 - keep_div) * float(cfg.max_iter),
                  # Anderson history does NOT carry across the phase
                  # boundary: phase 2's chunk map differs (precision /
                  # refine form), so the phase-1 secant would mislead the
                  # first extrapolation. nhist=0 re-arms the gate.
                  nhist=jnp.zeros((), jnp.float32),
                  r_in_prev=zeros_rn,
                  f_prev=zeros_rn)
        if refine:
            cond2, body2 = make_refine_loop(cfg.atol, cfg.max_iter)
        else:
            cond2, body2 = make_loop(substep, cfg.atol, cfg.max_iter)
        out = jax.lax.while_loop(cond2, body2, init2)
    else:
        cond1, body1 = make_loop(substep, cfg.atol, cfg.max_iter)
        out = jax.lax.while_loop(cond1, body1, init)
    r_ref[...] = out.r
    conv_ref[...] = out.conv.astype(jnp.int32)
    div_ref[...] = out.div.astype(jnp.int32)
    iters_ref[...] = out.iters.astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "check_every", "interpret", "two_phase",
                     "refine", "accel"),
)
def _solve(cfg, W, I_ext, check_every, interpret, two_phase, refine, accel):
    B, n2 = W.shape[0], W.shape[-1]
    S = I_ext.shape[0]
    check_fits(S, n2)
    s_pad, n_pad = padded_dims(S, n2)

    # W^T per circuit, so the kernel's matmul is a plain r @ W^T.
    WT = jnp.zeros((B, n_pad, n_pad), jnp.float32)
    WT = WT.at[:, :n2, :n2].set(jnp.swapaxes(W, -1, -2).astype(jnp.float32))
    Ip = jnp.zeros((s_pad, n_pad), jnp.float32)
    Ip = Ip.at[:S, :n2].set(I_ext.astype(jnp.float32))
    dt_tau = jnp.zeros((1, n_pad), jnp.float32)
    dt_tau = dt_tau.at[0, :n2].set(cfg.step_gain(dtype=jnp.float32))

    kernel = functools.partial(
        _solver_kernel, cfg, s_pad, n_pad, check_every,
        two_phase, refine, accel,
    )
    row = pl.BlockSpec((None, s_pad), lambda b: (b, 0))
    r, conv, div, iters = pl.pallas_call(
        kernel,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((None, n_pad, n_pad), lambda b: (b, 0, 0)),
            pl.BlockSpec((s_pad, n_pad), lambda b: (0, 0)),
            pl.BlockSpec((1, n_pad), lambda b: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, s_pad, n_pad), lambda b: (b, 0, 0)),
            row, row, row,
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, s_pad, n_pad), jnp.float32),
            jax.ShapeDtypeStruct((B, s_pad), jnp.int32),
            jax.ShapeDtypeStruct((B, s_pad), jnp.int32),
            jax.ShapeDtypeStruct((B, s_pad), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="ssn_fixed_point",
    )(WT, Ip, dt_tau)

    # Padded stimulus rows converge at once (I = 0, r = 0) and padded
    # lanes stay at zero (dt/tau = 0 there); both are dropped here.
    return FixedPointResult(
        r=r[:, :S, :n2],
        converged=conv[:, :S].astype(bool),
        diverged=div[:, :S].astype(bool),
        iters=iters[:, :S],
    )


def solve_fixed_point_pallas(
    cfg: SSNConfig,
    W: jnp.ndarray,  # (B, 2N, 2N)
    I_ext: jnp.ndarray,  # (S, 2N) shared stimulus battery
    check_every: int = 32,
    interpret: bool = False,
    two_phase: bool = True,
    refine: bool = True,
    accel: bool = False,
) -> FixedPointResult:
    """Fixed-point solve via the fused kernel, one circuit per program.

    Same contract as ``solve_fixed_point`` for the common generator layout
    (single leading batch dim, shared stimulus battery). Forward-only (wrap
    with ops.ift for gradients). The kernel is compiled for an NVIDIA GPU;
    elsewhere it runs only when a caller asks for ``interpret=True``.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the pallas solver kernel is compiled for an NVIDIA GPU, and "
            f"the default JAX backend is {jax.default_backend()!r}; use the "
            "xla solver backend (interpret=True runs the kernel in the "
            "Pallas interpreter, for tests)")
    return _solve(cfg, W, I_ext, check_every=check_every,
                  interpret=interpret, two_phase=two_phase, refine=refine,
                  accel=accel)
