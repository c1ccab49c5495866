"""Cross-implementation test: fused Pallas kernel vs the plain-XLA solver
(interpret mode on CPU; the compiled kernel runs on the GPU in
chip_smoke.py), plus the wrapper's padding, lowering and guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgan_tpu.ops import fixed_point, stimulus, weights
from tcgan_tpu.ops.pallas import solve_fixed_point_pallas, ssn_solve
from tcgan_tpu.ops.ssn import SSNConfig

BANDWIDTHS = (0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0)


def _problem(B=5):
    cfg = SSNConfig(N=8, k=0.01, n=2.2, dt=0.001, max_iter=4000, atol=1e-6)
    J = jnp.array([[0.025, 0.02], [0.025, 0.015]], dtype=jnp.float32)
    D = jnp.array([[0.1, 0.08], [0.1, 0.08]], dtype=jnp.float32)
    Ssp = jnp.array([[0.25, 0.1], [0.25, 0.1]], dtype=jnp.float32)
    x = cfg.site_pos()
    z = weights.sample_z(jax.random.PRNGKey(11), (B,), cfg.N)
    W = weights.build_weight(J, D, Ssp, z, x)
    I = stimulus.stimulus_battery((0.25, 1.0), (5.0,), x, cfg.smoothness)
    return cfg, W.astype(jnp.float32), I.astype(jnp.float32)


@pytest.mark.parametrize("refine", [True, False])
def test_pallas_matches_xla_solver(refine):
    cfg, W, I = _problem()
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=1,
                                   interpret=True,
                                   refine=refine)
    assert out.r.shape == ref.r.shape
    assert bool(ref.converged.all())
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)


def test_pallas_flags_divergence():
    cfg = SSNConfig(N=4, k=0.05, n=2.0, dt=0.001, max_iter=2000,
                    rate_stop_at=100.0, atol=1e-6)
    n2 = cfg.num_neurons
    key = jax.random.PRNGKey(0)
    W_bad = 5.0 * jnp.abs(jax.random.normal(key, (2, n2, n2)))
    I = 30.0 * jnp.ones((1, n2), jnp.float32)
    out = solve_fixed_point_pallas(cfg, W_bad.astype(jnp.float32), I,
                                   interpret=True)
    assert bool(out.diverged.all())
    assert not bool(out.converged.any())


def test_pallas_ragged_batch_padding():
    """An odd batch size (one program per circuit, no batch padding)
    returns exactly its circuits, matching the XLA solver."""
    cfg, W, I = _problem(B=3)
    out = solve_fixed_point_pallas(cfg, W, I, interpret=True)
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    assert out.r.shape[0] == 3
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)


def _interpret_kernel(monkeypatch):
    """Route solve_any's kernel call through the Pallas interpreter (the
    CPU has no compiled kernel); returns the real entry point."""
    import functools

    import tcgan_tpu.ops.pallas as pallas_pkg

    real = solve_fixed_point_pallas
    monkeypatch.setattr(pallas_pkg, "solve_fixed_point_pallas",
                        functools.partial(real, interpret=True))
    return real


def test_backend_dispatch_through_ift(monkeypatch):
    """cfg.backend='pallas' routes the generator forward through the kernel
    while IFT backward stays on the XLA matvec path; gradients must match
    the xla-backend gradients."""
    import dataclasses

    from tcgan_tpu.ops import ift

    _interpret_kernel(monkeypatch)
    cfg, W, I = _problem(B=4)
    cfg_p = dataclasses.replace(cfg, backend="pallas")

    def loss(cfg_used, W):
        res = ift.solve_fixed_point_implicit(cfg_used, W, I, bwd_atol=1e-8)
        return jnp.mean(res.r**2)

    g_x = jax.grad(lambda W: loss(cfg, W))(W)
    g_p = jax.grad(lambda W: loss(cfg_p, W))(W)
    np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_x),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("io_type", ["asym_tanh", "asym_linear"])
def test_pallas_io_variants_match_xla(io_type):
    """Saturating io types agree between the kernel and the XLA solver."""
    import dataclasses

    cfg, W, I = _problem(B=4)
    # low bounds so the saturating branch is actually exercised
    cfg = dataclasses.replace(cfg, io_type=io_type, rate_soft_bound=0.15,
                              rate_hard_bound=0.8, rate_stop_at=50.0)
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=1,
                                   interpret=True, two_phase=False)
    assert bool(ref.converged.all())
    # confirm saturation engaged (some rates above the soft bound)
    assert float(ref.r.max()) > 0.15
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)


def test_pallas_expo_stepper_matches_xla():
    import dataclasses

    cfg, W, I = _problem(B=4)
    cfg = dataclasses.replace(cfg, stepper="expo", dt=2.0 * cfg.tau_I,
                              max_iter=2000)
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=1,
                                   interpret=True, two_phase=False)
    assert bool(ref.converged.all()) and bool(out.converged.all())
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)


def test_reference_parity_aliases():
    from tcgan_tpu import ops

    assert ops.find_fixed_points is fixed_point.solve_fixed_point
    assert callable(ops.make_io_fun) and callable(ops.rate_to_volt)
    assert callable(ops.solve_dynamics)


def test_pallas_feedforward_init_matches():
    import dataclasses

    cfg, W, I = _problem(B=4)
    cfg_ff = dataclasses.replace(cfg, init="feedforward")
    ref = fixed_point.solve_fixed_point(cfg_ff, W, I)
    out = solve_fixed_point_pallas(cfg_ff, W, I, check_every=1,
                                   interpret=True, two_phase=False)
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)
    assert bool(out.converged.all())
    # feedforward warm start must agree on iteration counts with the XLA
    # path (the whole point of honoring cfg.init) up to a few
    # steps of float-associativity jitter at the atol crossing
    assert np.max(np.abs(np.asarray(out.iters, np.int64)
                         - np.asarray(ref.iters, np.int64))) <= 4


def test_solve_any_honors_pallas_knobs(monkeypatch):
    """SSNConfig.pallas_two_phase / check_every / accel must reach the
    kernel, and solve_any itself never asks for interpret mode."""
    import dataclasses

    from tcgan_tpu.ops import fixed_point as fp

    seen = {}
    real = solve_fixed_point_pallas

    def spy(cfg, W, I, **kw):
        seen.update(kw)
        return real(cfg, W, I, **{**kw, "interpret": True})

    import tcgan_tpu.ops.pallas as pallas_pkg
    monkeypatch.setattr(pallas_pkg, "solve_fixed_point_pallas", spy)
    cfg, W, I = _problem(B=2)
    cfg = dataclasses.replace(cfg, backend="pallas", check_every=8,
                              pallas_two_phase=False, accel="anderson")
    out = fp.solve_any(cfg, W, I)
    assert seen["two_phase"] is False
    assert seen["check_every"] == 8 and seen["accel"] is True
    assert "interpret" not in seen
    assert bool(out.converged.all())


def test_refine_tail_converges_tight_atol():
    """The refinement tail must reach a tight residual (well below the
    coarse phase-1 threshold) and agree with the XLA solver's fixed point
    and iteration counts."""
    import dataclasses

    cfg, W, I = _problem(B=4)  # atol=1e-6, far below the 1e-2 coarse phase
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=8,
                                   interpret=True, two_phase=True,
                                   refine=True)
    assert bool(out.converged.all())
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-5, atol=1e-6)
    # counts agree up to the check stride + phase-boundary quantization
    assert np.max(np.abs(np.asarray(out.iters, np.int64)
                         - np.asarray(ref.iters, np.int64))) <= 24


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_runaway_rates_stay_finite(backend):
    """Super-exponential blow-up between convergence checks must saturate
    at the clip ceiling (finite), not overflow to inf — inf rates NaN-
    poison the GAN losses downstream (observed in a live fit)."""
    cfg = SSNConfig(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
                    rate_stop_at=200.0, atol=1e-6, check_every=32)
    n2 = cfg.num_neurons
    W_bad = 8.0 * jnp.abs(jax.random.normal(jax.random.PRNGKey(0),
                                            (2, n2, n2)))
    I = 50.0 * jnp.ones((1, n2), jnp.float32)
    if backend == "xla":
        out = fixed_point.solve_fixed_point(cfg, W_bad, I, check_every=32)
    else:
        out = solve_fixed_point_pallas(cfg, W_bad, I, check_every=32, interpret=True)
    assert bool(out.diverged.all())
    assert np.all(np.isfinite(np.asarray(out.r)))
    assert float(out.r.max()) <= 10.0 * cfg.rate_stop_at + 1e-3


def test_pallas_anderson_matches_xla_fixed_point():
    """Anderson-accelerated kernel: same fixed points and flags as the
    plain-XLA solver, fewer iterations than the unaccelerated kernel."""
    cfg, W, I = _problem()
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    plain = solve_fixed_point_pallas(cfg, W, I, check_every=8,
                                     interpret=True)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=8,
                                   interpret=True, accel=True)
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)
    assert int(np.asarray(out.iters).max()) <= int(
        np.asarray(plain.iters).max())


def test_reopen_margin_same_flags_fewer_iters():
    """pallas_reopen_margin keeps HARD divergers (rates pinned above
    margin*rate_stop_at at the phase boundary) flagged through phase 2
    instead of re-proving their divergence at full precision — same
    flags and same converged rates as margin=0 and as the XLA reference,
    strictly fewer (or equal) recorded iterations on the diverged rows
    (BASELINE.md round-5 wgan_step root cause)."""
    import dataclasses

    cfg = SSNConfig(N=4, k=0.05, n=2.2, dt=0.002, max_iter=512,
                    rate_stop_at=200.0, atol=1e-4, check_every=32)
    n2 = cfg.num_neurons
    # mixed batch: 2 hard divergers + 2 convergers
    W_bad = 8.0 * jnp.abs(jax.random.normal(jax.random.PRNGKey(0),
                                            (2, n2, n2)))
    W_ok = 0.01 * jnp.abs(jax.random.normal(jax.random.PRNGKey(1),
                                            (2, n2, n2)))
    W = jnp.concatenate([W_bad, W_ok])
    # I=10: feedforward rate k*10^n ~ 8 Hz (convergers stay tame);
    # the W_bad recurrence still blows past rate_stop_at
    I = 10.0 * jnp.ones((1, n2), jnp.float32)

    ref = fixed_point.solve_fixed_point(cfg, W, I, check_every=32)
    out0 = solve_fixed_point_pallas(cfg, W, I, check_every=32,
                                    interpret=True)
    cfg_m = dataclasses.replace(cfg, pallas_reopen_margin=2.0)
    outm = solve_fixed_point_pallas(cfg_m, W, I, check_every=32,
                                    interpret=True)

    np.testing.assert_array_equal(np.asarray(outm.diverged),
                                  np.asarray(ref.diverged))
    np.testing.assert_array_equal(np.asarray(outm.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(np.asarray(outm.diverged),
                                  np.asarray(out0.diverged))
    assert bool(ref.diverged[:2].all()) and bool(ref.converged[2:].all())
    # converged rates unchanged by the margin
    np.testing.assert_allclose(np.asarray(outm.r[2:]),
                               np.asarray(out0.r[2:]), rtol=1e-5,
                               atol=1e-6)
    # hard divergers keep their cheap phase-1 iteration record
    assert np.all(np.asarray(outm.iters)[:2] <=
                  np.asarray(out0.iters)[:2])


@pytest.mark.parametrize("contrasts", [(10.0,), (5.0, 10.0, 13.0)],
                         ids=["S8", "S24"])
def test_kernel_lowers_for_cuda(contrasts):
    """At the real width (N=51, 8 bandwidths x 1 or 3 contrasts) the kernel
    lowers for CUDA from the CPU: every primitive it uses has a Triton
    lowering (no in-kernel slicing, dot dims >= 16). What the GPU
    compiler says about it shows only on the card (chip_smoke.py)."""
    cfg = SSNConfig(N=51, max_iter=8000, atol=1e-4)
    I = stimulus.stimulus_battery(BANDWIDTHS, contrasts, cfg.site_pos(),
                                  cfg.smoothness)
    W = jax.ShapeDtypeStruct((512, 102, 102), jnp.float32)
    lowered = jax.jit(lambda w: ssn_solve._solve(
        cfg, w, I, check_every=32, interpret=False, two_phase=True,
        refine=True, accel=False)).trace(W).lower(
            lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()
    assert ssn_solve.padded_dims(I.shape[0], 102) == (
        16 if len(contrasts) == 1 else 32, 128)


def test_non_interpret_call_off_gpu_raises():
    cfg, W, I = _problem(B=2)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        solve_fixed_point_pallas(cfg, W, I)


def test_solve_any_pallas_off_gpu_raises():
    """solve_any never interprets: choosing the kernel on the CPU fails."""
    import dataclasses

    cfg, W, I = _problem(B=2)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        fixed_point.solve_any(dataclasses.replace(cfg, backend="pallas"),
                              W, I)


def test_w_too_large_for_shared_memory_raises():
    """N=201 (402 neurons, padded to 512) cannot keep W in a block's shared
    memory; the wrapper says so instead of routing elsewhere."""
    ssn_solve.check_fits(24, 128)  # N=51 fits
    with pytest.raises(ValueError, match="shared memory"):
        ssn_solve.check_fits(24, 402)
    cfg = SSNConfig(N=201)
    W = jnp.zeros((1, 402, 402), jnp.float32)
    I = jnp.zeros((8, 402), jnp.float32)
    with pytest.raises(ValueError, match="shared memory"):
        solve_fixed_point_pallas(cfg, W, I, interpret=True)


def test_padding_leaks_nothing():
    """2N=10 pads to 16 lanes and S=3 to 16 rows: the padded lanes and
    rows must not change the real ones, and none come back."""
    cfg = SSNConfig(N=5, k=0.01, n=2.2, dt=0.001, max_iter=4000, atol=1e-6)
    x = cfg.site_pos()
    z = weights.sample_z(jax.random.PRNGKey(3), (3,), cfg.N)
    W = weights.build_weight(
        jnp.array([[0.025, 0.02], [0.025, 0.015]]),
        jnp.array([[0.1, 0.08], [0.1, 0.08]]),
        jnp.array([[0.25, 0.1], [0.25, 0.1]]), z, x).astype(jnp.float32)
    I = stimulus.stimulus_battery((0.25, 0.5, 1.0), (5.0,), x,
                                  cfg.smoothness).astype(jnp.float32)
    assert ssn_solve.padded_dims(3, 10) == (16, 16)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=4,
                                   interpret=True)
    ref = fixed_point.solve_fixed_point(cfg, W, I)
    assert out.r.shape == (3, 3, 10) and out.iters.shape == (3, 3)
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(np.asarray(out.r), np.asarray(ref.r),
                               rtol=1e-4, atol=1e-5)


def test_pallas_under_mesh_raises(monkeypatch):
    """Under a multi-device mesh the kernel would replicate the whole
    batch on every device (a pallas_call is opaque to automatic
    partitioning): solve_any refuses instead."""
    import dataclasses

    from tcgan_tpu import parallel as par

    _interpret_kernel(monkeypatch)
    cfg, W, I = _problem(B=4)
    cfg = dataclasses.replace(cfg, backend="pallas")
    with jax.set_mesh(par.make_mesh(n_batch=2)):
        with pytest.raises(ValueError, match="mesh"):
            fixed_point.solve_any(cfg, W, I)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    """The kernel as compiled for the card (never interpreted) agrees with
    the XLA solver at the real width, N=51 under the 8-stimulus battery,
    within chip_smoke.py's tolerances."""
    cfg = SSNConfig(N=51, max_iter=8000, atol=1e-4)
    x = cfg.site_pos()
    z = weights.sample_z(jax.random.PRNGKey(0), (64,), cfg.N)
    W = weights.build_weight(
        jnp.array([[0.045, 0.040], [0.050, 0.035]]),
        jnp.array([[0.10, 0.08], [0.10, 0.08]]),
        jnp.array([[0.25, 0.10], [0.25, 0.10]]), z, x).astype(jnp.float32)
    I = stimulus.stimulus_battery(BANDWIDTHS, (10.0,), x,
                                  cfg.smoothness).astype(jnp.float32)
    out = solve_fixed_point_pallas(cfg, W, I, check_every=32)
    ref = fixed_point.solve_fixed_point(cfg, W, I, check_every=32)
    both = np.asarray(out.converged & ref.converged)
    assert both.mean() > 0.99
    diff = np.abs(np.asarray(out.r) - np.asarray(ref.r))[both]
    assert diff.max() <= 5e-3
    assert int((np.asarray(out.converged)
                != np.asarray(ref.converged)).sum()) <= 2e-3 * both.size
