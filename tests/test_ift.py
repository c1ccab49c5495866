"""IFT gradient tests: implicit gradients vs finite differences and vs BPTT.

Reference test analog: the fixed-point-gradient checks near
``tc_gan/gradient_expressions/SS_grad.py`` (SURVEY.md §4 "Gradient tests")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgan_tpu.ops import euler, ift, stimulus, weights
from tcgan_tpu.ops.ssn import SSNConfig

CFG = SSNConfig(N=6, k=0.01, n=2.2, dt=0.001, max_iter=40000, atol=1e-9)
J0 = jnp.array([[0.08, 0.06], [0.09, 0.05]])
D0 = jnp.array([[0.2, 0.15], [0.2, 0.15]])
S0 = jnp.array([[0.25, 0.1], [0.25, 0.1]])


def _setup(dtype=jnp.float64):
    x = CFG.site_pos(dtype=dtype)
    z = weights.sample_z(jax.random.PRNGKey(3), (2,), CFG.N, dtype=dtype)
    I = stimulus.stimulus_battery((0.25, 1.0), (5.0,), x, CFG.smoothness)
    return x, z, I.astype(dtype)


def _make_loss(grad_method):
    x, z, I = _setup()

    def loss(params):
        J, D, S = params
        W = weights.build_weight(J, D, S, z, x)
        res = ift.solve_fixed_point_implicit(
            CFG, W, I, grad_method=grad_method, bwd_atol=1e-10
        )
        # scalar readout emphasizing a few probe neurons
        return jnp.sum(res.r[..., :, CFG.N // 2] ** 2) + 0.1 * jnp.mean(res.r)

    return loss


@pytest.mark.parametrize("grad_method", ["iterative"])
def test_ift_matches_finite_differences(grad_method):
    loss = _make_loss(grad_method)
    params = (
        J0.astype(jnp.float64),
        D0.astype(jnp.float64),
        S0.astype(jnp.float64),
    )
    gJ, gD, gS = jax.grad(loss)(params)
    assert np.all(np.isfinite(np.asarray(gJ)))

    loss_j = jax.jit(loss)
    eps = 1e-6
    # spot-check a handful of components across all three param matrices
    for which, (a, b) in [(0, (0, 0)), (0, (1, 1)), (1, (0, 1)), (2, (1, 0))]:
        p_list = [np.asarray(p, dtype=np.float64).copy() for p in params]
        p_list[which][a, b] += eps
        up = float(loss_j(tuple(jnp.asarray(p) for p in p_list)))
        p_list[which][a, b] -= 2 * eps
        dn = float(loss_j(tuple(jnp.asarray(p) for p in p_list)))
        fd = (up - dn) / (2 * eps)
        analytic = float((gJ, gD, gS)[which][a, b])
        np.testing.assert_allclose(analytic, fd, rtol=2e-3, atol=1e-7)


def test_iterative_matches_numpy_exact_ift():
    """The iterative adjoint solve must agree with an exact host-side NumPy
    solve of the IFT linear system (independent implementation, f64)."""
    x, z, I = _setup()
    W = weights.build_weight(J0.astype(jnp.float64), D0.astype(jnp.float64),
                             S0.astype(jnp.float64), z, x)
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                     (2, I.shape[0], W.shape[-1]),
                                     dtype=jnp.float64))

    def loss(W):
        res = ift.solve_fixed_point_implicit(CFG, W, I, bwd_atol=1e-11)
        return jnp.sum(jnp.asarray(g) * res.r)

    gW_jax = np.asarray(jax.grad(loss)(W))

    # exact IFT in numpy: lam solves (I - diag(phi) W)^T lam = g per (b, s)
    res = ift.solve_fixed_point_implicit(CFG, W, I)
    r = np.asarray(res.r)
    Wn = np.asarray(W)
    In = np.asarray(I)
    fprime = CFG.io_deriv()
    gW_np = np.zeros_like(Wn)
    n2 = Wn.shape[-1]
    for b in range(r.shape[0]):
        for s in range(r.shape[1]):
            u = Wn[b] @ r[b, s] + In[s]
            phi = np.asarray(fprime(jnp.asarray(u)))
            A = np.eye(n2) - phi[:, None] * Wn[b]
            lam = np.linalg.solve(A.T, g[b, s])
            gW_np[b] += np.outer(phi * lam, r[b, s])
    np.testing.assert_allclose(gW_jax, gW_np, rtol=1e-6, atol=1e-10)


def test_direct_method_f32():
    """The batched-dense 'direct' backward (f32) agrees with
    the iterative adjoint to f32 tolerance."""
    x64_x, x64_z, x64_I = _setup()
    x, z, I = (a.astype(jnp.float32) for a in (x64_x, x64_z, x64_I))
    cfg = SSNConfig(N=6, k=0.01, n=2.2, dt=0.001, max_iter=20000, atol=1e-6)

    def make(gm):
        def loss(J):
            W = weights.build_weight(J, D0.astype(jnp.float32),
                                     S0.astype(jnp.float32), z, x)
            res = ift.solve_fixed_point_implicit(cfg, W, I, grad_method=gm,
                                                 bwd_atol=1e-7)
            return jnp.mean(res.r**2)
        return loss

    g_di = jax.grad(make("direct"))(J0.astype(jnp.float32))
    g_it = jax.grad(make("iterative"))(J0.astype(jnp.float32))
    assert np.all(np.isfinite(np.asarray(g_di)))
    np.testing.assert_allclose(np.asarray(g_di), np.asarray(g_it),
                               rtol=5e-3, atol=1e-6)


def test_ift_matches_bptt():
    """Cross-implementation: implicit gradients agree with BPTT through a
    long unrolled trajectory (the two gradient paths of the reference,
    SURVEY.md §3.1 vs §3.2)."""
    x, z, I = _setup()

    def loss_ift(params):
        J, D, S = params
        W = weights.build_weight(J, D, S, z, x)
        res = ift.solve_fixed_point_implicit(CFG, W, I, bwd_atol=1e-10)
        return jnp.mean(res.r**2)

    def loss_bptt(params):
        J, D, S = params
        W = weights.build_weight(J, D, S, z, x)
        res = euler.solve_dynamics(CFG, W, I, seqlen=12000, checkpoint_chunk=400)
        return jnp.mean(res.r**2)

    params = (
        J0.astype(jnp.float64),
        D0.astype(jnp.float64),
        S0.astype(jnp.float64),
    )
    g_ift = jax.grad(loss_ift)(params)
    g_bptt = jax.grad(loss_bptt)(params)
    for a, b in zip(g_ift, g_bptt):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-9)


def test_diverged_samples_do_not_poison_gradient():
    """A batch mixing stable and divergent circuits must yield finite
    gradients, with the divergent samples' contribution masked out."""
    cfg = SSNConfig(N=6, k=0.05, n=2.0, dt=0.001, max_iter=5000, atol=1e-7,
                    rate_stop_at=100.0)
    x = cfg.site_pos(dtype=jnp.float64)
    z = weights.sample_z(jax.random.PRNGKey(5), (3,), cfg.N, dtype=jnp.float64)
    # make sample 0 wildly unstable: huge E columns, I columns rectified to 0
    z = z.at[0, :, : cfg.N].set(200.0)
    z = z.at[0, :, cfg.N :].set(-200.0)
    I = stimulus.stimulus_battery((1.0,), (5.0,), x, cfg.smoothness).astype(jnp.float64)

    def loss(J):
        W = weights.build_weight(J, D0.astype(jnp.float64), S0.astype(jnp.float64), z, x)
        res = ift.solve_fixed_point_implicit(cfg, W, I)
        return jnp.mean(res.r)

    res = ift.solve_fixed_point_implicit(
        cfg, weights.build_weight(J0.astype(jnp.float64), D0.astype(jnp.float64),
                                  S0.astype(jnp.float64), z, x), I)
    assert bool(res.diverged[0, 0]), "sample 0 should diverge"
    assert bool(res.converged[1:].all()), "samples 1,2 should converge"

    g = jax.grad(loss)(J0.astype(jnp.float64))
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0


def test_equal_rank_size1_broadcast_cotangent():
    """I_ext with a size-1 leading dim of the SAME rank as W's batch (e.g.
    (1, S, 2N) against (B, 2N, 2N) -> rates (B, S, 2N)) must yield an
    I_ext cotangent of shape (1, S, 2N) = the sum over the broadcast axis."""
    x, z, I = _setup()
    W = weights.build_weight(J0.astype(jnp.float64), D0.astype(jnp.float64),
                             S0.astype(jnp.float64), z, x)  # (2, 2N, 2N)
    I1 = I[None]  # (1, S, 2N), same rank as the (B, S, 2N) rates

    def loss(I_in):
        res = ift.solve_fixed_point_implicit(CFG, W, I_in, bwd_atol=1e-10)
        return jnp.sum(res.r ** 2)

    g1 = jax.grad(loss)(I1)
    assert g1.shape == I1.shape
    # must equal the unbroadcast (rank-reduced) gradient
    g0 = jax.grad(lambda I_in: loss(I_in[None]))(I)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g0),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("grad_method", ["direct", "iterative", "jfb"])
def test_excluded_sample_nan_cannot_poison_backward(grad_method):
    """An excluded (non-converged) sample carrying NaN rates or cotangents
    must be inert in EVERY adjoint method: its phi/g are where-masked to
    zero (NaN * 0 = NaN, so multiplication is not enough), the direct
    method's system row becomes the identity, and the iterative method's
    global residual norm never sees the excluded sample's dynamics."""
    from types import SimpleNamespace

    x, z, I = _setup()
    W = weights.build_weight(J0.astype(jnp.float64), D0.astype(jnp.float64),
                             S0.astype(jnp.float64), z, x)
    res = ift.solve_fixed_point_implicit(CFG, W, I)
    assert bool(res.converged.all())
    r_star = res.r.at[0].set(jnp.nan)  # sample 0: poisoned AND excluded
    converged = res.converged.at[0].set(False)
    g = jnp.ones_like(res.r).at[0].set(jnp.inf)
    cot = SimpleNamespace(r=g)
    W_bar, I_bar = ift._bwd(CFG, grad_method, 2000, 1e-10,
                            (W, I, r_star, converged), cot)
    assert np.all(np.isfinite(np.asarray(W_bar)))
    assert np.all(np.isfinite(np.asarray(I_bar)))
    # the included sample still produces signal
    assert float(jnp.max(jnp.abs(W_bar[1]))) > 0
