#!/usr/bin/env python
"""On-device validation of pallas_reopen_margin (the wgan_step
cost recovery — BASELINE.md round-5 root cause):

1. FLAG PARITY on a divergence-heavy batch: margin=2.0 vs margin=0 vs
   the XLA reference, on the REAL chip (the bench's _parity gate runs a
   100%-convergent battery, so it cannot see this path).
2. COST: the bench's exact WGAN-GP step config (32%-divergent fake
   draws) timed with the marginal-cost methodology at margin 0 vs 2.0.

Run alone: one JAX process per card.
"""

import os
import sys

# standalone-invocation bootstrap: these scripts live in docs/artifacts
# but import the repo package (the 04:17 queue run failed on a bare
# `python docs/artifacts/...py` without PYTHONPATH)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.models import wgan as wgan_lib
from tcgan_tpu.models.generator import GeneratorConfig
from tcgan_tpu.ops import fixed_point, stimulus, weights
from tcgan_tpu.ops.pallas import solve_fixed_point_pallas
from tcgan_tpu.ops.ssn import SSNConfig

out = {}

# --- 1. on-device flag parity, divergence-heavy batch -------------------
cfg = SSNConfig(N=51, k=0.01, n=2.2, dt=0.0005, max_iter=8000, atol=1e-4)
J = jnp.array([[0.045, 0.040], [0.050, 0.035]], jnp.float32)
D = jnp.array([[0.10, 0.08], [0.10, 0.08]], jnp.float32)
S = jnp.array([[0.25, 0.10], [0.25, 0.10]], jnp.float32)
x = cfg.site_pos()
# high contrast pushes a large fraction of z-draws past criticality
I = stimulus.stimulus_battery((0.0, 0.25, 0.5, 1.0), (20.0,), x,
                              cfg.smoothness)
z = weights.sample_z(jax.random.PRNGKey(3), (96,), cfg.N)
W = weights.build_weight(J, D, S, z, x)

ref = jax.jit(lambda w: fixed_point.solve_fixed_point(
    cfg, w, I, check_every=16))(W)
r0 = jax.jit(lambda w: solve_fixed_point_pallas(
    cfg, w, I, check_every=32))(W)
cfg_m = dataclasses.replace(cfg, pallas_reopen_margin=2.0)
rm = jax.jit(lambda w: solve_fixed_point_pallas(
    cfg_m, w, I, check_every=32))(W)
jax.block_until_ready(rm.r)

div_ref = np.asarray(ref.diverged)
out["parity"] = {
    "frac_diverged_ref": round(float(div_ref.mean()), 4),
    "flag_mismatch_m0_vs_ref": int(
        (np.asarray(r0.diverged) != div_ref).sum()),
    "flag_mismatch_m2_vs_ref": int(
        (np.asarray(rm.diverged) != div_ref).sum()),
    "flag_mismatch_m2_vs_m0": int(
        (np.asarray(rm.diverged) != np.asarray(r0.diverged)).sum()),
    "conv_mismatch_m2_vs_m0": int(
        (np.asarray(rm.converged) != np.asarray(r0.converged)).sum()),
    "mean_iters_m0": round(float(np.asarray(r0.iters).mean()), 1),
    "mean_iters_m2": round(float(np.asarray(rm.iters).mean()), 1),
    # converged rates must be bit-comparable (margin only touches rows
    # that stay flagged)
    "max_rdiff_converged": round(float(jnp.max(jnp.abs(
        (rm.r - r0.r) * (rm.converged & r0.converged)[..., None]))), 8),
}

# --- 2. wgan step cost, margin 0 vs 2 -----------------------------------
def wgan_ms(margin):
    ssn = dataclasses.replace(cfg, backend="pallas",
                              check_every=32,
                              pallas_reopen_margin=margin)
    gen_cfg = GeneratorConfig(ssn=ssn, sample_sites=1, solver="ift")
    wcfg = wgan_lib.WGANConfig(gen=gen_cfg, batch_size=32, n_critic=5,
                               n_critic0=5)
    gp = gen_lib.init_params(gen_cfg, tuple(map(tuple, np.asarray(J))),
                             tuple(map(tuple, np.asarray(D))),
                             tuple(map(tuple, np.asarray(S))))
    state = wgan_lib.init_state(wcfg, gen_init=gp)
    real = 0.1 * jax.random.normal(
        jax.random.PRNGKey(0),
        (wcfg.n_critic, wcfg.critic_batch, gen_cfg.tc_dim)) + 1.0

    def run(reps):
        nonlocal state
        t0 = time.perf_counter()
        m = None
        for i in range(reps):
            state, m = wgan_lib.train_step(wcfg, wcfg.n_critic, state,
                                           real, jax.random.PRNGKey(i))
        _ = float(m.d_loss)
        return time.perf_counter() - t0

    run(1)
    samples = []
    for _ in range(3):
        t3, t9 = run(3), run(9)
        samples.append((t9 - t3) / 6 * 1e3)
    return round(sorted(samples)[1], 2), [round(s, 2) for s in samples]

m0, s0 = wgan_ms(0.0)
m2, s2 = wgan_ms(2.0)
out["wgan_step_ms"] = {"margin0": m0, "margin0_samples": s0,
                       "margin2": m2, "margin2_samples": s2}
print(json.dumps(out))
