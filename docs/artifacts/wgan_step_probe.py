#!/usr/bin/env python
"""Round-5 probe: time the bench's exact WGAN-GP step (IFT gradients,
Pallas forward) against the package code in CWD — run from different git
worktrees to bisect the r02 (22 ms) -> r03/r04 (36-37.5 ms) regression
with the bench methodology held fixed (marginal cost (t9-t3)/6, one sync).

VERDICT r4 weak #2 / next-round #3.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import jax
import numpy as np

from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.models import wgan as wgan_lib
from tcgan_tpu.models.generator import GeneratorConfig
from tcgan_tpu.ops.ssn import SSNConfig

cfg = SSNConfig(N=51, k=0.01, n=2.2, dt=0.0005, max_iter=8000, atol=1e-4)
J = np.array([[0.045, 0.040], [0.050, 0.035]], dtype=np.float32)
D = np.array([[0.10, 0.08], [0.10, 0.08]], dtype=np.float32)
S = np.array([[0.25, 0.10], [0.25, 0.10]], dtype=np.float32)

gen_cfg = GeneratorConfig(
    ssn=dataclasses.replace(cfg, backend="pallas", check_every=32),
    sample_sites=1, solver="ift",
)
wcfg = wgan_lib.WGANConfig(gen=gen_cfg, batch_size=32, n_critic=5,
                           n_critic0=5)
gp = gen_lib.init_params(gen_cfg, tuple(map(tuple, J)),
                         tuple(map(tuple, D)), tuple(map(tuple, S)))
state = wgan_lib.init_state(wcfg, gen_init=gp)
k = jax.random.PRNGKey(0)
real = 0.1 * jax.random.normal(
    k, (wcfg.n_critic, wcfg.critic_batch, gen_cfg.tc_dim)) + 1.0


def run(reps):
    global state
    t0 = time.perf_counter()
    m = None
    for i in range(reps):
        state, m = wgan_lib.train_step(wcfg, wcfg.n_critic, state,
                                       real, jax.random.PRNGKey(i))
    _ = float(m.d_loss)
    return time.perf_counter() - t0


run(1)  # compile
samples = []
for _ in range(3):
    t3, t9 = run(3), run(9)
    samples.append((t9 - t3) / 6 * 1e3)
print(json.dumps({"rev": os.environ.get("PROBE_REV", "cwd"),
                  "wgan_step_ms": sorted(samples)[1],
                  "samples_ms": [round(s, 2) for s in samples]}))
