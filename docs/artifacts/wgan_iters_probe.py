#!/usr/bin/env python
"""Round-5 follow-up to wgan_step_probe: per-step solver iteration +
convergence trace for the bench's exact WGAN config, to test whether the
r02 (22 ms) -> r03/HEAD (53 ms median, GROWING 36->57 across sample
blocks) regression is "the trained params wander into a harder solve
region faster at r03+" vs "the compiled step itself got slower".
Run from a worktree: PROBE_REV=r02 python .../wgan_iters_probe.py
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

trace = []
for i in range(37):
    t0 = time.perf_counter()
    state, m = wgan_lib.train_step(wcfg, wcfg.n_critic, state,
                                   real, jax.random.PRNGKey(i))
    it = float(m.mean_iters)
    dt_ms = (time.perf_counter() - t0) * 1e3
    trace.append({"step": i, "ms": round(dt_ms, 1),
                  "mean_iters": round(it, 1),
                  "fconv": round(float(m.frac_converged), 3)})
print(json.dumps({"rev": os.environ.get("PROBE_REV", "cwd"),
                  "trace": trace}))
