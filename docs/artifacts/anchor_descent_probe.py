"""Anchor-only descent probe: pick the phase-2 (lr, gamma, b1) for D.

Context (round 4, runs/rec13anchor3 @ ~36k steps): J has recovered to
~7% but D is flat at ~25.5%.  anchor_d_probe.json proved the witness
still demands D (J-corrected residual 35x the truth level), so the
stall is optimization, not information.  The mechanism: the anchor's
Adam drifts at lr x SNR per step, and D's per-step gradient SNR is
~100x smaller than J's (the coupled J/D valley + gamma=0.9's 20x-noisier
EMA, the round-3 limit-cycle fix that rescued J).  mm13fix (lr 1e-3,
gamma 0.995) descended D at ~0.2%/1k steps — 92k more steps at that
pace, which does not fit the remaining chip window.

This probe runs ANCHOR-ONLY Adam (no adversarial updates — at the
decayed gen lr 1.25e-5 the adversarial force is negligible anyway)
from the live endpoint, with the EXACT anchor_loss semantics
(survivor-chain mask, straight-through debiased EMA, whitened joint
moments), for a grid of (lr, gamma, b1), and measures the D-error
descent rate.  The winner sets the flagship's phase-2 recipe.

Run one config per process (CPU, JAX_PLATFORMS=cpu) while the chip
trains:  for cfg in "2e-3 0.9 0.5" "1e-2 0.98 0.5" ...; do
  JAX_PLATFORMS=cpu python docs/artifacts/anchor_descent_probe.py \
      --lr ... --gamma ... --b1 ... --out ...json &
done
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="runs/rec13anchor3")
    ap.add_argument("--lr", type=float, required=True)
    ap.add_argument("--gamma", type=float, required=True)
    ap.add_argument("--b1", type=float, default=0.5)
    ap.add_argument("--b2", type=float, default=0.9)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--record-every", type=int, default=10)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from tcgan_tpu.models import generator as gen_lib
    from tcgan_tpu.models.moments import (data_moments as batch_moments,
                                          survivor_chain)
    from tcgan_tpu.run import common

    info = json.load(open(f"{args.run}/info.json"))["config"]
    cfg_args = SimpleNamespace(**info)
    gen_cfg = common.generator_config_from_args(cfg_args, solver="ift")

    import csv
    rows = list(csv.reader(open(f"{args.run}/generator.csv")))
    data = np.array(rows[1:], dtype=float)
    data = data[np.argsort(data[:, 0])]
    last = data[-1]
    step_now = int(last[0])
    params = {k: jnp.asarray(np.log(last[1 + 4 * i:5 + 4 * i].reshape(2, 2)))
              for i, k in enumerate(("J", "D", "S"))}
    truth = {k: np.array(info[f"true_{k}"], dtype=float).reshape(2, 2)
             for k in ("J", "D", "S")}

    # frozen data moments from the live checkpoint (identical witness)
    from tcgan_tpu.train.checkpoint import CheckpointManager
    raw = CheckpointManager(f"{args.run}/ckpt").load_tree()
    data_mean = jnp.asarray(raw["data_mean"])
    data_second = jnp.asarray(raw["data_second"])
    eps = 1e-2
    wm = 1.0 / (jnp.abs(data_mean) + eps) ** 2
    wc = 1.0 / (jnp.abs(data_second) + eps) ** 2

    g = args.gamma
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(args.lr, b1=args.b1, b2=args.b2))
    opt_state = tx.init(params)
    ema_m = data_mean * 0.0
    ema_s = data_second * 0.0
    count = jnp.zeros(())

    def loss_fn(p, key, ema_m, ema_s, count):
        out = gen_lib.sample_tuning_curves(gen_cfg, p, key, args.batch)
        tc = out.tc.reshape(-1, out.tc.shape[-1])
        w = survivor_chain(out.converged, tc.dtype)
        if tc.shape[0] != w.shape[0]:
            w = jnp.repeat(w, tc.shape[0] // w.shape[0])
        sg = jax.lax.stop_gradient
        bmean, bsecond = batch_moments(tc, w)
        has_data = jnp.sum(w) > 0
        new_em = jnp.where(has_data, g * sg(ema_m) + (1 - g) * sg(bmean),
                           sg(ema_m))
        new_es = jnp.where(has_data, g * sg(ema_s) + (1 - g) * sg(bsecond),
                           sg(ema_s))
        new_count = count + has_data.astype(bmean.dtype)
        debias = jnp.maximum(1.0 - g ** new_count, 1e-12)
        m_mean = sg(new_em / debias) + bmean - sg(bmean)
        m_second = sg(new_es / debias) + bsecond - sg(bsecond)
        me = jnp.mean(wm * (m_mean - data_mean) ** 2)
        ce = jnp.mean(wc * (m_second - data_second) ** 2)
        return me + ce, (new_em, new_es, new_count)

    @jax.jit
    def step(p, opt_state, key, ema_m, ema_s, count):
        (loss, (em, es, c)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, key, ema_m, ema_s, count)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, loss, em, es, c

    def errs(p):
        return {k: float(np.mean(np.abs(np.exp(np.asarray(p[k])) - truth[k])
                                 / truth[k])) * 100 for k in ("J", "D", "S")}

    key = jax.random.PRNGKey(1234)
    traj = [{"step": 0, **errs(params), "residual": None}]
    print(f"lr={args.lr} gamma={g} b1={args.b1}: start "
          f"J {traj[0]['J']:.1f}% D {traj[0]['D']:.1f}%", flush=True)
    for i in range(args.steps):
        params, opt_state, loss, ema_m, ema_s, count = step(
            params, opt_state, jax.random.fold_in(key, i),
            ema_m, ema_s, count)
        if (i + 1) % args.record_every == 0:
            e = errs(params)
            traj.append({"step": i + 1, **e, "residual": float(loss)})
            print(f"  step {i+1:4d}: J {e['J']:5.1f}% D {e['D']:5.1f}% "
                  f"S {e['S']:5.1f}% res {float(loss):.2e}", flush=True)

    d0, d1 = traj[0]["D"], traj[-1]["D"]
    rate = (d0 - d1) / args.steps * 1000.0
    result = {
        "run": args.run, "step_now": step_now, "lr": args.lr,
        "gamma": g, "b1": args.b1, "b2": args.b2, "batch": args.batch,
        "steps": args.steps, "D_start": d0, "D_end": d1,
        "J_end": traj[-1]["J"], "S_end": traj[-1]["S"],
        "D_rate_pct_per_1k": rate,
        "steps_to_D7_est": (None if rate <= 0
                            else int((d1 - 7.0) / rate * 1000)
                            if d1 > 7.0 else 0),
        "traj": traj,
    }
    json.dump(result, open(args.out, "w"), indent=1)
    print(f"D rate {rate:+.2f}%/1k steps -> wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
