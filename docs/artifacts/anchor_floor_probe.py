"""Anchor-witness stall diagnosis for runs/rec13anchor2 (VERDICT r3 #2).

Question: at the flagship's stall point (J ~25.6%, D ~26.7% off truth,
logged anchor_residual ~2.7e-5), does the joint-layout EMA-moment witness
still carry signal toward truth — or is 2.7e-5 already its noise floor?

Measured quantities (all in the anchor's own whitened metric,
wm = 1/(|data_mean|+eps)^2 etc., the exact formula of
models/wgan.py:anchor_loss):

  res(t)    anchor residual vs the run's data moments at interpolated
            params theta_t = (1-t) log theta_now + t log theta_truth,
            estimated from N fresh survivor-selected samples
  d_signal  whitened moment-space distance between theta_now and
            theta_truth draws — the displacement the anchor must resolve
  d_noise   same metric between two INDEPENDENT draws at the same point —
            pure sampling noise at this probe's N; scales ~1/N, so
            noise at the run's EMA (eff. N ~ batch*(1+g)/(1-g) ~ 102k)
            and at the data moments' N=4096 follow by rescaling

Verdict logic: the anchor can keep descending only if
  d_signal >> d_noise * (N_probe/102k)   [EMA floor]  AND
  d_signal >> d_noise * (N_probe/4096)   [data-moment finite-sample error]
If d_signal is at or below the data-moment error, NO anchor lr can close
the gap: the 4096-sample data moments themselves cannot localize truth
any tighter (an information limit of the witness+data budget, the
anchor-layout analog of BASELINE.md's ridge_discrimination probes).

CPU-safe (run with JAX_PLATFORMS=cpu while the chip is busy).
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="runs/rec13anchor2")
    ap.add_argument("--samples", type=int, default=2048,
                    help="circuits per probe point (survivor-selected)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default="docs/artifacts/anchor_floor_probe.json")
    ap.add_argument("--ts", type=float, nargs="+",
                    default=[0.0, 0.25, 0.5, 0.75, 1.0])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tcgan_tpu.models import generator as gen_lib
    from tcgan_tpu.models.moments import survivor_chain
    from tcgan_tpu.run import common

    info = json.load(open(f"{args.run}/info.json"))["config"]
    cfg_args = SimpleNamespace(**info)
    gen_cfg = common.generator_config_from_args(cfg_args, solver="ift")

    # Current point: last generator.csv row (fresher than the checkpoint).
    import csv
    rows = list(csv.reader(open(f"{args.run}/generator.csv")))
    last = np.array(rows[-1], dtype=float)
    step_now = int(last[0])
    now = {k: np.log(last[1 + 4 * i:5 + 4 * i].reshape(2, 2))
           for i, k in enumerate(("J", "D", "S"))}
    truth = {k: np.log(np.array(info[f"true_{k}"], dtype=float).reshape(2, 2))
             for k in ("J", "D", "S")}

    # The run's own data moments: read them out of the latest checkpoint
    # (state.data_mean/data_second — exact, and avoids regenerating the
    # 4096-sample truth set on CPU, which is minutes of solver time).
    from tcgan_tpu.train.checkpoint import CheckpointManager
    raw = CheckpointManager(f"{args.run}/ckpt").load_tree()
    data_mean = np.asarray(raw["data_mean"])
    data_second = np.asarray(raw["data_second"])
    ema_mean = np.asarray(raw["mom_ema_mean"])
    ema_second = np.asarray(raw["mom_ema_second"])
    ema_count = float(np.asarray(raw["mom_ema_count"]))
    eps = 1e-2
    wm = 1.0 / (np.abs(data_mean) + eps) ** 2
    wc = 1.0 / (np.abs(data_second) + eps) ** 2

    def wdist(m1, s1, m2, s2):
        return float(np.mean(wm * (m1 - m2) ** 2)
                     + np.mean(wc * (s1 - s2) ** 2))

    @jax.jit
    def batch_sums(params, key):
        out = gen_lib.sample_tuning_curves(gen_cfg, params, key, args.batch)
        tc = out.tc.reshape(-1, out.tc.shape[-1])
        w = survivor_chain(out.converged, tc.dtype)
        if tc.shape[0] != w.shape[0]:
            w = jnp.repeat(w, tc.shape[0] // w.shape[0])
        return ((tc * w[:, None]).sum(0), (tc * w[:, None]).T @ tc,
                w.sum())

    def moments_at(params, seed):
        params = {k: jnp.asarray(v) for k, v in params.items()}
        key = jax.random.PRNGKey(seed)
        sm = np.zeros_like(data_mean)
        ss = np.zeros_like(data_second)
        sw = 0.0
        n_batches = max(1, args.samples // args.batch)
        for i in range(n_batches):
            m, s, w = batch_sums(params, jax.random.fold_in(key, i))
            sm += np.asarray(m)
            ss += np.asarray(s)
            sw += float(w)
        return sm / sw, ss / sw, sw

    def interp(t):
        return {k: (1 - t) * now[k] + t * truth[k] for k in now}

    result = {
        "run": args.run, "step_now": step_now,
        "samples_per_point": args.samples,
        "eps": eps,
        "ema_gamma": info["anchor_ema"],
        "batch": info["batch_size"],
        # EMA of batch-mean with decay g: var ratio (1-g)/(1+g) vs one batch
        "ema_effective_n": info["batch_size"]
        * (1 + info["anchor_ema"]) / (1 - info["anchor_ema"]),
        "data_samples": info["truth_samples"],
        "ckpt_ema_count": ema_count,
        # cross-check: the debiased checkpoint EMA's residual should match
        # the learning.jsonl anchor_residual stream at the checkpoint step
        "ckpt_ema_residual": None,
        "points": [],
    }
    g = info["anchor_ema"]
    debias = max(1.0 - g ** ema_count, 1e-12)
    result["ckpt_ema_residual"] = wdist(ema_mean / debias,
                                        ema_second / debias,
                                        data_mean, data_second)

    draws = {}
    for t in args.ts:
        m, s, w = moments_at(interp(t), seed=1000 + int(t * 100))
        draws[t] = (m, s)
        res = wdist(m, s, data_mean, data_second)
        result["points"].append(
            {"t": t, "res_vs_data": res, "survivor_mass": w})
        print(f"t={t:.2f}  res_vs_data={res:.3e}  survivors={w:.0f}",
              flush=True)

    # Independent second draws at the endpoints -> sampling-noise floor.
    m0b, s0b, _ = moments_at(interp(0.0), seed=7001)
    m1b, s1b, _ = moments_at(interp(1.0), seed=7002)
    d_noise_now = wdist(*draws[0.0], m0b, s0b)
    d_noise_truth = wdist(*draws[1.0], m1b, s1b)
    d_signal = wdist(*draws[0.0], *draws[1.0])
    n_probe = args.samples
    # two independent N-sample draws differ by ~2x the per-draw variance
    per_draw_noise = 0.5 * (d_noise_now + d_noise_truth) / 2
    ema_floor = per_draw_noise * n_probe / result["ema_effective_n"]
    data_err = per_draw_noise * n_probe / result["data_samples"]
    result.update({
        "d_signal_now_vs_truth": d_signal,
        "d_noise_between_draws_now": d_noise_now,
        "d_noise_between_draws_truth": d_noise_truth,
        "per_draw_noise": per_draw_noise,
        "ema_floor_est": ema_floor,
        "data_moment_err_est": data_err,
        "signal_over_ema_floor": d_signal / max(ema_floor, 1e-30),
        "signal_over_data_err": d_signal / max(data_err, 1e-30),
    })
    verdict = ("SIGNAL: the anchor witness still separates now from truth "
               "well above both floors - the stall is an "
               "equilibrium/learning-rate problem, not an information limit"
               if d_signal > 10 * max(ema_floor, data_err) else
               "MARGINAL: signal within 10x of a floor - raising anchor lr "
               "may help but the endgame will be noise-limited"
               if d_signal > max(ema_floor, data_err) else
               "STARVED: the remaining displacement is below the witness "
               "noise/data floor - no anchor lr can close it with this "
               "data budget and moment map")
    result["verdict"] = verdict
    print(verdict)
    json.dump(result, open(args.out, "w"), indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
