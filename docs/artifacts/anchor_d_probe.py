"""Axis-decomposed anchor-witness probe: can the anchor see D at all?

Context (round 4, runs/rec13anchor3): after the anchor-EMA fix
(gamma 0.995 -> 0.9, see anchor_floor_probe.json) J error descends
steadily (25.9% -> 18.3% over 6k steps) but D is FLAT at ~26% below
truth for the same 6k steps.  Two hypotheses:

  (A) conditional optimum: at the current J, the anchor residual's
      gradient w.r.t. D is ~0 (moving D alone toward truth would RAISE
      the residual because J and D are coupled along the ridge).  D then
      tracks J quasi-statically and will move once J is close - patience
      works, pace set by J.
  (B) D-starved witness: fixing J alone already drives the residual to
      its floor - the joint-layout moment map cannot see the remaining
      D displacement, so no anchor lr and no amount of time recovers D.

Decides by measuring the fresh-draw whitened residual (exact
models/wgan.py:anchor_loss metric, same machinery as
anchor_floor_probe.py) at four corners in log-param space:

  now            current generator.csv endpoint
  truth          the run's --true-J/D/S
  J-corrected    J=truth, D,S=now
  D-corrected    D=truth, J,S=now

Readout:
  res(J-corrected) ~ res(truth) << res(now)      -> (B) D-starved
  res(J-corrected) >> res(truth)                 -> (A) witness still
                                                    demands D movement
  res(D-corrected) > res(now)                    -> confirms J-D coupling
                                                    (moving D alone hurts)

CPU-safe (JAX_PLATFORMS=cpu) - run while the chip trains the flagship.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="runs/rec13anchor3")
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default="docs/artifacts/anchor_d_probe.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tcgan_tpu.models import generator as gen_lib
    from tcgan_tpu.models.moments import survivor_chain
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
    now = {k: np.log(last[1 + 4 * i:5 + 4 * i].reshape(2, 2))
           for i, k in enumerate(("J", "D", "S"))}
    truth = {k: np.log(np.array(info[f"true_{k}"], dtype=float).reshape(2, 2))
             for k in ("J", "D", "S")}

    from tcgan_tpu.train.checkpoint import CheckpointManager
    raw = CheckpointManager(f"{args.run}/ckpt").load_tree()
    data_mean = np.asarray(raw["data_mean"])
    data_second = np.asarray(raw["data_second"])
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
        for i in range(max(1, args.samples // args.batch)):
            m, s, w = batch_sums(params, jax.random.fold_in(key, i))
            sm += np.asarray(m)
            ss += np.asarray(s)
            sw += float(w)
        return sm / sw, ss / sw, sw

    corners = {
        "now": now,
        "truth": truth,
        "J_corrected": {"J": truth["J"], "D": now["D"], "S": now["S"]},
        "D_corrected": {"J": now["J"], "D": truth["D"], "S": now["S"]},
    }
    result = {"run": args.run, "step_now": step_now,
              "samples_per_point": args.samples, "eps": eps,
              "corners": {}}
    draws = {}
    for name, p in corners.items():
        m, s, w = moments_at(p, seed=hash(name) % 10_000)
        draws[name] = (m, s)
        res = wdist(m, s, data_mean, data_second)
        result["corners"][name] = {"res_vs_data": res, "survivor_mass": w}
        print(f"{name:14s} res_vs_data={res:.3e} survivors={w:.0f}",
              flush=True)

    # noise floor: two independent draws at 'now'
    m2, s2, _ = moments_at(corners["now"], seed=7777)
    noise = wdist(*draws["now"], m2, s2)
    result["d_noise_between_draws_now"] = noise
    per_draw = noise / 2
    result["per_draw_noise"] = per_draw
    ema_eff_n = info["batch_size"] * (1 + info["anchor_ema"]) / (
        1 - info["anchor_ema"])
    result["ema_floor_est"] = per_draw * args.samples / ema_eff_n
    result["data_moment_err_est"] = per_draw * args.samples / info[
        "truth_samples"]

    rn = result["corners"]["now"]["res_vs_data"]
    rt = result["corners"]["truth"]["res_vs_data"]
    rj = result["corners"]["J_corrected"]["res_vs_data"]
    rd = result["corners"]["D_corrected"]["res_vs_data"]
    floor = max(result["ema_floor_est"], result["data_moment_err_est"])
    if rj <= max(rt * 3, 3 * floor):
        verdict = ("D-STARVED: correcting J alone already drives the "
                   "residual to the truth/noise level - the joint moment "
                   "witness cannot see the remaining D displacement; the "
                   "anchor will never move D from here")
    elif rj > 10 * max(rt, floor):
        verdict = ("D-DEMANDED: with J corrected the residual stays well "
                   "above the truth level - the witness still requires D "
                   "to move; flat D is a conditional-optimum/force-balance "
                   "effect, not starvation")
    else:
        verdict = "MARGINAL: J-corrected residual within 10x of floor"
    result["coupling_confirmed"] = bool(rd > rn)
    result["verdict"] = verdict
    print(f"coupling (D-only move hurts): {result['coupling_confirmed']}")
    print(verdict)
    json.dump(result, open(args.out, "w"), indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
