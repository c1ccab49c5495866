"""Force-balance probe at a hybrid run's endpoint: what error does the
anchor/critic equilibrium predict, per parameter coordinate?

Context (round 4c, runs/rec13anchor4): with the K=8 composed-Adam anchor
the flagship descends J and D together, but J's slope flattens around
8-9% while mm13fix (pure moment matching, same per-update dynamics)
reached 1.7%. Hypothesis: the hybrid's endpoint is a FORCE BALANCE —
each GAN step composes one adversarial Adam update (lr_gen, decayed)
with K anchor Adam updates (lr_anchor), and Adam normalizes each
objective's gradient scale away, so the per-coordinate drift is

    drift ~= lr * SNR,   SNR = |E[g]| / sqrt(E[g]^2 + Var[g])

(the normalized-gradient magnitude; saturates at 1 for noiseless
coordinates). The equilibrium sits where the anchor's toward-truth
drift equals the adversarial push, NOT at the anchor's own optimum —
so the remaining error should be predictable from the two SNR profiles,
and the lever ratio (K * lr_anchor vs lr_gen_decayed) says how much a
bigger K buys.

Measures, at the latest checkpoint (all state restored — generator,
critic, frozen data moments; critic input scale rebuilt from the data
moments exactly as run/common.critic_input_scales does for mode=std):

  g_adv    = grad_theta [ -E_w[critic(tc)] + rate_cost * pen ]   (gen_loss_fn)
  g_anchor = grad_theta [ whitened fresh-draw moment residual ]  (anchor witness)

over --batches independent batches of the run's own batch size, and
reports per log-coordinate: displacement to truth, each force's SNR,
signed toward-truth drift per 1k GAN steps (lr_gen decayed to the
endpoint step; anchor scaled by K), and the net.

CPU-safe (forces jax_platforms=cpu) — run while the chip does real work.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="runs/rec13anchor4")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--step", type=int, default=0,
                    help="probe THIS checkpoint step instead of the "
                         "latest (round-5 adversarial-tax scan: floor ~ "
                         "lr_g at pre-cooling checkpoints, ROUND5 §3)")
    ap.add_argument("--out",
                    default="docs/artifacts/anchor_equilibrium_probe.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tcgan_tpu.models import critic as critic_lib
    from tcgan_tpu.models import generator as gen_lib
    from tcgan_tpu.models.moments import data_moments as batch_moments
    from tcgan_tpu.models.moments import survivor_chain
    from tcgan_tpu.models.wgan import WGANConfig, fake_sample_weights
    from tcgan_tpu.run import common
    from tcgan_tpu.train.checkpoint import CheckpointManager

    info = json.load(open(f"{args.run}/info.json"))["config"]
    # XLA solver: the run's Pallas kernel is compiled for the GPU only;
    # kernel-vs-XLA parity at the same atol is checked by chip_smoke.py,
    # so the gradients are the same.
    gen_cfg = common.generator_config_from_args(
        SimpleNamespace(**{**info, "solver_backend": "xla"}),
        solver="ift")

    # --- full endpoint state from the latest checkpoint ---
    mgr = CheckpointManager(Path(f"{args.run}/ckpt"))
    steps_avail = mgr.steps()
    if args.step > 0:
        if args.step not in steps_avail:
            raise SystemExit(f"--step {args.step} not in checkpoints "
                             f"{steps_avail}")
        latest = args.step
    else:
        latest = steps_avail[-1]
    raw = mgr.load_tree(latest)
    gen_params = {k: jnp.asarray(raw["gen_params"][k]) for k in "JDS"}
    critic_params = {k: jnp.asarray(v)
                     for k, v in raw["critic_params"].items()}
    data_mean = jnp.asarray(raw["data_mean"])
    data_second = jnp.asarray(raw["data_second"])
    step = int(np.asarray(raw["step"]))

    # Critic input scale, rebuilt from the frozen data moments exactly as
    # run/common.critic_input_scales (mode=std) computed it from the
    # dataset: std = sqrt(diag(E[xx^T]) - mean^2), floored at 5% of the
    # mean |TC| (TCs are nonnegative, so E|x| = E[x]).
    assert info.get("normalize_input_mode") == "std", info.get(
        "normalize_input_mode")
    var = np.maximum(np.diag(np.asarray(data_second))
                     - np.asarray(data_mean) ** 2, 0.0)
    floor = 0.05 * float(np.asarray(data_mean).mean())
    input_scale = tuple(
        float(s) for s in 1.0 / np.maximum(np.sqrt(var),
                                           max(floor, 1e-6)))

    cfg = WGANConfig(
        gen=gen_cfg,
        critic_layers=tuple(info["disc_layers"]),
        input_scale=input_scale,
        batch_size=int(info["batch_size"]),
        rate_cost=float(info["rate_cost"]),
        reject_unconverged=bool(info.get("reject_unconverged", False)),
    )
    eps = 1e-2
    wm = 1.0 / (jnp.abs(data_mean) + eps) ** 2
    wc = 1.0 / (jnp.abs(data_second) + eps) ** 2

    def adv_loss(params, key):
        out = gen_lib.sample_tuning_curves(cfg.gen, params, key,
                                           cfg.batch_size)
        d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, out.tc)
        w = fake_sample_weights(cfg, out)
        pen = gen_lib.rate_penalty(cfg.gen, out.rates)
        return (-jnp.sum(d_fake * w) / jnp.maximum(jnp.sum(w), 1e-12)
                + cfg.rate_cost * pen)

    def anchor_loss_fresh(params, key):
        out = gen_lib.sample_tuning_curves(cfg.gen, params, key,
                                           cfg.batch_size)
        tc = out.tc.reshape(-1, out.tc.shape[-1])
        ok = survivor_chain(out.converged, tc.dtype)
        if tc.shape[0] != ok.shape[0]:
            ok = jnp.repeat(ok, tc.shape[0] // ok.shape[0])
        bmean, bsecond = batch_moments(tc, ok)
        return (jnp.mean(wm * (bmean - data_mean) ** 2)
                + jnp.mean(wc * (bsecond - data_second) ** 2))

    g_adv_fn = jax.jit(jax.grad(adv_loss))
    g_anc_fn = jax.jit(jax.grad(anchor_loss_fresh))

    key = jax.random.PRNGKey(4242)
    g_adv, g_anc = [], []
    for i in range(args.batches):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        g_adv.append(jax.tree.map(np.asarray, g_adv_fn(gen_params, k1)))
        g_anc.append(jax.tree.map(np.asarray, g_anc_fn(gen_params, k2)))
        print(f"batch {i + 1}/{args.batches} done", flush=True)

    truth = {k: np.log(np.asarray(info[f"true_{k}"],
                                  dtype=float).reshape(2, 2))
             for k in "JDS"}
    # effective adversarial lr at the endpoint step (exponential decay)
    lr_gen = float(info["lr_gen"]) * (
        float(info.get("lr_decay_rate", 0.5))
        ** (step / info["lr_decay_steps"])
        if info.get("lr_decay_steps", 0) > 0 else 1.0)
    # Endgame-latch awareness (round 5): if the checkpoint carries a
    # LATCHED endgame flag, the adversarial update is scaled so its
    # effective lr is gen_lr_floor — the schedule value above is then the
    # COUNTERFACTUAL hot lr, and the actual adversarial drift is
    # floor/schedule times the reported one.
    endgame = bool(np.asarray(raw["endgame"])) if "endgame" in raw else None
    lr_floor = float(info.get("gen_lr_floor", 0.0))
    lr_gen_actual = (lr_floor if (endgame and lr_floor > 0
                                  and lr_floor < lr_gen)
                     else lr_gen)
    k_updates = int(info.get("anchor_updates", 1))
    lr_anchor = float(info.get("moment_anchor", 0.0))

    def stats(gs, k, i, j):
        v = np.array([g[k][i, j] for g in gs])
        mean, sd = float(v.mean()), float(v.std())
        snr = abs(mean) / max(np.sqrt(mean ** 2 + sd ** 2), 1e-30)
        return mean, sd, snr

    result = {"run": args.run, "ckpt_step": step, "batches": args.batches,
              "batch_size": cfg.batch_size, "lr_gen_eff": lr_gen,
              "endgame_latched": endgame,
              "lr_gen_actual": lr_gen_actual,
              "note": ("coords[].adv uses the SCHEDULED lr (lr_gen_eff); "
                       "with endgame_latched the realized adversarial "
                       "drift is (lr_gen_actual/lr_gen_eff) x that — the "
                       "scheduled number is the counterfactual hot arm"),
              "k_anchor_updates": k_updates, "lr_anchor": lr_anchor,
              "coords": {}}
    hdr = (f"{'coord':6s} {'d_truth':>8s} | {'adv snr':>8s} "
           f"{'adv->truth/1k':>13s} | {'anc snr':>8s} "
           f"{'anc->truth/1k':>13s} | {'net/1k':>8s}")
    print(f"\nckpt step {step}: lr_gen_eff {lr_gen:.2e}, "
          f"anchor {lr_anchor:.0e} x K={k_updates}\n{hdr}")
    for blk in "JDS":
        for i in range(2):
            for j in range(2):
                name = f"{blk}_{'EI'[i]}{'EI'[j]}"
                # gen_params are trained in LOG space (see
                # models/generator.py); truth is logged above to match
                d = float(truth[blk][i, j]
                          - np.asarray(gen_params[blk])[i, j])
                sgn = np.sign(d) if d != 0 else 1.0
                am, asd, asnr = stats(g_adv, blk, i, j)
                nm, nsd, nsnr = stats(g_anc, blk, i, j)
                # gradient DESCENT drift per 1k steps, signed toward truth
                adv1k = 1000 * lr_gen * asnr * np.sign(-am) * sgn
                anc1k = 1000 * k_updates * lr_anchor * nsnr \
                    * np.sign(-nm) * sgn
                result["coords"][name] = {
                    "dlog_to_truth": d,
                    "adv": {"mean": am, "std": asd, "snr": asnr,
                            "toward_truth_per_1k": float(adv1k)},
                    "anchor": {"mean": nm, "std": nsd, "snr": nsnr,
                               "toward_truth_per_1k": float(anc1k)},
                    "net_toward_truth_per_1k": float(adv1k + anc1k),
                }
                print(f"{name:6s} {d:+8.4f} | {asnr:8.3f} {adv1k:+13.5f} "
                      f"| {nsnr:8.3f} {anc1k:+13.5f} "
                      f"| {adv1k + anc1k:+8.5f}", flush=True)

    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
