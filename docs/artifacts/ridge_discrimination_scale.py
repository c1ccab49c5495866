"""Ridge discriminability vs truth-dataset size (round 3, follow-up to
ridge_discrimination.py).

That probe showed the rec13r ridge stall (J err 37%) is invisible to ANY
sample-trained critic at the reference-era dataset size (4096/side). The
witness-estimation floor scales ~sqrt(dim / M), so on an accelerator —
where truth samples cost far less than on a workstation core — the
dataset size is a free parameter. This probe measures held-out
discrimination accuracy vs M for two ridge displacements:

  - "stall": rec13r's endpoint (J +37% / D −8% / S 6%);
  - "mid":   halfway to truth in log-space (J ~ +17%) — the signal the
    critic must still see for a descending GAN to KEEP descending.

If accuracy rises clearly above chance at M ~ 10^5, a cWGAN with an
accelerator-scale `--truth-samples` has learnable witness signal all the way
down the ridge, and the GAN-recovery run is justified.

Usage: python docs/artifacts/ridge_discrimination_scale.py [--gen-only|--cpu]
  --gen-only: generate the sample sets (on the accelerator) and exit;
  --cpu:      force the CPU backend (probe training while the chip is
              busy with a science run; training is scan-fused so it does
              not pay per-step dispatch).
Writes: docs/artifacts/ridge_discrimination_scale.{npz,json}
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update(
    "jax_compilation_cache_dir", str(ROOT / ".jax_cache"))

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tcgan_tpu.models.generator import (GeneratorConfig, init_params,  # noqa: E402
                                        param_values, sample_tuning_curves)
from tcgan_tpu.ops.ssn import SSNConfig  # noqa: E402

TRUTH = dict(J=[[0.045, 0.040], [0.050, 0.035]],
             D=[[0.10, 0.08], [0.10, 0.08]],
             S=[[0.25, 0.10], [0.25, 0.10]])
STALL = dict(J=[[0.06110, 0.05260], [0.06677, 0.05179]],
             D=[[0.09152, 0.07437], [0.09245, 0.07381]],
             S=[[0.24247, 0.10947], [0.23742, 0.10719]])
M_MAX = 262144
GEN_BATCH = 4096
NPZ = pathlib.Path(__file__).with_name("ridge_discrimination_scale.npz")
OUT = pathlib.Path(__file__).with_name("ridge_discrimination_scale.json")


def mid_params():
    out = {}
    for k in ("J", "D", "S"):
        out[k] = np.exp(0.5 * (np.log(np.array(TRUTH[k]))
                               + np.log(np.array(STALL[k])))).tolist()
    return out


def make_cfg():
    return GeneratorConfig(
        ssn=SSNConfig(N=51, max_iter=8000, atol=1e-4, check_every=32),
        contrasts=(5.0, 10.0, 13.0), sample_sites=4,
        include_inhibitory_neurons=True, track_offset_identity=True,
        solver="ift")


def gen_side(cfg, params_dict, seed, n):
    p = init_params(cfg, **params_dict)
    f = jax.jit(lambda k: sample_tuning_curves(cfg, p, k, GEN_BATCH))
    tcs, k = [], jax.random.PRNGKey(seed)
    got = 0
    while got < n:
        k, sub = jax.random.split(k)
        out = f(sub)
        keep = np.asarray(out.converged.all(axis=-1))
        t = np.asarray(out.tc)[keep]
        tcs.append(t)
        got += t.shape[0]
    return np.concatenate(tcs)[:n]


def mlp_init(key, in_dim, widths=(512, 512)):
    ks = jax.random.split(key, len(widths) + 1)
    dims = (in_dim,) + widths + (1,)
    return [(jax.random.normal(ks[i], (dims[i], dims[i + 1]))
             * np.sqrt(2.0 / dims[i]), jnp.zeros(dims[i + 1]))
            for i in range(len(dims) - 1)]


def mlp_apply(params, x):
    for w, b in params[:-1]:
        x = jax.nn.relu(x @ w + b)
    w, b = params[-1]
    return (x @ w + b)[..., 0]


def train_probe(Xr, Xf, key, total_steps=6000, bs=512, lr=1e-3):
    """Held-out accuracy of a fresh MLP 512x512 probe on two sample sets.

    90/10 split; training draws random balanced minibatches (with
    replacement) for `total_steps` Adam steps — models the on-line budget
    a GAN critic gets, independent of M. The whole loop runs as ONE
    lax.fori_loop under jit (no per-step dispatch).
    """
    n = Xr.shape[0]
    n_tr = int(0.9 * n)
    Xtr = jnp.asarray(np.concatenate([Xr[:n_tr], Xf[:n_tr]]))
    ytr = jnp.asarray(np.concatenate([np.ones(n_tr), np.zeros(n_tr)]))
    Xte = jnp.asarray(np.concatenate([Xr[n_tr:], Xf[n_tr:]]))
    yte = np.concatenate([np.ones(n - n_tr), np.zeros(n - n_tr)])
    params = mlp_init(key, Xtr.shape[1])
    opt = optax.adam(lr)

    @jax.jit
    def train(params, key):
        ost = opt.init(params)

        def body(i, carry):
            params, ost = carry
            idx = jax.random.randint(
                jax.random.fold_in(key, i), (bs,), 0, Xtr.shape[0])
            xb, yb = Xtr[idx], ytr[idx]

            def loss(p):
                return optax.sigmoid_binary_cross_entropy(
                    mlp_apply(p, xb), yb).mean()

            g = jax.grad(loss)(params)
            up, ost = opt.update(g, ost)
            return optax.apply_updates(params, up), ost

        params, _ = jax.lax.fori_loop(0, total_steps, body, (params, ost))
        return params

    params = train(params, key)
    s = np.asarray(jax.jit(mlp_apply)(params, Xte))
    acc = float(((s > 0) == (yte > 0.5)).mean())
    sep = float((s[yte > 0.5].mean() - s[yte < 0.5].mean())
                / (s.std() + 1e-12))
    return acc, sep


def main():
    if not NPZ.exists():
        cfg = make_cfg()
        t0 = time.perf_counter()
        sides = {"truth": gen_side(cfg, TRUTH, 0, M_MAX),
                 "stall": gen_side(cfg, STALL, 1, M_MAX),
                 "mid": gen_side(cfg, mid_params(), 2, M_MAX)}
        print(f"generated 3x{M_MAX} converged circuits in "
              f"{time.perf_counter() - t0:.0f}s on {jax.default_backend()}",
              flush=True)
        np.savez(NPZ, **{k: v.astype(np.float16) for k, v in sides.items()})
    if "--gen-only" in sys.argv:
        return
    d = np.load(NPZ)
    sides = {k: d[k].astype(np.float32) for k in ("truth", "stall", "mid")}

    jscale = 1.0 / (np.concatenate([sides["truth"], sides["stall"]])
                    .std(axis=0) + 1e-6)
    S_COND, P = 24, 8
    cscale = 1.0 / (np.concatenate([sides["truth"], sides["stall"]])
                    .reshape(-1, S_COND, P).std(axis=0) + 1e-6)
    feats = np.zeros((S_COND, 2), np.float32)
    feats[:, 0] = np.tile(
        np.array([0, .0625, .125, .1875, .25, .5, .75, 1.]), 3)
    feats[:, 1] = np.repeat(np.array([5., 10., 13.]) / 20.0, 8)

    def rows(X):
        # (M, 192) -> (M * 24, 10): per-condition probe block (std-
        # normalized per condition, rec13r's --normalize-per-condition)
        # + 2 condition-tag features — the cWGAN critic's exact input.
        t = X.reshape(-1, S_COND, P) * cscale
        tagged = np.concatenate(
            [t, np.broadcast_to(feats, t.shape[:1] + feats.shape)], -1)
        return tagged.reshape(-1, S_COND * (P + 2)).reshape(-1, P + 2)

    decision_first = "--decision-first" in sys.argv
    cells = []
    for disp in ("stall", "mid"):
        for m in (M_MAX, 65536, 16384, 4096) if decision_first \
                else (4096, 16384, 65536, M_MAX):
            cells.append((disp, m))
    results = {}
    for disp, m in cells:
        for fam in ("joint", "row"):
            accs, seps = [], []
            n_seeds = 1 if fam == "row" else 3
            for seed in range(n_seeds):
                if fam == "joint":
                    Xr = sides["truth"][:m] * jscale
                    Xf = sides[disp][:m] * jscale
                    steps = 6000
                else:
                    Xr, Xf = rows(sides["truth"][:m]), rows(sides[disp][:m])
                    steps = 12000
                acc, sep = train_probe(
                    Xr, Xf, jax.random.PRNGKey(1000 * seed + m),
                    total_steps=steps)
                accs.append(acc)
                seps.append(sep)
            results[f"{fam}_{disp}_m{m}"] = {
                "acc": round(float(np.mean(accs)), 4),
                "acc_seeds": [round(a, 4) for a in accs],
                "sep": round(float(np.mean(seps)), 3)}
            print(fam, disp, m, results[f"{fam}_{disp}_m{m}"], flush=True)
            OUT.write_text(json.dumps(results, indent=2))

    print(json.dumps(results))


if __name__ == "__main__":
    main()
