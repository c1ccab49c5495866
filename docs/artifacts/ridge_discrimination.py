"""Static ridge-discrimination probe (round 3, VERDICT r2 #1 diagnosis).

Question: rec13r's cWGAN critic sits at CHANCE (d_accuracy 0.50, W1 0.03)
while the generator is ridge-displaced at J err ~37% — is that

  (a) an information limit of the cWGAN's critic INPUT (each row is one
      stim condition's n_probe=8 values + 2 condition tags = 10 dims; the
      cross-condition joint structure of a circuit is never seen), or
  (b) an optimization/adversarial-dynamics failure (a critic trained on
      FIXED distributions would separate them)?

Method: freeze two generators — truth (J,D,S)* and rec13r's current
ridge-displaced point — sample fully-converged circuits from each, and
train fresh binary probes on the two STATIC sample sets:

  - "joint"  probe: full per-circuit vector (n_stim*n_probe = 192 dims),
    i.e. the plain WGAN critic's input (track_offset_identity layout);
  - "row"    probe: per-condition tagged rows (10 dims), i.e. the cWGAN
    critic's input, with the same per-condition std normalization rec13r
    used; row scores are also AGGREGATED per circuit (mean over the
    circuit's 24 rows) to measure the best case for a row critic;
  - "linear" probe on the joint vector (logistic regression) as a
    capacity-free reference.

Each probe reports held-out accuracy vs training-set size per side.
Decision rule: if the joint probe separates at sizes the row probe does
not, the cWGAN marginal-row input is the binding constraint and the
unconditional WGAN (full-battery critic) is the right estimator for the
near-critical battery; if nothing separates at 4k samples, the ridge
displacement is simply below the battery's practical resolution at GAN
batch sizes (consistent with mm needing ~256k EMA-effective samples).

Usage:  python docs/artifacts/ridge_discrimination.py [--gen-only|--cpu]
Writes: docs/artifacts/ridge_discrimination.{npz,json}
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TRUTH = dict(J=[[0.045, 0.040], [0.050, 0.035]],
             D=[[0.10, 0.08], [0.10, 0.08]],
             S=[[0.25, 0.10], [0.25, 0.10]])
# rec13r generator.csv step 11945 (ridge-displaced stall point).
DISPLACED = dict(J=[[0.06110, 0.05260], [0.06677, 0.05179]],
                 D=[[0.09152, 0.07437], [0.09245, 0.07381]],
                 S=[[0.24247, 0.10947], [0.23742, 0.10719]])
N_PER_SIDE = 4096
BATCH = 512
NPZ = pathlib.Path(__file__).with_name("ridge_discrimination.npz")
OUT = pathlib.Path(__file__).with_name("ridge_discrimination.json")


def generate():
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tcgan_tpu.models.generator import (GeneratorConfig, init_params,
                                            sample_tuning_curves)
    from tcgan_tpu.ops.ssn import SSNConfig

    cfg = GeneratorConfig(
        ssn=SSNConfig(N=51, max_iter=8000, atol=1e-4, check_every=32),
        contrasts=(5.0, 10.0, 13.0), sample_sites=4,
        include_inhibitory_neurons=True, track_offset_identity=True,
        solver="ift")

    def side(params_dict, seed):
        p = init_params(cfg, **params_dict)
        f = jax.jit(lambda k: sample_tuning_curves(cfg, p, k, BATCH))
        tcs = []
        k = jax.random.PRNGKey(seed)
        while sum(t.shape[0] for t in tcs) < N_PER_SIDE:
            k, sub = jax.random.split(k)
            out = f(sub)
            keep = np.asarray(out.converged.all(axis=-1))
            tcs.append(np.asarray(out.tc)[keep])
        return np.concatenate(tcs)[:N_PER_SIDE]

    t0 = time.perf_counter()
    real = side(TRUTH, 0)
    fake = side(DISPLACED, 1)
    print(f"generated 2x{N_PER_SIDE} converged circuits in "
          f"{time.perf_counter() - t0:.1f}s on {jax.default_backend()}")
    np.savez_compressed(NPZ, real=real, fake=fake)


def probes():
    # CPU-only training of the static probes (saved samples, no solver).
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    d = np.load(NPZ)
    real, fake = d["real"], d["fake"]  # (M, 192) each
    M, F = real.shape
    S_COND, P = 24, 8
    rng = np.random.default_rng(0)

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

    def train_probe(Xr, Xf, key, epochs=200, bs=256, lr=1e-3):
        # 80/20 split, balanced classes; returns held-out accuracy and the
        # mean score separation in held-out std units. The split index is
        # rounded to a multiple of S_COND so the circuit-major row layout
        # never leaks rows of one circuit across the split.
        n = Xr.shape[0]
        n_tr = (int(0.8 * n) // S_COND) * S_COND
        X = jnp.asarray(np.concatenate([Xr[:n_tr], Xf[:n_tr]]))
        y = jnp.asarray(np.concatenate([np.ones(n_tr), np.zeros(n_tr)]))
        Xte = jnp.asarray(np.concatenate([Xr[n_tr:], Xf[n_tr:]]))
        yte = np.concatenate([np.ones(n - n_tr), np.zeros(n - n_tr)])
        params = mlp_init(key, X.shape[1])
        opt = optax.adam(lr)
        ost = opt.init(params)

        @jax.jit
        def step(params, ost, xb, yb):
            def loss(p):
                return optax.sigmoid_binary_cross_entropy(
                    mlp_apply(p, xb), yb).mean()

            g = jax.grad(loss)(params)
            up, ost = opt.update(g, ost)
            return optax.apply_updates(params, up), ost

        idx = np.arange(X.shape[0])
        for _ in range(epochs):
            rng.shuffle(idx)
            for i in range(0, len(idx) - bs + 1, bs):
                b = idx[i:i + bs]
                params, ost = step(params, ost, X[b], y[b])
        s = np.asarray(mlp_apply(params, Xte))
        acc = float(((s > 0) == (yte > 0.5)).mean())
        sep = float((s[yte > 0.5].mean() - s[yte < 0.5].mean())
                    / (s.std() + 1e-12))
        return acc, sep, s, yte

    # Per-condition tagged rows, rec13r's std normalization.
    def rows(X):
        t = X.reshape(-1, S_COND, P)
        feats = np.zeros((S_COND, 2), np.float32)
        # condition features (bandwidth, contrast/20) in battery order —
        # values only matter as distinct tags for the probe.
        bws = np.tile(np.array([0, .0625, .125, .1875, .25, .5, .75, 1.]), 3)
        cs = np.repeat(np.array([5., 10., 13.]) / 20.0, 8)
        feats[:, 0], feats[:, 1] = bws, cs
        tagged = np.concatenate(
            [t, np.broadcast_to(feats, (t.shape[0],) + feats.shape)], -1)
        return tagged  # (M, 24, 10)

    scale = 1.0 / (np.concatenate([real, fake]).reshape(-1, S_COND, P)
                   .std(axis=0, keepdims=True) + 1e-6)
    jscale = 1.0 / (np.concatenate([real, fake]).std(axis=0) + 1e-6)

    results = {}
    for m in (512, 2048, N_PER_SIDE):
        key = jax.random.PRNGKey(m)
        Xr, Xf = real[:m] * jscale, fake[:m] * jscale
        acc_j, sep_j, _, _ = train_probe(Xr, Xf, key)
        Rr, Rf = rows(real[:m]) * 1.0, rows(fake[:m]) * 1.0
        Rr[..., :P] *= scale[0]
        Rf[..., :P] *= scale[0]
        kr = jax.random.PRNGKey(m + 1)
        acc_r, sep_r, s, yte = train_probe(
            Rr.reshape(-1, P + 2), Rf.reshape(-1, P + 2), kr, epochs=60)
        # circuit-aggregated row score: mean critic score over the
        # circuit's 24 rows (the best a row critic could feed back).
        n_te = len(yte) // S_COND
        sc = s.reshape(-1, S_COND).mean(-1)
        yc = yte.reshape(-1, S_COND)[:, 0]
        thr = np.median(sc)
        acc_ra = float(max(((sc > thr) == (yc > .5)).mean(),
                           ((sc < thr) == (yc > .5)).mean()))
        results[f"m{m}"] = {
            "joint_mlp_acc": round(acc_j, 4), "joint_sep": round(sep_j, 3),
            "row_mlp_acc": round(acc_r, 4), "row_sep": round(sep_r, 3),
            "row_circuit_agg_acc": round(acc_ra, 4),
        }
        print(m, results[f"m{m}"], flush=True)

    OUT.write_text(json.dumps(results, indent=2))
    print(json.dumps(results))


if __name__ == "__main__":
    if not NPZ.exists() or "--gen-only" in sys.argv:
        generate()
    if "--gen-only" not in sys.argv:
        probes()
