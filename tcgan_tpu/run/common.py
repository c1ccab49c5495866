"""Shared CLI flag machinery.

Reference parity: the shared flag family across ``tc_gan/run/*.py``
(SURVEY.md §5.6). Flag spellings follow the reference's recalled set where
known (``--J/--D/--S`` as 2x2 row-major lists, ``--N``, ``--dt``,
``--seqlen``, ``--sample-sites``, ``--bandwidths``, ``--contrasts``,
``--WGAN_lambda``, ``--WGAN_n_critic``/``--WGAN_n_critic0``, ``--io_type``,
``--track_offset_identity``, ``--include-inhibitory-neurons``,
``--datastore``, ...); the exact upstream spellings could not be
line-verified (empty reference mount — SURVEY.md provenance notice).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Sequence

import numpy as np

from tcgan_tpu.models.generator import GeneratorConfig
from tcgan_tpu.ops.ssn import (
    DEFAULT_BANDWIDTHS,
    DEFAULT_CONTRASTS,
    DEFAULT_D,
    DEFAULT_J,
    DEFAULT_S,
    SSNConfig,
)


def mat22(values: Sequence[float]):
    v = [float(x) for x in values]
    if len(v) != 4:
        raise argparse.ArgumentTypeError("expected 4 values (row-major 2x2)")
    return ((v[0], v[1]), (v[2], v[3]))


def add_ssn_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("SSN circuit")
    flat = lambda m: [x for row in m for x in row]
    g.add_argument("--J", type=float, nargs=4, default=flat(DEFAULT_J),
                   metavar="Jab", help="2x2 mean connectivity, row-major (EE EI IE II)")
    g.add_argument("--D", type=float, nargs=4, default=flat(DEFAULT_D),
                   metavar="Dab", help="2x2 disorder (delta), row-major")
    g.add_argument("--S", type=float, nargs=4, default=flat(DEFAULT_S),
                   metavar="Sab", help="2x2 spatial range (sigma), row-major")
    g.add_argument("--N", type=int, default=51, help="sites per population")
    g.add_argument("--k", type=float, default=0.01, help="io gain")
    g.add_argument("--n", type=float, default=2.2, help="io exponent")
    g.add_argument("--tau-E", type=float, default=0.016, help="E time constant (s)")
    g.add_argument("--tau-I", type=float, default=0.002, help="I time constant (s)")
    g.add_argument("--dt", type=float, default=0.0005, help="Euler step (s)")
    g.add_argument("--seqlen", type=int, default=4000,
                   help="BPTT path: unrolled Euler steps")
    g.add_argument("--max-iter", type=int, default=10000,
                   help="fixed-point path: max Euler iterations")
    g.add_argument("--atol", type=float, default=1e-5,
                   help="fixed-point residual tolerance")
    g.add_argument("--rate-stop-at", type=float, default=200.0,
                   help="divergence ceiling on rates")
    g.add_argument("--io_type", choices=("asym_power", "asym_tanh", "asym_linear"),
                   default="asym_power")
    g.add_argument("--rate-soft-bound", type=float, default=100.0)
    g.add_argument("--rate-hard-bound", type=float, default=200.0)
    g.add_argument("--smoothness", type=float, default=0.03125,
                   help="stimulus edge smoothness")
    g.add_argument("--solver-backend", choices=("xla", "pallas"),
                   default="xla",
                   help="fixed-point forward: lockstep XLA while_loop vs "
                        "fused Pallas kernel (NVIDIA GPU, one device, "
                        "N <= 64)")
    g.add_argument("--check-every", type=int, default=32,
                   help="convergence-check stride (Euler steps); the "
                        "solve returns the SAME fixed points at the same "
                        "atol, only the stop check is strided (at most a "
                        "stride of overshoot iterations). The default of "
                        "32 is not yet measured on the H100. Use 1 to "
                        "reproduce runs recorded before round 4c.")
    g.add_argument("--pallas-two-phase", choices=("on", "off"), default="on",
                   help="TF32 first loop + f32-accurate tail")
    g.add_argument("--pallas-refine", choices=("on", "off"), default="on",
                   help="iterative-refinement tail (TF32 correction steps "
                        "around an f32 anchor)")
    g.add_argument("--pallas-reopen-margin", type=float, default=0.0,
                   help="phase-2 divergence-reopen margin: rows whose "
                        "phase-1 rates are pinned above MARGIN * "
                        "rate-stop-at stay flagged through the "
                        "f32 tail instead of re-proving their "
                        "divergence on divergence-heavy batches. 0 = "
                        "reopen all. 2.0 is safe: the TF32 peak-test "
                        "noise is well under a per cent at the threshold, "
                        "never 2x (chip_smoke.py checks flag parity with "
                        "the XLA path on a divergence-heavy batch)")
    g.add_argument("--init", choices=("zero", "feedforward"), default="zero",
                   help="fixed-point initial rates: zeros (reference) or "
                        "the feedforward estimate f(I)")
    g.add_argument("--stepper", choices=("euler", "expo"), default="euler",
                   help="euler: reference-faithful forward Euler; expo: "
                        "exponential Euler (exact leak integration, dt not "
                        "capped by tau_I, same fixed point)")
    g.add_argument("--accel", choices=("none", "anderson"), default="none",
                   help="fixed-point acceleration (xla backend): "
                        "Anderson(1) per check chunk — same fixed point, "
                        "~2x fewer iterations (composes with --stepper)")


def add_stimulus_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("stimulus battery / readout")
    g.add_argument("--bandwidths", type=float, nargs="+",
                   default=list(DEFAULT_BANDWIDTHS))
    g.add_argument("--contrasts", type=float, nargs="+",
                   default=list(DEFAULT_CONTRASTS))
    g.add_argument("--sample-sites", type=int, default=1,
                   help="number of probe sites read out (center-out)")
    g.add_argument("--track_offset_identity", action="store_true",
                   help="concatenate probe sites into one sample instead of "
                        "treating each site as an independent sample")
    g.add_argument("--include-inhibitory-neurons", action="store_true",
                   help="also read out I cells at the probe sites")
    g.add_argument("--antithetic", action="store_true",
                   help="antithetic (+z, -z) quenched-noise pairs: halves "
                        "generator-gradient variance at no solver cost "
                        "(requires even --batch-size)")


def add_gan_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("GAN")
    g.add_argument("--disc-layers", type=int, nargs="+", default=[128, 128],
                   help="critic MLP hidden layer sizes")
    g.add_argument("--batch-size", type=int, default=64,
                   help="circuits sampled per generator batch")
    g.add_argument("--WGAN_lambda", type=float, default=10.0, dest="gp_lambda")
    g.add_argument("--WGAN_n_critic", type=int, default=5, dest="n_critic")
    g.add_argument("--WGAN_n_critic0", type=int, default=50, dest="n_critic0")
    g.add_argument("--disc-learn-rate", type=float, default=1e-3, dest="lr_critic")
    g.add_argument("--gen-learn-rate", type=float, default=1e-4, dest="lr_gen")
    g.add_argument("--adam-beta1", type=float, default=0.5)
    g.add_argument("--adam-beta2", type=float, default=0.9)
    g.add_argument("--rate-cost", type=float, default=0.01)
    g.add_argument("--normalize-input", action="store_true",
                   help="scale critic inputs by 1/mean dataset tuning curve")
    g.add_argument("--normalize-input-mode", choices=("mean", "std"),
                   default=None,
                   help="per-feature scale for --normalize-input (and "
                        "implies it when given explicitly — passing a mode "
                        "without the switch would otherwise silently run "
                        "unnormalized): 'mean' = "
                        "1/|mean TC| (reference-style), 'std' = 1/std with "
                        "a 5%%-of-mean-|TC| degeneracy floor (whitens the "
                        "joint critic input; the scale the ridge-"
                        "discrimination probes separate under, "
                        "docs/artifacts/ridge_discrimination_scale.py)")
    g.add_argument("--normalize-per-condition", nargs="?", const="mean",
                   choices=("mean", "std"), default=None,
                   help="(conditional WGAN) per-(condition, probe) critic "
                        "input scale from the dataset: 'mean' = 1/|mean TC| "
                        "per condition, 'std' = 1/std per condition "
                        "(equalizes heavy-tailed near-critical conditions); "
                        "also normalizes the (bandwidth, contrast) tag "
                        "features to O(1). Implies --normalize-input "
                        "semantics at per-condition granularity.")
    g.add_argument("--contrast-weights", type=float, nargs="+", default=None,
                   help="(conditional WGAN) per-contrast loss weights in "
                        "--contrasts order, expanded across bandwidths and "
                        "normalized to mean 1; upweights informative "
                        "(near-critical) contrasts in the critic and "
                        "generator objectives")
    g.add_argument("--moment-anchor", type=float, default=0.0,
                   help="hybrid objective: per GAN step, one extra Adam "
                        "update on the survivor-masked EMA-averaged "
                        "moment-matching residual (models/moments.py), "
                        "with THIS value as that update's own learn rate "
                        "(typical: the mm lr, 1e-3; 0 = off). The moment "
                        "term's fixed witness accumulates dataset-level "
                        "signal across steps where a sample-trained "
                        "critic goes blind (ridge-dominated batteries, "
                        "BASELINE.md round-3 scale probe); the "
                        "adversarial term keeps distribution-level "
                        "fidelity beyond second moments.")
    g.add_argument("--anchor-ema", type=float, default=0.995,
                   help="EMA decay for the anchor's generated moments "
                        "(effective sample count ~ batch/(1-gamma))")
    g.add_argument("--anchor-ema-late", type=float, default=0.0,
                   help="two-phase anchor gamma: switch the anchor EMA "
                        "decay to this value at --anchor-ema-switch-step "
                        "(0 = off). Measured (BASELINE round-4c "
                        "orbit-damping sweep): gamma 0.98 collapses the "
                        "near-truth limit cycle 10x with no D "
                        "starvation, while 0.995 carries the descent — "
                        "descend-then-damp in one run")
    g.add_argument("--anchor-ema-switch-step", type=int, default=0,
                   help="GAN step at which --anchor-ema-late takes over "
                        "(0 = off). With --anchor-ema-switch-drift this "
                        "becomes the ARMING step instead (no latch "
                        "before it)")
    g.add_argument("--anchor-ema-switch-drift", type=float, default=0.0,
                   help="drift-latched late gamma (0 = off): engage "
                        "--anchor-ema-late when the max-over-components "
                        "drift ratio |EMA(delta)|/EMA(|delta|) of the "
                        "generator params first drops below this value "
                        "(~1 during directional descent, ~0 inside a "
                        "limit cycle; try 0.25). Measured motivation "
                        "(rec13recipe5 + rec13gammactl counterfactual, "
                        "BASELINE.md): a step-count switch tuned on J "
                        "froze D's bias mid-descent; the latch cannot "
                        "freeze a family that is still moving. Recorded "
                        "per step as drift_ratio in learning.jsonl. "
                        "MEASURED CAVEAT (driftlatch5 live probe): at "
                        "production per-step SNR the ratio sits at its "
                        "~0.02 noise floor even mid-descent, so it fires "
                        "at the arming step — prefer "
                        "--anchor-ema-switch-vel")
    g.add_argument("--anchor-ema-switch-vel", type=float, default=0.0,
                   help="velocity-latched late gamma (0 = off; mutually "
                        "exclusive with --anchor-ema-switch-drift): "
                        "engage --anchor-ema-late when the max-over-"
                        "components smoothed relative parameter velocity "
                        "first drops below this value, in %%-per-1000-"
                        "steps. Calibrated on the driftlatch5 live probe "
                        "(BASELINE.md round 5): descent reads 3-5.5, the "
                        "finding-7 shell rotation ~1.1 (must not latch), "
                        "the damped near-truth hold <<1 — try 1.0. "
                        "--anchor-ema-switch-step arms it; statistic "
                        "recorded per step as drift_ratio in "
                        "learning.jsonl")
    g.add_argument("--anchor-drift-ema", type=float, default=0.995,
                   help="decay for the drift detector's delta EMAs "
                        "(~200-step window at the default; both EMAs "
                        "share it so the warm-up bias cancels in the "
                        "ratio)")
    g.add_argument("--anchor-updates", type=int, default=1,
                   help="anchor Adam updates per GAN step (fresh "
                        "generator batch each). The anchor's ridge-"
                        "direction drift is throughput-limited (lr x "
                        "per-update SNR) and one update costs ~1/7 of a "
                        "GAN step's solver passes, so K updates buy ~Kx "
                        "ridge progress per step at ~(6+K)/7x cost — "
                        "where raising lr past the stability edge "
                        "diverges (measured: BASELINE.md rec13anchor3 "
                        "phase 2)")
    g.add_argument("--anchor-beta1", type=float, default=None,
                   help="beta1 for the anchor's OWN Adam (default: the "
                        "WGAN --adam-beta1, 0.5). Heavier momentum (0.9) "
                        "averages the anchor gradient over ~1/(1-beta1) "
                        "steps — variance reduction along weakly "
                        "identified ridge directions at a fraction of "
                        "the moment-EMA's lag")
    g.add_argument("--critic-lr-decay-steps", type=int, default=-1,
                   help="critic-side lr decay horizon: -1 = follow "
                        "--lr-decay-steps, 0 = constant critic lr")
    g.add_argument("--reject-unconverged", action="store_true",
                   help="drop non-converged fake samples from the critic "
                        "objective (matches the fake-truth dataset's "
                        "survivor selection; the reference fixed-point "
                        "GAN's reject semantics). CAUTION: only for "
                        "mostly-convergent regimes — rejection removes "
                        "the critic's implicit penalty on clamped "
                        "diverged fakes, so on fragile (near-critical) "
                        "batteries the generator can drift into "
                        "divergence unopposed (measured: rec13d, fdiv "
                        "0.8%%->8%% in 500 steps, then a degenerate "
                        "all-rejected critic). Prefer the default "
                        "penalty semantics there.")
    g.add_argument("--clip-grad", type=float, default=0.0,
                   help="global-norm gradient clip for both nets (0 = off)")
    g.add_argument("--lr-decay-steps", type=int, default=0,
                   help="exponential lr decay horizon in steps (0 = off)")
    g.add_argument("--lr-decay-rate", type=float, default=0.5,
                   help="decay factor applied every --lr-decay-steps")
    g.add_argument("--gen-lr-floor", type=float, default=0.0,
                   help="critic-cooling endgame floor for the ADVERSARIAL "
                        "generator lr: the exponential decay clamps here, "
                        "and the --gen-lr-switch-* triggers jump straight "
                        "to it (the anchor's own lr is untouched). "
                        "Rationale: near truth the critic's pull is pure "
                        "bias tax (anchor_equilibrium_probe.json, "
                        "BASELINE.md rec13anchor4) — one run encodes the "
                        "whole adversarial->anchor schedule, no mid-run "
                        "resume.")
    g.add_argument("--gen-lr-switch-step", "--phase-switch-at", type=int,
                   default=0, dest="gen_lr_switch_step",
                   help="hard-switch the adversarial generator lr to "
                        "--gen-lr-floor at this step (0 = off)")
    g.add_argument("--gen-lr-switch-residual", type=float, default=0.0,
                   help="auto endgame trigger (0 = off): latch the "
                        "adversarial lr to --gen-lr-floor once the "
                        "anchor's debiased EMA residual first drops below "
                        "this value (requires --moment-anchor; pick ~k x "
                        "the run's data floor — the flagship's "
                        "equilibrium residual was ~2e-5 over a 7.8e-6 "
                        "noise floor)")
    g.add_argument("--gen-lr-switch-min-step", type=int, default=0,
                   help="arm the residual trigger only from this step on. "
                        "On a ridge start the whitened residual is small "
                        "both at the START (moments barely move along the "
                        "ridge) and near truth — measured live: flagship "
                        "rec13recipe5's unarmed trigger latched at step "
                        "205 (BASELINE.md round 5)")
    g.add_argument("--adaptive-max-iter", choices=("on", "off"),
                   default="on",
                   help="adaptive train-time solver budget: cap max_iter "
                        "at ~4x the healthy-step mean iteration count "
                        "(power-of-2 buckets), so hostile parameter "
                        "regions can't inflate step time ~6x while the "
                        "solver carries diverging samples to the full "
                        "max_iter; 'off' restores the fixed budget")
    g.add_argument("--adaptive-margin", type=float, default=4.0,
                   help="safety margin for --adaptive-max-iter")
    g.add_argument("--gen-ema", type=float, default=0.0,
                   help="EMA decay for generator params (e.g. 0.999; 0 = "
                        "off); the EMA estimate is exported to "
                        "disc_params.npz as J_ema/D_ema/S_ema")


def add_run_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("run plumbing")
    g.add_argument("--datastore", type=str, required=True,
                   help="run directory for recorder streams / checkpoints")
    g.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the datastore")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--n-steps", type=int, default=1000)
    g.add_argument("--checkpoint-every", type=int, default=100)
    g.add_argument("--timing-every", type=int, default=0,
                   help="measure SSsolve_time/gradient_time columns every "
                        "k steps (0 = off)")
    g.add_argument("--tc-mean-every", type=int, default=50,
                   help="record the mean generated tuning curve every k "
                        "steps (0 = off)")
    g.add_argument("--divergence-abort", type=float, default=0.5)
    g.add_argument("--divergence-patience", type=int, default=20)
    g.add_argument("--parallel", choices=("none", "mesh"), default="none",
                   help="'mesh': shard the sample batch over all devices")
    g.add_argument("--profile-dir", type=str, default=None,
                   help="write a jax.profiler device trace of the run here")
    g.add_argument("--dtype", choices=("float32", "bfloat16", "float64"),
                   default="float32")


def add_data_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("data (real tuning curves)")
    g.add_argument("--dataset", type=str, default=None,
                   help=".npz/.npy/.mat tuning-curve dataset; if omitted, a "
                        "fake-truth dataset is generated from --true-J/D/S")
    g.add_argument("--true-J", type=float, nargs=4, default=None)
    g.add_argument("--true-D", type=float, nargs=4, default=None)
    g.add_argument("--true-S", type=float, nargs=4, default=None)
    g.add_argument("--truth-samples", type=int, default=1024,
                   help="fake-truth dataset size")
    g.add_argument("--truth-seed", type=int, default=42)
    g.add_argument("--truth-batch", type=int, default=64,
                   help="circuits per fake-truth solver batch")
    g.add_argument("--truth-tries-factor", type=int, default=4,
                   help="abort fake-truth generation below ~1/factor "
                        "per-circuit yield (raise for near-critical "
                        "batteries; see BASELINE.md battery design)")


REPO_ROOT = Path(__file__).resolve().parents[2]
COMPILE_CACHE_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache, on every backend, and
    return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here. Otherwise the cache goes to the fixed path
    ``<repo>/.jax_cache`` (listed in .gitignore): the path is part of the
    cache key, so a directory that moved would never hit. Call it before
    the process compiles anything — JAX decides once per process whether
    the cache is in use."""
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))
    return jax.config.jax_compilation_cache_dir


def explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dests of options explicitly present on the command line (vs taking
    their parser default). Used by eval-style tools that default-load the
    training run's recorded config and let explicit flags override it.

    Matches argparse's prefix-abbreviation rule (allow_abbrev): an
    unambiguous ``--contrast`` sets the ``contrasts`` dest, so it must be
    marked explicit too — otherwise apply_run_config would silently
    overwrite the user's typed value with the run's recorded one."""
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    tokens = []
    for tok in argv:
        if tok == "--":  # argparse: everything after is positional
            break
        if tok.startswith("--"):
            tokens.append(tok.split("=", 1)[0])
    seen = set()
    for tok in tokens:
        exact = [a for a in parser._actions if tok in a.option_strings]
        if exact:
            seen.add(exact[0].dest)
            continue
        # unambiguous abbreviation: all prefix-matching options must agree
        # on one dest (argparse itself errors out on ambiguous prefixes
        # before any caller reaches this helper)
        dests = {a.dest for a in parser._actions
                 if any(o.startswith(tok) for o in a.option_strings
                        if o.startswith("--"))}
        if len(dests) == 1:
            seen.add(dests.pop())
    return seen


def critic_input_scales(args, gen_cfg, dataset, conditional):
    """Critic input-normalization scales from the dataset: honors
    ``--normalize-per-condition`` (conditional runs only) and
    ``--normalize-input`` / ``--normalize-input-mode`` (an explicit mode
    implies the switch; ``args`` is updated in place so info.json records
    what actually ran). Shared by gan_common and run.ensemble so an
    identically-flagged ensemble member trains with the same critic
    inputs as the single-run recipe.

    Returns ``(input_scale, cond_input_scale)`` — flat tuples or None."""
    import numpy as np

    if getattr(args, "normalize_input_mode", None) is not None:
        args.normalize_input = True
    per_cond = getattr(args, "normalize_per_condition", None)
    if per_cond is not None and not conditional:
        raise SystemExit(
            "--normalize-per-condition requires a conditional run "
            "(run.cwgan / run.bptt_cwgan); for the unconditional critic "
            "use --normalize-input [--normalize-input-mode std]")
    input_scale = None
    cond_input_scale = None
    if conditional and per_cond is not None:
        # Per-(condition, probe) scale: keeps the heavy-tailed near-critical
        # conditions from swamping the critic's per-batch signal
        # (BASELINE.md rec13 stall diagnosis). Tag features normalized to
        # O(1) so contrast ~13 doesn't dominate the He-init first layer.
        tc = np.asarray(dataset.tc).reshape(
            dataset.num_samples, gen_cfg.n_stim, gen_cfg.n_probe)
        if per_cond == "std":
            denom = tc.std(axis=0)
        else:
            denom = np.abs(tc.mean(axis=0))
        # Floor at 5% of the global TC magnitude: near-silent conditions
        # (e.g. bandwidth 0) have ~zero mean AND ~zero variance, and an
        # eps-only floor would amplify their pure noise by ~1e6 — the
        # critic then rides that one degenerate feature to a runaway
        # Wasserstein (observed: rec13d blow-up, W -> 1e5 by step 2k).
        floor = 0.05 * float(np.abs(tc).mean())
        sp_scale = 1.0 / np.maximum(denom, max(floor, 1e-6))  # (S, P)
        feats = np.asarray(gen_cfg.condition_features())  # (S, 2)
        tag_scale = 1.0 / np.maximum(np.abs(feats).max(axis=0), 1e-6)
        cond_input_scale = tuple(
            float(s) for s in np.concatenate([sp_scale.ravel(), tag_scale]))
    elif getattr(args, "normalize_input", False):
        tc = np.asarray(dataset.tc)
        if getattr(args, "normalize_input_mode", "mean") == "std":
            # Per-feature std scale with the same degeneracy floor as the
            # per-condition path: near-silent features (bandwidth-0
            # conditions) have ~zero std, and an eps-only floor would
            # amplify pure noise (rec13d blow-up mechanism).
            denom = tc.std(axis=0)
            floor = 0.05 * float(np.abs(tc).mean())
            scale = 1.0 / np.maximum(denom, max(floor, 1e-6))
        else:
            mean_tc = tc.mean(axis=0)
            scale = 1.0 / np.maximum(np.abs(mean_tc), 1e-6)
        if conditional:
            # conditional critic sees (per-condition probe block, cond tag)
            n_probe = gen_cfg.n_probe
            probe_scale = scale.reshape(gen_cfg.n_stim, n_probe).mean(axis=0)
            scale = np.concatenate([probe_scale, np.ones(2)])
        input_scale = tuple(float(s) for s in scale)
    return input_scale, cond_input_scale


def contrast_cond_weight(args, conditional):
    """Per-stimulus-condition loss weights from ``--contrast-weights``
    (conditional runs), expanded across bandwidths in the battery's
    contrast-major condition order and normalized to mean 1. None when
    the flag is absent or the run is unconditional."""
    import numpy as np

    if not (conditional and getattr(args, "contrast_weights", None)):
        return None
    cw = np.asarray(args.contrast_weights, dtype=np.float64)
    if cw.shape[0] != len(args.contrasts):
        raise SystemExit(
            f"--contrast-weights needs {len(args.contrasts)} values "
            f"(one per --contrasts entry), got {cw.shape[0]}")
    # battery order is contrast-major (ops/stimulus.py condition_features):
    # expand each contrast weight across bandwidths
    per_stim = np.repeat(cw, len(args.bandwidths))
    per_stim = per_stim / per_stim.mean()
    return tuple(float(w) for w in per_stim)


def run_config_dests() -> set:
    """Arg dests that belong to the run's scientific configuration (SSN
    circuit, stimulus battery/readout, data/truth) — the fields an eval
    must reproduce from the training run's ``info.json`` to avoid silently
    wrong W1/recovery numbers."""
    p = argparse.ArgumentParser(add_help=False)
    add_ssn_flags(p)
    add_stimulus_flags(p)
    add_data_flags(p)
    return {a.dest for a in p._actions if a.dest != "help"}


def apply_run_config(args, parser: argparse.ArgumentParser, argv,
                     run_dir) -> list:
    """Overlay the training run's recorded config (``info.json`` in
    ``run_dir``) onto ``args`` for every scientific-config dest the user
    did not explicitly set. Explicit flags win, but a mismatch against the
    recorded value is reported loudly (returned + printed to stderr).

    Returns the list of human-readable override notices (empty when the
    CLI agrees with the run's config or no info.json exists)."""
    import json as _json
    import pathlib
    import sys as _sys

    info_path = pathlib.Path(run_dir) / "info.json"
    if not info_path.exists():
        print(f"eval: no info.json under {run_dir} — relying on CLI flags "
              "for the run configuration", file=_sys.stderr)
        return []
    run_cfg = _json.loads(info_path.read_text()).get("config", {})
    explicit = explicit_dests(parser, argv)
    notices = []
    for dest in sorted(run_config_dests()):
        if dest not in run_cfg:
            continue
        run_val = run_cfg[dest]
        if dest in explicit:
            cur = getattr(args, dest, None)
            if cur != run_val:
                msg = (f"eval: --{dest.replace('_', '-')} overrides the "
                       f"run's recorded config (run: {run_val!r}, "
                       f"cli: {cur!r})")
                notices.append(msg)
                print(msg, file=_sys.stderr)
        else:
            setattr(args, dest, run_val)
    return notices


def ssn_config_from_args(args) -> SSNConfig:
    return SSNConfig(
        N=args.N, k=args.k, n=args.n, tau_E=args.tau_E, tau_I=args.tau_I,
        dt=args.dt, io_type=args.io_type,
        rate_soft_bound=args.rate_soft_bound,
        rate_hard_bound=args.rate_hard_bound,
        smoothness=args.smoothness, max_iter=args.max_iter, atol=args.atol,
        rate_stop_at=args.rate_stop_at, seqlen=args.seqlen,
        backend=args.solver_backend, check_every=args.check_every,
        pallas_two_phase=(args.pallas_two_phase == "on"),
        pallas_refine=(args.pallas_refine == "on"),
        pallas_reopen_margin=getattr(args, "pallas_reopen_margin", 0.0),
        stepper=args.stepper,
        init=args.init,
        accel=getattr(args, "accel", "none"),
    )


def generator_config_from_args(args, solver: str) -> GeneratorConfig:
    import jax.numpy as jnp

    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
             "float64": jnp.float64}[args.dtype]
    return GeneratorConfig(
        ssn=ssn_config_from_args(args),
        bandwidths=tuple(args.bandwidths),
        contrasts=tuple(args.contrasts),
        sample_sites=args.sample_sites,
        track_offset_identity=args.track_offset_identity,
        include_inhibitory_neurons=args.include_inhibitory_neurons,
        antithetic=getattr(args, "antithetic", False),
        solver=solver,
        dtype=dtype,
    )


def as22(flat) -> tuple:
    return ((flat[0], flat[1]), (flat[2], flat[3]))


def resolve_true_params(args):
    tj = as22(args.true_J) if args.true_J else DEFAULT_J
    td = as22(args.true_D) if args.true_D else DEFAULT_D
    ts = as22(args.true_S) if args.true_S else DEFAULT_S
    return tj, td, ts


def load_or_generate_dataset(args, gen_cfg: GeneratorConfig):
    """Real tuning curves: from file, or fake truth from known params."""
    from tcgan_tpu.data.datasets import (
        TuningCurveDataset, generate_fake_truth, load_tuning_curves,
    )

    if args.dataset:
        arr = load_tuning_curves(args.dataset)
    else:
        tj, td, ts = resolve_true_params(args)
        arr = generate_fake_truth(
            gen_cfg, tj, td, ts, args.truth_samples, seed=args.truth_seed,
            batch=getattr(args, "truth_batch", 64),
            tries_factor=getattr(args, "truth_tries_factor", 4),
        )
    return TuningCurveDataset.from_array(np.asarray(arr))
