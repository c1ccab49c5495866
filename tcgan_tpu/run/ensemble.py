"""Ensemble (multi-start) WGAN fitting CLI — K independent fits in one
jitted program (``tcgan_tpu.models.ensemble``).

The reference ran multi-start as shell job arrays (one Theano process per
fit); here ``vmap`` batches K member fits onto one chip, so seed/start
robustness checks cost roughly one fit's wall-clock. Usage::

    python -m tcgan_tpu.run.ensemble --datastore runs/ens \\
        --ensemble 8 --start-jitter 0.1 --batch-size 64 [gan flags...]

Artifacts: ``ensemble.csv`` (per-member learning + parameter trajectory),
``ensemble_params.npz`` (final stacked J/D/S [+ EMA]),
``ensemble_summary.json`` (across-member mean/std + per-member recovery
errors when truth is known), NumPy checkpoints of the stacked state.
"""

from __future__ import annotations

import json


def make_parser():
    from tcgan_tpu.run.gan_common import make_gan_parser

    p = make_gan_parser(__doc__)
    g = p.add_argument_group("ensemble")
    g.add_argument("--ensemble", type=int, default=4,
                   help="number of member fits run in one program")
    g.add_argument("--start-jitter", type=float, default=0.0,
                   help="log-space stddev of per-member start perturbation "
                        "(member 0 keeps the exact --J/--D/--S start)")
    g.add_argument("--record-every", type=int, default=10,
                   help="write ensemble.csv rows every k steps")
    g.add_argument("--conditional", action="store_true",
                   help="conditional WGAN members (cwgan semantics: "
                        "condition-tagged samples, within-condition GP)")
    g.add_argument("--estimator", choices=("wgan", "cwgan", "mm"),
                   default=None,
                   help="member estimator: wgan (default), cwgan (same as "
                        "--conditional), or mm — multi-start MOMENT "
                        "MATCHING (vmapped MMState incl. moment-EMA "
                        "buffers; the estimator that recovered the "
                        "near-critical battery, BASELINE.md mm13fix)")
    g.add_argument("--mm-lr", type=float, default=1e-3,
                   help="(mm) member Adam learn rate")
    g.add_argument("--moment-ema", type=float, default=0.0,
                   help="(mm) EMA decay for generated moments per member")
    g.add_argument("--moment-ema-late", type=float, default=0.0,
                   help="(mm) two-phase gamma: switch the moment-EMA "
                        "decay to this value at --moment-ema-switch-step "
                        "(0 = off; BASELINE round-4c orbit-damping sweep)")
    g.add_argument("--moment-ema-switch-step", type=int, default=0,
                   help="(mm) step at which --moment-ema-late takes over")
    g.add_argument("--fixed-z", action="store_true",
                   help="(mm) common-random-numbers quenched noise")
    g.add_argument("--data-seed-per-member", action="store_true",
                   help="(mm) give each member its OWN fake-truth dataset "
                        "(truth seed = --truth-seed + member index), so "
                        "the member spread includes SAMPLING variance and "
                        "is comparable to the CRLB. Default (shared "
                        "dataset) measures estimator-internal noise only "
                        "— measured round 4c (BASELINE.md mmens13): "
                        "shared-data spread rides the STRONG Fisher "
                        "directions (limit-cycle amplitude), the opposite "
                        "structure of posterior width. Requires generated "
                        "fake truth (incompatible with --dataset).")
    g.add_argument("--mean-weight", type=float, default=1.0)
    g.add_argument("--cov-weight", type=float, default=1.0)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    import contextlib

    import jax

    from tcgan_tpu.models import ensemble as ens_lib
    from tcgan_tpu.run import common

    from tcgan_tpu.models import cwgan as cwgan_lib
    from tcgan_tpu.models import wgan as wgan_lib

    common.enable_compile_cache()
    gen_cfg = common.generator_config_from_args(args, solver="ift")
    if args.record_every < 1:
        raise SystemExit("--record-every must be >= 1 (ensemble.csv IS "
                         "the run's output stream)")
    # Contradictory flag combinations error loudly instead of resolving
    # silently (an unconditional mm or a cwgan recorded as 'wgan' would
    # otherwise train behind the user's back).
    if args.estimator == "wgan" and args.conditional:
        raise SystemExit("--estimator wgan contradicts --conditional; "
                         "use --estimator cwgan (or drop --conditional)")
    estimator = args.estimator or ("cwgan" if args.conditional else "wgan")
    if estimator == "cwgan":
        args.conditional = True
    if estimator == "mm":
        if args.conditional:
            raise SystemExit("--estimator mm has no conditional path; "
                             "drop --conditional")
        if args.parallel == "mesh":
            raise SystemExit("--estimator mm does not support --parallel "
                             "mesh (members are not sharded); drop the "
                             "flag to run single-device")
        return _run_mm(args, gen_cfg)
    model = cwgan_lib if args.conditional else wgan_lib

    step_fn = jax.jit(
        ens_lib.make_ensemble_step_impl(model.train_step_impl),
        static_argnames=("cfg", "n_critic"))
    mesh_cm = None
    if args.parallel == "mesh":
        # Members shard over the device mesh (embarrassingly parallel —
        # zero cross-member collectives). Requires --ensemble divisible
        # by the device count.
        from tcgan_tpu import parallel as par

        mesh = par.make_mesh(n_model=1)
        n_dev = mesh.devices.size
        if args.ensemble % n_dev:
            raise SystemExit(
                f"--ensemble {args.ensemble} must be divisible by the "
                f"{n_dev}-device mesh")
        step_fn = par.make_sharded_ensemble_step(
            ens_lib.make_ensemble_step_impl(model.train_step_impl), mesh)
        mesh_cm = jax.set_mesh(mesh)

    with mesh_cm if mesh_cm is not None else contextlib.nullcontext():
        return _run(args, gen_cfg, step_fn, model)


def _member_param_columns(gen_cfg, gp_host, m):
    """Flattened J/D/S CSV columns of member ``m`` (shared by the wgan and
    mm runners so the two artifacts cannot silently diverge)."""
    import jax
    import numpy as np

    from tcgan_tpu.models import generator as gen_lib

    J, D, S = gen_lib.param_values_np(
        gen_cfg, jax.tree.map(lambda a: a[m], gp_host))
    out = {}
    for blk, val in (("J", J), ("D", D), ("S", S)):
        v = np.asarray(val)
        for i, a in enumerate(("E", "I")):
            for j, b in enumerate(("E", "I")):
                out[f"{blk}_{a}{b}"] = float(v[i][j])
    return out


def _stack_member_params(gen_cfg, host_params, K, suffix=""):
    """K-member-stacked J/D/S arrays for ensemble_params.npz."""
    import jax
    import numpy as np

    from tcgan_tpu.models import generator as gen_lib

    stacked = {}
    for m in range(K):
        J, D, S = gen_lib.param_values_np(
            gen_cfg, jax.tree.map(lambda a: a[m], host_params))
        for blk, val in ((f"J{suffix}", J), (f"D{suffix}", D),
                         (f"S{suffix}", S)):
            stacked.setdefault(blk, []).append(np.asarray(val))
    return {k: np.stack(v) for k, v in stacked.items()}


def _run_mm(args, gen_cfg) -> int:
    """Multi-start moment-matching ensemble: K vmapped MM fits (incl.
    moment-EMA buffers) in one jitted program, sharing one dataset's
    moments. Artifacts match the WGAN ensemble (ensemble.csv /
    ensemble_params.npz / ensemble_summary.json) so ``analysis.ensemble_view
    --jacobian`` runs unchanged."""
    import numpy as np

    import jax

    from tcgan_tpu.models import ensemble as ens_lib
    from tcgan_tpu.models import generator as gen_lib
    from tcgan_tpu.models import moments as mm_lib
    from tcgan_tpu.run import common
    from tcgan_tpu.train.checkpoint import CheckpointManager
    from tcgan_tpu.train.datastore import (DataStore,
                                           PervasiveDivergenceError)
    from tcgan_tpu.train.driver import GracefulStop
    from tcgan_tpu.train.recorders import CSVRecorder
    from tcgan_tpu.utils.stopwatch import StopWatch

    cfg = mm_lib.MomentMatchingConfig(
        gen=gen_cfg,
        batch_size=args.batch_size,
        lr=args.mm_lr,
        beta1=args.adam_beta1,
        beta2=args.adam_beta2,
        mean_weight=args.mean_weight,
        cov_weight=args.cov_weight,
        rate_cost=args.rate_cost,
        clip_grad=args.clip_grad,
        seed=args.seed,
        fixed_z=args.fixed_z,
        moment_ema=args.moment_ema,
        moment_ema_late=getattr(args, "moment_ema_late", 0.0),
        moment_ema_switch_step=getattr(args, "moment_ema_switch_step", 0),
    )
    K = args.ensemble
    per_member_data = getattr(args, "data_seed_per_member", False)
    if per_member_data:
        # K independent fake-truth draws -> stacked moments (K, F) /
        # (K, F, F); the vmapped step maps over the data axis too, so
        # member spread includes the data's sampling variance (the
        # CRLB-comparable mode — see the flag's help text).
        if args.dataset:
            raise SystemExit("--data-seed-per-member requires generated "
                             "fake truth, not --dataset")
        import copy

        means, seconds = [], []
        for m in range(K):
            args_m = copy.copy(args)  # argparse.Namespace shallow copy
            args_m.truth_seed = args.truth_seed + m
            dm, dsec = common.load_or_generate_dataset(
                args_m, gen_cfg).moments()
            means.append(np.asarray(dm))
            seconds.append(np.asarray(dsec))
        data_mean = np.stack(means)
        data_second = np.stack(seconds)
    else:
        dataset = common.load_or_generate_dataset(args, gen_cfg)
        data_mean, data_second = dataset.moments()

    store = DataStore(args.datastore)
    store.write_info({"entry": "ensemble_mm", "n_members": K, **vars(args)})
    gen_init = gen_lib.init_params(
        cfg.gen, common.as22(args.J), common.as22(args.D), common.as22(args.S))
    states = ens_lib.init_mm_ensemble(
        cfg, K, jax.random.PRNGKey(cfg.seed), gen_init=gen_init,
        start_jitter=args.start_jitter)
    step_fn = jax.jit(
        ens_lib.make_mm_ensemble_step_impl(per_member_data=per_member_data),
        static_argnames=("cfg",))

    ckpt = CheckpointManager(store.subdir("ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        states = ckpt.restore(states)

    pops = ("E", "I")
    cols = (["step", "member", "loss", "mean_err", "cov_err",
             "rate_penalty", "frac_converged", "frac_diverged",
             "train_time"]
            + [f"{blk}_{a}{b}" for blk in ("J", "D", "S")
               for a in pops for b in pops])
    rec = CSVRecorder(store.file("ensemble.csv"), cols)
    watch = StopWatch()

    start = int(np.asarray(states.step)[0])
    if start > 0:
        # resume: drop the replayed window's rows (the stream flushes
        # every record but checkpoints are periodic — see GANDriver.run)
        rec.truncate_from(start)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 7919), start)
    true_params = None
    if not args.dataset:
        tj, td, ts = common.resolve_true_params(args)
        true_params = {"J": np.asarray(tj), "D": np.asarray(td),
                       "S": np.asarray(ts)}

    divergence_strikes = 0
    status = "finished"
    stop = GracefulStop()  # SIGTERM (queue timeout/preemption) finishes
    stop.__enter__()       # the step, then falls through to the summary
    try:
        for step in range(start, start + args.n_steps):
            if stop.requested:
                status = "interrupted"
                break
            key, k_step = jax.random.split(key)
            member_keys = jax.random.split(k_step, K)
            with watch.time("train"):
                states, metrics = step_fn(cfg, states, data_mean,
                                          data_second, member_keys)
                jax.block_until_ready(metrics.loss)

            if (step % args.record_every == 0
                    or step == start + args.n_steps - 1):
                host = {f: np.asarray(getattr(metrics, f)) for f in
                        ("loss", "mean_err", "cov_err", "rate_penalty",
                         "frac_converged", "frac_diverged")}
                gp_host = jax.tree.map(np.asarray, states.gen_params)
                for m in range(K):
                    rec.record({"step": step, "member": m,
                                "train_time": watch.last("train"),
                                **{f: float(v[m]) for f, v in host.items()},
                                **_member_param_columns(cfg.gen, gp_host, m)})
            # divergence accounting every REAL step: a record-gated check
            # would abort record_every-fold later than the single-run
            # driver on the same runaway
            fdiv = float(np.asarray(metrics.frac_diverged).mean())
            if fdiv > args.divergence_abort:
                divergence_strikes += 1
                if divergence_strikes >= args.divergence_patience:
                    raise PervasiveDivergenceError(
                        f"ensemble mean frac_diverged={fdiv:.2f} for "
                        f"{divergence_strikes} steps")
            else:
                divergence_strikes = 0

            if (args.checkpoint_every
                    and (step + 1) % args.checkpoint_every == 0):
                ckpt.save(step + 1, states)
    except PervasiveDivergenceError as e:
        status = f"aborted: {e}"
    finally:
        rec.close()

    ckpt.save(int(np.asarray(states.step)[0]), states)
    ckpt.close()

    gp_host = jax.tree.map(np.asarray, states.gen_params)
    np.savez(store.file("ensemble_params.npz"),
             **_stack_member_params(cfg.gen, gp_host, K))

    summary = ens_lib.ensemble_summary(cfg, states, true_params)
    with open(store.file("ensemble_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"status": status, "n_members": K,
                      "estimator": "mm",
                      "mean": summary["mean"], "std": summary["std"]}))
    store.finalize(status)
    # Restore the SIGTERM handler only AFTER the summary/params/finalize
    # are on disk: a preemption landing during finalization is the exact
    # window _GracefulStop exists for, and ensemble finalization is
    # non-trivial for large K (ADVICE r4 #2; driver.py ordering).
    stop.__exit__()
    return 0


def _run(args, gen_cfg, step_fn, model) -> int:
    import numpy as np

    import jax

    from tcgan_tpu.models import ensemble as ens_lib
    from tcgan_tpu.models import generator as gen_lib
    from tcgan_tpu.models import wgan as wgan_lib
    from tcgan_tpu.run import common
    from tcgan_tpu.train.checkpoint import CheckpointManager
    from tcgan_tpu.train.datastore import (DataStore,
                                           PervasiveDivergenceError)
    from tcgan_tpu.train.driver import GracefulStop
    from tcgan_tpu.train.recorders import CSVRecorder
    from tcgan_tpu.utils.stopwatch import StopWatch

    import dataclasses

    if getattr(args, "moment_anchor", 0.0):
        raise SystemExit(
            "--moment-anchor is not supported by the ensemble runner: the "
            "vmapped member state has no anchor Adam/EMA buffers, so members "
            "would silently train WITHOUT the anchor. Drop the flag, or run "
            "K separate tcgan_tpu.run.bptt_wgan/bptt_cwgan fits.")

    conditional = bool(getattr(args, "conditional", False))
    data_gen_cfg = (dataclasses.replace(gen_cfg, track_offset_identity=True)
                    if conditional else gen_cfg)
    dataset = common.load_or_generate_dataset(args, data_gen_cfg)

    # same critic-input scaling and condition weighting as an
    # identically-flagged single run (gan_common) — shared helpers
    input_scale, cond_input_scale = common.critic_input_scales(
        args, gen_cfg, dataset, conditional)
    cond_weight = common.contrast_cond_weight(args, conditional)

    from tcgan_tpu.models import cwgan as cwgan_lib

    mk_cfg = cwgan_lib.CWGANConfig if conditional else wgan_lib.WGANConfig
    extra_cfg = {}
    if conditional:
        extra_cfg = dict(cond_input_scale=cond_input_scale,
                         cond_weight=cond_weight)
    cfg = mk_cfg(
        gen=gen_cfg,
        input_scale=input_scale,
        critic_lr_decay_steps=getattr(args, "critic_lr_decay_steps", -1),
        **extra_cfg,
        critic_layers=tuple(args.disc_layers),
        batch_size=args.batch_size,
        gp_lambda=args.gp_lambda,
        n_critic=args.n_critic,
        n_critic0=args.n_critic0,
        lr_gen=args.lr_gen,
        lr_critic=args.lr_critic,
        beta1=args.adam_beta1,
        beta2=args.adam_beta2,
        rate_cost=args.rate_cost,
        clip_grad=args.clip_grad,
        lr_decay_steps=args.lr_decay_steps,
        lr_decay_rate=args.lr_decay_rate,
        ema_decay=args.gen_ema,
        reject_unconverged=getattr(args, "reject_unconverged", False),
        seed=args.seed,
    )
    K = args.ensemble

    store = DataStore(args.datastore)
    store.write_info({"entry": "ensemble", "n_members": K, **vars(args)})
    gen_init = gen_lib.init_params(
        cfg.gen, common.as22(args.J), common.as22(args.D), common.as22(args.S))
    states = ens_lib.init_ensemble(
        cfg, K, jax.random.PRNGKey(cfg.seed), gen_init=gen_init,
        start_jitter=args.start_jitter, model=model)

    if conditional:
        from tcgan_tpu.models.cwgan import tag_with_conditions

        raw = dataset.tc.reshape(dataset.num_samples, cfg.gen.n_stim,
                                 cfg.gen.n_probe)
        tagged = tag_with_conditions(cfg, raw)
        tagged = tagged.reshape(dataset.num_samples, cfg.gen.n_stim, -1)

        def sample_real(key, n_stacks):
            idx = jax.random.randint(key, (n_stacks, cfg.batch_size), 0,
                                     dataset.num_samples)
            return tagged[idx].reshape(n_stacks,
                                       cfg.batch_size * cfg.gen.n_stim, -1)
    else:
        def sample_real(key, n_stacks):
            return dataset.sample_stack(key, n_stacks, cfg.critic_batch)
    ckpt = CheckpointManager(store.subdir("ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        states = ckpt.restore(states)

    pops = ("E", "I")
    cols = (["step", "member", "d_loss", "g_loss", "wasserstein",
             "d_accuracy", "frac_converged", "frac_diverged", "mean_iters",
             "train_time"]
            + [f"{blk}_{a}{b}" for blk in ("J", "D", "S")
               for a in pops for b in pops])
    rec = CSVRecorder(store.file("ensemble.csv"), cols)
    watch = StopWatch()

    start = int(np.asarray(states.step)[0])
    if start > 0:
        # resume: drop the replayed window's rows (the stream flushes
        # every record but checkpoints are periodic — see GANDriver.run)
        rec.truncate_from(start)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 7919), start)
    true_params = None
    if not args.dataset:
        tj, td, ts = common.resolve_true_params(args)
        true_params = {"J": np.asarray(tj), "D": np.asarray(td),
                       "S": np.asarray(ts)}

    divergence_strikes = 0
    status = "finished"
    stop = GracefulStop()  # see _run_mm: summary survives a SIGTERM
    stop.__enter__()
    try:
        for step in range(start, start + args.n_steps):
            if stop.requested:
                status = "interrupted"
                break
            key, k_data, k_step = jax.random.split(key, 3)
            n_critic = cfg.n_critic0 if step == 0 else cfg.n_critic
            stacks = sample_real(k_data, K * n_critic)
            real = stacks.reshape((K, n_critic) + stacks.shape[1:])
            member_keys = jax.random.split(k_step, K)
            with watch.time("train"):
                states, metrics = step_fn(cfg, n_critic, states, real,
                                          member_keys)
                jax.block_until_ready(metrics.d_loss)

            if (step % args.record_every == 0
                    or step == start + args.n_steps - 1):
                host = {f: np.asarray(getattr(metrics, f)) for f in
                        ("d_loss", "g_loss", "wasserstein", "d_accuracy",
                         "frac_converged", "frac_diverged", "mean_iters")}
                gp_host = jax.tree.map(np.asarray, states.gen_params)
                for m in range(K):
                    rec.record({"step": step, "member": m,
                                "train_time": watch.last("train"),
                                **{f: float(v[m]) for f, v in host.items()},
                                **_member_param_columns(cfg.gen, gp_host, m)})
            # divergence accounting every REAL step (see _run_mm)
            fdiv = float(np.asarray(metrics.frac_diverged).mean())
            if fdiv > args.divergence_abort:
                divergence_strikes += 1
                if divergence_strikes >= args.divergence_patience:
                    raise PervasiveDivergenceError(
                        f"ensemble mean frac_diverged={fdiv:.2f} for "
                        f"{divergence_strikes} steps")
            else:
                divergence_strikes = 0

            if (args.checkpoint_every
                    and (step + 1) % args.checkpoint_every == 0):
                ckpt.save(step + 1, states)
    except PervasiveDivergenceError as e:
        status = f"aborted: {e}"
    finally:
        rec.close()

    ckpt.save(int(np.asarray(states.step)[0]), states)
    ckpt.close()

    # Final artifacts: stacked params + summary.
    gp_host = jax.tree.map(np.asarray, states.gen_params)
    npz = _stack_member_params(cfg.gen, gp_host, K)
    if cfg.ema_decay > 0 and states.ema_params is not None:
        ema_host = jax.tree.map(np.asarray, states.ema_params)
        npz.update(_stack_member_params(cfg.gen, ema_host, K,
                                        suffix="_ema"))
    np.savez(store.file("ensemble_params.npz"), **npz)

    summary = ens_lib.ensemble_summary(cfg, states, true_params)
    with open(store.file("ensemble_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"status": status, "n_members": K,
                      "mean": summary["mean"], "std": summary["std"]}))
    store.finalize(status)
    # Restore the SIGTERM handler only AFTER the summary/params/finalize
    # are on disk: a preemption landing during finalization is the exact
    # window _GracefulStop exists for, and ensemble finalization is
    # non-trivial for large K (ADVICE r4 #2; driver.py ordering).
    stop.__exit__()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
