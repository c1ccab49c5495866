"""C5: moment-matching fit (optionally sample-parallel over a device mesh).

Reference parity: ``tc_gan/run/bptt_moments.py`` +
``tc_gan/networks/moment_matching.py`` (SURVEY.md §3.5, [BASELINE] config
C5). ``--parallel mesh`` shards the generator's circuit batch over all
devices (the large-N sample-parallel configuration).

Usage:
    python -m tcgan_tpu.run.moments --datastore /tmp/run_mm --n-steps 500
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tcgan_tpu.run import common


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_ssn_flags(p)
    common.add_stimulus_flags(p)
    common.add_data_flags(p)
    common.add_run_flags(p)
    g = p.add_argument_group("moment matching")
    g.add_argument("--solver", choices=("ift", "bptt"), default="ift")
    g.add_argument("--batch-size", type=int, default=64)
    g.add_argument("--learn-rate", type=float, default=1e-3, dest="lr")
    g.add_argument("--adam-beta1", type=float, default=0.5)
    g.add_argument("--adam-beta2", type=float, default=0.9)
    g.add_argument("--mean-weight", type=float, default=1.0)
    g.add_argument("--cov-weight", type=float, default=1.0)
    g.add_argument("--rate-cost", type=float, default=0.01)
    g.add_argument("--moment-ema", type=float, default=0.0,
                   help="EMA decay for the generated moments (e.g. 0.99): "
                        "moment averaging across steps — effective "
                        "generator sample count ~batch/(1-decay)")
    g.add_argument("--moment-ema-late", type=float, default=0.0,
                   help="two-phase gamma: switch the moment-EMA decay to "
                        "this value at --moment-ema-switch-step (0 = "
                        "off). Measured (BASELINE round-4c): 0.995 for "
                        "the descent, 0.98 near truth collapses the "
                        "limit cycle 10x")
    g.add_argument("--moment-ema-switch-step", type=int, default=0,
                   help="step at which --moment-ema-late takes over "
                        "(0 = off)")
    g.add_argument("--fixed-z", action="store_true",
                   help="common random numbers: one fixed quenched-noise "
                        "set every step (deterministic objective; escapes "
                        "the minibatch-noise floor — see BASELINE.md)")
    g.add_argument("--no-survivor-mask", action="store_true",
                   help="disable the survivor-selection mask on generated "
                        "moments (matches pre-round-2b unmasked baselines; "
                        "the masked objective is the default because the "
                        "unmasked one repels the truth on fragile "
                        "batteries — BASELINE.md round-2b)")
    return p


def main(argv=None):
    import contextlib

    import jax

    args = make_parser().parse_args(argv)

    from tcgan_tpu.models import moments as mm_lib

    common.enable_compile_cache()
    gen_cfg = common.generator_config_from_args(args, solver=args.solver)

    step_fn = mm_lib.train_step
    mesh_cm = None
    if args.parallel == "mesh":
        from tcgan_tpu import parallel as par

        mesh = par.make_mesh()
        gen_cfg = dataclasses.replace(gen_cfg, mesh_axis=par.BATCH_AXIS)
        step_fn = par.make_sharded_mm_step(mm_lib.train_step_impl, mesh)
        # Bare-PartitionSpec constraints in the generator need a mesh
        # context, and fake-truth generation uses the same constrained
        # gen_cfg — span the whole run (see run_gan / run.ensemble).
        mesh_cm = jax.set_mesh(mesh)

    with mesh_cm if mesh_cm is not None else contextlib.nullcontext():
        return _main_body(args, gen_cfg, step_fn, mm_lib)


def _main_body(args, gen_cfg, step_fn, mm_lib) -> int:
    from tcgan_tpu.train.datastore import DataStore
    from tcgan_tpu.train.driver import DriverConfig, MomentMatchingDriver

    cfg = mm_lib.MomentMatchingConfig(
        gen=gen_cfg,
        batch_size=args.batch_size,
        lr=args.lr,
        beta1=args.adam_beta1,
        beta2=args.adam_beta2,
        mean_weight=args.mean_weight,
        cov_weight=args.cov_weight,
        rate_cost=args.rate_cost,
        seed=args.seed,
        fixed_z=args.fixed_z,
        moment_ema=args.moment_ema,
        moment_ema_late=getattr(args, "moment_ema_late", 0.0),
        moment_ema_switch_step=getattr(args, "moment_ema_switch_step", 0),
        survivor_mask=not args.no_survivor_mask,
    )
    dataset = common.load_or_generate_dataset(args, gen_cfg)
    store = DataStore(args.datastore)
    store.write_info({"entry": "moments", **vars(args)})
    driver_cfg = DriverConfig(
        n_steps=args.n_steps,
        checkpoint_every=args.checkpoint_every,
        divergence_abort=args.divergence_abort,
        divergence_patience=args.divergence_patience,
        seed=args.seed,
    )
    from tcgan_tpu.models import generator as gen_lib

    state = mm_lib.init_state(
        cfg,
        gen_init=gen_lib.init_params(
            cfg.gen, common.as22(args.J), common.as22(args.D),
            common.as22(args.S),
        ),
    )
    from tcgan_tpu.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(store.subdir("ckpt"))
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    driver = MomentMatchingDriver(
        cfg, driver_cfg, store, step_fn, state, dataset.moments(),
        checkpoints=ckpt,
    )
    from tcgan_tpu.utils.profiling import maybe_trace

    with maybe_trace(getattr(args, "profile_dir", None)):
        driver.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
