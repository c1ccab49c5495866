"""Training drivers: the step loop with recording, checkpointing, and
numerical-failure accounting.

Reference parity: ``tc_gan/drivers.py::GANDriver`` (SURVEY.md §2 "Training
driver", §3.1, §5.3):

- per step: sample real minibatches, ``n_critic`` critic updates + 1
  generator update (fused on device here), record learning/param streams;
- critic-iters schedule: ``n_critic0`` for the warm-up steps, ``n_critic``
  afterwards (two jit specializations, compiled once each);
- divergence accounting: per-step diverged fraction is tracked; if it
  exceeds ``divergence_abort`` for ``divergence_patience`` consecutive
  steps the run aborts with PervasiveDivergenceError (the reference's
  KnownError semantics);
- periodic NumPy checkpoints (full state, resumable) + mean-TC snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import numpy as np

from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.train.checkpoint import CheckpointManager
from tcgan_tpu.train.datastore import DataStore, PervasiveDivergenceError
from tcgan_tpu.train.recorders import (CSVRecorder, GEN_COLUMNS,
                                       JSONLRecorder, RecorderSet,
                                       flatten_gen_params)
from tcgan_tpu.utils.stopwatch import StopWatch


def _divergence_streak(streak: int, frac: float, cfg: "DriverConfig",
                       step: int) -> int:
    """Shared pervasive-divergence accounting (GAN + MM drivers): returns
    the updated streak, raising PervasiveDivergenceError at patience."""
    streak = streak + 1 if frac > cfg.divergence_abort else 0
    if streak >= cfg.divergence_patience:
        raise PervasiveDivergenceError(
            f"step {step}: diverged fraction {frac:.2f} exceeded "
            f"{cfg.divergence_abort} for {streak} steps")
    return streak


class _GracefulStop:
    """Preemption-safe stop for the step loops: SIGTERM/SIGINT set a flag
    that the drivers check at step boundaries, then checkpoint the last
    COMPLETED step and finalize the datastore as "interrupted" (resumable
    with zero lost steps) instead of dying mid-step with everything since
    the last periodic checkpoint lost. Batch schedulers' preemptions
    deliver SIGTERM. A second signal while the flag is already set falls through
    to the previous handler (default: kill) so a hung save can still be
    stopped. No-op off the main thread (signal.signal raises there)."""

    def __init__(self):
        self.requested = False
        self._old = {}

    def __enter__(self):
        import signal

        def _request(signum, frame):
            if self.requested:  # second signal: escalate
                handler = self._old.get(signum, signal.SIG_DFL)
                signal.signal(signum, handler)
                raise KeyboardInterrupt
            self.requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, _request)
            except ValueError:  # non-main thread (e.g. test harnesses)
                pass
        return self

    def __exit__(self, *exc):
        import signal

        for sig, handler in self._old.items():
            signal.signal(sig, handler)
        return False


# Public name: run/ensemble.py's step loops install the same
# preemption-safe stop (timeout(1)-bounded queue items deliver SIGTERM).
GracefulStop = _GracefulStop


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    n_steps: int = 1000
    n_critic0_steps: int = 1  # how many initial steps use n_critic0
    checkpoint_every: int = 100
    tc_mean_every: int = 50
    timing_every: int = 0  # measure SSsolve_time/gradient_time every k steps
    divergence_abort: float = 0.5  # abort if frac_diverged > this ...
    divergence_patience: int = 20  # ... for this many consecutive steps
    seed: int = 0
    # Adaptive train-time solver budget (SURVEY.md §5.3 failure semantics):
    # cap the solver's max_iter at ``adaptive_margin`` x the EMA of healthy
    # steps' mean iteration count, so a drift into a hostile parameter
    # region cannot silently inflate step time ~6x while the kernel carries
    # diverging samples to the full max_iter (measured: mean iters 2931 vs
    # 485 on a 34%-divergent batch, BASELINE.md round 2). The cap moves in
    # power-of-2 buckets, so jit re-specializes at most a handful of times
    # per run; samples the cap cuts off are simply unconverged — the same
    # reject/penalize path as any other unresolved sample.
    adaptive_max_iter: bool = False
    adaptive_margin: float = 4.0


class GANDriver:
    """Runs a WGAN/cWGAN fit. Model-agnostic: the model module supplies
    ``train_step(cfg, n_critic, state, real_stack, key)`` and the config
    supplies ``n_critic``/``n_critic0``/``critic_batch``."""

    def __init__(
        self,
        model_cfg: Any,
        driver_cfg: DriverConfig,
        store: DataStore,
        train_step: Callable,
        state: Any,
        real_sampler: Callable[[jax.Array, int, int], Any],
        checkpoints: Optional[CheckpointManager] = None,
        gen_loss_fn: Optional[Callable] = None,
    ):
        self.model_cfg = model_cfg
        self.cfg = driver_cfg
        self.store = store
        self.train_step = train_step
        self.state = state
        self.real_sampler = real_sampler
        # (cfg, gen_params, critic_params, key) -> (loss, aux): the model's
        # TRUE generator loss, used so the recorded gradient_time matches the
        # reference's semantics (time of the actual training gradient).
        self.gen_loss_fn = gen_loss_fn
        self.checkpoints = checkpoints or CheckpointManager(store.subdir("ckpt"))
        critic_names = list(state.critic_params.keys())
        self.recorders = RecorderSet(store, critic_param_names=critic_names)
        self.watch = StopWatch()
        self._div_streak = 0
        self._tc_mean_fn = None
        self._iter_ema = None  # EMA of healthy-step mean iters (see _adapt)
        self._capped_unhealthy = 0  # escape-valve streak (see _adapt)
        self._orig_max_iter = int(model_cfg.gen.ssn.max_iter)
        # Adaptive-budget state survives resume via a sidecar (the
        # checkpoint holds model state only): without it a resumed run
        # restarts at the original uncapped budget with a disarmed EMA —
        # absent exactly during the divergence outbreaks it exists for.
        if self.cfg.adaptive_max_iter:
            self._restore_adaptive_state()

    def run(self, n_steps: Optional[int] = None, on_step=None):
        n_steps = n_steps if n_steps is not None else self.cfg.n_steps
        start = int(self.state.step)
        if start > 0:
            # Resume: the streams were flushed every step but checkpoints
            # are periodic — drop rows from the replayed window instead of
            # appending a second, divergent set for the same steps.
            self.recorders.truncate_from(start)
        # Fold the starting step into the key so a checkpoint-resumed run
        # draws FRESH data/noise keys instead of replaying the step-0..n
        # sequence. (Note: resumed and uninterrupted runs still use
        # different streams from the resume point — this prevents
        # replay, it does not bit-reproduce an uninterrupted run.)
        key = jax.random.fold_in(jax.random.PRNGKey(self.cfg.seed), start)
        stop = _GracefulStop()
        stop.__enter__()
        try:
            for step in range(start, start + n_steps):
                key, k_data, k_step = jax.random.split(key, 3)
                n_critic = (
                    self.model_cfg.n_critic0
                    if step < self.cfg.n_critic0_steps
                    else self.model_cfg.n_critic
                )
                real_stack = self.real_sampler(
                    k_data, n_critic, self.model_cfg.critic_batch
                )
                with self.watch.time("train"):
                    self.state, metrics = self.train_step(
                        self.model_cfg, n_critic, self.state, real_stack, k_step
                    )
                    jax.block_until_ready(metrics)
                metrics = self._record(step, metrics)  # host copy back
                self._check_divergence(step, metrics)
                if self.cfg.adaptive_max_iter:
                    self._adapt_solver_budget(step, metrics)
                if on_step is not None:
                    on_step(step, self.state, metrics)
                if (self.cfg.checkpoint_every
                        and (step + 1) % self.cfg.checkpoint_every == 0):
                    self.checkpoints.save(step + 1, self.state)
                    self._export_params(step + 1)
                    self._save_adaptive_state()
                if stop.requested:
                    break
            done = int(self.state.step)
            self.checkpoints.save(done, self.state)
            self._export_params(done)
            self._save_adaptive_state()
            self.store.finalize("interrupted" if stop.requested
                                else "finished")
        except PervasiveDivergenceError as e:
            self.store.finalize("known_error", {"error": str(e)})
            raise
        except BaseException:
            self.store.finalize("crashed")
            raise
        finally:
            stop.__exit__()
            self.recorders.close()
        return self.state

    def _export_params(self, step: int):
        """Plain .npz snapshot of critic params + generator values — the
        reference's lasagne `.npz` critic dumps (SURVEY.md §5.4), readable
        without jax."""
        values = gen_lib.param_values(self.model_cfg.gen, self.state.gen_params)
        extra = {}
        if getattr(self.state, "ema_params", None) is not None:
            ema = gen_lib.param_values(self.model_cfg.gen,
                                       self.state.ema_params)
            extra = {f"{n}_ema": np.asarray(v)
                     for n, v in zip(("J", "D", "S"), ema)}
        np.savez(
            self.store.file("disc_params.npz"),
            step=np.asarray(step),
            J=np.asarray(values[0]), D=np.asarray(values[1]),
            S=np.asarray(values[2]),
            **extra,
            **{k: np.asarray(v) for k, v in self.state.critic_params.items()},
        )

    # -- internals ---------------------------------------------------------

    def _record(self, step: int, metrics):
        if self.cfg.timing_every and step % self.cfg.timing_every == 0:
            self._measure_component_times()
        # ONE device->host sync for everything this step records. Eager jnp
        # ops / per-value fetches here would serialize on device dispatch
        # (measured ~20 round-trips per step before this batching); all
        # derived stats are computed on host NumPy instead.
        metrics, gen_params, critic_params = jax.device_get(
            (metrics, self.state.gen_params, self.state.critic_params))
        row = {k: v for k, v in metrics._asdict().items()
               if not k.endswith("_iters") or k == "mean_iters"}
        row["step"] = step
        row["train_time"] = self.watch.last("train")
        # NaN on steps without a probe: repeating the last lap would be
        # indistinguishable from a fresh measurement in the CSV
        probed = self.cfg.timing_every and step % self.cfg.timing_every == 0
        row["SSsolve_time"] = self.watch.last("SSsolve") if probed else np.nan
        row["gradient_time"] = (self.watch.last("gradient") if probed
                                else np.nan)
        self.recorders.record_learning(row)
        iters_streams = tuple(
            getattr(metrics, n, None)
            for n in ("d_loss_iters", "wasserstein_iters", "gp_iters",
                      "acc_iters"))
        if all(s is not None for s in iters_streams):
            self.recorders.record_disc_learning(step, *iters_streams)
        self.recorders.record_generator(
            step, gen_lib.param_values_np(self.model_cfg.gen, gen_params))
        self.recorders.record_disc_stats(step, {
            f"{k}.{s}": v
            for k, p in critic_params.items()
            for s, v in (("nnorm", float(np.linalg.norm(p.ravel()))),
                         ("absmax", float(np.max(np.abs(p)))))
        })
        if self.cfg.tc_mean_every and step % self.cfg.tc_mean_every == 0:
            if self._tc_mean_fn is None:
                gen_cfg = self.model_cfg.gen
                batch = self.model_cfg.batch_size
                self._tc_mean_fn = jax.jit(
                    lambda p, k: gen_lib.sample_tuning_curves(
                        gen_cfg, p, k, batch).tc.mean(axis=0)
                )
            tc_mean = self._tc_mean_fn(self.state.gen_params,
                                       jax.random.PRNGKey(step))
            self.recorders.record_tc_mean(step, np.asarray(tc_mean))
        return metrics  # host copy, for divergence checks / callbacks

    def _measure_component_times(self):
        """Instrument the reference's SSsolve_time / gradient_time columns
        (SURVEY.md §5.1): wall-clock of a forward batch solve and of a full
        generator value_and_grad, measured out-of-band of the train step."""
        import jax.numpy as jnp

        if not hasattr(self, "_solve_fn"):
            gen_cfg = self.model_cfg.gen
            batch = self.model_cfg.batch_size
            self._solve_fn = jax.jit(
                lambda p, k: gen_lib.sample_tuning_curves(gen_cfg, p, k,
                                                          batch).rates)
            if self.gen_loss_fn is not None:
                model_cfg, loss = self.model_cfg, self.gen_loss_fn
                self._grad_fn = jax.jit(jax.grad(
                    lambda p, cp, k: loss(model_cfg, p, cp, k)[0]))
            else:
                # fallback probe when no model loss was supplied
                self._grad_fn = jax.jit(jax.grad(
                    lambda p, cp, k: jnp.mean(
                        gen_lib.sample_tuning_curves(gen_cfg, p, k, batch).tc)))
            # warm both compiles outside the timed region
            key = jax.random.PRNGKey(0)
            jax.block_until_ready(self._solve_fn(self.state.gen_params, key))
            jax.block_until_ready(self._grad_fn(
                self.state.gen_params, self.state.critic_params, key))
        key = jax.random.PRNGKey(int(self.state.step))
        with self.watch.time("SSsolve"):
            jax.block_until_ready(self._solve_fn(self.state.gen_params, key))
        with self.watch.time("gradient"):
            jax.block_until_ready(self._grad_fn(
                self.state.gen_params, self.state.critic_params, key))

    def _adapt_solver_budget(self, step: int, metrics):
        """Adaptive train-time max_iter (see DriverConfig.adaptive_max_iter).

        Healthy steps (>=90% converged) update an EMA of the batch's mean
        iteration count; the solver budget is then clamped to
        ``adaptive_margin x EMA`` rounded up to a power of two (floor 1024,
        ceiling the configured max_iter). Unhealthy steps do NOT update the
        EMA, so a divergence outbreak keeps the healthy-era cap and cannot
        inflate its own budget."""
        import math

        fconv = float(metrics.frac_converged)
        miters = float(metrics.mean_iters)
        capped = self.model_cfg.gen.ssn.max_iter < self._orig_max_iter
        if fconv >= 0.9 and math.isfinite(miters) and miters > 0:
            self._iter_ema = (miters if self._iter_ema is None
                              else 0.95 * self._iter_ema + 0.05 * miters)
            self._capped_unhealthy = 0
        elif capped:
            # Escape valve: if the cap itself is what keeps the batch
            # unhealthy (a legitimately slow tail now reads "unconverged"
            # and the EMA gate never fires again — an absorbing state),
            # raise the EMA one bucket after a sustained unhealthy streak.
            # A genuine divergence outbreak is bounded by the original
            # max_iter (pre-feature behavior) and by divergence_abort.
            self._capped_unhealthy += 1
            if self._capped_unhealthy >= 50:
                self._iter_ema *= 2.0
                self._capped_unhealthy = 0
                print(f"[driver] step {step}: adaptive budget escape valve"
                      f" — <90% converged for 50 capped steps, EMA -> "
                      f"{self._iter_ema:.0f}")
        if self._iter_ema is None:
            return
        target = self.cfg.adaptive_margin * self._iter_ema
        bucket = 1 << max(10, math.ceil(math.log2(max(target, 1.0))))
        bucket = min(bucket, self._orig_max_iter)
        ssn = self.model_cfg.gen.ssn
        if bucket != ssn.max_iter:
            print(f"[driver] step {step}: adaptive solver budget "
                  f"max_iter {ssn.max_iter} -> {bucket} "
                  f"(healthy mean iters EMA {self._iter_ema:.0f})")
            gen = dataclasses.replace(
                self.model_cfg.gen,
                ssn=dataclasses.replace(ssn, max_iter=bucket))
            self.model_cfg = dataclasses.replace(self.model_cfg, gen=gen)
            # The timing probes and the tc_mean snapshot close over the
            # OLD gen config — rebuild them on the new budget, or every
            # recorded SSsolve/gradient probe keeps paying the stale
            # (typically uncapped) solver cost the cap exists to remove.
            for attr in ("_solve_fn", "_grad_fn"):
                if hasattr(self, attr):
                    delattr(self, attr)
            self._tc_mean_fn = None

    _ADAPTIVE_SIDECAR = "adaptive_budget.json"

    def _save_adaptive_state(self):
        import json

        if not self.cfg.adaptive_max_iter or self._iter_ema is None:
            return
        path = self.store.file(self._ADAPTIVE_SIDECAR)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            "iter_ema": self._iter_ema,
            "max_iter": int(self.model_cfg.gen.ssn.max_iter)}))
        import os

        os.replace(tmp, path)

    def _restore_adaptive_state(self):
        import json

        path = self.store.file(self._ADAPTIVE_SIDECAR)
        try:
            saved = json.loads(path.read_text())
        except (OSError, ValueError):
            return
        self._iter_ema = float(saved["iter_ema"])
        bucket = min(int(saved["max_iter"]), self._orig_max_iter)
        if bucket < self._orig_max_iter:
            print(f"[driver] resume: restoring adaptive solver budget "
                  f"max_iter -> {bucket} (EMA {self._iter_ema:.0f})")
            gen = dataclasses.replace(
                self.model_cfg.gen,
                ssn=dataclasses.replace(self.model_cfg.gen.ssn,
                                        max_iter=bucket))
            self.model_cfg = dataclasses.replace(self.model_cfg, gen=gen)

    def _check_divergence(self, step: int, metrics):
        self._div_streak = _divergence_streak(
            self._div_streak, float(metrics.frac_diverged), self.cfg, step)


class MomentMatchingDriver:
    """Driver for the non-adversarial moment-matching fit (reference:
    ``run/bptt_moments.py`` flow, SURVEY.md §3.5)."""

    def __init__(self, model_cfg, driver_cfg: DriverConfig, store: DataStore,
                 train_step: Callable, state, data_moments,
                 checkpoints: Optional[CheckpointManager] = None):
        self.model_cfg = model_cfg
        self.cfg = driver_cfg
        self.store = store
        self.train_step = train_step
        self.state = state
        self.data_mean, self.data_second = data_moments
        self.checkpoints = checkpoints or CheckpointManager(store.subdir("ckpt"))
        self._learning = CSVRecorder(
            store.file("learning.csv"),
            ["step", "loss", "mean_err", "cov_err", "rate_penalty",
             "frac_converged", "frac_diverged", "train_time"],
        )
        self._jsonl = JSONLRecorder(store.file("learning.jsonl"))
        self._gen = CSVRecorder(store.file("generator.csv"), GEN_COLUMNS)
        self.watch = StopWatch()
        self._div_streak = 0

    def run(self, n_steps: Optional[int] = None, on_step=None):
        n_steps = n_steps if n_steps is not None else self.cfg.n_steps
        start = int(self.state.step)
        if start > 0:
            # As in GANDriver.run: drop the replayed window's rows.
            for rec in (self._learning, self._jsonl, self._gen):
                rec.truncate_from(start)
        # As in GANDriver.run: fresh keys after resume (no replay).
        key = jax.random.fold_in(jax.random.PRNGKey(self.cfg.seed), start)
        stop = _GracefulStop()  # see GANDriver.run: preemption-safe stop
        stop.__enter__()
        try:
            for step in range(start, start + n_steps):
                key, k_step = jax.random.split(key)
                with self.watch.time("train"):
                    self.state, m = self.train_step(
                        self.model_cfg, self.state, self.data_mean,
                        self.data_second, k_step,
                    )
                    jax.block_until_ready(m)
                # one device->host sync per step (see GANDriver._record)
                m, gen_params = jax.device_get((m, self.state.gen_params))
                row = dict(step=step, loss=m.loss, mean_err=m.mean_err,
                           cov_err=m.cov_err, rate_penalty=m.rate_penalty,
                           frac_converged=m.frac_converged,
                           frac_diverged=m.frac_diverged,
                           train_time=self.watch.last("train"))
                self._learning.record(row)
                self._jsonl.record(row)
                g = {"step": step}
                g.update(flatten_gen_params(
                    gen_lib.param_values_np(self.model_cfg.gen, gen_params)))
                self._gen.record(g)
                self._div_streak = _divergence_streak(
                    self._div_streak, float(m.frac_diverged), self.cfg, step)
                if on_step is not None:
                    on_step(step, self.state, m)
                if (self.cfg.checkpoint_every
                        and (step + 1) % self.cfg.checkpoint_every == 0):
                    self.checkpoints.save(step + 1, self.state)
                if stop.requested:
                    break
            self.checkpoints.save(int(self.state.step), self.state)
            self.store.finalize("interrupted" if stop.requested
                                else "finished")
        except PervasiveDivergenceError as e:
            self.store.finalize("known_error", {"error": str(e)})
            raise
        except BaseException:
            self.store.finalize("crashed")
            raise
        finally:
            stop.__exit__()
            self._learning.close()
            self._jsonl.close()
            self._gen.close()
        return self.state
