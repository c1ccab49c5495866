"""WGAN-GP training assembly: losses, optimizers, fused train step.

Reference parity: ``tc_gan/networks/bptt_gan.py`` (SURVEY.md §2 "BPTT WGAN",
§3.1) — WGAN with gradient penalty [PAPERS.md: Gulrajani et al. 1704.00028],
two-timescale Adam [PAPERS.md: TTUR], per-step schedule of
``critic_iters`` discriminator updates then one generator update, and the
rate penalty on runaway circuits.

Deviations from the reference's structure (behavior preserved):

- The reference compiled separate ``train_discriminator`` /
  ``train_generator`` Theano functions and looped in Python. Here the WHOLE
  GAN step — ``n_critic`` critic updates (a ``lax.scan``) followed by one
  generator update — is a single jitted function, so the schedule runs
  on-device without host round-trips.
- The gradient penalty differentiates the critic w.r.t. its *input* only
  (per the WGAN-GP objective), so no second-order autodiff through the SSN
  solver is needed; the generator update backprops through the solver via
  the custom_vjp IFT rule (or BPTT scan).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from tcgan_tpu.models import critic as critic_lib
from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.models.critic import CriticConfig
from tcgan_tpu.models.generator import GeneratorConfig


@dataclasses.dataclass(frozen=True)
class WGANConfig:
    """Static GAN hyper-parameters (reference flag family, SURVEY.md §5.6)."""

    gen: GeneratorConfig = GeneratorConfig()
    critic_layers: Tuple[int, ...] = (128, 128)
    batch_size: int = 64  # circuits sampled per generator-side batch
    gp_lambda: float = 10.0  # --WGAN_lambda
    n_critic: int = 5  # --WGAN_n_critic (steady state)
    n_critic0: int = 50  # --WGAN_n_critic0 (first step warm-up)
    lr_gen: float = 1e-4
    lr_critic: float = 1e-3
    beta1: float = 0.5
    beta2: float = 0.9
    rate_cost: float = 0.01  # generator penalty on rates above soft bound
    clip_grad: float = 0.0  # global-norm gradient clip (0 = off)
    # Reject non-converged fake samples from the critic objective (the
    # reference fixed-point GAN's semantics, SURVEY.md §3.4): fake-truth
    # DATA keeps only circuits whose every condition converged, so scoring
    # ceiling-clamped unconverged fakes against survivor-only data hands
    # the critic a spurious outlier signal that pushes the generator away
    # from any truth that occasionally diverges (measured for the moment
    # objective in BASELINE.md round-2b; same mechanism here). Off by
    # default: with the standard batteries convergence is ~100% and the
    # masking is a no-op.
    reject_unconverged: bool = False
    # exponential lr decay: lr * rate^(step/steps); 0 steps = constant lr
    lr_decay_steps: int = 0
    lr_decay_rate: float = 0.5
    # Critic-cooling endgame (first-class version of the round-4 flagship
    # phase-6 resume, BASELINE.md rec13anchor4): once the generator is
    # inside ~10% of truth, the critic's Adam-normalized pull is ~90x
    # weaker than the moment anchor's and is pure bias tax
    # (docs/artifacts/anchor_equilibrium_probe.json) — its useful work
    # (early landscape navigation, where the pure anchor is slower and
    # the pure WGAN stalls at 25%+) is over. gen_lr_floor > 0 clamps the
    # generator's exponential decay at that value; gen_lr_switch_step > 0
    # hard-switches the ADVERSARIAL generator lr to the floor at that
    # step (the anchor's own lr is untouched), so one run IS the whole
    # early-adversarial -> anchor-endgame schedule with no mid-run
    # resume. The critic keeps training throughout — only the
    # generator's response to it cools — so the learning.csv witness
    # stream stays comparable across the phase boundary.
    gen_lr_floor: float = 0.0
    gen_lr_switch_step: int = 0
    # Auto endgame trigger (0 = off): when the anchor's debiased EMA
    # residual first drops below this value, latch the endgame — from
    # then on the adversarial generator lr is gen_lr_floor, exactly as
    # if gen_lr_switch_step had fired. Requires moment_anchor > 0 (the
    # residual is the anchor's own whitened objective; pick the
    # threshold as k x the run's measured data floor — the flagship's
    # was ~2e-5 at equilibrium vs a 7.8e-6 noise floor). Latched in
    # TrainState.endgame so a residual that wanders back up cannot
    # re-heat the schedule.
    gen_lr_switch_residual: float = 0.0
    # Arming step for the residual trigger (live measurement, flagship
    # rec13recipe5 step 205): on a RIDGE start the whitened moment
    # residual is small BOTH at the start (moments barely move along the
    # ridge — that is what makes it a ridge) and near truth, so an
    # unarmed threshold latches on the warm-up/ridge artifact and cools
    # the critic before its early-game work. The residual trigger only
    # arms from this step on; the gen_lr_switch_step hard backstop is
    # unaffected.
    gen_lr_switch_min_step: int = 0
    # critic-side decay horizon: -1 = follow lr_decay_steps; 0 = constant
    # critic lr even when the generator decays. Keeping the critic lr
    # undecayed preserves its per-batch signal on heavy-tailed
    # (near-critical) conditions after the generator schedule has cooled
    # (BASELINE.md rec13 stall diagnosis).
    critic_lr_decay_steps: int = -1
    # exponential moving average of the generator params (0 = off) — a
    # cheap variance-reduction lever for the recovered parameter estimate
    ema_decay: float = 0.0
    seed: int = 0
    # per-feature critic input scale (1/mean TC of the dataset when the
    # --normalize-input knob is on); None = raw inputs
    input_scale: Tuple[float, ...] | None = None
    # Moment-anchor hybrid objective (--moment-anchor): per GAN step,
    # apply ONE extra Adam update to the generator on the survivor-masked,
    # EMA-averaged moment-matching residual (models/moments.py), with this
    # value as that update's OWN learn rate (0 = off; typical = the mm lr,
    # 1e-3). A separate optimizer — rather than a weighted loss sum —
    # because Adam is scale-invariant per objective: a summed loss lets
    # the adversarial gradient's arbitrary scale mute the anchor (measured
    # 15:1 at a 35% J offset with an untrained critic), whereas composed
    # updates weight the two pulls by their lr ratio alone. Rationale
    # (BASELINE.md round-3 discriminability-vs-scale probe): on
    # ridge-dominated batteries the per-sample witness signal vanishes
    # part-way down the ridge, so a sample-trained critic goes blind
    # before truth; the moment term's FIXED witness accumulates
    # dataset-level signal across steps via the EMA (the mechanism that
    # recovered mm13fix to CRLB scale), while the adversarial term keeps
    # distribution-level fidelity beyond second moments.
    moment_anchor: float = 0.0
    # EMA decay for the anchor's generated moments (ignored when
    # moment_anchor == 0); effective sample count ~ batch/(1-gamma)
    moment_ema: float = 0.995
    # Two-phase anchor gamma (round-4c orbit-damping sweep, BASELINE.md):
    # switch the anchor EMA's decay from moment_ema to anchor_ema_late at
    # GAN step anchor_ema_switch_step (0 = off). Long windows carry the
    # ridge DESCENT; gamma 0.98 measured a 10x orbit-amplitude collapse
    # near truth with no D starvation — descend-then-damp in one run,
    # composable with the gen_lr_switch_* critic cooling.
    anchor_ema_late: float = 0.0
    anchor_ema_switch_step: int = 0
    # Drift-latched late gamma (round-5 rec13recipe5 + rec13gammactl
    # counterfactual, BASELINE.md flagship findings 4-6): a step-count
    # gamma switch tuned on J froze D's remaining -10% bias the moment it
    # fired mid-descent — the fast gamma rectifies residual noise into a
    # static offset for any family still systematically moving, while
    # the same gamma is the measured optimum once motion is orbit-like.
    # With anchor_ema_switch_drift > 0 the late gamma engages via a LATCH
    # on the observable (truth-free) drift ratio instead of the step
    # count: per parameter component, |EMA(delta)| / EMA(|delta|) is ~1
    # during directional descent and ~0 inside a limit cycle; the latch
    # fires when the MAX over components first drops below this
    # threshold (so no family that is still descending can be frozen),
    # and anchor_ema_switch_step becomes the ARMING step (no latch
    # before it; 0 = armed from the start — safe, the ratio starts at
    # exactly 1). Both EMAs share anchor_drift_ema, so the warm-up
    # debias factor cancels in the ratio.
    # MEASURED CAVEAT (round-5 driftlatch5 live probe): at production
    # per-step SNR (~0.006) this ratio decays to its ~0.02 noise floor
    # within ~200 steps REGARDLESS of whether the family is descending —
    # any threshold above that floor fires at the arming step, and no
    # threshold separates the phases. Prefer anchor_ema_switch_vel
    # (below), whose statistic tracks the true velocity at these SNRs.
    anchor_ema_switch_drift: float = 0.0
    # Velocity-latched late gamma — the round-5 driftlatch5 live probe's
    # replacement for the ratio detector above, calibrated on measured
    # dynamics (docs/artifacts/driftlatch5_summary.json): per-step
    # parameter deltas under Adam are noise-dominated (E|dlog p| ~6e-3
    # per step vs net motion ~4e-5 per step, SNR ~0.006), so the
    # |EMA(d)|/EMA(|d|) ratio sits at its ~0.02 noise floor even while D
    # is descending at 2-4%/1k — it fired at the arming step mid-descent,
    # the very defect it fences. The debiased EMA of the deltas, by
    # contrast, tracks the true per-family velocity within ~1-2%/1k after
    # a few-hundred-step warm-up (Adam's jitter is anti-persistent, so it
    # cancels much faster than sqrt(N)). This trigger latches the late
    # gamma when the MAX over components of the smoothed relative
    # velocity |debiased EMA(delta)| (log-space params: already relative;
    # raw space: divided by |p|) first drops below this threshold, in
    # %-per-1000-steps units: measured regimes are descent 3-5.5, shell
    # rotation ~1.1 (finding 7 — must NOT latch), damped near-truth hold
    # << 1 (round-4c gamma-0.98 sweep). Recommended threshold 1.0;
    # anchor_ema_switch_step is the arming step as for the ratio mode.
    # Mutually exclusive with anchor_ema_switch_drift (error-loudly).
    anchor_ema_switch_vel: float = 0.0
    anchor_drift_ema: float = 0.995  # ~200-step window at the default
    moment_eps: float = 1e-2  # moment-normalization floor (as in mm)
    # beta1 for the anchor's OWN Adam (None = the WGAN beta1, 0.5). The
    # anchor's drift per step is ~lr x gradient-SNR; along the weakly
    # identified J/D ridge the per-step SNR is tiny (the rec13anchor3
    # D stall), and heavier momentum averages the gradient over
    # ~1/(1-beta1) steps with only that much lag — variance reduction
    # the moment EMA can only buy at 10-20x the lag (gamma 0.98 lags
    # ~50 steps; beta1 0.9 lags ~10). Measured caution (rec13anchor3
    # phase-2 blowup, BASELINE.md): lr 1e-2 + beta1 0.9 destabilized the
    # production battery within ~500 steps — raise the UPDATE COUNT
    # (anchor_updates), not the step size.
    anchor_beta1: float | None = None
    # Anchor Adam updates per GAN step (fresh generator batch each).
    # The anchor's parameter drift is throughput-limited (lr x per-update
    # SNR), and one solver pass per update is ~1/7 of the GAN step's
    # solver passes (n_critic fake draws + gen fwd/bwd + anchor) — so K
    # anchor updates multiply ridge-direction progress per GAN step ~Kx
    # at ~(6+K)/7x step cost, where raising lr past the stability edge
    # simply diverges. The adversarial and anchor pulls still compose
    # sequentially; the critic trains at the SAME cadence.
    anchor_updates: int = 1

    @property
    def critic_cfg(self) -> CriticConfig:
        return CriticConfig(
            in_dim=self.gen.tc_dim, layers=self.critic_layers,
            dtype=self.gen.dtype, input_scale=self.input_scale,
        )

    @property
    def critic_batch(self) -> int:
        """Number of critic-side samples one generator batch yields."""
        return self.batch_size * self.gen.samples_per_circuit()


class TrainState(NamedTuple):
    gen_params: Dict[str, jnp.ndarray]
    gen_opt: Any
    critic_params: Dict[str, jnp.ndarray]
    critic_opt: Any
    step: jnp.ndarray
    # EMA of gen_params when cfg.ema_decay > 0, else None (empty pytree)
    ema_params: Any = None
    # moment-anchor buffers (cfg.moment_anchor > 0 only; else None):
    # frozen data moments + running EMA of generated moments + the
    # anchor's own Adam state
    data_mean: Any = None
    data_second: Any = None
    mom_ema_mean: Any = None
    mom_ema_second: Any = None
    # batches actually blended into the EMA (zero-survivor batches hold
    # it), so the debias factor matches the accumulated mass
    mom_ema_count: Any = None
    anchor_opt: Any = None
    # Critic-cooling auto-trigger latch (cfg.gen_lr_switch_residual > 0
    # only; else None): bool scalar, flips once when the anchor residual
    # first crosses the threshold and never flips back.
    endgame: Any = None
    # Drift-latched late-gamma state (cfg.anchor_ema_switch_drift > 0
    # only; else None, so checkpoints from runs without the feature keep
    # their tree structure): EMAs of the per-step parameter deltas
    # (signed, and absolute) plus the one-way latch bool.
    drift_dir: Any = None
    drift_mag: Any = None
    gamma_late: Any = None


class StepMetrics(NamedTuple):
    """Per-step learning stats (the reference's learning.csv columns,
    SURVEY.md §2 "Recorders")."""

    d_loss: jnp.ndarray
    g_loss: jnp.ndarray
    wasserstein: jnp.ndarray  # E[D(real)] - E[D(fake)] (critic advantage)
    gp: jnp.ndarray
    rate_penalty: jnp.ndarray
    frac_converged: jnp.ndarray
    frac_diverged: jnp.ndarray
    mean_iters: jnp.ndarray
    d_accuracy: jnp.ndarray  # fraction of pairs ranked correctly
    # per-critic-iteration traces, shape (n_critic,) — the reference's
    # DiscLearningRecorder stream (SURVEY.md §2 "Recorders"); None when a
    # producer does not track them
    d_loss_iters: jnp.ndarray | None = None
    wasserstein_iters: jnp.ndarray | None = None
    gp_iters: jnp.ndarray | None = None
    acc_iters: jnp.ndarray | None = None
    # moment-anchor residual (cfg.moment_anchor > 0 only; recorded in the
    # learning.jsonl stream so a silently-stuck anchor is observable)
    anchor_residual: jnp.ndarray | None = None
    # fraction of generated circuits whose EVERY battery condition
    # converged — the survivor yield the rejection mask keys on. A yield
    # collapse (the rec13anchor absorbing state) is visible here long
    # before frac_diverged looks alarming: at 24 conditions/circuit, 9%
    # per-solve divergence is ~0% circuit yield.
    circuit_yield: jnp.ndarray | None = None
    # max-over-components |EMA(delta)|/EMA(|delta|) drift ratio
    # (cfg.anchor_ema_switch_drift > 0 only) — recorded so the latch
    # threshold is tunable from the learning stream, like anchor_residual
    drift_ratio: jnp.ndarray | None = None


def gen_lr_schedule(cfg: WGANConfig):
    """The ADVERSARIAL generator lr as a function of step count: the
    exponential decay, clamped below at ``gen_lr_floor``, hard-switched to
    the floor from ``gen_lr_switch_step`` on (see the WGANConfig field
    docs — this is the one-run form of the flagship's phase-6 endgame
    resume). Returns an optax schedule (callable step -> lr)."""
    if cfg.lr_decay_steps > 0:
        base = optax.exponential_decay(
            cfg.lr_gen, cfg.lr_decay_steps, cfg.lr_decay_rate,
            end_value=cfg.gen_lr_floor if cfg.gen_lr_floor > 0 else None)
    else:
        base = optax.constant_schedule(cfg.lr_gen)
    if cfg.gen_lr_switch_step <= 0:
        return base
    switch, floor = cfg.gen_lr_switch_step, cfg.gen_lr_floor

    def sched(count):
        return jnp.where(count >= switch, floor, base(count))

    return sched


def make_optimizers(cfg: WGANConfig):
    def tx(lr):
        adam = optax.adam(lr, b1=cfg.beta1, b2=cfg.beta2)
        if cfg.clip_grad > 0:
            adam = optax.chain(optax.clip_by_global_norm(cfg.clip_grad),
                               adam)
        # Skip (don't apply) any update containing non-finite values
        # instead of corrupting the whole training state — the GAN analog
        # of the reference's reject-the-bad-sample semantics for the rare
        # step where a loss/grad overflows despite the solver-side clamps.
        return optax.apply_if_finite(adam, max_consecutive_errors=100)

    critic_decay = (cfg.lr_decay_steps if cfg.critic_lr_decay_steps < 0
                    else cfg.critic_lr_decay_steps)
    critic_lr = cfg.lr_critic
    if critic_decay > 0:
        critic_lr = optax.exponential_decay(cfg.lr_critic, critic_decay,
                                            cfg.lr_decay_rate)
    return tx(gen_lr_schedule(cfg)), tx(critic_lr)


def make_anchor_optimizer(cfg: WGANConfig):
    """The anchor's own Adam (see WGANConfig.moment_anchor): constant lr =
    moment_anchor, the WGAN betas (beta1 overridable via anchor_beta1),
    same clip/finite guards."""
    b1 = cfg.beta1 if cfg.anchor_beta1 is None else cfg.anchor_beta1
    adam = optax.adam(cfg.moment_anchor, b1=b1, b2=cfg.beta2)
    if cfg.clip_grad > 0:
        adam = optax.chain(optax.clip_by_global_norm(cfg.clip_grad), adam)
    return optax.apply_if_finite(adam, max_consecutive_errors=100)


def anchor_buffers(cfg, data_moments, gen_params) -> dict:
    """TrainState moment-anchor buffer fields for ``init_state``:
    frozen data moments + zero-initialized generated-moment EMA (debiased
    in the loss, as in models/moments.py) + the anchor Adam state.
    Shared with cwgan.init_state."""
    if cfg.moment_anchor <= 0:
        return {}
    if data_moments is None:
        raise ValueError("moment_anchor > 0 requires data_moments="
                         "(mean, second) at init_state time")
    dm, ds = data_moments
    dtype = cfg.gen.dtype
    return dict(
        data_mean=jnp.asarray(dm, dtype),
        data_second=jnp.asarray(ds, dtype),
        mom_ema_mean=jnp.zeros(jnp.shape(dm), dtype),
        mom_ema_second=jnp.zeros(jnp.shape(ds), dtype),
        mom_ema_count=jnp.zeros((), dtype),
        anchor_opt=make_anchor_optimizer(cfg).init(gen_params),
    )


def init_state(cfg: WGANConfig, key: jax.Array | None = None,
               gen_init: Dict[str, jnp.ndarray] | None = None,
               data_moments=None) -> TrainState:
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    kc, _ = jax.random.split(key)
    gen_params = gen_init if gen_init is not None else gen_lib.init_params(cfg.gen)
    critic_params = critic_lib.init_params(cfg.critic_cfg, kc)
    gen_tx, critic_tx = make_optimizers(cfg)
    if cfg.gen_lr_switch_residual > 0 and cfg.moment_anchor <= 0:
        raise ValueError("gen_lr_switch_residual triggers on the moment "
                         "anchor's residual — it requires moment_anchor > 0")
    if cfg.anchor_ema_late > 0 and cfg.moment_anchor <= 0:
        raise ValueError("anchor_ema_late schedules the moment anchor's "
                         "EMA — it requires moment_anchor > 0 (same "
                         "error-loudly rule as moments.moment_ema_late)")
    if cfg.anchor_ema_switch_drift > 0 and cfg.anchor_ema_late <= 0:
        raise ValueError("anchor_ema_switch_drift latches the LATE anchor "
                         "gamma — it requires anchor_ema_late > 0 "
                         "(error-loudly rule: a drift threshold with no "
                         "late gamma to switch to would be silently inert)")
    if cfg.anchor_ema_switch_vel > 0 and cfg.anchor_ema_late <= 0:
        raise ValueError("anchor_ema_switch_vel latches the LATE anchor "
                         "gamma — it requires anchor_ema_late > 0 "
                         "(same error-loudly rule as the drift-ratio "
                         "trigger)")
    if cfg.anchor_ema_switch_vel > 0 and cfg.anchor_ema_switch_drift > 0:
        raise ValueError("anchor_ema_switch_vel and anchor_ema_switch_drift "
                         "are two detectors for the same latch — pick one "
                         "(the velocity trigger is the measured-calibration "
                         "recommendation; see the WGANConfig field docs)")
    drift = cfg.anchor_ema_switch_drift > 0 or cfg.anchor_ema_switch_vel > 0
    return TrainState(
        gen_params=gen_params,
        gen_opt=gen_tx.init(gen_params),
        critic_params=critic_params,
        critic_opt=critic_tx.init(critic_params),
        step=jnp.zeros((), jnp.int32),
        ema_params=(jax.tree.map(jnp.copy, gen_params)
                    if cfg.ema_decay > 0 else None),
        endgame=(jnp.zeros((), bool)
                 if cfg.gen_lr_switch_residual > 0 else None),
        drift_dir=(jax.tree.map(jnp.zeros_like, gen_params)
                   if drift else None),
        drift_mag=(jax.tree.map(jnp.zeros_like, gen_params)
                   if drift else None),
        gamma_late=jnp.zeros((), bool) if drift else None,
        **anchor_buffers(cfg, data_moments, gen_params),
    )


def gradient_penalty(cfg: WGANConfig, critic_params, real, fake, key):
    """WGAN-GP interpolate penalty: lambda * E[(||grad_xhat D|| - 1)^2]."""
    eps = jax.random.uniform(key, (real.shape[0],) + (1,) * (real.ndim - 1),
                             dtype=real.dtype)
    xhat = eps * real + (1.0 - eps) * fake

    def score(x):
        return critic_lib.apply(cfg.critic_cfg, critic_params, x)

    grads = jax.vmap(jax.grad(lambda x: score(x[None])[0]))(xhat)
    norms = jnp.sqrt(jnp.sum(grads**2, axis=tuple(range(1, grads.ndim))) + 1e-12)
    return jnp.mean((norms - 1.0) ** 2)


# Per-circuit survivor weights with the absorbing-state soft fallback —
# shared with the moment matcher (single implementation; see its docstring
# for the semantics and the rec13anchor absorbing-state rationale). The
# _wmean unweighted fallback below remains as the final guard for a batch
# where not even one solve converged.
from tcgan_tpu.models.moments import survivor_chain as _survivor_chain  # noqa: E402


def survivor_weights(cfg, out) -> jnp.ndarray:
    """Per-critic-sample weights matching the fake-truth dataset's
    survivor selection (see _survivor_chain). Per CIRCUIT, broadcast over
    that circuit's critic samples."""
    ok = _survivor_chain(out.converged, cfg.gen.dtype)  # (B,)
    if cfg.gen.track_offset_identity:
        return ok
    return jnp.repeat(ok, cfg.gen.samples_per_circuit())


def fake_sample_weights(cfg: WGANConfig, out) -> jnp.ndarray | None:
    """Survivor weights for the critic objective when
    ``reject_unconverged`` is on; None (no masking) when off."""
    if not cfg.reject_unconverged:
        return None
    return survivor_weights(cfg, out)


def _wmean(x, w):
    if w is None:
        return jnp.mean(x)
    # Degeneracy guard: if EVERY row is masked out (observed when
    # reject_unconverged meets a batch with no fully-converged circuit —
    # rec13d blow-up), fall back to the unweighted mean. A silent zero here
    # deletes the fake term from the critic loss, whose maximization of
    # E[D(real)] is then unbounded (W -> 1e5, GP explosion).
    total = jnp.sum(w)
    return jnp.where(total > 0.0,
                     jnp.sum(x * w) / jnp.maximum(total, 1e-12),
                     jnp.mean(x))


def critic_loss_fn(cfg: WGANConfig, critic_params, real, fake, key,
                   fake_w=None):
    d_real = critic_lib.apply(cfg.critic_cfg, critic_params, real)
    d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, fake)
    # With rejection on, keep the GP interpolates away from the rejected
    # (ceiling-clamped) fakes too — otherwise the penalty still forces
    # unit critic slope along real->outlier rays, partially re-creating
    # the spurious signal the masking removes. Substituting real rows for
    # rejected fakes keeps interpolates in-distribution (GP is a slope
    # regularizer, not a distribution estimate).
    fake_gp = fake
    if fake_w is not None:
        fake_gp = jnp.where(fake_w[:, None] > 0.5, fake,
                            real[: fake.shape[0]])
    gp = gradient_penalty(cfg, critic_params, real, fake_gp, key)
    wasserstein = jnp.mean(d_real) - _wmean(d_fake, fake_w)
    loss = -wasserstein + cfg.gp_lambda * gp
    # rank accuracy: how often a real sample outscores a (valid) fake one
    pairs = (d_real[:, None] > d_fake[None, :]).astype(real.dtype)
    if fake_w is None:
        acc = jnp.mean(pairs)
    else:
        acc = jnp.sum(pairs * fake_w[None, :]) / jnp.maximum(
            d_real.shape[0] * jnp.sum(fake_w), 1.0)
    return loss, (wasserstein, gp, acc)


def gen_loss_fn(cfg: WGANConfig, gen_params, critic_params, key):
    out = gen_lib.sample_tuning_curves(cfg.gen, gen_params, key, cfg.batch_size)
    d_fake = critic_lib.apply(cfg.critic_cfg, critic_params, out.tc)
    pen = gen_lib.rate_penalty(cfg.gen, out.rates)
    loss = -_wmean(d_fake, fake_sample_weights(cfg, out)) \
        + cfg.rate_cost * pen
    stats = (
        pen,
        jnp.mean(out.converged.astype(jnp.float32)),
        jnp.mean(out.diverged.astype(jnp.float32)),
        jnp.mean(out.iters.astype(jnp.float32)),
        jnp.mean(jnp.min(out.converged.astype(jnp.float32), axis=-1)),
    )
    return loss, stats


def anchor_gamma(cfg: WGANConfig, state: TrainState):
    """EMA decay for this step's anchor moment blend. Drift-latched mode
    (``anchor_ema_switch_drift > 0``) takes precedence over the step-count
    switch: the late gamma engages when TrainState.gamma_late has latched
    (see next_drift_latch), not at a blind step count — the rec13recipe5
    lesson that a step switch tuned on J froze D's bias mid-descent."""
    latched_mode = (cfg.anchor_ema_switch_drift > 0
                    or cfg.anchor_ema_switch_vel > 0)
    if latched_mode and state.gamma_late is not None:
        return jnp.where(state.gamma_late,
                         jnp.asarray(cfg.anchor_ema_late),
                         jnp.asarray(cfg.moment_ema))
    from tcgan_tpu.models.moments import effective_gamma
    return effective_gamma(cfg, state.step, base=cfg.moment_ema,
                           late=cfg.anchor_ema_late,
                           switch=cfg.anchor_ema_switch_step)


def next_drift_latch(cfg: WGANConfig, state: TrainState, new_gen_params):
    """Advance the drift-latched late-gamma state from this step's actual
    parameter movement (anchor + adversarial combined). Returns
    ``(fields, stat)``: the three TrainState fields as a dict (None-gated
    exactly like anchor_buffers, so the feature is checkpoint-compatible
    when off) and the active detector's scalar statistic for the
    learning stream (recorded under ``drift_ratio`` either way: the
    |EMA|/EMA|.| ratio in drift mode, the %-per-1k velocity in vel
    mode; None when off).

    The detector: per component, ``|EMA(delta)| / EMA(|delta|)`` is ~1
    while the component drifts directionally (descent — D's state when
    the rec13recipe5 step-switch froze it) and falls toward 0 once the
    motion is a limit cycle (J's state, where the fast gamma is the
    measured optimum). Latching on the MAX over components means no
    family still descending can be frozen. Both EMAs share the decay, so
    the zero-init warm-up bias cancels in the ratio (it starts at exactly
    1 — the safe, no-latch side)."""
    if state.drift_dir is None:
        return dict(drift_dir=None, drift_mag=None,
                    gamma_late=state.gamma_late), None
    b = jnp.asarray(cfg.anchor_drift_ema)
    delta = jax.tree.map(lambda n, o: n - o, new_gen_params,
                         state.gen_params)
    drift_dir = jax.tree.map(lambda e, d: b * e + (1.0 - b) * d,
                             state.drift_dir, delta)
    drift_mag = jax.tree.map(lambda e, d: b * e + (1.0 - b) * jnp.abs(d),
                             state.drift_mag, delta)
    armed = (state.step + 1) >= cfg.anchor_ema_switch_step
    if cfg.anchor_ema_switch_vel > 0:
        # Velocity trigger (see WGANConfig.anchor_ema_switch_vel): the
        # statistic is the max over components of the debiased smoothed
        # per-step motion, in %-per-1k-steps. Log-space params make the
        # delta already relative; raw space normalizes by |p|. The
        # debias (1 - b^(step+1)) assumes the drift EMAs started at
        # step 0 — on a resume from a checkpoint that predates the
        # feature, set the arming step past the warm-up (~3/(1-b)
        # steps) instead of trusting the early statistic.
        debias = 1.0 - b ** (state.step.astype(jnp.float32) + 1.0)
        if cfg.gen.param_space == "log":
            rel = [jnp.abs(a) for a in jax.tree.leaves(drift_dir)]
        else:
            rel = [jnp.abs(a) / (jnp.abs(p) + 1e-12)
                   for a, p in zip(jax.tree.leaves(drift_dir),
                                   jax.tree.leaves(new_gen_params))]
        stat = jnp.max(jnp.stack([jnp.max(r) for r in rel])) / debias * 1e5
        fired = jnp.logical_and(armed, stat < cfg.anchor_ema_switch_vel)
    else:
        per_leaf = [jnp.max(jnp.abs(a) / (m + 1e-12))
                    for a, m in zip(jax.tree.leaves(drift_dir),
                                    jax.tree.leaves(drift_mag))]
        stat = jnp.max(jnp.stack(per_leaf))
        fired = jnp.logical_and(armed, stat < cfg.anchor_ema_switch_drift)
    return dict(drift_dir=drift_dir, drift_mag=drift_mag,
                gamma_late=jnp.logical_or(state.gamma_late, fired)), stat


def anchor_loss(cfg, state: TrainState, out):
    """Moment-anchor term (see WGANConfig.moment_anchor): survivor-masked
    EMA-averaged moment residual of the generated TCs against the frozen
    data moments — models/moments.py's objective, evaluated inside the
    GAN's generator update. Returns (loss, new_ema_mean, new_ema_second,
    new_ema_count);
    gradients flow through the current batch's (1 - gamma) contribution."""
    from tcgan_tpu.models.moments import data_moments as batch_moments

    # out.tc rows must be in the same representation the data moments were
    # computed from (joint per-circuit for cwgan, per-probe rows for the
    # unconditional track_offset_identity=False layout) — derive the
    # survivor mask from the ACTUAL row count rather than cfg.gen flags.
    tc = out.tc.reshape(-1, out.tc.shape[-1])
    # per-circuit survivor mask with the absorbing-state fallback chain —
    # an all-rejected batch must not zero the anchor gradient either
    ok = _survivor_chain(out.converged, tc.dtype)  # (B,)
    if tc.shape[0] != ok.shape[0]:
        ok = jnp.repeat(ok, tc.shape[0] // ok.shape[0])
    w = ok
    g = anchor_gamma(cfg, state)
    sg = jax.lax.stop_gradient
    bmean, bsecond = batch_moments(tc, w)
    # Zero-survivor guard: a batch where not even one solve converged
    # yields all-zero weights, and batch_moments then returns zeros — NOT
    # an estimate. Blending those into the EMA would drag the anchor
    # toward zero for ~1/(1-gamma) subsequent steps after the generator
    # recovers, biasing the straight-through residual; hold the EMA
    # instead (the batch's pathwise gradient is already zero through w)
    # and do not advance the update counter, so the debias factor keeps
    # matching the mass actually accumulated.
    has_data = jnp.sum(w) > 0
    new_em = jnp.where(has_data,
                       g * sg(state.mom_ema_mean) + (1 - g) * sg(bmean),
                       sg(state.mom_ema_mean))
    new_es = jnp.where(has_data,
                       g * sg(state.mom_ema_second) + (1 - g) * sg(bsecond),
                       sg(state.mom_ema_second))
    count = (state.mom_ema_count if state.mom_ema_count is not None
             else state.step.astype(bmean.dtype))
    new_count = count + has_data.astype(bmean.dtype)
    debias = jnp.maximum(1.0 - g ** new_count, 1e-12)
    # Straight-through moment estimate: VALUE = the debiased EMA (low-
    # variance residual, ~batch/(1-gamma) effective samples), GRADIENT =
    # the current batch's full-scale pathwise derivative. Unlike the pure
    # moment matcher — where Adam's scale invariance absorbs the EMA's
    # (1-gamma) gradient attenuation — the hybrid objective competes with
    # the adversarial term inside ONE Adam update, so the attenuation
    # would silently mute the anchor (measured: J frozen at the start in
    # the tiny-battery recovery test until this compensation).
    m_mean = sg(new_em / debias) + bmean - sg(bmean)
    m_second = sg(new_es / debias) + bsecond - sg(bsecond)
    wm = 1.0 / (jnp.abs(state.data_mean) + cfg.moment_eps) ** 2
    wc = 1.0 / (jnp.abs(state.data_second) + cfg.moment_eps) ** 2
    me = jnp.mean(wm * (m_mean - state.data_mean) ** 2)
    ce = jnp.mean(wc * (m_second - state.data_second) ** 2)
    return me + ce, new_em, new_es, new_count


def apply_anchor_update(cfg, state: TrainState, gen_params, key_g,
                        gen_cfg=None):
    """Composed moment-anchor update (see WGANConfig.moment_anchor): one
    extra Adam step on the anchor residual, applied AFTER the adversarial
    generator update, with the anchor's own optimizer state. Returns
    (updated params, anchor TrainState fields, anchor residual value).
    Shared with cwgan, which passes the joint-layout ``gen_cfg`` its data
    moments were computed from.

    Cost note: this samples a fresh generator batch (a second SSN solve +
    one more solver backprop per step). Reusing the adversarial update's
    forward would halve that, but the anchor is deliberately evaluated at
    the POST-adversarial-update parameters so the two pulls compose
    sequentially rather than tug at a stale point; measured on the
    production battery the extra pass costs ~15% step time (the adaptive
    solver budget absorbs most of it)."""
    if cfg.moment_anchor <= 0:
        return gen_params, dict(mom_ema_mean=None, mom_ema_second=None,
                                mom_ema_count=None, anchor_opt=None), None
    anchor_tx = make_anchor_optimizer(cfg)
    key_a = jax.random.fold_in(key_g, 1)
    gen_cfg = cfg.gen if gen_cfg is None else gen_cfg

    def one_update(carry, k):
        gp, opt, em, es, cnt = carry
        st = state._replace(mom_ema_mean=em, mom_ema_second=es,
                            mom_ema_count=cnt)

        def anchor_only(gp_):
            out = gen_lib.sample_tuning_curves(gen_cfg, gp_, k,
                                               cfg.batch_size)
            aloss, new_em, new_es, new_count = anchor_loss(cfg, st, out)
            return aloss, (new_em, new_es, new_count)

        (aloss, (em, es, cnt)), a_grads = jax.value_and_grad(
            anchor_only, has_aux=True)(gp)
        a_updates, opt = anchor_tx.update(a_grads, opt, gp)
        gp = optax.apply_updates(gp, a_updates)
        sg = jax.lax.stop_gradient
        return (gp, opt, sg(em), sg(es), sg(cnt)), aloss

    n = max(1, int(cfg.anchor_updates))
    carry = (gen_params, state.anchor_opt, state.mom_ema_mean,
             state.mom_ema_second,
             state.mom_ema_count if state.mom_ema_count is not None
             else state.step.astype(state.data_mean.dtype))
    keys = jax.random.split(key_a, n)
    if n == 1:  # keep the single-update trace shallow (no scan body)
        carry, aloss = one_update(carry, keys[0])
    else:
        carry, alosses = jax.lax.scan(one_update, carry, keys)
        aloss = alosses[-1]
    gen_params, anchor_opt, new_em, new_es, new_count = carry
    return gen_params, dict(
        mom_ema_mean=new_em,
        mom_ema_second=new_es,
        mom_ema_count=new_count,
        anchor_opt=anchor_opt,
    ), aloss


def scale_updates_for_endgame(cfg: WGANConfig, state: TrainState,
                              g_updates):
    """Residual-triggered critic cooling (cfg.gen_lr_switch_residual):
    once TrainState.endgame is latched, rescale the adversarial Adam
    update so its effective lr is ``gen_lr_floor`` — Adam's update is
    linear in lr, so post-optimizer scaling by floor/schedule(step) IS
    Adam at the floor, without a second optimizer state. No-op (returns
    updates unchanged) when the trigger is off. Shared with cwgan."""
    if cfg.gen_lr_switch_residual <= 0 or state.endgame is None:
        return g_updates
    lr_now = gen_lr_schedule(cfg)(state.step)
    # lr_now can be exactly 0 (gen_lr_switch_step fired with floor 0):
    # 0/0 = NaN would poison the params via 0 * NaN (ADVICE r4 #1). A
    # zero schedule already IS the floor, so scale 1 is correct there.
    safe = jnp.where(state.endgame & (lr_now > 0),
                     cfg.gen_lr_floor / jnp.where(lr_now > 0, lr_now, 1.0),
                     1.0)
    return jax.tree.map(lambda u: u * safe, g_updates)


def next_endgame(cfg: WGANConfig, state: TrainState, a_res):
    """Advance the endgame latch from this step's anchor residual (the
    debiased-EMA whitened residual ``anchor_loss`` returns). One-step
    delay by construction: the latch computed here first cools the NEXT
    step's adversarial update. Shared with cwgan."""
    if state.endgame is None:
        return None
    fired = a_res < cfg.gen_lr_switch_residual
    if cfg.gen_lr_switch_min_step > 0:
        fired = jnp.logical_and(fired,
                                state.step >= cfg.gen_lr_switch_min_step)
    return jnp.logical_or(state.endgame, fired)


def train_step_impl(
    cfg: WGANConfig,
    n_critic: int,
    state: TrainState,
    real_stack: jnp.ndarray,  # (n_critic, critic_batch, tc_dim)
    key: jax.Array,
) -> Tuple[TrainState, StepMetrics]:
    """One full GAN step: ``n_critic`` critic updates + 1 generator update,
    entirely on-device. Unjitted implementation — use ``train_step`` (jitted)
    or wrap via tcgan_tpu.parallel for mesh execution."""
    gen_tx, critic_tx = make_optimizers(cfg)
    key_c, key_g = jax.random.split(jax.random.fold_in(key, state.step))

    def critic_update(carry, inp):
        critic_params, critic_opt = carry
        real, k = inp
        k_z, k_gp = jax.random.split(k)
        fout = gen_lib.sample_tuning_curves(
            cfg.gen, state.gen_params, k_z, cfg.batch_size
        )
        fake = jax.lax.stop_gradient(fout.tc)
        fake_w = fake_sample_weights(cfg, fout)
        (loss, (w, gp, acc)), grads = jax.value_and_grad(
            lambda cp: critic_loss_fn(cfg, cp, real, fake, k_gp,
                                      fake_w=fake_w), has_aux=True
        )(critic_params)
        updates, critic_opt = critic_tx.update(grads, critic_opt, critic_params)
        critic_params = optax.apply_updates(critic_params, updates)
        return (critic_params, critic_opt), (loss, w, gp, acc)

    keys_c = jax.random.split(key_c, n_critic)
    (critic_params, critic_opt), (d_losses, ws, gps, accs) = jax.lax.scan(
        critic_update, (state.critic_params, state.critic_opt),
        (real_stack, keys_c),
    )

    (g_loss, (pen, fconv, fdiv, miters, cyield)), g_grads = jax.value_and_grad(
        lambda gp_: gen_loss_fn(cfg, gp_, critic_params, key_g), has_aux=True
    )(state.gen_params)
    g_updates, gen_opt = gen_tx.update(g_grads, state.gen_opt, state.gen_params)
    g_updates = scale_updates_for_endgame(cfg, state, g_updates)
    gen_params = optax.apply_updates(state.gen_params, g_updates)

    gen_params, anchor_state, a_res = apply_anchor_update(
        cfg, state, gen_params, key_g)
    drift_fields, drift_ratio = next_drift_latch(cfg, state, gen_params)

    ema_params = state.ema_params
    if cfg.ema_decay > 0 and ema_params is not None:
        d = cfg.ema_decay
        ema_params = jax.tree.map(lambda e, p: d * e + (1.0 - d) * p,
                                  ema_params, gen_params)

    new_state = TrainState(
        gen_params=gen_params,
        gen_opt=gen_opt,
        critic_params=critic_params,
        critic_opt=critic_opt,
        step=state.step + 1,
        ema_params=ema_params,
        data_mean=state.data_mean,
        data_second=state.data_second,
        endgame=next_endgame(cfg, state, a_res),
        **drift_fields,
        **anchor_state,
    )
    metrics = StepMetrics(
        d_loss=d_losses[-1],
        g_loss=g_loss,
        wasserstein=ws[-1],
        gp=gps[-1],
        rate_penalty=pen,
        frac_converged=fconv,
        frac_diverged=fdiv,
        mean_iters=miters,
        d_accuracy=accs[-1],
        d_loss_iters=d_losses,
        wasserstein_iters=ws,
        gp_iters=gps,
        acc_iters=accs,
        anchor_residual=a_res,
        circuit_yield=cyield,
        drift_ratio=drift_ratio,
    )
    return new_state, metrics


train_step = jax.jit(train_step_impl, static_argnames=("cfg", "n_critic"))
