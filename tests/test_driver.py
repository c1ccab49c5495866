"""Driver-loop tests with a stub train step (fast, no solver) plus a real
tiny end-to-end moment-matching run.

Reference test analog: driver/smoke tier of SURVEY.md §4."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.models import moments as mm_lib
from tcgan_tpu.models import wgan as wgan_lib
from tcgan_tpu.models.generator import GeneratorConfig
from tcgan_tpu.models.wgan import StepMetrics, TrainState
from tcgan_tpu.ops.ssn import SSNConfig
from tcgan_tpu.train.datastore import DataStore, PervasiveDivergenceError
from tcgan_tpu.train.driver import DriverConfig, GANDriver

TINY_GEN = GeneratorConfig(
    ssn=SSNConfig(N=6, k=0.005, n=2.0, dt=0.001, max_iter=2000, atol=1e-5),
    bandwidths=(0.25, 1.0), contrasts=(5.0,), sample_sites=1,
    solver="ift", dtype=jnp.float64,
)


def _stub_step(diverged_frac=0.0):
    def step(cfg, n_critic, state, real_stack, key):
        z = jnp.zeros(())
        m = StepMetrics(z, z, z, z, z, z,
                        jnp.asarray(diverged_frac), z, z)
        return state._replace(step=state.step + 1), m

    return step


def _sampler(key, n, b):
    return jnp.zeros((n, b, TINY_GEN.tc_dim))


def _mk_driver(tmp_path, step_fn, **driver_kw):
    cfg = wgan_lib.WGANConfig(gen=TINY_GEN, critic_layers=(8,),
                              batch_size=2, n_critic=2, n_critic0=3)
    state = wgan_lib.init_state(cfg)
    store = DataStore(tmp_path / "run")
    store.write_info({"entry": "test"})
    dcfg = DriverConfig(n_steps=5, checkpoint_every=100, tc_mean_every=0,
                        **driver_kw)
    return GANDriver(cfg, dcfg, store, step_fn, state, _sampler), store


def test_driver_runs_and_records(tmp_path):
    seen = []

    def spy(cfg, n_critic, state, real_stack, key):
        seen.append((n_critic, real_stack.shape))
        return _stub_step()(cfg, n_critic, state, real_stack, key)

    driver, store = _mk_driver(tmp_path, spy)
    final = driver.run()
    assert int(final.step) == 5
    # critic-iters schedule: warm-up value on step 0, steady after
    assert seen[0][0] == 3 and seen[1][0] == 2
    assert seen[0][1][0] == 3 and seen[1][1][0] == 2
    info = json.loads((store.path / "info.json").read_text())
    assert info["status"] == "finished"
    lines = (store.path / "learning.csv").read_text().strip().split("\n")
    assert len(lines) == 6  # header + 5 steps
    gen_lines = (store.path / "generator.csv").read_text().strip().split("\n")
    assert len(gen_lines) == 6
    # checkpoint written at end
    assert driver.checkpoints.latest_step() == 5


def test_driver_aborts_on_pervasive_divergence(tmp_path):
    driver, store = _mk_driver(
        tmp_path, _stub_step(diverged_frac=0.9),
        divergence_abort=0.5, divergence_patience=3,
    )
    with pytest.raises(PervasiveDivergenceError):
        driver.run()
    info = json.loads((store.path / "info.json").read_text())
    assert info["status"] == "known_error"


def test_checkpoint_restore_roundtrip(tmp_path):
    driver, store = _mk_driver(tmp_path, _stub_step())
    final = driver.run()
    restored = driver.checkpoints.restore(
        jax.tree_util.tree_map(jnp.zeros_like, final))
    chex_equal = jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
        final, restored)
    assert all(jax.tree_util.tree_leaves(chex_equal))


def test_fake_truth_generation_and_mm_driver(tmp_path):
    from tcgan_tpu.data.datasets import TuningCurveDataset, generate_fake_truth
    from tcgan_tpu.train.driver import MomentMatchingDriver

    arr = generate_fake_truth(TINY_GEN, ((0.02, 0.016), (0.02, 0.012)),
                              ((0.05, 0.04), (0.05, 0.04)),
                              ((0.25, 0.1), (0.25, 0.1)),
                              num_samples=12, batch=8)
    assert arr.shape == (12, TINY_GEN.tc_dim)
    assert np.isfinite(arr).all() and (arr >= 0).all()

    ds = TuningCurveDataset.from_array(arr, dtype=jnp.float64)
    cfg = mm_lib.MomentMatchingConfig(gen=TINY_GEN, batch_size=4, lr=1e-2)
    state = mm_lib.init_state(cfg)
    store = DataStore(tmp_path / "mm")
    store.write_info({"entry": "mm"})
    drv = MomentMatchingDriver(cfg, DriverConfig(n_steps=2), store,
                               mm_lib.train_step, state, ds.moments())
    final = drv.run()
    assert int(final.step) == 2
    lines = (store.path / "learning.csv").read_text().strip().split("\n")
    assert len(lines) == 3


def test_fake_truth_unstable_params_raise(tmp_path):
    from tcgan_tpu.data.datasets import generate_fake_truth
    from tcgan_tpu.train.datastore import KnownError

    bad = dataclasses.replace(
        TINY_GEN, ssn=dataclasses.replace(TINY_GEN.ssn, k=0.2, max_iter=500))
    with pytest.raises(KnownError):
        generate_fake_truth(bad, ((5.0, 0.01), (5.0, 0.01)),
                            ((0.01, 0.01), (0.01, 0.01)),
                            ((0.3, 0.3), (0.3, 0.3)),
                            num_samples=8, batch=4)


def test_param_export_npz(tmp_path):
    driver, store = _mk_driver(tmp_path, _stub_step())
    driver.run()
    data = np.load(store.path / "disc_params.npz")
    assert "J" in data and "w0" in data and int(data["step"]) == 5
    assert data["J"].shape == (2, 2)


def test_disc_learning_stream_and_timing(tmp_path):
    """Per-critic-iteration rows + SSsolve/gradient timing columns."""

    def step_with_iters(cfg, n_critic, state, real_stack, key):
        z = jnp.zeros(())
        v = jnp.arange(float(n_critic))
        m = StepMetrics(z, z, z, z, z, z, z, z, z,
                        d_loss_iters=v, wasserstein_iters=v * 2,
                        gp_iters=v * 3, acc_iters=v * 4)
        return state._replace(step=state.step + 1), m

    driver, store = _mk_driver(tmp_path, step_with_iters, timing_every=2)
    driver.run()
    lines = (store.path / "disc_learning.csv").read_text().strip().split("\n")
    # 5 steps: step0 uses n_critic0=3 iters, steps 1-4 use 2 -> 3 + 4*2 rows
    assert len(lines) == 1 + 3 + 4 * 2
    assert lines[1].startswith("0,0,0.0")
    # timing columns populated on measured steps
    import csv as _csv

    with open(store.path / "learning.csv") as fh:
        rows = list(_csv.DictReader(fh))
    assert float(rows[2]["SSsolve_time"]) > 0
    assert float(rows[2]["gradient_time"]) > 0


def test_adaptive_solver_budget_bucketing(tmp_path):
    from tests.test_wgan import small_gen_cfg

    gen = small_gen_cfg(ssn=SSNConfig(N=6, max_iter=8192))
    cfg = wgan_lib.WGANConfig(gen=gen, batch_size=4)
    state = wgan_lib.init_state(cfg)

    class M:
        def __init__(self, fconv, miters):
            self.frac_converged = fconv
            self.mean_iters = miters

    store = DataStore(tmp_path)
    drv = GANDriver(cfg, DriverConfig(adaptive_max_iter=True,
                                      adaptive_margin=4.0),
                    store, lambda *a: None, state,
                    lambda *a: None)
    # healthy steps at ~400 iters -> cap 4*400=1600 -> bucket 2048
    for s in range(5):
        drv._adapt_solver_budget(s, M(1.0, 400.0))
    assert drv.model_cfg.gen.ssn.max_iter == 2048
    # a divergence outbreak must NOT raise the budget (EMA frozen)
    drv._adapt_solver_budget(6, M(0.3, 2048.0))
    assert drv.model_cfg.gen.ssn.max_iter == 2048
    # floor: very fast convergence still keeps >= 1024
    drv2 = GANDriver(cfg, DriverConfig(adaptive_max_iter=True),
                     store, lambda *a: None, state, lambda *a: None)
    drv2._adapt_solver_budget(0, M(1.0, 50.0))
    assert drv2.model_cfg.gen.ssn.max_iter == 1024
    # ceiling: never exceeds the configured max_iter
    drv3 = GANDriver(cfg, DriverConfig(adaptive_max_iter=True,
                                       adaptive_margin=100.0),
                     store, lambda *a: None, state, lambda *a: None)
    drv3._adapt_solver_budget(0, M(1.0, 5000.0))
    assert drv3.model_cfg.gen.ssn.max_iter == 8192


def test_adaptive_budget_escape_valve_and_sidecar(tmp_path):
    """(1) Escape valve: when the cap itself keeps frac_converged < 0.9
    (an absorbing state — the EMA gate would never fire again), 50
    sustained unhealthy capped steps raise the EMA one bucket. (2) The
    adaptive state survives resume via the sidecar file (the checkpoint
    holds model state only)."""
    from tests.test_wgan import small_gen_cfg

    gen = small_gen_cfg(ssn=SSNConfig(N=6, max_iter=8192))
    cfg = wgan_lib.WGANConfig(gen=gen, batch_size=4)
    state = wgan_lib.init_state(cfg)

    class M:
        def __init__(self, fconv, miters):
            self.frac_converged = fconv
            self.mean_iters = miters

    store = DataStore(tmp_path)
    dcfg = DriverConfig(adaptive_max_iter=True, adaptive_margin=4.0)
    drv = GANDriver(cfg, dcfg, store, lambda *a: None, state,
                    lambda *a: None)
    for s in range(5):
        drv._adapt_solver_budget(s, M(1.0, 400.0))
    assert drv.model_cfg.gen.ssn.max_iter == 2048
    # slow-but-convergent tail cut off by the cap: unhealthy while capped
    for s in range(49):
        drv._adapt_solver_budget(10 + s, M(0.85, 2048.0))
    assert drv.model_cfg.gen.ssn.max_iter == 2048  # not yet
    drv._adapt_solver_budget(60, M(0.85, 2048.0))  # 50th -> valve fires
    assert drv.model_cfg.gen.ssn.max_iter == 4096
    # a healthy step resets the streak and resumes normal EMA tracking
    drv._adapt_solver_budget(61, M(0.95, 500.0))
    assert drv._capped_unhealthy == 0

    # sidecar: persists at checkpoint time, restored by a fresh driver
    drv._save_adaptive_state()
    drv2 = GANDriver(cfg, dcfg, store, lambda *a: None, state,
                     lambda *a: None)
    assert drv2._iter_ema is not None
    assert drv2.model_cfg.gen.ssn.max_iter == drv.model_cfg.gen.ssn.max_iter


def test_graceful_stop_on_sigterm(tmp_path):
    """SIGTERM mid-run: the driver finishes the current step, checkpoints
    the COMPLETED step, finalizes the datastore as "interrupted" (not
    "crashed"), and a resume continues with zero lost steps — the
    preemption-safe semantics a scheduler's SIGTERM relies on."""
    import json
    import os
    import signal

    drv, store = _mk_driver(tmp_path, _stub_step())
    drv.cfg = DriverConfig(n_steps=50, checkpoint_every=0, tc_mean_every=0)

    def send_sigterm(step, state, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    state = drv.run(on_step=send_sigterm)
    assert int(state.step) == 3  # steps 0..2 completed, then stopped
    info = json.loads((tmp_path / "run" / "info.json").read_text())
    assert info["status"] == "interrupted"
    assert drv.checkpoints.latest_step() == 3
    # the handler is restored after run()
    assert signal.getsignal(signal.SIGTERM) in (
        signal.SIG_DFL, signal.default_int_handler)

    # resume: a fresh driver restores step 3 and completes the rest
    cfg = drv.model_cfg
    state2 = drv.checkpoints.restore(wgan_lib.init_state(cfg))
    drv2 = GANDriver(cfg, DriverConfig(n_steps=2, checkpoint_every=0,
                                       tc_mean_every=0),
                     store, _stub_step(), state2, _sampler,
                     checkpoints=drv.checkpoints)
    state2 = drv2.run()
    assert int(state2.step) == 5
    info = json.loads((tmp_path / "run" / "info.json").read_text())
    assert info["status"] == "finished"


def test_checkpoint_forward_compat_added_fields(tmp_path):
    """A checkpoint written before a TrainState field existed (the
    round-5 drift-latch fields broke the rec13fence arms' resume of the
    flagship's pre-change checkpoints) must restore via the
    forward-compat path: saved fields load exactly, added fields keep
    their init values. A genuinely foreign structure must still raise
    the loud schema error."""
    from typing import Any, NamedTuple

    import numpy as np

    from tcgan_tpu.train.checkpoint import CheckpointManager

    class OldState(NamedTuple):
        gen_params: Any
        step: Any
        endgame: Any = None

    class NewState(NamedTuple):
        gen_params: Any
        step: Any
        endgame: Any = None
        drift_dir: Any = None     # added post-save
        gamma_late: Any = None    # added post-save

    old = OldState(gen_params={"J": np.full((2, 2), 0.3)},
                   step=np.asarray(7), endgame=None)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(7, old)

    # feature OFF template: added fields None -> restored as None
    t_off = NewState(gen_params={"J": np.zeros((2, 2))},
                     step=np.asarray(0))
    r = mgr.restore(t_off)
    assert isinstance(r, NewState) and int(r.step) == 7
    np.testing.assert_allclose(r.gen_params["J"], 0.3)
    assert r.drift_dir is None and r.gamma_late is None

    # feature ON template: added fields keep their cold-start init
    t_on = NewState(gen_params={"J": np.zeros((2, 2))},
                    step=np.asarray(0),
                    drift_dir={"J": np.zeros((2, 2))},
                    gamma_late=np.zeros((), bool))
    r = mgr.restore(t_on)
    np.testing.assert_allclose(r.gen_params["J"], 0.3)
    np.testing.assert_allclose(r.drift_dir["J"], 0.0)
    assert not bool(r.gamma_late)

    # foreign structure (field the checkpoint has but we don't) still
    # errors loudly instead of silently dropping saved state
    class Shrunk(NamedTuple):
        gen_params: Any

    import pytest as _pytest
    with _pytest.raises(ValueError, match="TrainState structure"):
        mgr.restore(Shrunk(gen_params={"J": np.zeros((2, 2))}))
    mgr.close()


def test_checkpoint_keeps_newest_and_refuses_orbax_dirs(tmp_path):
    """max_to_keep prunes the oldest files, no temp file survives a save,
    non-numpy dtypes (bfloat16) round-trip, and a directory holding only
    checkpoints of the earlier orbax format says so instead of silently
    starting over."""
    from tcgan_tpu.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"a": np.full(3, float(s)),
                     "b": jnp.full((2,), s, jnp.bfloat16)})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert not list((tmp_path / "ckpt").glob("*.tmp"))
    r = mgr.restore({"a": np.zeros(3), "b": jnp.zeros((2,), jnp.bfloat16)})
    np.testing.assert_array_equal(r["a"], 3.0)
    assert r["b"].dtype == jnp.bfloat16 and float(r["b"][0]) == 3.0

    old = tmp_path / "old"
    (old / "100" / "default").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="orbax"):
        CheckpointManager(old).latest_step()


def test_checkpoint_load_tree_without_template(tmp_path):
    """load_tree reads a checkpoint back as nested dicts keyed by field
    name, dict key and sequence index, with no state to restore into."""
    from typing import Any, NamedTuple

    from tcgan_tpu.train.checkpoint import CheckpointManager

    class State(NamedTuple):
        gen_params: Any
        critic_params: Any
        opt: Any
        step: Any

    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(4, State(gen_params={"J": np.full((2, 2), 0.5)},
                      critic_params={"w0": np.ones((3, 2)), "b0": np.zeros(2)},
                      opt=(np.arange(3.0), [np.asarray(2)]),
                      step=np.asarray(4)))
    mgr.save(9, State(gen_params={"J": np.full((2, 2), 0.9)},
                      critic_params={}, opt=(), step=np.asarray(9)))
    tree = mgr.load_tree(4)
    np.testing.assert_array_equal(tree["gen_params"]["J"], 0.5)
    assert sorted(tree["critic_params"]) == ["b0", "w0"]
    np.testing.assert_array_equal(tree["opt"][0], np.arange(3.0))
    assert int(tree["opt"][1][0]) == 2 and int(tree["step"]) == 4
    # the latest by default
    np.testing.assert_array_equal(mgr.load_tree()["gen_params"]["J"], 0.9)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").load_tree()
