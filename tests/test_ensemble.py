"""Ensemble (multi-start) fitting: vmapped member equivalence vs the
single-fit step, start-jitter semantics, and the CLI end-to-end."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgan_tpu.models import ensemble as ens_lib
from tcgan_tpu.models import generator as gen_lib
from tcgan_tpu.models import wgan as wgan_lib

from tests.test_wgan import TINY_GEN, tiny_wgan_cfg

# shared tiny-battery CLI config for the end-to-end ensemble tests (one
# place to change the test circuit; mirrors test_cli.py's TINY_GAN)
TINY_CLI = [
    "--N", "6", "--max-iter", "1500", "--atol", "1e-5",
    "--J", "0.02", "0.016", "0.02", "0.012",
    "--D", "0.05", "0.04", "0.05", "0.04",
    "--S", "0.25", "0.1", "0.25", "0.1",
    "--contrasts", "5", "--bandwidths", "0.25", "1.0",
]


@pytest.mark.slowtest
def test_ensemble_member_matches_single_fit():
    """A stacked K=1 ensemble step must reproduce the single train_step
    bit-for-bit: vmap adds members, not semantics."""
    cfg = tiny_wgan_cfg()
    single = wgan_lib.init_state(cfg)
    key = jax.random.PRNGKey(3)
    real = 0.1 * jax.random.normal(
        key, (cfg.n_critic, cfg.critic_batch, cfg.gen.tc_dim)) + 1.0

    new_single, m_single = wgan_lib.train_step(cfg, cfg.n_critic, single,
                                               real, key)

    stacked = jax.tree.map(lambda a: a[None], single)
    new_stacked, m_stacked = ens_lib.ensemble_train_step(
        cfg, cfg.n_critic, stacked, real[None], key[None])

    np.testing.assert_allclose(np.asarray(m_stacked.d_loss)[0],
                               np.asarray(m_single.d_loss), rtol=1e-12)
    for k in ("J", "D", "S"):
        np.testing.assert_allclose(
            np.asarray(new_stacked.gen_params[k])[0],
            np.asarray(new_single.gen_params[k]), rtol=1e-12)


@pytest.mark.slowtest
def test_ensemble_members_independent_and_jittered():
    cfg = tiny_wgan_cfg(batch_size=2, critic_layers=(8,))
    gen_init = gen_lib.init_params(cfg.gen)
    states = ens_lib.init_ensemble(cfg, 3, jax.random.PRNGKey(0),
                                   gen_init=gen_init, start_jitter=0.1)
    # member 0 keeps the exact start; others are perturbed and distinct
    J = np.asarray(states.gen_params["J"])
    np.testing.assert_allclose(J[0], np.asarray(gen_init["J"]), rtol=1e-12)
    assert not np.allclose(J[1], J[0])
    assert not np.allclose(J[2], J[1])
    # critic inits differ per member (weights; biases start at zero)
    assert any(
        not np.allclose(np.asarray(leaf)[0], np.asarray(leaf)[1])
        for leaf in jax.tree.leaves(states.critic_params)
    )

    key = jax.random.PRNGKey(1)
    real = 0.1 * jax.random.normal(
        key, (3, cfg.n_critic, cfg.critic_batch, cfg.gen.tc_dim)) + 1.0
    new_states, metrics = ens_lib.ensemble_train_step(
        cfg, cfg.n_critic, states, real, jax.random.split(key, 3))
    assert metrics.d_loss.shape == (3,)
    assert np.all(np.isfinite(np.asarray(metrics.d_loss)))
    assert int(np.asarray(new_states.step)[0]) == 1
    # summary across members
    summary = ens_lib.ensemble_summary(
        cfg, new_states,
        {"J": np.full((2, 2), 0.02), "D": np.full((2, 2), 0.05),
         "S": np.full((2, 2), 0.2)})
    assert summary["n_members"] == 3
    assert "recovery_error" in summary["members"][0]
    assert np.all(np.asarray(summary["std"]["J"]) >= 0)


def test_ensemble_cli_end_to_end(tmp_path):
    from tcgan_tpu.run import ensemble as ens_cli

    d = str(tmp_path / "ens")
    rc = ens_cli.main([
        "--datastore", d,
        *TINY_CLI,
        "--batch-size", "3", "--n-steps", "2",
        "--WGAN_n_critic", "2", "--WGAN_n_critic0", "2",
        "--truth-samples", "8", "--disc-layers", "8",
        "--ensemble", "2", "--start-jitter", "0.05",
        "--record-every", "1", "--gen-ema", "0.9",
    ])
    assert rc == 0
    rows = open(f"{d}/ensemble.csv").read().strip().split("\n")
    # header + 2 members x 2 steps
    assert len(rows) == 5
    assert rows[0].startswith("step,member,")
    summary = json.loads(open(f"{d}/ensemble_summary.json").read())
    assert summary["n_members"] == 2
    assert summary["members"][0]["recovery_error"]["J"] >= 0
    npz = np.load(f"{d}/ensemble_params.npz")
    assert npz["J"].shape == (2, 2, 2)
    assert npz["J_ema"].shape == (2, 2, 2)
    # member starts differ (jitter) but member 0 began at the exact --J
    first = {r.split(",")[1]: r for r in rows[1:] if r.split(",")[0] == "0"}
    j00_m0 = float(first["0"].split(",")[10])
    assert abs(j00_m0 - 0.02) < 5e-3  # moved at most one Adam step
    info = json.loads(open(f"{d}/info.json").read())
    assert info["status"] == "finished"


@pytest.mark.slowtest
def test_sharded_ensemble_matches_unsharded():
    """Members sharded over the 8-device mesh must equal the single-device
    vmap result (same program, different partitioning)."""
    from tcgan_tpu import parallel as par

    cfg = tiny_wgan_cfg(batch_size=2, critic_layers=(8,))
    K = 8
    states = ens_lib.init_ensemble(cfg, K, jax.random.PRNGKey(0),
                                   start_jitter=0.05)
    key = jax.random.PRNGKey(1)
    real = 0.1 * jax.random.normal(
        key, (K, cfg.n_critic, cfg.critic_batch, cfg.gen.tc_dim)) + 1.0
    keys = jax.random.split(key, K)

    ref_states, ref_m = ens_lib.ensemble_train_step(
        cfg, cfg.n_critic, states, real, keys)

    mesh = par.make_mesh(n_batch=8, n_model=1)
    step = par.make_sharded_ensemble_step(ens_lib.ensemble_train_step_impl,
                                          mesh)
    with jax.set_mesh(mesh):
        sh_states, sh_m = step(cfg, cfg.n_critic, states, real, keys)
        jax.block_until_ready(sh_m.d_loss)

    np.testing.assert_allclose(np.asarray(sh_m.d_loss),
                               np.asarray(ref_m.d_loss), rtol=1e-10)
    for k in ("J", "D", "S"):
        np.testing.assert_allclose(np.asarray(sh_states.gen_params[k]),
                                   np.asarray(ref_states.gen_params[k]),
                                   rtol=1e-10)


def test_conditional_ensemble_cli(tmp_path):
    from tcgan_tpu.run import ensemble as ens_cli

    d = str(tmp_path / "cens")
    rc = ens_cli.main([
        "--datastore", d, "--conditional",
        *TINY_CLI,
        "--batch-size", "3", "--n-steps", "2",
        "--WGAN_n_critic", "2", "--WGAN_n_critic0", "2",
        "--truth-samples", "8", "--disc-layers", "8",
        "--ensemble", "2", "--start-jitter", "0.05",
        "--record-every", "1", "--normalize-input",
    ])
    assert rc == 0
    rows = open(f"{d}/ensemble.csv").read().strip().split("\n")
    assert len(rows) == 5  # header + 2 members x 2 steps
    summary = json.loads(open(f"{d}/ensemble_summary.json").read())
    assert summary["n_members"] == 2
    for row in rows[1:]:
        vals = row.split(",")
        assert all(np.isfinite(v) for v in map(float, vals[2:10]))


def test_ensemble_loader_and_view(tmp_path):
    from tcgan_tpu.analysis import ensemble_view
    from tcgan_tpu.analysis.loaders import load_ensemble

    d = tmp_path / "ens"
    d.mkdir()
    pops = ("E", "I")
    cols = (["step", "member", "d_loss", "g_loss", "wasserstein",
             "d_accuracy", "frac_converged", "frac_diverged", "mean_iters",
             "train_time"]
            + [f"{blk}_{a}{b}" for blk in ("J", "D", "S")
               for a in pops for b in pops])
    rng = np.random.default_rng(0)
    lines = [",".join(cols)]
    for step in (0, 10):
        for m in (0, 1, 2):
            vals = [step, m] + list(rng.uniform(0.1, 1.0, len(cols) - 2))
            lines.append(",".join(str(v) for v in vals))
    (d / "ensemble.csv").write_text("\n".join(lines) + "\n")
    np.savez(d / "ensemble_params.npz",
             J=rng.uniform(0.03, 0.06, (3, 2, 2)),
             D=rng.uniform(0.05, 0.12, (3, 2, 2)),
             S=rng.uniform(0.08, 0.3, (3, 2, 2)))
    (d / "ensemble_summary.json").write_text(json.dumps(
        {"n_members": 3, "std": {"J": [[0.01] * 2] * 2}}))

    rec = load_ensemble(d)
    assert rec.n_members == 3
    traj = rec.member_trajectory(1, "J")
    assert traj.shape == (2, 2, 2)

    jac = tmp_path / "jac.npz"
    np.savez(jac, jacobian=rng.normal(size=(20, 12)))
    rc = ensemble_view.main([str(d), "--jacobian", str(jac),
                             "-o", str(tmp_path / "ens.png")])
    assert rc == 0
    assert (tmp_path / "ens.png").exists()


@pytest.mark.slowtest
def test_ensemble_cli_resume(tmp_path):
    from tcgan_tpu.run import ensemble as ens_cli

    d = str(tmp_path / "ens_r")
    base = [
        "--datastore", d,
        *TINY_CLI,
        "--batch-size", "3", "--n-steps", "2",
        "--WGAN_n_critic", "2", "--WGAN_n_critic0", "2",
        "--truth-samples", "8", "--disc-layers", "8",
        "--ensemble", "2", "--record-every", "1",
        "--checkpoint-every", "2",
    ]
    assert ens_cli.main(base) == 0
    assert ens_cli.main(base + ["--resume"]) == 0
    rows = open(f"{d}/ensemble.csv").read().strip().split("\n")[1:]
    steps = sorted({int(float(r.split(",")[0])) for r in rows})
    assert steps == [0, 1, 2, 3]


@pytest.mark.slowtest
def test_mm_ensemble_member_matches_single_fit():
    """A stacked K=1 MOMENT-MATCHING ensemble step must reproduce the
    single mm train_step bit-for-bit (VERDICT r2 #9)."""
    import dataclasses

    from tcgan_tpu.models import moments as mm_lib

    cfg = mm_lib.MomentMatchingConfig(gen=TINY_GEN, batch_size=4,
                                      moment_ema=0.9)
    single = mm_lib.init_state(cfg)
    key = jax.random.PRNGKey(5)
    d = cfg.gen.tc_dim
    data_mean = jnp.linspace(0.5, 1.5, d)
    data_second = jnp.eye(d) + 0.5

    new_single, m_single = mm_lib.train_step(cfg, single, data_mean,
                                             data_second, key)

    stacked = jax.tree.map(lambda a: a[None], single)
    step = jax.jit(ens_lib.make_mm_ensemble_step_impl(),
                   static_argnames=("cfg",))
    new_stacked, m_stacked = step(cfg, stacked, data_mean, data_second,
                                  key[None])
    np.testing.assert_allclose(np.asarray(m_stacked.loss)[0],
                               np.asarray(m_single.loss), rtol=1e-12)
    for k in ("J", "D", "S"):
        np.testing.assert_allclose(
            np.asarray(new_stacked.gen_params[k])[0],
            np.asarray(new_single.gen_params[k]), rtol=1e-12)
    # moment-EMA buffers carried per member
    np.testing.assert_allclose(np.asarray(new_stacked.ema_mean)[0],
                               np.asarray(new_single.ema_mean), rtol=1e-12)


def test_mm_ensemble_cli_end_to_end(tmp_path):
    from tcgan_tpu.run import ensemble as ens_cli

    d = str(tmp_path / "ensmm")
    rc = ens_cli.main([
        "--datastore", d,
        *TINY_CLI,
        "--batch-size", "4", "--n-steps", "2",
        "--truth-samples", "8",
        "--estimator", "mm", "--moment-ema", "0.9",
        "--ensemble", "2", "--start-jitter", "0.05",
        "--record-every", "1",
    ])
    assert rc == 0
    rows = open(f"{d}/ensemble.csv").read().strip().split("\n")
    assert len(rows) == 5  # header + 2 members x 2 steps
    assert rows[0].startswith("step,member,loss,")
    summary = json.loads(open(f"{d}/ensemble_summary.json").read())
    assert summary["n_members"] == 2
    npz = np.load(f"{d}/ensemble_params.npz")
    assert npz["J"].shape == (2, 2, 2)
    info = json.loads(open(f"{d}/info.json").read())
    assert info["status"] == "finished"
    assert info["config"]["entry"] == "ensemble_mm"


def test_mm_ensemble_members_get_distinct_fixed_z_keys():
    """Under fixed_z every ensemble member must carry its OWN CRN z-set;
    a shared PRNGKey(seed) would turn the z-set's Monte-Carlo error into
    a common bias invisible to the member spread."""
    from tcgan_tpu.models import moments as mm_lib
    from tests.test_wgan import small_gen_cfg

    cfg = mm_lib.MomentMatchingConfig(gen=small_gen_cfg(), batch_size=4,
                                      fixed_z=True)
    states = ens_lib.init_mm_ensemble(cfg, 4, jax.random.PRNGKey(0),
                                      start_jitter=0.05)
    zk = np.asarray(states.z_key)
    assert zk.shape[0] == 4
    assert len({tuple(row) for row in zk.reshape(4, -1)}) == 4


def test_ensemble_member0_ema_params_reset():
    """With start_jitter, member 0 keeps the exact requested start in its
    parameter-EMA buffer too (init seeds the EMA from the jittered
    params)."""
    from tests.test_wgan import small_gen_cfg

    cfg = wgan_lib.WGANConfig(gen=small_gen_cfg(), batch_size=4,
                              critic_layers=(8,), ema_decay=0.99)
    base = jax.tree.map(jnp.asarray, gen_lib.init_params(cfg.gen))
    states = ens_lib.init_ensemble(cfg, 3, jax.random.PRNGKey(1),
                                   gen_init=base, start_jitter=0.1)
    for leaf_s, leaf_b in zip(jax.tree.leaves(states.ema_params),
                              jax.tree.leaves(base)):
        np.testing.assert_allclose(np.asarray(leaf_s[0]), np.asarray(leaf_b))
        assert not np.allclose(np.asarray(leaf_s[1]), np.asarray(leaf_b))


def test_ensemble_flag_contradictions_error_loudly():
    """--estimator wgan + --conditional, --estimator mm + --conditional,
    mm + --parallel mesh, and --record-every 0 must all SystemExit instead
    of silently resolving to something the user did not ask for."""
    import pytest

    from tcgan_tpu.run import ensemble as ens_run

    base = ("--datastore /tmp/x --N 8 --batch-size 4 "
            "--J .045 .04 .05 .035 --D .1 .08 .1 .08 "
            "--S .25 .1 .25 .1").split()
    for extra in (["--estimator", "wgan", "--conditional"],
                  ["--estimator", "mm", "--conditional"],
                  ["--estimator", "mm", "--parallel", "mesh"],
                  ["--record-every", "0"]):
        with pytest.raises(SystemExit):
            ens_run.main(base + extra)


def test_mm_ensemble_sigterm_still_writes_summary(tmp_path):
    """Preemption safety: a SIGTERM mid-run (queue `timeout`, pool
    preemption) must still produce ensemble_summary.json/params.npz with
    status "interrupted" — the queue's post-processing chain depends on
    the summary existing."""
    import signal
    import threading

    from tcgan_tpu.run import ensemble as ens_cli

    d = str(tmp_path / "enssig")

    # Raise SIGTERM only once the step loop is demonstrably live (first
    # ensemble.csv row) — earlier, the handler isn't installed yet and
    # the default action would kill the test process itself.
    import os
    import time
    stop_probe = threading.Event()

    def _fire():
        deadline = time.time() + 120
        path = f"{d}/ensemble.csv"
        while time.time() < deadline and not stop_probe.is_set():
            try:
                with open(path) as fh:
                    n_lines = sum(1 for _ in fh)
                if n_lines >= 2:  # header + >=1 data row
                    signal.raise_signal(signal.SIGTERM)
                    return
            except OSError:
                pass
            time.sleep(0.05)

    t = threading.Thread(target=_fire, daemon=True)
    t.start()
    try:
        rc = ens_cli.main([
            "--datastore", d,
            *TINY_CLI,
            "--batch-size", "4", "--n-steps", "100000",
            "--truth-samples", "8",
            "--estimator", "mm", "--moment-ema", "0.9",
            "--ensemble", "2", "--record-every", "1",
        ])
    finally:
        stop_probe.set()
    assert rc == 0
    summary = json.loads(open(f"{d}/ensemble_summary.json").read())
    assert summary["n_members"] == 2
    assert np.load(f"{d}/ensemble_params.npz")["J"].shape == (2, 2, 2)
    info = json.loads(open(f"{d}/info.json").read())
    assert info["status"] == "interrupted"


def test_mm_ensemble_per_member_data():
    """--data-seed-per-member (model layer): with stacked per-member data
    moments, identically-initialized members diverge because each chases
    its OWN dataset — the CRLB-comparable spread mode (BASELINE.md
    mmens13: shared-data spread measures only the optimizer)."""
    from tcgan_tpu.models import moments as mm_lib

    cfg = mm_lib.MomentMatchingConfig(gen=TINY_GEN, batch_size=4,
                                      moment_ema=0.9)
    K, d = 2, cfg.gen.tc_dim
    states = ens_lib.init_mm_ensemble(cfg, K, jax.random.PRNGKey(0),
                                      start_jitter=0.0)  # identical starts
    rng = np.random.RandomState(0)
    data_mean = jnp.asarray(0.8 + 0.4 * rng.rand(K, d))
    data_second = jnp.asarray(np.stack([np.eye(d) + 0.5,
                                        np.eye(d) + 0.7]))
    step = jax.jit(ens_lib.make_mm_ensemble_step_impl(per_member_data=True),
                   static_argnames=("cfg",))
    key = jax.random.PRNGKey(3)
    new_states, m = step(cfg, states, data_mean, data_second,
                         jnp.stack([key, key]))  # same sampling keys too
    # identical params + keys, different data -> different losses and
    # different post-step params
    losses = np.asarray(m.loss)
    assert losses.shape == (K,) and losses[0] != losses[1]
    dj = np.abs(np.asarray(new_states.gen_params["J"][0])
                - np.asarray(new_states.gen_params["J"][1])).max()
    assert dj > 0
    # (the moment-EMA buffers track GENERATED moments — identical params
    # + identical keys give identical EMAs at step 1 by construction, so
    # they are deliberately not compared here)


def test_mm_ensemble_per_member_data_cli(tmp_path):
    """--data-seed-per-member end-to-end: runs, records per-member truth
    seeds implicitly (truth_seed + m), and refuses --dataset."""
    from tcgan_tpu.run import ensemble as ens_cli

    d = str(tmp_path / "ensmm_pmd")
    rc = ens_cli.main([
        "--datastore", d,
        *TINY_CLI,
        "--batch-size", "4", "--n-steps", "2",
        "--truth-samples", "8",
        "--estimator", "mm", "--moment-ema", "0.9",
        "--ensemble", "2", "--start-jitter", "0.05",
        "--record-every", "1",
        "--data-seed-per-member",
    ])
    assert rc == 0
    summary = json.loads(open(f"{d}/ensemble_summary.json").read())
    assert summary["n_members"] == 2
    info = json.loads(open(f"{d}/info.json").read())
    assert info["config"]["data_seed_per_member"] is True

    import pytest

    with pytest.raises(SystemExit):
        ens_cli.main([
            "--datastore", str(tmp_path / "x"),
            *TINY_CLI,
            "--estimator", "mm", "--ensemble", "2",
            "--data-seed-per-member", "--dataset", "some.npz",
        ])
