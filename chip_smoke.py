#!/usr/bin/env python
"""Smoke test of the SSN fit on NVIDIA GPUs, through the normal entry points.

Usage, from the repository root on a machine with the card(s):

    python chip_smoke.py               # one card: every phase below but 5
    python chip_smoke.py --four-cards  # four cards: phase 5 only

Phases (one process; the CLIs' ``main(argv)`` run in-process, and only
``nvidia-smi`` runs as a child, which never imports JAX):

1. kernel: the fused Pallas solver compiled for the card at N=51, timed
   against the plain XLA solver and checked against it at three sizes —
   (a) 512 circuits x the 8-bandwidth battery at contrast 10, (b) the same
   circuits under the (5, 10, 13) battery, (c) a divergence-heavy batch —
   and against the float64 native CPU solver on 16 circuits.
2. forward: ``run.forward`` data generation, once per solver backend.
3. gan: ``run.gan`` at the flagship C2 width (N=51, (5, 10, 13) battery,
   rich readout, batch 256), 6 steps once per backend, then ``--resume``.
4. entry points: ``run.bptt_wgan --seqlen 4000``, ``run.bptt_cwgan``,
   ``run.moments`` and ``run.ensemble --ensemble 2``, 2 steps each.
5. mesh (``--four-cards``): ``run.moments --parallel mesh`` at N=201 and
   ``run.forward --parallel mesh``, each against the same seed on one card.

No phase falls back to the CPU or to interpret mode: without a GPU the
script exits non-zero and prints no result. Any failed phase makes it exit
non-zero. The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Run directories go to ``runs/chip_smoke/`` and a summary to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUNS = ROOT / "runs" / "chip_smoke"
SUMMARY = ROOT / "chiprun_out" / "chip_smoke.json"

BANDWIDTHS = (0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0)
# The near-critical bench circuit and the flagship fit's truth (README,
# "Fit your own tuning curves"; docs/artifacts/launch_rec13anchor2.sh).
TRUE_J = (0.045, 0.040, 0.050, 0.035)
TRUE_D = (0.10, 0.08, 0.10, 0.08)
TRUE_S = (0.25, 0.10, 0.25, 0.10)
START_J = (0.0585, 0.052, 0.065, 0.0455)
START_D = (0.07, 0.056, 0.07, 0.056)

# Tolerances (kernel vs the plain XLA solver run in float64, and the
# 4-vs-1-card agreement). The reference runs in float64 because the f32
# XLA path has its own residual floor: near-critical rows whose f32
# residual never drops below atol=1e-4 are converged by the f64 XLA and
# native solvers (and by the kernel's refinement tail), so f32 XLA is
# reported beside the kernel, not used as the yardstick.
# - rates where both sides converged: max abs diff <= 5e-3 Hz. Both solve
#   to the same residual atol=1e-4, so the fixed points differ by about
#   atol / (1 - spectral radius); 5e-3 leaves room for near-critical rows.
RATE_ATOL = 5e-3
# - converged / diverged flag mismatches: at most 0.2% of rows. A row
#   whose residual crosses atol between two check strides, or whose peak
#   sits at the divergence ceiling within TF32 noise, may flip.
FLAG_FRAC = 2e-3
# - 4 cards vs 1: the parameters after 2 steps may differ by at most 5% of
#   how far they moved from the start (reduction order and the survivor
#   mask of near-threshold rows differ; a wrong sharding moves them by
#   the whole step).
MESH_REL = 0.05
GEN_COLUMNS = [f"{n}_{a}{b}" for n in "JDS" for a in "EI" for b in "EI"]


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase; the defaults are the real widths."""

    N: int = 51
    kernel_batch: int = 512
    native_batch: int = 16
    kernel_reps: int = 5
    fwd_batch: int = 512
    fwd_total: int = 4096
    gan_batch: int = 256
    truth_samples: int = 1024
    gan_steps: int = 6
    seqlen: int = 4000
    other_batch: int = 64
    other_truth: int = 256
    mesh_N: int = 201
    mesh_batch: int = 256
    mesh_truth: int = 512
    mesh_fwd_total: int = 1024
    max_iter: int = 8000


def log(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, from a child that never
    imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or f"nvidia-smi failed: {out.stderr}"
    except Exception as e:  # the card is what JAX reports; keep going
        return f"nvidia-smi unavailable: {e!r}"


def _flat(values) -> list:
    return [f"{v:g}" for v in values]


def _circuit_flags(sizes: Sizes) -> list:
    return ["--N", str(sizes.N), "--max-iter", str(sizes.max_iter),
            "--atol", "1e-4"]


def _truth_flags() -> list:
    return ["--true-J", *_flat(TRUE_J), "--true-D", *_flat(TRUE_D),
            "--true-S", *_flat(TRUE_S)]


def read_csv(path: Path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def _finite_column(rows, name) -> bool:
    import math

    return bool(rows) and all(math.isfinite(float(r[name])) for r in rows)


# ---------------------------------------------------------------- phase 1


def _parity(out, ref) -> dict:
    """Flag and rate agreement of two FixedPointResults."""
    import numpy as np

    conv_o, conv_r = np.asarray(out.converged), np.asarray(ref.converged)
    div_o, div_r = np.asarray(out.diverged), np.asarray(ref.diverged)
    both = conv_o & conv_r
    diff = np.abs(np.asarray(out.r, np.float64) - np.asarray(ref.r,
                                                            np.float64))
    rdiff = float(diff[both].max()) if both.any() else 0.0
    rows = conv_o.size
    res = {
        "rows": rows,
        "max_rate_diff": rdiff,
        "conv_mismatch": int((conv_o != conv_r).sum()),
        "div_mismatch": int((div_o != div_r).sum()),
        "frac_conv": float(conv_r.mean()),
        "frac_div": float(div_r.mean()),
    }
    res["ok"] = bool(rdiff <= RATE_ATOL
                     and res["conv_mismatch"] <= FLAG_FRAC * rows
                     and res["div_mismatch"] <= FLAG_FRAC * rows)
    # the first few rows whose flags differ: (circuit, stimulus),
    # converged/diverged/iters/peak rate of each side (out, ref)
    bad = np.argwhere((conv_o != conv_r) | (div_o != div_r))[:8]
    iters_o, iters_r = np.asarray(out.iters), np.asarray(ref.iters)
    peak_o = np.asarray(out.r).max(-1)
    peak_r = np.asarray(ref.r).max(-1)
    res["flag_mismatches"] = [
        dict(row=[int(i) for i in ix],
             conv=[bool(conv_o[tuple(ix)]), bool(conv_r[tuple(ix)])],
             div=[bool(div_o[tuple(ix)]), bool(div_r[tuple(ix)])],
             iters=[int(iters_o[tuple(ix)]), int(iters_r[tuple(ix)])],
             peak=[float(peak_o[tuple(ix)]), float(peak_r[tuple(ix)])])
        for ix in bad]
    return res


def _timed(fn, arg, reps: int):
    """(result, first-call seconds incl. compile, median of ``reps`` warm
    calls, all warm times); every call ends in block_until_ready."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(arg))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times)), times


def phase_kernel(sizes: Sizes) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tcgan_tpu.ops import fixed_point, native, stimulus, weights
    from tcgan_tpu.ops.pallas import solve_fixed_point_pallas
    from tcgan_tpu.ops.ssn import SSNConfig

    cfg = SSNConfig(N=sizes.N, max_iter=sizes.max_iter, atol=1e-4)
    x = cfg.site_pos()
    J, D, S = (jnp.asarray(v, jnp.float32).reshape(2, 2)
               for v in (TRUE_J, TRUE_D, TRUE_S))

    def circuits(seed):
        z = weights.sample_z(jax.random.PRNGKey(seed), (sizes.kernel_batch,),
                             cfg.N)
        return weights.build_weight(J, D, S, z, x).astype(jnp.float32)

    W = circuits(0)
    # (c): contrast 20 pushes a large share of z-draws past criticality
    # (docs/artifacts/reopen_margin_probe.py)
    W_div = circuits(3)
    batteries = {
        "a": (W, stimulus.stimulus_battery(BANDWIDTHS, (10.0,), x,
                                           cfg.smoothness)),
        "b": (W, stimulus.stimulus_battery(BANDWIDTHS, (5.0, 10.0, 13.0), x,
                                           cfg.smoothness)),
        "c": (W_div, stimulus.stimulus_battery((0.0, 0.25, 0.5, 1.0),
                                               (20.0,), x, cfg.smoothness)),
    }
    summary, ok = {}, True
    for name, (Wb, I) in batteries.items():
        I = I.astype(jnp.float32)
        with jax.enable_x64(True):
            ref = jax.block_until_ready(jax.jit(
                lambda w, I=I: fixed_point.solve_fixed_point(
                    cfg, w.astype(jnp.float64), I.astype(jnp.float64),
                    check_every=32))(Wb))
        xla = jax.jit(lambda w, I=I: fixed_point.solve_fixed_point(
            cfg, w, I, check_every=32))
        ker = jax.jit(lambda w, I=I: solve_fixed_point_pallas(
            cfg, w, I, check_every=32))
        xla32, xla_first, xla_t, xla_all = _timed(xla, Wb, sizes.kernel_reps)
        out, ker_first, ker_t, ker_all = _timed(ker, Wb, sizes.kernel_reps)
        par = _parity(out, ref)
        par_x = _parity(xla32, ref)
        par_kx = _parity(out, xla32)
        log("kernel", size=name, reference="xla_f64",
            xla_f32_max_rate_diff=par_x["max_rate_diff"],
            xla_f32_conv_mismatch=par_x["conv_mismatch"],
            xla_f32_div_mismatch=par_x["div_mismatch"],
            kernel_vs_xla_f32_conv_mismatch=par_kx["conv_mismatch"],
            kernel_vs_xla_f32_div_mismatch=par_kx["div_mismatch"],
            kernel_vs_xla_f32_max_rate_diff=par_kx["max_rate_diff"])
        n_solves = Wb.shape[0] * I.shape[0]
        entry = dict(
            B=int(Wb.shape[0]), S=int(I.shape[0]), parity=par,
            xla_f32_parity=par_x, kernel_vs_xla_f32=par_kx,
            xla_s=xla_t, kernel_s=ker_t, xla_all=xla_all, kernel_all=ker_all,
            xla_first_s=xla_first, kernel_first_s=ker_first,
            kernel_speedup=xla_t / ker_t,
            xla_solves_per_s=n_solves / xla_t,
            kernel_solves_per_s=n_solves / ker_t,
            mean_iters_xla=float(np.asarray(xla32.iters).mean()),
            mean_iters_kernel=float(np.asarray(out.iters).mean()),
            max_iters_xla=int(np.asarray(xla32.iters).max()),
        )
        log("kernel", size=name, B=entry["B"], S=entry["S"],
            xla_ms=f"{1e3 * xla_t:.3f}", kernel_ms=f"{1e3 * ker_t:.3f}",
            speedup=f"{entry['kernel_speedup']:.3f}",
            max_rate_diff=par["max_rate_diff"],
            conv_mismatch=par["conv_mismatch"],
            div_mismatch=par["div_mismatch"], rows=par["rows"],
            frac_conv=f"{par['frac_conv']:.4f}",
            frac_div=f"{par['frac_div']:.4f}",
            mean_iters=f"{entry['mean_iters_xla']:.1f}", ok=par["ok"])
        for m in par["flag_mismatches"]:
            log("kernel", size=name, flag_mismatch_kernel_vs_f64=m)
        ok &= par["ok"]
        if name == "a":
            mem = ker.lower(Wb).compile().memory_analysis()
            log("kernel", memory_analysis=str(mem).replace("\n", " "))
            # Does the two-phase (TF32 then f32) structure pay on this
            # card? Time the single-phase all-f32 kernel on the same input.
            one = jax.jit(lambda w, I=I: solve_fixed_point_pallas(
                cfg, w, I, check_every=32, two_phase=False))
            out1, _, one_t, one_all = _timed(one, Wb, sizes.kernel_reps)
            par1 = _parity(out1, ref)
            entry.update(single_phase_s=one_t, single_phase_all=one_all,
                         single_phase_parity=par1)
            log("kernel", size=name, variant="single_phase_f32",
                kernel_ms=f"{1e3 * one_t:.3f}",
                two_phase_gain=f"{one_t / ker_t:.3f}",
                max_rate_diff=par1["max_rate_diff"], ok=par1["ok"])
            ok &= par1["ok"]
            if native.available():
                nb = sizes.native_batch
                nat = native.solve_fixed_point_native(
                    cfg, np.asarray(Wb[:nb], np.float64),
                    np.asarray(I, np.float64))
                sub = type(out)(*(a[:nb] for a in out))
                pn = _parity(sub, nat)
                px = _parity(type(xla32)(*(a[:nb] for a in xla32)), nat)
                entry.update(native_vs_kernel=pn, native_vs_xla=px)
                log("kernel", size=name, reference="native_f64",
                    circuits=nb, kernel_max_rate_diff=pn["max_rate_diff"],
                    kernel_conv_mismatch=pn["conv_mismatch"],
                    xla_max_rate_diff=px["max_rate_diff"],
                    xla_conv_mismatch=px["conv_mismatch"],
                    ok=pn["ok"] and px["ok"])
                ok &= pn["ok"] and px["ok"]
            else:
                log("kernel", reference="native_f64",
                    error=f"unavailable: {native._load_error}")
                ok = False
        if name == "c":
            cfg_m = dataclasses.replace(cfg, pallas_reopen_margin=2.0)
            ker_m = jax.jit(lambda w, I=I: solve_fixed_point_pallas(
                cfg_m, w, I, check_every=32))
            out_m, _, m_t, m_all = _timed(ker_m, Wb, sizes.kernel_reps)
            par_m = _parity(out_m, ref)
            entry.update(margin2_s=m_t, margin2_all=m_all,
                         margin2_parity=par_m)
            log("kernel", size=name, variant="reopen_margin_2",
                kernel_ms=f"{1e3 * m_t:.3f}",
                div_mismatch=par_m["div_mismatch"],
                conv_mismatch=par_m["conv_mismatch"], ok=par_m["ok"])
            ok &= par_m["ok"]
        summary[name] = entry
    summary["ok"] = ok
    return summary


# ---------------------------------------------------------------- phase 2


def phase_forward(sizes: Sizes) -> dict:
    import numpy as np

    from tcgan_tpu.run import forward

    summary, outs = {"ok": True}, {}
    for backend in ("xla", "pallas"):
        store = RUNS / f"forward_{backend}"
        argv = ["--datastore", str(store), *_circuit_flags(sizes),
                "--J", *_flat(TRUE_J), "--D", *_flat(TRUE_D),
                "--S", *_flat(TRUE_S),
                "--bandwidths", *_flat(BANDWIDTHS),
                "--contrasts", "5", "10", "13",
                "--batch-size", str(sizes.fwd_batch),
                "--total-samples", str(sizes.fwd_total),
                "--solver-backend", backend]
        forward.main(argv)
        info = json.loads((store / "info.json").read_text())["summary"]
        data = np.load(store / "tuning_curves.npz")
        outs[backend] = data
        finite = bool(np.isfinite(data["tuning_curves"]).all())
        info["finite"] = finite
        summary[backend] = info
        log("forward", backend=backend,
            circuits_per_s=f"{info['circuits_per_sec']:.1f}",
            stim_solves_per_s=f"{info['stim_solves_per_sec']:.1f}",
            solve_s=f"{info['solve_seconds']:.4f}",
            compile_plus_solve_s=f"{info['compile_plus_solve_seconds']:.3f}",
            frac_converged=f"{info['frac_converged']:.4f}",
            mean_iters=f"{info['mean_iters']:.1f}", finite=finite)
        summary["ok"] &= finite and info["n_samples"] == sizes.fwd_total
    # Same seed -> same circuits: the two backends must agree.
    a, b = outs["xla"], outs["pallas"]
    both = a["converged"] & b["converged"]
    diff = np.abs(a["rates"] - b["rates"])[both]
    rows = both.size
    agree = {
        "max_rate_diff": float(diff.max()) if diff.size else 0.0,
        "conv_mismatch": int((a["converged"] != b["converged"]).sum()),
        "div_mismatch": int((a["diverged"] != b["diverged"]).sum()),
        "rows": rows,
    }
    agree["ok"] = bool(agree["max_rate_diff"] <= RATE_ATOL
                       and agree["conv_mismatch"] <= FLAG_FRAC * rows
                       and agree["div_mismatch"] <= FLAG_FRAC * rows)
    log("forward", compare="pallas_vs_xla", **agree)
    summary["agreement"] = agree
    summary["ok"] &= agree["ok"]
    return summary


# ---------------------------------------------------------------- phase 3


def _check_run(store: Path, loss_cols, steps: int) -> dict:
    rows = read_csv(store / "learning.csv")
    finite = all(_finite_column(rows, c) for c in loss_cols)
    res = {
        "rows": len(rows),
        "finite": finite,
        "frac_converged": [float(r["frac_converged"]) for r in rows],
        "train_time": [float(r["train_time"]) for r in rows],
    }
    res["ok"] = bool(finite and len(rows) == steps)
    return res


def phase_gan(sizes: Sizes) -> dict:
    import numpy as np

    from tcgan_tpu.run import gan
    from tcgan_tpu.train.checkpoint import CheckpointManager

    summary = {"ok": True}
    for backend in ("xla", "pallas"):
        store = RUNS / f"gan_{backend}"
        argv = ["--datastore", str(store), *_circuit_flags(sizes),
                *_truth_flags(), "--J", *_flat(START_J), "--D", *_flat(START_D),
                "--S", *_flat(TRUE_S),
                "--bandwidths", *_flat(BANDWIDTHS),
                "--contrasts", "5", "10", "13",
                "--sample-sites", "4", "--include-inhibitory-neurons",
                "--track_offset_identity", "--normalize-input-mode", "std",
                "--reject-unconverged", "--moment-anchor", "2e-3",
                "--batch-size", str(sizes.gan_batch),
                "--truth-samples", str(sizes.truth_samples),
                "--truth-batch", str(sizes.truth_samples),
                "--truth-tries-factor", "16",
                "--solver-backend", backend]
        gan.main(argv + ["--n-steps", str(sizes.gan_steps)])
        res = _check_run(store, ("d_loss", "g_loss"), sizes.gan_steps)
        ckpt = CheckpointManager(store / "ckpt")
        res["checkpoint_step"] = ckpt.latest_step()
        # --resume reads the checkpoint back and continues from it
        gan.main(argv + ["--n-steps", "1", "--resume"])
        after = _check_run(store, ("d_loss", "g_loss"), sizes.gan_steps + 1)
        res["resumed_step"] = ckpt.latest_step()
        res["train_time"] = after["train_time"]
        # steady steps: step 0 compiles and runs the n_critic0 warm-up,
        # step 1 recompiles for the adaptive solver budget, and the
        # resumed run compiles again
        steady = after["train_time"][2:sizes.gan_steps]
        res["steady_step_s"] = float(np.median(steady)) if steady else None
        res["ok"] = bool(res["ok"] and after["ok"]
                         and res["checkpoint_step"] == sizes.gan_steps
                         and res["resumed_step"] == sizes.gan_steps + 1)
        log("gan", backend=backend, steps=after["rows"],
            finite=after["finite"],
            frac_converged=",".join(f"{v:.4f}"
                                    for v in after["frac_converged"]),
            train_time_s=",".join(f"{v:.4f}" for v in after["train_time"]),
            steady_step_s=res["steady_step_s"],
            checkpoint=res["checkpoint_step"], resumed=res["resumed_step"],
            ok=res["ok"])
        summary[backend] = res
        summary["ok"] &= res["ok"]
    return summary


# ---------------------------------------------------------------- phase 4


def phase_entry_points(sizes: Sizes) -> dict:
    from tcgan_tpu.run import bptt_cwgan, bptt_wgan, ensemble, moments

    common = [*_circuit_flags(sizes), *_truth_flags(), "--n-steps", "2",
              "--contrasts", "10",
              "--truth-samples", str(sizes.other_truth),
              "--truth-batch", str(sizes.other_truth),
              "--batch-size", str(sizes.other_batch)]
    gan_common = ["--WGAN_n_critic0", "5", "--seqlen", str(sizes.seqlen)]
    runs = {
        "bptt_wgan": (bptt_wgan.main, gan_common, ("d_loss", "g_loss")),
        "bptt_cwgan": (bptt_cwgan.main, gan_common, ("d_loss", "g_loss")),
        "moments": (moments.main, [], ("loss",)),
        "ensemble": (ensemble.main, ["--ensemble", "2",
                                     "--WGAN_n_critic0", "5",
                                     "--record-every", "1"], None),
    }
    summary = {"ok": True}
    for name, (main, extra, cols) in runs.items():
        store = RUNS / name
        main(["--datastore", str(store), *common, *extra])
        if cols is None:
            import numpy as np

            params = np.load(store / "ensemble_params.npz")
            finite = all(np.isfinite(params[k]).all() for k in params.files)
            rows = read_csv(store / "ensemble.csv")
            res = {"finite": finite, "rows": len(rows),
                   "ok": bool(finite and rows)}
        else:
            res = _check_run(store, cols, 2)
        log("entry", run=name, **{k: v for k, v in res.items()
                                  if k in ("rows", "finite", "ok")})
        summary[name] = res
        summary["ok"] &= res["ok"]
    return summary


# ---------------------------------------------------------------- phase 5


def phase_mesh(sizes: Sizes) -> dict:
    import numpy as np

    from tcgan_tpu.run import forward, moments

    # J and D scaled by 51/N keep a circuit's summed input, and so its
    # stability, at the N=51 bench circuit's (all converge at contrast 10)
    k = 51.0 / sizes.mesh_N
    true_j, true_d = (np.multiply(TRUE_J, k), np.multiply(TRUE_D, k))
    start = np.concatenate([np.multiply(START_J, k), np.multiply(START_D, k),
                            TRUE_S])
    base = ["--N", str(sizes.mesh_N), "--max-iter", str(sizes.max_iter),
            "--atol", "1e-4", "--contrasts", "10"]
    summary = {"ok": True}

    params = {}
    for mode in ("one", "mesh"):
        store = RUNS / f"mesh_moments_{mode}"
        argv = ["--datastore", str(store), *base, "--n-steps", "2",
                "--true-J", *_flat(true_j), "--true-D", *_flat(true_d),
                "--true-S", *_flat(TRUE_S),
                "--J", *_flat(start[:4]), "--D", *_flat(start[4:8]),
                "--S", *_flat(TRUE_S),
                "--batch-size", str(sizes.mesh_batch),
                "--truth-samples", str(sizes.mesh_truth),
                "--truth-batch", str(sizes.mesh_truth)]
        if mode == "mesh":
            argv += ["--parallel", "mesh"]
        moments.main(argv)
        rows = read_csv(store / "learning.csv")
        gen = read_csv(store / "generator.csv")
        params[mode] = np.array([float(gen[-1][c]) for c in GEN_COLUMNS])
        summary[f"moments_{mode}"] = {
            "finite": _finite_column(rows, "loss"),
            "frac_converged": [float(r["frac_converged"]) for r in rows],
            "train_time": [float(r["train_time"]) for r in rows]}
    moved = float(np.abs(params["one"] - start).max())
    gap = float(np.abs(params["mesh"] - params["one"]).max())
    rel = gap / max(moved, 1e-30)
    mm_ok = bool(rel <= MESH_REL and summary["moments_one"]["finite"]
                 and summary["moments_mesh"]["finite"])
    log("mesh", run="moments", N=sizes.mesh_N, params_moved=moved,
        mesh_vs_one=gap, rel=f"{rel:.5f}", tol=MESH_REL,
        train_time_one=summary["moments_one"]["train_time"],
        train_time_mesh=summary["moments_mesh"]["train_time"], ok=mm_ok)
    summary["moments"] = {"moved": moved, "gap": gap, "rel": rel,
                          "ok": mm_ok}

    outs = {}
    for mode in ("one", "mesh"):
        store = RUNS / f"mesh_forward_{mode}"
        argv = ["--datastore", str(store), *base,
                "--J", *_flat(true_j), "--D", *_flat(true_d),
                "--S", *_flat(TRUE_S),
                "--batch-size", str(sizes.mesh_batch),
                "--total-samples", str(sizes.mesh_fwd_total)]
        if mode == "mesh":
            argv += ["--parallel", "mesh"]
        forward.main(argv)
        outs[mode] = np.load(store / "tuning_curves.npz")
        info = json.loads((store / "info.json").read_text())["summary"]
        summary[f"forward_{mode}"] = info
        log("mesh", run="forward", mode=mode, n_devices=info["n_devices"],
            circuits_per_s=f"{info['circuits_per_sec']:.1f}",
            stim_solves_per_s=f"{info['stim_solves_per_sec']:.1f}",
            frac_converged=f"{info['frac_converged']:.4f}")
    a, b = outs["one"], outs["mesh"]
    both = a["converged"] & b["converged"]
    diff = np.abs(a["rates"] - b["rates"])[both]
    rows = both.size
    fwd = {"max_rate_diff": float(diff.max()) if diff.size else 0.0,
           "conv_mismatch": int((a["converged"] != b["converged"]).sum()),
           "rows": rows}
    fwd["ok"] = bool(fwd["max_rate_diff"] <= RATE_ATOL
                     and fwd["conv_mismatch"] <= FLAG_FRAC * rows
                     and summary["forward_mesh"]["n_devices"] > 1)
    log("mesh", compare="forward_mesh_vs_one", **fwd)
    summary["forward"] = fwd
    summary["ok"] = mm_ok and fwd["ok"]
    return summary


ONE_CARD = {"kernel": phase_kernel, "forward": phase_forward,
            "gan": phase_gan, "entry": phase_entry_points}


def run_phases(phases: dict, sizes: Sizes) -> dict:
    """Run each phase; a raised exception is a failed phase, and the
    remaining phases still run so one call reports them all."""
    results = {}
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            res = fn(sizes)
        except (Exception, SystemExit) as e:  # a CLI's argparse exits
            traceback.print_exc()
            res = {"ok": False, "error": repr(e)}
        res["seconds"] = time.perf_counter() - t0
        log(name, done=res["ok"], seconds=f"{res['seconds']:.1f}")
        results[name] = res
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh phase")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform!r} "
              "devices); nothing runs on the CPU", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    from tcgan_tpu.run.common import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    dev = devices[0]
    print(card, flush=True)
    log("setup", device_kind=repr(dev.device_kind), count=len(devices),
        jax=jax.__version__, compile_cache=cache)

    phases = {"mesh": phase_mesh} if args.four_cards else ONE_CARD
    shutil.rmtree(RUNS, ignore_errors=True)
    results = run_phases(phases, Sizes())
    ok = all(r["ok"] for r in results.values())
    SUMMARY.parent.mkdir(parents=True, exist_ok=True)
    SUMMARY.write_text(json.dumps({
        "card": card, "device_kind": dev.device_kind,
        "count": len(devices), "jax": jax.__version__,
        "phases": results}, indent=1, default=str))
    if not ok:
        failed = [k for k, r in results.items() if not r["ok"]]
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
