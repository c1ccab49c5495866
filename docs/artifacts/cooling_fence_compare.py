#!/usr/bin/env python
"""Round-5 cooling fence (VERDICT r4 next #6; ROUND5 §1): paired read of
the flagship's COOLED post-latch tail vs the HOT continuation
(runs/rec13fence: same checkpoint, same anchor schedule, adversarial lr
floored at its latch-region value instead of 1e-8) over the same
absolute step range. Reports per-arm tail-mean J/D/S recovery errors and
the per-step error series summary — the fence passes if the cooled arm's
J/D tail is at or below the hot arm's (the tiny-battery counter-result
showed cooling HURTS when moments under-identify J; this is the
rich-battery test that must run on chip, per ROUND5 §1).

Host-side only (reads CSVs; no device).
"""
from __future__ import annotations

import os
import sys

# standalone-invocation bootstrap: these scripts live in docs/artifacts
# but import the repo package (the 04:17 queue run failed on a bare
# `python docs/artifacts/...py` without PYTHONPATH)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import argparse
import json

import numpy as np

from tcgan_tpu.analysis import loaders


def tail_errors(run: str, from_step: int, truth: dict):
    rec = loaders.load_run(run)
    gen = rec.generator  # dict of column arrays (loaders._read_csv)
    steps = np.asarray(gen["step"], float)
    sel = steps >= from_step
    if not sel.any():
        return None
    out = {"n_rows": int(sel.sum()),
           "step_range": [float(steps[sel][0]), float(steps[sel][-1])]}
    for fam in ("J", "D", "S"):
        e = np.mean([np.abs(np.asarray(gen[f"{fam}_{c}"], float)[sel]
                            - truth[fam][c]) / truth[fam][c]
                     for c in ("EE", "EI", "IE", "II")], axis=0)
        out[fam] = {"tail_mean": round(float(e.mean()), 5),
                    "tail_last": round(float(e[-1]), 5),
                    "tail_max": round(float(e.max()), 5),
                    "tail_min": round(float(e.min()), 5)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cooled", required=True)
    ap.add_argument("--hot", required=True)
    ap.add_argument("--from-step", type=int, required=True)
    ap.add_argument("--labels", nargs=2, default=["cooled", "hot"],
                    help="arm names for the output keys/verdict (the "
                         "script compares ANY two tails from the same "
                         "checkpoint; e.g. 'g0.98 g0.995' for the "
                         "gamma counterfactual)")
    args = ap.parse_args()

    info = json.load(open(f"{args.cooled}/info.json"))["config"]
    keys = ("EE", "EI", "IE", "II")
    truth = {f: dict(zip(keys, info[f"true_{f}"]))
             for f in ("J", "D", "S")}

    cooled = tail_errors(args.cooled, args.from_step, truth)
    hot = tail_errors(args.hot, args.from_step, truth)
    la, lb = args.labels
    verdict = None
    if cooled and hot:
        if [la, lb] == ["cooled", "hot"]:
            verdict = ("cooling helps (or ties)"
                       if (cooled["J"]["tail_mean"]
                           <= hot["J"]["tail_mean"] + 0.002
                           and cooled["D"]["tail_mean"]
                           <= hot["D"]["tail_mean"] + 0.002)
                       else "cooling hurts on this battery — revisit "
                            "--gen-lr-switch-* defaults (VERDICT r4 next #6)")
        else:
            # Generic two-arm read: report which arm each family favors
            # (tail_last, i.e. the endpoint of the shared step range).
            fams = {f: (la if cooled[f]["tail_last"]
                        <= hot[f]["tail_last"] else lb)
                    for f in ("J", "D", "S")}
            verdict = ("endpoint favors: "
                       + ", ".join(f"{f}->{w}" for f, w in fams.items()))
    print(json.dumps({"from_step": args.from_step, la: cooled,
                      lb: hot, "verdict": verdict}, indent=2))


if __name__ == "__main__":
    main()
