"""Progress monitor for the flagship anchor run (runs/rec13anchor2).

Prints J/D/S recovery errors vs truth along the generator.csv trajectory
plus the latest learning.jsonl observables (anchor residual, circuit
yield, critic accuracy). Pure host-side CSV reading — safe to run while
the training job is live.

Usage: python docs/artifacts/monitor_rec13anchor2.py [run_dir]
"""
import csv
import json
import sys

import numpy as np

RUN = sys.argv[1] if len(sys.argv) > 1 else "runs/rec13anchor2"
TJ = np.array([0.045, 0.04, 0.05, 0.035])
TD = np.array([0.1, 0.08, 0.1, 0.08])
TS = np.array([0.25, 0.1, 0.25, 0.1])


def main():
    rows = list(csv.reader(open(f"{RUN}/generator.csv")))
    data = np.array(rows[1:], dtype=float)
    steps, J, D, S = data[:, 0], data[:, 1:5], data[:, 5:9], data[:, 9:13]
    jerr = np.abs(J / TJ - 1).mean(1)
    derr = np.abs(D / TD - 1).mean(1)
    serr = np.abs(S / TS - 1).mean(1)
    marks = np.unique(np.concatenate([
        np.arange(0, len(steps), max(1, len(steps) // 12)),
        [len(steps) - 1]]))
    print(f"{'step':>7} {'Jerr':>7} {'Derr':>7} {'Serr':>7}")
    for i in marks:
        print(f"{steps[i]:>7.0f} {jerr[i]:>7.3f} {derr[i]:>7.3f} "
              f"{serr[i]:>7.3f}")
    gate = (jerr[-1] <= 0.10) and (derr[-1] <= 0.10)
    print(f"\nlatest: J {jerr[-1]:.1%}  D {derr[-1]:.1%}  S {serr[-1]:.1%}"
          f"   GATE(J<=10% and D<=10%): {'CLEARED' if gate else 'not yet'}")
    try:
        last = None
        for line in open(f"{RUN}/learning.jsonl"):
            last = line
        m = json.loads(last)
        keys = ("step", "d_accuracy", "anchor_residual", "circuit_yield",
                "frac_converged", "wasserstein")
        print("learning tail:",
              {k: round(m[k], 4) for k in keys if k in m and m[k] is not None})
    except (OSError, TypeError, ValueError):
        pass


if __name__ == "__main__":
    main()
