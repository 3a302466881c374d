"""The readings a cell's limits are set from, in one process on the card.

    python3 -m portbench.readings --workload <cell> --seconds <s> [--seeds 12] [--control 3] [--faults 3]

Runs the cell as a run does (set-up, a window of ``--seconds``, the check)
over ``--seeds`` seeds, the control (the reference in TF32 in the
program's place) on the first ``--control`` of them, and each fault of
``faults.py`` that the cell's driver can have on ``--faults`` further
seeds; prints one JSON line a run, then a summary: for each number the
lower reading (the largest over the sound runs), the control's least, and
each fault's least; and, judged by the cell's limits as a run's check
judges, whether each sound run, each control and each fault run came out
correct. Seeds are drawn above 2**31 from ``--first-seed``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import bench, faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    driver = cell.traffic["driver"]
    sound, control, planted = {}, {}, {}
    verdicts, control_runs = {}, []  # each run's `correct`; each control run's numbers
    seed = args.first_seed

    def one(label, ctl=False):
        nonlocal seed
        t0 = time.time()
        r = bench.run_cell(cell, seed, args.seconds, False, "cuda", control=ctl)
        print(json.dumps({"run": label, "seed": seed, "correct": r["correct"], "readings": r["readings"],
                          "s": round(time.time() - t0, 1)}), flush=True)
        verdicts.setdefault(label, []).append(r["correct"])
        ctl_numbers = {k[len("control."):]: v for k, v in r["readings"].items() if k.startswith("control.")}
        if ctl_numbers:
            control_runs.append(ctl_numbers)
        seed += 7919
        gc.collect()  # the run's program and reference, before the next one's set-up
        return r["readings"]

    for i in range(args.seeds):
        for k, v in one("sound", i < args.control).items():
            (control if k.startswith("control.") else sound).setdefault(k.split(".")[-1], []).append(v)
    for fault in (faults.EXTRACT if driver == "extract" else faults.TRAIN) if args.faults else ():
        for _ in range(args.faults):
            with faults.planted(driver, fault):
                for k, v in one(fault).items():
                    planted.setdefault(fault, {}).setdefault(k, []).append(v)
    summary = {k: {"lower": max(v), "sound": v, "limit": cell.limits.get(k),
                   "control_least": min(control.get(k, [float("nan")])),
                   **{f"{f}_least": min(planted[f][k]) for f in planted}} for k, v in sound.items()}
    # judged as a run's check judges: a run is correct only if every number is within its limit
    judged = {"sound_correct": verdicts["sound"],
              "control_correct": [all(v <= cell.limits[k] for k, v in r.items() if k in cell.limits)
                                  for r in control_runs],
              **{f"{f}_correct": verdicts[f] for f in planted}}
    print(json.dumps({"summary": summary, "judged": judged}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
