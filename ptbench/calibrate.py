"""Readings that the limits of ``ptbench/checks/<cell>.json`` are set
from: for each seed, the check's numbers of a sound run of the program (a
short window at the cell's own sizes) and of the control, the reference
computed in the precision below the configuration's (bfloat16 for
float32) put in the program's place. One JSON line a seed, then the
largest program reading and the smallest control reading of each number.

    python3 ptbench/calibrate.py --workload cover_frames --seeds 11 12 13 --seconds 1

It is not part of a benchmark run; a limit lies above the program's
readings and below the control's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ptbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ptbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also read the control")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    rows = []
    for i, seed in enumerate(args.seeds):
        keep = {}
        t0 = time.perf_counter()
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           device=args.device, keep=keep)
        t_check = time.perf_counter() - t0
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["check"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "run_s": t_check}
        cell = keep["cell"]
        if hasattr(cell, "losses"):  # train steps: each step's loss, both sides
            row["losses"] = [cell.losses, list(cell.ref[0])]
        if i < args.control_seeds:
            t1 = time.perf_counter()
            row["control"] = cell.control(torch.bfloat16)
            row["control_s"] = time.perf_counter() - t1
        rows.append(row)
        print(json.dumps(row), flush=True)
        keep.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    names = rows[0]["program"].keys()
    summary = {"workload": args.workload,
               "program_max": {n: max(r["program"][n] for r in rows)
                               for n in names},
               "control_min": {n: min(r["control"][n] for r in rows
                                      if "control" in r)
                               for n in names if any("control" in r
                                                     for r in rows)}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
