#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, at the cell's
own size, on the card, in one process:

    python3 benchmark/controls.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed N] [--fault NAME] [--out FILE]

* the lower readings: a short run of the cell (set-up, one unit, the
  check) on each of `--seeds` seeds, its numbers read before any limit;
* with --fault, the program's readings with that fault of
  benchmark/faults.py planted (a training cell's upper readings);
* the control: the plain reference at the next lower precision than the
  configuration states (tf32 for fp32, fp8 for bf16), put in the program's
  place and held against the reference by the same numbers, on
  `--control-seeds` seeds.

Prints one JSON line: {"program": {number: [readings]}, "control": {...},
"verdicts": ...}. A cell's limits (benchmark/limits/<cell>.json) lie above
the program's largest reading and below the control's smallest where that
separates. Each control seed, and with --fault each program seed, is held
against those limits by the harness's own comparison: the command exits 1
if any of them comes out correct (the limits would let it pass). Without
--fault the program's verdicts are printed and decide nothing, since the
limits are set from those readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOWER = {"fp32": "tf32", "bf16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of benchmark/faults.py in the program's runs")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    r = harness.resolve(harness.load_bench(ROOT), args.workload, ROOT)
    driver = harness.load_module(r["driver"], "benchmark_driver_" + r["traffic"]["driver"])
    dtype = "bf16" if r["cfg"]["network_G"].get("dtype") == "bf16" else "fp32"
    precision = LOWER[dtype]
    out = {"workload": args.workload, "precision": precision, "program": {}, "control": {},
           "seconds": {}, "verdicts": {"program": [], "control": []}}
    seeds = [args.first_seed + 7919 * i for i in range(max(args.seeds, args.control_seeds))]
    if args.fault:
        from benchmark import faults

        class Patches:
            def setattr(self, obj, name, value):
                setattr(obj, name, value)
        faults.FAULTS[args.fault](Patches(), args.workload)
        out["fault"] = args.fault
    t = time.perf_counter()
    for s in seeds[: args.seeds]:
        res = harness.run_cell(args.workload, s, 0.0, False, "cuda", time.perf_counter(), ROOT)
        for name, v in res["readings"]:
            out["program"].setdefault(name, []).append(v)
        out["verdicts"]["program"].append(res["correct"])
        print(f"program seed {s}: correct {res['correct']} {res['readings']}", file=sys.stderr,
              flush=True)
    out["seconds"]["program"] = time.perf_counter() - t
    t = time.perf_counter()
    for s in seeds[: args.control_seeds]:
        readings = driver.control(r["cfg"], r["traffic"], s, "cuda", precision)
        for name, v in readings:
            out["control"].setdefault(name, []).append(v)
        checks, correct = harness.verdict(readings, r["limits"])
        out["verdicts"]["control"].append(correct)
        torch.cuda.empty_cache()
        print(f"control seed {s}: correct {correct} {checks}", file=sys.stderr, flush=True)
    out["seconds"]["control"] = time.perf_counter() - t
    passed = out["verdicts"]["control"] + (out["verdicts"]["program"] if args.fault else [])
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    if any(passed):
        print(f"{sum(passed)} control or fault run(s) came out correct under "
              f"benchmark/limits/{args.workload}.json", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
