#!/usr/bin/env python3
"""One traced run of a cell, as `run.py --trace 1` makes it, then the
device's idle by the innermost program span the host was in, over the
window and in its ten longest gaps (program_trace.idle_by_span and
longest_gaps_by_span), in ms a unit:

    python3 benchmark/breakdown.py --workload <cell> --seed <n> [--seconds 30]

Prints the run's per-layer metrics as one JSON line first. Exits 2 with no
result where no card is present.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    from benchmark import harness, program_trace as pt, trace as trace_mod

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    made = []

    class Kept(trace_mod.Tracer):  # the harness's Tracer, kept for after the run
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    trace_mod.Tracer = Kept
    out = harness.run_cell(args.workload, args.seed, args.seconds, True, "cuda", T0, ROOT)
    tr = made[-1].trace
    units = tr.counters.get("units", 0) or 1
    print(json.dumps({k: v["value"] for k, v in out["metrics"].items()}))
    print(f"{args.workload} seed {args.seed}: correct {out['correct']}; window "
          f"{tr.window_s:.4f} s, busy {tr.busy_s:.4f} s, units {units}")
    print("device idle by innermost program span (ms a unit):")
    for name, us in pt.idle_by_span(tr).items():
        print(f"  {name:24s} {us / 1e3 / units:10.3f}")
    print("ten longest idle gaps (ms), cut by innermost program span (ms):")
    for us, cut in pt.longest_gaps_by_span(tr):
        print(f"  {us / 1e3:9.3f}:", ", ".join(
            f"{n} {v / 1e3:.3f}" for n, v in sorted(cut.items(), key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
