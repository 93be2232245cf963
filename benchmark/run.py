#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card(s) of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last `checks`, each number the correctness comparison read beside its
limit; the same numbers are the last lines of standard error. Exits
nonzero without a result when no card (or fewer than the cell asks for)
is present, or when a module of JAX or the JAX package was loaded.
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
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Kernel builds and caches stay inside the checkout, at fixed paths.
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    from benchmark import harness, roofline

    bench = harness.load_bench(ROOT)
    cell = harness.resolve(bench, args.workload, ROOT)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", T0, ROOT)
    except harness.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["peak_bytes"], "power_limit_w": roofline.power_limit_w()}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    compared = {n for n, _, _ in out["checks"]}
    for name, v in out["readings"]:
        if name not in compared:
            print(f"reading {name} = {v!r} (not compared)", file=sys.stderr)
    for name, v, lim in out["checks"]:
        print(f"check {name} = {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    try:
        harness.guard()  # the last look before the result
    except harness.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
