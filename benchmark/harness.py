"""One run of one cell: every name is looked up through BENCHMARK.json.

A cell names a configuration (its `file`, under benchmark/configs/) and a
traffic mix (benchmark/traffic/<traffic>.json); the mix names its driver
(benchmark/drivers/<driver>.py); the correctness limits of a cell are
benchmark/limits/<cell>.json; a per-layer metric is read by
benchmark/metrics/<metric>.py or, where that file is absent, by the reader
of its name before the last dot (`mfu.train` -> metrics/mfu.py). Adding a
cell, configuration, mix, driver or metric is adding files and entries.

A driver module has:
  setup(cfg, traffic, seed, device, tracer) -> state   (weights, inputs, warm-up)
  window(state, seconds) -> {end-to-end metric: value} (measured, untraced)
  traced(state, tracer)                                 (the traced window)
  check(state, seed) -> [(name, reading)]              (after the window; frees the
                                                        program's state first)
  control(cfg, traffic, seed, device, precision) -> [(name, reading)]
  unit_flops(state) -> the reference's FLOPs of one unit
  state.units, the units the window ran.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import roofline, trace as trace_mod

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dynavsr_tpu")
GIB = 2.0 ** 30


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name (before the first dot, compared
    whole) is jax, jaxlib, flax or the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: metrics/<name>.py, or else the
    reader its suffix-less name shares (metrics/<name before the last dot>.py)."""
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    return own if own.exists() else BENCH_DIR / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"


def verdict(readings, limits: dict):
    """[(number, reading, limit)] for every limited number, and whether all
    hold; a limited number that the readings lack raises."""
    checks = [(n, v, limits[n]) for n, v in readings if n in limits]
    missing = set(limits) - {n for n, _, _ in checks}
    if missing:
        raise KeyError(f"the check read no {sorted(missing)}")
    return checks, all(v <= lim for _, v, lim in checks)


def guard() -> None:
    """Raise ForbiddenImport if a module of JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(bench: dict, cell_name: str, root: Path = ROOT) -> dict:
    """The files and entries of one cell: its configuration, traffic mix,
    driver, limits, and end-to-end and per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = root / "benchmark" / "drivers" / f"{traffic['driver']}.py"
    limits = json.loads((root / "benchmark" / "limits" / f"{cell_name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell_name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "driver": driver,
            "limits": limits["limits"], "e2e": e2e, "per_layer": per_layer}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device: str,
             t0: float, root: Path = ROOT, overrides: Optional[dict] = None) -> dict:
    """Set up, run the window (or the traced window), check, and return the
    result's fields. `overrides` ({"cfg": ..., "traffic": ..., "limits": ...})
    exist for the CPU tests, which run a cell at a tiny size."""
    r = resolve(load_bench(root), cell_name, root)
    cfg = _merge(r["cfg"], (overrides or {}).get("cfg", {}))
    traffic = _merge(r["traffic"], (overrides or {}).get("traffic", {}))
    driver = load_module(r["driver"], f"benchmark_driver_{traffic['driver']}")
    cuda = device != "cpu"
    tracer = trace_mod.Tracer(sync=cuda)
    state = driver.setup(cfg, traffic, seed, device, tracer)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    setup_s = start - t0
    e2e: Dict[str, float] = {}
    if traced:
        with tracer.window():
            driver.traced(state, tracer)
    else:
        e2e = driver.window(state, seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tracer.restore()
    guard()
    e2e.update(setup_s=setup_s, peak_mem_gib=peak / GIB)
    readings = driver.check(state, seed)
    checks, correct = verdict(readings, {**r["limits"], **(overrides or {}).get("limits", {})})
    out = {"correct": correct, "attempted": int(state.units), "failed": 0 if correct else 1,
           "checks": checks, "readings": readings, "peak_bytes": int(peak)}
    if traced:
        tr = tracer.trace
        tr.info["flops_per_unit"] = driver.unit_flops(state)
        if not tr.device and cuda:
            raise RuntimeError("the traced window's profile holds no device event")
        out["metrics"] = {}
        for m in r["per_layer"]:
            reader = load_module(reader_path(m["name"]),
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            v = reader.read(tr)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": trace_mod.device_ops(tr, roofline.kernel_label),
                            "idle_gaps": trace_mod.idle_gaps(tr)}
    else:
        out["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                          for m in r["e2e"]}
    guard()  # the check and the readers ran after the window closed
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package were loaded: " + ", ".join(names))
        self.names = names
