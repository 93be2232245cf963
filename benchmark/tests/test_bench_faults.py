"""Each cell's run, at a tiny size on the CPU (the harness's look for a
card skipped), comes out correct as it stands and not correct with the
timed path broken underneath: a step that leaves its state unchanged,
half of the batch left out of the loss (its mean over the rest), an
answer altered where it is produced. The control (the reference at the
next lower precision in the program's place) reads above the program on
every number it moves, and comes out not correct under the cell's limits.
A module of JAX loaded after the window (by the check or a metric reader)
stops the run before any result."""

import io
import sys
import time
import types
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import faults, harness

TINY_NETS = {"network_G": {"nf": 8, "groups": 2, "front_RBs": 1, "back_RBs": 1},
             "network_E": {"nf": 8}}
TINY = {
    "edvr_m.reds4": {"cfg": TINY_NETS, "traffic": {"clip": {"frames": 8, "lr_h": 16, "lr_w": 20},
                                                    "pool": 2, "check_among": 2,
                                                    "check_frames": 4}},
    # At nf 8 the bf16 net's median leaf changes 1.3e-2 away from the
    # float32 reference (1e-3 at EDVR-L's widths): this size's own limit.
    "edvr_l.reds4": {"cfg": TINY_NETS, "traffic": {"clip": {"frames": 8, "lr_h": 16, "lr_w": 20},
                                                    "pool": 2, "check_among": 2,
                                                    "check_frames": 4},
                     "limits": {"weight_change_median": 0.05}},
    "edvr_m.meta_reds": {"cfg": {**TINY_NETS, "meta": {"batch_size": 2, "GT_size": 64}},
                         "traffic": {"pool": {"clips": 2, "frames": 6, "hr_h": 72, "hr_w": 80}}},
    "edvr_m.live4_qcif": {"cfg": TINY_NETS, "traffic": {"h": 16, "w": 20, "pool_frames": 12,
                                                         "check_among": 6}},
}
CELLS = [c["name"] for c in harness.load_bench()["workloads"]]
SEED = 2 ** 31 + 4099


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.0, False, "cpu", time.perf_counter(),
                            overrides=TINY[cell], **kw)


CASES = [(c, f) for c in CELLS for f in faults.FAULTS if faults.applies(c, f)]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    faults.FAULTS[fault](monkeypatch, cell)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    r = harness.resolve(harness.load_bench(), cell)
    cfg = harness._merge(r["cfg"], TINY[cell]["cfg"])
    traffic = harness._merge(r["traffic"], TINY[cell]["traffic"])
    driver = harness.load_module(r["driver"], "ctl_" + cell.replace(".", "_"))
    prog = {n: v for n, v, _ in _run(cell)["checks"]}
    ctl = dict(driver.control(cfg, traffic, SEED, "cpu",
                              "fp8" if cfg["network_G"].get("dtype") == "bf16" else "tf32"))
    assert set(prog) <= set(ctl)
    assert max(ctl[n] / max(prog[n], 1e-12) for n in prog) > 10, (prog, ctl)
    checks, correct = harness.verdict(list(ctl.items()),
                                      {**r["limits"], **TINY[cell].get("limits", {})})
    assert not correct, checks


def _forget_jax(monkeypatch):
    for n in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, n)


@pytest.mark.parametrize("where", ["check", "reader"])
def test_jax_loaded_after_the_window_stops_the_run(monkeypatch, where):
    """A cell's check (the reference) or a metric reader loads `jax`:
    run_cell raises rather than return a result."""
    _forget_jax(monkeypatch)
    real = harness.load_module
    attr = "check" if where == "check" else "read"

    def load(path, name):
        mod = real(path, name)
        fn = getattr(mod, attr, None)
        if fn is not None and name.startswith("benchmark_driver_") == (where == "check"):
            def loading(*a, **k):
                monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
                return fn(*a, **k)
            monkeypatch.setattr(mod, attr, loading)
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    cell = "edvr_m.meta_reds"
    with pytest.raises(harness.ForbiddenImport):
        harness.run_cell(cell, SEED, 0.0, where == "reader", "cpu", time.perf_counter(),
                         overrides=TINY[cell])


def test_run_prints_no_result_once_jax_is_loaded(monkeypatch):
    """run.py looks again just before it prints: a module of JAX loaded
    after run_cell returned gives exit code 3 and no result line."""
    _forget_jax(monkeypatch)
    run = harness.load_module(harness.BENCH_DIR / "run.py", "benchmark_run_under_test")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")

    def run_cell(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "checks": [],
                "readings": [], "peak_bytes": 0}

    monkeypatch.setattr(harness, "run_cell", run_cell)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "edvr_m.reds4", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc == 3 and "{" not in out.getvalue()
