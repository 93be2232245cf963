"""BENCHMARK.json holds the keys and limits of its format, and every name in it
resolves to the files that carry it (CPU only)."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_their_keys_and_valid_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
            "source": "host_clock"} in BENCH["end_to_end"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    r = harness.resolve(BENCH, cell)
    assert r["driver"].exists()
    for fn in ("setup", "window", "traced", "check", "control", "unit_flops"):
        assert callable(getattr(harness.load_module(r["driver"], "d_" + cell.replace(".", "_")),
                                fn))
    names = {m["name"] for m in r["e2e"]}
    assert "setup_s" in names and len(names) >= 2 and r["per_layer"]
    for m in r["per_layer"]:
        mod = harness.load_module(harness.reader_path(m["name"]), "m")
        assert callable(mod.read) and m["moves"] in names
    assert r["limits"] and all(v > 0 for v in r["limits"].values())


@pytest.mark.parametrize("metric,reader", [("mfu.train", "mfu.py"),
                                           ("device_idle_pct.stream", "device_idle_pct.py"),
                                           ("dcn_roofline.train", "dcn_roofline.train.py"),
                                           ("mfu", "mfu.py")])
def test_reader_is_its_own_file_or_the_one_its_stem_shares(metric, reader):
    assert harness.reader_path(metric) == harness.BENCH_DIR / "metrics" / reader


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_states_its_source_and_cuts(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert cfg["source"] and "assumed" in cfg and cfg["reduced"] == conf["reduced"]
    assert cfg["network_G"]["nf"] in (64, 128) and cfg["network_G"]["groups"] == 8
