"""The import guard compares whole top-level names, and nothing the
benchmark loads is JAX or the JAX package; the reference loads nothing of
the program (CPU only)."""

import ast
import subprocess
import sys
import types

import pytest

from benchmark import harness


@pytest.mark.parametrize("name,flagged", [("dynavsr_tpu_torch.ops", False),
                                          ("dynavsr_tpu_torch", False),
                                          ("dynavsr_tpu", True), ("dynavsr_tpu.models", True),
                                          ("jax", True), ("jaxlib.xla_client", True),
                                          ("flax.linen", True), ("jaxtyping", False)])
def test_guard_compares_whole_top_level_names(monkeypatch, name, flagged):
    for n in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, n)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) == flagged


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert set(tops) <= {"__future__", "typing", "math", "numpy", "torch", "benchmark"}, \
                (path.name, tops)


def test_harness_and_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "[harness.load_module(p, 'd' + p.stem)._port() "
            "for p in (harness.BENCH_DIR / 'drivers').glob('[!_]*.py')]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
