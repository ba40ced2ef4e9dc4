"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module names; the plain reference imports nothing of the
port."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nrse_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_module_of_the_benchmark_names_jax():
    files = [p for p in run.BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        found = set(imported(p)) & FORBIDDEN
        assert not found, (p, found)


def test_the_reference_imports_nothing_of_the_program():
    for p in (run.BENCH / "reference").glob("*.py"):
        assert "nrse_tpu_torch" not in set(imported(p)), p


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run in a fresh process whose import system refuses the
    forbidden names, and whose modules are listed after the run."""
    script = tmp_path / "drive.py"
    script.write_text(f"""
import sys, importlib.abc
sys.path.insert(0, {str(run.ROOT)!r})
FORBIDDEN = {sorted(FORBIDDEN)!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in FORBIDDEN:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from portbench import run
from portbench.tests.tiny import OVERRIDES
rc = run.main(["--workload", "ser-eval-ragged", "--seed", "5",
               "--seconds", "0.2", "--trace", "0"], device="cpu",
              overrides=OVERRIDES["ser-eval-ragged"])
assert rc == 0, rc
bad = [n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN]
assert not bad, bad
print("clean")
""")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_jax_loaded_by_the_reference_leaves_no_result(monkeypatch):
    """A stub ``jax`` that enters ``sys.modules`` while the reference runs,
    after the window: the run prints no result and fails."""
    import contextlib
    import importlib
    import io
    import types

    from portbench.tests.tiny import OVERRIDES

    entry = importlib.import_module("portbench.entries.evaluate")
    check = entry.Cell.check

    def check_loading_jax(self, *a, **k):
        sys.modules["jax"] = types.ModuleType("jax")
        return check(self, *a, **k)

    monkeypatch.setattr(entry.Cell, "check", check_loading_jax)
    saved = sys.modules.pop("jax", None)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = run.main(["--workload", "ser-eval-ragged", "--seed", "7",
                           "--seconds", "0.2", "--trace", "0"],
                          device="cpu", overrides=OVERRIDES["ser-eval-ragged"])
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved
    assert rc != 0
    assert out.getvalue().strip() == ""
    assert "jax" in err.getvalue()
