"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere in ``portbench/``, and nothing of the program in its reference.
Module names are compared by their top-level name (before the first dot),
whole: ``shadow1_tpu_torch`` is the program and ``shadow1_tpu`` the JAX
package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "shadow1_tpu"}
PROGRAM = "shadow1_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value,
                                                           str):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


def harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = imported(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PROGRAM not in imported(path), path.relative_to(ROOT)
        # Nor through the harness, which imports the program: only the
        # reference's own modules.
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            for m in mods:
                if m.split(".", 1)[0] == "portbench":
                    assert m.startswith("portbench.reference"), (path, m)


def test_top_level_names_are_compared_whole():
    from portbench.harness import forbidden_modules

    sys.modules.setdefault("shadow1_tpu_torch_lookalike", sys)
    try:
        assert "shadow1_tpu_torch_lookalike" not in forbidden_modules()
    finally:
        del sys.modules["shadow1_tpu_torch_lookalike"]


def test_a_tiny_pass_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A run of a tiny cell in a fresh interpreter, with the trace: after
    it, ``sys.modules`` holds no forbidden top-level name."""
    script = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from portbench.tests.tiny import run_tiny
from portbench.harness import forbidden_modules
out = run_tiny("phold.tiny", seed=3, trace=True)
print(json.dumps({{"correct": out["correct"], "bad": forbidden_modules(),
                  "program": "shadow1_tpu_torch" in sys.modules}}))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "program": True}
