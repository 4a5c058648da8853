"""What the benchmark may import: no module of ptbench/ imports jax,
jaxlib, flax or the JAX package (top-level names compared whole: the
port's name begins with the JAX package's), and the reference imports
nothing of the port. A run without a card, or in a directory that holds
only the benchmark, prints no result and exits with another code than 0."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

from _util import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pathtrace_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "ptbench").rglob("*.py"))
    assert files
    for f in files:
        assert not set(imported_tops(f)) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((ROOT / "ptbench" / "reference").rglob("*.py")):
        tops = set(imported_tops(f))
        assert "pathtrace_tpu_torch" not in tops, f
        assert tops <= {"__future__", "typing", "math", "statistics", "torch",
                        "numpy"}, (f, tops)


def test_the_names_are_compared_whole():
    from ptbench import run

    assert "pathtrace_tpu_torch" not in run.FORBIDDEN
    assert "pathtrace_tpu_torch".split(".")[0] not in set(run.FORBIDDEN)


def _run(cwd):
    return subprocess.run(
        [sys.executable, "ptbench/run.py", "--workload", "cover_frames",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the card's own tests run the cells
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
