"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "multibox_tpu"}


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not imported_roots(path) & JAX


@pytest.mark.parametrize("path", sorted(sources(os.path.join(BENCH, "reference"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert imported_roots(path) <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}
    src = open(path).read()
    assert "multibox_tpu" not in src


def test_the_run_names_what_it_found():
    sys.path.insert(0, BENCH)
    import run

    planted = ("multibox_tpu_stub_for_test", "flax.linen")
    try:
        for name in planted:
            sys.modules[name] = sys
        assert run.forbidden_modules() == ["flax"]  # the port's prefix alone is no match
    finally:
        for name in planted:
            del sys.modules[name]


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Without CUDA the run exits non-zero and prints nothing on stdout; in a
    directory with only the benchmark's files likewise."""
    d = tmp_path / "alone"
    shutil.copytree(BENCH, d / "benchmark")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), d)
    for cwd in (d, harness.ROOT):
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                               "multibox_inception_v3.detect_b4096", "--seed", "3", "--seconds", "1"],
                              cwd=cwd, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and proc.stdout == ""
