"""No module of the benchmark imports JAX, flax or the JAX package (by whole top-level
name), and the reference imports nothing of the port."""

import ast
import os

import pytest

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "gomatching_tpu"}


def modules():
    for d, _, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_jax(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "gomatching_tpu_torch" not in tops and "benchmark" not in tops


def test_whole_name_match():
    assert run.forbidden_modules(["gomatching_tpu_torch", "gomatching_tpu_torch.models"]) == []
    assert run.forbidden_modules(["gomatching_tpu.models", "jax._src", "numpy"]) == [
        "gomatching_tpu", "jax"]


def test_a_run_loads_no_jax():
    """What a run imports (the port included) loads none of them."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.jobs.video, "
            "gomatching_tpu_torch.engine.predictor; from benchmark import run; "
            "print(run.forbidden_modules(sys.modules))" % run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=run.ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
