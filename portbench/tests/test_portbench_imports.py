"""The benchmark loads neither JAX nor the JAX package, and its reference
takes nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.run import FORBIDDEN, forbidden_modules

HERE = manifest.HERE
ROOT = os.path.dirname(HERE)


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources(HERE)), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_package(path):
    found = set(_imported(path)) & set(FORBIDDEN)
    assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(HERE, "reference")):
        assert "vectorchord_bm25_tpu_torch" not in set(_imported(path)), path


def test_roofline_targets_name_the_port():
    for module in manifest.roofline_modules().values():
        assert module.TARGET[0].split(".", 1)[0] == "vectorchord_bm25_tpu_torch"


def test_forbidden_names_compare_whole():
    assert forbidden_modules(["vectorchord_bm25_tpu_torch", "vectorchord_bm25_tpu_torch.index", "benchmarks"]) == []
    assert forbidden_modules(["jaxlib.xla_client", "vectorchord_bm25_tpu.ops", "flax"]) == [
        "flax", "jaxlib", "vectorchord_bm25_tpu",
    ]


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.argv = ['x'];"
        "from portbench.tests.tiny import run_tiny; run_tiny('trec-covid.search', seconds=0.3);"
        "from portbench.run import forbidden_modules; print(forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
