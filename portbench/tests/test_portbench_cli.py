"""A run that finds no card, or no port, fails and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import manifest

ROOT = os.path.dirname(manifest.HERE)
ARGS = ["-m", "portbench.run", "--workload", "trec-covid.search", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "nope", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    import json

    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
