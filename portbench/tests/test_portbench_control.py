"""The control, the reference in bfloat16 in the program's place, comes
out as not correct; the same reference in float32 passes."""

import pytest
import torch

from portbench.control import control_readings

from .tiny import WORKLOADS, tiny_cell


@pytest.mark.parametrize("name", WORKLOADS)
def test_bfloat16_control_fails(name):
    r = control_readings(tiny_cell(name, check_queries=256), 2**32 + 9, 20, "cpu", torch.bfloat16)
    assert not r["correct"]
    assert r["score_rel_err"] > 100 * r["limits"]["score_rel_err"] and r["rank_errors"] > 0


def test_float32_in_the_programs_place_passes():
    r = control_readings(tiny_cell("trec-covid.search", check_queries=256), 2**32 + 9, 20, "cpu", torch.float32)
    assert r["correct"] and r["score_rel_err"] < 1e-6
