"""The kernels' bytes and operations on small calls counted by hand."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import manifest
from portbench.roofline import peaks, s1, s2, s5, sp_stream
from portbench.roofline.windows import window_words

# Three windows: 128 postings at 4-bit deltas and no tfs (16 words), 64 at
# 16 bits with 2-bit tfs (32 + 4 words), 10 at 2 bits with 8-bit tfs (1 + 3).
LAYOUT = SimpleNamespace(
    n_windows=3,
    w_len=np.array([128, 64, 10]),
    w_dbits=np.array([4, 16, 2], dtype=np.uint8),
    w_tfbits=np.array([0, 2, 8], dtype=np.uint8),
    w_base=np.array([0, 500, 900], dtype=np.int32),
)


def test_window_words_by_hand():
    assert window_words(LAYOUT, [0]) == (16, 128, 1)
    assert window_words(LAYOUT, [1]) == (36, 64, 1)
    assert window_words(LAYOUT, [2]) == (4, 10, 1)
    assert window_words(LAYOUT, [0, 1, 2, 3, 3]) == (56, 202, 3)  # 3: the pad window


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_s1_by_hand():
    wsrc = torch.tensor([0, 1, 3, 3], dtype=torch.int32)
    args = [None] * 6 + [wsrc, torch.zeros(3, dtype=torch.int32), None, 2, 1000]
    n_bytes, ops = s1.cost(s1.capture(args, {}), LAYOUT)
    # words 16 + 36, 2 windows of meta, 4 ids and 4 ordinals, 3 spans,
    # 192 lanes' s1, a [2, 1001] accumulator.
    assert n_bytes == 4 * 52 + 14 * 2 + 8 * 4 + 4 * 3 + 4 * 192 + 4 * 2 * 1001
    assert ops == 4 * 192


def test_s2_by_hand():
    acc = torch.zeros(4, 1024)
    n_bytes, ops = s2.cost(s2.capture([acc, 16, 1000], {}), None)
    assert n_bytes == 4 * 4 * 1000 + 8 * 4 * 16 and ops == 4 * 1000


def test_sp_stream_by_hand():
    wsrc = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32)
    seg = torch.zeros((2, 3), dtype=torch.int32)
    args = [None] * 6 + [wsrc, 10, 1000, 1, seg]
    n_bytes, ops = sp_stream.cost(sp_stream.capture(args, {}), LAYOUT)
    assert n_bytes == 4 * 56 + 14 * 3 + 4 * 4 + 4 * 202 + 4 * 6 + 8 * 2 * 10
    assert ops == 3 * 202


def test_s5_by_hand():
    # One query, candidates 5 and 950 (and a pad, 1000), one term over
    # windows [0, 3): 5 falls in window 0, 950 in window 2.
    cand = torch.tensor([[5, 950, 1000]], dtype=torch.int32)
    t_lo = torch.tensor([[0]], dtype=torch.int32)
    t_hi = torch.tensor([[3]], dtype=torch.int32)
    args = [None] * 6 + [cand, t_lo, t_hi, 10, 1000]
    n_bytes, ops = s5.cost(s5.capture(args, {}), LAYOUT)
    assert n_bytes == 4 * (16 + 4) + 14 * 2 + 4 * 3 + 4 * 2 + 8 * 1 + 8 * 1 * 10
    assert ops == 4 * 3 * 1


def test_every_kernel_module_captures_its_call_unchanged():
    for name, module in manifest.roofline_modules().items():
        owner = __import__(module.TARGET[0], fromlist=[module.TARGET[1]])
        assert callable(getattr(owner, module.TARGET[1])), name
