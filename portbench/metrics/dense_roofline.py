"""Kernels S1 (``csrc/stream_dense.cu``) and S2 (``csrc/dense_topk.cu``):
their calls' least time on the card's peaks (``roofline/s1.py``,
``roofline/s2.py``) over their kernels' device time in the profiled
steps, in %.  None where the profile holds no such kernel."""


def read(run):
    return run.kernel_share(("s1", "s2"))
