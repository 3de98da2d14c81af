"""Kernels SP-stream (``csrc/sparse_merge.cu``) and S5
(``csrc/stream_rescore.cu``): their calls' least time on the card's peaks
(``roofline/sp_stream.py``, ``roofline/s5.py``) over their kernels'
device time in the profiled steps, in %.  None where the profile holds no
such kernel."""


def read(run):
    return run.kernel_share(("sp_stream", "s5"))
