"""Kernels P1-tf (``csrc/tf_range_scores.cu``) and B1-bounds, B1-select and
B1-merge (``csrc/blockmax_round.cu``): their calls' least time on the
card's peaks (``roofline/p1_tf.py``, ``b1_bounds.py``, ``b1_select.py``,
``b1_merge.py``) over their kernels' device time in the profiled steps,
in %.  None where the profile holds no such kernel."""


def read(run):
    return run.kernel_share(("p1_tf", "b1_bounds", "b1_select", "b1_merge"))
