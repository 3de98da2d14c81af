"""Device: the share of the profiled steps in which the card runs no
kernel, copy or fill, in %.  None where the profile saw no device
activity."""


def read(run):
    p = run.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
