"""CUDA graph keys the fused executor captured inside the measured window
(its own capture records): a capture there is set-up work the window pays."""


def read(run):
    return float(run.captures_in_window)
